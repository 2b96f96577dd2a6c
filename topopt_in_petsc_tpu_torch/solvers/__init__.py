"""Krylov, smoother, multigrid transfers and the resident MG-PCG solver."""
