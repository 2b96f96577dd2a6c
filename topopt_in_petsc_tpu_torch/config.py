"""Problem configuration mirroring the reference's PETSc options database.

Same fields, defaults, CLI flags and banner as the JAX package's
`TopOptConfig` (reference TopOpt.cc:106-135, 154-165, 323-337), plus one
flag of the port: ``-device cuda|cpu`` (default ``cuda``, no
auto-detection).

Every flag of the JAX package's CLI runs, on one device and under
`-mesh_shape`; a value outside a flag's set raises `ValueError`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

# Dof from which "-mg_dtype same" resolves to a bf16 V-cycle: where the
# f32 run's peak device memory would pass 90% of an 80 GB card.  Peaks of
# one split-driver iteration of the 513^3 recipe (-nlvls 6
# -smooth_sweeps 2, 405,017,091 dof), torch.cuda.max_memory_allocated,
# NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 18): f32
# 34,519,015,936 B (85.2 B per dof), bf16 33,100,128,768 B (81.7 B per
# dof).  So f32 fits at 513^3, and the threshold is about 8.45e8 dof.
F32_PEAK_BYTES_PER_DOF = 34_519_015_936 / 405_017_091
MG_BF16_DOF = 0.9 * 80e9 / F32_PEAK_BYTES_PER_DOF


@dataclasses.dataclass
class TopOptConfig:
    """All knobs of the optimization problem + solvers.

    Field names/defaults follow the reference CLI one-to-one
    (TopOpt.cc:106-135):  ``-nx -ny -nz`` are *node* counts, the design grid
    is ``(nx-1, ny-1, nz-1)`` elements.
    """

    # --- FEM mesh (TopOpt.cc:106-117) ---
    nx: int = 65
    ny: int = 33
    nz: int = 33
    xcmin: float = 0.0
    xcmax: float = 2.0
    ycmin: float = 0.0
    ycmax: float = 1.0
    zcmin: float = 0.0
    zcmax: float = 1.0
    nu: float = 0.3
    nlvls: int = 4  # multigrid levels

    # --- Optimization (TopOpt.cc:119-128) ---
    volfrac: float = 0.12
    maxItr: int = 400
    rmin: float = 0.08
    penal: float = 3.0
    Emin: float = 1.0e-9
    Emax: float = 1.0
    filter: int = 1  # 0=sensitivity, 1=density, 2=PDE; other = no filtering
    Xmin: float = 0.0
    Xmax: float = 1.0
    movlim: float = 0.2
    nconstraints: int = 1  # m — reference TopOpt(nconstraints) (TopOpt.cc:15)

    # --- Projection filter (TopOpt.cc:131-135) ---
    projectionFilter: bool = False
    beta: float = 0.1
    betaFinal: float = 48.0
    eta: float = 0.0

    # --- Restart (TopOpt.cc:401-450) ---
    restart: bool = True
    onlyLoadDesign: bool = False
    restartFileVec: str = ""  # one .npz per checkpoint stream
    # accepted and ignored: itr/fscale live inside the restart .npz
    restartFileItr: str = ""
    restartFileVecSol: str = ""
    workdir: str = "./"

    # --- Linear solver (LinearElasticity.cc:619-635) ---
    ksp_rtol: float = 1.0e-5
    ksp_maxit: int = 200
    ksp_type: str = "fcg"  # flexible PCG, or "fgmres" (solvers/gmres.py)
    ksp_gmres_restart: int = 30
    # accepted no-ops: the JAX package's host-chunked Krylov, design
    # parking and two-program tail served the TPU backend's execution
    # time limit and its 16 GB of HBM; the port's solve is one segmented
    # loop and every field stays on the device
    ksp_chunk: int = -1
    ksp_monitor: bool = False  # per-chunk residuals; no chunks here
    park_design: int = -1
    tail_split: bool = False
    # f32 Chebyshev steps after a V-cycle whose fine level is bf16
    mg_fine_post: int = 0
    # "rediscretize" or "galerkin_octant" (octant-Galerkin coarse levels,
    # nodal path only: models/elasticity.py routes it there)
    coarse_op: str = "rediscretize"
    coarse_rtol: float = 1.0e-8
    coarse_maxit: int = 30
    smooth_sweeps: int = 4  # Chebyshev degree per pre/post smooth
    cheby_upper: float = 1.1  # smooth band = [lower*lmax, upper*lmax]
    # -1 = auto: 0.25 for a reduced-precision V-cycle of degree <= 2,
    # else 0.06
    cheby_lower: float = -1.0

    # --- PDE filter solver (PDEFilter.cc:269-380; opt/pde_filter.py) ---
    pde_nlvls: int = 3
    pde_rtol: float = 1.0e-8
    pde_maxit: int = 60

    # --- knobs without a reference equivalent ---
    dtype: str = "float32"  # field dtype: "float32" or "float64"
    # "auto" and "blocked" both select the resident solver (kernel K1);
    # "pallas" selects the nodal layout with the hand-written nodal
    # kernel (K4) at every rediscretized MG level; "xla" the nodal layout
    # on the plain torch operators (ops/hex_operator.py) at every level.
    # The route of each combination: models/elasticity.py
    operator_impl: str = "auto"
    # V-cycle storage: "same" (f32; bf16 by `resolve_mg_mode` above its
    # dof threshold), "bfloat16" (every level) or "mixed" (f32 fine level,
    # bf16 coarse levels; the resident solver only)
    mg_dtype: str = "same"
    precise_dots: bool = True  # f64 accumulation of dots and sums
    # rank grid of the multi-device engine (parallel/spmd_driver.py)
    mesh_shape: tuple = (1, 1, 1)
    fused: bool = False  # the fused step (parallel/fused_step.py)
    output_cadence_vtu: bool = True  # write .vtu fields like main.cc:114-116
    output_dat: bool = False  # reference-format .dat (io/mpiio_dat.py)
    # a torch.profiler trace of the run (utils/profiling.py), one per
    # rank under -mesh_shape
    profile_dir: str = ""
    device: str = "cuda"  # "cuda" or "cpu"; no auto-detection

    # ----------------------------------------------------------------- #

    @property
    def m(self) -> int:
        return self.nconstraints

    @property
    def nelx(self) -> int:
        return self.nx - 1

    @property
    def nely(self) -> int:
        return self.ny - 1

    @property
    def nelz(self) -> int:
        return self.nz - 1

    @property
    def nelem(self) -> int:
        return self.nelx * self.nely * self.nelz

    @property
    def ndof(self) -> int:
        return 3 * self.nx * self.ny * self.nz

    # -- auto-lever rules, at the values of the path the port carries -- #

    def resolve_ksp_chunk(self, ndof: int) -> int:
        """The state solve is one call: no host-chunked Krylov."""
        return 0

    def resolve_mg_mode(self, ndof: int) -> str:
        """Resolved V-cycle storage: "same" (f32), "bfloat16" or "mixed".
        An explicit -mg_dtype wins; "same" turns to "bfloat16" from
        `MG_BF16_DOF` dof on, where the f32 solve no longer fits the card
        (the JAX package's rule, its threshold re-derived for an H100)."""
        if self.mg_dtype != "same":
            return self.mg_dtype
        return "bfloat16" if ndof >= MG_BF16_DOF else "same"

    def resolve_mg_bf16(self, ndof: int) -> bool:
        return self.resolve_mg_mode(ndof) != "same"

    def resolve_park(self, ndof: int) -> bool:
        """No design parking: the port keeps every field on the device."""
        return False

    def resolve_cheby_lower(self, ndof: int) -> float:
        """Explicit value wins; auto narrows the smoothing band to 0.25
        for a reduced-precision V-cycle of degree <= 2 (the giga-dof
        recipe), else 0.06."""
        if self.cheby_lower >= 0:
            return self.cheby_lower
        if self.resolve_mg_mode(ndof) != "same" and self.smooth_sweeps <= 2:
            return 0.25
        return 0.06

    @property
    def dx(self) -> float:
        return (self.xcmax - self.xcmin) / (self.nx - 1)

    @property
    def dy(self) -> float:
        return (self.ycmax - self.ycmin) / (self.ny - 1)

    @property
    def dz(self) -> float:
        return (self.zcmax - self.zcmin) / (self.nz - 1)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32

    def torch_device(self) -> torch.device:
        """The device every tensor of a run lives on.  Raises when CUDA is
        asked for and there is none: a run never moves to the CPU by
        itself."""
        if self.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "-device cuda: no CUDA device is available "
                "(pass -device cpu to run on the CPU)"
            )
        return torch.device(self.device)

    def validate(self) -> None:
        """MG-compatibility check (reference TopOpt.cc:183-201) and the
        port's coverage check.

        Every axis must satisfy (n-1) % 2^(nlvls-1) == 0 so the element grid
        can be halved nlvls-1 times.  The reference exit(0)s; we raise.
        """
        div = 2 ** (self.nlvls - 1)
        for name, n in (("x", self.nx), ("y", self.ny), ("z", self.nz)):
            if (n - 1) % div != 0:
                raise ValueError(
                    "MESH DIMENSION NOT COMPATIBLE WITH NUMBER OF MULTIGRID "
                    f"LEVELS: {name} - number of nodes {n} cannot be halved "
                    f"{self.nlvls - 1} times"
                )
        if self.filter == 0 and self.Xmin < 0.001:
            # Prevent division by zero in the sensitivity filter
            # (reference TopOpt.cc:357-359).
            self.Xmin = 0.001
        for flag, value, allowed in (
            ("ksp_type", self.ksp_type, ("fcg", "fgmres")),
            ("dtype", self.dtype, ("float32", "float64")),
            ("coarse_op", self.coarse_op,
             ("rediscretize", "galerkin_octant")),
            ("operator_impl", self.operator_impl,
             ("auto", "blocked", "pallas", "xla")),
            ("mg_dtype", self.mg_dtype, ("same", "bfloat16", "mixed")),
            ("device", self.device, ("cuda", "cpu")),
        ):
            if value not in allowed:
                raise ValueError(
                    f"-{flag} must be one of {', '.join(allowed)}, "
                    f"got {value}"
                )
        if self.filter == 2:
            # the PDE filter's own MG hierarchy (opt/pde_filter.py)
            div = 2 ** (self.pde_nlvls - 1)
            for n in (self.nelx, self.nely, self.nelz):
                if n % div != 0:
                    raise ValueError(
                        f"PDE filter: element count {n} not divisible "
                        f"by {div} (-pde_nlvls {self.pde_nlvls})"
                    )
        if self.mesh:
            # the overlapping blocks (parallel/decomp.py): raises unless
            # every axis splits evenly into blocks that coarsen nlvls-1
            # times
            from topopt_in_petsc_tpu_torch.grid import Grid
            from topopt_in_petsc_tpu_torch.parallel.decomp import (
                BlockDecomp,
            )

            BlockDecomp(Grid.from_config(self), tuple(self.mesh_shape),
                        self.nlvls)

    @property
    def mesh(self) -> bool:
        """Does the run go over a rank grid (`-mesh_shape` not 1,1,1)?"""
        return tuple(self.mesh_shape) != (1, 1, 1)

    # ----------------------------------------------------------------- #
    # CLI (PETSc options style: single-dash long flags; TopOpt.cc:154-165)

    _INT_FLAGS = ("nx", "ny", "nz", "nlvls", "maxItr", "filter", "nconstraints",
                  "ksp_maxit", "smooth_sweeps", "pde_nlvls", "pde_maxit",
                  "coarse_maxit", "ksp_gmres_restart", "ksp_chunk",
                  "park_design", "mg_fine_post")
    _BOOL_FLAGS = ("projectionFilter", "restart", "onlyLoadDesign",
                   "fused", "ksp_monitor", "tail_split",
                   "precise_dots", "output_cadence_vtu", "output_dat")
    _STR_FLAGS = ("restartFileVec", "restartFileItr", "restartFileVecSol",
                  "workdir", "dtype", "coarse_op", "operator_impl",
                  "mg_dtype", "profile_dir", "ksp_type", "device")

    @classmethod
    def from_args(cls, argv: Sequence[str]) -> "TopOptConfig":
        cfg = cls()
        fields = {f.name for f in dataclasses.fields(cls)}
        i = 0
        argv = list(argv)
        while i < len(argv):
            tok = argv[i]
            if not tok.startswith("-"):
                raise ValueError(f"unexpected argument: {tok}")
            name = tok.lstrip("-")
            if name not in fields:
                raise ValueError(f"unknown option: {tok}")
            if i + 1 >= len(argv):
                raise ValueError(f"option {tok} needs a value")
            val = argv[i + 1]
            if name in cls._INT_FLAGS:
                setattr(cfg, name, int(val))
            elif name in cls._BOOL_FLAGS:
                setattr(cfg, name, val.lower() in ("1", "true", "yes", "on"))
            elif name in cls._STR_FLAGS:
                setattr(cfg, name, val)
            elif name == "mesh_shape":
                setattr(cfg, name, tuple(int(v) for v in val.split(",")))
            else:
                setattr(cfg, name, float(val))
            i += 2
        cfg.validate()
        return cfg

    def banner(self) -> str:
        """Config printout equivalent to TopOpt.cc:168-180, 339-353."""
        lines = [
            "#" * 62,
            "######################### FEM settings #######################",
            f"# Number of nodes: (-nx,-ny,-nz):        ({self.nx},{self.ny},{self.nz})",
            f"# Number of degree of freedom:           {self.ndof}",
            f"# Number of elements:                    ({self.nelx},{self.nely},{self.nelz})",
            f"# Dimensions: (-xcmin,-xcmax,..,-zcmax): ({self.xcmax - self.xcmin},{self.ycmax - self.ycmin},{self.zcmax - self.zcmin})",
            f"# -nlvls: {self.nlvls}",
            "################### Optimization settings ####################",
            f"# Problem size: n= {self.nelem}, m= {self.m}",
            f"# -filter: {self.filter}  (0=sens., 1=dens, 2=PDE)",
            f"# -rmin: {self.rmin}",
            f"# -projectionFilter: {int(self.projectionFilter)}  (0/1)",
            f"# -beta: {self.beta}",
            f"# -betaFinal: {self.betaFinal}",
            f"# -eta: {self.eta}",
            f"# -volfrac: {self.volfrac}",
            f"# -penal: {self.penal}",
            f"# -Emin/-Emax: {self.Emin:e} - {self.Emax:e}",
            f"# -nu: {self.nu}",
            f"# -maxItr: {self.maxItr}",
            f"# -movlim: {self.movlim}",
            "#" * 62,
        ]
        return "\n".join(lines)
