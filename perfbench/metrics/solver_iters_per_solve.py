"""Outer Krylov iterations of the state solve per solve: the program's
`OptState.solver_iters` at each iteration of the measured window,
averaged (one solve per iteration)."""


def read(w):
    iters = w.counters.get("solver_iters") or []
    return sum(iters) / len(iters) if iters else None
