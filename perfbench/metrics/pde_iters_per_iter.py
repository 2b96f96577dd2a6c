"""CG iterations of the PDE filter's solves per iteration: the program's
`FusedStep.pde_iters` (one entry per solve) at each iteration of the
measured window, summed per iteration and averaged; None without a PDE
filter."""


def read(w):
    pde = [sum(p) for p in w.counters.get("pde_iters") or [] if p]
    return sum(pde) / len(pde) if pde else None
