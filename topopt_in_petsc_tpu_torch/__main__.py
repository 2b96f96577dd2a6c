"""CLI entry point: `python -m topopt_in_petsc_tpu_torch -nx 65 -ny 33 ...`

Accepts the reference's PETSc-style single-dash flags (TopOpt.cc:154-165,
323-337), as the JAX package's CLI does, plus ``-device cuda|cpu``
(default cuda).  Writes ``history.npz`` (fx, gx, ch, mnd, solver
iterations, seconds per iteration) beside the VTU and restart outputs.
"""

import os
import sys

import numpy as np

from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.driver import run_topopt


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg = TopOptConfig.from_args(argv)
    history = run_topopt(cfg)
    if history and history.get("fx"):
        np.savez(
            os.path.join(cfg.workdir, "history.npz"),
            **{k: np.asarray(v) for k, v in history.items()},
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
