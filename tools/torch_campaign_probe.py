#!/usr/bin/env python3
"""Run the port's CLI in this process, as `python -m
topopt_in_petsc_tpu_torch` does, with any of three probes:

    python3 tools/torch_campaign_probe.py [--memory-at 4,200]
                                          [--f32-element-matrices]
                                          [--tail-devices] <CLI flags>

--memory-at: after the fused step of each named iteration, one `# memory`
line on stderr: device memory allocated now, its peak since the start and
reserved by the caching allocator, and this process's resident host
memory.  The line is read before the iteration's log lines and writes, so
two lines compare like with like: a growth from iteration 4 (the first
graph replay) to a later one is memory that the replays or the outputs
kept.

--f32-element-matrices: every elasticity element matrix rounded to f32 and
widened back, so that a `-dtype float64` run computes on the f32 path's
element matrices and differs from it by the rounding of its arithmetic
alone.

--tail-devices (with `-maxItr 1`; on a GPU): after the run, the post-solve
tail of its iteration (`tail_stages`: K2's per-element uᵀKEu, the
objective and its sensitivity, the filter chain rule, the movelimits, the
MMA update and the re-filtered design) once on the GPU and once on the
CPU, both from the run's state field (`RestartSol00.npz` in the workdir),
then one `# tail` line per stage on stderr: the largest difference
between the two, relative to the field's largest magnitude (K2 and the
MMA against their plain versions, cuFFT against the CPU's FFT), and the
GPU tail's design against the run's own (`Restart00.npz`), which shows
that the tail is the fused step's.

The campaign's run with the memory lines, for example (then
tools/summarize_run.py on the log and tools/compare_history.py on the
history, as tools/torch_run_campaign256.sh does):

    python3 tools/torch_campaign_probe.py --memory-at 4,200 -nx 257 \
        -ny 257 -nz 257 -nlvls 5 -maxItr 200 -fused 1 -output_dat 1 \
        -output_cadence_vtu 0 -workdir /dev/shm/campaign256
"""

import contextlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_rss() -> int:
    """This process's resident set, in bytes."""
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) * 1024 for line in f
                    if line.startswith("VmRSS:"))


@contextlib.contextmanager
def memory_lines(at):
    """Print the `# memory` line after the fused step of each iteration in
    `at`."""
    import torch

    from topopt_in_petsc_tpu_torch.parallel.fused_step import FusedStep

    call = FusedStep.__call__

    def reporting(step, s, itr=3):
        out = call(step, s, itr)
        if itr in at:
            line = f"# memory it. {itr}:"
            if step.device.type == "cuda":
                torch.cuda.synchronize(step.device)
                line += (
                    f" allocated {torch.cuda.memory_allocated(step.device)}"
                    f" B, peak {torch.cuda.max_memory_allocated(step.device)}"
                    f" B, reserved {torch.cuda.memory_reserved(step.device)}"
                    " B,")
            print(f"{line} host RSS {host_rss()} B", file=sys.stderr,
                  flush=True)
        return out

    FusedStep.__call__ = reporting
    try:
        yield
    finally:
        FusedStep.__call__ = call


@contextlib.contextmanager
def f32_element_matrices():
    """Every elasticity element matrix the port builds, rounded to f32 and
    widened back."""
    import numpy as np

    from topopt_in_petsc_tpu_torch.models import elasticity

    exact = elasticity.hex8_stiffness
    elasticity.hex8_stiffness = lambda *args: (
        exact(*args).astype(np.float32).astype(np.float64))
    try:
        yield
    finally:
        elasticity.hex8_stiffness = exact


def tail_stages(step, u):
    """The post-solve tail of the fused step's first iteration, from its
    init state and the state field `u` (nx, ny, nz, 3), stage by stage:
    the calls of `FusedStep`'s head, mma_start, dip_seg and post stages
    (parallel/fused_step.py) in their order, with `-filter 0` or `1`.
    Returns {stage: tensor}: K2's uKu, fx, gx[0], the scaled sensitivity
    before and after the filter chain rule (dfdx_raw, dfdx, dgdx), the
    movelimits, the asymptotes, the dual's lambda, the new design x, ch,
    xTilde, xPhys and mnd."""
    import torch

    from topopt_in_petsc_tpu_torch.ops.hex_operator import (
        element_quadratic_form,
    )
    from topopt_in_petsc_tpu_torch.ops.quadform import quadform
    from topopt_in_petsc_tpu_torch.solvers.cg import SEGMENT

    cfg, ph, mma, filt = step.cfg, step.physics, step.mma, step.filt
    if filt.filterType == 2:
        raise ValueError("tail_stages takes -filter 0 or 1")
    s = step.init_state()
    u = torch.as_tensor(u).to(device=s.u.device, dtype=s.u.dtype)
    uKu = (element_quadratic_form(u, ph._KEt) if ph.route == "xla"
           else quadform(u, ph.KE))
    # head
    fx, gx, dfdx, dgdx = ph._objective_parts(s.xPhys, u)
    fscale = 10.0 / fx
    dfdx_raw = dfdx * fscale
    dfdx, dgdx = filt._gradients_impl(
        s.x, s.xTilde, dfdx_raw, dgdx, s.beta, step.eta,
        projection=step.projection)
    # mma_start, then dip_seg until its flag drops
    xmin, xmax = mma._movelimit_impl(s.x, cfg.Xmin, cfg.Xmax, cfg.movlim)
    sub = mma._subproblem(s.x, dfdx, gx, dgdx, xmin, xmax, s.L, s.U,
                          s.xo1, s.xo2, fresh_asymptotes=True)
    dip = mma.dip_trips(mma.dip_start(), sub, SEGMENT)
    while bool(mma.dip_active(dip)):
        dip = mma.dip_trips(dip, sub, SEGMENT)
    # post
    x_new = mma.dip_x(dip, sub)
    xTilde, xPhys = step.project(x_new, s.beta)
    return {
        "uKu": uKu, "fx": fx, "gx": gx[0], "dfdx_raw": dfdx_raw,
        "dfdx": dfdx, "dgdx": dgdx[0], "xmin": xmin, "xmax": xmax,
        "L": sub[0], "U": sub[1], "lam": dip.lam, "x": x_new,
        "ch": torch.max(torch.abs(x_new - s.x)), "xTilde": xTilde,
        "xPhys": xPhys, "mnd": torch.mean(4.0 * xPhys * (1.0 - xPhys)),
    }


def field_error(a, b) -> float:
    """max |a - b| over max |b|, in f64 on the host (max |a| where b is
    all zeros)."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = float(np.abs(b).max())
    return float(np.abs(a - b).max()) / scale if scale > 0 else float(
        np.abs(a).max())


def tail_devices(cli, devices=("cuda", "cpu")) -> int:
    """The `--tail-devices` lines: the tail on the first of `devices`
    against the tail on the second from the run's own state field, and the
    first's design against the run's restart.  Exits 1 if it names cuda
    and there is no GPU."""
    import numpy as np
    import torch

    from topopt_in_petsc_tpu_torch.config import TopOptConfig
    from topopt_in_petsc_tpu_torch.parallel.fused_step import FusedStep

    if "cuda" in devices and not torch.cuda.is_available():
        print("--tail-devices needs a GPU", file=sys.stderr)
        return 1
    cfg = TopOptConfig.from_args(cli)
    with np.load(os.path.join(cfg.workdir, "RestartSol00.npz")) as z:
        u = z["u"]
    with np.load(os.path.join(cfg.workdir, "Restart00.npz")) as z:
        run = {k: z[k] for k in ("x", "xPhys", "L", "U")}
    tails = []
    for dev in devices:
        step = FusedStep(cfg, torch.device(dev), graphs=False)
        tails.append({k: v.detach().cpu().numpy()
                      for k, v in tail_stages(step, u).items()})
        del step
        if dev == "cuda":
            torch.cuda.empty_cache()
    (a, b), (first, second) = devices, tails
    for k in first:
        print(f"# tail {k}: {a} against {b} "
              f"{field_error(first[k], second[k]):.3e} ({a} "
              f"{float(np.abs(first[k]).max()):.9g})", file=sys.stderr)
    for k, v in run.items():
        print(f"# tail {k}: {a} against the run's restart "
              f"{field_error(first[k], v):.3e}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    cli = sys.argv[1:] if argv is None else list(argv)
    sys.path.insert(0, ROOT)
    from topopt_in_petsc_tpu_torch.__main__ import main as cli_main

    tail = False
    with contextlib.ExitStack() as probes:
        while cli[:1] in (["--memory-at"], ["--f32-element-matrices"],
                          ["--tail-devices"]):
            if cli[0] == "--tail-devices":
                tail = True
                cli = cli[1:]
            elif cli[0] == "--memory-at":
                at = {int(v) for v in cli[1].split(",")}
                probes.enter_context(memory_lines(at))
                cli = cli[2:]
            else:
                probes.enter_context(f32_element_matrices())
                cli = cli[1:]
        rc = cli_main(cli)
        return tail_devices(cli) if rc == 0 and tail else rc


if __name__ == "__main__":
    sys.exit(main())
