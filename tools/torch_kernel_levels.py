#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's kernels K1, K1-bf16 and K4 at every level
of the 257^3 multigrid hierarchy and at 65x33x33 (K1-bf16 also at 513^3),
K3 at the PDE filter's levels 257^3, 129^3 and 65^3, and K2 at 257^3 and
65x33x33, optionally beside the same kernels built from another
checkout, in turns on one GPU.

    python3 tools/torch_kernel_levels.py [--parent DIR] [--reps 15]

--parent DIR: the root of another checkout (for instance the parent
commit, `git archive` unpacked under build/); its csrc/ is built into its
own library and its entry points hex_operator_f32, hex_operator_bf16,
quadform_f32, nodal_hex_f32 and helmholtz_f32 are timed beside this
tree's.

Each time is topopt_in_petsc_tpu_torch/ops/roofline.py's `graph_ms`: CUDA
events around the replay of a CUDA graph of n back-to-back launches (n so
that a replay moves about 0.5 GB, at most 200), divided by n, median of
--reps replays, the trees taken in turns.  Before timing, each tree's
output is held to the plain PyTorch version at rtol 2e-5, atol 1e-5 of
max|ref| (K1-bf16: rtol 2^-7 against the plain version on the widened
inputs, rounded to bf16: both round once, so a rounding may fall the
other way), and the trees' outputs compared bit for bit.  Prints the
card's name and power limit, the kernels' `ptxas` lines, then one JSON
line per kernel and size.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
LEVELS = [(257,) * 3, (129,) * 3, (65,) * 3, (33,) * 3, (17,) * 3,
          (65, 33, 33)]
# the PDE filter's levels at 257^3 (3 levels)
K3_LEVELS = [(257,) * 3, (129,) * 3, (65,) * 3]
# K1-bf16 also runs the 513^3 recipe's levels
BF16_LEVELS = [(513,) * 3, *LEVELS]
BF16_RTOL = 2.0**-7


def _call(fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with CUDA error {err}")


def _check(name, got, ref, rtol=2e-5):
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    ok = bool(torch.all((got - ref).abs() <= 1e-5 * scale + rtol * ref.abs()))
    if not ok:
        raise AssertionError(f"{name} disagrees with the plain version")
    return float((got - ref).abs().max()) / scale


def _time(kernel, nn, calls, out, ref, nbytes, reps, rtol=2e-5):
    """Check every call's output against ref, then print their times."""
    from topopt_in_petsc_tpu_torch.ops.roofline import bound_ms, graph_ms

    err, outs = {}, {}
    for name, f in calls.items():
        out.zero_()
        f()
        torch.cuda.synchronize()
        err[name] = _check(f"{kernel} {name} {nn}", out, ref, rtol)
        outs[name] = out.clone()
    first = outs[next(iter(outs))]
    same = all(torch.equal(first, o) for o in outs.values())
    del outs, first
    n = max(1, min(200, int(5e8 // nbytes)))
    ms = dict(zip(calls, graph_ms(list(calls.values()), n, reps)))
    b, by = bound_ms(kernel, nn)
    print(json.dumps({"kernel": kernel, "nn": nn, "launches_per_graph": n,
                      "ms": ms, "bound_ms": b, "bound_by": by,
                      "share_of_bound": {k: b / v for k, v in ms.items()},
                      "max_err_over_max_ref": err,
                      "trees_bitwise_equal": same}), flush=True)


def _time_bf16(nn, lib, parent, dev, reps):
    """K1-bf16 (hex_operator_bf16) on K1's inputs rounded to bf16, against
    the plain version on the widened inputs, rounded."""
    from topopt_in_petsc_tpu_torch.grid import Grid
    from topopt_in_petsc_tpu_torch.models.elements import hex8_stiffness
    from topopt_in_petsc_tpu_torch.ops.blocked_hex import mask0
    from topopt_in_petsc_tpu_torch.ops.hex_operator import apply_hex_operator
    from topopt_in_petsc_tpu_torch.ops.roofline import work

    grid = Grid(nn=nn, lo=(0.0, 0.0, 0.0), hi=(2.0, 1.0, 1.0))
    KE = np.ascontiguousarray(hex8_stiffness(*grid.h, 0.3), dtype=np.float32)
    rng = np.random.default_rng(sum(nn) + 1)
    vb = torch.as_tensor(rng.normal(size=(3, *nn)), dtype=torch.float32,
                         device=dev).to(torch.bfloat16)
    E = torch.as_tensor(rng.uniform(1e-9, 1.0, size=grid.ne),
                        dtype=torch.float32, device=dev).to(torch.bfloat16)
    ref = mask0(apply_hex_operator(
        vb.float().permute(1, 2, 3, 0), E.float(),
        torch.as_tensor(KE, device=dev)).permute(3, 0, 1, 2).contiguous())
    ref = ref.to(torch.bfloat16)
    torch.cuda.empty_cache()
    out = torch.empty_like(vb)
    ptrs = (vb.data_ptr(), E.data_ptr(), out.data_ptr(), KE.ctypes.data,
            *nn, 1)
    calls = {"this": lambda: _call(lib.hex_operator_bf16, *ptrs)}
    if parent is not None:
        calls["parent"] = lambda: _call(parent.hex_operator_bf16, *ptrs)
    _time("K1-bf16", nn, calls, out, ref, work("K1-bf16", nn)[0], reps,
          BF16_RTOL)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_levels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from topopt_in_petsc_tpu_torch.grid import Grid
    from topopt_in_petsc_tpu_torch.models.elements import (
        helmholtz_element_matrices,
        hex8_stiffness,
    )
    from topopt_in_petsc_tpu_torch.ops.blocked_hex import mask0
    from topopt_in_petsc_tpu_torch.ops.cuda_build import LIBRARY, _Library
    from topopt_in_petsc_tpu_torch.ops.hex_operator import (
        apply_hex_operator,
        element_quadratic_form,
    )
    from topopt_in_petsc_tpu_torch.ops.roofline import work

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = LIBRARY.get()
    for line in LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"ptxas: {line.strip()}")
    parent = None
    if args.parent is not None:
        parent = _Library(
            csrc=args.parent / "topopt_in_petsc_tpu_torch" / "csrc",
            build_dir=ROOT / "build" / "parent_kernels",
            symbols=("hex_operator_f32", "hex_operator_bf16", "quadform_f32",
                     "nodal_hex_f32", "helmholtz_f32")).get()
    dev = torch.device("cuda", 0)

    for nn in BF16_LEVELS:
        _time_bf16(nn, lib, parent, dev, args.reps)
        torch.cuda.empty_cache()
    for nn in LEVELS:
        grid = Grid(nn=nn, lo=(0.0, 0.0, 0.0), hi=(2.0, 1.0, 1.0))
        KE = np.ascontiguousarray(hex8_stiffness(*grid.h, 0.3),
                                  dtype=np.float32)
        KEt = torch.as_tensor(KE, device=dev)
        rng = np.random.default_rng(sum(nn))
        vb = torch.as_tensor(rng.normal(size=(3, *nn)), dtype=torch.float32,
                             device=dev)
        E = torch.as_tensor(rng.uniform(1e-9, 1.0, size=grid.ne),
                            dtype=torch.float32, device=dev)
        out = torch.empty_like(vb)
        ptrs = (vb.data_ptr(), E.data_ptr(), out.data_ptr(), KE.ctypes.data,
                *nn, 1)
        calls = {"this": lambda: _call(lib.hex_operator_f32, *ptrs)}
        if parent is not None:
            calls["parent"] = lambda: _call(parent.hex_operator_f32, *ptrs)
        ref = mask0(apply_hex_operator(vb.permute(1, 2, 3, 0), E, KEt)
                    .permute(3, 0, 1, 2).contiguous())
        _time("K1", nn, calls, out, ref, work("K1", nn)[0], args.reps)
        del ref
        if nn in ((257,) * 3, (65, 33, 33)):
            un = vb.permute(1, 2, 3, 0).contiguous()
            q = torch.empty_like(E)
            qp = (un.data_ptr(), q.data_ptr(), KE.ctypes.data, *nn)
            qcalls = {"this": lambda: _call(lib.quadform_f32, *qp)}
            if parent is not None:
                qcalls["parent"] = lambda: _call(parent.quadform_f32, *qp)
            _time("K2", nn, qcalls, q, element_quadratic_form(un, KEt),
                  work("K2", nn)[0], args.reps)
            del un, q
        del vb, E, out
        torch.cuda.empty_cache()
        # K4 on u (nx, ny, nz, 3), and K3 on u (nx, ny, nz, 1) with the
        # default rmin 0.08 (R = rmin / (2 sqrt 3)) on the filter's levels
        nodal = [("K4", "nodal_hex_f32", 3, KE)]
        if nn in K3_LEVELS:
            KF = helmholtz_element_matrices(*grid.h, 0.08 / (2 * 3**0.5))[0]
            nodal.append(("K3", "helmholtz_f32", 1,
                          np.ascontiguousarray(KF, dtype=np.float32)))
        for name, symbol, dof, K in nodal:
            un = torch.as_tensor(rng.normal(size=(*nn, dof)),
                                 dtype=torch.float32, device=dev)
            En = torch.as_tensor(rng.uniform(1e-3, 1.0, size=grid.ne),
                                 dtype=torch.float32, device=dev)
            out = torch.empty_like(un)
            p = (un.data_ptr(), En.data_ptr(), out.data_ptr(),
                 K.ctypes.data, *nn)
            calls = {"this": lambda: _call(getattr(lib, symbol), *p)}
            if parent is not None:
                calls["parent"] = lambda: _call(getattr(parent, symbol), *p)
            ref = apply_hex_operator(un, En, torch.as_tensor(K, device=dev))
            _time(name, nn, calls, out, ref, work(name, nn)[0], args.reps)
            del un, En, out, ref
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
