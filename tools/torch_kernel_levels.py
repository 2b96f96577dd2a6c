#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's kernels K1, K1-bf16 and K4 at every level
of the 257^3 multigrid hierarchy and at 65x33x33 (K1-bf16 also at 513^3),
K3 at the PDE filter's levels 257^3, 129^3 and 65^3, and K2 at 257^3 and
65x33x33, optionally beside the same kernels built from another
checkout, in turns on one GPU.

    python3 tools/torch_kernel_levels.py [--parent DIR] [--reps 15]
                                         [--cheb-only]

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

The Chebyshev step kernel (csrc/chebyshev.cu) is timed at each level of
the 257^3 hierarchy in its four forms, beside its plain torch twin (the
torch operations of the same step in solvers/chebyshev.py::
chebyshev_smooth_plain, with its 0-d coefficient operations): a start
from zero (3 field passes: b, dinv read, d written), a start from x (7),
a recurrence step (8: r, A d, d, dinv, x read, r, d, x written) and the
last step of a smoothing (6: x written alone).  Its bound is those
passes at 3.35 TB/s; each form's output is first held to the twin's bit
for bit.  --cheb-only times it alone.
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


# the forms of the Chebyshev step: (field passes of the kernel, the
# outputs r, d, x it stores)
CHEB_FORMS = {"from_zero": (3, "d"), "from_x": (7, "rdx"), "step": (8, "rdx"),
              "last": (6, "x")}


def _time_cheb(nn, dev, reps):
    """The Chebyshev step kernel's four forms on (3, *nn) f32 fields, the
    recurrence at its step 2, beside the plain torch operations of the
    same step."""
    from topopt_in_petsc_tpu_torch.ops.chebyshev import (
        chebyshev_band,
        chebyshev_step,
    )
    from topopt_in_petsc_tpu_torch.ops.roofline import (
        H100_BYTES_PER_S,
        graph_ms,
    )

    rng = np.random.default_rng(sum(nn) + 3)

    def field(lo=-1.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, size=(3, *nn)),
                               dtype=torch.float32, device=dev)

    b, ad, dinv, x0, r, d, x = (field() for _ in range(7))
    dinv = dinv.abs() + 0.5
    lmax = torch.tensor(1.9, dtype=torch.float32, device=dev)
    band = dict(lmax=lmax, lower=0.06, upper=1.1)
    out = {"r": torch.empty_like(b), "d": torch.empty_like(b),
           "x": torch.empty_like(b)}
    r2, d2, x2 = out.values()

    # the band, and rho after step 1, formed once per smoothing
    theta, delta, sigma = chebyshev_band(lmax, 0.06, 1.1, torch.float32)
    rho = 1.0 / (2.0 * sigma - 1.0 / sigma)

    def plain(form):
        """{r, d, x} of the plain smoother's operations for `form`, the
        recurrence at its step 2 (chebyshev_smooth_plain's own lines)."""
        if form == "from_zero":
            return {"d": (dinv * b) / theta}
        if form == "from_x":
            rr = b - ad
            dd = (dinv * rr) / theta
            return {"r": rr, "d": dd, "x": x0 + dd}
        rr = r - ad
        rho_new = 1.0 / (2.0 * sigma - rho)
        dd = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv * rr)
        return {"r": rr, "d": dd, "x": x + dd}

    kernels = {  # in place from the step on, as the smoother runs them
        "from_zero": lambda: chebyshev_step(0, b, None, None, dinv, None,
                                            d_out=d2, **band),
        "from_x": lambda: chebyshev_step(0, b, ad, None, dinv, x0, r_out=r2,
                                         d_out=d2, x_out=x2, **band),
        "step": lambda: chebyshev_step(2, r2, ad, d2, dinv, x2, r_out=r2,
                                       d_out=d2, x_out=x2, **band),
        "last": lambda: chebyshev_step(2, r2, ad, d2, dinv, x2, x_out=x2,
                                       **band),
    }
    nbytes = 4.0 * b.numel()
    for form, (passes, stored) in CHEB_FORMS.items():
        for t, src in ((r2, r), (d2, d), (x2, x)):
            t.copy_(src)
        kernels[form]()
        ref = plain(form)
        same = all(torch.equal(out[k], ref[k]) for k in stored)
        del ref
        n = max(1, min(200, int(5e8 // (passes * nbytes))))
        ms = dict(zip(("kernel", "plain"), graph_ms(
            [kernels[form], lambda: plain(form)], n, reps)))
        bound = passes * nbytes / H100_BYTES_PER_S * 1e3
        print(json.dumps({"kernel": "chebyshev_step", "form": form,
                          "nn": nn, "field_passes": passes,
                          "launches_per_graph": n, "ms": ms,
                          "bound_ms": bound, "bound_by": "bytes",
                          "share_of_bound": {
                              key: bound / v for key, v in ms.items()},
                          "bitwise_equal_plain": same}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--cheb-only", action="store_true")
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

    for nn in LEVELS[:5]:
        _time_cheb(nn, dev, args.reps)
        torch.cuda.empty_cache()
    if args.cheb_only:
        return 0
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
