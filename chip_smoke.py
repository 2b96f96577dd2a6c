#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (topopt_in_petsc_tpu_torch) on one
NVIDIA GPU.  Run from the repository root:  python3 chip_smoke.py

Phases, each printing its lines before the next starts:
  1. environment: torch and CUDA versions, device name, nvidia-smi's name
     and power limit;
  2. build: the hand-written kernels K1-K4 with nvcc, and its time;
  3. kernel parity: each kernel against its plain PyTorch version on the
     card at 9x7x5, 65x33x33, 13x11x7, the tile edges 9x9x33 and
     13x11x37, and the coarse levels 17^3 and 33^3 (rtol 2e-5, atol 1e-5
     of max|ref|, the JAX package's bar for its Pallas kernels; K1's
     bf16-storage build, K1-bf16, rtol 2^-7: both round once to bf16);
     two launches of each of K1-K4 and K1-bf16 bitwise equal (no
     atomics); and, for element matrices without the brick's reflection
     symmetry, the FMA products;
  4. kernel times at 257^3 nodes against the plain versions (the kernel
     as a CUDA graph of one launch replays it, the plain version around
     its call; CUDA events, median of 15), each kernel's output first
     held to the plain version's at the same bar; K1 and K4 at every
     level of the 257^3 hierarchy (K1 also at 65x33x33, K1-bf16 also at
     513^3 and 65x33x33) and K3 at the PDE filter's levels 257^3, 129^3
     and 65^3, held to the plain version and then timed as a graph of
     back-to-back launches replays it, beside the bound and its share,
     which must not exceed 100%;
  5. the default 65x33x33 run through the CLI entry for 10 iterations,
     held against docs/jax_cpu_history_65x33x33.npz (the JAX package on
     CPU), with the launch counts of K1 and K2 over that run;
  6. the 257^3 run (50.9M dof) for 2 iterations: iteration-1 compliance
     against the JAX package's 257^3 golden history, both solves
     converged;
  7. the 65x33x33 run with the PDE filter (-filter 2) for 10 iterations,
     held against docs/jax_cpu_history_65x33x33_filter2.npz, with the
     launch counts of K1, K2 and K3;
  8. the 65x33x33 run of the nodal solve (-operator_impl pallas) for 10
     iterations, held against docs/jax_cpu_history_65x33x33.npz (solver
     iterations within 1), with the launch counts of K4 and K2;
  9. the 257^3 run of each of those two paths for 2 iterations, held to
     the golden iteration-1 compliance as in phase 6 (the design is
     uniform there and the PDE filter preserves constants);
 10. the fused driver (-fused 1), 65x33x33, 10 iterations through the CLI
     entry, held against docs/jax_cpu_history_65x33x33_fused.npz (the JAX
     package's -fused 1 on CPU), with the launch counts of K1 and K2;
 11. the fused nodal path (-fused 1 -operator_impl pallas) against the
     same history, solver iterations within 1, with K4's launches;
 12. the fused -filter 2 path against
     docs/jax_cpu_history_65x33x33_fused_filter2.npz, with K3's launches;
 13. graph = eager: 4 iterations of the fused step with its steady
     variant captured as CUDA graphs (replayed at iteration 4) against
     the same stage functions kept eager, equal to 1e-6 relative;
 14. the fused 257^3 run, 4 iterations (the last replays the graphs):
     iteration-1 compliance against the golden, no stalled solve, graphs
     captured, peak memory, and s/iteration beside the split driver's
     (phases 6 and 9); first of the default path, then (after its
     profile) of the nodal and the -filter 2 paths;
 15. a torch.profiler window over one steady iteration of the split and
     of the fused driver at 65x33x33 and at 257^3, and of the fused nodal
     and -filter 2 paths at 257^3: host launch calls, kernels on the
     device, device-to-host copies, host synchronizations, and the
     device's idle share; and the runs of K1-K4 the device recorded in
     each window, which must equal the growth of their launch counts
     over it; in the fused 257^3 windows, the runs and device time per
     multigrid level of K1 (default and -filter 2), K4 (nodal) and K3
     (-filter 2), told apart by the launch grid;
 16. the bf16 V-cycle (-mg_dtype bfloat16) at 65x33x33 for 10 iterations:
     split and fused, resident and nodal, and -mg_dtype mixed (split) and
     -mg_fine_post 1 (fused), each held to its driver's f32 history at the
     bars of phases 5 and 10, its solver iterations printed beside the
     history's; graph = eager for the fused bf16 step;
 17. the bf16 V-cycle at 257^3: 2 split iterations (also -mg_dtype mixed
     and -mg_fine_post 2) and 4 fused held to the golden iteration-1
     compliance, the fused s/iteration beside phase 14's f32 ones, peak
     memory, and a profiled steady fused iteration with K1's and
     K1-bf16's runs and device time per level;
 18. the one-card 513^3 recipe (405M dof, -nlvls 6 -smooth_sweeps 2), one
     split iteration in f32 and one with the bf16 V-cycle: fx agree to
     1e-3, solver iterations, peak memory and seconds.
A CUDA graph's replay counts the kernel launches it recorded
(ops/cuda_build.py); phase 15 holds that count to the device's own
record.  Then one JSON line of per-kernel results, whose
launch counts are the fused paths' (phases 10-12, K1-bf16's phase 16's
fused resident run) and whose bounds are
topopt_in_petsc_tpu_torch/ops/roofline.py's for phase 4's inputs, and,
last, the JSON status line.  Any failure raises: the exit code is
nonzero and no status line is printed.  Nothing falls back to the CPU or
to a plain version.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PARITY_SHAPES = ((9, 7, 5), (65, 33, 33), (13, 11, 7), (9, 9, 33),
                 (13, 11, 37), (17, 17, 17), (33, 33, 33))
# the bitwise repeats at these shapes (tile edges on every axis)
REPEAT_SHAPES = ((13, 11, 37), (65, 33, 33))
LEVELS_257 = ((257,) * 3, (129,) * 3, (65,) * 3, (33,) * 3, (17,) * 3)
# the PDE filter's levels at 257^3 (3 levels)
PDE_LEVELS_257 = LEVELS_257[:3]
RTOL, ATOL_REL = 2e-5, 1e-5
# K1-bf16 against its plain version: both compute in f32 and round once to
# bf16, so at most one rounding falls the other way (2^-7 relative)
BF16_RTOL = 2.0**-7
# history bars against the JAX package on CPU: fx relative, gx and ch
# absolute (gx[0] passes through 0 at iteration 1)
FX_RTOL, GX_ATOL, CH_ATOL = 1e-3, 1e-4, 1e-3
GOLDEN_257_FX1 = 1725.1459  # docs/golden_history_257x257x257.npz, it. 1


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1 env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    log(smi)  # name, power limit


def phase_build():
    from topopt_in_petsc_tpu_torch.ops.cuda_build import LIBRARY

    t0 = time.perf_counter()
    LIBRARY.get()
    dt = time.perf_counter() - t0
    for line in LIBRARY.build_log.splitlines():
        if ("registers" in line or "spill" in line or "error" in line
                or "entry function" in line):
            log(f"[2 build] ptxas: {line.strip()}")
    log(f"[2 build] {os.path.relpath(LIBRARY.path, REPO)} in {dt:.2f} s "
        f"(nvcc {LIBRARY.build_seconds} s)")


def _case(nn, seed, dev):
    from topopt_in_petsc_tpu_torch.grid import Grid
    from topopt_in_petsc_tpu_torch.models.elements import hex8_stiffness

    grid = Grid(nn=nn, lo=(0.0, 0.0, 0.0), hi=(2.0, 1.0, 1.0))
    KE = hex8_stiffness(*grid.h, 0.3)
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.normal(size=(3, *nn)), dtype=torch.float32,
                        device=dev)
    E = torch.as_tensor(rng.uniform(1e-9, 1.0, size=grid.ne),
                        dtype=torch.float32, device=dev)
    return KE, u, E


def _nodal_case(nn, seed, dev, dof):
    """(element matrix, u, E) of K3 (dof 1) or K4 (dof 3) on one grid."""
    from topopt_in_petsc_tpu_torch.grid import Grid
    from topopt_in_petsc_tpu_torch.models.elements import (
        helmholtz_element_matrices,
        hex8_stiffness,
    )

    grid = Grid(nn=nn, lo=(0.0, 0.0, 0.0), hi=(2.0, 1.0, 1.0))
    if dof == 1:  # the default rmin 0.08, R = rmin / (2 sqrt 3)
        KE = helmholtz_element_matrices(*grid.h, 0.08 / (2 * 3**0.5))[0]
    else:
        KE = hex8_stiffness(*grid.h, 0.3)
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.normal(size=(*nn, dof)), dtype=torch.float32,
                        device=dev)
    E = torch.as_tensor(rng.uniform(1e-3, 1.0, size=grid.ne),
                        dtype=torch.float32, device=dev)
    return np.ascontiguousarray(KE, dtype=np.float32), u, E


def _plain_nodal(u, E, KE):
    from topopt_in_petsc_tpu_torch.ops.hex_operator import apply_hex_operator

    return apply_hex_operator(u, E, torch.as_tensor(KE, device=u.device))


def _nodal_wrappers():
    """name -> (dof, wrapper) of K3 and K4."""
    from topopt_in_petsc_tpu_torch.ops.nodal_hex import helmholtz, nodal_hex

    return {"K3": (1, helmholtz), "K4": (3, nodal_hex)}


def _plain_k1(vb, eb, KE, mask_x0):
    from topopt_in_petsc_tpu_torch.ops.blocked_hex import mask0
    from topopt_in_petsc_tpu_torch.ops.hex_operator import apply_hex_operator

    KEt = torch.as_tensor(KE, dtype=torch.float32, device=vb.device)
    out = apply_hex_operator(vb.permute(1, 2, 3, 0), eb, KEt)
    out = out.permute(3, 0, 1, 2).contiguous()
    return mask0(out) if mask_x0 else out


def _bf16_case(nn, seed, dev):
    """K1-bf16's inputs: K1's, rounded to bf16."""
    KE, u, E = _case(nn, seed, dev)
    return KE, u.to(torch.bfloat16), E.to(torch.bfloat16)


def _plain_k1_bf16(vb, eb, KE, mask_x0):
    """K1-bf16's plain version: K1's on the widened inputs, rounded."""
    return _plain_k1(vb.float(), eb.float(), KE, mask_x0).to(torch.bfloat16)


def _plain_k2(u, KE):
    from topopt_in_petsc_tpu_torch.ops.hex_operator import (
        element_quadratic_form,
    )

    return element_quadratic_form(
        u, torch.as_tensor(KE, dtype=torch.float32, device=u.device)
    )


def _compare(name, got, ref, phase="3 parity", rtol=RTOL):
    got, ref = got.float(), ref.float()
    err = float(torch.max(torch.abs(got - ref)))
    scale = float(torch.max(torch.abs(ref)))
    ok = bool(torch.all(
        torch.abs(got - ref) <= ATOL_REL * scale + rtol * torch.abs(ref)
    ))
    log(f"[{phase}] {name}: max|err| {err:.3e}, max|ref| {scale:.3e}, "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def phase_parity(dev):
    from topopt_in_petsc_tpu_torch.ops.blocked_hex import hex_operator
    from topopt_in_petsc_tpu_torch.ops.quadform import quadform

    errs = {"K1": 0.0, "K2": 0.0, "K1-bf16": 0.0}
    for i, nn in enumerate(PARITY_SHAPES):
        KE, vb, E = _case(nn, i, dev)
        _, vh, Eh = _bf16_case(nn, i, dev)
        for mask_x0 in (False, True):
            got = hex_operator(vb, E, KE, mask_x0)
            ref = _plain_k1(vb, E, KE, mask_x0)
            errs["K1"] = max(errs["K1"], _compare(
                f"K1 {nn} mask_x0={mask_x0}", got, ref))
            errs["K1-bf16"] = max(errs["K1-bf16"], _compare(
                f"K1-bf16 {nn} mask_x0={mask_x0}",
                hex_operator(vh, Eh, KE, mask_x0),
                _plain_k1_bf16(vh, Eh, KE, mask_x0), rtol=BF16_RTOL))
        u = vb.permute(1, 2, 3, 0).contiguous()
        errs["K2"] = max(errs["K2"], _compare(
            f"K2 {nn}", quadform(u, KE), _plain_k2(u, KE)))
        for name, (dof, wrapper) in _nodal_wrappers().items():
            K, un, En = _nodal_case(nn, 10 + i, dev, dof)
            errs[name] = max(errs.get(name, 0.0), _compare(
                f"{name} {nn}", wrapper(un, En, K), _plain_nodal(un, En, K)))
    torch.cuda.synchronize()
    _parity_forms(dev)
    return errs


def _bent(KE, seed):
    """KE plus a symmetric perturbation of 1e-2 of max|KE|: no brick's
    element matrix, so the kernels take their (8 dof)^2-FMA products."""
    A = np.random.default_rng(seed).normal(size=KE.shape)
    return np.ascontiguousarray(KE + 1e-2 * np.abs(KE).max() * (A + A.T),
                                dtype=np.float32)


def _parity_forms(dev):
    """Two launches of each of K1-K4 bitwise equal, and each kernel on an
    element matrix without the reflection symmetry."""
    from topopt_in_petsc_tpu_torch.ops.blocked_hex import hex_operator
    from topopt_in_petsc_tpu_torch.ops.quadform import quadform

    for nn in REPEAT_SHAPES:
        KE, vb, E = _case(nn, 20, dev)
        _, vh, Eh = _bf16_case(nn, 20, dev)
        u = vb.permute(1, 2, 3, 0).contiguous()
        same = {
            "K1": torch.equal(hex_operator(vb, E, KE, True),
                              hex_operator(vb, E, KE, True)),
            "K2": torch.equal(quadform(u, KE), quadform(u, KE)),
            "K1-bf16": torch.equal(hex_operator(vh, Eh, KE, True),
                                   hex_operator(vh, Eh, KE, True)),
        }
        for name, (dof, wrapper) in _nodal_wrappers().items():
            K, un, En = _nodal_case(nn, 21, dev, dof)
            same[name] = torch.equal(wrapper(un, En, K), wrapper(un, En, K))
        log(f"[3 parity] {nn} two launches bitwise equal: {same}")
        if not all(same.values()):
            raise AssertionError("a kernel is not deterministic")
    # matrices that are no brick's: the kernels take their FMA products
    KEn = _bent(KE, 3)
    _compare(f"K1 {nn} KE without the symmetry",
             hex_operator(vb, E, KEn, True), _plain_k1(vb, E, KEn, True))
    _compare(f"K2 {nn} KE without the symmetry", quadform(u, KEn),
             _plain_k2(u, KEn))
    _compare(f"K1-bf16 {nn} KE without the symmetry",
             hex_operator(vh, Eh, KEn, True),
             _plain_k1_bf16(vh, Eh, KEn, True), rtol=BF16_RTOL)
    for name, (dof, wrapper) in _nodal_wrappers().items():
        K, un, En = _nodal_case(nn, 22, dev, dof)
        Kn = _bent(K, 4)
        _compare(f"{name} {nn} matrix without the symmetry",
                 wrapper(un, En, Kn), _plain_nodal(un, En, Kn))


def _median_ms(fns, reps=15):
    """Median CUDA-event time of each function, run in turns."""
    times = [[] for _ in fns]
    for f in fns:  # warm-up
        f()
    torch.cuda.synchronize()
    for _ in range(reps):
        for i, f in enumerate(fns):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            f()
            b.record()
            torch.cuda.synchronize()
            times[i].append(a.elapsed_time(b))
    return [statistics.median(t) for t in times]


def _graph_ms(fn, n):
    """Device ms per call of fn from a CUDA graph of n calls."""
    from topopt_in_petsc_tpu_torch.ops.roofline import graph_ms

    return graph_ms([fn], n)[0]


def _share(name, nn, ms):
    """(bound ms, what sets it, share of the bound) of `name` on an `nn`
    grid run in `ms`; a share above 1 means the bound is no bound."""
    from topopt_in_petsc_tpu_torch.ops.roofline import bound_ms

    b, by = bound_ms(name, nn)
    if b > ms:
        raise AssertionError(f"{name} {nn}: {ms} ms beats its bound {b} ms")
    return b, by, b / ms


def _level_case(name, nn, dev):
    """(kernel call, plain call) of `name` on one level's inputs."""
    from topopt_in_petsc_tpu_torch.ops.blocked_hex import hex_operator

    if name == "K1":
        KE, vb, E = _case(nn, 30, dev)
        return (lambda: hex_operator(vb, E, KE, True),
                lambda: _plain_k1(vb, E, KE, True))
    if name == "K1-bf16":
        KE, vb, E = _bf16_case(nn, 30, dev)
        return (lambda: hex_operator(vb, E, KE, True),
                lambda: _plain_k1_bf16(vb, E, KE, True))
    dof, wrapper = _nodal_wrappers()[name]
    K, un, En = _nodal_case(nn, 31, dev, dof)
    return lambda: wrapper(un, En, K), lambda: _plain_nodal(un, En, K)


def _level_times(dev, errs):
    """K1 and K4 at every level of the 257^3 hierarchy (K1 also at
    65x33x33), K3 at the PDE filter's levels 257^3, 129^3 and 65^3, each
    held to the plain version, then timed as a graph of back-to-back
    launches replays it (the fused step's form), beside its bound."""
    from topopt_in_petsc_tpu_torch.ops.roofline import work

    levels = {"K1": (*LEVELS_257, (65, 33, 33)), "K4": LEVELS_257,
              "K3": PDE_LEVELS_257,
              "K1-bf16": ((513,) * 3, *LEVELS_257, (65, 33, 33))}
    for name, sizes in levels.items():
        for nn in sizes:
            kernel, plain = _level_case(name, nn, dev)
            errs[name] = max(errs[name], _compare(
                f"{name} {nn}", kernel(), plain(), "4 times",
                rtol=BF16_RTOL if name == "K1-bf16" else RTOL))
            torch.cuda.empty_cache()
            n = max(1, min(200, int(5e8 // work(name, nn)[0])))
            ms = _graph_ms(kernel, n)
            b, by, share = _share(name, nn, ms)
            log(f"[4 times] {name} {'x'.join(map(str, nn))}: {ms:.5f} ms "
                f"per launch (graph of {n}), bound {b:.5f} ms ({by}), "
                f"{100 * share:.1f}% of the bound")
            del kernel, plain
            torch.cuda.empty_cache()


def phase_kernel_times(dev, errs):
    """Times at 257^3 (kernel, plain), after holding each kernel's output
    to the plain version's on the same inputs; `errs` grows to the
    largest error seen."""
    from topopt_in_petsc_tpu_torch.ops.blocked_hex import hex_operator
    from topopt_in_petsc_tpu_torch.ops.quadform import quadform

    nn = (257, 257, 257)
    KE, vb, E = _case(nn, 7, dev)
    errs["K1"] = max(errs["K1"], _compare(
        f"K1 {nn}", hex_operator(vb, E, KE, True),
        _plain_k1(vb, E, KE, True), "4 times"))
    k1 = _graph_ms(lambda: hex_operator(vb, E, KE, True), 1)
    p1 = _median_ms([lambda: _plain_k1(vb, E, KE, True)])[0]
    u = vb.permute(1, 2, 3, 0).contiguous()
    errs["K2"] = max(errs["K2"], _compare(
        f"K2 {nn}", quadform(u, KE), _plain_k2(u, KE), "4 times"))
    k2 = _graph_ms(lambda: quadform(u, KE), 1)
    p2 = _median_ms([lambda: _plain_k2(u, KE)])[0]
    log(f"[4 times] 257^3 K1 hex_operator {k1:.4f} ms, plain {p1:.4f} ms")
    log(f"[4 times] 257^3 K2 quadform {k2:.4f} ms, plain {p2:.4f} ms")
    del vb, E, u
    torch.cuda.empty_cache()
    KE, vh, Eh = _bf16_case(nn, 7, dev)
    errs["K1-bf16"] = max(errs["K1-bf16"], _compare(
        f"K1-bf16 {nn}", hex_operator(vh, Eh, KE, True),
        _plain_k1_bf16(vh, Eh, KE, True), "4 times", rtol=BF16_RTOL))
    kb = _graph_ms(lambda: hex_operator(vh, Eh, KE, True), 1)
    pb = _median_ms([lambda: _plain_k1_bf16(vh, Eh, KE, True)])[0]
    log(f"[4 times] 257^3 K1-bf16 hex_operator {kb:.4f} ms, plain "
        f"{pb:.4f} ms")
    del vh, Eh
    torch.cuda.empty_cache()
    times = {"K1": (k1, p1), "K2": (k2, p2), "K1-bf16": (kb, pb)}
    for name, (dof, wrapper) in _nodal_wrappers().items():
        K, un, En = _nodal_case(nn, 8, dev, dof)
        errs[name] = max(errs[name], _compare(
            f"{name} {nn}", wrapper(un, En, K), _plain_nodal(un, En, K),
            "4 times"))
        times[name] = (_graph_ms(lambda: wrapper(un, En, K), 1),
                       _median_ms([lambda: _plain_nodal(un, En, K)])[0])
        log(f"[4 times] 257^3 {name} {wrapper.__name__} "
            f"{times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms")
        del un, En
        torch.cuda.empty_cache()
    _level_times(dev, errs)
    return times


def _run_cli(args, workdir):
    from topopt_in_petsc_tpu_torch.__main__ import main

    rc = main([*args, "-workdir", workdir])
    if rc != 0:
        raise RuntimeError(f"CLI run {args} returned {rc}")
    with np.load(os.path.join(workdir, "history.npz")) as h:
        return {k: h[k] for k in h.files}


def phase_default_run():
    kernels = _kernel_objects()
    ref = _load_history("jax_cpu_history_65x33x33.npz")
    with tempfile.TemporaryDirectory() as tmp:
        for k in kernels.values():
            k.launches = 0
        h = _run_cli(["-maxItr", "10"], tmp)
        torch.cuda.synchronize()
        launches = {n: kernels[n].launches for n in ("K1", "K2")}
        files = set(os.listdir(tmp))
    log(f"[5 default] launches over the run: {launches}")
    for name in ("output_00001.vtu", "output_00011.vtu", "Restart00.npz",
                 "Restart01.npz", "RestartSol00.npz"):
        if name not in files:
            raise AssertionError(f"{name} was not written")
    _check_history("5 default", h, ref, launches)
    return launches


def _check_history(tag, h, ref, launches, iters_within=None):
    """Hold a 10-iteration history to the JAX package's CPU history and
    every kernel of the path to at least one launch."""
    if len(h["fx"]) != 10 or not all(
            np.isfinite(h[k]).all() for k in ("fx", "gx", "ch", "mnd")):
        raise AssertionError(f"bad history: {h}")
    dfx = np.max(np.abs(h["fx"] - ref["fx"]) / np.abs(ref["fx"]))
    dgx = np.max(np.abs(h["gx"] - ref["gx"]))
    dch = np.max(np.abs(h["ch"] - ref["ch"]))
    dit = int(np.max(np.abs(h["iters"] - ref["iters"])))
    log(f"[{tag}] vs JAX CPU history: fx max rel {dfx:.3e} "
        f"(bar {FX_RTOL}), gx max abs {dgx:.3e} (bar {GX_ATOL}), "
        f"ch max abs {dch:.3e} (bar {CH_ATOL}), solver iterations max "
        f"diff {dit} (bar {iters_within})")
    log(f"[{tag}] s/iteration {h['time'].tolist()}, "
        f"solver iterations {h['iters'].tolist()}")
    if not (dfx <= FX_RTOL and dgx <= GX_ATOL and dch <= CH_ATOL):
        raise AssertionError(f"{tag} run disagrees with the JAX history")
    if iters_within is not None and dit > iters_within:
        raise AssertionError(f"{tag} solver iterations off the history")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")


def _load_history(name):
    with np.load(os.path.join(REPO, "docs", name)) as r:
        return {k: r[k] for k in r.files}


def _kernel_objects():
    from topopt_in_petsc_tpu_torch.ops.blocked_hex import (
        HEX_OPERATOR,
        HEX_OPERATOR_BF16,
    )
    from topopt_in_petsc_tpu_torch.ops.nodal_hex import HELMHOLTZ, NODAL_HEX
    from topopt_in_petsc_tpu_torch.ops.quadform import QUADFORM

    return {"K1": HEX_OPERATOR, "K2": QUADFORM, "K3": HELMHOLTZ,
            "K4": NODAL_HEX, "K1-bf16": HEX_OPERATOR_BF16}


def phase_path_run(tag, args, history, names, iters_within=None):
    """One 10-iteration 65x33x33 run of a path through the CLI entry, with
    the launch counts of its kernels `names` over that run."""
    kernels = _kernel_objects()
    ref = _load_history(history)
    with tempfile.TemporaryDirectory() as tmp:
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        h = _run_cli([*args, "-maxItr", "10", "-output_cadence_vtu", "0"],
                     tmp)
        torch.cuda.synchronize()
        launches = {n: kernels[n].launches for n in names}
    log(f"[{tag}] launches over the run: {launches}; the run took "
        f"{time.perf_counter() - t0:.1f} s; the f32 history's solver "
        f"iterations {ref['iters'].tolist()}")
    _check_history(tag, h, ref, launches, iters_within)
    return launches


def _size_args(n):
    return ["-nx", str(n), "-ny", str(n), "-nz", str(n), "-nlvls", "5"]


def phase_real_size(tag="6 257^3", args=()):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        h = _run_cli([*_size_args(257), "-maxItr", "2",
                      "-output_cadence_vtu", "0", *args], tmp)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    d = abs(h["fx"][0] - GOLDEN_257_FX1) / GOLDEN_257_FX1
    log(f"[{tag}] fx {h['fx'].tolist()}, it.1 rel diff to golden "
        f"{d:.3e}, s/iteration {h['time'].tolist()}, solver iterations "
        f"{h['iters'].tolist()} (golden it.1: 27), stalled "
        f"{h['stalled'].tolist()}, max_memory_allocated {peak} B "
        f"({peak / 2**30:.2f} GiB)")
    if len(h["fx"]) != 2 or not np.isfinite(h["fx"]).all():
        raise AssertionError(f"bad history: {h}")
    if d > 1e-3 or h["stalled"].any():
        raise AssertionError("257^3 run off the golden or stalled")
    return h["time"].tolist()


# -- the fused driver (-fused 1) ------------------------------------------- #

def phase_graph_eager(tag="13 graph=eager", **options):
    """The fused step replayed from its CUDA graphs against the same stage
    functions run eagerly, 4 iterations at 65x33x33, with the
    configuration `options`."""
    from topopt_in_petsc_tpu_torch.config import TopOptConfig
    from topopt_in_petsc_tpu_torch.parallel.fused_step import (
        make_fused_step,
    )

    runs = []
    for graphs in (True, False):
        step, state = make_fused_step(TopOptConfig(fused=True, **options),
                                      graphs=graphs)
        for itr in range(1, 5):
            step(state, itr)
        torch.cuda.synchronize()
        if (step.graphs is not None) != graphs:
            raise AssertionError("the steady variant was not captured")
        runs.append((step, state))
    (step, got), (_, ref) = runs
    rel = {f: float(torch.max(torch.abs(getattr(got, f) - getattr(ref, f)))
                    / torch.max(torch.abs(getattr(ref, f))))
           for f in ("fx", "gx", "ch", "mnd", "x")}
    its = (int(got.solver_iters), int(ref.solver_iters))
    log(f"[{tag}] {len(step.graphs)} graphs; max rel diff "
        f"{ {k: f'{v:.2e}' for k, v in rel.items()} }, solver iterations "
        f"{its[0]} and {its[1]} at iteration 4")
    if max(rel.values()) > 1e-6 or its[0] != its[1]:
        raise AssertionError("graph replay differs from the eager step")


def _fused_driver(size_args, maxItr, args=()):
    from topopt_in_petsc_tpu_torch.config import TopOptConfig
    from topopt_in_petsc_tpu_torch.fused_driver import FusedDriver

    return FusedDriver(TopOptConfig.from_args([
        *size_args, "-fused", "1", "-maxItr", str(maxItr),
        "-output_cadence_vtu", "0", "-restart", "0", *args]))


def phase_fused_real_size(split_times, tag="14 fused 257^3", args=()):
    """4 fused iterations at 257^3 of the path `args`; returns the driver,
    for the profile, and its s/iteration."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    d = _fused_driver(_size_args(257), 5, args)
    setup = time.perf_counter() - t0
    h = d.run(4)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    d1 = abs(h["fx"][0] - GOLDEN_257_FX1) / GOLDEN_257_FX1
    log(f"[{tag}] fx {h['fx']}, it.1 rel diff to golden "
        f"{d1:.3e}, s/iteration {h['time']} (beside: "
        f"{split_times}), solver iterations {h['iters']}, stalled "
        f"{h['stalled']}, max_memory_allocated {peak} B "
        f"({peak / 2**30:.2f} GiB), graphs {d.step.graphs is not None}, "
        f"driver set up in {setup:.1f} s")
    if (len(h["fx"]) != 4 or not np.isfinite(h["fx"]).all() or d1 > 1e-3
            or any(h["stalled"]) or d.step.graphs is None):
        raise AssertionError(f"{tag} run off the golden, stalled or not "
                             "captured")
    return d, h["time"]


def _bound(name, ms):
    """The kernels line's bound of `name` at phase 4's 257^3 inputs, run
    in `ms`.  No single PyTorch call computes any of K1-K4, so no library
    time: in K1 and K4 E varies per element, which no convolution
    expresses; K2's form is quadratic in u, where a convolution is
    linear; a convolution gives K3's interior rows only."""
    b, by, _ = _share(name, (257,) * 3, ms)
    return {"bound_ms": b, "bound_by": by, "library_ms": None}


# the device's records in a trace: kernels, copies, fills
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernelEx", "cudaGraphLaunch")
# each kernel's device function, demangled or mangled (csrc/*.cu)
_DEVICE_NAMES = {
    "K1": ("hex_operator_kernel",),
    "K2": ("quadform_kernel",),
    "K3": ("helmholtz_kernel",),
    "K4": ("nodal_hex_kernel",),
    "K1-bf16": ("hex_operator_bf16_kernel",),
}


def _grid_query(name):
    """The launch-grid query of the operator kernel `name`."""
    from topopt_in_petsc_tpu_torch.ops.blocked_hex import hex_operator_grid
    from topopt_in_petsc_tpu_torch.ops.nodal_hex import (
        helmholtz_grid,
        nodal_hex_grid,
    )

    return {"K1": hex_operator_grid, "K3": helmholtz_grid,
            "K4": nodal_hex_grid,
            "K1-bf16": lambda nn: hex_operator_grid(nn, torch.bfloat16),
            }[name]


def _trace(prof):
    """The events of a profile as its chrome trace records them: read
    several times faster than `prof.events()` builds its event tree."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def _by_level(kernels, levels):
    """Runs and device ms of each operator kernel of `levels` (name ->
    grid sizes) among the device's `kernels` (trace events), grouped by
    launch grid and named by the level that launches with that grid."""
    out = {}
    for name, sizes in levels.items():
        query = _grid_query(name)
        names = {query(nn): "x".join(map(str, nn)) for nn in sizes}
        by = {}
        for e in kernels:
            if not any(s in e["name"] for s in _DEVICE_NAMES[name]):
                continue
            grid = tuple(e.get("args", {}).get("grid", ()))
            key = names.get(grid, f"grid {list(grid)}")
            runs, us = by.get(key, (0, 0.0))
            by[key] = (runs + 1, us + float(e.get("dur", 0.0)))
        out[name] = {k: {"runs": r, "device_ms": round(us / 1e3, 4)}
                     for k, (r, us) in by.items()}
    return out


def _profile(run_once, levels=None):
    """Counts of one profiled call: host launch calls (graph launches
    included), kernels and device-to-host copies on the device, host
    synchronizations, wall and device-busy seconds, idle share, and the
    executions of K1-K4 that the device recorded, held equal to the
    growth of the wrappers' launch counts over the same call (graph
    replays included); with `levels` (kernel name -> grid sizes), those
    kernels' runs and device time per level."""
    from torch.profiler import ProfilerActivity, profile

    kernels = _kernel_objects()
    torch.cuda.synchronize()
    before = {n: k.launches for n, k in kernels.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    ev = [e for e in _trace(prof) if "name" in e]
    dev = [e for e in ev if e.get("cat") in _DEVICE_CATS]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in dev)
    busy, end = 0.0, -1.0
    for a, b in spans:  # union of the device intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    busy *= 1e-6
    on_gpu = [e for e in dev if e["cat"] == "kernel"]
    counted = {n: k.launches - before[n] for n, k in kernels.items()}
    on_device = {n: sum(any(s in e["name"] for s in names) for e in on_gpu)
                 for n, names in _DEVICE_NAMES.items()}
    if counted != on_device or not any(counted.values()):
        raise AssertionError(f"launch counts {counted} differ from the "
                             f"kernels the device ran {on_device}")
    host = [e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    by_level = {"by_level": _by_level(on_gpu, levels)} if levels else {}
    return {
        **by_level,
        "kernel_runs": on_device,
        "launch_calls": sum(e["name"] in _LAUNCH_CALLS for e in host),
        "graph_launches": sum(e["name"] == "cudaGraphLaunch" for e in host),
        "device_kernels": len(on_gpu),
        "d2h_copies": sum("DtoH" in e["name"] for e in dev),
        "syncs": sum(e["name"].endswith("Synchronize") for e in host),
        "wall_s": round(wall, 4), "busy_s": round(busy, 4),
        "idle_share": round(1.0 - busy / wall, 3),
        # host seconds spent reading the profile after the window
        "read_s": round(time.perf_counter() - t1, 1),
    }


def phase_profiles(fused_257):
    """One steady iteration of each driver under torch.profiler, at
    65x33x33 and 257^3: the split driver's iteration 2, the fused
    driver's iteration 5 (its second replay)."""
    from topopt_in_petsc_tpu_torch.config import TopOptConfig
    from topopt_in_petsc_tpu_torch.driver import Driver

    for size, size_args in (("65x33x33", []), ("257^3", _size_args(257))):
        split = Driver(TopOptConfig.from_args([
            *size_args, "-maxItr", "2", "-output_cadence_vtu", "0",
            "-restart", "0"]))
        split.run(1)
        counts = {"split": _profile(lambda: split.run(2))}
        del split
        if size_args:
            fused, fused_257 = fused_257, None
        else:
            fused = _fused_driver(size_args, 5)
            fused.run(4)
        counts["fused"] = _profile(lambda: fused.run(5),
                                   {"K1": LEVELS_257} if size_args else None)
        del fused
        torch.cuda.empty_cache()
        for k, c in counts.items():
            log(f"[15 profile] {size} {k}: {json.dumps(c)}")


def phase_fused_paths_257(split_times):
    """The fused nodal and -filter 2 paths at 257^3: 4 iterations each as
    phase 14, then one steady iteration (iteration 5, the second replay)
    under torch.profiler, with K4's (nodal) and K3's (-filter 2) runs and
    device time per level."""
    paths = {
        "nodal": (["-operator_impl", "pallas"], {"K4": LEVELS_257}),
        "filter 2": (["-filter", "2"],
                     {"K3": PDE_LEVELS_257, "K1": LEVELS_257}),
    }
    for tag, (args, levels) in paths.items():
        d, _ = phase_fused_real_size(split_times[tag],
                                     f"14 fused 257^3 {tag}", args)
        c = _profile(lambda: d.run(5), levels)
        log(f"[15 profile] 257^3 fused {tag}: {json.dumps(c)}")
        del d
        torch.cuda.empty_cache()


# -- the reduced-precision V-cycle (-mg_dtype bfloat16|mixed) --------------- #

BF16 = ["-mg_dtype", "bfloat16"]
# the f32 history of the split and the fused driver
SPLIT_HISTORY = "jax_cpu_history_65x33x33.npz"
FUSED_HISTORY = "jax_cpu_history_65x33x33_fused.npz"


def phase_bf16_runs():
    """The bf16 V-cycle at 65x33x33, 10 iterations through the CLI entry:
    split and fused on the resident and the nodal path, `mixed` and
    `-mg_fine_post 1`, each held to the f32 history of its driver; then
    graph = eager for the fused bf16 step.  Returns the kernel launches of
    the fused resident bf16 run, this slice's path."""
    runs = {
        "split": (BF16, SPLIT_HISTORY, ("K1", "K1-bf16", "K2")),
        "split nodal": ([*BF16, "-operator_impl", "pallas"], SPLIT_HISTORY,
                        ("K4", "K2")),
        "fused": ([*BF16, "-fused", "1"], FUSED_HISTORY,
                  ("K1", "K1-bf16", "K2")),
        "fused nodal": ([*BF16, "-fused", "1", "-operator_impl", "pallas"],
                        FUSED_HISTORY, ("K4", "K2")),
        "split mixed": (["-mg_dtype", "mixed"], SPLIT_HISTORY,
                        ("K1", "K1-bf16", "K2")),
        "fused mg_fine_post 1": ([*BF16, "-mg_fine_post", "1", "-fused",
                                  "1"], FUSED_HISTORY,
                                 ("K1", "K1-bf16", "K2")),
    }
    launches = None
    for name, (args, history, names) in runs.items():
        got = phase_path_run(f"16 bf16 {name}", args, history, names)
        if name == "fused":
            launches = got
    phase_graph_eager("16 bf16 graph=eager", mg_dtype="bfloat16")
    return launches


def phase_bf16_257(fused_f32_times):
    """The bf16 V-cycle at 257^3: 2 split iterations (phase 6 with
    -mg_dtype bfloat16, then mixed and with -mg_fine_post 2) and 4 fused
    (phase 14 with -mg_dtype bfloat16, the times beside phase 14's f32
    ones), then one steady fused iteration under torch.profiler with K1's
    and K1-bf16's runs and device time per level."""
    phase_real_size("17 bf16 257^3 split", BF16)
    phase_real_size("17 mixed 257^3 split", ["-mg_dtype", "mixed"])
    phase_real_size("17 bf16 mg_fine_post 2 257^3 split",
                    [*BF16, "-mg_fine_post", "2"])
    d, _ = phase_fused_real_size(f"f32 {fused_f32_times}",
                                 "17 bf16 257^3 fused", BF16)
    c = _profile(lambda: d.run(5), {"K1": LEVELS_257[:1],
                                    "K1-bf16": LEVELS_257})
    log(f"[17 profile] 257^3 fused bf16: {json.dumps(c)}")
    del d
    torch.cuda.empty_cache()


def phase_513():
    """The one-card 513^3 recipe (405M dof): one split-driver iteration of
    -nlvls 6 -smooth_sweeps 2 in f32 (-mg_dtype same) and with the bf16
    V-cycle; fx agree to 1e-3, peak memory and seconds of each.  The f32
    run must resolve to the f32 V-cycle (config.MG_BF16_DOF)."""
    import gc

    from topopt_in_petsc_tpu_torch.config import TopOptConfig

    args = ["-nx", "513", "-ny", "513", "-nz", "513", "-nlvls", "6",
            "-smooth_sweeps", "2", "-maxItr", "1", "-output_cadence_vtu",
            "0", "-restart", "0"]
    out = {}
    for mode in ("same", "bfloat16"):
        cfg = TopOptConfig.from_args([*args, "-mg_dtype", mode])
        resolved = cfg.resolve_mg_mode(cfg.ndof)
        if resolved != mode:
            raise AssertionError(f"513^3 -mg_dtype {mode} resolves to "
                                 f"{resolved}")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            h = _run_cli([*args, "-mg_dtype", mode], tmp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        out[mode] = h
        log(f"[18 513^3 {mode}] fx {h['fx'].tolist()}, solver iterations "
            f"{h['iters'].tolist()}, stalled {h['stalled'].tolist()}, "
            f"s/iteration {h['time'].tolist()}, command {wall:.1f} s, "
            f"cheby_lower {cfg.resolve_cheby_lower(cfg.ndof)}, "
            f"max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB, "
            f"{peak / cfg.ndof:.1f} B per dof)")
        if (not np.isfinite(h["fx"]).all() or h["stalled"].any()):
            raise AssertionError(f"513^3 {mode} run stalled or not finite")
    f32, bf = out["same"]["fx"][0], out["bfloat16"]["fx"][0]
    rel = abs(bf - f32) / abs(f32)
    log(f"[18 513^3] bf16 fx {bf} against f32 fx {f32}: rel {rel:.3e} "
        f"(bar 1e-3)")
    if rel > 1e-3:
        raise AssertionError("513^3 bf16 fx off the f32 fx")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import topopt_in_petsc_tpu_torch  # noqa: F401  (sets TF32 off)

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()

    def done(phase):
        log(f"[time] phase {phase} done at {time.perf_counter() - t0:.1f} s")

    phase_environment()
    phase_build()
    done(2)
    errs = phase_parity(dev)
    done(3)
    times = phase_kernel_times(dev, errs)
    done(4)
    phase_default_run()
    done(5)
    split_times = {"default": phase_real_size()}
    done(6)
    phase_path_run("7 filter 2", ["-filter", "2"],
                   "jax_cpu_history_65x33x33_filter2.npz",
                   ("K1", "K2", "K3"))
    phase_path_run("8 nodal", ["-operator_impl", "pallas"],
                   "jax_cpu_history_65x33x33.npz", ("K4", "K2"),
                   iters_within=1)
    done(8)
    split_times["filter 2"] = phase_real_size("9 257^3 filter 2",
                                              ["-filter", "2"])
    split_times["nodal"] = phase_real_size(
        "9 257^3 nodal", ["-operator_impl", "pallas"])
    done(9)
    # the fused paths: this slice's main path, whose counts the kernel
    # line reports
    launches = phase_path_run(
        "10 fused", ["-fused", "1"], "jax_cpu_history_65x33x33_fused.npz",
        ("K1", "K2"))
    launches["K4"] = phase_path_run(
        "11 fused nodal", ["-fused", "1", "-operator_impl", "pallas"],
        "jax_cpu_history_65x33x33_fused.npz", ("K4", "K2"),
        iters_within=1)["K4"]
    launches["K3"] = phase_path_run(
        "12 fused filter 2", ["-fused", "1", "-filter", "2"],
        "jax_cpu_history_65x33x33_fused_filter2.npz",
        ("K1", "K2", "K3"))["K3"]
    done(12)
    phase_graph_eager()
    done(13)
    fused_257, fused_times = phase_fused_real_size(split_times["default"])
    phase_profiles(fused_257)
    del fused_257
    done("14-15 default")
    phase_fused_paths_257(split_times)
    done("14-15 nodal and filter 2")
    launches["K1-bf16"] = phase_bf16_runs()["K1-bf16"]
    done(16)
    phase_bf16_257(fused_times)
    done(17)
    phase_513()
    done(18)
    src = "topopt_in_petsc_tpu_torch/csrc/"
    kernels = [
        {"name": "hex_operator (K1)", "route": "cuda",
         "source": src + "hex_operator.cu",
         "replaces": "topopt_in_petsc_tpu/ops/blocked_hex.py:65",
         "launches": launches["K1"], "max_abs_err": errs["K1"],
         "ms": times["K1"][0], "plain_ms": times["K1"][1],
         **_bound("K1", times["K1"][0])},
        {"name": "quadform (K2)", "route": "cuda",
         "source": src + "quadform.cu",
         "replaces": "topopt_in_petsc_tpu/ops/pallas_hex.py:274",
         "launches": launches["K2"], "max_abs_err": errs["K2"],
         "ms": times["K2"][0], "plain_ms": times["K2"][1],
         **_bound("K2", times["K2"][0])},
        {"name": "helmholtz (K3)", "route": "cuda",
         "source": src + "nodal_hex.cu",
         "replaces": "topopt_in_petsc_tpu/ops/pallas_hex.py:416",
         "launches": launches["K3"], "max_abs_err": errs["K3"],
         "ms": times["K3"][0], "plain_ms": times["K3"][1],
         **_bound("K3", times["K3"][0])},
        {"name": "nodal_hex (K4)", "route": "cuda",
         "source": src + "nodal_hex.cu",
         "replaces": "topopt_in_petsc_tpu/ops/pallas_hex.py:59",
         "launches": launches["K4"], "max_abs_err": errs["K4"],
         "ms": times["K4"][0], "plain_ms": times["K4"][1],
         **_bound("K4", times["K4"][0])},
        {"name": "hex_operator bf16 (K1 bf16)", "route": "cuda",
         "source": src + "hex_operator.cu",
         "replaces": "topopt_in_petsc_tpu/ops/blocked_hex.py:65",
         "launches": launches["K1-bf16"], "max_abs_err": errs["K1-bf16"],
         "ms": times["K1-bf16"][0], "plain_ms": times["K1-bf16"][1],
         **_bound("K1-bf16", times["K1-bf16"][0])},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
