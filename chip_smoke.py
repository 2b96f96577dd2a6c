#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (topopt_in_petsc_tpu_torch) on one
NVIDIA GPU.  Run from the repository root:  python3 chip_smoke.py

Phases, each printing its lines before the next starts:
  1. environment: torch and CUDA versions, device name, nvidia-smi's name
     and power limit;
  2. build: the hand-written kernels K1-K4 with nvcc, and its time;
  3. kernel parity: each kernel against its plain PyTorch version on the
     card at 9x7x5, 65x33x33, 13x11x7, the tile edges 9x9x33 and
     13x11x37, and the coarse levels 17^3 and 33^3, then on every local
     block that phases 21-25's meshes give a kernel at any level, with
     the element matrix of the level's global grid (129x257x257 down to
     9x17x17 of 257^3 on mesh (2,1,1), 17x9x9, 9x5x5 and 5x3x3 of
     33x17x17 on (2,2,2), 9x9x9 and 5x5x5 of 33x17x9 on (4,2,1) and of
     17^3 on (2,2,2), 17x9x17, 9x5x9 and 5x3x5 of 33x17x17 on (2,2,1),
     9x9x9 and 5x5x5 of 17x9x9 on (2,1,1)); K1 with and without the
     x = 0 mask, as the ranks at x-coordinate 0 and the others run it)
     (rtol 2e-5, atol 1e-5 of max|ref|, the JAX package's bar for its Pallas kernels; K1's
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
 15. a torch.profiler window (utils/profiling.py `trace_to`, which
     `-profile_dir` runs) over one steady iteration of the split and
     of the fused driver at 65x33x33 and at 257^3, and of the fused nodal
     and -filter 2 paths at 257^3: host launch calls, kernels on the
     device, device-to-host copies, host synchronizations, and the
     device's idle share; and the runs of K1-K4 the device recorded in
     each window, which must equal the growth of their launch counts
     over it; in the fused 257^3 windows, the runs and device time per
     multigrid level of K1 (default and -filter 2), K4 (nodal) and K3
     (-filter 2), told apart by the launch grid; in the fused default
     257^3 window also the 20 kernels with the most device time, and the
     device ms of one state-solve trip from its graph;
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
     1e-3, solver iterations, peak memory and seconds;
 19. the remaining single-device options at 65x33x33 for 10 iterations,
     each against the JAX package's CPU history with its flags (solver
     iterations within 1): -ksp_type fgmres (resident, nodal, fused),
     -dtype float64 (split, fused), -operator_impl xla and -coarse_op
     galerkin_octant, with the launch counts of their kernels (none on
     the float64 and xla paths, which run the plain operators as the JAX
     package's XLA code does); a profiled steady fused iteration of the
     nodal FGMRES and the galerkin paths with K4's runs per level; graph =
     eager for fused FGMRES (also with a restart every 4 iterations) and
     fused float64;
 20. those options at 257^3: one split iteration each of FGMRES and
     galerkin_octant held to the golden iteration-1 compliance, of
     float64 on the element matrices rounded to f32, held to the golden
     (an f32 run), and of float64 on the exact matrices, held within 5e-2
     of that run (the rounding's measured effect); solver iterations,
     seconds and peak memory of each; 4 fused FGMRES iterations as phase
     14 and a profiled steady one with K1's runs and device time per
     level and the 20 kernels with the most device time; the device ms of
     an Arnoldi trip and of a cycle close, and of a trip's Krylov part
     alone (A and M the identity) beside its Gram-Schmidt's bytes bound;
 21. the multi-device engine (-mesh_shape), its ranks sharing the card
     over gloo: the CLI in a subprocess (which spawns its ranks) under a
     300 s timeout, for the three variants of the JAX package's
     __graft_entry__.py::dryrun_multichip at 8 ranks, 2 iterations each,
     with its f32 sums (-precise_dots 0):
     mesh (2,2,2) 33x17x17 3 levels on the default route (K1) and on
     -operator_impl pallas (K4), mesh (4,2,1) 33x17x9 with -filter 2
     -projectionFilter 1 -beta 1 (K1, K3), mesh (2,2,2) 17x17x17 on
     -operator_impl blocked; each held to the single-card -fused 1 run
     with its flags (fx within 1e-4 at iteration 1 and 1e-3 at every
     iteration, solver iterations within 1, never stalled), with every
     rank's launches of the route's kernels above 0 (each rank's own
     counts, from its "# rank r launches" line);
 22. 257^3 on mesh (2,1,1) (129x257x257 nodes per rank), 2 iterations of
     the default route: iteration-1 compliance within 1e-3 of the golden,
     solver iterations within 1 of its 27, K1 and K2 launched on both
     ranks, s/iteration beside phase 6's and each rank's peak memory;
 23. the single-device solvers' options on a mesh: 33x17x17 on mesh
     (2,2,1), 4 ranks, 3 iterations each of -mg_dtype bfloat16, -mg_dtype
     mixed -mg_fine_post 2, -coarse_op galerkin_octant, -ksp_type fgmres
     (resident) and -ksp_type fgmres -operator_impl pallas, each held to
     the single-card -fused 1 run as phase 21's, every rank launching its
     route's kernels (K1-bf16 under bf16, K4 under galerkin);
 24. 257^3 on mesh (2,1,1), iteration 1 of -mg_dtype bfloat16 and of
     -ksp_type fgmres: fx within 1e-3 of the golden, solver iterations
     within 12 of the single card's 83 (bf16) and within 1 of its 18
     (FGMRES), s/iteration, peak memory and communication by rank;
 25. -profile_dir: the fused 65x33x33 run, 4 iterations, traced (device
     events of K1 and K2 in the trace, fx on its history), 17x9x9 on mesh
     (2,1,1) with one trace per rank (K1's device events in each),
     utils' speed_of_light_spmv for phase 4's 257^3 K1 time beside
     ops/roofline.py's bound, and the fused -filter 2 step's PDE-solve
     iterations against the eager solves of the same fields;
 26. the output and restart path at 257^3, run right after phases 14-15
     of the default path, whose history it reads: the CLI entry with
     phase 14's flags (-fused 1); run A, 1 iteration with every output on
     (.vtu at the default cadence, -output_dat 1, the restart pair), its
     fx within 1e-3 of the golden and the .dat holding the datasets of
     iterations 1 and 2; run B, a resume from A's restart pair to -maxItr
     4 with no .vtu, which prints "# Continue optimization" and matches
     phase 14's iterations 2-4 to 1e-6 relative (fx, gx, ch, mnd) with
     the same solver iterations, its iteration 3 the one that captures
     the graphs; then tools/torch_bin2vtu.py on A's .dat, in a directory
     of its own, whose ux, uy, uz, x, xTilde and xPhys equal those of the
     driver's output_00002.vtu bit for bit.  One line gives each write's
     seconds, each file's bytes, the free space before the run, the
     host's peak RSS and the tool's seconds and peak RSS.  Files are
     deleted as they are checked; a temporary directory without room for
     them fails the phase and says how much it needs.
 27. the mesh's output and restart path at 257^3 on (2,1,1), run right
     after phase 22, whose history is its uninterrupted reference: run A,
     launched by torchrun (`python -m torch.distributed.run --standalone
     --nproc_per_node 2 -m topopt_in_petsc_tpu_torch ... -mesh_shape
     2,1,1`), 1 iteration with every output on (.vtu at the default
     cadence, -output_dat 1, the restart pair), its iteration 1 within
     1e-6 of phase 22's (fx, gx, ch, mnd, each scaled by its largest value
     over phase 22's run) with the same solver iterations, within 1e-3 of
     the golden in 27 +- 1, exactly the six files written and the .dat
     holding iterations 1 and 2; run B, the spawn launch resuming A's
     restart pair to -maxItr 2 with no .vtu, which prints "# Continue
     optimization" and whose iteration 2 is within 1e-6 of phase 22's with
     the same solver iterations; run C, one card under -fused 1 (the CLI
     entry in this process) resuming the same pair, fx within 1e-3 of
     phase 22's iteration 2, solver iterations within 1, never stalled;
     then tools/torch_bin2vtu.py on A's .dat, whose six arrays equal A's
     output_00002.vtu bit for bit; K1 and K2 launched on both ranks of A
     and B.  One line gives each run's seconds, A's beyond phase 22's,
     each file's bytes and the tool's seconds and peak RSS; files are
     deleted as they are checked.
A failed mesh run prints its output's last lines (the launcher prints
every rank's last 40 on a failure) and raises.
A CUDA graph's replay counts the kernel launches it recorded
(ops/cuda_build.py); phase 15 holds that count to the device's own
record.  Then one JSON line of per-kernel results, whose
launch counts are the fused paths' (phases 10-12, K1-bf16's phase 16's
fused resident run; every kernel also carries `mesh_launches`, its
launches summed over the ranks of phases 21-24 and 27) and whose bounds are
topopt_in_petsc_tpu_torch/ops/roofline.py's for phase 4's inputs, and,
last, the JSON status line.  Any failure raises: the exit code is
nonzero and no status line is printed.  Nothing falls back to the CPU or
to a plain version.
"""

import contextlib
import json
import os
import re
import signal
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
# phases 21-25's meshes: (global nodes, mesh, levels); phase 3 holds the
# kernels to their plain versions on every level's local block
MESH_GRIDS = (((257, 257, 257), (2, 1, 1), 5), ((33, 17, 17), (2, 2, 2), 3),
              ((33, 17, 9), (4, 2, 1), 2), ((17, 17, 17), (2, 2, 2), 2),
              ((33, 17, 17), (2, 2, 1), 3), ((17, 9, 9), (2, 1, 1), 2))
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
GOLDEN_257_ITERS1 = 27  # its solver iterations at iteration 1
# the multi-device runs (phases 21-22): the CLI's flags of each variant of
# __graft_entry__.py::dryrun_multichip, and the kernels of its route
MESH_TIMEOUT = 300
MESH_VARIANTS = (
    ("21 deep", ["-nx", "33", "-ny", "17", "-nz", "17", "-nlvls", "3",
                 "-rmin", "0.16"], "2,2,2", ("K1", "K2")),
    ("21 deep pallas", ["-nx", "33", "-ny", "17", "-nz", "17", "-nlvls",
                        "3", "-rmin", "0.16", "-operator_impl", "pallas"],
     "2,2,2", ("K4", "K2")),
    ("21 filter 2", ["-nx", "33", "-ny", "17", "-nz", "9", "-nlvls", "2",
                     "-rmin", "0.16", "-filter", "2", "-projectionFilter",
                     "1", "-beta", "1"], "4,2,1", ("K1", "K2", "K3")),
    ("21 blocked", ["-nx", "17", "-ny", "17", "-nz", "17", "-nlvls", "2",
                    "-rmin", "0.12", "-operator_impl", "blocked",
                    "-ksp_chunk", "2"], "2,2,2", ("K1", "K2")),
)
# a rank's launch-count line; searched for, not matched at the line's
# start, since another process's warning may still lack its newline when
# a rank writes its line into the same output
RANK_LINE = re.compile(r"# rank (\d+) launches (\{.*?\}) comm (\{.*?\})"
                       r"(?: max_memory_allocated (\d+))?$")
# |fx / fx_r - 1| of an f64 257^3 iteration 1 on the exact element
# matrices against one on the matrices rounded to f32: the rounding moves
# the compliance by 5.7e-4 at 65x33x33, 2.3e-3 at 129x65x65 and 3.49e-2 at
# 257^3 (tools/torch_f64_gap.py; PERF.md section 6)
F64_EXACT_GAP = 5e-2


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


def _case(nn, seed, dev, grid_nn=None):
    """(element matrix, v, E) of K1 on nn nodes; the element matrix is that
    of the grid of grid_nn nodes (default nn) on the 2x1x1 box."""
    from topopt_in_petsc_tpu_torch.grid import Grid
    from topopt_in_petsc_tpu_torch.models.elements import hex8_stiffness

    grid = Grid(nn=grid_nn or nn, lo=(0.0, 0.0, 0.0), hi=(2.0, 1.0, 1.0))
    KE = hex8_stiffness(*grid.h, 0.3)
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.normal(size=(3, *nn)), dtype=torch.float32,
                        device=dev)
    E = torch.as_tensor(rng.uniform(1e-9, 1.0, size=[n - 1 for n in nn]),
                        dtype=torch.float32, device=dev)
    return KE, u, E


def _nodal_case(nn, seed, dev, dof, grid_nn=None):
    """(element matrix, u, E) of K3 (dof 1) or K4 (dof 3) on nn nodes, the
    element matrix as `_case`'s."""
    from topopt_in_petsc_tpu_torch.grid import Grid
    from topopt_in_petsc_tpu_torch.models.elements import (
        helmholtz_element_matrices,
        hex8_stiffness,
    )

    grid = Grid(nn=grid_nn or nn, lo=(0.0, 0.0, 0.0), hi=(2.0, 1.0, 1.0))
    if dof == 1:  # the default rmin 0.08, R = rmin / (2 sqrt 3)
        KE = helmholtz_element_matrices(*grid.h, 0.08 / (2 * 3**0.5))[0]
    else:
        KE = hex8_stiffness(*grid.h, 0.3)
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.normal(size=(*nn, dof)), dtype=torch.float32,
                        device=dev)
    E = torch.as_tensor(rng.uniform(1e-3, 1.0, size=[n - 1 for n in nn]),
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


def _bf16_case(nn, seed, dev, grid_nn=None):
    """K1-bf16's inputs: K1's, rounded to bf16."""
    KE, u, E = _case(nn, seed, dev, grid_nn)
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


def _mesh_blocks():
    """(local block nodes, level grid nodes) of every level of MESH_GRIDS,
    each block once."""
    from topopt_in_petsc_tpu_torch.grid import Grid
    from topopt_in_petsc_tpu_torch.parallel.decomp import BlockDecomp

    blocks = []
    for nn, mesh, nlvls in MESH_GRIDS:
        d = BlockDecomp(Grid(nn=nn), mesh, nlvls)
        for l in range(nlvls):
            b = (d.local_nn(l), d.level_grid(l).nn)
            if b not in blocks:
                blocks.append(b)
    return blocks


def phase_parity(dev):
    from topopt_in_petsc_tpu_torch.ops.blocked_hex import hex_operator
    from topopt_in_petsc_tpu_torch.ops.quadform import quadform

    errs = {"K1": 0.0, "K2": 0.0, "K1-bf16": 0.0}
    cases = [(nn, None) for nn in PARITY_SHAPES] + _mesh_blocks()
    for i, (nn, grid_nn) in enumerate(cases):
        where = f"{nn}" if grid_nn is None else f"{nn} block of {grid_nn}"
        KE, vb, E = _case(nn, i, dev, grid_nn)
        _, vh, Eh = _bf16_case(nn, i, dev, grid_nn)
        for mask_x0 in (False, True):
            got = hex_operator(vb, E, KE, mask_x0)
            ref = _plain_k1(vb, E, KE, mask_x0)
            errs["K1"] = max(errs["K1"], _compare(
                f"K1 {where} mask_x0={mask_x0}", got, ref))
            errs["K1-bf16"] = max(errs["K1-bf16"], _compare(
                f"K1-bf16 {where} mask_x0={mask_x0}",
                hex_operator(vh, Eh, KE, mask_x0),
                _plain_k1_bf16(vh, Eh, KE, mask_x0), rtol=BF16_RTOL))
        u = vb.permute(1, 2, 3, 0).contiguous()
        errs["K2"] = max(errs["K2"], _compare(
            f"K2 {where}", quadform(u, KE), _plain_k2(u, KE)))
        for name, (dof, wrapper) in _nodal_wrappers().items():
            K, un, En = _nodal_case(nn, 10 + i, dev, dof, grid_nn)
            errs[name] = max(errs.get(name, 0.0), _compare(
                f"{name} {where}", wrapper(un, En, K),
                _plain_nodal(un, En, K)))
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
    if launches and min(launches.values()) <= 0:
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
    the launch counts of its kernels `names` over that run; with no
    `names`, a path on the plain operators, where no kernel may launch."""
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
        if not names and any(k.launches for k in kernels.values()):
            raise AssertionError(f"{tag}: a kernel launched on a plain path")
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
    for the profile, and its history."""
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
    return d, h


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


def _trace_events(logdir):
    """The events of the chrome trace that `utils/profiling.py::trace_to`
    wrote under `logdir`: read several times faster than `prof.events()`
    builds its event tree."""
    from topopt_in_petsc_tpu_torch.utils.profiling import TRACE_FILE

    with open(os.path.join(logdir, TRACE_FILE)) as f:
        return json.load(f).get("traceEvents", [])


def _device_kernels(events):
    """The kernels the device ran, among a trace's events."""
    return [e for e in events if e.get("cat") == "kernel" and "name" in e]


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


def _kernel_label(name):
    """A device kernel's name without its namespaces and argument list,
    cut to 140 characters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::",
                 "at::", "c10::", "std::"):
        name = name.replace(junk, "")
    return name.split("(")[0][:140]


def _by_name(kernels, top):
    """The `top` device kernels by device time: label -> [runs, ms]."""
    by = {}
    for e in kernels:
        k = _kernel_label(e["name"])
        runs, us = by.get(k, (0, 0.0))
        by[k] = (runs + 1, us + float(e.get("dur", 0.0)))
    ranked = sorted(by.items(), key=lambda kv: -kv[1][1])[:top]
    return {k: [r, round(us / 1e3, 3)] for k, (r, us) in ranked}


def _profile(run_once, levels=None, top=0):
    """Counts of one profiled call: host launch calls (graph launches
    included), kernels and device-to-host copies on the device, host
    synchronizations, wall and device-busy seconds, idle share, and the
    executions of K1-K4 that the device recorded, held equal to the
    growth of the wrappers' launch counts over the same call (graph
    replays included); with `levels` (kernel name -> grid sizes), those
    kernels' runs and device time per level; with `top`, the runs and
    device ms of the `top` kernels that took the most device time."""
    from topopt_in_petsc_tpu_torch.utils.profiling import trace_to

    kernels = _kernel_objects()
    torch.cuda.synchronize()
    before = {n: k.launches for n, k in kernels.items()}
    with tempfile.TemporaryDirectory() as tmp:
        with trace_to(tmp, torch.device("cuda", 0)):
            t0 = time.perf_counter()
            run_once()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            t1 = time.perf_counter()
        ev = [e for e in _trace_events(tmp) if "name" in e]
    dev = [e for e in ev if e.get("cat") in _DEVICE_CATS]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in dev)
    busy, end = 0.0, -1.0
    for a, b in spans:  # union of the device intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    busy *= 1e-6
    on_gpu = _device_kernels(dev)
    counted = {n: k.launches - before[n] for n, k in kernels.items()}
    on_device = {n: sum(any(s in e["name"] for s in names) for e in on_gpu)
                 for n, names in _DEVICE_NAMES.items()}
    if counted != on_device or not any(counted.values()):
        raise AssertionError(f"launch counts {counted} differ from the "
                             f"kernels the device ran {on_device}")
    host = [e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    by_level = {"by_level": _by_level(on_gpu, levels)} if levels else {}
    if top:
        by_level["by_name"] = _by_name(on_gpu, top)
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
        # host seconds spent closing the window (the trace written) and
        # reading the profile
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
        if size_args:
            counts["fused"] = _profile(lambda: fused.run(5),
                                       {"K1": LEVELS_257}, top=20)
            counts["fused"].update(_solver_stage_ms(fused.step))
        else:
            counts["fused"] = _profile(lambda: fused.run(5))
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


# -- the remaining single-device options ------------------------------------ #

FGMRES = ["-ksp_type", "fgmres"]
F64 = ["-dtype", "float64"]
GALERKIN = ["-coarse_op", "galerkin_octant"]


def phase_options_runs():
    """The single-device options at 65x33x33, 10 iterations through the
    CLI entry, each held to the JAX package's CPU history with the same
    flags (solver iterations within 1): FGMRES on the resident, nodal and
    fused paths, float64 split and fused, the plain nodal path
    (-operator_impl xla, whose history is the default one: the JAX
    package's CPU runs `auto` as `xla`) and octant-Galerkin coarse levels.
    The float64 and xla runs take the plain operators, so no kernel may
    launch there.  Then one steady fused iteration of the nodal FGMRES
    and the galerkin paths under torch.profiler, with K4's runs and
    device time per level, and graph = eager for fused FGMRES (also
    restarting every 4 iterations) and fused float64.  Returns the launches of the
    fused FGMRES run."""
    runs = {
        "fgmres": (FGMRES, "fgmres", ("K1", "K2")),
        "fgmres nodal": ([*FGMRES, "-operator_impl", "pallas"], "fgmres",
                         ("K4", "K2")),
        "fgmres fused": ([*FGMRES, "-fused", "1"], "fused_fgmres",
                         ("K1", "K2")),
        "float64": (F64, "float64", ()),
        "float64 fused": ([*F64, "-fused", "1"], "fused_float64", ()),
        "xla": (["-operator_impl", "xla"], None, ()),
        "galerkin": (GALERKIN, "galerkin", ("K4", "K2")),
    }
    out = {}
    log("[19] prediction: the float64 runs' fx gap to the JAX float64 "
        "histories is well under 1e-6")
    for name, (args, hist, names) in runs.items():
        history = ("jax_cpu_history_65x33x33"
                   + (f"_{hist}" if hist else "") + ".npz")
        out[name] = phase_path_run(f"19 {name}", args, history, names,
                                   iters_within=1)
    # K4's runs per level in a steady fused iteration: every level under
    # FGMRES on the nodal path, the fine level only under galerkin_octant
    levels = {"K4": ((65, 33, 33), (33, 17, 17), (17, 9, 9), (9, 5, 5))}
    for name, args in (("fgmres nodal", [*FGMRES, "-operator_impl",
                                         "pallas"]),
                       ("galerkin", GALERKIN)):
        d = _fused_driver([], 5, args)
        d.run(4)
        c = _profile(lambda: d.run(5), levels)
        log(f"[19 profile] 65x33x33 fused {name}: {json.dumps(c)}")
        del d
    phase_graph_eager("19 fgmres graph=eager", ksp_type="fgmres")
    phase_graph_eager("19 fgmres restart 4 graph=eager", ksp_type="fgmres",
                      ksp_gmres_restart=4)
    phase_graph_eager("19 float64 graph=eager", dtype="float64")
    return out["fgmres fused"]


def _one_iteration_257(tag, args, bar=1e-3):
    """One split iteration at 257^3 of the path `args`: the solve converged
    within -ksp_maxit and, unless `bar` is None, fx within `bar` of the
    golden iteration-1 compliance; prints solver iterations, seconds and
    peak memory, and returns fx."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        h = _run_cli([*_size_args(257), "-maxItr", "1",
                      "-output_cadence_vtu", "0", "-restart", "0", *args],
                     tmp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    d = abs(h["fx"][0] - GOLDEN_257_FX1) / GOLDEN_257_FX1
    log(f"[{tag}] fx {h['fx'].tolist()}, rel diff to golden {d:.3e} (bar "
        f"{bar}), solver iterations {h['iters'].tolist()} (golden: 27), "
        f"stalled {h['stalled'].tolist()}, s/iteration "
        f"{h['time'].tolist()}, command {wall:.1f} s, max_memory_allocated "
        f"{peak} B ({peak / 2**30:.2f} GiB)")
    if (len(h["fx"]) != 1 or not np.isfinite(h["fx"]).all()
            or (bar is not None and d > bar) or h["stalled"].any()
            or h["iters"][0] >= 200):
        raise AssertionError(f"{tag} off the golden or stalled")
    return float(h["fx"][0])


@contextlib.contextmanager
def f32_element_matrices():
    """Every elasticity element matrix the port builds, rounded to f32 and
    widened back: an f64 run on the f32 path's element matrices."""
    from topopt_in_petsc_tpu_torch.models import elasticity

    exact = elasticity.hex8_stiffness
    elasticity.hex8_stiffness = lambda *args: (
        exact(*args).astype(np.float32).astype(np.float64))
    try:
        yield
    finally:
        elasticity.hex8_stiffness = exact


def _solver_stage_ms(step, reps=5):
    """Device ms of one trip of the state solve's loop (the step's second
    graph, SEGMENT trips, over SEGMENT) and, under FGMRES, of one cycle
    close (its graph): CUDA events around replays after the iteration.
    The trips are inactive then, and do the work of active ones; what the
    close writes, the next iteration's first stage overwrites."""
    from topopt_in_petsc_tpu_torch.solvers.cg import SEGMENT

    stages = [("trip_ms", step.graphs[1], SEGMENT)]
    stages += [("close_ms", g, 1) for g in step.graphs if g.repeat_prev]
    out = {}
    for name, g, n in stages:
        times = []
        torch.cuda.synchronize()
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.graph.replay()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / n)
        out[name] = round(statistics.median(times), 4)
    return out


def _fgmres_krylov_trip(m=30):
    """Device ms of one predicated FGMRES trip with A and M the identity,
    on resident 257^3 vectors: the masked Gram-Schmidt over all m + 1 rows
    of V, the rotations and the predication, without the operator and the
    V-cycle; beside the Gram-Schmidt's bytes bound (per row, the dot reads
    w and v_i, the update reads both and writes w)."""
    from topopt_in_petsc_tpu_torch.ops.roofline import (
        H100_BYTES_PER_S,
        graph_ms,
    )
    from topopt_in_petsc_tpu_torch.solvers.cg import _dot
    from topopt_in_petsc_tpu_torch.solvers.gmres import (
        fgmres_start,
        fgmres_trips,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    b = torch.randn((3, 257, 257, 257), device="cuda", generator=gen)
    ident = lambda v: v  # noqa: E731
    dot = lambda u, v: _dot(u, v, True)  # noqa: E731
    box = [fgmres_start(ident, b, torch.zeros_like(b), rtol=0.0,
                        restart=m, dot=dot)]

    def trip():
        box[0] = fgmres_trips(ident, box[0], None, 1, maxiter=10**6,
                              dot=dot)

    ms = graph_ms([trip], 3, reps=5)[0]
    bound = (m + 1) * 5 * b.numel() * 4 / H100_BYTES_PER_S * 1e3
    del box, b
    torch.cuda.empty_cache()
    return {"krylov_trip_ms": round(ms, 4),
            "gram_schmidt_bound_ms": round(bound, 4)}


def phase_options_257(fused_f32_times):
    """The options at 257^3: one split iteration of FGMRES and of
    octant-Galerkin coarse levels, each held to the golden iteration-1
    compliance; one of float64 on the element matrices rounded to f32,
    held to the golden (an f32 run), and one of float64 on the exact
    matrices, held within F64_EXACT_GAP of the rounded run; then 4 fused
    FGMRES iterations (phase 14 with -ksp_type fgmres, beside phase 14's
    FCG times), one steady fused iteration under torch.profiler with K1's
    runs and device time per level and the kernels that took the most
    device time, the device ms of an Arnoldi trip and of a cycle close,
    and of the Krylov part of a trip alone."""
    for tag, args in (("fgmres", FGMRES), ("galerkin", GALERKIN)):
        _one_iteration_257(f"20 257^3 {tag}", args)
    fx64 = _one_iteration_257("20 257^3 float64", F64, bar=None)
    with f32_element_matrices():
        fx64r = _one_iteration_257(
            "20 257^3 float64, f32 element matrices", F64)
    gap = fx64 / fx64r - 1
    log(f"[20 257^3 float64] fx {fx64} is {gap:.3e} from the same f64 run "
        f"on the f32-rounded element matrices ({fx64r}; bar "
        f"{F64_EXACT_GAP}), which is {fx64r / GOLDEN_257_FX1 - 1:.3e} from "
        f"the f32 golden")
    if abs(gap) > F64_EXACT_GAP:
        raise AssertionError("257^3 float64 fx off its rounded-matrix run")
    d, _ = phase_fused_real_size(f"fcg {fused_f32_times}",
                                 "20 257^3 fused fgmres", FGMRES)
    c = _profile(lambda: d.run(5), {"K1": LEVELS_257}, top=20)
    c.update(_solver_stage_ms(d.step))
    log(f"[20 profile] 257^3 fused fgmres: {json.dumps(c)}")
    del d
    torch.cuda.empty_cache()
    log(f"[20 257^3 fgmres] {json.dumps(_fgmres_krylov_trip())}")


# -- the multi-device engine (-mesh_shape) --------------------------------- #

# the CLI that spawns the mesh's ranks itself, and torchrun's launch of
# `n` ranks of it on this node
SPAWN = [sys.executable, "-m", "topopt_in_petsc_tpu_torch"]


def _torchrun(n):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(n), "-m", "topopt_in_petsc_tpu_torch"]


def _descendants(pid):
    """The pids of every process below `pid` (from /proc)."""
    children = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            with contextlib.suppress(OSError):
                with open(f"/proc/{entry}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
                children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        kids = children.get(todo.pop(), [])
        out += kids
        todo += kids
    return out


def _stop(proc):
    """Stop the launch `proc` and every process below it: torchrun starts
    its ranks in sessions of their own and stops them on SIGTERM; what is
    left after a minute, and the launch's own process group, is killed."""
    if proc.poll() is None:
        below = _descendants(proc.pid)
        proc.terminate()
        with contextlib.suppress(subprocess.TimeoutExpired):
            proc.wait(timeout=60)
        for pid in below:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def _run_mesh(tag, args, workdir, launcher=SPAWN):
    """The CLI run of `args` in a subprocess of its own process group,
    started by `launcher` (the CLI, which spawns the mesh's ranks, or
    torchrun's launch of them), under `MESH_TIMEOUT`: (history, the ranks'
    launch counts and peak memory, seconds).  Its output goes to
    `workdir`/cli.log.  A failed or overlong run prints the last lines of
    its output, then raises."""
    path = os.path.join(workdir, "cli.log")
    cmd = [*launcher, *args, "-workdir", workdir]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    with open(path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=MESH_TIMEOUT)
        except subprocess.TimeoutExpired:
            rc = f"timeout after {MESH_TIMEOUT} s"
        finally:
            _stop(proc)
    seconds = time.perf_counter() - t0
    with open(path) as f:
        lines = f.read().splitlines()
    if rc != 0:
        log(f"[{tag}] mesh run {' '.join(cmd)}: exit {rc} after "
            f"{seconds:.1f} s; the last lines of its output:")
        for line in lines[-400:]:
            log(f"[{tag}] | {line}")
        raise RuntimeError(f"{tag}: the mesh run failed ({rc})")
    ranks, comm = {}, {}
    for line in lines:
        m = RANK_LINE.search(line)
        if m:
            ranks[int(m.group(1))] = (json.loads(m.group(2)),
                                      int(m.group(4) or 0))
            comm[int(m.group(1))] = json.loads(m.group(3))
    log(f"[{tag}] communication by rank (exchanges, reductions, seconds "
        f"waiting for the device, seconds of transfer): "
        f"{json.dumps(dict(sorted(comm.items())))}")
    with np.load(os.path.join(workdir, "history.npz")) as h:
        return {k: h[k] for k in h.files}, ranks, seconds


def _by_rank(ranks):
    """Each rank's launches and peak memory, for a log line."""
    return {r: (c, f"{p} B ({p / 2**30:.2f} GiB)")
            for r, (c, p) in sorted(ranks.items())}


def _check_ranks(tag, ranks, world, names):
    """Every rank reported, and launched each kernel of `names`."""
    if sorted(ranks) != list(range(world)):
        raise AssertionError(f"{tag}: rank lines of {sorted(ranks)}, "
                             f"expected {world} ranks")
    low = {r: {n: c[n] for n in names} for r, (c, _) in ranks.items()
           if min(c[n] for n in names) <= 0}
    if low:
        raise AssertionError(f"{tag}: a kernel of the route was not "
                             f"launched on every rank: {low}")


MESH_NAMES = ("K1", "K2", "K3", "K4", "K1-bf16")


def _add_launches(total, ranks):
    """`total` plus each rank's launches of every kernel."""
    for c, _ in ranks.values():
        for n in total:
            total[n] += c.get(n, 0)
    return total


def _mesh_against_one_card(tag, flags, shape, names, common, total):
    """The mesh run of `flags` on `shape` against the single-card -fused 1
    run with the same flags: fx within 1e-4 at iteration 1 and 1e-3 at
    every iteration, solver iterations within 1, never stalled, every
    rank launched each kernel of `names`; adds the ranks' launches to
    `total`."""
    world = int(np.prod([int(v) for v in shape.split(",")]))
    with tempfile.TemporaryDirectory() as tmp:
        h, ranks, seconds = _run_mesh(
            tag, [*flags, *common, "-mesh_shape", shape], tmp)
    with tempfile.TemporaryDirectory() as tmp:
        ref = _run_cli([*flags, *common, "-fused", "1"], tmp)
    n = len(ref["fx"])
    rel = np.abs(h["fx"] / ref["fx"] - 1)
    dit = int(np.max(np.abs(h["iters"] - ref["iters"])))
    log(f"[{tag}] mesh {shape}, {world} ranks: fx {h['fx'].tolist()} "
        f"against -fused 1 {ref['fx'].tolist()}: rel {rel.tolist()} "
        f"(bars 1e-4 at it. 1, 1e-3); solver iterations "
        f"{h['iters'].tolist()} and {ref['iters'].tolist()}; stalled "
        f"{h['stalled'].tolist()}; s/iteration {h['time'].tolist()}; "
        f"the run took {seconds:.1f} s; launches by rank "
        f"{ {r: c for r, (c, _) in sorted(ranks.items())} }")
    if (len(h["fx"]) != n or not np.isfinite(h["fx"]).all()
            or rel[0] > 1e-4 or rel.max() > 1e-3 or dit > 1
            or h["stalled"].any()):
        raise AssertionError(f"{tag}: the mesh run is off the "
                             "single-card run or stalled")
    _check_ranks(tag, ranks, world, names)
    return _add_launches(total, ranks)


def phase_mesh_variants():
    """Phase 21; returns the launch counts summed over ranks and runs."""
    total = {n: 0 for n in MESH_NAMES}
    common = ["-ksp_maxit", "30", "-maxItr", "2", "-output_cadence_vtu",
              "0", "-restart", "0", "-precise_dots", "0"]
    for tag, flags, shape, names in MESH_VARIANTS:
        _mesh_against_one_card(tag, flags, shape, names, common, total)
    return total


def phase_mesh_257(split_times, total):
    """Phase 22: 257^3 on two ranks of the card; returns its history and
    seconds, phase 27's uninterrupted reference."""
    tag = "22 257^3 mesh 2,1,1"
    with tempfile.TemporaryDirectory() as tmp:
        h, ranks, seconds = _run_mesh(
            tag, [*_size_args(257), "-maxItr", "2", "-output_cadence_vtu",
                  "0", "-mesh_shape", "2,1,1"], tmp)
    d = abs(h["fx"][0] - GOLDEN_257_FX1) / GOLDEN_257_FX1
    log(f"[{tag}] fx {h['fx'].tolist()}, it.1 rel diff to golden {d:.3e}, "
        f"solver iterations {h['iters'].tolist()} (single card: "
        f"{GOLDEN_257_ITERS1}), stalled {h['stalled'].tolist()}, "
        f"s/iteration {h['time'].tolist()} (single card, phase 6: "
        f"{split_times}), the run took {seconds:.1f} s; by rank: "
        f"launches and max_memory_allocated "
        f"{_by_rank(ranks)}")
    if (len(h["fx"]) != 2 or not np.isfinite(h["fx"]).all() or d > 1e-3
            or abs(int(h["iters"][0]) - GOLDEN_257_ITERS1) > 1
            or h["stalled"].any()):
        raise AssertionError(f"{tag}: off the golden or stalled")
    _check_ranks(tag, ranks, 2, ("K1", "K2"))
    _add_launches(total, ranks)
    return h, seconds


# phase 23: the options of the single-device solvers on a mesh, each with
# the kernels its route launches on every rank (K1 is the bf16 runs'
# outer f32 operator; galerkin_octant runs K4 at the fine level only)
MESH_OPTIONS = (
    ("23 bf16", ["-mg_dtype", "bfloat16"], ("K1-bf16", "K1", "K2")),
    ("23 mixed fine_post 2", ["-mg_dtype", "mixed", "-mg_fine_post", "2"],
     ("K1-bf16", "K1", "K2")),
    ("23 galerkin", GALERKIN, ("K4", "K2")),
    ("23 fgmres", FGMRES, ("K1", "K2")),
    ("23 fgmres pallas", [*FGMRES, "-operator_impl", "pallas"],
     ("K4", "K2")),
)
# phase 24: the single card's solver iterations at 257^3, iteration 1
# (phases 17 and 20), and how far the mesh's may stray: 15% of the bf16
# count, whose V-cycle rounds the shared planes' sums on each rank before
# they are added (one card rounds the whole sum once), and 1 for FGMRES
BF16_257_ITERS1, FGMRES_257_ITERS1 = 83, 18
MESH_257_OPTIONS = (
    ("24 257^3 mesh bf16", ["-mg_dtype", "bfloat16"],
     ("K1-bf16", "K1", "K2"), BF16_257_ITERS1, 12),
    ("24 257^3 mesh fgmres", FGMRES, ("K1", "K2"), FGMRES_257_ITERS1, 1),
)


def phase_mesh_options(total):
    """Phase 23: 33x17x17 on mesh (2,2,1), 3 iterations of each of
    `MESH_OPTIONS`, held to the single-card -fused 1 run."""
    grid = ["-nx", "33", "-ny", "17", "-nz", "17", "-nlvls", "3", "-rmin",
            "0.16"]
    common = ["-maxItr", "3", "-output_cadence_vtu", "0", "-restart", "0"]
    for tag, flags, names in MESH_OPTIONS:
        _mesh_against_one_card(tag, [*grid, *flags], "2,2,1", names, common,
                               total)
    return total


def phase_mesh_options_257(split_times, total):
    """Phase 24: 257^3 on mesh (2,1,1), iteration 1 of the bf16 V-cycle
    and of FGMRES: fx within 1e-3 of the golden, solver iterations within
    their gap of the single card's, the route's kernels on both ranks;
    s/iteration, peak memory and communication by rank."""
    for tag, flags, names, iters, gap in MESH_257_OPTIONS:
        with tempfile.TemporaryDirectory() as tmp:
            h, ranks, seconds = _run_mesh(
                tag, [*_size_args(257), "-maxItr", "1", "-output_cadence_vtu",
                      "0", "-restart", "0", "-mesh_shape", "2,1,1", *flags],
                tmp)
        d = abs(h["fx"][0] - GOLDEN_257_FX1) / GOLDEN_257_FX1
        log(f"[{tag}] fx {h['fx'].tolist()}, rel diff to golden {d:.3e}, "
            f"solver iterations {h['iters'].tolist()} (single card: {iters}, "
            f"bar {gap}), stalled {h['stalled'].tolist()}, s/iteration "
            f"{h['time'].tolist()} (f32 single card, phase 6: "
            f"{split_times}), the run took {seconds:.1f} s; by rank: "
            f"launches and max_memory_allocated "
            f"{_by_rank(ranks)}")
        if (len(h["fx"]) != 1 or not np.isfinite(h["fx"]).all() or d > 1e-3
                or abs(int(h["iters"][0]) - iters) > gap
                or h["stalled"].any()):
            raise AssertionError(f"{tag}: off the golden, off the single "
                                 "card's iterations or stalled")
        _check_ranks(tag, ranks, 2, names)
        _add_launches(total, ranks)
    return total


def _kernel_events(events, name):
    """The device's runs of kernel `name` among a trace's events."""
    return [e for e in _device_kernels(events)
            if any(s in e["name"] for s in _DEVICE_NAMES[name])]


def _pde_trips_against_eager():
    """The fused -filter 2 step's PDE-solve iterations (`pde_iters`, the
    `# PDE filter iterations` line of the fused driver) at 65x33x33,
    iterations 1-3 with its stages eager, against the eager solve
    (opt/pde_filter.py `_solve`) of each field from the same warm start:
    equal."""
    from topopt_in_petsc_tpu_torch.config import TopOptConfig
    from topopt_in_petsc_tpu_torch.parallel.fused_step import make_fused_step

    step, state = make_fused_step(
        TopOptConfig.from_args(["-fused", "1", "-filter", "2"]),
        graphs=False)
    pdef, calls, start = step.pdef, [], step.pdef.start

    def recording_start(x):
        calls.append((x.clone(), pdef._u.clone()))
        return start(x)

    pdef.start = recording_start
    xt, xp = step.project(state.x, state.beta)
    state.xTilde.copy_(xt)
    state.xPhys.copy_(xp)
    trips = []
    for itr in (1, 2, 3):
        calls.clear()
        step(state, itr)
        fused = step.pde_iters.tolist()
        eager = [int(pdef._solve(x, u0)[2]) for x, u0 in calls]
        trips.append((fused, eager))
        if fused != eager or len(fused) != 3:
            raise AssertionError(f"25 pde trips: the fused step's PDE "
                                 f"iterations {fused} differ from the "
                                 f"eager solves' {eager}")
    log(f"[25 pde trips] 65x33x33 -fused 1 -filter 2, iterations 1-3, "
        f"PDE-solve iterations (dfdx, dgdx, design) fused and eager: "
        f"{trips}")


def phase_profile_dir(times):
    """Phase 25, `-profile_dir`: the fused 65x33x33 run, 4 iterations,
    traced (its fx against the JAX fused history's first 4 at the history
    bar; device events of K1 and K2 in the trace); 17x9x9 on mesh
    (2,1,1), 2 iterations, one trace per rank, each with K1's device
    events; `speed_of_light_spmv` of phase 4's 257^3 K1 time beside
    ops/roofline.py's bound; the fused -filter 2 step's PDE-solve
    iterations against the eager solves."""
    from topopt_in_petsc_tpu_torch.ops.roofline import bound_ms
    from topopt_in_petsc_tpu_torch.utils import speed_of_light_spmv

    ref = _load_history("jax_cpu_history_65x33x33_fused.npz")
    with tempfile.TemporaryDirectory() as tmp:
        prof = os.path.join(tmp, "prof")
        t0 = time.perf_counter()
        h = _run_cli(["-fused", "1", "-maxItr", "4", "-output_cadence_vtu",
                      "0", "-restart", "0", "-profile_dir", prof],
                     os.path.join(tmp, "run"))
        seconds = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(prof, "trace.json"))
        ev = _trace_events(prof)
    runs = {n: len(_kernel_events(ev, n)) for n in ("K1", "K2")}
    rel = np.abs(h["fx"] / ref["fx"][:4] - 1)
    log(f"[25 profile_dir] 65x33x33 -fused 1, 4 iterations traced in "
        f"{seconds:.1f} s: trace {size} B, {len(ev)} events, device runs "
        f"{runs}; fx {h['fx'].tolist()} rel to the JAX fused history "
        f"{rel.tolist()} (bar {FX_RTOL}), s/iteration {h['time'].tolist()}")
    if min(runs.values()) <= 0 or rel.max() > FX_RTOL:
        raise AssertionError("25: the trace lacks K1 or K2, or the traced "
                             "run is off its history")
    tag = "25 profile_dir mesh 2,1,1"
    with tempfile.TemporaryDirectory() as tmp:
        prof = os.path.join(tmp, "prof")
        _, ranks, seconds = _run_mesh(
            tag, ["-nx", "17", "-ny", "9", "-nz", "9", "-nlvls", "2",
                  "-rmin", "0.16", "-maxItr", "2", "-output_cadence_vtu",
                  "0", "-restart", "0", "-mesh_shape", "2,1,1",
                  "-profile_dir", prof], tmp)
        per_rank = {r: len(_kernel_events(
            _trace_events(os.path.join(prof, f"rank{r}")), "K1"))
            for r in (0, 1)}
        dirs = sorted(os.listdir(prof))
    log(f"[{tag}] trace directories {dirs}, K1 device runs by rank "
        f"{per_rank}, launches by rank "
        f"{ {r: c['K1'] for r, (c, _) in sorted(ranks.items())} }; the "
        f"run took {seconds:.1f} s")
    if dirs != ["rank0", "rank1"] or min(per_rank.values()) <= 0:
        raise AssertionError(f"{tag}: not one trace with K1 per rank")
    card = torch.cuda.get_device_name(0)
    sol = speed_of_light_spmv(256**3, times["K1"][0] * 1e-3, card)
    b, by = bound_ms("K1", (257,) * 3)
    log(f"[25 speed of light] K1 at 257^3, {times['K1'][0]} ms on {card}: "
        f"utils speed_of_light_spmv {json.dumps(sol)} (the JAX package's "
        f"dense-product model); ops/roofline.py bound {b:.4f} ms by {by}")
    _pde_trips_against_eager()


# -- the output and restart path at 257^3 (phase 26) ----------------------- #

# the fields that the .dat carries and the tool writes back into a .vtu
OUTPUT_FIELDS = ("ux", "uy", "uz", "x", "xTilde", "xPhys")
TOOL_TIMEOUT = 600


def _output_bytes(n):
    """Bytes on disk that phase 26 (or 27) needs at once for an n^3-node
    grid: the .dat with two datasets, two .vtu (base64 of the mesh and the
    fields) and two restart pairs (every array counted at 8 bytes)."""
    nnode, nelem = n**3, (n - 1) ** 3
    fields = 12 * nnode + 12 * nelem
    vtu = 4 * (12 * nnode + 80 * nelem + fields) // 3
    dat = 12 * nnode + 80 * nelem + 2 * (8 + fields)
    restart = 48 * nelem + 24 * nnode
    return dat + 2 * vtu + 2 * restart


@contextlib.contextmanager
def _timed_calls(targets):
    """Wrap each (owner, attribute, label) of `targets` so that every call
    appends its seconds to the yielded dict's list under `label`."""
    seconds = {label: [] for _, _, label in targets}
    saved = []
    for owner, attr, label in targets:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))

        def timed(*a, _fn=fn, _label=label, **k):
            t = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                seconds[_label].append(time.perf_counter() - t)

        setattr(owner, attr, timed)
    try:
        yield seconds
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


@contextlib.contextmanager
def _step_modes():
    """Record, for every fused step call, (itr, how it ran): "eager",
    "capture" (eager, then captured as CUDA graphs) or "replay"."""
    from topopt_in_petsc_tpu_torch.parallel.fused_step import FusedStep

    modes, call = [], FusedStep.__call__

    def spy(step, s, itr=3):
        before = step.graphs is not None
        out = call(step, s, itr)
        modes.append((itr, "replay" if before else "capture"
                       if step.graphs is not None else "eager"))
        return out

    FusedStep.__call__ = spy
    try:
        yield modes
    finally:
        FusedStep.__call__ = call


def _vtu_arrays(path, names):
    """The payloads of the `DataArray` blocks named `names` in a .vtu in
    VTK's binary format (base64 of a UInt64 byte count, then base64 of the
    payload), decoded; the count is checked against the payload."""
    import base64
    import mmap
    import struct

    out = {}
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0,
                                          access=mmap.ACCESS_READ) as m:
        for name in names:
            tag = m.find(f'Name="{name}"'.encode())
            if tag < 0:
                raise AssertionError(f"{path}: no DataArray {name}")
            start = m.find(b">\n", tag) + 2
            end = m.find(b"\n", start)
            (count,) = struct.unpack("<Q", base64.b64decode(m[start:start
                                                              + 12]))
            out[name] = base64.b64decode(m[start + 12:end])
            if len(out[name]) != count:
                raise AssertionError(f"{path}: {name} holds "
                                     f"{len(out[name])} B, its header {count}")
    return out


# starts a command and writes its peak RSS to a file: a process's
# ru_maxrss starts from the peak of the process that execs it, so the
# command is started from this small process, not from the smoke's
TOOL_LAUNCHER = """
import os, subprocess, sys
p = subprocess.Popen(sys.argv[2:])
_, status, usage = os.wait4(p.pid, 0)
with open(sys.argv[1], "w") as f:
    f.write(str(usage.ru_maxrss * 1024))
sys.exit(os.waitstatus_to_exitcode(status))
"""


def _run_tool(argv, cwd, rss_path):
    """(exit code, stdout, stderr, seconds, peak RSS in bytes) of the
    command `argv` run in `cwd` under TOOL_TIMEOUT; its peak RSS passes
    through the file `rss_path`."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", TOOL_LAUNCHER, rss_path, *argv], cwd=cwd,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TOOL_TIMEOUT)
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    seconds = time.perf_counter() - t0
    with open(rss_path) as f:
        return proc.returncode, out, err, seconds, int(f.read())


def _rss_bytes():
    """(the process's resident set now, its peak so far), in bytes."""
    import resource

    with open("/proc/self/status") as f:
        now = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return now * 1024, peak * 1024


def _tool_against_vtu(tag, dat, final, workdir, rss_path):
    """tools/torch_bin2vtu.py on dataset 1 of `dat` in `workdir`, its six
    arrays against those of the driver's `final` .vtu: a dict of whether
    each is equal, whether the final's are finite, the tool's seconds,
    peak RSS and bytes, and the seconds of decoding both files.  The .dat
    and both .vtu are deleted as they are read."""
    tool = os.path.join(REPO, "tools", "torch_bin2vtu.py")
    rc, out, err, tool_s, tool_rss = _run_tool(
        [sys.executable, tool, "1", dat], workdir, rss_path)
    log(f"[{tag}] tools/torch_bin2vtu.py 1 on the .dat: exit {rc}, "
        f"stdout {out!r}")
    if rc != 0 or out != "wrote output_00001.vtu\n":
        raise AssertionError(f"{tag}: the tool failed: {err[-4000:]}")
    os.remove(dat)
    tool_vtu = os.path.join(workdir, "output_00001.vtu")
    tool_bytes = os.path.getsize(tool_vtu)
    t0 = time.perf_counter()
    got = _vtu_arrays(tool_vtu, OUTPUT_FIELDS)
    os.remove(tool_vtu)
    ref = _vtu_arrays(final, OUTPUT_FIELDS)
    os.remove(final)
    return {"same": {n: got[n] == ref[n] for n in OUTPUT_FIELDS},
            "finite": all(np.isfinite(np.frombuffer(v, "<f4")).all()
                          for v in ref.values()),
            "tool_s": tool_s, "tool_peak_rss": tool_rss,
            "tool_vtu_bytes": tool_bytes,
            "decode_s": time.perf_counter() - t0}


def phase_output_restart(fused_hist):
    """Phase 26, the output and restart path at 257^3 through the CLI entry
    with phase 14's flags (-fused 1): run A, one iteration with every
    output on (.vtu at the default cadence, -output_dat 1, restart),
    its fx against the golden; run B, a resume from A's restart pair to
    -maxItr 4 with no .vtu, its iterations 2-4 against phase 14's at the
    graph-replay bar and its iteration 3 the one that captures; then
    tools/torch_bin2vtu.py on A's .dat, whose arrays must equal the
    driver's final .vtu bit for bit.  Each write's seconds, each file's
    bytes, the host's peak memory and the tool's seconds are logged."""
    import io
    import shutil

    from topopt_in_petsc_tpu_torch import fused_driver
    from topopt_in_petsc_tpu_torch.io.mpiio_dat import MPIIODat, read_dat
    from topopt_in_petsc_tpu_torch.io.restart import RestartManager

    tag = "26 output 257^3"
    args = [*_size_args(257), "-fused", "1"]
    targets = ((MPIIODat, "__init__", "dat mesh"),
               (MPIIODat, "write_state", "dat dataset"),
               (fused_driver, "write_state_vtu", "vtu"),
               (RestartManager, "write", "restart write"),
               (RestartManager, "load", "restart load"),
               (RestartManager, "load_state", "restart load u"))
    need = _output_bytes(257)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        log(f"[{tag}] {free} B free in {tmp}; the phase needs {need} B")
        if free < need:
            raise RuntimeError(f"{tag}: {free} B free in {tmp}, the phase "
                               f"needs {need} B")
        a, b, c = (os.path.join(tmp, d) for d in ("A", "B", "tool"))
        os.makedirs(c)
        rss_before = _rss_bytes()
        with _timed_calls(targets) as sec_a, _step_modes() as modes_a:
            t0 = time.perf_counter()
            ha = _run_cli([*args, "-maxItr", "1", "-output_dat", "1"], a)
            wall_a = time.perf_counter() - t0
        rss_after = _rss_bytes()
        sizes = {n: os.path.getsize(os.path.join(a, n))
                 for n in sorted(os.listdir(a))}
        want = {"output_00001.vtu", "output_00002.vtu", "output_00000.dat",
                "Restart00.npz", "RestartSol00.npz", "history.npz"}
        dat = os.path.join(a, "output_00000.dat")
        dat_itrs = [st["itr"] for st in read_dat(dat)["steps"]]
        d1 = abs(ha["fx"][0] - GOLDEN_257_FX1) / GOLDEN_257_FX1
        log(f"[{tag}] run A (-maxItr 1, every output): fx "
            f"{ha['fx'].tolist()}, it.1 rel diff to golden {d1:.3e}, "
            f"solver iterations {ha['iters'].tolist()}, step modes "
            f"{modes_a}, files {sorted(sizes)}, .dat datasets of "
            f"iterations {dat_itrs}")
        if (set(sizes) != want or dat_itrs != [1, 2] or d1 > 1e-3
                or ha["stalled"].any() or modes_a != [(1, "eager")]):
            raise AssertionError(f"{tag}: run A wrote {sorted(sizes)}, "
                                 f".dat iterations {dat_itrs}, or is off "
                                 "the golden")
        os.remove(os.path.join(a, "output_00001.vtu"))

        buf = io.StringIO()
        try:
            with _timed_calls(targets) as sec_b, _step_modes() as modes_b, \
                    contextlib.redirect_stdout(buf):
                t0 = time.perf_counter()
                hb = _run_cli([*args, "-maxItr", "4", "-output_cadence_vtu",
                               "0", "-restartFileVec",
                               os.path.join(a, "Restart00.npz"),
                               "-restartFileVecSol",
                               os.path.join(a, "RestartSol00.npz")], b)
                wall_b = time.perf_counter() - t0
        finally:
            sys.stdout.write(buf.getvalue())
        resumed = (f"# Continue optimization from file: "
                   f"{os.path.join(a, 'Restart00.npz')}"
                   in buf.getvalue().splitlines())
        rel = {k: float(np.max(np.abs(hb[k] - np.asarray(fused_hist[k][1:])))
                        / np.max(np.abs(fused_hist[k][1:])))
               for k in ("fx", "gx", "ch", "mnd")}
        log(f"[{tag}] run B (resume to -maxItr 4): '# Continue "
            f"optimization' printed {resumed}, fx {hb['fx'].tolist()}, "
            f"solver iterations {hb['iters'].tolist()} against phase 14's "
            f"{fused_hist['iters'][1:]}, max rel diff to phase 14's "
            f"iterations 2-4 { {k: f'{v:.2e}' for k, v in rel.items()} } "
            f"(bar 1e-6), step modes {modes_b}, s/iteration "
            f"{hb['time'].tolist()}")
        if (not resumed or len(hb["fx"]) != 3 or max(rel.values()) > 1e-6
                or hb["iters"].tolist() != list(fused_hist["iters"][1:])
                or modes_b != [(2, "eager"), (3, "capture"), (4, "replay")]):
            raise AssertionError(f"{tag}: the resume did not continue "
                                 "phase 14's run")
        shutil.rmtree(b)
        for name in ("Restart00.npz", "RestartSol00.npz"):
            os.remove(os.path.join(a, name))

        tool = _tool_against_vtu(tag, dat, os.path.join(a, "output_00002.vtu"),
                                 c, os.path.join(tmp, "tool_rss"))
    same, finite = tool.pop("same"), tool.pop("finite")
    summary = {
        "free_bytes": free, "needed_bytes": need, "files": sizes,
        "tool_vtu_bytes": tool["tool_vtu_bytes"], "run_a_s": wall_a,
        "run_a_iteration_s": ha["time"].tolist(), "write_s_a": sec_a,
        "run_b_s": wall_b, "write_s_b": sec_b, "tool_s": tool["tool_s"],
        "tool_peak_rss": tool["tool_peak_rss"], "rss_before_a": rss_before[0],
        "peak_rss_before_a": rss_before[1], "peak_rss_after_a": rss_after[1],
        "resume_max_rel": rel, "decode_s": tool["decode_s"],
    }
    log(f"[{tag}] arrays of the tool's .vtu equal the driver's "
        f"output_00002.vtu: {same}, finite {finite}; {json.dumps(summary)}")
    if not all(same.values()) or not finite:
        raise AssertionError(f"{tag}: the tool's arrays differ from the "
                             "driver's final .vtu")


# -- the mesh's output and restart path at 257^3 (phase 27) ---------------- #

def _mesh_rel(h, i, ref, j):
    """max over fx, gx, ch and mnd of |h[k][i] - ref[k][j]| / max|ref[k]|
    (gx[0] is about 0 at iteration 1, so each key is scaled by its largest
    value over the reference run, as phase 26 does)."""
    return {k: float(abs(h[k][i] - ref[k][j]) / np.max(np.abs(ref[k])))
            for k in ("fx", "gx", "ch", "mnd")}


def phase_mesh_output_restart(ref, ref_seconds, total):
    """Phase 27, the mesh's output and restart path at 257^3 on (2,1,1),
    against phase 22's uninterrupted run `ref` (which took `ref_seconds`):
    run A, launched by torchrun, 1 iteration with every output on; run B,
    the spawn launch, resumes A's restart pair for iteration 2; run C, one
    card under -fused 1 (the CLI entry in this process), resumes it too;
    then tools/torch_bin2vtu.py on A's .dat, whose arrays must equal A's
    final .vtu.  Adds A's and B's launches to `total`."""
    import io
    import shutil

    from topopt_in_petsc_tpu_torch.io.mpiio_dat import read_dat

    tag = "27 mesh output 257^3"
    mesh = [*_size_args(257), "-mesh_shape", "2,1,1"]
    need = _output_bytes(257)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        log(f"[{tag}] {free} B free in {tmp}; the phase needs {need} B")
        if free < need:
            raise RuntimeError(f"{tag}: {free} B free in {tmp}, the phase "
                               f"needs {need} B")
        a, b, c, t = (os.path.join(tmp, d) for d in ("A", "B", "C", "tool"))
        for d in (a, b, c, t):
            os.makedirs(d)
        ha, ranks_a, wall_a = _run_mesh(
            f"{tag} A", [*mesh, "-maxItr", "1", "-output_dat", "1"], a,
            launcher=_torchrun(2))
        # cli.log is this script's record of the launch
        sizes = {n: os.path.getsize(os.path.join(a, n))
                 for n in sorted(os.listdir(a)) if n != "cli.log"}
        want = {"output_00001.vtu", "output_00002.vtu", "output_00000.dat",
                "Restart00.npz", "RestartSol00.npz", "history.npz"}
        dat = os.path.join(a, "output_00000.dat")
        dat_itrs = [st["itr"] for st in read_dat(dat)["steps"]]
        rel_a = _mesh_rel(ha, 0, ref, 0)
        d1 = abs(ha["fx"][0] - GOLDEN_257_FX1) / GOLDEN_257_FX1
        beyond = wall_a - (ref_seconds - float(ref["time"][1]))
        log(f"[{tag}] run A (torchrun, -maxItr 1, every output): fx "
            f"{ha['fx'].tolist()}, against phase 22's iteration 1 "
            f"{ {k: f'{v:.2e}' for k, v in rel_a.items()} } (bar 1e-6), "
            f"it.1 rel diff to golden {d1:.3e}, solver iterations "
            f"{ha['iters'].tolist()} (phase 22: {ref['iters'].tolist()}), "
            f"s/iteration {ha['time'].tolist()} (phase 22: "
            f"{ref['time'].tolist()}), the run took {wall_a:.1f} s, "
            f"{beyond:.1f} s beyond phase 22's run less its second "
            f"iteration ({ref_seconds:.1f} s in all); files {sizes}; .dat "
            f"datasets of iterations {dat_itrs}; by rank: launches and "
            f"max_memory_allocated {_by_rank(ranks_a)}")
        if (set(sizes) != want or dat_itrs != [1, 2]
                or len(ha["fx"]) != 1 or max(rel_a.values()) > 1e-6
                or int(ha["iters"][0]) != int(ref["iters"][0])
                or d1 > 1e-3
                or abs(int(ha["iters"][0]) - GOLDEN_257_ITERS1) > 1
                or ha["stalled"].any()):
            raise AssertionError(f"{tag}: run A wrote {sorted(sizes)}, "
                                 f".dat iterations {dat_itrs}, or is off "
                                 "phase 22's iteration 1 or the golden")
        _check_ranks(f"{tag} A", ranks_a, 2, ("K1", "K2"))
        _add_launches(total, ranks_a)
        os.remove(os.path.join(a, "output_00001.vtu"))

        resume = ["-restartFileVec", os.path.join(a, "Restart00.npz"),
                  "-restartFileVecSol", os.path.join(a, "RestartSol00.npz")]
        continued = ("# Continue optimization from file: "
                     f"{os.path.join(a, 'Restart00.npz')}")
        hb, ranks_b, wall_b = _run_mesh(
            f"{tag} B", [*mesh, "-maxItr", "2", "-output_cadence_vtu", "0",
                         *resume], b)
        with open(os.path.join(b, "cli.log")) as f:
            resumed_b = any(continued in line for line in f)
        rel_b = _mesh_rel(hb, 0, ref, 1)
        log(f"[{tag}] run B (spawn, resume to -maxItr 2): '# Continue "
            f"optimization' printed {resumed_b}, fx {hb['fx'].tolist()}, "
            f"against phase 22's iteration 2 "
            f"{ {k: f'{v:.2e}' for k, v in rel_b.items()} } (bar 1e-6), "
            f"solver iterations {hb['iters'].tolist()} (phase 22's "
            f"iteration 2: {int(ref['iters'][1])}), s/iteration "
            f"{hb['time'].tolist()}, the run took {wall_b:.1f} s; by rank: "
            f"launches and max_memory_allocated {_by_rank(ranks_b)}")
        if (not resumed_b or len(hb["fx"]) != 1
                or max(rel_b.values()) > 1e-6
                or int(hb["iters"][0]) != int(ref["iters"][1])
                or hb["stalled"].any()):
            raise AssertionError(f"{tag}: run B did not continue phase "
                                 "22's run")
        _check_ranks(f"{tag} B", ranks_b, 2, ("K1", "K2"))
        _add_launches(total, ranks_b)
        shutil.rmtree(b)

        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                t0 = time.perf_counter()
                hc = _run_cli([*_size_args(257), "-fused", "1", "-maxItr",
                               "2", "-output_cadence_vtu", "0", *resume], c)
                wall_c = time.perf_counter() - t0
        finally:
            sys.stdout.write(buf.getvalue())
        resumed_c = continued in buf.getvalue().splitlines()
        dc = abs(hc["fx"][0] / ref["fx"][1] - 1)
        log(f"[{tag}] run C (one card, -fused 1, resume to -maxItr 2): "
            f"'# Continue optimization' printed {resumed_c}, fx "
            f"{hc['fx'].tolist()}, rel diff to phase 22's iteration 2 "
            f"{dc:.3e} (bar 1e-3), solver iterations {hc['iters'].tolist()} "
            f"(within 1 of {int(ref['iters'][1])}), stalled "
            f"{hc['stalled'].tolist()}, s/iteration {hc['time'].tolist()}, "
            f"the run took {wall_c:.1f} s")
        if (not resumed_c or len(hc["fx"]) != 1 or dc > 1e-3
                or abs(int(hc["iters"][0]) - int(ref["iters"][1])) > 1
                or hc["stalled"].any()):
            raise AssertionError(f"{tag}: run C did not continue phase "
                                 "22's run on one card")
        shutil.rmtree(c)
        for name in ("Restart00.npz", "RestartSol00.npz"):
            os.remove(os.path.join(a, name))

        tool = _tool_against_vtu(tag, dat, os.path.join(a, "output_00002.vtu"),
                                 t, os.path.join(tmp, "tool_rss"))
    same, finite = tool.pop("same"), tool.pop("finite")
    summary = {"free_bytes": free, "needed_bytes": need, "files_a": sizes,
               "run_a_s": wall_a, "run_a_beyond_phase_22_s": beyond,
               "run_b_s": wall_b, "run_c_s": wall_c, **tool,
               "rel_a": rel_a, "rel_b": rel_b, "rel_c_fx": dc}
    log(f"[{tag}] arrays of the tool's .vtu equal A's output_00002.vtu: "
        f"{same}, finite {finite}; {json.dumps(summary)}")
    if not all(same.values()) or not finite:
        raise AssertionError(f"{tag}: the tool's arrays differ from A's "
                             "final .vtu")


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
    fused_257, fused_hist = phase_fused_real_size(split_times["default"])
    fused_times = fused_hist["time"]
    phase_profiles(fused_257)
    del fused_257
    done("14-15 default")
    phase_output_restart(fused_hist)
    done(26)
    phase_fused_paths_257(split_times)
    done("14-15 nodal and filter 2")
    launches["K1-bf16"] = phase_bf16_runs()["K1-bf16"]
    done(16)
    phase_bf16_257(fused_times)
    done(17)
    phase_513()
    done(18)
    phase_options_runs()
    done(19)
    phase_options_257(fused_times)
    done(20)
    mesh_launches = phase_mesh_variants()
    done(21)
    mesh_hist, mesh_seconds = phase_mesh_257(split_times["default"],
                                             mesh_launches)
    done(22)
    phase_mesh_output_restart(mesh_hist, mesh_seconds, mesh_launches)
    done(27)
    phase_mesh_options(mesh_launches)
    done(23)
    phase_mesh_options_257(split_times["default"], mesh_launches)
    done(24)
    phase_profile_dir(times)
    done(25)
    src = "topopt_in_petsc_tpu_torch/csrc/"
    kernels = [
        {"name": "hex_operator (K1)", "route": "cuda",
         "source": src + "hex_operator.cu",
         "replaces": "topopt_in_petsc_tpu/ops/blocked_hex.py:65",
         "launches": launches["K1"], "max_abs_err": errs["K1"],
         "ms": times["K1"][0], "plain_ms": times["K1"][1],
         "mesh_launches": mesh_launches["K1"],
         **_bound("K1", times["K1"][0])},
        {"name": "quadform (K2)", "route": "cuda",
         "source": src + "quadform.cu",
         "replaces": "topopt_in_petsc_tpu/ops/pallas_hex.py:274",
         "launches": launches["K2"], "max_abs_err": errs["K2"],
         "ms": times["K2"][0], "plain_ms": times["K2"][1],
         "mesh_launches": mesh_launches["K2"],
         **_bound("K2", times["K2"][0])},
        {"name": "helmholtz (K3)", "route": "cuda",
         "source": src + "nodal_hex.cu",
         "replaces": "topopt_in_petsc_tpu/ops/pallas_hex.py:416",
         "launches": launches["K3"], "max_abs_err": errs["K3"],
         "ms": times["K3"][0], "plain_ms": times["K3"][1],
         "mesh_launches": mesh_launches["K3"],
         **_bound("K3", times["K3"][0])},
        {"name": "nodal_hex (K4)", "route": "cuda",
         "source": src + "nodal_hex.cu",
         "replaces": "topopt_in_petsc_tpu/ops/pallas_hex.py:59",
         "launches": launches["K4"], "max_abs_err": errs["K4"],
         "ms": times["K4"][0], "plain_ms": times["K4"][1],
         "mesh_launches": mesh_launches["K4"],
         **_bound("K4", times["K4"][0])},
        {"name": "hex_operator bf16 (K1 bf16)", "route": "cuda",
         "source": src + "hex_operator.cu",
         "replaces": "topopt_in_petsc_tpu/ops/blocked_hex.py:65",
         "launches": launches["K1-bf16"], "max_abs_err": errs["K1-bf16"],
         "ms": times["K1-bf16"][0], "plain_ms": times["K1-bf16"][1],
         "mesh_launches": mesh_launches["K1-bf16"],
         **_bound("K1-bf16", times["K1-bf16"][0])},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
