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
     symmetry, the FMA products; then the Chebyshev step kernel
     (chebyshev_smooth on f32 card fields, degree 4, from zero and from
     x, dinv and lmax from the solvers' set-up) at 9x7x5 to 33^3 above,
     resident (dof 3) and nodal (dof 1), bitwise equal to the
     plain torch steps, with 4 launches per call and b and x kept;
  4. kernel times at 257^3 nodes against the plain versions (the kernel
     as a CUDA graph of one launch replays it, the plain version around
     its call; CUDA events, median of 15), each kernel's output first
     held to the plain version's at the same bar; K1 and K4 at every
     level of the 257^3 hierarchy (K1 also at 65x33x33, K1-bf16 also at
     513^3 and 65x33x33) and K3 at the PDE filter's levels 257^3, 129^3
     and 65^3, held to the plain version and then timed as a graph of
     back-to-back launches replays it, beside the bound and its share,
     which must not exceed 100%; the Chebyshev step kernel, as in phase
     3, at every level of the 257^3 hierarchy and at the PDE filter's
     levels (dof 1), then one recurrence step timed so beside its bytes
     bound (8 field passes), its share not above 100% where its fields
     do not fit in L2;
  5. the default 65x33x33 run through the CLI entry for 10 iterations,
     held against docs/jax_cpu_history_65x33x33.npz (the JAX package on
     CPU), with the launch counts of K1 and K2 over that run;
  6. the 257^3 run (50.9M dof) for 1 iteration: its compliance against
     the JAX package's 257^3 golden history, the solve converged;
  7. the 65x33x33 run with the PDE filter (-filter 2) for 10 iterations,
     held against docs/jax_cpu_history_65x33x33_filter2.npz, with the
     launch counts of K1, K2 and K3;
  8. the 65x33x33 run of the nodal solve (-operator_impl pallas) for 10
     iterations, held against docs/jax_cpu_history_65x33x33.npz (solver
     iterations within 1), with the launch counts of K4 and K2;
  9. the 257^3 run of each of those two paths for 1 iteration, held to
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
     `-profile_dir` runs; `_window` opens and closes it with a ~20 ms
     spin kernel, 10,000 one-cycle ones and a synchronization, and leaves
     their records out) over one
     steady iteration of the split and
     of the fused driver at 65x33x33 and at 257^3, and of the fused nodal
     and -filter 2 paths at 257^3: host launch calls, kernels on the
     device, device-to-host copies, host synchronizations, and the
     device's idle share; and the runs of K1-K4, K1-bf16 and the
     Chebyshev step kernel the device recorded in
     each window, which must equal the growth of their launch counts
     over it; in the fused 257^3 windows, the runs and device time per
     multigrid level of K1 (default and -filter 2), K4 (nodal) and K3
     (-filter 2), told apart by the launch grid; in the fused default
     257^3 window also the 20 kernels with the most device time, and the
     device ms of one state-solve trip from its graph;
 16. the bf16 V-cycle (-mg_dtype bfloat16) at 65x33x33 for OPTION_ITERS
     iterations:
     split and fused, resident and nodal, and -mg_dtype mixed (split) and
     -mg_fine_post 1 (fused), each held to its driver's f32 history at the
     bars of phases 5 and 10, its solver iterations printed beside the
     history's; graph = eager for the fused bf16 step;
 17. the bf16 V-cycle at 257^3: 1 split iteration (also -mg_dtype mixed
     and -mg_fine_post 2) and 4 fused held to the golden iteration-1
     compliance, the fused s/iteration beside phase 14's f32 ones, peak
     memory, and a profiled steady fused iteration with K1's and
     K1-bf16's runs and device time per level;
 18. the one-card 513^3 recipe (405M dof, -nlvls 6 -smooth_sweeps 2), one
     split iteration in f32 and one with the bf16 V-cycle: fx agree to
     1e-3, solver iterations, peak memory and seconds;
 19. the remaining single-device options at 65x33x33 for OPTION_ITERS
     iterations, each against the JAX package's CPU history with its
     flags (solver
     iterations within 1): -ksp_type fgmres (resident, nodal, fused),
     -dtype float64 (split, fused), -operator_impl xla and -coarse_op
     galerkin_octant, with the launch counts of their kernels (none on
     the float64 paths, and the Chebyshev step kernel alone on the xla
     path, which run the plain operators as the JAX package's XLA code
     does); a profiled steady fused iteration
     (iteration 5: CUDA graph replays and eager stages) of the nodal FGMRES
     and the galerkin paths, as phase 15's, with K4's runs per level; graph
     = eager for fused FGMRES (also with a restart every 4 iterations) and
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
     __graft_entry__.py::dryrun_multichip at 8 ranks, 1 iteration each,
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
     (2,1,1), 1 iteration, with one trace per rank (K1's device events in
     each),
     utils' speed_of_light_spmv for phase 4's 257^3 K1 time beside
     ops/roofline.py's bound, and the fused -filter 2 step's PDE-solve
     iterations against the eager solves of the same fields;
 26. the one-card 513^3 recipe as a campaign runs it, right after phase
     18, through the CLI entry with -fused 1 (phase 18's flags): run R, 3
     iterations with no output, the uninterrupted reference, its
     iteration-1 fx within 1e-3 of phase 18's f32 fx and its solver
     iterations within 1 of phase 18's, never stalled, step modes eager,
     eager, capture (the first CUDA-graph capture at 513^3), peak memory;
     run A, 1 iteration with every output on (.vtu at the default
     cadence, -output_dat 1, the restart pair), its iteration 1 within
     1e-6 of R's (fx, gx, ch, mnd, each scaled by its largest value over
     R) with the same solver iterations, exactly the six files, the .vtu
     and .dat of the bytes that io/vtu.py's `vtu_layout` and
     io/mpiio_dat.py's `dat_size` give, every restart member its npy
     header and array, the .dat's datasets of iterations 1 and 2 read
     through its index, and the rise of this process's RSS over the run
     (sampled every 10 ms) at most 16 GB; run B, a resume from A's
     restart pair to -maxItr 3 with no .vtu, which prints "# Continue
     optimization" and matches R's iterations 2-3 to 1e-6 with the same
     solver iterations, step modes (2, eager), (3, capture); while B
     runs, the host checks A's output_00002.vtu (its DataArrays where the
     layout puts them, the connectivity of the first and last element of
     every x-slab of the writer and of the last element, past 2^32 bytes,
     decoded against the node ids, its six fields finite) and runs
     tools/torch_bin2vtu.py on A's .dat, whose .vtu equals A's
     output_00002.vtu byte for byte (a chunked compare) at a peak RSS of
     at most 4 GB (sampled from /proc); K1 and K2 launched in R, A and B.
     The lines give each write's seconds and MB/s (checksum64 over x
     among them), each file's bytes, peak memory, and the peak of the
     phase's files (70.1 GB), which must fit in OUTPUT_ROOT (/dev/shm
     unless CHIP_SMOKE_OUTPUT_ROOT names another) and in the
     host's available memory beside 24 GB for the process (the disk of
     the H100 hosts it was measured on takes 45 GiB of writes per run,
     and the phase writes ~91 GB); files are deleted as soon as they are
     checked, and their directory (OUTPUT_ROOT/chip_smoke26-<pid>-*)
     at the phase's end, at exit, on SIGTERM, or by a later run should a
     killed run leave it.  R and B
     stop at 3 iterations, the tool runs beside B and phase 27 runs no
     tool, to keep the smoke inside its limit (phase 14 covers the
     replay).
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
     then A's output_00002.vtu checked as phase 26's (no tool run, cut to
     keep the smoke inside its limit: phase 26 runs it at 513^3); K1 and
     K2 launched on both ranks of A and B.  One line gives each run's
     seconds, A's beyond phase 22's and each file's bytes; files are
     deleted as they are checked;
 28. the production campaign's cadences at 257^3 (tools/
     torch_run_campaign256.sh's flags), right after phases 14-15 of the
     default path, its files under OUTPUT_ROOT as phase 26's: run A,
     -maxItr 21 through the CLI entry, every iteration that
     docs/jax_cpu_history_257x257x257_campaign.npz holds (the JAX
     package's own run of the campaign's flags on the CPU, the gate of
     tools/torch_run_campaign256.sh) held to it (fx rtol 1e-3, gx, ch and
     mnd absolute 1e-4, 1e-3 and 1e-3, solver iterations within 2), its
     gap to the TPU golden, docs/golden_history_257x257x257.npz, at every
     iteration printed and not held (the JAX package on the CPU and the
     port part from it in iteration 1's design update; ROADMAP queue 3),
     every iteration finite and never
     stalled, step modes eager, eager, capture and 18 replays, exactly
     the files that `campaign_cadence` gives, the restart writes
     (Restart00 at 10, Restart01 at 20, Restart00 at 21) and the
     iteration each file holds, the .dat's datasets (1-10, 20 and the
     final dump 22, read through its index) and its closed-form bytes, K1
     and K2 launched; run B, a resume of the restart the cadence wrote
     last (Restart01, iteration 20) to -maxItr 21, which prints "#
     Continue optimization" and matches A's iteration 21 to 1e-6 (fx, gx,
     ch, mnd, each scaled by its largest value over A) with the same
     solver iterations, K1 and K2 launched; run C, -fused 1 at 65x33x33
     for 100 iterations against
     docs/jax_cpu_history_65x33x33_fused_100.npz: fx rtol 1e-3 and gx
     absolute 1e-4 at every iteration, ch 1e-3 and solver iterations
     within 1 over iterations 1-20, ch 0.06 and solver iterations within 5
     after them (CAMPAIGN_C_LATE).
 29. right after phase 19, two CLI routes at 65x33x33 through the CLI
     entry, OPTION_ITERS iterations each, split and -fused 1: the material
     and domain flags off their defaults (`MATERIAL`), and -restart 1
     -onlyLoadDesign 1 from the restart that `write_seeded_restart` writes
     with the port's writer (a design made from DESIGN_SEED with numpy,
     every other member off a fresh run's); each held to the JAX
     package's CPU history with its flags
     (docs/jax_cpu_history_65x33x33_{material,fused_material,onlyload,
     fused_onlyload}.npz, the onlyload ones checked first for the
     design's digest) at fx rtol 1e-3, gx 1e-4, ch 1e-3 and solver
     iterations within 1, never stalled, K1 and K2 launched, and the
     onlyload runs' log saying "# Loading design from file:", never "#
     Continue optimization".
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

import atexit
import contextlib
import glob
import hashlib
import importlib.util
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from itertools import repeat

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
# phases 16 and 19 hold their runs to the first OPTION_ITERS iterations of
# the 10-iteration histories (cut from 10 to keep the smoke inside its
# limit)
OPTION_ITERS = 5
GOLDEN_257_FX1 = 1725.1459  # docs/golden_history_257x257x257.npz, it. 1
GOLDEN_257_ITERS1 = 27  # its solver iterations at iteration 1
# the one-card 513^3 recipe (phases 18 and 26; the JAX package's bench.py
# opt_iter_512), 405M dof
RECIPE_513 = ["-nx", "513", "-ny", "513", "-nz", "513", "-nlvls", "6",
              "-smooth_sweeps", "2"]
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
    return smi


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
    for nn in PARITY_SHAPES:
        for dof in (3, 1):
            _cheb_equal("3 parity", dof, nn, dev)
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


def _cheb_case(dof, nn, seed, dev):
    """(A, dinv, lmax, b, x) of one smoothed level on nn nodes of the 2x1x1
    box: the resident state solve's (BlockedElasticityMG, K1, dof 3) or
    the PDE filter's nodal V-cycle's (GeometricMultigrid, K3, dof 1), set
    up from a seeded element field; b and x from the seed."""
    from topopt_in_petsc_tpu_torch.grid import Grid
    from topopt_in_petsc_tpu_torch.models.elements import (
        helmholtz_element_matrices,
        hex8_stiffness,
    )
    from topopt_in_petsc_tpu_torch.solvers.blocked_mg import (
        BlockedElasticityMG,
    )
    from topopt_in_petsc_tpu_torch.solvers.multigrid import (
        GeometricMultigrid,
    )

    grid = Grid(nn=nn, lo=(0.0, 0.0, 0.0), hi=(2.0, 1.0, 1.0))
    rng = np.random.default_rng(seed)
    E = torch.as_tensor(1e-9 + rng.uniform(0.0, 1.0, size=grid.ne) ** 3,
                        dtype=torch.float32, device=dev)
    if dof == 3:
        mg = BlockedElasticityMG([grid], [hex8_stiffness(*grid.h, 0.3)],
                                 device=dev)
        lvl = mg.setup(E)[0]
        A, shape = mg._A(0, lvl["eb"]), (3, *nn)
    else:  # the default rmin 0.08, R = rmin / (2 sqrt 3)
        KF = helmholtz_element_matrices(*grid.h, 0.08 / (2 * 3**0.5))[0]
        mg = GeometricMultigrid([grid], [KF], None, 1, device=dev)
        lvl = mg.setup(torch.ones_like(E))[0]
        A, shape = (lambda v: mg.apply(0, lvl["coef"], v)), (*nn, 1)
    b, x = (torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=dev) for _ in range(2))
    return A, lvl["dinv"], lvl["lmax"], b, x


CHEB = dict(degree=4, lower=0.06, upper=1.1)  # the V-cycles' smoothing


def _cheb_equal(phase, dof, nn, dev):
    """`chebyshev_smooth` on one level's f32 card fields, from zero and
    from x: `degree` launches of the step kernel, the bits of the plain
    torch steps (`chebyshev_smooth_plain`), b and x left as they were.
    Returns the level's (A, dinv, lmax, b, x)."""
    from topopt_in_petsc_tpu_torch.ops.chebyshev import CHEBYSHEV_STEP
    from topopt_in_petsc_tpu_torch.solvers.chebyshev import (
        chebyshev_smooth,
        chebyshev_smooth_plain,
    )

    case = A, dinv, lmax, b, x = _cheb_case(dof, nn, 40 + dof, dev)
    b0, x0 = b.clone(), x.clone()
    for x_is_zero in (True, False):
        before = CHEBYSHEV_STEP.launches
        got = chebyshev_smooth(A, b, x, dinv, lmax, x_is_zero=x_is_zero,
                               **CHEB)
        launched = CHEBYSHEV_STEP.launches - before
        ref = chebyshev_smooth_plain(A, b, x, dinv, lmax,
                                     x_is_zero=x_is_zero, **CHEB)
        same = torch.equal(got, ref)
        kept = torch.equal(b, b0) and torch.equal(x, x0)
        log(f"[{phase}] Chebyshev step dof {dof} {nn} x_is_zero="
            f"{x_is_zero}: {launched} launches, bitwise equal to the plain "
            f"steps {same}, b and x kept {kept}")
        if not (same and kept and launched == CHEB["degree"]):
            raise AssertionError(f"Chebyshev step dof {dof} {nn}: not the "
                                 "plain steps")
    return case


def _cheb_level_times(dev):
    """The Chebyshev step kernel at every level of the 257^3 hierarchy and
    of the PDE filter's there (dof 1): held to the plain steps
    (`_cheb_equal`), then a recurrence step in place, as the smoother
    runs it, timed as a graph of back-to-back launches replays it, beside
    its bytes bound (8 field passes: r, A d, d, dinv, x read, r, d, x
    written); a share above 100% refused where the fields it reads do
    not fit in the card's L2."""
    from topopt_in_petsc_tpu_torch.ops.chebyshev import chebyshev_step
    from topopt_in_petsc_tpu_torch.ops.roofline import H100_BYTES_PER_S

    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    for dof, sizes in ((3, LEVELS_257), (1, PDE_LEVELS_257)):
        for nn in sizes:
            A, dinv, lmax, b, x = _cheb_equal("4 times", dof, nn, dev)
            r, d = b.clone(), x.clone()
            ad = A(d)
            nbytes = 8 * 4.0 * b.numel()
            n = max(1, min(200, int(5e8 // nbytes)))
            ms = _graph_ms(lambda: chebyshev_step(
                2, r, ad, d, dinv, x, lmax, CHEB["lower"], CHEB["upper"],
                r_out=r, d_out=d, x_out=x), n)
            bound = nbytes / H100_BYTES_PER_S * 1e3
            # the five fields it reads stay in L2 between launches
            in_l2 = 5 * 4 * b.numel() <= l2
            log(f"[4 times] Chebyshev step dof {dof} "
                f"{'x'.join(map(str, nn))}: {ms:.5f} ms per launch (graph "
                f"of {n}), bound {bound:.5f} ms (bytes), "
                f"{100 * bound / ms:.1f}% of the bound"
                + (" (its fields fit in L2: no DRAM bound)" if in_l2 else ""))
            if bound > ms and not in_l2:
                raise AssertionError(f"Chebyshev step {nn}: {ms} ms beats "
                                     f"its bound {bound} ms")
            del A, dinv, lmax, b, x, r, d, ad
            torch.cuda.empty_cache()


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
    launches replays it (the fused step's form), beside its bound; then
    the Chebyshev step kernel at those levels (`_cheb_level_times`)."""
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
    _cheb_level_times(dev)


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


def _check_history(tag, h, ref, launches, iters_within=None, late=None):
    """Hold a history to the JAX package's CPU history of as many
    iterations and every kernel of the path to at least one launch.  With
    `late` = (n, ch bar, solver iterations bar), the ch and solver
    iterations bars hold for the first n iterations and `late`'s after
    them."""
    if len(h["fx"]) != len(ref["fx"]) or not all(
            np.isfinite(h[k]).all() for k in ("fx", "gx", "ch", "mnd")):
        raise AssertionError(f"bad history: {h}")
    n = len(ref["fx"]) if late is None else late[0]
    dfx = np.max(np.abs(h["fx"] - ref["fx"]) / np.abs(ref["fx"]))
    dgx = np.max(np.abs(h["gx"] - ref["gx"]))
    ch = np.abs(h["ch"] - ref["ch"])
    its = np.abs(h["iters"].astype(int) - ref["iters"].astype(int))
    dch, dit = ch[:n].max(), int(its[:n].max())
    log(f"[{tag}] vs JAX CPU history: fx max rel {dfx:.3e} "
        f"(bar {FX_RTOL}), gx max abs {dgx:.3e} (bar {GX_ATOL}), "
        f"ch max abs {dch:.3e} (bar {CH_ATOL}), solver iterations max "
        f"diff {dit} (bar {iters_within})"
        + ("" if late is None else f", over iterations 1-{n}; after "
           f"them ch max abs {ch[n:].max():.3e} (bar {late[1]}), solver "
           f"iterations max diff {its[n:].max()} (bar {late[2]})"))
    log(f"[{tag}] s/iteration {h['time'].tolist()}, "
        f"solver iterations {h['iters'].tolist()}")
    if not (dfx <= FX_RTOL and dgx <= GX_ATOL and dch <= CH_ATOL):
        raise AssertionError(f"{tag} run disagrees with the JAX history")
    if iters_within is not None and dit > iters_within:
        raise AssertionError(f"{tag} solver iterations off the history")
    if late is not None and (ch[n:].max() > late[1]
                             or its[n:].max() > late[2]):
        raise AssertionError(f"{tag} ch or solver iterations off the "
                             f"history after iteration {n}")
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
    from topopt_in_petsc_tpu_torch.ops.chebyshev import CHEBYSHEV_STEP
    from topopt_in_petsc_tpu_torch.ops.nodal_hex import HELMHOLTZ, NODAL_HEX
    from topopt_in_petsc_tpu_torch.ops.quadform import QUADFORM

    return {"K1": HEX_OPERATOR, "K2": QUADFORM, "K3": HELMHOLTZ,
            "K4": NODAL_HEX, "K1-bf16": HEX_OPERATOR_BF16,
            "Cheb": CHEBYSHEV_STEP}


def phase_path_run(tag, args, history, names, iters_within=None,
                   max_itr=10, late=None, only=False):
    """One `max_itr`-iteration 65x33x33 run of a path through the CLI
    entry, held to the first `max_itr` iterations of `history`, never
    stalled, with the launch counts of its kernels `names` over that run,
    each above 0; with no `names` or with `only`, no other kernel may
    launch (a path on the plain operators)."""
    kernels = _kernel_objects()
    ref = {k: v[:max_itr] for k, v in _load_history(history).items()
           if v.ndim}
    with tempfile.TemporaryDirectory() as tmp:
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        h = _run_cli([*args, "-maxItr", str(max_itr),
                      "-output_cadence_vtu", "0"], tmp)
        torch.cuda.synchronize()
        launches = {n: kernels[n].launches for n in names}
        if (only or not names) and any(
                k.launches for n, k in kernels.items() if n not in names):
            raise AssertionError(f"{tag}: a kernel outside {names} "
                                 "launched on a plain path")
    log(f"[{tag}] launches over the run: {launches}; the run took "
        f"{time.perf_counter() - t0:.1f} s; the f32 history's solver "
        f"iterations {ref['iters'].tolist()}")
    _check_history(tag, h, ref, launches, iters_within, late)
    if np.asarray(h["stalled"]).any():
        raise AssertionError(f"{tag}: a state solve stalled: {h}")
    return launches


def _size_args(n):
    return ["-nx", str(n), "-ny", str(n), "-nz", str(n), "-nlvls", "5"]


def phase_real_size(tag="6 257^3", args=()):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        h = _run_cli([*_size_args(257), "-maxItr", "1",
                      "-output_cadence_vtu", "0", *args], tmp)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    d = abs(h["fx"][0] - GOLDEN_257_FX1) / GOLDEN_257_FX1
    log(f"[{tag}] fx {h['fx'].tolist()}, it.1 rel diff to golden "
        f"{d:.3e}, s/iteration {h['time'].tolist()}, solver iterations "
        f"{h['iters'].tolist()} (golden it.1: 27), stalled "
        f"{h['stalled'].tolist()}, max_memory_allocated {peak} B "
        f"({peak / 2**30:.2f} GiB)")
    if len(h["fx"]) != 1 or not np.isfinite(h["fx"]).all():
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
    "Cheb": ("chebyshev_step_kernel",),
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


# A torch.profiler window on the card loses device records at its edges,
# counted in records, not time: the first 1 to 3,838 records after it
# opens (a 20 ms or 100 ms kernel, or 100 ms of host sleep, before the
# profiled call does not shield it) and at times its last ones before
# it closes, up to 1,582 (tools/torch_profile_window.py; PERF.md section
# 6).  So `_window` opens and closes with the same pad: a ~20 ms spin
# kernel (PAD_CYCLES, at 2 GHz), PAD_BURST one-cycle spin kernels and a
# synchronization; the pads' records are left out.
PAD_CYCLES = 40_000_000
PAD_BURST = 10_000
PAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's device function
WINDOW_SPAN = "chip_smoke window"


def _pad():
    torch.cuda._sleep(PAD_CYCLES)
    for _ in range(PAD_BURST):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def _window(run_once):
    """One torch.profiler window over `run_once()`, between two pads
    (`_pad`): the trace's named events without the pads' (host
    events only inside the call's span, device records without the pad
    kernels), the growth of the wrappers' launch counts over the call
    (graph replays included), its wall seconds and the host clock after
    the closing pad, and the pads' device records."""
    from topopt_in_petsc_tpu_torch.utils.profiling import trace_to

    kernels = _kernel_objects()
    with tempfile.TemporaryDirectory() as tmp:
        with trace_to(tmp, torch.device("cuda", 0)):
            _pad()
            before = {n: k.launches for n, k in kernels.items()}
            with torch.profiler.record_function(WINDOW_SPAN):
                t0 = time.perf_counter()
                run_once()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            _pad()
            t1 = time.perf_counter()
        ev = [e for e in _trace_events(tmp) if "name" in e]
    counted = {n: k.launches - before[n] for n, k in kernels.items()}
    spans = [e for e in ev if e["name"] == WINDOW_SPAN
             and e.get("cat") != "gpu_user_annotation"]
    if len(spans) != 1:
        raise AssertionError(f"{len(spans)} spans {WINDOW_SPAN!r} traced")
    lo, hi = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    pads = [e for e in ev if PAD_KERNEL in e["name"]]
    ev = [e for e in ev if PAD_KERNEL not in e["name"] and (
        e.get("cat") in _DEVICE_CATS or lo <= e.get("ts", lo) <= hi)]
    return ev, counted, wall, t1, pads


def _kernel_runs(on_gpu):
    """The device's runs of each kernel of `_DEVICE_NAMES` among its
    kernels `on_gpu`."""
    return {n: sum(any(s in e["name"] for s in names) for e in on_gpu)
            for n, names in _DEVICE_NAMES.items()}


def _profile(run_once, levels=None, top=0):
    """Counts of one profiled call: host launch calls (graph launches
    included), kernels and device-to-host copies on the device, host
    synchronizations, wall and device-busy seconds, idle share, and the
    executions of the hand-written kernels (`_DEVICE_NAMES`) that the
    device recorded, held equal to the
    growth of the wrappers' launch counts over the same call (graph
    replays included); with `levels` (kernel name -> grid sizes), those
    kernels' runs and device time per level; with `top`, the runs and
    device ms of the `top` kernels that took the most device time."""
    ev, counted, wall, t1, _ = _window(run_once)
    dev = [e for e in ev if e.get("cat") in _DEVICE_CATS]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in dev)
    busy, end = 0.0, -1.0
    for a, b in spans:  # union of the device intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    busy *= 1e-6
    on_gpu = _device_kernels(dev)
    on_device = _kernel_runs(on_gpu)
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
        got = phase_path_run(f"16 bf16 {name}", args, history, names,
                             max_itr=OPTION_ITERS)
        if name == "fused":
            launches = got
    phase_graph_eager("16 bf16 graph=eager", mg_dtype="bfloat16")
    return launches


def phase_bf16_257(fused_f32_times):
    """The bf16 V-cycle at 257^3: 1 split iteration (phase 6 with
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
    run must resolve to the f32 V-cycle (config.MG_BF16_DOF).  Returns the
    f32 run's history (phase 26's reference for its iteration 1)."""
    import gc

    from topopt_in_petsc_tpu_torch.config import TopOptConfig

    args = [*RECIPE_513, "-maxItr", "1", "-output_cadence_vtu", "0",
            "-restart", "0"]
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
    return out["same"]


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
    The float64 and xla runs take the plain operators: no kernel may
    launch in the float64 runs, and in the xla run the Chebyshev step
    kernel alone (its smoothing is f32).  Then one steady fused
    iteration of the nodal FGMRES and the galerkin paths under
    torch.profiler, with K4's runs and device time per level, and graph =
    eager for fused FGMRES (also restarting every 4 iterations) and fused
    float64.  Returns the launches of the fused FGMRES run."""
    runs = {
        "fgmres": (FGMRES, "fgmres", ("K1", "K2")),
        "fgmres nodal": ([*FGMRES, "-operator_impl", "pallas"], "fgmres",
                         ("K4", "K2")),
        "fgmres fused": ([*FGMRES, "-fused", "1"], "fused_fgmres",
                         ("K1", "K2")),
        "float64": (F64, "float64", ()),
        "float64 fused": ([*F64, "-fused", "1"], "fused_float64", ()),
        "xla": (["-operator_impl", "xla"], None, ("Cheb",)),
        "galerkin": (GALERKIN, "galerkin", ("K4", "K2")),
    }
    out = {}
    log("[19] prediction: the float64 runs' fx gap to the JAX float64 "
        "histories is well under 1e-6")
    for name, (args, hist, names) in runs.items():
        history = ("jax_cpu_history_65x33x33"
                   + (f"_{hist}" if hist else "") + ".npz")
        out[name] = phase_path_run(f"19 {name}", args, history, names,
                                   iters_within=1, max_itr=OPTION_ITERS,
                                   only=name in ("float64", "float64 fused",
                                                 "xla"))
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


# -- the material and domain flags, and -onlyLoadDesign ------------------- #

# the material and domain flags moved together off their defaults; the
# element is a brick with three unequal sides
MATERIAL = ["-penal", "3.5", "-Emin", "1e-6", "-Emax", "2", "-nu", "0.25",
            "-xcmax", "3", "-zcmin", "0.25", "-zcmax", "1.5"]
DESIGN_SEED = 16


def seeded_design(nn, volfrac=0.12, seed=DESIGN_SEED, amplitude=12.5):
    """The design that -onlyLoadDesign loads, made from `seed` with numpy
    for a grid of `nn` nodes: uniform noise u in [-0.5, 0.5) on the
    elements, smoothed by four passes of a periodic 3-point mean along
    each axis, then volfrac * (1 + amplitude * u) clipped to [0.05, 0.95]
    (f64; 0.066-0.211 at 17x9x9, 0.05-0.227 at 65x33x33).  It takes
    correctly rounded elementwise arithmetic alone, so every machine makes
    the same bits (np.exp and reductions may differ in the last bit
    between machines).  The default amplitude keeps the stiffness contrast
    low; at six times it (x 0.05-0.66 at 17x9x9) each package's f32 run
    parts from its f64 run by 2.0e-3 in ch, past the history bar
    (tests/test_torch_routes.py::test_high_contrast_onlyload)."""
    u = np.random.default_rng(seed).random([n - 1 for n in nn]) - 0.5
    for _ in range(4):
        for ax in range(3):
            u = (np.roll(u, 1, ax) + u + np.roll(u, -1, ax)) / 3.0
    return np.clip(volfrac * (1.0 + amplitude * u), 0.05, 0.95)


def design_digest(x):
    """sha256 of a design's f64 bytes: the onlyLoadDesign histories in
    docs/ carry it."""
    return hashlib.sha256(
        np.ascontiguousarray(x, dtype="<f8").tobytes()).hexdigest()


def write_seeded_restart(workdir, nn, volfrac=0.12, seed=DESIGN_SEED,
                         amplitude=12.5):
    """Write `seeded_design` as `workdir`/Restart00.npz with the port's
    io/restart.py writer, in the JAX package's format, and return its
    path.  Every member that -onlyLoadDesign must ignore is set off a
    fresh run's: itr 3, fscale 0.25, xPhys 0.5, xo1 and xo2 the design
    scaled by 0.9 and 1.1, L and U the design -+ 0.2."""
    from topopt_in_petsc_tpu_torch.io.restart import RestartManager

    x = seeded_design(nn, volfrac, seed, amplitude)
    RestartManager(workdir).write(
        3, 0.25, x, np.full_like(x, 0.5), 0.9 * x, 1.1 * x, x + 0.2,
        x - 0.2, np.zeros((*nn, 3)))
    return os.path.join(workdir, "Restart00.npz")


def phase_routes():
    """29. The material and domain flags off their defaults (`MATERIAL`)
    and -onlyLoadDesign from `write_seeded_restart`'s file, split and
    -fused 1 at 65x33x33, OPTION_ITERS iterations each through the CLI
    entry, each held to the JAX package's CPU history with its flags
    (docs/jax_cpu_history_65x33x33_{material,fused_material,onlyload,
    fused_onlyload}.npz; the onlyload ones carry the design's digest,
    checked first): fx rtol 1e-3, gx 1e-4, ch 1e-3, solver iterations
    within 1, never stalled, K1 and K2 launched; the onlyload runs print
    "# Loading design from file:" and not "# Continue optimization"."""
    with tempfile.TemporaryDirectory() as tmp:
        restart = write_seeded_restart(tmp, (65, 33, 33))
        with np.load(restart) as r:
            digest = design_digest(r["x"])
        onlyload = ["-restart", "1", "-restartFileVec", restart,
                    "-onlyLoadDesign", "1"]
        for name, args in (("material", MATERIAL),
                           ("fused_material", [*MATERIAL, "-fused", "1"]),
                           ("onlyload", onlyload),
                           ("fused_onlyload", [*onlyload, "-fused", "1"])):
            history = f"jax_cpu_history_65x33x33_{name}.npz"
            if "onlyload" in name and str(
                    _load_history(history)["design_sha256"]) != digest:
                raise AssertionError(f"{history} holds another design")
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    phase_path_run(f"29 {name}", args, history,
                                   ("K1", "K2"), iters_within=1,
                                   max_itr=OPTION_ITERS)
            finally:
                sys.stdout.write(out.getvalue())
            lines = out.getvalue().splitlines()
            loaded = sum(ln.startswith("# Loading design from file:")
                         for ln in lines)
            resumed = sum(ln.startswith("# Continue optimization")
                          for ln in lines)
            if resumed or loaded != ("onlyload" in name):
                raise AssertionError(f"29 {name}: {loaded} design loads "
                                     f"and {resumed} resumes in the log")


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


def f32_element_matrices():
    """Every elasticity element matrix the port builds, rounded to f32 and
    widened back, inside the block: an f64 run on the f32 path's element
    matrices (tools/torch_campaign_probe.py's)."""
    spec = importlib.util.spec_from_file_location(
        "torch_campaign_probe",
        os.path.join(REPO, "tools", "torch_campaign_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe.f32_element_matrices()


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
    common = ["-ksp_maxit", "30", "-maxItr", "1", "-output_cadence_vtu",
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
                  "-rmin", "0.16", "-maxItr", "1", "-output_cadence_vtu",
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


# -- the output and restart path at 513^3 (phase 26) ----------------------- #

# the fields that the .dat carries and the tool writes back into a .vtu
POINT_FIELDS, CELL_FIELDS = ("ux", "uy", "uz"), ("x", "xTilde", "xPhys")
FIELD_KEYS = ("fx", "gx", "ch", "mnd")
TOOL_TIMEOUT = 600
# phase 26's host bars: the tool's peak RSS, and the rise of this
# process's RSS over run A; a writer that holds arrays of the grid's size
# (the connectivity alone is 8.6 GB at 513^3) passes them
TOOL_RSS_BAR, RSS_RISE_BAR = 4e9, 16e9
# a restart file: its arrays, plus at most this much of zip and npy headers
NPZ_SLACK = 4096
# phase 26 writes ~91 GB at 513^3, 70 GB of it at once: more than the
# disk of the H100 hosts this smoke was measured on takes per run (45 GiB
# of writes, deleted files included); so its files (and phase 28's) live
# under OUTPUT_ROOT, by default /dev/shm, a file system in host memory,
# which must hold them and leave the process HOST_HEADROOM bytes
# (CHIP_SMOKE_OUTPUT_ROOT names another root).  They go into a directory
# OUTPUT_PREFIX<pid>-..., removed when the phase ends, at exit and on
# SIGTERM; one whose process is gone, which a killed run left behind, is
# removed when a phase starts, and one whose process lives (another
# checkout's smoke on the same host) is left alone
OUTPUT_ROOT = os.environ.get("CHIP_SMOKE_OUTPUT_ROOT", "/dev/shm")
OUTPUT_PREFIX, HOST_HEADROOM = "chip_smoke26-", 24e9
# bytes of a .vtu's base64 decoded at once: whole f32 values, whole groups
DECODE_BYTES = 3 << 21


def _owner_gone(path):
    """Whether the process that named the directory `path`
    (OUTPUT_PREFIX<pid>-...) has ended."""
    pid = os.path.basename(path)[len(OUTPUT_PREFIX):].split("-")[0]
    if not pid.isdigit():
        return False
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return True
    except PermissionError:
        pass
    return False


@contextlib.contextmanager
def _output_dir():
    """A new directory under OUTPUT_ROOT for phase 26's or 28's files, after
    removing those that ended runs left there; it is removed when the
    block ends, and at exit should the block not end."""
    for stale in glob.glob(os.path.join(OUTPUT_ROOT, OUTPUT_PREFIX + "*")):
        if _owner_gone(stale):
            shutil.rmtree(stale, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix=f"{OUTPUT_PREFIX}{os.getpid()}-",
                           dir=OUTPUT_ROOT)
    atexit.register(shutil.rmtree, tmp, True)
    try:
        yield tmp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _output_sizes(n):
    """Bytes of (the .dat with two datasets, one .vtu, one restart pair)
    on an n^3-node grid: io/mpiio_dat.py's and io/vtu.py's closed forms,
    and the pair's f32 arrays (6 per element, 3 per node) with headers."""
    from topopt_in_petsc_tpu_torch.io.mpiio_dat import dat_size
    from topopt_in_petsc_tpu_torch.io.vtu import vtu_layout

    nnode, nelem = n**3, (n - 1) ** 3
    return (dat_size(nnode, nelem, 2),
            vtu_layout(nnode, nelem, POINT_FIELDS, CELL_FIELDS)[0],
            24 * nelem + 12 * nnode + 2 * NPZ_SLACK)


def _files_peak(n):
    """Bytes of files at the worst point of phase 26's order of writes and
    deletions on an n^3-node grid: after run A, the .dat, two .vtu and
    the restart pair; once A's first .vtu is gone, the resume adds a pair
    of its own while the tool adds its .vtu.  Phase 27, whose resumes run
    before the mesh's files are deleted, peaks lower, at the first of
    these or .dat + .vtu + two pairs."""
    dat, vtu, pair = _output_sizes(n)
    return dat + 2 * vtu + 2 * pair


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


def _b64_pairs():
    """(65536,) int32: two base64 characters, read as a little-endian
    u2, to their 12 bits."""
    value = np.zeros(256, np.int32)
    value[np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
                        b"0123456789+/", np.uint8)] = np.arange(64)
    k = np.arange(65536)
    return (value[k & 0xFF] << 6) | value[k >> 8]


def _b64decode(chars, pairs):
    """Standard base64 `chars` (bytes; only its last 4-character group may
    be padded) decoded, the whole groups by numpy lookups in `pairs`,
    which release the interpreter lock."""
    import base64

    whole = len(chars) - (4 if chars.endswith(b"=") else 0)
    q = np.frombuffer(chars, "<u2", count=whole // 2).reshape(-1, 2)
    w = (pairs[q[:, 0]] << 12) | pairs[q[:, 1]]
    out = np.empty((w.size, 3), np.uint8)
    out[:, 0], out[:, 1], out[:, 2] = w >> 16, w >> 8, w
    return out.tobytes() + base64.b64decode(chars[whole:])


def _vtu_checks(path, n):
    """Check the driver's .vtu at `path` of an n^3-node grid where
    io/vtu.py's `vtu_layout` places each DataArray: its size, each array's
    opening tag and byte count; the connectivity of the first and last
    element of every x-slab that the writer makes and of the last element
    (whose bytes lie past 2^32), decoded from the file, against the node
    ids (i*n + j)*n + k of its corners; and each field decoded chunk by
    chunk on 4 threads, finite.  Returns (elements checked, those that
    differ, {field: finite}, seconds)."""
    import base64
    import struct

    from topopt_in_petsc_tpu_torch.io.vtu import slabs, vtu_layout

    t0 = time.perf_counter()
    nelem, plane = (n - 1) ** 3, (n - 1) ** 2
    size, where = vtu_layout(n**3, nelem, POINT_FIELDS, CELL_FIELDS)
    if os.path.getsize(path) != size:
        raise AssertionError(f"{path}: {os.path.getsize(path)} B, its "
                             f"layout {size} B")
    pairs = _b64_pairs()

    def corners(e):
        i, r = divmod(e, plane)
        j, k = divmod(r, n - 1)
        return [((i + a) * n + j + b) * n + k + c
                for a, b, c in ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                                (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))]

    fd = os.open(path, os.O_RDONLY)
    try:
        def decode(name, b0, b1):
            """Bytes [b0, b1) of the payload of the array `name`."""
            at = where[name][0] + 12
            g0, g1 = b0 // 3, -(-b1 // 3)
            raw = _b64decode(os.pread(fd, 4 * (g1 - g0), at + 4 * g0), pairs)
            return raw[b0 - 3 * g0:b1 - 3 * g0]

        for name, (at, nbytes) in where.items():
            tag = (b"" if name == "points" else f' Name="{name}"'.encode())
            count = struct.unpack("<Q", base64.b64decode(
                os.pread(fd, 12, at)))[0]
            if (not os.pread(fd, 64, at - 64).endswith(
                    tag + b' format="binary">\n') or count != nbytes):
                raise AssertionError(f"{path}: no DataArray {name} of "
                                     f"{nbytes} B at byte {at}")
        elems = sorted({e for i0, i1 in slabs(n - 1, 64 * plane)
                        for e in (i0 * plane, i1 * plane - 1)}
                       | {nelem - 1})
        bad = [e for e in elems if np.frombuffer(
            decode("connectivity", 64 * e, 64 * e + 64), "<u8").tolist()
            != corners(e)]

        def block_finite(name, b0):
            b1 = min(b0 + DECODE_BYTES, where[name][1])
            return bool(np.isfinite(np.frombuffer(decode(name, b0, b1),
                                                  "<f4")).all())

        with ThreadPoolExecutor(4) as pool:
            finite = {name: pool.map(block_finite, repeat(name),
                                     range(0, where[name][1], DECODE_BYTES))
                      for name in (*POINT_FIELDS, *CELL_FIELDS)}
            finite = {name: all(v) for name, v in finite.items()}
    finally:
        os.close(fd)
    return len(elems), bad, finite, time.perf_counter() - t0


def _npz_members(path):
    """{member: (shape, dtype)} of an .npz, each member stored as its npy
    header and its array's bytes, the file at most NPZ_SLACK bytes more
    than its members."""
    import zipfile

    out, total = {}, 0
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            with z.open(info) as m:
                version = np.lib.format.read_magic(m)
                read = (np.lib.format.read_array_header_1_0
                        if version == (1, 0)
                        else np.lib.format.read_array_header_2_0)
                shape, _, dtype = read(m)
                want = m.tell() + int(np.prod(shape)) * dtype.itemsize
            if (info.compress_type != zipfile.ZIP_STORED
                    or info.file_size != want):
                raise AssertionError(f"{path}: member {info.filename} of "
                                     f"{info.file_size} B, not {want}")
            out[info.filename[:-4]] = (shape, dtype.str)
            total += info.file_size
    if not total <= os.path.getsize(path) <= total + NPZ_SLACK:
        raise AssertionError(f"{path}: {os.path.getsize(path)} B for "
                             f"{total} B of members")
    return out


def _same_bytes(a, b, chunk=64 << 20):
    """Whether the files `a` and `b` hold the same bytes, read chunk by
    chunk, the two files at once."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    buf_a, buf_b = bytearray(chunk), bytearray(chunk)
    with open(a, "rb") as fa, open(b, "rb") as fb, \
            ThreadPoolExecutor(1) as pool:
        while True:
            got_b = pool.submit(fb.readinto, buf_b)
            n = fa.readinto(buf_a)
            if got_b.result() != n:
                return False
            if n == 0:
                return True
            if (buf_a != buf_b if n == chunk
                    else buf_a[:n] != buf_b[:n]):
                return False


def _run_tool(argv, cwd):
    """(exit code, stdout, stderr, seconds, peak RSS in bytes) of the
    command `argv` run in `cwd` under TOOL_TIMEOUT.  Its resident set is
    sampled from /proc: the card machine's kernel reports a child's
    ru_maxrss from the peak of the process that forked it."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        with _rss_peak(proc.pid) as rss:
            out, err = proc.communicate(timeout=TOOL_TIMEOUT)
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    return (proc.returncode, out, err, time.perf_counter() - t0,
            rss["peak"])


def _rss_now(pid="self"):
    """The resident set of process `pid`, in bytes (0 once it has
    exited)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            return next((int(line.split()[1]) * 1024 for line in f
                         if line.startswith("VmRSS:")), 0)
    except FileNotFoundError:
        return 0


@contextlib.contextmanager
def _rss_peak(pid="self", period=0.01):
    """Sample the resident set of process `pid` every `period` seconds
    while the block runs; the yielded dict holds the sample before the
    block ("before") and the largest one ("peak")."""
    import threading

    out = {"before": _rss_now(pid)}
    out["peak"] = out["before"]
    stop = threading.Event()

    def sample():
        while not stop.wait(period):
            out["peak"] = max(out["peak"], _rss_now(pid))

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        yield out
    finally:
        stop.set()
        sampler.join()
        out["peak"] = max(out["peak"], _rss_now(pid))


def _tool_against_vtu(dat, final, workdir):
    """tools/torch_bin2vtu.py on dataset 1 of `dat` in `workdir`, its .vtu
    against the driver's `final` .vtu byte for byte: a dict of the tool's
    exit code and output, whether the files are the same, the tool's
    seconds, peak RSS and bytes, and the seconds of the compare.  The
    .dat and the tool's .vtu are deleted as they are used; a tool that
    fails raises."""
    tool = os.path.join(REPO, "tools", "torch_bin2vtu.py")
    rc, out, err, tool_s, tool_rss = _run_tool(
        [sys.executable, tool, "1", dat], workdir)
    if rc != 0 or out != "wrote output_00001.vtu\n":
        raise AssertionError(f"tools/torch_bin2vtu.py 1 {dat} exited {rc}, "
                             f"stdout {out!r}: {err[-4000:]}")
    os.remove(dat)
    tool_vtu = os.path.join(workdir, "output_00001.vtu")
    tool_bytes = os.path.getsize(tool_vtu)
    t0 = time.perf_counter()
    same = _same_bytes(tool_vtu, final)
    compare_s = time.perf_counter() - t0
    os.remove(tool_vtu)
    return {"rc": rc, "stdout": out, "same": same, "tool_s": tool_s,
            "tool_peak_rss": tool_rss, "tool_vtu_bytes": tool_bytes,
            "compare_s": compare_s}


def _rates(seconds, per_call):
    """[seconds, MB/s] of each call in `_timed_calls`' record, for the
    labels whose bytes per call `per_call` gives."""
    return {k: [[s, per_call[k] / s / 1e6] for s in v]
            for k, v in seconds.items() if v}


def phase_output_restart(ref18):
    """Phase 26, the one-card 513^3 recipe as a campaign runs it, through
    the CLI entry under -fused 1: run R, 3 iterations with no output, the
    uninterrupted reference (iteration 1 against phase 18's f32 split run
    `ref18`; the first CUDA-graph capture at 513^3); run A, one iteration
    with every output on; run B, a resume from A's restart pair to
    -maxItr 3 with no .vtu, held to R; beside B, A's final .vtu checked
    and tools/torch_bin2vtu.py on A's .dat, whose .vtu must equal it byte
    for byte.  Each write's seconds and MB/s, the files' bytes against
    their closed forms, the rise of the host's RSS over run A, the tool's
    seconds and peak RSS and the files' peak are logged."""
    import gc
    import io

    from topopt_in_petsc_tpu_torch import fused_driver
    from topopt_in_petsc_tpu_torch.io import restart
    from topopt_in_petsc_tpu_torch.io.mpiio_dat import (
        MPIIODat,
        dat_size,
        index_dat,
    )

    n = int(RECIPE_513[1])
    tag, args = f"26 output {n}^3", [*RECIPE_513, "-fused", "1"]
    nnode, nelem = n**3, (n - 1) ** 3
    dat_bytes, vtu_bytes, pair_bytes = _output_sizes(n)
    per_call = {"dat mesh": dat_size(nnode, nelem, 0),
                "dat dataset": 8 + 12 * nnode + 12 * nelem,
                "vtu": vtu_bytes, "restart write": 24 * nelem + 12 * nnode,
                "restart load": 24 * nelem, "restart load u": 12 * nnode,
                "checksum64": 4 * nelem}
    targets = ((MPIIODat, "__init__", "dat mesh"),
               (MPIIODat, "write_state", "dat dataset"),
               (fused_driver, "write_state_vtu", "vtu"),
               (restart.RestartManager, "write", "restart write"),
               (restart.RestartManager, "load", "restart load"),
               (restart.RestartManager, "load_state", "restart load u"),
               (restart, "checksum64", "checksum64"))
    kernels = _kernel_objects()

    def run(go):
        """One run, `go()`, which returns its history: the history, the
        writes' seconds, step modes, K1 and K2 launches, seconds, peak
        device memory and printed text."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        buf = io.StringIO()
        try:
            with _timed_calls(targets) as sec, _step_modes() as modes, \
                    contextlib.redirect_stdout(buf):
                t0 = time.perf_counter()
                h = {k: np.asarray(v) for k, v in go().items()}
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            sys.stdout.write(buf.getvalue())
        return {"h": h, "rates": _rates(sec, per_call), "modes": modes,
                "launches": {k: kernels[k].launches for k in ("K1", "K2")},
                "s": wall, "peak": torch.cuda.max_memory_allocated(),
                "text": buf.getvalue()}

    need = _files_peak(n)
    with _output_dir() as tmp:
        free = shutil.disk_usage(tmp).free
        with open("/proc/meminfo") as f:
            avail = next(int(line.split()[1]) * 1024 for line in f
                         if line.startswith("MemAvailable:"))
        log(f"[{tag}] {free} B free in {tmp}, {avail} B of host memory "
            f"available; the phase's order of writes and deletions peaks at "
            f"{need} B of files (.dat {dat_bytes} B, .vtu {vtu_bytes} B, "
            f"restart pair {pair_bytes} B), beside {HOST_HEADROOM:.0f} B "
            "for the process")
        if free < need or avail < need + HOST_HEADROOM:
            raise RuntimeError(f"{tag}: {free} B free in {tmp} and {avail} "
                               f"B of host memory; the phase needs {need} B "
                               f"and {need + HOST_HEADROOM:.0f} B")
        a, b, c = (os.path.join(tmp, d) for d in ("A", "B", "tool"))
        os.makedirs(c)

        R = run(lambda: _run_cli([*args, "-maxItr", "3",
                                  "-output_cadence_vtu", "0", "-restart",
                                  "0"], os.path.join(tmp, "R")))
        hr = R["h"]
        d18 = abs(hr["fx"][0] - ref18["fx"][0]) / abs(ref18["fx"][0])
        log(f"[{tag}] run R (-maxItr 3, no output): fx {hr['fx'].tolist()}, "
            f"it.1 rel diff to phase 18's f32 {d18:.3e} (bar 1e-3), solver "
            f"iterations {hr['iters'].tolist()} (phase 18: "
            f"{ref18['iters'].tolist()}), stalled {hr['stalled'].tolist()}, "
            f"step modes {R['modes']}, s/iteration {hr['time'].tolist()}, "
            f"the run took {R['s']:.1f} s, launches {R['launches']}, "
            f"max_memory_allocated {R['peak']} B "
            f"({R['peak'] / 2**30:.2f} GiB)")
        if (len(hr["fx"]) != 3 or not np.isfinite(hr["fx"]).all()
                or d18 > 1e-3 or hr["stalled"].any()
                or abs(int(hr["iters"][0]) - int(ref18["iters"][0])) > 1
                or R["modes"] != [(1, "eager"), (2, "eager"),
                                  (3, "capture")]
                or min(R["launches"].values()) <= 0):
            raise AssertionError(f"{tag}: run R is off phase 18's run, "
                                 "stalled, not captured or launched no K1 "
                                 "or K2")

        with _rss_peak() as rss:
            A = run(lambda: _run_cli([*args, "-maxItr", "1", "-output_dat",
                                      "1"], a))
        rss_before, rss_rise = rss["before"], rss["peak"] - rss["before"]
        ha = A["h"]
        rel_a = {k: float(abs(ha[k][0] - hr[k][0]) / np.max(np.abs(hr[k])))
                 for k in FIELD_KEYS}
        sizes = {f: os.path.getsize(os.path.join(a, f))
                 for f in sorted(os.listdir(a))}
        want = {"output_00000.dat": dat_bytes, "output_00001.vtu": vtu_bytes,
                "output_00002.vtu": vtu_bytes}
        dat, final = (os.path.join(a, f) for f in ("output_00000.dat",
                                                   "output_00002.vtu"))
        dat_itrs = [st["itr"] for st in index_dat(dat).steps]
        npz = {f: _npz_members(os.path.join(a, f))
               for f in ("Restart00.npz", "RestartSol00.npz")}
        per_elem = {k for k, (shape, dt) in npz["Restart00.npz"].items()
                    if int(np.prod(shape)) == nelem and dt == "<f4"}
        u_shape, u_dt = npz["RestartSol00.npz"]["u"]
        log(f"[{tag}] run A (-maxItr 1, every output): fx "
            f"{ha['fx'].tolist()}, against R's iteration 1 "
            f"{ {k: f'{v:.2e}' for k, v in rel_a.items()} } (bar 1e-6), "
            f"solver iterations {ha['iters'].tolist()}, step modes "
            f"{A['modes']}, launches {A['launches']}, the run took "
            f"{A['s']:.1f} s, s/iteration {ha['time'].tolist()}; files "
            f"{sizes} (closed forms {want}, restart pair {pair_bytes} B at "
            f"most); .dat datasets of iterations {dat_itrs} (index); "
            f"restart members {npz}; RSS {rss_before} B before the run, its "
            f"peak rise over the run (sampled every 10 ms) {rss_rise} B (bar "
            f"{RSS_RISE_BAR:.0f}); writes [s, MB/s] {json.dumps(A['rates'])}")
        if (set(sizes) != {*want, "Restart00.npz", "RestartSol00.npz",
                           "history.npz"}
                or any(sizes[f] != v for f, v in want.items())
                or sizes["Restart00.npz"] + sizes["RestartSol00.npz"]
                > pair_bytes
                or dat_itrs != [1, 2] or len(ha["fx"]) != 1
                or max(rel_a.values()) > 1e-6
                or int(ha["iters"][0]) != int(hr["iters"][0])
                or A["modes"] != [(1, "eager")]
                or per_elem != {"x", "xPhys", "xo1", "xo2", "U", "L"}
                or int(np.prod(u_shape)) != 3 * nnode or u_dt != "<f4"
                or min(A["launches"].values()) <= 0
                or rss_rise > RSS_RISE_BAR):
            raise AssertionError(f"{tag}: run A wrote other files or bytes, "
                                 "is off R's iteration 1, launched no K1 or "
                                 "K2 or took too much host memory")
        os.remove(os.path.join(a, "output_00001.vtu"))

        # while the card runs B, the host checks A's final .vtu and, at
        # once, converts A's .dat: all read only files that B leaves alone
        pair = [os.path.join(a, f) for f in ("Restart00.npz",
                                             "RestartSol00.npz")]
        with ThreadPoolExecutor(2) as host:
            checks = host.submit(_vtu_checks, final, n)
            converted = host.submit(_tool_against_vtu, dat, final, c)
            B = run(lambda: _run_cli([*args, "-maxItr", "3",
                                      "-output_cadence_vtu", "0",
                                      "-restartFileVec", pair[0],
                                      "-restartFileVecSol", pair[1]], b))
            (checked, bad, finite, check_s), tool = (checks.result(),
                                                     converted.result())
        os.remove(final)
        hb = B["h"]
        resumed = (f"# Continue optimization from file: {pair[0]}"
                   in B["text"].splitlines())
        rel_b = {k: float(np.max(np.abs(hb[k] - hr[k][1:]))
                          / np.max(np.abs(hr[k]))) for k in FIELD_KEYS}
        log(f"[{tag}] run B (resume to -maxItr 3): '# Continue "
            f"optimization' printed {resumed}, fx {hb['fx'].tolist()}, "
            f"solver iterations {hb['iters'].tolist()} against R's "
            f"{hr['iters'][1:].tolist()}, max rel diff to R's iterations "
            f"2-3 { {k: f'{v:.2e}' for k, v in rel_b.items()} } (bar 1e-6), "
            f"step modes {B['modes']}, s/iteration {hb['time'].tolist()}, "
            f"the run took {B['s']:.1f} s, launches {B['launches']}; "
            f"[s, MB/s] {json.dumps(B['rates'])}")
        log(f"[{tag}] meanwhile on the host: A's output_00002.vtu, "
            f"connectivity of {checked} elements at the x-slab ends and the "
            f"last element decoded, {len(bad)} off the node ids {bad[:8]}, "
            f"fields finite {finite} ({check_s:.1f} s); "
            f"tools/torch_bin2vtu.py 1 on the .dat: exit {tool['rc']}, "
            f"stdout {tool['stdout']!r}, {tool['tool_s']:.1f} s, peak RSS "
            f"{tool['tool_peak_rss']} B (bar {TOOL_RSS_BAR:.0f}), its .vtu "
            f"equal to output_00002.vtu byte for byte: {tool['same']} "
            f"(compared in {tool['compare_s']:.1f} s)")
        if (not resumed or len(hb["fx"]) != 2 or max(rel_b.values()) > 1e-6
                or hb["iters"].tolist() != hr["iters"][1:].tolist()
                or B["modes"] != [(2, "eager"), (3, "capture")]
                or min(B["launches"].values()) <= 0):
            raise AssertionError(f"{tag}: the resume did not continue R")
        if bad or not all(finite.values()):
            raise AssertionError(f"{tag}: A's final .vtu is off its layout "
                                 "or not finite")
        if not tool["same"] or tool["tool_peak_rss"] > TOOL_RSS_BAR:
            raise AssertionError(f"{tag}: the tool's .vtu differs from the "
                                 "driver's final .vtu, or it took more than "
                                 f"{TOOL_RSS_BAR:.0f} B")
    summary = {
        "free_bytes": free, "mem_available": avail, "files_peak_bytes": need,
        "files_a": sizes, "run_s": {"R": R["s"], "A": A["s"], "B": B["s"]},
        "max_memory_allocated": {"R": R["peak"], "A": A["peak"],
                                 "B": B["peak"]},
        "rss_before_a": rss_before, "rss_rise_a": rss_rise, "tool": tool,
        "rel_a": rel_a, "rel_b": rel_b}
    log(f"[{tag}] {json.dumps(summary)}")


# -- the mesh's output and restart path at 257^3 (phase 27) ---------------- #

def _quiet_run(args, workdir):
    """`_run_cli` with its output held back until the run ends, then
    printed: (history, printed text, seconds, step modes)."""
    import io

    buf = io.StringIO()
    try:
        with _step_modes() as modes, contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            h = _run_cli(args, workdir)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        sys.stdout.write(buf.getvalue())
    return h, buf.getvalue(), wall, modes


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
    then A's final .vtu checked as phase 26's (phase 26's tool at 513^3
    covers the tool).  Adds A's and B's launches to `total`."""
    from topopt_in_petsc_tpu_torch.io.mpiio_dat import index_dat

    tag = "27 mesh output 257^3"
    mesh = [*_size_args(257), "-mesh_shape", "2,1,1"]
    need = _files_peak(257)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        log(f"[{tag}] {free} B free in {tmp}; the phase needs {need} B")
        if free < need:
            raise RuntimeError(f"{tag}: {free} B free in {tmp}, the phase "
                               f"needs {need} B")
        a, b, c = (os.path.join(tmp, d) for d in ("A", "B", "C"))
        for d in (a, b, c):
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
        dat_itrs = [st["itr"] for st in index_dat(dat).steps]
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

        hc, text, wall_c, _ = _quiet_run(
            [*_size_args(257), "-fused", "1", "-maxItr", "2",
             "-output_cadence_vtu", "0", *resume], c)
        resumed_c = continued in text.splitlines()
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

        final = os.path.join(a, "output_00002.vtu")
        checked, bad, finite, check_s = _vtu_checks(final, 257)
        log(f"[{tag}] A's output_00002.vtu: connectivity of {checked} "
            f"elements decoded, {len(bad)} off the node ids {bad[:8]}; "
            f"fields finite {finite} ({check_s:.1f} s)")
        if bad or not all(finite.values()):
            raise AssertionError(f"{tag}: A's final .vtu is off its layout "
                                 "or not finite")
    summary = {"free_bytes": free, "files_peak_bytes": need, "files_a": sizes,
               "run_a_s": wall_a, "run_a_beyond_phase_22_s": beyond,
               "run_b_s": wall_b, "run_c_s": wall_c, "rel_a": rel_a,
               "rel_b": rel_b, "rel_c_fx": dc}
    log(f"[{tag}] {json.dumps(summary)}")


# -- the campaign's cadences at 257^3 (phase 28) --------------------------- #

# tools/torch_run_campaign256.sh's flags (tools/run_campaign256.sh's) but
# -maxItr; run A stops at CAMPAIGN_ITERS, one past the second restart, so
# that run B's resume of that restart has an uninterrupted iteration to
# meet and the two restart files hold different iterations
CAMPAIGN_FLAGS = ["-fused", "1", "-output_dat", "1", "-output_cadence_vtu",
                  "0"]
CAMPAIGN_ITERS = 21
# run A against the JAX package's own run of the campaign's flags on the
# CPU (the gate of tools/torch_run_campaign256.sh): every iteration that
# history holds at FX_RTOL, GX_ATOL, CH_ATOL and MND_ATOL with solver
# iterations within CAMPAIGN_ITERS_WITHIN.  The JAX campaign's TPU history
# (the golden) is printed beside it and not held: the JAX package on the
# CPU and the port part from it in iteration 1's design update (mnd 0.3973
# against 0.4006; ROADMAP queue 3).  The long horizon is run C's, against
# the JAX package on the CPU
CAMPAIGN_REFERENCE = "jax_cpu_history_257x257x257_campaign.npz"
MND_ATOL = 1e-3
CAMPAIGN_ITERS_WITHIN = 2
# run C (65x33x33, 100 iterations) against the JAX CPU history: ch and
# solver iterations hold phase 10's bars over its first 20 iterations and
# these after them.  Late in a run ch (a max over elements of the design
# change) and the solver's count follow the rounding of the arithmetic:
# the card against the JAX history parts by 0.039 in ch and by 3 solver
# iterations there, the port's f32 and float64 runs on the CPU (f32
# element matrices) by 0.023 and 4 (PERF.md section 6), while a late step
# that is off moves ch by a typical value of 0.07-0.2 (movlim 0.2)
CAMPAIGN_C_LATE = (20, 0.06, 5)


def campaign_cadence(max_itr):
    """What fused_driver.py writes in a -maxItr `max_itr` run from iteration
    1 with -output_dat 1, no .vtu and no beta continuation: the .dat's
    datasets (iterations 1-10, every 20th and the final dump, max_itr + 1)
    and the restart writes in order, each (file, itr) as the A/B flip
    places it (Restart00 first): one at every 10th iteration and the
    final one."""
    dat = [i for i in range(1, max_itr + 1) if i < 11 or i % 20 == 0]
    itrs = [*range(10, max_itr + 1, 10), max_itr]
    return ([*dat, max_itr + 1],
            [(f"Restart0{k % 2}.npz", i) for k, i in enumerate(itrs)])


@contextlib.contextmanager
def _restart_writes():
    """Record every restart write as (file name, itr), in order."""
    from topopt_in_petsc_tpu_torch.io.restart import RestartManager

    written, write = [], RestartManager.write

    def recording(mgr, itr, *a, **k):
        write(mgr, itr, *a, **k)
        path = mgr.file00 if not mgr.flip else mgr.file01
        written.append((os.path.basename(path), int(itr)))

    RestartManager.write = recording
    try:
        yield written
    finally:
        RestartManager.write = write


def phase_campaign():
    """Phase 28, the campaign's cadences at 257^3: run A, the campaign's
    flags to -maxItr CAMPAIGN_ITERS through the CLI entry, the iterations
    that CAMPAIGN_REFERENCE holds held to it and its gap to the TPU golden
    printed at every iteration, its files, restart writes, restart files
    and .dat datasets against `campaign_cadence`; run B, a resume of the
    restart that the cadence wrote last, held to A's next iteration.  The
    files live under OUTPUT_ROOT, as phase 26's."""
    from topopt_in_petsc_tpu_torch.io import restart
    from topopt_in_petsc_tpu_torch.io.mpiio_dat import (
        MPIIODat,
        dat_size,
        index_dat,
    )

    n, N = 257, CAMPAIGN_ITERS
    size_args, tag = _size_args(n), f"28 campaign {n}^3"
    nnode, nelem = n**3, (n - 1) ** 3
    gold = {k: v[:N] for k, v in
            _load_history("golden_history_257x257x257.npz").items()}
    ref = _load_history(CAMPAIGN_REFERENCE)
    nref = len(ref["fx"])
    dat_want, writes_want = campaign_cadence(N)
    files_want = {"output_00000.dat", "history.npz", "Restart00.npz",
                  "Restart01.npz", "RestartSol00.npz", "RestartSol01.npz"}
    pair_bytes = _output_sizes(n)[2]
    need = dat_size(nnode, nelem, len(dat_want)) + 3 * pair_bytes
    kernels = _kernel_objects()
    with _output_dir() as tmp:
        free = shutil.disk_usage(tmp).free
        log(f"[{tag}] {free} B free in {tmp}; the phase needs {need} B")
        if free < need:
            raise RuntimeError(f"{tag}: {free} B free in {tmp}, the phase "
                               f"needs {need} B")
        a, b = (os.path.join(tmp, d) for d in ("A", "B"))
        for k in kernels.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        with _restart_writes() as written, _timed_calls((
                (MPIIODat, "__init__", "dat mesh"),
                (MPIIODat, "write_state", "dat dataset"),
                (restart.RestartManager, "write", "restart write"))) as sec:
            ha, _, wall_a, modes_a = _quiet_run(
                [*size_args, *CAMPAIGN_FLAGS, "-maxItr", str(N)], a)
        launches_a = {k: kernels[k].launches for k in ("K1", "K2")}
        peak = torch.cuda.max_memory_allocated()
        files = set(os.listdir(a))
        dat = os.path.join(a, "output_00000.dat")
        dat_itrs = [st["itr"] for st in index_dat(dat).steps]
        dat_bytes = os.path.getsize(dat)
        held = {}
        for f in ("Restart00.npz", "Restart01.npz"):
            with np.load(os.path.join(a, f)) as z:
                held[f] = int(z["itr"])
        held_want = dict(writes_want)
        os.remove(dat)
        held_err = {"fx": np.abs(ha["fx"][:nref] - ref["fx"]) / ref["fx"],
                    **{k: np.abs(ha[k][:nref] - ref[k])
                       for k in ("gx", "ch", "mnd")},
                    "iters": np.abs(ha["iters"][:nref].astype(int)
                                    - ref["iters"].astype(int))}
        bars = {"fx": FX_RTOL, "gx": GX_ATOL, "ch": CH_ATOL,
                "mnd": MND_ATOL, "iters": CAMPAIGN_ITERS_WITHIN}
        fx = np.abs(ha["fx"] - gold["fx"]) / gold["fx"]
        gx, ch, mnd = (np.abs(ha[k] - gold[k]) for k in ("gx", "ch", "mnd"))
        past = np.flatnonzero(fx > FX_RTOL)
        modes_want = [(i, "eager" if i < 3 else "capture" if i == 3
                       else "replay") for i in range(1, N + 1)]
        log(f"[{tag}] run A (-maxItr {N}, the campaign's flags): fx "
            f"{ha['fx'].tolist()}; against {CAMPAIGN_REFERENCE} at its "
            f"iterations 1-{nref}: "
            + ", ".join(f"{k} {[float(f'{v:.3e}') for v in e]} (bar "
                        f"{bars[k]})" for k, e in held_err.items())
            + f", solver iterations {ha['iters'][:nref].tolist()} (JAX "
            f"{ref['iters'].tolist()}); the TPU golden, printed, not "
            f"held: first iteration past fx {FX_RTOL}: "
            f"{int(past[0]) + 1 if past.size else None}, by iteration fx "
            f"rel {[float(f'{v:.3e}') for v in fx]}, ch abs "
            f"{[float(f'{v:.3e}') for v in ch]}, mnd abs "
            f"{[float(f'{v:.3e}') for v in mnd]}, solver iterations "
            f"{ha['iters'].tolist()} (golden {gold['iters'].tolist()}); "
            f"stalled {int(ha['stalled'].sum())}; "
            f"s/iteration {ha['time'].tolist()}, the run took {wall_a:.1f} "
            f"s, replays {sum(m == 'replay' for _, m in modes_a)}, launches "
            f"{launches_a}, max_memory_allocated {peak} B "
            f"({peak / 2**30:.2f} GiB); files {sorted(files)}; restart "
            f"writes {written} (cadence {writes_want}), restart files hold "
            f"{held}; .dat datasets {dat_itrs} (cadence {dat_want}), "
            f"{dat_bytes} B (closed form "
            f"{dat_size(nnode, nelem, len(dat_want))} B); writes [s] "
            f"{json.dumps(sec)}")
        if (len(ha["fx"]) != N or not np.isfinite(ha["fx"]).all()
                or any(e.max() > bars[k] for k, e in held_err.items())
                or ha["stalled"].any()):
            raise AssertionError(f"{tag}: run A is off {CAMPAIGN_REFERENCE},"
                                 " not finite, or stalled")
        if (files != files_want or written != writes_want
                or held != held_want or dat_itrs != dat_want
                or dat_bytes != dat_size(nnode, nelem, len(dat_want))
                or modes_a != modes_want
                or min(launches_a.values()) <= 0):
            raise AssertionError(f"{tag}: run A's files, restarts, .dat or "
                                 "step modes are not the cadence's, or it "
                                 "launched no K1 or K2")

        # the restart that the cadence wrote last (iteration 20; the final
        # write follows it): the file that a campaign stopped before its
        # end resumes from
        last, i = writes_want[-2]
        pair = [os.path.join(a, f) for f in (last, last.replace(
            "Restart", "RestartSol"))]
        for k in kernels.values():
            k.launches = 0
        hb, text, wall_b, modes_b = _quiet_run(
            [*size_args, *CAMPAIGN_FLAGS, "-maxItr", str(N), "-output_dat",
             "0", "-restartFileVec", pair[0], "-restartFileVecSol", pair[1]],
            b)
        launches_b = {k: kernels[k].launches for k in ("K1", "K2")}
        resumed = (f"# Continue optimization from file: {pair[0]}"
                   in text.splitlines())
        rel_b = {k: float(np.max(np.abs(hb[k] - ha[k][i:]))
                          / np.max(np.abs(ha[k]))) for k in FIELD_KEYS}
        log(f"[{tag}] run B (resume of {last}, it. {i}, to -maxItr {N}): "
            f"'# Continue optimization' printed {resumed}, fx "
            f"{hb['fx'].tolist()}, against A's iterations {i + 1}-{N} "
            f"{ {k: f'{v:.2e}' for k, v in rel_b.items()} } (bar 1e-6), "
            f"solver iterations {hb['iters'].tolist()} (A: "
            f"{ha['iters'][i:].tolist()}), step modes {modes_b}, the run "
            f"took {wall_b:.1f} s, launches {launches_b}")
        if (not resumed or len(hb["fx"]) != N - i
                or max(rel_b.values()) > 1e-6
                or hb["iters"].tolist() != ha["iters"][i:].tolist()
                or min(launches_b.values()) <= 0):
            raise AssertionError(f"{tag}: the resume did not continue run A")
    summary = {"run_a_s": wall_a, "run_b_s": wall_b,
               "reference": {k: e.tolist() for k, e in held_err.items()},
               "golden_fx_rel": fx.tolist(), "golden_gx_abs": gx.tolist(),
               "golden_mnd_abs": mnd.tolist(), "rel_b": rel_b,
               "max_memory_allocated": peak, "writes_s": sec}
    log(f"[{tag}] {json.dumps(summary, default=float)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import topopt_in_petsc_tpu_torch.config  # noqa: F401  (sets TF32 off)

    # a SIGTERM ends the run through its cleanups: child processes
    # stopped, phase 26's and 28's files under OUTPUT_ROOT removed
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))

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
    phase_campaign()
    phase_path_run("28 C fused 100", ["-fused", "1"],
                   "jax_cpu_history_65x33x33_fused_100.npz", ("K1", "K2"),
                   iters_within=1, max_itr=100, late=CAMPAIGN_C_LATE)
    done(28)
    phase_fused_paths_257(split_times)
    done("14-15 nodal and filter 2")
    launches["K1-bf16"] = phase_bf16_runs()["K1-bf16"]
    done(16)
    phase_bf16_257(fused_times)
    done(17)
    f32_513 = phase_513()
    done(18)
    torch.cuda.empty_cache()
    phase_output_restart(f32_513)
    done(26)
    phase_options_runs()
    done(19)
    phase_routes()
    done(29)
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
