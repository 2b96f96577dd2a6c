#!/usr/bin/env python3
"""Time K1-bf16's column body (csrc/hex_operator.cu) beside variants that
each undo one of its design choices, in turns on one GPU.

    python3 tools/torch_k1bf16_ablations.py [--sizes 513,257,129,65,33,17]
        [--reps 15]

The variants are this tree's csrc/ with text replaced in
hex_operator.cu, each built into its own library under
build/k1bf16_ablations/:

  dense       the blocks' 72 entries, not the 45 that a brick's KE fills
  wide        the 512-thread tile at every size (none of 256 threads
              below 2^17 nodes)
  narrow      the 256-thread tile at every size
  tile_order  one block per SM slot walking an equal share of all
              (tile, node plane) pairs in tile order, where the column
              body's (z tiles, shares) grid has the blocks of one share
              walk the same planes of the z tiles of a y row together

Each output is held to the plain version (rtol 2^-7, atol 1e-5 of
max|ref|, as smoke phase 3) and to the column body's own bits (the
`dense` variant's may differ by a rounding); each time is
ops/roofline.py's `graph_ms`, the variants taken in turns.  Prints the
card's name and power limit, each variant's `ptxas` registers, then one
JSON line per size.  With `cuobjdump` it also prints each variant's
SASS instructions per element step.
"""

import argparse
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
BF16_RTOL = 2.0**-7

# name -> [(text in hex_operator.cu, its replacement), ...]
VARIANTS = {
    "dense": [(
        "__host__ __device__ constexpr unsigned block_pattern(int k) {\n"
        "  return k == 0 || k == 7 ? 0777u",
        "__host__ __device__ constexpr unsigned block_pattern(int k) {\n"
        "  return k >= 0 ? 0777u")],
    "wide": [("constexpr long kNarrowNodes = 1L << 17;",
              "constexpr long kNarrowNodes = 0;")],
    "narrow": [("constexpr long kNarrowNodes = 1L << 17;",
                "constexpr long kNarrowNodes = 1L << 62;")],
    "tile_order": [
        ("  const long work = static_cast<long>(gy) * nx;  // of this z tile "
         "column\n"
         "  long w = work * blockIdx.y / gridDim.y;\n"
         "  const long w_end = work * (blockIdx.y + 1) / gridDim.y;",
         "  const int gz = (nz + TZ - 1) / TZ;\n"
         "  const long work = static_cast<long>(gy) * gz * nx;\n"
         "  long w = work * blockIdx.x / gridDim.x;\n"
         "  const long w_end = work * (blockIdx.x + 1) / gridDim.x;"),
        ("  const int z0 = blockIdx.x * TZ;\n", ""),
        ("    const int ty = static_cast<int>(w / nx);\n"
         "    const int xa = static_cast<int>(w - static_cast<long>(ty) * nx);",
         "    const int tile = static_cast<int>(w / nx);\n"
         "    const int xa = static_cast<int>(w - static_cast<long>(tile) "
         "* nx);\n    const int ty = tile / gz, z0 = tile % gz * TZ;"),
        ("  const long work = static_cast<long>(gy) * nx;\n"
         "  const long slots =",
         "  const long work = static_cast<long>(gy) * gz * nx;\n"
         "  const long slots ="),
        ("  const long shares = std::min(std::max(slots / gz, 1L),\n"
         "                               (work + S::kMinPlanes - 1) / "
         "S::kMinPlanes);\n"
         "  const dim3 grid(gz, static_cast<unsigned>(shares));",
         "  const dim3 grid(static_cast<unsigned>(std::min(\n"
         "      slots, (work + S::kMinPlanes - 1) / S::kMinPlanes)));"),
    ],
}


def _build(name, subs):
    """The library of this tree's csrc/ with `subs` applied."""
    from topopt_in_petsc_tpu_torch.ops.cuda_build import CSRC, _Library

    dst = ROOT / "build" / "k1bf16_ablations" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst / "csrc")
    src = dst / "csrc" / "hex_operator.cu"
    text = src.read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: {old[:60]!r} not in hex_operator.cu")
        text = text.replace(old, new)
    src.write_text(text)
    lib = _Library(csrc=dst / "csrc", build_dir=dst / "lib",
                   symbols=("hex_operator_bf16",))
    lib.get()
    return lib


def _registers(lib):
    """ptxas's register and spill lines of the K1-bf16 kernels."""
    out, name = [], None
    for line in lib.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and "hex_operator_bf16_kernel" in name and (
                "registers" in line or "spill" in line):
            shape = re.search(r"ShapeILi(\d+)ELi(\d+)", name)
            sym = "reflection" if "Lb1E" in name else "576-FMA"
            out.append(f"{shape.group(1)} threads, {sym}: {line.strip()}")
    return out


def _loop_per_step(sass):
    """SASS instructions per element step in one kernel's listing: its x
    loop runs two steps per trip, so it is the backward branch whose span
    holds two barriers."""
    lines = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)
    bars = [int(a, 16) for a, text in lines if "BAR.SYNC" in text]
    for a, text in lines:
        m = re.search(r"\bBRA\s+0x([0-9a-f]+)", text)
        lo, hi = (int(m.group(1), 16), int(a, 16)) if m else (0, 0)
        if lo < hi and sum(lo <= b <= hi for b in bars) == 2:
            return (hi - lo) // 16 // 2
    return None


def _sass_per_step(lib):
    """_loop_per_step of the 512-thread reflection kernel of `lib`."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(lib.path)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    for func in sass.split("Function : ")[1:]:
        name = func.split("\n", 1)[0]
        if ("hex_operator_bf16_kernel" in name and "ShapeILi512" in name
                and "Lb1E" in name):
            return _loop_per_step(func)
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="513,257,129,65,33,17")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k1bf16_ablations: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from topopt_in_petsc_tpu_torch.grid import Grid
    from topopt_in_petsc_tpu_torch.models.elements import hex8_stiffness
    from topopt_in_petsc_tpu_torch.ops.blocked_hex import mask0
    from topopt_in_petsc_tpu_torch.ops.cuda_build import LIBRARY
    from topopt_in_petsc_tpu_torch.ops.hex_operator import apply_hex_operator
    from topopt_in_petsc_tpu_torch.ops.roofline import (
        bound_ms,
        graph_ms,
        work,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        jobs = {"column": pool.submit(lambda: (LIBRARY.get(), LIBRARY)[1])}
        jobs.update({n: pool.submit(_build, n, s)
                     for n, s in VARIANTS.items()})
        builds = {n: j.result() for n, j in jobs.items()}
    for name, build in builds.items():
        for line in _registers(build):
            print(f"ptxas {name}: {line}", flush=True)
        print(f"sass {name}: {_sass_per_step(build)} instructions per "
              "element step (512 threads, reflection product)", flush=True)
    libs = {name: build.get() for name, build in builds.items()}
    dev = torch.device("cuda", 0)

    def call(fn, *a):
        err = fn(*a, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")

    for n in map(int, args.sizes.split(",")):
        nn = (n, n, n)
        grid = Grid(nn=nn, lo=(0.0, 0.0, 0.0), hi=(2.0, 1.0, 1.0))
        KE = np.ascontiguousarray(hex8_stiffness(*grid.h, 0.3),
                                  dtype=np.float32)
        rng = np.random.default_rng(sum(nn) + 2)
        vb = torch.as_tensor(rng.normal(size=(3, *nn)), dtype=torch.float32,
                             device=dev).to(torch.bfloat16)
        E = torch.as_tensor(rng.uniform(1e-9, 1.0, size=grid.ne),
                            dtype=torch.float32,
                            device=dev).to(torch.bfloat16)
        ref = mask0(apply_hex_operator(
            vb.float().permute(1, 2, 3, 0), E.float(),
            torch.as_tensor(KE, device=dev)).permute(3, 0, 1, 2)
            .contiguous()).to(torch.bfloat16).float()
        torch.cuda.empty_cache()
        out = torch.empty_like(vb)
        ptrs = (vb.data_ptr(), E.data_ptr(), out.data_ptr(), KE.ctypes.data,
                *nn, 1)
        calls, checks, first = {}, {}, None
        scale = float(ref.abs().max())
        for name, lib in libs.items():
            fn = lib.hex_operator_bf16
            out.zero_()
            call(fn, *ptrs)
            torch.cuda.synchronize()
            got = out.float()
            if not bool(((got - ref).abs() <= BF16_RTOL * ref.abs()
                         + 1e-5 * scale).all()):
                raise AssertionError(f"{name} {nn} disagrees with the plain "
                                     "version")
            first = out.clone() if first is None else first
            checks[name] = bool(torch.equal(out, first))
            calls[name] = (lambda fn=fn: call(fn, *ptrs))
        k = max(1, min(200, int(5e8 // work("K1-bf16", nn)[0])))
        ms = dict(zip(calls, graph_ms(list(calls.values()), k, args.reps)))
        b, by = bound_ms("K1-bf16", nn)
        print(json.dumps({"nn": nn, "launches_per_graph": k, "ms": ms,
                          "bound_ms": b, "bound_by": by,
                          "bits_equal_to_column": checks}), flush=True)
        del vb, E, ref, out, first
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
