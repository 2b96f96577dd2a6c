"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

The sources are compiled with nvcc, one process per source, all started
together, and linked into one shared library with a plain C interface,
loaded with ctypes.  The build runs at the first launch (never at
import), goes to ``build/topopt_torch_kernels/`` beside the package, and
is keyed by a hash of the flags, the sources and every header of
``csrc/`` (`source_key`), so an edited source or header is rebuilt and an
unchanged tree is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("hex_operator.cu", "quadform.cu", "nodal_hex.cu", "chebyshev.cu")
BUILD_DIR = _PKG.parent / "build" / "topopt_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
    "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong
# C signature of every entry point: (argtypes), all returning cudaError_t
_SIGNATURES = {
    "hex_operator_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "hex_operator_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "hex_operator_grid": (_I, _I, _I, _P),
    "hex_operator_bf16_grid": (_I, _I, _I, _P),
    "quadform_f32": (_P, _P, _P, _I, _I, _I, _P),
    "helmholtz_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
    "nodal_hex_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
    "helmholtz_grid": (_I, _I, _I, _P),
    "nodal_hex_grid": (_I, _I, _I, _P),
    "chebyshev_step_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _D, _D, _D,
                           _I, _L, _P),
}


def source_key(csrc: Path = CSRC) -> str:
    """Hash of the nvcc flags, the `SOURCES` and every ``*.cuh`` header
    in `csrc`: the build is reused only while all of them are unchanged."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in csrc.glob("*.cuh"))
    for name in (*SOURCES, *headers):
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return h.hexdigest()[:16]


class _Library:
    """A compiled library of the `SOURCES` in `csrc`, built at first use,
    with the entry points `symbols` (of `_SIGNATURES`) bound: loading
    fails if one is missing.  `LIBRARY` is this package's, with all of
    them; another checkout's `csrc` and the entry points it shares with
    this tree give that tree's kernels, for timing two trees in one
    process (tools/torch_kernel_levels.py)."""

    def __init__(self, csrc: Path = CSRC, build_dir: Path = BUILD_DIR,
                 symbols=tuple(_SIGNATURES)):
        self.csrc = Path(csrc)
        self.build_dir = Path(build_dir)
        self.symbols = tuple(symbols)
        self._lock = threading.Lock()
        self._lib = None
        self.path = None
        self.build_seconds = None  # None: loaded without compiling
        self.build_log = ""

    def _nvcc(self) -> str:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError("nvcc not found: CUDA_HOME is not set")
        return os.path.join(CUDA_HOME, "bin", "nvcc")

    def build(self) -> Path:
        srcs = [self.csrc / s for s in SOURCES]
        path = self.build_dir / f"libtopopt_kernels_{source_key(self.csrc)}.so"
        if not path.exists():
            self.build_dir.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            nvcc = self._nvcc()
            t0 = time.perf_counter()
            objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
            procs = [
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )
                for s, o in zip(srcs, objs)
            ]
            logs = [p.communicate()[0] for p in procs]
            link = None
            if all(p.returncode == 0 for p in procs):
                link = subprocess.run(
                    [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                     *[str(o) for o in objs]],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )
                logs.append(link.stdout)
            for o in objs:
                o.unlink(missing_ok=True)
            self.build_log = "".join(logs)
            if link is None or link.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{self.build_log}")
            os.replace(tmp, path)
            self.build_seconds = time.perf_counter() - t0
        return path

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.path = self.build()
                lib = ctypes.CDLL(str(self.path))
                for name in self.symbols:
                    fn = getattr(lib, name)
                    fn.argtypes = _SIGNATURES[name]
                    fn.restype = ctypes.c_int
                lib.topopt_cuda_error_string.argtypes = (ctypes.c_int,)
                lib.topopt_cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib


LIBRARY = _Library()

# every entry point, in the order the wrappers' modules created them
KERNELS: list = []


class CudaKernel:
    """One C entry point of the library, with its launch count.

    `launches` grows by one for every launch that runs and for nothing
    else; the wrappers call the plain PyTorch version for CPU tensors,
    which does not count.  A call while the stream is being captured into
    a CUDA graph records a launch without running it: it counts in
    `captured`, and the graph adds what it recorded to `launches` at each
    replay (parallel/fused_step.py).
    """

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0
        self.captured = 0
        KERNELS.append(self)

    def __call__(self, *args) -> None:
        lib = LIBRARY.get()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, self.symbol)(*args, stream)
        if err != 0:
            msg = lib.topopt_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} launch failed: {msg}")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1


def launch_grid(symbol: str, nn) -> tuple:
    """The CUDA launch grid that the grid query `symbol` (for instance
    "hex_operator_grid") reports for an `nn` node grid: a profiler's
    record of a tile kernel tells the multigrid levels apart by it."""
    grid = (ctypes.c_int * 3)()
    getattr(LIBRARY.get(), symbol)(*nn, grid)
    return tuple(grid)


def check_cuda_tensor(t: torch.Tensor, name: str, shape, dtype) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of the given shape and
    dtype (what the kernels take)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
