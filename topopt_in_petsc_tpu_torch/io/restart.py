"""Checkpoint / restart with A/B file flip, in the JAX package's format.

Mirrors the reference restart machinery (TopOpt.cc:386-570 +
LinearElasticity.cc:447-478, 551-611):

- two alternating checkpoint streams (Restart00 / Restart01) so one intact
  checkpoint survives a crash mid-write (the `flip` bool,
  TopOpt.cc:526-531),
- the optimization state set: x, xPhys, MMA history xo1/xo2, asymptotes
  U/L, iteration counter and objective scale fscale (TopOpt.cc:552-562),
- the FE state u in its own file pair (RestartSol00/01), the Krylov warm
  start on resume (LinearElasticity.cc:472, 607).

The files are the JAX package's: the same `.npz` keys (``itr, fscale, x,
xPhys, xo1, xo2, U, L, checksum`` and ``u``), arrays of global shape, and
the same checksum of x.  A run of either package resumes the other's.
"""

from __future__ import annotations

import os
import zlib
from typing import Optional

import numpy as np
import torch

_MOD = 0xFFFFFFFF
_CHUNK = 1 << 20


def checksum64(data: bytes) -> int:
    """Fletcher-style 64-bit checksum of a byte string: a = 1 + sum of
    bytes, b = sum of the running a, both mod 2^32 - 1, returned as
    (b << 32) | a.  The JAX package's native codec computes the same
    value (`io/native/vtu_codec.cpp::checksum64`)."""
    v = np.frombuffer(data, dtype=np.uint8)
    n = v.size
    a = 1
    b = n % _MOD  # the 1 in every running a
    for s in range(0, n, _CHUNK):
        c = v[s : s + _CHUNK].astype(np.int64)
        w = n - s - np.arange(c.size, dtype=np.int64)  # how many a's see c
        a = (a + int(c.sum())) % _MOD
        b = (b + int(np.dot(c, w) % _MOD)) % _MOD
    return (b << 32) | a


def _checksum(arr: np.ndarray) -> int:
    return checksum64(np.ascontiguousarray(arr).tobytes())


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class RestartManager:
    def __init__(self, workdir: str = "./", enabled: bool = True):
        self.enabled = enabled
        self.flip = True
        self.workdir = workdir
        self.file00 = os.path.join(workdir, "Restart00.npz")
        self.file01 = os.path.join(workdir, "Restart01.npz")
        self.sol00 = os.path.join(workdir, "RestartSol00.npz")
        self.sol01 = os.path.join(workdir, "RestartSol01.npz")

    # -- write (TopOpt::WriteRestartFiles + physics counterpart) ------- #

    def write(self, itr: int, fscale: float, x, xPhys, xo1, xo2, U, L,
              state_u) -> None:
        if not self.enabled:
            return
        self.flip = not self.flip
        path = self.file00 if not self.flip else self.file01
        sol_path = self.sol00 if not self.flip else self.sol01
        tmp = path + ".tmp.npz"
        x_np = _to_numpy(x)
        np.savez(
            tmp,
            itr=np.int64(itr),
            fscale=np.float64(fscale),
            x=x_np,
            xPhys=_to_numpy(xPhys),
            xo1=_to_numpy(xo1),
            xo2=_to_numpy(xo2),
            U=_to_numpy(U),
            L=_to_numpy(L),
            checksum=np.uint64(_checksum(x_np)),
        )
        os.replace(tmp, path)
        tmp = sol_path + ".tmp.npz"
        np.savez(tmp, u=_to_numpy(state_u))
        os.replace(tmp, sol_path)

    # -- read (AllocateMMAwithRestart, TopOpt.cc:463-506) -------------- #

    def load(self, path: str) -> Optional[dict]:
        """Load a checkpoint; returns None (with a message) if missing or
        corrupt.  The checksum is the native codec's; a file written where
        the JAX package had no C++ compiler carries its adler32 fallback,
        which is accepted too."""
        if not path or not os.path.exists(path):
            if path:
                print(f"File: {path} NOT FOUND")
            return None
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        if "checksum" in data:
            raw = np.ascontiguousarray(data["x"]).tobytes()
            if int(data["checksum"]) not in (checksum64(raw),
                                             zlib.adler32(raw)):
                print(f"CHECKPOINT CORRUPT (checksum mismatch): {path}")
                return None
        return data

    def load_state(self, path: str) -> Optional[np.ndarray]:
        if not path or not os.path.exists(path):
            if path:
                print(f"File: {path} NOT FOUND")
            return None
        with np.load(path) as z:
            return z["u"]


def state_from_numpy(d: dict, device) -> dict:
    """A loaded restart dict (JAX package or port) as the port's tensors:
    the MMA history (xo1, xo2, U, L) in f64, the fields (x, xPhys, and u
    when present) in f32, itr an int and fscale a float."""
    out = {"itr": int(d["itr"]), "fscale": float(d["fscale"])}
    for k in ("xo1", "xo2", "U", "L"):
        out[k] = torch.as_tensor(
            np.asarray(d[k]), dtype=torch.float64, device=device
        )
    for k in ("x", "xPhys", "u"):
        if k in d:
            out[k] = torch.as_tensor(
                np.asarray(d[k]), dtype=torch.float32, device=device
            )
    return out
