"""Density-filter convolution backends.

The filter operator H (Filter.cc:404-440) is a dense (2s+1)^3 hat-kernel
convolution with zero padding; Hs is computed by convolving ones with the
same backend, which reproduces the reference's boundary truncation.

- `conv3d_direct`: `torch.nn.functional.conv3d`, for small stencils (the
  package sets cuDNN's TF32 off at import, so this runs in full f32),
- `make_fft_conv`: zero-padded real-FFT linear convolution, whose cost does
  not grow with the stencil; used above `FFT_TAP_THRESHOLD` taps.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def conv3d_direct(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME-padded direct convolution (kernel symmetric)."""
    s = (kernel.shape[0] - 1) // 2
    return F.conv3d(x[None, None], kernel[None, None], padding=s)[0, 0]


def next_smooth(n: int) -> int:
    """Smallest 5-smooth integer (2^a 3^b 5^c) >= n: zero-padded linear
    convolution is exact for any transform size >= signal + kernel - 1,
    and smooth sizes are the fast ones."""
    m = max(int(n), 1)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def make_fft_conv(
    shape: Tuple[int, int, int],
    kernel: np.ndarray,
    dtype=torch.float32,
    device=None,
):
    """Precompute the kernel spectrum for SAME/zero-pad linear FFT
    convolution of fields of the given shape; returns ``conv(x)``."""
    s = (kernel.shape[0] - 1) // 2
    full = tuple(next_smooth(shape[a] + 2 * s) for a in range(3))
    k = torch.zeros(full, dtype=dtype, device=device)
    k[: 2 * s + 1, : 2 * s + 1, : 2 * s + 1] = torch.as_tensor(
        kernel, dtype=dtype, device=device
    )
    # kernel centred at s: circular shift so the centre lands at the origin
    k = torch.roll(k, shifts=(-s, -s, -s), dims=(0, 1, 2))
    KF = torch.fft.rfftn(k)
    del k
    pad = (0, full[2] - shape[2], 0, full[1] - shape[1], 0, full[0] - shape[0])

    def conv(x: torch.Tensor) -> torch.Tensor:
        XF = torch.fft.rfftn(F.pad(x.to(dtype), pad))
        out = torch.fft.irfftn(XF * KF, s=full)
        return out[: shape[0], : shape[1], : shape[2]].contiguous()

    return conv


# taps above which the FFT path is used (the JAX package's threshold; the
# stencil of the default 65x33x33 run, 5^3, stays direct)
FFT_TAP_THRESHOLD = 343  # 7^3
