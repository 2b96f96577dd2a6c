"""The least time an NVIDIA H100 could take for the work of each operator
kernel, by its compulsory bytes: each input read once, each output
written once, at the memory's published rate.

The work counted is the operation, not a kernel body: one K(E) v on the
grid of the level it runs on (K1: a nodal 3-vector read and written and
one element coefficient read, in f32; K1-bf16: the same in bf16; K3: a
nodal scalar read and written and one coefficient read; K4 as K1; K2:
the 3-vector read and one element value written).  The operations of the
element products are counted beside the bytes, for the record; at every
grid size the bytes bound these kernels, so the share of the roofline is
taken against the bytes alone, and it stays the same whatever body
implements the operation.

Peaks: NVIDIA's H100 SXM data sheet (dense rates, at its 700 W limit):
3.35 TB/s of HBM3, 67 TFLOP/s in f32 outside the tensor cores.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12

# the cards whose peaks are known, by `torch.cuda.get_device_name`
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": H100_BYTES_PER_S}


def _counts(nn):
    nx, ny, nz = nn
    return nx * ny * nz, (nx - 1) * (ny - 1) * (nz - 1)


def work_bytes(kernel: str, nn) -> float:
    """Compulsory bytes of one run of `kernel` on an `nn` node grid."""
    nnode, nelem = _counts(nn)
    if kernel in ("K1", "K4"):
        return 4.0 * (6 * nnode + nelem)
    if kernel == "K1-bf16":
        return 2.0 * (6 * nnode + nelem)
    if kernel == "K2":
        return 4.0 * (3 * nnode + nelem)
    if kernel == "K3":
        return 4.0 * (2 * nnode + nelem)
    raise ValueError(f"unknown kernel {kernel!r}")


def work_flop(kernel: str, nn) -> float:
    """Operations of one run, an add or a multiply counted 1 and an FMA 2,
    as the kernels' bodies do them for a brick's element matrix (two
    8-corner transforms, the eight 3 x 3 blocks, the E scaling and the
    corner sums; K1-bf16's column body carries half of each transform
    and keeps the 45 entries of the blocks a brick fills); for the
    record, not used in the share."""
    nnode, nelem = _counts(nn)
    if kernel in ("K1", "K4"):
        return (144 + 120 + 24) * nelem + 21 * nnode
    if kernel == "K1-bf16":
        return 192 * nelem + 9 * nnode
    if kernel == "K2":
        return (72 + 120 + 48) * nelem
    if kernel == "K3":
        return (48 + 8 + 8) * nelem + 7 * nnode
    raise ValueError(f"unknown kernel {kernel!r}")


def bound_s(kernel: str, nn, card: str) -> float:
    """Least seconds of one run on the card named `card`; raises for a card
    whose peak is not known."""
    try:
        rate = PEAK_BYTES_PER_S[card]
    except KeyError:
        raise ValueError(f"no peak known for the card {card!r}") from None
    return work_bytes(kernel, nn) / rate
