"""VTK UnstructuredGrid (.vtu) field output.

The reference writes a binary .dat via MPI-IO (MPIIO.{h,cc}) that an offline
tool converts to base64 .vtu for ParaView.  Here the .vtu is written
directly per dump, in the JAX package's format: point data ux, uy, uz from
the state field, cell data x, xTilde, xPhys (main.cc:40), appended base64
'binary' DataArrays of Float32 data with UInt64 byte headers.
"""

from __future__ import annotations

import base64
import struct
from typing import Dict, Optional

import numpy as np
import torch


def _b64_block(raw: bytes) -> bytes:
    """VTK 'binary' format: base64(UInt64 length) + base64(payload)."""
    return base64.b64encode(struct.pack("<Q", len(raw))) + base64.b64encode(
        raw
    )


def _data_array(
    f, data: np.ndarray, *, name: Optional[str] = None, vtk_type="Float32",
    ncomp: Optional[int] = None
):
    attrs = f'type="{vtk_type}"'
    if name is not None:
        attrs += f' Name="{name}"'
    if ncomp is not None:
        attrs += f' NumberOfComponents="{ncomp}"'
    f.write(f"\t\t\t<DataArray {attrs} format=\"binary\">\n".encode())
    f.write(_b64_block(data.tobytes()))
    f.write(b"\n\t\t\t</DataArray>\n")


def hex_connectivity(nn) -> np.ndarray:
    """(nelem, 8) VTK_HEXAHEDRON connectivity for the structured grid with
    node id = (i*ny + j)*nz + k (C order of the (nx, ny, nz) arrays)."""
    nx, ny, nz = nn
    i, j, k = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1),
        indexing="ij",
    )

    def nid(ii, jj, kk):
        return (ii * ny + jj) * nz + kk

    corners = [
        nid(i, j, k),
        nid(i + 1, j, k),
        nid(i + 1, j + 1, k),
        nid(i, j + 1, k),
        nid(i, j, k + 1),
        nid(i + 1, j, k + 1),
        nid(i + 1, j + 1, k + 1),
        nid(i, j + 1, k + 1),
    ]
    return np.stack([c.ravel() for c in corners], axis=-1)


def write_vtu(
    path: str,
    grid,
    point_fields: Dict[str, np.ndarray],
    cell_fields: Dict[str, np.ndarray],
) -> None:
    """Write one .vtu with the given nodal/element scalar fields.

    point_fields values: (nx, ny, nz) arrays; cell_fields: (ex, ey, ez).
    """
    nn = grid.nn
    npoints = grid.nnode
    ncells = grid.nelem

    points = grid.node_coords(np.float32).reshape(-1, 3)
    conn = hex_connectivity(nn).astype(np.uint64)
    offsets = (8 * np.arange(1, ncells + 1)).astype(np.uint64)
    types = np.full(ncells, 12, dtype=np.uint64)  # VTK_HEXAHEDRON

    with open(path, "wb") as f:
        f.write(b'<?xml version="1.0"?>\n')
        f.write(
            b'<VTKFile type="UnstructuredGrid" version="1.0" '
            b'header_type="UInt64" byte_order="LittleEndian">\n'
        )
        f.write(b"<UnstructuredGrid>\n")
        f.write(
            f'\t<Piece NumberOfPoints="{npoints}" '
            f'NumberOfCells="{ncells}">\n'.encode()
        )

        f.write(b"\t\t<Points>\n")
        _data_array(f, points.astype(np.float32), ncomp=3)
        f.write(b"\t\t</Points>\n")

        f.write(b"\t\t<Cells>\n")
        _data_array(f, conn, name="connectivity", vtk_type="UInt64")
        _data_array(f, offsets, name="offsets", vtk_type="UInt64")
        _data_array(f, types, name="types", vtk_type="UInt64")
        f.write(b"\t\t</Cells>\n")

        if point_fields:
            f.write(b'\t\t<PointData Scalars="scalars">\n')
            for name, arr in point_fields.items():
                _data_array(
                    f, np.asarray(arr, dtype=np.float32).ravel(), name=name
                )
            f.write(b"\t\t</PointData>\n")

        if cell_fields:
            f.write(b'\t\t<CellData Scalars="scalars">\n')
            for name, arr in cell_fields.items():
                _data_array(
                    f, np.asarray(arr, dtype=np.float32).ravel(), name=name
                )
            f.write(b"\t\t</CellData>\n")

        f.write(b"\t</Piece>\n")
        f.write(b"</UnstructuredGrid>\n")
        f.write(b"</VTKFile>")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def write_state_vtu(path: str, grid, u, x, xTilde, xPhys) -> None:
    """The reference field set (main.cc:40): point ux,uy,uz; cell
    x, xTilde, xPhys."""
    u = _np(u)
    write_vtu(
        path,
        grid,
        point_fields={"ux": u[..., 0], "uy": u[..., 1], "uz": u[..., 2]},
        cell_fields={"x": _np(x), "xTilde": _np(xTilde),
                     "xPhys": _np(xPhys)},
    )
