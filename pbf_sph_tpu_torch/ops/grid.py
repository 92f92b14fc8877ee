"""Spatial index on tensors: cell sort key + dense CSR cell table.

Port of `pbf_sph_tpu/ops/grid.py`; every output is an integer and matches
the JAX package bit for bit.

Particles are sorted by **row-major linear cell id** (x*NY*NZ + y*NZ + z,
z fastest), not by Morton code.  Linear order makes every (dx,dy) slice of
the 27-cell stencil one *contiguous* range of the sorted particle array: a
particle's neighbours are nine ranges of the cell table, which is what the
phase kernels walk (`ops/phases.py`).

Membership still mirrors the reference's Morton rules (the reference skips
stencil cells with `offset >= gridTableN`, `src/sph.hpp:207`): with
`quirks=True` a particle is a grid member iff its cell is inside the extent
box AND its Morton code is < maxz, which excludes exactly the far-corner
cell.  `quirks=False` makes every in-box cell a member.  The gather backend's
`stencil_ranges` also keeps the reference's end-rule: a stencil cell is
gathered only if its Morton code + 1 is < maxz.

The dense table is a bincount (scatter-add) plus an exclusive cumsum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.ops.curves import morton_encode3

Cells = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # three (C,) int32

# 27-cell stencil, x fastest (reference `src/sph.hpp:220-234` order).
STENCIL27 = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


@dataclass(frozen=True)
class GridSpec:
    """Static grid geometry.

    The reference recomputes the extent from the (per-frame moving) bounds in
    fp32 every frame (`src/omp/ompsph.hpp:133-135`); under translation-only
    motion the span is constant up to 1 ulp, so the extent is frozen from the
    *initial* bounds and minExtent stays dynamic.
    """

    extent: Tuple[int, int, int]
    maxz: int
    # True: replicate the reference's Morton-table membership quirk (the
    # far-corner cell is not a member).  False: every in-box cell is a member.
    quirks: bool = True

    @property
    def dims(self) -> Tuple[int, int, int]:
        """Linear grid dims: cells have coords in [0, extent] inclusive."""
        return (self.extent[0] + 1, self.extent[1] + 1, self.extent[2] + 1)

    @property
    def ncells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz

    @staticmethod
    def from_bounds(min_bound, max_bound, scale: float, h: float) -> "GridSpec":
        f = np.float32
        padding = f(h) * f(2)
        min_extent = np.asarray(min_bound, f) / f(scale) - padding
        max_extent = np.asarray(max_bound, f) / f(scale) + padding
        extent = np.trunc((max_extent - min_extent) / f(h)).astype(np.int64)
        maxz = int(morton_encode3(int(extent[0]), int(extent[1]), int(extent[2])))
        return GridSpec(extent=tuple(int(v) for v in extent), maxz=maxz)


def cell_coords(pstar, min_extent, h) -> Cells:
    """Per-axis (C,) int32 cell coords by C-style truncation
    (reference `src/sph.hpp:198-201`); may be negative / out of range.

    `h` is a float or a 0-d tensor.  The clip to +-2e9 comes before the NaN
    map and the cast, because a float beyond 2^31 cast to int32 is undefined
    in torch.  A float `h` is put on the device as a tensor first: CUDA
    divides by a host scalar as a multiply by its reciprocal, which can flip
    a cell against the true division the CPU does."""
    if not torch.is_tensor(h):
        h = torch.full((), h, dtype=pstar[0].dtype, device=pstar[0].device)
    out = []
    for axis in range(3):
        c = (pstar[axis] - min_extent[axis]) / h
        c = torch.clamp(c, -2.0e9, 2.0e9)
        c = torch.where(torch.isnan(c), 2.0e9, c)
        out.append(torch.trunc(c).to(torch.int32))
    return tuple(out)


def sort_key(cells: Cells, alive, spec: GridSpec):
    """Linear-cell-id sort key with invalid/dead slots pushed to the end.

    Key layout: [0, ncells) valid cell ids; ncells = invalid-but-alive;
    ncells+1 = dead.  Membership mirrors the reference's Morton rules (see
    module docstring)."""
    nx, ny, nz = spec.dims
    in_box = None
    for a, n in zip(cells, (nx, ny, nz)):
        m = (a >= 0) & (a < n)
        in_box = m if in_box is None else (in_box & m)
    safe = [torch.where(in_box, c, 0) for c in cells]
    if spec.quirks:
        z = morton_encode3(safe[0], safe[1], safe[2])
        member = in_box & (z < spec.maxz)
    else:
        member = in_box
    lin = (safe[0] * ny + safe[1]) * nz + safe[2]
    key = torch.where(alive & member, lin, spec.ncells)
    key = torch.where(alive, key, spec.ncells + 1)
    return key.to(torch.int32)


def decode_key(key, spec: GridSpec) -> Tuple[Cells, torch.Tensor]:
    """Recover cell coords from a sorted key; returns (cells, member_mask)."""
    nx, ny, nz = spec.dims
    member = key < spec.ncells
    k = torch.where(member, key, 0)
    cx = k // (ny * nz)
    rem = k - cx * (ny * nz)
    cy = rem // nz
    cz = rem - cy * nz
    return (cx, cy, cz), member


def build_cell_table(sorted_key, spec: GridSpec):
    """Dense CSR cell-start table: table[c] = first sorted index with key >= c
    (same semantics as the reference's `makeGridTable`, `src/sph.hpp:238-250`,
    over linear ids).  table has ncells+1 entries; table[ncells] = member count.

    A scatter-add count (`torch.bincount` would read the largest key back to
    the host on CUDA) plus an exclusive cumsum."""
    ncells = spec.ncells
    k = torch.clamp(sorted_key, max=ncells).long()  # invalid+dead pile into the sentinel
    cnt = torch.zeros(ncells + 1, dtype=torch.int32, device=sorted_key.device)
    cnt.scatter_add_(0, k, torch.ones_like(sorted_key, dtype=torch.int32))
    return (torch.cumsum(cnt, 0, dtype=torch.int32) - cnt).to(torch.int32)


def stencil_ranges(cells: Cells, member, cell_table, spec: GridSpec) -> List[Tuple]:
    """Per-particle [start, end) candidate ranges for each of the 27 stencil
    cells, in `STENCIL27` order (reference `foreach_grid`,
    `src/sph.hpp:203-236`).  `cells`/`member` must be in sorted order.
    Returns a 27-element list of (start, end), each (C,) int32.  Port of
    `pbf_sph_tpu/ops/grid.py:150-176`."""
    nx, ny, nz = spec.dims
    maxz = spec.maxz
    out = []
    for dx, dy, dz in STENCIL27:
        nc = (cells[0] + dx, cells[1] + dy, cells[2] + dz)
        in_box = ((nc[0] >= 0) & (nc[0] < nx) & (nc[1] >= 0) & (nc[1] < ny)
                  & (nc[2] >= 0) & (nc[2] < nz))
        safe = [torch.where(in_box, c, 0) for c in nc]
        if spec.quirks:
            zc = morton_encode3(safe[0], safe[1], safe[2])
            # reference skip rule + end-rule quirk (src/sph.hpp:207-208)
            ok = member & in_box & (zc < maxz) & (zc + 1 < maxz)
        else:
            ok = member & in_box
        lin = torch.where(ok, (safe[0] * ny + safe[1]) * nz + safe[2], 0).long()
        start = torch.where(ok, cell_table[lin], 0)
        end = torch.where(ok, cell_table[lin + 1], 0)
        out.append((start, end))
    return out


def max_cell_occupancy(cell_table):
    """Largest cell population — the neighbour-gather capacity check."""
    return torch.max(cell_table[1:] - cell_table[:-1])
