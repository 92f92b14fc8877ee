"""Colour diffusion as per-cell colour sums, then a 27-cell gather with the mix.

The main path's diffuse (`csrc/pbf_diffuse_cells.cu`, `pbf_diffuse_cell_sums`
and `pbf_diffuse_cells`), redesigned for Hopper from the per-row kernel of
`ops/phases.py` (`diffuse_kernel` and `mix_colour` around it).  The Pallas
kernel weights a candidate by its cell's adjacency to the row's cell and by
its non-obstacle flag alone, so every row of a cell gets the same sums:

* `diffuse_cell_sums_*` -> (ncells, 8) pack: each cell's r, g, b, a sums
  and count over its rows with ptype != OBSTACLE and alive, then 3 zeros;
* `diffuse_cells_*` -> (4, C) colour: each member row adds the pack of the
  27 cells around its own (none off the grid), and fluid, alive rows with a
  count above 0.5 take `mix_colour`'s update; every other row keeps its
  colour.

As in `ops/cells.py` each kernel has a launcher (`*_kernel`) and a plain
PyTorch version of the same signature (`*_plain`); `PbfPhases.diffuse`
picks between them by the device of the colour alone.  The plain versions
add in the kernels' order, rows of a run one by one and then the 27 cells
dx, dy, dz, and mix through `mix_colour` itself, so on the card the two agree
bit for bit.
"""

from __future__ import annotations

import torch

from pbf_sph_tpu_torch.core.types import OBSTACLE
from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops.phases import CellIndex, _decode, _stream, mix_colour

PACK_WIDTH = 8  # r, g, b, a, count, 3 pad: two aligned float4 a cell


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def diffuse_cell_sums_plain(index: CellIndex, colour, ptype, alive):
    """(ncells, 8) pack: what `diffuse_cell_sums_kernel` writes, the rows of
    each run added one by one from 0."""
    ncells = index.grid.ncells
    lo = index.table[:-1].long()
    run = index.table[1:].long() - lo
    counted = (ptype != OBSTACLE) & alive
    values = torch.cat([colour, torch.ones_like(colour[:1])])  # (5, C)
    sums = torch.zeros((5, ncells), dtype=colour.dtype, device=colour.device)
    for j in range(int(run.max()) if ncells else 0):
        row = torch.where(j < run, lo + j, 0)
        take = (j < run) & counted[row]
        sums = torch.where(take, sums + values[:, row], sums)
    pack = torch.zeros((ncells, PACK_WIDTH), dtype=colour.dtype, device=colour.device)
    pack[:, :5] = sums.T
    return pack


def neighbour_sums_plain(index: CellIndex, pack):
    """(5, C) [sum r, sum g, sum b, sum a, count] of each member row over the
    27 cells around its own, dx outer, then dy, then dz, skipping a cell off
    the grid; zeros for non-member rows.  `diffuse_cells_kernel` adds the same
    in the same order (for the rows it mixes)."""
    nx, ny, nz = index.grid.dims
    key = index.key.long()
    member = key < index.grid.ncells
    own = _decode(torch.where(member, key, 0), index.grid)
    sums = torch.zeros((5, key.shape[0]), dtype=pack.dtype, device=pack.device)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                at = [c + d for c, d in zip(own, (dx, dy, dz))]
                ok = member
                for a, n in zip(at, (nx, ny, nz)):
                    ok = ok & (a >= 0) & (a < n)
                cell = torch.where(ok, (at[0] * ny + at[1]) * nz + at[2], 0)
                sums = torch.where(ok, sums + pack[cell, :5].T, sums)
    return sums


def diffuse_cells_plain(index: CellIndex, pack, colour, ptype, alive, dt):
    """(4, C) colour after one diffusion step: what `diffuse_cells_kernel`
    writes."""
    return mix_colour(colour, neighbour_sums_plain(index, pack), ptype, alive, dt)


# ---------------------------------------------------------------------------
# CUDA kernel launchers
# ---------------------------------------------------------------------------


def _check(index: CellIndex, **tensors) -> None:
    """Raise on anything the kernels do not take."""
    dev, n, ncells = index.key.device, index.key.shape[0], index.grid.ncells
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    want = dict(key=(torch.int32, (n,)), table=(torch.int32, (ncells + 1,)),
                colour=(torch.float32, (4, n)), ptype=(torch.int32, (n,)),
                alive=(torch.bool, (n,)), pack=(torch.float32, (ncells, PACK_WIDTH)),
                dt=(torch.float32, ()))
    tensors = dict(key=index.key, table=index.table, **tensors)
    for name, t in tensors.items():
        dtype, shape = want[name]
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: want a contiguous {dtype} {shape} tensor on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def diffuse_cell_sums_kernel(index: CellIndex, colour, ptype, alive):
    """(ncells, 8) pack from `pbf_diffuse_cell_sums` (replaces the candidate
    sums of `make_diffuse_call`)."""
    _check(index, colour=colour, ptype=ptype, alive=alive)
    ncells = index.grid.ncells
    pack = torch.empty((ncells, PACK_WIDTH), dtype=colour.dtype, device=colour.device)
    with torch.cuda.device(colour.device):
        err = cuda_build.library().pbf_diffuse_cell_sums(
            colour.data_ptr(), ptype.data_ptr(), alive.data_ptr(), index.table.data_ptr(),
            colour.shape[1], ncells, pack.data_ptr(), _stream(colour.device))
    cuda_build.check("pbf_diffuse_cell_sums", err)
    return pack


def diffuse_cells_kernel(index: CellIndex, pack, colour, ptype, alive, dt):
    """(4, C) colour from `pbf_diffuse_cells` (replaces the rest of
    `make_diffuse_call` and the wrapper's mix and clamp)."""
    _check(index, pack=pack, colour=colour, ptype=ptype, alive=alive, dt=dt)
    nx, ny, nz = index.grid.dims
    out = torch.empty_like(colour)
    with torch.cuda.device(colour.device):
        err = cuda_build.library().pbf_diffuse_cells(
            pack.data_ptr(), index.key.data_ptr(), colour.data_ptr(), ptype.data_ptr(),
            alive.data_ptr(), dt.data_ptr(), colour.shape[1], nx, ny, nz, out.data_ptr(),
            _stream(colour.device))
    cuda_build.check("pbf_diffuse_cells", err)
    return out
