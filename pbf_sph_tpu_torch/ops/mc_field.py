"""The marching-cubes lattice field: per node, sums over the particles near it.

Port of `PallasMcField` (`pbf_sph_tpu/ops/pallas_mc.py:276-355`), in three
parts as in `ops/phases.py`:

* `mc_field_kernel` launches the hand-written CUDA kernel of
  `csrc/mc_field.cu` (replaces `make_mc_field_call`, `pallas_mc.py:185`);
* `mc_field_plain` is its plain PyTorch version, with the same signature;
* `McField` is the wrapper: it picks between the two by the device of its
  tensors alone (CPU -> plain; anything else -> the kernel, which raises on a
  tensor it does not take), counts kernel launches, and applies the post-pass
  of `pallas_mc.py:336-355`.

Raw sums, (9, L) fp32 in lattice order (node i = (x*ny + y)*nz + z), rows
[S0, Sx, Sy, Sz, Cr, Cg, Cb, Ca, cnt]: S0 = sum d2^(-infl/2), S = sum
l*d2^(-infl/2) with l = particle - node in world units, the colour sums and
the count, over the non-obstacle members whose sort-time cell lies in the 27
cells around the node's cell c = trunc(node/res), with 0 < d2 < (h*scale)^2.
The cells come from the sort-time key, the distances from the post-finalise
positions: the reference gathers by the pre-solve grid
(`src/omp/ompsph.hpp:335-337`).  The far-corner node (c == extent on every
axis) sums nothing, and the post-pass writes 0 there, as the Pallas path does
(the XLA `mc_field` gives NaN).

Edge semantics: the exact 27-cell neighbourhood, each cell counted once.
The Pallas kernel tests cell-id adjacency inside windows that it clamps to
[0, extent-1] per sub-block (`pallas_mc.py:98-123,243`), so it misses a
neighbour cell whose x, y or z coordinate equals `extent`.  The two agree
whenever no member's sort-time cell coordinate equals `extent`, which the
bounds clamp ensures except for a particle that advect pushed past the bounds
before the solve.  (The XLA `mc_field` instead clamps the stencil,
double-counting edge cells, and adds the Morton guard, `mc.py:173-193`.)

Not carried over: the static cell-sorted node permutation, its window plan
and the multi-operand sort that restores lattice order
(`pallas_mc.py:58-182,336-350`) exist for the TPU's VMEM and lane rules; the
node rows stay in lattice order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops.mc import McSpec
from pbf_sph_tpu_torch.ops.phases import CellIndex, _check_cuda, _stream, nonobstacle


def _constants(mc: McSpec, h: float, scale: float) -> Tuple[float, float]:
    """(step = h/res, th2 = (h*scale)^2) in fp32, as the Pallas path folds them."""
    f = np.float32
    step = f(h) / f(mc.resolution)
    th2 = f(h * scale) * f(h * scale)
    return float(step), float(th2)


def skip_box(mc: McSpec, extent) -> Tuple[int, int, int]:
    """(x0, y0, z0): the skip nodes, whose cell is `extent` on every axis,
    are the corner box [x0:, y0:, z0:] of the lattice (one node when the
    lattice is cut from the grid, as `McSpec.from_extent` cuts it)."""
    f = np.float32
    starts = []
    for a in range(3):
        cell = np.trunc(np.arange(mc.sample[a], dtype=f) / f(mc.resolution))
        starts.append(int(np.searchsorted(cell, f(extent[a]))))
    return tuple(starts)


def lattice_nodes(mc: McSpec, extent, device):
    """(node (3, L) int32 coords, cell (3, L) int32 = trunc(node/res),
    skip (L,) bool: the far-corner node), in lattice order."""
    nx, ny, nz = mc.sample
    idx = torch.arange(nx * ny * nz, dtype=torch.int32, device=device)
    x = idx // (ny * nz)
    rem = idx - x * (ny * nz)
    y = rem // nz
    node = torch.stack([x, y, rem - y * nz])
    res = torch.full((), mc.resolution, dtype=torch.float32, device=device)
    cell = torch.trunc(node.to(torch.float32) / res).to(torch.int32)
    skip = (cell[0] == extent[0]) & (cell[1] == extent[1]) & (cell[2] == extent[2])
    return node, cell, skip


def node_ranges(index: CellIndex, cell, skip):
    """(lo, hi, base), each (9, L) int64: for each node and (dx, dy) column of
    its 27 cells, the sorted candidate range [lo, hi) of cells
    (c.x+dx, c.y+dy, c.z-1..c.z+1) and base = lin(c.x+dx, c.y+dy, c.z), in
    the kernel's order (dx outer, dy inner).  Empty for columns off the grid
    and for the skip node."""
    gnx, gny, gnz = index.grid.dims
    ncells = index.grid.ncells
    table = index.table.long()
    cx, cy, cz = (c.long() for c in cell)
    los, his, bases = [], [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            bx, by = cx + dx, cy + dy
            ok = (bx >= 0) & (bx < gnx) & (by >= 0) & (by < gny) & ~skip
            base = (bx * gny + by) * gnz + cz
            lo = table[torch.clamp(base - 1, 0, ncells)]
            hi = table[torch.clamp(base + 2, 0, ncells)]
            los.append(lo)
            his.append(torch.where(ok, hi, lo))
            bases.append(base)
    return torch.stack(los), torch.stack(his), torch.stack(bases)


def _node_positions(node, mc: McSpec, h: float, scale: float, min_extent):
    """(3, L) world positions (min_extent + node*step)*scale, rounded op by op
    as the kernel computes them."""
    step, _ = _constants(mc, h, scale)
    return torch.stack([(min_extent[a] + node[a].to(torch.float32) * step) * scale
                        for a in range(3)])


def mc_field_plain(index: CellIndex, mc: McSpec, h: float, scale: float,
                   position, colour, nonobs, min_extent, rows_per_block: int = 1 << 15):
    """Raw field sums (9, L) from the plain PyTorch ops; what `mc_field_kernel`
    computes.  `position` (3, C) post-finalise world positions and `colour`
    (4, C) in the sorted order of `index`; `nonobs` (C,) 1.0 where a
    candidate counts; `min_extent` (3,)."""
    dev = position.device
    _, th2 = _constants(mc, h, scale)
    gnz = index.grid.dims[2]
    node, cell, skip = lattice_nodes(mc, index.grid.extent, dev)
    aw = _node_positions(node, mc, h, scale, min_extent)
    lo, hi, base = node_ranges(index, cell, skip)
    key = index.key.long()
    cz = cell[2].long()
    infl = float(mc.influence_static)
    n_nodes = node.shape[1]
    out = torch.zeros((9, n_nodes), dtype=position.dtype, device=dev)
    width = int((hi - lo).max()) if n_nodes else 0
    steps = torch.arange(width, device=dev)
    for r0 in range(0, n_nodes, rows_per_block):
        rows = slice(r0, min(n_nodes, r0 + rows_per_block))
        for s in range(9):
            j = lo[s, rows, None] + steps
            valid = j < hi[s, rows, None]
            j = torch.where(valid, j, 0)
            bz = cz[rows, None] + (key[j] - base[s, rows, None])
            m = valid & (bz >= 0) & (bz < gnz) & (nonobs[j] > 0.5)
            lvec = position[:, j] - aw[:, rows, None]  # (3, R, W)
            d2 = lvec[0] * lvec[0] + lvec[1] * lvec[1] + lvec[2] * lvec[2]
            m = m & (d2 < th2) & (d2 > 0)
            d2 = torch.where(m, d2, 1.0)
            if infl == 0.5:
                w = torch.sqrt(torch.rsqrt(d2))
            else:
                w = torch.exp((-0.5 * infl) * torch.log(d2))
            w = torch.where(m, w, 0.0)
            mf = m.to(position.dtype)
            out[0, rows] += w.sum(1)
            out[1:4, rows] += (lvec * w).sum(2)
            out[4:8, rows] += (colour[:, j] * mf).sum(2)
            out[8, rows] += mf.sum(1)
    return out


def mc_field_kernel(index: CellIndex, mc: McSpec, h: float, scale: float,
                    position, colour, nonobs, min_extent, name: str = "mc_field"):
    """Raw field sums (9, L) from `mc_field` (replaces `make_mc_field_call`),
    or from the launcher `name` of `csrc/mc_field.cu` of the same signature."""
    _check_cuda(index, position=position, colour=colour, nonobs=nonobs)
    if (min_extent.device != position.device or min_extent.dtype != torch.float32
            or tuple(min_extent.shape) != (3,)):
        raise ValueError(f"min_extent: want a (3,) float32 tensor on {position.device}")
    pos4, col4 = mc_field_packs(position, colour, nonobs)
    out = torch.empty((9, int(np.prod(mc.sample))), dtype=torch.float32,
                      device=position.device)
    mc_field_launch(name, index, mc, h, scale, pos4, col4, min_extent.contiguous(), out)
    return out


def mc_field_packs(position, colour, nonobs):
    """The kernel's (C, 4) candidate packs: (x, y, z, nonobs) and the colour."""
    return torch.cat([position, nonobs[None]]).t().contiguous(), colour.t().contiguous()


def mc_field_launch(name: str, index: CellIndex, mc: McSpec, h: float, scale: float,
                    pos4, col4, min_extent, out) -> None:
    """The launcher `name` of `csrc/mc_field.cu` on prebuilt packs into `out`
    (9, L); `mc_field_kernel` checks what it is given."""
    if pos4.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {pos4.device}")
    step, th2 = _constants(mc, h, scale)
    ex, ey, ez = index.grid.extent
    lib = cuda_build.library()
    with torch.cuda.device(pos4.device):
        err = getattr(lib, name)(
            pos4.data_ptr(), col4.data_ptr(), index.key.data_ptr(),
            index.table.data_ptr(), min_extent.data_ptr(), *mc.sample, ex, ey, ez,
            float(mc.resolution), step, float(scale), th2,
            float(mc.influence_static), out.data_ptr(), _stream(pos4.device))
    cuda_build.check(name, err)


def post_pass(raw, mc: McSpec, extent, particle_size):
    """(v (L,), n (3, L), c (4, L)) from the raw sums (`pallas_mc.py:336-348`):
    v = size*S0, n = -S/|S| (NaN for an empty node, as the reference),
    c = Csum/cnt (NaN when cnt = 0), and all of them 0 on the skip node."""
    s = raw[1:4]
    norm = torch.sqrt(s[0] * s[0] + s[1] * s[1] + s[2] * s[2])
    v = particle_size * raw[0]
    n = -s / norm
    c = raw[4:8] / raw[8]
    x0, y0, z0 = skip_box(mc, extent)
    for t in (v, n, c):
        t.view(t.shape[:-1] + tuple(mc.sample))[..., x0:, y0:, z0:] = 0.0
    return v, n, c


class McField:
    """The MC-field wrapper of one solver, with a launch counter:
    `launches["mc_field"]` grows by one each time the wrapper launches the
    CUDA kernel, and at no other time."""

    def __init__(self, h: float):
        self.h = float(h)
        self.launches = {"mc_field": 0}

    def reset_launches(self) -> None:
        self.launches["mc_field"] = 0

    def __call__(self, index: CellIndex, mc: McSpec, scale: float, position,
                 colour, ptype, alive, min_extent, particle_size):
        """(v (L,), n (3, L), c (4, L)) in lattice order."""
        nonobs = nonobstacle(ptype, alive, position.dtype)
        args = (index, mc, self.h, scale, position, colour, nonobs, min_extent)
        if position.device.type == "cpu":
            raw = mc_field_plain(*args)
        else:
            raw = mc_field_kernel(*args)
            self.launches["mc_field"] += 1
        return post_pass(raw, mc, index.grid.extent, particle_size)
