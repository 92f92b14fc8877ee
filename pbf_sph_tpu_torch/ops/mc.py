"""Marching cubes: the static lattice spec, the gather backend's lattice
field and the triangle extraction.

Port of `McSpec`, `mc_field` and `mc_extract` of `pbf_sph_tpu/ops/mc.py`
(reference mc_lattice `src/ocl/oclsph_kernel.h:176-263`, mc_size `:272-318`
and mc_eval `:336-408`).  The kernel backend's lattice field is
`ops/mc_field.py`; `mc_field` here is the XLA field of the gather backend,
plain torch ops on either device.

Extraction, on plain torch ops (XLA ran this stage without a Pallas kernel):
corner values from shifted views of the (nx, ny, nz) lattice, the case index
from `vals < isolevel`, the triangle count per cube and its exclusive cumsum,
the edge lerp with the raw divide (NaN on uncrossed edges, as the reference),
then every vertex of cube m goes to slot `(offs[m] + k//3)*3 + k%3` of a
fixed-capacity buffer whose tail stays zero.  The JAX package emits by sorting
the slots by destination, because a scatter along the minor axis is slow on a
TPU (`mc.py:383-387`); the destinations are unique and dense, so a direct
scatter gives the same order.  Nothing here reads a value back to the host.

Layout as in the JAX package: lattice normals (3, L), colours (4, L), corner
values (8, M), output mesh (3, 3T) / (4, 3T).

The slab and tile engines' hooks (`parallel/sharded.py`,
`parallel/sharded2d.py`; `mc.py:122-196,266-297,367-405,477-561`):
`mc_field` takes `node_offset`, `cell_offset` and `quirk_grid`, `mc_extract`
takes `node_offset`, `cube_x_hi` and `cube_y_hi` with the global `extent`.
An offset or a bound is an int or a 0-d int tensor on the lattice's device
(under rebalancing it follows the slab bounds or tile cuts, and nothing of
it is read back to the host); the lattice itself stays sized by the spec.

The blocked two-stage emission (`McSpec.emit_block`/`emit_cap`,
`mc.py:70-78,411-434`), on the uncompacted path only: the JAX package sorts
each block's slots and then merges the staged rows with a short global sort;
the port scatters twice, each block's live slots to their rank inside the
block in a staging buffer of `smax` columns a block, then the staged rows to
their destinations.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.core.types import OBSTACLE
from pbf_sph_tpu_torch.ops import mc_tables as mct
from pbf_sph_tpu_torch.ops.curves import morton_encode3
from pbf_sph_tpu_torch.ops.pbf import scalar

# Initial staged rows a block of the blocked emission (`mc.py:28-37`); the
# growth policy grows `emit_cap` from it on `emit_overflow`.
EMIT_CAP_DEFAULT = 1280

# Below this march volume the lattice is small enough that emitting from every
# cube is cheap; above it, live cubes are compacted first (`cube_cap`).
CUBE_COMPACT_MIN_VOL = 32768


def default_cube_cap(march_volume: int) -> int:
    """An eighth of the march volume, 128-aligned (`mc.py:51-54`)."""
    if march_volume < CUBE_COMPACT_MIN_VOL:
        return 0
    return min(-(-(march_volume // 8) // 128) * 128, march_volume)


@dataclass(frozen=True)
class McSpec:
    """Static MC geometry derived from the grid extent and the (static)
    resolution: sampleSize = floor(extent*res)+1 (reference
    `src/omp/ompsph.hpp:283-284`)."""

    resolution: float
    sample: Tuple[int, int, int]
    tri_capacity: int
    # particleInfluence baked into the field kernel, as the Pallas kernel
    # bakes it: changing it builds a new spec
    influence_static: float = 0.5
    # Live-cube compaction before emission: the first `cube_cap` live cubes
    # (in cube order) are gathered and emitted; more live cubes than that
    # report `emit_overflow` (the mesh is then INVALID and the growth policy
    # grows the cap).  0 emits from every cube.
    cube_cap: int = 0
    # Blocked two-stage emission, taken only with cube_cap 0: each
    # `emit_block`-cube block stages its live vertex slots in
    # max(128, emit_cap or EMIT_CAP_DEFAULT) rows before the global scatter;
    # a block with more live rows reports `emit_overflow` (mesh INVALID; the
    # growth policy grows emit_cap, then falls back to emit_block 0).
    # emit_block 0 scatters every slot straight to its destination.
    emit_block: int = 0
    emit_cap: int = 0

    @staticmethod
    def from_extent(extent, resolution: float, tri_capacity: int = 0,
                    influence_static: float = 0.5) -> "McSpec":
        f = np.float32
        sample = (np.floor(np.asarray(extent, f) * f(resolution)) + 1).astype(np.int64)
        march = sample - 1
        vol = int(march[0] * march[1] * march[2])
        if tri_capacity <= 0:
            tri_capacity = max(1024, vol)  # ~1 triangle/cube on average
        return McSpec(
            resolution=float(resolution),
            sample=tuple(int(v) for v in sample),
            tri_capacity=int(tri_capacity),
            influence_static=float(influence_static),
            cube_cap=default_cube_cap(vol),
        )


def _node_grid(spec: McSpec, device):
    """Lattice node coords, x slowest: three (L,) int32."""
    nx, ny, nz = spec.sample
    idx = torch.arange(nx * ny * nz, dtype=torch.int32, device=device)
    x = idx // (ny * nz)
    rem = idx - x * (ny * nz)
    y = rem // nz
    return x, y, rem - y * nz


def _offset(value, device) -> torch.Tensor:
    """An int or 0-d tensor offset as a 0-d int32 tensor on `device`."""
    if torch.is_tensor(value):
        return value.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(value), dtype=torch.int32, device=device)


def mc_field(position, colour, ptype, alive, cell_table, grid, min_extent,
             extent, spec: McSpec, cap: int, h: float, scale,
             particle_size, particle_influence,
             node_offset=None, cell_offset=None, quirk_grid=None):
    """Metaball lattice field of the gather backend (reference
    `src/omp/ompsph.hpp:288-356`; `pbf_sph_tpu/ops/mc.py:122-244`, single-chip
    arguments).

    Per node: gather the K-capped candidates of the 27 cells around the
    node's cell, each axis clamped to [0, extent - 1] (so an edge node counts
    an edge cell twice, as the XLA field does); accumulate v += size/len^infl
    over the non-obstacle particles within h*scale, the analytic normal and
    the mean colour.  A cell is gathered only if its Morton code and code + 1
    are below maxz; the node whose cell is the far corner gathers nothing;
    zero-distance particles are skipped.  Normals of a zero field and
    colours of no particle are NaN, as the reference's divisions give them.
    Dead particles lie outside every cell range, so `alive` is not read.

    On a CUDA device every node is summed, as XLA sums them, so that the step
    reads nothing back.  On the CPU, where reading which nodes have a
    candidate costs nothing, only those are summed and the rest get what
    their empty sums give (v 0, n and c NaN): the same bits, ~30x sooner on
    the 2-cube scene's lattice, where most nodes see no particle.

    Slab mode (`parallel/sharded.py`): `spec.sample` covers the local node
    range; `node_offset` (3 offsets) maps local node indices to global ones
    for world positions, clamps and the far-corner skip, `cell_offset` maps
    global cell coords to the local grid's (cells outside the local grid
    contribute nothing), and `quirk_grid` supplies the global grid's Morton
    guard.  Nodes past the global sample (the last slab's padding) are
    skipped.

    `position` (3,C), `colour` (4,C); `scale`, `particle_size` and
    `particle_influence` 0-d tensors.  Returns (lat_v (L,), lat_n (3,L),
    lat_c (4,L))."""
    dtype, dev = position.dtype, position.device
    node = _node_grid(spec, dev)
    L = node[0].shape[0]
    pad_skip = None
    if node_offset is not None:
        node = tuple(node[a] + _offset(node_offset[a], dev) for a in range(3))
        gs = [int(np.floor(extent[a] * spec.resolution)) + 1 for a in range(3)]
        pad_skip = (node[0] >= gs[0]) | (node[1] >= gs[1]) | (node[2] >= gs[2])
    res = scalar(spec.resolution, position)
    step = scalar(h, position) / res
    a_world = torch.stack([(min_extent[a] + node[a].to(dtype) * step) * scale
                           for a in range(3)])
    node_cell = [torch.trunc(node[a].to(dtype) / res).to(torch.int32) for a in range(3)]
    skip = ((node_cell[0] == extent[0]) & (node_cell[1] == extent[1])
            & (node_cell[2] == extent[2]))  # the single far-corner node
    if pad_skip is not None:
        skip = skip | pad_skip

    choices = []
    for a in range(3):
        lo = torch.clamp(node_cell[a] - 1, 0, extent[a] - 1)
        hi = torch.clamp(node_cell[a] + 1, 0, extent[a] - 1)
        choices.append((lo, node_cell[a], hi))

    maxz = (quirk_grid or grid).maxz
    cell_off = None if cell_offset is None else [_offset(c, dev) for c in cell_offset]
    gx, gy, gz = grid.dims
    ranges = []
    for ck in (0, 1, 2):  # z choice
        for cj in (0, 1, 2):  # y
            for ci_ in (0, 1, 2):  # x (fastest, the reference's offset order)
                sc = (choices[0][ci_], choices[1][cj], choices[2][ck])
                zc = morton_encode3(sc[0], sc[1], sc[2])
                # reference skip + end-rule (`src/sph.hpp:207-208`)
                ok = (~skip) & (zc < maxz) & (zc + 1 < maxz)
                if cell_off is not None:
                    sc = tuple(sc[a] + cell_off[a] for a in range(3))
                    # cells outside the local grid contribute nothing (a
                    # clipped index would alias them onto its last cell)
                    ok = (ok & (sc[0] >= 0) & (sc[0] < gx) & (sc[1] >= 0) & (sc[1] < gy)
                          & (sc[2] >= 0) & (sc[2] < gz))
                lin = torch.where(ok, (sc[0] * gy + sc[1]) * gz + sc[2], 0)
                lin = torch.clamp(lin, 0, gx * gy * gz - 1).long()
                ranges.append((torch.where(ok, cell_table[lin], 0),
                               torch.where(ok, cell_table[lin + 1], 0)))

    nodes = None
    if dev.type == "cpu":
        nodes = torch.nonzero(torch.stack([e > s for s, e in ranges]).any(0))[:, 0]
        ranges = [(s[nodes], e[nodes]) for s, e in ranges]
        a_world = a_world[:, nodes]
    v, n, c = _field_sums(position, colour, ptype, ranges, a_world, cap,
                          scalar(h, position) * scale, particle_size, particle_influence)
    if nodes is None:
        return v, n, c
    nan = float("nan")
    return (torch.zeros(L, dtype=dtype, device=dev).index_copy_(0, nodes, v),
            torch.full((3, L), nan, dtype=dtype, device=dev).index_copy_(1, nodes, n),
            torch.full((4, L), nan, dtype=dtype, device=dev).index_copy_(1, nodes, c))


def _field_sums(position, colour, ptype, ranges, a_world, cap: int, threshold,
                particle_size, particle_influence):
    """`mc_field`'s sums over the K-capped candidates of each node's 27
    `ranges` ((N,) start and end each) for nodes at `a_world` (3, N):
    (v (N,), n (3, N), c (4, N))."""
    dtype, dev = position.dtype, position.device
    N = a_world.shape[1]
    v_acc = torch.zeros(N, dtype=dtype, device=dev)
    n_acc = [torch.zeros_like(v_acc) for _ in range(3)]
    c_acc = [torch.zeros_like(v_acc) for _ in range(4)]
    cnt = torch.zeros(N, dtype=torch.int32, device=dev)
    coef = (-particle_influence) * particle_size
    karange = torch.arange(cap, device=dev)[:, None]
    for start, end in ranges:
        idx = start[None, :].long() + karange  # (K, N)
        mask = idx < end[None, :]
        idx = torch.where(mask, idx, 0)

        lvec = [position[a][idx] - a_world[a][None, :] for a in range(3)]
        dist = torch.sqrt(lvec[0] * lvec[0] + lvec[1] * lvec[1] + lvec[2] * lvec[2])
        use = mask & (ptype[idx] != OBSTACLE) & (dist < threshold)
        denom = dist ** particle_influence
        use = use & (denom > 0)
        denom_safe = torch.where(use, denom, 1.0)
        v_acc = v_acc + torch.sum(torch.where(use, particle_size / denom_safe, 0.0), 0)
        usef = use.to(dtype)
        for a in range(3):
            n_acc[a] = n_acc[a] + torch.sum(coef * (lvec[a] / denom_safe) * usef, 0)
        for a in range(4):
            c_acc[a] = c_acc[a] + torch.sum(colour[a][idx] * usef, 0)
        cnt = cnt + torch.sum(use, 0, dtype=torch.int32)

    n_norm = torch.sqrt(n_acc[0] * n_acc[0] + n_acc[1] * n_acc[1] + n_acc[2] * n_acc[2])
    lat_n = torch.stack([n_acc[a] / n_norm for a in range(3)])  # NaN when empty
    cntf = cnt.to(dtype)
    lat_c = torch.stack([c_acc[a] / cntf for a in range(4)])  # NaN when cnt == 0
    return v_acc, lat_n, lat_c


class _Tables(NamedTuple):
    """The MC tables as int64 tensors on one device."""

    ntris: torch.Tensor  # (256,) triangles per case, 0 where EDGE_TABLE is 0
    tri15: torch.Tensor  # (256, 15) edge ids of each case, -1-padded
    bits: torch.Tensor  # (8, 1) 1 << corner
    offsets: torch.Tensor  # (8, 3, 1) CUBE_OFFSETS
    e_from: torch.Tensor  # (12,) first corner of each edge
    e_to: torch.Tensor  # (12,) second corner


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
    """The tables on `device`, copied there once."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    return _Tables(
        ntris=t(np.where(mct.EDGE_TABLE == 0, 0, mct.NUM_VERTS_TABLE // 3)),
        tri15=t(mct.TRI_TABLE[:, :15]),
        bits=t(1 << np.arange(8))[:, None],
        offsets=t(mct.CUBE_OFFSETS)[:, :, None],
        e_from=t(mct.EDGE_CORNERS[:, 0]),
        e_to=t(mct.EDGE_CORNERS[:, 1]),
    )


def _corner_slices(lat, sample):
    """(..., L) lattice -> (8, ..., M) corner values, one shifted view of the
    (nx, ny, nz) lattice per cube corner."""
    nx, ny, nz = sample
    mx, my, mz = nx - 1, ny - 1, nz - 1
    lead = tuple(lat.shape[:-1])
    lat3 = lat.reshape(lead + (nx, ny, nz))
    views = [lat3[..., o0:o0 + mx, o1:o1 + my, o2:o2 + mz]
             for o0, o1, o2 in mct.CUBE_OFFSETS.tolist()]
    return torch.stack(views).reshape((8,) + lead + (mx * my * mz,))


def _corners(cube, spec: McSpec, tables: _Tables):
    """(8, 3, K) node coords of the corners of the cubes with ids `cube`."""
    _, my, mz = (s - 1 for s in spec.sample)
    cx = cube // (my * mz)
    rem = cube - cx * (my * mz)
    cy = rem // mz
    return torch.stack([cx, cy, rem - cy * mz])[None] + tables.offsets


def _classify(vals, isolevel, tables: _Tables):
    """Case index (bit i set when corner i < isolevel) and triangles per cube."""
    ci = ((vals < isolevel) * tables.bits).sum(0)
    return ci, tables.ntris[ci]


def _edge_payload(ci, vals, cnrm, ccol, corners, min_extent, step, scale,
                  isolevel, tables: _Tables):
    """Edge-lerped payload of K cubes from their corner node coords `corners`
    (8, 3, K): (tri15 (15, K) edge ids, -1-padded; payload (10, 12, K) =
    position (3), normal (3), colour (4) per edge)."""
    cpos = (min_extent[:, None] + corners.to(vals.dtype) * step) * scale  # (8, 3, K)
    attrs = torch.cat([cpos, cnrm, ccol], dim=1)  # (8, 10, K)
    v0, v1 = vals[tables.e_from], vals[tables.e_to]  # (12, K)
    # raw divide: uncrossed edges give NaN like the reference's unconditional
    # lerp; TRI_TABLE never selects them
    t = (isolevel - v0) / (v1 - v0)
    a, b = attrs[tables.e_from], attrs[tables.e_to]  # (12, 10, K)
    payload = (a + t[:, None] * (b - a)).transpose(0, 1)
    return tables.tri15[ci].T, payload


def slot_rows(ntris, offs, tri15, payload):
    """The 15 vertex slots of each of K cubes: (dest (15, K) int64, the
    destination `(offs + k//3)*3 + k%3` of slot k; live (15, K), slot k
    holds a vertex; vals (10, 15, K), its position, normal and colour)."""
    k = torch.arange(3 * mct.MAX_TRIS_PER_CUBE, device=ntris.device)[:, None]  # (15, 1)
    dest = (offs[None, :] + k // 3) * 3 + k % 3
    e = torch.clamp(tri15, min=0)
    nval, _, kc = payload.shape
    vals = torch.gather(payload, 1, e[None].expand(nval, -1, kc))
    return dest, (k // 3) < ntris[None, :], vals


def _emit(ntris, offs, tri15, payload, cap3: int):
    """Scatter the live vertex slots of K cubes to their destinations in a
    zeroed (10, cap3) buffer.  Dead slots and slots past the capacity go to
    one extra column, which is dropped."""
    dest, live, vals = slot_rows(ntris, offs, tri15, payload)
    dest = torch.where(live & (dest < cap3), dest, cap3)
    nval = vals.shape[0]
    out = torch.zeros((nval, cap3 + 1), dtype=payload.dtype, device=ntris.device)
    out.index_copy_(1, dest.reshape(-1), vals.reshape(nval, -1))
    return out[:, :cap3]


def _emit_blocked(ntris, offs, tri15, payload, cap3: int, block: int, emit_cap: int):
    """`_emit` in two stages, for M cubes in blocks of `block`: stage 1
    scatters each block's live vertex slots to their rank inside the block
    (destination minus the block's first destination: a block's
    destinations are consecutive) in a (10, nblk * scut) staging buffer,
    scut = min(smax, 15 * block); stage 2 scatters the staged rows to the
    block's first destination plus their rank.  A block with more than smax
    live rows drops the rest.  Returns (out (10, cap3), emit_overflow =
    max(max_b live_b - smax, 0))."""
    dev = ntris.device
    M = ntris.shape[0]
    nblk = -(-M // block)
    smax = max(128, emit_cap or EMIT_CAP_DEFAULT)
    scut = min(smax, 15 * block)
    blk = torch.arange(nblk, device=dev)
    first = offs[blk * block] * 3  # each block's first destination
    ends = torch.clamp((blk + 1) * block, max=M) - 1
    live_b = (offs[ends] + ntris[ends]) * 3 - first  # (nblk,)
    emit_ovf = torch.clamp(live_b.max() - smax, min=0)

    dest, live, vals = slot_rows(ntris, offs, tri15, payload)
    cube_blk = torch.arange(M, device=dev) // block
    rank = dest - first[cube_blk][None, :]  # (15, M)
    nstage = nblk * scut
    stage = torch.where(live & (rank < scut), cube_blk[None, :] * scut + rank, nstage)
    nval = vals.shape[0]
    staged = torch.zeros((nval, nstage + 1), dtype=payload.dtype, device=dev)
    staged.index_copy_(1, stage.reshape(-1), vals.reshape(nval, -1))

    j = torch.arange(scut, device=dev)[None, :]
    dest = first[:, None] + j  # (nblk, scut)
    dest = torch.where((j < live_b[:, None]) & (dest < cap3), dest, cap3)
    out = torch.zeros((nval, cap3 + 1), dtype=payload.dtype, device=dev)
    out.index_copy_(1, dest.reshape(-1), staged[:, :nstage])
    return out[:, :cap3], emit_ovf


def _in_volume(cube, spec: McSpec, extent, node_offset, cube_x_hi, cube_y_hi):
    """Slab and tile mode: cubes whose global min corner lies inside the
    global march volume and, with `cube_x_hi` / `cube_y_hi`, below that
    global x / y (the next slab's or tile's cubes), for cube ids `cube`
    (K,)."""
    dev = cube.device
    _, my, mz = (s - 1 for s in spec.sample)
    cx = cube // (my * mz)
    rem = cube - cx * (my * mz)
    cy = rem // mz
    ok = None
    for a, (c, hi) in enumerate(zip((cx, cy, rem - cy * mz), (cube_x_hi, cube_y_hi, None))):
        g = c + _offset(node_offset[a], dev)
        m = g < int(np.floor(extent[a] * spec.resolution))
        if hi is not None:
            m = m & (g < _offset(hi, dev))
        ok = m if ok is None else ok & m
    return ok


def _global_corners(corners, node_offset):
    """(8, 3, K) local corner node coords shifted by `node_offset`."""
    dev = corners.device
    off = torch.stack([_offset(o, dev) for o in node_offset]).to(corners.dtype)
    return corners + off[None, :, None]


def emission_inputs(lat_v, lat_n, lat_c, min_extent, spec: McSpec, h: float,
                    scale, isolevel, node_offset=None, cube_x_hi=None, extent=None,
                    cube_y_hi=None):
    """`mc_extract` up to the emission, the same arguments: (ntris (K,),
    offs (K,) exclusive, total, tri15 (15, K), payload (10, 12, K),
    emit_overflow) of the K = M cubes, or of the `cube_cap` compacted ones
    (and then emit_overflow = live cubes beyond the cap)."""
    dev, dtype = lat_v.device, lat_v.dtype
    nx, ny, nz = spec.sample
    M = (nx - 1) * (ny - 1) * (nz - 1)
    tables = _tables(dev)
    step = (torch.full((), h, dtype=dtype, device=dev)
            / torch.full((), spec.resolution, dtype=dtype, device=dev))

    idx = torch.arange(M, device=dev)
    vals = _corner_slices(lat_v, spec.sample)  # (8, M)
    ci, ntris = _classify(vals, isolevel, tables)
    if node_offset is not None:
        ntris = torch.where(_in_volume(idx, spec, extent, node_offset, cube_x_hi, cube_y_hi),
                            ntris, 0)
    total = ntris.sum()
    if spec.cube_cap > 0:
        K = min(int(spec.cube_cap), M)
        live = ntris > 0
        nlive = live.sum()
        rank = torch.cumsum(live, 0) - 1
        slot = torch.where(live & (rank < K), rank, K)
        cube = torch.zeros(K + 1, dtype=torch.int64, device=dev)
        cube = cube.index_copy_(0, slot, idx)[:K]  # live ids first; dead rows hold 0
        live_c = torch.arange(K, device=dev) < torch.clamp(nlive, max=K)
        corners = _corners(cube, spec, tables)
        nodes = (corners[:, 0] * ny + corners[:, 1]) * nz + corners[:, 2]  # (8, K)
        vals = lat_v[nodes]
        cnrm = lat_n[:, nodes].transpose(0, 1)  # (8, 3, K)
        ccol = lat_c[:, nodes].transpose(0, 1)  # (8, 4, K)
        ci, ntris = _classify(vals, isolevel, tables)
        ntris = torch.where(live_c, ntris, 0)
        emit_ovf = torch.clamp(nlive - K, min=0)
    else:
        emit_ovf = torch.zeros((), dtype=torch.int64, device=dev)
        corners = _corners(idx, spec, tables)
        cnrm = _corner_slices(lat_n, spec.sample)  # (8, 3, M)
        ccol = _corner_slices(lat_c, spec.sample)  # (8, 4, M)
    if node_offset is not None:
        corners = _global_corners(corners, node_offset)
    offs = torch.cumsum(ntris, 0) - ntris  # exclusive
    tri15, payload = _edge_payload(ci, vals, cnrm, ccol, corners, min_extent,
                                   step, scale, isolevel, tables)
    return ntris, offs, total, tri15, payload, emit_ovf


def mc_extract(lat_v, lat_n, lat_c, min_extent, spec: McSpec, h: float,
               scale, isolevel, node_offset=None, cube_x_hi=None, extent=None,
               cube_y_hi=None):
    """Case classification, triangle cumsum and emission of one lattice.

    `lat_v` (L,), `lat_n` (3, L), `lat_c` (4, L) in lattice order;
    `min_extent` (3,), `scale` and `isolevel` are tensors or floats.
    With `spec.cube_cap > 0` the live cubes are first compacted to a fixed
    `cube_cap` rows by a cumsum-scatter of their ids (no host read, no
    `nonzero`); their order is cube order, so the mesh is the one every cube
    would emit.  `emit_overflow` = live cubes beyond the cap (mesh INVALID).
    Otherwise, with `spec.emit_block > 0`, the slots are emitted in two
    stages (`_emit_blocked`): the mesh equals the one-stage scatter's bit for
    bit while no block holds more live rows than its staging rows, and
    `emit_overflow` = the most live rows of a block beyond them (mesh
    INVALID: rows were dropped).

    Slab and tile mode (`parallel/sharded.py`, `parallel/sharded2d.py`):
    `node_offset` maps local cube and node coords to global ones for the
    vertex positions, and cubes outside the global march volume of `extent`
    (the grid extent) or, with `cube_x_hi` / `cube_y_hi`, at global x >=
    cube_x_hi / y >= cube_y_hi emit nothing.

    Returns (vs (3, 3T), ns (3, 3T), cs (4, 3T), total, emit_overflow) with
    T = `spec.tri_capacity`; `total` may exceed T, and then the buffer holds
    the first T triangles."""
    ntris, offs, total, tri15, payload, emit_ovf = emission_inputs(
        lat_v, lat_n, lat_c, min_extent, spec, h, scale, isolevel, node_offset,
        cube_x_hi, extent, cube_y_hi)
    if spec.cube_cap <= 0 and spec.emit_block > 0:
        out, emit_ovf = _emit_blocked(ntris, offs, tri15, payload, spec.tri_capacity * 3,
                                      spec.emit_block, spec.emit_cap)
    else:
        out = _emit(ntris, offs, tri15, payload, spec.tri_capacity * 3)
    return (out[0:3], out[3:6], out[6:10], total.to(torch.int32),
            emit_ovf.to(torch.int32))
