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

Not ported: the blocked two-stage emission (`emit_block`/`emit_cap`) and the
multi-chip hooks (`node_offset`, `cell_offset`, `quirk_grid`, `cube_x_hi`,
`cube_y_hi`).
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


def mc_field(position, colour, ptype, alive, cell_table, grid, min_extent,
             extent, spec: McSpec, cap: int, h: float, scale,
             particle_size, particle_influence):
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

    `position` (3,C), `colour` (4,C); `scale`, `particle_size` and
    `particle_influence` 0-d tensors.  Returns (lat_v (L,), lat_n (3,L),
    lat_c (4,L))."""
    dtype, dev = position.dtype, position.device
    node = _node_grid(spec, dev)
    L = node[0].shape[0]
    res = scalar(spec.resolution, position)
    step = scalar(h, position) / res
    a_world = torch.stack([(min_extent[a] + node[a].to(dtype) * step) * scale
                           for a in range(3)])
    node_cell = [torch.trunc(node[a].to(dtype) / res).to(torch.int32) for a in range(3)]
    skip = ((node_cell[0] == extent[0]) & (node_cell[1] == extent[1])
            & (node_cell[2] == extent[2]))  # the single far-corner node

    choices = []
    for a in range(3):
        lo = torch.clamp(node_cell[a] - 1, 0, extent[a] - 1)
        hi = torch.clamp(node_cell[a] + 1, 0, extent[a] - 1)
        choices.append((lo, node_cell[a], hi))

    gx, gy, gz = grid.dims
    ranges = []
    for ck in (0, 1, 2):  # z choice
        for cj in (0, 1, 2):  # y
            for ci_ in (0, 1, 2):  # x (fastest, the reference's offset order)
                sc = (choices[0][ci_], choices[1][cj], choices[2][ck])
                zc = morton_encode3(sc[0], sc[1], sc[2])
                # reference skip + end-rule (`src/sph.hpp:207-208`)
                ok = (~skip) & (zc < grid.maxz) & (zc + 1 < grid.maxz)
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


def _emit(ntris, offs, tri15, payload, cap3: int):
    """Scatter the live vertex slots of K cubes to their destinations
    `(offs + k//3)*3 + k%3` in a zeroed (10, cap3) buffer.  Dead slots and
    slots past the capacity go to one extra column, which is dropped."""
    dev = ntris.device
    k = torch.arange(3 * mct.MAX_TRIS_PER_CUBE, device=dev)[:, None]  # (15, 1)
    dest = (offs[None, :] + k // 3) * 3 + k % 3  # (15, K)
    dest = torch.where(((k // 3) < ntris[None, :]) & (dest < cap3), dest, cap3)
    e = torch.clamp(tri15, min=0)
    nval, _, kc = payload.shape
    vals = torch.gather(payload, 1, e[None].expand(nval, -1, kc))  # (10, 15, K)
    out = torch.zeros((nval, cap3 + 1), dtype=payload.dtype, device=dev)
    out.index_copy_(1, dest.reshape(-1), vals.reshape(nval, -1))
    return out[:, :cap3]


def mc_extract(lat_v, lat_n, lat_c, min_extent, spec: McSpec, h: float,
               scale, isolevel):
    """Case classification, triangle cumsum and emission of one lattice.

    `lat_v` (L,), `lat_n` (3, L), `lat_c` (4, L) in lattice order;
    `min_extent` (3,), `scale` and `isolevel` are tensors or floats.
    With `spec.cube_cap > 0` the live cubes are first compacted to a fixed
    `cube_cap` rows by a cumsum-scatter of their ids (no host read, no
    `nonzero`); their order is cube order, so the mesh is the one every cube
    would emit.  `emit_overflow` = live cubes beyond the cap (mesh INVALID).

    Returns (vs (3, 3T), ns (3, 3T), cs (4, 3T), total, emit_overflow) with
    T = `spec.tri_capacity`; `total` may exceed T, and then the buffer holds
    the first T triangles."""
    dev, dtype = lat_v.device, lat_v.dtype
    nx, ny, nz = spec.sample
    M = (nx - 1) * (ny - 1) * (nz - 1)
    tables = _tables(dev)
    step = (torch.full((), h, dtype=dtype, device=dev)
            / torch.full((), spec.resolution, dtype=dtype, device=dev))

    idx = torch.arange(M, device=dev)
    vals = _corner_slices(lat_v, spec.sample)  # (8, M)
    ci, ntris = _classify(vals, isolevel, tables)
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
    offs = torch.cumsum(ntris, 0) - ntris  # exclusive
    tri15, payload = _edge_payload(ci, vals, cnrm, ccol, corners, min_extent,
                                   step, scale, isolevel, tables)
    out = _emit(ntris, offs, tri15, payload, spec.tri_capacity * 3)
    return (out[0:3], out[3:6], out[6:10], total.to(torch.int32),
            emit_ovf.to(torch.int32))
