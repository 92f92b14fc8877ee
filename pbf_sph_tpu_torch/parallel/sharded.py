"""The 1D slab engine: the particle set decomposed into x-slabs over D ranks.

Port of `pbf_sph_tpu/parallel/sharded.py`.  Each rank owns the particles
inside its slab of global x-columns (fixed slabs of `slab_w` columns, or
boundaries re-partitioned from the particle x-CDF every frame under
`rebalance`), and each frame

  1. kills the ghost tail, spawns (only the rank owning a source's x-slab)
     and drains,
  2. advects locally,
  3. migrates particles whose new cell crossed a slab boundary to the
     neighbouring rank (one hop, `migrate_cap` slots a direction; the rest
     is deferred, alive, to the next frame),
  4. exchanges the one-cell-deep boundary columns as ghosts, installed in the
     tail slots [cap_local, cap_local + 2 ghost_cap),
  5. sorts over the local grid (the slab's columns and one ghost column each
     side) and runs the single-chip phase pipeline (`neighbour_phases`: the
     kernel backend or the gather backend) with the ghosts' lambda and pStar
     refreshed from their owners after every lambda and every delta, so
     every owned particle sees the neighbourhood a single-device run gives
     it,
  6. finalises, extracts its slab's marching cubes (the XLA field, as the
     JAX step does), drops the ghosts, compacts alive rows to the front and,
     under `rebalance`, moves each boundary by at most `rebalance_step`
     columns toward equal counts.

A rank's step talks to the others only through its communicator
(`parallel/comm.py`): `exchange` in place of `ppermute`, `all_reduce_sum` in
place of `psum`.  Where JAX refreshes pStar axis by axis, the port sends the
three axes in one (3, n) exchange: the values are the same.  The interaction
radius h is one grid cell, so a one-cell ghost layer suffices.

`ShardSpec.gather` takes the place of the JAX spec's `use_pallas`
(`gather=False` is `use_pallas=True`: the kernel backend; the default is the
gather backend, as JAX's default is its XLA path).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pbf_sph_tpu_torch.core.types import FLUID, FluidState, ParticleSoA, Scene
from pbf_sph_tpu_torch.models.torch_solver import (
    CAPACITY_ALIGN,
    SceneSpec,
    StepSpec,
    Tensors,
    _apply_drains,
    _apply_sources,
    neighbour_phases,
    scene_arrays_of,
    scene_spec_of,
)
from pbf_sph_tpu_torch.ops import pbf
from pbf_sph_tpu_torch.ops.curves import morton_encode3
from pbf_sph_tpu_torch.ops.grid import GridSpec, build_cell_table, cell_coords, sort_key
from pbf_sph_tpu_torch.ops.mc import McSpec, default_cube_cap, mc_extract
from pbf_sph_tpu_torch.ops.mc import mc_field as gather_mc_field
from pbf_sph_tpu_torch.ops.pbf import scalar
from pbf_sph_tpu_torch.ops.phases import CellIndex, PbfPhases
from pbf_sph_tpu_torch.parallel.comm import all_gather_cat, require_device

# stats of one value a rank, (n_dev,) once assembled
PER_RANK_STATS = ("alive_count", "extent_ok", "migrate_dropped", "migrate_deferred",
                  "ghost_dropped", "ghost_peak", "spawn_dropped", "strip_overflow",
                  "query_overflow", "tri_count", "mc_emit_overflow")


@dataclass(frozen=True)
class ShardSpec:
    n_dev: int
    cap_local: int        # owned-particle capacity a rank
    ghost_cap: int        # ghost slots a side
    migrate_cap: int      # migration slots a direction a frame
    slab_w: int           # owned columns a rank (fixed mode)
    grid_global: GridSpec
    h: float
    scale: float
    iteration: int
    cell_capacity: int
    dtype: str = "float32"
    scene: SceneSpec = SceneSpec()
    # True: the gather backend (K-capped gathers, plain torch ops); False: the
    # kernel backend (the CUDA kernels of ops/phases.py)
    gather: bool = True
    # initial-bounds min x (world space); used only by distribute_particles
    min_bound_x: float = 0.0
    # the LOCAL marching-cubes spec (max_slab_w*res+1 node columns); None =
    # no surface
    surface: Optional[McSpec] = None
    # dynamic slab boundaries: (n_dev+1,) x-columns re-partitioned from the
    # global particle x-CDF every frame, each moving at most rebalance_step
    # columns a frame, each slab min_slab_w..max_slab_w columns wide, which
    # keeps migration to one slab hop
    rebalance: bool = False
    rebalance_step: int = 1
    min_slab_w: int = 3
    # widest slab under rebalancing (columns); 0 = 3x the uniform width,
    # clamped feasible
    max_slab_cap: int = 0

    @property
    def grid_local(self) -> GridSpec:
        """Slab columns plus one ghost column each side, sized for the widest
        slab; no Morton quirks (a slab's far corner is an interior cell)."""
        _, gy, gz = self.grid_global.dims
        return GridSpec(extent=(self.max_slab_w + 1, gy - 1, gz - 1),
                        maxz=self.grid_global.maxz, quirks=False)

    @property
    def max_slab_w(self) -> int:
        if not self.rebalance:
            return self.slab_w
        gx = self.grid_global.dims[0]
        cap = self.max_slab_cap or -(-3 * gx // self.n_dev)
        cap = max(cap, self.min_slab_w, -(-gx // self.n_dev))
        return min(cap, gx - (self.n_dev - 1) * self.min_slab_w)

    def uniform_bounds(self) -> np.ndarray:
        """Fixed-mode slab boundaries: [0, slab_w, 2*slab_w, ..., gx]."""
        gx = self.grid_global.dims[0]
        b = np.minimum(np.arange(self.n_dev + 1) * self.slab_w, gx)
        b[-1] = gx
        return b.astype(np.int32)

    def initial_bounds(self, soa) -> np.ndarray:
        """Equal-count boundaries from a host-side particle histogram (the
        rebalance criterion applied to the initial state)."""
        if not self.rebalance:
            return self.uniform_bounds()
        gx = self.grid_global.dims[0]
        scale = np.float32(self.scale)
        h = np.float32(self.h)
        min_ext_x = np.float32(self.min_bound_x) / scale - h * 2
        gcx = np.trunc(
            (soa.position[:, 0].astype(np.float32) / scale - min_ext_x) / h
        ).astype(np.int64)
        hist = np.bincount(np.clip(gcx, 0, gx - 1), minlength=gx)
        cdf = np.cumsum(hist)
        total = int(cdf[-1])
        mw, xw = self.min_slab_w, self.max_slab_w
        b = [0]
        for d in range(1, self.n_dev):
            target = total * d / self.n_dev
            v = int(np.searchsorted(cdf, target, side="left")) + 1
            v = min(max(v, b[-1] + mw, gx - xw * (self.n_dev - d)),
                    gx - mw * (self.n_dev - d), b[-1] + xw)
            b.append(v)
        b.append(gx)
        return np.asarray(b, np.int32)

    @property
    def cap_total(self) -> int:
        return self.cap_local + 2 * self.ghost_cap

    @staticmethod
    def create(config, n_dev: int, count: int, h: float,
               cell_capacity: int = 48, dtype: str = "float32",
               cap_local: int = 0, scene: Scene = None,
               gather: bool = True,
               rebalance: bool = False, ghost_cap: int = 0,
               min_slab_w: int = 3) -> "ShardSpec":
        """The JAX spec's sizing (`sharded.py:154-264`)."""
        grid = GridSpec.from_bounds(config.min_bound, config.max_bound, config.scale, h)
        gx = grid.dims[0]
        slab_w = -(-gx // n_dev)
        sspec = scene_spec_of(scene or Scene(), config)
        if rebalance and config.surface is not None:
            # the MC node partition follows the dynamic bounds, so
            # bounds[d]*res must be a whole node index for every column
            if not float(config.surface.resolution).is_integer():
                raise ValueError(
                    "rebalance + surface requires an integer MC resolution "
                    "(the dynamic node partition shifts by whole columns)")
        if rebalance and gx < n_dev * min_slab_w:
            raise ValueError(
                f"rebalance: grid has {gx} x-columns but {n_dev} slabs of "
                f">= {min_slab_w} columns need {n_dev * min_slab_w} — use "
                f"fewer devices, a finer grid (smaller scale), or a smaller "
                f"min_slab_w"
            )
        if cap_local <= 0 and rebalance:
            # equal-count slabs hold near count/n_dev; 2.5x headroom for the
            # imbalance between rebalances
            per = (count + sspec.total_spawn) / n_dev
            cap_local = max(256, -(-int(per * 2.5) // 128) * 128)
        if cap_local <= 0:
            # fixed slabs: the whole set (a dam column can sit inside one slab)
            cap_local = max(256, -(-int(count + sspec.total_spawn) // 128) * 128)
        gy, gz = grid.dims[1], grid.dims[2]
        if ghost_cap <= 0:
            # worst case: 8 particles a boundary-column cell
            ghost_cap = max(128, -(-(gy * gz * 8) // 128) * 128)
        ghost_cap = min(ghost_cap, cap_local)
        # a boundary move hands a whole column to a neighbour in one frame
        migrate_cap = cap_local if rebalance else min(cap_local, max(128, ghost_cap))
        if not gather:
            # the kernel backend's capacity alignment (the JAX spec pads to
            # the Pallas block)
            total = cap_local + 2 * ghost_cap
            cap_local += -(-total // CAPACITY_ALIGN) * CAPACITY_ALIGN - total
        spec = ShardSpec(
            n_dev=n_dev,
            cap_local=cap_local,
            ghost_cap=ghost_cap,
            migrate_cap=migrate_cap,
            slab_w=slab_w,
            grid_global=grid,
            h=h,
            scale=float(config.scale),
            iteration=int(config.iteration),
            cell_capacity=cell_capacity,
            dtype=dtype,
            scene=sspec,
            gather=gather,
            min_bound_x=float(np.asarray(config.min_bound, np.float32)[0]),
            surface=None,
            rebalance=rebalance,
            min_slab_w=min_slab_w,
        )
        if config.surface is not None:
            res = float(config.surface.resolution)
            # the local lattice is sized for the widest slab; the bounds mask
            # the owned cubes each frame
            nodes_x = spec.max_slab_w * res
            if nodes_x != int(nodes_x):
                raise ValueError("sharded MC requires slab_w * resolution to be integral")
            gspec = McSpec.from_extent(
                grid.extent, res,
                influence_static=float(config.surface.particle_influence))
            local_sample = (int(nodes_x) + 1, gspec.sample[1], gspec.sample[2])
            local_vol = int(np.prod([s - 1 for s in local_sample]))
            surface = dataclasses.replace(
                gspec,
                sample=local_sample,
                tri_capacity=max(1024, -(-gspec.tri_capacity // n_dev) * 2),
                cube_cap=default_cube_cap(local_vol),
            )
            spec = dataclasses.replace(spec, surface=surface)
        return spec


def _equal_count_target(total, d: int, n: int):
    """floor(total * d / n) without the product that overflows int32:
    total = q*n + r gives q*d + (r*d)//n, every term < 2^31 (q*d <= total,
    r*d < n^2).  `total` an int or an int32 tensor."""
    q, r = total // n, total % n
    return q * d + (r * d) // n


def _owner_of_col(bounds, gcx, n_dev: int):
    """Owning rank of global x-column gcx (int32) under slab boundaries
    `bounds` ((n_dev+1,) int32 ascending, bounds[0] = 0, bounds[-1] = gx)."""
    o = torch.searchsorted(bounds, gcx, right=True).to(torch.int32) - 1
    return torch.clamp(o, 0, n_dev - 1)


def _compact_first(flag, cap: int):
    """Indices of the first `cap` rows where flag is True (padded with the
    remaining rows); returns (idx (cap,), valid (cap,))."""
    order = torch.argsort((~flag).to(torch.int32), stable=True)
    idx = order[:cap]
    return idx, flag[idx]


def _column(x_sim, min_extent_x, h):
    """Global x-column of sim-space x, clipped to +-2e9 before the cast (a
    NaN maps to 2e9, as in `cell_coords`: its int32 cast is undefined)."""
    c = torch.clamp((x_sim - min_extent_x) / h, -2e9, 2e9)
    return torch.trunc(torch.nan_to_num(c, nan=2e9)).to(torch.int32)


def _centre_cell_queries(scene: SceneSpec, grid_local: GridSpec, grid_global: GridSpec,
                         comm, scn, locate, pid, ptype, alive, table, min_extent, h, scale):
    """Point queries over the owning rank's centre cell (reference
    `src/omp/ompsph.hpp:167-186` with the Morton guard), merged over the
    ranks by one sum: the owner contributes id + 1, the others 0, and an
    empty slot decodes back to -1.  `locate(cell)` gives, for a query's
    global (3,) cell, whether this rank owns it and its local (x, y, z)
    cell.  Returns replicated (n_queries, qcap) ids and (n_queries,)
    counts, and the overflow."""
    qcap = scene.query_capacity
    dev = pid.device
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if scene.n_queries == 0:
        return (torch.zeros((0, qcap), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev), overflow)
    _, lny, lnz = grid_local.dims
    gdims = grid_global.dims
    gmaxz = grid_global.maxz
    steps = torch.arange(qcap, dtype=torch.int32, device=dev)
    rows = []
    for qi in range(scene.n_queries):
        qcell = torch.trunc((scn["q_point"][qi] / scale - min_extent) / h).to(torch.int32)
        in_range = torch.stack(
            [(qcell[a] >= 0) & (qcell[a] < n) for a, n in enumerate(gdims)]).all()
        safe = torch.where(in_range, qcell, 0)
        zq = morton_encode3(safe[0], safe[1], safe[2])
        ok = in_range & (zq < gmaxz) & (zq + 1 < gmaxz)
        owned, (lx, ly, lz) = locate(safe)
        mine = ok & owned
        # 1-element gathers: indexing by a 0-d tensor would read it to the host
        lin = torch.where(mine, (lx * lny + ly) * lnz + lz, 0).reshape(1).long()
        start = torch.where(mine, table[lin], 0)
        end = torch.where(mine, table[lin + 1], 0)
        idx = start + steps
        m = idx < end
        idxc = torch.where(m, idx, 0).long()
        keep = m & (ptype[idxc] == FLUID) & alive[idxc]
        ids = torch.where(keep, pid[idxc] + 1, 0)
        rows.append(torch.cat([ids, keep.sum().to(torch.int32).reshape(1)]))
        overflow = torch.maximum(overflow,
                                 torch.where(mine, (end - start) - qcap, 0).reshape(()))
    merged = comm.all_reduce_sum(torch.stack(rows))
    return merged[:, :qcap] - 1, merged[:, qcap], torch.clamp(overflow, min=0)


def _sharded_queries(spec: ShardSpec, comm, scn, b_me, bounds, pid, ptype, alive,
                     table, min_extent):
    """`_centre_cell_queries` over the slabs: the owner by x-column, owned
    local columns 1..w_me."""
    def locate(cell):
        owner = _owner_of_col(bounds, cell[:1], spec.n_dev)[0]
        return owner == comm.rank, (cell[0] - b_me + 1, cell[1], cell[2])

    return _centre_cell_queries(spec.scene, spec.grid_local, spec.grid_global, comm, scn,
                                locate, pid, ptype, alive, table, min_extent,
                                scalar(spec.h, min_extent), scalar(spec.scale, min_extent))


def _pack_migrants(fields, flag, cap: int, capacity: int):
    """The first `cap` rows where `flag` holds, as a payload of every field
    and `valid`, and the (capacity,) mask of the rows sent."""
    idx, valid = _compact_first(flag, cap)
    buf = {k: torch.where(valid, v[idx], 0) for k, v in fields.items()}
    buf["valid"] = valid
    sent = torch.zeros(capacity, dtype=torch.bool, device=flag.device)
    sent[idx] = valid
    return buf, sent


def _merge_migrants(fields, alive, recv, cap_local: int, cap: int):
    """`recv`'s immigrants into the first `cap` dead owned slots (`fields`
    updated in place); returns the new alive mask and the count refused."""
    slots, _ = _compact_first(~alive[:cap_local], cap)
    can = ~alive[slots] & recv["valid"]
    for k, v in fields.items():
        v[slots] = torch.where(can, recv[k].to(v.dtype), v[slots])
    alive = alive.clone()
    alive[slots] = alive[slots] | can
    return alive, recv["valid"].sum() - can.sum()


def _ghost_payload(idx, valid, rows):
    """Ghost rows `idx` of `rows` (pstar, position, mass, ptype, colour):
    positions 1e9 and the rest 0 where not `valid`."""
    pstar, position, mass, ptype, colour = rows
    far = dict(px=pstar[0], py=pstar[1], pz=pstar[2],
               posx=position[0], posy=position[1], posz=position[2])
    near = dict(mass=mass, ptype=ptype, cr=colour[0], cg=colour[1], cb=colour[2],
                ca=colour[3])
    g = {k: torch.where(valid, v[idx], 1e9) for k, v in far.items()}
    g.update({k: torch.where(valid, v[idx], 0) for k, v in near.items()})
    g["valid"] = valid
    return g


def _install_ghosts(g, lo: int, n: int, rows, alive) -> None:
    """A ghost payload into slots [lo, lo + n) of `rows` and `alive`, in place."""
    pstar, position, mass, ptype, colour = rows
    sl = slice(lo, lo + n)
    for a, ax in enumerate("xyz"):
        pstar[a, sl] = g["p" + ax]
        position[a, sl] = g["pos" + ax]
    mass[sl] = g["mass"].to(mass.dtype)
    ptype[sl] = g["ptype"]
    for a, c in enumerate(("cr", "cg", "cb", "ca")):
        colour[a, sl] = g[c]
    alive[sl] = g["valid"]


class ShardedStep:
    """One rank's frame of the slab engine: `step(state, dyn, scn=None,
    bounds=None)` on the rank's state (capacity `spec.cap_total`).  Fixed
    slabs return (state, stats); under `rebalance` pass the current bounds
    (start from `spec.initial_bounds(soa)`) and thread the returned
    new_bounds into the next call: (state, stats, new_bounds).  Stats hold
    this rank's values with a leading axis of 1 (`assemble_stats` makes the
    JAX step's (n_dev,) arrays), replicated query ids and counts, and the
    rank's mesh segment with the surface.

    The kernel backend's launches are counted per rank (`launches`)."""

    def __init__(self, spec: ShardSpec, comm):
        self.spec = spec
        self.comm = comm
        self.local_spec = StepSpec(
            capacity=spec.cap_total, cell_capacity=spec.cell_capacity,
            grid=spec.grid_local, h=spec.h, scale=spec.scale, iteration=spec.iteration,
            dtype=spec.dtype, scene=spec.scene, surface=None)
        self.phases = None if spec.gather else PbfPhases(spec.h)
        self._empty_scn: Dict[torch.device, Tensors] = {}

    @property
    def launches(self) -> Dict[str, int]:
        return dict(self.phases.launches) if self.phases is not None else {}

    def reset_launches(self) -> None:
        if self.phases is not None:
            self.phases.reset_launches()

    def __call__(self, state: FluidState, dyn: Tensors, scn: Optional[Tensors] = None,
                 bounds=None):
        spec = self.spec
        dev = state.pid.device
        if scn is None:
            sc = spec.scene
            if sc.n_wells or sc.total_spawn or sc.n_drains or sc.n_queries:
                raise ValueError("spec has scene objects; pass scn arrays")
            if dev not in self._empty_scn:
                self._empty_scn[dev] = scene_arrays_of(Scene(), sc, np.dtype(spec.dtype), dev)
            scn = self._empty_scn[dev]
        if bounds is None:
            if spec.rebalance:
                raise ValueError(
                    "rebalance mode: pass bounds (spec.initial_bounds(soa)) and "
                    "thread the returned new_bounds into the next step")
            bounds = spec.uniform_bounds()
        if torch.is_tensor(bounds):
            bounds = bounds.to(device=dev, dtype=torch.int32)
        else:
            bounds = torch.as_tensor(np.asarray(bounds, np.int32), device=dev)
        new_state, stats, new_bounds = self._local_step(state, dyn, scn, bounds)
        if spec.rebalance:
            return new_state, stats, new_bounds
        return new_state, stats

    def _local_step(self, state: FluidState, dyn: Tensors, scn: Tensors, bounds):
        spec, comm = self.spec, self.comm
        D, CL, H, M, CT = (spec.n_dev, spec.cap_local, spec.ghost_cap, spec.migrate_cap,
                           spec.cap_total)
        me = comm.rank
        lgrid = spec.grid_local
        dev = state.pid.device
        b_me = bounds[me]
        w_me = bounds[me + 1] - b_me
        h = scalar(spec.h, state.mass)
        scale = scalar(spec.scale, state.mass)
        dt = dyn["dt"]
        min_bound, max_bound = dyn["min_bound"], dyn["max_bound"]
        padding = h * 2
        min_extent = min_bound / scale - padding
        # the global grid was sized from the initial bounds: a resized domain
        # must fail loudly (1e-3-cell slack for one-ULP jitter, as the
        # single-chip guard)
        needed = torch.trunc(
            ((max_bound / scale + padding) - min_extent) / h - 1e-3).to(torch.int32)
        extent_ok = torch.stack(
            [needed[a] <= e for a, e in enumerate(spec.grid_global.extent)]).all()

        # ghost slots (the tail 2H rows) always start dead
        alive = state.alive.clone()
        alive[CL:] = False
        state = dataclasses.replace(state, alive=alive)

        # 0a. sources: only the rank owning the spawn x-cell spawns
        state, src_dropped = _apply_sources(
            state, scn, self.local_spec,
            accept=lambda pos: _owner_of_col(
                bounds, _column(pos[0] / scale, min_extent[0], h), D) == me,
            slot_limit=CL)
        # 0b. drains (position-based, local)
        state = _apply_drains(state, scn, self.local_spec)

        # 1. advect (wells are replicated force fields: local)
        vel, pstar = pbf.advect(
            state.position, state.velocity, state.mass, state.ptype, state.alive,
            scn["wells_centre"], scn["wells_force"], dyn["constant_force"], dt, scale)

        # 2. migration by global x-column, one slab hop a frame
        owner = torch.clamp(_owner_of_col(bounds, _column(pstar[0], min_extent[0], h), D),
                            me - 1, me + 1)
        go_left = state.alive & (owner < me)
        go_right = state.alive & (owner > me)
        fields = dict(
            pid=state.pid, ptype=state.ptype, mass=state.mass,
            px=state.position[0], py=state.position[1], pz=state.position[2],
            vx=vel[0], vy=vel[1], vz=vel[2],
            cr=state.colour[0], cg=state.colour[1], cb=state.colour[2], ca=state.colour[3],
        )

        send_l, sent_l = _pack_migrants(fields, go_left, M, CT)
        send_r, sent_r = _pack_migrants(fields, go_right, M, CT)
        # emigrants beyond the send capacity stay alive here, deferred to the
        # next frame (outside the local grid for one frame) and counted
        unsent = (go_left & ~sent_l) | (go_right & ~sent_r)
        migrate_deferred = unsent.sum().to(torch.int32)
        alive = state.alive & ((owner == me) | unsent)
        recv_from_l, recv_from_r = comm.exchange(send_l, send_r)

        # merge immigrants into dead owned slots
        fields = {k: v.clone() for k, v in fields.items()}
        alive, drop_r = _merge_migrants(fields, alive, recv_from_r, CL, M)
        alive, drop_l = _merge_migrants(fields, alive, recv_from_l, CL, M)

        # rebuild after the merge; immigrants recompute pStar from v and x
        position = torch.stack([fields["px"], fields["py"], fields["pz"]])
        vel = torch.stack([fields["vx"], fields["vy"], fields["vz"]])
        colour = torch.stack([fields["cr"], fields["cg"], fields["cb"], fields["ca"]])
        pid, ptype, mass = fields["pid"], fields["ptype"], fields["mass"]
        fluid = (ptype == FLUID) & alive
        pstar = torch.stack([
            torch.where(fluid, vel[a] * dt + position[a] / scale, position[a] / scale)
            for a in range(3)])

        # 3. ghost exchange: the one-cell-deep boundary columns
        lcx = _column(pstar[0], min_extent[0], h) - b_me  # owned columns [0, w_me)
        bl = alive & (lcx == 0)
        br = alive & (lcx == w_me - 1)
        idx_bl, val_bl = _compact_first(bl, H)
        idx_br, val_br = _compact_first(br, H)

        # what comes from the left is the left neighbour's right boundary
        rows = (pstar, position, mass, ptype, colour)
        ghost_from_l, ghost_from_r = comm.exchange(_ghost_payload(idx_bl, val_bl, rows),
                                                   _ghost_payload(idx_br, val_br, rows))

        # install the ghosts in the tail slots [CL, CL+2H)
        _install_ghosts(ghost_from_l, CL, H, rows, alive)
        _install_ghosts(ghost_from_r, CL + H, H, rows, alive)

        # 4. local sort over the local grid (owned + ghost columns)
        cells_g = cell_coords(pstar, min_extent, spec.h)
        cells_l = (cells_g[0] - b_me + 1, cells_g[1], cells_g[2])
        key = sort_key(cells_l, alive, lgrid)
        key, order = torch.sort(key, stable=True)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(CT, device=dev)
        pid, ptype, mass, alive = pid[order], ptype[order], mass[order], alive[order]
        position, vel = position[:, order], vel[:, order]
        colour, pstar = colour[:, order], pstar[:, order]
        table = build_cell_table(key, lgrid)
        index = CellIndex(grid=lgrid, key=key, table=table)

        # sorted positions of the ghost slots and of our boundary particles
        ghost_pos_l, ghost_pos_r = inv[CL:CL + H], inv[CL + H:CL + 2 * H]
        bpos_l, bpos_r = inv[idx_bl], inv[idx_br]

        # 4b. point queries: the owning rank scans its centre cell
        q_ids, q_counts, q_overflow = _sharded_queries(
            spec, comm, scn, b_me, bounds, pid, ptype, alive, table, min_extent)

        # 5-6. diffuse + constraint solve with the halo hooks
        valid_l, valid_r = ghost_from_l["valid"], ghost_from_r["valid"]

        def refresh(arr):
            """Ghost rows of arr (C,) or (3, C) set to their owners' values."""
            from_l, from_r = comm.exchange({"v": arr[..., bpos_l]}, {"v": arr[..., bpos_r]})
            out = arr.clone()
            out[..., ghost_pos_l] = torch.where(valid_l, from_l["v"], arr[..., ghost_pos_l])
            out[..., ghost_pos_r] = torch.where(valid_r, from_r["v"], arr[..., ghost_pos_r])
            return out

        colour, pstar = neighbour_phases(
            self.phases, self.local_spec, index, colour, pstar, mass, ptype, alive,
            dt, scale, min_bound, max_bound, refresh_lam=refresh, refresh_pstar=refresh)

        # 7. finalise
        new_pos, new_vel = pbf.finalise(position, vel, pstar, ptype, alive, dt, scale)

        # 7b. marching cubes over the slab's lattice nodes (ghosts still
        # alive: edge nodes gather from the ghost columns; cubes partition
        # exactly over the slabs)
        mesh_out = None
        if spec.surface is not None:
            if spec.rebalance:
                # the node partition follows the dynamic bounds: nodes
                # [bounds[me]*res, bounds[me+1]*res], cubes below
                # bounds[me+1]*res
                res_i = int(spec.surface.resolution)
                node_off = (b_me * res_i, 0, 0)
                cube_hi = bounds[me + 1] * res_i
                cell_x0 = b_me
            else:
                node_off = (me * (spec.surface.sample[0] - 1), 0, 0)
                cube_hi = None
                cell_x0 = me * spec.slab_w
            cell_off = (-(cell_x0 - 1), 0, 0)
            lat_v, lat_n, lat_c = gather_mc_field(
                new_pos, colour, ptype, alive, table, lgrid, min_extent,
                spec.grid_global.extent, spec.surface, spec.cell_capacity, spec.h, scale,
                dyn["mc_particle_size"], dyn["mc_particle_influence"],
                node_offset=node_off, cell_offset=cell_off, quirk_grid=spec.grid_global)
            mesh_out = mc_extract(
                lat_v, lat_n, lat_c, min_extent, spec.surface, spec.h, scale,
                dyn["mc_isolevel"], node_offset=node_off, cube_x_hi=cube_hi,
                extent=spec.grid_global.extent)

        # drop the ghosts, then compact alive rows to the front: the sort can
        # strand owned particles in the tail, which the next frame reserves
        # for ghosts
        ghost = torch.zeros(CT, dtype=torch.bool, device=dev)
        ghost[CL:] = True
        alive = alive & ~ghost[order]
        order2 = torch.argsort((~alive).to(torch.int32), stable=True)
        pid, ptype, mass, alive = pid[order2], ptype[order2], mass[order2], alive[order2]
        new_pos, new_vel, colour = new_pos[:, order2], new_vel[:, order2], colour[:, order2]

        # 8. rebalancing from the global x-CDF (one (gx,) sum a frame); moves
        # clipped to rebalance_step columns and widths to [MW, XW]
        if spec.rebalance:
            gxn = spec.grid_global.dims[0]
            col = torch.clamp(_column(new_pos[0] / scale, min_extent[0], h), 0, gxn - 1)
            histl = torch.zeros(gxn, dtype=torch.int32, device=dev).index_add_(
                0, col.long(), alive.to(torch.int32))
            cdf = torch.cumsum(comm.all_reduce_sum(histl), 0, dtype=torch.int32)
            total = cdf[-1:]
            S, MW, XW = spec.rebalance_step, spec.min_slab_w, spec.max_slab_w
            bs = [torch.zeros(1, dtype=torch.int32, device=dev)]
            for d in range(1, D):
                target = _equal_count_target(total, d, D)
                raw = torch.searchsorted(cdf, target).to(torch.int32) + 1
                v = torch.clamp(raw, bounds[d] - S, bounds[d] + S)
                lo = torch.clamp(bs[-1] + MW, min=gxn - XW * (D - d))
                hi = torch.clamp(bs[-1] + XW, max=gxn - MW * (D - d))
                bs.append(torch.minimum(torch.maximum(v, lo), hi))
            bs.append(torch.full((1,), gxn, dtype=torch.int32, device=dev))
            new_bounds = torch.cat(bs)
        else:
            new_bounds = bounds

        new_state = FluidState(pid=pid, ptype=ptype, mass=mass, position=new_pos,
                               velocity=new_vel, colour=colour, alive=alive)
        total_spawn = spec.scene.total_spawn
        spawn_dropped = torch.zeros((), dtype=torch.int32, device=dev)
        if total_spawn:
            spawned = comm.all_reduce_sum((total_spawn - src_dropped).reshape(1))[0]
            spawn_dropped = (total_spawn - spawned).to(torch.int32)
        nbl, nbr = bl.sum(), br.sum()
        zero = torch.zeros((), dtype=torch.int32, device=dev)

        def one(v):
            return v.to(torch.int32).reshape(1)

        stats = dict(
            alive_count=one(alive.sum()),
            extent_ok=one(extent_ok),
            migrate_dropped=one(drop_l + drop_r),
            migrate_deferred=one(migrate_deferred),
            ghost_dropped=one(torch.clamp(nbl - H, min=0) + torch.clamp(nbr - H, min=0)),
            # the boundary-layer occupancy ghost_cap must cover
            ghost_peak=one(torch.maximum(nbl, nbr)),
            spawn_dropped=one(spawn_dropped),
            strip_overflow=one(zero),  # no strip buffer in either backend
            query_overflow=one(q_overflow),
            query_ids=q_ids,
            query_counts=q_counts,
        )
        if mesh_out is not None:
            vs, ns, cs, tris, emit_ovf = mesh_out
            stats.update(mesh_vs=vs, mesh_ns=ns, mesh_cs=cs, tri_count=one(tris),
                         mc_emit_overflow=one(emit_ovf))
        return new_state, stats, new_bounds


def build_sharded_step(spec: ShardSpec, comm) -> ShardedStep:
    """One rank's step of the slab engine (`sharded.py:349-816`): the full
    frame of the single-chip step with migration, ghosts and their refresh,
    the slab MC and rebalancing."""
    return ShardedStep(spec, comm)


# ---------------------------------------------------------------------------
# Host-side assembly
# ---------------------------------------------------------------------------


def assemble_stats(rank_stats: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """The ranks' stats (rank order) as the JAX step returns them: (n_dev,)
    per-rank values, replicated query ids and counts, and the mesh arrays
    side by side, (3|4, n_dev * 3 * tri_capacity)."""
    out = {}
    for k in rank_stats[0]:
        vals = [s[k].cpu().numpy() for s in rank_stats]
        if k in PER_RANK_STATS:
            out[k] = np.concatenate(vals)
        elif k.startswith("mesh_"):
            out[k] = np.concatenate(vals, axis=1)
        else:
            out[k] = vals[0]
    return out


def gather_mesh(rank_stats: Sequence[Dict[str, torch.Tensor]]):
    """The global triangle soup from the ranks' mesh segments and tri_counts,
    in rank order (host-side): (vs, ns, cs) arrays of shape (3*T, 3|4)."""
    outs = []
    for key, w in (("mesh_vs", 3), ("mesh_ns", 3), ("mesh_cs", 4)):
        segs = [s[key][:, :3 * int(s["tri_count"])].T.cpu().numpy() for s in rank_stats]
        outs.append(np.concatenate(segs) if segs else np.zeros((0, w), np.float32))
    return outs[0], outs[1], outs[2]


def distribute_particles(soa, spec: ShardSpec, dtype=np.float32, bounds=None) -> FluidState:
    """Assign particles to slabs by x-position and build the concatenated
    per-rank state on the host (CPU tensors, capacity n_dev * cap_total,
    rank-major).  `bounds` defaults to the fixed uniform slabs, or
    spec.initial_bounds(soa) in rebalance mode."""
    f = dtype
    scale = np.float32(spec.scale)
    h = np.float32(spec.h)
    if bounds is None:
        bounds = spec.initial_bounds(soa) if spec.rebalance else spec.uniform_bounds()
    # owner by the current position's global x-column (migration fixes any
    # edge case on the first step)
    min_ext_x = np.float32(spec.min_bound_x) / scale - h * 2
    gcx = np.trunc((soa.position[:, 0].astype(f) / scale - min_ext_x) / h).astype(np.int64)
    owner = np.clip(np.searchsorted(bounds, np.clip(gcx, 0, None), side="right") - 1,
                    0, spec.n_dev - 1)
    states = []
    for d in range(spec.n_dev):
        idx = np.nonzero(owner == d)[0]
        if len(idx) > spec.cap_local:
            raise ValueError(f"device {d}: {len(idx)} particles > cap {spec.cap_local}")
        sub = ParticleSoA(soa.pid[idx], soa.ptype[idx], soa.mass[idx],
                          soa.position[idx], soa.velocity[idx], soa.colour[idx])
        states.append(FluidState.from_soa(sub, spec.cap_total, f, device="cpu"))
    return FluidState(
        pid=torch.cat([s.pid for s in states]),
        ptype=torch.cat([s.ptype for s in states]),
        mass=torch.cat([s.mass for s in states]),
        position=torch.cat([s.position for s in states], dim=1),
        velocity=torch.cat([s.velocity for s in states], dim=1),
        colour=torch.cat([s.colour for s in states], dim=1),
        alive=torch.cat([s.alive for s in states]),
    )


def local_state(global_state: FluidState, rank: int, spec: ShardSpec, device="cuda") -> FluidState:
    """Rank `rank`'s block of a rank-major state (`distribute_particles`) on
    `device` (the card unless the caller asks for the CPU; without a card a
    CUDA device raises): the port's counterpart of placing the state on the
    mesh.  The tile engine's blocks (`cap_total` each, x-major) too."""
    device = require_device(device)
    sl = slice(rank * spec.cap_total, (rank + 1) * spec.cap_total)
    return FluidState(**{
        f.name: getattr(global_state, f.name)[..., sl].contiguous().to(device)
        for f in dataclasses.fields(FluidState)})


def gather_soa(states: Sequence[FluidState]) -> ParticleSoA:
    """The alive particles of the ranks' states (rank order), as the JAX
    global state's `to_soa()` gives them."""
    return ParticleSoA.concat([s.to_soa() for s in states])


def all_gather_soa(comm, state: FluidState) -> ParticleSoA:
    """`gather_soa` over the communicator: every rank's alive particles, in
    rank order, on every rank."""
    keep = torch.nonzero(state.alive)[:, 0]
    parts = {f.name: all_gather_cat(comm, getattr(state, f.name)[..., keep])
             for f in dataclasses.fields(FluidState) if f.name != "alive"}
    host = {k: v.cpu().numpy() for k, v in parts.items()}
    return ParticleSoA(pid=host["pid"], ptype=host["ptype"], mass=host["mass"],
                       position=host["position"].T, velocity=host["velocity"].T,
                       colour=host["colour"].T)


def all_gather_mesh(comm, stats: Dict[str, torch.Tensor]):
    """`gather_mesh` over the communicator, on every rank."""
    t3 = 3 * int(stats["tri_count"])
    return tuple(all_gather_cat(comm, stats[k][:, :t3]).T.cpu().numpy()
                 for k in ("mesh_vs", "mesh_ns", "mesh_cs"))
