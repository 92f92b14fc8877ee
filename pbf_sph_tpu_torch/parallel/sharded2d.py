"""The 2D tile engine: the particle set decomposed into (x, y) tiles over an
NX x NY mesh of ranks.

Port of `pbf_sph_tpu/parallel/sharded2d.py`.  The tiles are a tensor
product: x-cuts `xb` (NX+1,) and y-cuts `yb` (NY+1,) in global grid columns
and rows, each cut cell-granular and at least `min_w` wide, so a hop along
one axis never changes the owner along the other.  Ranks are numbered
x-major (rank = mx*NY + my).  Each frame a rank

  1. kills the ghost tail, spawns (only the tile owning the spawn cell on
     both axes) and drains,
  2. advects locally,
  3. migrates in two phases, x then y, each one hop with `migrate_cap` slots
     a direction (the rest deferred, alive, to the next frame); the y phase
     reads the fields after the x merge, so a diagonal move completes in one
     frame,
  4. exchanges ghosts in two phases: the x pass sends the owned boundary
     columns, then the y pass scans the owned rows and the x-ghosts just
     installed, so the corner neighbourhoods ride the y pass.  Slots:
     [CL, CL+HX) from lo-x, [CL+HX, CL+2HX) from hi-x, then HY each from
     lo-y and hi-y,
  5. sorts over the local tile grid (the tile and one ghost column and row
     each side) and runs the single-chip phase pipeline (`neighbour_phases`)
     with the ghosts' lambda and pStar refreshed after every lambda and
     every delta, x fully installed before y reads,
  6. finalises, extracts its tile's marching cubes (the XLA field, as the
     JAX step does; nodes [bx*res, bx1*res] x [by*res, by1*res], cubes
     owned below bx1*res and by1*res), drops the ghosts, compacts alive rows
     to the front and, under `rebalance`, moves each cut by at most
     `rebalance_step` toward equal counts of its axis's marginal histogram
     summed over all tiles.

A rank talks to the others only through two views of its communicator
(`parallel/comm.py` `MeshAxis`): `exchange` along x or y in place of
`ppermute(..., "x"|"y", ...)`, and `all_reduce_sum` over the group in place of
`psum(..., ("x", "y"))`.  `Shard2DSpec.gather` takes the place of the JAX
spec's `use_pallas`, as in `ShardSpec`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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
from pbf_sph_tpu_torch.ops.grid import GridSpec, build_cell_table, cell_coords, sort_key
from pbf_sph_tpu_torch.ops.mc import McSpec, default_cube_cap, mc_extract
from pbf_sph_tpu_torch.ops.mc import mc_field as gather_mc_field
from pbf_sph_tpu_torch.ops.pbf import scalar
from pbf_sph_tpu_torch.ops.phases import CellIndex, PbfPhases
from pbf_sph_tpu_torch.parallel.comm import MeshAxis
from pbf_sph_tpu_torch.parallel.sharded import (  # noqa: F401  (re-exported, as JAX does)
    _centre_cell_queries,
    _column,
    _compact_first,
    _equal_count_target,
    _ghost_payload,
    _install_ghosts,
    _merge_migrants,
    _owner_of_col,
    _pack_migrants,
    assemble_stats,
    gather_mesh,
    gather_soa,
    local_state,
)


def _axis_cap(g: int, n: int, min_w: int, cap: int = 0) -> int:
    """The widest tile along one axis under rebalancing: `cap`, or 3x the
    uniform width, clamped feasible (`sharded2d.py:73-78`)."""
    cap = cap or -(-3 * g // n)
    cap = max(cap, min_w, -(-g // n))
    return min(cap, g - (n - 1) * min_w)


def _equal_count_cuts(vals, lo: int, hi: int, n: int, min_w: int = 3, max_w=None):
    """Equal-count cell-granular cuts of [lo, hi) into n ranges with widths
    in [min_w, max_w] (`sharded2d.py:81-96`)."""
    hist = np.bincount(np.clip(vals, lo, hi - 1) - lo, minlength=hi - lo)
    cdf = np.cumsum(hist)
    total = int(cdf[-1])
    xw = max_w if max_w is not None else hi - lo
    b = [lo]
    for d in range(1, n):
        v = lo + int(np.searchsorted(cdf, total * d / n, side="left")) + 1
        v = min(max(v, b[-1] + min_w, hi - xw * (n - d)), hi - min_w * (n - d), b[-1] + xw)
        b.append(v)
    b.append(hi)
    return tuple(int(x) for x in b)


def _host_cells(soa, axis: int, scale, h, min_bound, dtype=np.float32) -> np.ndarray:
    """Global grid column (axis 0) or row (axis 1) of each particle, on the
    host, as the JAX module computes it."""
    me = np.float32(min_bound[axis]) / scale - h * 2
    return np.trunc((soa.position[:, axis].astype(dtype) / scale - me) / h).astype(np.int64)


@dataclass(frozen=True)
class Shard2DSpec:
    nx: int
    ny: int
    cap_local: int       # owned-particle capacity a tile
    ghost_x: int         # x-ghost slots a side (a boundary column)
    ghost_y: int         # y-ghost slots a side (a boundary row with its x-ghosts)
    migrate_cap: int     # migration slots a direction a phase
    xb: Tuple[int, ...]  # initial x-cuts (nx+1,), xb[0] = 0, xb[-1] = gx
    yb: Tuple[int, ...]  # initial y-cuts (ny+1,)
    grid_global: GridSpec
    h: float
    scale: float
    iteration: int
    cell_capacity: int
    dtype: str = "float32"
    scene: SceneSpec = SceneSpec()
    # True: the gather backend; False: the kernel backend (ops/phases.py)
    gather: bool = True
    min_bound: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # the LOCAL marching-cubes spec (wx_max*res+1 x wy_max*res+1 node
    # columns); None = no surface.  Needs an integer resolution: a tile's
    # node offset bx*res is a whole node index at every cut
    surface: Optional[McSpec] = None
    # dynamic tensor-product cuts: each axis re-partitioned every frame from
    # the global marginal histogram, each cut moving at most rebalance_step,
    # widths in [min_w, wx_max|wy_max], which keeps migration one hop an axis
    rebalance: bool = False
    rebalance_step: int = 1
    min_w: int = 3
    # widest tile a side under rebalancing (0 = 3x uniform, clamped feasible)
    max_wx_cap: int = 0
    max_wy_cap: int = 0

    @property
    def wx_max(self) -> int:
        if self.rebalance:
            return _axis_cap(self.grid_global.dims[0], self.nx, self.min_w, self.max_wx_cap)
        return max(b - a for a, b in zip(self.xb, self.xb[1:]))

    @property
    def wy_max(self) -> int:
        if self.rebalance:
            return _axis_cap(self.grid_global.dims[1], self.ny, self.min_w, self.max_wy_cap)
        return max(b - a for a, b in zip(self.yb, self.yb[1:]))

    @property
    def grid_local(self) -> GridSpec:
        """The widest tile plus one ghost column and row each side; no Morton
        quirks (a tile's far corner is an interior cell)."""
        gz = self.grid_global.dims[2]
        return GridSpec(extent=(self.wx_max + 1, self.wy_max + 1, gz - 1),
                        maxz=self.grid_global.maxz, quirks=False)

    @property
    def cap_total(self) -> int:
        return self.cap_local + 2 * self.ghost_x + 2 * self.ghost_y

    def initial_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """The spec's cuts as the int32 arrays a rebalancing step threads."""
        return np.asarray(self.xb, np.int32), np.asarray(self.yb, np.int32)

    @staticmethod
    def create(config, nx: int, ny: int, soa, h: float, cell_capacity: int = 48,
               dtype: str = "float32", cap_local: int = 0, scene: Scene = None,
               gather: bool = True, min_w: int = 3, rebalance: bool = False,
               ghost_x: int = 0, ghost_y: int = 0) -> "Shard2DSpec":
        """The JAX spec's sizing (`sharded2d.py:165-262`); the cuts are
        equal-count over `soa`.  `ghost_x`/`ghost_y` > 0 replace the
        defaults (the CLI's growth), before the kernel backend's capacity
        alignment."""
        grid = GridSpec.from_bounds(config.min_bound, config.max_bound, config.scale, h)
        gx, gy, gz = grid.dims
        if gx < nx * min_w or gy < ny * min_w:
            raise ValueError(f"grid {gx}x{gy} columns/rows cannot hold {nx}x{ny} tiles of "
                             f">= {min_w} cells")
        if config.surface is not None and not float(config.surface.resolution).is_integer():
            # the cuts land on arbitrary columns, so every tile's node offset
            # b*res must be a whole node index
            raise ValueError("2D tile surface extraction requires an integer MC resolution "
                             "(the tile node partition shifts by whole columns)")
        sspec = scene_spec_of(scene or Scene(), config)
        scale = np.float32(config.scale)
        hf = np.float32(h)
        min_bound = np.asarray(config.min_bound, np.float32)
        gcx = _host_cells(soa, 0, scale, hf, min_bound)
        gcy = _host_cells(soa, 1, scale, hf, min_bound)
        # rebalancing sizes the local grid by the width caps, so the initial
        # cuts keep to them too
        wx_cap = _axis_cap(gx, nx, min_w) if rebalance else None
        wy_cap = _axis_cap(gy, ny, min_w) if rebalance else None
        xb = _equal_count_cuts(gcx, 0, gx, nx, min_w, wx_cap)
        yb = _equal_count_cuts(gcy, 0, gy, ny, min_w, wy_cap)
        count = len(soa)
        if cap_local <= 0 and rebalance:
            # the cuts bound the marginal, not the joint, count: 3x headroom
            per = (count + sspec.total_spawn) / (nx * ny)
            cap_local = max(256, -(-int(per * 3) // 128) * 128)
        if cap_local <= 0:
            # fixed tiles under the sloshing motion can gather most of an
            # x-band into one tile: the whole set
            cap_local = max(256, -(-int(count + sspec.total_spawn) // 128) * 128)
        # one boundary column (x) / one boundary row with the x-ghost columns
        # (y) at 8 particles a cell
        wx_loc = (wx_cap if rebalance else max(b - a for a, b in zip(xb, xb[1:]))) + 2
        if ghost_x <= 0:
            ghost_x = min(max(128, -(-(gy * gz * 8) // 128) * 128), cap_local)
        if ghost_y <= 0:
            ghost_y = min(max(128, -(-(wx_loc * gz * 8) // 128) * 128), cap_local)
        # a rebalancing cut hands a whole column or row to a neighbour in a frame
        migrate_cap = cap_local if rebalance else min(cap_local, max(128, ghost_x, ghost_y))
        if not gather:
            # the kernel backend's capacity alignment (the JAX spec pads to
            # the Pallas block)
            total = cap_local + 2 * ghost_x + 2 * ghost_y
            cap_local += -(-total // CAPACITY_ALIGN) * CAPACITY_ALIGN - total
        spec = Shard2DSpec(
            nx=nx, ny=ny, cap_local=cap_local, ghost_x=ghost_x, ghost_y=ghost_y,
            migrate_cap=migrate_cap, xb=xb, yb=yb, grid_global=grid, h=h,
            scale=float(config.scale), iteration=int(config.iteration),
            cell_capacity=cell_capacity, dtype=dtype, scene=sspec, gather=gather,
            min_bound=tuple(float(v) for v in min_bound), rebalance=rebalance, min_w=min_w)
        if config.surface is not None:
            res = float(config.surface.resolution)
            gspec = McSpec.from_extent(grid.extent, res,
                                       influence_static=float(config.surface.particle_influence))
            # the local lattice is sized for the widest tile along each axis;
            # the cuts mask the owned cubes each frame
            local_sample = (int(spec.wx_max * res) + 1, int(spec.wy_max * res) + 1,
                            gspec.sample[2])
            local_vol = int(np.prod([s - 1 for s in local_sample]))
            surface = dataclasses.replace(
                gspec, sample=local_sample,
                tri_capacity=max(1024, -(-gspec.tri_capacity // (nx * ny)) * 2),
                cube_cap=default_cube_cap(local_vol))
            spec = dataclasses.replace(spec, surface=surface)
        return spec


def _queries_2d(spec: Shard2DSpec, comm, scn, mx, my, bx, by, xb, yb, pid, ptype, alive,
                table, min_extent):
    """`_centre_cell_queries` over the tiles (`sharded2d.py:749-792`): the
    owner by x-column and y-row, the local cell ((gx - bx + 1, gy - by + 1,
    gz)), merged by the id + 1 sum over all tiles."""
    def locate(cell):
        ox = _owner_of_col(xb, cell[:1], spec.nx)[0]
        oy = _owner_of_col(yb, cell[1:2], spec.ny)[0]
        return (ox == mx) & (oy == my), (cell[0] - bx + 1, cell[1] - by + 1, cell[2])

    return _centre_cell_queries(spec.scene, spec.grid_local, spec.grid_global, comm, scn,
                                locate, pid, ptype, alive, table, min_extent,
                                scalar(spec.h, min_extent), scalar(spec.scale, min_extent))


class Sharded2DStep:
    """One rank's frame of the tile engine: `step(state, dyn, scn=None,
    bounds=None)` on the rank's state (capacity `spec.cap_total`).  Fixed
    cuts return (state, stats); under `rebalance` pass the current (xb, yb)
    (start from `spec.initial_bounds()`) and thread the returned pair into
    the next call: (state, stats, (xb, yb)).  Stats hold this rank's values
    with a leading axis of 1 (`assemble_stats` makes the JAX step's (NX*NY,)
    arrays), replicated query ids and counts, and the tile's mesh segment
    with the surface.

    The kernel backend's launches are counted per rank (`launches`)."""

    def __init__(self, spec: Shard2DSpec, comm):
        self.spec = spec
        self.comm = comm
        self.axes = (MeshAxis(comm, (spec.nx, spec.ny), 0),
                     MeshAxis(comm, (spec.nx, spec.ny), 1))
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
                    "rebalance mode: pass bounds=(xb, yb) (spec.initial_bounds()) and "
                    "thread the returned cuts into the next step")
            bounds = spec.initial_bounds()
        xb, yb = (b.to(device=dev, dtype=torch.int32) if torch.is_tensor(b)
                  else torch.as_tensor(np.asarray(b, np.int32), device=dev) for b in bounds)
        new_state, stats, new_bounds = self._local_step(state, dyn, scn, xb, yb)
        if spec.rebalance:
            return new_state, stats, new_bounds
        return new_state, stats

    def _local_step(self, state: FluidState, dyn: Tensors, scn: Tensors, xb, yb):
        spec = self.spec
        CL, HX, HY, M, CT = spec.cap_local, spec.ghost_x, spec.ghost_y, spec.migrate_cap, \
            spec.cap_total
        ax, ay = self.axes
        mx, my = ax.rank, ay.rank
        cuts, sizes, me = (xb, yb), (spec.nx, spec.ny), (mx, my)
        lgrid = spec.grid_local
        dev = state.pid.device
        bx, by = xb[mx], yb[my]
        wx, wy = xb[mx + 1] - bx, yb[my + 1] - by
        h = scalar(spec.h, state.mass)
        scale = scalar(spec.scale, state.mass)
        dt = dyn["dt"]
        min_bound, max_bound = dyn["min_bound"], dyn["max_bound"]
        padding = h * 2
        min_extent = min_bound / scale - padding
        needed = torch.trunc(
            ((max_bound / scale + padding) - min_extent) / h - 1e-3).to(torch.int32)
        extent_ok = torch.stack(
            [needed[a] <= e for a, e in enumerate(spec.grid_global.extent)]).all()

        # ghost slots (the tail 2HX + 2HY rows) always start dead
        alive = state.alive.clone()
        alive[CL:] = False
        state = dataclasses.replace(state, alive=alive)

        def owner(a, world):
            """Owning tile index along axis a of world-space coordinates."""
            return _owner_of_col(cuts[a], _column(world / scale, min_extent[a], h), sizes[a])

        # 0a. sources: only the tile owning the spawn cell on both axes
        state, src_dropped = _apply_sources(
            state, scn, self.local_spec,
            accept=lambda pos: (owner(0, pos[0]) == mx) & (owner(1, pos[1]) == my),
            slot_limit=CL)
        # 0b. drains (local)
        state = _apply_drains(state, scn, self.local_spec)

        # 1. advect
        vel, _ = pbf.advect(
            state.position, state.velocity, state.mass, state.ptype, state.alive,
            scn["wells_centre"], scn["wells_force"], dyn["constant_force"], dt, scale)

        # 2. migration in two phases, x then y, one tile hop each
        fields = dict(
            pid=state.pid, ptype=state.ptype, mass=state.mass,
            px=state.position[0], py=state.position[1], pz=state.position[2],
            vx=vel[0], vy=vel[1], vz=vel[2],
            cr=state.colour[0], cg=state.colour[1], cb=state.colour[2], ca=state.colour[3],
        )
        fields = {k: v.clone() for k, v in fields.items()}
        alive = state.alive
        migrate_deferred = torch.zeros((), dtype=torch.int64, device=dev)
        migrate_dropped = torch.zeros((), dtype=torch.int64, device=dev)

        for a, axis in enumerate(self.axes):
            # the predicted cell in world space from the current fields
            # (this frame's x-immigrants included), as the JAX step
            p, v = fields["p" + "xyz"[a]], fields["v" + "xyz"[a]]
            fluid = (fields["ptype"] == FLUID) & alive
            pw = torch.where(fluid, v * dt * scale + p, p)
            own = torch.clamp(owner(a, pw), me[a] - 1, me[a] + 1)
            go_lo = alive & (own < me[a])
            go_hi = alive & (own > me[a])
            send_lo, sent_lo = _pack_migrants(fields, go_lo, M, CT)
            send_hi, sent_hi = _pack_migrants(fields, go_hi, M, CT)
            # emigrants beyond the send capacity stay alive here, deferred
            unsent = (go_lo & ~sent_lo) | (go_hi & ~sent_hi)
            migrate_deferred = migrate_deferred + unsent.sum()
            alive = alive & ((own == me[a]) | unsent)
            recv_lo, recv_hi = axis.exchange(send_lo, send_hi)
            alive, drop_hi = _merge_migrants(fields, alive, recv_hi, CL, M)
            alive, drop_lo = _merge_migrants(fields, alive, recv_lo, CL, M)
            migrate_dropped = migrate_dropped + drop_hi + drop_lo

        # rebuild after the merges; immigrants recompute pStar from v and x
        position = torch.stack([fields["px"], fields["py"], fields["pz"]])
        vel = torch.stack([fields["vx"], fields["vy"], fields["vz"]])
        colour = torch.stack([fields["cr"], fields["cg"], fields["cb"], fields["ca"]])
        pid, ptype, mass = fields["pid"], fields["ptype"], fields["mass"]
        fluid = (ptype == FLUID) & alive
        pstar = torch.stack([
            torch.where(fluid, vel[a] * dt + position[a] / scale, position[a] / scale)
            for a in range(3)])

        # 3. ghosts in two phases: the x pass sends the boundary columns, the
        # y pass the boundary rows of the owned rows and the x-ghosts just
        # installed (the corners ride it)
        rows = (pstar, position, mass, ptype, colour)
        ghost_dropped = torch.zeros((), dtype=torch.int64, device=dev)
        ghost_peak = torch.zeros((), dtype=torch.int64, device=dev)
        packs = []
        for a, (axis, b_me, w_me, lo, H) in enumerate(
                ((ax, bx, wx, CL, HX), (ay, by, wy, CL + 2 * HX, HY))):
            lc = _column(pstar[a], min_extent[a], h) - b_me  # owned [0, w_me)
            b_lo = alive & (lc == 0)
            b_hi = alive & (lc == w_me - 1)
            idx_lo, val_lo = _compact_first(b_lo, H)
            idx_hi, val_hi = _compact_first(b_hi, H)
            from_lo, from_hi = axis.exchange(_ghost_payload(idx_lo, val_lo, rows),
                                             _ghost_payload(idx_hi, val_hi, rows))
            _install_ghosts(from_lo, lo, H, rows, alive)
            _install_ghosts(from_hi, lo + H, H, rows, alive)
            n_lo, n_hi = b_lo.sum(), b_hi.sum()
            ghost_dropped = ghost_dropped + torch.clamp(n_lo - H, min=0) + \
                torch.clamp(n_hi - H, min=0)
            ghost_peak = torch.maximum(ghost_peak, torch.maximum(n_lo, n_hi))
            packs.append((idx_lo, idx_hi, from_lo["valid"], from_hi["valid"], lo, H))

        # 4. local sort over the tile grid (owned + one ghost column and row)
        cells_g = cell_coords(pstar, min_extent, spec.h)
        cells_l = (cells_g[0] - bx + 1, cells_g[1] - by + 1, cells_g[2])
        key = sort_key(cells_l, alive, lgrid)
        key, order = torch.sort(key, stable=True)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(CT, device=dev)
        pid, ptype, mass, alive = pid[order], ptype[order], mass[order], alive[order]
        position, vel = position[:, order], vel[:, order]
        colour, pstar = colour[:, order], pstar[:, order]
        table = build_cell_table(key, lgrid)
        index = CellIndex(grid=lgrid, key=key, table=table)

        # sorted positions of each phase's ghost slots and boundary particles
        halo = [(axis, inv[idx_lo], inv[idx_hi], inv[lo:lo + H], inv[lo + H:lo + 2 * H],
                 v_lo, v_hi)
                for axis, (idx_lo, idx_hi, v_lo, v_hi, lo, H) in zip(self.axes, packs)]

        # 4b. point queries: the owning tile scans its centre cell
        q_ids, q_counts, q_overflow = _queries_2d(
            spec, self.comm, scn, mx, my, bx, by, xb, yb, pid, ptype, alive, table,
            min_extent)

        # 5-6. diffuse + constraint solve; the refresh installs x before y
        # reads, so a y-ghost sourced from an x-ghost carries the fresh value
        def refresh(arr):
            """Ghost rows of arr (C,) or (3, C) set to their owners' values."""
            out = arr.clone()
            for axis, b_lo, b_hi, g_lo, g_hi, v_lo, v_hi in halo:
                from_lo, from_hi = axis.exchange({"v": out[..., b_lo]}, {"v": out[..., b_hi]})
                out[..., g_lo] = torch.where(v_lo, from_lo["v"], out[..., g_lo])
                out[..., g_hi] = torch.where(v_hi, from_hi["v"], out[..., g_hi])
            return out

        colour, pstar = neighbour_phases(
            self.phases, self.local_spec, index, colour, pstar, mass, ptype, alive,
            dt, scale, min_bound, max_bound, refresh_lam=refresh, refresh_pstar=refresh)

        # 7. finalise
        new_pos, new_vel = pbf.finalise(position, vel, pstar, ptype, alive, dt, scale)

        # 7b. the tile's marching cubes (ghosts still alive: boundary nodes
        # gather from the ghost columns and rows, corner nodes from the
        # corner ghosts; cubes partition exactly over the tiles)
        mesh_out = None
        if spec.surface is not None:
            res_i = int(spec.surface.resolution)
            node_off = (bx * res_i, by * res_i, 0)
            cell_off = (-(bx - 1), -(by - 1), 0)
            lat_v, lat_n, lat_c = gather_mc_field(
                new_pos, colour, ptype, alive, table, lgrid, min_extent,
                spec.grid_global.extent, spec.surface, spec.cell_capacity, spec.h, scale,
                dyn["mc_particle_size"], dyn["mc_particle_influence"],
                node_offset=node_off, cell_offset=cell_off, quirk_grid=spec.grid_global)
            mesh_out = mc_extract(
                lat_v, lat_n, lat_c, min_extent, spec.surface, spec.h, scale,
                dyn["mc_isolevel"], node_offset=node_off, cube_x_hi=xb[mx + 1] * res_i,
                cube_y_hi=yb[my + 1] * res_i, extent=spec.grid_global.extent)

        # drop the ghosts, then compact alive rows to the front (the sort can
        # strand owned particles in the ghost tail)
        ghost = torch.zeros(CT, dtype=torch.bool, device=dev)
        ghost[CL:] = True
        alive = alive & ~ghost[order]
        order2 = torch.argsort((~alive).to(torch.int32), stable=True)
        pid, ptype, mass, alive = pid[order2], ptype[order2], mass[order2], alive[order2]
        new_pos, new_vel, colour = new_pos[:, order2], new_vel[:, order2], colour[:, order2]

        # 8. tensor-product rebalancing: each axis's cuts from its marginal
        # histogram summed over all tiles (one (gx + gy,) sum a frame); moves
        # clipped to rebalance_step and widths to [min_w, w*_max]
        if spec.rebalance:
            dims = spec.grid_global.dims[:2]
            hists = []
            for a, g in enumerate(dims):
                col = torch.clamp(_column(new_pos[a] / scale, min_extent[a], h), 0, g - 1)
                hists.append(torch.zeros(g, dtype=torch.int32, device=dev).index_add_(
                    0, col.long(), alive.to(torch.int32)))
            summed = self.comm.all_reduce_sum(torch.cat(hists))
            S, MW = spec.rebalance_step, spec.min_w
            new_bounds = []
            for a, (g, n, XW) in enumerate(zip(dims, sizes, (spec.wx_max, spec.wy_max))):
                cdf = torch.cumsum(summed[:g] if a == 0 else summed[dims[0]:], 0,
                                   dtype=torch.int32)
                total = cdf[-1:]
                bs = [torch.zeros(1, dtype=torch.int32, device=dev)]
                for d in range(1, n):
                    target = _equal_count_target(total, d, n)
                    raw = torch.searchsorted(cdf, target).to(torch.int32) + 1
                    v = torch.clamp(raw, cuts[a][d] - S, cuts[a][d] + S)
                    lo = torch.clamp(bs[-1] + MW, min=g - XW * (n - d))
                    hi = torch.clamp(bs[-1] + XW, max=g - MW * (n - d))
                    bs.append(torch.minimum(torch.maximum(v, lo), hi))
                bs.append(torch.full((1,), g, dtype=torch.int32, device=dev))
                new_bounds.append(torch.cat(bs))
            new_bounds = tuple(new_bounds)
        else:
            new_bounds = (xb, yb)

        new_state = FluidState(pid=pid, ptype=ptype, mass=mass, position=new_pos,
                               velocity=new_vel, colour=colour, alive=alive)
        total_spawn = spec.scene.total_spawn
        spawn_dropped = torch.zeros((), dtype=torch.int32, device=dev)
        if total_spawn:
            spawned = self.comm.all_reduce_sum((total_spawn - src_dropped).reshape(1))[0]
            spawn_dropped = (total_spawn - spawned).to(torch.int32)
        zero = torch.zeros((), dtype=torch.int32, device=dev)

        def one(v):
            return v.to(torch.int32).reshape(1)

        stats = dict(
            alive_count=one(alive.sum()),
            extent_ok=one(extent_ok),
            migrate_dropped=one(migrate_dropped),
            migrate_deferred=one(migrate_deferred),
            ghost_dropped=one(ghost_dropped),
            # the boundary-layer occupancy ghost_x / ghost_y must cover
            ghost_peak=one(ghost_peak),
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


def build_sharded2d_step(spec: Shard2DSpec, comm) -> Sharded2DStep:
    """One rank's step of the tile engine (`sharded2d.py:272-746`): the full
    frame of the single-chip step with two-phase migration, two-phase ghosts
    and their refresh, the tile MC and tensor-product rebalancing.  `comm`
    holds nx * ny ranks, numbered x-major."""
    return Sharded2DStep(spec, comm)


def distribute_particles_2d(soa, spec: Shard2DSpec, dtype=np.float32,
                            bounds=None) -> FluidState:
    """Assign particles to tiles by (x, y) cell and build the concatenated
    per-rank state on the host (CPU tensors, capacity nx * ny * cap_total,
    x-major tile order).  `bounds` defaults to the spec's cuts; pass a
    resumed (xb, yb) so that ownership follows a rebalanced run's cuts."""
    xb, yb = bounds if bounds is not None else (spec.xb, spec.yb)
    scale = np.float32(spec.scale)
    h = np.float32(spec.h)
    owners = []
    for a, (cuts, n) in enumerate(((xb, spec.nx), (yb, spec.ny))):
        gc = _host_cells(soa, a, scale, h, spec.min_bound, dtype)
        owners.append(np.clip(np.searchsorted(cuts, np.clip(gc, 0, None), side="right") - 1,
                              0, n - 1))
    states = []
    for dx in range(spec.nx):
        for dy in range(spec.ny):
            idx = np.nonzero((owners[0] == dx) & (owners[1] == dy))[0]
            if len(idx) > spec.cap_local:
                raise ValueError(f"tile ({dx},{dy}): {len(idx)} particles > cap {spec.cap_local}")
            sub = ParticleSoA(soa.pid[idx], soa.ptype[idx], soa.mass[idx],
                              soa.position[idx], soa.velocity[idx], soa.colour[idx])
            states.append(FluidState.from_soa(sub, spec.cap_total, dtype, device="cpu"))
    return FluidState(
        pid=torch.cat([s.pid for s in states]),
        ptype=torch.cat([s.ptype for s in states]),
        mass=torch.cat([s.mass for s in states]),
        position=torch.cat([s.position for s in states], dim=1),
        velocity=torch.cat([s.velocity for s in states], dim=1),
        colour=torch.cat([s.colour for s in states], dim=1),
        alive=torch.cat([s.alive for s in states]),
    )
