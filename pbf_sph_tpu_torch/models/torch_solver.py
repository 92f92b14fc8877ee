"""PyTorch solver backends: one frame as a sequence of tensor ops on one device.

Port of `pbf_sph_tpu/models/jax_solver.py`.  The frame is the same: sources,
drains, advect, cell sort, dense cell table, centre-cell queries, colour
diffusion, the iterated lambda/delta solve with its in-iteration bounds
clamp, finalise, and the marching-cubes surface.  State has a fixed capacity
and stays on `device`; `step_device` never reads a value back to the host.

Two backends, chosen by name and never substituted for each other:
* `torch` (the kernel backend): the main path's Pallas kernels replaced by
  the hand-written CUDA kernels of `ops/phases.py` and `ops/mc_field.py`.
  On a CUDA device they launch their kernels; on the CPU they run their
  plain PyTorch versions.  fp32 only, as the Pallas backend.
* `gather` (`TorchSolver(gather=True)`): the JAX package's XLA path, the
  K-capped (K, C) gathers of `ops/pbf.py` over `ops/grid.stencil_ranges` and
  the XLA field `ops/mc.mc_field`, plain torch ops on either device.  It
  launches no kernel of the port and runs fp32 or fp64.

The device is "cuda" unless the caller asks for another; nothing falls back
to the CPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.convert import arrays_to_device
from pbf_sph_tpu_torch.core.types import (
    FLUID,
    ColouredMesh,
    FluidState,
    ParticleSoA,
    QueryResult,
    Result,
    Scene,
    SphParams,
)
from pbf_sph_tpu_torch.models.growth import growth_changes
from pbf_sph_tpu_torch.models.solver import Solver
from pbf_sph_tpu_torch.ops import pbf
from pbf_sph_tpu_torch.ops.curves import morton_encode3
from pbf_sph_tpu_torch.ops.grid import (
    GridSpec,
    build_cell_table,
    cell_coords,
    decode_key,
    max_cell_occupancy,
    sort_key,
    stencil_ranges,
)
from pbf_sph_tpu_torch.ops.mc import McSpec, mc_extract, mc_field as gather_mc_field
from pbf_sph_tpu_torch.ops.mc_field import McField
from pbf_sph_tpu_torch.ops.pbf import scalar
from pbf_sph_tpu_torch.ops.phases import CellIndex, PbfPhases

# Capacities are rounded up as the JAX package rounds them, so each backend
# holds the state shapes of the JAX path it is held against: the Pallas block
# (1024 rows) for the kernel backend, 128 for the gather backend (the XLA
# path's `_cap_align`, `jax_solver.py:571-576`).  The kernels themselves take
# any capacity.
CAPACITY_ALIGN = 1024
GATHER_CAPACITY_ALIGN = 128

Tensors = Dict[str, torch.Tensor]
# Called with a stage name as each stage of a frame has been enqueued
# (`bench.PhaseClock` records a CUDA event there); None in production.
Mark = Optional[Callable[[str], None]]


def _no_mark(name: str) -> None:
    pass


# ---------------------------------------------------------------------------
# Static step specification
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SceneSpec:
    """Static shape of the scene (counts / spawn grids)."""

    n_wells: int = 0
    spawn: Tuple[Tuple[int, int], ...] = ()  # per-source (width, depth)
    n_drains: int = 0
    n_queries: int = 0
    query_capacity: int = 128

    @property
    def total_spawn(self) -> int:
        return sum(w * d for w, d in self.spawn)


@dataclass(frozen=True)
class StepSpec:
    capacity: int
    # Largest cell population the spec was sized for: K of the gather
    # backend's (K, C) candidate gathers, which truncate a more populous cell
    # (the growth policy then re-runs the frame under a larger K).  The
    # kernel backend walks exact cell ranges and is not bounded by it.
    cell_capacity: int
    grid: GridSpec
    h: float
    scale: float
    iteration: int
    dtype: str
    scene: SceneSpec
    surface: Optional[McSpec] = None


def scene_spec_of(scene: Scene, config: SphParams, query_capacity: int = 128) -> SceneSpec:
    spawn = []
    for s in scene.sources:
        size = float(np.sqrt(np.float32(s.rate)))
        spawn.append((int(np.floor(size)), int(np.ceil(size))))
    return SceneSpec(
        n_wells=len(scene.wells),
        spawn=tuple(spawn),
        n_drains=len(scene.drains),
        n_queries=len(scene.queries),
        query_capacity=query_capacity,
    )


def scene_arrays_of(scene: Scene, spec: SceneSpec, dtype=np.float32,
                    device="cuda") -> Tensors:
    f = dtype

    def arr(vals, shape, dt=f):
        if not vals:
            return np.zeros(shape, dt)
        return np.asarray(vals, dt).reshape(shape)

    return arrays_to_device(dict(
        wells_centre=arr([w.centre for w in scene.wells], (spec.n_wells, 3)),
        wells_force=arr([w.force for w in scene.wells], (spec.n_wells,)),
        src_centre=arr([s.centre for s in scene.sources], (len(spec.spawn), 3)),
        src_velocity=arr([s.velocity for s in scene.sources], (len(spec.spawn), 3)),
        src_colour=arr([s.colour for s in scene.sources], (len(spec.spawn), 4)),
        src_tag=arr([s.tag for s in scene.sources], (len(spec.spawn),), np.int32),
        drain_centre=arr([d.centre for d in scene.drains], (spec.n_drains, 3)),
        drain_width=arr([d.width for d in scene.drains], (spec.n_drains,)),
        q_point=arr([q.point for q in scene.queries], (spec.n_queries, 3)),
        q_id=arr([q.id for q in scene.queries], (spec.n_queries,), np.int32),
    ), device)


def dyn_params_of(config: SphParams, dtype=np.float32, device="cuda") -> Tensors:
    f = dtype
    surf = config.surface
    return arrays_to_device(dict(
        dt=np.asarray(config.dt, f),
        min_bound=np.asarray(config.min_bound, f),
        max_bound=np.asarray(config.max_bound, f),
        constant_force=np.asarray(config.constant_force, f),
        mc_isolevel=np.asarray(surf.isolevel if surf else 0.0, f),
        mc_particle_size=np.asarray(surf.particle_size if surf else 0.0, f),
        mc_particle_influence=np.asarray(surf.particle_influence if surf else 0.0, f),
    ), device)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def _apply_sources(state: FluidState, scn: Tensors, spec: StepSpec, accept=None,
                   slot_limit=None):
    """Spawn particles into dead slots (reference `src/omp/ompsph.hpp:93-105`);
    the reference's emplace_back becomes mask-set on a fixed-capacity array.

    `accept` (optional): callable spawn_pos (3, total) -> (total,) bool; the
    sharded step passes it so that only the rank owning a source's x-slab
    spawns.  `slot_limit`: candidate dead slots only in [0, slot_limit) (the
    sharded step's owned region, not the ghost tail); the slots beyond sort
    last.  `jax_solver.py:150-214`."""
    sc = spec.scene
    total = sc.total_spawn
    if total == 0:
        return state, torch.zeros((), dtype=torch.int32, device=state.pid.device)
    h = scalar(spec.h, state.mass)
    scale = scalar(spec.scale, state.mass)
    spacing = h * scale / 2
    dev, f = state.mass.device, state.mass.dtype

    pos_parts, vel_parts, col_parts, tag_parts = [], [], [], []
    for i, (w, d) in enumerate(sc.spawn):
        if w * d == 0:
            continue
        centre = scn["src_centre"][i]
        offset = [centre[a] - (float(v) * 0.5) * spacing for a, v in enumerate((w, 0, d))]
        gx = torch.arange(w, dtype=f, device=dev)[:, None]
        gz = torch.arange(d, dtype=f, device=dev)[None, :]
        px = (offset[0] + gx * spacing).expand(w, d)
        py = offset[1].expand(w, d)
        pz = (offset[2] + gz * spacing).expand(w, d)
        pos_parts.append(torch.stack([px.reshape(-1), py.reshape(-1), pz.reshape(-1)]))
        vel_parts.append(scn["src_velocity"][i][:, None].expand(3, w * d))
        col_parts.append(scn["src_colour"][i][:, None].expand(4, w * d))
        tag_parts.append(scn["src_tag"][i].expand(w * d))
    spawn_pos = torch.cat(pos_parts, dim=1)
    spawn_vel = torch.cat(vel_parts, dim=1)
    spawn_col = torch.cat(col_parts, dim=1)
    spawn_tag = torch.cat(tag_parts)

    # dead slots first (stable sort of the alive mask)
    eligible = state.alive.to(torch.int32)
    if slot_limit is not None:
        eligible = torch.where(torch.arange(eligible.shape[0], device=dev) < slot_limit,
                               eligible, 2)
    slots = torch.argsort(eligible, stable=True)[:total]
    can = ~state.alive[slots]
    if slot_limit is not None:
        can = can & (slots < slot_limit)
    if accept is not None:
        can = can & accept(spawn_pos)
    dropped = total - can.sum()

    def put(arr, new):
        out = arr.clone()
        out[..., slots] = torch.where(can, new.to(arr.dtype), arr[..., slots])
        return out

    alive = state.alive.clone()
    alive[slots] = state.alive[slots] | can
    state = FluidState(
        pid=put(state.pid, spawn_tag),
        ptype=put(state.ptype, torch.zeros_like(spawn_tag)),
        mass=put(state.mass, torch.ones((total,), dtype=f, device=dev)),
        position=put(state.position, spawn_pos),
        velocity=put(state.velocity, spawn_vel),
        colour=put(state.colour, spawn_col),
        alive=alive,
    )
    return state, dropped.to(torch.int32)


def _apply_drains(state: FluidState, scn: Tensors, spec: StepSpec) -> FluidState:
    """Clear alive bits within drain radius (reference `src/omp/ompsph.hpp:107-118`)."""
    alive = state.alive
    for i in range(spec.scene.n_drains):
        d2 = torch.zeros_like(state.mass)
        for a in range(3):
            diff = state.position[a] - scn["drain_centre"][i, a]
            d2 = d2 + diff * diff
        hit = (state.ptype == FLUID) & (torch.sqrt(d2) < scn["drain_width"][i])
        alive = alive & ~hit
    return dataclasses.replace(state, alive=alive)


def _queries(scn: Tensors, spec: StepSpec, pid, ptype, alive, cell_table, min_extent):
    """Point queries over the centre cell only (reference
    `src/omp/ompsph.hpp:167-186`, incl. its `zIdx+1 < gridTableN` guard).

    Scans a static `query_capacity` window and reports `overflow` = how many
    cell members beyond the window could not be scanned, so the growth loop
    can enlarge the capacity instead of silently truncating."""
    sc = spec.scene
    qcap = sc.query_capacity
    maxz = spec.grid.maxz
    nx, ny, nz = spec.grid.dims
    dev = pid.device
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if sc.n_queries == 0:
        return (torch.zeros((0, qcap), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev), overflow)
    h = scalar(spec.h, min_extent)
    scale = scalar(spec.scale, min_extent)
    steps = torch.arange(qcap, dtype=torch.int32, device=dev)
    out_ids, out_counts = [], []
    for qi in range(sc.n_queries):
        scaled = scn["q_point"][qi] / scale - min_extent
        qcell = torch.trunc(scaled / h).to(torch.int32)
        in_range = torch.stack(
            [(qcell[a] >= 0) & (qcell[a] < n) for a, n in enumerate((nx, ny, nz))]
        ).all()
        safe = torch.where(in_range, qcell, 0)
        zq = morton_encode3(safe[0], safe[1], safe[2])
        ok = in_range & (zq < maxz) & (zq + 1 < maxz)
        lin = torch.where(ok, (safe[0] * ny + safe[1]) * nz + safe[2], 0).reshape(1)
        # 1-element gathers: indexing by a 0-d tensor would read it to the host
        start = torch.where(ok, cell_table[lin], 0)
        end = torch.where(ok, cell_table[lin + 1], 0)
        idx = start + steps
        m = idx < end
        idxc = torch.where(m, idx, 0).long()
        keep = m & (ptype[idxc] == FLUID) & alive[idxc]
        out_ids.append(torch.where(keep, pid[idxc], -1))
        out_counts.append(keep.sum().to(torch.int32))
        overflow = torch.maximum(overflow, ((end - start) - qcap).reshape(()))
    return (torch.stack(out_ids), torch.stack(out_counts),
            torch.clamp(overflow, min=0))


@dataclass
class SortedFrame:
    """A frame after advect, cell sort and table (steps 3-6): the state in
    cell order with advected velocities, pStar, and the neighbour index."""

    state: FluidState
    pstar: torch.Tensor  # (3, C)
    index: CellIndex
    min_extent: torch.Tensor  # (3,)
    extent_ok: torch.Tensor  # () bool


def advect_and_sort(spec: StepSpec, state: FluidState, dyn: Tensors,
                    scn: Tensors, mark: Mark = None) -> SortedFrame:
    mark = mark or _no_mark
    scale = scalar(spec.scale, state.mass)
    h = scalar(spec.h, state.mass)
    dt = dyn["dt"]
    min_bound, max_bound = dyn["min_bound"], dyn["max_bound"]
    padding = h * 2
    min_extent = min_bound / scale - padding

    # GridSpec freezes the extent from the *initial* bounds; assert per frame
    # that the current bounds still span it.  The 1e-3-cell slack absorbs
    # one-ULP jitter against GridSpec.from_bounds' host division; a real
    # domain resize moves the span by >= 1 cell.
    needed = torch.trunc(
        ((max_bound / scale + padding) - min_extent) / h - 1e-3
    ).to(torch.int32)
    extent_ok = torch.stack(
        [needed[a] <= e for a, e in enumerate(spec.grid.extent)]
    ).all()

    # 3. advect
    vel, pstar = pbf.advect(
        state.position, state.velocity, state.mass, state.ptype, state.alive,
        scn["wells_centre"], scn["wells_force"], dyn["constant_force"], dt, scale,
    )
    mark("advect")

    # 4-5. cells + stable sort by key, then one gather per field
    cells = cell_coords(pstar, min_extent, h)
    key = sort_key(cells, state.alive, spec.grid)
    key, order = torch.sort(key, stable=True)
    vel = vel[:, order]
    state = FluidState(
        pid=state.pid[order], ptype=state.ptype[order], mass=state.mass[order],
        position=state.position[:, order], velocity=vel,
        colour=state.colour[:, order], alive=state.alive[order],
    )
    # pStar recomputed from the sorted fields with advect's formula (exact)
    fluid_s = (state.ptype == FLUID) & state.alive
    pstar = torch.stack([
        torch.where(fluid_s, vel[a] * dt + state.position[a] / scale,
                    state.position[a] / scale)
        for a in range(3)
    ])
    mark("sort+gather")

    # 6. dense cell table
    table = build_cell_table(key, spec.grid)
    mark("table")
    return SortedFrame(state=state, pstar=pstar,
                       index=CellIndex(grid=spec.grid, key=key, table=table),
                       min_extent=min_extent, extent_ok=extent_ok)


def neighbour_phases(phases: Optional[PbfPhases], spec: StepSpec, index: CellIndex,
                     colour, pstar, mass, ptype, alive,
                     dt, scale, min_bound, max_bound, mark: Mark = None,
                     refresh_lam=None, refresh_pstar=None):
    """Colour diffusion, then `spec.iteration` rounds of lambda and delta
    (`jax_solver.py:306-352`), through the kernel backend's `phases` or, when
    `phases` is None, the gather backend's K-capped gathers.

    `refresh_lam` ((C,) -> (C,)) and `refresh_pstar` ((3, C) -> (3, C)) are
    the slab engine's halo hooks: applied to lambda right after each lambda
    phase and to pStar right after each delta phase and its clamp, so that
    ghost rows carry their owners' values into the next use.  The
    single-chip step passes None.  Returns (colour, pstar)."""
    mark = mark or _no_mark
    if phases is not None:
        colour = phases.diffuse(index, colour, ptype, alive, dt)
        mark("diffuse")
        pstar = phases.solve(index, pstar, mass, ptype, alive, spec.iteration,
                             scale, min_bound, max_bound, mark,
                             refresh_lam=refresh_lam, refresh_pstar=refresh_pstar)
        return colour, pstar
    cells, member = decode_key(index.key, spec.grid)
    ranges = stencil_ranges(cells, member, index.table, spec.grid)
    K = spec.cell_capacity
    colour = pbf.diffuse(colour, ptype, alive, ranges, K, dt)
    mark("diffuse")
    for _ in range(spec.iteration):
        lam = pbf.lambda_phase(pstar, mass, ptype, alive, ranges, K, spec.h)
        if refresh_lam is not None:
            lam = refresh_lam(lam)
        mark("lambda")
        pstar = pbf.delta_phase(pstar, lam, ptype, alive, ranges, K, spec.h,
                                scale, min_bound, max_bound)
        if refresh_pstar is not None:
            pstar = refresh_pstar(pstar)
        mark("delta")
    return colour, pstar


def solve_frame(spec: StepSpec, phases: Optional[PbfPhases], state: FluidState,
                dyn: Tensors, scn: Tensors, mark: Mark = None):
    """Stages 1-10 of a frame: sources, drains, advect, sort, table, queries,
    diffusion, the constraint solve and finalise; `phases` None takes the
    gather backend.  Returns (frame, new_state, outputs): the sort-time frame
    (its cell index feeds the MC field), the finalised state in cell order,
    and the frame's output tensors."""
    mark = mark or _no_mark
    mark("begin")
    dev = state.pid.device
    scale = scalar(spec.scale, state.mass)
    dt = dyn["dt"]
    min_bound, max_bound = dyn["min_bound"], dyn["max_bound"]

    # 1-2. sources / drains
    state, spawn_dropped = _apply_sources(state, scn, spec)
    state = _apply_drains(state, scn, spec)
    mark("sources+drains")

    # 3-6. advect, sort, table
    fr = advect_and_sort(spec, state, dyn, scn, mark)
    state = fr.state
    occupancy = max_cell_occupancy(fr.index.table)

    # 7. queries (before diffusion, reference order `src/omp/ompsph.hpp:167`)
    q_ids, q_counts, q_overflow = _queries(
        scn, spec, state.pid, state.ptype, state.alive, fr.index.table,
        fr.min_extent,
    )
    mark("occupancy+queries")

    # 8-9. colour diffusion + constraint solve
    colour, pstar = neighbour_phases(
        phases, spec, fr.index,
        state.colour, fr.pstar, state.mass, state.ptype, state.alive,
        dt, scale, min_bound, max_bound, mark,
    )

    # 10. finalise
    position, velocity = pbf.finalise(
        state.position, state.velocity, pstar, state.ptype, state.alive, dt, scale
    )
    mark("finalise")

    outputs: Dict[str, Any] = dict(
        max_occupancy=occupancy,
        alive_count=state.alive.sum().to(torch.int32),
        spawn_dropped=spawn_dropped,
        extent_ok=fr.extent_ok,
        # neither backend has a strip buffer, so nothing can overflow
        # one: always 0
        strip_overflow=torch.zeros((), dtype=torch.int32, device=dev),
        query_ids=q_ids,
        query_counts=q_counts,
        query_overflow=q_overflow,
    )
    new_state = FluidState(
        pid=state.pid, ptype=state.ptype, mass=state.mass,
        position=position, velocity=velocity, colour=colour, alive=state.alive,
    )
    return fr, new_state, outputs


def surface_stage(spec: StepSpec, mc_field: Optional[McField], fr: SortedFrame,
                  state: FluidState, dyn: Tensors, mark: Mark = None) -> Tensors:
    """Stage 11, the marching-cubes surface of the finalised `state`: the
    field gathers by the sort-time cells of `fr` and measures distances to
    the post-finalise positions (`jax_solver.py:484-504`), through the
    kernel backend's `mc_field` or, when it is None, the XLA field."""
    mark = mark or _no_mark
    mc = spec.surface
    if mc_field is not None:
        lat_v, lat_n, lat_c = mc_field(
            fr.index, mc, spec.scale, state.position, state.colour, state.ptype,
            state.alive, fr.min_extent, dyn["mc_particle_size"])
    else:
        lat_v, lat_n, lat_c = gather_mc_field(
            state.position, state.colour, state.ptype, state.alive, fr.index.table,
            spec.grid, fr.min_extent, spec.grid.extent, mc, spec.cell_capacity, spec.h,
            scalar(spec.scale, state.mass), dyn["mc_particle_size"],
            dyn["mc_particle_influence"])
    mark("mc field")
    vs, ns, cs, total, emit_ovf = mc_extract(
        lat_v, lat_n, lat_c, fr.min_extent, mc, spec.h,
        scalar(spec.scale, lat_v), dyn["mc_isolevel"])
    mark("mc extract")
    return dict(mesh_vs=vs, mesh_ns=ns, mesh_cs=cs, tri_count=total,
                mc_emit_overflow=emit_ovf,
                # no strip buffer in either field: always 0
                mc_strip_overflow=torch.zeros_like(total))


def build_step(spec: StepSpec, phases: Optional[PbfPhases], mc_field: Optional[McField]):
    """The full-frame step for a static spec:
    step(state, dyn, scn, mark=None) -> (new_state, outputs), all tensors
    on the state's device.  `phases` and `mc_field` None take the gather
    backend."""

    def step(state: FluidState, dyn: Tensors, scn: Tensors, mark: Mark = None):
        fr, new_state, outputs = solve_frame(spec, phases, state, dyn, scn, mark)
        if spec.surface is not None:
            outputs.update(surface_stage(spec, mc_field, fr, new_state, dyn, mark))
        return new_state, outputs

    return step


# ---------------------------------------------------------------------------
# Solver frontend
# ---------------------------------------------------------------------------


class TorchSolver(Solver):
    """The port's solver on `device`: "cuda[:n]" unless the caller asks for
    "cpu".  `gather=False` is the kernel backend (`torch`, fp32 only);
    `gather=True` the gather backend, in `dtype` float32 or float64."""

    def __init__(
        self,
        h: float = 0.1,
        cell_capacity: int = 48,
        query_capacity: int = 128,
        dtype: str = "float32",
        gather: bool = False,
        device="cuda",
    ):
        super().__init__(h)
        self.dtype = np.dtype(dtype)
        self.gather = bool(gather)
        if not self.gather and self.dtype != np.dtype(np.float32):
            # the kernels are fp32-only, as the Pallas backend refuses fp64
            # (`jax_solver.py:536-540`)
            raise ValueError("FP64 is not supported for the torch backend")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSolver(device='cuda') needs a CUDA device, but "
                "torch.cuda.is_available() is False")
        self.cell_capacity = int(cell_capacity)
        self.query_capacity = int(query_capacity)
        # the kernel backend's wrappers; the gather backend calls neither, so
        # their launch counts stay 0 on it
        self.phases = PbfPhases(self.h)
        self.mc_field = McField(self.h)
        self._steps: Dict[StepSpec, Any] = {}

    @property
    def launches(self) -> Dict[str, int]:
        """Kernel launches by kernel name since the last reset."""
        return {**self.phases.launches, **self.mc_field.launches}

    def reset_launches(self) -> None:
        self.phases.reset_launches()
        self.mc_field.reset_launches()

    def get_step(self, spec: StepSpec):
        fn = self._steps.get(spec)
        if fn is None:
            if self.gather:
                fn = build_step(spec, None, None)
            else:
                fn = build_step(spec, self.phases, self.mc_field)
            self._steps[spec] = fn
        return fn

    def _capacity_for(self, config: SphParams, scene: Scene, n: int) -> int:
        n += scene_spec_of(scene, config, self.query_capacity).total_spawn
        al = GATHER_CAPACITY_ALIGN if self.gather else CAPACITY_ALIGN
        return max(al, -(-n // al) * al)

    # -- device-resident fast path (benchmark loop) ---------------------------

    def prepare(
        self,
        config: SphParams,
        scene: Scene,
        xs: ParticleSoA,
        capacity: Optional[int] = None,
        cell_capacity: Optional[int] = None,
    ):
        """Build (spec, device state, scene arrays) for a run of `step_device`
        calls that keep all state on the device."""
        cap = capacity or self._capacity_for(config, scene, len(xs))
        spec = self.make_spec(config, scene, cap, cell_capacity)
        state = FluidState.from_soa(xs, spec.capacity, self.dtype, self.device)
        scn = scene_arrays_of(scene, spec.scene, self.dtype, self.device)
        return spec, state, scn

    def step_device(self, spec: StepSpec, state: FluidState, dyn: Tensors,
                    scn: Tensors, mark: Mark = None):
        """One frame; returns (new_state, outputs) as device tensors, without
        reading anything back to the host."""
        return self.get_step(spec)(state, dyn, scn, mark)

    def make_spec(
        self,
        config: SphParams,
        scene: Scene,
        capacity: int,
        cell_capacity: Optional[int] = None,
        tri_capacity: Optional[int] = None,
    ) -> StepSpec:
        grid = GridSpec.from_bounds(config.min_bound, config.max_bound, config.scale, self.h)
        surface = None
        if config.surface is not None:
            # tri_capacity 0: ~1 triangle a cube (McSpec.from_extent)
            surface = McSpec.from_extent(
                grid.extent,
                config.surface.resolution,
                tri_capacity or 0,
                influence_static=config.surface.particle_influence,
            )
        return StepSpec(
            capacity=int(capacity),
            cell_capacity=int(cell_capacity or self.cell_capacity),
            grid=grid,
            h=self.h,
            scale=float(config.scale),
            iteration=int(config.iteration),
            dtype=str(self.dtype),
            scene=scene_spec_of(scene, config, self.query_capacity),
            surface=surface,
        )

    # -- host-level API (reference `Solver::advance` parity) ------------------

    def advance(self, config: SphParams, scene: Scene, xs: ParticleSoA,
                mark: Mark = None):
        """One frame of `xs` (reference `Solver::advance`); `mark` is the
        step's stage hook, called again for each re-run of the frame."""
        spec = self.make_spec(config, scene, self._capacity_for(config, scene, len(xs)))
        scn = scene_arrays_of(scene, spec.scene, self.dtype, self.device)
        dyn = dyn_params_of(config, self.dtype, self.device)

        for _attempt in range(4):
            state = FluidState.from_soa(xs, spec.capacity, self.dtype, self.device)
            new_state, out = self.step_device(spec, state, dyn, scn, mark)
            if not bool(out["extent_ok"]):
                raise RuntimeError(
                    "frame bounds exceed the grid extent "
                    f"{spec.grid.extent}; the solver's GridSpec was frozen from "
                    "the initial bounds — rebuild the solver for a larger domain"
                )
            # grow and re-run the frame under a larger spec; the policy is
            # shared with bench.py (models/growth.py)
            changes = growth_changes(spec, out)
            if not changes:
                break
            spec = dataclasses.replace(spec, **changes)
        else:
            raise RuntimeError("capacity growth did not converge")

        if int(out["alive_count"]) == 0:
            return Result(), ParticleSoA.empty(self.dtype)
        return self._extract_result(out, scn, spec), new_state.to_soa()

    def _extract_result(self, out, scn, spec: StepSpec) -> Result:
        mesh = ColouredMesh.empty(self.dtype)
        if spec.surface is not None:
            t3 = 3 * int(out["tri_count"])
            mesh = ColouredMesh(*(out[k][:, :t3].T.cpu().numpy()
                                  for k in ("mesh_vs", "mesh_ns", "mesh_cs")))
        queries = []
        ids_all = out["query_ids"].cpu().numpy()
        q_id = scn["q_id"].cpu().numpy()
        q_point = scn["q_point"].cpu().numpy()
        for qi in range(spec.scene.n_queries):
            ids = ids_all[qi]
            queries.append(
                QueryResult(
                    id=int(q_id[qi]),
                    point=q_point[qi],
                    neighbours=ids[ids >= 0].astype(np.int32),
                )
            )
        return Result(mesh=mesh, queries=queries)
