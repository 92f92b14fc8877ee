"""The port's 2D tile engine (`pbf_sph_tpu_torch/parallel/sharded2d.py`) and
the mesh axes of its transport on the CPU.

* `_axis_cap` and `_equal_count_cuts` against the JAX functions on seeded
  columns; `Shard2DSpec.create` (fixed and rebalance, with and without
  surface, both backends) field for field the JAX spec, with `wx_max`,
  `wy_max`, `grid_local`, `cap_total` and `distribute_particles_2d`;
* the slice against the JAX package: the JAX `build_sharded2d_step` (XLA
  path) at 2x2 on the virtual CPU mesh, dam_break(1200, 2), cell capacity
  16, 2 frames, against 4 `ThreadComm` ranks through both backends (the
  kernel backend's plain versions, the gather backend).  Integer stats
  exact every frame, ghosts on every tile, alive particles by pid within
  atol 1e-3 (position, velocity) and 1e-5 (colour), the tolerances of
  `test_torch_step.py`.  Fixed cuts run in the fast tier; the rebalance
  case (from cuts one column and one row off the equal-count ones) is
  `slow`, as the JAX package's own rebalance tests are, because it
  compiles a second JAX program;
* against the port's own single-chip `TorchSolver` with the JAX sharded
  tests' tolerances (`tests/test_sharded.py:63-77`): a scene with a well, a
  source, a drain and a query; conservation under the sloshing bounds with
  `cap_local` below the count and a particle that crosses both axes in one
  frame; a surface frame whose triangles equal the single chip's; cuts that
  move on both axes under rebalancing; two runs bit for bit;
* `MeshAxis` over `ThreadComm` at NX=2, NY=3 with rank-tagged payloads (the
  `DistComm` case rides `test_torch_sharded.py`'s 2-process gloo spawn);
* the CLI's `--multichip 2x2 --devices cpu`.

torch runs on one intra-op thread in this module.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pbf_sph_tpu.core.configs import dam_break as jax_dam_break
from pbf_sph_tpu_torch.convert import sharded_state_from_numpy, sharded_state_to_numpy
from pbf_sph_tpu_torch.core import types as ttypes
from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.scene import apply_motion_sin_x_cos_z, simple_config_with_2_cubes
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, dyn_params_of, scene_arrays_of
from pbf_sph_tpu_torch.parallel import sharded2d
from pbf_sph_tpu_torch.parallel.comm import MeshAxis, run_ranks

REPO = Path(__file__).resolve().parent.parent
WAIT = 120.0
PROC_WAIT = 240.0
SOA_FIELDS = ("pid", "ptype", "mass", "position", "velocity", "colour")
STATE_FIELDS = SOA_FIELDS + ("alive",)
# tests/test_sharded.py:63-77: sharded against single-chip
SINGLE_TOLS = dict(position=0.1, velocity=0.1, colour=2e-3)
# tests/test_torch_step.py: the port against the JAX package
JAX_TOLS = dict(position=1e-3, velocity=1e-3, colour=1e-5)
# the JAX comparison's cell capacity (as test_torch_sharded.py's JAX_K)
JAX_K = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(soa):
    return ttypes.ParticleSoA(**{f: getattr(soa, f) for f in SOA_FIELDS})


def _close(a, b, tols):
    a, b = a.order_by_id(), b.order_by_id()
    np.testing.assert_array_equal(a.pid, b.pid)
    for name, atol in tols.items():
        np.testing.assert_allclose(getattr(a, name), getattr(b, name), atol=atol, rtol=0,
                                   err_msg=name)


def _tiles(spec, cfg, frames, states, bounds=None, motion=False, scn=None, frame0=0):
    """`frames` frames of the tile engine from the ranks' `states` on
    ThreadComm ranks on the CPU (with `motion`, the sloshing bounds of
    frames frame0...).  Returns (final states, assembled stats a frame,
    (xb, yb) a frame, each rank's last-frame stats)."""

    def rank(comm):
        state = states[comm.rank]
        step = sharded2d.build_sharded2d_step(spec, comm)
        b, out = bounds, []
        for f in range(frames):
            dyn = dyn_params_of(apply_motion_sin_x_cos_z(cfg, frame0 + f) if motion else cfg,
                                np.float32, "cpu")
            if spec.rebalance:
                state, s, b = step(state, dyn, scn, bounds=b)
                out.append((s, tuple(v.numpy().copy() for v in b)))
            else:
                state, s = step(state, dyn, scn)
                out.append((s, None))
        return state, out

    ranks = run_ranks(spec.nx * spec.ny, rank, "cpu", timeout=WAIT)
    stats = [sharded2d.assemble_stats([r[1][f][0] for r in ranks]) for f in range(frames)]
    return ([r[0] for r in ranks], stats, [ranks[0][1][f][1] for f in range(frames)],
            [r[1][-1][0] for r in ranks])


def _distributed(spec, xs, bounds=None):
    whole = sharded2d.distribute_particles_2d(xs, spec, bounds=bounds)
    return [sharded2d.local_state(whole, r, spec, "cpu") for r in range(spec.nx * spec.ny)]


def _single(cfg, xs, frames, gather=False, motion=False, scene=None):
    solver = TorchSolver(h=cfg.h, device="cpu", gather=gather)
    res = None
    for f in range(frames):
        c = apply_motion_sin_x_cos_z(cfg, f) if motion else cfg
        res, xs = solver.advance(c, scene or ttypes.Scene(), xs)
    return res, xs


def _shifted_cuts(spec):
    """Valid cuts one column and one row past the equal-count ones."""
    xb, yb = (b.copy() for b in spec.initial_bounds())
    xb[1:-1] += 1
    yb[1:-1] += 1
    for b, wmax in ((xb, spec.wx_max), (yb, spec.wy_max)):
        w = np.diff(b)
        assert (w >= spec.min_w).all() and (w <= wmax).all(), b
    return xb, yb


# ---------------------------------------------------------------------------
# Spec, sizing and host-side placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_axis_cuts_match_jax(seed):
    from pbf_sph_tpu.parallel import sharded2d as jsh

    rng = np.random.default_rng(seed)
    g = int(rng.integers(12, 90))
    # a skewed column histogram with empty stretches
    vals = np.clip(rng.normal(g * 0.3, g * 0.15, 5000), -5, g + 5).astype(np.int64)
    for n in (1, 2, 3, 4):
        for min_w in (1, 3):
            if g < n * min_w:
                continue
            for cap in (0, g // n + 1, 2 * g):
                assert sharded2d._axis_cap(g, n, min_w, cap) == jsh._axis_cap(g, n, min_w, cap)
            for max_w in (None, jsh._axis_cap(g, n, min_w)):
                got = sharded2d._equal_count_cuts(vals, 0, g, n, min_w, max_w)
                assert got == jsh._equal_count_cuts(vals, 0, g, n, min_w, max_w)
                w = np.diff(got)
                assert got[0] == 0 and got[-1] == g and (w >= min_w).all()


def _spec_pair(rebalance, surface, gather, **kw):
    from pbf_sph_tpu.parallel import sharded2d as jsh

    mc, cfg, xs = dam_break(1200, solver_iter=2, surface=surface)
    kw = dict(rebalance=rebalance, cap_local=len(xs) if rebalance else 0, **kw)
    jspec = jsh.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h, use_pallas=not gather, **kw)
    tspec = sharded2d.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h, gather=gather, **kw)
    return jspec, tspec, cfg, xs


@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("surface", [False, True])
@pytest.mark.parametrize("rebalance", [False, True])
def test_shard2d_spec_matches_jax(rebalance, surface, gather):
    from pbf_sph_tpu.parallel import sharded2d as jsh

    jspec, tspec, cfg, xs = _spec_pair(rebalance, surface, gather)
    jf = {f.name for f in dataclasses.fields(jspec)}
    tf = {f.name for f in dataclasses.fields(tspec)}
    assert jf - tf == {"use_pallas", "strip_capacity"} and tf - jf == {"gather"}
    assert tspec.gather == (not jspec.use_pallas) and jspec.strip_capacity == 0
    for name in sorted(jf & tf):
        j, t = getattr(jspec, name), getattr(tspec, name)
        if name in ("grid_global", "scene"):
            assert dataclasses.asdict(j) == dataclasses.asdict(t), name
        elif name == "surface":
            assert (j is None) == (t is None) == (not surface)
            if j is not None:
                for k in ("resolution", "sample", "tri_capacity", "influence_static",
                          "cube_cap"):
                    assert getattr(j, k) == getattr(t, k), k
        else:
            assert j == t, name
    assert dataclasses.asdict(tspec.grid_local) == dataclasses.asdict(jspec.grid_local)
    for k in ("wx_max", "wy_max", "cap_total"):
        assert getattr(tspec, k) == getattr(jspec, k), k
    # the local grid is narrower in y than the global one
    assert tspec.grid_local.dims[1] < tspec.grid_global.dims[1]
    bounds = _shifted_cuts(tspec) if rebalance else None
    want = jsh.distribute_particles_2d(xs, jspec, bounds=bounds)
    got = sharded2d.distribute_particles_2d(_to_port(xs), tspec, bounds=bounds)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    back = sharded_state_to_numpy(
        [sharded2d.local_state(got, r, tspec, "cpu") for r in range(4)])
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(want, f)), f)


def test_shard2d_spec_refusals_match_jax():
    from pbf_sph_tpu.parallel import sharded2d as jsh

    mc, cfg, xs = dam_break(1200, solver_iter=2)
    for nx, ny in ((5, 2), (2, 5)):  # 13 columns hold at most 4 tiles of 3
        with pytest.raises(ValueError) as want:
            jsh.Shard2DSpec.create(cfg, nx, ny, xs, cfg.h)
        with pytest.raises(ValueError) as got:
            sharded2d.Shard2DSpec.create(cfg, nx, ny, xs, cfg.h)
        assert str(got.value) == str(want.value)
    frac = cfg.replace(surface=dataclasses.replace(mc, resolution=1.5))
    with pytest.raises(ValueError, match="integer MC resolution"):
        jsh.Shard2DSpec.create(frac, 2, 2, xs, cfg.h)
    with pytest.raises(ValueError, match="integer MC resolution"):
        sharded2d.Shard2DSpec.create(frac, 2, 2, xs, cfg.h)
    spec = sharded2d.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h, cap_local=256)
    with pytest.raises(ValueError, match=r"tile \(0,0\): 480 particles > cap 256"):
        sharded2d.distribute_particles_2d(xs, spec)
    # grown ghosts replace the defaults before the kernel backend's alignment
    grown = sharded2d.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h, gather=False, ghost_x=2048,
                                         ghost_y=4096)
    assert (grown.ghost_x, grown.ghost_y) == (2048, 4096) and grown.cap_total % 1024 == 0


@pytest.mark.parametrize("cube_cap", [0, 256], ids=["every-cube", "compacted"])
def test_mc_extract_tile_bounds_match_jax(cube_cap):
    """A tile's extraction: the node offset and both ownership bounds
    (`cube_x_hi`, `cube_y_hi`) against the JAX `mc_extract` on a seeded
    lattice, every cube or the compacted live cubes."""
    import jax
    import jax.numpy as jnp

    from pbf_sph_tpu.ops import mc as jmc
    from pbf_sph_tpu_torch.ops import mc as tmc

    rng = np.random.default_rng(7)
    sample, extent = (9, 8, 7), (16.0, 14.0, 6.0)
    L = int(np.prod(sample))
    lat_v = rng.uniform(0.0, 2.0, L).astype(np.float32)
    lat_n = rng.normal(size=(3, L)).astype(np.float32)
    lat_c = rng.uniform(size=(4, L)).astype(np.float32)
    min_extent = np.asarray([-0.2, -0.3, -0.1], np.float32)
    node_off, x_hi, y_hi = (6, 4, 0), 12, 9
    kw = dict(resolution=1.0, sample=sample, tri_capacity=1024, influence_static=0.5,
              cube_cap=cube_cap)
    jspec = dataclasses.replace(jmc.McSpec.from_extent(extent, 1.0), **kw)
    tspec = tmc.McSpec(**kw)
    want = jax.jit(lambda v, n, c, me, xh, yh: jmc.mc_extract(
        v, n, c, me, extent, jspec, 0.1, jnp.float32(2.0), jnp.float32(1.0),
        node_offset=node_off, cube_x_hi=xh, cube_y_hi=yh))(
            lat_v, lat_n, lat_c, min_extent, jnp.int32(x_hi), jnp.int32(y_hi))
    t = torch.from_numpy
    got = tmc.mc_extract(t(lat_v), t(lat_n), t(lat_c), t(min_extent), tspec, 0.1,
                         torch.tensor(2.0), torch.tensor(1.0), node_offset=node_off,
                         cube_x_hi=torch.tensor(x_hi), cube_y_hi=torch.tensor(y_hi),
                         extent=extent)
    total = int(got[3])
    assert total == int(want[3]) and 0 < total <= 1024 and int(got[4]) == int(want[4]) == 0
    # without the y bound the tile emits more: the mask is live
    more = tmc.mc_extract(t(lat_v), t(lat_n), t(lat_c), t(min_extent), tspec, 0.1,
                          torch.tensor(2.0), torch.tensor(1.0), node_offset=node_off,
                          cube_x_hi=x_hi, extent=extent)
    assert int(more[3]) > total
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g[:, :3 * total].numpy(), np.asarray(w)[:, :3 * total],
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The slice against the JAX package
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_tiles(rebalance: bool):
    """The JAX 2D step at 2x2 on dam_break(1200, 2), 2 frames: (initial
    global state as numpy, initial cuts, stats a frame, cuts a frame, final
    alive particles)."""
    from pbf_sph_tpu.models.jax_solver import dyn_params_of as jdyn
    from pbf_sph_tpu.parallel import sharded2d as jsh

    mc, cfg, xs = jax_dam_break(1200, solver_iter=2)
    spec = jsh.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h, rebalance=rebalance,
                                  cap_local=len(xs) if rebalance else 0, cell_capacity=JAX_K)
    b0 = (_shifted_cuts(sharded2d.Shard2DSpec.create(
        cfg, 2, 2, xs, cfg.h, rebalance=True, cap_local=len(xs))) if rebalance else None)
    whole = jsh.distribute_particles_2d(xs, spec, bounds=b0)
    first = {f: np.asarray(getattr(whole, f)) for f in STATE_FIELDS}
    mesh = jsh.make_mesh2d(2, 2)
    state = jsh.shard_state_2d(whole, mesh)
    step = jsh.build_sharded2d_step(spec, mesh)
    stats, cuts, b = [], [], b0
    with mesh:
        for f in range(2):
            dyn = jdyn(cfg, np.float32)
            if rebalance:
                state, s, b = step(state, dyn, bounds=b)
                cuts.append(tuple(np.asarray(v) for v in b))
            else:
                state, s = step(state, dyn)
            stats.append({k: np.asarray(v) for k, v in s.items()})
    return first, b0, stats, cuts, state.to_soa()


@functools.lru_cache(maxsize=None)
def _port_tiles(rebalance: bool, gather: bool):
    """The port's side of `_jax_tiles` (cached: the repeat test reruns it)."""
    first, b0, _, _, _ = _jax_tiles(rebalance)
    return _port_run(rebalance, gather, first, b0)


def _port_run(rebalance, gather, first, b0):
    mc, cfg, xs = dam_break(1200, solver_iter=2)
    spec = sharded2d.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h, gather=gather,
                                        rebalance=rebalance,
                                        cap_local=len(xs) if rebalance else 0,
                                        cell_capacity=JAX_K)
    if gather:  # the JAX distribution itself, carried over
        states = sharded_state_from_numpy(first, 4, "cpu")
    else:  # the kernel backend's capacity is padded: the same owner rule
        states = _distributed(spec, xs, b0)
    start = [int(s.alive.sum()) for s in states]
    return (start,) + _tiles(spec, cfg, 2, states, bounds=b0)


@pytest.mark.parametrize("gather", [True, False], ids=["gather", "kernels"])
@pytest.mark.parametrize("rebalance", [False, pytest.param(True, marks=pytest.mark.slow)],
                         ids=["fixed", "rebalance"])
def test_tiles_match_jax(rebalance, gather):
    _, b0, jstats, jcuts, jfinal = _jax_tiles(rebalance)
    start, final, stats, cuts, _ = _port_tiles(rebalance, gather)
    for f in range(2):
        assert sorted(stats[f]) == sorted(jstats[f])
        for k, v in jstats[f].items():
            np.testing.assert_array_equal(stats[f][k], v, err_msg=f"frame {f}: {k}")
        if rebalance:
            for a in range(2):
                np.testing.assert_array_equal(cuts[f][a], jcuts[f][a],
                                              err_msg=f"frame {f}: cuts {a}")
    # the traffic the comparison depends on: ghosts on every tile, both passes
    assert all((s["ghost_peak"] > 0).all() for s in stats)
    if not rebalance:  # fluid on every tile
        assert all((s["alive_count"] > 0).all() for s in stats)
    if rebalance:
        assert not np.array_equal(cuts[0][0], b0[0]) and not np.array_equal(cuts[0][1], b0[1])
        assert stats[-1]["alive_count"].tolist() != start, start
    _close(sharded2d.gather_soa(final), _to_port(jfinal), JAX_TOLS)


def test_tiles_repeat_bit_for_bit():
    first, b0, _, _, _ = _jax_tiles(False)
    a, b = _port_tiles(False, False), _port_run(False, False, first, b0)
    for sa, sb in zip(a[1], b[1]):
        for f in STATE_FIELDS:
            assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    for sa, sb in zip(a[4], b[4]):
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


# ---------------------------------------------------------------------------
# Against the port's single chip
# ---------------------------------------------------------------------------


def test_scene_dynamics_match_single():
    """A well, a source, a drain and a query at 2x2 (tests/test_sharded.py:
    491-520): spawn only on the tile owning the spawn cell on both axes,
    queries merged over the tiles."""
    mc, cfg, xs = dam_break(1200, solver_iter=2)
    lo = np.asarray(cfg.min_bound, np.float32)
    hi = np.asarray(cfg.max_bound, np.float32)
    mid = (lo + hi) / 2
    scene = ttypes.Scene(
        wells=[ttypes.Well(tag=0, centre=tuple(mid * 0.6), force=150.0)],
        sources=[ttypes.Source(tag=777, centre=tuple(mid), velocity=(0, 1, 0),
                               colour=(1, 0, 0, 1), rate=9)],
        drains=[ttypes.Drain(tag=0, centre=tuple(mid * 0.3), width=40.0)],
        queries=[ttypes.Query(id=3, point=tuple(mid * 0.5))],
    )
    spec = sharded2d.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h, scene=scene, gather=False)
    scn = scene_arrays_of(scene, spec.scene, np.float32, "cpu")
    final, stats, _, _ = _tiles(spec, cfg, 2, _distributed(spec, xs), scn=scn)
    res, single = _single(cfg, xs, 2, scene=scene)
    for k in ("migrate_dropped", "spawn_dropped", "ghost_dropped"):
        assert stats[-1][k].sum() == 0, k
    got = sharded2d.gather_soa(final)
    assert len(got) == len(single) != len(xs)

    def canon(s):  # spawned particles share a tag: order by (id, rounded position)
        r = np.round(s.position, 1)
        o = np.lexsort((r[:, 2], r[:, 1], r[:, 0], s.pid))
        return ttypes.ParticleSoA(*(getattr(s, f)[o] for f in SOA_FIELDS))

    a, b = canon(got), canon(single)
    np.testing.assert_array_equal(a.pid, b.pid)
    np.testing.assert_allclose(a.position, b.position, atol=0.1, rtol=0)
    np.testing.assert_allclose(a.colour, b.colour, atol=2e-3, rtol=0)
    ids = set(int(v) for v in stats[-1]["query_ids"][0] if v >= 0)
    want = set(res.queries[0].neighbours.tolist())
    assert ids == want and len(want) > 0
    assert int(stats[-1]["query_counts"][0]) == len(want)


def test_conserves_particles_under_motion():
    """The sloshing bounds at cap_local below the count (tests/
    test_sharded.py:523-548, 4 of its 12 frames), with one particle sent
    across both tile axes in the first frame: the two-phase migration hands
    it to the diagonal tile at once."""
    mc, cfg, xs = dam_break(1600, solver_iter=1)
    spec = sharded2d.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h, cap_local=1024, gather=False)
    assert spec.cap_local < len(xs)
    h, scale, dt = cfg.h, np.float32(cfg.scale), float(np.float32(cfg.dt))
    me = np.asarray(cfg.min_bound, np.float32) / scale - np.float32(h) * 2
    # a particle in the last cell of tile (0, 0), one cell a frame toward (1, 1)
    cell = np.array([spec.xb[1] - 1, spec.yb[1] - 1, 5])
    pos, vel = xs.position.copy(), xs.velocity.copy()
    pos[0] = (me + (cell + 0.5) * h) * scale
    vel[0] = (h / dt, 1.5 * h / dt, 0.0)
    xs = ttypes.ParticleSoA(xs.pid, xs.ptype, xs.mass, pos, vel, xs.colour)
    mover = int(xs.pid[0])
    states = _distributed(spec, xs)
    assert mover in states[0].pid[states[0].alive].tolist()
    first, stats, _, _ = _tiles(spec, cfg, 1, states, motion=True)
    assert mover in first[3].pid[first[3].alive].tolist(), "the particle did not move diagonally"
    final, more, _, _ = _tiles(spec, cfg, 3, first, motion=True, frame0=1)
    for s in stats + more:
        for k in ("migrate_dropped", "ghost_dropped"):
            assert int(s[k].sum()) == 0, k
        assert int(s["alive_count"].sum()) == len(xs)
    out = sharded2d.gather_soa(final)
    np.testing.assert_array_equal(np.sort(out.pid), np.sort(xs.pid))
    assert np.isfinite(out.position).all() and np.isfinite(out.velocity).all()


def test_surface_matches_single():
    """The tiles' marching cubes (the XLA field over the local nodes with the
    node and cell offsets, cubes owned below both next cuts) concatenate to
    the single-chip triangle soup (tests/test_sharded.py:569-616)."""
    mc, cfg, xs = simple_config_with_2_cubes(1500, 2, 500.0)
    cfg = cfg.replace(surface=dataclasses.replace(mc, resolution=1.0))
    spec = sharded2d.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h)
    _, stats, _, last = _tiles(spec, cfg, 1, _distributed(spec, xs))
    res, _ = _single(cfg, xs, 1, gather=True)
    t_ref = len(res.mesh) // 3
    assert t_ref > 0
    for k in ("migrate_dropped", "ghost_dropped", "mc_emit_overflow"):
        assert int(stats[-1][k].sum()) == 0, k
    tris = stats[-1]["tri_count"]
    assert int(tris.sum()) == t_ref and (tris > 0).sum() >= 2, tris
    vs, ns, cs = sharded2d.gather_mesh(last)
    assert len(vs) == len(ns) == len(cs) == 3 * t_ref

    def canon(a):
        r = np.round(a.reshape(-1, 9), 3)
        return r[np.lexsort(r.T[::-1])]

    np.testing.assert_allclose(canon(vs), canon(res.mesh.vs), atol=2e-2, rtol=0)


def test_rebalance_matches_single():
    mc, cfg, xs = dam_break(1200, solver_iter=3)
    spec = sharded2d.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h, rebalance=True,
                                        cap_local=len(xs), gather=False)
    b0 = _shifted_cuts(spec)
    states = _distributed(spec, xs, b0)
    start = [int(s.alive.sum()) for s in states]
    final, stats, cuts, _ = _tiles(spec, cfg, 2, states, bounds=b0, motion=True)
    assert sum(int(s[k].sum()) for s in stats
               for k in ("migrate_dropped", "migrate_deferred", "ghost_dropped")) == 0
    for a in range(2):  # the cuts moved on both axes
        assert not np.array_equal(cuts[0][a], b0[a]), a
        assert np.all(np.diff(cuts[-1][a]) >= spec.min_w)
    assert stats[-1]["alive_count"].tolist() != start  # and ownership with them
    _, single = _single(cfg, xs, 2, motion=True)
    _close(sharded2d.gather_soa(final), single, SINGLE_TOLS)


# ---------------------------------------------------------------------------
# The transport's mesh axes
# ---------------------------------------------------------------------------


def test_mesh_axes_over_thread_comm():
    """NX=2, NY=3, x-major: along x rank r pairs with r +- 3, along y with
    r +- 1 inside its mesh column; an edge gets zeros, and no y exchange
    crosses a column (rank 2's hi and rank 3's lo are empty)."""
    nx, ny = 2, 3

    def rank(comm):
        r = comm.rank
        out = []
        for a in range(2):
            axis = MeshAxis(comm, (nx, ny), a)
            out.append((axis.rank, axis.size, axis.exchange(
                {"v": torch.tensor([r, 0, a]), "valid": torch.ones(2, dtype=torch.bool)},
                {"v": torch.tensor([r, 1, a]), "valid": torch.ones(2, dtype=torch.bool)})))
        total = MeshAxis(comm, (nx, ny), 1).all_reduce_sum(torch.tensor([r]))
        return out, int(total)

    got = run_ranks(nx * ny, rank, "cpu", timeout=WAIT)
    for r, (axes, total) in enumerate(got):
        mx, my = divmod(r, ny)
        assert total == sum(range(nx * ny))
        for a, (along, size, (from_lo, from_hi)) in enumerate(axes):
            assert (along, size) == ((mx, nx) if a == 0 else (my, ny))
            stride = ny if a == 0 else 1
            if along > 0:  # the lo neighbour's to_hi
                assert from_lo["v"].tolist() == [r - stride, 1, a] and from_lo["valid"].all()
            else:
                assert from_lo["v"].tolist() == [0, 0, 0] and not from_lo["valid"].any()
            if along + 1 < size:  # the hi neighbour's to_lo
                assert from_hi["v"].tolist() == [r + stride, 0, a] and from_hi["valid"].all()
            else:
                assert from_hi["v"].tolist() == [0, 0, 0] and not from_hi["valid"].any()


def test_mesh_axis_refuses_a_wrong_group_or_pairing():
    def rank(comm):
        with pytest.raises(ValueError, match="2x2 mesh needs 4 ranks"):
            MeshAxis(comm, (2, 2), 0)
        # rank 0 pairs with 1, but 1 pairs with 2: refused, not a silent halo
        peers = {0: (None, 1), 1: (None, 2), 2: (1, None)}[comm.rank]
        try:
            comm.exchange_peers(*peers, {"v": torch.zeros(1)}, {"v": torch.zeros(1)})
        except ValueError as e:
            return str(e)
        return ""

    got = run_ranks(3, rank, "cpu", timeout=WAIT)
    assert got == ["rank 0 pairs with 1, which pairs with None", "", ""]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_multichip_2x2_on_cpu(tmp_path):
    out = tmp_path / "m"
    argv = ["--devices", "cpu", "--multichip", "2x2", "--workload", "dam1m", "--count", "700",
            "--iter", "1", "--warmup", "1", "--no-surface", "--output", str(out)]
    res = subprocess.run([sys.executable, "-m", "pbf_sph_tpu_torch.cli", *argv], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=PROC_WAIT)
    assert res.returncode == 0, res.stdout + res.stderr
    n = len(dam_break(700)[2])
    assert "Multichip 2D: 2x2 tiles (cpu), static cuts" in res.stdout
    lines = {line.split(":")[0].strip(): line.split(":", 1)[1].strip()
             for line in res.stdout.splitlines() if " : " in line}
    assert int(lines["Final Particle count"]) == n
    counts = [int(v) for v in lines["Per-tile particles"].strip("[]").split(",")]
    assert len(counts) == 4 and sum(counts) == n and min(counts) > 0
    ply = (out / "cloud.ply").read_text().splitlines()
    assert f"element vertex {n}" in ply
    assert int(lines["Final Vertex count"]) == 0
