"""The port's 1D slab engine (`pbf_sph_tpu_torch/parallel/`) on the CPU.

* `_equal_count_target` exact up to 2^31 - 1; `ShardSpec.create` (fixed and
  rebalance, with and without surface, both backends) field for field the
  JAX spec, with `grid_local`, `max_slab_w`, `uniform_bounds`,
  `initial_bounds` and `distribute_particles`; `_apply_sources`' `accept`
  and `slot_limit` against the JAX function;
* the slice against the JAX package: the JAX `build_sharded_step` (XLA path)
  on the virtual CPU mesh at D=4 on dam_break(1200, 2), 2 frames, against
  `ThreadComm` D=4 from the same distribution through both backends (the
  kernel backend's plain versions, the gather backend).  Integer stats and
  bounds exact every frame; alive particles by pid within atol 1e-3
  (position, velocity) and 1e-5 (colour), the tolerances of
  `test_torch_step.py`, which holds the single-chip frame on the resting
  dam too: under the sloshing bounds the walls crush the dam and both
  single-chip solvers already part by ~6e-3 in position after 2 frames.
  The rebalance run starts from a valid partition one column off the
  equal-count one, so that its boundaries move and a column migrates.
  Fixed slabs run in the fast tier; the rebalance case is `slow`, because
  its JAX program alone compiles in ~37 s cold on one process (the fast
  tier keeps rebalance tests against the port's single chip);
* against the port's own single-chip `TorchSolver` with the JAX sharded
  tests' tolerances (`tests/test_sharded.py`): a scene with a source, a
  drain, a well and a query, conservation under motion, deferral through a
  small `migrate_cap`, a surface frame whose triangle soup equals the
  single-chip soup, rebalancing under motion, and two runs bit for bit;
* the transport: `ThreadComm`'s exchange, sums and gathers, a failing rank
  that fails the call, and `DistComm` over gloo in 2 spawned processes
  giving `ThreadComm`'s bits, with the tile engine's `MeshAxis` views
  (2x1 and 1x2) over the same group;
* the CLI's `--multichip` with `--devices cpu`, and its refusals.

Every ThreadComm barrier waits at most `WAIT` seconds, every spawned process
and CLI run `PROC_WAIT`.  torch runs on one intra-op thread in this module.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import pbf_sph_tpu.core.types as jtypes
from pbf_sph_tpu.core.configs import dam_break as jax_dam_break
from pbf_sph_tpu_torch import cli
from pbf_sph_tpu_torch.convert import sharded_state_from_numpy, sharded_state_to_numpy
from pbf_sph_tpu_torch.core import types as ttypes
from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.scene import apply_motion_sin_x_cos_z, simple_config_with_2_cubes
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, dyn_params_of, scene_arrays_of
from pbf_sph_tpu_torch.parallel import sharded
from pbf_sph_tpu_torch.parallel.comm import (
    all_gather_cat,
    all_gather_fixed,
    run_ranks,
)

REPO = Path(__file__).resolve().parent.parent
WAIT = 120.0
# a spawned process's bound: it imports torch afresh, which the tier's
# parallel workers slow the most
PROC_WAIT = 240.0
SOA_FIELDS = ("pid", "ptype", "mass", "position", "velocity", "colour")
STATE_FIELDS = SOA_FIELDS + ("alive",)
# tests/test_sharded.py:63-77: sharded against single-chip
SINGLE_TOLS = dict(position=0.1, velocity=0.1, colour=2e-3)
# tests/test_torch_step.py: the port against the JAX package
JAX_TOLS = dict(position=1e-3, velocity=1e-3, colour=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the tier runs several test
    processes at once, and a ThreadComm run adds a thread a rank."""
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


def _slabs(spec, cfg, frames, states, bounds=None, motion=False, scn=None):
    """`frames` frames of the slab engine from the ranks' `states` on
    ThreadComm ranks on the CPU.  Returns (final states, assembled stats a
    frame, bounds a frame, each rank's last-frame stats)."""

    def rank(comm):
        state = states[comm.rank]
        step = sharded.build_sharded_step(spec, comm)
        b, out = bounds, []
        for f in range(frames):
            dyn = dyn_params_of(apply_motion_sin_x_cos_z(cfg, f) if motion else cfg,
                                np.float32, "cpu")
            if spec.rebalance:
                state, s, b = step(state, dyn, scn, bounds=b)
                out.append((s, b.numpy().copy()))
            else:
                state, s = step(state, dyn, scn)
                out.append((s, None))
        return state, out

    ranks = run_ranks(spec.n_dev, rank, "cpu", timeout=WAIT)
    stats = [sharded.assemble_stats([r[1][f][0] for r in ranks]) for f in range(frames)]
    return ([r[0] for r in ranks], stats, [ranks[0][1][f][1] for f in range(frames)],
            [r[1][-1][0] for r in ranks])


def _distributed(spec, xs, bounds=None):
    whole = sharded.distribute_particles(xs, spec, bounds=bounds)
    return [sharded.local_state(whole, r, spec, "cpu") for r in range(spec.n_dev)]


def _single(cfg, xs, frames, gather=False, motion=False, scene=None):
    solver = TorchSolver(h=cfg.h, device="cpu", gather=gather)
    res = None
    for f in range(frames):
        c = apply_motion_sin_x_cos_z(cfg, f) if motion else cfg
        res, xs = solver.advance(c, scene or ttypes.Scene(), xs)
    return res, xs


# ---------------------------------------------------------------------------
# Spec, sizing and host-side placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total", [0, 1, 97, 1_000_003, 2_000_000_000, 2_147_483_647])
def test_equal_count_target_exact(total):
    # the product total * d wraps int32 past ~2^31 / n; the decomposition
    # must hold exact to the int32 ceiling (tests/test_sharded.py:47-60)
    for n in (2, 8, 128):
        for d in (1, n // 2, n - 1):
            want = (total * d) // n
            assert sharded._equal_count_target(total, d, n) == want
            got = sharded._equal_count_target(torch.tensor(total, dtype=torch.int32), d, n)
            assert got.dtype == torch.int32 and int(got) == want, (total, d, n)


def _spec_pair(rebalance, surface, gather):
    from pbf_sph_tpu.parallel import sharded as jsh

    mc, cfg, xs = dam_break(1200, solver_iter=2, surface=surface)
    kw = dict(rebalance=rebalance, cap_local=len(xs) if rebalance else 0)
    jspec = jsh.ShardSpec.create(cfg, 4, len(xs), cfg.h, use_pallas=not gather, **kw)
    tspec = sharded.ShardSpec.create(cfg, 4, len(xs), cfg.h, gather=gather, **kw)
    return jspec, tspec, cfg, xs


@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("surface", [False, True])
@pytest.mark.parametrize("rebalance", [False, True])
def test_shard_spec_matches_jax(rebalance, surface, gather):
    from pbf_sph_tpu.parallel import sharded as jsh

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
    assert (tspec.max_slab_w, tspec.cap_total) == (jspec.max_slab_w, jspec.cap_total)
    np.testing.assert_array_equal(tspec.uniform_bounds(), jspec.uniform_bounds())
    b0 = jspec.initial_bounds(xs)
    np.testing.assert_array_equal(tspec.initial_bounds(_to_port(xs)), b0)
    want = jsh.distribute_particles(xs, jspec, bounds=b0)
    got = sharded.distribute_particles(_to_port(xs), tspec, bounds=b0)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    back = sharded_state_to_numpy([sharded.local_state(got, r, tspec, "cpu") for r in range(4)])
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(want, f)), f)


def test_distribute_refuses_a_full_slab():
    from pbf_sph_tpu.parallel import sharded as jsh

    mc, cfg, xs = jax_dam_break(1200, solver_iter=2)
    jspec = jsh.ShardSpec.create(cfg, 4, len(xs), cfg.h, cap_local=256)
    tspec = sharded.ShardSpec.create(cfg, 4, len(xs), cfg.h, cap_local=256)
    with pytest.raises(ValueError) as want:
        jsh.distribute_particles(xs, jspec)
    with pytest.raises(ValueError) as got:
        sharded.distribute_particles(_to_port(xs), tspec)
    assert str(got.value) == str(want.value)


def test_apply_sources_accept_and_slot_limit_match_jax():
    import jax
    import jax.numpy as jnp

    from pbf_sph_tpu.models import jax_solver as js
    from pbf_sph_tpu_torch.models import torch_solver as ts

    mc, cfg, xs = dam_break(1200, solver_iter=2)
    sub = ttypes.ParticleSoA(*(getattr(xs, f)[:40] for f in SOA_FIELDS))
    src = dict(tag=77, centre=(300.0, 500.0, 300.0), velocity=(0.0, -1.0, 0.0),
               colour=(1.0, 0.0, 0.0, 1.0), rate=30.0)
    jscene = jtypes.Scene(sources=[jtypes.Source(**src)])
    tscene = ttypes.Scene(sources=[ttypes.Source(**src)])
    jspec = js.JaxSolver(h=cfg.h).make_spec(cfg, jscene, 64)
    tspec = TorchSolver(h=cfg.h, device="cpu").make_spec(cfg, tscene, 64)
    alive = np.ones(64, bool)
    alive[40:] = False
    alive[[3, 7, 50]] = [False, False, True]
    jstate = jtypes.FluidState.from_soa(sub, 64, np.float32)
    jstate = jtypes.FluidState(**{f: jnp.asarray(alive if f == "alive" else getattr(jstate, f))
                                  for f in STATE_FIELDS})
    tstate = dataclasses.replace(ttypes.FluidState.from_soa(sub, 64, np.float32, "cpu"),
                                 alive=torch.from_numpy(alive))
    jscn = js.scene_arrays_of(jscene, jspec.scene, np.float32)
    tscn = scene_arrays_of(tscene, tspec.scene, np.float32, "cpu")
    x_cut = 290.0  # a source of 5 x 6 spawns either side of it
    jout, jdrop = jax.jit(lambda st, sc: js._apply_sources(
        st, sc, jspec, jnp.float32, accept=lambda p: p[0] < x_cut, slot_limit=56))(jstate, jscn)
    tout, tdrop = ts._apply_sources(tstate, tscn, tspec,
                                    accept=lambda p: p[0] < x_cut, slot_limit=56)
    assert 0 < int(tdrop) == int(jdrop) < 30
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)), f)
    assert not tout.alive[56:].any()  # no slot past the limit spawns


# ---------------------------------------------------------------------------
# The slice against the JAX package
# ---------------------------------------------------------------------------


# the JAX comparison's cell capacity: the gather path's K, twice the
# dam's largest cell (8), so that no cell is truncated, at a third of the
# default's gathers
JAX_K = 16


def _shifted_bounds(spec, xs):
    """A valid partition one column right of the equal-count one."""
    b = spec.initial_bounds(xs).copy()
    b[1:-1] += 1
    w = np.diff(b)
    assert (w >= spec.min_slab_w).all() and (w <= spec.max_slab_w).all(), b
    return b


@functools.lru_cache(maxsize=None)
def _jax_slabs(rebalance: bool):
    """The JAX sharded step at D=4 on dam_break(1200, 2), 2 frames: (initial
    global state as numpy, initial bounds, stats a frame, bounds a frame,
    final alive particles)."""
    import jax
    from jax.sharding import Mesh

    from pbf_sph_tpu.models.jax_solver import dyn_params_of as jdyn
    from pbf_sph_tpu.parallel import sharded as jsh

    mc, cfg, xs = jax_dam_break(1200, solver_iter=2)
    spec = jsh.ShardSpec.create(cfg, 4, len(xs), cfg.h, rebalance=rebalance,
                                cap_local=len(xs) if rebalance else 0, cell_capacity=JAX_K)
    b0 = _shifted_bounds(spec, xs) if rebalance else spec.uniform_bounds()
    whole = jsh.distribute_particles(xs, spec, bounds=b0)
    first = {f: np.asarray(getattr(whole, f)) for f in STATE_FIELDS}
    mesh = Mesh(np.array(jax.devices()[:4]), (jsh.AXIS,))
    state = jsh.shard_state(whole, mesh)
    step = jsh.build_sharded_step(spec, mesh)
    stats, bounds, b = [], [], b0
    with mesh:
        for f in range(2):
            dyn = jdyn(cfg, np.float32)
            if rebalance:
                state, s, b = step(state, dyn, bounds=b)
                bounds.append(np.asarray(b))
            else:
                state, s = step(state, dyn)
            stats.append({k: np.asarray(v) for k, v in s.items()})
    return first, b0, stats, bounds, state.to_soa()


@pytest.mark.parametrize("gather", [True, False], ids=["gather", "kernels"])
@pytest.mark.parametrize("rebalance", [False, pytest.param(True, marks=pytest.mark.slow)],
                         ids=["fixed", "rebalance"])
def test_slabs_match_jax(rebalance, gather):
    first, b0, jstats, jbounds, jfinal = _jax_slabs(rebalance)
    mc, cfg, xs = dam_break(1200, solver_iter=2)
    spec = sharded.ShardSpec.create(cfg, 4, len(xs), cfg.h, gather=gather, rebalance=rebalance,
                                    cap_local=len(xs) if rebalance else 0, cell_capacity=JAX_K)
    if gather:  # the JAX distribution itself, carried over
        states = sharded_state_from_numpy(first, 4, "cpu")
    else:  # the kernel backend's capacity is padded: the same owner rule
        states = _distributed(spec, xs, b0)
    start = [int(s.alive.sum()) for s in states]
    final, stats, bounds, _ = _slabs(spec, cfg, 2, states, bounds=b0)
    for f in range(2):
        assert sorted(stats[f]) == sorted(jstats[f])
        for k, v in jstats[f].items():
            np.testing.assert_array_equal(stats[f][k], v, err_msg=f"frame {f}: {k}")
        if rebalance:
            np.testing.assert_array_equal(bounds[f], jbounds[f], err_msg=f"frame {f}: bounds")
    # the traffic the comparison depends on
    assert max(int(s["ghost_peak"].max()) for s in stats) > 0
    if rebalance:
        assert not np.array_equal(bounds[0], b0)
        assert stats[-1]["alive_count"].tolist() != start, start
    _close(sharded.gather_soa(final), _to_port(jfinal), JAX_TOLS)


# ---------------------------------------------------------------------------
# Against the port's single chip
# ---------------------------------------------------------------------------


def test_scene_dynamics_match_single():
    """A well, a source, a drain and a query at D=4 (tests/test_sharded.py:
    80-126): spawn only on the owning rank, queries merged over the ranks."""
    mc, cfg, xs = dam_break(1200, solver_iter=3)
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
    spec = sharded.ShardSpec.create(cfg, 4, len(xs), cfg.h, scene=scene, gather=False)
    scn = scene_arrays_of(scene, spec.scene, np.float32, "cpu")
    final, stats, _, _ = _slabs(spec, cfg, 2, _distributed(spec, xs), scn=scn)
    res, single = _single(cfg, xs, 2, scene=scene)
    assert stats[-1]["migrate_dropped"].sum() == 0 and stats[-1]["spawn_dropped"].sum() == 0
    got = sharded.gather_soa(final)
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
    mc, cfg, xs = dam_break(1500, solver_iter=2)
    spec = sharded.ShardSpec.create(cfg, 4, len(xs), cfg.h, gather=False)
    final, stats, _, _ = _slabs(spec, cfg, 4, _distributed(spec, xs), motion=True)
    assert all(int(s["alive_count"].sum()) == len(xs) for s in stats)
    np.testing.assert_array_equal(np.sort(sharded.gather_soa(final).pid), np.sort(xs.pid))


def test_migrate_deferral_recovers():
    """Emigrants beyond migrate_cap stay alive, deferred, and the backlog
    drains at migrate_cap a frame (tests/test_sharded.py:283-336)."""
    mc, cfg, particles = dam_break(1200, solver_iter=2)
    spec = sharded.ShardSpec.create(cfg, 2, len(particles), cfg.h, cap_local=len(particles),
                                    gather=False)
    spec = dataclasses.replace(spec, migrate_cap=256)
    # every particle half a column left of the slab boundary, moving +x by
    # ~2 columns a frame
    h, scale = cfg.h, float(cfg.scale)
    min_ext_x = float(np.asarray(cfg.min_bound, np.float32)[0]) / scale - h * 2
    pos = particles.position.copy()
    pos[:, 0] = (min_ext_x + (spec.slab_w - 0.5) * h) * scale + np.linspace(
        0, h * scale * 0.2, len(pos))
    vel = particles.velocity.copy()
    vel[:, 0] = 2.0 * h / float(np.float32(cfg.dt))
    xs = ttypes.ParticleSoA(particles.pid, particles.ptype, particles.mass, pos, vel,
                            particles.colour)
    states, stats, _, _ = _slabs(spec, cfg, 6, _distributed(spec, xs))
    deferred = [int(s["migrate_deferred"].sum()) for s in stats]
    assert all(int(s["migrate_dropped"].sum()) == 0 for s in stats)
    assert deferred[0] > 0, "the deferral path was not exercised"
    assert deferred[-1] == 0, f"backlog never drained: {deferred}"
    assert all(b - a >= 0 for a, b in zip(deferred[1:], deferred[:-1])), deferred
    out = sharded.gather_soa(states)
    np.testing.assert_array_equal(np.sort(out.pid), np.sort(xs.pid))
    assert np.isfinite(out.position).all() and np.isfinite(out.velocity).all()


@pytest.mark.parametrize("rebalance", [False, True], ids=["fixed", "rebalance"])
def test_surface_matches_single(rebalance):
    """The slabs' marching cubes (the XLA field over the local nodes with
    the node and cell offsets, cubes owned below the next slab's first node)
    concatenate to the single-chip triangle soup (tests/test_sharded.py:
    147-210,339-401)."""
    mc, cfg, xs = simple_config_with_2_cubes(1500, 2, 500.0)
    cfg = cfg.replace(surface=dataclasses.replace(mc, resolution=1.0))
    frames = 1
    spec = sharded.ShardSpec.create(cfg, 2, len(xs), cfg.h, rebalance=rebalance,
                                    cap_local=len(xs) if rebalance else 0)
    b0 = spec.initial_bounds(xs)
    if rebalance:  # the dynamic node offsets are exercised
        assert not np.array_equal(b0, spec.uniform_bounds())
    _, stats, _, last = _slabs(spec, cfg, frames, _distributed(spec, xs, b0), bounds=b0,
                               motion=rebalance)
    res, _ = _single(cfg, xs, frames, gather=True, motion=rebalance)
    t_ref = len(res.mesh) // 3
    assert t_ref > 0
    for k in ("migrate_dropped", "ghost_dropped", "mc_emit_overflow"):
        assert int(stats[-1][k].sum()) == 0, k
    assert int(stats[-1]["tri_count"].sum()) == t_ref
    vs, ns, cs = sharded.gather_mesh(last)
    assert len(vs) == len(ns) == len(cs) == 3 * t_ref

    def canon(a):
        r = np.round(a.reshape(-1, 9), 3)
        return r[np.lexsort(r.T[::-1])]

    np.testing.assert_allclose(canon(vs), canon(res.mesh.vs), atol=2e-2, rtol=0)


def test_rebalance_matches_single():
    mc, cfg, xs = dam_break(1200, solver_iter=3)
    spec = sharded.ShardSpec.create(cfg, 4, len(xs), cfg.h, rebalance=True,
                                    cap_local=len(xs), gather=False)
    b0 = _shifted_bounds(spec, xs)
    states = _distributed(spec, xs, b0)
    start = [int(s.alive.sum()) for s in states]
    final, stats, bounds, _ = _slabs(spec, cfg, 2, states, bounds=b0, motion=True)
    assert sum(int(s[k].sum()) for s in stats
               for k in ("migrate_dropped", "migrate_deferred", "ghost_dropped")) == 0
    assert not np.array_equal(bounds[0], b0)  # the boundaries moved
    assert stats[-1]["alive_count"].tolist() != start  # and ownership with them
    assert np.all(np.diff(bounds[-1]) >= spec.min_slab_w)
    _, single = _single(cfg, xs, 2, motion=True)
    _close(sharded.gather_soa(final), single, SINGLE_TOLS)


def _rebalance_d2():
    """One frame of the rebalance scene at D=2 (the sloshing bounds' frame
    0, which moves the z walls)."""
    mc, cfg, xs = dam_break(1200, solver_iter=2)
    spec = sharded.ShardSpec.create(cfg, 2, len(xs), cfg.h, rebalance=True,
                                    cap_local=len(xs), gather=False)
    b0 = spec.initial_bounds(xs)
    return _slabs(spec, cfg, 1, _distributed(spec, xs, b0), bounds=b0, motion=True)


@functools.lru_cache(maxsize=None)
def _rebalance_d2_run():
    return _rebalance_d2()


def test_thread_ranks_repeat_bit_for_bit():
    first, again = _rebalance_d2_run(), _rebalance_d2()
    assert int(first[1][0]["ghost_peak"].max()) > 0
    for a, b in zip(first[0], again[0]):
        for f in STATE_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    np.testing.assert_array_equal(first[2][0], again[2][0])
    for a, b in zip(first[3], again[3]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# The transport
# ---------------------------------------------------------------------------


def test_thread_comm_exchange_sum_and_gathers():
    def rank(comm):
        r = comm.rank
        payload = lambda side: dict(  # noqa: E731
            v=torch.full((2, 3), 10.0 * r + side), i=torch.tensor([r, side], dtype=torch.int32),
            valid=torch.ones(3, dtype=torch.bool))
        from_l, from_r = comm.exchange(payload(0), payload(1))
        total = comm.all_reduce_sum(torch.tensor([r + 1.0, 2.0 ** -r]))
        odd = torch.tensor([float("nan"), -0.0, r + 0.5])[: r + 1]
        cat = all_gather_cat(comm, odd)
        fixed = all_gather_fixed(comm, torch.tensor([-0.0, float(r)]))
        with pytest.raises(ValueError, match="one device"):
            comm.all_reduce_sum(torch.zeros(1, device="meta"))
        return from_l, from_r, total, cat, fixed

    out = run_ranks(3, rank, "cpu", timeout=WAIT)
    for r, (from_l, from_r, total, cat, fixed) in enumerate(out):
        if r == 0:  # no left neighbour: zeros of the same shapes, valid False
            assert not from_l["valid"].any() and not from_l["v"].any()
            assert from_l["i"].dtype == torch.int32 and from_l["i"].shape == (2,)
        else:  # the left neighbour's to_right
            assert torch.equal(from_l["v"], torch.full((2, 3), 10.0 * (r - 1) + 1))
            assert from_l["i"].tolist() == [r - 1, 1] and from_l["valid"].all()
        if r == 2:
            assert not from_r["valid"].any() and not from_r["v"].any()
        else:
            assert torch.equal(from_r["v"], torch.full((2, 3), 10.0 * (r + 1)))
        assert total.tolist() == [6.0, 1.0 + 0.5 + 0.25]
        bits = cat.view(torch.int32)
        want = torch.cat([torch.tensor([float("nan"), -0.0, q + 0.5])[: q + 1]
                          for q in range(3)])
        assert torch.equal(bits, want.view(torch.int32))  # NaN and -0.0 kept
        assert torch.equal(fixed.view(torch.int32),
                           torch.tensor([[-0.0, q] for q in (0.0, 1.0, 2.0)]).view(torch.int32))


def test_thread_comm_stress():
    """More ranks than cores and a short switch interval: every exchange
    brings each rank its neighbours' values of that round, and every sum
    the same total on every rank (a lost or stale slot would break both)."""
    n, rounds = 2 * (os.cpu_count() or 1) + 3, 12

    def rank(comm):
        r, bad = comm.rank, 0
        for k in range(rounds):
            from_l, from_r = comm.exchange({"v": torch.tensor([r, k, 0])},
                                           {"v": torch.tensor([r, k, 1])})
            want_l = [r - 1, k, 1] if r > 0 else [0, 0, 0]
            want_r = [r + 1, k, 0] if r + 1 < n else [0, 0, 0]
            bad += from_l["v"].tolist() != want_l or from_r["v"].tolist() != want_r
            bad += int(comm.all_reduce_sum(torch.tensor([r + k]))) != n * (n - 1) // 2 + n * k
        return bad

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t0 = time.monotonic()
        assert run_ranks(n, rank, "cpu", timeout=WAIT) == [0] * n
        assert time.monotonic() - t0 < WAIT
    finally:
        sys.setswitchinterval(old)


def test_failing_rank_fails_the_call():
    def rank(comm):
        if comm.rank == 1:
            raise RuntimeError("rank 1 broke")
        comm.exchange({"v": torch.zeros(2)}, {"v": torch.zeros(2)})
        return comm.rank

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 broke") as e:
        run_ranks(3, rank, "cpu", timeout=WAIT)
    assert time.monotonic() - t0 < 30.0
    assert any("rank 1 of 3" in note for note in getattr(e.value, "__notes__", []))
    assert not [t.name for t in threading.enumerate() if t.name.startswith("rank ")]


DIST_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from pbf_sph_tpu_torch.core.configs import dam_break
    from pbf_sph_tpu_torch.core.scene import apply_motion_sin_x_cos_z
    from pbf_sph_tpu_torch.models.torch_solver import dyn_params_of
    from pbf_sph_tpu_torch.parallel import sharded
    from pbf_sph_tpu_torch.parallel.comm import DistComm, MeshAxis
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    mc, cfg, xs = dam_break(1200, solver_iter=2)
    spec = sharded.ShardSpec.create(cfg, 2, len(xs), cfg.h, rebalance=True,
                                    cap_local=len(xs), gather=False)
    b0 = spec.initial_bounds(xs)
    state = sharded.local_state(sharded.distribute_particles(xs, spec, bounds=b0), rank,
                                spec, "cpu")
    comm = DistComm("cpu")
    step = sharded.build_sharded_step(spec, comm)
    state, stats, b = step(state, dyn_params_of(apply_motion_sin_x_cos_z(cfg, 0),
                                                np.float32, "cpu"), bounds=b0)
    # the tile engine's mesh axes over the same group: 2x1 and 1x2
    axes = {}
    for shape in ((2, 1), (1, 2)):
        for a in range(2):
            lo, hi = MeshAxis(comm, shape, a).exchange(
                {"v": torch.tensor([rank, 0, a]), "valid": torch.ones(2, dtype=torch.bool)},
                {"v": torch.tensor([rank, 1, a]), "valid": torch.ones(2, dtype=torch.bool)})
            for side, got in (("lo", lo), ("hi", hi)):
                for k, v in got.items():
                    axes[f"axis_{shape[0]}x{shape[1]}_{a}_{side}_{k}"] = v.numpy()
    np.savez(out, bounds=b.numpy(), **{k: getattr(state, k).numpy() for k in
             ("pid", "ptype", "mass", "position", "velocity", "colour", "alive")},
             **{"stat_" + k: v.numpy() for k, v in stats.items()}, **axes)
    dist.destroy_process_group()
""")


def test_dist_comm_over_gloo_matches_thread_comm(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", DIST_RANK, str(r), str(tmp_path / "store"),
                               str(tmp_path / f"rank{r}.npz")], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROC_WAIT)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs

    final, stats, bounds, last = _rebalance_d2_run()
    assert int(stats[0]["ghost_peak"].max()) > 0  # boundary traffic went over the wire
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_array_equal(got["bounds"], bounds[0])
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(got[f], getattr(final[r], f).numpy(), f)
        for k, v in last[r].items():
            np.testing.assert_array_equal(got["stat_" + k], v.numpy(), k)
        # MeshAxis over DistComm: rank-tagged payloads along the axis of
        # size 2, zeros along the axis of size 1
        for shape in ((2, 1), (1, 2)):
            for a in range(2):
                pre = f"axis_{shape[0]}x{shape[1]}_{a}_"
                paired = shape[a] == 2
                want_lo = [r - 1, 1, a] if paired and r == 1 else [0, 0, 0]
                want_hi = [r + 1, 0, a] if paired and r == 0 else [0, 0, 0]
                assert got[pre + "lo_v"].tolist() == want_lo, (pre, r)
                assert got[pre + "hi_v"].tolist() == want_hi, (pre, r)
                assert got[pre + "lo_valid"].all() == (want_lo != [0, 0, 0])
                assert got[pre + "hi_valid"].all() == (want_hi != [0, 0, 0])


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


CLI_RUNS = {
    # the 2-cube benchmark scene with its surface: the gathered mesh
    "fixed": ["--impl", "gather", "--warmup", "0"],
    # a 700-particle dam break (no surface) through the kernel backend's
    # plain versions, with a snapshot after frame 1
    "rebalance": ["--rebalance", "--workload", "dam1m", "--warmup", "1",
                  "--ckpt-every", "1"],
}


@pytest.mark.parametrize("run", sorted(CLI_RUNS))
def test_cli_multichip_on_cpu(tmp_path, run):
    out = tmp_path / "m"
    argv = ["--devices", "cpu", "--multichip", "2", *CLI_RUNS[run], "--count", "700",
            "--iter", "1", "--output", str(out)]
    res = subprocess.run([sys.executable, "-m", "pbf_sph_tpu_torch.cli", *argv], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=PROC_WAIT)
    assert res.returncode == 0, res.stdout + res.stderr
    n = len((simple_config_with_2_cubes(700, 6, 500.0) if run == "fixed"
             else dam_break(700))[2])
    lines = {line.split(":")[0].strip(): line.split(":", 1)[1].strip()
             for line in res.stdout.splitlines() if " : " in line}
    assert int(lines["Final Particle count"]) == n
    counts = [int(v) for v in lines["Per-device particles"].strip("[]").split(",")]
    assert len(counts) == 2 and sum(counts) == n
    ply = (out / "cloud.ply").read_text().splitlines()
    assert f"element vertex {n}" in ply
    verts = sum(1 for line in (out / "mesh.obj").read_text().splitlines()
                if line.startswith("v "))
    assert verts == int(lines["Final Vertex count"]) and (verts > 0) == (run == "fixed")


@pytest.mark.parametrize("argv, message", [
    (["--multichip", "2x2"], "needs 4 CUDA devices"),
    (["--multichip", "2x0", "--devices", "cpu"], "NXxNY with NX, NY >= 1"),
    (["--multichip", "2"], "needs 2 CUDA devices"),
    (["--multichip", "0", "--devices", "cpu"], "N >= 1"),
    (["--multichip", "2", "--devices", "cpu", "--fp64", "--impl", "gather"], "fp32-only"),
])
def test_cli_multichip_refusals(monkeypatch, capsys, argv, message):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([*argv, "--count", "700", "--iter", "1", "--warmup", "0"]) != 0
    assert message in capsys.readouterr().err
