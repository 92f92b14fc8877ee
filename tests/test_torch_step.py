"""The port's frame against the JAX package's XLA frame, on CPU.

`TorchSolver(device="cpu")` runs the plain PyTorch versions of its kernels;
`JaxSolver(use_pallas=False)` is the reference.  Tolerances follow
`test_pallas_interpret.py`: position and velocity atol 1e-3, colour 1e-5
(the port's phases use the Pallas kernels' rsqrt form of the spiky
gradient, the XLA path a sqrt form).  Integers (alive mask, ids, query ids)
must match exactly.
"""

import dataclasses

import numpy as np
import pytest

import pbf_sph_tpu.core.types as jtypes
from pbf_sph_tpu.core.configs import dam_break as jax_dam_break
from pbf_sph_tpu.core.scene import simple_config_with_2_cubes as jax_2cubes
from pbf_sph_tpu.models.growth import growth_changes as jax_growth_changes
from pbf_sph_tpu.models.jax_solver import JaxSolver, dyn_params_of as jax_dyn
from pbf_sph_tpu_torch.convert import (
    dyn_from_numpy,
    scene_arrays_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from pbf_sph_tpu_torch.core import types as ttypes
from pbf_sph_tpu_torch.models.growth import growth_changes
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver

WORKLOADS = {
    "2cubes700": lambda: jax_2cubes(700, 2, 500.0),
    "dam4096": lambda: jax_dam_break(4096, solver_iter=2),
}


def _close(a, b, pos_atol=1e-3):
    a, b = a.order_by_id(), b.order_by_id()
    np.testing.assert_array_equal(a.pid, b.pid)
    np.testing.assert_array_equal(a.ptype, b.ptype)
    np.testing.assert_allclose(a.position, b.position, atol=pos_atol, rtol=0)
    np.testing.assert_allclose(a.velocity, b.velocity, atol=1e-3, rtol=0)
    np.testing.assert_allclose(a.colour, b.colour, atol=1e-5, rtol=0)


def _to_port(soa):
    """The JAX package's host ParticleSoA -> the port's (same arrays)."""
    return ttypes.ParticleSoA(**{f.name: getattr(soa, f.name)
                                 for f in dataclasses.fields(soa)})


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_advance_matches_jax(name):
    mc, cfg, xs = WORKLOADS[name]()
    _, want = JaxSolver(h=cfg.h).advance(cfg, jtypes.Scene(), xs)
    _, got = TorchSolver(h=cfg.h, device="cpu").advance(cfg, ttypes.Scene(), _to_port(xs))
    assert len(got) == len(xs)
    _close(got, want)


def test_three_chained_step_device_frames():
    # the dam break starts at rest density; the over-compressed 2-cube scene
    # amplifies the sqrt/rsqrt difference ~2.6x a frame (8e-3 by frame 4),
    # the dam break's difference stays at a few ulps of the world coords
    mc, cfg, xs = jax_dam_break(4096, solver_iter=2)
    js = JaxSolver(h=cfg.h)
    jspec, jstate, jscn = js.prepare(cfg, jtypes.Scene(), xs)
    jdyn = jax_dyn(cfg, js.dtype)

    ts = TorchSolver(h=cfg.h, device="cpu")
    tspec = ts.make_spec(cfg, ttypes.Scene(), jspec.capacity)
    tstate = state_from_numpy(
        {k: np.asarray(getattr(jstate, k)) for k in
         ("pid", "ptype", "mass", "position", "velocity", "colour", "alive")}, "cpu")
    tdyn = dyn_from_numpy(jdyn, "cpu")
    tscn = scene_arrays_from_numpy({k: np.asarray(v) for k, v in jscn.items()}, "cpu")

    for _ in range(3):
        jstate, jout = js.step_device(jspec, jstate, jdyn, jscn)
        tstate, tout = ts.step_device(tspec, tstate, tdyn, tscn)
        assert int(tout["alive_count"]) == int(jout["alive_count"]) == len(xs)
        assert int(tout["max_occupancy"]) == int(jout["max_occupancy"])
        assert bool(tout["extent_ok"])
    assert tstate.capacity == jstate.capacity
    d = state_to_numpy(tstate)
    # the stable sort keeps both packages' rows in the same order
    np.testing.assert_array_equal(d["pid"], np.asarray(jstate.pid))
    np.testing.assert_array_equal(d["alive"], np.asarray(jstate.alive))
    _close(tstate.to_soa(), _to_port(jstate.to_soa()))


def _busy_scene(cfg, xs):
    """One well, one source, one drain and one query, in both packages."""
    probe = [float(v) for v in xs.position[len(xs) // 4]]
    kw = dict(
        wells=[("Well", dict(tag=1, centre=(160.0, 150.0, 160.0), force=4000.0))],
        sources=[("Source", dict(tag=9000, centre=(500.0, 700.0, 500.0),
                                 velocity=(0.0, -5.0, 0.0),
                                 colour=(1.0, 0.2, 0.2, 1.0), rate=16.0))],
        drains=[("Drain", dict(tag=2, centre=(620.0, 40.0, 620.0), width=60.0))],
        queries=[("Query", dict(id=7, point=tuple(probe)))],
    )

    def build(mod):
        return mod.Scene(**{k: [getattr(mod, c)(**a) for c, a in v] for k, v in kw.items()})

    return build(jtypes), build(ttypes)


def test_scene_with_well_source_drain_query():
    mc, cfg, xs = jax_2cubes(700, 2, 500.0)
    jscene, tscene = _busy_scene(cfg, xs)
    jres, want = JaxSolver(h=cfg.h).advance(cfg, jscene, xs)
    tres, got = TorchSolver(h=cfg.h, device="cpu").advance(cfg, tscene, _to_port(xs))

    # the drain removed particles and the source added 16 (all with pid 9000)
    assert len(got) == len(want)
    assert len(want) != len(xs)
    assert (want.pid == 9000).sum() == 16
    np.testing.assert_array_equal(np.sort(got.pid), np.sort(want.pid))
    _close(got, want)

    assert [q.id for q in tres.queries] == [q.id for q in jres.queries] == [7]
    tq, jq = tres.queries[0].neighbours, jres.queries[0].neighbours
    assert len(jq) > 0
    np.testing.assert_array_equal(np.sort(tq), np.sort(jq))


GROWTH_OUTS = {
    "held": dict(max_occupancy=12, query_overflow=0),
    "occupancy": dict(max_occupancy=49, query_overflow=0),
    "query": dict(max_occupancy=30, query_overflow=5),
    "both": dict(max_occupancy=200, query_overflow=300),
}


@pytest.mark.parametrize("case", sorted(GROWTH_OUTS))
def test_growth_changes_match_jax(case):
    mc, cfg, xs = jax_2cubes(700, 2, 500.0)
    jspec = JaxSolver(h=cfg.h).make_spec(cfg, jtypes.Scene(), 1024)
    tspec = TorchSolver(h=cfg.h, device="cpu").make_spec(cfg, ttypes.Scene(), 1024)
    out = dict(GROWTH_OUTS[case])
    want = jax_growth_changes(jspec, dict(out, strip_overflow=0))
    got = growth_changes(tspec, out)
    assert sorted(got) == sorted(want)
    if "cell_capacity" in want:
        assert got["cell_capacity"] == want["cell_capacity"]
    if "scene" in want:
        assert got["scene"].query_capacity == want["scene"].query_capacity
    assert (case == "held") == (got == {})
