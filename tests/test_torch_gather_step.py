"""The gather backend's frame against the JAX package's XLA frame, on CPU.

`TorchSolver(gather=True, device="cpu").advance` runs the K-capped gathers
of `ops/pbf.py` and the XLA field of `ops/mc.py` on plain torch ops;
`JaxSolver(use_pallas=False).advance` is the reference.  Both use the sqrt
form of the spiky gradient, so the float32 frames agree far inside the
tolerances of `test_torch_step.py`: position and velocity atol 1e-3, colour
1e-5, the alive mask and ids exact, triangle counts within 1%.  One float64
frame (JAX's x64 on for the test alone): position and velocity atol 1e-7,
colour 1e-9, the triangle count exact.

The float32 JAX programs are the ones `test_torch_step.py` (2cubes700) and
`test_torch_surface.py` (dam4096 with its surface) compile, so the
persistent compile cache serves them; the float64 2cubes700 frame with its
surface is the one program this file adds.
"""

import jax
import numpy as np
import pytest
import torch

import pbf_sph_tpu.core.types as jtypes
from pbf_sph_tpu.core.configs import dam_break as jax_dam_break
from pbf_sph_tpu.core.scene import simple_config_with_2_cubes as jax_2cubes
from pbf_sph_tpu.models.jax_solver import JaxSolver
from pbf_sph_tpu_torch.core import types as ttypes
from pbf_sph_tpu_torch.models import make_solver
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver
from test_torch_step import _to_port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests: their eager torch ops
    are many and small, and the tier runs several test processes at once,
    where a pool of a thread a core each oversubscribes the cores and made
    these tests ~10-25x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_surface(tup):
    mc, cfg, xs = tup
    return mc, cfg.replace(surface=mc), xs


WORKLOADS = {
    "2cubes700": lambda: jax_2cubes(700, 2, 500.0),
    "dam4096-surface": lambda: jax_dam_break(4096, solver_iter=2, surface=True),
}


def _diffs(got, want):
    """Largest |port - JAX| of each float field, with the ids checked."""
    a, b = got.order_by_id(), want.order_by_id()
    np.testing.assert_array_equal(a.pid, b.pid)
    np.testing.assert_array_equal(a.ptype, b.ptype)
    assert a.position.dtype == b.position.dtype
    return {k: float(np.abs(getattr(a, k) - getattr(b, k)).max())
            for k in ("position", "velocity", "colour")}


def _triangles(res):
    assert len(res.mesh) % 3 == 0
    return len(res.mesh) // 3


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_gather_advance_matches_jax(name):
    mc, cfg, xs = WORKLOADS[name]()
    jres, want = JaxSolver(h=cfg.h).advance(cfg, jtypes.Scene(), xs)
    solver = TorchSolver(h=cfg.h, gather=True, device="cpu")
    tres, got = solver.advance(cfg, ttypes.Scene(), _to_port(xs))
    assert len(got) == len(want) == len(xs)
    d = _diffs(got, want)
    print(f"{name} float32 largest differences: {d}")
    assert d["position"] <= 1e-3 and d["velocity"] <= 1e-3 and d["colour"] <= 1e-5
    assert all(v == 0 for v in solver.launches.values())
    if cfg.surface is not None:
        tj, tt = _triangles(jres), _triangles(tres)
        print(f"{name} triangles: JAX {tj}, port {tt}")
        assert tj > 0 and abs(tt - tj) <= 0.01 * tj


def test_gather_advance_matches_jax_fp64():
    mc, cfg, xs = _with_surface(jax_2cubes(700, 2, 500.0))
    with jax.enable_x64(True):
        jres, want = JaxSolver(h=cfg.h, dtype="float64").advance(cfg, jtypes.Scene(), xs)
    tres, got = TorchSolver(h=cfg.h, dtype="float64", gather=True, device="cpu").advance(
        cfg, ttypes.Scene(), _to_port(xs))
    assert got.position.dtype == np.float64
    d = _diffs(got, want)
    tj, tt = _triangles(jres), _triangles(tres)
    print(f"2cubes700 float64 largest differences: {d}; triangles: JAX {tj}, port {tt}")
    assert d["position"] <= 1e-7 and d["velocity"] <= 1e-7 and d["colour"] <= 1e-9
    assert tj > 0 and tt == tj


def test_torch_backend_refuses_fp64():
    for make in (lambda: TorchSolver(dtype="float64", device="cpu"),
                 lambda: make_solver("torch", dtype="float64", device="cpu")):
        with pytest.raises(ValueError, match="FP64 is not supported for the torch backend"):
            make()
    assert make_solver("gather", dtype="float64", device="cpu").dtype == np.float64


def test_gather_growth_reruns_truncated_frame():
    """A frame whose occupancy exceeds K is re-run under the grown K, and
    gives what a solver built with that K gives."""
    mc, cfg, xs = jax_dam_break(4096, solver_iter=2)
    xs = _to_port(xs)
    solver = TorchSolver(h=cfg.h, cell_capacity=4, gather=True, device="cpu")
    _, got = solver.advance(cfg, ttypes.Scene(), xs)
    ks = sorted(spec.cell_capacity for spec in solver._steps)
    assert len(ks) == 2 and ks[0] == 4 < ks[1]
    _, want = TorchSolver(h=cfg.h, cell_capacity=ks[1], gather=True,
                          device="cpu").advance(cfg, ttypes.Scene(), xs)
    np.testing.assert_array_equal(got.pid, want.pid)
    np.testing.assert_array_equal(got.position, want.position)
    np.testing.assert_array_equal(got.velocity, want.velocity)
    np.testing.assert_array_equal(got.colour, want.colour)
