"""The gather backend's pieces against the JAX package's XLA path, on CPU.

`stencil_ranges`, `diffuse`, `lambda_phase`, `delta_phase` and the XLA
`mc_field` of the port (plain torch ops, no kernel) against the JAX
functions they port, called eagerly on the same numpy inputs:

* the 27 [start, end) ranges exact, on the sort-time states of
  `simple_config_with_2_cubes(700, 2, 500)` and `dam_break(4096, 2)` and on a
  synthetic grid with members in the far-corner cell and in the cell whose
  Morton code + 1 is maxz, so that both of the reference's quirks bite;
* the phases on those states (seeded colours and 5% obstacle rows): float32
  lambda atol 1e-6 / rtol 1e-5, pStar after one delta and its clamp atol
  1e-5, colour 1e-6, the diffuse neighbour count exact; float64 (JAX's x64
  on for the test alone) within 1e-12 relative; and with K = 4, below the
  occupancy, both sides truncated alike;
* the field on the post-finalise state of a gather frame: v rtol 1e-4 /
  atol 1e-3, the colour's NaN nodes exact (its count is an integer), the
  normal's NaN nodes under 1% apart, n and c rtol 1e-3 / atol 1e-3 where
  both are finite and v > 1e-3 (`tests/test_pallas_mc.py:70-82`).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbf_sph_tpu.ops import grid as jgrid
from pbf_sph_tpu.ops import mc as jmc
from pbf_sph_tpu.ops import pbf as jpbf
from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
from pbf_sph_tpu_torch.core.types import OBSTACLE, Scene
from pbf_sph_tpu_torch.models.torch_solver import (
    TorchSolver,
    advect_and_sort,
    dyn_params_of,
    solve_frame,
)
from pbf_sph_tpu_torch.ops import mc as tmc
from pbf_sph_tpu_torch.ops import pbf as tpbf
from pbf_sph_tpu_torch.ops.curves import morton_encode3
from pbf_sph_tpu_torch.ops.grid import (
    GridSpec,
    build_cell_table,
    decode_key,
    sort_key,
    stencil_ranges,
)

CASES = {
    "2cubes700": lambda: simple_config_with_2_cubes(700, 2, 500.0),
    "dam4096": lambda: dam_break(4096, solver_iter=2),
}
# both states at dam4096's capacity, so that JAX's eager ops compiled for
# one state's (K, C) shapes serve the other
CAPACITY = 4608


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


def _jgrid(grid: GridSpec):
    return jgrid.GridSpec(extent=grid.extent, maxz=grid.maxz, quirks=grid.quirks)


def _j(t):
    return jnp.asarray(t.numpy())


def _ranges_equal(got, want):
    assert len(got) == len(want) == 27
    for (gs, ge), (ws, we) in zip(got, want):
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        np.testing.assert_array_equal(ge.numpy(), np.asarray(we))


@pytest.fixture(scope="module", params=sorted(CASES))
def frame(request):
    """A sort-time state with seeded colours and 5% obstacle rows, its cells
    and both packages' ranges."""
    mc, cfg, xs = CASES[request.param]()
    solver = TorchSolver(h=cfg.h, gather=True, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs, capacity=CAPACITY)
    dyn = dyn_params_of(cfg, device="cpu")
    fr = advect_and_sort(spec, state, dyn, scn)
    st = fr.state
    rng = np.random.default_rng(18)
    colour = torch.from_numpy(rng.uniform(0.05, 1.0, st.colour.shape).astype(np.float32))
    ptype = torch.where(torch.from_numpy(rng.uniform(size=st.ptype.shape) < 0.05),
                        OBSTACLE, st.ptype).to(torch.int32)
    cells, member = decode_key(fr.index.key, spec.grid)
    ranges = stencil_ranges(cells, member, fr.index.table, spec.grid)
    jranges = jgrid.stencil_ranges(tuple(_j(c) for c in cells), _j(member),
                                   _j(fr.index.table), _jgrid(spec.grid))
    occupancy = int((fr.index.table[1:] - fr.index.table[:-1]).max())
    return dict(spec=spec, dyn=dyn, fr=fr, colour=colour, ptype=ptype, ranges=ranges,
                jranges=jranges, occupancy=occupancy)


def test_stencil_ranges_match_jax(frame):
    _ranges_equal(frame["ranges"], frame["jranges"])
    lens = torch.stack([e - s for s, e in frame["ranges"]])
    assert int(lens.max()) == frame["occupancy"] > 1


def _quirk_grid(quirks: bool):
    """extent (3, 4, 3): maxz = 173 is the far corner (3, 4, 3), and the cell
    (2, 4, 3) has Morton code 172 = maxz - 1."""
    extent = (3, 4, 3)
    return GridSpec(extent=extent, maxz=int(morton_encode3(*extent)), quirks=quirks)


@pytest.mark.parametrize("quirks", [True, False])
def test_stencil_ranges_quirk_cells_match_jax(quirks):
    spec = _quirk_grid(quirks)
    assert morton_encode3(2, 4, 3) + 1 == spec.maxz
    rng = np.random.default_rng(5)
    every = np.array(list(itertools.product(*(range(n) for n in spec.dims))))
    extra = np.array([(3, 4, 3)] * 5 + [(2, 4, 3)] * 4 + [(2, 3, 2)] * 3)
    pts = np.concatenate([every, every[rng.integers(0, len(every), 60)], extra,
                          [(-1, 0, 0), (4, 2, 1)]])  # two outside the box
    cells = tuple(torch.from_numpy(pts[:, a].astype(np.int32)) for a in range(3))
    alive = torch.from_numpy(rng.uniform(size=len(pts)) < 0.95)
    key = torch.sort(sort_key(cells, alive, spec), stable=True).values
    table = build_cell_table(key, spec)
    scells, member = decode_key(key, spec)
    got = stencil_ranges(scells, member, table, spec)
    want = jgrid.stencil_ranges(tuple(_j(c) for c in scells), _j(member), _j(table),
                                _jgrid(spec))
    _ranges_equal(got, want)

    # the quirks bite: the far-corner cell has no members, and no row gathers
    # the cell whose code + 1 is maxz; without them both are gathered
    lin = (2 * spec.dims[1] + 4) * spec.dims[2] + 3
    corner = spec.ncells - 1
    qs, qe = int(table[lin]), int(table[lin + 1])
    assert qe > qs
    hits = sum(int(((s == qs) & (e == qe)).sum()) for s, e in got)
    assert (int(table[corner + 1] - table[corner]) == 0) == quirks
    assert (hits == 0) == quirks


def _phase_inputs(frame, dtype):
    fr = frame["fr"]
    st = fr.state
    t = dict(pstar=fr.pstar.to(dtype), mass=st.mass.to(dtype),
             colour=frame["colour"].to(dtype), ptype=frame["ptype"], alive=st.alive,
             dt=frame["dyn"]["dt"].to(dtype), scale=torch.tensor(frame["spec"].scale, dtype=dtype),
             min_bound=frame["dyn"]["min_bound"].to(dtype),
             max_bound=frame["dyn"]["max_bound"].to(dtype))
    return t, {k: _j(v) for k, v in t.items()}


def _run_phases(frame, dtype, cap):
    """(port, JAX) outputs of diffuse, the diffuse count, lambda and one
    delta (fed JAX's lambda), as numpy."""
    h = frame["spec"].h
    t, j = _phase_inputs(frame, dtype)
    ranges, jranges = frame["ranges"], frame["jranges"]
    got = dict(
        colour=tpbf.diffuse(t["colour"], t["ptype"], t["alive"], ranges, cap, t["dt"]),
        count=tpbf.diffuse_sums(t["colour"], t["ptype"], ranges, cap)[1],
        lam=tpbf.lambda_phase(t["pstar"], t["mass"], t["ptype"], t["alive"], ranges, cap, h))
    jlam = jpbf.lambda_phase(j["pstar"], j["mass"], j["ptype"], j["alive"], jranges, cap, h)
    got["pstar"] = tpbf.delta_phase(t["pstar"], torch.from_numpy(np.asarray(jlam)),
                                    t["ptype"], t["alive"], ranges, cap, h, t["scale"],
                                    t["min_bound"], t["max_bound"])
    jcount = sum(jnp.sum(m & (j["ptype"][idx] != OBSTACLE), axis=0)
                 for idx, m in (jpbf._candidates(s, e, cap) for s, e in jranges))
    want = dict(
        colour=jpbf.diffuse(j["colour"], j["ptype"], j["alive"], jranges, cap, j["dt"]),
        count=jcount, lam=jlam,
        pstar=jpbf.delta_phase(j["pstar"], jlam, j["ptype"], j["alive"], jranges, cap, h,
                               j["scale"], j["min_bound"], j["max_bound"]))
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    npdtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    for k in ("colour", "lam", "pstar"):
        assert got[k].dtype == want[k].dtype == npdtype
    return got, want


def _check_fp32(got, want, t_pstar, t_colour):
    np.testing.assert_array_equal(got["count"], want["count"])
    assert want["count"].max() > 1
    np.testing.assert_allclose(got["lam"], want["lam"], atol=1e-6, rtol=1e-5)
    assert np.abs(want["lam"]).max() > 0
    np.testing.assert_allclose(got["pstar"], want["pstar"], atol=1e-5, rtol=0)
    assert np.abs(want["pstar"] - t_pstar).max() > 0
    np.testing.assert_allclose(got["colour"], want["colour"], atol=1e-6, rtol=0)
    assert np.abs(want["colour"] - t_colour).max() > 0


def test_phases_match_jax_fp32(frame):
    got, want = _run_phases(frame, torch.float32, frame["spec"].cell_capacity)
    assert frame["occupancy"] <= frame["spec"].cell_capacity
    _check_fp32(got, want, frame["fr"].pstar.numpy(), frame["colour"].numpy())


def test_phases_truncate_like_jax(frame):
    """K below the occupancy: both sides drop the same candidates."""
    cap = 4
    lens = torch.stack([e - s for s, e in frame["ranges"]])
    assert bool((lens > cap).any())
    got, want = _run_phases(frame, torch.float32, cap)
    _check_fp32(got, want, frame["fr"].pstar.numpy(), frame["colour"].numpy())
    assert got["count"].max() <= 27 * cap


def test_phases_match_jax_fp64(frame):
    with jax.enable_x64(True):
        got, want = _run_phases(frame, torch.float64, frame["spec"].cell_capacity)
    np.testing.assert_array_equal(got["count"], want["count"])
    for k in ("lam", "pstar", "colour"):
        scale = np.abs(want[k]).max()
        assert scale > 0
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12 * scale)


def test_mc_field_matches_jax():
    # res 1.0, the mc128k geometry at a small count (18^3 nodes); JAX's eager
    # ops compile once a shape, so one lattice keeps the test cheap
    mc, cfg, xs = dam_break(4096, solver_iter=2, surface=True)
    solver = TorchSolver(h=cfg.h, gather=True, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, device="cpu")
    fr, st, _ = solve_frame(spec, None, state, dyn, scn)
    sur, K = spec.surface, spec.cell_capacity
    scale = torch.tensor(spec.scale, dtype=torch.float32)
    args = (st.position, st.colour, st.ptype, st.alive, fr.index.table)
    got = tmc.mc_field(*args, spec.grid, fr.min_extent, spec.grid.extent, sur, K, spec.h,
                       scale, dyn["mc_particle_size"], dyn["mc_particle_influence"])
    jsur = jmc.McSpec(resolution=sur.resolution, sample=sur.sample,
                      tri_capacity=sur.tri_capacity, influence_static=sur.influence_static,
                      cube_cap=sur.cube_cap)
    want = jmc.mc_field(*(_j(a) for a in args), _jgrid(spec.grid), _j(fr.min_extent),
                        spec.grid.extent, jsur, K, spec.h, _j(scale),
                        _j(dyn["mc_particle_size"]), _j(dyn["mc_particle_influence"]))
    gv, gn, gc = (g.numpy() for g in got)
    wv, wn, wc = (np.asarray(w) for w in want)
    assert gv.shape == wv.shape == (int(np.prod(sur.sample)),)
    np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-3)
    assert wv.max() > cfg.surface.isolevel
    np.testing.assert_array_equal(np.isnan(gc), np.isnan(wc))
    assert 0 < np.isnan(wc[0]).sum() < wc.shape[1]
    active = wv > 1e-3
    for g, w in ((gn, wn), (gc, wc)):
        assert (np.isfinite(g) != np.isfinite(w)).mean() < 0.01
        m = np.isfinite(w) & np.isfinite(g) & active
        np.testing.assert_allclose(g[m], w[m], rtol=1e-3, atol=1e-3)
