"""The port's marching cubes against the JAX package's, on CPU.

* tables and `McSpec.from_extent` equal the JAX package's;
* `mc_field_plain` and the `McField` post-pass against `PallasMcField` in
  interpret mode, on the post-finalise state of the port's frame.  Raw count
  exact; v rtol 1e-4, atol 1e-3; n and c rtol 1e-3, atol 1e-3 on finite
  nodes with v > 1e-3, NaN disagreement under 1% of the nodes
  (`test_pallas_mc.py`'s tolerances); the skip node 0;
* `mc_extract` against JAX `mc_extract` on an analytic lattice, on the
  global and the compacted path: total exact, the same vertex order, values
  rtol 1e-6, atol 1e-5 (the lerp in another fp order), NaN where JAX has NaN;
* the growth policy's surface branches against the JAX package's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbf_sph_tpu.core.types as jtypes
from pbf_sph_tpu.core.configs import WORKLOADS as JAX_WORKLOADS
from pbf_sph_tpu.models.growth import growth_changes as jax_growth_changes
from pbf_sph_tpu.models.jax_solver import JaxSolver, make_phase_objects
from pbf_sph_tpu.ops import mc as jax_mc
from pbf_sph_tpu.ops import mc_tables as jax_tables
from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
from pbf_sph_tpu_torch.core.types import Scene
from pbf_sph_tpu_torch.models.growth import growth_changes
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, dyn_params_of, solve_frame
from pbf_sph_tpu_torch.ops import mc as tmc
from pbf_sph_tpu_torch.ops import mc_field as mf
from pbf_sph_tpu_torch.ops import mc_tables as tables
from pbf_sph_tpu_torch.ops.grid import decode_key
from test_mc_emit import _sphere_lattice


def test_tables_equal_jax():
    for name in ("CUBE_OFFSETS", "EDGE_CORNERS", "EDGE_TABLE", "TRI_TABLE",
                 "NUM_VERTS_TABLE"):
        np.testing.assert_array_equal(getattr(tables, name), getattr(jax_tables, name))
    assert tables.MAX_TRIS_PER_CUBE == jax_tables.MAX_TRIS_PER_CUBE == 5


@pytest.mark.parametrize("workload", ["bench20k", "mc128k", "mc512k"])
def test_mc_spec_matches_jax(workload):
    mc, cfg, _ = JAX_WORKLOADS[workload]()
    jspec = JaxSolver(h=cfg.h).make_spec(cfg, jtypes.Scene(), 1024).surface
    got = TorchSolver(h=cfg.h, device="cpu").make_spec(cfg, Scene(), 1024).surface
    want = tmc.McSpec(**{f.name: getattr(jspec, f.name)
                         for f in dataclasses.fields(tmc.McSpec)})
    assert got == want
    assert got == tmc.McSpec.from_extent(
        JaxSolver(h=cfg.h).make_spec(cfg, jtypes.Scene(), 1024).grid.extent,
        mc.resolution)


# -- the field -----------------------------------------------------------------

FIELD_SCENES = {
    # res 2.0: eight nodes share a cell
    "2cubes1500": lambda: _with_surface(simple_config_with_2_cubes(1500, 2, 500.0)),
    # res 1.0, the mc128k geometry at a small count
    "dam4096": lambda: dam_break(4096, solver_iter=2, surface=True),
}


def _with_surface(tup):
    mc, cfg, xs = tup
    return mc, cfg.replace(surface=mc), xs


@pytest.fixture(scope="module", params=sorted(FIELD_SCENES))
def field_frame(request):
    """The port's frame up to finalise, and PallasMcField (interpret mode) on
    the same sort-time cells and post-finalise state."""
    mc, cfg, xs = FIELD_SCENES[request.param]()
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, device="cpu")
    fr, st, _ = solve_frame(spec, solver.phases, state, dyn, scn)
    # the edge precondition under which the exact 27-neighbourhood equals the
    # Pallas kernel's clamped windows (ops/mc_field.py)
    member = fr.index.key < spec.grid.ncells
    cells, _ = decode_key(fr.index.key, spec.grid)
    for a in range(3):
        assert int(cells[a][member].max()) < spec.grid.extent[a]

    jspec = JaxSolver(h=cfg.h, use_pallas=True).make_spec(cfg, jtypes.Scene(), spec.capacity)
    assert jspec.grid.extent == spec.grid.extent
    _, pallas = make_phase_objects(jspec, use_pallas=True)
    raw_rows = []
    call = pallas._call
    pallas._call = lambda *a: raw_rows.append(call(*a)) or raw_rows[-1]
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    lat_v, lat_n, lat_c, overflow = pallas(
        j(fr.index.table), tuple(j(c) for c in cells), j(st.position), j(st.colour),
        j(st.ptype), j(st.alive), j(member), j(fr.min_extent),
        j(dyn["mc_particle_size"]), jnp.float32(spec.scale), jnp.float32)
    assert int(overflow) == 0
    # the kernel's rows are cell-sorted nodes: back to lattice order
    L = lat_v.shape[0]
    cnt = np.zeros(L, np.float32)
    cnt[pallas.static["row_lat"][:L]] = np.asarray(raw_rows[0])[8, :L]
    return dict(spec=spec, dyn=dyn, fr=fr, st=st, solver=solver,
                want=(np.asarray(lat_v), np.asarray(lat_n), np.asarray(lat_c), cnt))


def test_mc_field_plain_matches_pallas(field_frame):
    spec, fr, st, dyn = (field_frame[k] for k in ("spec", "fr", "st", "dyn"))
    v_want, n_want, c_want, cnt_want = field_frame["want"]
    nonobs = mf.nonobstacle(st.ptype, st.alive)
    raw = mf.mc_field_plain(fr.index, spec.surface, spec.h, spec.scale, st.position,
                            st.colour, nonobs, fr.min_extent)
    np.testing.assert_array_equal(raw[8].numpy(), cnt_want)
    assert cnt_want.max() > 1

    field = mf.McField(spec.h)
    v, n, c = field(fr.index, spec.surface, spec.scale, st.position, st.colour,
                    st.ptype, st.alive, fr.min_extent, dyn["mc_particle_size"])
    assert field.launches == {"mc_field": 0}
    np.testing.assert_allclose(v.numpy(), v_want, rtol=1e-4, atol=1e-3)
    active = v_want > 1e-3
    assert active.any()
    for got, want in ((n.numpy(), n_want), (c.numpy(), c_want)):
        assert (np.isfinite(got) != np.isfinite(want)).mean() < 0.01
        m = np.isfinite(want) & active
        np.testing.assert_allclose(got[m], want[m], rtol=1e-3, atol=1e-3)

    _, _, skip = mf.lattice_nodes(spec.surface, spec.grid.extent, "cpu")
    assert int(skip.sum()) == 1
    assert v[skip].item() == 0 and (n[:, skip] == 0).all() and (c[:, skip] == 0).all()
    assert v_want[skip.numpy()].item() == 0


def test_mc_field_ranges_are_disjoint(field_frame):
    """A node's nine candidate ranges are disjoint, so no candidate is
    visited twice."""
    spec, fr = field_frame["spec"], field_frame["fr"]
    _, cell, skip = mf.lattice_nodes(spec.surface, spec.grid.extent, "cpu")
    lo, hi, _ = mf.node_ranges(fr.index, cell, skip)
    span = hi - lo
    assert (span >= 0).all() and int(span.sum()) > 0
    # empty ranges sort last; each nonempty range ends before the next begins
    end = spec.capacity + 1
    lo, hi = torch.where(span > 0, lo, end), torch.where(span > 0, hi, end)
    lo, order = torch.sort(lo, dim=0)
    hi = torch.gather(hi, 0, order)
    assert (hi[:-1] <= lo[1:]).all()


# -- extraction ------------------------------------------------------------------


def _port_extract(args, spec):
    v, n, c, min_extent, _extent, _spec, h, scale, iso = args
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return tmc.mc_extract(t(v), t(n), t(c), t(min_extent), spec, h, t(scale), t(iso))


def _port_spec(jspec, **kw):
    return dataclasses.replace(
        tmc.McSpec(resolution=jspec.resolution, sample=jspec.sample,
                   tri_capacity=jspec.tri_capacity), **kw)


@pytest.mark.parametrize("cube_cap", [0, "M", 1024, 896])
def test_mc_extract_matches_jax(cube_cap):
    jspec, args = _sphere_lattice()
    M = int(np.prod([s - 1 for s in jspec.sample]))
    cap = M if cube_cap == "M" else cube_cap
    want = jax_mc.mc_extract(*args)  # the global sort
    got = _port_extract(args, _port_spec(jspec, cube_cap=cap))
    total = int(want[3])
    assert total > 100
    assert int(got[3]) == total and int(got[4]) == 0
    for g, w in zip(got[:3], want[:3]):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)
        assert not g[:, 3 * total:].any()  # the tail stays zero


def test_mc_extract_reports_cube_overflow():
    jspec, args = _sphere_lattice()
    want = jax_mc.mc_extract(*(args[:5] + (dataclasses.replace(jspec, cube_cap=128),)
                               + args[6:]))
    got = _port_extract(args, _port_spec(jspec, cube_cap=128))
    assert int(got[4]) == int(want[4]) > 0
    assert int(got[3]) == int(want[3])


def test_mc_extract_truncates_at_tri_capacity():
    """More triangles than the buffer holds: the first T are kept, in order,
    and the total reports the overflow to the growth policy."""
    jspec, args = _sphere_lattice()
    full = _port_extract(args, _port_spec(jspec))
    small = _port_extract(args, _port_spec(jspec, tri_capacity=64))
    assert int(small[3]) == int(full[3]) > 64
    for s, f in zip(small[:3], full[:3]):
        np.testing.assert_array_equal(s.numpy(), f[:, :192].numpy())


# -- growth ----------------------------------------------------------------------

GROWTH_OUTS = {
    "held": dict(tri_count=10, mc_emit_overflow=0),
    "triangles": dict(tri_count=150_000, mc_emit_overflow=0),
    "cubes": dict(tri_count=10, mc_emit_overflow=300),
    "cubes_past_volume": dict(tri_count=10, mc_emit_overflow=10_000_000),
    "both": dict(tri_count=200_000, mc_emit_overflow=5000),
}


@pytest.mark.parametrize("case", sorted(GROWTH_OUTS))
def test_surface_growth_matches_jax(case):
    mc, cfg, _ = dam_break(128_000, solver_iter=3, surface=True)
    jspec = JaxSolver(h=cfg.h).make_spec(cfg, jtypes.Scene(), 1024)
    tspec = TorchSolver(h=cfg.h, device="cpu").make_spec(cfg, Scene(), 1024)
    assert tspec.surface.cube_cap > 0
    out = dict(GROWTH_OUTS[case], max_occupancy=12, query_overflow=0)
    want = jax_growth_changes(jspec, dict(out, strip_overflow=0, mc_strip_overflow=0))
    got = growth_changes(tspec, out)
    assert sorted(got) == sorted(want)
    assert (case == "held") == (got == {})
    if "surface" in want:
        assert got["surface"].tri_capacity == want["surface"].tri_capacity
        assert got["surface"].cube_cap == want["surface"].cube_cap
