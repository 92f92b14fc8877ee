"""The port's marching cubes against the JAX package's, on CPU.

* tables and `McSpec.from_extent` equal the JAX package's;
* `mc_field_plain` and `McField` (row 4b's plain version,
  `mc_field_cells_plain`) against `PallasMcField` in interpret mode, on the
  post-finalise state of the port's frame.  Raw count exact; v rtol 1e-4,
  atol 1e-3; n and c rtol 1e-3, atol 1e-3 on finite nodes with v > 1e-3,
  NaN disagreement under 1% of the nodes (`test_pallas_mc.py`'s
  tolerances); c NaN exactly where Pallas counts 0; the skip node 0;
* row 4b's ranges, clamped at the z-ends from the table, admit exactly the
  candidates of row 4's key test, on the frames and on a synthetic index
  with members in the z-wrapping cells, an empty column and columns off the
  grid; `mc_field_cells_plain` gives `post_pass(mc_field_plain)`'s bits
  (both walk one padded layout, so only the admission test differs);
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
from pbf_sph_tpu_torch.ops.grid import GridSpec, build_cell_table, decode_key
from test_mc_emit import _sphere_lattice


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the tier runs several test
    processes at once, and torch's default pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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

    v, n, c = _cells_field(field_frame)  # McField, with no launch counted
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


def _cells_field(field_frame):
    """`McField` on the CPU (`mc_field_cells_plain`) at the frame, once."""
    if "cells" not in field_frame:
        spec, fr, st, dyn = (field_frame[k] for k in ("spec", "fr", "st", "dyn"))
        field = mf.McField(spec.h)
        field_frame["cells"] = field(fr.index, spec.surface, spec.scale, st.position,
                                     st.colour, st.ptype, st.alive, fr.min_extent,
                                     dyn["mc_particle_size"])
        assert field.launches == {"mc_field_cells": 0, "mc_field": 0}
    return field_frame["cells"]


def test_mc_field_cells_nan_pattern_is_pallas_empty_nodes(field_frame):
    """c is NaN exactly on the nodes where the Pallas kernel counts no
    candidate (its count is exact, as the port's), but the skip node, which
    is 0 in v, n and c."""
    spec = field_frame["spec"]
    v, n, c = _cells_field(field_frame)
    cnt_want = field_frame["want"][3]
    _, _, skip = mf.lattice_nodes(spec.surface, spec.grid.extent, "cpu")
    empty = (cnt_want == 0) & ~skip.numpy()
    assert 0 < empty.sum() < empty.size
    for ch in c.numpy():
        np.testing.assert_array_equal(np.isnan(ch), empty)
    assert v[skip].item() == 0 and (n[:, skip] == 0).all() and (c[:, skip] == 0).all()


def test_mc_field_cells_plain_is_post_passed_row4(field_frame):
    """Row 4b's plain version against `post_pass(mc_field_plain(...))`: the
    same bits, NaN in the same places, the skip node 0 in both."""
    spec, fr, st, dyn = (field_frame[k] for k in ("spec", "fr", "st", "dyn"))
    size = dyn["mc_particle_size"]
    raw = mf.mc_field_plain(fr.index, spec.surface, spec.h, spec.scale, st.position,
                            st.colour, mf.nonobstacle(st.ptype, st.alive), fr.min_extent)
    want = mf.post_pass(raw, spec.surface, spec.grid.extent, size)
    got = mf.mc_field_cells_plain(fr.index, spec.surface, spec.h, spec.scale, st.position,
                                  st.colour, st.ptype, st.alive, fr.min_extent, size)
    assert got.shape == (8, raw.shape[1])
    for g, w in zip((got[0], got[1:4], got[4:8]), want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    for g, w in zip(_cells_field(field_frame), want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert np.isnan(want[2].numpy()).any() and (want[0] > 1e-3).any()


def _admitted(index, cell, skip):
    """(lo, j, admitted): row 4's padded layout over `node_ranges` and the
    candidates its key test admits (z-wrapped cells dropped)."""
    lo, hi, base = mf.node_ranges(index, cell, skip)
    width = int((hi - lo).max())
    j = lo[..., None] + torch.arange(width)
    valid = j < hi[..., None]
    key = index.key.long()[torch.where(valid, j, 0)]
    bz = cell[2].long()[None, :, None] + key - base[..., None]
    return j, valid & (bz >= 0) & (bz < index.grid.dims[2])


def _assert_clamp_admits_key_test(index, cell, skip):
    j, admitted = _admitted(index, cell, skip)
    clo, chi = mf.node_ranges_clamped(index, cell, skip)
    assert torch.equal(admitted, (j >= clo[..., None]) & (j < chi[..., None]))
    assert torch.equal(admitted.sum(-1), chi - clo)
    return admitted


def test_mc_field_clamped_ranges_admit_the_key_test(field_frame):
    """On the frame: each of a node's nine clamped ranges holds exactly the
    slots of `node_ranges` that the key test admits."""
    spec, fr = field_frame["spec"], field_frame["fr"]
    _, cell, skip = mf.lattice_nodes(spec.surface, spec.grid.extent, "cpu")
    admitted = _assert_clamp_admits_key_test(fr.index, cell, skip)
    assert int(admitted.sum()) > 0


def _synthetic_index():
    """A 4 x 3 x 5 grid (extent (3, 2, 4)): every cell at z = 0 and z = ez
    holds 1-3 members (the cells that z-wrap into the next or last column),
    the others 0-3, column (2, 1) none, then 5 rows that are no members."""
    grid = GridSpec(extent=(3, 2, 4), maxz=0, quirks=False)
    gnx, gny, gnz = grid.dims
    rng = np.random.default_rng(17)
    counts = rng.integers(0, 4, size=(gnx, gny, gnz))
    counts[:, :, [0, gnz - 1]] = rng.integers(1, 4, size=(gnx, gny, 2))
    counts[2, 1, :] = 0
    key = np.concatenate([np.repeat(np.arange(grid.ncells), counts.ravel()),
                          np.full(5, grid.ncells)])
    key = torch.from_numpy(key.astype(np.int32))
    return mf.CellIndex(grid, key, build_cell_table(key, grid))


@pytest.mark.parametrize("res", [1.0, 2.0])
def test_mc_field_clamped_ranges_on_synthetic_index(res):
    """Every node of the lattice at `res`, node by node: the clamped range of
    each (dx, dy) column is the list of candidates the key test admits, in
    order; a z-end node's unclamped range holds a wrapped cell that the clamp
    drops, a column off the grid and the empty column give empty ranges."""
    index = _synthetic_index()
    mc = tmc.McSpec.from_extent(index.grid.extent, res)
    _, cell, skip = mf.lattice_nodes(mc, index.grid.extent, "cpu")
    lo, hi, base = (t.numpy() for t in mf.node_ranges(index, cell, skip))
    clo, chi = (t.numpy() for t in mf.node_ranges_clamped(index, cell, skip))
    key, cz = index.key.numpy(), cell[2].numpy()
    gnx, gny, gnz = index.grid.dims
    dropped = off_grid = empty = 0
    for i in range(cell.shape[1]):
        for s in range(9):
            want = [j for j in range(lo[s, i], hi[s, i]) if 0 <= cz[i] + key[j] - base[s, i] < gnz]
            assert list(range(clo[s, i], chi[s, i])) == want, (i, s)
            dropped += hi[s, i] - lo[s, i] - len(want)
            bx, by = cell[0, i] + s // 3 - 1, cell[1, i] + s % 3 - 1
            off_grid += not (0 <= bx < gnx and 0 <= by < gny) and not skip[i]
            empty += (int(bx), int(by)) == (2, 1) and chi[s, i] == clo[s, i]
    assert dropped > 0 and off_grid > 0 and empty > 0
    assert int(skip.sum()) == 1 and (clo[:, skip] == chi[:, skip]).all()
    _assert_clamp_admits_key_test(index, cell, skip)


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
