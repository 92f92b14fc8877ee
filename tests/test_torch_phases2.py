"""The port's v2 compacted-candidate phases (`tools/phases2.py`) against the
JAX package's `tools/pallas_pbf2.py`.

The JAX module lives in `tools/`, outside the package; it is loaded from its
file.  `PallasPhases2(..., interpret=True)` runs the Pallas kernels in
interpret mode on the CPU; the port's `PbfPhases2` runs its plain versions
there.  Both get the sort-time state of `test_torch_phases.py`'s two cases,
capacity 1024, smax as `tools/bench_phases.py` sets it (1024 here) and
wcap 512: four chunks, which holds both cases with no overflow and keeps the
interpreted chain short.

Tolerances: plan integers and slabs exact (the slabs bit for bit on the
columns the kernel writes); lambda atol 1e-6, rtol 1e-5 and pStar after one
delta phase and the clamp atol 1e-5 (fp32 sums in another order, as in
`test_torch_phases.py`); diffused colour atol 1e-5 (the Pallas colour sums
go through a matmul).
"""

import functools
import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbf_sph_tpu.models.jax_solver import JaxSolver
from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
from pbf_sph_tpu_torch.core.types import Scene
from pbf_sph_tpu_torch.models.torch_solver import (
    TorchSolver,
    advect_and_sort,
    dyn_params_of,
)
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.ops.grid import decode_key
from pbf_sph_tpu_torch.tools import phases2 as p2

REPO = Path(__file__).resolve().parent.parent
CASES = {
    # the end-to-end parity scene
    "2cubes": (700, 2, 500.0),
    # sparse particles on a 9^3-cell grid: sub-blocks span many cells
    "sparse": (600, 2, 2500.0),
}
WCAP = 512


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the tier runs several test
    processes at once, and torch's default pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def jax_v2():
    spec = importlib.util.spec_from_file_location(
        "pallas_pbf2_reference", REPO / "tools" / "pallas_pbf2.py")
    module = importlib.util.module_from_spec(spec)
    # its dataclass resolves string annotations through sys.modules
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def j(t):
    return jnp.asarray(t.numpy())


@functools.lru_cache(maxsize=None)
def frame(case: str):
    """(spec, dyn, sort-time frame, JAX grid, member, cells, smax)."""
    mc, cfg, xs = simple_config_with_2_cubes(*CASES[case])
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    assert spec.capacity == 1024
    dyn = dyn_params_of(cfg, device="cpu")
    fr = advect_and_sort(spec, state, dyn, scn)
    jspec = JaxSolver(h=cfg.h, use_pallas=True).make_spec(cfg, Scene(), spec.capacity)
    assert jspec.grid.extent == spec.grid.extent
    cells, member = decode_key(fr.index.key, spec.grid)
    smax = p2.default_strip_capacity(spec.grid.dims, spec.capacity)
    assert smax == 1024
    return spec, dyn, fr, jspec.grid, member, cells, smax


@functools.lru_cache(maxsize=None)
def pallas(case: str):
    """The interpreted JAX chain, as numpy: plan, slabs, lambda, pStar after
    delta, diffused colour."""
    spec, dyn, fr, jgrid, member, cells, smax = frame(case)
    st = fr.state
    phases = jax_v2().PallasPhases2(spec.capacity, jgrid, spec.h, smax, WCAP,
                                    interpret=True)
    wins, ovf = phases.plan_frame(j(fr.index.key), j(fr.index.table))
    jm, jc = j(member), tuple(j(c) for c in cells)
    cands = phases.compact_pstar(wins, j(fr.pstar), jm)
    lam = phases.lambda_phase(wins, cands, j(fr.pstar), j(st.mass), jm, j(st.ptype),
                              j(st.alive))
    lamc = phases.compact_lam(wins, lam)
    moved = phases.delta_phase(wins, cands, lamc, j(fr.pstar), lam, jm, j(st.ptype),
                               j(st.alive), jnp.float32(spec.scale), j(dyn["min_bound"]),
                               j(dyn["max_bound"]))
    colour = phases.diffuse(wins, j(st.colour), jc, jm, j(st.ptype), j(st.alive),
                            j(dyn["dt"]))
    out = {k: np.asarray(v) for k, v in wins.items()}
    out.update({k: int(v) for k, v in ovf.items()})
    out.update(cands=np.asarray(cands), lam=np.asarray(lam), lamc=np.asarray(lamc),
               moved=np.asarray(moved), colour=np.asarray(colour))
    return out


@functools.lru_cache(maxsize=None)
def port(case: str):
    """The port's plan and phases on the CPU, fed the JAX lambda where a
    phase takes one, so each phase is compared alone."""
    spec, dyn, fr, _, member, cells, smax = frame(case)
    st = fr.state
    want = pallas(case)
    phases = p2.PbfPhases2(spec.capacity, spec.grid, spec.h, smax, WCAP)
    wins, ovf = phases.plan_frame(fr.index.key, fr.index.table)
    cands = phases.compact_pstar(wins, fr.pstar, member)
    lam = phases.lambda_phase(wins, cands, fr.pstar, st.mass, member, st.ptype, st.alive)
    jlam = torch.from_numpy(want["lam"].copy())
    lamc = phases.compact_lam(wins, jlam)
    moved = phases.delta_phase(wins, cands, lamc, fr.pstar, jlam, member, st.ptype,
                               st.alive, torch.tensor(spec.scale, dtype=torch.float32),
                               dyn["min_bound"], dyn["max_bound"])
    colour = phases.diffuse(wins, st.colour, cells, member, st.ptype, st.alive, dyn["dt"])
    assert phases.launches == {"compact": 0, "lambda2": 0, "delta2": 0, "diffuse2": 0}
    return dict(wins=wins, ovf=ovf, cands=cands, lam=lam, lamc=lamc, moved=moved,
                colour=colour)


def defined_columns(nchunkp: np.ndarray) -> np.ndarray:
    """(nsub * WCAP,) bool: the slab columns below nchunkp * 128."""
    col = np.arange(WCAP)[None, :] < nchunkp[:, None] * p2.WCOL
    return col.reshape(-1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_matches_jax(case):
    want, got = pallas(case), port(case)
    wins = got["wins"]
    for name in ("nchunk", "nchunkp", "sstart"):
        np.testing.assert_array_equal(wins[name].numpy(), want[name], err_msg=name)
    for name in ("strip_overflow", "wcap_overflow"):
        assert int(got["ovf"][name]) == want[name] == 0
    assert 0 < int(wins["nchunk"].max()) <= WCAP // p2.WCOL
    # the absolute source chunk of every slot j < nchunk
    jw = {k: torch.from_numpy(want[k].copy()) for k in ("meta", "sstart")}
    abs_want = p2.source_columns(jw).numpy()
    abs_got = p2.source_columns(wins).numpy()
    used = np.arange(WCAP // p2.WCOL)[None, :] < want["nchunk"][:, None]
    np.testing.assert_array_equal(abs_got[used], abs_want[used])


@pytest.mark.parametrize("case", sorted(CASES))
def test_compaction_matches_jax(case):
    want, got = pallas(case), port(case)
    cols = defined_columns(want["nchunkp"])
    assert cols.any()
    for name in ("cands", "lamc"):
        np.testing.assert_array_equal(got[name].numpy()[:, cols], want[name][:, cols],
                                      err_msg=name)
    # the fill of [nchunk, nchunkp) is part of the output
    fill = cols & ~(np.arange(WCAP)[None, :] < want["nchunk"][:, None] * p2.WCOL).reshape(-1)
    assert (got["cands"].numpy()[:, fill] == p2.SENTINEL).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_lambda2_matches_jax(case):
    want, got = pallas(case), port(case)
    assert np.abs(want["lam"]).max() > 0
    np.testing.assert_allclose(got["lam"].numpy(), want["lam"], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_delta2_matches_jax(case):
    spec, dyn, fr, *_ = frame(case)
    want, got = pallas(case), port(case)
    assert np.abs(want["moved"] - fr.pstar.numpy()).max() > 0
    np.testing.assert_allclose(got["moved"].numpy(), want["moved"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_diffuse2_matches_jax(case):
    spec, dyn, fr, *_ = frame(case)
    want, got = pallas(case), port(case)
    assert np.abs(want["colour"] - fr.state.colour.numpy()).max() > 0
    np.testing.assert_allclose(got["colour"].numpy(), want["colour"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_v2_matches_per_row_phases(case):
    """v2 against the port's per-row `PbfPhases` (v1), on member rows (a
    non-member row's raw v1 lambda is 1/CFM, its v2 lambda 0)."""
    spec, dyn, fr, _, member, cells, _ = frame(case)
    st, got = fr.state, port(case)
    v1 = ph.PbfPhases(spec.h)
    lam = v1.lambda_phase(fr.index, fr.pstar, st.mass, st.ptype, st.alive)
    torch.testing.assert_close(got["lam"][member], lam[member], atol=1e-6, rtol=1e-5)
    jlam = torch.from_numpy(pallas(case)["lam"].copy())
    moved = v1.delta_phase(fr.index, fr.pstar, jlam, st.ptype, st.alive,
                           torch.tensor(spec.scale, dtype=torch.float32),
                           dyn["min_bound"], dyn["max_bound"])
    torch.testing.assert_close(got["moved"][:, member], moved[:, member], atol=1e-5, rtol=0)
    colour = v1.diffuse(fr.index, st.colour, st.ptype, st.alive, dyn["dt"])
    torch.testing.assert_close(got["colour"][:, member], colour[:, member], atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_diffuse2_count_and_pairs_cover_v1(case):
    """The raw diffuse2 count equals the per-row count exactly on member
    rows, and slab pairs cover at least the per-row pairs."""
    spec, dyn, fr, _, member, cells, _ = frame(case)
    st, got = fr.state, port(case)
    wins = got["wins"]
    cl, wpack = p2.diffuse_packs(cells, member, st.ptype, st.alive, spec.grid.dims)
    cands_c = p2.compact_plain(wins, st.colour)
    cands_w = p2.compact_plain(wins, wpack)
    sums = p2.diffuse2_plain(wins["nchunkp"], cl, cands_c, cands_w, spec.grid.dims)
    want = ph.diffuse_plain(fr.index, st.colour, ph.nonobstacle(st.ptype, st.alive))
    assert torch.equal(sums[4][member], want[4][member])
    assert float(want[4].max()) > 1
    lo, hi = ph.neighbour_ranges(fr.index)
    assert p2.slab_pairs(wins) >= int((hi - lo).sum()) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_packs_match_pallas(case):
    """`pstar_pack` and `diffuse_packs` hold what `PallasPhases2` packs:
    [1, x|SENTINEL, y, z], its linear cell ids, and [w, bcl|SENTINEL] (its
    two zero rows not carried)."""
    spec, dyn, fr, jgrid, member, cells, smax = frame(case)
    st = fr.state
    assert not bool(member.all())
    pack = p2.pstar_pack(fr.pstar, member)
    want = np.stack([np.ones(spec.capacity, np.float32),
                     np.where(member.numpy(), fr.pstar[0].numpy(), p2.SENTINEL),
                     fr.pstar[1].numpy(), fr.pstar[2].numpy()])
    np.testing.assert_array_equal(pack.numpy(), want)
    acl, wpack = p2.diffuse_packs(cells, member, st.ptype, st.alive, spec.grid.dims)
    ref = jax_v2().PallasPhases2(spec.capacity, jgrid, spec.h, smax, WCAP, interpret=True)
    jacl = np.asarray(ref._linear_id(tuple(j(c) for c in cells), jnp.float32))
    np.testing.assert_array_equal(acl.numpy(), jacl)
    w = (st.ptype.numpy() != p2.OBSTACLE) & st.alive.numpy() & member.numpy()
    np.testing.assert_array_equal(wpack.numpy(), np.stack(
        [w.astype(np.float32), np.where(member.numpy(), jacl, p2.SENTINEL)]))


@functools.lru_cache(maxsize=None)
def dam32k():
    mc, cfg, xs = dam_break(32_000, solver_iter=3)
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    fr = advect_and_sort(spec, state, dyn_params_of(cfg, device="cpu"), scn)
    jgrid = JaxSolver(h=cfg.h, use_pallas=True).make_spec(cfg, Scene(), spec.capacity).grid
    return spec, fr, jgrid


@pytest.mark.parametrize("smax,wcap", [(128, 512), (8192, 512)])
def test_plan_overflow_matches_jax(smax, wcap):
    """The plan alone (XLA, not interpreted) at dam_break(32_000, 3)'s
    sort-time state: overflowing strip and slab capacities give the same
    overflows and plan on both sides."""
    spec, fr, jgrid = dam32k()
    wins, ovf = p2.plan_compact(fr.index.key, fr.index.table, spec.grid, spec.capacity,
                                smax, wcap)
    jwins, jovf = jax_v2().plan_compact(j(fr.index.key), j(fr.index.table), jgrid,
                                        spec.capacity, smax, wcap)
    assert int(ovf["wcap_overflow"]) == int(jovf["wcap_overflow"]) > 0
    assert int(ovf["strip_overflow"]) == int(jovf["strip_overflow"])
    assert (int(ovf["strip_overflow"]) > 0) == (smax == 128)
    for name in ("nchunk", "nchunkp", "sstart"):
        np.testing.assert_array_equal(wins[name].numpy(), np.asarray(jwins[name]))


def test_growth_rules_match_jax():
    ref = jax_v2()
    for wcap, ovf in ((512, 0), (512, 1), (2560, 128), (2560, 5000), (4608, 4096)):
        assert p2.grown_wcap(wcap, ovf) == ref.grown_wcap(wcap, ovf)
    for dims, strip, cap, ovf in (((88, 88, 88), None, 1_008_640, 0),
                                  ((88, 88, 88), 12288, 1_008_640, 3000),
                                  ((9, 9, 9), None, 1024, 10),
                                  ((47, 47, 47), 20480, 130_048, 9000)):
        spec = SimpleNamespace(grid=SimpleNamespace(dims=dims), strip_capacity=strip,
                               capacity=cap)
        assert p2.grown_strip_capacity(dims, strip, cap, ovf) == \
            ref.grown_strip_capacity(spec, ovf)
    assert p2.default_wcap() == ref.default_wcap()
    for name in ("BLK", "SUB", "WCOL", "UNROLL", "NPIECES", "NIV", "GAP_MIN", "WCAP_MAX",
                 "STRIP_MAX", "SENTINEL"):
        assert getattr(p2, name) == getattr(ref, name), name


def test_phases2_spec_is_checked():
    spec, fr, _ = dam32k()
    with pytest.raises(ValueError, match="multiple"):
        p2.PbfPhases2(spec.capacity, spec.grid, spec.h, 8192, 1000)
    with pytest.raises(ValueError, match="exceeds"):
        p2.PbfPhases2(1024, spec.grid, spec.h, 2048, 512)
