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
from test_torch_cuda import (
    ADVERSARIAL_SEEDS,
    DIFFUSE_DIMS,
    DIFFUSE_SENTINEL_SLOTS,
    DIFFUSE_ZERO_SLOTS,
    adversarial_diffuse_slab,
    adversarial_slab,
    diffuse_band_edges,
)

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


# ---------------------------------------------------------------------------
# The cull kernels' keep mask (`cull_keep_plain`): every pair it drops has
# zero terms, so the masked plain versions are the plain versions bit for bit
# on member rows.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def slabs(case: str):
    """(nchunkp, lambda rows, delta rows, pStar slab, lambda slab, member) of
    `port(case)`, the delta side fed the JAX lambda as there."""
    spec, dyn, fr, _, member, cells, _ = frame(case)
    got = port(case)
    jlam = torch.from_numpy(pallas(case)["lam"].copy())
    rows_l = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], fr.state.mass], dim=1)
    rows_d = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], jlam], dim=1)
    return got["wins"]["nchunkp"], rows_l, rows_d, got["cands"], got["lamc"], member


@pytest.mark.parametrize("case", sorted(CASES))
def test_culled_plain_equals_plain(case):
    spec = frame(case)[0]
    nchunkp, rows_l, rows_d, cands, lamc, member = slabs(case)
    keep = p2.cull_keep_plain(nchunkp, rows_l, member, cands, spec.h)
    assert keep.shape == (nchunkp.shape[0], WCAP)
    defined = torch.from_numpy(defined_columns(nchunkp.numpy())).reshape(keep.shape)
    assert not bool((keep & ~defined).any())
    assert 0 < int(keep.sum()) < int(defined.sum())
    lam = p2.lambda2_plain(nchunkp, rows_l, cands, spec.h)
    lam_c = p2.lambda2_plain(nchunkp, rows_l, cands, spec.h, keep=keep)
    assert torch.equal(lam_c[member], lam[member])
    dp = p2.delta2_plain(nchunkp, rows_d, cands, lamc, spec.h)
    dp_c = p2.delta2_plain(nchunkp, rows_d, cands, lamc, spec.h, keep=keep)
    assert torch.equal(dp_c[:, member], dp[:, member])
    assert float(dp[:, member].abs().max()) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_culled_plain_matches_jax(case):
    spec, dyn, fr, _, member, *_ = frame(case)
    st, want = fr.state, pallas(case)
    nchunkp, rows_l, rows_d, cands, lamc, _ = slabs(case)
    keep = p2.cull_keep_plain(nchunkp, rows_l, member, cands, spec.h)
    lam = p2.lambda2_plain(nchunkp, rows_l, cands, spec.h, keep=keep)
    lam = torch.where((st.ptype == p2.FLUID) & st.alive & member, lam, 0.0)
    np.testing.assert_allclose(lam.numpy(), want["lam"], atol=1e-6, rtol=1e-5)
    dp = p2.delta2_plain(nchunkp, rows_d, cands, lamc, spec.h, keep=keep)
    moved = ph.clamp_to_bounds(fr.pstar, dp, st.ptype, st.alive & member,
                               torch.tensor(spec.scale, dtype=torch.float32),
                               dyn["min_bound"], dyn["max_bound"])
    np.testing.assert_allclose(moved.numpy(), want["moved"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", ADVERSARIAL_SEEDS)
def test_cull_keeps_every_nonzero_pair(seed):
    """On `adversarial_slab`, every (member row, column) pair with a nonzero
    lambda or delta term is kept, and every dropped pair has zero terms even
    under the kernels' worst rounding: r2 from any contraction (3 roundings
    of |d|^2), rsqrtf 2 ulp low and the product rounded once more."""
    h = float(np.float32(1.3))
    c = p2.PairConstants.of(h)
    nchunkp, rows, member, cands, lamc = adversarial_slab(h, seed)
    keep = p2.cull_keep_plain(nchunkp, rows, member, cands, h)
    nsub, wcap = keep.shape
    d = p2._row_diffs(rows.reshape(nsub, p2.SUB, 4), slice(0, nsub),
                      cands[1:].reshape(3, nsub, wcap))
    r2 = torch.clamp(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], min=c.eps2)
    u = torch.rsqrt(r2)
    tt = torch.clamp(c.hh - r2, min=0.0)
    t2 = torch.clamp(c.h - r2 * u, min=0.0)
    xq = (tt * tt * tt) * c.xqf
    lam_a = rows[:, 3].reshape(nsub, p2.SUB, 1)
    factor = (lam_a + lamc.reshape(nsub, 1, wcap) + c.corr_k * (xq * xq) ** 2) * c.rho_recip
    terms = [tt, t2, (t2 * t2 * u) * c.skf * factor]
    pairs = member.reshape(nsub, p2.SUB, 1) & torch.ones_like(keep)[:, None, :]
    kept = keep[:, None, :].expand_as(pairs)
    for term in terms:
        assert not bool((pairs & ~kept & (term != 0)).any())
    d64 = d.double()
    low = (d64 * d64).sum(0) * (1.0 - 2.0 ** -24) ** 3
    dropped = pairs & ~kept
    assert bool((low[dropped] >= c.hh).all())
    assert bool((low[dropped].sqrt() * (1 - 2.0 ** -22) * (1 - 2.0 ** -24) >= c.h).all())
    # the seeded columns straddle both the cut-off and the keep threshold
    rel = r2 / c.hh - 1.0
    near = (rel.abs() < 2.0 ** -18) & pairs
    assert bool((near & dropped).any()) and bool((near & kept & (tt == 0)).any())
    assert bool((pairs & kept & (tt > 0) & (rel > -2.0 ** -19)).any())
    assert not bool(keep[:, 448:].any())


def test_kept_pairs_at_dam32k():
    """At dam_break(32_000, 3)'s sort-time state, the cull kernels run the
    pair chain for no fewer pairs than lie within h and fewer than the
    slab holds."""
    from pbf_sph_tpu_torch.tools.bench_phases import grown_plan

    spec, fr, _ = dam32k()
    cells, member = decode_key(fr.index.key, spec.grid)
    phases, wins, *_ = grown_plan(spec, fr.index)
    nchunkp = wins["nchunkp"]
    cands = phases.compact_pstar(wins, fr.pstar, member)
    rows = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], fr.state.mass], dim=1)
    hh = p2.PairConstants.of(spec.h).hh
    a = rows.reshape(-1, p2.SUB, 4)
    within = 0
    for tb, (pc,) in p2._slab_blocks(nchunkp, (cands,)):
        d = p2._row_diffs(a, tb, pc[1:4])
        near = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) < hh
        within += int((near & member.reshape(-1, p2.SUB)[tb, :, None]).sum())
    spairs = p2.slab_pairs(wins)
    assert 0 < within <= p2.kept_pairs(nchunkp, rows, member, cands, spec.h) < spairs


# ---------------------------------------------------------------------------
# The diffuse2 cull kernel's keep mask (`diffuse_keep_plain`): every column
# it drops adds +0 to each member row's sums, so the masked plain version is
# the plain version bit for bit on member rows.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def diffuse_slabs(case: str):
    """(nchunkp, acl, colour slab, [w, bcl] slab) of `port(case)`'s plan."""
    spec, dyn, fr, _, member, cells, _ = frame(case)
    st, wins = fr.state, port(case)["wins"]
    cl, wpack = p2.diffuse_packs(cells, member, st.ptype, st.alive, spec.grid.dims)
    return (wins["nchunkp"], cl, p2.compact_plain(wins, st.colour),
            p2.compact_plain(wins, wpack))


def band_accepts(nchunkp, acl, member, cands_w, dims):
    """(nsub, SUB, wcap) bool: the (member row, defined column) pairs whose
    band test passes with w != 0, from the cell ids in float64."""
    _, ny, nz = dims
    nsub = nchunkp.shape[0]
    wcap = cands_w.shape[1] // nsub
    w, b = cands_w.double().reshape(2, nsub, 1, wcap)
    e = (b - acl.double().reshape(nsub, p2.SUB, 1)).abs()
    g1 = torch.minimum((e - ny * nz).abs(), e)
    g2 = torch.minimum((g1 - nz).abs(), g1)
    defined = torch.arange(wcap) < nchunkp.long()[:, None, None] * p2.WCOL
    return (g2 <= 1) & (w != 0) & defined & member.reshape(nsub, p2.SUB, 1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_diffuse_culled_plain_equals_plain(case):
    spec, _, _, _, member, *_ = frame(case)
    nchunkp, cl, cands_c, cands_w = diffuse_slabs(case)
    dims = spec.grid.dims
    keep = p2.diffuse_keep_plain(nchunkp, cl, member, cands_w, dims)
    assert keep.shape == (nchunkp.shape[0], WCAP)
    defined = torch.from_numpy(defined_columns(nchunkp.numpy())).reshape(keep.shape)
    assert not bool((keep & ~defined).any())
    assert 0 < int(keep.sum()) < int(defined.sum())
    accepted = band_accepts(nchunkp, cl, member, cands_w, dims).any(1)
    assert not bool((accepted & ~keep).any())
    sums = p2.diffuse2_plain(nchunkp, cl, cands_c, cands_w, dims)
    culled = p2.diffuse2_plain(nchunkp, cl, cands_c, cands_w, dims, keep=keep)
    assert torch.equal(culled[:, member], sums[:, member])
    assert float(sums[4][member].max()) > 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_diffuse_culled_plain_matches_jax(case):
    spec, dyn, fr, _, member, *_ = frame(case)
    st, want = fr.state, pallas(case)
    nchunkp, cl, cands_c, cands_w = diffuse_slabs(case)
    keep = p2.diffuse_keep_plain(nchunkp, cl, member, cands_w, spec.grid.dims)
    sums = p2.diffuse2_plain(nchunkp, cl, cands_c, cands_w, spec.grid.dims, keep=keep)
    colour = ph.mix_colour(st.colour, sums, st.ptype, st.alive & member, dyn["dt"])
    np.testing.assert_allclose(colour.numpy(), want["colour"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", ADVERSARIAL_SEEDS)
def test_diffuse_keep_holds_every_accepted_column(seed):
    """On `adversarial_diffuse_slab`: every column
    that a member row's band test accepts with w != 0 is kept, at each edge
    of the band, at cells 0 and ncells - 1, across the x and y boundaries;
    all-zero slots, non-member slots, the fill and the sub-block with no
    member row are dropped; the masked sums are the sums bit for bit on
    member rows."""
    nchunkp, acl, member, cands_c, cands_w = adversarial_diffuse_slab(seed)
    nsub, wcap = nchunkp.shape[0], cands_w.shape[1] // nchunkp.shape[0]
    accepted = band_accepts(nchunkp, acl, member, cands_w, DIFFUSE_DIMS)
    # the slab reaches every edge of the band and the grid's two end cells
    b = cands_w[1].reshape(nsub, 1, wcap)
    dist = (b - acl.reshape(nsub, p2.SUB, 1)).abs()
    inside, outside = diffuse_band_edges(DIFFUSE_DIMS)
    for e in inside:
        assert bool((accepted & (dist == e)).any()), e
    w = cands_w[0].reshape(nsub, 1, wcap)
    for e in outside:
        assert bool(((dist == e) & (w == 1) & member.reshape(nsub, p2.SUB, 1)).any()), e
        assert not bool((accepted & (dist == e)).any()), e
    rows_at = acl.reshape(nsub, p2.SUB, 1).expand_as(accepted)
    ncells = int(np.prod(DIFFUSE_DIMS))
    assert bool(accepted[rows_at == 0].any()) and bool(accepted[rows_at == ncells - 1].any())
    sums = p2.diffuse2_plain(nchunkp, acl, cands_c, cands_w, DIFFUSE_DIMS)
    keep = p2.diffuse_keep_plain(nchunkp, acl, member, cands_w, DIFFUSE_DIMS)
    assert not bool((accepted.any(1) & ~keep).any())
    for dropped in (DIFFUSE_ZERO_SLOTS, DIFFUSE_SENTINEL_SLOTS, slice(448, wcap)):
        assert not bool(keep[:, dropped].any())
    assert not bool(keep[3].any())
    culled = p2.diffuse2_plain(nchunkp, acl, cands_c, cands_w, DIFFUSE_DIMS, keep=keep)
    assert torch.equal(culled[:, member], sums[:, member])
    # the slot test drops columns with w != 0 too: whole slots outside the
    # band when the columns are sorted
    if seed % 2:
        live = (cands_w[0].reshape(nsub, wcap) == 1)[:3, 40:448]
        assert bool((live & ~keep[:3, 40:448]).any())
    assert float(sums[4][member].max()) > 1


def test_diffuse_kept_pairs_at_dam32k():
    """At dam_break(32_000, 3)'s sort-time state, the diffuse2 cull kernel
    runs the sums for no fewer pairs than its member rows count (the 27-cell
    neighbours with w 1) and fewer than the slab holds."""
    from pbf_sph_tpu_torch.tools.bench_phases import grown_plan

    spec, fr, _ = dam32k()
    st, dims = fr.state, spec.grid.dims
    cells, member = decode_key(fr.index.key, spec.grid)
    phases, wins, *_ = grown_plan(spec, fr.index)
    nchunkp = wins["nchunkp"]
    cl, wpack = p2.diffuse_packs(cells, member, st.ptype, st.alive, dims)
    cands_w = p2.compact_plain(wins, wpack)
    counted = int(ph.diffuse_plain(fr.index, st.colour, ph.nonobstacle(st.ptype, st.alive))
                  [4][member].sum())
    kept = p2.diffuse_kept_pairs(nchunkp, cl, member, cands_w, dims)
    assert 0 < counted <= kept < p2.slab_pairs(wins)
