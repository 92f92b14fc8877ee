"""The port's tiled lambda/delta (`ops/tiles.py`) against the JAX package.

`PallasPhases(capacity, grid, h, 1024, interpret=True, sub, mxu)` runs the
Pallas `sub`/`mxu` variants in interpret mode on the CPU; the port's
`PbfPhases(h, sub, mxu)` runs the tile plain versions there.  Both get the
sort-time state of `test_torch_phases.py`'s two cases.

Tolerances as in `test_torch_phases.py`: lambda atol 1e-6, rtol 1e-5
(`test_pallas_interpret.py` holds the Pallas lambda to its per-pair oracle
so); pStar after one delta phase and the clamp atol 1e-5 in simulation units
(fp32 sums in another order; the port's centred r2 is rounded from fp64,
the Pallas one accumulated in fp32).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbf_sph_tpu.models.jax_solver import JaxSolver
from pbf_sph_tpu.ops.pallas_pbf import PallasPhases
from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
from pbf_sph_tpu_torch.core.types import Scene
from pbf_sph_tpu_torch.models.torch_solver import (
    TorchSolver,
    advect_and_sort,
    dyn_params_of,
)
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.ops import tiles as tl
from pbf_sph_tpu_torch.ops.grid import decode_key

CASES = {
    # the end-to-end parity scene, capacity 1024
    "2cubes": (700, 2, 500.0),
    # sparse particles on a 9^3-cell grid: tiles span many cells and their
    # windows overlap before the coverage scan
    "sparse": (600, 2, 2500.0),
}
SWEEP = [(sub, mxu) for sub in (16, 32, 64) for mxu in (False, True)]


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
def frame(case: str):
    mc, cfg, xs = simple_config_with_2_cubes(*CASES[case])
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    assert spec.capacity == 1024
    dyn = dyn_params_of(cfg, device="cpu")
    fr = advect_and_sort(spec, state, dyn, scn)
    jspec = JaxSolver(h=cfg.h, use_pallas=True).make_spec(cfg, Scene(), spec.capacity)
    assert jspec.grid.extent == spec.grid.extent
    return spec, dyn, fr, jspec.grid


@functools.lru_cache(maxsize=None)
def pallas(case: str, sub: int, mxu: bool):
    """(lambda, pStar after delta) of the Pallas variant, as numpy."""
    spec, dyn, fr, jgrid = frame(case)
    st = fr.state
    phases = PallasPhases(spec.capacity, jgrid, spec.h, spec.capacity,
                          interpret=True, sub=sub, mxu=mxu)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    wins, ovf = phases.plan_frame(j(fr.index.key), j(fr.index.table))
    assert int(ovf) == 0
    cells, member = decode_key(fr.index.key, spec.grid)
    memberf, cells = j(member.float()), tuple(j(c) for c in cells)
    lam = phases.lambda_phase(wins, j(fr.pstar), j(st.mass), memberf, j(st.ptype),
                              j(st.alive), cells)
    moved = phases.delta_phase(
        wins, j(fr.pstar), lam, memberf, j(st.ptype), j(st.alive),
        jnp.float32(spec.scale), j(dyn["min_bound"]), j(dyn["max_bound"]), cells)
    return np.asarray(lam), np.asarray(moved)


@pytest.mark.parametrize("sub", tl.TILE_SUBS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_windows_disjoint_and_covering(case, sub):
    spec, dyn, fr, _ = frame(case)
    tiles = tl.plan_tiles(fr.index, sub).long()
    n = spec.capacity
    assert tiles.shape == (n // sub, 9, 2)
    lo, hi = tiles[..., 0], tiles[..., 1]
    assert bool((hi >= lo).all()) and bool((lo[:, 1:] >= hi[:, :-1]).all())
    # every row's own nine ranges lie inside its tile's windows
    covered = torch.zeros((n // sub, n + 1), dtype=torch.int64)
    for s in range(9):
        covered.scatter_add_(1, lo[:, s:s + 1], torch.ones_like(lo[:, :1]))
        covered.scatter_add_(1, hi[:, s:s + 1], -torch.ones_like(lo[:, :1]))
    inside = torch.cumsum(covered, 1)[:, :n]
    assert int(inside.max()) <= 1  # disjoint: no candidate twice
    prefix = torch.cat([torch.zeros((n // sub, 1), dtype=torch.int64),
                        torch.cumsum(inside, 1)], 1)
    rlo, rhi = ph.neighbour_ranges(fr.index)
    tile_of = torch.arange(n) // sub
    for s in range(9):
        got = prefix[tile_of, rhi[s]] - prefix[tile_of, rlo[s]]
        assert torch.equal(got, rhi[s] - rlo[s])
    per_row = int((rhi - rlo).sum())
    assert tl.tile_pairs(tiles, sub) >= per_row > 0


@pytest.mark.parametrize("sub,mxu", SWEEP)
@pytest.mark.parametrize("case", sorted(CASES))
def test_lambda_matches_pallas_variant(case, sub, mxu):
    spec, dyn, fr, _ = frame(case)
    st = fr.state
    want, _ = pallas(case, sub, mxu)
    phases = ph.PbfPhases(spec.h, sub=sub, mxu=mxu)
    got = phases.lambda_phase(fr.index, fr.pstar, st.mass, st.ptype, st.alive)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    assert phases.launches == {"diffuse": 0, "diffuse_cell_sums": 0, "diffuse_cells": 0,
                               "lambda": 0, "delta": 0, "lambda_tile": 0, "delta_tile": 0}


@pytest.mark.parametrize("sub,mxu", SWEEP)
@pytest.mark.parametrize("case", sorted(CASES))
def test_delta_matches_pallas_variant(case, sub, mxu):
    spec, dyn, fr, _ = frame(case)
    st = fr.state
    lam, want = pallas(case, sub, mxu)
    phases = ph.PbfPhases(spec.h, sub=sub, mxu=mxu)
    got = phases.delta_phase(
        fr.index, fr.pstar, torch.from_numpy(lam.copy()), st.ptype, st.alive,
        torch.tensor(spec.scale, dtype=torch.float32), dyn["min_bound"],
        dyn["max_bound"])
    assert np.abs(want - fr.pstar.numpy()).max() > 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sub8_tiles_match_per_row_phases(case, mxu):
    """sub 8, instantiated on the card but outside the sweep, against the
    per-row plain versions."""
    spec, dyn, fr, _ = frame(case)
    st, h = fr.state, spec.h
    tiles = tl.plan_tiles(fr.index, 8)
    lam = tl.lambda_tile_plain(tiles, fr.index, h, fr.pstar, st.mass, 8, mxu)
    torch.testing.assert_close(lam, ph.lambda_plain(fr.index, h, fr.pstar, st.mass),
                               atol=1e-6, rtol=1e-5)
    dp = tl.delta_tile_plain(tiles, fr.index, h, fr.pstar, lam, 8, mxu)
    torch.testing.assert_close(dp, ph.delta_plain(fr.index, h, fr.pstar, lam),
                               atol=1e-5, rtol=0)


def test_sub_is_checked():
    with pytest.raises(ValueError, match="multiple of 8"):
        ph.PbfPhases(0.1, sub=12)
    with pytest.raises(ValueError, match="multiple of 8"):
        tl.check_sub(48)
    assert ph.PbfPhases(0.1, mxu=True).plan.sub == 64
    assert ph.PbfPhases(0.1).plan is None


# tools/precision_centered.py: a settled-like jittered lattice in simulation
# units, spacing h/2, at ~8 units from the origin (the 1M dam-break's range)
H = 0.1


def _lattice():
    rng = np.random.default_rng(7)
    grid = np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pts = grid * (H / 2) + 8.0 + rng.uniform(-0.01, 0.01, grid.shape)
    rng.shuffle(pts)
    a = pts[:64]
    b = pts[(np.abs(pts - a.mean(0)) < 2.5 * H).all(1)]
    return a, b


def _rho_grad(r2, d):
    """poly6 sum and spiky-gradient sum per row, in r2's precision."""
    p6 = np.maximum(H * H - r2, 0.0) ** 3
    r = np.sqrt(np.maximum(r2, 1e-16))
    sg = np.where(r2 > 1e-16, np.maximum(H - r, 0.0) ** 2 / r, 0.0)
    return p6.sum(1), (d * sg[None]).sum(2)


@pytest.mark.parametrize("variant", ["centred", "uncentred"])
def test_centred_r2_precision(variant):
    """Variant B of the precision study (centred r2 accumulated in fp32, as
    the Pallas MXU kernel does) stays near an fp64 per-pair oracle; variant
    D (uncentred) loses digits to the |a||b| cancellation.  The port's own
    route (fp64 accumulation) is as good as per-pair fp64 rounded to fp32."""
    a, b = _lattice()
    d64 = a.T[:, :, None] - b.T[:, None, :]
    rho64, grad64 = _rho_grad((d64 * d64).sum(0), d64)

    a32 = torch.from_numpy(a.T.astype(np.float32))
    b32 = torch.from_numpy(b.T.astype(np.float32))
    c = a32.double().mean(1, keepdim=True).float() if variant == "centred" else 0.0
    ac, bc = a32 - c, b32 - c
    d32 = (ac[:, :, None] - bc[:, None, :]).double().numpy()

    def err(acc):
        r2 = tl.centred_r2(ac, bc, acc).double().numpy()
        rho, grad = _rho_grad(r2, d32)
        return (np.abs(rho - rho64).max() / np.abs(rho64).max(),
                np.abs(grad - grad64).max() / np.abs(grad64).max())

    # what is left is the fp32 rounding of the inputs at |a| ~ 8 (~1e-5)
    e_rho, e_grad = err(torch.float32)
    port_rho, port_grad = err(torch.float64)
    assert port_rho < 1e-4 and port_grad < 1e-4
    if variant == "centred":
        assert e_rho < 1e-4 and e_grad < 1e-4
    else:
        # the uncentred fp32 product loses two more digits
        assert e_rho > 1e-3 and e_grad > 1e-3
