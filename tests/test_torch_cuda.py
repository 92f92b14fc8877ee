"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: without a CUDA device every test skips.  On a machine with
one (and without jax, whose CPU setup `conftest.py` makes), run
`python -m pytest tests/test_torch_cuda.py --noconftest -q`.

Tolerances: diffuse sums and count exact (the plain version sums in the
kernel's order); lambda atol 1e-6, rtol 1e-5; pStar after one delta phase
atol 1e-5 in simulation units (the kernel contracts to FMAs and sums in
another order; the tile kernels' fp64 tensor-core r2 rounds as the plain
version's fp64 r2 does); MC field count exact (the kernel rounds the distances as
the plain version does), sums rtol 1e-4, atol 1e-3.
"""

import pytest
import torch

from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.types import FLUID, Scene
from pbf_sph_tpu_torch.models.torch_solver import (
    TorchSolver,
    advect_and_sort,
    dyn_params_of,
    solve_frame,
)
from pbf_sph_tpu_torch.ops import mc_field as mf
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.ops import tiles as tl

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mc, cfg, xs = dam_break(32_000, solver_iter=3)
    solver = TorchSolver(h=cfg.h, device="cuda")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, device="cuda")
    return spec, dyn, advect_and_sort(spec, state, dyn, scn)


def test_diffuse_kernel_matches_plain(card_frame):
    spec, dyn, fr = card_frame
    st = fr.state
    nonobs = ph.nonobstacle(st.ptype, st.alive)
    got = ph.diffuse_kernel(fr.index, st.colour, nonobs)
    want = ph.diffuse_plain(fr.index, st.colour, nonobs)
    assert torch.equal(got, want)
    assert float(got[4].max()) > 1


def test_lambda_kernel_matches_plain(card_frame):
    spec, dyn, fr = card_frame
    st = fr.state
    got = ph.lambda_kernel(fr.index, spec.h, fr.pstar, st.mass)
    want = ph.lambda_plain(fr.index, spec.h, fr.pstar, st.mass)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_delta_kernel_matches_plain(card_frame):
    spec, dyn, fr = card_frame
    st = fr.state
    lam = ph.lambda_kernel(fr.index, spec.h, fr.pstar, st.mass)
    lam = torch.where((st.ptype == FLUID) & st.alive, lam, 0.0)
    scale = torch.full((), spec.scale, device="cuda")
    moved = [
        ph.clamp_to_bounds(fr.pstar, delta(fr.index, spec.h, fr.pstar, lam),
                           st.ptype, st.alive, scale, dyn["min_bound"], dyn["max_bound"])
        for delta in (ph.delta_kernel, ph.delta_plain)
    ]
    torch.testing.assert_close(moved[0], moved[1], atol=1e-5, rtol=0)


def test_wrappers_count_kernel_launches(card_frame):
    spec, dyn, fr = card_frame
    st = fr.state
    phases = ph.PbfPhases(spec.h)
    colour = phases.diffuse(fr.index, st.colour, st.ptype, st.alive, dyn["dt"])
    lam = phases.lambda_phase(fr.index, fr.pstar, st.mass, st.ptype, st.alive)
    phases.delta_phase(fr.index, fr.pstar, lam, st.ptype, st.alive,
                       torch.full((), spec.scale, device="cuda"),
                       dyn["min_bound"], dyn["max_bound"])
    torch.cuda.synchronize()
    assert colour.is_cuda
    assert phases.launches == {"diffuse": 1, "lambda": 1, "delta": 1}


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("sub", tl.TILE_SUBS)
def test_tile_kernels_match_plain(card_frame, sub, mxu):
    spec, dyn, fr = card_frame
    st, h = fr.state, spec.h
    tiles = tl.plan_tiles(fr.index, sub)
    lam_k = tl.lambda_tile_kernel(tiles, fr.index, h, fr.pstar, st.mass, sub, mxu)
    lam_p = tl.lambda_tile_plain(tiles, fr.index, h, fr.pstar, st.mass, sub, mxu)
    torch.testing.assert_close(lam_k, lam_p, atol=1e-6, rtol=1e-5)
    lam = torch.where((st.ptype == FLUID) & st.alive, lam_k, 0.0)
    scale = torch.full((), spec.scale, device="cuda")
    moved = [
        ph.clamp_to_bounds(fr.pstar, delta(tiles, fr.index, h, fr.pstar, lam, sub, mxu),
                           st.ptype, st.alive, scale, dyn["min_bound"], dyn["max_bound"])
        for delta in (tl.delta_tile_kernel, tl.delta_tile_plain)
    ]
    torch.testing.assert_close(moved[0], moved[1], atol=1e-5, rtol=0)


def test_tile_wrappers_count_kernel_launches(card_frame):
    spec, dyn, fr = card_frame
    st = fr.state
    phases = ph.PbfPhases(spec.h, sub=32, mxu=True)
    lam = phases.lambda_phase(fr.index, fr.pstar, st.mass, st.ptype, st.alive)
    phases.delta_phase(fr.index, fr.pstar, lam, st.ptype, st.alive,
                       torch.full((), spec.scale, device="cuda"),
                       dyn["min_bound"], dyn["max_bound"])
    torch.cuda.synchronize()
    assert phases.launches == {"diffuse": 0, "lambda": 0, "delta": 0,
                               "lambda_tile": 1, "delta_tile": 1}
    with pytest.raises(ValueError, match="instantiates"):
        tl.lambda_tile_kernel(tl.plan_tiles(fr.index, 128), fr.index, spec.h,
                              fr.pstar, st.mass, 128)


@pytest.fixture(scope="module")
def card_surface_frame():
    """The sort-time index and the finalised state of one dam-break frame
    with its surface (res 1.0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mc, cfg, xs = dam_break(32_000, solver_iter=3, surface=True)
    solver = TorchSolver(h=cfg.h, device="cuda")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, device="cuda")
    fr, st, _ = solve_frame(spec, solver.phases, state, dyn, scn)
    return spec, dyn, fr, st


def test_mc_field_kernel_matches_plain(card_surface_frame):
    spec, dyn, fr, st = card_surface_frame
    nonobs = ph.nonobstacle(st.ptype, st.alive)
    args = (fr.index, spec.surface, spec.h, spec.scale, st.position, st.colour,
            nonobs, fr.min_extent)
    got = mf.mc_field_kernel(*args)
    want = mf.mc_field_plain(*args)
    assert torch.equal(got[8], want[8])
    assert float(got[8].max()) > 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def test_mc_field_counts_kernel_launches(card_surface_frame):
    spec, dyn, fr, st = card_surface_frame
    field = mf.McField(spec.h)
    v, n, c = field(fr.index, spec.surface, spec.scale, st.position, st.colour,
                    st.ptype, st.alive, fr.min_extent, dyn["mc_particle_size"])
    torch.cuda.synchronize()
    assert v.is_cuda and n.shape == (3, v.shape[0]) and c.shape == (4, v.shape[0])
    assert field.launches == {"mc_field": 1}
