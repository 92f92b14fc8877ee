"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: without a CUDA device every test skips.  On a machine with
one (and without jax, whose CPU setup `conftest.py` makes), run
`python -m pytest tests/test_torch_cuda.py --noconftest -q`.

Tolerances: diffuse sums and count exact (the plain version sums in the
kernel's order); lambda atol 1e-6, rtol 1e-5; pStar after one delta phase
atol 1e-5 in simulation units (the kernel contracts to FMAs and sums in
another order; the tile kernels' fp64 tensor-core r2 rounds as the plain
version's fp64 r2 does); MC field count exact (the kernel rounds the distances as
the plain version does), sums rtol 1e-4, atol 1e-3; the main path's MC field
(row 4b, `csrc/mc_field_cells.cu`) against its plain version and row 4 with
the post-pass: v rtol 1e-4, atol 1e-3, n and c rtol/atol 1e-3 on the finite
active nodes, c NaN on the same elements (`micro_mc_field.cells_agree`; the
lanes of a node sum in another order than the plain version), and bit for
bit over two launches.  The v2 phases: slabs
bit for bit on the columns the compaction writes, lambda2 and delta2 as
lambda and delta, diffuse2 and its cull kernel count exact and sums atol
1e-6 (the plain version sums column by column in the kernel's order; the
cull kernel bit for bit the dense one on member rows).  The rate anchor's
kernels: issue tiles and body sums rtol 1e-5, atol 1e-6 (the kernel fuses
multiply-adds), the blocked body the same (rtol n eps on the tool's
inputs, whose n = 4096 like terms a row drift one way in a running fp32
sum) and bit for bit the body kernel (each row's pairs in the same order;
the two pair headers give the same bits wherever r2c >= eps^2 is normal),
rowfix λ atol 1e-9.  The window
micro-benchmark's kernels: λ rtol 5e-4, atol 1e-12 (λ is ~1e-7 and prod's
ci of 0.077 amplifies the sums' rounding ~14x; the kernel sums a chunk's
pairs in its own order); the blocked ones bit for bit prod's and guarded's
(each row's pairs in their order, the same pair code and epilogue).
The MC-field bisection's kernels: noop zero, rows bit for bit (the same
rounded ops), loops rtol 1e-5 with atol 1e-6 x max|value| (fp32 sums of
~1e7 in the kernel's order against a float64 sum).  The pair-chunk
micro-benchmark's kernels: chunk sums rtol 1e-5, atol 1e-9 (non-negative
fp32 terms, the kernel's fused order against torch's), the fma ceiling
rtol 1e-6 (both fuse each multiply-add).  The loop probes' kernels: exact
(the same fused FMAs, adds, multiplies and selects), e) rsqrt rtol 1e-6
(the card's rsqrtf against torch's on a contracting iteration).  The
dense-λ micro-benchmark's kernels: rtol 1e-5, atol 1e-5 x max|value| (sums
of mixed-sign terms in the kernel's order, a lane's columns and then a
warp-shuffle tree, against Pallas's per-column carries; d)/g)'s fp64
reduce against torch's float64 product).  The compaction building blocks:
rolls, part bodies and slices bit for bit with NaN in place (shuffles,
selects and copies of the same values; the part output NaN-filled on both
sides), the 4-chunk λ rtol 1e-5, atol 1e-5 x max|value| (as the dense-λ
kernels).  The op streams, dots and reshape: bit for bit (the same fused
multiply-adds, multiplies, selects, IEEE sqrt and divide and ordered FFMA
sums) in every CTA of the grid, but rsqrt rtol 1e-6 (MUFU.RSQ against
torch's rsqrt on a contracting chain).  The main path's λ/Δp kernels
(`csrc/pbf_cells.cu`) and their staged walk (`csrc/cells_staged.cu`): λ atol 1e-6, rtol 1e-5 and pStar atol 1e-5
against their plain versions and against the per-row kernels with the
wrappers' mask and clamp (the plain versions sum in the kernels' order with
their fused multiply-adds, so they agree to the bit on the card).  The main
path's diffuse kernels (`csrc/pbf_diffuse_cells.cu`): bit for bit their
plain versions (the same fp32 adds in the same order, the mix op by op), on
the frame as sorted and with obstacle and dead rows inside member runs;
colour atol 1e-6 and count exact beside the per-row path.
"""

import numpy as np

import pytest
import torch

from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
from pbf_sph_tpu_torch.core.types import FLUID, OBSTACLE, Scene
from pbf_sph_tpu_torch.models.torch_solver import (
    TorchSolver,
    advect_and_sort,
    dyn_params_of,
    solve_frame,
)
from pbf_sph_tpu_torch.ops import cells
from pbf_sph_tpu_torch.ops import diffuse_cells as dc
from pbf_sph_tpu_torch.ops import mc_field as mf
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.ops import tiles as tl
from pbf_sph_tpu_torch.ops.grid import GridSpec, decode_key
from pbf_sph_tpu_torch.tools import anchor_rate as ar
from pbf_sph_tpu_torch.tools import bench_cells as bc
from pbf_sph_tpu_torch.tools import micro_chunk as mch
from pbf_sph_tpu_torch.tools import micro_dense as md
from pbf_sph_tpu_torch.tools import micro_loop as ml
from pbf_sph_tpu_torch.tools import micro_mc_field as mcb
from pbf_sph_tpu_torch.tools import micro_roll as mr
from pbf_sph_tpu_torch.tools import micro_vpu as mv
from pbf_sph_tpu_torch.tools import micro_window as mw
from pbf_sph_tpu_torch.tools import phases2 as p2

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


def _mixed(st):
    """ptype and alive with a seeded 10% of the rows OBSTACLE and 5% dead,
    without a new sort: obstacle and dead rows inside member runs."""
    rng = np.random.default_rng(14)
    n = st.ptype.shape[0]
    obstacle = torch.from_numpy(rng.random(n) < 0.1).cuda()
    dead = torch.from_numpy(rng.random(n) < 0.05).cuda()
    return torch.where(obstacle, OBSTACLE, st.ptype).to(torch.int32), st.alive & ~dead


@pytest.mark.parametrize("variant", ["scene", "mixed"])
def test_diffuse_cells_kernels_match_plain(card_frame, variant):
    """The main path's diffuse kernels bit for bit their plain versions, and
    beside the per-row path (colour atol 1e-6, colour sums rtol 1e-5, count
    exact)."""
    spec, dyn, fr = card_frame
    st = fr.state
    ptype, alive = (st.ptype, st.alive) if variant == "scene" else _mixed(st)
    pack = dc.diffuse_cell_sums_kernel(fr.index, st.colour, ptype, alive)
    want_pack = dc.diffuse_cell_sums_plain(fr.index, st.colour, ptype, alive)
    assert torch.equal(pack, want_pack)
    got = dc.diffuse_cells_kernel(fr.index, pack, st.colour, ptype, alive, dyn["dt"])
    want = dc.diffuse_cells_plain(fr.index, pack, st.colour, ptype, alive, dyn["dt"])
    assert torch.equal(got, want)
    assert not torch.equal(got, st.colour)
    sums = ph.diffuse_plain(fr.index, st.colour, ph.nonobstacle(ptype, alive))
    cell_sums = dc.neighbour_sums_plain(fr.index, pack)
    assert torch.equal(cell_sums[4], sums[4])
    torch.testing.assert_close(cell_sums[:4], sums[:4], rtol=1e-5, atol=0)
    rows = ph.mix_colour(st.colour, sums, ptype, alive, dyn["dt"])
    torch.testing.assert_close(got, rows, atol=1e-6, rtol=0)


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


@pytest.mark.parametrize("staged", [False, True])
def test_cells_kernels_match_plain(card_frame, staged):
    """The main path's λ/Δp kernels, each walk, against their plain versions
    and against the per-row kernels with the wrappers' mask and clamp."""
    spec, dyn, fr = card_frame
    par = bc.parity(bc.Frame(spec, dyn, fr), staged)
    assert par["lambda_ok"] and par["pstar_err"] <= 1e-5
    assert par["packs_kept"] and par["finite"]
    assert par["lambda_rows_diff"] <= 1e-6 and par["pstar_rows_diff"] <= 1e-5


def test_solve_counts_cells_launches(card_frame):
    spec, dyn, fr = card_frame
    st = fr.state
    phases = ph.PbfPhases(spec.h)
    got = phases.solve(fr.index, fr.pstar, st.mass, st.ptype, st.alive, 2,
                       torch.full((), spec.scale, device="cuda"),
                       dyn["min_bound"], dyn["max_bound"])
    torch.cuda.synchronize()
    assert got.shape == (3, spec.capacity) and bool(torch.isfinite(got).all())
    assert phases.launches == {"diffuse": 0, "diffuse_cell_sums": 0, "diffuse_cells": 0,
                               "lambda": 0, "delta": 0, "lambda_cells": 2, "delta_cells": 2}
    with pytest.raises(ValueError, match="alias"):
        pack = torch.zeros((spec.capacity, 4), device="cuda")
        cells.lambda_cells_kernel(fr.index, spec.h, pack, (st.ptype == FLUID) & st.alive,
                                  pack)


def test_wrappers_count_kernel_launches(card_frame):
    spec, dyn, fr = card_frame
    st = fr.state
    phases = ph.PbfPhases(spec.h)
    colour = phases.diffuse(fr.index, st.colour, st.ptype, st.alive, dyn["dt"])
    rows = phases.diffuse_rows(fr.index, st.colour, st.ptype, st.alive, dyn["dt"])
    lam = phases.lambda_phase(fr.index, fr.pstar, st.mass, st.ptype, st.alive)
    phases.delta_phase(fr.index, fr.pstar, lam, st.ptype, st.alive,
                       torch.full((), spec.scale, device="cuda"),
                       dyn["min_bound"], dyn["max_bound"])
    torch.cuda.synchronize()
    assert colour.is_cuda and rows.is_cuda
    assert phases.launches == {"diffuse": 1, "diffuse_cell_sums": 1, "diffuse_cells": 1,
                               "lambda": 1, "delta": 1, "lambda_cells": 0, "delta_cells": 0}


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
    assert phases.launches == {"diffuse": 0, "diffuse_cell_sums": 0, "diffuse_cells": 0,
                               "lambda": 0, "delta": 0, "lambda_tile": 1, "delta_tile": 1}
    with pytest.raises(ValueError, match="instantiates"):
        tl.lambda_tile_kernel(tl.plan_tiles(fr.index, 128), fr.index, spec.h,
                              fr.pstar, st.mass, 128)


@pytest.fixture(scope="module")
def card_v2(card_frame):
    """The v2 phases, plan and pStar slab at the card frame."""
    spec, dyn, fr = card_frame
    cells, member = decode_key(fr.index.key, spec.grid)
    smax = p2.default_strip_capacity(spec.grid.dims, spec.capacity)
    phases = p2.PbfPhases2(spec.capacity, spec.grid, spec.h, smax, p2.default_wcap())
    wins, ovf = phases.plan_frame(fr.index.key, fr.index.table)
    assert int(ovf["strip_overflow"]) == int(ovf["wcap_overflow"]) == 0
    cands = phases.compact_pstar(wins, fr.pstar, member)
    return phases, wins, cands, cells, member


def _defined(wins, slab):
    """The slab columns below nchunkp * 128, as (F, columns)."""
    nsub = wins["nchunkp"].shape[0]
    col = torch.arange(slab.shape[1] // nsub, device=slab.device)
    return slab[:, (col < wins["nchunkp"][:, None] * p2.WCOL).reshape(-1)]


def test_compact_kernel_matches_plain(card_frame, card_v2):
    spec, dyn, fr = card_frame
    phases, wins, cands, cells, member = card_v2
    for packed in (fr.pstar, fr.state.mass.reshape(1, -1)):
        got = p2.compact_kernel(wins, packed.contiguous())
        want = p2.compact_plain(wins, packed.contiguous())
        assert torch.equal(_defined(wins, got), _defined(wins, want))


def test_lambda2_kernel_matches_plain(card_frame, card_v2):
    spec, dyn, fr = card_frame
    phases, wins, cands, cells, member = card_v2
    rows = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], fr.state.mass], dim=1)
    got = p2.lambda2_kernel(wins["nchunkp"], rows, cands, spec.h)
    want = p2.lambda2_plain(wins["nchunkp"], rows, cands, spec.h)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_delta2_kernel_matches_plain(card_frame, card_v2):
    spec, dyn, fr = card_frame
    phases, wins, cands, cells, member = card_v2
    st = fr.state
    lam = phases.lambda_phase(wins, cands, fr.pstar, st.mass, member, st.ptype, st.alive)
    lamc = p2.compact_kernel(wins, lam.reshape(1, -1))
    rows = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], lam], dim=1)
    scale = torch.full((), spec.scale, device="cuda")
    moved = [
        ph.clamp_to_bounds(fr.pstar, delta(wins["nchunkp"], rows, cands, lamc, spec.h),
                           st.ptype, st.alive & member, scale, dyn["min_bound"],
                           dyn["max_bound"])
        for delta in (p2.delta2_kernel, p2.delta2_plain)
    ]
    torch.testing.assert_close(moved[0], moved[1], atol=1e-5, rtol=0)


def test_diffuse2_kernel_matches_plain(card_frame, card_v2):
    spec, dyn, fr = card_frame
    phases, wins, cands, cells, member = card_v2
    st = fr.state
    cl, wpack = p2.diffuse_packs(cells, member, st.ptype, st.alive, spec.grid.dims)
    cands_c = p2.compact_kernel(wins, st.colour)
    cands_w = p2.compact_kernel(wins, wpack)
    got = p2.diffuse2_kernel(wins["nchunkp"], cl, cands_c, cands_w, spec.grid.dims)
    want = p2.diffuse2_plain(wins["nchunkp"], cl, cands_c, cands_w, spec.grid.dims)
    assert torch.equal(got[4], want[4]) and float(got[4].max()) > 1
    torch.testing.assert_close(got[:4], want[:4], atol=1e-6, rtol=0)


def test_phases2_wrappers_count_kernel_launches(card_frame, card_v2):
    spec, dyn, fr = card_frame
    phases, wins, cands, cells, member = card_v2
    st = fr.state
    phases.reset_launches()
    cands = phases.compact_pstar(wins, fr.pstar, member)
    lam = phases.lambda_phase(wins, cands, fr.pstar, st.mass, member, st.ptype, st.alive)
    lamc = phases.compact_lam(wins, lam)
    phases.delta_phase(wins, cands, lamc, fr.pstar, lam, member, st.ptype, st.alive,
                       torch.full((), spec.scale, device="cuda"), dyn["min_bound"],
                       dyn["max_bound"])
    phases.diffuse(wins, st.colour, cells, member, st.ptype, st.alive, dyn["dt"])
    torch.cuda.synchronize()
    assert phases.launches == {"compact": 4, "lambda2": 1, "delta2": 1, "diffuse2": 1}


def test_cull_kernels_equal_dense_kernels(card_frame, card_v2):
    """The cull kernels give the dense kernels' raw λ and Δp bit for bit on
    every member row, and their plain versions' at 3d's tolerances."""
    spec, dyn, fr = card_frame
    phases, wins, cands, cells, member = card_v2
    st, nchunkp = fr.state, wins["nchunkp"]
    rows = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], st.mass], dim=1)
    lam = p2.lambda2_cull_kernel(nchunkp, rows, cands, member, spec.h)
    assert torch.equal(lam[member], p2.lambda2_kernel(nchunkp, rows, cands, spec.h)[member])
    want = p2.lambda2_plain(nchunkp, rows, cands, spec.h)
    torch.testing.assert_close(lam[member], want[member], atol=1e-6, rtol=1e-5)
    lam = torch.where((st.ptype == FLUID) & st.alive & member, lam, 0.0)
    lamc = p2.compact_kernel(wins, lam.reshape(1, -1))
    rows = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], lam], dim=1)
    dp = p2.delta2_cull_kernel(nchunkp, rows, cands, lamc, member, spec.h)
    dense = p2.delta2_kernel(nchunkp, rows, cands, lamc, spec.h)
    assert torch.equal(dp[:, member], dense[:, member])
    want = p2.delta2_plain(nchunkp, rows, cands, lamc, spec.h)
    torch.testing.assert_close(dp[:, member], want[:, member], atol=1e-5, rtol=0)


def adversarial_slab(h: float, seed: int):
    """Two sub-blocks of 32 rows (a few non-members, parked far away) and a
    512-column slab each: candidates at r^2 = h^2 (1 +- k 2^-23), k <= 8,
    from a member row, and at the keep threshold h^2 (1 + KEEP_MARGIN)
    +- k 2^-23, in seeded directions; columns inside h; non-member slots
    (x = SENTINEL) and SENTINEL fill.  Returns (nchunkp, rows, member,
    cands, lamc) on the CPU."""
    rng = np.random.default_rng(seed)
    nsub, wcap = 2, 512
    n = nsub * p2.SUB
    pos = rng.uniform(0.0, 2.0 * h, (n, 3))
    member = np.ones(n, bool)
    member[[5, 31, 40, 63]] = False
    pos[~member] = 50.0 * h
    rows = np.concatenate([pos, rng.uniform(0.5, 1.5, (n, 1))], axis=1).astype(np.float32)
    ks = np.arange(-8, 9) * 2.0 ** -23
    scales = np.concatenate([1.0 + ks, 1.0 + ph.KEEP_MARGIN + ks])
    cands = np.empty((4, nsub, wcap), np.float32)
    cands[0] = 1.0
    for t in range(nsub):
        owners = np.flatnonzero(member[t * p2.SUB:(t + 1) * p2.SUB]) + t * p2.SUB
        v = rng.normal(size=(wcap, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        r = h * np.sqrt(rng.choice(scales, wcap))
        r[:32] = rng.uniform(0.0, h, 32)                   # inside h
        x = rows[rng.choice(owners, wcap), :3].astype(np.float64) + v * r[:, None]
        cands[1:, t] = x.T.astype(np.float32)
    cands[1, :, 40:48] = p2.SENTINEL                       # non-member slots
    cands[1:, :, 448:] = p2.SENTINEL                       # the fill
    lamc = rng.uniform(-2.0, 0.0, (1, nsub * wcap)).astype(np.float32)
    rows[:, 3] = np.where(member, rows[:, 3], 0.0)
    return (torch.full((nsub,), wcap // p2.WCOL, dtype=torch.int32), torch.from_numpy(rows),
            torch.from_numpy(member), torch.from_numpy(cands.reshape(4, -1)),
            torch.from_numpy(lamc))


ADVERSARIAL_SEEDS = range(8)

# the grid of `adversarial_diffuse_slab`: nz 9, ny*nz 63, 378 cells
DIFFUSE_DIMS = (6, 7, 9)
DIFFUSE_SENTINEL_SLOTS = slice(32, 40)   # its non-member slots
DIFFUSE_ZERO_SLOTS = slice(0, 32)        # its in-band slots with w = 0 throughout


def diffuse_band_edges(dims):
    """(inside, outside): the cell-id distances |b - a| at the edges of the
    27-cell band that diffuse2's band test passes (0, 1, nz +- 1, ny*nz +- 1,
    ny*nz +- nz +- 1) and the ones just beyond them that it fails."""
    _, ny, nz = dims
    nynz = ny * nz
    centres = [nz, nynz - nz, nynz, nynz + nz]
    inside = [0, 1] + [c + d for c in centres for d in (-1, 1)]
    outside = [2] + [c + d for c in centres for d in (-2, 2)]
    return inside, outside


def adversarial_diffuse_slab(seed: int):
    """Four sub-blocks of 32 rows on `DIFFUSE_DIMS` and a 512-column
    [w, bcl] and colour slab each, for the diffuse2 cull kernel's keep mask.
    Rows (sorted cell ids, non-members at cell 0 as decoded): sub-block 0
    from cell 0, 1 across an x boundary (cell 2*ny*nz, also a y boundary),
    2 up to cell ncells - 1 with its last 6 rows non-members, 3 no member
    row.  Columns: 0-31 in-band cells with w = 0 (all-zero slots), 32-39
    non-member slots (w 0, SENTINEL), 40-77 a seeded member row's cell +- each
    `diffuse_band_edges` distance, 78-447 seeded member cells + a band offset
    + d, |d| <= 2, or (20%) a cell no member row of the sub-block accepts
    (w 1 in 85%; sorted by cell id for odd seeds, as a slab is, so that
    whole slots lie outside the band), 448-511 the SENTINEL fill; sub-block 0 holds
    cell 0 and sub-block 2 cell ncells - 1 with w 1.  Returns (nchunkp,
    acl, member, cands_c, cands_w) on the CPU."""
    rng = np.random.default_rng(seed)
    _, ny, nz = DIFFUSE_DIMS
    ncells = int(np.prod(DIFFUSE_DIMS))
    nsub, wcap, sub = 4, 512, p2.SUB
    cells = np.zeros((nsub, sub), np.int64)
    cells[0] = np.sort(rng.integers(0, 12, sub))
    cells[0, 0] = 0
    edge = 2 * ny * nz
    cells[1] = np.sort(rng.integers(edge - 12, edge + 12, sub))
    member = np.ones((nsub, sub), bool)
    member[2, -6:] = False
    member[3] = False
    cells[2, :-6] = np.sort(rng.integers(ncells - 14, ncells, sub - 6))
    cells[2, -7] = ncells - 1
    cells[~member] = 0
    offs = np.asarray(p2.band_offsets(DIFFUSE_DIMS))
    inside, outside = diffuse_band_edges(DIFFUSE_DIMS)
    dist = np.asarray(inside + outside)
    b = np.empty((nsub, wcap), np.int64)
    w = (rng.uniform(size=(nsub, wcap)) < 0.85).astype(np.float32)
    for t in range(nsub):
        rows = cells[t][member[t]] if member[t].any() else cells[t]
        a = rng.choice(rows, wcap)
        b[t] = a + offs[rng.integers(0, 9, wcap)] + rng.integers(-2, 3, wcap)
        b[t, :32] = a[:32] + offs[rng.integers(0, 9, 32)] + rng.integers(-1, 2, 32)
        e = np.concatenate([dist, dist])
        sign = np.repeat([1, -1], len(dist))
        up = a[40:40 + len(e)] + sign * e
        b[t, 40:40 + len(e)] = np.where((up >= 0) & (up < ncells), up,
                                        a[40:40 + len(e)] - sign * e)
        w[t, 40:40 + len(e)] = 1.0
        # cells no member row of the sub-block accepts
        band = (rows[:, None, None] + offs[None, :, None] + np.arange(-1, 2)).ravel()
        away = np.setdiff1d(np.arange(ncells), band)
        far = rng.uniform(size=wcap) < 0.2
        far[:40 + len(e)] = False
        b[t, far] = rng.choice(away, int(far.sum()))
    b = np.clip(b, 0, ncells - 1)
    b[0, 100], b[2, 100] = 0, ncells - 1
    w[0, 100] = w[2, 100] = 1.0
    if seed % 2:
        b[:, 78:448] = np.sort(b[:, 78:448], axis=1)
    w[:, DIFFUSE_ZERO_SLOTS] = 0.0
    bf = b.astype(np.float32)
    w[:, DIFFUSE_SENTINEL_SLOTS] = 0.0
    bf[:, DIFFUSE_SENTINEL_SLOTS] = p2.SENTINEL
    colours = rng.uniform(0.0, 1.0, (4, nsub, wcap)).astype(np.float32)
    w[:, 448:] = bf[:, 448:] = colours[:, :, 448:] = p2.SENTINEL
    return (torch.full((nsub,), wcap // p2.WCOL, dtype=torch.int32),
            torch.from_numpy(cells.reshape(-1).astype(np.float32)),
            torch.from_numpy(member.reshape(-1)),
            torch.from_numpy(colours.reshape(4, -1)),
            torch.from_numpy(np.stack([w, bf]).reshape(2, -1)))


def adversarial_tiles(h: float, seed: int):
    """A synthetic frame for the tile cull kernels: 120 members in one cell
    of a 3^3 grid, so that every tile's nine windows hold all of them in row
    order, and 8 non-members parked far away at the tail.  The members come
    in 15 groups of 8 consecutive rows, which are both a row block and a
    column block of every tile; a group is one point, or (every fourth) 8
    points 0.05 h / 7 apart on a seeded line, the first at its centre.
    Each group after the first sits from an earlier one in a seeded
    direction, with k a seeded integer in [1, 8] and u = 2^-23:
      4, 8, 12: from a seeded earlier group, 0.2-0.9 h away;
      2, 10 / 6, 14: from a seeded earlier group, at r^2 = h^2 (1 - k u) /
        h^2 (1 + k u), just inside / outside the cut-off;
      1, 5, 9, 13: from the group before (a line), at the keep threshold
        h^2 (1 + KEEP_MARGIN) +- k u;
      3, 7, 11: from the group before (a point), at h^2 (1 + KEEP_MARGIN)
        + (k + 1) u, where the block test, at the pairs' own distance,
        drops them.
    Returns (index, pstar (3, 128), mass, lam) on the CPU."""
    rng = np.random.default_rng(seed)
    n, groups, u = 128, 15, 2.0 ** -23
    centres = [rng.uniform(0.0, 2.0 * h, 3)]
    for i in range(1, groups):
        v = rng.normal(size=3)
        k = rng.integers(1, 9)
        r2 = {0: rng.uniform(0.2, 0.9) ** 2, 1: 1.0 + ph.KEEP_MARGIN + rng.choice([-k, k]) * u,
              2: 1.0 + (k if i % 8 == 6 else -k) * u,
              3: 1.0 + ph.KEEP_MARGIN + (k + 1) * u}[i % 4]
        parent = i - 1 if i % 2 else rng.integers(i)
        centres.append(centres[parent] + v / np.linalg.norm(v) * h * np.sqrt(r2))
    e = rng.normal(size=(groups, 3))
    e *= ((np.arange(groups) % 4 == 0) * 0.05 * h / 7 / np.linalg.norm(e, axis=1))[:, None]
    pos = np.asarray(centres)[:, None, :] + np.arange(8)[None, :, None] * e[:, None, :]
    pos = pos.reshape(-1, 3).astype(np.float32)
    pos = np.concatenate([pos, np.full((n - 8 * groups, 3), 50.0 * h, np.float32)])
    grid = GridSpec(extent=(2, 2, 2), maxz=0)
    key = np.full(n, 13, np.int32)                      # the centre cell
    key[8 * groups:] = grid.ncells + np.arange(n - 8 * groups)
    table = np.where(np.arange(grid.ncells + 1) <= 13, 0, 8 * groups).astype(np.int32)
    index = ph.CellIndex(grid, torch.from_numpy(key), torch.from_numpy(table))
    member = key < grid.ncells
    mass = np.where(member, rng.uniform(0.5, 1.5, n), 0.0).astype(np.float32)
    lam = np.where(member, rng.uniform(-2.0, 0.0, n), 0.0).astype(np.float32)
    return (index, torch.from_numpy(np.ascontiguousarray(pos.T)), torch.from_numpy(mass),
            torch.from_numpy(lam))


@pytest.mark.parametrize("seed", ADVERSARIAL_SEEDS)
def test_tile_cull_kernels_at_the_keep_boundary(seed):
    """On `adversarial_tiles`, whose blocks straddle r^2 = h^2 and the keep
    threshold: the tile cull kernels equal the dense ones bit for bit on
    every row (λ 1/CFM and Δp 0 on the non-members), at every sub on both
    r^2 routes, and the plain versions masked with `tile_keep_plain` (λ atol
    1e-6, rtol 1e-5; Δp rtol 1e-5 with atol 1e-6 x max|Δp|, as the v2 cull
    kernels' test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h = float(np.float32(1.3))
    index, pstar, mass, lam = adversarial_tiles(h, seed)
    index = ph.CellIndex(index.grid, index.key.cuda(), index.table.cuda())
    pstar, mass, lam = pstar.cuda(), mass.cuda(), lam.cuda()
    member = index.key < index.grid.ncells
    for sub in tl.TILE_SUBS:
        tiles = tl.plan_tiles(index, sub)
        for mxu in (False, True):
            args = (tiles, index, h, pstar)
            keep = tl.tile_keep_plain(tiles, index, pstar, sub, mxu, h)
            got = tl.lambda_tile_cull_kernel(*args, mass, sub, mxu)
            assert torch.equal(got, tl.lambda_tile_kernel(*args, mass, sub, mxu))
            want = tl.lambda_tile_plain(*args, mass, sub, mxu, keep=keep)
            torch.testing.assert_close(got[member], want[member], atol=1e-6, rtol=1e-5)
            got = tl.delta_tile_cull_kernel(*args, lam, sub, mxu)
            assert torch.equal(got, tl.delta_tile_kernel(*args, lam, sub, mxu))
            want = tl.delta_tile_plain(*args, lam, sub, mxu, keep=keep)[:, member]
            scale = float(want.abs().max())
            assert scale > 0
            torch.testing.assert_close(got[:, member], want, atol=1e-6 * scale, rtol=1e-5)


@pytest.mark.parametrize("seed", ADVERSARIAL_SEEDS)
def test_cull_kernels_at_the_keep_boundary(seed):
    """On `adversarial_slab`, whose columns straddle r^2 = h^2 and the keep
    threshold: the cull kernels equal the dense kernels bit for bit on every
    member row, and the plain versions masked with `cull_keep_plain` (λ
    atol 1e-6, rtol 1e-5; Δp rtol 1e-5 with atol 1e-6 x max|Δp|: sums of
    mixed-sign terms in the kernels' order against torch's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h = float(np.float32(1.3))
    nchunkp, rows, member, cands, lamc = (t.cuda() for t in adversarial_slab(h, seed))
    keep = p2.cull_keep_plain(nchunkp, rows, member, cands, h)
    lam = p2.lambda2_cull_kernel(nchunkp, rows, cands, member, h)
    assert torch.equal(lam[member], p2.lambda2_kernel(nchunkp, rows, cands, h)[member])
    want = p2.lambda2_plain(nchunkp, rows, cands, h, keep=keep)
    torch.testing.assert_close(lam[member], want[member], atol=1e-6, rtol=1e-5)
    dp = p2.delta2_cull_kernel(nchunkp, rows, cands, lamc, member, h)
    assert torch.equal(dp[:, member], p2.delta2_kernel(nchunkp, rows, cands, lamc, h)[:, member])
    want = p2.delta2_plain(nchunkp, rows, cands, lamc, h, keep=keep)[:, member]
    scale = float(want.abs().max())
    assert scale > 0
    torch.testing.assert_close(dp[:, member], want, atol=1e-6 * scale, rtol=1e-5)


def test_dense_phases2_count_kernel_launches(card_frame, card_v2):
    spec, dyn, fr = card_frame
    phases, wins, cands, cells, member = card_v2
    st = fr.state
    rows = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], st.mass], dim=1)
    dense = p2.DensePhases2(spec.h)
    lam = dense.lambda_raw(wins["nchunkp"], rows, cands)
    dense.delta_raw(wins["nchunkp"], rows, cands, p2.compact_kernel(wins, lam.reshape(1, -1)))
    cl, wpack = p2.diffuse_packs(cells, member, st.ptype, st.alive, spec.grid.dims)
    dense.diffuse_raw(wins["nchunkp"], cl, p2.compact_kernel(wins, st.colour),
                      p2.compact_kernel(wins, wpack), spec.grid.dims)
    torch.cuda.synchronize()
    assert dense.launches == {"lambda2": 1, "delta2": 1, "diffuse2": 1}


@pytest.fixture(scope="module", params=[(32_000, 3), (1_000_000, 6)], ids=["32k", "1m"])
def card_diffuse2(request):
    """The diffuse2 slabs at the sort-time state of dam_break(count, iters),
    the plan grown until it has no overflow: (dims, nchunkp, acl, member,
    colour slab, [w, bcl] slab)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pbf_sph_tpu_torch.tools.bench_phases import grown_plan

    count, iters = request.param
    mc, cfg, xs = dam_break(count, solver_iter=iters)
    solver = TorchSolver(h=cfg.h, device="cuda")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    fr = advect_and_sort(spec, state, dyn_params_of(cfg, device="cuda"), scn)
    st, dims = fr.state, spec.grid.dims
    cells, member = decode_key(fr.index.key, spec.grid)
    _, wins, *_ = grown_plan(spec, fr.index)
    cl, wpack = p2.diffuse_packs(cells, member, st.ptype, st.alive, dims)
    return (dims, wins["nchunkp"], cl, member, p2.compact_kernel(wins, st.colour),
            p2.compact_kernel(wins, wpack))


def test_diffuse2_cull_kernel_equals_dense_kernel(card_diffuse2):
    """The diffuse2 cull kernel gives the dense kernel's sums bit for bit on
    every member row, and the plain version's masked by `diffuse_keep_plain`
    (count exact, sums atol 1e-6)."""
    dims, nchunkp, cl, member, cands_c, cands_w = card_diffuse2
    got = p2.diffuse2_cull_kernel(nchunkp, cl, cands_c, cands_w, member, dims)
    dense = p2.diffuse2_kernel(nchunkp, cl, cands_c, cands_w, dims)
    assert torch.equal(got[:, member], dense[:, member])
    assert float(got[4][member].max()) > 1
    keep = p2.diffuse_keep_plain(nchunkp, cl, member, cands_w, dims)
    want = p2.diffuse2_plain(nchunkp, cl, cands_c, cands_w, dims, keep=keep)
    assert torch.equal(got[4], want[4])
    torch.testing.assert_close(got[:4], want[:4], atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", ADVERSARIAL_SEEDS)
def test_diffuse2_cull_kernel_on_adversarial_slab(seed):
    """On `adversarial_diffuse_slab` (the band's edges, the grid's end cells,
    x and y boundaries, all-zero and non-member slots, a sub-block with no
    member row): the cull kernel equals the dense one bit for bit on every
    member row, and the plain version masked by
    `diffuse_keep_plain` (count exact, sums atol 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    nchunkp, acl, member, cands_c, cands_w = (t.cuda() for t in adversarial_diffuse_slab(seed))
    dense = p2.diffuse2_kernel(nchunkp, acl, cands_c, cands_w, DIFFUSE_DIMS)
    got = p2.diffuse2_cull_kernel(nchunkp, acl, cands_c, cands_w, member, DIFFUSE_DIMS)
    assert torch.equal(got[:, member], dense[:, member])
    keep = p2.diffuse_keep_plain(nchunkp, acl, member, cands_w, DIFFUSE_DIMS)
    want = p2.diffuse2_plain(nchunkp, acl, cands_c, cands_w, DIFFUSE_DIMS, keep=keep)
    assert torch.equal(got[4], want[4])
    torch.testing.assert_close(got[:4], want[:4], atol=1e-6, rtol=0)


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
    """McField on the card launches row 4b once a call, into one (8, L)
    output whose rows are v, n and c."""
    spec, dyn, fr, st = card_surface_frame
    field = mf.McField(spec.h)
    v, n, c = field(fr.index, spec.surface, spec.scale, st.position, st.colour,
                    st.ptype, st.alive, fr.min_extent, dyn["mc_particle_size"])
    torch.cuda.synchronize()
    assert v.is_cuda and n.shape == (3, v.shape[0]) and c.shape == (4, v.shape[0])
    assert field.launches == {"mc_field_cells": 1, "mc_field": 0}
    L = v.shape[0]
    assert n.data_ptr() == v.data_ptr() + 4 * L and c.data_ptr() == v.data_ptr() + 16 * L


def test_mc_field_row4_launches_are_counted(card_surface_frame):
    """Row 4's launcher adds one to ROW4_LAUNCHES a launch of `mc_field` and
    none for the bisection bodies, and McField reports it since its reset."""
    spec, dyn, fr, st = card_surface_frame
    field = mf.McField(spec.h)
    start = mf.ROW4_LAUNCHES["mc_field"]
    args = (fr.index, spec.surface, spec.h, spec.scale, st.position, st.colour,
            ph.nonobstacle(st.ptype, st.alive), fr.min_extent)
    mf.mc_field_kernel(*args)
    mf.mc_field_kernel(*args, name="mc_field_loops")
    torch.cuda.synchronize()
    assert mf.ROW4_LAUNCHES["mc_field"] == start + 1
    assert field.launches == {"mc_field_cells": 0, "mc_field": 1}
    field.reset_launches()
    assert field.launches == {"mc_field_cells": 0, "mc_field": 0}


@pytest.fixture(scope="module")
def card_field_frames(card_surface_frame):
    """{res: (spec, dyn, frame, finalised state)}: the dam break of
    `card_surface_frame` (res 1.0) and a 2-cube frame at res 2.0."""
    mc, cfg, xs = simple_config_with_2_cubes(1500, 2, 500.0)
    cfg = cfg.replace(surface=mc)
    solver = TorchSolver(h=cfg.h, device="cuda")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, device="cuda")
    fr, st, _ = solve_frame(spec, solver.phases, state, dyn, scn)
    assert spec.surface.resolution == 2.0
    return {1.0: card_surface_frame, 2.0: (spec, dyn, fr, st)}


@pytest.mark.parametrize("res", [1.0, 2.0])
def test_mc_field_cells_kernel_matches_plain(card_field_frames, res):
    """Row 4b against its plain version and against row 4 with the
    post-pass, at res 1.0 and 2.0."""
    spec, dyn, fr, st = card_field_frames[res]
    size = dyn["mc_particle_size"]
    args = mcb.cells_args(spec, fr, st, size)
    got = mf.mc_field_cells_kernel(*args)
    want = mf.mc_field_cells_plain(*args)
    row4 = mf.post_pass(mf.mc_field_kernel(*mcb.field_args(spec, fr, st)), spec.surface,
                        spec.grid.extent, size)
    _, _, skip = mf.lattice_nodes(spec.surface, spec.grid.extent, st.position.device)
    for ref in ((want[0], want[1:4], want[4:8]), row4):
        res_ = mcb.cells_agree(got, ref, skip)
        assert all(ok for ok, _ in res_.values()), res_
    assert bool((got[0] > 1e-3).any()) and bool(torch.isnan(got[4]).any())


@pytest.mark.parametrize("res", [1.0, 2.0])
def test_mc_field_cells_is_deterministic(card_field_frames, res):
    spec, dyn, fr, st = card_field_frames[res]
    args = mcb.cells_args(spec, fr, st, dyn["mc_particle_size"])
    first = mf.mc_field_cells_kernel(*args)
    assert all(mcb.bits_equal(first, mf.mc_field_cells_kernel(*args)) for _ in range(3))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _issue_x(card):
    rng = np.random.default_rng(0)
    return torch.from_numpy((1 + 1e-3 * rng.random(ar.TILE)).astype(np.float32)).to(card)


@pytest.mark.parametrize("shape", ar.OP_SHAPES)
def test_anchor_issue_kernel_matches_plain(card, shape):
    op, nstreams, unroll = shape
    x = _issue_x(card)
    got = ar.issue_kernel(x, op, nstreams, unroll, 8)
    want = ar.issue_plain(x, op, nstreams, unroll, 8)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_anchor_issue_uninstantiated_raises(card):
    x = _issue_x(card)
    with pytest.raises(ValueError, match="no issue kernel"):
        ar.issue_kernel(x, "mul", 1, 16, 8)
    with pytest.raises(RuntimeError, match="cudaError"):
        ar.issue_kernel(x, "mul", 1, 16, 8, nthreads=1024)


@pytest.mark.parametrize("which", ["lambda", "delta"])
def test_anchor_body_kernel_matches_plain(card, which):
    for nunroll, nch, niter, stride in ((2, 2, 3, 0), (5, 3, 4, 1), (8, 8, 4, 0)):
        rows, strip = ar.random_body_inputs(nch, nch, card)
        got = ar.body_kernel(rows, strip, which, nunroll, niter, stride)
        want = ar.body_plain(rows, strip, which, nunroll, niter, stride)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", ["lambda", "delta"])
def test_anchor_body_blocked_is_the_body_bit_for_bit(card, which):
    """The redesigned body (the cells kernels' pair terms, BLOCKED_ROWS rows a
    thread) gives the body kernel's bits on the tool's inputs and on seeded
    ones at strides 1-2, and agrees with the plain version at each case's
    rtol (`blocked_cases`)."""
    for tag, (rows, strip), (nunroll, niter, stride), rtol in ar.blocked_cases(card):
        got = ar.body_blocked_kernel(rows, strip, which, nunroll, niter, stride)
        assert torch.equal(got, ar.body_kernel(rows, strip, which, nunroll, niter, stride)), tag
        torch.testing.assert_close(got, ar.body_plain(rows, strip, which, nunroll, niter, stride),
                                   rtol=rtol, atol=1e-6)


def test_anchor_body_blocked_refuses_a_device_mix(card):
    rows, strip = ar.random_body_inputs(0, 2, card)
    anchor = ar.Anchor()
    with pytest.raises(ValueError, match="strip"):
        anchor.body_blocked(rows, strip.cpu(), "lambda", 2, 3)
    with pytest.raises(ValueError, match="nthreads"):
        anchor.body_blocked(rows, strip, "lambda", 2, 3, 0, 1)
    assert anchor.launches == dict.fromkeys(ar.KERNELS, 0)


def test_anchor_rowfix_kernel_matches_plain(card):
    rows = torch.full((5, ar.ROWS), 0.05, device=card)
    rows[4, ::3] = 0  # some non-member rows
    index = ar.rowfix_index(rows)
    for nblocks in (1, 8):
        got = ar.rowfix_kernel(rows, index, nblocks)
        torch.testing.assert_close(got, ar.rowfix_plain(rows, index, nblocks), rtol=0,
                                   atol=1e-9)


@pytest.mark.parametrize("seed", [1, 2])
def test_anchor_rowfix_blocked_is_the_row_kernel_bit_for_bit(card, seed):
    """The redesigned row kernel gives the row kernel's bits on every
    element: the tool's index with some non-member rows at 1, 3 and 8
    blocks, and the seeded index (pairs, empty cells, warps that load their
    ends directly) at 8; and the plain version's within 1e-9 / rtol 1e-5."""
    rows = torch.full((5, ar.ROWS), 0.05, device=card)
    rows[4, ::3] = 0
    cases = [(rows, ar.rowfix_index(rows), nb, 0.0) for nb in (1, 3, 8)]
    srows, sindex = ar.seeded_rowfix(seed, device=card)
    cases.append((srows, sindex, 8, 1e-5))
    for rows, index, nb, rtol in cases:
        got = ar.rowfix_blocked_kernel(rows, index, nb, whole=True)
        assert torch.equal(got, ar.rowfix_kernel(rows, index, nb, whole=True)), nb
        torch.testing.assert_close(got, ar.rowfix_plain(rows, index, nb).expand(nb, -1),
                                   rtol=rtol, atol=1e-9 if rtol == 0 else 1e-6)


def test_anchor_rowfix_bits(card):
    """`rowfix_bits`, the labels chip_smoke.py holds bit for bit."""
    bits = ar.rowfix_bits(card)
    assert len(bits) == 2 * len(ar.ROWFIX_BLOCKS) + 1
    assert all(ok and err == 0 for err, ok in bits.values()), bits


def test_anchor_wrappers_count_kernel_launches(card):
    anchor = ar.Anchor()
    x, rows, strip, frows = ar.tool_inputs(card)
    anchor.issue(x, "rsqrt", 16, 16, 2)
    anchor.body(rows, strip, "delta", 2, 2)
    anchor.body_blocked(rows, strip, "lambda", 2, 2)
    anchor.rowfix(frows, ar.rowfix_index(frows), 2)
    anchor.rowfix_blocked(frows, ar.rowfix_index(frows), 2)
    torch.cuda.synchronize()
    assert anchor.launches == dict.fromkeys(ar.KERNELS, 1)


def test_anchor_sass_is_full(card):
    from pbf_sph_tpu_torch.ops import cuda_build

    cuda_build.library()
    report = ar.check_sass(cuda_build.library_path())
    assert {name for name, r in report.items() if not r["ok"]} == set(), report
    for which in ("lambda", "delta"):
        blocked = report[f"body_blocked {which}"]
        assert blocked["rows"] == ar.BLOCKED_ROWS and blocked["same_as_cells"], blocked


@pytest.mark.parametrize("width", mw.WIDTHS)
@pytest.mark.parametrize("body", mw.BODIES)
def test_window_kernels_match_plain(card, body, width):
    cases = [mw.random_inputs(1, width, card),
             mw.tool_inputs(card) if width == mw.WCOL
             else mw.census_inputs(*mw.PARITY_CENSUS, device=card)]
    for x in cases:
        got = mw.run_kernel(body, x, 3)
        torch.testing.assert_close(got, mw.run_plain(body, x), rtol=mw.RTOL, atol=mw.ATOL)


@pytest.mark.parametrize("width", mw.WIDTHS)
def test_window_blocked_kernels_are_the_originals_bit_for_bit(card, width):
    """The blocked kernels give 7.1's to 7.4's bits on every block of nblocks
    3 (a CTA's replica blocks, some past nblocks), split and fused, on every
    `parity_cases` case: the tool's or census inputs, random ones (an empty
    window, a ragged hi, the sentinel clip at smax), long windows, flat
    lists and static offsets of several stage rounds with an empty flat
    list, and at W 1 every window empty; and agree with the plain versions
    at RTOL/ATOL."""
    for case, x in mw.parity_cases(width, card).items():
        for body, orig in mw.BLOCKED_OF.items():
            got = mw.window_blocks(body, x, mw.BITS_BLOCKS)
            assert got.shape == (mw.BITS_BLOCKS, mw.ROWS)
            assert torch.equal(got, mw.window_blocks(orig, x, mw.BITS_BLOCKS)), (body, case)
            torch.testing.assert_close(got[:1], mw.run_plain(body, x), rtol=mw.RTOL,
                                       atol=mw.ATOL)


def test_window_wrappers_count_kernel_launches(card):
    win = mw.MicroWindow()
    x = mw.tool_inputs(card)
    for body in mw.ALL_BODIES:
        win.run(body, x, 1)
    torch.cuda.synchronize()
    assert win.launches == {"window_prod": 2, "window_guarded": 2, "window_flat": 2,
                            "window_static": 1, "window_prod_blocked": 2,
                            "window_guarded_blocked": 2, "window_flat_blocked": 2,
                            "window_static_blocked": 1}
    with pytest.raises(ValueError, match="instantiates"):
        mw.prod_kernel(x.wins, x.rows, x.strip, 1, width=64)
    with pytest.raises(ValueError, match="instantiates"):
        mw.guarded_blocked_kernel(x.wins, x.rows, x.strip, 1, width=64)
    with pytest.raises(ValueError, match="instantiates"):
        mw.flat_blocked_kernel(x.tbl, x.rows, x.strip, 1, False, width=64)
    with pytest.raises(ValueError, match="instantiates"):
        mw.static_blocked_kernel(x.rows, x.pack, 1, width=64)


def test_window_sass_is_full(card):
    from pbf_sph_tpu_torch.ops import cuda_build

    cuda_build.library()
    report = mw.check_sass(cuda_build.library_path())
    assert {name for name, r in report.items() if not r["ok"]} == set(), report
    for body in mw.BLOCKED_BODIES:
        for width in mw.WIDTHS:
            r = report[f"{body} W{width}"]
            assert r["rows"] == mw.BLOCKED_ROWS and r["same_as_phase"], r
            assert r["pairs_a_read"] == mw.BLOCKED_ROWS and r["ldg_in_loop"] == r["local"] == 0


@pytest.mark.parametrize("body", mcb.BODIES)
def test_mc_bisect_kernels_match_plain(card_surface_frame, body):
    spec, dyn, fr, st = card_surface_frame
    res = mcb.card_parity(spec, fr, st, "dam32k")
    err, ok = res[f"{body} dam32k"]
    assert ok, (body, err)


def test_mc_bisect_wrappers_count_kernel_launches(card_surface_frame):
    spec, dyn, fr, st = card_surface_frame
    args = mcb.field_args(spec, fr, st)
    bisect = mcb.McFieldBisect(spec.h)
    for body in mcb.BODIES:
        bisect(body, *args[:2], *args[3:])
    ladder = mcb.kernel_ladder(bisect, spec, fr, st, 2)
    turns = mcb.noop_turns(bisect, spec, fr, st, 1)
    torch.cuda.synchronize()
    assert [s["step"] for s in ladder["steps"]] == ["noop", "rows", "loops", "full"]
    assert {k: len(v) for k, v in turns.items()} == {"noop": 1, "zero_fill": 1, "zeros": 1}
    assert all(v > mcb.GRAPH_LAUNCHES for v in bisect.launches.values())


def test_mc_zero_fill_is_noop_plain(card_surface_frame):
    """mc_field_zero_fill writes every float of a NaN-filled (9, L) output,
    the n mod 4 tail included, as noop_plain's zeros; at lengths off a
    float4 too; and refuses an output off 16 bytes."""
    spec, dyn, fr, st = card_surface_frame
    args = mcb.field_args(spec, fr, st)
    assert mcb.card_parity(spec, fr, st, "dam32k")["zero_fill dam32k"][1]
    for n in (1, 3, 4, 7, 4 * 300_001 + 2):
        out = torch.full((n,), float("nan"), device=st.position.device)
        mcb.zero_fill_launch(out)
        assert torch.equal(out, torch.zeros_like(out)), n
    off = torch.zeros(9 * 4 + 1, device=st.position.device)[1:]
    with pytest.raises(ValueError, match="aligned"):
        mcb.zero_fill_launch(off)
    bisect = mcb.McFieldBisect(spec.h)
    got = bisect("zero_fill", *args[:2], *args[3:])
    torch.cuda.synchronize()
    assert torch.equal(got, mcb.noop_plain(*args))
    assert bisect.launches["mc_field_zero_fill"] == 1


def test_mc_bisect_pieces_equal_mc_field(card_surface_frame):
    """Row 4's call rebuilt from its pieces gives post_pass(mc_field_kernel)
    bit for bit, and agrees with McField (row 4b) as 3n holds them."""
    spec, dyn, fr, st = card_surface_frame
    size = dyn["mc_particle_size"]
    args = (fr.index, spec.surface, spec.scale, st.position, st.colour, st.ptype, st.alive,
            fr.min_extent, size)
    pieces = mcb.field_by_pieces(spec.h, *args)
    row4 = mf.post_pass(mf.mc_field_kernel(*mcb.field_args(spec, fr, st)), spec.surface,
                        spec.grid.extent, size)
    for got, want in zip(pieces, row4):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    v, n, c = mf.McField(spec.h)(*args)
    _, _, skip = mf.lattice_nodes(spec.surface, spec.grid.extent, st.position.device)
    agree = mcb.cells_agree(torch.cat([v[None], n, c]), pieces, skip)
    assert all(ok for ok, _ in agree.values()), agree


def test_mc_bisect_sass(card):
    from pbf_sph_tpu_torch.ops import cuda_build

    cuda_build.library()
    report = mcb.check_sass(cuda_build.library_path())
    assert {name for name, r in report.items() if not r["ok"]} == set(), report


@pytest.mark.parametrize("interleave", mch.INTERLEAVES)
@pytest.mark.parametrize("body", mch.BODIES)
def test_chunk_kernels_match_plain(card, body, interleave):
    s, rows, _ = mch.tool_inputs(card)
    for s_, rows_ in ((s, rows), mch.random_inputs(1, card)):
        got = mch.chunk_kernel(s_, rows_, body, interleave, mch.PARITY_CHUNKS, 24)
        want = mch.chunk_plain(s_, rows_, body, interleave, mch.PARITY_CHUNKS)
        torch.testing.assert_close(got, want, rtol=mch.RTOL, atol=mch.ATOL)


@pytest.mark.parametrize("streams", mch.STREAMS)
def test_chunk_fma_kernel_matches_plain(card, streams):
    x = torch.ones(mch.TILE, device=card)
    got = mch.fma_kernel(x, streams, mch.PARITY_ITERS, 16)
    torch.testing.assert_close(got, mch.fma_plain(x, streams, mch.PARITY_ITERS), rtol=1e-6,
                               atol=0.0)


@pytest.mark.parametrize("label", list(ml.BODIES))
def test_loop_kernels_match_plain(card, label):
    body = ml.BODIES[label]
    n = body.trips // ml.PARITY_DIV
    for xs in (ml.tool_inputs(card), ml.random_inputs(1, card)):
        x = xs[body.tile]
        got = ml.run_kernel(label, x, n, 3 * x.numel() // ml.CTA)
        rtol = ml.RTOL_RSQRT if label == "e_rsqrt" else 0.0
        torch.testing.assert_close(got, ml.run_plain(label, x, n), rtol=rtol, atol=0.0)


def test_micro_wrappers_count_kernel_launches(card):
    chunk, loop = mch.MicroChunk(), ml.MicroLoop()
    s, rows, x = mch.tool_inputs(card)
    for body in mch.BODIES:
        chunk.chunk(s, rows, body, 1, 8)
    chunk.fma(x, 8, 4)
    xs = ml.tool_inputs(card)
    for label, body in ml.BODIES.items():
        loop.run(label, xs[body.tile], 2)
    torch.cuda.synchronize()
    assert chunk.launches == dict.fromkeys(mch.KERNELS, 1)
    assert loop.launches == {"loop_fma": 9, "loop_chain": 2, "loop_op": 5}
    with pytest.raises(ValueError, match="instantiates"):
        mch.chunk_kernel(s, rows, "new", 3, 6)
    with pytest.raises(ValueError, match="instantiates"):
        ml.fma_kernel(xs[ml.TILE8], 3, 2)


def test_micro_chunk_and_loop_sass_are_full(card):
    from pbf_sph_tpu_torch.ops import cuda_build

    cuda_build.library()
    for tool in (mch, ml):
        report = tool.check_sass(cuda_build.library_path())
        assert tool is ml or set(report) >= {"old x4", "new x4", "fma 8", "pbf_lambda"}
        assert mch.short(report) == [], report


@pytest.mark.parametrize("label", list(md.BODIES) + list(md.REDESIGNS))
def test_dense_kernels_match_plain(card, label):
    for x in (md.tool_inputs(device=card), md.random_inputs(2, device=card)):
        got = md.run_kernel(label, x, 3)
        want = md.run_plain(label, x)
        torch.testing.assert_close(got, want.expand_as(got), rtol=md.RTOL,
                                   atol=md.ATOL_SHARE * float(want.abs().max()))
    got = md.run_kernel(label, x, 1, 3)   # three passes on the same carries
    want = md.run_plain(label, x, 1, 3)
    torch.testing.assert_close(got, want, rtol=md.RTOL,
                               atol=md.ATOL_SHARE * float(want.abs().max()))


@pytest.mark.parametrize("label", md.MXU + tuple(md.REDESIGNS))
def test_dense_mxu_within_float64(card, label):
    """d)/g) and gb on the card inside the range a float64 evaluation of the
    TPU tool's function takes under the rounding of its fp32 operands and
    sums, which shares none of the kernel's rounding choices."""
    for x in (md.tool_inputs(device=card), md.random_inputs(2, device=card)):
        assert md.within_f64(md.run_kernel(label, x, 2), md.mxu_f64(md.base(label), x))[1]


def test_dense_wrappers_count_kernel_launches(card):
    dense = md.MicroDense()
    x = md.tool_inputs(device=card)
    for label in (*md.BODIES, *md.REDESIGNS):
        dense.run(label, x)
    torch.cuda.synchronize()
    assert dense.launches == {"dense_loop": 9, "dense_mxu": 1, "dense_wmxu": 1, "dense_scr": 1,
                              "dense_wmxu_blocked": 1}
    with pytest.raises(ValueError, match="instantiates wcap"):
        md.run_kernel("a", md.tool_inputs(2, 4, device=card))
    with pytest.raises(ValueError, match="odd"):
        md.run_kernel("i", md.tool_inputs(3, device=card))


def test_micro_dense_sass_is_full(card):
    from pbf_sph_tpu_torch.ops import cuda_build

    cuda_build.library()
    report = md.check_sass(cuda_build.library_path())
    assert set(report) == set(md.BODIES) | set(md.REDESIGNS)
    assert md.short(report) == [], report


@pytest.mark.parametrize("label", mr.LANES)
def test_roll_lanes_kernel_matches_plain(card, label):
    zeros = mr.LanesInputs(torch.full((mr.ROWS, mr.W), -0.0, device=card),
                           mr.lanes_inputs(card).shifts)
    for x in (mr.lanes_inputs(card), mr.random_lanes_inputs(3, card), zeros):
        for ntrips in (0, 1, 1000):
            got = mr.lanes_kernel(label, x, ntrips, 11)
            assert mr.bit_equal(got, mr.lanes_plain(label, x, ntrips))[1], (label, ntrips)


@pytest.mark.parametrize("body", mr.PART_BODIES)
@pytest.mark.parametrize("label", mr.PARTS)
def test_roll_part_kernel_matches_plain(card, label, body):
    for x in (mr.part_inputs(card), mr.random_part_inputs(3, card)):
        got = mr.part_kernel(label, body, x, 3, 2)
        assert mr.bit_equal(got, mr.part_plain(label, x))[1]
        assert torch.isnan(got).any() and not torch.isnan(got).all()


@pytest.mark.parametrize("body", mr.PART_BODIES)
@pytest.mark.parametrize("label", mr.PARTS)
def test_roll_part_blocked_matches_roll_part(card, label, body):
    """The blocked kernel gives roll_part's bits and part_plain's, NaN in
    place, on the tool's inputs and three seeds, at 1, 3 and 513 copies and
    1 and 2 passes."""
    for x in (mr.part_inputs(card), *(mr.random_part_inputs(s, card) for s in range(3))):
        for nrep in (1, 3, 513):
            for npass in (1, 2):
                got = mr.part_blocked_kernel(label, body, x, nrep, npass)
                want = mr.part_kernel(label, body, x, nrep, npass)
                assert mr.bit_equal(got, want)[1], (nrep, npass)
                assert mr.bit_equal(got, mr.part_plain(label, x, nrep, npass))[1], (nrep, npass)


def test_roll_part_blocked_chunks_is_the_launchers(card):
    """The launcher's own count of CTAs a copy is part_chunks', the tests'
    mirror, on the tool's meta and five seeds; where no part runs (e) with
    niv or nci 0) it launches nothing and refuses."""
    from pbf_sph_tpu_torch.ops import cuda_build

    for meta in (torch.from_numpy(mr.tool_meta()),
                 *(mr.random_part_inputs(s).meta for s in range(5))):
        for label in mr.PARTS:
            assert mr.blocked_chunks(label, meta) == len(mr.part_chunks(label, meta))
    lib, x = cuda_build.library(), mr.part_inputs(card)
    m = mr.check_meta(x.meta)
    assert lib.roll_part_blocked_chunks(m.ctypes.data, mr.LOOP_ID["e"], 0, mr.NCI) == 0
    out = torch.full((1, mr.FIELDS, mr.OUT_COLS), float("nan"), device=card)
    err = lib.roll_part_blocked(x.strips.data_ptr(), m.ctypes.data, mr.BODY_ID["direct"],
                                mr.LOOP_ID["e"], 0, mr.NCI, 1, 1, 0, out.data_ptr(),
                                torch.cuda.current_stream(card).cuda_stream)
    assert err != 0 and torch.isnan(out).all()


def test_roll_lam_kernel_matches_plain(card):
    for x in (mr.lam_inputs(card), mr.random_lam_inputs(3, card)):
        for npass in (0, 1, 7):
            got = mr.lam_kernel(x, 3, npass)
            want = mr.lam_plain(x, 1, npass)
            torch.testing.assert_close(got, want.expand_as(got), rtol=mr.RTOL,
                                       atol=mr.ATOL_SHARE * float(want.abs().max()))


def test_vpu_kernels_match_plain(card):
    for s in mr.SEEDED_SHIFTS + mr.WRAPPED_SHIFTS + (2**31 - 1, -2**31):
        x = mr.random_vpu_inputs(4, s, 0, card)
        assert mr.bit_equal(mr.rot_kernel(x.tile, x.shift), mr.rot_plain(x.tile, x.shift))[1]
    for o in mr.SEEDED_OFFSETS:
        x = mr.random_vpu_inputs(5, 0, o, card)
        want = mr.slice_plain(x.wide, o)
        for kernel in (mr.unal_kernel, mr.dma_kernel):
            assert mr.bit_equal(kernel(x.wide, o), want)[1], (kernel, o)


def test_roll_wrappers_count_kernel_launches(card):
    roll = mr.MicroRoll()
    xl, xp, xf, xv = (mr.lanes_inputs(card), mr.part_inputs(card), mr.lam_inputs(card),
                      mr.vpu_inputs(card))
    for label in mr.LANES:
        roll.lanes(label, xl, 10)
    for label in mr.PARTS:
        for body in mr.PART_BODIES:
            roll.part(label, body, xp)
            roll.part_blocked(label, body, xp)
    roll.lam(xf, 1, 2)
    roll.rot(xv.tile, xv.shift)
    roll.unal(xv.wide, xv.offset)
    roll.dma(xv.wide, xv.offset)
    torch.cuda.synchronize()
    assert roll.launches == {"roll_lanes": 2, "roll_part_shuffle": 3, "roll_part_direct": 3,
                             "roll_part_blocked_shuffle": 3, "roll_part_blocked_direct": 3,
                             "roll_lam": 1, "vpu_rot": 1, "vpu_unal": 1, "vpu_dma": 1}
    for o in (-1, 385):
        with pytest.raises(ValueError, match="offset"):
            roll.dma(xv.wide, o)
    meta = xp.meta.clone()
    meta[4, 0] = mr.SM
    with pytest.raises(ValueError, match="part 4: s0"):
        roll.part("c", "shuffle", mr.PartInputs(xp.strips, meta))
    with pytest.raises(ValueError, match="part 4: s0"):
        roll.part_blocked("c", "direct", mr.PartInputs(xp.strips, meta))
    assert roll.launches["vpu_dma"] == 1 and roll.launches["roll_part_shuffle"] == 3
    assert roll.launches["roll_part_blocked_direct"] == 3


def test_micro_roll_sass_is_full(card):
    from pbf_sph_tpu_torch.ops import cuda_build

    cuda_build.library()
    report = mr.check_sass(cuda_build.library_path())
    assert len(report) == 2 + 1 + 6 + 6 + 1 + 2
    assert mr.short(report) == [], report


@pytest.mark.parametrize("op", mv.OPS)
def test_vpu_streams_kernel_matches_plain(card, op):
    """Every CTA of a grid of two and a half copies: the wrap of its element
    index included."""
    for x in (mv.tool_inputs(card, rows=16), mv.random_inputs(3, card, rows=16)):
        for ns in mv.STREAMS:
            got = mv.streams_kernel(x.x, op, ns, 300, 5)
            want = mv.streams_plain(x.x, op, ns, 300, 5)
            assert got.shape == want.shape == (5 * 8, 128)
            if op == "rsqrt":
                torch.testing.assert_close(got, want, rtol=mv.RTOL_RSQRT, atol=0)
            else:
                assert mr.bit_equal(got, want)[1], (op, ns)


def test_vpu_dots_and_tr_match_plain(card):
    for x in (mv.tool_inputs(card), mv.random_inputs(3, card)):
        for niter in (0, 1, 300):
            assert mr.bit_equal(mv.dot_kernel(x.a, x.b, niter, 3),
                                mv.dot_plain(x.a, x.b, niter))[1], niter
            assert mr.bit_equal(mv.dot2_kernel(x.a2, x.b2, niter, 3),
                                mv.dot2_plain(x.a2, x.b2, niter))[1]
            for body in mv.TR_BODIES:
                assert mr.bit_equal(mv.tr_kernel(x.t, body, niter, 3),
                                    mv.tr_plain(x.t, body, niter))[1], (body, niter)


def test_vpu_redesigns_match_plain(card):
    """vpu_dot_spread bit for bit dot_plain at no trip, one, a ragged tile
    and several tiles with a ragged end, over 3 copies; vpu_dot2_spread bit
    for bit dot2_plain at no trip, one, a ragged tile, several tiles with a
    ragged end and 8192 trips, over 3 copies; vpu_tr_split bit for bit
    tr_split_plain at every power-of-two split, ragged ones included."""
    for x in (mv.tool_inputs(card), mv.random_inputs(3, card)):
        for niter in (0, 1, 300, 2 * mv.SPREAD_TILE + 133):
            assert mr.bit_equal(mv.dot_spread_kernel(x.a, x.b, niter, 3),
                                mv.dot_plain(x.a, x.b, niter))[1], niter
        for niter in (0, 1, 100, 2 * mv.SPREAD2_TILE + 133, 8192):
            assert mr.bit_equal(mv.dot2_spread_kernel(x.a2, x.b2, niter, 3),
                                mv.dot2_plain(x.a2, x.b2, niter))[1], niter
        for niter in (0, 1, 5, 300):
            for parts in (1, 2, 8, 32, 64, 128, 256):
                assert mr.bit_equal(mv.tr_split_kernel(x.t, niter, parts, 3),
                                    mv.tr_split_plain(x.t, niter, parts))[1], (niter, parts)


def test_vpu_wrappers_count_kernel_launches(card):
    vpu = mv.MicroVpu()
    x = mv.tool_inputs(card, rows=8)
    for op in mv.OPS:
        vpu.streams(x.x, op, 2, 10)
    vpu.dot(x.a, x.b, 10)
    vpu.dot2(x.a2, x.b2, 10, 2)
    for body in mv.TR_BODIES:
        vpu.tr(x.t, body, 10)
    vpu.dot_spread(x.a, x.b, 10)
    vpu.tr_split(x.t, 10)
    vpu.tr_split(x.t, 10, parts=4)
    vpu.dot2_spread(x.a2, x.b2, 10, 2)
    torch.cuda.synchronize()
    assert vpu.launches == {"vpu_streams": 6, "vpu_dot": 1, "vpu_dot2": 1, "vpu_tr_direct": 1,
                            "vpu_tr_restage": 1, "vpu_dot_spread": 1, "vpu_tr_split": 2,
                            "vpu_dot2_spread": 1}
    with pytest.raises(ValueError, match="power of two"):
        vpu.tr_split(x.t, 10, parts=3)
    with pytest.raises(ValueError, match="instantiates"):
        vpu.streams(x.x, "fma", 3, 10)
    with pytest.raises(ValueError, match="aligned"):
        vpu.dot(x.a, torch.ones(8 * 128 + 1, device=card)[1:].view(8, 128), 10)
    with pytest.raises(ValueError, match="aligned"):
        vpu.dot2_spread(x.a2, torch.ones(8 * 128 + 1, device=card)[1:].view(8, 128), 10)
    with pytest.raises(ValueError, match="65535"):
        vpu.dot2_spread(x.a2, x.b2, 10, 65536)
    assert vpu.launches["vpu_streams"] == 6 and vpu.launches["vpu_dot"] == 1
    assert vpu.launches["vpu_dot2_spread"] == 1


def test_micro_vpu_sass_is_full(card):
    from pbf_sph_tpu_torch.ops import cuda_build

    cuda_build.library()
    report = mv.check_sass(cuda_build.library_path())
    assert len(report) == 24 + 2 + 2 + 3
    assert mv.short(report) == [], report
