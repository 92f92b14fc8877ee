"""Per-phase times on one CUDA card: v1 (per-row kernels, and the main
path's own) against v2 (compacted candidates).

    python -m pbf_sph_tpu_torch.tools.bench_phases [count] [reps]

Port of `tools/bench_phases.py`.  It settles dam_break(count, 6) (default
1M) with the growth warmup of `bench.warm_up` over 5 frames, takes the
sort-time state of one more advect and sort, and times on it, as device
times (CUDA events over `reps` calls after a warm one, default 10):

* shared: the sort (`torch.sort` of the cell keys and the gathers of
  `advect_and_sort`, the counterpart of the JAX 16-operand `lax.sort`) and
  the cell table;
* v2 (`tools/phases2.py` `PbfPhases2`): the plan, compact pStar, lambda2,
  compact lambda, delta2 and diffuse2 (its two compactions included), with
  lambda2, delta2 and diffuse2 on the cull kernels.  smax and wcap start
  where `tools/bench_phases.py` starts them and grow by
  `grown_strip_capacity`/`grown_wcap` until the plan reports no overflow;
  the run fails if one is left at STRIP_MAX/WCAP_MAX;
* the raw lambda2, delta2 and diffuse2 kernels alone: the dense ones
  (`DensePhases2`) and the cull ones, with the share of the slab columns
  the cull kernels' group test passes to the vote and the share diffuse2's
  slot test passes;
* v1 (`ops/phases.py` `PbfPhases`): the per-row lambda, delta and diffuse
  (`diffuse_rows`: rows 1-3), and the main path's own calls, `solve` for
  one iteration (its (C, 4) packs and the kernels of `ops/cells.py`: rows
  1b/2b) and `diffuse` (`ops/diffuse_cells.py`: rows 3b/3c).

A round is one constraint iteration: v2 compact pStar, lambda2, compact
lambda and delta2; v1 lambda and delta, per row or through `solve`.  The
tool prints the v2 round against both v1 rounds, and diffuse2 against both
v1 diffuse calls.

Then the parity of v2 against v1 on member rows (max |dlambda|, max
|dpStar| after one delta phase and the clamp, each chain with its own
lambda, max |dcolour| and the largest diffuse count difference), the cull
kernels' largest difference from the dense ones on member rows (0 when bit
for bit), and the pairs each evaluates: the dense v2 kernels every slab
column of its sub-block, sum nchunkp*128*32; the cull kernels the kept
columns times 32 (`kept_pairs`, `diffuse_kept_pairs`); v1 the per-row
candidate ranges.

The first line is the card's name and power limit, the last one JSON
object.  (ptxas's registers, spills and shared memory of the kernels come
on demand from `bench_kernel_variants --ptxas pbf_phases2.cu`.)
There is no CPU fallback: without a CUDA device the tool fails.  (The JAX
tool reads a `wcap_overflow` output that its solver no longer returns; this
one prints the plan's own overflows.)
"""

from __future__ import annotations

import json
import sys

import torch

from pbf_sph_tpu_torch.bench import warm_up
from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.types import Scene
from pbf_sph_tpu_torch.models.torch_solver import (
    TorchSolver,
    advect_and_sort,
    dyn_params_of,
)
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.ops import pbf
from pbf_sph_tpu_torch.ops.grid import build_cell_table, cell_coords, decode_key, sort_key
from pbf_sph_tpu_torch.tools import phases2 as p2
from pbf_sph_tpu_torch.tools.bench_kernel_variants import card_line, device_ms

WARMUP = 5


def grown_plan(spec, index):
    """(PbfPhases2, wins, smax, wcap, replans): smax and wcap grown until
    the plan has no overflow; raises if one is left at the caps."""
    dims, cap = spec.grid.dims, spec.capacity
    smax = p2.default_strip_capacity(dims, cap)
    wcap = p2.default_wcap()
    for replans in range(16):
        phases = p2.PbfPhases2(cap, spec.grid, spec.h, smax, wcap)
        wins, ovf = phases.plan_frame(index.key, index.table)
        s_ovf, w_ovf = int(ovf["strip_overflow"]), int(ovf["wcap_overflow"])
        print(f"plan smax {smax} wcap {wcap}: strip_overflow {s_ovf}, "
              f"wcap_overflow {w_ovf}")
        if s_ovf == 0 and w_ovf == 0:
            return phases, wins, smax, wcap, replans
        new = (p2.grown_strip_capacity(dims, smax, cap, s_ovf) if s_ovf else smax,
               p2.grown_wcap(wcap, w_ovf) if w_ovf else wcap)
        if new == (smax, wcap):
            raise SystemExit(f"bench_phases: the plan still overflows at smax {smax}, "
                             f"wcap {wcap} (caps {p2.STRIP_MAX}, {p2.WCAP_MAX})")
        smax, wcap = new
    raise SystemExit("bench_phases: plan growth did not converge")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    count = int(argv[0]) if argv else 1_000_000
    reps = int(argv[1]) if len(argv) > 1 else 10
    if not torch.cuda.is_available():
        raise SystemExit("bench_phases: needs a CUDA device")
    card = card_line()
    print(card)

    mc, cfg, xs = dam_break(count, solver_iter=6)
    solver = TorchSolver(h=cfg.h, device="cuda")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, solver.dtype, solver.device)
    spec, state, frames = warm_up(solver, spec, state, dyn, scn, xs, WARMUP)
    fr = advect_and_sort(spec, state, dyn, scn)
    st, idx, h = fr.state, fr.index, spec.h
    cells, member = decode_key(idx.key, spec.grid)
    scale = torch.full((), spec.scale, device=st.mass.device)
    bounds = (scale, dyn["min_bound"], dyn["max_bound"])
    print(f"count {len(xs)}, capacity {spec.capacity}, grid {spec.grid.dims}, "
          f"{spec.grid.ncells} cells, {frames} warmup frames, "
          f"{int(idx.table[-1])} members")
    times = {}

    # shared: the unsorted keys of the settled state, as advect_and_sort makes them
    _, pstar0 = pbf.advect(state.position, state.velocity, state.mass, state.ptype,
                           state.alive, scn["wells_centre"], scn["wells_force"],
                           dyn["constant_force"], dyn["dt"], scale)
    h_t = torch.full((), h, device=scale.device)
    key0 = sort_key(cell_coords(pstar0, dyn["min_bound"] / scale - h_t * 2, h_t),
                    state.alive, spec.grid)

    def sort_gather():
        key, order = torch.sort(key0, stable=True)
        return key, [t[..., order] for t in (state.pid, state.ptype, state.mass,
                                             state.position, state.velocity,
                                             state.colour, state.alive)]

    times["sort"] = device_ms(sort_gather, reps)
    times["table"] = device_ms(lambda: build_cell_table(idx.key, spec.grid), reps)

    # v2
    phases2, wins, smax, wcap, replans = grown_plan(spec, idx)
    times["plan2"] = device_ms(lambda: phases2.plan_frame(idx.key, idx.table), reps)
    cands = phases2.compact_pstar(wins, fr.pstar, member)
    times["compact_pstar"] = device_ms(
        lambda: phases2.compact_pstar(wins, fr.pstar, member), reps)
    lam2_fn = lambda: phases2.lambda_phase(  # noqa: E731
        wins, cands, fr.pstar, st.mass, member, st.ptype, st.alive)
    lam2 = lam2_fn()
    times["lambda2"] = device_ms(lam2_fn, reps)
    lamc = phases2.compact_lam(wins, lam2)
    times["compact_lam"] = device_ms(lambda: phases2.compact_lam(wins, lam2), reps)
    del2_fn = lambda: phases2.delta_phase(  # noqa: E731
        wins, cands, lamc, fr.pstar, lam2, member, st.ptype, st.alive, *bounds)
    moved2 = del2_fn()
    times["delta2"] = device_ms(del2_fn, reps)
    dif2_fn = lambda: phases2.diffuse(  # noqa: E731
        wins, st.colour, cells, member, st.ptype, st.alive, dyn["dt"])
    colour2 = dif2_fn()
    times["diffuse2"] = device_ms(dif2_fn, reps)

    # the raw lambda2 / delta2 kernels: dense and cull
    nchunkp = wins["nchunkp"]
    rows_l = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], st.mass], dim=1)
    rows_d = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], lam2], dim=1)
    dense = p2.DensePhases2(h)
    lam_d = dense.lambda_raw(nchunkp, rows_l, cands)
    dp_d = dense.delta_raw(nchunkp, rows_d, cands, lamc)
    times["lambda2_dense"] = device_ms(lambda: dense.lambda_raw(nchunkp, rows_l, cands),
                                       reps)
    times["delta2_dense"] = device_ms(
        lambda: dense.delta_raw(nchunkp, rows_d, cands, lamc), reps)
    lam_c = p2.lambda2_cull_kernel(nchunkp, rows_l, cands, member, h)
    dp_c = p2.delta2_cull_kernel(nchunkp, rows_d, cands, lamc, member, h)
    cull_diff = max(float((lam_c - lam_d)[member].abs().max()),
                    float((dp_c - dp_d)[:, member].abs().max()))
    times["lambda2_cull"] = device_ms(
        lambda: p2.lambda2_cull_kernel(nchunkp, rows_l, cands, member, h), reps)
    times["delta2_cull"] = device_ms(
        lambda: p2.delta2_cull_kernel(nchunkp, rows_d, cands, lamc, member, h), reps)
    ncols = int(nchunkp.long().sum()) * p2.WCOL
    group_share = (int(p2.cull_keep_plain(nchunkp, rows_l, member, cands, h, vote=False).sum())
                   / ncols)
    kept = p2.kept_pairs(nchunkp, rows_l, member, cands, h)

    # the raw diffuse2 kernels: dense and cull
    dims = spec.grid.dims
    cl, wpack = p2.diffuse_packs(cells, member, st.ptype, st.alive, dims)
    cands_c = p2.compact_kernel(wins, st.colour)
    cands_w = p2.compact_kernel(wins, wpack)
    sums_d = dense.diffuse_raw(nchunkp, cl, cands_c, cands_w, dims)
    times["diffuse2_dense"] = device_ms(
        lambda: dense.diffuse_raw(nchunkp, cl, cands_c, cands_w, dims), reps)
    sums_c = p2.diffuse2_cull_kernel(nchunkp, cl, cands_c, cands_w, member, dims)
    cull_diff = max(cull_diff, float((sums_c - sums_d)[:, member].abs().max()))
    times["diffuse2_cull"] = device_ms(
        lambda: p2.diffuse2_cull_kernel(nchunkp, cl, cands_c, cands_w, member, dims), reps)
    diffuse_kept = p2.diffuse_kept_pairs(nchunkp, cl, member, cands_w, dims)
    slot_share = diffuse_kept / p2.SUB / ncols

    # v1
    phases1 = ph.PbfPhases(h)
    lam1_fn = lambda: phases1.lambda_phase(  # noqa: E731
        idx, fr.pstar, st.mass, st.ptype, st.alive)
    lam1 = lam1_fn()
    times["lambda1"] = device_ms(lam1_fn, reps)
    del1_fn = lambda: phases1.delta_phase(  # noqa: E731
        idx, fr.pstar, lam1, st.ptype, st.alive, *bounds)
    moved1 = del1_fn()
    times["delta1"] = device_ms(del1_fn, reps)
    dif1_fn = lambda: phases1.diffuse_rows(  # noqa: E731
        idx, st.colour, st.ptype, st.alive, dyn["dt"])
    colour1 = dif1_fn()
    times["diffuse1"] = device_ms(dif1_fn, reps)
    # the main path's calls: one iteration of the solve on the (C, 4) packs
    # (rows 1b/2b), and the cell-sum diffuse (rows 3b/3c)
    solve_fn = lambda: phases1.solve(  # noqa: E731
        idx, fr.pstar, st.mass, st.ptype, st.alive, 1, *bounds)
    solve_fn()
    times["solve1_main"] = device_ms(solve_fn, reps)
    difm_fn = lambda: phases1.diffuse(  # noqa: E731
        idx, st.colour, st.ptype, st.alive, dyn["dt"])
    difm_fn()
    times["diffuse1_main"] = device_ms(difm_fn, reps)
    rounds = {"v2": times["compact_pstar"] + times["lambda2"] + times["compact_lam"]
              + times["delta2"],
              "v1_rows": times["lambda1"] + times["delta1"], "v1_main": times["solve1_main"]}
    ratios = {"round_v2_v1_rows": rounds["v2"] / rounds["v1_rows"],
              "round_v2_v1_main": rounds["v2"] / rounds["v1_main"],
              "diffuse_v2_v1_rows": times["diffuse2"] / times["diffuse1"],
              "diffuse_v2_v1_main": times["diffuse2"] / times["diffuse1_main"]}

    # parity on member rows, and the raw diffuse counts
    sums1 = ph.diffuse_kernel(idx, st.colour, ph.nonobstacle(st.ptype, st.alive))
    parity = dict(
        max_dlambda=float((lam2 - lam1)[member].abs().max()),
        max_dpstar=float((moved2 - moved1)[:, member].abs().max()),
        max_dcolour=float((colour2 - colour1)[:, member].abs().max()),
        max_dcount=float((sums_d[4] - sums1[4])[member].abs().max()))
    lo, hi = ph.neighbour_ranges(idx)
    row_pairs = int((hi - lo).sum())
    slab_pairs = p2.slab_pairs(wins)
    nchunkp = nchunkp.float()
    # PbfPhases2 counts its cull kernels as lambda2/delta2; named here as in
    # the kernels line of chip_smoke.py, the dense ones under their own names
    launches = {"compact": phases2.launches["compact"],
                "lambda2_cull": phases2.launches["lambda2"],
                "delta2_cull": phases2.launches["delta2"],
                "diffuse2_cull": phases2.launches["diffuse2"], **dense.launches,
                **{k: v for k, v in phases1.launches.items() if v}}

    print(f"== shared: sort {times['sort']:.4f} ms, table {times['table']:.4f} ms")
    print(f"== v2 (smax {smax}, wcap {wcap}, {replans} replans; nchunkp mean "
          f"{float(nchunkp.mean()):.2f}, max {int(nchunkp.max())}): plan "
          f"{times['plan2']:.4f}, compact pStar {times['compact_pstar']:.4f}, lambda2 "
          f"{times['lambda2']:.4f}, compact lambda {times['compact_lam']:.4f}, delta2 "
          f"{times['delta2']:.4f}, diffuse2 {times['diffuse2']:.4f} ms (lambda2, delta2 and "
          f"diffuse2 cull)")
    print(f"== v2 raw kernels: dense lambda2 {times['lambda2_dense']:.4f}, delta2 "
          f"{times['delta2_dense']:.4f} ms; cull lambda2 {times['lambda2_cull']:.4f}, delta2 "
          f"{times['delta2_cull']:.4f} ms, the group test passes {group_share:.4f} of the "
          f"columns; dense diffuse2 {times['diffuse2_dense']:.4f}, cull diffuse2 "
          f"{times['diffuse2_cull']:.4f} ms, the slot test passes {slot_share:.4f} of the "
          f"columns")
    print(f"== v1: lambda {times['lambda1']:.4f}, delta {times['delta1']:.4f}, "
          f"diffuse {times['diffuse1']:.4f} ms (per row); main path: solve, one iteration "
          f"{times['solve1_main']:.4f}, diffuse {times['diffuse1_main']:.4f} ms")
    print(f"== a round: v2 {rounds['v2']:.4f} ms, v1 per row {rounds['v1_rows']:.4f} "
          f"({ratios['round_v2_v1_rows']:.2f}x), v1 main path {rounds['v1_main']:.4f} "
          f"({ratios['round_v2_v1_main']:.2f}x); diffuse2 {ratios['diffuse_v2_v1_rows']:.2f}x "
          f"the per-row diffuse, {ratios['diffuse_v2_v1_main']:.2f}x the main path's")
    print(f"== pairs: v2 {slab_pairs} slab pairs ({slab_pairs / row_pairs:.2f}x), cull "
          f"{kept} kept pairs ({kept / slab_pairs:.4f} of the slab, "
          f"{kept / row_pairs:.3f}x), diffuse2 cull {diffuse_kept} kept pairs "
          f"({diffuse_kept / slab_pairs:.4f}), v1 "
          f"{row_pairs} per-row pairs; lambda2 dense "
          f"{slab_pairs / times['lambda2_dense'] / 1e6:.1f} G slab pairs/s, lambda2 "
          f"{slab_pairs / times['lambda2'] / 1e6:.1f} G slab pairs/s, lambda1 "
          f"{row_pairs / times['lambda1'] / 1e6:.1f} G pairs/s")
    print("== parity v2 - v1 on member rows: " + ", ".join(
        f"{k} {v:.3e}" for k, v in parity.items())
        + f"; cull - dense raw lambda2/delta2/diffuse2: {cull_diff:.3e}")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                      "count": len(xs), "capacity": spec.capacity, "reps": reps,
                      "smax": smax, "wcap": wcap, "times_ms": times, "parity": parity,
                      "cull_vs_dense": cull_diff, "group_share": group_share,
                      "slot_share": slot_share, "slab_pairs": slab_pairs, "kept_pairs": kept,
                      "diffuse_kept_pairs": diffuse_kept, "row_pairs": row_pairs,
                      "rounds_ms": rounds, "ratios": ratios, "launches": launches}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
