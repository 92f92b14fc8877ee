"""Per-phase times on one CUDA card: v1 (per-row kernels) against v2
(compacted candidates).

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
  lambda2 and delta2 on the cull kernels.  smax and wcap start where
  `tools/bench_phases.py` starts them and grow by
  `grown_strip_capacity`/`grown_wcap` until the plan reports no overflow;
  the run fails if one is left at STRIP_MAX/WCAP_MAX;
* the raw lambda2 and delta2 kernels alone: the dense ones (`DensePhases2`)
  and the cull ones, with the share of the slab columns the cull kernels'
  group test passes to the vote;
* v1 (`ops/phases.py` `PbfPhases`): lambda, delta and diffuse (the per-row
  `diffuse_rows`).

Then the parity of v2 against v1 on member rows (max |dlambda|, max
|dpStar| after one delta phase and the clamp, each chain with its own
lambda, max |dcolour| and the largest diffuse count difference), the cull
kernels' largest difference from the dense ones on member rows (0 when bit
for bit), and the pairs each evaluates: the dense v2 kernels every slab
column of its sub-block, sum nchunkp*128*32; the cull kernels the kept
columns times 32 (`kept_pairs`); v1 the per-row candidate ranges.

The first line is the card's name and power limit, the last one JSON object.
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
    group_share = (int(p2.cull_keep_plain(nchunkp, rows_l, member, cands, h, vote=False).sum())
                   / (int(nchunkp.long().sum()) * p2.WCOL))
    kept = p2.kept_pairs(nchunkp, rows_l, member, cands, h)

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

    # parity on member rows, and the raw diffuse counts
    cl, wpack = p2.diffuse_packs(cells, member, st.ptype, st.alive, spec.grid.dims)
    sums2 = p2.diffuse2_kernel(wins["nchunkp"], cl, p2.compact_kernel(wins, st.colour),
                               p2.compact_kernel(wins, wpack), spec.grid.dims)
    sums1 = ph.diffuse_kernel(idx, st.colour, ph.nonobstacle(st.ptype, st.alive))
    parity = dict(
        max_dlambda=float((lam2 - lam1)[member].abs().max()),
        max_dpstar=float((moved2 - moved1)[:, member].abs().max()),
        max_dcolour=float((colour2 - colour1)[:, member].abs().max()),
        max_dcount=float((sums2[4] - sums1[4])[member].abs().max()))
    lo, hi = ph.neighbour_ranges(idx)
    row_pairs = int((hi - lo).sum())
    slab_pairs = p2.slab_pairs(wins)
    nchunkp = nchunkp.float()
    # PbfPhases2 counts its cull kernels as lambda2/delta2; named here as in
    # the kernels line of chip_smoke.py, the dense ones under their own names
    launches = {"compact": phases2.launches["compact"],
                "lambda2_cull": phases2.launches["lambda2"],
                "delta2_cull": phases2.launches["delta2"],
                "diffuse2": phases2.launches["diffuse2"], **dense.launches}

    print(f"== shared: sort {times['sort']:.4f} ms, table {times['table']:.4f} ms")
    print(f"== v2 (smax {smax}, wcap {wcap}, {replans} replans; nchunkp mean "
          f"{float(nchunkp.mean()):.2f}, max {int(nchunkp.max())}): plan "
          f"{times['plan2']:.4f}, compact pStar {times['compact_pstar']:.4f}, lambda2 "
          f"{times['lambda2']:.4f}, compact lambda {times['compact_lam']:.4f}, delta2 "
          f"{times['delta2']:.4f}, diffuse2 {times['diffuse2']:.4f} ms (lambda2 and delta2 "
          f"cull)")
    print(f"== v2 raw kernels: dense lambda2 {times['lambda2_dense']:.4f}, delta2 "
          f"{times['delta2_dense']:.4f} ms; cull lambda2 {times['lambda2_cull']:.4f}, delta2 "
          f"{times['delta2_cull']:.4f} ms, the group test passes {group_share:.4f} of the "
          f"columns")
    print(f"== v1: lambda {times['lambda1']:.4f}, delta {times['delta1']:.4f}, "
          f"diffuse {times['diffuse1']:.4f} ms")
    print(f"== pairs: v2 {slab_pairs} slab pairs ({slab_pairs / row_pairs:.2f}x), cull "
          f"{kept} kept pairs ({kept / slab_pairs:.4f} of the slab, "
          f"{kept / row_pairs:.3f}x), v1 {row_pairs} per-row pairs; lambda2 dense "
          f"{slab_pairs / times['lambda2_dense'] / 1e6:.1f} G slab pairs/s, lambda2 "
          f"{slab_pairs / times['lambda2'] / 1e6:.1f} G slab pairs/s, lambda1 "
          f"{row_pairs / times['lambda1'] / 1e6:.1f} G pairs/s")
    print("== parity v2 - v1 on member rows: " + ", ".join(
        f"{k} {v:.3e}" for k, v in parity.items())
        + f"; cull - dense raw lambda2/delta2: {cull_diff:.3e}")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                      "count": len(xs), "capacity": spec.capacity, "reps": reps,
                      "smax": smax, "wcap": wcap, "times_ms": times, "parity": parity,
                      "cull_vs_dense": cull_diff, "group_share": group_share,
                      "slab_pairs": slab_pairs, "kept_pairs": kept, "row_pairs": row_pairs,
                      "launches": launches}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
