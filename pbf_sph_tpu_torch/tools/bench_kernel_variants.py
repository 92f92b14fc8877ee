"""Sweep of the tiled lambda/delta variants on one CUDA card.

    python -m pbf_sph_tpu_torch.tools.bench_kernel_variants [count] [reps]

Port of `tools/bench_kernel_variants.py`.  It settles dam_break(count, 6)
(default 1M) with the growth warmup of `bench.warm_up` over 5 frames, takes
the sort-time state of one more advect and sort, and times on it:

* the baseline: the per-row production kernels (`PbfPhases(h)`);
* every tiled variant, sub in {64, 32, 16} x mxu in {0, 1}
  (`PbfPhases(h, sub, mxu)`): the window plan, lambda and delta, with the
  largest |dlambda| (absolute and relative) and |dpStar| against the
  baseline, and the tile's row-candidate pairs against the per-row pairs.

Times are device times of the phase wrappers (CUDA events over `reps` calls
after a warm one, default 10).  The first line is the card's name and power
limit; a summary of plan + 6 x (lambda + delta), one constraint solve of
dam1m, follows the rows, and the last line is the table as one JSON object.
There is no CPU fallback: without a CUDA device the tool fails.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from pbf_sph_tpu_torch.bench import warm_up
from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.types import Scene
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, advect_and_sort, dyn_params_of
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.ops import tiles as tl

WARMUP = 5
SOLVE_ITERS = 6
VARIANTS = [(sub, mxu) for sub in (64, 32, 16) for mxu in (False, True)]


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, after one warm call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    count = int(argv[0]) if argv else 1_000_000
    reps = int(argv[1]) if len(argv) > 1 else 10
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernel_variants: needs a CUDA device")
    card = card_line()
    print(card)

    mc, cfg, xs = dam_break(count, solver_iter=SOLVE_ITERS)
    solver = TorchSolver(h=cfg.h, device="cuda")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, solver.dtype, solver.device)
    spec, state, frames = warm_up(solver, spec, state, dyn, scn, xs, WARMUP)
    fr = advect_and_sort(spec, state, dyn, scn)
    st, idx = fr.state, fr.index
    scale = torch.full((), spec.scale, device=st.mass.device)
    bounds = (scale, dyn["min_bound"], dyn["max_bound"])
    lo, hi = ph.neighbour_ranges(idx)
    row_pairs = int((hi - lo).sum())
    print(f"count {len(xs)}, capacity {spec.capacity}, grid {spec.grid.dims}, "
          f"{frames} warmup frames, {row_pairs} per-row candidate pairs")

    rows = []
    ref = None
    for variant in [None] + VARIANTS:
        if variant is None:
            tag, phases, plan_ms, pairs = "per-row", ph.PbfPhases(spec.h), 0.0, row_pairs
        else:
            sub, mxu = variant
            tag = f"sub={sub} mxu={int(mxu)}"
            phases = ph.PbfPhases(spec.h, sub=sub, mxu=mxu)
            plan_ms = device_ms(lambda: tl.plan_tiles(idx, sub), reps)
            pairs = tl.tile_pairs(phases.plan(idx), sub)

        def lam_fn():
            return phases.lambda_phase(idx, fr.pstar, st.mass, st.ptype, st.alive)

        lam = lam_fn()
        lam_ms = device_ms(lam_fn, reps)
        del_fn = lambda: phases.delta_phase(  # noqa: E731
            idx, fr.pstar, lam, st.ptype, st.alive, *bounds)
        moved = del_fn()
        del_ms = device_ms(del_fn, reps)
        row = dict(variant=tag, plan_ms=plan_ms, lambda_ms=lam_ms, delta_ms=del_ms,
                   solve_ms=plan_ms + SOLVE_ITERS * (lam_ms + del_ms),
                   pairs=pairs, pairs_vs_per_row=pairs / row_pairs,
                   launches=dict(phases.launches))
        if ref is None:
            ref = (lam, moved)
            parity = "(baseline)"
        else:
            dl = (lam - ref[0]).abs()
            row.update(max_dlambda=float(dl.max()),
                       max_dlambda_rel=float((dl / (ref[0].abs() + 1e-6)).max()),
                       max_dpstar=float((moved - ref[1]).abs().max()))
            parity = (f"max|dlam| {row['max_dlambda']:.3e} (rel "
                      f"{row['max_dlambda_rel']:.3e}), max|dpStar| {row['max_dpstar']:.3e}")
        print(f"{tag:16s} plan {plan_ms:8.4f}  lambda {lam_ms:8.4f}  delta {del_ms:8.4f} ms"
              f"  pairs {pairs} ({pairs / row_pairs:.2f}x)  {parity}")
        rows.append(row)
        torch.cuda.empty_cache()

    print(f"\nsummary (plan + {SOLVE_ITERS} x (lambda + delta), device ms):")
    for row in rows:
        print(f"  {row['variant']:16s} plan {row['plan_ms']:8.4f}  lam {row['lambda_ms']:8.4f}"
              f"  del {row['delta_ms']:8.4f}  solve{SOLVE_ITERS} {row['solve_ms']:9.4f}")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                      "count": len(xs), "capacity": spec.capacity, "reps": reps,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
