"""Where the v2 plan's time goes at dam1m: `phases2.plan_compact` stage by
stage.

Port of `tools/micro_plan.py`.  From the settled state of
`dam_break(count, 6)` (5 frames through `bench.warm_up`), one more advect,
sort and table give the prepared frame's key and cell table; at the JAX
tool's smax 8448 and wcap 2560 the tool times the plan's stages, each on
the previous stage's output:

  s1 lin + top-k + pieces   `phases2.plan_pieces` (with the strip starts)
  s2 gather + sort          `phases2.plan_intervals`
  s2a gather only           `phases2.interval_bounds`
  s3 chains + scatter       `phases2.plan_chunks`
  full plan_compact         the whole plan

on CUDA events on the card (the host clock on the CPU).  `plan_compact`
is these three stages composed, so their outputs are its own by
construction; its check is against the JAX plan (`test_torch_phases2.py`).

    python -m pbf_sph_tpu_torch.tools.micro_plan [count] [reps] [--devices cpu]

JSON last.
"""

from __future__ import annotations

import json
import sys

import torch

from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.models.torch_solver import advect_and_sort
from pbf_sph_tpu_torch.tools import phases2 as p2
from pbf_sph_tpu_torch.tools import study

SMAX, WCAP = 8448, 2560  # the JAX tool's plan sizes


def stages(key, table, grid, capacity: int, smax: int = SMAX, wcap: int = WCAP) -> dict:
    """{stage name: a call of it on the previous stage's output}."""
    pieces = p2.plan_pieces(key, table, grid, capacity, smax)
    intervals = p2.plan_intervals(pieces, table, grid)
    return {
        "s1 lin+topk+pieces": lambda: p2.plan_pieces(key, table, grid, capacity, smax),
        "s2 gather+sort": lambda: p2.plan_intervals(pieces, table, grid),
        "s2a gather only": lambda: p2.interval_bounds(pieces, table, grid),
        "s3 chains+scatter": lambda: p2.plan_chunks(*intervals, pieces["sstart"], smax, wcap),
        "full plan_compact": lambda: p2.plan_compact(key, table, grid, capacity, smax, wcap),
    }


def main(argv=None) -> int:
    device, argv = study.pop_device(sys.argv[1:] if argv is None else argv)
    count = int(argv[0]) if argv else 1_000_000
    reps = int(argv[1]) if len(argv) > 1 else 10
    card = study.card_line(device)
    print(card)
    _, spec, state, dyn, scn, _ = study.settled(dam_break(count, solver_iter=6), device)
    fr = advect_and_sort(spec, state, dyn, scn)
    key, table = fr.index.key, fr.index.table
    print(f"count={count} capacity={spec.capacity} grid={spec.grid.dims} smax={SMAX} "
          f"wcap={WCAP} ({device})")
    calls = stages(key, table, spec.grid, spec.capacity)
    ovf = {k: int(v) for k, v in calls["full plan_compact"]()[1].items()}
    print(f"  overflows {ovf}")
    res = {"card": card, "count": count, "device": str(device), "reps": reps,
           "capacity": spec.capacity, "smax": SMAX, "wcap": WCAP, "overflows": ovf,
           "ms": {}}
    for label, fn in calls.items():
        _, d, h = study.timed(fn, device, reps)
        print(f"  {label:28s}: {study.fmt_ms(d, h)}", flush=True)
        res["ms"][label] = {"device": d, "host": h}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
