"""The stage split of a surface frame: the full step against the
solver-only step, advect + sort + table, + the MC field, + the extraction.

Port of `tools/bench_mc_split.py`.  From the workload's state after 5
settling frames (`bench.warm_up`, growth included) it times, each over 8
calls after a warm one, on CUDA events and on the host clock: the full
step, the step with the surface off, `advect_and_sort`, that + the MC field
(row 4b, `ops/mc_field.py`, on the sorted pre-finalise positions, as the JAX
tool's field part), and that + `mc_extract`.  The differences give the MC
total, the field alone and the extraction alone.  The JAX tool's
`PBF_MC_SUB` (the Pallas field's sub-block rows) has no counterpart: row 4b
has no sub-block.

    python -m pbf_sph_tpu_torch.tools.bench_mc_split [workload] [reps] [--devices cpu]

`workload` is a name of `core/configs.WORKLOADS` with a surface (default
mc128k), a particle count for mc128k's scene or `cubes:n`
(`study.workload_of`; e.g. `cubes:1500 1` on the CPU).  JSON last.
"""

from __future__ import annotations

import dataclasses
import json
import sys

from pbf_sph_tpu_torch.models.torch_solver import advect_and_sort
from pbf_sph_tpu_torch.ops.mc import mc_extract
from pbf_sph_tpu_torch.ops.pbf import scalar
from pbf_sph_tpu_torch.tools import study

REPS = 8


def split(solver, spec, state, dyn, scn, reps: int = REPS) -> dict:
    """{stage: (device ms or None, host ms)} of the five timed parts."""
    dev = solver.device
    out = {}

    def stepper(sp):
        st = [state]

        def run():
            st[0], o = solver.step_device(sp, st[0], dyn, scn)
            return o
        return run

    out["full step"] = study.timed(stepper(spec), dev, reps)[1:]
    out["solver-only step"] = study.timed(
        stepper(dataclasses.replace(spec, surface=None)), dev, reps)[1:]

    def sort_part():
        return advect_and_sort(spec, state, dyn, scn)

    def field_part():
        return study.lattice(solver, spec, sort_part(), dyn)

    def extract_part():
        fr = sort_part()
        v, n, c = study.lattice(solver, spec, fr, dyn)
        return mc_extract(v, n, c, fr.min_extent, spec.surface, spec.h,
                          scalar(spec.scale, v), dyn["mc_isolevel"])

    out["advect+sort+table"] = study.timed(sort_part, dev, reps)[1:]
    out["  +mc field"] = study.timed(field_part, dev, reps)[1:]
    out["  +mc extract"] = study.timed(extract_part, dev, reps)[1:]
    return out


def differences(parts: dict) -> dict:
    """MC total, field alone and extract alone, in the device and host ms."""
    def diff(a, b):
        return tuple(None if x is None else x - y for x, y in zip(parts[a], parts[b]))

    return {"MC total (full - solver-only)": diff("full step", "solver-only step"),
            "field alone": diff("  +mc field", "advect+sort+table"),
            "extract alone": diff("  +mc extract", "  +mc field")}


def main(argv=None) -> int:
    device, argv = study.pop_device(sys.argv[1:] if argv is None else argv)
    name = argv[0] if argv else "mc128k"
    reps = int(argv[1]) if len(argv) > 1 else REPS
    card = study.card_line(device)
    print(card)
    solver, spec, state, dyn, scn, _ = study.settled(study.workload_of(name), device)
    if spec.surface is None:
        raise SystemExit(f"bench_mc_split: {name} has no surface")
    print(f"{name}: capacity={spec.capacity} grid={spec.grid.dims} "
          f"sample={spec.surface.sample} tri_cap={spec.surface.tri_capacity} "
          f"cube_cap={spec.surface.cube_cap} ({device})")
    parts = split(solver, spec, state, dyn, scn, reps)
    for k, (d, h) in parts.items():
        print(f"  {k:26s}: {study.fmt_ms(d, h)}")
    diffs = differences(parts)
    for k, (d, h) in diffs.items():
        print(f"{k:28s}: {study.fmt_ms(d, h)}")
    print(json.dumps({"card": card, "workload": name, "device": str(device),
                      "reps": reps, "ms": {k: {"device": d, "host": h}
                                           for k, (d, h) in {**parts, **diffs}.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
