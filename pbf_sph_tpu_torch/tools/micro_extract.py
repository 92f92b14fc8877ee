"""MC emission strategies on a settled state.

Port of `tools/micro_extract.py`.  From the lattice of a settled workload
(default mc512k: 5 frames of `bench.warm_up`, then `advect_and_sort` and
row 4b's field on the sorted positions, as the JAX tool's
`lattice_inputs`) it measures:

1. the per-block live-row census for each block size B: a block's live
   vertex rows bound the staging rows its blocked emission needs;
2. the port's production emission, `mc_extract` under the workload's spec
   (cube compaction at mc512k, then one scatter to the destinations), in
   the place of the JAX tool's "current global sort"; beside it the JAX
   package's 11-operand global sort of the 15*M slot rows (one sort of the
   destination keys, then the 10 payload rows gathered in that order: torch
   sorts one operand), and the payload build alone;
3. the blocked two-stage emission (`McSpec.emit_block`/`emit_cap`, cube
   compaction off) at each B, with emit_cap the census's smax;
4. the 9-operand ablation: the same global sort carrying 8 payload rows;
5. the compacted emission at cube_cap 1.25x, 2x and 4x the live cubes.

Each is timed over 8 calls after a warm one on CUDA events and the host
clock, and each emission's mesh is compared with the production mesh.

    python -m pbf_sph_tpu_torch.tools.micro_extract [workload] [B ...] [--devices cpu]

`workload` is a name of `core/configs.WORKLOADS` with a surface, a
particle count for mc128k's scene or `cubes:n` (`study.workload_of`; e.g.
`cubes:1500 64 512` on the CPU); a single B of 0 skips the blocked
emission.  JSON last.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch

from pbf_sph_tpu_torch.models.torch_solver import advect_and_sort
from pbf_sph_tpu_torch.ops import mc as mc_ops
from pbf_sph_tpu_torch.ops.pbf import scalar
from pbf_sph_tpu_torch.tools import study

REPS = 8
BIG = 1 << 30


def lattice_inputs(workload, device):
    """(lattice args of `mc_extract` but the spec, spec) of the settled
    workload: ((lat_v, lat_n, lat_c, min_extent), spec, h, scale, iso)."""
    solver, spec, state, dyn, scn, _ = study.settled(workload, device)
    fr = advect_and_sort(spec, state, dyn, scn)
    lat = study.lattice(solver, spec, fr, dyn)
    study.sync(device)
    return (*lat, fr.min_extent), spec.surface, spec.h, scalar(spec.scale, lat[0]), \
        dyn["mc_isolevel"]


def block_census(ntris: np.ndarray, blocks) -> dict:
    """{B: (nblk, live rows of each block)} from the per-cube triangle
    counts: a block's live vertex rows are 3x its triangles."""
    csum = np.concatenate([[0], np.cumsum(ntris)])
    M = len(ntris)
    out = {}
    for B in blocks:
        nblk = -(-M // B)
        ends = np.minimum(np.arange(1, nblk + 1) * B, M)
        out[B] = (nblk, 3 * (csum[ends] - csum[np.arange(nblk) * B]))
    return out


def staging_rows(live: np.ndarray) -> int:
    """The least 128-aligned staging rows that hold every block (>= 128)."""
    return max(128, -(-int(live.max()) // 128) * 128)


def global_sort(ntris, offs, tri15, payload, total, cap3: int, nvals: int = 10):
    """The JAX package's global-sort emission: every slot row keyed by its
    destination (BIG for a dead slot), sorted, the first cap3 rows kept and
    the tail past 3 * total zeroed; `nvals` payload rows carried (10, or 8
    for the ablation).  Returns (nvals, cap3)."""
    dest, live, vals = mc_ops.slot_rows(ntris, offs, tri15, payload)
    key = torch.where(live, dest, BIG).reshape(-1)
    pay = vals[:nvals].reshape(nvals, -1)
    nslot = key.shape[0]
    if nslot < cap3:
        key = torch.cat([key, key.new_full((cap3 - nslot,), BIG)])
        pay = torch.cat([pay, pay.new_zeros((nvals, cap3 - nslot))], dim=1)
    order = torch.sort(key).indices[:cap3]
    out = pay[:, order]
    keep = torch.arange(cap3, device=key.device) < total * 3
    return torch.where(keep[None, :], out, 0.0)


def max_diff(a, b) -> float:
    return float((torch.nan_to_num(a) - torch.nan_to_num(b)).abs().max())


def main(argv=None) -> int:
    device, argv = study.pop_device(sys.argv[1:] if argv is None else argv)
    name = argv[0] if argv else "mc512k"
    blocks = [int(a) for a in argv[1:]] or [512, 2048, 8192]
    blocks = [b for b in blocks if b > 0]
    card = study.card_line(device)
    print(card)
    lat, spec, h, scale, iso = lattice_inputs(study.workload_of(name), device)
    cap3 = spec.tri_capacity * 3
    flat = dataclasses.replace(spec, cube_cap=0, emit_block=0, emit_cap=0)

    def extract(sp):
        return lambda: mc_ops.mc_extract(*lat, sp, h, scale, iso)

    def inputs():
        return mc_ops.emission_inputs(*lat, flat, h, scale, iso)

    ntris, offs, total, tri15, payload, _ = inputs()
    ntris_h, total = ntris.cpu().numpy(), int(total)
    M = len(ntris_h)
    print(f"{name}: M={M} cubes, 15M={15 * M} slot rows, live={3 * total} "
          f"({3 * total / (15 * M):.1%}), tri_cap3={cap3} ({device})")
    res = {"card": card, "workload": name, "device": str(device), "reps": REPS, "M": M,
           "live_rows": 3 * total, "census": {}, "ms": {}, "parity": {}}

    census = block_census(ntris_h, blocks)
    for B, (nblk, live) in census.items():
        smax = staging_rows(live)
        print(f"  B={B:6d}: nblk={nblk:6d} live max={live.max():6d} mean={live.mean():8.1f} "
              f"-> smax={smax} stage2 rows={nblk * smax} ({nblk * smax / (15 * M):.1%} of 15M)")
        res["census"][B] = dict(nblk=nblk, live_max=int(live.max()),
                                live_mean=float(live.mean()), smax=smax)

    def run(label, fn):
        out, d, hms = study.timed(fn, device, REPS)
        print(f"  {label:34s}: {study.fmt_ms(d, hms)}", flush=True)
        res["ms"][label] = {"device": d, "host": hms}
        return out

    def parity(label, got, ovf=None):
        d = max(max_diff(g, r) for g, r in zip(got, ref[:3]))
        print(f"    parity vs production: max|diff|={d:.3g}"
              + ("" if ovf is None else f" emit_ovf={int(ovf)}"))
        res["parity"][label] = {"max_diff": d, "emit_overflow": None if ovf is None else int(ovf)}

    run("payload build only", inputs)
    ref = run(f"production scatter (cube_cap={spec.cube_cap})", extract(spec))
    args = (ntris, offs, tri15, payload, total, cap3)
    got = run("11-operand global sort", lambda: global_sort(*args))
    parity("11-operand global sort", (got[0:3], got[3:6], got[6:10]))
    run("9-operand global sort (ablation)", lambda: global_sort(*args, nvals=8))

    for B in blocks:
        smax = res["census"][B]["smax"]
        label = f"blocked B={B} smax={smax}"
        got = run(label, extract(dataclasses.replace(flat, emit_block=B, emit_cap=smax)))
        parity(label, got[:3], got[4])

    nlive = int((ntris_h > 0).sum())
    print(f"  live cubes: {nlive} of {M} ({nlive / M:.1%})")
    res["live_cubes"] = nlive
    for K in sorted({-(-int(nlive * f) // 128) * 128 for f in (1.25, 2.0, 4.0)}):
        label = f"compacted cube_cap={K}"
        got = run(label, extract(dataclasses.replace(spec, cube_cap=K)))
        parity(label, got[:3], got[4])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
