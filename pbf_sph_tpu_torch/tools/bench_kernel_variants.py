"""Sweep of the tiled lambda/delta variants on one CUDA card.

    python -m pbf_sph_tpu_torch.tools.bench_kernel_variants [count] [reps]
    python -m pbf_sph_tpu_torch.tools.bench_kernel_variants --ptxas SOURCE

Port of `tools/bench_kernel_variants.py`.  It settles dam_break(count, 6)
(default 1M) with the growth warmup of `bench.warm_up` over 5 frames, takes
the sort-time state of one more advect and sort, and times on it:

* the baseline: the per-row production kernels (`PbfPhases(h)`);
* every tiled variant, sub in {8, 16, 32, 64} x mxu in {0, 1}: the window
  plan, then lambda and delta through `PbfPhases(h, sub, mxu)` (the cull
  kernels) and through the dense kernels (`DenseTiles`, with the wrappers'
  fluid mask and clamp), with the largest |dlambda| (absolute and
  relative) and |dpStar| of the cull kernels against the baseline, whether
  the cull kernels equal the dense ones bit for bit on member rows, and the
  tile's row-candidate pairs and the kept pairs (`tile_keep_plain`)
  against the per-row pairs.

Times are device times of the phase calls (CUDA events over `reps` calls
after a warm one, default 10).  The first line is the card's name and power
limit, then ptxas's registers, spills and shared memory of every kernel of
`csrc/pbf_tiles.cu` (nvcc -Xptxas -v, with the library's flags); a summary
of plan + 6 x (lambda + delta), one constraint solve of dam1m, cull and
dense, follows the rows, and the last line is the table as one JSON
object.
With `--ptxas SOURCE` (a file of csrc/, e.g. pbf_phases2.cu) it only
prints ptxas's registers, spills and shared memory of every kernel of that
file (`ptxas_entries`), one line each, and needs nvcc but no card.
There is no CPU fallback: without a CUDA device the tool fails.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile

import torch

from pbf_sph_tpu_torch.bench import warm_up
from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.types import Scene
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, advect_and_sort, dyn_params_of
from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.ops import tiles as tl

WARMUP = 5
SOLVE_ITERS = 6
VARIANTS = [(sub, mxu) for sub in tl.TILE_SUBS for mxu in (False, True)]
CULL_NAMES = {"lambda_tile": "lambda_tile_cull", "delta_tile": "delta_tile_cull"}


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def ptxas_entries(source: str) -> list:
    """[{entry, registers, spill_bytes, smem_bytes}] of every kernel of
    csrc/`source` (entry: its mangled name), from `nvcc -Xptxas -v` with the
    library's flags (one object, no link)."""
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             f"{tmp}/kernels.o", str(cuda_build.SRC_DIR / source)],
            capture_output=True, text=True, check=True)
    rows = []
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            rows.append(dict(entry=m.group(1)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and rows:
            rows[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1].update(registers=int(m.group(1)),
                            smem_bytes=int(smem.group(1)) if smem else 0)
    return rows


def ptxas_report() -> list:
    """[{kernel, sub, mxu, pair, registers, spill_bytes, smem_bytes}] of every
    kernel of csrc/pbf_tiles.cu (`ptxas_entries`)."""
    rows = []
    for r in ptxas_entries("pbf_tiles.cu"):
        m = re.search(r"(tile_cull_kernel|tile_kernel)ILi(\d+)ELb([01])ENS_\d+(Lambda|Delta)Pair",
                      r.pop("entry"))
        if m:
            rows.append(dict(kernel=m.group(1), sub=int(m.group(2)), mxu=int(m.group(3)),
                             pair=m.group(4), **r))
    return sorted(rows, key=lambda r: (r["kernel"], r["pair"], r["sub"], r["mxu"]))


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
    if argv[:1] == ["--ptxas"]:
        for r in ptxas_entries(argv[1]):
            print(f"ptxas {r['entry']}: {r.get('registers')} registers, "
                  f"{r.get('spill_bytes')} bytes spilled, {r.get('smem_bytes')} bytes smem")
        return 0
    count = int(argv[0]) if argv else 1_000_000
    reps = int(argv[1]) if len(argv) > 1 else 10
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernel_variants: needs a CUDA device")
    card = card_line()
    print(card)
    ptxas = ptxas_report()
    for r in ptxas:
        print(f"ptxas {r['kernel']:16s} {r['pair']:6s} sub {r['sub']:2d} mxu {r['mxu']}: "
              f"{r['registers']} registers, {r['spill_bytes']} bytes spilled, "
              f"{r['smem_bytes']} bytes smem")

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

    member = idx.key < idx.grid.ncells
    fluid = (st.ptype == ph.FLUID) & st.alive
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
                   pairs=pairs, pairs_vs_per_row=pairs / row_pairs)
        if variant is not None:
            tiles = phases.plan(idx)
            dense = tl.DenseTiles(spec.h, sub, mxu)
            dl_fn = lambda: torch.where(  # noqa: E731
                fluid, dense.lambda_raw(tiles, idx, fr.pstar, st.mass), 0.0)
            dd_fn = lambda: ph.clamp_to_bounds(  # noqa: E731
                fr.pstar, dense.delta_raw(tiles, idx, fr.pstar, lam), st.ptype, st.alive,
                *bounds)
            same = (torch.equal(dl_fn()[member], lam[member])
                    and torch.equal(dd_fn()[:, member], moved[:, member]))
            dlam_ms, ddel_ms = device_ms(dl_fn, reps), device_ms(dd_fn, reps)
            kept = tl.kept_tile_pairs(tl.tile_keep_plain(tiles, idx, fr.pstar, sub, mxu,
                                                         spec.h), tiles)
            row.update(dense_lambda_ms=dlam_ms, dense_delta_ms=ddel_ms,
                       dense_solve_ms=plan_ms + SOLVE_ITERS * (dlam_ms + ddel_ms),
                       kept_pairs=kept, kept_vs_per_row=kept / row_pairs,
                       cull_equals_dense=same)
        row["launches"] = dict(phases.launches)
        if variant is not None:
            # PbfPhases counts its cull kernels as lambda_tile/delta_tile: here
            # they go by the kernels line's names, beside the dense kernels'
            row["launches"] = {CULL_NAMES.get(k, k): v
                               for k, v in phases.launches.items()} | dense.launches
        if ref is None:
            ref = (lam, moved)
            parity = "(baseline)"
        else:
            dl = (lam - ref[0]).abs()
            row.update(max_dlambda=float(dl.max()),
                       max_dlambda_rel=float((dl / (ref[0].abs() + 1e-6)).max()),
                       max_dpstar=float((moved - ref[1]).abs().max()))
            parity = (f"max|dlam| {row['max_dlambda']:.3e} (rel "
                      f"{row['max_dlambda_rel']:.3e}), max|dpStar| {row['max_dpstar']:.3e}; "
                      f"dense: lambda {row['dense_lambda_ms']:.4f} delta "
                      f"{row['dense_delta_ms']:.4f} ms, bit for bit "
                      f"{row['cull_equals_dense']}; kept pairs {row['kept_pairs']} "
                      f"({row['kept_vs_per_row']:.3f}x)")
        print(f"{tag:16s} plan {plan_ms:8.4f}  lambda {lam_ms:8.4f}  delta {del_ms:8.4f} ms"
              f"  pairs {pairs} ({pairs / row_pairs:.2f}x)  {parity}")
        rows.append(row)
        torch.cuda.empty_cache()

    print(f"\nsummary (plan + {SOLVE_ITERS} x (lambda + delta), device ms; the tiles "
          f"on the cull kernels, dense beside):")
    for row in rows:
        dense = (f"  dense lam {row['dense_lambda_ms']:8.4f}  del {row['dense_delta_ms']:8.4f}"
                 f"  solve{SOLVE_ITERS} {row['dense_solve_ms']:9.4f}"
                 if "dense_solve_ms" in row else "")
        print(f"  {row['variant']:16s} plan {row['plan_ms']:8.4f}  lam {row['lambda_ms']:8.4f}"
              f"  del {row['delta_ms']:8.4f}  solve{SOLVE_ITERS} {row['solve_ms']:9.4f}{dense}")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "ptxas": ptxas,
                      "count": len(xs), "capacity": spec.capacity, "reps": reps,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
