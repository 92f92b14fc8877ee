"""The main path's λ/Δp kernels against the per-row kernels, on one CUDA card.

    python -m pbf_sph_tpu_torch.tools.bench_cells [--sweep] [count] [reps]

`pbf_lambda_cells` and `pbf_delta_cells` (`csrc/pbf_cells.cu`, `ops/cells.py`;
the direct walk, the main path) and their staged walk (`csrc/cells_staged.cu`,
`tools/cells_staged.py`), beside `pbf_lambda` and
`pbf_delta` (`csrc/pbf_phases.cu`), at the settled sort-time state of
dam_break(count, 6) (default 1M; `anchor_rate.settled_dam1m`: the growth
warmup over 5 frames, then one advect and sort):

* the SASS of the four kernels (cuobjdump): each pair loop's fp32-pipe
  instructions a pair beside the per-row kernel's, one MUFU.RSQ and one
  float4 read a pair (the direct walk's from device memory, the staged
  walk's from shared memory, and no read of the other kind in the loop), no
  local memory in the kernel;
* the runs the staged kernels cut (`cells_staged.plan_runs`, their plain
  version): CTAs,
  runs, CTAs at the cap of runs, the mean and largest union, the CTAs
  staged in more than one piece;
* parity of each walk: each kernel against its plain version (λ atol 1e-6,
  rtol 1e-5; pStar atol 1e-5) and against the per-row kernel with the
  wrapper's mask or clamp (the largest difference, and whether every bit
  agrees);
* device ms by `anchor_rate.held_ms` over `reps` calls (default 20), in
  turns per-row, wrapper, direct, staged, staged, direct, wrapper, per-row:
  each per-row kernel on a (C, 4) pack made beforehand, its wrapper with the
  pack and the mask or clamp, and both walks on their packs; beside each
  the bound and the anchored ms (the per-row pairs over the body ceilings
  that `tools/anchor_rate.py` measured: for the cells kernels its blocked
  bodies', which run their pair code);
* with --sweep, the staged kernels built at each CTA and stage size of
  SWEEP (`-DCELLS_STAGED_ROWS`, `-DCELLS_STAGED_STAGE`), timed and checked
  against the direct walk bit for bit.

The first line is the card's name and power limit, the last one JSON object.
The exit code is 1 if the SASS or the parity is not as designed; the times
are printed either way.  There is no CPU fallback: without a CUDA device the
tool fails.
"""

from __future__ import annotations

import collections
import json
import sys
from typing import Dict

import torch

from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.types import FLUID
from pbf_sph_tpu_torch.models.torch_solver import dyn_params_of
from pbf_sph_tpu_torch.ops import cells, cuda_build
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.tools import anchor_rate as ar
from pbf_sph_tpu_torch.tools import cells_staged as cs
from pbf_sph_tpu_torch.tools.micro_mc_field import bound_ms
from pbf_sph_tpu_torch.tools.micro_roll import nbytes

# fp32 operations a candidate pair, as chip_smoke.py counts them for the
# per-row kernels: the cells kernels compute the same pairs
FLOP_PER_PAIR = {"lambda": 26, "delta": 34}
# the λ/Δp body ceilings that tools/anchor_rate.py measured (G pair-slots/s,
# NVIDIA H100 80GB HBM3 at 700 W): the anchored ms of rows 1-2 in PERF.md;
# and its blocked bodies' ceilings, which run the cells kernels' pair code
# (csrc/pbf_cells_pair.cuh): the anchored ms of rows 1b/2b/1c/2c
BODY_CEILING = {"lambda": 1224.2e9, "delta": 951.5e9}
CELLS_CEILING = {"lambda": 1496.6e9, "delta": 1070.5e9}
# the kernels of csrc/pbf_cells.cu (direct walk) and csrc/cells_staged.cu
# (staged walk) by name suffix, and the per-row kernels they take the place of
KERNELS = {"lambda": ({"": ar.CELLS_KERNELS["lambda"], "_staged": "20lambda_staged_kernel"},
                      ar.PHASE_KERNELS["lambda"]),
           "delta": ({"": ar.CELLS_KERNELS["delta"], "_staged": "19delta_staged_kernel"},
                     ar.PHASE_KERNELS["delta"])}
# rsqrtf's denormal guard, which the cells pair terms leave out: an FSETP,
# an FSEL and two FMULs a pair (the SASS of pbf_lambda and pbf_delta)
GUARD = collections.Counter({"FSETP": 1, "FSEL": 1, "FMUL": 2})
# each walk's kernels and plain versions (λ kernel, Δp kernel, λ plain, Δp
# plain), by staged
WALKS = {False: (cells.lambda_cells_kernel, cells.delta_cells_kernel,
                 cells.lambda_cells_plain, cells.delta_cells_plain),
         True: (cs.lambda_staged_kernel, cs.delta_staged_kernel,
                cs.lambda_staged_plain, cs.delta_staged_plain)}
# (CTA rows, staged candidates) that --sweep builds csrc/cells_staged.cu with
SWEEP = [(128, 2048), (128, 1536), (256, 2560), (64, 1024)]


def check_sass(lib_path) -> Dict[str, dict]:
    """`check_funcs` of the built library."""
    return check_funcs(ar.sass_functions(lib_path))


def check_funcs(funcs) -> Dict[str, dict]:
    """name -> dict(ok, counts): each kernel's pair loop holds one MUFU.RSQ and
    one float4 read a pair (direct LDG.128, staged LDS.128) and no read of
    the other kind, its fp32-pipe instructions a pair are the per-row
    kernel's without rsqrtf's denormal guard (GUARD), opcode by opcode, and
    the kernel has no local-memory load or store."""
    report = {}
    for which, (walks, old) in KERNELS.items():
        want = collections.Counter(ar.fp32_per_pair(ar.pair_loop(ar._one(funcs, old))))
        want.subtract(GUARD)
        want = {k: v for k, v in want.items() if v}
        for suffix, new in walks.items():
            sass = ar._one(funcs, new)
            loop = ar.pair_loop(sass)
            rsq = max(loop["MUFU.RSQ"], 1)
            lds = sum(v for k, v in loop.items() if k.startswith("LDS"))
            ldg = sum(v for k, v in loop.items() if k.startswith("LDG"))
            lds128 = sum(v for k, v in loop.items() if k.startswith("LDS") and "128" in k)
            ldg128 = sum(v for k, v in loop.items() if k.startswith("LDG") and "128" in k)
            reads, other = (lds128, ldg) if suffix else (ldg128, lds)
            local = sum(1 for _, op, _ in sass[0] if op.split(".")[0] in ("LDL", "STL"))
            per_pair = ar.fp32_per_pair(loop)
            report[f"pbf_{which}_cells{suffix}"] = dict(
                ok=loop["MUFU.RSQ"] > 0 and reads == loop["MUFU.RSQ"] and other == 0
                and local == 0 and per_pair == want,
                pairs_a_loop=loop["MUFU.RSQ"], fp32_per_pair=sum(per_pair.values()),
                per_row_fp32_per_pair=sum(want.values()) + sum(GUARD.values()),
                opcodes=per_pair, float4_reads_a_pair=reads / rsq, other_reads=other,
                local=local, insts_per_pair=sum(loop.values()) / rsq)
    return report


def pair_slots(index, warp: int = 32) -> int:
    """Lane-pairs the per-row walk issues: for every warp of `warp`
    consecutive rows and each of the nine ranges, the longest range of its
    lanes, times the lanes (the same warps in both designs)."""
    lo, hi = ph.neighbour_ranges(index)
    n = lo.shape[1] // warp * warp
    width = (hi - lo)[:, :n].reshape(9, -1, warp)
    return int(width.max(2).values.sum()) * warp


def variant_libraries(sizes):
    """{(rows, stage): ctypes library}: csrc/cells_staged.cu built alone with
    CELLS_STAGED_ROWS and CELLS_STAGED_STAGE, one nvcc for each, all at once,
    into the build directory (named by the source's hash)."""
    import ctypes
    import hashlib
    import subprocess

    src = cs.SOURCE
    digest = hashlib.sha256(src.read_bytes() + (cuda_build.SRC_DIR / "pbf_cells_pair.cuh")
                            .read_bytes()).hexdigest()[:12]
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for rows, stage in sizes:
        out = cuda_build.BUILD_DIR / f"libcells_staged_{rows}_{stage}_{digest}.so"
        cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, f"-DCELLS_STAGED_ROWS={rows}",
               f"-DCELLS_STAGED_STAGE={stage}", "-shared", "-o", str(out), str(src)]
        procs[rows, stage] = (out, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for size, (out, cmd, proc) in procs.items():
        cuda_build._check_nvcc(cmd, proc.wait(), proc.stdout.read())
        lib = ctypes.CDLL(str(out))
        for name in ("pbf_lambda_cells_staged", "pbf_delta_cells_staged"):
            getattr(lib, name).argtypes = cuda_build.SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        libs[size] = lib
    return libs


def sweep(f: "Frame", sizes, reps: int) -> dict:
    """Device ms (held_ms) of the staged kernels built at each (rows, stage),
    on f's inputs, each checked against the direct walk's output."""
    libs = variant_libraries(sizes)
    want_b = f.lambda_cells()
    want_a = f.delta_cells(want_b)
    out = {}
    for (rows, stage), lib in libs.items():
        entry = out[f"{rows}x{stage}"] = cs.plan_stats(cs.plan_runs(f.index, rows), stage)
        b = torch.empty_like(f.pack_a)
        a = f.pack_a.clone()
        lam = lambda: lib.pbf_lambda_cells_staged(  # noqa: E731
            *cells.lambda_cells_args(f.index, f.h, f.pack_a, f.fluid, b))
        dlt = lambda: lib.pbf_delta_cells_staged(  # noqa: E731
            *cells.delta_cells_args(f.index, f.h, want_b, f.fluid, *f.bounds, a))
        entry["lambda_staged_ms"] = ar.held_ms(lam, reps)
        entry["delta_staged_ms"] = ar.held_ms(dlt, reps)
        torch.cuda.synchronize()
        entry["same"] = bool(torch.equal(b, want_b) and torch.equal(a, want_a))
    return out


class Frame:
    """A sort-time frame's inputs to the cells kernels: the staged walk's
    runs, the packs A (pStar, mass) and B (filled by `lambda_cells_kernel`),
    the fluid mask and the bounds."""

    def __init__(self, spec, dyn, fr):
        st = fr.state
        self.spec, self.fr, self.index, self.h = spec, fr, fr.index, spec.h
        self.pstar, self.mass = fr.pstar, st.mass
        self.ptype, self.alive = st.ptype, st.alive
        self.fluid = (st.ptype == FLUID) & st.alive
        self.scale = torch.full((), spec.scale, dtype=torch.float32, device=st.mass.device)
        self.bounds = (self.scale, dyn["min_bound"], dyn["max_bound"])
        self.runs = cs.plan_runs(self.index)
        self.pack_a = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], st.mass], dim=1)
        self.pack_b = torch.empty_like(self.pack_a)
        lo, hi = ph.neighbour_ranges(self.index)
        self.pairs = int((hi - lo).sum())

    def lambda_cells(self, out=None, staged: bool = False):
        out = torch.empty_like(self.pack_a) if out is None else out
        WALKS[staged][0](self.index, self.h, self.pack_a, self.fluid, out)
        return out

    def delta_cells(self, pack_b, out=None, staged: bool = False):
        out = self.pack_a.clone() if out is None else out
        WALKS[staged][1](self.index, self.h, pack_b, self.fluid, *self.bounds, out)
        return out

    def lambda_rows(self):
        """The per-row kernel and the wrapper's mask."""
        lam = ph.lambda_kernel(self.index, self.h, self.pstar, self.mass)
        return torch.where(self.fluid, lam, 0.0)

    def delta_rows(self, lam):
        """The per-row kernel and the wrapper's clamp."""
        dp = ph.delta_kernel(self.index, self.h, self.pstar, lam.contiguous())
        return ph.clamp_to_bounds(self.pstar, dp, self.ptype, self.alive, *self.bounds)


def parity(f: Frame, staged: bool = False) -> dict:
    """One walk's kernels against their plain versions and against the
    per-row kernels with the wrappers' mask and clamp, on f's inputs."""
    b = f.lambda_cells(staged=staged)
    b_plain = torch.empty_like(b)
    WALKS[staged][2](f.index, f.h, f.pack_a, f.fluid, b_plain)
    a = f.delta_cells(b, staged=staged)
    a_plain = f.pack_a.clone()
    WALKS[staged][3](f.index, f.h, b, f.fluid, *f.bounds, a_plain)
    lam_rows = f.lambda_rows()
    moved_rows = f.delta_rows(b[:, 3])
    moved = a[:, :3].T
    return dict(
        lambda_err=float((b[:, 3] - b_plain[:, 3]).abs().max()),
        lambda_ok=bool(torch.allclose(b[:, 3], b_plain[:, 3], atol=1e-6, rtol=1e-5)),
        pstar_err=float((a[:, :3] - a_plain[:, :3]).abs().max()),
        packs_kept=bool(torch.equal(b[:, :3], f.pack_a[:, :3])
                        and torch.equal(a[:, 3], f.mass)),
        finite=bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
        lambda_rows_diff=float((b[:, 3] - lam_rows).abs().max()),
        lambda_rows_bits=bool(torch.equal(b[:, 3], lam_rows)),
        pstar_rows_diff=float((moved - moved_rows).abs().max()),
        pstar_rows_bits=bool(torch.equal(moved, moved_rows)),
    )


def cells_bounds(f: Frame) -> dict:
    """(bound_ms, bound_by) of each cells kernel, either walk: the pack, key, table and
    mask read once, the pack written once; the pairs' operations."""
    rd = nbytes(f.pack_a, f.index.key, f.index.table, f.fluid)
    return {
        "lambda": bound_ms(rd + nbytes(f.pack_b), f.pairs * FLOP_PER_PAIR["lambda"]),
        "delta": bound_ms(rd + 12 * f.pack_a.shape[0] + nbytes(*f.bounds),
                          f.pairs * FLOP_PER_PAIR["delta"]),
    }


def timings(f: Frame, reps: int) -> dict:
    """Device ms (`held_ms`) of each kernel at f, in turns per-row, wrapper,
    direct, staged, staged, direct, wrapper, per-row."""
    lam_out = torch.empty_like(f.mass)
    dp_out = torch.empty_like(f.pstar)
    b = f.lambda_cells()
    cand_a = f.pack_a.clone()
    cand_b = b.clone()
    a_out = f.pack_a.clone()
    b_out = torch.empty_like(b)
    runs = {
        "pbf_lambda": lambda: ph.lambda_launch(f.index, f.h, cand_a, lam_out),
        "lambda wrapper": lambda: f.lambda_rows(),
        "pbf_lambda_cells": lambda: f.lambda_cells(b_out),
        "pbf_lambda_cells staged": lambda: f.lambda_cells(b_out, staged=True),
        "pbf_delta": lambda: ph.delta_launch(f.index, f.h, cand_b, dp_out),
        "delta wrapper": lambda: f.delta_rows(b[:, 3]),
        "pbf_delta_cells": lambda: f.delta_cells(b, a_out),
        "pbf_delta_cells staged": lambda: f.delta_cells(b, a_out, staged=True),
    }
    turn = ["pbf_{}", "{} wrapper", "pbf_{}_cells", "pbf_{}_cells staged"]
    order = [t.format(w) for w in ("lambda", "delta") for t in turn + turn[::-1]]
    ms = collections.defaultdict(list)
    for name in order:
        ms[name].append(ar.held_ms(runs[name], reps))
    return dict(ms)


def main(argv=None) -> int:
    from pbf_sph_tpu_torch.tools.bench_kernel_variants import card_line

    argv = sys.argv[1:] if argv is None else argv
    do_sweep = "--sweep" in argv
    argv = [a for a in argv if a != "--sweep"]
    count = int(argv[0]) if argv else 1_000_000
    reps = int(argv[1]) if len(argv) > 1 else 20
    if not torch.cuda.is_available():
        raise SystemExit("bench_cells: needs a CUDA device")
    card = card_line()
    print(card)
    cuda_build.library()
    sass = check_sass(cuda_build.library_path())
    print("== SASS of csrc/pbf_cells.cu (cuobjdump)")
    for name, r in sass.items():
        print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in r.items()))

    spec, fr = ar.settled_dam1m(count)
    f = Frame(spec, dyn_params_of(dam_break(count)[1], device=fr.pstar.device), fr)
    stats = cs.plan_stats(f.runs)
    members = int(f.index.table[-1])
    slots = pair_slots(f.index)
    print(f"== dam_break({count}, 6) settled sort-time state: {members} member rows of "
          f"{spec.capacity}, {f.pairs} per-row pairs, {slots} pair-slots of the walk "
          f"({f.pairs / slots:.4f} of them pairs); staged runs {stats}")
    par = {"direct": parity(f), "staged": parity(f, staged=True)}
    for walk, r in par.items():
        print(f"== parity, {walk} walk: " + ", ".join(f"{k} {v}" for k, v in r.items()))
    ms = timings(f, reps)
    bounds = cells_bounds(f)
    print(f"== device ms (held_ms over {reps} calls, in turns)")
    for name, t in ms.items():
        which = "lambda" if "lambda" in name else "delta" if "delta" in name else None
        extra = ""
        if which and "cells" in name:
            b_ms, b_by = bounds[which]
            extra = f"; bound {b_ms:.4f} ms by {b_by}"
        if which:
            ceiling = (CELLS_CEILING if "cells" in name else BODY_CEILING)[which]
            extra += f"; anchored {f.pairs / ceiling * 1e3:.4f} ms"
        print(f"  {name}: {', '.join(f'{v:.4f}' for v in t)}{extra}")
    swept = {}
    if do_sweep:
        swept = sweep(f, SWEEP, reps)
        print("== CTA and stage sizes (rows x staged candidates; held_ms)")
        for name, r in swept.items():
            print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in r.items()))
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "count": count,
                      "reps": reps, "members": members, "pairs": f.pairs,
                      "pair_slots": slots, "plan": stats, "sweep": swept,
                      "sass": sass, "parity": par, "ms": ms,
                      "bound_ms": {k: v[0] for k, v in bounds.items()},
                      "anchored_ms": {k: f.pairs / v * 1e3 for k, v in BODY_CEILING.items()},
                      "cells_anchored_ms": {k: f.pairs / v * 1e3
                                            for k, v in CELLS_CEILING.items()}}))
    # the times stand with the kernels as they are; the exit code says
    # whether they are as designed
    if not all(r["ok"] for r in sass.values()):
        print("bench_cells: a cells kernel's SASS is not as designed", file=sys.stderr)
        return 1
    if not all(r["lambda_ok"] and r["pstar_err"] <= 1e-5 and r["packs_kept"] and r["finite"]
               for r in par.values()):
        print("bench_cells: a cells kernel disagrees with its plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
