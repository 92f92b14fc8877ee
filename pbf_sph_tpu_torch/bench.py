"""Benchmark of the port on one CUDA card: prints ONE JSON line.

    python -m pbf_sph_tpu_torch.bench

Metric: particle-steps/sec on the 1M-particle dam-break, 6 constraint
iterations, solver-only, one card, as the root `bench.py` measures it for the
JAX package.  vs_baseline is the ratio to the north-star target of 60
steps/s at 1M particles (6.0e7 particle-steps/s).  PBF_BENCH_WORKLOAD names
another preset of `core/configs.py`; `mc128k` and `mc512k` add the
marching-cubes surface, whose "mc field" and "mc extract" stages then appear
in the stage table.

Env overrides, as for the root `bench.py`: PBF_BENCH_COUNT, PBF_BENCH_FRAMES,
PBF_BENCH_WARMUP, PBF_BENCH_ITERS, PBF_BENCH_WORKLOAD, and PBF_BENCH_IMPL, the
backend: `torch` (the CUDA kernels, the default) or `gather` (the JAX
package's XLA gather path on plain torch ops).  PBF_BENCH_FP64=1 runs in
float64, which only `gather` accepts.  The JSON line names the backend and
the dtype.  There is no CPU fallback; the run fails without a CUDA device.

After the timed frames it prints to stderr the device time of each stage of
the frame (CUDA events between the stages, over 5 more frames), and
torch.profiler's kernel times and the device's busy share over 3 more frames.
Neither is part of the timed frames.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Tuple

import torch

from pbf_sph_tpu_torch.core.configs import WORKLOADS, dam_break
from pbf_sph_tpu_torch.core.types import FluidState, Scene
from pbf_sph_tpu_torch.models import make_solver
from pbf_sph_tpu_torch.models.growth import growth_changes
from pbf_sph_tpu_torch.models.torch_solver import dyn_params_of

NORTH_STAR = 60.0 * 1_000_000  # particle-steps/s
PHASE_FRAMES = 5
PROFILE_FRAMES = 3


def warm_up(solver, spec, state, dyn, scn, xs, warmup: int):
    """Settle the state and grow capacities, as the root `bench.py` does.

    On ANY overflow the round restarts from a FRESH state under the grown
    spec: frames computed past a capacity are suspect and would inflate every
    later estimate.  Returns (spec, state, frames_run)."""
    frames = 0
    for _round in range(6):
        occs = []
        for _ in range(warmup):
            state, out = solver.step_device(spec, state, dyn, scn)
            occs.append(out["max_occupancy"])
            frames += 1
        # judge the round on its peak occupancy, not just the last frame's
        out = dict(out)
        out["max_occupancy"] = max(int(o) for o in occs)
        changes = growth_changes(spec, out)
        if not changes:
            return spec, state, frames
        print(f"# growing: {changes}", file=sys.stderr)
        spec = dataclasses.replace(spec, **changes)
        state = FluidState.from_soa(xs, spec.capacity, solver.dtype, solver.device)
    raise RuntimeError(f"capacity growth did not converge: {changes}")


def time_frames(solver, spec, state, dyn, scn, frames: int):
    """Run `frames` frames; returns (state, outs, wall_s, device_ms_per_frame).

    The host reads nothing inside the loop.  wall_s is the host clock from a
    synchronised start to a synchronised end; the CUDA events bracket the same
    frames on the device's timeline."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(frames):
        state, out = solver.step_device(spec, state, dyn, scn)
        outs.append(out)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, outs, wall, start.elapsed_time(end) / frames


class PhaseClock:
    """CUDA events recorded as each stage of a frame is enqueued (the step's
    `mark` hook); `totals()` sums the device time between consecutive marks by
    the name of the stage that ends there.  The gap from one frame's last
    stage to the next frame's "begin" is the device waiting on the host.

    `cuda=False` reads the host clock at each mark instead, for a frame on
    the CPU, whose ops have finished when they return."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.events = []

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.events.append((name, ev))

    def totals(self):
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            name = "idle before frame" if name == "begin" else name
            ms = a.elapsed_time(b) if self.cuda else 1000.0 * (b - a)
            out[name] = out.get(name, 0.0) + ms
        return out


def phase_breakdown(solver, spec, state, dyn, scn, frames: int):
    """Mean device ms per frame of each stage; returns (state, {stage: ms})."""
    clock = PhaseClock()
    for _ in range(frames):
        state, _out = solver.step_device(spec, state, dyn, scn, clock.mark)
    return state, {k: v / frames for k, v in clock.totals().items()}


def profile_frames(solver, spec, state, dyn, scn, frames: int):
    """torch.profiler over `frames` frames: (state, busy share, table).  The
    busy share is the summed kernel time over the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            state, _out = solver.step_device(spec, state, dyn, scn)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA)
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    return state, busy_us / wall_us, table


def load_workload() -> Tuple:
    workload = os.environ.get("PBF_BENCH_WORKLOAD", "")
    if workload:
        return WORKLOADS[workload]()
    count = int(os.environ.get("PBF_BENCH_COUNT", 1_000_000))
    iters = int(os.environ.get("PBF_BENCH_ITERS", 6))
    return dam_break(count, solver_iter=iters)


def main() -> int:
    frames = int(os.environ.get("PBF_BENCH_FRAMES", 30))
    warmup = int(os.environ.get("PBF_BENCH_WARMUP", 10))
    impl = os.environ.get("PBF_BENCH_IMPL", "torch")
    dtype = "float64" if os.environ.get("PBF_BENCH_FP64", "") == "1" else "float32"
    mc, cfg, xs = load_workload()
    solver = make_solver(impl, h=cfg.h, dtype=dtype, device="cuda")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, solver.dtype, solver.device)

    spec, state, _ = warm_up(solver, spec, state, dyn, scn, xs, warmup)
    state, outs, wall, dev_ms = time_frames(solver, spec, state, dyn, scn, frames)

    state, stages = phase_breakdown(solver, spec, state, dyn, scn, PHASE_FRAMES)
    state, busy, table = profile_frames(solver, spec, state, dyn, scn, PROFILE_FRAMES)
    print(table, file=sys.stderr)
    print(f"# device busy share over {PROFILE_FRAMES} profiled frames (profiler on): "
          f"{busy:.4f}", file=sys.stderr)

    n = len(xs)
    pps = n * frames / wall
    workload = os.environ.get("PBF_BENCH_WORKLOAD", "") or "dam-break"
    surface = ", surface" if cfg.surface is not None else ""
    print(json.dumps({
        "metric": f"particle-steps/sec ({workload} {n} particles, "
                  f"{cfg.iteration} iters{surface}, {impl}-cuda, {dtype})",
        "value": round(pps, 1),
        "unit": "particle-steps/s",
        "vs_baseline": round(pps / NORTH_STAR, 4),
        "impl": f"{impl}-cuda",
        "dtype": dtype,
        "device": torch.cuda.get_device_name(0),
    }))
    print(
        f"# {frames / wall:.2f} steps/s, {1000 * wall / frames:.2f} ms/step "
        f"(device events {dev_ms:.2f} ms/step), max occupancy "
        f"{max(int(o['max_occupancy']) for o in outs)}, capacity {spec.capacity}",
        file=sys.stderr,
    )
    print("# device ms per frame by stage (CUDA events): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
