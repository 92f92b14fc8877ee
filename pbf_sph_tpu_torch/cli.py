"""Benchmark CLI of the port, the headless entry point.

    python -m pbf_sph_tpu_torch.cli [--impl torch|gather] [--fp64] ...

Port of the single-chip path of `pbf_sph_tpu/cli.py`, which mirrors the
reference benchmark's flags and output (reference `src/args.hpp:38-56`,
`src/args.cpp:7-75`, `src/benchmark.cpp:77-175`):
  --impl {torch,gather}   the CUDA kernels (fp32), or the JAX package's XLA
                          gather path on plain torch ops (fp32 or fp64)
  --list --verbose --devices --iter --warmup --fp64 --output
plus --workload, --count, --no-surface and --phase-timings.  The multi-chip
flags of the JAX CLI are not ported yet.

Default workload is the reference benchmark: 20k particles (two cubes),
6 constraint iterations, scale 500, surface on, oscillating bounds, 200 warmup
+ 200 timed frames (reference `src/benchmark.cpp:23-29,78`).

The CLI runs on `cuda:0` unless `--devices` picks another CUDA device by
index or by name; `--devices cpu` is the one way to run on the CPU.  Without
a CUDA device it fails.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import List

import numpy as np
import torch

from pbf_sph_tpu_torch.core.configs import WORKLOADS
from pbf_sph_tpu_torch.core.scene import apply_motion_sin_x_cos_z
from pbf_sph_tpu_torch.core.types import Scene
from pbf_sph_tpu_torch.models import BACKENDS, make_solver
from pbf_sph_tpu_torch.utils.stopwatch import Stopwatch

DEFAULT_ITER = 200
DEFAULT_WARMUP = 200


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pbf-sph-tpu-torch",
        description="PyTorch/CUDA PBF-SPH benchmark (same workload as the reference mini-app)",
    )
    p.add_argument("--impl", choices=BACKENDS, default="torch",
                   help="solver backend (default torch)")
    p.add_argument("--list", action="store_true", help="list available devices and exit")
    p.add_argument("--verbose", action="store_true", help="enable verbose device output")
    p.add_argument("--devices", action="append", default=[],
                   help="CUDA device index or name substring, or cpu (repeatable)")
    p.add_argument("--iter", type=int, default=DEFAULT_ITER, dest="iterations",
                   help="timed frames (default 200)")
    p.add_argument("--warmup", type=int, default=DEFAULT_WARMUP,
                   help="warmup frames (default 200)")
    p.add_argument("--fp64", action="store_true", help="use fp64 (gather backend)")
    p.add_argument("--output", default="",
                   help="output dir template, expands {impl} {type} {iter}")
    p.add_argument("--workload", default="bench20k", choices=sorted(WORKLOADS),
                   help="workload preset (default: the reference benchmark)")
    p.add_argument("--count", type=int, default=0,
                   help="override the workload's particle count")
    p.add_argument("--no-surface", action="store_true", help="disable marching cubes")
    p.add_argument("--phase-timings", action="store_true",
                   help="print the per-frame Stopwatch phase table")
    return p


def list_devices(verbose: bool) -> None:
    """The CUDA devices, one line each (the reference's `--list`)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        print("no CUDA device (torch.cuda.is_available() is False)")
    for i in range(n):
        print(f"[{i}] cuda:{torch.cuda.get_device_name(i)}")
        if verbose:
            print(f"    {torch.cuda.get_device_properties(i)}")


def find_device(specs: List[str], verbose: bool = False) -> torch.device:
    """Select a CUDA device by index or name substring (reference
    `src/utils.hpp:128-159`: try index first, then case-insensitive substring
    over the enumerated names; on no match, print the device list and fail).
    `cpu` selects the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for spec in specs:
        s = spec.strip()
        if s.lower() == "cpu":
            return torch.device("cpu")
        if s.isdigit():
            # purely an index: an out-of-range index fails instead of falling
            # through to substring matching
            if int(s) < n:
                return torch.device("cuda", int(s))
            continue
        for i in range(n):
            if s.lower() in f"cuda:{torch.cuda.get_device_name(i)}".lower():
                return torch.device("cuda", i)
    list_devices(verbose)
    raise SystemExit(f"No device matched {specs!r} (available devices listed above)")


def choose_device(specs: List[str], verbose: bool = False) -> torch.device:
    """The device of a run: the `--devices` choice (`find_device`), else
    `cuda:0`.  Without a CUDA device only `--devices cpu` runs; nothing
    falls back to the CPU by itself."""
    if specs:
        device = find_device(specs, verbose)
        print(f"Using device: {device}")
        return device
    if torch.cuda.is_available():
        return torch.device("cuda", 0)
    raise SystemExit("No CUDA device (torch.cuda.is_available() is False); "
                     "pass --devices cpu to run on the CPU")


def rendered_output_name(template: str, impl: str, fp64: bool, iterations: int) -> str:
    """Output-name templating (reference `src/args.cpp:69-75`)."""
    t = "double" if fp64 else "float"
    return (
        template.replace("{impl}", impl)
        .replace("{type}", t)
        .replace("{iter}", str(iterations))
    )


def summary_stats(xs: List[float]):
    a = np.asarray(xs, np.float64)
    mean = a.mean()
    var = ((a - mean) ** 2).mean()  # population variance (reference benchmark.cpp:68-70)
    return a.min(), a.max(), mean, var, math.sqrt(var)


def timed_advance(solver, config, xs):
    """One frame through the step's stage hook: (result, xs, Stopwatch of the
    stages).  On a CUDA device the stages are device ms between CUDA events
    recorded as each stage is enqueued (`bench.PhaseClock`); on the CPU they
    are host ms, since CPU ops have finished when they return."""
    from pbf_sph_tpu_torch.bench import PhaseClock

    cuda = solver.device.type == "cuda"
    clock = PhaseClock(cuda=cuda)
    result, xs = solver.advance(config, Scene(), xs, clock.mark)
    name = "advance, device ms by stage (CUDA events)" if cuda else \
        "advance, host ms by stage (host clock)"
    return result, xs, Stopwatch.from_durations(name, clock.totals().items())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list:
        list_devices(args.verbose)
        return 0

    dtype = "float64" if args.fp64 else "float32"
    if args.impl == "torch" and args.fp64:
        # mirror the reference's explicit fp64 rejection (benchmark.cpp:140-141)
        print(f"FP64 is not supported for the {args.impl} backend!", file=sys.stderr)
        return 1

    device = choose_device(args.devices, args.verbose)

    if args.count and args.workload.startswith("bench"):
        from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes

        mc, config, particles = simple_config_with_2_cubes(args.count, 6, 500.0)
    elif args.count:
        from pbf_sph_tpu_torch.core.configs import dam_break

        mc, config, particles = dam_break(args.count)
    else:
        mc, config, particles = WORKLOADS[args.workload]()
    if config.surface is None and not args.no_surface and args.workload.startswith("bench"):
        config = config.replace(surface=mc)
    if args.no_surface:
        config = config.replace(surface=None)

    output = rendered_output_name(args.output or "./out_{impl}_{type}_{iter}",
                                  args.impl, args.fp64, args.iterations)
    solver = make_solver(args.impl, h=config.h, dtype=dtype, device=device)
    print(f"Using {output} for output")
    print(f"Workload {args.workload}: {len(particles)} particles, "
          f"{config.iteration} iterations, surface={'on' if config.surface else 'off'}")

    xs = particles
    result = None
    for frame in range(args.warmup):
        try:
            result, xs = solver.advance(apply_motion_sin_x_cos_z(config, frame), Scene(), xs)
        except Exception as e:  # reference surfaces the frame index (benchmark.cpp:34-36)
            print(f"Caught exception at warmup frame {frame}:\n{e}")
            raise

    frame_times = []
    start = time.perf_counter()
    # the reference restarts the bound-motion phase for the timed loop
    # (frame index resets to 0, `src/benchmark.cpp:43-47`)
    for frame in range(args.iterations):
        f_start = time.perf_counter()
        try:
            cfg_f = apply_motion_sin_x_cos_z(config, frame)
            if args.phase_timings:
                result, xs, watch = timed_advance(solver, cfg_f, xs)
            else:
                result, xs = solver.advance(cfg_f, Scene(), xs)
        except Exception as e:
            print(f"Caught exception at benchmark frame {frame}:\n{e}")
            raise
        frame_times.append((time.perf_counter() - f_start) * 1000.0)
        if args.phase_timings:
            print(watch)
    elapsed = time.perf_counter() - start

    lo, hi, mean, _, std = summary_stats(frame_times)
    fps = args.iterations / elapsed
    print(
        f"Benchmark completed after {args.iterations} frames:\n"
        f"Runtime              : {elapsed:.4g} s\n"
        f"Framerate            : {fps:.4g} fps\n"
        f"Frame-time min       : {lo:.4g} ms\n"
        f"Frame-time max       : {hi:.4g} ms\n"
        f"Frame-time mean       : {mean:.4g} ms\n"
        f"Frame-time stdDev     : {std:.4g} ms\n"
        f"Final Vertex count   : {len(result.mesh.vs)}\n"
        f"Final Particle count : {len(xs)} \n"
    )
    # the reference always saves to the (templated) output dir
    # (`src/benchmark.cpp:102-103`)
    from pbf_sph_tpu_torch.utils.export import save

    save(result, xs, output)
    print("Results flushed.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
