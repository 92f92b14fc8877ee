"""Benchmark CLI of the port, the headless entry point.

    python -m pbf_sph_tpu_torch.cli [--impl torch|gather|cpp|numpy] [--fp64] ...

Port of the single-chip path of `pbf_sph_tpu/cli.py`, which mirrors the
reference benchmark's flags and output (reference `src/args.hpp:38-56`,
`src/args.cpp:7-75`, `src/benchmark.cpp:77-175`):
  --impl {torch,gather,cpp,numpy}
                          the CUDA kernels (fp32), the JAX package's XLA
                          gather path on plain torch ops (fp32 or fp64), or
                          a host oracle: C++/OpenMP or NumPy (fp32 or fp64)
  --list --verbose --devices --iter --warmup --fp64 --output
plus --workload, --count, --no-surface and --phase-timings, and the JAX
CLI's multi-device flags for the 1D slab engine (`parallel/sharded.py`) and
the 2D tile engine (`parallel/sharded2d.py`):
  --multichip N|NXxNY [--rebalance] [--ckpt-every K]
which runs N (or NX*NY, ranks x-major) processes, one rank each, over
`torch.distributed`: rank r on `cuda:r` with NCCL, or on the CPU with gloo
under `--devices cpu`.  It needs a card a rank; unlike the JAX CLI it never
falls back to a virtual CPU mesh.

Default workload is the reference benchmark: 20k particles (two cubes),
6 constraint iterations, scale 500, surface on, oscillating bounds, 200 warmup
+ 200 timed frames (reference `src/benchmark.cpp:23-29,78`).

The device backends (`torch`, `gather`) run on `cuda:0` unless `--devices`
picks another CUDA device by index or by name; `--devices cpu` is the one
way to run them on the CPU, and without a CUDA device they fail.  The
oracles run on the host and take no device, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import sys
import tempfile
import time
from typing import List

import numpy as np
import torch

from pbf_sph_tpu_torch.core.configs import WORKLOADS
from pbf_sph_tpu_torch.core.scene import apply_motion_sin_x_cos_z
from pbf_sph_tpu_torch.core.types import Scene
from pbf_sph_tpu_torch.models import BACKENDS, DEVICE_BACKENDS, make_solver
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
    p.add_argument("--fp64", action="store_true",
                   help="use fp64 (gather, cpp and numpy backends)")
    p.add_argument("--output", default="",
                   help="output dir template, expands {impl} {type} {iter}")
    p.add_argument("--workload", default="bench20k", choices=sorted(WORKLOADS),
                   help="workload preset (default: the reference benchmark)")
    p.add_argument("--count", type=int, default=0,
                   help="override the workload's particle count")
    p.add_argument("--no-surface", action="store_true", help="disable marching cubes")
    p.add_argument("--phase-timings", action="store_true",
                   help="print the per-frame Stopwatch phase table")
    p.add_argument("--multichip", default="", metavar="N|NXxNY",
                   help="run the workload across N devices (x-slab domain "
                        "decomposition + halo exchange over torch.distributed: "
                        "one process a rank, NCCL on cuda:0..N-1, or gloo with "
                        "--devices cpu), or across an NXxNY mesh of (x, y) "
                        "tiles.  Needs a card a rank; no fallback")
    p.add_argument("--rebalance", action="store_true",
                   help="dynamic equal-count re-partitioning from the "
                        "particle CDF (multichip: slab widths in 1D, "
                        "tensor-product tile cuts in 2D)")
    p.add_argument("--ckpt-every", type=int, default=50, metavar="K",
                   help="multichip: snapshot the state every K frames so a "
                        "capacity recovery replays only the frames after the "
                        "last snapshot instead of the whole window (default 50)")
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


def _silent(*args, **kwargs) -> None:
    pass


def parse_mesh(text: str):
    """`N` -> (N,), `NXxNY` -> (NX, NY); None unless every count is >= 1."""
    try:
        mesh = tuple(int(v) for v in str(text).strip().lower().split("x"))
    except ValueError:
        return None
    return mesh if len(mesh) in (1, 2) and min(mesh) >= 1 else None


def run_multichip(args, config, particles, output) -> int:
    """Benchmark the workload over N ranks of the slab engine or NX x NY
    ranks of the tile engine (the JAX CLI's `run_multichip` and
    `run_multichip2d`, `pbf_sph_tpu/cli.py:126-594`): a worker process a
    rank, or this one for a single rank, over a file store in a temporary
    directory."""
    mesh = parse_mesh(args.multichip)
    if mesh is None:
        print(f"--multichip {args.multichip}: want a device count N >= 1 or a tile mesh "
              "NXxNY with NX, NY >= 1", file=sys.stderr)
        return 1
    n_dev = int(np.prod(mesh))
    cpu = any(s.strip().lower() == "cpu" for s in args.devices)
    if not cpu:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_dev:
            print(f"--multichip {args.multichip} needs {n_dev} CUDA devices, one a rank; "
                  f"this machine has {have} (pass --devices cpu to run the ranks on the "
                  "CPU)", file=sys.stderr)
            return 1
    store = tempfile.mkdtemp(prefix="pbf_multichip_")
    work = (mesh, cpu, store, args, config, particles, output)
    try:
        if n_dev == 1:
            return multichip_rank(0, *work)
        import torch.multiprocessing as mp

        try:
            mp.start_processes(_multichip_worker, args=work, nprocs=n_dev, join=True,
                               start_method="spawn")
        except mp.ProcessException as e:
            print(f"--multichip {args.multichip}: {e}", file=sys.stderr)
            return 1
        return 0
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _multichip_worker(rank: int, *work) -> None:
    rc = multichip_rank(rank, *work)
    if rc:
        raise SystemExit(rc)


def multichip_rank(rank: int, mesh, cpu: bool, store: str, args, config, particles,
                   output) -> int:
    """Rank `rank` of a `--multichip` run over `mesh` ((N,) slabs or (NX, NY)
    tiles): joins the process group (gloo on the CPU, NCCL on `cuda:rank`)
    and runs the frames."""
    import torch.distributed as dist

    from pbf_sph_tpu_torch.parallel.comm import DistComm

    n_dev = int(np.prod(mesh))
    if cpu:
        device = torch.device("cpu")
        # the ranks share the cores: at most a share each, and never more
        # threads than the process was given (OMP_NUM_THREADS)
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // n_dev)))
    else:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if cpu else "nccl",
                            store=dist.FileStore(os.path.join(store, "store"), n_dev),
                            rank=rank, world_size=n_dev)
    try:
        engine = SlabEngine(*mesh) if len(mesh) == 1 else TileEngine(*mesh)
        return run_frames(engine, args, config, particles, output, DistComm(device), device)
    finally:
        dist.destroy_process_group()


def _ceil128(v: int) -> int:
    return -(-v // 128) * 128


class SlabEngine:
    """What `run_frames` asks of the slab engine: the spec from the grown
    capacities, the bounds, the rank's state, the step and the banner."""

    label = "Per-device particles"

    def __init__(self, n_dev: int):
        self.n_dev = n_dev
        self.ghost_cap = 0

    def spec(self, args, config, particles, soa, cap_local: int):
        from pbf_sph_tpu_torch.parallel import sharded

        return sharded.ShardSpec.create(
            config, self.n_dev, len(particles), config.h, gather=args.impl == "gather",
            rebalance=args.rebalance, cap_local=cap_local, ghost_cap=self.ghost_cap)

    def bounds(self, spec, soa, ckpt_bounds):
        if ckpt_bounds is not None:
            return np.asarray(ckpt_bounds, np.int32)
        return spec.initial_bounds(soa)

    def state(self, spec, soa, bounds, rank: int, device):
        from pbf_sph_tpu_torch.parallel import sharded

        return sharded.local_state(sharded.distribute_particles(soa, spec, bounds=bounds),
                                   rank, spec, device)

    def step(self, spec, comm):
        from pbf_sph_tpu_torch.parallel import sharded

        return sharded.build_sharded_step(spec, comm)

    def banner(self, spec, bounds, rebalance: bool, device) -> str:
        return (f"Multichip: {self.n_dev} devices ({device.type}), "
                f"{'rebalancing' if rebalance else 'fixed'} x-slabs, cap_local={spec.cap_local}")

    def host_bounds(self, bounds):
        return bounds.cpu().numpy() if torch.is_tensor(bounds) else bounds

    def grow_ghosts(self, spec, ghost_peak: int) -> None:
        self.ghost_cap = _ceil128(max(int(ghost_peak * 1.25), spec.ghost_cap + 128))

    def cap_floor(self, spec, cap_local: int) -> int:
        # a slab's ghosts fit in its owned capacity (`create` clamps them)
        return max(cap_local, self.ghost_cap, spec.cap_local)


class TileEngine:
    """`SlabEngine`'s counterpart for the tile engine, with the JAX 2D
    runner's rules: the spec (and so the cuts) made anew from the snapshot,
    both ghost capacities grown together."""

    label = "Per-tile particles  "

    def __init__(self, nx: int, ny: int):
        self.nx, self.ny = nx, ny
        self.ghost = (0, 0)

    def spec(self, args, config, particles, soa, cap_local: int):
        from pbf_sph_tpu_torch.parallel import sharded2d

        return sharded2d.Shard2DSpec.create(
            config, self.nx, self.ny, soa, config.h, gather=args.impl == "gather",
            cap_local=cap_local, rebalance=args.rebalance, ghost_x=self.ghost[0],
            ghost_y=self.ghost[1])

    def bounds(self, spec, soa, ckpt_bounds):
        return ckpt_bounds if ckpt_bounds is not None else spec.initial_bounds()

    def state(self, spec, soa, bounds, rank: int, device):
        from pbf_sph_tpu_torch.parallel import sharded2d

        return sharded2d.local_state(
            sharded2d.distribute_particles_2d(soa, spec, bounds=bounds), rank, spec, device)

    def step(self, spec, comm):
        from pbf_sph_tpu_torch.parallel import sharded2d

        return sharded2d.build_sharded2d_step(spec, comm)

    def banner(self, spec, bounds, rebalance: bool, device) -> str:
        # the cuts the run uses: a resumed rebalancing run's, not the spec's
        xb, yb = bounds if bounds is not None else (spec.xb, spec.yb)
        return (f"Multichip 2D: {self.nx}x{self.ny} tiles ({device.type}), "
                f"{'rebalancing' if rebalance else 'static'} cuts, "
                f"cap_local={spec.cap_local}, xb={tuple(int(v) for v in xb)}, "
                f"yb={tuple(int(v) for v in yb)}")

    def host_bounds(self, bounds):
        return tuple(b.cpu().numpy() for b in bounds)

    def grow_ghosts(self, spec, ghost_peak: int) -> None:
        g = _ceil128(max(int(ghost_peak * 1.25), 128))
        self.ghost = (max(g, spec.ghost_x + 128), max(g, spec.ghost_y + 128))

    def cap_floor(self, spec, cap_local: int) -> int:
        # a y-ghost row spans many columns: the ghosts may outgrow cap_local
        return cap_local


def run_frames(engine, args, config, particles, output, comm, device) -> int:
    """The frames of a `--multichip` run on one rank: the capacity-recovery
    loop (snapshots every `--ckpt-every` frames; dropped work grows the
    capacities from the observed demand and resumes from the last snapshot,
    at most 8 attempts), the motion phase, the stats block, the gathered
    mesh and the export.  Every rank takes the same decisions from the
    gathered per-rank counters; rank 0 alone prints and writes."""
    import dataclasses as _dc

    from pbf_sph_tpu_torch.core.types import ColouredMesh, Result
    from pbf_sph_tpu_torch.models.torch_solver import dyn_params_of
    from pbf_sph_tpu_torch.parallel import sharded
    from pbf_sph_tpu_torch.parallel.comm import gather_rank_values

    say = print if comm.rank == 0 else _silent
    cap_local = 0
    migrate_cap = None
    surface_over = {}

    def build_spec(soa):
        spec = engine.spec(args, config, particles, soa, cap_local)
        if migrate_cap is not None:
            # never past cap_local: a merge takes at most cap_local slots
            spec = _dc.replace(spec, migrate_cap=min(int(migrate_cap), spec.cap_local))
        if surface_over and spec.surface is not None:
            spec = _dc.replace(spec, surface=_dc.replace(spec.surface, **surface_over))
        return spec

    # dropped work in any frame corrupts the physics, so the run resumes
    # from the last snapshot under a spec grown from the observed demand.
    # Deferral is self-recovering (retried next frame), so it triggers a
    # re-run only when the backlog has not drained by the end of the window.
    HARD_KEYS = ("migrate_dropped", "ghost_dropped", "mc_emit_overflow")
    DROP_KEYS = HARD_KEYS + ("migrate_deferred",)
    warm = args.warmup
    total_frames = warm + args.iterations
    ckpt_every = max(1, args.ckpt_every)

    # snapshot = state before global frame ckpt_frame
    ckpt_frame = 0
    ckpt_soa = particles
    ckpt_bounds = None
    frame_times: List[float] = []
    per = {}

    for _attempt in range(8):
        spec = build_spec(ckpt_soa)
        bounds = engine.bounds(spec, ckpt_soa, ckpt_bounds) if args.rebalance else None
        state = engine.state(spec, ckpt_soa, bounds, comm.rank, device)
        step = engine.step(spec, comm)
        say(engine.banner(spec, bounds, args.rebalance, device)
            + (f" (resuming at frame {ckpt_frame}/{total_frames})" if ckpt_frame else ""))
        keys = ["alive_count", "extent_ok", "ghost_peak", *DROP_KEYS]
        if spec.surface is None:
            keys = [k for k in keys if k != "mc_emit_overflow"]
        else:
            keys.append("tri_count")

        def one(g, state, bounds):
            # motion phase: warmup counts 0..warm-1, the timed loop restarts
            # at 0 (reference `src/benchmark.cpp:43-47`)
            frame = g if g < warm else g - warm
            dyn = dyn_params_of(apply_motion_sin_x_cos_z(config, frame), np.float32, device)
            if spec.rebalance:
                state, stats, bounds = step(state, dyn, bounds=bounds)
            else:
                state, stats = step(state, dyn)
            return state, stats, bounds

        totals = {k: 0 for k in DROP_KEYS}
        ghost_peak = tri_peak = occ_need = deferred_last = 0
        extent_bad = hard_fail = False

        def track(stats):
            """The frame's per-rank counters on every rank (one collective,
            read back to the host: the frame is complete)."""
            nonlocal per, ghost_peak, tri_peak, occ_need, deferred_last, extent_bad
            vals = gather_rank_values(comm, [stats[k] for k in keys]).cpu().numpy()
            per = dict(zip(keys, vals))
            frame_hard = False
            for k in DROP_KEYS:
                if k in per:
                    v = int(per[k].sum())
                    totals[k] += v
                    frame_hard |= bool(v) and k in HARD_KEYS
            deferred_last = int(per["migrate_deferred"].sum())
            ghost_peak = max(ghost_peak, int(per["ghost_peak"].max()))
            occ_need = max(occ_need, int((per["alive_count"] + per["migrate_dropped"]).max()))
            if spec.surface is not None:
                tri_peak = max(tri_peak, int(per["tri_count"].max()))
            extent_bad |= not per["extent_ok"].all()
            return frame_hard

        # replay: timed-frame stats measured beyond the snapshot are invalid
        del frame_times[max(ckpt_frame - warm, 0):]
        g = ckpt_frame
        while g < total_frames:
            t0 = time.perf_counter()
            state, stats, bounds = one(g, state, bounds)
            frame_hard = track(stats)
            if g >= warm:
                frame_times.append((time.perf_counter() - t0) * 1000.0)
            if frame_hard or extent_bad:
                hard_fail = True
                break
            g += 1
            if g % ckpt_every == 0 and g < total_frames:
                ckpt_soa = sharded.all_gather_soa(comm, state)
                ckpt_bounds = engine.host_bounds(bounds) if bounds is not None else None
                ckpt_frame = g

        if extent_bad:
            # not a capacity: the bounds outgrew the grid sized from the
            # initial bounds
            say("ERROR: dynamic bounds outgrew the compiled grid extent "
                "(extent_ok=0) — results are not trustworthy; rebuild for "
                "the larger domain", file=sys.stderr)
            return 1
        grown = False
        if totals["ghost_dropped"] > 0:
            engine.grow_ghosts(spec, ghost_peak)
            grown = True
        if totals["migrate_dropped"] > 0:
            # grow from the observed demand: peak occupancy plus the refused
            # immigrants
            cap_local = _ceil128(max(int(occ_need * 5 // 4), spec.cap_local + 128))
            grown = True
        if totals["migrate_deferred"] > 0 and deferred_last > 0:
            # a backlog that had not drained by the final frame
            migrate_cap = -(-(spec.migrate_cap + deferred_last) * 5 // 4 // 128) * 128
            grown = True
        if spec.surface is not None:
            if totals["mc_emit_overflow"] > 0 and spec.surface.cube_cap > 0:
                vol = int(np.prod([s - 1 for s in spec.surface.sample]))
                surface_over["cube_cap"] = min(
                    -(-(spec.surface.cube_cap + totals["mc_emit_overflow"]) * 5 // 4
                      // 128) * 128, vol)
                grown = True
            if tri_peak > spec.surface.tri_capacity:
                surface_over["tri_capacity"] = -(-int(tri_peak * 3 // 2) // 1024) * 1024
                grown = True
        if not grown and not hard_fail:
            if totals["migrate_deferred"] > 0:
                say(f"# note: {totals['migrate_deferred']} transient migration "
                    "deferrals (drained by the final frame; peak backlog is "
                    "self-recovering)", file=sys.stderr)
            break
        if not grown:
            raise RuntimeError(
                f"hard failure at frame {g} without a growable capacity: {totals}")
        cap_local = engine.cap_floor(spec, cap_local)
        say(f"# dropped/deferred work {totals} at frame {g} (ghost_peak={ghost_peak}, "
            f"occ_need={occ_need}, tri_peak={tri_peak}) — growing capacities and "
            f"resuming from the frame-{ckpt_frame} snapshot ({g - ckpt_frame + 1} of "
            f"{total_frames} frames replayed)", file=sys.stderr)
    else:
        raise RuntimeError(f"multichip capacity growth did not converge: {totals}")
    elapsed = sum(frame_times) / 1000.0

    lo, hi, mean, _, std = summary_stats(frame_times)
    counts = per["alive_count"]
    tri_total = int(per["tri_count"].sum()) if spec.surface is not None else 0
    say(
        f"Benchmark completed after {args.iterations} frames:\n"
        f"Runtime              : {elapsed:.4g} s\n"
        f"Framerate            : {args.iterations / elapsed:.4g} fps\n"
        f"Frame-time min       : {lo:.4g} ms\n"
        f"Frame-time max       : {hi:.4g} ms\n"
        f"Frame-time mean       : {mean:.4g} ms\n"
        f"Frame-time stdDev     : {std:.4g} ms\n"
        f"Final Vertex count   : {tri_total * 3}\n"
        f"Final Particle count : {int(counts.sum())} \n"
        f"{engine.label} : {counts.tolist()}"
    )
    xs = sharded.all_gather_soa(comm, state)
    result = Result()
    if spec.surface is not None:
        vs, ns, cs = sharded.all_gather_mesh(comm, stats)
        result = Result(mesh=ColouredMesh(vs=vs, ns=ns, cs=cs))
    if comm.rank == 0:
        from pbf_sph_tpu_torch.utils.export import save

        save(result, xs, output)
        print("Results flushed.")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list:
        list_devices(args.verbose)
        return 0

    dtype = "float64" if args.fp64 else "float32"
    if args.impl == "torch" and args.fp64:
        # mirror the reference's explicit fp64 rejection (benchmark.cpp:140-141);
        # gather, numpy and cpp honour --fp64 (cpp through pbf_advance_f64,
        # reference benchmark.cpp:159-165)
        print(f"FP64 is not supported for the {args.impl} backend!", file=sys.stderr)
        return 1
    if args.multichip and args.impl not in DEVICE_BACKENDS:
        print("--multichip requires --impl torch or gather", file=sys.stderr)
        return 1
    if args.multichip and args.fp64:
        print("--multichip is fp32-only", file=sys.stderr)
        return 1

    # --devices applies to the device backends; an oracle takes no device
    device = None
    if not args.multichip and args.impl in DEVICE_BACKENDS:
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
    if args.multichip:
        print(f"Using {output} for output")
        print(f"Workload {args.workload}: {len(particles)} particles, "
              f"{config.iteration} iterations, "
              f"surface={'on' if config.surface else 'off'}")
        sys.stdout.flush()  # before the worker processes print
        return run_multichip(args, config, particles, output)

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
            if args.phase_timings and args.impl in DEVICE_BACKENDS:
                result, xs, watch = timed_advance(solver, cfg_f, xs)
            else:
                result, xs = solver.advance(cfg_f, Scene(), xs)
                # an oracle times its phases itself (the reference OMP
                # backend prints its Stopwatch a frame, src/omp/ompsph.hpp:482)
                watch = getattr(solver, "last_watch", None)
        except Exception as e:
            print(f"Caught exception at benchmark frame {frame}:\n{e}")
            raise
        frame_times.append((time.perf_counter() - f_start) * 1000.0)
        if args.phase_timings and watch is not None:
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
