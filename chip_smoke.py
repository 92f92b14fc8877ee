#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`pbf_sph_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, each printing one line or more; the first failed check ends the run
with a non-zero exit and no result line:

1. the card (`nvidia-smi` name and power limit), torch, CUDA and nvcc;
2. build the CUDA kernels from `pbf_sph_tpu_torch/csrc` (nvcc, at first use);
3. each kernel against its plain PyTorch version on the card, on the
   sort-time state of dam_break(32_000, 3) and dam_break(1_000_000, 6):
   diffuse count exact and colour sums to atol 1e-6, lambda to atol 1e-6 /
   rtol 1e-5, pStar after one delta phase to atol 1e-5 (simulation units);
   with CUDA-event times of both;
4. TorchSolver on the card against TorchSolver on the CPU, 2 frames of
   simple_config_with_2_cubes(700, 2, 500): position and velocity to atol
   1e-3, colour to 1e-5;
5. the main path: dam_break(1_000_000, solver_iter=6) through
   TorchSolver(device="cuda"): prepare, the growth warmup of the benchmark,
   then timed frames; particles conserved, grid extent held, no capacity
   overflow, positions finite and inside the bounds, and exactly 13 kernel
   launches per frame (1 diffuse + 6 lambda + 6 delta).

Then one JSON line of kernels, the card line again, and as the last line
`{"ok": true, "device": {...}}`.  Without a CUDA device, or outside a
checkout of the repo, it fails before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

TIMED_FRAMES = 10
WARMUP = 10

# phase name -> (kernel source, TPU kernel it replaces)
KERNELS = {
    "diffuse": ("pbf_sph_tpu_torch/csrc/pbf_phases.cu",
                "pbf_sph_tpu/ops/pallas_pbf.py:578"),
    "lambda": ("pbf_sph_tpu_torch/csrc/pbf_phases.cu",
               "pbf_sph_tpu/ops/pallas_pbf.py:391"),
    "delta": ("pbf_sph_tpu_torch/csrc/pbf_phases.cu",
              "pbf_sph_tpu/ops/pallas_pbf.py:491"),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok, msg: str) -> None:
    if not bool(ok):
        fail(msg)
    print(f"  ok: {msg}")


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


def phase_toolchain() -> None:
    print("== 1. card and toolchain")
    print(card_line())
    from pbf_sph_tpu_torch.ops import cuda_build

    drv = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    nvcc = subprocess.run([cuda_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  driver {drv}")
    print(f"nvcc: {nvcc.strip().splitlines()[-1]}")


def phase_build() -> None:
    print("== 2. build the CUDA kernels")
    from pbf_sph_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    lib = cuda_build.library()
    print(f"built {cuda_build.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s; launchers "
          f"{', '.join(n for n in cuda_build.SIGNATURES if getattr(lib, n))}")


def sort_time_state(count: int, iters: int):
    from pbf_sph_tpu_torch.core.configs import dam_break
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import (
        TorchSolver, advect_and_sort, dyn_params_of)

    mc, cfg, xs = dam_break(count, solver_iter=iters)
    solver = TorchSolver(h=cfg.h, device="cuda")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, solver.dtype, solver.device)
    return spec, dyn, advect_and_sort(spec, state, dyn, scn)


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns the 1M-shape numbers."""
    print("== 3. kernels against their plain PyTorch versions, on the card")
    from pbf_sph_tpu_torch.core.types import FLUID
    from pbf_sph_tpu_torch.ops import phases as ph

    report = {}
    for count, iters in ((32_000, 3), (1_000_000, 6)):
        spec, dyn, fr = sort_time_state(count, iters)
        st, idx, h = fr.state, fr.index, spec.h
        scale = torch.full((), spec.scale, device=st.mass.device)
        lo, hi = ph.neighbour_ranges(idx)
        pairs = int((hi - lo).sum())
        print(f"dam_break({count}, {iters}): capacity {spec.capacity}, grid "
              f"{spec.grid.dims}, members {int(idx.table[-1])}, "
              f"{pairs} candidate pairs per phase")
        reps = (20, 2) if count > 100_000 else (5, 1)

        nonobs = ph.nonobstacle(st.ptype, st.alive)
        sk = ph.diffuse_kernel(idx, st.colour, nonobs)
        sp = ph.diffuse_plain(idx, st.colour, nonobs)
        err_d = float((sk[:4] - sp[:4]).abs().max())
        check(torch.equal(sk[4], sp[4]), f"diffuse count exact (max {int(sk[4].max())})")
        check(err_d <= 1e-6, f"diffuse colour sums max abs err {err_d:.3e} <= 1e-6")

        lam_k = ph.lambda_kernel(idx, h, fr.pstar, st.mass)
        lam_p = ph.lambda_plain(idx, h, fr.pstar, st.mass)
        err_l = float((lam_k - lam_p).abs().max())
        check(torch.allclose(lam_k, lam_p, atol=1e-6, rtol=1e-5),
              f"lambda max abs err {err_l:.3e} (atol 1e-6, rtol 1e-5)")

        lam = torch.where((st.ptype == FLUID) & st.alive, lam_k, 0.0)
        moved = []
        for delta in (ph.delta_kernel, ph.delta_plain):
            dp = delta(idx, h, fr.pstar, lam)
            moved.append(ph.clamp_to_bounds(fr.pstar, dp, st.ptype, st.alive, scale,
                                            dyn["min_bound"], dyn["max_bound"]))
        err_p = float((moved[0] - moved[1]).abs().max())
        check(err_p <= 1e-5, f"pStar after one delta max abs err {err_p:.3e} <= 1e-5")
        check(bool(torch.isfinite(moved[0]).all()), "pStar after delta is finite")

        timings = {
            "diffuse": (lambda: ph.diffuse_kernel(idx, st.colour, nonobs),
                        lambda: ph.diffuse_plain(idx, st.colour, nonobs), err_d),
            "lambda": (lambda: ph.lambda_kernel(idx, h, fr.pstar, st.mass),
                       lambda: ph.lambda_plain(idx, h, fr.pstar, st.mass), err_l),
            "delta": (lambda: ph.delta_kernel(idx, h, fr.pstar, lam),
                      lambda: ph.delta_plain(idx, h, fr.pstar, lam), err_p),
        }
        for name, (kern, plain, err) in timings.items():
            ms = device_ms(kern, reps[0])
            plain_ms = device_ms(plain, reps[1])
            print(f"  {name}: kernel {ms:.4f} ms ({pairs / ms / 1e6:.3f} Gpairs/s), "
                  f"plain {plain_ms:.4f} ms (capacity {spec.capacity})")
            report[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del fr, st, idx
        torch.cuda.empty_cache()
    return report


def phase_parity() -> None:
    print("== 4. TorchSolver on the card against TorchSolver on the CPU")
    from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver

    mc, cfg, xs = simple_config_with_2_cubes(700, 2, 500.0)
    ends = []
    for device in ("cuda", "cpu"):
        solver = TorchSolver(h=cfg.h, device=device)
        x = xs
        for _ in range(2):
            _, x = solver.advance(cfg, Scene(), x)
        ends.append(x.order_by_id())
    g, c = ends
    check(np.array_equal(g.pid, c.pid), f"same {len(g)} particle ids")
    for name, atol in (("position", 1e-3), ("velocity", 1e-3), ("colour", 1e-5)):
        err = float(np.abs(getattr(g, name) - getattr(c, name)).max())
        check(err <= atol, f"{name} max abs err {err:.3e} <= {atol}")


def phase_main_path() -> dict:
    print("== 5. main path: dam_break(1_000_000, 6) through TorchSolver(device='cuda')")
    from pbf_sph_tpu_torch.bench import time_frames, warm_up
    from pbf_sph_tpu_torch.core.configs import dam_break
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.growth import growth_changes
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, dyn_params_of

    mc, cfg, xs = dam_break(1_000_000, solver_iter=6)
    n = len(xs)
    solver = TorchSolver(h=cfg.h, device="cuda")
    solver.phases.reset_launches()
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, solver.dtype, solver.device)
    print(f"{n} particles, capacity {spec.capacity}, grid {spec.grid.dims} "
          f"({spec.grid.ncells} cells)")
    t0 = time.perf_counter()
    spec, state, warm = warm_up(solver, spec, state, dyn, scn, xs, WARMUP)
    torch.cuda.synchronize()
    print(f"warmup: {warm} frames in {time.perf_counter() - t0:.2f} s")
    state, outs, wall, dev_ms = time_frames(solver, spec, state, dyn, scn, TIMED_FRAMES)
    launches = dict(solver.phases.launches)
    frames = warm + TIMED_FRAMES

    out = dict(outs[-1])
    out["max_occupancy"] = max(int(o["max_occupancy"]) for o in outs)
    check(all(int(o["alive_count"]) == n for o in outs), f"alive_count == {n} every frame")
    check(all(bool(o["extent_ok"]) for o in outs), "extent_ok every frame")
    check(growth_changes(spec, out) == {} and int(out["strip_overflow"]) == 0,
          f"no capacity overflow (max occupancy {out['max_occupancy']}, "
          f"cell capacity {spec.cell_capacity})")
    pos = state.position[:, state.alive]
    lo = torch.tensor(cfg.min_bound, device=solver.device)[:, None] - 1e-2
    hi = torch.tensor(cfg.max_bound, device=solver.device)[:, None] + 1e-2
    check(bool(torch.isfinite(pos).all()) and bool(torch.isfinite(state.velocity).all()),
          "positions and velocities finite")
    check(bool(((pos >= lo) & (pos <= hi)).all()), "positions inside the bounds")
    want = {"diffuse": frames, "lambda": 6 * frames, "delta": 6 * frames}
    check(launches == want, f"kernel launches {launches} == 13 x {frames} frames")

    ms = 1000 * wall / TIMED_FRAMES
    print(f"{card_line()}: {ms:.3f} ms/step (device events {dev_ms:.3f} ms/step), "
          f"{n * TIMED_FRAMES / wall:.4e} particle-steps/s over {TIMED_FRAMES} frames")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    # the port's package must come from this checkout: fail before any output
    # when the script stands alone
    import pbf_sph_tpu_torch  # noqa: F401

    phase_toolchain()
    phase_build()
    report = phase_kernels()
    phase_parity()
    launches = phase_main_path()

    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], **report[name])
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
