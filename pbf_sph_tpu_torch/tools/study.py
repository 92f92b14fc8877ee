"""What the study tools share: the device flag, a settled workload state,
timing on CUDA events and the host clock, and the card's line.

Every tool runs on `cuda:0` unless its argv holds `--devices cpu`; on the
CPU the tools run their small sizes, and a time there is the host clock's
(printed as such, never as a device time).
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, List, Optional, Tuple

import torch

from pbf_sph_tpu_torch.bench import warm_up
from pbf_sph_tpu_torch.core.types import Scene
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, dyn_params_of


def pop_device(argv: List[str]) -> Tuple[torch.device, List[str]]:
    """(`--devices X`'s device, default cuda:0, and argv without it).  A
    CUDA device without a card raises: nothing falls back to the CPU."""
    argv = list(argv)
    name = "cuda:0"
    if "--devices" in argv:
        i = argv.index("--devices")
        name = argv[i + 1]
        del argv[i:i + 2]
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is False); pass "
                         "--devices cpu to run on the CPU")
    return device, argv


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu (host clock)"
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, device: torch.device, reps: int = 8
          ) -> Tuple[object, Optional[float], float]:
    """(last output, device ms a call on CUDA events or None on the CPU, host
    ms a call) of `reps` calls of fn() after one warm call."""
    out = fn()
    sync(device)
    start = end = None
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    if end is not None:
        end.record()
    sync(device)
    host = (time.perf_counter() - t0) * 1e3 / reps
    dev = start.elapsed_time(end) / reps if start is not None else None
    return out, dev, host


def fmt_ms(dev: Optional[float], host: float) -> str:
    if dev is None:
        return f"host {host:9.3f} ms"
    return f"device {dev:9.4f} ms  host {host:9.3f} ms"


def workload_of(arg: str, surface: bool = True):
    """A name of `core/configs.WORKLOADS`; a particle count n for mc128k's
    scene at n particles (dam_break(n, 3) with the surface, or without it
    when `surface` is False); or `cubes:n` for the 2-cube scene of the dry
    run at n particles (2 iterations, the surface at lattice resolution
    1.0), small enough for the CPU and dense enough to cross the
    isolevel."""
    import dataclasses

    from pbf_sph_tpu_torch.core.configs import WORKLOADS, dam_break
    from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes

    if arg.isdigit():
        return dam_break(int(arg), solver_iter=3, surface=surface)
    if arg.startswith("cubes:"):
        mc, cfg, xs = simple_config_with_2_cubes(int(arg[6:]), 2, 500.0)
        mc = dataclasses.replace(mc, resolution=1.0)
        return mc, cfg.replace(surface=mc if surface else None), xs
    return WORKLOADS[arg]()


def settled(workload, device: torch.device, frames: int = 5, gather: bool = False):
    """(solver, spec, state, dyn, scn, config) of `workload` = (mc, config,
    particles) after `bench.warm_up` over `frames` frames (capacity growth
    included) on `device`."""
    _, cfg, xs = workload
    solver = TorchSolver(h=cfg.h, device=device, gather=gather)
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, solver.dtype, solver.device)
    spec, state, _ = warm_up(solver, spec, state, dyn, scn, xs, frames)
    return solver, spec, state, dyn, scn, cfg


def lattice(solver, spec, fr, dyn):
    """The MC lattice (v, n, c) of the sort-time frame `fr` through the
    solver's field: row 4b on the kernel backend, the XLA field on the
    gather backend."""
    from pbf_sph_tpu_torch.ops.mc import mc_field
    from pbf_sph_tpu_torch.ops.pbf import scalar

    st = fr.state
    if solver.gather:
        return mc_field(st.position, st.colour, st.ptype, st.alive, fr.index.table, spec.grid,
                        fr.min_extent, spec.grid.extent, spec.surface, spec.cell_capacity,
                        spec.h, scalar(spec.scale, st.mass), dyn["mc_particle_size"],
                        dyn["mc_particle_influence"])
    return solver.mc_field(fr.index, spec.surface, spec.scale, st.position, st.colour,
                           st.ptype, st.alive, fr.min_extent, dyn["mc_particle_size"])
