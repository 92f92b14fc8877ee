"""Visualisation pipeline — headless frame export.

    python -m pbf_sph_tpu_torch.visualise [--impl torch|gather] [--devices cpu] ...

Port of `pbf_sph_tpu/visualise.py`, the counterpart of the reference's
`visualise` binary, which drives a Polyscope GUI with ImGui sliders
(reference `src/visualise.cpp:29-197`).  With no GL surface, the loop is a
render-export loop: the same workload (20k particles, 3 solver iterations,
reference `src/visualise.cpp:44-47`), with the surface mesh + point cloud
exported per frame for offline rendering (`utils/render.py`).  The
ImGui-adjustable parameters are CLI flags (`--set`) or stdin lines
(`--live`); they stay per-frame dynamic exactly like the GUI mutates them
live (reference `src/visualise.cpp:89-94`): a change of iteration, scale or
MC resolution takes a new step from `TorchSolver`'s per-spec cache on the
next frame.

The JAX module's flags and defaults, but for three: `--impl` takes the
port's backends (`torch`, the CUDA kernels, or `gather`); `--devices` is the
port CLI's (`cuda:0` unless it picks another CUDA device; `cpu` is the one
way onto the CPU, and without a card the run fails); and `--precompile` /
`--precompile-ladder` are parsed but do nothing, as for the JAX module's
`--impl numpy`: `TorchSolver` builds a step in microseconds and has no
`warm`.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np

from pbf_sph_tpu_torch.cli import choose_device
from pbf_sph_tpu_torch.core.scene import apply_motion_sin_x_cos_z, simple_config_with_2_cubes
from pbf_sph_tpu_torch.core.types import McParams, Scene
from pbf_sph_tpu_torch.models import BACKENDS, make_solver
from pbf_sph_tpu_torch.utils.export import (
    load_checkpoint, save_checkpoint, save_obj_mesh, save_ply_points)
from pbf_sph_tpu_torch.utils.render import render_frame


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pbf-sph-tpu-torch-visualise")
    p.add_argument("--impl", choices=BACKENDS, default="torch",
                   help="solver backend (default torch: the CUDA kernels)")
    p.add_argument("--devices", action="append", default=[],
                   help="CUDA device index or name substring, or cpu "
                        "(repeatable; default cuda:0, and no CPU fallback)")
    p.add_argument("--workload", choices=("2cubes", "dam"), default="2cubes",
                   help="2cubes = the reference GUI scene "
                        "(src/visualise.cpp:44-47); dam = dam-break column")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--particles", type=int, default=20_000)
    p.add_argument("--out", default="./frames")
    p.add_argument("--every", type=int, default=1, help="export every k-th frame")
    p.add_argument("--no-motion", action="store_true")
    # the reference GUI's live-adjustable parameters (visualise.cpp:124-135)
    p.add_argument("--solver-iter", type=int, default=3)
    p.add_argument("--dt-scale", type=float, default=1.0)
    p.add_argument("--scale", type=float, default=500.0)
    p.add_argument("--mc-resolution", type=float, default=2.0)
    p.add_argument("--mc-isolevel", type=float, default=100.0)
    p.add_argument("--mc-particle-size", type=float, default=25.0)
    p.add_argument("--mc-particle-influence", type=float, default=0.5)
    p.add_argument("--no-surface", action="store_true")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="write a resumable state checkpoint every k frames")
    p.add_argument("--resume", default="", help="resume from a checkpoint file")
    p.add_argument("--render", action="store_true",
                   help="rasterize each exported frame to frame_NNNNN.png "
                        "(software z-buffer renderer on the host, "
                        "utils/render.py — the offline counterpart of the "
                        "reference's Polyscope viewer, "
                        "src/visualise.cpp:29-197).  Mesh and point cloud are "
                        "composited into one z-buffered image, as the "
                        "reference viewer draws both every frame "
                        "(src/visualise.cpp:152-179)")
    p.add_argument("--render-no-cloud", action="store_true",
                   help="with --render, draw only the mesh")
    p.add_argument("--render-size", default="640x480", metavar="WxH")
    p.add_argument("--live", action="store_true",
                   help="interactive stdin parameter loop: between frames, "
                        "read 'key=value' lines (same keys as --set) and "
                        "apply them to the next frame — the reference GUI's "
                        "live sliders (src/visualise.cpp:119-141); 'reset' "
                        "restores the initial parameters (the Reset button, "
                        "src/visualise.cpp:137-140); 'quit' ends the run")
    p.add_argument("--turntable", type=int, default=0, metavar="N",
                   help="after the last frame, render N orbit views of the "
                        "final surface as turntable_KK.png")
    p.add_argument("--precompile", action="store_true",
                   help="accepted for the JAX module's command lines and does "
                        "nothing here: TorchSolver builds the step of a new "
                        "spec (iteration, scale, mc_resolution) at its first "
                        "frame in microseconds, with no compile to move off "
                        "the frame loop")
    p.add_argument("--precompile-ladder", type=int, default=0, metavar="K",
                   help="with --precompile, accepted and does nothing (see "
                        "--precompile)")
    p.add_argument("--set", action="append", default=[], dest="sets",
                   metavar="FRAME:key=value",
                   help="mutate a live parameter before the given frame, as "
                        "the reference GUI's sliders do between frames "
                        "(visualise.cpp:89-94,119-141).  Keys: iteration, dt, "
                        "scale, force (fx,fy,fz), surface (0/1), "
                        "mc_resolution, mc_isolevel, mc_particle_size, "
                        "mc_particle_influence.  Repeatable.")
    return p


def parse_live_sets(specs):
    """'FRAME:key=value' strings -> {frame: [(key, value_str)]}."""
    out = {}
    for s in specs:
        frame_s, _, kv = s.partition(":")
        key, _, val = kv.partition("=")
        if not (frame_s.isdigit() and key and val):
            raise SystemExit(f"--set expects FRAME:key=value, got {s!r}")
        out.setdefault(int(frame_s), []).append((key, val))
    return out


def apply_live_set(config, key: str, val: str):
    """One live mutation (reference ImGui slider semantics: the solver sees
    the new value on its next frame; static-shape changes — iteration, scale,
    resolution — take a new step from the solver's per-spec cache)."""
    if key == "iteration":
        return config.replace(iteration=int(val))
    if key == "dt":
        return config.replace(dt=float(val))
    if key == "scale":
        return config.replace(scale=float(val))
    if key == "force":
        return config.replace(
            constant_force=tuple(float(v) for v in val.split(","))
        )
    if key == "surface":
        if val in ("0", "off", "false"):
            return config.replace(surface=None)
        return config.replace(surface=config.surface or McParams())
    if key.startswith("mc_"):
        surf = config.surface or McParams()
        return config.replace(
            surface=dataclasses.replace(surf, **{key[3:]: float(val)})
        )
    raise SystemExit(f"unknown live parameter {key!r}")


def precompile_plan(config, live_sets, ladder: int = 0):
    """Enumerate the distinct future configs a scheduled --set run will
    step, in first-use order, plus `ladder` halving/doubling mc_resolution
    rungs around each (for unscheduled slider moves).

    Kept from the JAX module, whose `--precompile` compiles each; `main`
    here builds nothing ahead (see `--precompile`)."""
    stops = [config]
    c = config
    for frame in sorted(live_sets):
        for key, val in live_sets[frame]:
            c = apply_live_set(c, key, val)
        stops.append(c)

    out, seen = [], set()

    def add(cfg):
        key = (cfg.iteration, cfg.scale, cfg.min_bound, cfg.max_bound,
               cfg.surface)
        if key not in seen:
            seen.add(key)
            out.append(cfg)

    for cfg in stops:
        add(cfg)
        if cfg.surface is not None:
            for k in range(1, ladder + 1):
                for res in (cfg.surface.resolution * 2.0 ** k,
                            cfg.surface.resolution / 2.0 ** k):
                    add(cfg.replace(surface=dataclasses.replace(
                        cfg.surface, resolution=res)))
    # the run's own starting spec is built by frame 0 anyway
    return out[1:] if out and out[0] is config else out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = choose_device(args.devices)
    if args.workload == "dam":
        from pbf_sph_tpu_torch.core.configs import dam_break

        mc, config, particles = dam_break(args.particles, args.solver_iter)
    else:
        mc, config, particles = simple_config_with_2_cubes(
            args.particles, args.solver_iter, args.scale
        )
    config = config.replace(dt=config.dt * args.dt_scale)
    if not args.no_surface:
        config = config.replace(
            surface=McParams(
                resolution=args.mc_resolution,
                isolevel=args.mc_isolevel,
                particle_size=args.mc_particle_size,
                particle_influence=args.mc_particle_influence,
            )
        )

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    solver = make_solver(args.impl, h=config.h, device=device)

    xs = particles
    frame0 = 0
    if args.resume:
        xs, last_frame = load_checkpoint(args.resume)
        frame0 = last_frame + 1  # the checkpoint holds post-frame state
        print(f"resumed {len(xs)} particles after frame {last_frame}")

    live_sets = parse_live_sets(args.sets)
    # --precompile: nothing to build ahead (see its help)

    live_q = None
    if args.live:
        # stdin reader thread + queue: the frame loop drains whatever lines
        # arrived since the last frame (non-blocking), exactly how the
        # reference GUI samples its ImGui state once per solver frame
        # (src/visualise.cpp:89-94)
        import queue
        import sys
        import threading

        live_q = queue.Queue()

        def _reader():
            for line in sys.stdin:
                live_q.put(line.strip())
            live_q.put(None)  # EOF

        threading.Thread(target=_reader, daemon=True).start()
        print("live: reading key=value lines from stdin "
              "('reset' restores, 'quit' ends)", flush=True)
    config0 = config

    render_wh = None
    cam_center = cam_radius = None
    if args.render or args.turntable:
        w, _, h = args.render_size.partition("x")
        render_wh = (int(w), int(h))
        # pin the camera to the domain bounds so the animation doesn't
        # re-frame per frame
        lo = np.asarray(config.min_bound, np.float64)
        hi = np.asarray(config.max_bound, np.float64)
        cam_center = 0.5 * (lo + hi)
        cam_radius = float(np.linalg.norm(hi - lo)) * 0.5

    result = None
    stop = False
    for frame in range(frame0, frame0 + args.frames):
        for key, val in live_sets.get(frame, []):
            config = apply_live_set(config, key, val)
            print(f"frame {frame}: set {key}={val}", flush=True)
        while live_q is not None and not live_q.empty():
            line = live_q.get_nowait()
            if line is None or line in ("quit", "q"):
                stop = line is not None
                live_q = None
                if stop:
                    print(f"frame {frame}: quit", flush=True)
                break
            if not line:
                continue
            if line == "reset":
                config = config0
                print(f"frame {frame}: reset", flush=True)
                continue
            key, _, val = line.partition("=")
            try:
                config = apply_live_set(config, key, val)
                print(f"frame {frame}: set {key}={val}", flush=True)
            except SystemExit as exc:
                print(f"frame {frame}: ignored {line!r} ({exc})", flush=True)
        if stop:
            break
        cfg = config if args.no_motion else apply_motion_sin_x_cos_z(config, frame)
        result, xs = solver.advance(cfg, Scene(), xs)
        if frame % args.every == 0:
            save_ply_points(out_dir / f"cloud_{frame:05d}.ply", xs)
            if config.surface is not None:
                save_obj_mesh(out_dir / f"mesh_{frame:05d}.obj", result.mesh)
            if args.render:
                mesh = result.mesh if config.surface is not None else None
                # composite mesh AND cloud (the reference viewer draws both
                # every frame, src/visualise.cpp:152-179); the z-buffer is
                # shared so particles inside the surface are hidden
                render_frame(
                    out_dir / f"frame_{frame:05d}.png", mesh=mesh,
                    xs=None if (mesh is not None and args.render_no_cloud) else xs,
                    width=render_wh[0], height=render_wh[1],
                    center=cam_center, radius=cam_radius,
                )
        if args.checkpoint_every and frame % args.checkpoint_every == 0:
            save_checkpoint(out_dir / f"ckpt_{frame:05d}.npz", xs, frame)
        print(
            f"frame {frame}: particles={len(xs)} mesh_verts={len(result.mesh.vs)}",
            flush=True,
        )
    if args.turntable and result is not None:
        mesh = result.mesh if config.surface is not None else None
        for k in range(args.turntable):
            render_frame(
                out_dir / f"turntable_{k:02d}.png", mesh=mesh,
                xs=None if (mesh is not None and args.render_no_cloud) else xs,
                width=render_wh[0], height=render_wh[1],
                center=cam_center, radius=cam_radius,
                azimuth_deg=360.0 * k / args.turntable,
            )
        print(f"turntable: {args.turntable} views", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
