"""Scene builders reproducing the reference benchmark workload.

These define the exact initial conditions the benchmark and GUI use, so they
mirror the reference helpers bit-for-bit:
  make_cube                  — reference `src/sph.hpp:127-145`
  apply_motion_sin_x_cos_z   — reference `src/sph.hpp:147-158`
  simple_config_with_2_cubes — reference `src/sph.hpp:160-186`
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from pbf_sph_tpu_torch.core.types import FLUID, McParams, ParticleSoA, SphParams


def make_cube(
    offset: int,
    spacing: float,
    count: int,
    origin,
    colour,
    dtype=np.float32,
) -> Tuple[int, ParticleSoA]:
    """Lattice cube of ~count fluid particles: side length floor(cbrt(count)),
    loop order x-outer/z-inner, ids assigned sequentially from `offset`
    (reference `src/sph.hpp:127-145`)."""
    side = int(math.pow(count, 1.0 / 3.0))
    # guard fp cbrt rounding (e.g. cbrt(1000) = 9.9999...)
    while (side + 1) ** 3 <= count:
        side += 1
    n = side**3
    x, y, z = np.meshgrid(np.arange(side), np.arange(side), np.arange(side), indexing="ij")
    grid = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1).astype(dtype)
    pos = grid * dtype(spacing) + np.asarray(origin, dtype)
    soa = ParticleSoA(
        pid=np.arange(offset, offset + n, dtype=np.int32),
        ptype=np.full(n, FLUID, np.int32),
        mass=np.ones(n, dtype),
        position=pos,
        velocity=np.zeros((n, 3), dtype),
        colour=np.broadcast_to(np.asarray(colour, dtype), (n, 4)).copy(),
    )
    return offset + n, soa


def apply_motion_sin_x_cos_z(config: SphParams, frame: int) -> SphParams:
    """Oscillate the domain bounds: x by 300*sin(frame/20), z by 90*cos(frame/20)
    (reference `src/sph.hpp:147-158`; math in fp32 like the reference)."""
    offset_scale = np.float32(300.0)
    offset_rate = np.float32(20.0)
    f = np.float32(frame)
    ox = float(np.float32(np.sin(f / offset_rate)) * offset_scale)
    oz = float(np.float32(np.cos(f / offset_rate)) * offset_scale * np.float32(0.3))
    off = np.array([ox, 0.0, oz])
    return config.replace(
        min_bound=tuple(np.asarray(config.min_bound) + off),
        max_bound=tuple(np.asarray(config.max_bound) + off),
    )


def simple_config_with_2_cubes(
    count: int = 20_000,
    solver_iter: int = 6,
    scaling: float = 500.0,
    dtype=np.float32,
) -> Tuple[McParams, SphParams, ParticleSoA]:
    """The benchmark/GUI workload: two cubes of count/2 particles each at
    (100,0,100) and (600,0,600), spacing 22, dt=0.0083*1.5, gravity (0,9.8,0),
    bounds (0..1000)^3 (reference `src/sph.hpp:160-186`)."""
    tag = 0
    tag, cube1 = make_cube(tag, 22.0, count // 2, (100.0, 0.0, 100.0), (0.0, 0.1, 0.8, 1.0), dtype)
    tag, cube2 = make_cube(tag, 22.0, count // 2, (600.0, 0.0, 600.0), (0.1, 0.8, 0.1, 1.0), dtype)
    particles = ParticleSoA.concat([cube1, cube2])

    config = SphParams(
        dt=0.0083 * 1.5,
        scale=float(scaling),
        iteration=int(solver_iter),
        constant_force=(0.0, 9.8, 0.0),
        min_bound=(0.0, 0.0, 0.0),
        max_bound=(1000.0, 1000.0, 1000.0),
        h=0.1,
        wait=True,
        surface=None,
    )
    mc = McParams(resolution=2.0, isolevel=100.0, particle_size=25.0, particle_influence=0.5)
    return mc, config, particles
