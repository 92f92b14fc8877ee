"""Benchmark workload presets.

`bench20k` is the reference's fixed benchmark workload
(reference `src/benchmark.cpp:23-29`).  The dam-break family implements the
BASELINE.json configs: ~32k parity run, 256k solver-only, 128k + MC export,
1M north-star, 2M stress.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from pbf_sph_tpu_torch.core.constants import DEFAULT_CONSTANTS as K
from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
from pbf_sph_tpu_torch.core.types import FLUID, McParams, ParticleSoA, SphParams


def dam_break(
    count: int,
    solver_iter: int = 6,
    h: float = 0.1,
    surface: bool = False,
    dtype=np.float32,
) -> Tuple[McParams, SphParams, ParticleSoA]:
    """Dam-break: a fluid column against one wall of the (0..1000)^3 domain.

    The world scale is derived from `count` so the column sits near the PBF
    rest density (RHO=6378 particles per sim-unit^3 at unit mass), i.e. the
    constraint solver starts in a physical regime instead of a pathological
    compression shock.  Column occupies ~30% x, ~90% y, 100% z of the domain.
    """
    sp = (1.0 / K.RHO) ** (1.0 / 3.0)  # rest spacing in sim units
    frac = 0.3 * 0.9 * 1.0
    S = (count * sp**3 / frac) ** (1.0 / 3.0)  # domain side in sim units
    scale = 1000.0 / S

    sp_world = float(sp * scale)
    margin = 0.02 * 1000.0
    max_side = int((1000.0 - 2 * margin) / sp_world)  # lattice points per axis

    nx = max(1, int(round(0.3 * S / sp)))
    ny = min(max_side, max(1, int(round(0.9 * S / sp))))
    nz = min(max_side, max(1, int(round(count / (nx * ny)))))
    nx = min(max_side, max(1, -(-count // (ny * nz))))  # widen x to fit count
    n = nx * ny * nz

    x, y, z = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    grid = np.stack([x.ravel(), y.ravel(), z.ravel()], 1).astype(dtype)
    pos = grid * dtype(sp_world) + dtype(margin)
    assert pos.max() <= 1000.0 - margin / 2, "dam column must fit the domain"
    particles = ParticleSoA(
        pid=np.arange(n, dtype=np.int32),
        ptype=np.full(n, FLUID, np.int32),
        mass=np.ones(n, dtype),
        position=pos,
        velocity=np.zeros((n, 3), dtype),
        colour=np.broadcast_to(np.asarray((0.1, 0.3, 0.9, 1.0), dtype), (n, 4)).copy(),
    )

    mc = McParams(resolution=1.0, isolevel=100.0, particle_size=25.0, particle_influence=0.5)
    config = SphParams(
        dt=0.0083 * 1.5,
        scale=float(scale),
        iteration=int(solver_iter),
        constant_force=(0.0, 9.8, 0.0),
        min_bound=(0.0, 0.0, 0.0),
        max_bound=(1000.0, 1000.0, 1000.0),
        h=h,
        surface=mc if surface else None,
    )
    return mc, config, particles


WORKLOADS = {
    # the reference benchmark workload (src/benchmark.cpp:23-29)
    "bench20k": lambda: _with_surface(simple_config_with_2_cubes(20_000, 6, 500.0)),
    "bench20k-nosurf": lambda: simple_config_with_2_cubes(20_000, 6, 500.0),
    # BASELINE.json configs
    "parity32k": lambda: dam_break(32_000, solver_iter=3),
    "dam256k": lambda: dam_break(256_000, solver_iter=5),
    "mc128k": lambda: dam_break(128_000, solver_iter=3, surface=True),
    # MC-scaling point: 4x the particles/lattice of mc128k
    "mc512k": lambda: dam_break(512_000, solver_iter=3, surface=True),
    "dam1m": lambda: dam_break(1_000_000, solver_iter=6),
    "dam2m": lambda: dam_break(2_000_000, solver_iter=6),
}


def _with_surface(tup):
    mc, cfg, xs = tup
    return mc, cfg.replace(surface=mc), xs
