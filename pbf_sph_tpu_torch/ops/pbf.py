"""Per-particle PBF phases outside the neighbour walk: advect and finalise.

Port of `advect` and `finalise` in `pbf_sph_tpu/ops/pbf.py` (reference host
phases `src/omp/ompsph.hpp:137-151`, finalise kernel
`src/ocl/oclsph_kernel.h:164-174`).  The neighbour phases live in
`ops/phases.py`.
"""

from __future__ import annotations

import torch

from pbf_sph_tpu_torch.core.constants import DEFAULT_CONSTANTS as K
from pbf_sph_tpu_torch.core.types import FLUID


def advect(position, velocity, mass, ptype, alive, wells_centre, wells_force,
           constant_force, dt, scale):
    """v += F*dt; pStar = v*dt + pos/scale for fluid particles
    (reference `src/omp/ompsph.hpp:137-151`); obstacles keep pStar = pos/scale
    (OCL semantics, `src/ocl/oclsph.cpp:64-69`).

    `position`/`velocity` are (3, C); returns ((3,C) vel, (3,C) pstar)."""
    fluid = (ptype == FLUID) & alive
    force = [mass * constant_force[a] for a in range(3)]
    n_wells = wells_centre.shape[0]
    for w in range(n_wells):  # static, tiny
        diff = [wells_centre[w, a] - position[a] for a in range(3)]
        dist = torch.sqrt(diff[0] ** 2 + diff[1] ** 2 + diff[2] ** 2)
        near = dist < 75.0
        dist_safe = torch.where(dist > 0, dist, 1.0)
        for a in range(3):
            fw = (diff[a] / dist_safe) * wells_force[w] * mass / (dist_safe * dist_safe)
            fw = torch.clamp(fw, -10.0, 10.0)
            force[a] = force[a] + torch.where(near, fw, 0.0)
    vel = torch.stack(
        [torch.where(fluid, velocity[a] + force[a] * dt, velocity[a]) for a in range(3)]
    )
    pstar = torch.stack(
        [
            torch.where(fluid, vel[a] * dt + position[a] / scale, position[a] / scale)
            for a in range(3)
        ]
    )
    return vel, pstar


def finalise(position, velocity, pstar, ptype, alive, dt, scale):
    """v = (dX/dt + v)*VD; pos = pStar*scale
    (reference `src/ocl/oclsph_kernel.h:164-174`).  All (3, C)."""
    fluid = (ptype == FLUID) & alive
    inv_dt = 1.0 / dt
    pos_rows, vel_rows = [], []
    for a in range(3):
        delta_x = pstar[a] - position[a] / scale
        pos_rows.append(torch.where(fluid, pstar[a] * scale, position[a]))
        vel_rows.append(
            torch.where(fluid, (delta_x * inv_dt + velocity[a]) * K.VD, velocity[a])
        )
    return torch.stack(pos_rows), torch.stack(vel_rows)
