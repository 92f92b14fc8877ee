"""PBF phases on plain torch ops: advect, finalise, and the gather backend's
neighbour phases.

Port of `pbf_sph_tpu/ops/pbf.py` (reference host phases
`src/omp/ompsph.hpp:137-151`, kernels diffuse `src/ocl/oclsph_kernel.h:67-93`,
lambda `:95-123`, delta `:125-162`, finalise `:164-174`).  The kernel
backend's neighbour phases live in `ops/phases.py`.

The gather backend's `diffuse`, `lambda_phase` and `delta_phase` are the JAX
package's XLA path as it is: for each of the 27 stencil offsets a dense
(K, C) gather of cell candidates (K = the spec's `cell_capacity`, C = the
particle capacity), the pair math and a masked sum over K.  A cell with more
than K members is truncated to its first K; the step reports the occupancy
so that the frame can be re-run under a larger K.  They launch no kernel of
the port and run on either device.  The spiky gradient takes the XLA path's
sqrt form, `(h - r)^2 / r`, not the kernels' rsqrt form.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from pbf_sph_tpu_torch.core.constants import DEFAULT_CONSTANTS as K
from pbf_sph_tpu_torch.core.types import FLUID, OBSTACLE
from pbf_sph_tpu_torch.ops.kernels import poly6_factor, spiky_kernel_factor


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of `like`'s dtype and device.  Dividing by it is a true
    division on CUDA too, where a host scalar divisor becomes a reciprocal
    multiply."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


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


# ---------------------------------------------------------------------------
# Gather backend: the neighbour phases as dense (K, C) gathers
# ---------------------------------------------------------------------------


def _candidates(start, end, cap: int):
    """(K, C) int64 candidate indices + mask from per-particle [start, end).
    Masked slots index row 0, as `pbf.py:30-34`; every use masks them."""
    idx = start[None, :].long() + torch.arange(cap, device=start.device)[:, None]
    mask = idx < end[None, :]
    return torch.where(mask, idx, 0), mask


def _poly6_block(r2, mask, h: float, factor):
    hh = h * h
    t = hh - r2
    return torch.where(mask & (r2 <= hh), factor * (t * t * t), 0.0)


def _spiky_scale_block(r, mask, h: float, factor, eps: float):
    """Scalar multiplier s such that spiky_grad = d * s (d = x - y)."""
    valid = mask & (r >= eps) & (r <= h)
    r_safe = torch.where(valid, r, 1.0)
    t = h - r_safe
    return torch.where(valid, factor * ((t * t) / r_safe), 0.0)


def _pair_block(pstar, idx):
    """Candidate displacement components + squared distance for one offset.
    `pstar` is (3, C); idx is (K, C).  Returns ((dx,dy,dz) each (K,C), r2)."""
    d = [pstar[a][None, :] - pstar[a][idx] for a in range(3)]
    return d, d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def diffuse_sums(colour, ptype, ranges: List[Tuple], cap: int):
    """The non-obstacle neighbours' colour sums (four (C,)) and their count
    ((C,) int32) over the K-capped candidates of `ranges`."""
    n = colour.shape[1]
    mixture = [torch.zeros(n, dtype=colour.dtype, device=colour.device) for _ in range(4)]
    cnt = torch.zeros(n, dtype=torch.int32, device=colour.device)
    for start, end in ranges:
        idx, mask = _candidates(start, end, cap)
        nb_ok = mask & (ptype[idx] != OBSTACLE)
        w = nb_ok.to(colour.dtype)
        for a in range(4):
            mixture[a] = mixture[a] + torch.sum(colour[a][idx] * w, dim=0)
        cnt = cnt + torch.sum(nb_ok, dim=0, dtype=torch.int32)
    return mixture, cnt


def diffuse(colour, ptype, alive, ranges: List[Tuple], cap: int, dt):
    """Colour diffusion (reference `src/omp/ompsph.hpp:188-207`): neighbour
    colour mean * 1.33 mixed in with weight dt/750, clamped to [0.03, 1].
    `colour` is (4, C); `dt` a 0-d tensor."""
    mixture, cnt = diffuse_sums(colour, ptype, ranges, cap)
    cnt_safe = torch.clamp(cnt, min=1).to(colour.dtype)
    upd = (ptype == FLUID) & alive & (cnt > 0)
    rate = dt / scalar(750.0, colour)
    rows = []
    for a in range(4):
        target = (mixture[a] / cnt_safe) * scalar(1.33, colour)
        mixed = torch.clamp(colour[a] + rate * (target - colour[a]), 0.03, 1.0)
        rows.append(torch.where(upd, mixed, colour[a]))
    return torch.stack(rows)


def lambda_phase(pstar, mass, ptype, alive, ranges, cap: int, h: float):
    """Density-constraint multiplier (reference `src/ocl/oclsph_kernel.h:95-123`):
    rho_i = m_i * sum_j poly6(r); lambda = -(rho/RHO - 1)/(|grad C|^2 + CFM)."""
    n = pstar.shape[1]
    p6f = scalar(poly6_factor(h), pstar)
    skf = scalar(spiky_kernel_factor(h), pstar)
    p6_sum = torch.zeros(n, dtype=pstar.dtype, device=pstar.device)
    grad = [torch.zeros_like(p6_sum) for _ in range(3)]
    for start, end in ranges:
        idx, mask = _candidates(start, end, cap)
        d, r2 = _pair_block(pstar, idx)
        r = torch.sqrt(r2)
        p6_sum = p6_sum + torch.sum(_poly6_block(r2, mask, h, p6f), dim=0)
        s = _spiky_scale_block(r, mask, h, skf, K.EPSILON)
        for a in range(3):
            grad[a] = grad[a] + torch.sum(d[a] * s, dim=0)
    rho = mass * p6_sum
    rr = scalar(K.RHO_RECIP, pstar)
    g = [grad[a] * rr for a in range(3)]
    norm2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
    lam = -(rho * rr - 1.0) / (norm2 + scalar(K.CFM_EPSILON, pstar))
    return torch.where((ptype == FLUID) & alive, lam, 0.0)


def delta_phase(pstar, lam, ptype, alive, ranges, cap: int, h: float,
                scale, min_bound, max_bound):
    """Position correction + in-iteration bounds clamp
    (reference `src/ocl/oclsph_kernel.h:125-162`).  `pstar` is (3, C);
    `scale` a 0-d tensor, the bounds (3,)."""
    n = pstar.shape[1]
    p6f = scalar(poly6_factor(h), pstar)
    skf = scalar(spiky_kernel_factor(h), pstar)
    cdq = scalar(K.CORR_DELTA_Q * h, pstar)
    t = scalar(h * h, pstar) - cdq * cdq
    p6dq = p6f * (t * t * t)
    rr = scalar(K.RHO_RECIP, pstar)
    corr_k = scalar(-K.CORR_K, pstar)
    dp = [torch.zeros(n, dtype=pstar.dtype, device=pstar.device) for _ in range(3)]
    for start, end in ranges:
        idx, mask = _candidates(start, end, cap)
        d, r2 = _pair_block(pstar, idx)
        r = torch.sqrt(r2)
        x = _poly6_block(r2, mask, h, p6f) / p6dq
        x2 = x * x
        corr = corr_k * x2 * x2  # x^CORR_N, CORR_N = 4
        factor = (lam[None, :] + lam[idx] + corr) * rr
        s = _spiky_scale_block(r, mask, h, skf, K.EPSILON) * factor
        for a in range(3):
            dp[a] = dp[a] + torch.sum(d[a] * s, dim=0)
    fluid = (ptype == FLUID) & alive
    rows = []
    for a in range(3):
        moved = torch.clamp((pstar[a] + dp[a]) * scale, min_bound[a], max_bound[a]) / scale
        rows.append(torch.where(fluid, moved, pstar[a]))
    return torch.stack(rows)
