"""SPH smoothing kernels: the factors, and the NumPy poly6 and spiky gradient.

Factors match the reference exactly: poly6 315/(64*pi*h^9), spiky
-45/(pi*h^6) (reference `src/sph.hpp:252-253`).  The torch paths write the
kernel functions out inside the phase code (`ops/phases.py`,
`csrc/pbf_phases.cu`); `poly6` and `spiky_gradient` below are the NumPy
forms of `pbf_sph_tpu/ops/kernels.py`, for the NumPy oracle
(`models/numpy_solver.py`):
  poly6(r) = factor*(h^2-r^2)^3 for r <= h (reference `src/omp/ompsph.hpp:67-69`),
  spiky_grad(x,y,r) = (x-y)*factor*(h-r)^2/r for EPSILON <= r <= h
  (reference `src/omp/ompsph.hpp:71-75`).
"""

from __future__ import annotations

import math

from pbf_sph_tpu_torch.core.constants import DEFAULT_CONSTANTS


def poly6_factor(h: float) -> float:
    return 315.0 / (64.0 * math.pi * h**9)


def spiky_kernel_factor(h: float) -> float:
    return -(45.0 / (math.pi * h**6))


def poly6(r, h: float, factor: float, xp):
    """poly6 kernel; 0 beyond h.  `xp` is numpy."""
    hh = h * h
    v = factor * (hh - r * r) ** 3
    return xp.where(r <= h, v, 0.0).astype(r.dtype)


def spiky_gradient(diff, r, h: float, factor: float, xp, eps: float = DEFAULT_CONSTANTS.EPSILON):
    """Spiky kernel gradient; `xp` is numpy.

    `diff` is x - y with shape (..., 3); `r` is |diff| with shape (...,).
    Returns 0 where r < EPSILON or r > h (reference `src/omp/ompsph.hpp:71-75`).
    """
    valid = (r >= eps) & (r <= h)
    r_safe = xp.where(valid, r, 1.0).astype(r.dtype)
    scale = factor * ((h - r_safe) ** 2 / r_safe)
    scale = xp.where(valid, scale, 0.0).astype(r.dtype)
    return diff * scale[..., None]
