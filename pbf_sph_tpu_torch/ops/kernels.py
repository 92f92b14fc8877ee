"""SPH smoothing-kernel factors.

Factors match the reference exactly: poly6 315/(64*pi*h^9), spiky
-45/(pi*h^6) (reference `src/sph.hpp:252-253`).  The kernel functions
themselves are written out inside the phase code (`ops/phases.py`,
`csrc/pbf_phases.cu`).
"""

from __future__ import annotations

import math


def poly6_factor(h: float) -> float:
    return 315.0 / (64.0 * math.pi * h**9)


def spiky_kernel_factor(h: float) -> float:
    return -(45.0 / (math.pi * h**6))
