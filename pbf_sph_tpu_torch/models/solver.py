"""Abstract solver interface.

The single entry point mirrors the reference's abstract Solver
(`Solver::advance(config, scene, xs) -> Result`, reference
`src/sph.hpp:119-125`), adapted to functional style: instead of mutating the
particle vector in place, `advance` returns the new particle state alongside
the Result.  Particle order in the returned state is Morton-sort order, like
the reference's writeback (`src/omp/ompsph.hpp:480`).
"""

from __future__ import annotations

import abc
from typing import Tuple

from pbf_sph_tpu_torch.core.types import ParticleSoA, Result, Scene, SphParams


class Solver(abc.ABC):
    def __init__(self, h: float = 0.1):
        self.h = float(h)

    @abc.abstractmethod
    def advance(
        self, config: SphParams, scene: Scene, xs: ParticleSoA
    ) -> Tuple[Result, ParticleSoA]:
        ...
