"""Physical constants of the PBF model.

Semantics match the reference's compile-time constant block
(reference `src/sph_constants.h:5-16`).  All values are fp32 exactly as the
reference declares them; they are plain Python floats here and get cast to the
working dtype where they are used.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class SphConstants:
    # Velocity dampening applied in the finalise phase (sph_constants.h:5).
    VD: float = 0.49
    # Reference (rest) density (sph_constants.h:6-7).
    RHO: float = 6378.0
    # Small epsilon gating the spiky gradient's 1/r (sph_constants.h:9).
    EPSILON: float = 1e-8
    # Constraint-force-mixing relaxation in the lambda solve (sph_constants.h:10).
    CFM_EPSILON: float = 600.0
    # Tensile-instability (s-corr) parameters (sph_constants.h:11,15-16).
    CORR_DELTA_Q: float = 0.3
    CORR_K: float = 0.0001
    CORR_N: float = 4.0
    # Vorticity-confinement constants exist in the reference but are vestigial
    # (constant declared at sph_constants.h:13-14, omega field commented out at
    # src/ocl/oclsph_type.h:28); kept for API completeness, unused.
    C: float = 0.00001
    VORTICITY_EPSILON: float = 0.0005

    @property
    def RHO_RECIP(self) -> float:
        return 1.0 / self.RHO


DEFAULT_CONSTANTS = SphConstants()
