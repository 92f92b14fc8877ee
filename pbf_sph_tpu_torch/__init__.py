"""pbf-sph-tpu-torch: the PyTorch and CUDA port of pbf-sph-tpu.

The same Position-Based-Fluids frame as the JAX package (`pbf_sph_tpu`), on
torch tensors of a fixed capacity on an explicit device.  The three
neighbour phases (diffuse, lambda, delta) are hand-written CUDA kernels for
Hopper (`csrc/pbf_phases.cu`), built with `nvcc` at first use; on the CPU
they run their plain PyTorch versions.  The package imports torch and numpy,
never jax.
"""

__version__ = "0.1.0"

from pbf_sph_tpu_torch.core.constants import SphConstants
from pbf_sph_tpu_torch.core.types import FluidState, McParams, Scene, SphParams
from pbf_sph_tpu_torch.core import scene as scene_builders
from pbf_sph_tpu_torch.models import make_solver

__all__ = [
    "SphConstants",
    "FluidState",
    "McParams",
    "Scene",
    "SphParams",
    "scene_builders",
    "make_solver",
]
