"""pbf-sph-tpu-torch: the PyTorch and CUDA port of pbf-sph-tpu.

The same Position-Based-Fluids frame as the JAX package (`pbf_sph_tpu`), on
torch tensors of a fixed capacity on an explicit device, with two device
backends (`models.DEVICE_BACKENDS`):
* `torch`: the neighbour phases and the MC field are hand-written CUDA
  kernels for Hopper (`csrc/pbf_cells.cu`, `csrc/pbf_diffuse_cells.cu`,
  `csrc/mc_field_cells.cu`), built with `nvcc` at first use; on the CPU they
  run their plain PyTorch versions.  fp32 only.
* `gather`: the JAX package's XLA gather path on plain torch ops, with no
  kernel, on either device, in fp32 or fp64.
and two host oracles beside them (`models.BACKENDS`), fp32 or fp64:
* `cpp`: the C++/OpenMP oracle (`native/csrc/ompsph.cpp`), built with g++
  at first use and bound with ctypes;
* `numpy`: the NumPy oracle (`models/numpy_solver.py`).
`python -m pbf_sph_tpu_torch.cli` is the benchmark CLI.  The package
imports torch and numpy, never jax.
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
