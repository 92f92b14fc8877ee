"""Solver backends of the port."""

from __future__ import annotations

from typing import Any

# torch: the hand-written CUDA kernels (fp32); gather: the JAX package's XLA
# gather path on plain torch ops (fp32 or fp64), no kernel
BACKENDS = ("torch", "gather")


def make_solver(impl: str, h: float = 0.1, **kwargs: Any):
    """Construct a solver backend by name; `dtype=` and `device=` are passed
    through."""
    if impl in BACKENDS:
        from pbf_sph_tpu_torch.models.torch_solver import TorchSolver

        return TorchSolver(h=h, gather=impl == "gather", **kwargs)
    raise ValueError(f"unknown impl {impl!r}; available: {BACKENDS}")
