"""Solver backends of the port."""

from __future__ import annotations

from typing import Any

BACKENDS = ("torch",)


def make_solver(impl: str, h: float = 0.1, **kwargs: Any):
    """Construct a solver backend by name; `device=` is passed through."""
    if impl == "torch":
        from pbf_sph_tpu_torch.models.torch_solver import TorchSolver

        return TorchSolver(h=h, **kwargs)
    raise ValueError(f"unknown impl {impl!r}; available: {BACKENDS}")
