"""Solver backends of the port."""

from __future__ import annotations

from typing import Any

# torch: the hand-written CUDA kernels (fp32); gather: the JAX package's XLA
# gather path on plain torch ops (fp32 or fp64), no kernel.  Both run on a
# device, "cuda" unless the caller asks for another.
DEVICE_BACKENDS = ("torch", "gather")
# cpp: the C++/OpenMP oracle; numpy: the NumPy oracle.  Both run on the host
# in fp32 or fp64, and never stand in for a device backend.
ORACLE_BACKENDS = ("cpp", "numpy")
BACKENDS = DEVICE_BACKENDS + ORACLE_BACKENDS


def make_solver(impl: str, h: float = 0.1, **kwargs: Any):
    """Construct a solver backend by name (the reference's `--impl` map,
    `src/args.hpp:24-30`); `dtype=` is passed through, and `device=` to a
    device backend.  An oracle takes no device: one other than None or "cpu"
    raises."""
    if impl in DEVICE_BACKENDS:
        from pbf_sph_tpu_torch.models.torch_solver import TorchSolver

        return TorchSolver(h=h, gather=impl == "gather", **kwargs)
    if impl in ORACLE_BACKENDS:
        device = kwargs.pop("device", None)
        if device is not None and str(device) != "cpu":
            raise ValueError(f"the {impl} oracle runs on the host; it takes no device "
                             f"({device!r})")
        if impl == "cpp":
            from pbf_sph_tpu_torch.models.cpp_solver import CppSolver

            return CppSolver(h=h, **kwargs)
        from pbf_sph_tpu_torch.models.numpy_solver import NumpySolver

        return NumpySolver(h=h, **kwargs)
    raise ValueError(f"unknown impl {impl!r}; available: {BACKENDS}")
