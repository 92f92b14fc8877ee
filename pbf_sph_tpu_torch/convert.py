"""Carry state between the JAX package and the port as numpy arrays.

The JAX package's `FluidState`, dyn dict and scene-array dict, pulled to
numpy, become the port's tensors on `device`, and back.  The tests use this
so that both packages step the same state.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from pbf_sph_tpu_torch.core.types import FluidState

STATE_FIELDS = ("pid", "ptype", "mass", "position", "velocity", "colour", "alive")


def arrays_to_device(d: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy (or array-like) values -> tensors on `device`, dtypes kept."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in d.items()}


def state_from_numpy(d: Dict[str, Any], device) -> FluidState:
    """`{pid, ptype, mass, position, velocity, colour, alive}` -> FluidState."""
    return FluidState(**arrays_to_device({k: d[k] for k in STATE_FIELDS}, device))


def state_to_numpy(state: FluidState) -> Dict[str, np.ndarray]:
    return {k: getattr(state, k).cpu().numpy() for k in STATE_FIELDS}


def dyn_from_numpy(d: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return arrays_to_device(d, device)


def scene_arrays_from_numpy(d: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return arrays_to_device(d, device)
