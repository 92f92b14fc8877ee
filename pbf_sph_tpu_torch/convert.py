"""Carry state between the JAX package and the port as numpy arrays.

The JAX package's `FluidState`, dyn dict and scene-array dict, pulled to
numpy, become the port's tensors on `device`, and back.  A JAX sharded state
(capacity n_dev x cap_total, device-major) becomes the slab engine's
per-rank states and comes back the same way.  The tests use this so that
both packages step the same state.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

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


def sharded_state_from_numpy(d: Dict[str, Any], n_dev: int, device) -> List[FluidState]:
    """A device-major global state (each field's last axis n_dev blocks of
    cap_total rows) -> the n_dev ranks' states on `device`."""
    n = np.asarray(d["pid"]).shape[-1]
    if n % n_dev:
        raise ValueError(f"capacity {n} is not {n_dev} equal blocks")
    ct = n // n_dev
    return [state_from_numpy({k: np.asarray(d[k])[..., r * ct:(r + 1) * ct]
                              for k in STATE_FIELDS}, device) for r in range(n_dev)]


def sharded_state_to_numpy(states: Sequence[FluidState]) -> Dict[str, np.ndarray]:
    """The ranks' states (rank order) -> one device-major global state."""
    parts = [state_to_numpy(s) for s in states]
    return {k: np.concatenate([p[k] for p in parts], axis=-1) for k in STATE_FIELDS}
