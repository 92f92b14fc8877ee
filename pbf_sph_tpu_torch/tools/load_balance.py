"""Load balance of the x-slabs under the sloshing workload.

Port of `tools/load_balance.py`.  It runs the single-chip solver on the
benchmark's oscillating-bounds motion (`apply_motion_sin_x_cos_z`,
reference `src/sph.hpp:147-158`) and records, every frame, the fraction of
the particles in each x-slab of an `n_dev`-way split of the grid's columns:
the peak slab fraction over the run is what the slab engine's `cap_local`
must hold.  Before the frames the state settles for 5 frames with the
capacity growth of `bench.warm_up` (the JAX tool runs its own abbreviated
protocol, up to 4 rounds of 5 frames).

`PBF_LB_REBALANCE=1` also applies the slab engine's rebalancing policy
(`parallel/sharded.py` step 8: equal-count boundaries from the x-CDF, each
moving at most one column a frame, slabs at least `min_slab_w` = 3 columns
wide) as an offline what-if on the same single-chip run, and reports both
tables.  `PBF_LB_IMPL` is the backend: `torch` (the kernels, default) or
`gather`.

    python -m pbf_sph_tpu_torch.tools.load_balance [count] [n_dev] [frames] [--devices cpu]

The JAX tool also writes its JSON to /tmp/load_balance.json; this one prints
it as its last line.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.scene import apply_motion_sin_x_cos_z
from pbf_sph_tpu_torch.models.torch_solver import dyn_params_of
from pbf_sph_tpu_torch.tools import study

MIN_SLAB_W = 3


def col_hist(position, alive, min_bound_x, scale: float, h: float, gx: int) -> torch.Tensor:
    """(gx,) particles a global x-column (the rebalance CDF's input), as the
    JAX tool's `col_hist` (`load_balance.py:49-58`), on the state's device."""
    min_ext_x = min_bound_x / scale - h * 2
    gcx = torch.trunc(torch.clamp((position[0] / scale - min_ext_x) / h, -2e9, 2e9))
    gcx = torch.clamp(gcx.to(torch.int32), 0, gx - 1)
    return torch.zeros(gx, dtype=torch.int32, device=position.device).index_add_(
        0, gcx.long(), alive.to(torch.int32))


def slab_fracs(bounds: np.ndarray, cdf: np.ndarray, gx: int) -> np.ndarray:
    """(n_dev,) the particle fraction in each slab [bounds[d], bounds[d+1])."""
    ends = np.minimum(bounds[1:], gx)
    cum = cdf[ends - 1]  # inclusive prefix count at each boundary
    return np.diff(np.concatenate(([0], cum))) / max(cdf[-1], 1)


def initial_bounds(cdf: np.ndarray, n_dev: int, gx: int,
                   min_slab_w: int = MIN_SLAB_W) -> np.ndarray:
    """Unclamped equal-count boundaries (`ShardSpec.initial_bounds`)."""
    b = np.zeros(n_dev + 1, dtype=np.int64)
    b[-1] = gx
    for d in range(1, n_dev):
        target = (int(cdf[-1]) * d) // n_dev
        v = int(np.searchsorted(cdf, target, side="left")) + 1
        b[d] = int(np.clip(v, b[d - 1] + min_slab_w, gx - min_slab_w * (n_dev - d)))
    return b


def rebalance_bounds(bounds: np.ndarray, hist: np.ndarray, n_dev: int, gx: int,
                     min_slab_w: int = MIN_SLAB_W) -> np.ndarray:
    """The slab engine's step 8: equal-count targets from the x-CDF, moves
    clamped to 1 column a frame, widths >= min_slab_w."""
    cdf = np.cumsum(hist)
    total = int(cdf[-1])
    new = bounds.copy()
    for d in range(1, n_dev):
        target = (total * d) // n_dev
        raw = int(np.searchsorted(cdf, target, side="left")) + 1
        raw = int(np.clip(raw, bounds[d] - 1, bounds[d] + 1))
        new[d] = int(np.clip(raw, new[d - 1] + min_slab_w, gx - min_slab_w * (n_dev - d)))
    return new


def report(fr: np.ndarray, label: str, n_dev: int, frames: int, count: int):
    """Print the JAX tool's table for (frames, n_dev) fractions; (peak,
    peak a slab)."""
    peak_per_slab = fr.max(axis=0)
    peak = float(fr.max())
    print(f"[{label}] slabs={n_dev} frames={frames} count={count}")
    print("peak fraction per slab:", np.round(peak_per_slab, 4).tolist())
    print("mean fraction per slab:", np.round(fr.mean(axis=0), 4).tolist())
    print(f"peak slab fraction: {peak:.4f}  (uniform {1 / n_dev:.4f}; "
          f"imbalance {peak * n_dev:.2f}x)")
    hist, edges = np.histogram(fr.max(axis=1), bins=10)
    print("per-frame max-slab-fraction histogram:")
    for i, hv in enumerate(hist):
        print(f"  [{edges[i]:.3f},{edges[i + 1]:.3f}): {hv}")
    return peak, peak_per_slab


def main(argv=None) -> int:
    device, argv = study.pop_device(sys.argv[1:] if argv is None else argv)
    count = int(argv[0]) if argv else 256_000
    n_dev = int(argv[1]) if len(argv) > 1 else 8
    frames = int(argv[2]) if len(argv) > 2 else 200
    impl = os.environ.get("PBF_LB_IMPL", "torch")
    if impl not in ("torch", "gather"):
        raise SystemExit(f"PBF_LB_IMPL={impl!r}: the port's backends are torch and gather")
    rebalance = os.environ.get("PBF_LB_REBALANCE", "") not in ("", "0")
    card = study.card_line(device)
    print(card)
    solver, spec, state, _, scn, cfg = study.settled(
        dam_break(count, solver_iter=6), device, gather=impl == "gather")
    gx = spec.grid.dims[0]
    slab_w = -(-gx // n_dev)

    fixed = np.arange(n_dev + 1, dtype=np.int64) * slab_w
    fixed[-1] = gx
    dyn_bounds = None
    fracs, fracs_dyn = [], []
    for f in range(frames):
        dyn = dyn_params_of(apply_motion_sin_x_cos_z(cfg, f), solver.dtype, solver.device)
        state, _ = solver.step_device(spec, state, dyn, scn)
        hist = col_hist(state.position, state.alive, dyn["min_bound"][0], spec.scale,
                        spec.h, gx).cpu().numpy()
        cdf = np.cumsum(hist)
        fracs.append(slab_fracs(fixed, cdf, gx))
        if rebalance:
            if dyn_bounds is None:
                dyn_bounds = initial_bounds(cdf, n_dev, gx)
            fracs_dyn.append(slab_fracs(dyn_bounds, cdf, gx))
            dyn_bounds = rebalance_bounds(dyn_bounds, hist, n_dev, gx)
    fracs = np.asarray(fracs)  # (frames, n_dev)

    peak, peak_per_slab = report(fracs, f"fixed slab_w={slab_w}", n_dev, frames, count)
    out = dict(card=card, device=str(device), impl=impl, count=count, n_dev=n_dev,
               frames=frames, peak_frac=peak, peak_per_slab=peak_per_slab.tolist(),
               mean_per_slab=fracs.mean(axis=0).tolist())
    if rebalance:
        fracs_dyn = np.asarray(fracs_dyn)
        pk, pps = report(fracs_dyn, "rebalanced (CDF, 1 col/frame)", n_dev, frames, count)
        out.update(peak_frac_rebalanced=pk, peak_per_slab_rebalanced=pps.tolist(),
                   mean_per_slab_rebalanced=fracs_dyn.mean(axis=0).tolist())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
