"""The v2 plan's per-sub-block slab need (wcap) at dam1m, by gap split.

Port of `tools/analyze_wcap.py`.  From the frame-0 cells of
`dam_break(count, 6)` (pStar taken as position/scale, no advect, as the JAX
tool takes it), sorted by the port's `ops/grid.py` key and table, the tool
splits each SUB-row sub-block of `tools/phases2.py`'s plan at its top G-1
cell-id gaps, G = 1, 2, 3, 4, 6 (the plan splits at NPIECES), takes the nine
stencil windows of each piece, makes them disjoint and counts the
WCOL-column source chunks that cover them: the census of slab chunks a
sub-block, whose maximum is the wcap the plan would need at that split.
The state is prepared on the device with the gather backend's capacity
(the JAX tool's `make_solver("jax")`: 128-aligned), and the census runs in
NumPy over the cell table on the host.

    python -m pbf_sph_tpu_torch.tools.analyze_wcap [count] [--devices cpu]

JSON last.
"""

from __future__ import annotations

import json
import sys
from typing import Dict

import numpy as np
import torch

from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.types import Scene
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, dyn_params_of
from pbf_sph_tpu_torch.ops.grid import build_cell_table, cell_coords, sort_key
from pbf_sph_tpu_torch.tools import study
from pbf_sph_tpu_torch.tools.phases2 import NPIECES, SUB, WCOL

SPLITS = (1, 2, 3, 4, 6)
QUANTILES = (50, 90, 99, 99.9, 100)


def frame0_index(count: int, device):
    """(grid, sorted key (C,), cell table (ncells + 1,)) as host int64
    arrays, of dam_break(count, 6)'s initial positions on `device`."""
    _, cfg, xs = dam_break(count, solver_iter=6)
    solver = TorchSolver(h=cfg.h, gather=True, device=device)
    spec, state, _ = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, solver.dtype, solver.device)
    scale = float(spec.scale)
    # as the JAX tool: min_extent and pos/scale in float32 NumPy
    min_extent = dyn["min_bound"].cpu().numpy() / scale - spec.h * 2
    pos = state.position.cpu().numpy() / scale
    cells = cell_coords(torch.from_numpy(pos).to(device), torch.from_numpy(min_extent).to(device),
                        spec.h)
    key = torch.sort(sort_key(cells, state.alive, spec.grid), stable=True).values
    table = build_cell_table(key, spec.grid)
    return spec.grid, key.cpu().numpy().astype(np.int64), table.cpu().numpy().astype(np.int64)


def census(key: np.ndarray, table: np.ndarray, grid) -> Dict[int, np.ndarray]:
    """{G: (nsub,) slab chunks a sub-block} for each G of SPLITS
    (`analyze_wcap.py:53-96`)."""
    ncells = grid.ncells
    _, ny, nz = grid.dims
    C = key.shape[0]
    lin = np.minimum(key, ncells - 1)
    last_valid = lin[max(int(table[ncells]) - 1, 0)]
    lin = np.minimum(lin, last_valid)
    nsub = C // SUB
    linr = lin[:nsub * SUB].reshape(nsub, SUB)
    offs = np.array([dx * ny * nz + dy * nz for dx in (-1, 0, 1) for dy in (-1, 0, 1)])
    out = {}
    for G in SPLITS:
        # split each sub-block's sorted cells at the top-(G-1) gaps
        d = np.diff(linr, axis=1)
        top = np.argsort(d, axis=1)[:, -(G - 1):] if G > 1 else np.zeros((nsub, 0), int)
        top = np.sort(top, axis=1)
        starts = np.concatenate([np.zeros((nsub, 1), int), top + 1], axis=1)  # (nsub, G)
        ends = np.concatenate([top, np.full((nsub, 1), SUB - 1)], axis=1)
        pmin = np.take_along_axis(linr, starts, axis=1)
        pmax = np.take_along_axis(linr, ends, axis=1)
        # a piece's nine windows: cells [pmin+off-1, pmax+off+2)
        lo_cell = np.clip(pmin[:, :, None] + offs[None, None, :] - 1, 0, ncells)
        hi_cell = np.clip(pmax[:, :, None] + offs[None, None, :] + 2, 0, ncells)
        ilo = table[lo_cell].reshape(nsub, -1)
        ihi = table[hi_cell].reshape(nsub, -1)
        o = np.argsort(ilo, axis=1, kind="stable")
        ilo = np.take_along_axis(ilo, o, axis=1)
        ihi = np.take_along_axis(ihi, o, axis=1)
        # chunk covering with a running max of the covered chunk end
        a = ilo // WCOL
        b = np.where(ihi > ilo, (ihi - 1) // WCOL + 1, a)
        nch = np.zeros(nsub, np.int64)
        prev = np.full(nsub, -1, np.int64)
        for i in range(ilo.shape[1]):
            ai = np.maximum(a[:, i], prev)
            ki = np.where(ihi[:, i] > ilo[:, i], np.maximum(b[:, i] - ai, 0), 0)
            nch += ki
            prev = np.maximum(prev, np.where(ki > 0, b[:, i], prev))
        out[G] = nch
    return out


def main(argv=None) -> int:
    device, argv = study.pop_device(sys.argv[1:] if argv is None else argv)
    count = int(argv[0]) if argv else 1_000_000
    card = study.card_line(device)
    print(card)
    grid, key, table = frame0_index(count, device)
    print(f"count={count} capacity={key.shape[0]} grid={grid.dims} ncells={grid.ncells} "
          f"members={table[grid.ncells]} ({device})")
    res = {"card": card, "count": count, "device": str(device), "capacity": int(key.shape[0]),
           "members": int(table[grid.ncells]), "sub": SUB, "wcol": WCOL,
           "plan_pieces": NPIECES, "census": {}}
    for G, nch in census(key, table, grid).items():
        q = np.percentile(nch, QUANTILES)
        print(f"G={G}: chunks/subblock p50={q[0]:.0f} p90={q[1]:.0f} p99={q[2]:.0f} "
              f"p99.9={q[3]:.0f} max={q[4]:.0f} (wcap={int(q[4]) * WCOL})"
              + ("  <- the plan's split" if G == NPIECES else ""))
        res["census"][G] = dict(zip(("p50", "p90", "p99", "p99.9", "max"),
                                    (float(v) for v in q)), wcap=int(q[4]) * WCOL)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
