"""Shared capacity-growth policy.

Port of the cell-capacity, triangle-capacity, cube-compaction,
blocked-emission and query-capacity branches of `pbf_sph_tpu/models/growth.py`.  One frame's
outputs report the static capacities the step depends on; when one
overflows, the frame is suspect and must be re-run under a larger spec.
Consumed by `TorchSolver.advance` (re-run the same frame) and by `bench.py`
(restart warmup from a fresh state).

On the gather backend, `max_occupancy > cell_capacity` means that the (K, C)
gathers truncated a cell's candidates: the frame is re-run under the larger
K.  The kernel backend walks exact cell ranges, so there its cell branch
only keeps the specs and warmups of both backends alike.

The JAX policy's two strip branches are not carried, by the port's ground
rule of porting what a kernel computes and not how the TPU lays it out.
`strip_capacity` sizes the VMEM strips of the Pallas λ/Δp kernels, and
`mc_strip_capacity` those of the Pallas MC field, with its fall-back to the
XLA field (`mc_pallas=False`) when a strip outgrows VMEM
(`growth.py:79-92`).  The port's kernels and fields read the cell table
directly and hold no strip, so no strip can overflow: `strip_overflow` and
`mc_strip_overflow` are always 0, and there is nothing to fall back from.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from pbf_sph_tpu_torch.ops.mc import EMIT_CAP_DEFAULT


def growth_changes(spec, out) -> Dict[str, Any]:
    """Return the `dataclasses.replace(spec, **changes)` field changes needed
    after a step produced outputs `out`; empty dict = all capacities held.

    Reads the host values of the scalars in `out` (a sync on a device)."""
    changes: Dict[str, Any] = {}

    # cell occupancy -> cell_capacity.  1.5x headroom: occupancy keeps rising
    # while the fluid compresses; growing to the observed max exactly would
    # regrow every few frames.
    occ = int(out["max_occupancy"])
    if occ > spec.cell_capacity:
        changes["cell_capacity"] = -(-int(occ * 1.5) // 16) * 16

    if spec.surface is not None:
        # triangle count -> surface.tri_capacity
        tri = int(out["tri_count"])
        if tri > spec.surface.tri_capacity:
            changes["surface"] = dataclasses.replace(
                spec.surface, tri_capacity=-(-int(tri * 1.5) // 1024) * 1024)

        # live cubes beyond the compaction rows -> surface.cube_cap, up to the
        # march volume, where compaction keeps every cube and cannot overflow
        eovf = int(out.get("mc_emit_overflow", 0))
        if eovf > 0 and spec.surface.cube_cap > 0:
            sur = changes.get("surface", spec.surface)
            vol = int(np.prod([s - 1 for s in sur.sample]))
            new_cap = -(-(sur.cube_cap + eovf) * 5 // 4 // 128) * 128
            changes["surface"] = dataclasses.replace(sur, cube_cap=min(new_cap, vol))
        # a block's live rows beyond its staging rows -> surface.emit_cap; a
        # block denser than 15 * emit_block / (5/4) rows falls back to the
        # one-stage emission (emit_block 0), which holds any density
        elif eovf > 0 and spec.surface.emit_block > 0:
            sur = changes.get("surface", spec.surface)
            cur = max(128, sur.emit_cap or EMIT_CAP_DEFAULT)
            new_cap = -(-(cur + eovf) * 5 // 4 // 128) * 128
            if new_cap >= 15 * sur.emit_block:
                changes["surface"] = dataclasses.replace(sur, emit_block=0, emit_cap=0)
            else:
                changes["surface"] = dataclasses.replace(sur, emit_cap=new_cap)

    # query-cell population -> scene.query_capacity (reference semantics are
    # unbounded)
    q_ovf = int(out.get("query_overflow", 0))
    if q_ovf > 0:
        sc = spec.scene
        new_q = -(-(sc.query_capacity + q_ovf) // 128) * 128
        changes["scene"] = dataclasses.replace(sc, query_capacity=new_q)

    return changes
