"""Static census of the MC field's walk (row 4b) at a surface workload.

Port of `tools/analyze_mc_windows.py`, retargeted from the Pallas node
kernel's window plan to the walk of `csrc/mc_field_cells.cu`, the port's
MC field: a group of G lanes (`ops/mc_field.CELLS_LANES`) walks a node's
nine (dx, dy) columns, each the z-clamped range of the cell table
(`ops/mc_field.node_ranges_clamped`), candidate v of the node's list to
lane v mod G; 32/G consecutive nodes share a warp.  From the sort-time
frame that follows `frames` settling frames (`bench.warm_up`), the tool
reports:

1. the cells: occupied ones and their occupancy;
2. the nodes: live (one candidate or more) and vacuum, and the
   node-candidate pairs a live node;
3. the z-clamped ranges: empty ones, and the lengths of the others;
4. the lanes: trips a node (ceil(pairs / G)), and the share of lane slots
   that hold a candidate, a node's and a warp's (a warp runs as long as its
   longest node; a warp of vacuum nodes skips its butterfly).

The JAX tool's TPU figures (strips, chunk rounding, VMEM rate, a time per
chunk) have no counterpart here and are not carried.  The census runs on
the device's tensors and is read back as integers.

    python -m pbf_sph_tpu_torch.tools.analyze_mc_windows [workload] [frames] [--devices cpu]

JSON last.
"""

from __future__ import annotations

import json
import sys
from typing import Dict

import numpy as np
import torch

from pbf_sph_tpu_torch.models.torch_solver import advect_and_sort
from pbf_sph_tpu_torch.ops import mc_field as mf
from pbf_sph_tpu_torch.tools import study

WARP = 32


def dist(v: np.ndarray) -> Dict[str, float]:
    if not len(v):
        return dict(n=0, mean=0.0, p50=0.0, p90=0.0, p99=0.0, max=0)
    return dict(n=int(len(v)), mean=float(v.mean()), p50=float(np.percentile(v, 50)),
                p90=float(np.percentile(v, 90)), p99=float(np.percentile(v, 99)),
                max=int(v.max()))


def census(index, mc, lanes: int = mf.CELLS_LANES) -> dict:
    """The cells, nodes, ranges and lanes of row 4b's walk over `index` at
    the lattice of `mc` (see the module docstring)."""
    table = index.table.long()
    occ = (table[1:] - table[:-1]).cpu().numpy()
    _, cell, skip = mf.lattice_nodes(mc, index.grid.extent, index.table.device)
    lo, hi = mf.node_ranges_clamped(index, cell, skip)
    lens = (hi - lo).cpu().numpy()                       # (9, L)
    per_node = lens.sum(0)
    live = per_node > 0
    trips = -(-per_node // lanes)
    per_warp = WARP // lanes
    L = per_node.shape[0]
    pad = -L % per_warp
    wtrips = np.pad(trips, (0, pad)).reshape(-1, per_warp).max(1)
    pairs = int(per_node.sum())
    live_lens = lens[:, live]
    return dict(
        cells=dict(ncells=int(occ.shape[0]), occupied=int((occ > 0).sum()),
                   occupancy=dist(occ[occ > 0])),
        nodes=dict(lattice=list(mc.sample), res=mc.resolution, nodes=int(L),
                   skip=int(skip.sum()), live=int(live.sum()), vacuum=int((~live).sum()),
                   pairs=pairs, per_live=dist(per_node[live])),
        ranges=dict(live_node_ranges=int(live_lens.size),
                    empty=int((live_lens == 0).sum()),
                    lengths=dist(live_lens[live_lens > 0])),
        lanes=dict(G=lanes, nodes_a_warp=per_warp, lane_trips=int(trips.sum()),
                   node_slot_share=pairs / max(int(trips.sum()) * lanes, 1),
                   warps=int(wtrips.shape[0]), vacuum_warps=int((wtrips == 0).sum()),
                   warp_trips=int(wtrips.sum()),
                   warp_slot_share=pairs / max(int(wtrips.sum()) * WARP, 1)))


def main(argv=None) -> int:
    device, argv = study.pop_device(sys.argv[1:] if argv is None else argv)
    name = argv[0] if argv else "mc128k"
    frames = int(argv[1]) if len(argv) > 1 else 5
    card = study.card_line(device)
    print(card)
    _, spec, state, dyn, scn, _ = study.settled(study.workload_of(name), device, frames)
    fr = advect_and_sort(spec, state, dyn, scn)
    c = census(fr.index, spec.surface)
    ce, no, ra, la = c["cells"], c["nodes"], c["ranges"], c["lanes"]
    members = int(fr.index.table[-1])
    print(f"{name}: {members} particles, grid {spec.grid.dims} = {ce['ncells']} cells, "
          f"{ce['occupied']} occupied ({ce['occupied'] / ce['ncells']:.1%}), occupancy "
          f"mean {ce['occupancy']['mean']:.1f} max {ce['occupancy']['max']} ({device}, "
          f"after {frames} frames)")
    print(f"nodes: lattice {no['lattice']} at res {no['res']} = {no['nodes']}, "
          f"{no['live']} live, {no['vacuum']} vacuum ({no['vacuum'] / no['nodes']:.1%}), "
          f"{no['skip']} skipped")
    pl = no["per_live"]
    print(f"node-candidate pairs {no['pairs']}: a live node mean {pl['mean']:.2f} p50 "
          f"{pl['p50']:.0f} p99 {pl['p99']:.0f} max {pl['max']}")
    rl = ra["lengths"]
    print(f"z-clamped ranges of the live nodes: {ra['live_node_ranges']}, {ra['empty']} "
          f"empty ({ra['empty'] / max(ra['live_node_ranges'], 1):.1%}); lengths of the "
          f"others mean {rl['mean']:.2f} p50 {rl['p50']:.0f} p90 {rl['p90']:.0f} p99 "
          f"{rl['p99']:.0f} max {rl['max']}")
    print(f"lanes (G={la['G']}, {la['nodes_a_warp']} nodes a warp): {la['lane_trips']} lane "
          f"trips, {la['node_slot_share']:.1%} of a node's lane slots hold a candidate; "
          f"{la['warps']} warps, {la['vacuum_warps']} vacuum, {la['warp_trips']} warp trips, "
          f"{la['warp_slot_share']:.1%} of a warp's slots hold a candidate")
    print(json.dumps({"card": card, "workload": name, "device": str(device),
                      "frames": frames, "members": members, **c}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
