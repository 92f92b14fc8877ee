"""One full frame of the slab engine on tiny shapes.

Port of `__graft_entry__.dryrun_multichip` (`__graft_entry__.py:57`), its
first phase: the JAX entry point jits the sharded step over a virtual CPU
mesh of n devices; here `n` `ThreadComm` ranks run as threads on one device
(`parallel.comm.run_ranks`).  The scene is the JAX dry run's: the 2-cube
configuration at 800 particles and 2 iterations with the surface at lattice
resolution 1.0, a well, a source, a drain and a query, through the kernel
backend (`ShardSpec.gather=False`; on the CPU its plain versions) with
`cap_local` 896.

    python -m pbf_sph_tpu_torch.parallel.dryrun [n] [--devices cpu]

runs it on the card (`--devices cpu` or `device="cpu"`: on the CPU) and
prints the counters as one JSON line.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
from pbf_sph_tpu_torch.core.types import Drain, Query, Scene, Source, Well
from pbf_sph_tpu_torch.models.torch_solver import dyn_params_of, scene_arrays_of
from pbf_sph_tpu_torch.parallel import sharded
from pbf_sph_tpu_torch.parallel.comm import require_device, run_ranks

# seconds a rank waits at a barrier for the others
TIMEOUT = 600.0


def dryrun_scene() -> Scene:
    """The JAX dry run's scene objects (`__graft_entry__.py:113-121`)."""
    return Scene(
        wells=[Well(tag=0, centre=(300.0, 150.0, 300.0), force=100.0)],
        sources=[Source(tag=9, centre=(500, 400, 500), velocity=(0, 1, 0),
                        colour=(1, 0, 0, 1), rate=4)],
        drains=[Drain(tag=0, centre=(150.0, 30.0, 150.0), width=30.0)],
        queries=[Query(id=1, point=(250.0, 40.0, 250.0))],
    )


def dryrun_multichip(n: int, device=None) -> Dict[str, int]:
    """One full sharded frame over `n` ranks on `device` (the card unless
    the caller asks for the CPU).  Checks what the JAX dry run asserts (a
    mesh, 0 < alive <= particles + spawned) and returns the frame's
    counters: each per-rank stat summed over the ranks, `particles` (the
    count distributed), `spawned`, `query_count`, `gathered` (the alive
    particles gathered from the ranks' states) and `launches` (the kernel
    launches of all ranks)."""
    device = require_device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    mc, cfg, particles = simple_config_with_2_cubes(800, 2, 500.0)
    cfg = cfg.replace(surface=dataclasses.replace(mc, resolution=1.0))
    scene = dryrun_scene()
    spec = sharded.ShardSpec.create(cfg, n, len(particles), cfg.h, scene=scene,
                                    gather=False, cap_local=896)
    whole = sharded.distribute_particles(particles, spec)

    def rank(comm):
        state = sharded.local_state(whole, comm.rank, spec, device)
        step = sharded.build_sharded_step(spec, comm)
        dyn = dyn_params_of(cfg, np.float32, device)
        scn = scene_arrays_of(scene, spec.scene, np.float32, device)
        state, stats = step(state, dyn, scn)
        return state, stats, step.launches

    ranks = run_ranks(n, rank, device, timeout=TIMEOUT)
    stats = sharded.assemble_stats([r[1] for r in ranks])
    out = {k: int(np.asarray(stats[k]).sum()) for k in sharded.PER_RANK_STATS}
    launches: Dict[str, int] = {}
    for r in ranks:
        for k, v in r[2].items():
            launches[k] = launches.get(k, 0) + v
    spawned = spec.scene.total_spawn - int(stats["spawn_dropped"][0])
    out.update(particles=len(particles), spawned=spawned,
               query_count=int(stats["query_counts"][0]),
               gathered=len(sharded.gather_soa([r[0] for r in ranks])),
               launches=launches)
    assert spawned >= 0
    assert out["tri_count"] > 0, out
    assert 0 < out["alive_count"] <= len(particles) + spawned, out
    return out


def main(argv=None) -> int:
    """`python -m pbf_sph_tpu_torch.parallel.dryrun [n] [--devices cpu]`:
    the counters as one JSON line."""
    import json
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--devices" in argv:
        i = argv.index("--devices")
        device = argv[i + 1]
        del argv[i:i + 2]
    print(json.dumps(dryrun_multichip(int(argv[0]) if argv else 4, device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
