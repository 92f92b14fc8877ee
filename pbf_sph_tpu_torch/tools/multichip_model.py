"""A model of the slab and tile engines across cards: the exchange census,
the per-slab census and a projection.

Port of `tools/multichip_model.py`, in three parts.

1. Exchange census, the counterpart of the JAX tool's census of the
   collectives in the compiled HLO (`multichip_model.py:89-200`).  A counting
   wrapper around each `ThreadComm` rank (`parallel/comm.py`) records every
   exchange and all-reduce the engines make, with its bytes, over one frame
   of `ShardedStep` at D = 4 (fixed slabs) and of `Sharded2DStep` at 2x2
   (rebalancing), both on the 2-cube scene at 2,000 particles, 6
   iterations, no surface.  The byte model (`slab_bytes`, `exchange_bytes`;
   the JAX tool's `ici_bytes`, `:203-221`) is written for the port's
   buffers and checked against the count.  An exchange carries both
   directions and every field in one call, where JAX permutes field by field
   and direction by direction; the port refreshes pStar in one (3, n)
   exchange where JAX goes axis by axis, with the same bytes.
2. Per-slab census: `tools/roofline.py`'s census (the candidate pairs rows
   1b/2b walk) on the settled state of `dam_break(count, 6)` (default 1M),
   split into N equal-count x-slabs with one ghost column each side, at N
   in {1, 2, 4, ..., 64} where N slabs of >= 3 columns fit the grid, and
   at the most that fit; and on (x, y) tiles of the tensor-product cuts
   (static and with the rebalance width caps) and of recursive cuts.
3. Projection (`:280-430`): step(N) = the busiest slab's 6 λ and 6 Δp
   sweeps at the rates measured here on the card (rows 1b/2b, `held_ms`) +
   the rest of the measured single-card step scaled by 1/N + the bytes a
   link carries over its bandwidth + the exchanges of part 1 times the
   link's latency.  The link bandwidth (`--link-bw`, bytes/s) and latency
   (`--link-lat`, s) are stated, not measured: the card's machine has one
   card.  They have no default, and without them the projection's time
   columns are left out; parts 1-2 run without them.

    python -m pbf_sph_tpu_torch.tools.multichip_model [count] [--census-only]
        [--link-bw B/s --link-lat s] [--slosh F] [--census N I] [--devices cpu]

`--census N I` runs part 1 at N particles and I iterations (default 2000
and 6, the JAX tool's), which the CPU test shrinks.

JSON last.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.scene import apply_motion_sin_x_cos_z, simple_config_with_2_cubes
from pbf_sph_tpu_torch.models.torch_solver import advect_and_sort, dyn_params_of
from pbf_sph_tpu_torch.ops.grid import cell_coords
from pbf_sph_tpu_torch.parallel import sharded, sharded2d
from pbf_sph_tpu_torch.parallel.comm import run_ranks
from pbf_sph_tpu_torch.tools import roofline, study

SWEEPS = 12  # 6 iterations x (λ + Δp)
# bytes a slot of each exchange (`parallel/sharded.py`): a migrant's 13
# 4-byte fields (pid, ptype, mass, position, velocity, colour) and `valid`;
# a ghost's 12 (pStar, position, mass, ptype, colour) and `valid`; a
# refreshed ghost's λ and pStar
MIGRANT_BYTES = 13 * 4 + 1
GHOST_BYTES = 12 * 4 + 1
REFRESH_BYTES = (1 + 3) * 4
N_LIST = (1, 2, 4, 8, 16, 32, 64)
TILES = ((4, 2), (4, 4), (8, 4), (8, 8), (16, 8))


# ---------------------------------------------------------------------------
# 1. exchange census
# ---------------------------------------------------------------------------


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class CountingComm:
    """A communicator that records each call of the one it wraps: ("exchange",
    bytes of both directions) and ("all_reduce", bytes)."""

    def __init__(self, comm):
        self.comm = comm
        self.rank, self.size = comm.rank, comm.size
        self.log: List[Tuple[str, int]] = []

    def exchange_peers(self, lo, hi, to_lo, to_hi):
        self.log.append(("exchange", _nbytes(to_lo.values()) + _nbytes(to_hi.values())))
        return self.comm.exchange_peers(lo, hi, to_lo, to_hi)

    def exchange(self, to_left, to_right):
        self.log.append(("exchange",
                         _nbytes(to_left.values()) + _nbytes(to_right.values())))
        return self.comm.exchange(to_left, to_right)

    def all_reduce_sum(self, t):
        self.log.append(("all_reduce", _nbytes([t])))
        return self.comm.all_reduce_sum(t)


def slab_bytes(migrate_cap: int, ghost_cap: int, iteration: int) -> int:
    """One direction's bytes a frame of a slab boundary: the migrants, the
    ghosts and each iteration's λ and pStar refresh."""
    return (migrate_cap * MIGRANT_BYTES + ghost_cap * GHOST_BYTES
            + iteration * REFRESH_BYTES * ghost_cap)


def exchange_bytes(spec) -> int:
    """Both directions' bytes a frame a rank sends through its exchanges:
    one slab boundary of a `ShardSpec`, or the x and the y boundary of a
    `Shard2DSpec` (a migration, a ghost pass and the refreshes along each
    axis)."""
    if isinstance(spec, sharded.ShardSpec):
        return 2 * slab_bytes(spec.migrate_cap, spec.ghost_cap, spec.iteration)
    return 2 * (slab_bytes(spec.migrate_cap, spec.ghost_x, spec.iteration)
                + slab_bytes(spec.migrate_cap, spec.ghost_y, spec.iteration))


def exchanges_a_frame(spec) -> int:
    """The exchanges of a frame: a migration, a ghost pass and 2 refreshes
    an iteration, along each axis."""
    axes = 1 if isinstance(spec, sharded.ShardSpec) else 2
    return axes * (2 + 2 * spec.iteration)


def census_run(spec, cfg, xs, device, two_d: bool) -> List[List[Tuple[str, int]]]:
    """Each rank's log of one frame of the engine under `spec`."""
    cfg_dyn = dyn_params_of(cfg, np.float32, device)
    if two_d:
        whole = sharded2d.distribute_particles_2d(xs, spec)
    else:
        whole = sharded.distribute_particles(xs, spec)

    def rank(comm):
        counted = CountingComm(comm)
        state = sharded.local_state(whole, comm.rank, spec, device)
        if two_d:
            step = sharded2d.build_sharded2d_step(spec, counted)
            step(state, cfg_dyn, bounds=spec.initial_bounds())
        else:
            step = sharded.build_sharded_step(spec, counted)
            step(state, cfg_dyn)
        return counted.log

    n = spec.n_dev if not two_d else spec.nx * spec.ny
    return run_ranks(n, rank, device)


def exchange_census(device, count: int = 2000, iteration: int = 6) -> Dict[str, dict]:
    """Part 1: the slab engine at D = 4 (fixed) and the tile engine at 2x2
    (rebalancing), one frame each; {engine: counts, bytes and the model}."""
    _, cfg, xs = simple_config_with_2_cubes(count, iteration, 500.0)
    cfg = cfg.replace(surface=None)
    specs = {
        "slabs D=4 (fixed)": (sharded.ShardSpec.create(cfg, 4, len(xs), cfg.h), False),
        "tiles 2x2 (rebalancing)": (sharded2d.Shard2DSpec.create(
            cfg, 2, 2, xs, cfg.h, rebalance=True), True),
    }
    out = {}
    for name, (spec, two_d) in specs.items():
        logs = census_run(spec, cfg, xs, device, two_d)
        if any(log != logs[0] for log in logs):
            raise RuntimeError(f"{name}: the ranks' exchanges differ")
        log = logs[0]
        ex = [b for k, b in log if k == "exchange"]
        ar = [b for k, b in log if k == "all_reduce"]
        out[name] = dict(
            exchanges=len(ex), exchange_bytes=sum(ex), all_reduces=len(ar),
            all_reduce_bytes=sum(ar), model_exchanges=exchanges_a_frame(spec),
            model_bytes=exchange_bytes(spec), migrate_cap=spec.migrate_cap,
            ghost=[spec.ghost_cap] if not two_d else [spec.ghost_x, spec.ghost_y])
    return out


def print_census(census: Dict[str, dict], count: int, iteration: int) -> None:
    for name, c in census.items():
        print(f"exchange census ({name}; count={count}, {iteration} iterations, no "
              "surface), a rank a frame:")
        print(f"  exchanges                 : {c['exchanges']} (model {c['model_exchanges']})")
        print(f"  exchange bytes (both dirs): {c['exchange_bytes']} (model "
              f"{c['model_bytes']}; migrate_cap={c['migrate_cap']}, ghost={c['ghost']})")
        print(f"  all-reduces               : {c['all_reduces']}, {c['all_reduce_bytes']} bytes")


# ---------------------------------------------------------------------------
# 2-3. per-slab census and projection
# ---------------------------------------------------------------------------


def local_pairs(cx, cy, cz, x0: int, x1: int, y0: int, y1: int, gz: int,
                y_ghosts: bool = True) -> int:
    """The census's pairs of the tile of columns [x0, x1) and rows [y0, y1)
    with one ghost layer on each side (along x only when not `y_ghosts`: a
    slab), on its local grid."""
    gy = int(y_ghosts)
    m = (cx >= x0 - 1) & (cx < x1 + 1) & (cy >= y0 - gy) & (cy < y1 + gy)
    wx, wy = x1 - x0 + 2, y1 - y0 + 2 * gy
    lin = ((cx[m] - x0 + 1).astype(np.int64) * wy + (cy[m] - y0 + gy)) * gz + cz[m]
    lin = np.sort(lin, kind="stable")
    table = np.searchsorted(lin, np.arange(wx * wy * gz + 1))
    return int(roofline.row_pairs(torch.from_numpy(lin), torch.from_numpy(table),
                                  (wx, wy, gz)).sum())


def slab_bounds(cx, gx: int, n: int) -> List[int]:
    """Equal-count x-slab boundaries, widths >= 3 (the JAX tool's)."""
    hist = np.bincount(np.clip(cx, 0, gx - 1), minlength=gx)
    cdf = np.cumsum(hist)
    total = int(cdf[-1])
    b = [0]
    for d in range(1, n):
        v = int(np.searchsorted(cdf, total * d / n, side="left")) + 1
        b.append(min(max(v, b[-1] + 3), gx - 3 * (n - d)))
    b.append(gx)
    return b


def step_model(mx_pairs: float, n: int, count: int, rates, t_local_1m: float,
               per_dir: float, link_bw: Optional[float], link_lat: Optional[float],
               ncoll: int) -> Tuple[float, ...]:
    """(step, solve, local, comm, latency) seconds of N cards: the busiest
    part's sweeps at the rates, the measured rest scaled by 1/N, a link's
    bytes over its bandwidth and the exchanges times its latency (0 at N = 1;
    NaN when the link is not stated)."""
    t_solve = SWEEPS / 2 * mx_pairs / rates[0] + SWEEPS / 2 * mx_pairs / rates[1]
    t_local = t_local_1m * (count / 1e6) / n
    nan = float("nan")
    t_comm = (per_dir / link_bw if link_bw else nan) if n > 1 else 0.0
    t_lat = (ncoll * link_lat if link_lat else nan) if n > 1 else 0.0
    return t_solve + t_local + t_comm + t_lat, t_solve, t_local, t_comm, t_lat


def project(cx, cy, cz, gdims, count: int, rates, t_local_1m: float, per_dir_of,
            link_bw=None, link_lat=None, ncoll: int = 0) -> Dict[int, tuple]:
    """Parts 2-3 for x-slabs: {N: (step, solve, local, comm, latency, max
    slab pairs, imbalance)} seconds, `per_dir_of(N)` a link's bytes a frame
    in one direction; prints the table."""
    gx, gy, gz = gdims
    print(f"\nper-slab census on the settled {count} state (grid {gdims}), equal-count "
          "x-slabs + 1 ghost column each side:")
    print(f"{'N':>4} {'max-slab pairs':>15} {'imbal':>6} {'solve':>9} {'local':>8} "
          f"{'comm':>8} {'lat':>8} {'step':>9} {'steps/s':>8}")
    n_list = [n for n in N_LIST if 3 * n <= gx]
    if gx // 3 not in n_list:
        n_list.append(gx // 3)
    out = {}
    for n in n_list:
        b = slab_bounds(cx, gx, n)
        pairs = [local_pairs(cx, cy, cz, b[d], b[d + 1], 0, gy, gz, y_ghosts=False)
                 for d in range(n)]
        mx = max(pairs)
        imbal = mx / (sum(pairs) / n)
        t = step_model(mx, n, count, rates, t_local_1m, per_dir_of(n), link_bw, link_lat,
                       ncoll)
        out[n] = t + (mx, imbal)
        print(f"{n:>4} {mx / 1e9:>14.4f}G {imbal:>6.2f} {t[1] * 1e3:>7.3f}ms "
              f"{t[2] * 1e3:>6.3f}ms {t[3] * 1e3:>6.3f}ms {t[4] * 1e3:>6.3f}ms "
              f"{t[0] * 1e3:>7.3f}ms {1 / t[0]:>8.1f}")
    return out


def tile_pairs(cx, cy, cz, gz: int, xb, yb) -> List[int]:
    return [local_pairs(cx, cy, cz, xb[i], xb[i + 1], yb[j], yb[j + 1], gz)
            for i in range(len(xb) - 1) for j in range(len(yb) - 1)]


def project_2d(cx, cy, cz, gdims, count: int, rates, t_local_1m: float, per_dir_of,
               link_bw=None, link_lat=None, ncoll_2d: int = 0) -> Dict[str, dict]:
    """The (x, y)-tile census and projection for the tensor-product cuts
    (static, and with the rebalance width caps: what `parallel/sharded2d.py`
    runs) and recursive cuts (per-x-band y-cuts, a bound the engine does
    not run).  A tile's link carries two slab boundaries' bytes."""
    gx, gy, gz = gdims
    out = {}
    for mode in ("tensor-product, static cuts", "tensor-product + rebalance width caps",
                 "recursive (bound)"):
        capped = "caps" in mode
        print(f"\n2D (x,y)-tile projection - {mode}:")
        print(f"{'NxxNy':>7} {'max-tile pairs':>15} {'imbal':>6} {'solve':>9} "
              f"{'step':>9} {'steps/s':>8}")
        out[mode] = {}
        for nx, ny in TILES:
            n = nx * ny
            if nx * 3 > gx or ny * 3 > gy:
                continue
            cap_x = sharded2d._axis_cap(gx, nx, 3) if capped else None
            xb = sharded2d._equal_count_cuts(cx, 0, gx, nx, 3, cap_x)
            if mode.startswith("tensor"):
                cap_y = sharded2d._axis_cap(gy, ny, 3) if capped else None
                pairs = tile_pairs(cx, cy, cz, gz, xb, sharded2d._equal_count_cuts(
                    cy, 0, gy, ny, 3, cap_y))
            else:
                pairs = []
                for i in range(nx):
                    band = (cx >= xb[i]) & (cx < xb[i + 1])
                    yb = sharded2d._equal_count_cuts(cy[band], 0, gy, ny, 3)
                    pairs += tile_pairs(cx, cy, cz, gz, xb[i:i + 2], yb)
            mx = max(pairs)
            imbal = mx / (sum(pairs) / n)
            t = step_model(mx, n, count, rates, t_local_1m, 2 * per_dir_of(n), link_bw,
                           link_lat, ncoll_2d)
            out[mode][f"{nx}x{ny}"] = t + (mx, imbal)
            print(f"{nx:>3}x{ny:<3} {mx / 1e9:>14.4f}G {imbal:>6.2f} {t[1] * 1e3:>7.3f}ms "
                  f"{t[0] * 1e3:>7.3f}ms {1 / t[0]:>8.1f}")
    return out


def settled_cells(count: int, device, slosh_frames: int = 0):
    """(cx, cy, cz int64 numpy of the alive rows' pStar cells, grid dims,
    config, rates (λ, Δp pairs/s), rest of the step in s scaled to 1M) of
    dam_break(count, 6) after 5 settling frames and `slosh_frames` frames of
    the sloshing motion; the rates and the step from this state."""
    solver, spec, state, dyn, scn, cfg = study.settled(dam_break(count, solver_iter=6),
                                                        device)
    for f in range(slosh_frames):
        dyn = dyn_params_of(apply_motion_sin_x_cos_z(cfg, f), solver.dtype, solver.device)
        state, _ = solver.step_device(spec, state, dyn, scn)
    fr = advect_and_sort(spec, state, dyn, scn)
    pairs = int(roofline.row_pairs(fr.index.key, fr.index.table, spec.grid.dims).sum())
    t_l, t_d = roofline.phase_ms(spec, dyn, fr, 10)
    st = [state]

    def frame():
        st[0], o = solver.step_device(spec, st[0], dyn, scn)
        return o

    _, dev_ms, host_ms = study.timed(frame, device, 5)
    step_ms = dev_ms if dev_ms is not None else host_ms
    t_local = max(step_ms - spec.iteration * (t_l + t_d), 0.0) * 1e-3 * 1e6 / count
    cells = cell_coords(fr.pstar, fr.min_extent, spec.h)
    alive = fr.state.alive
    cx, cy, cz = (c[alive].cpu().numpy().astype(np.int64) for c in cells)
    rates = (pairs / (t_l * 1e-3), pairs / (t_d * 1e-3))
    return cx, cy, cz, spec.grid.dims, cfg, rates, t_local, step_ms


def _flag(argv: List[str], name: str) -> Optional[str]:
    if name not in argv:
        return None
    i = argv.index(name)
    val = argv[i + 1]
    del argv[i:i + 2]
    return val


def main(argv=None) -> int:
    device, argv = study.pop_device(sys.argv[1:] if argv is None else argv)
    census_only = "--census-only" in argv
    argv = [a for a in argv if a != "--census-only"]
    bw, lat = _flag(argv, "--link-bw"), _flag(argv, "--link-lat")
    slosh = int(_flag(argv, "--slosh") or 0)
    ccount, citer = 2000, 6
    if "--census" in argv:
        i = argv.index("--census")
        ccount, citer = int(argv[i + 1]), int(argv[i + 2])
        del argv[i:i + 3]
    link_bw = float(bw) if bw else None
    link_lat = float(lat) if lat else None
    count = int(argv[0]) if argv else 1_000_000
    card = study.card_line(device)
    print(card)
    print("== 1. exchange census (ThreadComm ranks on one device) ==")
    census = exchange_census(device, ccount, citer)
    print_census(census, ccount, citer)
    res = {"card": card, "device": str(device), "census": census}
    if not census_only:
        print(f"\n== 2. settled-state census ({slosh} slosh frames) and projection ==")
        if link_bw is None or link_lat is None:
            print("link bandwidth and latency not given (--link-bw, --link-lat): the comm "
                  "and latency columns are NaN")
        else:
            print(f"link bandwidth {link_bw:.4g} B/s and latency {link_lat:.4g} s: stated, "
                  "not measured")
        cx, cy, cz, gdims, cfg, rates, t_local, step_ms = settled_cells(count, device, slosh)
        clock = "device" if device.type == "cuda" else "host clock"
        print(f"measured ({clock}): rows 1b/2b {rates[0] / 1e9:.2f} / {rates[1] / 1e9:.2f} G "
              f"pairs/s, step {step_ms:.3f} ms, the rest of the step {t_local * 1e3:.3f} ms "
              "at 1M")
        n1 = census["slabs D=4 (fixed)"]["exchanges"]
        n2 = census["tiles 2x2 (rebalancing)"]["exchanges"]

        def per_dir_of(n):
            """A slab boundary's bytes in one direction under the slab engine's
            rebalancing sizing of n ranks (at most the slabs the grid holds)."""
            spec = sharded.ShardSpec.create(cfg, min(n, gdims[0] // 3), len(cx), cfg.h,
                                            rebalance=True, gather=False)
            return slab_bytes(spec.migrate_cap, spec.ghost_cap, spec.iteration)

        slabs = project(cx, cy, cz, gdims, len(cx), rates, t_local, per_dir_of, link_bw,
                        link_lat, n1)
        tiles = project_2d(cx, cy, cz, gdims, len(cx), rates, t_local, per_dir_of, link_bw,
                           link_lat, n2)
        res.update(count=len(cx), grid=list(gdims), rates=list(rates), step_ms=step_ms,
                   rest_ms_1m=t_local * 1e3, link_bw=link_bw, link_lat=link_lat,
                   slabs={str(k): list(v) for k, v in slabs.items()},
                   tiles={m: {k: list(v) for k, v in d.items()} for m, d in tiles.items()})
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
