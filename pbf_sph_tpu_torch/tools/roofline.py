"""The neighbour-phase roofline at dam1m's settled state.

Port of `tools/roofline.py`.  The JAX tool counts the 128-lane chunks of
the TPU window plan (`roofline.py:67-115`), which the port does not have:
rows 1b/2b (`csrc/pbf_cells.cu`) walk each member row's nine (dx, dy)
ranges [table[lin + off - 1], table[lin + off + 2]) of the cell table, the
27-cell stencil.  So the census here counts what they walk: the candidate
pairs of each row, exact integers.  From the state of `dam_break(count, 6)`
after 5 settling frames (`bench.warm_up`) and one more advect and sort, the
tool reports:

1. that census (rows, pairs, pairs a row: mean, p50, p95, max);
2. `true_neighbours` (`roofline.py:117`): the neighbours within h of 2048
   sampled member rows, counted against every member;
3. the achieved pair rate of rows 1b/2b: the census's pairs over their
   device time (`anchor_rate.held_ms`; on the CPU the plain versions on
   the host clock);
4. the census under (2,2,1) and (2,2,2) supercells of 2h, the same walk
   over the coarser cells (no kernel is built for them: the census alone
   decides);
5. the implied step floor: 6 λ and 6 Δp sweeps of the census's pairs at the
   measured rates, and of a perfect neighbour list (the true neighbours).
   The JAX tool's "9-window floor" (one 128-lane chunk a window) has no
   counterpart: the port's walk has no chunks.

    python -m pbf_sph_tpu_torch.tools.roofline [count] [reps] [--devices cpu]

JSON last.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.types import FLUID
from pbf_sph_tpu_torch.models.torch_solver import advect_and_sort
from pbf_sph_tpu_torch.ops import cells
from pbf_sph_tpu_torch.tools import anchor_rate as ar
from pbf_sph_tpu_torch.tools import study

SWEEPS = 12  # 6 iterations x (λ + Δp)
NSAMPLE = 2048


def row_pairs(key, table, dims) -> torch.Tensor:
    """(members,) int64: the candidate pairs rows 1b/2b walk for each member
    row of the cell-sorted `key` over `table` on a grid of `dims`."""
    _, ny, nz = dims
    ncells = int(np.prod(dims))
    key, table = key.long(), table.long()
    lin = key[key < ncells]
    pairs = torch.zeros_like(lin)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            base = lin + (ox * ny * nz + oy * nz)
            pairs += (table[torch.clamp(base + 2, 0, ncells)]
                      - table[torch.clamp(base - 1, 0, ncells)])
    return pairs


def summary(pairs: torch.Tensor) -> Dict[str, float]:
    p = pairs.double().cpu().numpy()
    if not len(p):
        return dict(rows=0, pairs=0, mean=0.0, p50=0.0, p95=0.0, max=0)
    return dict(rows=len(p), pairs=int(p.sum()), mean=float(p.mean()),
                p50=float(np.percentile(p, 50)), p95=float(np.percentile(p, 95)),
                max=int(p.max()))


def print_census(label: str, s: Dict[str, float]) -> None:
    print(f"  census[{label}]: rows={s['rows']}  pairs={s['pairs']}  pairs/row "
          f"mean={s['mean']:.1f} p50={s['p50']:.0f} p95={s['p95']:.0f} max={s['max']}")


def true_neighbours(pstar, member_count: int, h: float, nsample: int = NSAMPLE,
                    seed: int = 0) -> np.ndarray:
    """(nsample,) the members within h of each of `nsample` member rows drawn
    as the JAX tool draws them (the row itself included), fp32 distances."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(member_count, size=nsample, replace=False)
    P = pstar[:, :member_count]
    q = pstar[:, torch.as_tensor(idx, device=pstar.device)]
    cnt = torch.zeros(nsample, dtype=torch.int64, device=pstar.device)
    h2 = h * h
    B = 200_000
    for s0 in range(0, member_count, B):
        blk = P[:, s0:s0 + B]
        d = q[:, :, None] - blk[:, None, :]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        cnt += (d2 <= h2).sum(1)
    return cnt.cpu().numpy()


def supercell_index(pstar, alive, min_extent, h: float, dims, div: Tuple[int, int, int]):
    """(sorted keys, table, dims) of the cells coarsened by `div` on each
    axis, as the JAX tool builds them (`roofline.py:200-221`)."""
    dev = pstar.device
    hf = torch.tensor(h, dtype=torch.float32, device=dev)
    cc = [torch.trunc((pstar[a] - min_extent[a]) / hf).to(torch.int64) // div[a]
          for a in range(3)]
    sd = tuple(dims[a] // div[a] + 1 for a in range(3))
    ncells = int(np.prod(sd))
    in_box = torch.ones_like(alive)
    for c, n in zip(cc, sd):
        in_box &= (c >= 0) & (c < n)
    lin = (cc[0] * sd[1] + cc[1]) * sd[2] + cc[2]
    k2 = torch.where(alive & in_box, lin, ncells)
    k2 = torch.where(alive, k2, ncells + 1)
    k2s = torch.sort(k2, stable=True).values
    table = torch.searchsorted(k2s, torch.arange(ncells + 1, device=dev))
    return k2s, table, sd


def phase_ms(spec, dyn, fr, reps: int) -> Tuple[float, float]:
    """(λ ms, Δp ms) of rows 1b/2b at the frame: `held_ms` on the card, the
    plain versions' host clock on the CPU."""
    st, dev = fr.state, fr.pstar.device
    pack_a = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], st.mass], dim=1)
    pack_b = torch.empty_like(pack_a)
    out = pack_a.clone()
    fluid = (st.ptype == FLUID) & st.alive
    scale = torch.full((), spec.scale, dtype=torch.float32, device=dev)
    cuda = dev.type == "cuda"
    lam = cells.lambda_cells_kernel if cuda else cells.lambda_cells_plain
    dlt = cells.delta_cells_kernel if cuda else cells.delta_cells_plain
    runs = (lambda: lam(fr.index, spec.h, pack_a, fluid, pack_b),
            lambda: dlt(fr.index, spec.h, pack_b, fluid, scale, dyn["min_bound"],
                        dyn["max_bound"], out))
    runs[0]()
    if cuda:
        return tuple(ar.held_ms(r, reps) for r in runs)
    return tuple(study.timed(r, dev, reps)[2] for r in runs)


def floor_ms(pairs: float, rate_l: float, rate_d: float) -> float:
    """ms of SWEEPS/2 λ and SWEEPS/2 Δp sweeps of `pairs` at the rates."""
    return (SWEEPS / 2 * pairs / rate_l + SWEEPS / 2 * pairs / rate_d) * 1e3


def settled_frame(count: int, device):
    """(spec, dyn, sort-time frame) of dam_break(count, 6) after 5 frames."""
    _, spec, state, dyn, scn, _ = study.settled(dam_break(count, solver_iter=6), device)
    return spec, dyn, advect_and_sort(spec, state, dyn, scn)


def main(argv=None) -> int:
    device, argv = study.pop_device(sys.argv[1:] if argv is None else argv)
    count = int(argv[0]) if argv else 1_000_000
    reps = int(argv[1]) if len(argv) > 1 else 10
    card = study.card_line(device)
    print(card)
    spec, dyn, fr = settled_frame(count, device)
    idx, dims = fr.index, spec.grid.dims
    members = int(idx.table[-1])
    print(f"count={count} capacity={spec.capacity} members={members} grid={dims} ({device})")
    res = {"card": card, "count": count, "device": str(device), "reps": reps,
           "members": members, "grid": list(dims), "census": {}}

    base = summary(row_pairs(idx.key, idx.table, dims))
    print_census("production (h,h,h)", base)
    res["census"]["production (h,h,h)"] = base

    t_l, t_d = phase_ms(spec, dyn, fr, reps)
    rate_l, rate_d = base["pairs"] / (t_l * 1e-3), base["pairs"] / (t_d * 1e-3)
    clock = "device (held_ms)" if device.type == "cuda" else "host clock, plain versions"
    print(f"  rows 1b/2b: lambda {t_l:.4f} ms, delta {t_d:.4f} ms ({clock}); achieved pair "
          f"rate: lambda {rate_l / 1e9:.2f} G/s, delta {rate_d / 1e9:.2f} G/s")
    res.update(lambda_ms=t_l, delta_ms=t_d, clock=clock, rate_lambda=rate_l, rate_delta=rate_d)

    nsample = min(NSAMPLE, members)
    cnt = true_neighbours(fr.pstar, members, spec.h, nsample)
    print(f"  true neighbours (r<=h, {nsample} rows): mean={cnt.mean():.1f} "
          f"p50={np.percentile(cnt, 50):.0f} p95={np.percentile(cnt, 95):.0f} max={cnt.max()}")
    res["true_neighbours"] = dict(nsample=nsample, mean=float(cnt.mean()),
                                  p50=float(np.percentile(cnt, 50)),
                                  p95=float(np.percentile(cnt, 95)), max=int(cnt.max()))

    for div, tag in (((2, 2, 1), "supercell (2h,2h,h)"), ((2, 2, 2), "supercell (2h,2h,2h)")):
        k2s, table, sd = supercell_index(fr.pstar, fr.state.alive, fr.min_extent, spec.h,
                                         dims, div)
        s = summary(row_pairs(k2s, table, sd))
        print_census(tag, s)
        res["census"][tag] = s

    now = floor_ms(base["pairs"], rate_l, rate_d)
    perfect = floor_ms(cnt.mean() * members, rate_l, rate_d)
    print("\nstep floor at the measured rates (60 steps/s at 1M -> 16.7 ms/step):")
    print(f"  the cells walk: {SWEEPS} sweeps x {base['pairs'] / 1e9:.4f} G pairs -> "
          f"{now:.3f} ms solve")
    print(f"  a perfect neighbour list: {cnt.mean():.1f} pairs/row -> {perfect:.3f} ms solve")
    res.update(floor_ms=now, perfect_list_floor_ms=perfect)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
