"""The staged walk of the main path's λ/Δp: candidates in shared memory.

`csrc/cells_staged.cu` (`pbf_lambda_cells_staged`, `pbf_delta_cells_staged`)
computes what `ops/cells.py`'s kernels compute, on the same packs and with
the same arguments, but reads the candidates from shared memory: a CTA takes
`ROWS` consecutive sorted rows, cuts its member rows into at most `SUBRUNS`
runs where the cell id jumps by a column (nz) or more, and stages the runs'
segments: for each (dx, dy), the candidates of a run whose cells are c0..c1
are one contiguous segment of the sorted array, `[table[clip(c0 + off - 1)],
table[clip(c1 + off + 2)])`, and the segments laid end to end are the CTA's
union, staged `STAGE` candidates at a time.  Each row walks only its own
sub-ranges of the union (`run_ranges`).  A run may cross from one column
into the next: the union stays contiguous, and between the fluid of two
adjacent columns lie only a few empty padding cells; where the ids jump by a
column or more the segments would hold up to whole columns that none of its
rows needs, so a new run starts there.  The kernel cuts its runs itself (a
scan over the CTA's keys), so a frame makes no plan; `plan_runs` is the plain
version of that cut.

On the card this walk is slower than the direct one the solver runs
(`tools/bench_cells.py`, `PERF.md`), so nothing on the solver's path calls
it; `tools/bench_cells.py` and `chip_smoke.py` measure and hold it.

The plain versions (`lambda_staged_plain`, `delta_staged_plain`) are
`ops/cells.py`'s sums over this walk's candidate blocks: each row's
sub-ranges in union slots, clipped to the same pieces and mapped back to
sorted rows through the staged copy (`staged_rows`), so a fault in the plan
shows on the CPU.  `StagedCells` counts the kernels' launches and, as the
solver's wrappers, takes the plain versions only for CPU tensors.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, Tuple

import torch

from pbf_sph_tpu_torch.ops import cells, cuda_build
from pbf_sph_tpu_torch.ops.phases import CellIndex, neighbour_ranges

# as csrc/cells_staged.cu compiles them by default: rows of a CTA (one a
# thread), candidates staged at once and runs a CTA (kRows, kStage, kSub)
ROWS = 128
STAGE = 2048
SUBRUNS = 3
SEGMENTS = 9
SOURCE = cuda_build.SRC_DIR / "cells_staged.cu"


def source_sizes(src=SOURCE) -> Tuple[int, int, int]:
    """(rows, stage, runs) that the CUDA source compiles by default."""
    text = src.read_text()
    rows, stage = (int(re.search(rf"#define CELLS_STAGED_{k} (\d+)", text).group(1))
                   for k in ("ROWS", "STAGE"))
    return rows, stage, int(re.search(r"constexpr int kSub = (\d+);", text).group(1))


@dataclass(frozen=True)
class CellRuns:
    """The runs of a frame: CTA b holds the sorted rows [b * size, (b + 1) *
    size); row i is in run `sub[i]` of its CTA."""

    sub: torch.Tensor  # (C,) int64: the run of each row in its CTA (0 for non-members)
    seg: torch.Tensor  # (nctas, 27) int64: first sorted row of each segment, run-major
    start: torch.Tensor  # (nctas, 28) int64: each segment's first union slot; [:, -1] the length
    size: int = ROWS


def stencil_offsets(index: CellIndex, device) -> torch.Tensor:
    """(9,) linear-id offsets of the (dx, dy) columns, dx outer, dy inner."""
    _, ny, nz = index.grid.dims
    s = torch.arange(SEGMENTS, device=device)
    return (s // 3 - 1) * (ny * nz) + (s % 3 - 1) * nz


def plan_runs(index: CellIndex, size: int = ROWS) -> CellRuns:
    """The kernels' runs, from the frame's keys and cell table: what each
    CTA of `size` rows computes for itself."""
    key, table = index.key.long(), index.table.long()
    n, ncells, dev = key.shape[0], index.grid.ncells, key.device
    nz = index.grid.dims[2]
    nctas = -(-n // size)
    row = torch.arange(n, device=dev)
    cta = row // size
    member = key < ncells
    jump = member & (row % size > 0) & (key - torch.roll(key, 1) >= nz)
    jumps = torch.cumsum(jump, 0)
    sub = torch.where(member, torch.clamp(jumps - jumps[cta * size], max=SUBRUNS - 1), 0)
    runs = nctas * SUBRUNS
    run = (cta * SUBRUNS + sub)[member]
    c0 = torch.full((runs,), ncells, device=dev).scatter_reduce(0, run, key[member], "amin")
    c1 = torch.full((runs,), -1, device=dev).scatter_reduce(0, run, key[member], "amax")
    off = stencil_offsets(index, dev)
    lo = table[torch.clamp(c0[:, None] + off - 1, 0, ncells)]
    hi = table[torch.clamp(c1[:, None] + off + 2, 0, ncells)]
    length = torch.where(c1[:, None] >= 0, hi - lo, 0).reshape(nctas, -1)
    start = torch.nn.functional.pad(torch.cumsum(length, 1), (1, 0))
    return CellRuns(sub=sub, seg=lo.reshape(nctas, -1), start=start, size=size)


def run_ranges(index: CellIndex, runs: CellRuns) -> Tuple[torch.Tensor, torch.Tensor]:
    """(9, C) int64 [lo, hi) of each row's sub-ranges in its CTA's union
    slots, as the kernels compute them; empty for non-member rows."""
    lo, hi = neighbour_ranges(index)
    cta = torch.arange(lo.shape[1], device=lo.device) // runs.size
    col = runs.sub[:, None] * SEGMENTS + torch.arange(SEGMENTS, device=lo.device)
    shift = (runs.start[cta[:, None], col] - runs.seg[cta[:, None], col]).T
    return lo + shift, hi + shift


def staged_rows(runs: CellRuns) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the sorted row held in each union slot of every CTA, laid CTA after
    CTA; (nctas,) the first of each CTA's slots there)."""
    start, seg = runs.start, runs.seg
    length = start[:, -1]
    ends = torch.cumsum(length, 0)
    base = ends - length
    slot = torch.arange(int(ends[-1]) if len(ends) else 0, device=start.device)
    cta = torch.searchsorted(ends, slot, right=True)
    u = slot - base[cta]
    s = (u[:, None] >= start[cta, 1:]).sum(1)  # the segment: ends at or below u
    return seg[cta, s] + u - start[cta, s], base


def plan_stats(runs: CellRuns, stage: int = STAGE) -> dict:
    """CTAs, runs with members, CTAs at the cap of runs, the mean and
    largest union of the CTAs with members, and those staged in more than
    one piece of `stage` candidates (host reads; reports only)."""
    length = runs.start[:, -1]
    active = length > 0
    nruns = (runs.start[:, SEGMENTS::SEGMENTS] > runs.start[:, :-1:SEGMENTS]).sum(1)
    return dict(ctas=int(length.shape[0]), runs=int(nruns.sum()),
                ctas_at_cap=int((nruns == SUBRUNS).sum()),
                union_max=int(length.max()), union_mean=float(length[active].float().mean()),
                over_cap=int((length > stage).sum()))


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def staged_blocks(index: CellIndex, runs: CellRuns, rows_per_block: int = 1 << 16
                  ) -> Iterator[Tuple[slice, torch.Tensor, torch.Tensor]]:
    """Yield (rows, idx, valid) in the kernels' order: for every piece of
    STAGE union slots, every block of rows and each of the nine sub-ranges
    clipped to the piece, idx (R, L) the sorted rows of the staged slots,
    valid masking the padding (whose idx is 0)."""
    lo, hi = run_ranges(index, runs)
    staged, base = staged_rows(runs)
    n = lo.shape[1]
    row_base = base[torch.arange(n, device=lo.device) // runs.size]
    union_max = int(runs.start[:, -1].max()) if n else 0
    for p0 in range(0, union_max, STAGE):
        plo = torch.clamp(lo, p0, p0 + STAGE)
        phi = torch.clamp(hi, p0, p0 + STAGE)
        steps = torch.arange(int((phi - plo).max()), device=lo.device)
        for r0 in range(0, n, rows_per_block):
            rows = slice(r0, min(n, r0 + rows_per_block))
            for s in range(SEGMENTS):
                u = plo[s, rows, None] + steps
                valid = u < phi[s, rows, None]
                slot = torch.where(valid, row_base[rows, None] + u, 0)
                yield rows, torch.where(valid, staged[slot], 0), valid


def lambda_staged_plain(index: CellIndex, h: float, pack_a, fluid, pack_b) -> None:
    """What `pbf_lambda_cells_staged` writes: `cells.lambda_cells_plain`
    through the staged union."""
    cells.lambda_cells_from(staged_blocks(index, plan_runs(index)), h, pack_a, fluid, pack_b)


def delta_staged_plain(index: CellIndex, h: float, pack_b, fluid, scale, min_bound,
                       max_bound, pack_a) -> None:
    """What `pbf_delta_cells_staged` writes: `cells.delta_cells_plain`
    through the staged union."""
    cells.delta_cells_from(staged_blocks(index, plan_runs(index)), h, pack_b, fluid, scale,
                           min_bound, max_bound, pack_a)


# ---------------------------------------------------------------------------
# CUDA kernel launchers
# ---------------------------------------------------------------------------


def lambda_staged_kernel(index: CellIndex, h: float, pack_a, fluid, pack_b) -> None:
    """`pbf_lambda_cells_staged`, on `cells.lambda_cells_kernel`'s arguments."""
    cells._check_cells(index, pack_a, pack_b, fluid)
    with torch.cuda.device(pack_a.device):
        err = cuda_build.library().pbf_lambda_cells_staged(
            *cells.lambda_cells_args(index, h, pack_a, fluid, pack_b))
    cuda_build.check("pbf_lambda_cells_staged", err)


def delta_staged_kernel(index: CellIndex, h: float, pack_b, fluid, scale, min_bound,
                        max_bound, pack_a) -> None:
    """`pbf_delta_cells_staged`, on `cells.delta_cells_kernel`'s arguments."""
    cells._check_cells(index, pack_b, pack_a, fluid, scale=scale, min_bound=min_bound,
                       max_bound=max_bound)
    with torch.cuda.device(pack_b.device):
        err = cuda_build.library().pbf_delta_cells_staged(*cells.delta_cells_args(
            index, h, pack_b, fluid, scale, min_bound, max_bound, pack_a))
    cuda_build.check("pbf_delta_cells_staged", err)


class StagedCells:
    """The staged walk's wrappers: the kernels on CUDA tensors, counted in
    `launches` where each launches, and the plain versions on CPU tensors."""

    def __init__(self, h: float):
        self.h = float(h)
        self.launches = {"lambda_cells_staged": 0, "delta_cells_staged": 0}

    def lambda_cells(self, index: CellIndex, pack_a, fluid, pack_b) -> None:
        if pack_a.device.type == "cpu":
            lambda_staged_plain(index, self.h, pack_a, fluid, pack_b)
            return
        lambda_staged_kernel(index, self.h, pack_a, fluid, pack_b)
        self.launches["lambda_cells_staged"] += 1

    def delta_cells(self, index: CellIndex, pack_b, fluid, scale, min_bound, max_bound,
                    pack_a) -> None:
        if pack_b.device.type == "cpu":
            delta_staged_plain(index, self.h, pack_b, fluid, scale, min_bound, max_bound,
                               pack_a)
            return
        delta_staged_kernel(index, self.h, pack_b, fluid, scale, min_bound, max_bound, pack_a)
        self.launches["delta_cells_staged"] += 1
