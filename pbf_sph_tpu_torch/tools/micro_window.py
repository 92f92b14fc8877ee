"""Split the per-row λ kernel's time by how a row finds its candidates.

    python -m pbf_sph_tpu_torch.tools.micro_window [reps]

Port of `tools/micro_window.py`.  The rate anchor (`anchor_rate`) leaves
~0.05 ms of `pbf_lambda` at dam1m unattributed: rows x fixed cost + pairs /
body ceiling falls short of the kernel.  This tool holds the λ pair terms
and the epilogue fixed and varies only how a kernel finds its candidates,
with the hand-written kernels of `csrc/micro_window.cu` (fourteen bodies):

* `window_prod` (`build_prod_structure`): nine windows from a flat lo/hi
  table `[t*18 + 2s + {lo, hi}]`, chunk 0 unconditional at min(c0*W, smax)
  (an empty window reads the sentinel chunk at smax), then a loop over the
  rest; three split loads a candidate, as the JAX tool, or one float4
  (`prod_fused`, as `pbf_lambda` loads its candidates);
* `window_guarded` (`build_guarded`): the same without the unconditional
  chunk, split or fused (`guarded_fused`);
* `window_flat` (`build_flat`): one loop over a per-sub-block list
  `[t*stride] = count`, then the chunk offsets; split loads from the (4,
  ncols) strip, or fused: one float4 from an (ncols, 4) pack;
* `window_static` (`build_static_fused`): nwin windows of nper chunks at the
  computed offsets ((s*7 + t) % 40) * nper * W, fused loads (the JAX tool's
  scenario: nwin 10, nper 1);
* `window_prod_blocked`, `window_guarded_blocked`, `window_flat_blocked`
  and `window_static_blocked` (rows 7.1-b to 7.4-b): the four rungs
  redesigned for this card in one blocked kernel, each bit for bit its
  original: a warp on one sub-block, BLOCKED_ROWS rows a thread, the chunks
  of the CTA's sub-block (its windows, its flat list or its computed
  offsets) staged once in shared memory, split from the strip or fused from
  the pack (`prod_blocked`, `prod_blocked_fused`, `guarded_blocked`,
  `guarded_blocked_fused`, `flat_blocked`, `flat_blocked_fused`;
  `static_blocked` fused).

Each computes λ (1, 1024) of 16 sub-blocks of 64 rows; the kernel runs
nblocks x 1024 threads, thread i taking row i mod 1024, and returns the
first block.  The chunk width W is 128 (the JAX tool's) or 1, where the
prod loop is `pbf_lambda`'s own `for j in [lo, hi)` and the flat list a
per-row candidate list.  Each kernel has a plain PyTorch version of the same
signature, which sums as Pallas does (a (64, W) carry, chunk by chunk, then
the lane sum); `MicroWindow` holds the wrappers, which take the plain
version for a CPU tensor and the kernel for a CUDA one, and count launches.

The tool prints the card line; checks the SASS of every instantiation
(cuobjdump: one MUFU.RSQ a pair, `pbf_lambda`'s fp32 instructions a pair
opcode by opcode, and the candidate bytes loaded a pair: 12 split, 16
fused, 4 more for the flat list's offset at W = 1; the blocked kernels
BLOCKED_ROWS pairs a LDS.128, no global load in the pair loop and no local
memory), and fails with no rate if one is short; holds each kernel against
its plain version, and each blocked kernel against its original bit for
bit on every block; then reads

* scenario A, the JAX tool's (W 128, its tables, rows 0.05, strip 0.055,
  smax 8448): the marginal between nblocks 256 and 1024, in ns a chunk, G
  pair-slots/s and ns a sub-block, prod counting its 4 sentinel chunks;
* scenario B, the dam1m census: at the settled dam1m state, k (the mean
  non-empty ranges of a member row) and the pairs a member row; at W 1 each
  sub-block gets round(k) windows of round(pairs/members/k) candidates, the
  rest empty at smax; each variant's ns a member row x the members, beside
  `pbf_lambda` on a prebuilt (C, 4) pack and the λ body ceiling's anchored
  ms, read in the same run: the ladder anchored -> static -> flat-fused ->
  flat -> guarded -> prod -> pbf_lambda, and the fused one anchored ->
  static -> guarded-fused -> pbf_lambda, which follows `pbf_lambda`'s own
  loads; the blocked one anchored -> guarded-blocked-fused ->
  guarded-fused -> pbf_lambda: what is left of the nine-window walk when
  it is laid out for this card; and the blocked JAX-order one anchored ->
  static-blocked -> flat-blocked-fused -> flat-blocked -> guarded-blocked
  -> prod-blocked -> pbf_lambda: the JAX tool's ladder with every rung in
  this card's layout.

with the SM clock sampled beside.  The last line is one JSON object.
Without a CUDA device the tool fails.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, replace
from typing import Dict, List, Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.tools import anchor_rate as ar

SUB = 64            # rows of a sub-block
WCOL = 128          # the JAX tool's chunk width
NSUB = 16           # sub-blocks of a block
ROWS = NSUB * SUB   # rows of a block: the (1, 1024) output
H = 0.1             # the JAX tool's smoothing length
SMAX = 8448         # the sentinel column: production smax at the 1M grid (88^3)
NWIN = 9            # windows of a sub-block
WIN_STRIDE = 2 * NWIN
SPAN = 40           # the period of the static offsets, in windows
REAL_WINS = 5       # the JAX tool's scenario: 5 windows of 2 chunks, 4 empty
CH_PER_WIN = 2
CHUNKS_CENSUS = REAL_WINS * CH_PER_WIN + (NWIN - REAL_WINS)  # 14
MAXC = 16           # the flat list's capacity a sub-block
ROW_VALUE, STRIP_VALUE = 0.05, 0.055  # the JAX tool's inputs
WIDTHS = (WCOL, 1)
# the JAX tool's five bodies, then prod and guarded with pbf_lambda's fused
# loads, which the JAX tool has not
JAX_BODIES = ("prod", "guarded", "flat", "flat_fused", "static")
BODIES = JAX_BODIES + ("prod_fused", "guarded_fused")
# the four rungs redesigned in one blocked kernel (rows 7.1-b to 7.4-b):
# prod, guarded and flat split and fused, static fused
BLOCKED_BODIES = ("prod_blocked", "guarded_blocked", "prod_blocked_fused",
                  "guarded_blocked_fused", "flat_blocked", "flat_blocked_fused",
                  "static_blocked")
ALL_BODIES = BODIES + BLOCKED_BODIES
# the original body of each blocked one: the kernel it equals bit for bit
BLOCKED_OF = {body: body.replace("_blocked", "") for body in BLOCKED_BODIES}
# the bodies that walk the nine windows of the lo/hi table, that read the
# flat list, and that compute their offsets
WINDOW_BODIES = ("prod", "guarded", "prod_fused", "guarded_fused", "prod_blocked",
                 "guarded_blocked", "prod_blocked_fused", "guarded_blocked_fused")
FLAT_BODIES = ("flat", "flat_fused", "flat_blocked", "flat_blocked_fused")
STATIC_BODIES = ("static", "static_blocked")
FUSED = ("flat_fused", "static", "prod_fused", "guarded_fused", "prod_blocked_fused",
         "guarded_blocked_fused", "flat_blocked_fused", "static_blocked")
KERNEL_OF = {"prod": "window_prod", "prod_fused": "window_prod",
             "guarded": "window_guarded", "guarded_fused": "window_guarded",
             "flat": "window_flat", "flat_fused": "window_flat", "static": "window_static",
             "prod_blocked": "window_prod_blocked", "prod_blocked_fused": "window_prod_blocked",
             "guarded_blocked": "window_guarded_blocked",
             "guarded_blocked_fused": "window_guarded_blocked",
             "flat_blocked": "window_flat_blocked", "flat_blocked_fused": "window_flat_blocked",
             "static_blocked": "window_static_blocked"}
KERNELS = ("window_prod", "window_guarded", "window_flat", "window_static",
           "window_prod_blocked", "window_guarded_blocked", "window_flat_blocked",
           "window_static_blocked")
# the blocked kernels' R, rows a thread (csrc/micro_window.cu's kBlockedRows),
# and their stage buffer in float4 slots (kStage): 6 chunks at W 128
BLOCKED_ROWS = 4
BLOCKED_STAGE = 768
# `parity_cases`' long tables, each several stage rounds of the blocked
# kernel: the window span in columns, the flat list's capacity in chunks and
# the static (nwin, nper)
LONG_SPAN = {WCOL: 16 * WCOL, 1: 400}
LONG_FLAT = {WCOL: 20, 1: 1600}
LONG_STATIC = {WCOL: (16, 1), 1: (9, 180)}
TOOL_BLOCKS = (256, 1024)     # the JAX tool's marginal
CENSUS_BLOCKS = (2048, 8192)  # scenario B: a few hundred pairs a row
PARITY_CENSUS = (7, 19)       # (k, m) of the uniform W = 1 parity case
RTOL, ATOL = 5e-4, 1e-12      # kernel against plain (see card_parity)


# ---------------------------------------------------------------------------
# Tables and inputs
# ---------------------------------------------------------------------------


def make_wins_table() -> torch.Tensor:
    """The JAX tool's window table (1, 1, 17*18) int32: windows 0-4 of each
    sub-block at ((s*7 + t) % 40) * 128 with a ragged hi 2*128 - 13 on, the
    rest empty at SMAX (`tools/micro_window.py:122-135`)."""
    wins = np.zeros((1, 1, (NSUB + 1) * WIN_STRIDE), np.int32)
    for t in range(NSUB):
        for s in range(NWIN):
            if s < REAL_WINS:
                lo = (s * 7 + t) % SPAN * WCOL
                hi = lo + CH_PER_WIN * WCOL - 13
            else:
                lo = hi = SMAX
            wins[0, 0, t * WIN_STRIDE + 2 * s] = lo
            wins[0, 0, t * WIN_STRIDE + 2 * s + 1] = hi
    return torch.from_numpy(wins)


def make_flat_table() -> torch.Tensor:
    """The JAX tool's flat list (1, 1, 16*17) int32: [t*17] = count, then
    the chunk offsets of windows 0-4 (`tools/micro_window.py:240-252`)."""
    tbl = np.zeros((1, 1, NSUB * (MAXC + 1)), np.int32)
    for t in range(NSUB):
        offs = [(s * 7 + t) % SPAN * WCOL + k * WCOL
                for s in range(REAL_WINS) for k in range(CH_PER_WIN)]
        tbl[0, 0, t * (MAXC + 1)] = len(offs)
        tbl[0, 0, t * (MAXC + 1) + 1:t * (MAXC + 1) + 1 + len(offs)] = offs
    return torch.from_numpy(tbl)


def census_tables(k: int, m: int, width: int = 1, smax: int = SMAX
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(wins, flat list, its row stride) of scenario B: each sub-block gets
    k windows of m chunks, window s at ((s*7 + t) % 40) * m * width (the
    static kernel's offsets at nwin k, nper m), the other 9 - k empty at
    smax; the flat list holds the same chunks, k*m of them."""
    if not 0 <= k <= NWIN or m < 1 or SPAN * m * width > smax:
        raise ValueError(f"census: want 0 <= k <= {NWIN}, m >= 1 and {SPAN}*m*width <= "
                         f"smax, got k {k}, m {m}, width {width}, smax {smax}")
    stride = k * m + 1
    wins = np.full((1, 1, (NSUB + 1) * WIN_STRIDE), 0, np.int32)
    tbl = np.zeros((1, 1, NSUB * stride), np.int32)
    for t in range(NSUB):
        offs = []
        for s in range(NWIN):
            lo = hi = smax
            if s < k:
                lo = (s * 7 + t) % SPAN * m * width
                hi = lo + m * width
                offs += [lo + c * width for c in range(m)]
            wins[0, 0, t * WIN_STRIDE + 2 * s] = lo
            wins[0, 0, t * WIN_STRIDE + 2 * s + 1] = hi
        tbl[0, 0, t * stride] = len(offs)
        tbl[0, 0, t * stride + 1:(t + 1) * stride] = offs
    return torch.from_numpy(wins), torch.from_numpy(tbl), stride


@dataclass(frozen=True)
class Inputs:
    """What the five bodies read: rows (5, 1024) x, y, z, mass, memberf;
    strip (4, smax + width) x, y, z, w and its (smax + width, 4) pack; the
    window table, the flat list and its stride; the static (nwin, nper)."""

    width: int
    smax: int
    rows: torch.Tensor
    strip: torch.Tensor
    pack: torch.Tensor
    wins: torch.Tensor
    tbl: torch.Tensor
    stride: int
    nwin: int
    nper: int

    def to(self, device) -> "Inputs":
        return replace(self, **{f: getattr(self, f).to(device)
                                for f in ("rows", "strip", "pack", "wins", "tbl")})


def _uniform(width: int, smax: int):
    rows = torch.full((5, ROWS), ROW_VALUE)
    strip = torch.full((4, smax + width), STRIP_VALUE)
    return rows, strip, strip.t().contiguous()


def tool_inputs(device="cpu") -> Inputs:
    """Scenario A, the JAX tool's: W 128, its tables, rows 0.05 (memberf
    0.05, a scale), strip 0.055 everywhere, the sentinel column included;
    static at nwin 10, nper 1."""
    rows, strip, pack = _uniform(WCOL, SMAX)
    return Inputs(WCOL, SMAX, rows, strip, pack, make_wins_table(), make_flat_table(),
                  MAXC + 1, REAL_WINS * CH_PER_WIN, 1).to(device)


def census_inputs(k: int, m: int, device="cpu") -> Inputs:
    """Scenario B at W 1 on the tool's uniform rows and strip: k windows of
    m candidates a sub-block (`census_tables`); static at nwin k, nper m."""
    rows, strip, pack = _uniform(1, SMAX)
    wins, tbl, stride = census_tables(k, m, 1, SMAX)
    return Inputs(1, SMAX, rows, strip, pack, wins, tbl, stride, k, m).to(device)


def random_inputs(seed: int, width: int, device="cpu", span: int = 0) -> Inputs:
    """Random rows, strip and tables from `seed`, distinct per sub-block:
    rows in [0.5, 0.51]^3 and candidates in [0.47, 0.49]^3 (every pair
    within h, dx, dy, dz > 0: no sum cancels), mass in [100, 200] and
    memberf in [0.5, 1] (rho/RHO >= ~1.7 from one pair on: ci stays far from
    0); windows empty at smax, empty elsewhere, ragged, or reaching past smax
    (clipped to the sentinel), at most `span` columns (0: 3 chunks at W 128,
    24 at W 1); flat lists of 0-16 aligned chunk offsets; static at nwin 4
    (W 128) or 7 (W 1), nper 1 or 5."""
    rng = np.random.default_rng(seed)
    smax, ncols = SMAX, SMAX + width
    rows = np.empty((5, ROWS), np.float32)
    rows[:3] = rng.uniform(0.5, 0.51, (3, ROWS))
    rows[3] = rng.uniform(100.0, 200.0, ROWS)
    rows[4] = rng.uniform(0.5, 1.0, ROWS)
    strip = np.empty((4, ncols), np.float32)
    strip[:3] = rng.uniform(0.47, 0.49, (3, ncols))
    strip[3] = rng.uniform(-2.0, -0.5, ncols)
    span = span or (3 * width if width > 1 else 24)
    wins = np.zeros((1, 1, (NSUB + 1) * WIN_STRIDE), np.int32)
    for t in range(NSUB):
        for s in range(NWIN):
            kind = rng.integers(5)
            if kind == 0:
                lo = hi = smax
            elif kind == 1:
                lo = hi = int(rng.integers(0, smax))
            elif kind == 2:
                lo = smax - span // 2
                hi = lo + span
            else:
                lo = int(rng.integers(0, smax - span))
                hi = lo + int(rng.integers(1, span + 1))
            wins[0, 0, t * WIN_STRIDE + 2 * s:t * WIN_STRIDE + 2 * s + 2] = lo, hi
    stride = MAXC + 1
    tbl = np.zeros((1, 1, NSUB * stride), np.int32)
    for t in range(NSUB):
        cnt = int(rng.integers(0, stride))
        tbl[0, 0, t * stride] = cnt
        tbl[0, 0, t * stride + 1:t * stride + 1 + cnt] = \
            width * rng.integers(0, smax // width + 1, cnt)
    strip_t = torch.from_numpy(strip)
    return Inputs(width, smax, torch.from_numpy(rows), strip_t, strip_t.t().contiguous(),
                  torch.from_numpy(wins), torch.from_numpy(tbl), stride,
                  4 if width > 1 else 7, 1 if width > 1 else 5).to(device)


def long_inputs(seed: int, width: int, device="cpu") -> Inputs:
    """`random_inputs` with windows of up to LONG_SPAN columns, flat lists of
    0 to LONG_FLAT chunks (sub-block 0's empty, sub-block 1's full) in a
    table of their own stride, and static at LONG_STATIC: each several stage
    rounds of the blocked kernel."""
    x = random_inputs(seed, width, "cpu", LONG_SPAN[width])
    rng = np.random.default_rng([seed, width])
    cap = LONG_FLAT[width]
    stride = cap + 1
    counts = rng.integers(0, stride, NSUB)
    counts[:2] = 0, cap
    tbl = np.zeros((1, 1, NSUB * stride), np.int32)
    for t, cnt in enumerate(counts):
        tbl[0, 0, t * stride] = cnt
        tbl[0, 0, t * stride + 1:t * stride + 1 + cnt] = \
            width * rng.integers(0, x.smax // width + 1, cnt)
    nwin, nper = LONG_STATIC[width]
    return replace(x, tbl=torch.from_numpy(tbl), stride=stride, nwin=nwin,
                   nper=nper).to(device)


# ---------------------------------------------------------------------------
# The chunks each body reads, and its plain PyTorch version
# ---------------------------------------------------------------------------


def _host(table: torch.Tensor) -> List[int]:
    return table.reshape(-1).tolist()


def window_chunks(wins, guarded: bool, width: int = WCOL, smax: int = SMAX) -> List[List[int]]:
    """Per sub-block, the chunk offsets the prod (guarded False) or guarded
    body reads, in order: per window c0 = lo // W, nchunk = cdiv(hi - c0*W,
    W) where hi > lo else 0, chunk wi at min((c0 + wi)*W, smax); prod reads
    chunk 0 of every window, empty or not."""
    w = _host(wins)
    out = []
    for t in range(NSUB):
        offs = []
        for s in range(NWIN):
            lo, hi = w[t * WIN_STRIDE + 2 * s], w[t * WIN_STRIDE + 2 * s + 1]
            c0 = lo // width
            nchunk = (hi - c0 * width + width - 1) // width if hi > lo else 0
            first = 0 if guarded else 1
            if not guarded:
                offs.append(min(c0 * width, smax))
            offs += [min((c0 + wi) * width, smax) for wi in range(first, nchunk)]
        out.append(offs)
    return out


def flat_chunks(tbl, stride: int = MAXC + 1) -> List[List[int]]:
    """Per sub-block, the chunk offsets of the flat list."""
    v = _host(tbl)
    return [v[t * stride + 1:t * stride + 1 + v[t * stride]] for t in range(NSUB)]


def static_chunks(nwin: int, nper: int, width: int = WCOL) -> List[List[int]]:
    """Per sub-block, the static body's computed chunk offsets."""
    return [[(s * 7 + t) % SPAN * nper * width + c * width
             for s in range(nwin) for c in range(nper)] for t in range(NSUB)]


def body_chunks(body: str, x: Inputs) -> List[List[int]]:
    """The chunks `body` reads at inputs `x`, per sub-block (a blocked
    body its original's)."""
    if body in WINDOW_BODIES:
        return window_chunks(x.wins, body.startswith("guarded"), x.width, x.smax)
    if body in FLAT_BODIES:
        return flat_chunks(x.tbl, x.stride)
    if body in STATIC_BODIES:
        return static_chunks(x.nwin, x.nper, x.width)
    raise ValueError(f"body {body!r} is not one of {ALL_BODIES}")


def body_pairs(body: str, x: Inputs, nblocks: int = 1) -> int:
    """Pair slots that `body` computes over nblocks blocks: W a chunk, 64
    rows a sub-block."""
    return nblocks * SUB * x.width * sum(len(c) for c in body_chunks(body, x))


def _lambda_plain(rows, strip, chunks: List[List[int]], width: int):
    """(1, 1024) λ of the rows against the chunks of each sub-block: the
    tool's lam_math into a (64, W) carry a sub-block, chunk by chunk, then
    the lane sum and the tool's epilogue (`tools/micro_window.py:81-109`)."""
    c = ph.PairConstants.of(H)
    dev = rows.device
    n = max(len(o) for o in chunks)
    offs = torch.tensor([o + [0] * (n - len(o)) for o in chunks], dtype=torch.long,
                        device=dev).reshape(NSUB, n)
    valid = torch.tensor([[j < len(o) for j in range(n)] for o in chunks],
                         device=dev).reshape(NSUB, n)
    a = rows[:3].reshape(3, NSUB, SUB, 1)
    lanes = torch.arange(width, device=dev)
    carry = torch.zeros((4, NSUB, SUB, width), dtype=rows.dtype, device=dev)
    for j in range(n):
        b = strip[:3][:, offs[:, j, None] + lanes]  # (3, NSUB, W)
        d = a - b[:, :, None, :]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        d2p = torch.clamp(c.hh - r2, min=0.0)
        r2c = torch.clamp(r2, min=c.eps2)
        u = torch.rsqrt(r2c)
        tt = torch.clamp(c.h - r2c * u, min=0.0)
        sg = tt * tt * u
        terms = torch.stack([d2p * d2p * d2p, d[0] * sg, d[1] * sg, d[2] * sg])
        carry += torch.where(valid[None, :, j, None, None], terms, 0.0)
    p6s, gx, gy, gz = carry.sum(-1).reshape(4, ROWS)
    mass, memberf = rows[3], rows[4]
    rho = mass * (p6s * c.p6f) * memberf
    cg = c.c_grad * memberf
    norm2 = (gx * cg) ** 2 + (gy * cg) ** 2 + (gz * cg) ** 2
    ci = rho * c.rho_recip - 1.0
    return (-ci / (norm2 + c.cfm)).reshape(1, ROWS)


def _check_width(width: int) -> None:
    if width not in WIDTHS:
        raise ValueError(f"width {width}: csrc/micro_window.cu instantiates {WIDTHS}")


def _check_shapes(rows, cand, ncols: int, fused: bool, nblocks: int) -> None:
    want = (ncols, 4) if fused else (4, ncols)
    if tuple(rows.shape) != (5, ROWS) or tuple(cand.shape) != want:
        raise ValueError(f"want rows (5, {ROWS}) and candidates {want}, got "
                         f"{tuple(rows.shape)} and {tuple(cand.shape)}")
    if nblocks < 1:
        raise ValueError(f"nblocks {nblocks} < 1")


def prod_plain(wins, rows, cand, nblocks: int, width: int = WCOL, smax: int = SMAX,
               fused: bool = False):
    """(1, 1024) λ of `build_prod_structure`; every one of the nblocks
    replicas gives the same.  cand is the (4, smax + width) strip, or with
    `fused` its (smax + width, 4) pack."""
    _check_width(width)
    _check_shapes(rows, cand, smax + width, fused, nblocks)
    strip = cand.t() if fused else cand
    return _lambda_plain(rows, strip, window_chunks(wins, False, width, smax), width)


def guarded_plain(wins, rows, cand, nblocks: int, width: int = WCOL, smax: int = SMAX,
                  fused: bool = False):
    """(1, 1024) λ of `build_guarded`."""
    _check_width(width)
    _check_shapes(rows, cand, smax + width, fused, nblocks)
    strip = cand.t() if fused else cand
    return _lambda_plain(rows, strip, window_chunks(wins, True, width, smax), width)


def flat_plain(tbl, rows, cand, nblocks: int, fused: bool, width: int = WCOL,
               stride: int = MAXC + 1):
    """(1, 1024) λ of `build_flat(nblocks, fused)`; cand is the (4, ncols)
    strip (split) or the (ncols, 4) pack (fused)."""
    _check_width(width)
    _check_shapes(rows, cand, cand.shape[0 if fused else 1], fused, nblocks)
    strip = cand.t() if fused else cand
    return _lambda_plain(rows, strip, flat_chunks(tbl, stride), width)


def _check_static(pack, nwin: int, nper: int, width: int) -> None:
    if nwin < 0 or nper < 0 or SPAN * nper * width > pack.shape[0]:
        raise ValueError(f"static: nwin {nwin}, nper {nper} at width {width} read past the "
                         f"{pack.shape[0]} columns")


def static_plain(rows, pack, nblocks: int, nwin: int = REAL_WINS * CH_PER_WIN, nper: int = 1,
                 width: int = WCOL):
    """(1, 1024) λ of `build_static_fused` (nwin 10, nper 1), or of nwin
    windows of nper chunks at the same computed offsets."""
    _check_width(width)
    _check_shapes(rows, pack, pack.shape[0], True, nblocks)
    _check_static(pack, nwin, nper, width)
    return _lambda_plain(rows, pack.t(), static_chunks(nwin, nper, width), width)


# ---------------------------------------------------------------------------
# CUDA kernel launchers
# ---------------------------------------------------------------------------


def _consts():
    c = ph.PairConstants.of(H)
    return c.h, c.hh, c.eps2, c.p6f, c.c_grad, c.rho_recip, c.cfm


def _launch(name: str, dev, nblocks: int, *args):
    """(nblocks, 1024): every block's λ from launcher `name`."""
    out = torch.empty((nblocks, ROWS), dtype=torch.float32, device=dev)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*args, out.numel(), *_consts(), out.data_ptr(),
                                 ph._stream(dev))
    cuda_build.check(name, err)
    return out


def _window_kernel(name: str, wins, rows, cand, nblocks: int, width: int, smax: int,
                   fused: bool):
    """`name`'s λ, every block's (nblocks, 1024)."""
    _check_width(width)
    _check_shapes(rows, cand, smax + width, fused, nblocks)
    dev = ar._check_card(wins=(wins, torch.int32, (1, 1, (NSUB + 1) * WIN_STRIDE)),
                         rows=(rows, torch.float32, (5, ROWS)),
                         cand=(cand, torch.float32, tuple(cand.shape)))
    return _launch(name, dev, nblocks, wins.data_ptr(), rows.data_ptr(), cand.data_ptr(),
                   smax + width, smax, width, int(fused))


def prod_kernel(wins, rows, cand, nblocks: int, width: int = WCOL, smax: int = SMAX,
                fused: bool = False):
    """(1, 1024) λ from `window_prod` (replaces `build_prod_structure`'s
    kernel), over nblocks x 1024 threads."""
    return _window_kernel("window_prod", wins, rows, cand, nblocks, width, smax, fused)[:1]


def guarded_kernel(wins, rows, cand, nblocks: int, width: int = WCOL, smax: int = SMAX,
                   fused: bool = False):
    """(1, 1024) λ from `window_guarded` (replaces `build_guarded`'s kernel)."""
    return _window_kernel("window_guarded", wins, rows, cand, nblocks, width, smax, fused)[:1]


def prod_blocked_kernel(wins, rows, cand, nblocks: int, width: int = WCOL, smax: int = SMAX,
                        fused: bool = False):
    """(1, 1024) λ from `window_prod_blocked` (replaces `build_prod_structure`'s
    kernel, redesigned: row 7.1-b), bit for bit `prod_kernel`'s."""
    return _window_kernel("window_prod_blocked", wins, rows, cand, nblocks, width, smax,
                          fused)[:1]


def guarded_blocked_kernel(wins, rows, cand, nblocks: int, width: int = WCOL,
                           smax: int = SMAX, fused: bool = False):
    """(1, 1024) λ from `window_guarded_blocked` (replaces `build_guarded`'s
    kernel, redesigned: row 7.2-b), bit for bit `guarded_kernel`'s."""
    return _window_kernel("window_guarded_blocked", wins, rows, cand, nblocks, width, smax,
                          fused)[:1]


def _flat_kernel(name: str, tbl, rows, cand, nblocks: int, fused: bool, width: int,
                 stride: int):
    """`name`'s λ, every block's (nblocks, 1024)."""
    _check_width(width)
    ncols = cand.shape[0 if fused else 1]
    _check_shapes(rows, cand, ncols, fused, nblocks)
    dev = ar._check_card(tbl=(tbl, torch.int32, (1, 1, NSUB * stride)),
                         rows=(rows, torch.float32, (5, ROWS)),
                         cand=(cand, torch.float32, tuple(cand.shape)))
    return _launch(name, dev, nblocks, tbl.data_ptr(), stride, rows.data_ptr(),
                   cand.data_ptr(), ncols, width, int(fused))


def flat_kernel(tbl, rows, cand, nblocks: int, fused: bool, width: int = WCOL,
                stride: int = MAXC + 1):
    """(1, 1024) λ from `window_flat` (replaces `build_flat`'s kernel)."""
    return _flat_kernel("window_flat", tbl, rows, cand, nblocks, fused, width, stride)[:1]


def flat_blocked_kernel(tbl, rows, cand, nblocks: int, fused: bool, width: int = WCOL,
                        stride: int = MAXC + 1):
    """(1, 1024) λ from `window_flat_blocked` (replaces `build_flat`'s
    kernel, redesigned: row 7.3-b), bit for bit `flat_kernel`'s."""
    return _flat_kernel("window_flat_blocked", tbl, rows, cand, nblocks, fused, width,
                        stride)[:1]


def _static_kernel(name: str, rows, pack, nblocks: int, nwin: int, nper: int, width: int):
    """`name`'s λ, every block's (nblocks, 1024)."""
    _check_width(width)
    _check_shapes(rows, pack, pack.shape[0], True, nblocks)
    _check_static(pack, nwin, nper, width)
    dev = ar._check_card(rows=(rows, torch.float32, (5, ROWS)),
                         pack=(pack, torch.float32, tuple(pack.shape)))
    return _launch(name, dev, nblocks, rows.data_ptr(), pack.data_ptr(), nwin, nper, width)


def static_kernel(rows, pack, nblocks: int, nwin: int = REAL_WINS * CH_PER_WIN, nper: int = 1,
                  width: int = WCOL):
    """(1, 1024) λ from `window_static` (replaces `build_static_fused`'s
    kernel)."""
    return _static_kernel("window_static", rows, pack, nblocks, nwin, nper, width)[:1]


def static_blocked_kernel(rows, pack, nblocks: int, nwin: int = REAL_WINS * CH_PER_WIN,
                          nper: int = 1, width: int = WCOL):
    """(1, 1024) λ from `window_static_blocked` (replaces
    `build_static_fused`'s kernel, redesigned: row 7.4-b), bit for bit
    `static_kernel`'s."""
    return _static_kernel("window_static_blocked", rows, pack, nblocks, nwin, nper, width)[:1]


def run_plain(body: str, x: Inputs, nblocks: int = 1):
    """`body`'s plain version at inputs `x` (a blocked body's is its
    original's)."""
    fused = body in FUSED
    cand = x.pack if fused else x.strip
    if body in WINDOW_BODIES:
        fn = guarded_plain if body.startswith("guarded") else prod_plain
        return fn(x.wins, x.rows, cand, nblocks, x.width, x.smax, fused)
    if body in FLAT_BODIES:
        return flat_plain(x.tbl, x.rows, cand, nblocks, fused, x.width, x.stride)
    if body in STATIC_BODIES:
        return static_plain(x.rows, x.pack, nblocks, x.nwin, x.nper, x.width)
    raise ValueError(f"body {body!r} is not one of {ALL_BODIES}")


def window_blocks(body: str, x: Inputs, nblocks: int):
    """(nblocks, 1024): every block's λ from the kernel of `body` at inputs
    `x`, each block its own replica's outputs."""
    name = KERNEL_OF.get(body)
    fused = body in FUSED
    cand = x.pack if fused else x.strip
    if body in WINDOW_BODIES:
        return _window_kernel(name, x.wins, x.rows, cand, nblocks, x.width, x.smax, fused)
    if body in FLAT_BODIES:
        return _flat_kernel(name, x.tbl, x.rows, cand, nblocks, fused, x.width, x.stride)
    if body in STATIC_BODIES:
        return _static_kernel(name, x.rows, x.pack, nblocks, x.nwin, x.nper, x.width)
    raise ValueError(f"body {body!r} is not one of {ALL_BODIES}")


def run_kernel(body: str, x: Inputs, nblocks: int):
    """`body`'s kernel at inputs `x`: the first block's (1, 1024) λ."""
    return window_blocks(body, x, nblocks)[:1]


class MicroWindow:
    """The eight kernels' wrappers, with a launch counter per kernel: `launches[name]`
    starts at 0 and grows by one each time a wrapper launches its CUDA
    kernel, and at no other time.  A CPU tensor takes the plain version."""

    def __init__(self):
        self.launches = dict.fromkeys(KERNELS, 0)

    def run(self, body: str, x: Inputs, nblocks: int):
        if x.rows.device.type == "cpu":
            return run_plain(body, x, nblocks)
        out = run_kernel(body, x, nblocks)
        self.launches[KERNEL_OF[body]] += 1
        return out


# ---------------------------------------------------------------------------
# The SASS of the built kernels
# ---------------------------------------------------------------------------


def sass_pattern(body: str, width: int) -> str:
    """A unique part of the mangled name of `body`'s kernel at `width`."""
    if body in BLOCKED_BODIES:  # window_blocked_kernel<W, List, FUSED>
        lists = {"prod": "10WindowListILb0EEE", "guarded": "10WindowListILb1EEE",
                 "flat": "8FlatListE", "static": "10StaticListE"}
        return (f"21window_blocked_kernelILi{width}ENS_{lists[body.split('_')[0]]}"
                f"Lb{int(body in FUSED)}E")
    if body in ("prod", "guarded", "prod_fused", "guarded_fused"):
        return (f"13window_kernelILi{width}ELb{int(body.startswith('guarded'))}E"
                f"Lb{int(body in FUSED)}E")
    if body in ("flat", "flat_fused"):
        return f"11flat_kernelILi{width}ELb{int(body == 'flat_fused')}E"
    return f"13static_kernelILi{width}E"


def load_bytes(loop) -> int:
    """Bytes of the global loads (LDG) of a loop's opcode counts."""
    return sum(v * (16 if ".128" in k else 8 if ".64" in k else 4)
               for k, v in loop.items() if k.startswith("LDG"))


def want_bytes(body: str, width: int) -> int:
    """Bytes a pair the body must load: a candidate (12 split, 16 fused),
    and at W = 1 the flat list's offset."""
    return (16 if body in FUSED else 12) + (4 if body in ("flat", "flat_fused") and width == 1
                                            else 0)


def check_sass(lib_path) -> Dict[str, dict]:
    """`check_funcs` and `check_blocked` of the built library."""
    funcs = ar.sass_functions(lib_path)
    return {**check_funcs(funcs), **check_blocked(funcs)}


def check_funcs(funcs) -> Dict[str, dict]:
    """"body W" -> dict(ok, counts): the pair loop of every instantiation
    holds one MUFU.RSQ a pair, `pbf_lambda`'s fp32-pipe instructions a pair
    opcode by opcode, and `want_bytes` of global loads a pair."""
    phase = ar.fp32_per_pair(ar.pair_loop(ar._one(funcs, ar.PHASE_KERNELS["lambda"])))
    report = {}
    for body in BODIES:
        for width in WIDTHS:
            loop = ar.pair_loop(ar._one(funcs, sass_pattern(body, width)))
            rsq = max(loop["MUFU.RSQ"], 1)
            per_pair = ar.fp32_per_pair(loop)
            got = load_bytes(loop) / rsq
            want = want_bytes(body, width)
            report[f"{body} W{width}"] = dict(
                ok=loop["MUFU.RSQ"] > 0 and per_pair == phase and got == want,
                pairs_a_loop=loop["MUFU.RSQ"], fp32_per_pair=sum(per_pair.values()),
                same_as_phase=per_pair == phase, load_bytes_per_pair=got, want_bytes=want,
                insts_per_pair=sum(loop.values()) / rsq)
    return report


def check_blocked(funcs) -> Dict[str, dict]:
    """"body W" -> dict(ok, counts) for every blocked instantiation: its pair
    loop holds R = BLOCKED_ROWS MUFU.RSQ a shared-memory float4 read
    (LDS.128), R >= 2, no global load, and `pbf_lambda`'s fp32-pipe
    instructions a pair opcode by opcode; the kernel reads and writes no
    local memory (no spill)."""
    phase = ar.fp32_per_pair(ar.pair_loop(ar._one(funcs, ar.PHASE_KERNELS["lambda"])))
    report = {}
    for body in BLOCKED_BODIES:
        for width in WIDTHS:
            sass = ar._one(funcs, sass_pattern(body, width))
            loop = ar.pair_loop(sass)
            rsq = loop["MUFU.RSQ"]
            lds = sum(v for k, v in loop.items() if k.startswith("LDS") and "128" in k)
            ldg = sum(v for k, v in loop.items() if k.startswith("LDG"))
            local = sum(1 for _, op, _ in sass[0] if op.split(".")[0] in ("LDL", "STL"))
            per_pair = ar.fp32_per_pair(loop)
            report[f"{body} W{width}"] = dict(
                ok=BLOCKED_ROWS >= 2 and lds > 0 and rsq == BLOCKED_ROWS * lds and ldg == 0
                and per_pair == phase and local == 0,
                rows=BLOCKED_ROWS, pairs_a_loop=rsq, pairs_a_read=rsq / max(lds, 1),
                ldg_in_loop=ldg, fp32_per_pair=sum(per_pair.values()),
                same_as_phase=per_pair == phase, local=local,
                insts_per_pair=sum(loop.values()) / max(rsq, 1))
    return report


# ---------------------------------------------------------------------------
# Parity and the readings
# ---------------------------------------------------------------------------


# the parity cases that only the blocked bodies take
BLOCKED_CASES = ("long", "empty")


def parity_cases(width: int, device, seed: int = 0) -> Dict[str, Inputs]:
    """The parity cases at `width`: the tool's uniform inputs (W 128:
    scenario A; W 1: the census tables at PARITY_CENSUS), random ones
    (`random_inputs`: empty, ragged and clipped windows), long ones
    (`long_inputs`: windows, flat lists and static offsets of several stage
    rounds of the blocked kernel, an empty flat list) and at W 1 every
    window empty (the census at k 0: guarded, flat and static read nothing,
    prod nine sentinels)."""
    cases = {"tool": tool_inputs(device) if width == WCOL
             else census_inputs(*PARITY_CENSUS, device=device),
             "random": random_inputs(seed, width, device),
             "long": long_inputs(seed, width, device)}
    if width == 1:
        cases["empty"] = census_inputs(0, 1, device)
    return cases


def card_parity(device, seed: int = 0) -> Dict[str, Tuple[float, bool]]:
    """Each body's kernel against its plain version on the card, its
    launches not counted; "body W case" -> (max abs err, within tolerance),
    on the tool's and random `parity_cases` (the blocked bodies on every
    case).  rtol 5e-4, atol 1e-12: λ is ~1e-7, prod's ci 0.077
    amplifies the sum's rounding ~14x, and the kernel sums each pair in
    another order."""
    res = {}
    for width in WIDTHS:
        for case, x in parity_cases(width, device, seed).items():
            for body in BLOCKED_BODIES if case in BLOCKED_CASES else ALL_BODIES:
                got, want = run_kernel(body, x, 2), run_plain(body, x)
                res[f"{body} W{width} {case}"] = (
                    float((got - want).abs().max()),
                    torch.allclose(got, want, rtol=RTOL, atol=ATOL))
    return res


BITS_BLOCKS = 3  # a CTA's replica blocks, some of them past nblocks


def blocked_bits(device, seed: int = 0) -> Dict[str, Tuple[float, bool]]:
    """Each blocked body's kernel against its original's (`BLOCKED_OF`) on
    every block of nblocks BITS_BLOCKS, on every `parity_cases` case at both
    widths, their launches not counted; "body W case = original" -> (max abs
    err, bit for bit)."""
    res = {}
    for width in WIDTHS:
        for case, x in parity_cases(width, device, seed).items():
            for body, orig in BLOCKED_OF.items():
                got = window_blocks(body, x, BITS_BLOCKS)
                want = window_blocks(orig, x, BITS_BLOCKS)
                res[f"{body} W{width} {case} = {orig}"] = (
                    float((got - want).abs().max()), torch.equal(got, want))
    return res


def read_scenario_a(mw: MicroWindow, device, reps: int) -> dict:
    """Scenario A through `mw`: each body's marginal between TOOL_BLOCKS,
    in ns a chunk (64 rows x 128 candidates), G pair-slots/s and ns a
    sub-block, with the SM clock sampled beside."""
    x = tool_inputs(device)
    res = {}
    with ar.ClockSampler(device) as clock:
        for body in ALL_BODIES:
            dt, t_lo, t_hi = ar.marginal(lambda nb: mw.run(body, x, nb), TOOL_BLOCKS, reps)
            per_block = sum(len(c) for c in body_chunks(body, x))
            nch = (TOOL_BLOCKS[1] - TOOL_BLOCKS[0]) * per_block
            res[body] = dict(blocks=list(TOOL_BLOCKS), ms=[t_lo, t_hi],
                             chunks_per_sub=per_block / NSUB, ns_per_chunk=dt * 1e9 / nch,
                             pair_slots_per_s=nch * SUB * WCOL / dt,
                             ns_per_sub=dt * 1e9 / ((TOOL_BLOCKS[1] - TOOL_BLOCKS[0]) * NSUB))
    res["clocks_sm_mhz"] = clock.summary()
    return res


def census(idx: ph.CellIndex) -> dict:
    """Member rows, per-row candidate pairs, and k, the mean non-empty
    (dx, dy) ranges of a member row, at a sort-time index."""
    members = int(idx.table[-1])
    lo, hi = ph.neighbour_ranges(idx)
    member = idx.key < idx.grid.ncells
    nonempty = int((hi > lo)[:, member].sum())
    return dict(members=members, pairs=int((hi - lo).sum()), k=nonempty / members)


# the ladders, from the anchored ms to pbf_lambda, and what each step adds:
# the JAX tool's order, the one that keeps pbf_lambda's fused loads, the one
# that starts from the nine-window walk laid out for this card, and the JAX
# tool's order again with every rung laid out for this card
LAST_STEP = ("pbf_lambda", "per-row ranges, which diverge within a warp, and real positions")
LADDERS = {
    "ladder": (("static", "L1/L2 reads in place of shared memory"),
               ("flat_fused", "offsets loaded from a table"),
               ("flat", "split loads"),
               ("guarded", "nine windows from a lo/hi table"),
               ("prod", "the unconditional chunk per empty window"),
               LAST_STEP),
    "fused_ladder": (("static", "L1/L2 reads in place of shared memory"),
                     ("guarded_fused", "nine windows from a lo/hi table, fused loads"),
                     LAST_STEP),
    "blocked_ladder": (("guarded_blocked_fused", "nine windows from a lo/hi table, staged "
                        "once a CTA, R rows a thread on one shared-memory read"),
                       ("guarded_fused", "a row a thread, each pair's candidate from L1"),
                       LAST_STEP),
    "blocked_jax_ladder": (("static_blocked", "computed offsets, staged once a CTA, R rows "
                            "a thread on one shared-memory read"),
                           ("flat_blocked_fused", "offsets loaded from a table, once a CTA"),
                           ("flat_blocked", "split loads, in the staging"),
                           ("guarded_blocked", "nine windows from a lo/hi table"),
                           ("prod_blocked", "the unconditional chunk per empty window"),
                           LAST_STEP),
}


def read_scenario_b(mw: MicroWindow, device, reps: int, spec, fr) -> dict:
    """Scenario B at the settled dam1m frame, through `mw`: each body at W 1
    on round(k) windows of round(pairs/members/k) candidates a sub-block,
    its ns a member row (the marginal between CENSUS_BLOCKS) x the members;
    beside it `pbf_lambda` on a prebuilt (C, 4) pack and the λ body
    ceiling's anchored ms (pairs / pair-slots a second), all in this run."""
    from pbf_sph_tpu_torch.tools.bench_kernel_variants import device_ms

    cen = census(fr.index)
    k = round(cen["k"])
    m = round(cen["pairs"] / cen["members"] / cen["k"])
    x = census_inputs(k, m, device)
    members = cen["members"]
    res = dict(census=cen, k=k, m=m, pairs_per_row=k * m,
               census_pairs_per_row=cen["pairs"] / members, bodies={})
    with ar.ClockSampler(device) as clock:
        for body in ALL_BODIES:
            dt, t_lo, t_hi = ar.marginal(lambda nb: mw.run(body, x, nb), CENSUS_BLOCKS, reps)
            ns_row = dt * 1e9 / ((CENSUS_BLOCKS[1] - CENSUS_BLOCKS[0]) * ROWS)
            res["bodies"][body] = dict(
                blocks=list(CENSUS_BLOCKS), ms=[t_lo, t_hi], ns_per_row=ns_row,
                pairs_per_row=body_pairs(body, x) / ROWS, implied_ms=ns_row * members * 1e-6)
        st, idx = fr.state, fr.index
        cand = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], st.mass], dim=1)
        lam = torch.empty_like(st.mass)
        res["pbf_lambda_ms"] = device_ms(lambda: ph.lambda_launch(idx, spec.h, cand, lam), reps)
        body = ar.body_rate(ar.Anchor(), "lambda", reps, device)
    res["body_rate"] = body["rate"]
    res["anchored_ms"] = cen["pairs"] / body["rate"] * 1e3
    res["clocks_sm_mhz"] = clock.summary()
    for key, steps in LADDERS.items():
        ladder = [("anchored", res["anchored_ms"], "")]
        for name, adds in steps:
            ms = (res["pbf_lambda_ms"] if name == "pbf_lambda"
                  else res["bodies"][name]["implied_ms"])
            ladder.append((name, ms, adds))
        res[key] = [dict(step=name, ms=ms, step_ms=ms - ladder[i - 1][1] if i else 0.0,
                         adds=adds) for i, (name, ms, adds) in enumerate(ladder)]
    return res


def main(argv=None) -> int:
    from pbf_sph_tpu_torch.tools.bench_kernel_variants import card_line

    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 10
    if not torch.cuda.is_available():
        raise SystemExit("micro_window: needs a CUDA device")
    card = card_line()
    print(card)
    device = torch.device("cuda", torch.cuda.current_device())

    print("== SASS of csrc/micro_window.cu (cuobjdump)")
    cuda_build.library()
    sass = check_sass(cuda_build.library_path())
    for name, r in sass.items():
        print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in r.items()))
    short = [name for name, r in sass.items() if not r["ok"]]
    if short:
        raise SystemExit(f"micro_window: the SASS of {short} is short or differs from "
                         f"pbf_lambda's pair loop, so no rate of it is printed")
    parity = card_parity(device)
    print("== each kernel against its plain version: " + ", ".join(
        f"{k} {e:.3e}" for k, (e, _) in parity.items()))
    wrong = [k for k, (_, ok) in parity.items() if not ok]
    if wrong:
        raise SystemExit(f"micro_window: {wrong} disagree with their plain versions")
    bits = blocked_bits(device)
    print("== each blocked kernel against its original, every block: " + ", ".join(
        f"{k} {e:.3e}" for k, (e, _) in bits.items()))
    wrong = [k for k, (_, same) in bits.items() if not same]
    if wrong:
        raise SystemExit(f"micro_window: {wrong} are not their originals bit for bit")

    mw = MicroWindow()
    a = read_scenario_a(mw, device, reps)
    print(f"== A. the JAX tool's scenario: W {WCOL}, {REAL_WINS} windows x {CH_PER_WIN} chunks "
          f"+ {NWIN - REAL_WINS} empty a sub-block, marginal between nblocks {TOOL_BLOCKS}; "
          f"SM clock (nvidia-smi, MHz) {a['clocks_sm_mhz']}")
    for body in ALL_BODIES:
        r = a[body]
        print(f"  {body:21s} ({r['ms'][0]:.4f}, {r['ms'][1]:.4f} ms): {r['ns_per_chunk']:.4f} "
              f"ns a chunk ({r['chunks_per_sub']:g} a sub-block), "
              f"{r['pair_slots_per_s'] / 1e9:.1f} G pair-slots/s, {r['ns_per_sub']:.4f} ns a "
              f"sub-block")

    spec, fr = ar.settled_dam1m()
    b = read_scenario_b(mw, device, reps, spec, fr)
    cen = b["census"]
    print(f"== B. dam_break(1M, 6) settled sort-time state: {cen['members']} member rows, "
          f"{cen['pairs']} per-row pairs ({b['census_pairs_per_row']:.2f} a row), k = "
          f"{cen['k']:.3f} non-empty ranges a row; W 1, {b['k']} windows x {b['m']} "
          f"candidates a sub-block ({b['pairs_per_row']} pairs a row), marginal between "
          f"nblocks {CENSUS_BLOCKS}; SM clock {b['clocks_sm_mhz']}")
    print("  the windows are uniform across a warp: divergence is left to the last step")
    for body in ALL_BODIES:
        r = b["bodies"][body]
        print(f"  {body:21s} ({r['ms'][0]:.4f}, {r['ms'][1]:.4f} ms): {r['ns_per_row']:.6f} ns "
              f"a row ({r['pairs_per_row']:g} pairs) x members = {r['implied_ms']:.4f} ms")
    print(f"  λ body ceiling {b['body_rate'] / 1e9:.1f} G pair-slots/s; pbf_lambda on a "
          f"prebuilt (C, 4) pack {b['pbf_lambda_ms']:.4f} ms")
    for key in LADDERS:
        print(f"  {key.replace('_', ' ')} (ms, step):")
        for r in b[key]:
            adds = f": {r['adds']}" if r["adds"] else ""
            print(f"    {r['step']:21s} {r['ms']:.4f}  {r['step_ms']:+.4f}{adds}")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "reps": reps,
                      "sass": sass, "parity": {k: e for k, (e, _) in parity.items()},
                      "bits": {k: e for k, (e, _) in bits.items()},
                      "scenario_a": a, "scenario_b": b, "launches": mw.launches}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
