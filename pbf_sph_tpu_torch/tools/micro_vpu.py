"""Op streams, fp32 dots and a lane->sublane reshape on the card, as the TPU
tool asks them.

    python -m pbf_sph_tpu_torch.tools.micro_vpu [--sweep] [reps]

Port of `tools/micro_vpu.py`.  Its `main` (`:102-247`) asks seven questions;
the four kernels of `csrc/micro_vpu.cu` answer sections 1, 5, 6 and 7, and
`micro_roll.MicroRoll`'s rot, unal and dma (`csrc/micro_roll.cu`) answer
sections 3, 4 and 4b:

* `vpu_streams` (`bench_streams`, row 7.12): `nstreams` carries from x + s
  on an (R, 128) tile, NITER trips of one op on every carry (fma c*1.000001
  + x, mul c*1.000001, cmp_where where(c > x, c*1.000001, x), rsqrt(c),
  sqrt(c) + x, x / c), summed in order; one thread an element, CTAs of 1024
  threads, `nblocks` of them (one copy of the tile, or the card filled);
* `vpu_dot` (`dot_kernel`, row 7.16): acc(64, 8) += (a s_i) (64, 128) ·
  b (8, 128)ᵀ, NITER trips, a CTA of 64 a copy, a thread a row's 8 outputs;
* `vpu_dot2` (`dot2_kernel`, row 7.17): acc(64, 128) += (a s_i) (64, 8) @
  b (8, 128), a CTA of 512 a copy, a thread 8 columns of 2 rows;
* `vpu_tr` (`tr_kernel`, row 7.18): acc(64, 1) += x[0, 0:64] s_i, a CTA of
  64 a copy, in two bodies, `direct` and `restage` (the row through shared
  memory each trip);
* `vpu_dot_spread` (`dot_kernel` redesigned, row 7.16b): `vpu_dot`'s
  function bit for bit, one copy spread over 128 CTAs, each a row and 4
  columns for all trips: producer warps compute a tile of trips' d at once
  into a shared-memory ring, and a consumer warp adds them to acc in trip
  order (`spread_plan` is the grid's index model);
* `vpu_dot2_spread` (`dot2_kernel` redesigned, row 7.17b): `vpu_dot2`'s
  function bit for bit, one copy spread over 128 CTAs, each 64 outputs (a
  row and 64 columns by default) for all trips: producer warps, each a row
  of a and 8 columns of b in registers, compute 8 trips' d a lane (a float4
  store an output and 4 trips) into a shared-memory ring, and two consumer
  warps on a scheduler of their own add them to the 64 chains in trip order
  (`spread2_plan` is the grid's index model);
* `vpu_tr_split` (`tr_kernel` redesigned, row 7.18b): the same Σ_i v s_i
  in another fixed order, each row's trips in `parts` contiguous parts of
  fused multiply-adds and the parts' partials in a fixed tree
  (`tr_split_plain`).

s_i = 1 + 1e-9 i, each op rounded in float32, as JAX's weak typing takes
it.  Each kernel has a plain PyTorch version of the same signature;
`MicroVpu` holds the wrappers, which take the plain version for a CPU tensor
and the kernel for a CUDA one, and count launches.  The dots run as fp32
FFMA chains (each trip: a s_i rounded, k summed in order by fused
multiply-adds, then one add to acc), the model the interpreted `dot2_kernel`
matches bit for bit; both plain dots are that model (`ffma_dot`), and the
card's kernels match it bit for bit.  XLA's CPU `dot_kernel` blocks its
K = 128 sum, so it meets the model bit for bit only where the rounding of
the partial sums agrees (the tool's all-ones inputs), and within `dot_atol`
elsewhere.

The tool prints the card line; checks the SASS (cuobjdump: each stream's
trip loop holds one op a carry, sqrt and div counted on their fast path with
their slow-path guards; each dot's trip loop its products and scale
multiplies and one add an output; tr one FFMA a trip, restage with its
store, barrier and load inside the trip; the redesigns as `spread_loops`,
`split_loop` and `spread2_loops` say); holds each kernel against its plain
version on the tool's inputs and on seeded ones, every CTA of every copy;
then reads every kernel as the marginal between NITER and 4 NITER trips
(`anchor_rate.marginal`), at the tool's size (one copy) and with the card
filled, beside the anchor's serial FFMA latency, while `nvidia-smi` samples
the SM clock, and answers sections 3-4b through `MicroRoll`.  The three
redesigns are read at one copy and 4 NITER trips in a CUDA graph
(`micro_roll.read_launch`: they are too short for the marginal's
2x-for-4x check), beside the library call of their function in the same
reader and `vpu_tr_split` at 0 trips (the launch with no trip).  With
--sweep, `vpu_dot_spread` is also built alone at each producer shape and
part of SWEEP (`-DMICRO_VPU_SPREAD_*`) and `vpu_dot2_spread` at each block
shape, producer shape, consumer layout and part of SWEEP2
(`-DMICRO_VPU_SPREAD2_*`), each checked bit for bit and read in turns at
NITER and 4 NITER trips.  The last line is one JSON object.
Without a CUDA device the tool fails.
"""

from __future__ import annotations

import json
import re
import sys
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.tools import anchor_rate as ar
from pbf_sph_tpu_torch.tools import micro_chunk as mch
from pbf_sph_tpu_torch.tools import micro_roll as mr
from pbf_sph_tpu_torch.tools.micro_mc_field import graph_ms

# the TPU tool's constants (`:22-24`) and inputs (`:90`, `:194-195`, `:217-218`, `:239`)
R, C, NITER = 512, 128, 2048
X_TOOL = 1.0000001
FMA_SCALE = mch.FMA_SCALE
SCALE_STEP = 1e-9
OPS = ("fma", "mul", "cmp_where", "rsqrt", "sqrt", "div")
STREAMS = (1, 2, 4, 8)
# csrc/micro_fma.cuh's CarryOp of each op
OP_ID = {"fma": 5, "mul": 2, "cmp_where": 6, "rsqrt": 7, "sqrt": 8, "div": 9}
CTA = 1024
DOT = dict(a=(64, 128), b=(8, 128), out=(64, 8), k=128)
DOT2 = dict(a=(64, 8), b=(8, 128), out=(64, 128), k=8)
DOTS = {"dot": DOT, "dot2": DOT2}
TR_IN, TR_ROWS = (8, 128), 64
TR_BODIES = ("direct", "restage")
TR_ID = {"direct": 0, "restage": 1}
KERNELS = ("vpu_streams", "vpu_dot", "vpu_dot2", "vpu_tr_direct", "vpu_tr_restage",
           "vpu_dot_spread", "vpu_tr_split", "vpu_dot2_spread")
# vpu_dot_spread's grid (csrc/micro_vpu.cu's kSpread*): a CTA a (copy, row,
# group of `cols` columns); `warps` producer warps of `trips` trips a thread
# fill a tile of trips into one of `slots` ring slots; the consumer reads
# `read` trips at a time
SPREAD = dict(cols=4, warps=11, trips=3, slots=2, read=32)
SPREAD_PRODUCERS = 32 * SPREAD["warps"]
SPREAD_TILE = SPREAD_PRODUCERS * SPREAD["trips"]
SPREAD_CTAS = DOT["out"][0] * DOT["out"][1] // SPREAD["cols"]   # a copy
# vpu_dot2_spread's grid (csrc/micro_vpu.cu's kSpread2*): a CTA a (copy,
# block of `rows` rows x 64 / rows columns); `warps` producer warps, warp p
# the 8 (`cols`) outputs 8 (p mod 8) to 8 (p mod 8) + 7 of the block and
# part p / 8 of each tile, lane l trips 4l to 4l + 3 of each 128 of it,
# `trips` in all, into one of `slots` ring slots; the consumers add `chains`
# chains a lane, `read` trips at a time, from warps 0 and 4 (chains 1) or 0
# (2) on the first scheduler, which holds `share` producer warps beside them
SPREAD2 = dict(rows=1, cols=8, warps=8, trips=8, slots=2, chains=1, share=0, read=32)
SPREAD2_OUTPUTS = 64   # a CTA's
SPREAD2_GROUPS = SPREAD2_OUTPUTS // SPREAD2["cols"]
SPREAD2_CONSUMERS = SPREAD2_OUTPUTS // SPREAD2["chains"]
SPREAD2_TILE = SPREAD2["warps"] // SPREAD2_GROUPS * 32 * SPREAD2["trips"]
SPREAD2_CTAS = DOT2["out"][0] * DOT2["out"][1] // SPREAD2_OUTPUTS   # a copy


def spread2_roles(warps: int = SPREAD2["warps"], chains: int = SPREAD2["chains"],
                  share: int = SPREAD2["share"]) -> list:
    """Each warp's role in a vpu_dot2_spread CTA, as the kernel's
    `spread2_producer` gives it, up to the last producer warp:
    ("consumer", c), ("producer", p) or ("idle", None).  Warp w = 4r + q runs
    on scheduler q; on scheduler 0 the consumer warps come first, then
    `share` producers, and the other producers fill rows r < ceil((warps -
    share) / 3) of the other three, in warp order."""
    consumer_warps = SPREAD2_OUTPUTS // chains // 32
    rows = -(-(warps - share) // 3)
    roles, p, w = [], 0, 0
    while p < warps:
        r, q = divmod(w, 4)
        if q == 0 and r < consumer_warps:
            roles.append(("consumer", r))
        elif r < rows if q else r < consumer_warps + share:
            roles.append(("producer", p))
            p += 1
        else:
            roles.append(("idle", None))
        w += 1
    return roles


# vpu_tr_split: the parts of a row's trips (a power of two up to
# TR_SPLIT_MAX_PARTS; csrc/micro_vpu.cu's kTrSplitMaxParts) and the chain
# loop's unroll (kTrSplitUnroll)
TR_PARTS = 64
TR_SPLIT_MAX_PARTS = 256
TR_SPLIT_UNROLL = 4
# --sweep: (producer warps, trips a thread, ring slots, part) that
# vpu_dot_spread is built alone at; part 0 is the kernel, 1 its producers
# alone (the consumer adds one trip a tile), 2 its chain alone (the
# producers store 0)
SWEEP = ((7, 2, 3, 0), (7, 3, 2, 0), (7, 4, 2, 0), (11, 2, 2, 0), (11, 3, 2, 0), (7, 4, 3, 0),
         (11, 3, 2, 1), (11, 3, 2, 2))
# --sweep: (rows a CTA, producer warps, trips a lane, ring slots, chains a
# consumer lane, producer warps beside the consumers, part) that
# vpu_dot2_spread is built alone at; part as SWEEP's
SWEEP2 = ((1, 8, 8, 2, 1, 0, 0), (1, 8, 8, 2, 1, 2, 0), (1, 8, 8, 2, 2, 2, 0),
          (1, 8, 8, 2, 1, 2, 1), (1, 8, 8, 2, 2, 2, 1), (1, 8, 8, 2, 1, 1, 0),
          (1, 8, 8, 2, 2, 0, 0), (1, 8, 4, 3, 1, 2, 0), (1, 8, 8, 2, 2, 2, 2),
          (1, 8, 8, 2, 1, 0, 1), (1, 8, 8, 2, 1, 0, 2))
# the -DMICRO_VPU_<kernel>_<knob> names of SWEEP's and SWEEP2's entries
SWEEP_KNOBS = {"dot_spread": ("SPREAD", ("WARPS", "TRIPS", "SLOTS", "PART")),
               "dot2_spread": ("SPREAD2", ("ROWS", "WARPS", "TRIPS", "SLOTS", "CHAINS",
                                           "SHARE", "PART"))}
FILL_ID = {"streams": 0, "dot": 1, "dot2": 2, "tr": 3}   # micro_vpu_fill's kernel

# the readings: the marginal between NITER and 4 NITER trips; parity on the
# card at NITER / 8 (where s_i takes three values), the streams over the
# card-filling grid the readings run and the dots and tr over 2 copies
TRIPS = (NITER, 4 * NITER)
PARITY_TRIPS = NITER // 8
PARITY_COPIES = 2
# tolerances: rsqrt's (card_parity), and dot's atol against XLA's blocked
# CPU sum (`dot_atol`), a unit of |a|·|b|ᵀ a trip
RTOL_RSQRT = 1e-6
DOT_ATOL = 2e-6
# the fp32 peak of one H100 SXM outside the tensor cores (data sheet; an FMA
# counts two), and its device memory rate
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = mch.HBM_BYTES_PER_S


class Inputs(NamedTuple):
    x: torch.Tensor     # (rows, 128): the streams' tile
    a: torch.Tensor     # (64, 128): dot's a
    b: torch.Tensor     # (8, 128): dot's b
    a2: torch.Tensor    # (64, 8): dot2's a
    b2: torch.Tensor    # (8, 128): dot2's b
    t: torch.Tensor     # (8, 128): tr's x


# ---------------------------------------------------------------------------
# Inputs and plain PyTorch versions
# ---------------------------------------------------------------------------


def tool_inputs(device="cpu", rows: int = R) -> Inputs:
    """The JAX tool's inputs: x = ones * 1.0000001 on (rows, 128), every dot
    operand and tr's x ones."""
    def ones(shape):
        return torch.ones(shape, device=device)

    return Inputs(torch.full((rows, C), X_TOOL, device=device), ones(DOT["a"]), ones(DOT["b"]),
                  ones(DOT2["a"]), ones(DOT2["b"]), ones(TR_IN))


def random_inputs(seed: int, device="cpu", rows: int = R) -> Inputs:
    """From `seed`: x in [0.5, 2) (every op's chain stays finite), the dot
    operands in [-1, 1), tr's x in [-4, 4)."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return Inputs(f32(rng.uniform(0.5, 2.0, (rows, C))), f32(rng.uniform(-1, 1, DOT["a"])),
                  f32(rng.uniform(-1, 1, DOT["b"])), f32(rng.uniform(-1, 1, DOT2["a"])),
                  f32(rng.uniform(-1, 1, DOT2["b"])), f32(rng.uniform(-4, 4, TR_IN)))


def scales(niter: int, device="cpu"):
    """(niter,) float32 s_i = 1 + 1e-9 i, the product and the sum each
    rounded to float32 (`:187`, `:212`, `:236`)."""
    i = torch.arange(niter, dtype=torch.float32, device=device)
    return i * torch.tensor(SCALE_STEP, dtype=torch.float32, device=device) + 1.0


def _check_streams(x, op: str, nstreams: int, niter: int) -> None:
    if op not in OPS:
        raise ValueError(f"op {op!r} is not one of {OPS}")
    if nstreams not in STREAMS:
        raise ValueError(f"nstreams {nstreams}: csrc/micro_vpu.cu instantiates {STREAMS}")
    if x.dim() != 2 or x.shape[1] != C or x.shape[0] % 8 or not x.shape[0] \
            or x.dtype != torch.float32:
        raise ValueError(f"x: want float32 (8k, {C}), got {x.dtype} {tuple(x.shape)}")
    if niter < 0:
        raise ValueError(f"niter {niter} < 0")


def _round(op: str, c, x, scale):
    if op == "fma":
        return torch.addcmul(x, c, scale)   # fused, as XLA and the FFMA round it once
    if op == "mul":
        return c * FMA_SCALE
    if op == "cmp_where":
        return torch.where(c > x, c * FMA_SCALE, x)
    if op == "rsqrt":
        return torch.rsqrt(c)
    # sqrt and divide in float64, rounded once to float32: correctly rounded
    # (as XLA's and the kernel's IEEE ops) on either device; torch's own CPU
    # float32 sqrt is not
    if op == "sqrt":
        return torch.sqrt(c.double()).float() + x
    return (x.double() / c.double()).float()


def _copy_blocks(x, nblocks: Optional[int]) -> int:
    """The CTAs of the grid: one copy of x (rows / 8) by default, never
    fewer."""
    nb = x.numel() // CTA if nblocks is None else nblocks
    if nb < x.numel() // CTA:
        raise ValueError(f"nblocks {nb} < {x.numel() // CTA}: the output needs them")
    return nb


def streams_plain(x, op: str, nstreams: int, niter: int = NITER,
                  nblocks: Optional[int] = None):
    """(nblocks * 8, 128) of `bench_streams(nstreams, op)` (`:62-88`):
    carries from x + s, niter trips of op on each, acc = c0 + c1 + ... in
    order; CTA b's (8, 128) rows are those of x's tile b mod (rows / 8), as
    the kernel's grid computes them (one copy of x by default)."""
    _check_streams(x, op, nstreams, niter)
    nb = _copy_blocks(x, nblocks)
    c = x + torch.arange(nstreams, dtype=x.dtype, device=x.device).reshape(-1, 1, 1)
    scale = torch.tensor(FMA_SCALE, dtype=x.dtype, device=x.device)
    for _ in range(niter):
        c = _round(op, c, x, scale)
    acc = c[0]
    for s in range(1, nstreams):
        acc = acc + c[s]
    return acc[torch.arange(nb * CTA // C, device=x.device) % x.shape[0]]


def _check_dot(which: str, a, b, niter: int, ncopies: int) -> None:
    shapes = DOTS[which]
    if tuple(a.shape) != shapes["a"] or tuple(b.shape) != shapes["b"] \
            or a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"{which}: want float32 a {shapes['a']} and b {shapes['b']}, got "
                         f"{a.dtype} {tuple(a.shape)} and {b.dtype} {tuple(b.shape)}")
    if niter < 0 or ncopies < 1:
        raise ValueError(f"niter {niter} must be >= 0 and ncopies {ncopies} >= 1")


def ffma_dot(a, bkn, niter: int):
    """(M, N) Σ_i d_i over niter trips, in trip order from 0: d_i = Σ_k
    fma(as_k, b_k, d) in k order from 0 (`torch.addcmul`, fused), as = a s_i
    rounded to float32 first, each d_i then added to acc by a separate
    add.  a (M, K), bkn (K, N); every trip's d at once, one addcmul a k."""
    sa = a[None] * scales(niter, a.device)[:, None, None]
    d = torch.zeros((niter, a.shape[0], bkn.shape[1]), dtype=torch.float32, device=a.device)
    for k in range(bkn.shape[0]):
        d = torch.addcmul(d, sa[:, :, k:k + 1], bkn[k])
    acc = torch.zeros(d.shape[1:], dtype=torch.float32, device=a.device)
    for di in d:
        acc = acc + di
    return acc


def dot_plain(a, b, niter: int = NITER, ncopies: int = 1):
    """(ncopies, 64, 8) of `dot_kernel` (`:184-192`): `ffma_dot` of a and
    bᵀ, the K = 128 sum in k order (XLA's CPU dot blocks it: see
    `dot_atol`)."""
    _check_dot("dot", a, b, niter, ncopies)
    return ffma_dot(a, b.T, niter).expand(ncopies, -1, -1)


def dot2_plain(a, b, niter: int = NITER, ncopies: int = 1):
    """(ncopies, 64, 128) of `dot2_kernel` (`:210-215`): `ffma_dot` of a
    and b, the model the interpreted kernel matches bit for bit."""
    _check_dot("dot2", a, b, niter, ncopies)
    return ffma_dot(a, b, niter).expand(ncopies, -1, -1)


def _check_tr(x, body: str, niter: int, ncopies: int) -> None:
    if body not in TR_BODIES:
        raise ValueError(f"tr body {body!r} is not one of {TR_BODIES}")
    if tuple(x.shape) != TR_IN or x.dtype != torch.float32:
        raise ValueError(f"tr: want float32 {TR_IN}, got {x.dtype} {tuple(x.shape)}")
    if niter < 0 or ncopies < 1:
        raise ValueError(f"niter {niter} must be >= 0 and ncopies {ncopies} >= 1")


def tr_plain(x, body: str = "direct", niter: int = NITER, ncopies: int = 1):
    """(ncopies, 64, 1) of `tr_kernel` (`:233-237`): acc = fma(v, s_i, acc),
    v = x[0, 0:64] as a column (`torch.addcmul`, fused as XLA fuses it);
    both bodies compute the same."""
    _check_tr(x, body, niter, ncopies)
    v = x[0, :TR_ROWS].reshape(TR_ROWS, 1)
    acc = torch.zeros((TR_ROWS, 1), dtype=torch.float32, device=x.device)
    for s in scales(niter, x.device):
        acc = torch.addcmul(acc, v, s)
    return acc.expand(ncopies, -1, -1)


def _check_tr_split(x, niter: int, parts: int, ncopies: int) -> None:
    _check_tr(x, "direct", niter, ncopies)
    if not 1 <= parts <= TR_SPLIT_MAX_PARTS or parts & (parts - 1):
        raise ValueError(f"parts {parts}: csrc/micro_vpu.cu takes a power of two from 1 to "
                         f"{TR_SPLIT_MAX_PARTS}")


def split_len(niter: int, parts: int) -> int:
    """L, the trips of a part: ceil(niter / parts); the last parts may
    hold fewer, or none."""
    return -(-niter // parts)


def split_partials(x, niter: int, parts: int):
    """(64, parts): part p of row j runs acc = fma(v_j, s_i, acc) from 0
    over trips p L to min((p + 1) L, niter) in order (`torch.addcmul`, fused
    as the kernel's `fmaf`), v = x[0, 0:64]; L steps on all parts at once."""
    v = x[0, :TR_ROWS].reshape(TR_ROWS, 1)
    span = split_len(niter, parts)
    s = scales(niter, x.device)
    first = torch.arange(parts, device=x.device) * span
    acc = torch.zeros((TR_ROWS, parts), dtype=torch.float32, device=x.device)
    for step in range(span):
        trip = first + step
        si = s[trip.clamp(max=niter - 1)]
        acc = torch.where(trip < niter, torch.addcmul(acc, v, si), acc)
    return acc


def split_tree(partials):
    """(rows, 1): the kernel's fixed tree over the parts, x[p] + x[p + w]
    for w = parts / 2, ..., 1."""
    w = partials.shape[1] // 2
    while w:
        partials = partials[:, :w] + partials[:, w:2 * w]
        w //= 2
    return partials


def tr_split_plain(x, niter: int = NITER, parts: int = TR_PARTS, ncopies: int = 1):
    """(ncopies, 64, 1) of `vpu_tr_split`: Σ_i v s_i as `split_tree` of
    `split_partials`.  parts = 1 is `tr_plain`'s sum, bit for bit."""
    _check_tr_split(x, niter, parts, ncopies)
    return split_tree(split_partials(x, niter, parts)).expand(ncopies, -1, -1)


def spread_plan(niter: int, ncopies: int = 1) -> dict:
    """The index model of `vpu_dot_spread`'s grid: `outputs` (ncopies *
    SPREAD_CTAS, cols), the flat (copy, m, n) index that each CTA's consumer
    lanes write (CTA x, y = (m, column group), copy); `stored` (tiles,
    SPREAD_TILE), the trip that producer thread t stores at ring position
    h SPREAD_PRODUCERS + t of each tile (-1 past niter); `read`, the trips in
    the order the consumer adds them (positions 0 to the tile's count of
    each tile in turn)."""
    groups = DOT["out"][1] // SPREAD["cols"]
    bx, cols = np.arange(SPREAD_CTAS)[:, None], np.arange(SPREAD["cols"])
    one = (bx // groups) * DOT["out"][1] + (bx % groups) * SPREAD["cols"] + cols
    outputs = np.concatenate([c * DOT["out"][0] * DOT["out"][1] + one for c in range(ncopies)])
    tiles = split_len(niter, SPREAD_TILE)
    t, h = np.meshgrid(np.arange(SPREAD_PRODUCERS), np.arange(SPREAD["trips"]), indexing="ij")
    pos = h * SPREAD_PRODUCERS + t
    stored = np.full((tiles, SPREAD_TILE), -1)
    for tile in range(tiles):
        trip = tile * SPREAD_TILE + pos
        stored[tile, pos] = np.where(trip < niter, trip, -1)
    read = [stored[tile, j] for tile in range(tiles)
            for j in range(min(SPREAD_TILE, niter - tile * SPREAD_TILE))]
    return dict(outputs=outputs, stored=stored, read=read)


def spread2_plan(niter: int, ncopies: int = 1) -> dict:
    """The index model of `vpu_dot2_spread`'s grid.  `outputs` (ncopies *
    SPREAD2_CTAS, 64): the flat (copy, m, n) index that the consumers write
    for block output o (consumer thread o mod SPREAD2_CONSUMERS, of warp 4
    (thread / 32), its chain o / SPREAD2_CONSUMERS); `produced`, the same for
    the (m, n) whose row of a and column of b the producer warp of output o
    holds; `writes` (64, SPREAD2_TILE), how many (producer warp, lane, trip)
    store each ring position of a tile; `stored` (tiles, SPREAD2_TILE), the
    trip stored at each position (-1 past niter); `read`, the trips in the
    order a chain adds them."""
    cols, trips = SPREAD2["cols"], SPREAD2["trips"]
    width = SPREAD2_OUTPUTS // SPREAD2["rows"]
    n_out = DOT2["out"][1]
    blocks = n_out // width
    producers = [p for role, p in spread2_roles() if role == "producer"]
    outputs = np.empty((ncopies * SPREAD2_CTAS, SPREAD2_OUTPUTS), np.int64)
    produced = np.empty_like(outputs)
    for copy in range(ncopies):
        base = copy * DOT2["out"][0] * n_out
        for x in range(SPREAD2_CTAS):
            m0, nb = x // blocks * SPREAD2["rows"], x % blocks * width
            cta = copy * SPREAD2_CTAS + x
            for ct in range(SPREAD2_CONSUMERS):
                for j in range(SPREAD2["chains"]):
                    o = ct + j * SPREAD2_CONSUMERS
                    outputs[cta, o] = base + (m0 + o // width) * n_out + nb + o % width
            for p in producers:
                o0 = (p % SPREAD2_GROUPS) * cols
                for c in range(cols):
                    produced[cta, o0 + c] = base + (m0 + o0 // width) * n_out + nb + o0 % width + c
    writes = np.zeros((SPREAD2_OUTPUTS, SPREAD2_TILE), np.int64)
    trip_at = np.full(SPREAD2_TILE, -1)
    for p in producers:
        o0 = (p % SPREAD2_GROUPS) * cols
        for lane in range(32):
            first = (p // SPREAD2_GROUPS) * 32 * trips + 4 * lane
            for h in range(trips):
                pos = first + (h // 4) * 128 + h % 4
                writes[o0:o0 + cols, pos] += 1
                trip_at[pos] = pos
    tiles = split_len(niter, SPREAD2_TILE)
    trip = np.arange(tiles)[:, None] * SPREAD2_TILE + trip_at[None]
    stored = np.where((trip_at[None] >= 0) & (trip < niter), trip, -1)
    read = [stored[tile, j] for tile in range(tiles)
            for j in range(min(SPREAD2_TILE, niter - tile * SPREAD2_TILE))]
    return dict(outputs=outputs, produced=produced, writes=writes, stored=stored, read=read)


# ---------------------------------------------------------------------------
# CUDA kernel launchers
# ---------------------------------------------------------------------------


def _launch(name: str, dev, *args) -> None:
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*args, ph._stream(dev))
    cuda_build.check(name, err)


def fill_blocks(device, kernel: str, op: str = "fma", nstreams: int = 1,
                body: str = "direct") -> int:
    """CTAs (copies) that fill every SM at the kernel's occupancy: kernel
    "streams" (op, nstreams), "dot", "dot2" or "tr" (body)."""
    a, b = {"streams": (OP_ID.get(op, -1), nstreams), "tr": (TR_ID.get(body, -1), 0)}.get(
        kernel, (0, 0))
    with torch.cuda.device(device):
        n = cuda_build.library().micro_vpu_fill(FILL_ID[kernel], a, b)
    if n <= 0:
        raise ValueError(f"csrc/micro_vpu.cu has no {kernel} kernel at {op}, {nstreams}, {body}")
    return n


def streams_kernel(x, op: str, nstreams: int, niter: int = NITER,
                   nblocks: Optional[int] = None):
    """(nblocks * 8, 128) from `vpu_streams` over nblocks CTAs (default: one
    copy of x, rows / 8 CTAs): every CTA's output."""
    _check_streams(x, op, nstreams, niter)
    dev = ar._check_card(x=(x, torch.float32, tuple(x.shape)))
    nb = _copy_blocks(x, nblocks)
    out = torch.empty((nb * CTA // C, C), dtype=torch.float32, device=dev)
    _launch("vpu_streams", dev, x.data_ptr(), x.numel(), OP_ID[op], nstreams, niter, nb,
            out.data_ptr())
    return out


def _dot_kernel(which: str, a, b, niter: int, ncopies: int):
    _check_dot(which, a, b, niter, ncopies)
    shapes = DOTS[which]
    dev = ar._check_card(a=(a, torch.float32, shapes["a"]), b=(b, torch.float32, shapes["b"]))
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{which}: the kernel's float4 loads need 16-byte aligned a and b")
    out = torch.empty((ncopies, *shapes["out"]), dtype=torch.float32, device=dev)
    _launch(f"vpu_{which}", dev, a.data_ptr(), b.data_ptr(), niter, ncopies, out.data_ptr())
    return out


def dot_kernel(a, b, niter: int = NITER, ncopies: int = 1):
    """(ncopies, 64, 8) from `vpu_dot`."""
    return _dot_kernel("dot", a, b, niter, ncopies)


def dot2_kernel(a, b, niter: int = NITER, ncopies: int = 1):
    """(ncopies, 64, 128) from `vpu_dot2`."""
    return _dot_kernel("dot2", a, b, niter, ncopies)


def tr_kernel(x, body: str = "direct", niter: int = NITER, ncopies: int = 1):
    """(ncopies, 64, 1) from `vpu_tr` in `body`."""
    _check_tr(x, body, niter, ncopies)
    dev = ar._check_card(x=(x, torch.float32, TR_IN))
    out = torch.empty((ncopies, TR_ROWS, 1), dtype=torch.float32, device=dev)
    _launch("vpu_tr", dev, x.data_ptr(), TR_ID[body], niter, ncopies, out.data_ptr())
    return out


def _check_grid(ncopies: int) -> None:
    if ncopies > 65535:
        raise ValueError(f"ncopies {ncopies}: the copies are the grid's y, at most 65535")


def dot_spread_kernel(a, b, niter: int = NITER, ncopies: int = 1):
    """(ncopies, 64, 8) from `vpu_dot_spread`: `vpu_dot`'s function."""
    _check_dot("dot", a, b, niter, ncopies)
    _check_grid(ncopies)
    dev = ar._check_card(a=(a, torch.float32, DOT["a"]), b=(b, torch.float32, DOT["b"]))
    if a.data_ptr() % 16:
        raise ValueError("dot_spread: the kernel's float4 loads need a 16-byte aligned a")
    out = torch.empty((ncopies, *DOT["out"]), dtype=torch.float32, device=dev)
    _launch("vpu_dot_spread", dev, a.data_ptr(), b.data_ptr(), niter, ncopies, out.data_ptr())
    return out


def dot2_spread_kernel(a, b, niter: int = NITER, ncopies: int = 1):
    """(ncopies, 64, 128) from `vpu_dot2_spread`: `vpu_dot2`'s function."""
    _check_dot("dot2", a, b, niter, ncopies)
    _check_grid(ncopies)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("dot2_spread: the kernel's float4 loads need 16-byte aligned a and b")
    dev = ar._check_card(a=(a, torch.float32, DOT2["a"]), b=(b, torch.float32, DOT2["b"]))
    out = torch.empty((ncopies, *DOT2["out"]), dtype=torch.float32, device=dev)
    _launch("vpu_dot2_spread", dev, a.data_ptr(), b.data_ptr(), niter, ncopies, out.data_ptr())
    return out


def tr_split_kernel(x, niter: int = NITER, parts: int = TR_PARTS, ncopies: int = 1):
    """(ncopies, 64, 1) from `vpu_tr_split`."""
    _check_tr_split(x, niter, parts, ncopies)
    _check_grid(ncopies)
    dev = ar._check_card(x=(x, torch.float32, TR_IN))
    out = torch.empty((ncopies, TR_ROWS, 1), dtype=torch.float32, device=dev)
    _launch("vpu_tr_split", dev, x.data_ptr(), niter, parts, ncopies, out.data_ptr())
    return out


class MicroVpu:
    """The wrappers of the kernels, with a launch counter per kernel name
    (`KERNELS`): it starts at 0 and grows by one each time a method launches
    a CUDA kernel, and at no other time.  A CPU tensor takes the plain
    version, where nblocks and ncopies only shape the output."""

    def __init__(self):
        self.launches = dict.fromkeys(KERNELS, 0)

    def _run(self, name: str, cpu: bool, plain, kernel):
        if cpu:
            return plain()
        out = kernel()
        self.launches[name] += 1
        return out

    def streams(self, x, op: str, nstreams: int, niter: int = NITER,
                nblocks: Optional[int] = None):
        return self._run("vpu_streams", x.device.type == "cpu",
                         lambda: streams_plain(x, op, nstreams, niter, nblocks),
                         lambda: streams_kernel(x, op, nstreams, niter, nblocks))

    def dot(self, a, b, niter: int = NITER, ncopies: int = 1):
        return self._run("vpu_dot", a.device.type == "cpu",
                         lambda: dot_plain(a, b, niter, ncopies),
                         lambda: dot_kernel(a, b, niter, ncopies))

    def dot2(self, a, b, niter: int = NITER, ncopies: int = 1):
        return self._run("vpu_dot2", a.device.type == "cpu",
                         lambda: dot2_plain(a, b, niter, ncopies),
                         lambda: dot2_kernel(a, b, niter, ncopies))

    def tr(self, x, body: str = "direct", niter: int = NITER, ncopies: int = 1):
        if body not in TR_BODIES:
            raise ValueError(f"tr body {body!r} is not one of {TR_BODIES}")
        return self._run(f"vpu_tr_{body}", x.device.type == "cpu",
                         lambda: tr_plain(x, body, niter, ncopies),
                         lambda: tr_kernel(x, body, niter, ncopies))

    def dot_spread(self, a, b, niter: int = NITER, ncopies: int = 1):
        return self._run("vpu_dot_spread", a.device.type == "cpu",
                         lambda: dot_plain(a, b, niter, ncopies),
                         lambda: dot_spread_kernel(a, b, niter, ncopies))

    def tr_split(self, x, niter: int = NITER, parts: int = TR_PARTS, ncopies: int = 1):
        return self._run("vpu_tr_split", x.device.type == "cpu",
                         lambda: tr_split_plain(x, niter, parts, ncopies),
                         lambda: tr_split_kernel(x, niter, parts, ncopies))

    def dot2_spread(self, a, b, niter: int = NITER, ncopies: int = 1):
        return self._run("vpu_dot2_spread", a.device.type == "cpu",
                         lambda: dot2_plain(a, b, niter, ncopies),
                         lambda: dot2_spread_kernel(a, b, niter, ncopies))


# ---------------------------------------------------------------------------
# The SASS of the built kernels
# ---------------------------------------------------------------------------

# each op's opcode that marks its trip loop, one a carry a trip
OP_MAIN = {"fma": "FFMA", "mul": "FMUL", "cmp_where": "FSEL", "rsqrt": "MUFU.RSQ",
           "sqrt": "MUFU.RSQ", "div": "MUFU.RCP"}
# the opcodes each op must hold exactly once a carry a trip, and whether its
# fp32 instructions are only those (fma, mul and cmp_where: nothing else)
OP_WANT = {"fma": ("FFMA",), "mul": ("FMUL",), "cmp_where": ("FSETP", "FMUL", "FSEL"),
           "rsqrt": ("MUFU.RSQ",), "sqrt": ("MUFU.RSQ",), "div": ("MUFU.RCP",)}
ONLY_WANT = ("fma", "mul", "cmp_where")
# forward branches a carry a trip: the IEEE sqrt's and divide's slow-path guard
OP_GUARDS = {"fma": 0, "mul": 0, "cmp_where": 0, "rsqrt": 0, "sqrt": 1, "div": 1}
# a dot thread's outputs, the rows of a it scales and its shared-memory
# float4 reads a trip (dot: one row's 8 outputs, reading b; dot2: 8 columns
# of 2 rows, reading their a)
DOT_THREAD = {"dot": dict(outputs=8, rows=1, lds128=256),
              "dot2": dict(outputs=16, rows=2, lds128=4)}


# the mangled-name pieces of the kernels that are not templates
MANGLED = {"dot": "14vpu_dot_kernel", "dot2": "15vpu_dot2_kernel",
           "dot_spread": "21vpu_dot_spread_kernel", "tr_split": "19vpu_tr_split_kernel",
           "dot2_spread": "22vpu_dot2_spread_kernel"}


def pattern(name: str) -> str:
    """The mangled-name piece of a kernel: "<op> <nstreams>", "dot", "dot2",
    "tr <body>", "dot_spread", "tr_split" or "dot2_spread"."""
    if name in MANGLED:
        return MANGLED[name]
    head, tail = name.split()
    if head == "tr":
        return f"13vpu_tr_kernelILi{TR_ID[tail]}E"
    return f"18vpu_streams_kernelILi{OP_ID[head]}ELi{tail}E"


def local_memory(sass: ar.Sass) -> int:
    """The kernel's local-memory loads and stores: spills."""
    return sum(1 for _, op, _ in sass[0] if op.startswith(("LDL", "STL")))


def _best_loop(sass: ar.Sass, key: str):
    """(counts, guards, loops with key) of the innermost loop whose fast path
    holds the most `key`: a kernel's trip loop."""
    found = []
    for span in ar.innermost_spans(sass):
        path, guards = mch.fast_path(sass, span)
        c = mch._counts(path)
        if c[key]:
            found.append((c, guards, len(path)))
    if not found:
        return None, 0, 0, 0
    c, guards, insts = max(found, key=lambda f: f[0][key])
    return c, guards, insts, len(found)


def stream_loop(sass: ar.Sass, op: str, ns: int) -> dict:
    """One stream instantiation's trip loop: ok if it is the one loop with
    its op, holding each opcode of OP_WANT once a carry, OP_GUARDS forward
    branches a carry and (fma, mul, cmp_where) no other fp32 instruction;
    a carry-trip's fp32 and MUFU instructions on the fast path."""
    c, guards, insts, nloops = _best_loop(sass, OP_MAIN[op])
    if c is None:
        return dict(ok=False)
    fp32 = mch._fp32(c)
    ok = (nloops == 1 and all(c[k] == ns for k in OP_WANT[op]) and guards == ns * OP_GUARDS[op]
          and (op not in ONLY_WANT or fp32 == ns * len(OP_WANT[op])) and not local_memory(sass))
    return dict(ok=ok, fp32_per_carry=fp32 / ns, mufu_per_carry=mch._mufu(c) / ns,
                insts_per_carry=insts / ns, guards_per_carry=guards / ns,
                opcodes={k: v / ns for k, v in sorted(c.items())})


def dot_loop(sass: ar.Sass, which: str) -> dict:
    """A dot's trip loop, the loop with its FFMAs: a thread's outputs x K
    products, K - 1 or K of each fused (FFMA: fma(a, b, 0) may be an FMUL),
    K scale multiplies (FMUL) a row it scales and the trip scale's one, one
    FADD an output and the scale's one, its shared-memory operand read every
    trip (DOT_THREAD) and no local memory in the kernel."""
    t, k = DOT_THREAD[which], DOTS[which]["k"]
    n = t["outputs"]
    c, guards, insts, nloops = _best_loop(sass, "FFMA")
    if c is None:
        return dict(ok=False)
    lds = c["LDS.128"]
    ok = (nloops == 1 and n * (k - 1) <= c["FFMA"] <= n * k
          and c["FFMA"] + c["FMUL"] == (n + t["rows"]) * k + 1 and c["FADD"] == n + 1
          and guards == 0 and lds == t["lds128"] and not local_memory(sass))
    return dict(ok=ok, ffma=c["FFMA"], fmul=c["FMUL"], fadd=c["FADD"], lds128=lds,
                local=local_memory(sass), insts=insts)


def tr_loop(sass: ar.Sass, body: str) -> dict:
    """tr's trip loop: one FFMA, the scale's FMUL and FADD; restage also its
    store, barrier and load inside the trip, direct no shared memory."""
    c, guards, insts, nloops = _best_loop(sass, "FFMA")
    if c is None:
        return dict(ok=False)
    sts, bar = c["STS"], c["BAR"]
    lds = sum(v for key, v in c.items() if key.startswith("LDS"))
    staged = sts >= 1 and bar >= 1 and lds >= 1 if body == "restage" else sts + bar + lds == 0
    ok = (nloops == 1 and c["FFMA"] == 1 and c["FMUL"] == 1 and c["FADD"] == 1 and guards == 0
          and staged and not local_memory(sass))
    return dict(ok=ok, sts=sts, bar=bar, lds=lds, insts=insts)


def _span_counts(sass: ar.Sass, span: Tuple[int, int]):
    return mch._counts([op for addr, op, _ in sass[0] if span[0] <= addr <= span[1]])


def spread_loops(sass: ar.Sass) -> dict:
    """vpu_dot_spread's two loops.  The producers' tile loop, the smallest
    loop that holds every FFMA of the kernel (it also holds the wait on a
    free slot): a thread's trips x 4 outputs x K products, K - 1 or K of
    each fused, K scale multiplies a trip and the trip scale's one, the
    scale's one FADD a trip, one broadcast float4 read of b a k and one
    store a trip and output.  The consumer's chain, the innermost loop with
    the most FADDs and no FFMA: two read-ins, one FADD a trip, 4 trips a
    float4 read.  No local memory."""
    insts = sass[0]
    total = mch._counts([op for _, op, _ in insts])
    spans = [sp for sp in ar.all_spans(sass) if total["FFMA"]
             and _span_counts(sass, sp)["FFMA"] == total["FFMA"]]
    chains = [c for c in (_span_counts(sass, sp) for sp in ar.innermost_spans(sass))
              if c["FADD"] and not c["FFMA"]]
    if not spans or not chains:
        return dict(ok=False)
    c = _span_counts(sass, min(spans, key=lambda sp: sp[1] - sp[0]))
    chain = max(chains, key=lambda c: c["FADD"])
    trips, cols, k = SPREAD["trips"], SPREAD["cols"], DOT["k"]
    n = trips * cols
    lds, chain_lds = mch._lds128(c), mch._lds128(chain)
    ok = (n * (k - 1) <= c["FFMA"] <= n * k
          and c["FFMA"] + c["FMUL"] == trips * (cols + 1) * k + trips and c["FADD"] == trips
          and lds == k and c["STS"] == n and chain["FADD"] == 2 * SPREAD["read"]
          and chain_lds * 4 == chain["FADD"] and not local_memory(sass))
    return dict(ok=ok, ffma=c["FFMA"], fmul=c["FMUL"], fadd=c["FADD"], lds128=lds,
                sts=c["STS"], chain_fadd=chain["FADD"], chain_lds128=chain_lds,
                local=local_memory(sass))


# the tensor-core instructions of sm_90a: none may stand in for a dot's FFMAs
TENSOR_CORE = ("HMMA", "HGMMA", "IMMA", "IGMMA", "DMMA", "BMMA", "QGMMA")
# opcodes whose first register is read, not written
NO_DEST = ("ST", "RED", "ATOM", "ISETP", "FSETP", "DSETP", "BRA", "SYNCS", "BAR", "EXIT",
           "YIELD", "CALL", "RET")


def products_scaled(sass: ar.Sass, span: Tuple[int, int]) -> int:
    """The FMULs of a span that read a register an FFMA wrote last before
    them in the span: a scale multiplied onto a product's result (d s_i)
    rather than onto an operand (a s_i).  A .64 or .WIDE destination writes
    two registers and a .128 one four."""
    last, n = {}, 0
    for addr, op, inst in sass[0]:
        if not span[0] <= addr <= span[1]:
            continue
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", inst)]
        writes = bool(regs) and not op.startswith(NO_DEST)
        srcs = regs[1:] if writes else regs
        if op.startswith("FMUL") and any(last.get(r) == "FFMA" for r in srcs):
            n += 1
        if writes:
            width = 4 if ".128" in op else 2 if ".64" in op or ".WIDE" in op else 1
            for r in range(regs[0], regs[0] + width):
                last[r] = op.split(".")[0]
    return n


def spread2_loops(sass: ar.Sass) -> dict:
    """vpu_dot2_spread's two loops.  The producers' tile loop, the smallest
    loop that holds every FFMA of the kernel (it holds the wait on a free
    slot): a lane's trips x 8 columns x K products, K - 1 or K of each
    fused, the row's K scale multiplies a trip and the trip scale's one, the
    scale's one FADD a trip, one float4 store an output and 4 trips, no
    shared-memory read (a and b stay in registers) and no multiply of a
    product's result (the scale is not hoisted onto d).  The consumer's
    chain, the innermost loop with the most FADDs and no FFMA: two read-ins
    of each of a lane's chains, one FADD a trip and chain, one float4 read
    every 4.  No local memory and no tensor-core instruction."""
    insts = sass[0]
    total = mch._counts([op for _, op, _ in insts])
    spans = [sp for sp in ar.all_spans(sass) if total["FFMA"]
             and _span_counts(sass, sp)["FFMA"] == total["FFMA"]]
    chains = [c for c in (_span_counts(sass, sp) for sp in ar.innermost_spans(sass))
              if c["FADD"] and not c["FFMA"]]
    if not spans or not chains:
        return dict(ok=False)
    tile = min(spans, key=lambda sp: sp[1] - sp[0])
    c = _span_counts(sass, tile)
    chain = max(chains, key=lambda c: c["FADD"])
    trips, cols, k = SPREAD2["trips"], SPREAD2["cols"], DOT2["k"]
    n = trips * cols
    sts = sum(1 for addr, op, _ in insts
              if tile[0] <= addr <= tile[1] and op.startswith("STS") and "128" in op)
    lds = sum(v for key, v in c.items() if key.startswith("LDS"))
    scaled = products_scaled(sass, tile)
    tensor = sum(1 for _, op, _ in insts if op.startswith(TENSOR_CORE))
    chain_lds = mch._lds128(chain)
    ok = (n * (k - 1) <= c["FFMA"] <= n * k
          and c["FFMA"] + c["FMUL"] == n * k + trips * k + trips and c["FADD"] == trips
          and sts == n // 4 and lds == 0 and scaled == 0 and tensor == 0
          and chain["FADD"] == 2 * SPREAD2["read"] * SPREAD2["chains"]
          and chain_lds * 4 == chain["FADD"] and not local_memory(sass))
    return dict(ok=ok, ffma=c["FFMA"], fmul=c["FMUL"], fadd=c["FADD"], sts128=sts, lds=lds,
                scaled_products=scaled, tensor_core=tensor, chain_fadd=chain["FADD"],
                chain_lds128=chain_lds, local=local_memory(sass))


def split_loop(sass: ar.Sass) -> dict:
    """vpu_tr_split's chain, the loop with the most FFMAs: TR_SPLIT_UNROLL
    trips, each one FFMA and its scale's FMUL and FADD (none contracted);
    the tree by shuffles, no atomics, no local memory."""
    c, guards, insts, _ = _best_loop(sass, "FFMA")
    if c is None:
        return dict(ok=False)
    ops = [op for _, op, _ in sass[0]]
    shfl = sum(op.startswith("SHFL") for op in ops)
    atomics = sum(op.startswith(("ATOM", "RED")) for op in ops)
    u = TR_SPLIT_UNROLL
    ok = (c["FFMA"] == c["FMUL"] == c["FADD"] == u and guards == 0 and shfl >= 1
          and not atomics and not local_memory(sass))
    return dict(ok=ok, ffma=c["FFMA"], fmul=c["FMUL"], fadd=c["FADD"], shfl=shfl,
                atomics=atomics, local=local_memory(sass), insts=insts)


def check_sass(lib_path) -> Dict[str, dict]:
    """`check_funcs` of the built library."""
    return check_funcs(ar.sass_functions(lib_path))


def check_funcs(funcs) -> Dict[str, dict]:
    """name -> dict(ok, counts) of every kernel of csrc/micro_vpu.cu: the
    24 stream instantiations (`stream_loop`), the two dots (`dot_loop`), the
    two tr bodies (`tr_loop`), dot_spread (`spread_loops`), tr_split
    (`split_loop`) and dot2_spread (`spread2_loops`)."""
    report = {}
    for op in OPS:
        for ns in STREAMS:
            name = f"{op} {ns}"
            report[name] = stream_loop(ar._one(funcs, pattern(name)), op, ns)
    for which in DOTS:
        report[which] = dot_loop(ar._one(funcs, pattern(which)), which)
    for body in TR_BODIES:
        report[f"tr {body}"] = tr_loop(ar._one(funcs, pattern(f"tr {body}")), body)
    report["dot_spread"] = spread_loops(ar._one(funcs, pattern("dot_spread")))
    report["tr_split"] = split_loop(ar._one(funcs, pattern("tr_split")))
    report["dot2_spread"] = spread2_loops(ar._one(funcs, pattern("dot2_spread")))
    return report


def short(report: Dict[str, dict]) -> list:
    return [name for name, r in report.items() if not r["ok"]]


# ---------------------------------------------------------------------------
# Parity
# ---------------------------------------------------------------------------


def dot_atol(a, b, niter: int):
    """(64, 8) elementwise atol of dot_plain against the interpreted
    `dot_kernel`: 2e-6 x (|a|·|b|ᵀ) x niter.  XLA's CPU dot blocks its K
    sum and the plain version sums k in order; each trip's d of either lies
    within K u Σ|a_k b_k| of the exact product, under 9e-7 x |a|·|b|ᵀ in the
    interpreter's runs.  The card's vpu_dot sums in the plain version's
    order and is held to it bit for bit."""
    return DOT_ATOL * (a.abs().double() @ b.abs().double().T).float() * niter


# the redesigns' further parity cases on the seeded inputs, beyond
# PARITY_TRIPS: dot_spread at two full tiles and a ragged one and at the
# readings' 4 NITER trips; tr_split with a ragged split, at 4 NITER trips,
# and at 1 part (one chain) and 256 (three tree levels in shared memory)
SPREAD_CASES = (2 * SPREAD_TILE + 133, 4 * NITER)
# dot2_spread on both inputs over SPREAD2_COPIES copies: at PARITY_TRIPS and
# SPREAD_CASES (17 full tiles and a ragged one; 64 full tiles)
SPREAD2_CASES = (PARITY_TRIPS, *SPREAD_CASES)
SPREAD2_COPIES = 3
SPLIT_CASES = ((PARITY_TRIPS - 6, TR_PARTS), (4 * NITER, TR_PARTS), (PARITY_TRIPS, 1),
               (PARITY_TRIPS, TR_SPLIT_MAX_PARTS))


def kernel_of(label: str) -> str:
    """The kernel (`KERNELS`) that a `card_parity` label holds."""
    head = label.split()
    if head[0] == "tr":
        return f"vpu_tr_{head[1]}"
    if head[0] in ("dot", "dot2", "dot_spread", "tr_split", "dot2_spread"):
        return f"vpu_{head[0]}"
    return "vpu_streams"


def card_parity(device, seed: int = 0) -> Dict[str, Tuple[float, bool]]:
    """Each kernel against its plain version on the card at PARITY_TRIPS
    trips, its launches not counted; "label case" -> (max abs err, ok), on
    the tool's inputs and on `random_inputs`.  Every CTA of the streams'
    card-filling grid (the readings' grid, a partial copy at its end) and
    every one of PARITY_COPIES copies of the dots and tr is held, and the
    redesigns also at SPREAD_CASES and SPLIT_CASES (dot2_spread on both
    inputs at SPREAD2_CASES over SPREAD2_COPIES copies).  Bit for bit (the same
    fused multiply-adds, multiplies, selects and IEEE sqrt and divide, each
    rounded once, the dots' ordered FFMA sums and tr_split's parts and tree)
    but rsqrt, rtol 1e-6 (the card's MUFU.RSQ against torch's rsqrt; the
    chain contracts to 1, so the difference does not grow)."""
    res = {}
    n = PARITY_TRIPS
    for case, x in (("tool", tool_inputs(device)), ("random", random_inputs(seed, device))):
        for op in OPS:
            for ns in STREAMS:
                nb = fill_blocks(device, "streams", op, ns)
                got = streams_kernel(x.x, op, ns, n, nb)
                want = streams_plain(x.x, op, ns, n, nb)
                if op == "rsqrt":
                    res[f"{op} {ns} {case}"] = (float((got - want).abs().max()), torch.allclose(
                        got, want, rtol=RTOL_RSQRT, atol=0.0))
                else:
                    res[f"{op} {ns} {case}"] = mr.bit_equal(got, want)
        res[f"dot {case}"] = mr.bit_equal(dot_kernel(x.a, x.b, n, PARITY_COPIES),
                                       dot_plain(x.a, x.b, n))
        res[f"dot2 {case}"] = mr.bit_equal(dot2_kernel(x.a2, x.b2, n, PARITY_COPIES),
                                        dot2_plain(x.a2, x.b2, n))
        for body in TR_BODIES:
            res[f"tr {body} {case}"] = mr.bit_equal(tr_kernel(x.t, body, n, PARITY_COPIES),
                                                 tr_plain(x.t, body, n))
        res[f"dot_spread {case}"] = mr.bit_equal(dot_spread_kernel(x.a, x.b, n, PARITY_COPIES),
                                              dot_plain(x.a, x.b, n))
        res[f"tr_split {case}"] = mr.bit_equal(tr_split_kernel(x.t, n, TR_PARTS, PARITY_COPIES),
                                            tr_split_plain(x.t, n, TR_PARTS))
        for trips in SPREAD2_CASES:
            res[f"dot2_spread {case} {trips} trips"] = mr.bit_equal(
                dot2_spread_kernel(x.a2, x.b2, trips, SPREAD2_COPIES),
                dot2_plain(x.a2, x.b2, trips))
    x = random_inputs(seed, device)
    for trips in SPREAD_CASES:
        res[f"dot_spread random {trips} trips"] = mr.bit_equal(
            dot_spread_kernel(x.a, x.b, trips), dot_plain(x.a, x.b, trips))
    for trips, parts in SPLIT_CASES:
        res[f"tr_split random {trips} trips {parts} parts"] = mr.bit_equal(
            tr_split_kernel(x.t, trips, parts), tr_split_plain(x.t, trips, parts))
    return res


# ---------------------------------------------------------------------------
# The work, the bound and the readings
# ---------------------------------------------------------------------------


def streams_work(x, op: str, nstreams: int, niter: int, nblocks: int,
                 sass: Optional[Dict[str, dict]] = None) -> dict:
    """What `bench_streams` needs over nblocks CTAs: one op a carry a trip
    (fma, mul: one fp32 instruction; cmp_where two, its where and its
    multiply; rsqrt one MUFU op; sqrt and div their IEEE fast path's fp32
    and MUFU instructions, from `sass`); x read once, the CTAs' output
    written once."""
    carry_trips = nblocks * CTA * nstreams * niter
    if op in ("sqrt", "div"):
        if sass is None:
            raise ValueError(f"{op}: its fast path's instructions come from the SASS")
        r = sass[f"{op} {nstreams}"]
        fp32, mufu = r["fp32_per_carry"], r["mufu_per_carry"]
    else:
        fp32, mufu = {"fma": (1, 0), "mul": (1, 0), "cmp_where": (2, 0), "rsqrt": (0, 1)}[op]
    return dict(fp32=carry_trips * fp32, mufu=carry_trips * mufu,
                bytes=mr.nbytes(x) + nblocks * CTA * 4)


def dot_work(which: str, niter: int, ncopies: int) -> dict:
    """What a dot needs: 2 M N K flops, the M K scale multiplies and the
    M N accumulate adds a trip a copy (and the scale's two a trip); a and b
    read once, the copies written once."""
    (m, k), n = DOTS[which]["a"], DOTS[which]["out"][1]
    flops = ncopies * niter * (2 * m * n * k + m * k + m * n + 2)
    return dict(flops=flops, bytes=4 * (m * k + k * n + ncopies * m * n))


def tr_work(niter: int, ncopies: int) -> dict:
    """What tr needs: one FFMA an element a trip and the scale's two
    instructions a trip; x's 64 floats read once, the copies written once.
    `chain`: the kernel's niter dependent FFMAs a thread (`chain_ms`)."""
    return dict(fp32=ncopies * niter * (TR_ROWS + 2), mufu=0, chain=niter,
                bytes=4 * (TR_ROWS + ncopies * TR_ROWS))


def bound_ms(w: dict, mhz: float, sms: int) -> Tuple[float, str, str]:
    """(ms, by, what): the least time, the longer of the bytes over 3.35
    TB/s and the operations (flops over the 67 TFLOP/s fp32 peak; or fp32
    and MUFU instructions over the issue rate and the MUFU pipe,
    `micro_chunk.issue_bound_ms`).  by is "bytes" or "operations"; what
    says "bytes", "flops" or "issue"."""
    t_bytes = w["bytes"] / HBM_BYTES_PER_S
    if "flops" in w:
        t_ops, what = w["flops"] / FP32_FLOP_PER_S, "flops"
    else:
        t_ops = mch.issue_bound_ms(w["fp32"], w["mufu"], 0, mhz, sms)[0] * 1e-3
        what = "issue"
    if t_bytes > t_ops:
        return 1e3 * t_bytes, "bytes", "bytes"
    return 1e3 * t_ops, "operations", what


def chain_ms(w: dict, serial_ns: float) -> float:
    """The floor of tr's kernel as written: its chain of dependent FFMAs at
    `serial_ns` each (the rate anchor's serial latency).  It is how the
    kernel accumulates, not the function's bound: `library_call`'s
    `torch.mv` sums the same products in another order, under it."""
    return w["chain"] * serial_ns * 1e-6


def library_call(which: str, x: Inputs, niter: int):
    """The one PyTorch call that computes a kernel's function, the yardstick
    of `library_ms` (the port never calls it), with its operands made here:
    a dot's `torch.matmul` of the niter stacked scaled operands, summed over
    the trips; tr's `torch.mv` of x[0, 0:64] broadcast over the trips with
    the niter scales (Σ_i v s_i).  Each does the same products in its own
    order, in fp32: TF32 is off inside the call and restored after it."""
    s = scales(niter, x.t.device)
    if which == "tr":
        v = x.t[0, :TR_ROWS, None].expand(TR_ROWS, niter)
        fn = lambda: torch.mv(v, s).view(TR_ROWS, 1)   # noqa: E731
    else:
        a, b = (x.a, x.b.T) if which == "dot" else (x.a2, x.b2)
        sa = a[None] * s[:, None, None]
        fn = lambda: torch.matmul(sa, b).sum(0)   # noqa: E731

    def call():
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

    return call


def read_streams(mv: MicroVpu, x, op: str, ns: int, nblocks: int, reps: int) -> dict:
    """One stream reading through `mv`: the marginal over TRIPS at nblocks
    CTAs; the tool's G (8,128)-slots/s a copy (`:98`) and lane ops/s of the
    grid."""
    dt, t_lo, t_hi = ar.marginal(lambda n: mv.streams(x, op, ns, n, nblocks), TRIPS, reps)
    trips = TRIPS[1] - TRIPS[0]
    copies = nblocks * CTA / x.numel()
    return dict(nblocks=nblocks, trips=list(TRIPS), ms=[t_lo, t_hi],
                gslots_per_s=trips * ns * (x.shape[0] // 8) / dt / 1e9,
                lane_ops_per_s=trips * ns * nblocks * CTA / dt, copies=copies)


def read_dot(mv: MicroVpu, which: str, x: Inputs, ncopies: int, reps: int) -> dict:
    """A dot through `mv`: the marginal over TRIPS at ncopies; ns a dot of
    one copy (the tool's unit, `:204`, `:227`) and of the card, flops/s."""
    a, b = (x.a, x.b) if which == "dot" else (x.a2, x.b2)
    run = mv.dot if which == "dot" else mv.dot2
    dt, t_lo, t_hi = ar.marginal(lambda n: run(a, b, n, ncopies), TRIPS, reps)
    trips = TRIPS[1] - TRIPS[0]
    return dict(copies=ncopies, trips=list(TRIPS), ms=[t_lo, t_hi], ns_per_dot=dt * 1e9 / trips,
                ns_per_card_dot=dt * 1e9 / (trips * ncopies),
                flops_per_s=dot_work(which, trips, ncopies)["flops"] / dt)


def read_tr(mv: MicroVpu, body: str, x: Inputs, ncopies: int, reps: int) -> dict:
    """A tr body through `mv`: the marginal over TRIPS at ncopies; ns a
    reshape (a trip) of one copy (the tool's unit, `:247`)."""
    dt, t_lo, t_hi = ar.marginal(lambda n: mv.tr(x.t, body, n, ncopies), TRIPS, reps)
    trips = TRIPS[1] - TRIPS[0]
    return dict(copies=ncopies, trips=list(TRIPS), ms=[t_lo, t_hi],
                ns_per_reshape=dt * 1e9 / trips)


def read_redesigns(mv: MicroVpu, x: Inputs, niter: int) -> dict:
    """The redesigns through `mv` (counted) at one copy and niter trips:
    `vpu_dot_spread`, `vpu_tr_split` (TR_PARTS parts), `vpu_tr_split` at 0
    trips (its grid, tree and stores with no trip: the launch's floor) and
    `vpu_dot2_spread`, and the library calls of their functions (not
    counted), each by `micro_roll.read_launch` (a CUDA graph of 100
    launches, and CUDA events over 100 back to back)."""
    return dict(dot_spread=mr.read_launch(lambda: mv.dot_spread(x.a, x.b, niter)),
                tr_split=mr.read_launch(lambda: mv.tr_split(x.t, niter)),
                tr_split_no_trip=mr.read_launch(lambda: mv.tr_split(x.t, 0)),
                dot2_spread=mr.read_launch(lambda: mv.dot2_spread(x.a2, x.b2, niter)),
                library_dot=mr.read_launch(library_call("dot", x, niter)),
                library_tr=mr.read_launch(library_call("tr", x, niter)),
                library_dot2=mr.read_launch(library_call("dot2", x, niter)))


def read_all(mv: MicroVpu, device, reps: int) -> dict:
    """Every kernel through `mv` (counted) at the tool's inputs, one copy
    (the tool's size) and the card filled, and the redesigns at one copy
    and 4 NITER trips (`read_redesigns`), beside the anchor's serial FFMA
    latency, with the SM clock sampled."""
    x = tool_inputs(device)
    res = {"streams": {}, "dots": {}, "tr": {}}
    with ar.ClockSampler(device) as clock:
        for op in OPS:
            for ns in STREAMS:
                geo = {"tool": R * C // CTA, "fill": fill_blocks(device, "streams", op, ns)}
                res["streams"][f"{op} {ns}"] = {
                    g: read_streams(mv, x.x, op, ns, nb, reps) for g, nb in geo.items()}
        for which in DOTS:
            res["dots"][which] = {g: read_dot(mv, which, x, n, reps)
                                  for g, n in (("tool", 1), ("fill", fill_blocks(device, which)))}
        for body in TR_BODIES:
            res["tr"][body] = {g: read_tr(mv, body, x, n, reps)
                               for g, n in (("tool", 1),
                                            ("fill", fill_blocks(device, "tr", body=body)))}
        res["redesigns"] = read_redesigns(mv, x, TRIPS[1])
        res["anchor_serial"] = mch.anchor_fma(ar.Anchor(), device, reps, serial=True)
    res["clocks_sm_mhz"] = clock.summary()
    return res


def sweep_libraries(kernel: str, shapes):
    """{shape: (ctypes library, ptxas's line for the kernel)}: csrc/
    micro_vpu.cu built alone at each shape of `kernel` ("dot_spread": SWEEP's
    entries, "dot2_spread": SWEEP2's; `SWEEP_KNOBS` names their defines),
    one nvcc for each, all at once, into the build directory (named by the
    sources' hash)."""
    import ctypes
    import subprocess

    src = cuda_build.SRC_DIR / "micro_vpu.cu"
    digest = cuda_build.library_path().stem.rsplit("_", 1)[1]
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    prefix, knobs = SWEEP_KNOBS[kernel]
    procs = {}
    for shape in shapes:
        out = (cuda_build.BUILD_DIR
               / f"libmicro_vpu_{kernel}_{'_'.join(map(str, shape))}_{digest}.so")
        defs = [f"-DMICRO_VPU_{prefix}_{k}={v}" for k, v in zip(knobs, shape)]
        cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, *defs, "-Xptxas", "-v",
               "-shared", "-o", str(out), str(src)]
        procs[shape] = (out, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for shape, (out, cmd, proc) in procs.items():
        log = proc.communicate()[0]
        cuda_build._check_nvcc(cmd, proc.returncode, log)
        lines = log.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling" in line and pattern(kernel) in line)
        lib = ctypes.CDLL(str(out))
        fn = getattr(lib, f"vpu_{kernel}")
        fn.argtypes = cuda_build.SIGNATURES[f"vpu_{kernel}"]
        fn.restype = ctypes.c_int
        libs[shape] = (fn, " ".join(line.split(":", 1)[-1].strip()
                                    for line in lines[at + 2:at + 4]))
    return libs


def sweep(device) -> dict:
    """Each spread kernel at each shape of `sweep_libraries` on seeded
    inputs, one copy: the whole kernel (part 0) bit for bit its plain
    version at SPREAD_CASES, then every shape in a CUDA graph at NITER and 4
    NITER trips, in turns (the shapes in order, then reversed), the SM clock
    sampled.  {kernel: {shape: entry}, "clocks_sm_mhz": ...}."""
    x = random_inputs(0, device)
    plans = {"dot_spread": (SWEEP, x.a, x.b, DOT["out"], dot_plain),
             "dot2_spread": (SWEEP2, x.a2, x.b2, DOT2["out"], dot2_plain)}
    res, runs = {}, []
    for kernel, (shapes, a, b, shape_out, plain) in plans.items():
        out = torch.empty((1, *shape_out), dtype=torch.float32, device=device)

        def run(fn, n, a=a, b=b, out=out, kernel=kernel):
            cuda_build.check(f"vpu_{kernel}", fn(a.data_ptr(), b.data_ptr(), n, 1,
                                                 out.data_ptr(), ph._stream(device)))

        res[kernel] = {}
        for shape, (fn, ptxas) in sweep_libraries(kernel, shapes).items():
            entry = res[kernel][" ".join(map(str, shape))] = dict(ptxas=ptxas, ms={})
            if shape[-1] == 0:
                same = []
                for n in SPREAD_CASES:
                    run(fn, n)
                    same.append(mr.bit_equal(out, plain(a, b, n))[1])
                entry["same"] = all(same)
            runs.append((entry["ms"], lambda n, fn=fn, run=run: run(fn, n)))
    with ar.ClockSampler(device) as clock:
        for ms, fn in runs + runs[::-1]:
            for n in TRIPS:
                ms.setdefault(str(n), []).append(graph_ms(lambda: fn(n)))
    res["clocks_sm_mhz"] = clock.summary()
    return res


def roll_probes(device) -> Tuple[dict, dict]:
    """Sections 3, 4 and 4b of the tool (`:113-180`) through
    `micro_roll.MicroRoll` (`csrc/micro_roll.cu`): its verdict on each, and the
    wrapper's launches."""
    roll = mr.MicroRoll()
    xv = mr.vpu_inputs(device)
    tile = np.arange(mr.ROWS * mr.W, dtype=np.float32).reshape(mr.ROWS, mr.W)
    wide = np.arange(mr.ROWS * mr.VPU_COLS, dtype=np.float32).reshape(mr.ROWS, mr.VPU_COLS)
    want_rot = np.roll(tile, mr.TOOL_SHIFT, 1)
    want_slice = wide[:, mr.TOOL_OFFSET:mr.TOOL_OFFSET + mr.W]
    verdicts = {
        "pltpu.roll dynamic shift": np.array_equal(roll.rot(xv.tile, xv.shift).cpu().numpy(),
                                                   want_rot),
        "unaligned load": np.array_equal(roll.unal(xv.wide, xv.offset).cpu().numpy(),
                                         want_slice),
        "unaligned DMA": np.array_equal(roll.dma(xv.wide, xv.offset).cpu().numpy(), want_slice),
    }
    return verdicts, dict(roll.launches)


def main(argv=None) -> int:
    from pbf_sph_tpu_torch.tools.bench_kernel_variants import card_line

    argv = sys.argv[1:] if argv is None else argv
    do_sweep = "--sweep" in argv
    argv = [a for a in argv if a != "--sweep"]
    reps = int(argv[0]) if argv else 5
    if not torch.cuda.is_available():
        raise SystemExit("micro_vpu: needs a CUDA device")
    card = card_line()
    print(card)
    device = torch.device("cuda", torch.cuda.current_device())

    print("== SASS of csrc/micro_vpu.cu (cuobjdump)")
    cuda_build.library()
    sass = check_sass(cuda_build.library_path())
    for name, r in sass.items():
        print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in r.items()))
    if short(sass):
        raise SystemExit(f"micro_vpu: the SASS of {short(sass)} is off: the compiler folded, "
                         f"unrolled or contracted what is measured, so no rate is printed")
    parity = card_parity(device)
    print("== each kernel against its plain version: " + ", ".join(
        f"{k} {e:.3e}" for k, (e, _) in parity.items()))
    wrong = [k for k, (_, ok) in parity.items() if not ok]
    if wrong:
        raise SystemExit(f"micro_vpu: {wrong} disagree with their plain versions")

    mv = MicroVpu()
    res = read_all(mv, device, reps)
    mhz = mch.sm_clock_mhz(res["clocks_sm_mhz"], device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    serial = res["anchor_serial"]["ns_per_op"]
    x = tool_inputs(device)
    print(f"== SM clock beside the readings (nvidia-smi, MHz): {res['clocks_sm_mhz']}; the "
          f"anchor's serial FFMA {serial:.4f} ns")
    print(f"== 1/2. issue rate (G (8,128)-slots/s of one copy; R={R}, marginal over trips "
          f"{TRIPS}; tool = {R * C // CTA} CTAs, fill = the card at occupancy)")
    for name, geo in res["streams"].items():
        op, ns = name.split()
        full = geo["fill"]
        bms, _, what = bound_ms(streams_work(x.x, op, int(ns), TRIPS[1], full["nblocks"], sass),
                                mhz, sms)
        print(f"  {op:10s} streams={ns}: tool {geo['tool']['gslots_per_s']:8.1f} Gslots/s "
              f"({geo['tool']['lane_ops_per_s'] / 1e12:.3f} T lane-ops/s); fill "
              f"{full['lane_ops_per_s'] / 1e12:.3f} T lane-ops/s at {full['nblocks']} CTAs, "
              f"kernel {full['ms'][1]:.4f} ms, bound {bms:.4f} ms by {what}")
    verdicts, roll_launches = roll_probes(device)
    for what, ok in verdicts.items():
        print(f"== 3/4/4b. {what}: OK, correct={ok} (micro_roll.MicroRoll)")
    for which, geo in res["dots"].items():
        s = DOTS[which]
        full = geo["fill"]
        bms, _, what = bound_ms(dot_work(which, TRIPS[1], full["copies"]), mhz, sms)
        label = "(64,128)x(8,128)^T" if which == "dot" else "(64,8)x(8,128)"
        print(f"== {5 if which == 'dot' else 6}. fp32 FFMA dot {label} -> {s['out']}: tool "
              f"{geo['tool']['ns_per_dot']:.1f} ns/dot; fill ({full['copies']} copies) "
              f"{full['ns_per_card_dot']:.3f} ns/dot, {full['flops_per_s'] / 1e12:.2f} TFLOP/s, "
              f"kernel {full['ms'][1]:.4f} ms, bound {bms:.4f} ms by {what}")
    for body, geo in res["tr"].items():
        full = geo["fill"]
        work = tr_work(TRIPS[1], full["copies"])
        bms, _, what = bound_ms(work, mhz, sms)
        print(f"== 7. lane->sublane reshape, {body}: tool {geo['tool']['ns_per_reshape']:.3f} "
              f"ns/reshape ({geo['tool']['ns_per_reshape'] / serial:.2f}x the serial FFMA); fill "
              f"({full['copies']} copies) {full['ns_per_reshape']:.3f} ns, kernel "
              f"{full['ms'][1]:.4f} ms, bound {bms:.4f} ms by {what}, its chain "
              f"{chain_ms(work, serial):.4f} ms")
    red, n = res["redesigns"], TRIPS[1]
    dot_bound = bound_ms(dot_work("dot", n, 1), mhz, sms)
    dot2_bound = bound_ms(dot_work("dot2", n, 1), mhz, sms)
    tr_bound = bound_ms(tr_work(n, 1), mhz, sms)
    print(f"== 5b. dot_spread (one copy over {SPREAD_CTAS} CTAs) at {n} trips: "
          f"{red['dot_spread']['graph_ms']:.5f} ms in a graph, "
          f"{red['dot_spread']['events_ms']:.5f} back to back; library (torch.matmul + "
          f".sum(0)) {red['library_dot']['graph_ms']:.5f} ms in a graph; vpu_dot (one copy) "
          f"{res['dots']['dot']['tool']['ms'][1]:.4f} ms; bound {dot_bound[0]:.5f} ms by "
          f"{dot_bound[2]}")
    print(f"== 6b. dot2_spread (one copy over {SPREAD2_CTAS} CTAs) at {n} trips: "
          f"{red['dot2_spread']['graph_ms']:.5f} ms in a graph, "
          f"{red['dot2_spread']['events_ms']:.5f} back to back; library (torch.matmul + "
          f".sum(0)) {red['library_dot2']['graph_ms']:.5f} ms in a graph; vpu_dot2 (one copy) "
          f"{res['dots']['dot2']['tool']['ms'][1]:.4f} ms; bound {dot2_bound[0]:.5f} ms by "
          f"{dot2_bound[2]}")
    print(f"== 7b. tr_split ({TR_PARTS} parts) at {n} trips: {red['tr_split']['graph_ms']:.5f} ms "
          f"in a graph, {red['tr_split']['events_ms']:.5f} back to back; at 0 trips "
          f"{red['tr_split_no_trip']['graph_ms']:.5f} ms in a graph; library (torch.mv) "
          f"{red['library_tr']['graph_ms']:.5f} ms in a graph; vpu_tr direct (one copy) "
          f"{res['tr']['direct']['tool']['ms'][1]:.4f} ms; bound {tr_bound[0]:.7f} ms by "
          f"{tr_bound[2]}")
    swept = None
    if do_sweep:
        swept = sweep(device)
        print(f"== 5c/6c. the spread kernels built at other shapes (dot_spread: producer "
              f"warps, trips a thread, ring slots, part; dot2_spread: rows a CTA, producer "
              f"warps, trips a lane, ring slots, chains a lane, part; part 0 all, 1 producers "
              f"alone, 2 chain alone), ms in a graph at {TRIPS} trips, in turns; SM clock "
              f"{swept['clocks_sm_mhz']}")
        wrong = []
        for kernel in SWEEP_KNOBS:
            for name, entry in swept[kernel].items():
                print(f"  {kernel} {name}: " + "; ".join(
                    f"{n}: " + ", ".join(f"{t:.5f}" for t in ms) for n, ms in entry["ms"].items())
                    + f"; bit for bit {entry.get('same', '-')}; {entry['ptxas']}")
                if entry.get("same") is False:
                    wrong.append(f"{kernel} {name}")
        if wrong:
            raise SystemExit(f"micro_vpu: the sweep's {wrong} disagree with their plain versions")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "reps": reps,
                      "sass": sass, "parity": {k: e for k, (e, _) in parity.items()},
                      "readings": res, "roll_probes": verdicts, "sweep": swept,
                      "launches": {**mv.launches, **roll_launches}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
