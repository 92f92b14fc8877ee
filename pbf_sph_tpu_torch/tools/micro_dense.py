"""Bisect the dense-slab λ inner loop on the card: loop structure, tensor-core
r2, staging.

    python -m pbf_sph_tpu_torch.tools.micro_dense [reps]

Port of `tools/micro_dense.py`.  The v2 λ (`pbf_lambda2`, row 6b) walks a
dense slab of 32 rows x WCAP candidates a sub-block; this tool runs one grid
step's worth of that inner loop (NSUB = 32 sub-blocks of 32 rows, WCAP =
2560 candidates each, rows (32, 32, 8), cands (3, 81920)) in the twelve
forms of the TPU tool, with the four hand-written kernels of
`csrc/micro_dense.cu`:

* `dense_loop` (`run(kernel_fn, ...)`): the FPU bodies a) dynamic trip, b)
  static trip, c) unrolled, e) dynamic x2, f) 512-wide dynamic, h) full
  slab, i) two sub-blocks interleaved, j) i) with two chunks a trip, l) the
  v1 mask math (sqrt, divide, masks);
* `dense_mxu` at 128 (`k_mxu`, d) and 512 (`k_wmxu`, g) wide: r2 = A2 @ B2
  and the reduce sg @ [1; bx; by; bz]^T on the FP64 tensor cores.  As in the
  TPU tool, A2 = [ax, ay, az, a2, 1] and B2 = [-2bx, -2by, -2bz, b2, 1], so
  their "r2" is a2*b2 + 1 - 2 a.b, not |a - b|^2 (a fault of the TPU tool
  that the port keeps, so that both compute the same);
* `dense_scr` (`k_scr`, k): c)'s body on candidates staged by TMA bulk
  copies (`cp.async.bulk` on an mbarrier) in place of thread loads;
* `dense_wmxu_blocked` (gb, `k_wmxu` redesigned for the card): g)'s
  function on the sm_90 FP64 shapes, a warp on 16 rows: r2 of a 16 x 8 block
  by one m16n8k4 with A2's constant column folded into the accumulator's
  starting value, and the block's sg kept in registers as the A operand of
  one m16n8k8 reduce (k = t its column 2t, k = t + 4 its column 2t + 1), so
  the chunk loop has no shared-memory round trip and no barrier; b2 staged
  once a CTA in fp64, the CTA persistent over its sub-block's copies.  Its
  fp64 sums run in another order: held to g)'s plain version and float64
  range as g) is (the CPU tests mirror its column pairing in float64).

Each output is (nrep, nsub, 32, 4): per row [sum p6, sum dx*sg, sum dy*sg,
sum dz*sg].  The TPU kernels' REP loop recomputes the same values, so REP is
the grid: copy r comes from CTAs (., r).  Each kernel has a plain PyTorch
version of the same signature that computes chunk by chunk on (32, width)
carries as Pallas does (multiply-adds by `torch.addcmul`, fused as the
kernels' FFMA; d)/g)'s products in float64, rounded once, as the FP64
tensor cores give them, and their a2, hf - r2*u and a*sum(sg) - sum(b*sg)
each rounded once from its exact value, in the kernel too: their r2
cancels, so a contraction choice on either side would show); `MicroDense`
holds the wrappers, which take the plain version for a CPU tensor and the
kernel for a CUDA one, and count launches (gb takes g)'s plain version).

The FPU bodies inline `lambda_pair` of `csrc/pbf_pair.cuh`, the λ phase
kernels' own pair code.  The tool prints the card line; checks the SASS
(cuobjdump: `pbf_lambda`'s fp32 instructions a pair, opcode by opcode, and
one MUFU.RSQ a pair in a, b, c, e, f, h, i, j and k; the pairs a trip of
each loop; b)'s loop bound an immediate; l)'s sqrt and divide with their
slow-path guards; d)/g)'s DMMAs a chunk; k)'s bulk copy and barrier wait,
which no other body has; gb's 2 DMMA a 16 x 8 block and no barrier,
shared-memory store or local memory in its chunk loop); holds each body
and gb against its plain version on the tool's inputs and on seeded ones,
and d)/g)/gb inside the range of a float64 evaluation (`mxu_f64`); then
reads each body as the marginal between two sizes with CUDA events, at the
JAX call's size (64 reps = 2048 CTAs, the card filled) and at one grid step
(32 CTAs, `npass` passes a CTA over the same candidates, which nvcc cannot
hoist: pass p reads at p * PASS_STRIDE, 0 at run time), while `nvidia-smi`
samples the SM clock; and prints ns a chunk and G pairs/s in the TPU tool's
units beside the rate anchor's λ body rate, `chunk_new`'s pair-slot rate
(read in the same run) and λ2's slab rate, each beside its bound from the
work its function needs (`PAIR_WORK`).  The last line is one JSON object.
Without a CUDA device the tool fails.
"""

from __future__ import annotations

import collections
import json
import re
import sys
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.tools import anchor_rate as ar
from pbf_sph_tpu_torch.tools import micro_chunk as mch

# the TPU tool's constants (:21-30) and l)'s eps (:465)
W = 128
SUB = 32
NSUB = 32
NCH = 20
WCAP = NCH * W
REP = 64
WIDE = 512
HH = float(np.float32(0.01))
HF = float(np.float32(0.1))
EPS2 = float(np.float32(1e-16))
EPS = float(np.float32(1e-8))
ROW_W = 8                    # floats of a row: rows (nsub, 32, 8)
PASS_STRIDE = 0              # pass p reads its candidates at p * PASS_STRIDE
# the H100 SXM data sheet's FP64 tensor-core peak (dense), for d)/g)'s bound
FP64_TC_FLOP_PER_S = 67e12
# the work a pair-slot of each body's function needs, whatever the kernel
# issues: (fp32 operations, MUFU operations, tensor-core flops).  chunk_math:
# 3 subtractions, r2 by a multiply and 2 FMAs, the clamp, hh - r2 and its
# max, the cube's 2 multiplies, the p6 sum, hf - r2*u by an FMA and its max,
# sg's 2 multiplies and 3 FMAs = 19, and the rsqrt.  v1_math: bx + by,
# - acl, the cell test, 3 subtractions, r2 (3), hh - r2, the cube (2), the
# r2 test and its select, the two r tests, rs's select, hf - rs, its
# square, the multiply by 1/rs, sg's select, the p6 sum and 3 FMAs = 25,
# and sqrt and the reciprocal one MUFU each.  d)/g): r2 as a 5-term dot and
# the reduce as a 4-output dot on the tensor cores, 2 x (5 + 4) flops, and
# the epilogue's clamp, hh - r2 and its max, the cube (2), the p6 sum, the
# FMA and its max and sg's 2 multiplies = 10, and the rsqrt.
PAIR_WORK = {"fpu": (19, 1, 0), "l": (25, 2, 0), "mxu": (10, 1, 2 * (5 + 4))}
# λ2's slab rate at dam1m on an H100 80GB HBM3 at 700 W (`chip_smoke.py`
# phase 3d, recorded in PERF_FINDINGS.md: "λ2 does 1.15 T slab pairs/s"),
# read beside the bodies
LAMBDA2_SLAB_PAIRS_PER_S = 1.15e12


class Body(NamedTuple):
    label: str       # the TPU tool's letter
    name: str
    kernel: str      # the kernel that runs it (a key of the launch counts)
    code: int        # dense_loop's body id, or dense_mxu's width
    trip: int        # pair-slots a lane a trip of its innermost loop (d/g: a chunk)


BODIES = {b.label: b for b in (
    Body("a", "dynamic fori", "dense_loop", 0, 4),
    Body("b", "static fori", "dense_loop", 1, 4),
    Body("c", "unrolled", "dense_loop", 2, NCH * 4),
    Body("d", "MXU r2+reduce", "dense_mxu", W, 4),
    Body("e", "dynamic fori x2", "dense_loop", 3, 8),
    Body("f", "dynamic wide-512", "dense_loop", 4, 16),
    Body("g", "wide-512 MXU", "dense_wmxu", WIDE, 16),
    Body("h", "full-slab one shot", "dense_loop", 5, NCH * 4),
    Body("i", "interleave x2", "dense_loop", 6, 8),
    Body("j", "interleave2 unrol2", "dense_loop", 7, 16),
    Body("k", "scratch cands unrl", "dense_scr", 0, NCH * 4),
    Body("l", "v1-mask math unrl", "dense_loop", 8, NCH * 4),
)}
KERNELS = ("dense_loop", "dense_mxu", "dense_wmxu", "dense_scr", "dense_wmxu_blocked")
# the redesigns: label -> (the body whose function and plain version it
# takes, its kernel, its name)
REDESIGNS = {"gb": ("g", "dense_wmxu_blocked", "wide-512 MXU blocked")}
PAIRED = ("i", "j")          # a CTA takes sub-blocks t and t + 1
MXU = ("d", "g")
# mma a warp a chunk: d/g 2 x width / 32 warps (m8n8k4); gb 2 a 16 x 8 block,
# 4 blocks (an m16n8k4 and an m16n8k8)
DMMA_A_TRIP = {"d": 8, "g": 32, "gb": 8}
# the readings: reps of the grid at the JAX call's size, passes at one step
SIZES = {"jax": (16, REP), "step": (16, 64)}
PARITY_REPS = 2
# kernel against plain version (see card_parity): rtol, and atol as a share
# of the largest |value| of the case
RTOL, ATOL_SHARE = 1e-5, 1e-5
# d)/g) against a float64 evaluation of a2*b2 + 1 - 2 a.b (see mxu_f64): the
# move of r2 its fp32 operands and a 5-term dot allow, as a share of the sum
# of |term|: a2's rounding (2^-24) and the dot's (5 x 2^-24); and fp32 sums of
# up to 2560 terms in any order that keeps their depth under 160, as a share
# of the sum of |term|
R2_ROUND = 6 * 2.0 ** -24
SUM_ROUND = 1e-5


class DenseInputs(NamedTuple):
    rows: torch.Tensor       # (nsub, 32, 8): x, y, z in columns 0-2
    cands: torch.Tensor      # (3, nsub * wcap)
    nch: torch.Tensor        # (nsub,) int32 chunks of each sub-block
    b2: torch.Tensor         # (8, nsub * wcap): -2bx, -2by, -2bz, b2, 1, bx, by, bz
    acl_rows: torch.Tensor   # (nsub, 32, 8): l)'s rows, acl in column 3


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def b2_slab(cands):
    """(8, C) of `b2s` (`:176-181`): -2 cands, |b|^2, 1, cands."""
    return torch.cat([-2.0 * cands, (cands * cands).sum(0, keepdim=True),
                      torch.ones_like(cands[:1]), cands])


def _inputs(rows, cands, nch, acl_rows, device) -> DenseInputs:
    rows, cands, acl_rows = (torch.from_numpy(a).to(device) for a in (rows, cands, acl_rows))
    return DenseInputs(rows, cands, torch.from_numpy(nch).to(device), b2_slab(cands),
                       acl_rows)


def tool_inputs(nsub: int = NSUB, nch: int = NCH, device="cpu") -> DenseInputs:
    """The TPU tool's inputs (`:88-90`, `:176`, `:459`), drawn from
    default_rng(0) in its order: rows and cands uniform on [0, 1), every
    sub-block `nch` chunks, acl_rows uniform on [0, 1000).  l) meets almost
    no pair: its rows sit up to 1000 away."""
    rng = np.random.default_rng(0)
    rows = rng.uniform(0, 1, (nsub, SUB, 8)).astype(np.float32)
    cands = rng.uniform(0, 1, (3, nsub * nch * W)).astype(np.float32)
    acl_rows = rng.uniform(0, 1000, (nsub, SUB, 8)).astype(np.float32)
    return _inputs(rows, cands, np.full(nsub, nch, np.int32), acl_rows, device)


def random_inputs(seed: int, nsub: int = NSUB, nch: int = NCH, device="cpu") -> DenseInputs:
    """Inputs from `seed` where every test splits: rows within 0.03 and
    candidates within 0.06 of p = (1, 1, 1)/sqrt(3), so most pairs lie
    inside h = 0.1 and some outside; candidate 5 of each sub-block on its
    row 0 (r2 = 0 < eps2, the clamp); acl in [0, 3) against bx + by ~ 1.15,
    so l)'s cell test splits; each sub-block's chunks drawn in 0..nch, the
    first nch.  |p| = 1, so |a||b| ~ 1 and a nearly parallels b: d)/g)'s
    a2*b2 + 1 - 2 a.b ~ |a - b|^2 + 4 (p.(a-p))(p.(b-p)) spans h^2 too."""
    rng = np.random.default_rng(seed)
    p = np.float32(1.0 / np.sqrt(3.0))
    wcap = nch * W
    rows = np.empty((nsub, SUB, 8), np.float32)
    rows[:, :, :3] = p + rng.uniform(-0.03, 0.03, (nsub, SUB, 3))
    rows[:, :, 3] = rng.uniform(0, 3, (nsub, SUB))
    rows[:, :, 4:] = rng.uniform(0, 1, (nsub, SUB, 4))
    cands = (p + rng.uniform(-0.06, 0.06, (3, nsub * wcap))).astype(np.float32)
    for t in range(nsub):
        cands[:, t * wcap + 5] = rows[t, 0, :3]
    counts = rng.integers(0, nch + 1, nsub).astype(np.int32)
    counts[0] = nch
    return _inputs(rows, cands, counts, rows.copy(), device)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def base(label: str) -> str:
    """The body whose function `label` computes: itself, or a redesign's."""
    return REDESIGNS[label][0] if label in REDESIGNS else label


def kernel_of(label: str) -> str:
    """The kernel that runs `label` (a key of the launch counts)."""
    return REDESIGNS[label][1] if label in REDESIGNS else BODIES[label].kernel


def _check_inputs(label: str, x: DenseInputs) -> Tuple[int, int]:
    """(nsub, wcap) of the inputs; raises on shapes that do not fit."""
    label = base(label)
    if label not in BODIES:
        raise ValueError(f"body {label!r} is not one of {tuple(BODIES)}")
    nsub = x.rows.shape[0]
    if tuple(x.rows.shape) != (nsub, SUB, ROW_W) or x.acl_rows.shape != x.rows.shape:
        raise ValueError(f"rows: want ({nsub}, {SUB}, {ROW_W}), got {tuple(x.rows.shape)}")
    ncols = x.cands.shape[1]
    if x.cands.shape[0] != 3 or ncols % (nsub * W) or tuple(x.b2.shape) != (8, ncols):
        raise ValueError(f"cands {tuple(x.cands.shape)} / b2 {tuple(x.b2.shape)} do not hold "
                         f"{nsub} sub-blocks of whole chunks")
    if tuple(x.nch.shape) != (nsub,):
        raise ValueError(f"nch: want ({nsub},), got {tuple(x.nch.shape)}")
    if label in PAIRED and nsub % 2:
        raise ValueError(f"body {label} pairs sub-blocks: nsub {nsub} is odd")
    wcap = ncols // nsub
    if label in ("f", "g") and wcap % WIDE:
        raise ValueError(f"body {label}: wcap {wcap} is not a multiple of {WIDE}")
    return nsub, wcap


def _check_geometry(nrep: int, npass: int) -> None:
    if nrep < 1 or npass < 1:
        raise ValueError(f"nrep {nrep} and npass {npass} must be at least 1")


def chunk_math(a, b, carry):
    """`chunk_math` (`:65-76`) on a (3, 32, 1) and b (3, 1, width), carry
    (4, 32, width) updated in place: r2 = max(|a - b|^2, eps2), u =
    rsqrt(r2), p6 = max(hh - r2, 0)^3, sg = max(hf - r2*u, 0)^2 u."""
    d = a - b
    r2 = torch.addcmul(torch.addcmul(d[0] * d[0], d[1], d[1]), d[2], d[2]).clamp_min(EPS2)
    u = torch.rsqrt(r2)
    tt = (HH - r2).clamp_min(0.0)
    t2 = torch.addcmul(torch.full_like(r2, HF), r2, u, value=-1.0).clamp_min(0.0)
    _accumulate(carry, tt * tt * tt, d, t2 * t2 * u)


def v1_math(a, acl, b, carry):
    """l)'s v1 mask math (`:477-488`): the cell test |bx + by - acl| <= 1,
    p6 = (hh - r2)^3 where r2 <= hh, sg = (hf - r)^2 / r where eps <= r <=
    hf, IEEE sqrt and divide."""
    m = ((b[0] + b[1]) - acl).abs() <= 1.0
    d = a - b
    r2 = torch.addcmul(torch.addcmul(d[0] * d[0], d[1], d[1]), d[2], d[2])
    t = HH - r2
    p6 = torch.where(m & (r2 <= HH), t * t * t, 0.0)
    rr = torch.sqrt(r2)
    ok = m & (rr >= EPS) & (rr <= HF)
    rs = torch.where(ok, rr, 1.0)
    q = HF - rs
    _accumulate(carry, p6, d, torch.where(ok, q * q / rs, 0.0))


def _accumulate(carry, p6, d, sg):
    carry[0] += p6
    carry[1:].addcmul_(d, sg)


def chunk_schedule(label: str, nch: int, wcap: int) -> List[Tuple[int, int]]:
    """(offset, width) of each chunk a pass of body `label` computes, in
    order, for a sub-block of `nch` chunks (clamped to wcap / 128, what the
    sub-block holds; the static bodies take all of them)."""
    full = wcap // W
    n = max(min(nch, full), 0)
    if label in ("a", "i"):
        return [(c * W, W) for c in range(n)]
    if label in ("e", "j"):
        return [(c * W, W) for c in range(2 * (n // 2))]
    if label == "f":
        return [(c * WIDE, WIDE) for c in range(n * W // WIDE)]
    if label == "h":
        return [(0, wcap)]
    if label == "g":
        return [(c * WIDE, WIDE) for c in range(wcap // WIDE)]
    return [(c * W, W) for c in range(full)]


def _row_vectors(rows, t):
    return rows[t, :, :3].T.unsqueeze(-1)   # (3, 32, 1)


def _finish(carry):
    return carry.sum(-1).T                 # (32, 4)


def loop_plain(label: str, x: DenseInputs, nrep: int = 1, npass: int = 1):
    """(nrep, nsub, 32, 4) of an FPU body (a, b, c, e, f, h, i, j, k, l):
    each sub-block's chunks in the body's order on (4, 32, width) carries
    over `npass` passes, then summed over the width, as Pallas sums them;
    i)/j) run sub-block t + 1 with sub-block t's trip count."""
    nsub, wcap = _check_inputs(label, x)
    _check_geometry(nrep, npass)
    rows = x.acl_rows if label == "l" else x.rows
    counts = x.nch.tolist()
    out = x.rows.new_empty((nsub, SUB, 4))
    for t in range(nsub):
        lead = t - t % 2 if label in PAIRED else t
        sched = chunk_schedule(label, counts[lead], wcap)
        width = sched[0][1] if sched else W
        a = _row_vectors(rows, t)
        acl = rows[t, :, 3:4]
        carry = x.cands.new_zeros((4, SUB, width))
        b0 = t * wcap
        for _ in range(npass):
            for o, wd in sched:
                b = x.cands[:, b0 + o:b0 + o + wd].unsqueeze(1)
                if label == "l":
                    v1_math(a, acl, b, carry)
                else:
                    chunk_math(a, b, carry)
        out[t] = _finish(carry)
    return out.expand(nrep, -1, -1, -1)


def mxu_plain(label: str, x: DenseInputs, nrep: int = 1, npass: int = 1):
    """(nrep, nsub, 32, 4) of d) (128 wide) or g) (512): per chunk r2 =
    max(A2 @ B2, eps2) with A2 = [ax, ay, az, a2, 1], B2 = b2 rows 0-4, the
    products in float64 rounded once to fp32; p6 on (32, width) carries; the
    reduce sg @ b2 rows 4-7 (1, bx, by, bz)^T in float64 over every chunk,
    rounded once; out = [sum p6, ax*sum sg - sum bx*sg, ...] (`:212-215`)."""
    nsub, wcap = _check_inputs(label, x)
    _check_geometry(nrep, npass)
    out = x.rows.new_empty((nsub, SUB, 4))
    ones = x.rows.new_ones(SUB)
    for t in range(nsub):
        a64 = x.rows[t, :, :3].double()
        a2 = (a64 * a64).sum(1).float()        # rounded once from its exact value
        amat = torch.cat([a64, a2[:, None].double(), ones[:, None].double()], 1)
        sched = chunk_schedule(label, 0, wcap)
        p6s = x.rows.new_zeros((SUB, sched[0][1]))
        red = amat.new_zeros((SUB, 4))
        for _ in range(npass):
            for o, wd in sched:
                blk = x.b2[:, t * wcap + o:t * wcap + o + wd].double()
                r2 = (amat @ blk[0:5]).float().clamp_min(EPS2)
                u = torch.rsqrt(r2)
                tt = (HH - r2).clamp_min(0.0)
                p6s += tt * tt * tt
                t2 = _fused_hf_minus(r2, u).clamp_min(0.0)
                red += (t2 * t2 * u).double() @ blk[4:8].T
        red = red.float().double()              # the dot's fp32 result
        grad = a64 * red[:, :1] - red[:, 1:]    # the product exact in fp64, rounded once
        out[t] = torch.cat([p6s.sum(1, keepdim=True), grad.float()], 1)
    return out.expand(nrep, -1, -1, -1)


def _fused_hf_minus(r2, u):
    """hf - r2*u rounded once, as the kernels' FFMA (the product is exact in
    fp64)."""
    return (HF - r2.double() * u.double()).float()


def mxu_f64(label: str, x: DenseInputs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(value, lo, hi), each (nsub, 32, 4) float64 on x's device, of d) or g):
    the TPU tool's function evaluated in float64, sharing none of the
    kernel's rounding choices.  value: r2 = a2*b2 + 1 - 2 a.b with a2 exact
    and B2 as given, then every operation in float64, one sum over all the
    sub-block's columns.  [lo, hi]: the range the sums take when each r2
    moves by R2_ROUND x (a2*b2 + 2|a.b| + 1), the rounding of its fp32
    operands and of a 5-term dot (every term is monotone in r2, so the range
    is reached at the ends), widened by SUM_ROUND x the sum of |term| for
    fp32 sums in any order (for a gradient, of a*sum(sg) and sum(b*sg),
    which the function subtracts).  The function's r2 cancels, so one ulp
    of a2 moves the outputs by up to 6e-3 x max|value| on `random_inputs`:
    a fixed tolerance either passes any such rounding or fails them all."""
    nsub, wcap = _check_inputs(label, x)
    rows = x.rows[:, :, :3].double()
    b2 = x.b2.double()
    out = torch.empty((3, nsub, SUB, 4), dtype=torch.float64, device=x.rows.device)

    def terms(r2, d, b, a):
        r2 = r2.clamp_min(EPS2)
        u = torch.rsqrt(r2)
        sg = (HF - r2 * u).clamp_min(0.0) ** 2 * u
        p6 = (HH - r2).clamp_min(0.0) ** 3
        return p6, d * sg, sg, b * sg        # (32, C), (3, 32, C), (32, C), (3, 32, C)

    for t in range(nsub):
        cols = slice(t * wcap, (t + 1) * wcap)
        a = rows[t]                                                  # (32, 3)
        b = b2[5:8, cols]                                            # (3, C)
        a2 = (a * a).sum(1, keepdim=True)
        ab = a @ b
        r2 = a2 * b2[3, cols] + 1.0 - 2.0 * ab
        delta = R2_ROUND * (a2 * b2[3, cols].abs() + 2.0 * ab.abs() + 1.0)
        d = a.T[:, :, None] - b[:, None, :]                          # (3, 32, C)
        bb = b[:, None, :].expand_as(d)
        p6, g, _, _ = terms(r2, d, bb, a)
        out[0, t] = torch.cat([p6.sum(1, keepdim=True), g.sum(2).T], 1)
        # p6 and sg fall as r2 grows: r2 + delta gives the least of each
        p6_lo, g_lo, sg_lo, bsg_lo = terms(r2 + delta, d, bb, a)
        p6_hi, g_hi, sg_hi, bsg_hi = terms(r2 - delta, d, bb, a)
        slack_p6 = SUM_ROUND * p6_hi.sum(1, keepdim=True)
        slack_g = SUM_ROUND * (a.abs() * sg_hi.sum(1, keepdim=True)
                               + bsg_hi.abs().sum(2).T + g_hi.abs().sum(2).T)
        lo_g, hi_g = torch.minimum(g_lo, g_hi).sum(2).T, torch.maximum(g_lo, g_hi).sum(2).T
        out[1, t] = torch.cat([p6_lo.sum(1, keepdim=True) - slack_p6, lo_g - slack_g], 1)
        out[2, t] = torch.cat([p6_hi.sum(1, keepdim=True) + slack_p6, hi_g + slack_g], 1)
    return out[0], out[1], out[2]


def run_plain(label: str, x: DenseInputs, nrep: int = 1, npass: int = 1):
    """The plain version of body `label` (k: c)'s; its staging is all it
    changes; gb: g)'s)."""
    label = base(label)
    if label in MXU:
        return mxu_plain(label, x, nrep, npass)
    return loop_plain("c" if label == "k" else label, x, nrep, npass)


# ---------------------------------------------------------------------------
# CUDA kernel launchers
# ---------------------------------------------------------------------------


def _card(label: str, x: DenseInputs, nrep: int, npass: int) -> Tuple[torch.device, int]:
    nsub, wcap = _check_inputs(label, x)
    _check_geometry(nrep, npass)
    if wcap != WCAP:
        raise ValueError(f"csrc/micro_dense.cu instantiates wcap {WCAP}, got {wcap}")
    if nrep > 65535:
        raise ValueError(f"nrep {nrep} > 65535, the grid's y")
    rows = (x.rows, torch.float32, (nsub, SUB, ROW_W))
    ncols = nsub * WCAP
    tensors = dict(rows=rows, cands=(x.cands, torch.float32, (3, ncols)),
                   nch=(x.nch, torch.int32, (nsub,)), b2=(x.b2, torch.float32, (8, ncols)),
                   acl_rows=(x.acl_rows, torch.float32, (nsub, SUB, ROW_W)))
    dev = ar._check_card(**tensors)
    if x.cands.data_ptr() % 16:
        raise ValueError("cands: the bulk copies need a 16-byte aligned tensor")
    return dev, nsub


def run_kernel(label: str, x: DenseInputs, nrep: int = 1, npass: int = 1):
    """(nrep, nsub, 32, 4) from the kernel of body `label`: `dense_loop`,
    `dense_mxu` (d at 128, g at 512), `dense_scr` (k) or
    `dense_wmxu_blocked` (gb), over a grid of (nsub, nrep) CTAs (nsub / 2
    for i, j; gb: (nsub, y), y filling the card, each CTA persistent over
    its copies), `npass` passes a CTA."""
    dev, nsub = _card(label, x, nrep, npass)
    kernel = kernel_of(label)
    body = BODIES[base(label)]
    out = torch.empty((nrep, nsub, SUB, 4), dtype=torch.float32, device=dev)
    lib = cuda_build.library()
    geo = (nsub, nrep, npass, PASS_STRIDE)
    with torch.cuda.device(dev):
        stream = ph._stream(dev)
        if kernel == "dense_wmxu_blocked":
            err = lib.dense_wmxu_blocked(x.rows.data_ptr(), x.b2.data_ptr(), *geo, HH, HF, EPS2,
                                         out.data_ptr(), stream)
        elif kernel == "dense_loop":
            rows = x.acl_rows if label == "l" else x.rows
            err = lib.dense_loop(rows.data_ptr(), x.cands.data_ptr(), x.nch.data_ptr(),
                                 body.code, *geo, HH, HF, EPS2, EPS, out.data_ptr(), stream)
        elif kernel == "dense_scr":
            err = lib.dense_scr(x.rows.data_ptr(), x.cands.data_ptr(), *geo, HH, HF, EPS2,
                                out.data_ptr(), stream)
        else:
            err = lib.dense_mxu(x.rows.data_ptr(), x.b2.data_ptr(), body.code, *geo, HH, HF,
                                EPS2, out.data_ptr(), stream)
    cuda_build.check(kernel, err)
    return out


class MicroDense:
    """The wrappers of the five kernels, with a launch counter per kernel
    name (`KERNELS`): it starts at 0 and grows by one each time `run`
    launches a CUDA kernel, and at no other time.  A CPU tensor takes the
    plain version, where nrep only repeats the copy; a label is a body's or
    a redesign's (`REDESIGNS`)."""

    def __init__(self):
        self.launches = dict.fromkeys(KERNELS, 0)

    def run(self, label: str, x: DenseInputs, nrep: int = 1, npass: int = 1):
        if x.rows.device.type == "cpu":
            return run_plain(label, x, nrep, npass)
        out = run_kernel(label, x, nrep, npass)
        self.launches[kernel_of(label)] += 1
        return out


# ---------------------------------------------------------------------------
# The SASS of the built kernels
# ---------------------------------------------------------------------------


def pattern(label: str) -> str:
    if label == "gb":
        return "24dense_mxu_blocked_kernelILi512E"
    body = BODIES[label]
    if body.kernel == "dense_loop":
        return f"17dense_loop_kernelILi{body.code}E"
    if body.kernel == "dense_scr":
        return "16dense_scr_kernel"
    return f"16dense_mxu_kernelILi{body.code}E"


def _lds(c: collections.Counter) -> int:
    return sum(v for k, v in c.items() if k.startswith("LDS"))


def _span_counts(sass: ar.Sass, span: Tuple[int, int]) -> collections.Counter:
    lo, hi = span
    return collections.Counter(ar._opcode_key(op) for a, op, _ in sass[0] if lo <= a <= hi)


def _has_immediate_bound(sass: ar.Sass, span: Tuple[int, int]) -> bool:
    """An ISETP in the loop compares with an immediate: the trip count is a
    constant of the code."""
    lo, hi = span
    return any(op.startswith("ISETP") and re.search(r",\s*-?0x[0-9a-f]+\s*,", inst)
               for a, op, inst in sass[0] if lo <= a <= hi)


def fpu_loop(sass: ar.Sass) -> dict:
    """The pair loop of an FPU body: the innermost loop with the most
    MUFU.RSQ (one a pair-slot); its fast path (the slow paths of l)'s IEEE
    sqrt and divide left out): pairs a trip, fp32, MUFU, shared-memory loads,
    all instructions and guards a pair-slot, and whether its ISETP takes an
    immediate."""
    spans = ar.innermost_spans(sass)
    best = max(spans, key=lambda s: _span_counts(sass, s)["MUFU.RSQ"], default=None)
    if best is None or not _span_counts(sass, best)["MUFU.RSQ"]:
        return dict(pairs_a_trip=0, fp32_per_pair=0, mufu_per_pair=0, guards_per_pair=0,
                    immediate_bound=False)
    path, guards = mch.fast_path(sass, best)
    c = mch._counts(path)
    pairs = c["MUFU.RSQ"]
    return dict(pairs_a_trip=pairs, fp32_per_pair=mch._fp32(c) / pairs,
                mufu_per_pair=mch._mufu(c) / pairs, lds_per_pair=_lds(c) / pairs,
                insts_per_pair=len(path) / pairs, guards_per_pair=guards / pairs,
                immediate_bound=_has_immediate_bound(sass, best),
                opcodes={k: v / pairs for k, v in sorted(c.items())})


def mxu_loop(sass: ar.Sass) -> dict:
    """The chunk loop of d)/g): the innermost loop with DMMAs; DMMAs, MUFU.RSQ
    and fp32 instructions a trip (one chunk a warp)."""
    loops = [c for c in ar.innermost_loops(sass) if c["DMMA"]]
    if len(loops) != 1:
        return dict(dmma_a_trip=0, rsq_a_trip=0, loops_with_dmma=len(loops))
    c = loops[0]
    return dict(dmma_a_trip=c["DMMA"], rsq_a_trip=c["MUFU.RSQ"], fp32_a_trip=mch._fp32(c),
                mufu_a_trip=mch._mufu(c), insts_a_trip=sum(c.values()))


def blocked_loop(sass: ar.Sass) -> dict:
    """gb's chunk loop, `mxu_loop`'s counts and, in the loop, the barriers
    and shared-memory stores; in the whole kernel, the local-memory
    accesses."""
    r = mxu_loop(sass)
    spans = [sp for sp in ar.innermost_spans(sass) if _span_counts(sass, sp)["DMMA"]]
    c = _span_counts(sass, spans[0]) if len(spans) == 1 else collections.Counter()
    r.update(bar_a_trip=sum(v for k, v in c.items() if k.startswith("BAR")),
             sts_a_trip=sum(v for k, v in c.items() if k.startswith("STS")),
             local=ar._local(sass))
    return r


def _bulk_ops(sass: ar.Sass) -> Dict[str, int]:
    ops = collections.Counter(op.split(".")[0] for _, op, _ in sass[0])
    return {"bulk_copy": sum(v for k, v in ops.items() if "BLKCP" in k),
            "barrier_wait": sum(v for k, v in ops.items() if k.startswith("SYNCS"))}


def _opcodes(sass: ar.Sass) -> List[str]:
    return [op for _, op, _ in sass[0]]


def check_sass(lib_path) -> Dict[str, dict]:
    """`check_funcs` of the built library."""
    return check_funcs(ar.sass_functions(lib_path))


def check_funcs(funcs) -> Dict[str, dict]:
    """label -> dict(ok, counts): each FPU body's pair loop holds `trip` pairs
    a trip, one MUFU.RSQ and, opcode by opcode, the fp32 instructions a pair
    of `pbf_lambda`'s own pair loop (the bodies inline its lambda_pair, so
    they cannot drift from the code they stand for); b)'s bound is an
    immediate; l) holds `trip` pairs with two MUFU ops (sqrt's RSQ, the
    divide's RCP) and two slow-path guards a pair-slot; d)/g)'s chunk loop
    DMMA_A_TRIP DMMAs and `trip` MUFU.RSQ; k) a bulk copy and a barrier wait
    that no other body has.  h) notes whether it compiled to c)'s
    instructions.  gb (`blocked_loop`): its chunk loop DMMA_A_TRIP["gb"]
    DMMAs (an r2 mma and a reduce mma a 16 x 8 block) and g)'s MUFU.RSQ, no
    barrier and no shared-memory store (sg stays in registers), no local
    memory and no bulk copy."""
    report = {}
    phase = ar.fp32_per_pair(ar.pair_loop(ar._one(funcs, ar.PHASE_KERNELS["lambda"])))
    for label, body in BODIES.items():
        sass = ar._one(funcs, pattern(label))
        bulk = _bulk_ops(sass)
        if label in MXU:
            r = mxu_loop(sass)
            r["ok"] = (r["dmma_a_trip"] == DMMA_A_TRIP[label] and r["rsq_a_trip"] == body.trip)
        else:
            r = fpu_loop(sass)
            if label == "l":
                r["ok"] = (r["pairs_a_trip"] == body.trip and r["mufu_per_pair"] == 2
                           and r["guards_per_pair"] == 2)
            else:
                fp32 = {k: v for k, v in r.get("opcodes", {}).items() if k in ar.FP32_OPCODES}
                r["same_as_pbf_lambda"] = bool(phase) and fp32 == phase
                r["ok"] = (r["pairs_a_trip"] == body.trip and r["mufu_per_pair"] == 1
                           and r["guards_per_pair"] == 0 and r["same_as_pbf_lambda"])
                if label == "b":
                    r["ok"] = r["ok"] and r["immediate_bound"]
        r.update(bulk)
        want_bulk = label == "k"
        r["ok"] = r["ok"] and (bulk["bulk_copy"] > 0 and bulk["barrier_wait"] > 0) == want_bulk \
            and (want_bulk or bulk["bulk_copy"] + bulk["barrier_wait"] == 0)
        report[label] = r
    report["h"]["same_as_c"] = (_opcodes(ar._one(funcs, pattern("h")))
                                == _opcodes(ar._one(funcs, pattern("c"))))
    sass = ar._one(funcs, pattern("gb"))
    r = blocked_loop(sass)
    r.update(_bulk_ops(sass))
    r["ok"] = (r["dmma_a_trip"] == DMMA_A_TRIP["gb"] and r["rsq_a_trip"] == BODIES["g"].trip
               and r["bar_a_trip"] == 0 and r["sts_a_trip"] == 0 and r["local"] == 0
               and r["bulk_copy"] + r["barrier_wait"] == 0)
    report["gb"] = r
    return report


def short(report: Dict[str, dict]) -> List[str]:
    return [name for name, r in report.items() if not r["ok"]]


# ---------------------------------------------------------------------------
# Parity, the bound and the readings
# ---------------------------------------------------------------------------


def close(got, want) -> Tuple[float, bool]:
    """(max abs err, within RTOL and ATOL_SHARE x max|want|) over every copy."""
    want = want.expand_as(got)
    atol = ATOL_SHARE * float(want.abs().max())
    return (float((got - want).abs().max()),
            bool(torch.allclose(got, want, rtol=RTOL, atol=atol)))


def card_parity(device, seed: int = 0) -> Dict[str, Tuple[float, bool]]:
    """Each body's kernel against its plain version on the card, over
    PARITY_REPS copies, its launches not counted; label -> (max abs err,
    ok).  On the tool's inputs (every sub-block 20 chunks) and `random_inputs`
    (trip counts drawn in 0..20); rtol 1e-5 and atol 1e-5 x max|value|: fp32
    sums of mixed-sign terms in the kernel's order (a lane's four columns,
    then a warp-shuffle tree) against Pallas's (per column, then across),
    and d)/g)'s fp64 reduce against torch's float64 product."""
    res = {}
    for case, x in (("tool", tool_inputs(device=device)),
                    ("random", random_inputs(seed, device=device))):
        for label in (*BODIES, *REDESIGNS):
            got = run_kernel(label, x, PARITY_REPS)
            res[f"{label} {case}"] = close(got, run_plain(label, x))
    return res


def within_f64(got, f64) -> Tuple[float, bool]:
    """(max abs err against the float64 value, every copy inside [lo, hi])
    of `mxu_f64`'s (value, lo, hi)."""
    value, lo, hi = (v.expand_as(got) for v in f64)
    g = got.double()
    return float((g - value).abs().max()), bool(((g >= lo) & (g <= hi)).all())


def card_float64(device, seed: int = 0) -> Dict[str, Tuple[float, bool]]:
    """d)'s, g)'s and gb's kernels against `mxu_f64` (gb: g)'s) on the
    card, on the tool's inputs and `random_inputs`, their launches not
    counted; label -> (max abs err against the float64 value, inside its
    rounding range)."""
    res = {}
    for case, x in (("tool", tool_inputs(device=device)),
                    ("random", random_inputs(seed, device=device))):
        for label in (*MXU, *REDESIGNS):
            got = run_kernel(label, x, PARITY_REPS)
            res[f"{label} {case} f64"] = within_f64(got, mxu_f64(base(label), x))
    return res


def pairs_a_rep(x: DenseInputs, label: str) -> int:
    """Pair-slots one copy of body `label` computes on `x`."""
    label = base(label)
    nsub, wcap = _check_inputs(label, x)
    counts = x.nch.tolist()
    total = 0
    for t in range(nsub):
        lead = t - t % 2 if label in PAIRED else t
        total += sum(wd for _, wd in chunk_schedule(label, counts[lead], wcap))
    return total * SUB


def read_body(md: MicroDense, label: str, x: DenseInputs, geo: str, reps: int) -> dict:
    """One body's reading through `md`: the marginal between SIZES[geo] (grid
    reps at "jax", passes of one grid step at "step"); ns a (32, 128) chunk
    and G pairs/s in the TPU tool's units (`report`, `:79-84`)."""
    lo, hi = SIZES[geo]
    if geo == "jax":
        run = lambda n: md.run(label, x, n, 1)  # noqa: E731
    else:
        run = lambda n: md.run(label, x, 1, n)  # noqa: E731
    dt, t_lo, t_hi = ar.marginal(run, (lo, hi), reps)
    nsub = x.rows.shape[0]
    pairs = (hi - lo) * pairs_a_rep(x, label)
    chunks = (hi - lo) * nsub * NCH
    ctas = nsub // 2 if base(label) in PAIRED else nsub
    return dict(sizes=[lo, hi], ctas=ctas * (hi if geo == "jax" else 1), ms=[t_lo, t_hi],
                ms_per_gridstep=dt * 1e3 / (hi - lo), ns_per_chunk=dt * 1e9 / chunks,
                pairs_per_s=pairs / dt)


def read_all(md: MicroDense, device, reps: int) -> dict:
    """Every body and redesign at both sizes through `md` (counted) at the tool's inputs,
    beside the rate anchor's λ body rate and chunk_new's pair-slot rate with
    the card filled, with the SM clock sampled."""
    x = tool_inputs(device=device)
    res = {"bodies": {}}
    with ar.ClockSampler(device) as clock:
        for label in (*BODIES, *REDESIGNS):
            res["bodies"][label] = {geo: read_body(md, label, x, geo, reps) for geo in SIZES}
        res["anchor_lambda_body"] = ar.body_rate(ar.Anchor(), "lambda", reps, device)
        fill = mch.fill_blocks(device, "bench", "new", 1)
        res["chunk_new"] = mch.read_chunk(mch.MicroChunk(), "new", 1, fill,
                                          mch.tool_inputs(device), reps)
    res["clocks_sm_mhz"] = clock.summary()
    return res


def work(label: str, x: DenseInputs, nrep: int) -> dict:
    """What `nrep` copies of body `label`'s function need on `x`, however
    the kernel computes it: the pair-slots this run's trip counts give,
    times PAIR_WORK's fp32 and MUFU operations and tensor-core flops a
    pair; and the bytes read and written once."""
    label = base(label)
    pairs = nrep * pairs_a_rep(x, label)
    nsub = x.rows.shape[0]
    fp32, mufu, flops = PAIR_WORK["mxu" if label in MXU else "l" if label == "l" else "fpu"]
    if label in MXU:
        inputs = (x.rows, x.b2)
    else:
        inputs = (x.acl_rows if label == "l" else x.rows, x.cands, x.nch)
    nbytes = sum(t.numel() * t.element_size() for t in inputs) + nrep * nsub * SUB * 16
    return dict(fp32_ops=pairs * fp32, mufu_ops=pairs * mufu, tc_flops=pairs * flops,
                bytes=nbytes)


def bound_ms(w: dict, mhz: float, sms: int) -> Tuple[float, str]:
    """The least time: the issue bound of `micro_chunk.issue_bound_ms` (fp32
    and MUFU operations, one lane each, at the sampled clock, or the bytes at
    3.35 TB/s), or the tensor-core flops over the FP64 tensor-core peak,
    whichever is longest."""
    ms, by = mch.issue_bound_ms(w["fp32_ops"], w["mufu_ops"], w["bytes"], mhz, sms)
    tc = 1e3 * w["tc_flops"] / FP64_TC_FLOP_PER_S
    return (tc, "operations") if tc > ms else (ms, by)


def main(argv=None) -> int:
    from pbf_sph_tpu_torch.tools.bench_kernel_variants import card_line

    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 10
    if not torch.cuda.is_available():
        raise SystemExit("micro_dense: needs a CUDA device")
    card = card_line()
    print(card)
    device = torch.device("cuda", torch.cuda.current_device())

    print("== SASS of csrc/micro_dense.cu (cuobjdump)")
    cuda_build.library()
    sass = check_sass(cuda_build.library_path())
    for label, r in sass.items():
        print(f"  {label}: " + ", ".join(f"{k} {v}" for k, v in r.items() if k != "opcodes"))
    if sass["h"]["same_as_c"]:
        print("  h) compiles to c)'s instructions: the full slab is c) unrolled")
    if short(sass):
        raise SystemExit(f"micro_dense: the SASS of {short(sass)} is off: the compiler "
                         f"folded or branched around what is measured, so no rate is printed")
    parity = card_parity(device)
    print("== each kernel against its plain version: " + ", ".join(
        f"{k} {e:.3e}" for k, (e, _) in parity.items()))
    wrong = [k for k, (_, ok) in parity.items() if not ok]
    if wrong:
        raise SystemExit(f"micro_dense: {wrong} disagree with their plain versions")
    f64 = card_float64(device)
    print("== d)/g) against a float64 evaluation of the TPU tool's r2, each inside the range "
          "its fp32 operands and sums allow: "
          + ", ".join(f"{k} {e:.3e}" for k, (e, _) in f64.items()))
    wrong = [k for k, (_, ok) in f64.items() if not ok]
    if wrong:
        raise SystemExit(f"micro_dense: {wrong} disagree with float64")

    md = MicroDense()
    res = read_all(md, device, reps)
    body_rate = res["anchor_lambda_body"]["rate"]
    new_rate = res["chunk_new"]["pair_slots_per_s"]
    mhz = mch.sm_clock_mhz(res["clocks_sm_mhz"], device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    x = tool_inputs(device=device)
    print(f"== SM clock beside the readings (nvidia-smi, MHz): {res['clocks_sm_mhz']}; the rate "
          f"anchor's λ body {body_rate / 1e9:.1f} G pair-slots/s, chunk_new "
          f"{new_rate / 1e9:.1f} G pair-slots/s, λ2 at dam1m "
          f"{LAMBDA2_SLAB_PAIRS_PER_S / 1e12:.2f} T slab pairs/s (PERF_FINDINGS.md)")
    print(f"== dense λ bodies (NSUB {NSUB} x NCH {NCH} chunks of (32, 128) a grid step; jax = "
          f"marginal over grid reps {SIZES['jax']}, step = one grid step, 32 CTAs (i, j: 16 "
          f"of two sub-blocks), one an SM, marginal over passes {SIZES['step']})")
    for label, geo in res["bodies"].items():
        j, s = geo["jax"], geo["step"]
        bms, by = bound_ms(work(label, x, REP), mhz, sms)
        fp32 = sass[label].get("fp32_per_pair")
        name = REDESIGNS[label][2] if label in REDESIGNS else BODIES[label].name
        if label in REDESIGNS:
            name += f" ({res['bodies'][base(label)]['jax']['ms'][1] / j['ms'][1]:.3f}x)"
        print(f"  {label}) {name:20s}: jax {j['ms_per_gridstep']:7.4f} "
              f"ms/gridstep-eq {j['ns_per_chunk']:7.3f} ns/chunk "
              f"[{j['pairs_per_s'] / 1e9:7.1f} Gpair/s = {j['pairs_per_s'] / body_rate:.3f} of "
              f"the λ body, {j['pairs_per_s'] / LAMBDA2_SLAB_PAIRS_PER_S:.3f} of λ2]; step "
              f"{s['ns_per_chunk']:7.3f} ns/chunk [{s['pairs_per_s'] / 1e9:7.1f} Gpair/s on "
              f"{s['ctas']} SMs, {s['pairs_per_s'] / s['ctas'] / 1e9:5.2f} an SM]; "
              f"bound {bms:.4f} ms by {by} at {REP} reps"
              + (f"; {fp32:g} fp32 a pair" if fp32 else ""))
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "reps": reps,
                      "sass": sass, "parity": {k: e for k, (e, _) in parity.items()},
                      "float64": {k: e for k, (e, _) in f64.items()},
                      "readings": res, "launches": md.launches}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
