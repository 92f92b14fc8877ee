"""Count what a λ pair costs on the card in the two pair forms of the TPU tool.

    python -m pbf_sph_tpu_torch.tools.micro_chunk [reps]

Port of `tools/micro_chunk.py`.  `pbf_lambda` and `pbf_delta` sit near their
measured body ceilings (`anchor_rate`), so what is left is fewer
instructions a pair.  This tool gives the instructions a pair and the rate
of the TPU tool's two forms of the same λ pair body under its masks, with
the two hand-written kernels of `csrc/micro_chunk.cu`:

* `chunk_bench` (`make_bench(body, interleave)`): each slot (row a, lane j)
  of a (64, 128) output runs `nchunks` chunks, chunk c against column
  ((c mod 32) * 128 + j) of a (4, 4096) strip (x, y, z, cell), with the
  window test o + j in [13, 1e6) and the cell test |bcl - (acl + 3)| <= 1;
  body `old` (`chunk_old`: sqrt, divide, separate masks) or `new`
  (`chunk_new`: r2-space tests, fused masks, (h-r)^2/r = u*(h^2 + r^2) -
  2h with u = rsqrt(r^2)), `interleave` 1, 2 or 4 chunks a trip on separate
  carries (p6s, gx, gy, gz); the output is stream 0's four carries summed
  plus p6s + gx of every other stream, as the JAX kernel's;
* `chunk_fma` (`fma_ceiling(streams)`): 1, 2, 4 or 8 carries from x + s,
  c = c*1.000001 + x a trip, summed.

Each has a plain PyTorch version of the same signature (the chunk sums
chunk by chunk on (64, 128) carries, as Pallas does; the multiply-adds by
`torch.addcmul`, which fuses them as the kernels' FFMA and the interpreted
Pallas kernel do); `MicroChunk` holds the wrappers, which take the plain
version for a CPU tensor and the kernel for a CUDA one, and count launches.
A kernel runs `nblocks` CTAs of 1024 threads, 8 a (64, 128) copy: 8 is the
JAX tool's size (8 SMs), and the tool also fills the card.

The tool prints the card line; checks the SASS (cuobjdump: each pair body's
trip loop holds `interleave` pairs, one shared-memory float4 read a pair,
the same fp32 instructions a pair-slot at every interleave, no branch in
`new`, and in `old` only the guards of the IEEE sqrt's and divide's slow
paths, whose instructions it leaves out of the fast path it counts; each fma
loop its streams' FFMAs and nothing else in fp32); holds each kernel
against its plain version on the tool's inputs and on seeded ones; then
reads each body and the fma ceiling as the marginal between two sizes, with
CUDA events, at the JAX size and at the full card, beside the rate anchor's
λ body and fma rates and `pbf_lambda`'s fp32 instructions a pair, read in
the same run, while `nvidia-smi` samples the SM clock.  The last line is one
JSON object.  Without a CUDA device the tool fails.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.tools import anchor_rate as ar

SUB, WCOL = 64, 128          # the output tile (rows a, lanes j)
TILE = (SUB, WCOL)
STRIP_CHUNKS = 32            # chunks of the strip
NCOLS = STRIP_CHUNKS * WCOL  # 4096 columns
CTA = 1024                   # threads of a CTA: elements of an (8, 128) tile
COPY_BLOCKS = SUB * WCOL // CTA  # 8 CTAs a (64, 128) copy: the JAX size
CHUNKS = 4096                # the JAX tool's chunks a call
FMA_ITERS = 16384            # the JAX fma ceiling's trips
FMA_SCALE = 1.000001
# the JAX tool's constants (:40-42) and its body's run-time ones (:89-91);
# EPS2, HF2 and TWO_HF as the f32 products the JAX body computes
HH = float(np.float32(0.01))
HF = float(np.float32(0.1))
EPS = float(np.float32(1e-8))
EPS2 = float(np.float32(EPS) * np.float32(EPS))
HF2 = float(np.float32(HF) * np.float32(HF))
TWO_HF = float(np.float32(2.0) * np.float32(HF))
OFF, LO, HI = 3.0, 13, 1_000_000
SINK_MASK = 0                # the mask of the dropped carries' sink: 0, nothing stored
BODIES = ("old", "new")
BODY_ID = {"old": 0, "new": 1}
INTERLEAVES = (1, 2, 4)
STREAMS = (1, 2, 4, 8)
KERNELS = ("chunk_old", "chunk_new", "chunk_fma")
CHUNK_SIZES = (CHUNKS // 4, CHUNKS)      # the marginal's two sizes
FMA_SIZES = (FMA_ITERS // 4, FMA_ITERS)
PARITY_CHUNKS, PARITY_ITERS = 256, 1024  # the trips of a check on the card
COINCIDENT = 200             # strip columns 200-203 hold rows 0-3's positions
RTOL, ATOL = 1e-5, 1e-9      # chunk sums, kernel against plain (see card_parity)
# the SASS a pair-slot: MUFU ops (old: sqrt's and the divide's), and forward
# branches on the fast path (old: the guards of their slow paths)
WANT_MUFU = {"old": 2, "new": 1}
WANT_GUARDS = {"old": 2, "new": 0}
# the bound: lanes an SM a clock of fp32 issue and of the MUFU pipe on
# Hopper, and the published device-memory rate of one H100 SXM
FP32_LANES, MUFU_LANES = 128, 16
HBM_BYTES_PER_S = 3.35e12


# ---------------------------------------------------------------------------
# Inputs and plain PyTorch versions
# ---------------------------------------------------------------------------


def tool_inputs(device="cpu"):
    """The JAX tool's inputs (`:113-114`, `:141`): s (4, 4096) 0.05, rows
    (4, 64) 0.04, x (64, 128) ones.  Every pair is masked out: |0.05 - (0.04
    + 3)| > 1, so both bodies give 0."""
    return (torch.full((4, NCOLS), 0.05, device=device),
            torch.full((4, SUB), 0.04, device=device),
            torch.ones(TILE, device=device))


def random_inputs(seed: int, device="cpu"):
    """(s, rows) from `seed` where every mask splits: rows in [0.55, 0.56]^3
    with cells 0-4, candidates in [0.49, 0.55]^3 with cells 0-8 (r2 on both
    sides of h^2, most pairs well inside, the cell test both ways; dx, dy,
    dz >= 0, so no sum cancels), rows 0-3 at the corner (0.55, 0.55, 0.55)
    and columns COINCIDENT + a there with row a's adjacent cell (r2 = 0 <
    EPS^2), and the window cutting lanes 0-12 of chunk 0.  A slot meets 32
    columns: one whose few pairs all lay near r = h would hold new's
    u*(h^2 + r^2) - 2h, a difference of two ~0.2s, to a rounding far above
    1e-5 of its sum."""
    rng = np.random.default_rng(seed)
    rows = np.empty((4, SUB), np.float32)
    rows[:3] = rng.uniform(0.55, 0.56, (3, SUB))
    rows[3] = rng.integers(0, 5, SUB)
    s = np.empty((4, NCOLS), np.float32)
    s[:3] = rng.uniform(0.49, 0.55, (3, NCOLS))
    s[3] = rng.integers(0, 9, NCOLS)
    rows[:3, :4] = 0.55
    for a in range(4):
        s[:3, COINCIDENT + a] = rows[:3, a]
        s[3, COINCIDENT + a] = rows[3, a] + OFF
    return torch.from_numpy(s).to(device), torch.from_numpy(rows).to(device)


def _check_chunk(s, rows, body: str, interleave: int, nchunks: int) -> None:
    if body not in BODIES:
        raise ValueError(f"body {body!r} is not one of {BODIES}")
    if interleave not in INTERLEAVES:
        raise ValueError(f"interleave {interleave}: csrc/micro_chunk.cu instantiates "
                         f"{INTERLEAVES}")
    if nchunks < 0 or nchunks % interleave:
        raise ValueError(f"nchunks {nchunks} is not a multiple of interleave {interleave}")
    if tuple(s.shape) != (4, NCOLS) or tuple(rows.shape) != (4, SUB):
        raise ValueError(f"want s (4, {NCOLS}) and rows (4, {SUB}), got {tuple(s.shape)} "
                         f"and {tuple(rows.shape)}")


def _check_blocks(nblocks: int, least: int) -> None:
    if nblocks < least:
        raise ValueError(f"nblocks {nblocks} < {least}: the output needs them")


def pair_terms(s, rows, body: str):
    """(5, 64, 4096): p6, dx, dy, dz and sg of every pair (row a, column),
    by `chunk_old` or `chunk_new` (`tools/micro_chunk.py:45-80`); column
    o + j meets the window test as lane j of the chunk at o."""
    a = rows[:, :, None]
    b = s[:, None, :]
    g = torch.arange(NCOLS, device=s.device)
    win = (g >= LO) & (g < HI)
    adj = (b[3] - (a[3] + OFF)).abs() <= 1.0
    d = a[:3] - b[:3]
    r2 = torch.addcmul(torch.addcmul(d[0] * d[0], d[1], d[1]), d[2], d[2])  # fused, as nvcc
    if body == "old":
        m = win & adj
        p6 = torch.where(m & (r2 <= HH), (HH - r2) ** 3, 0.0)
        r = torch.sqrt(r2)
        ok = m & (r >= EPS) & (r <= HF)
        rs = torch.where(ok, r, 1.0)
        sg = torch.where(ok, (HF - rs) ** 2 / rs, 0.0)
    else:
        q = win & adj & (r2 <= HH)
        t = torch.where(q, HH - r2, 0.0)
        p6 = t * t * t
        ok = q & (r2 >= EPS2)
        u = torch.rsqrt(torch.where(ok, r2, 1.0))
        # fused, as the kernel's FFMA: near r = h sg is the difference of
        # two ~2h, and its rounding shows
        sg = torch.where(ok, torch.addcmul(torch.full_like(u, -TWO_HF), u, HF2 + r2), 0.0)
    return torch.stack([p6, d[0], d[1], d[2], sg])


def chunk_trips(interleave: int, nchunks: int):
    """The strip chunk of each stream at each trip: (nchunks / interleave,
    interleave) int64, chunk (i*interleave + k) mod 32 (`:97`)."""
    c = torch.arange(nchunks, dtype=torch.int64).reshape(-1, interleave)
    return c % STRIP_CHUNKS


def chunk_plain(s, rows, body: str, interleave: int, nchunks: int = CHUNKS,
                nblocks: int = COPY_BLOCKS):
    """(64, 128) of `make_bench(body, interleave)`: the pair terms of the 32
    strip chunks, then the carries chunk by chunk as Pallas sums them (p6s +=
    p6; g += d * sg, fused); every one of the nblocks / 8 copies gives the
    same."""
    _check_chunk(s, rows, body, interleave, nchunks)
    _check_blocks(nblocks, COPY_BLOCKS)
    terms = pair_terms(s, rows, body).reshape(5, SUB, STRIP_CHUNKS, WCOL)
    terms = terms.permute(2, 0, 1, 3).contiguous()  # (32, 5, 64, 128)
    carry = s.new_zeros((interleave, 4, SUB, WCOL))
    period = STRIP_CHUNKS // interleave   # the trips after which the chunks repeat
    ids = chunk_trips(interleave, period * interleave).to(s.device)
    for i in range(nchunks // interleave):
        t = terms[ids[i % period]]        # (interleave, 5, 64, 128)
        carry[:, 0] += t[:, 0]
        carry[:, 1:].addcmul_(t[:, 1:4], t[:, 4:5])
    acc = carry[0, 0] + carry[0, 1] + carry[0, 2] + carry[0, 3]
    for k in range(1, interleave):
        acc = acc + carry[k, 0] + carry[k, 1]
    return acc


def fma_carries_plain(x, k: int, niter: int):
    """The sum of k carries from x + s after niter trips of c = c*1.000001 +
    x: one `torch.addcmul` a trip on the (k, *x.shape) carries, fused as the
    kernels' FFMA (and XLA on the CPU) round it once."""
    c = x + torch.arange(k, dtype=x.dtype, device=x.device).reshape(-1, *[1] * x.dim())
    scale = torch.tensor(FMA_SCALE, dtype=x.dtype, device=x.device)
    for _ in range(niter):
        c = torch.addcmul(x, c, scale)
    acc = c[0]
    for q in range(1, k):
        acc = acc + c[q]
    return acc


def _check_fma(x, streams: int) -> None:
    if streams not in STREAMS:
        raise ValueError(f"streams {streams}: csrc/micro_chunk.cu instantiates {STREAMS}")
    if tuple(x.shape) != TILE:
        raise ValueError(f"x: want {TILE}, got {tuple(x.shape)}")


def fma_plain(x, streams: int, niter: int = FMA_ITERS, nblocks: int = COPY_BLOCKS):
    """(64, 128) of `fma_ceiling(streams)` at `niter` trips."""
    _check_fma(x, streams)
    _check_blocks(nblocks, COPY_BLOCKS)
    return fma_carries_plain(x, streams, niter)


# ---------------------------------------------------------------------------
# CUDA kernel launchers
# ---------------------------------------------------------------------------


def _launch(name: str, dev, nblocks: int, *args):
    out = torch.empty(nblocks * CTA, dtype=torch.float32, device=dev)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*args, nblocks, out.data_ptr(), ph._stream(dev))
    cuda_build.check(name, err)
    return out


def fill_blocks(device, kernel: str, body: str = "new", interleave: int = 1) -> int:
    """CTAs that fill every SM of the card at the kernel's occupancy:
    kernel "bench" (body, interleave) or "fma" (streams in `interleave`)."""
    lib = cuda_build.library()
    with torch.cuda.device(device):
        n = lib.micro_chunk_fill({"bench": 0, "fma": 1}[kernel], BODY_ID.get(body, -1),
                                 interleave)
    if n <= 0:
        raise ValueError(f"csrc/micro_chunk.cu has no {kernel} kernel for body {body}, "
                         f"{interleave}")
    return n


def chunk_kernel(s, rows, body: str, interleave: int, nchunks: int = CHUNKS,
                 nblocks: int = COPY_BLOCKS):
    """(64, 128) from `chunk_bench` (replaces `make_bench`'s kernel) over
    nblocks CTAs of 1024 threads, 8 a copy; the first copy."""
    _check_chunk(s, rows, body, interleave, nchunks)
    _check_blocks(nblocks, COPY_BLOCKS)
    dev = ar._check_card(s=(s, torch.float32, (4, NCOLS)), rows=(rows, torch.float32, (4, SUB)))
    out = _launch("chunk_bench", dev, nblocks, s.data_ptr(), rows.data_ptr(), BODY_ID[body],
                  interleave, OFF, LO, HI, nchunks, HH, HF, EPS, EPS2, HF2, TWO_HF, SINK_MASK)
    return out[:SUB * WCOL].view(TILE)


def fma_kernel(x, streams: int, niter: int = FMA_ITERS, nblocks: int = COPY_BLOCKS):
    """(64, 128) from `chunk_fma` (replaces `fma_ceiling`'s kernel)."""
    _check_fma(x, streams)
    _check_blocks(nblocks, COPY_BLOCKS)
    dev = ar._check_card(x=(x, torch.float32, TILE))
    out = _launch("chunk_fma", dev, nblocks, x.data_ptr(), streams, niter)
    return out[:SUB * WCOL].view(TILE)


class MicroChunk:
    """The two wrappers, with a launch counter per kernel name: `launches`
    ("chunk_old", "chunk_new" for `chunk_bench`'s two bodies, "chunk_fma")
    starts at 0 and grows by one each time a wrapper launches its CUDA
    kernel, and at no other time.  A CPU tensor takes the plain version,
    where nblocks means nothing."""

    def __init__(self):
        self.launches = dict.fromkeys(KERNELS, 0)

    def chunk(self, s, rows, body: str, interleave: int, nchunks: int = CHUNKS,
              nblocks: int = COPY_BLOCKS):
        if s.device.type == "cpu":
            return chunk_plain(s, rows, body, interleave, nchunks, nblocks)
        out = chunk_kernel(s, rows, body, interleave, nchunks, nblocks)
        self.launches[f"chunk_{body}"] += 1
        return out

    def fma(self, x, streams: int, niter: int = FMA_ITERS, nblocks: int = COPY_BLOCKS):
        if x.device.type == "cpu":
            return fma_plain(x, streams, niter, nblocks)
        out = fma_kernel(x, streams, niter, nblocks)
        self.launches["chunk_fma"] += 1
        return out


# ---------------------------------------------------------------------------
# The SASS of the built kernels
# ---------------------------------------------------------------------------


def chunk_pattern(body: str, interleave: int) -> str:
    return f"18chunk_bench_kernelILi{BODY_ID[body]}ELi{interleave}E"


def fma_pattern(streams: int) -> str:
    return f"16chunk_fma_kernelILi{streams}E"


def _is_control(op: str) -> bool:
    return op.startswith("BRA") or op.startswith("CALL")


def fast_path(sass: ar.Sass, span: Tuple[int, int]) -> Tuple[List[str], int]:
    """(opcodes, guards) of a loop's fast path: its instructions in order,
    less each block that a forward branch on the path jumps over inside the
    loop (the call of a slow path); guards = the forward branches and calls
    on the path (the back edge not counted)."""
    insts, labels = sass
    lo, hi = span
    path, guards, skip_to = [], 0, -1
    for addr, op, inst in insts:
        if not lo <= addr <= hi or addr < skip_to:
            continue
        path.append(op)
        if addr < hi and _is_control(op):
            guards += 1
            target = ar.branch_target(inst, labels)
            if op.startswith("BRA") and target is not None and addr < target <= hi:
                skip_to = target
    return path, guards


def _counts(opcodes: List[str]) -> collections.Counter:
    return collections.Counter(ar._opcode_key(op) for op in opcodes)


def _lds128(c: collections.Counter) -> int:
    return sum(v for k, v in c.items() if k.startswith("LDS") and "128" in k)


def _mufu(c: collections.Counter) -> int:
    return sum(v for k, v in c.items() if k.startswith("MUFU"))


def _fp32(c: collections.Counter) -> int:
    return sum(c[k] for k in ar.FP32_OPCODES)


def pair_body(sass: ar.Sass) -> dict:
    """The pair loop of a chunk_bench instantiation, the innermost loop with
    the most shared-memory float4 reads (one a pair): pairs a trip and, a
    pair-slot, the fast path's fp32, MUFU and all instructions and guards."""
    spans = ar.innermost_spans(sass)
    best = max(spans, key=lambda s: _lds128(_counts(fast_path(sass, s)[0])), default=None)
    if best is None:
        return dict(pairs_a_loop=0)
    path, guards = fast_path(sass, best)
    c = _counts(path)
    pairs = max(_lds128(c), 1)
    return dict(pairs_a_loop=_lds128(c), fp32_per_pair=_fp32(c) / pairs,
                mufu_per_pair=_mufu(c) / pairs, insts_per_pair=len(path) / pairs,
                guards_per_pair=guards / pairs,
                opcodes={k: v / pairs for k, v in sorted(c.items())})


def fma_loop(sass: ar.Sass, want_ffma: int) -> dict:
    """The trip loop of an fma kernel, the innermost loop with FFMAs: FFMAs
    and all instructions a trip (the loop unrolled t times holds t trips);
    ok if it holds want_ffma FFMAs a trip and no other fp32 instruction."""
    loops = [c for c in ar.innermost_loops(sass) if c["FFMA"]]
    if not loops:
        return dict(ok=False, trips_a_loop=0)
    c = loops[0]
    trips = c["FFMA"] // want_ffma
    ok = (len(loops) == 1 and trips >= 1 and c["FFMA"] == want_ffma * trips
          and _fp32(c) == c["FFMA"])
    return dict(ok=ok, trips_a_loop=trips, ffma_per_trip=c["FFMA"] / max(trips, 1),
                insts_per_trip=sum(c.values()) / max(trips, 1),
                own_per_trip=(sum(c.values()) - c["FFMA"]) / max(trips, 1))


def check_sass(lib_path) -> Dict[str, dict]:
    """`check_funcs` of the built library."""
    return check_funcs(ar.sass_functions(lib_path))


def check_funcs(funcs) -> Dict[str, dict]:
    """name -> dict(ok, counts): each pair body's trip loop holds
    `interleave` pairs, WANT_MUFU MUFU ops and WANT_GUARDS forward branches a
    pair-slot (new: branch-free; old: the guards of its sqrt and divide slow
    paths) and, at every interleave, the fp32 instructions a pair-slot of
    interleave 1; each fma loop its streams' FFMAs and no other fp32
    instruction a trip.  "pbf_lambda" gives the phase kernel's fp32
    instructions a pair, beside which the bodies are read."""
    report = {}
    for body in BODIES:
        first = None
        for il in INTERLEAVES:
            r = pair_body(ar._one(funcs, chunk_pattern(body, il)))
            if first is None:
                first = r.get("fp32_per_pair")
            r["ok"] = (r["pairs_a_loop"] == il and r["mufu_per_pair"] == WANT_MUFU[body]
                       and r["guards_per_pair"] == WANT_GUARDS[body]
                       and r["fp32_per_pair"] == first)
            report[f"{body} x{il}"] = r
    for streams in STREAMS:
        report[f"fma {streams}"] = fma_loop(ar._one(funcs, fma_pattern(streams)), streams)
    phase = ar.fp32_per_pair(ar.pair_loop(ar._one(funcs, ar.PHASE_KERNELS["lambda"])))
    report["pbf_lambda"] = dict(ok=bool(phase), fp32_per_pair=sum(phase.values()))
    return report


def short(report: Dict[str, dict]) -> List[str]:
    return [name for name, r in report.items() if not r["ok"]]


# ---------------------------------------------------------------------------
# Parity, the bound and the readings
# ---------------------------------------------------------------------------


def card_parity(device, seed: int = 0) -> Dict[str, Tuple[float, bool]]:
    """Each kernel against its plain version on the card, its launches not
    counted; label -> (max abs err, within tolerance).  Every body and
    interleave at PARITY_CHUNKS chunks on the tool's inputs (both exactly 0)
    and `random_inputs` over 2 copies: rtol 1e-5, atol 1e-9 (sums of
    non-negative fp32 terms in the kernel's fused order against torch's);
    every fma width at PARITY_ITERS trips, rtol 1e-6 (both fuse each
    multiply-add)."""
    res = {}
    s0, rows0, x = tool_inputs(device)
    cases = {"tool": (s0, rows0), "random": random_inputs(seed, device)}
    for case, (s, rows) in cases.items():
        for body in BODIES:
            for il in INTERLEAVES:
                got = chunk_kernel(s, rows, body, il, PARITY_CHUNKS, 2 * COPY_BLOCKS)
                want = chunk_plain(s, rows, body, il, PARITY_CHUNKS)
                ok = torch.allclose(got, want, rtol=RTOL, atol=ATOL)
                if case == "tool":
                    ok = ok and not bool(got.any())
                res[f"{body} x{il} {case}"] = (float((got - want).abs().max()), ok)
    for streams in STREAMS:
        got = fma_kernel(x, streams, PARITY_ITERS, 2 * COPY_BLOCKS)
        want = fma_plain(x, streams, PARITY_ITERS)
        res[f"fma {streams}"] = (float((got - want).abs().max()),
                                 torch.allclose(got, want, rtol=1e-6, atol=0.0))
    return res


def sm_clock_mhz(summary: Optional[dict], device) -> float:
    """The median SM clock sampled beside a reading; without a sample, the
    card's maximum SM clock (`nvidia-smi`)."""
    if summary:
        return float(summary["median"])
    index = torch.device(device).index or 0
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits", "-i", str(index)],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def issue_bound_ms(fp32_lanes: float, mufu_lanes: float, nbytes: int, mhz: float,
                   sms: int) -> Tuple[float, str]:
    """(ms, by): the least time the card could take, the larger of the
    bytes over the device memory rate and the operations' time: the fp32
    and MUFU instruction lanes over the issue rate (sms x 128 lanes x the SM
    clock), or the MUFU lanes over the MUFU pipe's (sms x 16 x it), which
    runs beside the fp32 issue, whichever is longer."""
    hz = mhz * 1e6
    t_ops = max((fp32_lanes + mufu_lanes) / (sms * FP32_LANES * hz),
                mufu_lanes / (sms * MUFU_LANES * hz))
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def anchor_fma(anchor: ar.Anchor, device, reps: int, serial: bool = False) -> dict:
    """The rate anchor's fma reading through `anchor`: 16 streams x 16
    rounds with the card filled (rate in FFMA/s), or the serial chain on one
    warp an SM (ns a dependent FFMA)."""
    x = torch.full(ar.TILE, 1.0000001, device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ns, sizes = (1, ar.SERIAL_ITERS) if serial else (16, ar.FP32_ITERS)
    n = 32 * sms if serial else ar.fill_threads(device, "issue", "fma", 16, 16)
    dt, t_lo, t_hi = ar.marginal(lambda it: anchor.issue(x, "fma", ns, 16, it, n), sizes, reps)
    steps = (sizes[1] - sizes[0]) * 16
    return dict(threads=n, iters=list(sizes), ms=[t_lo, t_hi], rate=steps * n * ns / dt,
                ns_per_op=dt * 1e9 / steps)


def geometries(device, kernel: str, body: str = "new", interleave: int = 1) -> Dict[str, int]:
    """nblocks of the two readings: the JAX size (one copy) and the card
    filled."""
    return {"jax": COPY_BLOCKS, "card": fill_blocks(device, kernel, body, interleave)}


def read_chunk(mc: MicroChunk, body: str, interleave: int, nblocks: int, inputs,
               reps: int) -> dict:
    """One body's reading through `mc` at nblocks: the marginal between
    CHUNK_SIZES, ns a (64, 128) chunk of one copy, ps and G pair-slots a
    second over the grid."""
    s, rows, _ = inputs
    dt, t_lo, t_hi = ar.marginal(
        lambda n: mc.chunk(s, rows, body, interleave, n, nblocks), CHUNK_SIZES, reps)
    dch = CHUNK_SIZES[1] - CHUNK_SIZES[0]
    slots = dch * nblocks * CTA
    return dict(nblocks=nblocks, chunks=list(CHUNK_SIZES), ms=[t_lo, t_hi],
                ns_per_chunk=dt * 1e9 / (dch * nblocks / COPY_BLOCKS),
                ps_per_pair_slot=dt * 1e12 / slots, pair_slots_per_s=slots / dt)


def read_fma(mc: MicroChunk, streams: int, nblocks: int, inputs, reps: int) -> dict:
    """The fma ceiling at `streams` through `mc` at nblocks: the marginal
    between FMA_SIZES, ns a (64, 128) fma of one copy and FFMA/s."""
    x = inputs[2]
    dt, t_lo, t_hi = ar.marginal(lambda n: mc.fma(x, streams, n, nblocks), FMA_SIZES, reps)
    dit = FMA_SIZES[1] - FMA_SIZES[0]
    return dict(nblocks=nblocks, iters=list(FMA_SIZES), ms=[t_lo, t_hi],
                ns_per_fma=dt * 1e9 / (dit * streams * nblocks / COPY_BLOCKS),
                ffma_per_s=dit * streams * nblocks * CTA / dt)


def read_all(mc: MicroChunk, device, reps: int) -> dict:
    """Every reading of the tool, through `mc` (counted) at the tool's
    inputs, and the rate anchor's λ body and fma rates beside them, with
    the SM clock sampled."""
    inputs = tool_inputs(device)
    anchor = ar.Anchor()
    res = {"bodies": {}, "fma": {}}
    with ar.ClockSampler(device) as clock:
        for body in BODIES:
            for il in INTERLEAVES:
                res["bodies"][f"{body} x{il}"] = {
                    geo: read_chunk(mc, body, il, nb, inputs, reps)
                    for geo, nb in geometries(device, "bench", body, il).items()}
        for streams in STREAMS:
            res["fma"][streams] = {
                geo: read_fma(mc, streams, nb, inputs, reps)
                for geo, nb in geometries(device, "fma", interleave=streams).items()}
        res["anchor_fma"] = anchor_fma(anchor, device, reps)
        res["anchor_lambda_body"] = ar.body_rate(anchor, "lambda", reps, device)
    res["clocks_sm_mhz"] = clock.summary()
    return res


def main(argv=None) -> int:
    from pbf_sph_tpu_torch.tools.bench_kernel_variants import card_line

    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 10
    if not torch.cuda.is_available():
        raise SystemExit("micro_chunk: needs a CUDA device")
    card = card_line()
    print(card)
    device = torch.device("cuda", torch.cuda.current_device())

    print("== SASS of csrc/micro_chunk.cu (cuobjdump)")
    cuda_build.library()
    sass = check_sass(cuda_build.library_path())
    for name, r in sass.items():
        print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in r.items() if k != "opcodes"))
    if short(sass):
        raise SystemExit(f"micro_chunk: the SASS of {short(sass)} is off: the compiler "
                         f"folded or branched around what is measured, so no rate is printed")
    parity = card_parity(device)
    print("== each kernel against its plain version: " + ", ".join(
        f"{k} {e:.3e}" for k, (e, _) in parity.items()))
    wrong = [k for k, (_, ok) in parity.items() if not ok]
    if wrong:
        raise SystemExit(f"micro_chunk: {wrong} disagree with their plain versions")

    mc = MicroChunk()
    res = read_all(mc, device, reps)
    fma_rate = res["anchor_fma"]["rate"]
    body_rate = res["anchor_lambda_body"]["rate"]
    lam = sass["pbf_lambda"]["fp32_per_pair"]
    print(f"== SM clock beside the readings (nvidia-smi, MHz): {res['clocks_sm_mhz']}; the "
          f"rate anchor: fma {fma_rate / 1e12:.3f} T FFMA/s, λ body "
          f"{body_rate / 1e9:.1f} G pair-slots/s, pbf_lambda {lam:g} fp32 instructions a pair")
    print("== fma ceiling ((64,128) op = 8 CTAs of 1024 lanes; jax = one copy on 8 SMs, "
          "card = the card filled)")
    for streams, geo in res["fma"].items():
        j, c = geo["jax"], geo["card"]
        print(f"  streams={streams}: jax {j['ns_per_fma']:7.3f} ns per (64,128) fma, "
              f"{j['ffma_per_s'] / 1e12:.3f} T FFMA/s; card ({c['nblocks']} CTAs) "
              f"{c['ffma_per_s'] / 1e12:.3f} T FFMA/s = {c['ffma_per_s'] / fma_rate:.3f} of "
              f"the anchor's fma")
    print(f"== λ chunk bodies ({CHUNKS} chunks of (64,128), marginal between {CHUNK_SIZES})")
    for name, geo in res["bodies"].items():
        j, c = geo["jax"], geo["card"]
        s = sass[name]
        print(f"  {name:6s}: jax {j['ms'][1]:7.3f} ms -> {j['ns_per_chunk']:7.1f} ns/chunk "
              f"({j['ps_per_pair_slot']:.3f} ps/pairslot), card ({c['nblocks']} CTAs) "
              f"{c['pair_slots_per_s'] / 1e9:.1f} G pair-slots/s = "
              f"{c['pair_slots_per_s'] / body_rate:.3f} of the λ body; "
              f"{s['fp32_per_pair']:g} fp32, {s['mufu_per_pair']:g} MUFU, "
              f"{s['insts_per_pair']:g} instructions a pair-slot (pbf_lambda {lam:g} fp32)")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "reps": reps,
                      "sass": sass, "parity": {k: e for k, (e, _) in parity.items()},
                      "readings": res, "launches": mc.launches}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
