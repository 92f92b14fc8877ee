"""Price the compaction's building blocks on the card: lane rolls, the
unaligned part body, a 4-chunk dense λ, and the roll, unaligned-slice and
unaligned-copy probes.

    python -m pbf_sph_tpu_torch.tools.micro_roll [reps]

Port of `tools/micro_roll.py` (its `run`, row 7.19) and of three probes of
`tools/micro_vpu.py` (rows 7.13-7.15), with the kernels of
`csrc/micro_roll.cu`:

* `roll_lanes` (a `k_dyn`, b `k_sta`): 8 rows of 128 rolled N times, by
  s[i mod 64] (a) or 37 (b), + 0.0 a trip; out = the rows' sum on every row;
* `roll_part` (c `k_static`, d `k_fori`, e `k_nested`): the v2 compaction's
  `part_body` over 16 parts (s0, dst, len) of a (4, 4096) strip into a
  (4, 512) output, unrolled x16, in a loop of 16, or 9 x 2 nested over parts
  (iv + ci) mod 16, in two bodies: `shuffle` (two aligned float4 windows,
  realigned by warp shuffles: what the TPU tool measures) and `direct`
  (unaligned 32-bit loads);
* `roll_part_blocked`: the same six, laid out for Hopper: a warp per copy,
  field and chunk that some part writes, the chunk held in registers from
  one load to one store, lane l on columns l + 32k (shuffle: the two aligned
  windows in 8 loads rolled by 4 shuffles; direct: 4 loads of AB[r + j]);
* `roll_lam` (f `k_lam`): micro_dense's chunk_math over 4 chunks of 128 for
  32 rows, v = Σp6 + Σgx + Σgy + Σgz a row, added REP times;
* `vpu_rot` (`rot_kernel`): roll(x, s, 1) on (8, 128), s read from memory;
* `vpu_unal` (`unal_kernel`): x[:, o:o+128] of (8, 512), 32-bit loads;
* `vpu_dma` (`dma_kernel`): the same slice landed in shared memory by
  4-byte cp.async copies completed on an mbarrier, then stored.

Each has a plain PyTorch version of the same signature; `MicroRoll` holds
the wrappers, which take the plain version for a CPU tensor and the kernel
for a CUDA one, and count launches.  The part output starts as NaN in both
(the TPU kernels never write the columns no part covers; interpret mode
leaves NaN there), so kernel, plain version and interpreted Pallas kernel
agree bit for bit, NaN included.  The meta table is a CPU tensor, as the
TPU's SMEM table is scalar memory: the launcher checks it and passes it by
value.  The TPU kernels' REP loop rewrites one output (c-e) or adds one pure
value (f); on the card REP copies are the grid (c-e, CTA r owns copy r, or
for the blocked kernel one CTA a copy and written chunk) and
passes of one CTA (c-f, read at a run-time stride of 0, so none can be
hoisted; f's acc adds each pass's v in the tool's order).

pltpu.roll takes any int32 shift, mod 128 (interpret mode: 128 gives 0,
-1 gives 127), and so do the port's rolls; the slices take o in [0, 384]
(interpret mode refuses the rest as an out-of-bounds read), and the port
refuses the rest.

The tool prints the card line; checks the SASS (cuobjdump: a)/b) 32 SHFL a
trip, 4 a roll, and whether the 32 + 0.0 adds survive; vpu_rot 32 SHFL; each
part body's loop its parts' float4 stores, shuffle 16 SHFL a part, direct 16
32-bit loads a part; each blocked body's loop no store, shuffle 4 SHFL and 8
32-bit loads a visit, direct 4 32-bit loads; no local memory; f) 16 pairs a
pass with `pbf_lambda`'s fp32 instructions a pair, opcode by opcode, beside
the pass's reduction; vpu_unal 32-bit loads, vpu_dma cp.async copies and a
barrier wait); holds each kernel against its plain version on the tool's
inputs and on seeded ones (bit for bit, but f at rtol 1e-5; the blocked part
kernels also against roll_part); then reads a)/b) and the part bodies as the
marginal between two trip or pass counts (CUDA events) for one copy (the
TPU's sequence), at the JAX call's 512 copies (the part bodies) and with the
card filled, f) beside micro_dense's c) in the same run, and rows
7.13-7.15 by CUDA events and a CUDA graph of 100 launches, beside
torch.roll and x[:, o:o+128].contiguous(), while `nvidia-smi` samples the
SM clock.  The last line is one JSON object.
Without a CUDA device the tool fails.
"""

from __future__ import annotations

import collections
import json
import sys
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.tools import anchor_rate as ar
from pbf_sph_tpu_torch.tools import micro_chunk as mch
from pbf_sph_tpu_torch.tools import micro_dense as md

# the TPU tools' constants: micro_roll.py :18-19, :80-89, :111, :146-153;
# micro_vpu.py's probes :117-169
W = 128
ROWS = 8
N = 8192
NSHIFT = 64
STATIC_SHIFT = 37
SM = 4096
FIELDS = 4
NPART = 16
OUT_COLS = 512
PART_LEN = 90
REP = 512
NIV, NCI = 9, 2
LAM_ROWS, LAM_CANDS, LAM_ROW_W = 32, 512, 8
HH, HF, EPS2 = md.HH, md.HF, md.EPS2
VPU_COLS = 512
MAX_OFFSET = VPU_COLS - W
TOOL_SHIFT, TOOL_OFFSET = 5, 37
PASS_STRIDE = 0              # pass p reads its inputs at p * PASS_STRIDE
# the seeded shifts and offsets every check runs
SEEDED_SHIFTS = (0, 1, 31, 32, 33, 64, 127)
WRAPPED_SHIFTS = (128, 300, -1, -5, -128, -129)   # taken mod 128, as pltpu.roll
SEEDED_OFFSETS = (0, 1, 37, 383, 384)

LANES = ("a", "b")
PARTS = ("c", "d", "e")
PART_BODIES = ("shuffle", "direct")
LOOP_ID = {"c": 0, "d": 1, "e": 2}
BODY_ID = {"shuffle": 0, "direct": 1}
NAMES = {"a": "dynamic roll x8", "b": "static roll x8", "c": "static x16 parts",
         "d": "fori x16 parts", "e": "nested fori 9x2", "f": "dense lambda 4 chunks"}
KERNELS = ("roll_lanes", "roll_part_shuffle", "roll_part_direct", "roll_part_blocked_shuffle",
           "roll_part_blocked_direct", "roll_lam", "vpu_rot", "vpu_unal", "vpu_dma")
VPU = ("vpu_rot", "vpu_unal", "vpu_dma")

# the readings: the marginal's two sizes (trips of a/b, passes of c-f)
TRIPS = (N // 4, N)
PASSES = (16, 64)
LAM_PASSES = (REP // 4, REP)
PARITY_REPS = 2
# f) against its plain version: rtol, and atol as a share of max|value|
RTOL, ATOL_SHARE = 1e-5, 1e-5
# the bound's rates an SM a clock on Hopper: a warp shuffle (32 results a
# clock: the CUDA C++ Programming Guide's arithmetic-instruction throughput
# table, compute capability 9.0), and 32-bit loads and stores through the
# L1 (its 32 banks of 4 bytes a clock: the same guide, shared memory of
# compute capability 9.0); device memory at 3.35 TB/s (H100 SXM data sheet)
SHFL_WARPS_PER_CLK = 1
LSU_LANES_PER_CLK = 32
HBM_BYTES_PER_S = mch.HBM_BYTES_PER_S
# f)'s reduction a pass, beside its 16 pairs a lane: 4 warp sums of 5
# shuffle-adds, 3 adds to v and the add to acc
LAM_REDUCE = {"FADD": 24, "SHFL": 20}
LAM_PAIRS_A_PASS = LAM_CANDS // 32


class LanesInputs(NamedTuple):
    x: torch.Tensor          # (8, 128)
    shifts: torch.Tensor     # (64,) int32: a)'s table


class PartInputs(NamedTuple):
    strips: torch.Tensor     # (4, 4096)
    meta: torch.Tensor       # (16, 3) int32 (s0, dst, len), on the CPU


class LamInputs(NamedTuple):
    rows: torch.Tensor       # (32, 8): x, y, z in columns 0-2
    cands: torch.Tensor      # (4, 512): x, y, z in rows 0-2


class VpuInputs(NamedTuple):
    tile: torch.Tensor       # (8, 128): rot's x
    wide: torch.Tensor       # (8, 512): the slices' x
    shift: torch.Tensor      # (1,) int32 on the tile's device
    offset: int


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def _f32(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _i32(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def lanes_inputs(device="cpu") -> LanesInputs:
    """a)/b)'s inputs (`:52-53`): x = arange(1024) as (8, 128), shifts
    arange(64) % 127 + 1."""
    return LanesInputs(_f32(np.arange(ROWS * W).reshape(ROWS, W), device),
                       _i32(np.arange(NSHIFT) % 127 + 1, device))


def random_lanes_inputs(seed: int, device="cpu") -> LanesInputs:
    """Normal x and a shift table that starts with SEEDED_SHIFTS and
    WRAPPED_SHIFTS, the rest in [-300, 300]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ROWS, W)).astype(np.float32)
    shifts = rng.integers(-300, 301, NSHIFT)
    fixed = SEEDED_SHIFTS + WRAPPED_SHIFTS
    shifts[:len(fixed)] = fixed
    return LanesInputs(_f32(x, device), _i32(shifts, device))


def tool_meta() -> np.ndarray:
    """(16, 3) of `:82-86`: s0 = 517p mod (SM - 256), dst = 97p mod 384,
    len 90."""
    p = np.arange(NPART)
    return np.stack([(p * 517) % (SM - 256), (p * 97) % 384, np.full(NPART, PART_LEN)],
                    1).astype(np.int32)


def part_inputs(device="cpu") -> PartInputs:
    """c)-e)'s inputs (`:80-89`): strips arange(4 * 4096) as (4, 4096)."""
    return PartInputs(_f32(np.arange(FIELDS * SM).reshape(FIELDS, SM), device),
                      torch.from_numpy(tool_meta()))


def random_meta(rng) -> np.ndarray:
    """Meta that reaches what the tool's never does: parts 0-2 and 15 start
    in the last window with r > 0 (the bb clamp: B is A), part 15 as the last
    writer of chunk 3's tail, where the wrapped lanes land; part 3 starts at
    SM - 128 (r 0); parts 4-7 cross their chunk's end (dst mod 128 + len >
    128); parts 8/9 and 10/11 overlap in chunks 2 and 1, in both orders;
    part 12 is empty; parts 13-14 lie in chunk 0; the rest is drawn."""
    s0 = rng.integers(0, SM, NPART)
    dst = rng.integers(0, OUT_COLS, NPART)
    ln = rng.integers(0, W + 1, NPART)
    s0[[0, 1, 2, 15]] = SM - W + rng.integers(1, W, 4)
    s0[3] = SM - W
    dst[4:8] = W * np.arange(4) + rng.integers(60, W, 4)
    ln[4:8] = rng.integers(80, W + 1, 4)
    dst[8], ln[8], dst[9], ln[9] = 2 * W + 10, 70, 2 * W + 40, 60
    dst[10], ln[10], dst[11], ln[11] = W + 50, 60, W + 5, 70
    ln[12] = 0
    dst[13:15] = rng.integers(0, 60, 2)
    dst[15], ln[15] = 3 * W + 40, 88
    return np.stack([s0, dst, ln], 1).astype(np.int32)


def random_part_inputs(seed: int, device="cpu") -> PartInputs:
    rng = np.random.default_rng(seed)
    strips = rng.uniform(-1, 1, (FIELDS, SM)).astype(np.float32)
    return PartInputs(_f32(strips, device), torch.from_numpy(random_meta(rng)))


def lam_inputs(device="cpu") -> LamInputs:
    """f)'s inputs (`:147-148`): rows 0.03, cands 0.05: every pair alike."""
    return LamInputs(torch.full((LAM_ROWS, LAM_ROW_W), 0.03, device=device),
                     torch.full((4, LAM_CANDS), 0.05, device=device))


def random_lam_inputs(seed: int, device="cpu") -> LamInputs:
    """Rows within 0.03 and candidates within 0.06 of (1, 1, 1)/sqrt(3), so
    some pairs lie inside h = 0.1 and some outside; candidate 5 on row 0
    (r2 = 0 < eps2, the clamp)."""
    rng = np.random.default_rng(seed)
    p = np.float32(1.0 / np.sqrt(3.0))
    rows = rng.uniform(0, 1, (LAM_ROWS, LAM_ROW_W)).astype(np.float32)
    rows[:, :3] = p + rng.uniform(-0.03, 0.03, (LAM_ROWS, 3))
    cands = rng.uniform(0, 1, (4, LAM_CANDS)).astype(np.float32)
    cands[:3] = p + rng.uniform(-0.06, 0.06, (3, LAM_CANDS))
    cands[:3, 5] = rows[0, :3]
    return LamInputs(_f32(rows, device), _f32(cands, device))


def vpu_inputs(device="cpu") -> VpuInputs:
    """The probes' inputs (`micro_vpu.py:125-126`, `:146-147`, `:173-174`):
    arange as (8, 128) and (8, 512), s = 5, o = 37."""
    return VpuInputs(_f32(np.arange(ROWS * W).reshape(ROWS, W), device),
                     _f32(np.arange(ROWS * VPU_COLS).reshape(ROWS, VPU_COLS), device),
                     _i32([TOOL_SHIFT], device), TOOL_OFFSET)


def random_vpu_inputs(seed: int, shift: int, offset: int, device="cpu") -> VpuInputs:
    rng = np.random.default_rng(seed)
    return VpuInputs(_f32(rng.standard_normal((ROWS, W)), device),
                     _f32(rng.standard_normal((ROWS, VPU_COLS)), device),
                     _i32([shift], device), offset)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _check_lanes(label: str, x: LanesInputs, ntrips: int, ncopies: int) -> None:
    if label not in LANES:
        raise ValueError(f"roll body {label!r} is not one of {LANES}")
    if tuple(x.x.shape) != (ROWS, W) or tuple(x.shifts.shape) != (NSHIFT,) \
            or x.shifts.dtype != torch.int32:
        raise ValueError(f"lanes: want x ({ROWS}, {W}) and int32 shifts ({NSHIFT},), got "
                         f"{tuple(x.x.shape)} and {x.shifts.dtype} {tuple(x.shifts.shape)}")
    if ntrips < 0 or ncopies < 1:
        raise ValueError(f"ntrips {ntrips} must be >= 0 and ncopies {ncopies} >= 1")


def trip_shifts(label: str, x: LanesInputs, ntrips: int) -> np.ndarray:
    """The shift of each trip: shifts[i mod 64] (a) or 37 (b)."""
    if label == "b":
        return np.full(ntrips, STATIC_SHIFT, np.int64)
    table = x.shifts.cpu().numpy().astype(np.int64)
    return table[np.arange(ntrips) % NSHIFT]


def lanes_plain(label: str, x: LanesInputs, ntrips: int = N, ncopies: int = 1):
    """(ncopies, 8, 128) of a)/b): the trips' rolls compose into one by their
    sum mod 128, and + 0.0 after the first trip changes only -0.0; the rows
    summed in the tool's order (`:61-64`) on every row."""
    _check_lanes(label, x, ntrips, ncopies)
    rows = torch.roll(x.x, int(trip_shifts(label, x, ntrips).sum() % W), 1)
    if ntrips:
        rows = rows + 0.0
    acc = rows[0]
    for row in rows[1:]:
        acc = acc + row
    return acc.expand(ncopies, ROWS, W)


def check_meta(meta) -> np.ndarray:
    """The (16, 3) int32 table as numpy; raises unless it lies on the CPU
    and every s0 is in [0, 4096), dst in [0, 512) and len in [0, 512]: the
    TPU kernel's reads and writes stay inside its buffers only there."""
    if not isinstance(meta, torch.Tensor) or meta.device.type != "cpu" \
            or meta.dtype != torch.int32 or tuple(meta.shape) != (NPART, 3):
        raise ValueError(f"meta: want a ({NPART}, 3) int32 CPU tensor, got {meta!r:.80}")
    m = meta.numpy()
    for what, col, lo, hi in (("s0", 0, 0, SM - 1), ("dst", 1, 0, OUT_COLS - 1),
                              ("len", 2, 0, OUT_COLS)):
        bad = np.flatnonzero((m[:, col] < lo) | (m[:, col] > hi))
        if bad.size:
            raise ValueError(f"part {bad[0]}: {what} {m[bad[0], col]} outside [{lo}, {hi}]")
    return np.ascontiguousarray(m)


def _check_part(label: str, x: PartInputs, nrep: int, npass: int) -> np.ndarray:
    if label not in PARTS:
        raise ValueError(f"part structure {label!r} is not one of {PARTS}")
    if tuple(x.strips.shape) != (FIELDS, SM) or x.strips.dtype != torch.float32:
        raise ValueError(f"strips: want float32 ({FIELDS}, {SM}), got {x.strips.dtype} "
                         f"{tuple(x.strips.shape)}")
    if nrep < 1 or npass < 1:
        raise ValueError(f"nrep {nrep} and npass {npass} must be at least 1")
    return check_meta(x.meta)


def part_order(label: str) -> List[int]:
    """The parts a pass runs, in order: c)/d) 0..15; e) (iv + ci) mod 16
    for iv < 9, ci < 2 (`:134-140`): 0, 1, 1, 2, ..., 8, 9."""
    if label == "e":
        return [(iv + ci) % NPART for iv in range(NIV) for ci in range(NCI)]
    return list(range(NPART))


def rolled_window(strips, s0: int):
    """(4, 128) `rolled` of a part (`:101-105`): AB[r .. r + 128) of A =
    strips[:, ba:ba+128], B = strips[:, bb:bb+128], bb = min(ba + 128, SM -
    128)."""
    r = s0 % W
    ba = s0 - r
    bb = min(ba + W, SM - W)
    return torch.cat([strips[:, ba:ba + W], strips[:, bb:bb + W]], 1)[:, r:r + W]


def valid_columns(dst: int, ln: int) -> Tuple[int, np.ndarray]:
    """(chunk c, mask of its 128 columns) that a part writes (`:96-99`)."""
    c = dst // W
    cols = c * W + np.arange(W)
    return c, (cols >= dst) & (cols < dst + ln)


def part_chunks(label: str, meta) -> List[int]:
    """The chunks that some part of the structure writes, in order: the
    tests' mirror of the choice that `roll_part_blocked`'s launcher makes
    (`blocked_chunks` asks the launcher itself)."""
    m = check_meta(meta)
    return sorted({int(m[p, 1]) // W for p in part_order(label)})


def part_plain(label: str, x: PartInputs, nrep: int = 1, npass: int = 1):
    """(nrep, 4, 512) of c)/d)/e) on an output that starts as NaN: each pass
    runs the structure's parts in order, each merging its rolled window
    into chunk dst // 128 where the column is in [dst, dst + len)."""
    meta = _check_part(label, x, nrep, npass)
    out = torch.full((FIELDS, OUT_COLS), float("nan"), device=x.strips.device)
    for _ in range(npass):
        for p in part_order(label):
            s0, dst, ln = (int(v) for v in meta[p])
            c, valid = valid_columns(dst, ln)
            chunk = out[:, c * W:(c + 1) * W]
            mask = torch.from_numpy(valid).to(out.device)
            chunk.copy_(torch.where(mask, rolled_window(x.strips, s0), chunk))
    return out.expand(nrep, -1, -1)


def _check_lam(x: LamInputs, nrep: int, npass: int) -> None:
    if tuple(x.rows.shape) != (LAM_ROWS, LAM_ROW_W) or tuple(x.cands.shape) != (4, LAM_CANDS):
        raise ValueError(f"lam: want rows ({LAM_ROWS}, {LAM_ROW_W}) and cands (4, {LAM_CANDS}), "
                         f"got {tuple(x.rows.shape)} and {tuple(x.cands.shape)}")
    if nrep < 1 or npass < 0:
        raise ValueError(f"nrep {nrep} must be >= 1 and npass {npass} >= 0")


def lam_v(x: LamInputs):
    """(32,) v of one rep of f) (`:157-177`): md.chunk_math over the 4
    chunks on (4, 32, 128) carries, then ((Σp6 + Σgx) + Σgy) + Σgz over the
    columns."""
    a = x.rows[:, :3].T.unsqueeze(-1)
    carry = x.rows.new_zeros((4, LAM_ROWS, W))
    for c in range(LAM_CANDS // W):
        md.chunk_math(a, x.cands[:3, c * W:(c + 1) * W].unsqueeze(1), carry)
    s = carry.sum(-1)
    return ((s[0] + s[1]) + s[2]) + s[3]


def lam_plain(x: LamInputs, nrep: int = 1, npass: int = REP):
    """(nrep, 32, 1) of f): acc + v, npass times in order (`:178`)."""
    _check_lam(x, nrep, npass)
    v = lam_v(x)
    acc = torch.zeros_like(v)
    for _ in range(npass):
        acc = acc + v
    return acc.reshape(1, LAM_ROWS, 1).expand(nrep, -1, -1)


def _check_rot(x, s) -> None:
    if tuple(x.shape) != (ROWS, W) or x.dtype != torch.float32:
        raise ValueError(f"rot: want float32 ({ROWS}, {W}), got {x.dtype} {tuple(x.shape)}")
    if tuple(s.shape) != (1,) or s.dtype != torch.int32 or s.device != x.device:
        raise ValueError(f"rot: want the shift as an int32 (1,) tensor on {x.device}, got "
                         f"{s.dtype} {tuple(s.shape)} on {s.device}")


def rot_plain(x, s):
    """(8, 128) roll(x, s, 1) (`micro_vpu.py:115-117`): every int32 shift,
    mod 128."""
    _check_rot(x, s)
    return torch.roll(x, int(s[0]) % W, 1)


def check_offset(o) -> int:
    """o as an int; raises unless it is an int in [0, 384]: x[:, o:o+128]
    inside (8, 512), the offsets the interpreted Pallas slice takes."""
    if isinstance(o, bool) or not isinstance(o, (int, np.integer)) or not 0 <= o <= MAX_OFFSET:
        raise ValueError(f"offset {o!r} is not an int in [0, {MAX_OFFSET}]")
    return int(o)


def _check_wide(x) -> None:
    if tuple(x.shape) != (ROWS, VPU_COLS) or x.dtype != torch.float32:
        raise ValueError(f"slice: want float32 ({ROWS}, {VPU_COLS}), got {x.dtype} "
                         f"{tuple(x.shape)}")


def slice_plain(x, o: int):
    """(8, 128) x[:, o:o+128] (`micro_vpu.py:136-138`, `:157-165`): the
    function of both the unaligned load and the unaligned copy."""
    o = check_offset(o)
    _check_wide(x)
    return x[:, o:o + W].clone()


# ---------------------------------------------------------------------------
# CUDA kernel launchers
# ---------------------------------------------------------------------------


def _launch(name: str, dev, *args) -> None:
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*args, ph._stream(dev))
    cuda_build.check(name, err)


def _aligned(name: str, t) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel's 16-byte accesses need an aligned tensor")


def lanes_kernel(label: str, x: LanesInputs, ntrips: int = N, ncopies: int = 1):
    """(ncopies, 8, 128) from `roll_lanes`: one warp a copy, 8 a CTA."""
    _check_lanes(label, x, ntrips, ncopies)
    dev = ar._check_card(x=(x.x, torch.float32, (ROWS, W)),
                         shifts=(x.shifts, torch.int32, (NSHIFT,)))
    out = torch.empty((ncopies, ROWS, W), dtype=torch.float32, device=dev)
    _launch("roll_lanes", dev, x.x.data_ptr(), x.shifts.data_ptr(), int(label == "a"),
            STATIC_SHIFT, ntrips, ncopies, out.data_ptr())
    return out


def _part_launch(name: str, label: str, body: str, x: PartInputs, nrep: int, npass: int, out):
    if body not in PART_BODIES:
        raise ValueError(f"part body {body!r} is not one of {PART_BODIES}")
    meta = _check_part(label, x, nrep, npass)
    if out is None:
        out = torch.full((nrep, FIELDS, OUT_COLS), float("nan"), device=x.strips.device)
    dev = ar._check_card(strips=(x.strips, torch.float32, (FIELDS, SM)),
                         out=(out, torch.float32, (nrep, FIELDS, OUT_COLS)))
    _aligned("strips", x.strips)
    _aligned("out", out)
    _launch(name, dev, x.strips.data_ptr(), meta.ctypes.data, BODY_ID[body], LOOP_ID[label],
            NIV, NCI, nrep, npass, PASS_STRIDE, out.data_ptr())
    return out


def part_kernel(label: str, body: str, x: PartInputs, nrep: int = 1, npass: int = 1,
                out=None):
    """(nrep, 4, 512) from `roll_part` (body `shuffle` or `direct`), one
    warp a copy, on `out` (NaN-filled here when None; the kernel writes only
    the parts' columns, and passes again give the same)."""
    return _part_launch("roll_part", label, body, x, nrep, npass, out)


def part_blocked_kernel(label: str, body: str, x: PartInputs, nrep: int = 1, npass: int = 1,
                        out=None):
    """`part_kernel`'s output from `roll_part_blocked`: one warp a copy,
    field and chunk that a part of the structure writes (`blocked_chunks`),
    the merge in registers from one load of the chunk to one store."""
    return _part_launch("roll_part_blocked", label, body, x, nrep, npass, out)


def blocked_chunks(label: str, meta) -> int:
    """The CTAs a copy of `roll_part_blocked` runs on this meta, as its
    launcher counts them: one for each chunk that a part writes."""
    m = check_meta(meta)
    n = cuda_build.library().roll_part_blocked_chunks(m.ctypes.data, LOOP_ID[label], NIV, NCI)
    if n <= 0:
        raise ValueError(f"roll_part_blocked runs no chunk of {label} on this meta")
    return n


def lam_kernel(x: LamInputs, nrep: int = 1, npass: int = REP):
    """(nrep, 32, 1) from `roll_lam`: one CTA of 1024 threads a copy."""
    _check_lam(x, nrep, npass)
    dev = ar._check_card(rows=(x.rows, torch.float32, (LAM_ROWS, LAM_ROW_W)),
                         cands=(x.cands, torch.float32, (4, LAM_CANDS)))
    out = torch.empty((nrep, LAM_ROWS, 1), dtype=torch.float32, device=dev)
    _launch("roll_lam", dev, x.rows.data_ptr(), x.cands.data_ptr(), nrep, npass, PASS_STRIDE,
            HH, HF, EPS2, out.data_ptr())
    return out


def rot_kernel(x, s):
    """(8, 128) from `vpu_rot`: one warp, s read by the kernel."""
    _check_rot(x, s)
    dev = ar._check_card(x=(x, torch.float32, (ROWS, W)), s=(s, torch.int32, (1,)))
    out = torch.empty((ROWS, W), dtype=torch.float32, device=dev)
    _launch("vpu_rot", dev, x.data_ptr(), s.data_ptr(), out.data_ptr())
    return out


def _slice_kernel(name: str, x, o: int):
    o = check_offset(o)
    _check_wide(x)
    dev = ar._check_card(x=(x, torch.float32, (ROWS, VPU_COLS)))
    out = torch.empty((ROWS, W), dtype=torch.float32, device=dev)
    _launch(name, dev, x.data_ptr(), o, out.data_ptr())
    return out


def unal_kernel(x, o: int):
    """(8, 128) from `vpu_unal`: 32-bit loads at o."""
    return _slice_kernel("vpu_unal", x, o)


def dma_kernel(x, o: int):
    """(8, 128) from `vpu_dma`: 4-byte cp.async copies into shared memory,
    waited on an mbarrier, then stored."""
    return _slice_kernel("vpu_dma", x, o)


class MicroRoll:
    """The wrappers of the kernels, with a launch counter per kernel name
    (`KERNELS`): it starts at 0 and grows by one each time a method launches
    a CUDA kernel, and at no other time.  A CPU tensor takes the plain
    version."""

    def __init__(self):
        self.launches = dict.fromkeys(KERNELS, 0)

    def _run(self, name: str, cpu: bool, plain, kernel):
        if cpu:
            return plain()
        out = kernel()
        self.launches[name] += 1
        return out

    def lanes(self, label: str, x: LanesInputs, ntrips: int = N, ncopies: int = 1):
        return self._run("roll_lanes", x.x.device.type == "cpu",
                         lambda: lanes_plain(label, x, ntrips, ncopies),
                         lambda: lanes_kernel(label, x, ntrips, ncopies))

    def part(self, label: str, body: str, x: PartInputs, nrep: int = 1, npass: int = 1,
             out=None):
        if body not in PART_BODIES:
            raise ValueError(f"part body {body!r} is not one of {PART_BODIES}")
        return self._run(f"roll_part_{body}", x.strips.device.type == "cpu",
                         lambda: part_plain(label, x, nrep, npass),
                         lambda: part_kernel(label, body, x, nrep, npass, out))

    def part_blocked(self, label: str, body: str, x: PartInputs, nrep: int = 1, npass: int = 1,
                     out=None):
        if body not in PART_BODIES:
            raise ValueError(f"part body {body!r} is not one of {PART_BODIES}")
        return self._run(f"roll_part_blocked_{body}", x.strips.device.type == "cpu",
                         lambda: part_plain(label, x, nrep, npass),
                         lambda: part_blocked_kernel(label, body, x, nrep, npass, out))

    def lam(self, x: LamInputs, nrep: int = 1, npass: int = REP):
        return self._run("roll_lam", x.rows.device.type == "cpu",
                         lambda: lam_plain(x, nrep, npass), lambda: lam_kernel(x, nrep, npass))

    def rot(self, x, s):
        return self._run("vpu_rot", x.device.type == "cpu", lambda: rot_plain(x, s),
                         lambda: rot_kernel(x, s))

    def unal(self, x, o: int):
        return self._run("vpu_unal", x.device.type == "cpu", lambda: slice_plain(x, o),
                         lambda: unal_kernel(x, o))

    def dma(self, x, o: int):
        return self._run("vpu_dma", x.device.type == "cpu", lambda: slice_plain(x, o),
                         lambda: dma_kernel(x, o))


# ---------------------------------------------------------------------------
# The SASS of the built kernels
# ---------------------------------------------------------------------------


def pattern(name: str) -> str:
    """The mangled-name piece of a kernel: "a", "b", "f", a VPU name, or
    "<structure> <body>" of a part kernel ("<structure> <body> blocked" of
    the redesign)."""
    if name in LANES:
        return f"17roll_lanes_kernelILi{int(name == 'a')}E"
    if name == "f":
        return "15roll_lam_kernel"
    if name in VPU:
        return {"vpu_rot": "14vpu_rot_kernel", "vpu_unal": "15vpu_unal_kernel",
                "vpu_dma": "14vpu_dma_kernel"}[name]
    label, body, *blocked = name.split()
    kernel = "24roll_part_blocked_kernel" if blocked else "16roll_part_kernel"
    return f"{kernel}ILi{BODY_ID[body]}ELi{LOOP_ID[label]}E"


def _ops(sass: ar.Sass, span=None) -> List[str]:
    return [op for a, op, _ in sass[0] if span is None or span[0] <= a <= span[1]]


def _count(ops: List[str]) -> Dict[str, int]:
    """The opcodes the checks read, by kind."""
    c = collections.Counter()
    for op in ops:
        base = op.split(".")[0]
        if base in ("SHFL", "FADD", "LDS", "SYNCS", "LDGSTS", "LDL", "STL"):
            c[base] += 1
        elif base in ("LDG", "STG"):
            c[base + (".128" if ".128" in op else ".32")] += 1
        elif op == "MUFU.RSQ":
            c[op] += 1
    return dict(c)


def _loop_with(sass: ar.Sass, kind: str):
    """(span, counts) of the one innermost loop holding `kind`; (None, {})
    unless exactly one does."""
    spans = [s for s in ar.innermost_spans(sass) if _count(_ops(sass, s)).get(kind)]
    if len(spans) != 1:
        return None, {}
    return spans[0], _count(_ops(sass, spans[0]))


def _no_local(sass: ar.Sass) -> bool:
    c = _count(_ops(sass))
    return not c.get("LDL") and not c.get("STL")


def check_sass(lib_path) -> Dict[str, dict]:
    """`check_funcs` of the built library."""
    return check_funcs(ar.sass_functions(lib_path))


def check_funcs(funcs) -> Dict[str, dict]:
    """name -> dict(ok, counts).  a)/b): one trip loop of 32 SHFL (4 a roll,
    8 rolls), a) with its shift read from shared memory, b) none;
    `plus_zero_kept` whether its 32 + 0.0 FADDs survive.  vpu_rot: 32 SHFL.
    Each part kernel: the loop of its structure holds its parts' float4
    stores (c: 16 parts a pass, d/e: one), shuffle 16 SHFL and 12 float4
    loads a part, direct 16 32-bit loads, 4 float4 loads and no SHFL.  Each
    blocked one: the loop of its structure holds its visits (a part on one
    field; c: 16 a pass, d/e: one), shuffle 4 SHFL and 8 32-bit loads a
    visit, direct 4 32-bit loads and no SHFL, and no store: the output is
    loaded before the pass loop and stored after it.  f):
    the pass loop holds 16 MUFU.RSQ and, beside its reduction (LAM_REDUCE),
    `pbf_lambda`'s fp32 instructions a pair, opcode by opcode.  vpu_unal: 4
    32-bit loads and stores, no asynchronous copy; vpu_dma: 4 cp.async copies
    (LDGSTS) and a barrier wait, no global load.  No kernel spills to local
    memory."""
    report = {}
    for label in LANES:
        sass = ar._one(funcs, pattern(label))
        span, c = _loop_with(sass, "SHFL")
        r = dict(shfl_a_trip=c.get("SHFL", 0), fadd_a_trip=c.get("FADD", 0),
                 lds_a_trip=c.get("LDS", 0), ldg_a_trip=c.get("LDG.32", 0),
                 insts_a_trip=len(_ops(sass, span)) if span else 0)
        r["plus_zero_kept"] = r["fadd_a_trip"] >= ROWS * 4
        reads = r["lds_a_trip"] >= 1 if label == "a" else r["lds_a_trip"] + r["ldg_a_trip"] == 0
        r["ok"] = r["shfl_a_trip"] == ROWS * 4 and reads and _no_local(sass)
        report[label] = r
    sass = ar._one(funcs, pattern("vpu_rot"))
    c = _count(_ops(sass))
    report["vpu_rot"] = dict(shfl=c.get("SHFL", 0),
                             ok=c.get("SHFL", 0) == ROWS * 4 and _no_local(sass))
    for label in PARTS:
        parts = NPART if label == "c" else 1
        for body in PART_BODIES:
            sass = ar._one(funcs, pattern(f"{label} {body}"))
            span, c = _loop_with(sass, "STG.128")
            r = {k: c.get(k, 0) / parts for k in ("STG.128", "LDG.128", "LDG.32", "SHFL")}
            r["insts"] = len(_ops(sass, span)) / parts if span else 0
            want = ({"STG.128": 4, "LDG.128": 12, "LDG.32": 0, "SHFL": 16} if body == "shuffle"
                    else {"STG.128": 4, "LDG.128": 4, "LDG.32": 16, "SHFL": 0})
            r = {f"{k}_a_part": v for k, v in r.items()}
            r["ok"] = all(r[f"{k}_a_part"] == v for k, v in want.items()) and _no_local(sass)
            report[f"{label} {body}"] = r
    for label in PARTS:
        visits = NPART if label == "c" else 1
        for body in PART_BODIES:
            sass = ar._one(funcs, pattern(f"{label} {body} blocked"))
            span, c = _loop_with(sass, "SHFL" if body == "shuffle" else "LDG.32")
            r = {k: c.get(k, 0) / visits for k in ("SHFL", "LDG.128", "LDG.32", "STG.128",
                                                    "STG.32")}
            r["insts"] = len(_ops(sass, span)) / visits if span else 0
            want = ({"SHFL": 4, "LDG.128": 0, "LDG.32": 8} if body == "shuffle"
                    else {"SHFL": 0, "LDG.128": 0, "LDG.32": 4})
            want.update({"STG.128": 0, "STG.32": 0})
            r = {f"{k}_a_visit": v for k, v in r.items()}
            r["ok"] = (span is not None and _no_local(sass)
                       and all(r[f"{k}_a_visit"] == v for k, v in want.items()))
            report[f"{label} {body} blocked"] = r
    sass = ar._one(funcs, pattern("f"))
    span, c = _loop_with(sass, "MUFU.RSQ")
    phase = ar.fp32_per_pair(ar.pair_loop(ar._one(funcs, ar.PHASE_KERNELS["lambda"])))
    fp32 = {}
    if span is not None:
        counts = collections.Counter(ar._opcode_key(op) for op in _ops(sass, span))
        fp32 = {k: (counts[k] - LAM_REDUCE.get(k, 0)) / LAM_PAIRS_A_PASS
                for k in ar.FP32_OPCODES if counts[k]}
    r = dict(pairs_a_pass=c.get("MUFU.RSQ", 0), shfl_a_pass=c.get("SHFL", 0),
             fp32_per_pair=sum(fp32.values()))
    r["same_as_pbf_lambda"] = bool(phase) and fp32 == phase
    r["ok"] = (r["pairs_a_pass"] == LAM_PAIRS_A_PASS and r["shfl_a_pass"] == LAM_REDUCE["SHFL"]
               and r["same_as_pbf_lambda"] and _no_local(sass))
    report["f"] = r
    for name in ("vpu_unal", "vpu_dma"):
        sass = ar._one(funcs, pattern(name))
        c = _count(_ops(sass))
        r = {k: c.get(k, 0) for k in ("LDG.32", "LDG.128", "STG.32", "STG.128", "LDGSTS",
                                      "SYNCS")}
        if name == "vpu_unal":
            r["ok"] = r["LDG.32"] == 4 and r["STG.32"] == 4 and r["LDGSTS"] == 0
        else:
            r["ok"] = (r["LDGSTS"] == 4 and r["SYNCS"] >= 1
                       and r["LDG.32"] + r["LDG.128"] == 0)
        r["ok"] = r["ok"] and _no_local(sass)
        report[name] = r
    return report


def short(report: Dict[str, dict]) -> List[str]:
    return [name for name, r in report.items() if not r["ok"]]


# ---------------------------------------------------------------------------
# Parity
# ---------------------------------------------------------------------------


def bit_equal(got, want) -> Tuple[float, bool]:
    """(max abs err off NaN, NaN in the same places and every other value
    bit for bit, -0.0 told from +0.0)."""
    want = want.expand_as(got)
    gn, wn = torch.isnan(got), torch.isnan(want)
    same = torch.equal(gn, wn) and torch.equal(got[~gn].view(torch.int32),
                                               want[~wn].view(torch.int32))
    diff = (got[~gn] - want[~wn]).abs() if torch.equal(gn, wn) else got.new_full((1,), np.inf)
    return (float(diff.max()) if diff.numel() else 0.0), bool(same)


def close(got, want) -> Tuple[float, bool]:
    """(max abs err, within RTOL and ATOL_SHARE x max|want|)."""
    want = want.expand_as(got)
    atol = ATOL_SHARE * float(want.abs().max())
    return (float((got - want).abs().max()),
            bool(torch.allclose(got, want, rtol=RTOL, atol=atol)))


def card_parity(device, seed: int = 0) -> Dict[str, Tuple[float, bool]]:
    """Each kernel against its plain version on the card, its launches not
    counted; label -> (max abs err, ok).  On the tool's inputs and seeded
    ones (the shift table with SEEDED_SHIFTS and WRAPPED_SHIFTS, meta that
    reaches the bb clamp, chunk crossings and overlaps, every shift and
    offset of SEEDED_SHIFTS, WRAPPED_SHIFTS and SEEDED_OFFSETS); a)-e) and
    rows 7.13-7.15 bit for bit, NaN in the same places (the blocked part
    kernels against both part_plain and roll_part), and a)/b) also on an
    x of -0.0, whose sum the trips' + 0.0 makes +0.0; f) rtol 1e-5, atol
    1e-5 x max|value| (fp32 sums of mixed-sign terms in the kernel's order,
    a lane's columns then a warp-shuffle tree, against Pallas's per-column
    carries; its acc adds v in the same order on both sides)."""
    res = {}
    cases = {"tool": (lanes_inputs(device), part_inputs(device), lam_inputs(device)),
             "random": (random_lanes_inputs(seed, device), random_part_inputs(seed, device),
                        random_lam_inputs(seed, device))}
    for case, (xl, xp, xf) in cases.items():
        for label in LANES:
            res[f"{label} {case}"] = bit_equal(lanes_kernel(label, xl, N, PARITY_REPS),
                                               lanes_plain(label, xl, N))
        for label in PARTS:
            want = part_plain(label, xp, PARITY_REPS, 2)
            for body in PART_BODIES:
                orig = part_kernel(label, body, xp, PARITY_REPS, 2)
                res[f"{label} {body} {case}"] = bit_equal(orig, want)
                got = part_blocked_kernel(label, body, xp, PARITY_REPS, 2)
                err, ok = bit_equal(got, want)
                res[f"{label} {body} blocked {case}"] = (err, ok and bit_equal(got, orig)[1])
        res[f"f {case}"] = close(lam_kernel(xf, PARITY_REPS), lam_plain(xf))
    zeros = LanesInputs(torch.full((ROWS, W), -0.0, device=device), lanes_inputs(device).shifts)
    for label in LANES:
        res[f"{label} zeros"] = bit_equal(lanes_kernel(label, zeros, N, PARITY_REPS),
                                          lanes_plain(label, zeros, N))
    x = vpu_inputs(device)
    res["vpu_rot tool"] = bit_equal(rot_kernel(x.tile, x.shift), rot_plain(x.tile, x.shift))
    for name, kernel in (("vpu_unal", unal_kernel), ("vpu_dma", dma_kernel)):
        res[f"{name} tool"] = bit_equal(kernel(x.wide, x.offset), slice_plain(x.wide, x.offset))
    for i, s in enumerate(SEEDED_SHIFTS + WRAPPED_SHIFTS):
        xr = random_vpu_inputs(seed + i, s, 0, device)
        res[f"vpu_rot s={s}"] = bit_equal(rot_kernel(xr.tile, xr.shift),
                                          rot_plain(xr.tile, xr.shift))
    for i, o in enumerate(SEEDED_OFFSETS):
        xr = random_vpu_inputs(seed + i, 0, o, device)
        for name, kernel in (("vpu_unal", unal_kernel), ("vpu_dma", dma_kernel)):
            res[f"{name} o={o}"] = bit_equal(kernel(xr.wide, o), slice_plain(xr.wide, o))
    return res


# ---------------------------------------------------------------------------
# The work, the bound and the readings
# ---------------------------------------------------------------------------


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def lanes_work(label: str, x: LanesInputs, ntrips: int = N, ncopies: int = 1) -> dict:
    """What a)/b) need: 4 SHFL a row for each trip whose shift is not a
    multiple of 32 (one that is moves whole slots, no lane), 8 rows a copy;
    x and the table read once, the copies written once."""
    moves = int((trip_shifts(label, x, ntrips) % 32 != 0).sum())
    table = nbytes(x.shifts) if label == "a" else 0
    return dict(shfl=ncopies * ROWS * 4 * moves,
                bytes=nbytes(x.x) + table + ncopies * ROWS * W * 4)


def rot_work(x, s) -> dict:
    moves = int(int(s[0]) % 32 != 0)
    return dict(shfl=ROWS * 4 * moves, bytes=nbytes(x, s) + ROWS * W * 4)


def part_work(label: str, x: PartInputs, nrep: int = 1, npass: int = 1) -> dict:
    """What c)/d)/e) need: each part of each pass reads the window's valid
    columns from the strip, and a copy writes the columns that some part
    writes once, 4 fields, as 32-bit lane accesses; the strip and meta read
    once, the copies written once."""
    meta = check_meta(x.meta)
    masks = [valid_columns(int(meta[p, 1]), int(meta[p, 2])) for p in part_order(label)]
    cols = sum(int(valid.sum()) for _, valid in masks)
    written = np.zeros(OUT_COLS, bool)
    for c, valid in masks:
        written[c * W:(c + 1) * W] |= valid
    return dict(lsu=nrep * FIELDS * (npass * cols + int(written.sum())),
                bytes=nbytes(x.strips, x.meta) + nrep * FIELDS * OUT_COLS * 4)


def lam_work(x: LamInputs, nrep: int = 1, npass: int = REP) -> dict:
    """What f) needs: md.PAIR_WORK's chunk_math a pair (19 fp32, 1 MUFU),
    and a row's v (3 adds) and acc (1) a pass; rows and cands read once,
    the copies written once."""
    fp32, mufu, _ = md.PAIR_WORK["fpu"]
    pairs = nrep * npass * LAM_ROWS * LAM_CANDS
    return dict(fp32=pairs * fp32 + nrep * npass * LAM_ROWS * 4, mufu=pairs * mufu,
                bytes=nbytes(x.rows, x.cands) + nrep * LAM_ROWS * 4)


def slice_work() -> dict:
    return dict(bytes=2 * ROWS * W * 4)


def bound_ms(w: dict, mhz: float, sms: int) -> Tuple[float, str]:
    """The least time: the bytes over 3.35 TB/s, or the operations: f)'s
    fp32 and MUFU issue (`micro_chunk.issue_bound_ms`), SHFLs over one a
    clock an SM, 32-bit loads and stores over 32 lanes a clock an SM, at
    the sampled SM clock; whichever is longest."""
    if "fp32" in w:
        return mch.issue_bound_ms(w["fp32"], w["mufu"], w["bytes"], mhz, sms)
    hz = mhz * 1e6
    t_ops = max(w.get("shfl", 0) / (sms * SHFL_WARPS_PER_CLK * hz),
                w.get("lsu", 0) / (sms * LSU_LANES_PER_CLK * hz))
    t_bytes = w["bytes"] / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def fill_copies(device, kernel: str, label: str = "a", body: str = "shuffle") -> int:
    """Copies that fill every SM at the kernel's occupancy: kernel "lanes"
    (label a/b), "part" or "part_blocked" (label c/d/e, body; a blocked
    copy is a CTA for each chunk the tool's parts write) or "lam"."""
    part = 3 * BODY_ID.get(body, -1) + LOOP_ID.get(label, 0)
    kid, variant = {"lanes": (0, int(label == "a")), "part": (1, part), "part_blocked": (3, part),
                    "lam": (2, 0)}[kernel]
    with torch.cuda.device(device):
        n = cuda_build.library().micro_roll_fill(kid, variant)
    if n <= 0:
        raise ValueError(f"csrc/micro_roll.cu has no {kernel} kernel {label} {body}")
    if kernel == "part_blocked":
        return -(-n // blocked_chunks(label, torch.from_numpy(tool_meta())))
    return n


def read_lanes(mr: MicroRoll, label: str, x: LanesInputs, ncopies: int, reps: int) -> dict:
    """a)/b) through `mr`: the marginal over TRIPS at `ncopies` copies; ns a
    trip and a roll of one copy (the TPU tool's units, `:66`), rolls/s and
    SHFL a clock an SM of the card at the sampled clock's median."""
    dt, t_lo, t_hi = ar.marginal(lambda n: mr.lanes(label, x, n, ncopies), TRIPS, reps)
    trips = TRIPS[1] - TRIPS[0]
    return dict(copies=ncopies, trips=list(TRIPS), ms=[t_lo, t_hi],
                ns_per_trip=dt * 1e9 / trips, ns_per_roll=dt * 1e9 / (trips * ROWS),
                rolls_per_s=ncopies * trips * ROWS / dt)


def read_part(mr: MicroRoll, label: str, body: str, x: PartInputs, ncopies: int,
              reps: int, blocked: bool = False) -> dict:
    """A part body (`blocked`: the blocked kernel's) through `mr`: the
    marginal over PASSES at `ncopies` copies, on one NaN-filled output; ns a
    part of one copy, parts/s of the card, and that output at the end
    against `part_plain` (passes again give the same): max abs err and bit
    for bit, NaN in place."""
    out = torch.full((ncopies, FIELDS, OUT_COLS), float("nan"), device=x.strips.device)
    run = mr.part_blocked if blocked else mr.part
    dt, t_lo, t_hi = ar.marginal(lambda n: run(label, body, x, ncopies, n, out), PASSES, reps)
    parts = (PASSES[1] - PASSES[0]) * len(part_order(label))
    err, same = bit_equal(out, part_plain(label, x, ncopies))
    return dict(copies=ncopies, passes=list(PASSES), ms=[t_lo, t_hi],
                ns_per_part=dt * 1e9 / parts, parts_per_s=ncopies * parts / dt,
                max_abs_err=err, bit_equal=same)


def read_lam(mr: MicroRoll, x: LamInputs, ncopies: int, reps: int) -> dict:
    """f) through `mr`: the marginal over LAM_PASSES at `ncopies` copies; ns
    a sub-block (one pass: 32 rows x 512 candidates) of one copy and G
    pairs/s of the card."""
    dt, t_lo, t_hi = ar.marginal(lambda n: mr.lam(x, ncopies, n), LAM_PASSES, reps)
    passes = LAM_PASSES[1] - LAM_PASSES[0]
    return dict(copies=ncopies, passes=list(LAM_PASSES), ms=[t_lo, t_hi],
                ns_per_subblock=dt * 1e9 / passes,
                pairs_per_s=ncopies * passes * LAM_ROWS * LAM_CANDS / dt)


def read_launch(fn, reps: int = 100) -> dict:
    """One tiny launch, read as micro_mc_field reads mc_field_noop: CUDA
    events over `reps` back-to-back calls, and a CUDA graph of 100 captured
    calls."""
    from pbf_sph_tpu_torch.tools.bench_kernel_variants import device_ms
    from pbf_sph_tpu_torch.tools.micro_mc_field import graph_ms

    return dict(events_ms=device_ms(fn, reps), graph_ms=graph_ms(fn))


def read_all(mr: MicroRoll, device, reps: int) -> dict:
    """Every reading through `mr` (counted) at the tools' inputs, with the
    SM clock sampled: a)/b) and each part body and structure, original and
    blocked, for one copy and with the card filled (c-e also at the JAX
    call's REP copies), f) beside
    micro_dense's c) in the same run, and rows 7.13-7.15 beside their
    library calls."""
    xl, xp, xf, xv = (lanes_inputs(device), part_inputs(device), lam_inputs(device),
                      vpu_inputs(device))
    res = {"lanes": {}, "parts": {}, "vpu": {}}
    with ar.ClockSampler(device) as clock:
        for label in LANES:
            res["lanes"][label] = {
                geo: read_lanes(mr, label, xl, n, reps)
                for geo, n in (("copy", 1), ("fill", fill_copies(device, "lanes", label)))}
        for label in PARTS:
            for body in PART_BODIES:
                for kernel, blocked in (("part", False), ("part_blocked", True)):
                    res["parts"][f"{label} {body}" + " blocked" * blocked] = {
                        geo: read_part(mr, label, body, xp, n, reps, blocked)
                        for geo, n in (("copy", 1), ("jax", REP),
                                       ("fill", fill_copies(device, kernel, label, body)))}
        res["lam"] = {geo: read_lam(mr, xf, n, reps)
                      for geo, n in (("copy", 1), ("fill", fill_copies(device, "lam")))}
        res["dense_c"] = md.read_body(md.MicroDense(), "c", md.tool_inputs(device=device), "jax",
                                      reps)
        o = xv.offset
        res["vpu"] = {"vpu_rot": read_launch(lambda: mr.rot(xv.tile, xv.shift)),
                      "vpu_unal": read_launch(lambda: mr.unal(xv.wide, o)),
                      "vpu_dma": read_launch(lambda: mr.dma(xv.wide, o))}
        res["library"] = {
            "vpu_rot": read_launch(lambda: torch.roll(xv.tile, TOOL_SHIFT, 1)),
            "vpu_unal": read_launch(lambda: xv.wide[:, o:o + W].contiguous())}
        res["library"]["vpu_dma"] = res["library"]["vpu_unal"]
    res["clocks_sm_mhz"] = clock.summary()
    return res


def main(argv=None) -> int:
    from pbf_sph_tpu_torch.tools.bench_kernel_variants import card_line

    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 10
    if not torch.cuda.is_available():
        raise SystemExit("micro_roll: needs a CUDA device")
    card = card_line()
    print(card)
    device = torch.device("cuda", torch.cuda.current_device())

    print("== SASS of csrc/micro_roll.cu (cuobjdump)")
    cuda_build.library()
    sass = check_sass(cuda_build.library_path())
    for name, r in sass.items():
        print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in r.items()))
    if short(sass):
        raise SystemExit(f"micro_roll: the SASS of {short(sass)} is off: the compiler folded, "
                         f"hoisted or spilled what is measured, so no rate is printed")
    parity = card_parity(device)
    print("== each kernel against its plain version: " + ", ".join(
        f"{k} {e:.3e}" for k, (e, _) in parity.items()))
    wrong = [k for k, (_, ok) in parity.items() if not ok]
    if wrong:
        raise SystemExit(f"micro_roll: {wrong} disagree with their plain versions")

    mr = MicroRoll()
    res = read_all(mr, device, reps)
    wrong = [f"{name} {geo}" for name, r in res["parts"].items() for geo, g in r.items()
             if not g["bit_equal"]]
    if wrong:
        raise SystemExit(f"micro_roll: the outputs of the readings {wrong} are not part_plain's")
    print("== every part body reading's output is part_plain's, bit for bit, NaN in place")
    mhz = mch.sm_clock_mhz(res["clocks_sm_mhz"], device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    xl, xp, xf = lanes_inputs(device), part_inputs(device), lam_inputs(device)
    print(f"== SM clock beside the readings (nvidia-smi, MHz): {res['clocks_sm_mhz']}")
    print(f"== a)/b) lane rolls (marginal over trips {TRIPS}; copy = one warp, the TPU's "
          f"8 streams; fill = the card at occupancy)")
    for label, geo in res["lanes"].items():
        one, full = geo["copy"], geo["fill"]
        bms, by = bound_ms(lanes_work(label, xl, N, full["copies"]), mhz, sms)
        shfl = lanes_work(label, xl, TRIPS[1] - TRIPS[0], full["copies"])["shfl"]
        dt = (full["ms"][1] - full["ms"][0]) * 1e-3
        print(f"  {label}) {NAMES[label]}: copy {one['ns_per_trip']:.2f} ns/trip -> "
              f"{one['ns_per_roll']:.2f} ns/roll; fill ({full['copies']} copies) "
              f"{full['rolls_per_s'] / 1e9:.2f} G rolls/s, {shfl / dt / (sms * mhz * 1e6):.3f} "
              f"SHFL a clock an SM; bound {bms:.4f} ms by {by} at {N} trips")
    print(f"== c)/d)/e) part bodies (marginal over passes {PASSES}; copy = one warp walking "
          f"the parts in order, blocked = 4 warps a chunk; jax = {REP} copies, fill = the card "
          f"at occupancy)")
    for name, geo in res["parts"].items():
        label = name.split()[0]
        full, jax = geo["fill"], geo["jax"]
        bms, by = bound_ms(part_work(label, xp, full["copies"], PASSES[1]), mhz, sms)
        jax_bms, _ = bound_ms(part_work(label, xp, REP, PASSES[1]), mhz, sms)
        orig = res["parts"].get(name.removesuffix(" blocked")) if name.endswith("blocked") \
            else None
        gain = f", {orig['jax']['ms'][1] / jax['ms'][1]:.3f}x the original" if orig else ""
        print(f"  {name:19s} ({NAMES[label]}): copy {geo['copy']['ns_per_part']:7.2f} ns/part; "
              f"jax {jax['ns_per_part']:.4f} ns/part ({jax['parts_per_s'] / 1e9:.2f} G parts/s, "
              f"{jax['ms'][1]:.4f} ms, {jax_bms / jax['ms'][1]:.3f} of its bound{gain}); fill "
              f"{full['parts_per_s'] / 1e9:.2f} G parts/s; bound {bms:.4f} ms by {by} at "
              f"{full['copies']} copies x {PASSES[1]} passes (kernel {full['ms'][1]:.4f} ms)")
    lam, dc = res["lam"], res["dense_c"]
    bms, by = bound_ms(lam_work(xf, lam["fill"]["copies"], LAM_PASSES[1]), mhz, sms)
    print(f"== f) {NAMES['f']}: copy {lam['copy']['ns_per_subblock']:.1f} ns/subblock "
          f"({lam['copy']['pairs_per_s'] / 1e9:.2f} G pairs/s on one SM); fill "
          f"({lam['fill']['copies']} copies) {lam['fill']['pairs_per_s'] / 1e9:.1f} G pairs/s = "
          f"{lam['fill']['pairs_per_s'] / dc['pairs_per_s']:.3f} of micro_dense c) "
          f"({dc['pairs_per_s'] / 1e9:.1f} G pairs/s, this run); bound {bms:.4f} ms by {by}")
    print("== rows 7.13-7.15 (one launch each: CUDA events over 100 back to back, and a CUDA "
          "graph of 100)")
    for name, r in res["vpu"].items():
        lib = res["library"][name]
        print(f"  {name}: events {r['events_ms']:.5f} ms, graph {r['graph_ms']:.5f} ms; library "
              f"events {lib['events_ms']:.5f} ms, graph {lib['graph_ms']:.5f} ms")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "reps": reps,
                      "sass": sass, "parity": {k: e for k, (e, _) in parity.items()},
                      "readings": res, "launches": mr.launches}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
