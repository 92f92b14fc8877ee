"""Anchor the λ/Δp pair-math rate against the card's own issue rates.

    python -m pbf_sph_tpu_torch.tools.anchor_rate [reps]

Port of `tools/anchor_rate.py`.  The bound of the phase kernels counts each
fp32 add, max and rsqrt as one operation against a peak (67 TFLOP/s) that
counts an FMA as two and takes no rsqrt from the MUFU unit, so it cannot say
how near a kernel is to what the card can do.  This tool measures that on
the card, with the three hand-written kernels of `csrc/anchor_rate.cu`:

* `issue` (`build_issue`): the issue rate of one op (fma, mul, max, sub_mul,
  rsqrt) on `nstreams` independent fp32 carries, `unroll` rounds of the op an
  iteration; the output is the (8, 128) sum of the carries;
* `body` (`build_body`): the λ or Δp pair terms of `csrc/pbf_pair.cuh`,
  which `pbf_lambda` and `pbf_delta` run, for 64 rows against a strip of
  `nch` chunks of 128 candidates, `nunroll` chunks an iteration, chunk
  (k + i*stride) mod nch; the output is each row's sum over its pairs of
  its summed carries;
* `rowfix` (`build_subfix`): λ of 1024 rows by `pbf_lambda`'s own row code
  (`lambda_member` of `csrc/pbf_pair.cuh`), replicated over `nblocks`
  blocks, with a cell table whose every range is empty: the fixed cost of a
  row; λ = 1/CFM_EPSILON.

Each has a plain PyTorch version of the same signature; `Anchor` holds the
wrappers, which take the plain version for a CPU tensor and the kernel for a
CUDA one, and count kernel launches.  A unit of work is one fp32 instruction
on one element (one lane), where the JAX tool's vop is one instruction on an
(8, 128) tile; rsqrt counts two, its add and the rsqrt, as the JAX tool
counts it.

The tool prints the card line; checks the SASS of every kernel (cuobjdump:
the loop of each issue instantiation holds nstreams*unroll instructions of
its op, the body loop one MUFU.RSQ and one shared-memory float4 read a pair
and, opcode by opcode, the fp32 instructions a pair of the phase kernel's
own loop, the row kernel `pbf_lambda`'s loads and pair loop); settles
dam_break(1M, 6) as `bench_phases` does and counts its member rows and
per-row candidate pairs; reads each rate as the marginal between two sizes,
with CUDA events, while `nvidia-smi` samples the SM clock; and decomposes
the per-row `pbf_lambda` and `pbf_delta` kernels at that state (launched on
a (C, 4) pack made beforehand) into rows x fixed cost + pairs / body rate
and a remainder.  The last line is one JSON object.  Without a CUDA device
the tool fails.
"""

from __future__ import annotations

import collections
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.ops.grid import GridSpec

OPS = ("fma", "mul", "max", "sub_mul", "rsqrt")
# (op, nstreams, unroll) that csrc/anchor_rate.cu instantiates: the JAX
# tool's 16 x 16 for every op, and the serial chain for fma
OP_SHAPES = tuple((op, 16, 16) for op in OPS) + (("fma", 1, 16),)
TILE = (8, 128)     # the JAX output tile of `issue`
SUB = 64            # rows of `body`
WCOL = 128          # candidates of one strip chunk
ROWS = 1024         # rows of one `rowfix` block (16 sub-blocks of 64)
H = 0.1             # the JAX tool's smoothing length
DAM1M_DIMS = (88, 88, 88)  # dam_break(1M)'s grid
# instructions per element of one issue round, and fp32 operations of the
# bound (an FMA is two, as the published peak counts it)
OPS_PER_ROUND = {"fma": 1, "mul": 1, "max": 1, "sub_mul": 1, "rsqrt": 2}
FLOP_PER_ROUND = {"fma": 2, "mul": 1, "max": 1, "sub_mul": 1, "rsqrt": 2}
KERNELS = ("anchor_issue", "anchor_body", "anchor_rowfix")

# the marginal's two sizes, 4x apart: issue iterations (an rsqrt round
# takes 4x an fp32 one), the serial chain's, body iterations, row blocks
FP32_ITERS = (2048, 8192)
RSQRT_ITERS = (256, 1024)
SERIAL_ITERS = (16384, 65536)
BODY_SHAPE = dict(nunroll=8, nch=8)   # the JAX tool's
BODY_ITERS = (32, 128)
ROWFIX_BLOCKS = (16384, 65536)        # 8x the JAX tool's: the host call costs ~80 us


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _issue_round(op: str, c, x, u: int):
    if op == "fma":
        return c * 1.000001 + x
    if op == "mul":
        return c * 1.000001
    if op == "max":
        return torch.maximum(c, x)
    if op == "sub_mul":  # alternating, like dx then dx*dx
        return c - x if u % 2 else c * x
    return torch.rsqrt(c + x)


def _op_id(op: str) -> int:
    if op not in OPS:
        raise ValueError(f"op {op!r} is not one of {OPS}")
    return OPS.index(op)


def issue_plain(x, op: str, nstreams: int, unroll: int, niter: int):
    """(8, 128): `nstreams` carries from x + s, `niter` iterations of
    `unroll` rounds of `op` on each, summed (`tools/anchor_rate.py:89-113`).
    fma rounds twice here, where the kernel's fused multiply-add rounds once."""
    _op_id(op)
    c = x + torch.arange(nstreams, dtype=x.dtype, device=x.device).reshape(-1, 1, 1)
    for _ in range(niter):
        for u in range(unroll):
            c = _issue_round(op, c, x, u)
    acc = c[0]
    for s in range(1, nstreams):
        acc = acc + c[s]
    return acc


def _pair_terms(rows, strip, which: str):
    """(SUB, ncols): each pair's summed carries, the pair terms of
    `csrc/pbf_pair.cuh` (λ: p6 + (dx+dy+dz)*sg; Δp: (dx+dy+dz)*sg)."""
    c = ph.PairConstants.of(H)
    a = rows[:4, :, None]
    b = strip[:, None, :]
    d = a[:3] - b[:3]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    d2p = torch.clamp(c.hh - r2, min=0.0)
    r2c = torch.clamp(r2, min=c.eps2)
    u = torch.rsqrt(r2c)
    tt = torch.clamp(c.h - r2c * u, min=0.0)
    if which == "lambda":
        sg = tt * tt * u
        return d2p * d2p * d2p + d[0] * sg + d[1] * sg + d[2] * sg
    xq = d2p * d2p * d2p * c.xqf
    x2 = xq * xq
    corr = c.corr_k * x2 * x2
    factor = (a[3] + b[3] + corr) * c.rho_recip
    sg = (c.skf * (tt * tt) * u) * factor
    return d[0] * sg + d[1] * sg + d[2] * sg


def chunk_reads(nch: int, nunroll: int, niter: int, stride: int = 0):
    """(nch,) int64: how often the body reads each strip chunk, chunk
    (k + i*stride) mod nch for k < nunroll, i < niter."""
    i = torch.arange(niter, dtype=torch.int64)
    k = torch.arange(nunroll, dtype=torch.int64)
    return torch.bincount(((i[:, None] * stride + k) % nch).reshape(-1), minlength=nch)


def _strip_chunks(which: str, strip) -> int:
    if which not in ("lambda", "delta"):
        raise ValueError(f"which {which!r} is not 'lambda' or 'delta'")
    if strip.dim() != 2 or strip.shape[0] != 4 or strip.shape[1] % WCOL or not strip.shape[1]:
        raise ValueError(f"strip: want (4, nch*{WCOL}), got {tuple(strip.shape)}")
    return strip.shape[1] // WCOL


def body_plain(rows, strip, which: str, nunroll: int, niter: int, stride: int = 0):
    """(SUB,): each of the 64 rows' sum over its pairs of the summed carries
    (`tools/anchor_rate.py:153-196` summed over its 128 lanes).  rows is
    (5, SUB) x, y, z, λ and a spare; strip (4, nch*128) x, y, z, λ."""
    nch = _strip_chunks(which, strip)
    per_chunk = _pair_terms(rows, strip, which).reshape(SUB, nch, WCOL).sum(2)
    reads = chunk_reads(nch, nunroll, niter, stride).to(per_chunk.device, per_chunk.dtype)
    return (per_chunk * reads).sum(1)


def rowfix_index(rows, dims=DAM1M_DIMS) -> ph.CellIndex:
    """The 1024 rows (5, 1024: x, y, z, mass, memberf) as `pbf_lambda`'s
    index: a row with memberf != 0 is a member, two rows to a cell from the
    grid's centre cell on; the cell table is all 0, so every range is empty."""
    nx, ny, nz = dims
    ncells = nx * ny * nz
    centre = (nx // 2) * ny * nz + (ny // 2) * nz + nz // 2
    if centre + ROWS // 2 > ncells:
        raise ValueError(f"grid {dims} too small for {ROWS} rows")
    r = torch.arange(ROWS, device=rows.device)
    key = torch.where(rows[4] != 0, centre + r // 2, ncells).to(torch.int32)
    table = torch.zeros(ncells + 1, dtype=torch.int32, device=rows.device)
    return ph.CellIndex(GridSpec(extent=(nx - 1, ny - 1, nz - 1), maxz=0), key, table)


def rowfix_table_entries(index: ph.CellIndex) -> int:
    """The distinct cell-table entries the row kernel reads: both ends,
    clip(base - 1) and clip(base + 2), of the nine (dx, dy) ranges of every
    member row."""
    _, ny, nz = index.grid.dims
    ncells = index.grid.ncells
    lin = index.key.long()
    lin = lin[lin < ncells]
    off = torch.tensor([ox * ny * nz + oy * nz for ox in (-1, 0, 1) for oy in (-1, 0, 1)],
                       device=lin.device)
    base = lin[:, None] + off
    return int(torch.unique(torch.cat([base - 1, base + 2]).clamp(0, ncells)).numel())


def rowfix_plain(rows, index: ph.CellIndex, nblocks: int):
    """(1, 1024) λ of the rows over `index`, as `pbf_lambda` computes it;
    every one of the `nblocks` replicas gives the same.  memberf only picks
    the member rows, as the port's key does; it scales nothing."""
    _check_rows(rows)
    return ph.lambda_plain(index, H, rows[:3], rows[3]).reshape(1, ROWS)


def _check_rows(rows) -> None:
    if tuple(rows.shape) != (5, ROWS):
        raise ValueError(f"rows: want (5, {ROWS}), got {tuple(rows.shape)}")


# ---------------------------------------------------------------------------
# CUDA kernel launchers
# ---------------------------------------------------------------------------


def _check_card(**tensors) -> torch.device:
    """Each value is (tensor, dtype, shape); raise unless all are contiguous
    tensors of that dtype and shape on one CUDA device."""
    dev = next(iter(tensors.values()))[0].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    for name, (t, dtype, shape) in tensors.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
                or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: want a contiguous {dtype} {tuple(shape)} tensor on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")
    return dev


def fill_threads(device, kernel: str, op: str = "fma", nstreams: int = 0,
                 unroll: int = 0, nch: int = 0) -> int:
    """Threads that fill every SM of the card at the kernel's occupancy:
    kernel "issue" (op, nstreams, unroll) or "lambda"/"delta" (nch)."""
    ids = {"issue": 0, "lambda": 1, "delta": 2}
    lib = cuda_build.library()
    with torch.cuda.device(device):
        n = lib.anchor_fill_threads(ids[kernel], _op_id(op), nstreams, unroll, nch)
    if n <= 0:
        raise ValueError(f"csrc/anchor_rate.cu has no {kernel} kernel for op {op}, "
                         f"nstreams {nstreams}, unroll {unroll}, nch {nch}")
    return n


def _threads(nthreads: int, least: int) -> int:
    if nthreads < least:
        raise ValueError(f"nthreads {nthreads} < {least}: the output needs them")
    return nthreads


def issue_kernel(x, op: str, nstreams: int, unroll: int, niter: int,
                 nthreads: Optional[int] = None):
    """(8, 128) from `anchor_issue` (replaces `build_issue`'s kernel),
    over `nthreads` threads (default: the card filled; else a multiple of
    256, or of 32 for blocks of one warp); thread t computes element t mod
    1024.  A shape with no instantiation raises."""
    dev = _check_card(x=(x, torch.float32, TILE))
    opid = _op_id(op)
    if nthreads is None:
        nthreads = fill_threads(dev, "issue", op, nstreams, unroll)
    out = torch.empty(_threads(nthreads, ROWS), dtype=x.dtype, device=dev)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = lib.anchor_issue(x.data_ptr(), opid, nstreams, unroll, niter, nthreads,
                               out.data_ptr(), ph._stream(dev))
    cuda_build.check("anchor_issue", err)
    return out[:ROWS].view(TILE)


def body_kernel(rows, strip, which: str, nunroll: int, niter: int, stride: int = 0,
                nthreads: Optional[int] = None):
    """(SUB,) from `anchor_body` (replaces `build_body`'s kernel), over
    `nthreads` threads (default: the card filled); thread t takes row t mod 64."""
    nch = _strip_chunks(which, strip)
    dev = _check_card(rows=(rows, torch.float32, (5, SUB)),
                      strip=(strip, torch.float32, (4, nch * WCOL)))
    if nthreads is None:
        nthreads = fill_threads(dev, which, nch=nch)
    out = torch.empty(_threads(nthreads, SUB), dtype=rows.dtype, device=dev)
    c = ph.PairConstants.of(H)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = lib.anchor_body(rows.data_ptr(), strip.data_ptr(), int(which == "lambda"), nch,
                              nunroll, niter, stride, c.h, c.hh, c.eps2, c.skf, c.xqf,
                              c.corr_k, c.rho_recip, nthreads, out.data_ptr(),
                              ph._stream(dev))
    cuda_build.check("anchor_body", err)
    return out[:SUB]


def rowfix_kernel(rows, index: ph.CellIndex, nblocks: int):
    """(1, 1024) λ from `anchor_rowfix` (replaces `build_subfix`'s kernel):
    `nblocks` x 1024 threads, thread t computing row t mod 1024."""
    _check_rows(rows)
    if nblocks < 1:
        raise ValueError(f"nblocks {nblocks} < 1")
    ncells = index.grid.ncells
    dev = _check_card(rows=(rows, torch.float32, (5, ROWS)),
                      key=(index.key, torch.int32, (ROWS,)),
                      table=(index.table, torch.int32, (ncells + 1,)))
    cand = rows[:4].t().contiguous()  # (1024, 4) x, y, z, mass
    lam = torch.empty(nblocks * ROWS, dtype=rows.dtype, device=dev)
    _, ny, nz = index.grid.dims
    c = ph.PairConstants.of(H)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = lib.anchor_rowfix(cand.data_ptr(), index.key.data_ptr(), index.table.data_ptr(),
                                lam.numel(), ROWS, ny, nz, ncells, c.h, c.hh, c.eps2, c.p6f,
                                c.c_grad, c.rho_recip, c.cfm, lam.data_ptr(), ph._stream(dev))
    cuda_build.check("anchor_rowfix", err)
    return lam[:ROWS].view(1, ROWS)


class Anchor:
    """The three wrappers, with a launch counter per kernel: `launches[name]`
    starts at 0 and grows by one each time a wrapper launches its CUDA
    kernel, and at no other time.  A CPU tensor takes the plain version,
    where `nthreads` means nothing."""

    def __init__(self):
        self.launches = dict.fromkeys(KERNELS, 0)

    def issue(self, x, op: str, nstreams: int, unroll: int, niter: int,
              nthreads: Optional[int] = None):
        if x.device.type == "cpu":
            return issue_plain(x, op, nstreams, unroll, niter)
        out = issue_kernel(x, op, nstreams, unroll, niter, nthreads)
        self.launches["anchor_issue"] += 1
        return out

    def body(self, rows, strip, which: str, nunroll: int, niter: int, stride: int = 0,
             nthreads: Optional[int] = None):
        if rows.device.type == "cpu":
            return body_plain(rows, strip, which, nunroll, niter, stride)
        out = body_kernel(rows, strip, which, nunroll, niter, stride, nthreads)
        self.launches["anchor_body"] += 1
        return out

    def rowfix(self, rows, index: ph.CellIndex, nblocks: int):
        if rows.device.type == "cpu":
            return rowfix_plain(rows, index, nblocks)
        out = rowfix_kernel(rows, index, nblocks)
        self.launches["anchor_rowfix"] += 1
        return out


# ---------------------------------------------------------------------------
# The SASS of the built kernels
# ---------------------------------------------------------------------------

_INST = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_PRED = re.compile(r"^@!?U?P[0-9T]+\s+")
# each issue op's instructions, and the fp32-pipe opcodes of a pair
OP_OPCODES = {"fma": ("FFMA",), "mul": ("FMUL",), "max": ("FMNMX",),
              "sub_mul": ("FMUL", "FADD"), "rsqrt": ("MUFU.RSQ",)}
FP32_OPCODES = ("FFMA", "FADD", "FMUL", "FMNMX", "FSETP", "FSEL", "FSET")

Sass = Tuple[List[Tuple[int, str, str]], Dict[str, int]]


def sass_functions(lib_path) -> Dict[str, Sass]:
    """`parse_sass` of the library's `cuobjdump -sass`."""
    tool = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
    return parse_sass(subprocess.run([str(tool), "-sass", str(lib_path)],
                                     capture_output=True, text=True, check=True).stdout)


def parse_sass(text: str) -> Dict[str, Sass]:
    """{mangled kernel name: ([(address, opcode, instruction)], {label:
    address})} of a `cuobjdump -sass` listing."""
    funcs: Dict[str, Sass] = {}
    insts: Optional[list] = None
    labels: Dict[str, int] = {}
    pending: List[str] = []
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            insts, labels, pending = [], {}, []
            funcs[m.group(1)] = (insts, labels)
        elif insts is not None and _LABEL.match(line):
            pending.append(_LABEL.match(line).group(1))
        elif insts is not None and _INST.search(line):
            m = _INST.search(line)
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            inst = _PRED.sub("", m.group(2).strip())
            insts.append((addr, inst.split()[0], inst))
    return funcs


def _opcode_key(op: str) -> str:
    base = op.split(".")[0]
    return op if base in ("MUFU", "LDS", "LDG") else base


def innermost_loops(sass: Sass) -> List[collections.Counter]:
    """Opcode counts of each innermost loop: the span of a backward branch
    that holds no other such span."""
    return [collections.Counter(_opcode_key(op) for a, op, _ in sass[0] if lo <= a <= hi)
            for lo, hi in innermost_spans(sass)]


def innermost_spans(sass: Sass) -> List[Tuple[int, int]]:
    """(first, last) address of each innermost loop: the span of a backward
    branch that holds no other such span; the last is the branch's own."""
    insts, labels = sass
    spans = []
    for addr, op, inst in insts:
        if not op.startswith("BRA"):
            continue
        target = branch_target(inst, labels)
        if target is not None and target <= addr:
            spans.append((target, addr))
    return [s for s in spans
            if not any(o != s and s[0] <= o[0] and o[1] <= s[1] for o in spans)]


def branch_target(inst: str, labels: Dict[str, int]) -> Optional[int]:
    """The address a branch instruction jumps to: its label, or the address
    it prints; None if it names neither."""
    m = re.search(r"\(\s*(\.L_x_\d+)\s*\)", inst)
    if m is not None:
        return labels.get(m.group(1))
    h = re.search(r"0x([0-9a-f]+)", inst)
    return int(h.group(1), 16) if h else None


def _one(funcs: Dict[str, Sass], pattern: str) -> Sass:
    names = [n for n in funcs if pattern in n]
    if len(names) != 1:
        raise RuntimeError(f"{len(names)} kernels of the library match {pattern!r}")
    return funcs[names[0]]


def pair_loop(sass: Sass) -> collections.Counter:
    """The innermost loop with the most MUFU.RSQ (one a pair): a kernel's
    unrolled pair loop; empty if it has none."""
    loops = [c for c in innermost_loops(sass) if c["MUFU.RSQ"]]
    return max(loops, key=lambda c: c["MUFU.RSQ"]) if loops else collections.Counter()


def fp32_per_pair(loop: collections.Counter) -> Dict[str, float]:
    """{fp32-pipe opcode: instructions a pair} of a pair loop."""
    rsq = max(loop["MUFU.RSQ"], 1)
    return {k: loop[k] / rsq for k in FP32_OPCODES if loop[k]}


def _ldg32(sass: Sass) -> int:
    return sum(1 for _, op, _ in sass[0] if op.startswith("LDG") and "128" not in op)


# the phase kernels of csrc/pbf_phases.cu whose pair loop the anchor measures
PHASE_KERNELS = {"lambda": "13lambda_kernelEPK6float4", "delta": "12delta_kernelEPK6float4"}


def check_sass(lib_path) -> Dict[str, dict]:
    """`check_funcs` of the built library."""
    return check_funcs(sass_functions(lib_path))


def check_funcs(funcs: Dict[str, Sass]) -> Dict[str, dict]:
    """name -> dict(ok, counts): every issue instantiation's loop holds
    nstreams*unroll instructions of its op (or a multiple, where the compiler
    unrolled the iteration loop), with an FADD beside each MUFU.RSQ and as
    many FMUL as FADD for sub_mul, and all its instructions (the loop's own
    included) a round; the phase kernels `pbf_lambda` and `pbf_delta` their
    pair loop, one MUFU.RSQ and one float4 load (LDG.128) a pair; each body's
    pair loop one MUFU.RSQ and one shared-memory float4 read (LDS.128) a
    pair and, opcode by opcode, the fp32-pipe instructions a pair of its
    phase kernel's loop, so that the anchor cannot drift from the code it
    measures; the row kernel the 32-bit loads of `pbf_lambda` (the key and
    the two cell-table reads of the nine-range loop) and its pair loop."""
    report = {}
    for op, ns, un in OP_SHAPES:
        kinds = OP_OPCODES[op]
        loops = [c for c in innermost_loops(_one(
            funcs, f"issue_kernelILi{_op_id(op)}ELi{ns}ELi{un}E")) if any(c[k] for k in kinds)]
        counts = [sum(c[k] for k in kinds) for c in loops]
        ok = bool(loops) and all(n % (ns * un) == 0 for n in counts)
        if op == "sub_mul":
            ok = ok and all(c["FMUL"] == c["FADD"] for c in loops)
        if op == "rsqrt":
            ok = ok and all(c["FADD"] >= c["MUFU.RSQ"] for c in loops)
        report[f"issue {op} {ns}x{un}"] = dict(
            ok=ok, want=ns * un, loops=counts,
            insts_per_round=sum(loops[0].values()) / counts[0] if loops else 0.0)
    phase = {}
    for which, pattern in PHASE_KERNELS.items():
        main = pair_loop(_one(funcs, pattern))
        phase[which] = fp32_per_pair(main)
        rsq = max(main["MUFU.RSQ"], 1)
        ldg = sum(v for k, v in main.items() if k.startswith("LDG") and "128" in k)
        report[f"pbf_{which}"] = dict(
            ok=main["MUFU.RSQ"] > 0 and main["MUFU.RSQ"] == ldg, pairs_a_loop=main["MUFU.RSQ"],
            fp32_per_pair=sum(phase[which].values()), insts_per_pair=sum(main.values()) / rsq)
    for which, flag in (("lambda", 1), ("delta", 0)):
        main = pair_loop(_one(funcs, f"body_kernelILb{flag}E"))
        lds = sum(v for k, v in main.items() if k.startswith("LDS") and "128" in k)
        per_pair = fp32_per_pair(main)
        rsq = max(main["MUFU.RSQ"], 1)
        report[f"body {which}"] = dict(
            ok=main["MUFU.RSQ"] > 0 and main["MUFU.RSQ"] == lds and per_pair == phase[which],
            pairs_a_loop=main["MUFU.RSQ"], fp32_per_pair=sum(per_pair.values()),
            insts_per_pair=sum(main.values()) / rsq, same_as_phase=per_pair == phase[which])
    rowfix = _one(funcs, "rowfix_kernel")
    want = _ldg32(_one(funcs, PHASE_KERNELS["lambda"]))
    same = fp32_per_pair(pair_loop(rowfix)) == phase["lambda"]
    report["rowfix"] = dict(ok=want >= 3 and _ldg32(rowfix) == want and same,
                            want=want, ldg32=_ldg32(rowfix), same_as_phase=same)
    return report


# ---------------------------------------------------------------------------
# Inputs, parity and the rates
# ---------------------------------------------------------------------------


def tool_inputs(device):
    """The JAX tool's inputs: x = 1.0000001; body rows 0.05 and strip 0.055
    (every pair alike, within h); 1024 rows of 0.05 (memberf 0.05: members)."""
    return (torch.full(TILE, 1.0000001, device=device),
            torch.full((5, SUB), 0.05, device=device),
            torch.full((4, BODY_SHAPE["nch"] * WCOL), 0.055, device=device),
            torch.full((5, ROWS), 0.05, device=device))


def random_body_inputs(seed: int, nch: int, device="cpu"):
    """(rows (5, SUB), strip (4, nch*128)) from `seed`: rows in [0.5, 0.51]^3,
    candidates in [0.47, 0.49]^3 (every pair within h, dx, dy, dz > 0), λ in
    [-2, -0.5]: every term of a row's sum has the same sign."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((5, SUB), np.float32)
    rows[:3] = rng.uniform(0.5, 0.51, (3, SUB))
    rows[3] = rng.uniform(-2.0, -0.5, SUB)
    strip = np.empty((4, nch * WCOL), np.float32)
    strip[:3] = rng.uniform(0.47, 0.49, (3, nch * WCOL))
    strip[3] = rng.uniform(-2.0, -0.5, nch * WCOL)
    return torch.from_numpy(rows).to(device), torch.from_numpy(strip).to(device)


def card_parity(device, seed: int = 0) -> Dict[str, Tuple[float, bool]]:
    """Each kernel against its plain version on the card, its launches not
    counted; label -> (max abs err, within tolerance).  Every issue
    instantiation at niter 8 on x = 1 + U(0, 1e-3); the λ and Δp bodies on
    random rows and strips at (nunroll, nch, niter) (2, 2, 3) and (8, 8, 4);
    both rtol 1e-5, atol 1e-6.  rowfix at 1 and 8 blocks, atol 1e-9."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((1 + 1e-3 * rng.random(TILE)).astype(np.float32)).to(device)
    res = {}

    def close(label, got, want, **tol):
        res[label] = (float((got - want).abs().max()), torch.allclose(got, want, **tol))

    for op, ns, un in OP_SHAPES:
        close(f"issue {op} {ns}x{un}", issue_kernel(x, op, ns, un, 8),
              issue_plain(x, op, ns, un, 8), rtol=1e-5, atol=1e-6)
    for nunroll, nch, niter in ((2, 2, 3), (8, 8, 4)):
        rows, strip = random_body_inputs(seed, nch, device)
        for which in ("lambda", "delta"):
            close(f"body {which} ({nunroll}, {nch}, {niter})",
                  body_kernel(rows, strip, which, nunroll, niter),
                  body_plain(rows, strip, which, nunroll, niter), rtol=1e-5, atol=1e-6)
    frows = tool_inputs(device)[3]
    index = rowfix_index(frows)
    for nblocks in (1, 8):
        close(f"rowfix {nblocks} blocks", rowfix_kernel(frows, index, nblocks),
              rowfix_plain(frows, index, nblocks), rtol=0, atol=1e-9)
    return res


class ClockSampler:
    """`nvidia-smi` reading the card's SM clock every 100 ms while open;
    `mhz` holds the readings after it closes."""

    def __init__(self, device):
        self.index = torch.device(device).index or 0
        self.mhz: List[int] = []

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
             "-lms", "100", "-i", str(self.index)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc) -> None:
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.mhz = [int(v) for v in out.split() if v.isdigit()]

    def summary(self) -> Optional[dict]:
        """min, median, max and count of the readings; None without any."""
        mhz = self.mhz
        return (dict(min=min(mhz), median=statistics.median(mhz), max=max(mhz),
                     samples=len(mhz)) if mhz else None)


# cycles of the spin kernel that holds the device while the host enqueues a
# reading's calls: ~25 ms at 1980 MHz, above the enqueue time of any reading
HOLD_CYCLES = 50_000_000


def held_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over `reps` back-to-back calls, after one warm
    call.  A spin kernel holds the device while the host enqueues the calls,
    so where a wrapper's host work outruns its kernel, the reading is still
    the device's: CUDA events alone would time the host's enqueue."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def marginal(run, sizes: Tuple[int, int], reps: int) -> Tuple[float, float, float]:
    """(seconds, t_lo ms, t_hi ms): the device time that the larger size adds
    to the smaller, over which launch cost and ramp cancel (`held_ms`).
    Raises unless the time grows with the size: every pair of sizes here is
    4x apart, and the larger takes at least 2x the time."""
    lo, hi = sizes
    t_lo = held_ms(lambda: run(lo), reps)
    t_hi = held_ms(lambda: run(hi), reps)
    if not t_hi >= 2 * t_lo:
        raise RuntimeError(f"the time does not scale with the size: {t_lo:.4f} ms at "
                           f"{lo}, {t_hi:.4f} ms at {hi}")
    return (t_hi - t_lo) * 1e-3, t_lo, t_hi


def body_rate(anchor: Anchor, which: str, reps: int, device) -> dict:
    """The λ or Δp body ceiling through `anchor` at the JAX tool's inputs
    and BODY_SHAPE, the card filled: dict(threads, iters, ms, rate in
    pair-slots/s)."""
    _, rows, strip, _ = tool_inputs(device)
    nunroll, nch = BODY_SHAPE["nunroll"], BODY_SHAPE["nch"]
    n = fill_threads(device, which, nch=nch)
    dt, t_lo, t_hi = marginal(
        lambda it: anchor.body(rows, strip, which, nunroll, it, 0, n), BODY_ITERS, reps)
    pairs = (BODY_ITERS[1] - BODY_ITERS[0]) * n * nunroll * WCOL
    return dict(threads=n, iters=list(BODY_ITERS), ms=[t_lo, t_hi], rate=pairs / dt)


def read_rates(anchor: Anchor, dims, reps: int, device) -> dict:
    """Every rate of the tool, through `anchor`'s wrappers (counted), at the
    JAX tool's inputs, with the SM clock sampled beside: the issue rates
    (ops/s; the serial fma chain on one warp per SM, its ns per dependent
    op: a latency), the body ceilings (pair-slots/s) and the row fixed cost (ns/row)."""
    x, _, _, frows = tool_inputs(device)
    index = rowfix_index(frows, dims)
    sms =torch.cuda.get_device_properties(device).multi_processor_count
    res = {"issue": {}, "body": {}}
    with ClockSampler(device) as clock:
        for op, ns, un in OP_SHAPES:
            serial = ns == 1
            n = 32 * sms if serial else fill_threads(device, "issue", op, ns, un)
            sizes = SERIAL_ITERS if serial else RSQRT_ITERS if op == "rsqrt" else FP32_ITERS
            dt, t_lo, t_hi = marginal(
                lambda it: anchor.issue(x, op, ns, un, it, n), sizes, reps)
            steps = (sizes[1] - sizes[0]) * un
            entry = dict(threads=n, iters=list(sizes), ms=[t_lo, t_hi],
                         rate=steps * n * ns * OPS_PER_ROUND[op] / dt)
            if serial:
                entry["ns_per_op"] = dt * 1e9 / steps
            res["issue"][f"{op} {ns}x{un}"] = entry
        for which in ("lambda", "delta"):
            res["body"][which] = body_rate(anchor, which, reps, device)
        dt, t_lo, t_hi = marginal(lambda nb: anchor.rowfix(frows, index, nb),
                                  ROWFIX_BLOCKS, reps)
        res["rowfix"] = dict(blocks=list(ROWFIX_BLOCKS), ms=[t_lo, t_hi],
                             ns_per_row=dt * 1e9 / ((ROWFIX_BLOCKS[1] - ROWFIX_BLOCKS[0]) * ROWS))
    res["clocks_sm_mhz"] = clock.summary()
    return res


# ---------------------------------------------------------------------------
# The decomposition at dam1m
# ---------------------------------------------------------------------------


def settled_dam1m(count: int = 1_000_000):
    """(spec, sort-time frame) of dam_break(count, 6) after the growth warmup
    of `bench.warm_up` over 5 frames and one more advect and sort, as
    `bench_phases` takes it."""
    from pbf_sph_tpu_torch.bench import warm_up
    from pbf_sph_tpu_torch.core.configs import dam_break
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import (
        TorchSolver, advect_and_sort, dyn_params_of)

    mc, cfg, xs = dam_break(count, solver_iter=6)
    solver = TorchSolver(h=cfg.h, device="cuda")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, solver.dtype, solver.device)
    spec, state, _ = warm_up(solver, spec, state, dyn, scn, xs, 5)
    return spec, advect_and_sort(spec, state, dyn, scn)


def decompose(rates: dict, sass: dict, spec, fr, reps: int) -> dict:
    """`pbf_lambda` and `pbf_delta` at the frame (CUDA events: the kernel
    launched on a (C, 4) pack made beforehand, and `ops/phases.py`'s wrapper,
    which makes the pack, beside it) against the model member rows x the row
    fixed cost + per-row pairs / the body ceiling; the rest is the range
    walk, the L1/L2 reads of the candidates and occupancy.  Each kernel's
    fp32 issue share counts its own pair loop's instructions (the SASS)."""
    from pbf_sph_tpu_torch.core.types import FLUID
    from pbf_sph_tpu_torch.tools.bench_kernel_variants import device_ms

    st, idx, h = fr.state, fr.index, spec.h
    members = int(idx.table[-1])
    lo, hi = ph.neighbour_ranges(idx)
    pairs = int((hi - lo).sum())
    lam = torch.where((st.ptype == FLUID) & st.alive,
                      ph.lambda_kernel(idx, h, fr.pstar, st.mass), 0.0)
    runs = {
        "lambda": (lambda: ph.lambda_kernel(idx, h, fr.pstar, st.mass), ph.lambda_launch,
                   st.mass, torch.empty_like(st.mass)),
        "delta": (lambda: ph.delta_kernel(idx, h, fr.pstar, lam), ph.delta_launch,
                  lam, torch.empty_like(fr.pstar)),
    }
    fma = rates["issue"]["fma 16x16"]["rate"]
    fixed_s = rates["rowfix"]["ns_per_row"] * 1e-9
    out = dict(capacity=spec.capacity, members=members, pairs=pairs)
    for which, (wrapper, launch, w, res) in runs.items():
        cand = torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], w], dim=1)
        ms = device_ms(lambda: launch(idx, h, cand, res), reps)
        wrapper_ms = device_ms(wrapper, reps)
        body = rates["body"][which]["rate"]
        per_pair = sass[f"pbf_{which}"]["fp32_per_pair"]
        fixed_ms = members * fixed_s * 1e3
        anchored_ms = pairs / body * 1e3
        out[which] = dict(
            kernel_ms=ms, wrapper_ms=wrapper_ms, body_rate=body,
            body_fp32_share=body * sass[f"body {which}"]["fp32_per_pair"] / fma,
            fp32_per_pair=per_pair, fixed_ms=fixed_ms, anchored_ms=anchored_ms,
            model_ms=fixed_ms + anchored_ms, remainder_ms=ms - fixed_ms - anchored_ms,
            share_of_ceiling=anchored_ms / ms, wrapper_share_of_ceiling=anchored_ms / wrapper_ms,
            kernel_fp32_share=pairs * per_pair / (ms * 1e-3) / fma)
    return out


def main(argv=None) -> int:
    from pbf_sph_tpu_torch.tools.bench_kernel_variants import card_line

    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 10
    if not torch.cuda.is_available():
        raise SystemExit("anchor_rate: needs a CUDA device")
    card = card_line()
    print(card)
    device = torch.device("cuda", torch.cuda.current_device())

    print("== SASS of csrc/anchor_rate.cu (cuobjdump)")
    cuda_build.library()
    sass = check_sass(cuda_build.library_path())
    for name, r in sass.items():
        print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in r.items()))
    short = [name for name, r in sass.items() if not r["ok"]]
    if short:
        raise SystemExit(f"anchor_rate: the SASS of {short} is short: the compiler folded "
                         f"the work, so no rate of it is printed")
    parity = card_parity(device)
    print("== each kernel against its plain version: " + ", ".join(
        f"{k} {e:.3e}" for k, (e, _) in parity.items()))
    wrong = [k for k, (_, ok) in parity.items() if not ok]
    if wrong:
        raise SystemExit(f"anchor_rate: {wrong} disagree with their plain versions")

    spec, fr = settled_dam1m()
    rates = read_rates(Anchor(), spec.grid.dims, reps, device)
    clocks = rates["clocks_sm_mhz"]
    print(f"== SM clock beside the rate runs (nvidia-smi, MHz): {clocks}")
    fma = rates["issue"]["fma 16x16"]["rate"]
    print("== A. fp32 issue rate (an op = one instruction on one element; rsqrt counts "
          "its add and the rsqrt; marginal between two sizes)")
    for name, r in rates["issue"].items():
        extra = f", {r['ns_per_op']:.3f} ns a dependent op" if "ns_per_op" in r else ""
        print(f"  {name:12s} ({r['threads']} threads, iterations {r['iters']}: "
              f"{r['ms'][0]:.4f}, {r['ms'][1]:.4f} ms): {r['rate'] / 1e12:.3f} T ops/s, "
              f"{r['rate'] / fma:.3f} of fma{extra}")
    print(f"== B. pair-chain bodies (nunroll {BODY_SHAPE['nunroll']}, nch "
          f"{BODY_SHAPE['nch']}, strip in shared memory)")
    for which, r in rates["body"].items():
        s = sass[f"body {which}"]
        print(f"  {which:6s} ({r['threads']} threads, iterations {r['iters']}: "
              f"{r['ms'][0]:.4f}, {r['ms'][1]:.4f} ms): {r['rate'] / 1e9:.1f} G pair-slots/s; "
              f"{s['fp32_per_pair']:.2f} fp32-pipe and {s['insts_per_pair']:.2f} instructions "
              f"a pair = {r['rate'] * s['fp32_per_pair'] / fma:.3f} of the fma rate")
    r = rates["rowfix"]
    print(f"== C. row fixed cost (blocks of {ROWS} rows {r['blocks']}: {r['ms'][0]:.4f}, "
          f"{r['ms'][1]:.4f} ms): {r['ns_per_row']:.5f} ns a row on the whole card")

    dec = decompose(rates, sass, spec, fr, reps)
    print(f"== D. dam_break(1M, 6) settled sort-time state: {dec['members']} member rows "
          f"of {dec['capacity']}, {dec['pairs']} per-row candidate pairs")
    for which in ("lambda", "delta"):
        d = dec[which]
        print(f"  pbf_{which}: kernel {d['kernel_ms']:.4f} ms on a prebuilt (C, 4) pack "
              f"(the wrapper, which makes the pack, {d['wrapper_ms']:.4f} ms)\n"
              f"    body ceiling {d['body_rate'] / 1e9:.1f} G pair-slots/s, its fp32 issue "
              f"{d['body_fp32_share']:.3f} of the fma rate\n"
              f"    model {d['model_ms']:.4f} ms = rows x fixed {d['fixed_ms']:.4f} + pairs / "
              f"body rate {d['anchored_ms']:.4f}; remainder (range walk, L1/L2 reads, "
              f"occupancy) {d['remainder_ms']:.4f} ms\n"
              f"    the kernel at {d['share_of_ceiling']:.3f} of the body ceiling (the wrapper "
              f"{d['wrapper_share_of_ceiling']:.3f}); its fp32 issue ({d['fp32_per_pair']:.2f} a "
              f"pair in its own loop) {d['kernel_fp32_share']:.3f} of the fma rate")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "reps": reps,
                      "sass": sass, "parity": {k: e for k, (e, _) in parity.items()},
                      "rates": rates, "dam1m": dec}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
