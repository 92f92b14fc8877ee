"""The v2 compacted-candidate neighbour phases: plan, compaction, lambda2,
delta2 and diffuse2.

Port of `tools/pallas_pbf2.py`, the JAX package's second neighbour-phase
pipeline.  It is retired from the solver there and kept for ablation runs;
here too no `TorchSolver` path runs it: `tools/bench_phases.py` and
`chip_smoke.py` drive it.  Per frame:

1. `plan_compact` (plain torch on every device; XLA in JAX): each 32-row
   sub-block's nine stencil windows, gap-split into up to 36 intervals, are
   merged into one list of 128-column source chunks (`meta`, `nchunk`,
   `nchunkp`, `sstart`), with the strip and slab overflows.
2. The compaction copies those chunks of an (nf, C) field pack into a dense
   (nf, C/32 * wcap) slab, SENTINEL-filling chunks [nchunk, nchunkp).
3. The dense phases evaluate every row of a sub-block against every slab
   column below nchunkp*128.  Slab lanes that are not true neighbours are
   rejected by geometry: spilled head/tail lanes lie >= 2 cells away along
   the sort axis (> h), non-member slots carry x = SENTINEL, the fill is
   SENTINEL throughout; diffuse2 uses the exact cell-band test.

As in `ops/phases.py` each kernel has a launcher (`compact_kernel`,
`lambda2_kernel`, `delta2_kernel`, `diffuse2_kernel`: the CUDA kernels of
`csrc/pbf_phases2.cu`) and a plain PyTorch version of the same signature;
`PbfPhases2` picks between them by the device of its tensors alone and
counts kernel launches.  A launcher raises on a tensor it does not take.

Pair math as in Pallas: r2 clamped to EPSILON^2 from below, the rsqrt form
of the spiky gradient, no per-pair mask.  The one deliberate difference:
the Pallas diffuse2 reduces its colour sums with a default-precision matmul
(`_nt_dot`, bf16 passes on a TPU); the port sums exact fp32 products.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pbf_sph_tpu_torch.core.types import FLUID, OBSTACLE
from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops.grid import GridSpec
from pbf_sph_tpu_torch.ops.phases import (
    PairConstants,
    _stream,
    clamp_to_bounds,
    mix_colour,
)

BLK = 1024          # rows per Pallas block: the strip starts are per block
SUB = 32            # rows per sub-block (one compacted candidate slab each)
NSUB = BLK // SUB
WCOL = 128          # columns per slab chunk
UNROLL = 4          # the plan pads nchunk to a multiple: nchunkp
NPIECES = 4         # gap-split pieces per sub-block (top NPIECES-1 cell gaps)
NIV = 9 * NPIECES   # stencil intervals per sub-block after gap splitting
GAP_MIN = 6         # split only at cell-id gaps larger than this
# capacity bounds of the Pallas kernels' VMEM blocks, kept so the port grows
# and fails where the JAX package does
WCAP_MAX = 5120
STRIP_MAX = 24576
SENTINEL = np.float32(1.0e9)

Wins = Dict[str, torch.Tensor]


def default_wcap() -> int:
    """The starting slab capacity of `pallas_pbf2.py:102-106`."""
    return 2560


def default_strip_capacity(dims: Sequence[int], capacity: int) -> int:
    """smax as `tools/bench_phases.py:122-123` sets it: nz*96 columns rounded
    up to 128, at least 8192, at most the capacity."""
    smax = max(8192, -(-(dims[2] * 48 * 2) // 128) * 128)
    return min(-(-smax // 128) * 128, capacity)


def grown_wcap(wcap: int, overflow: int) -> int:
    g = UNROLL * WCOL
    need = wcap + int(overflow) + g
    return min(-(-need // g) * g, WCAP_MAX)


def grown_strip_capacity(dims: Sequence[int], strip_capacity, capacity: int,
                         overflow: int) -> int:
    """Next per-dx-strip capacity after an overflow of `overflow` columns
    (`pallas_pbf2.py:115-124`, which reads `dims`, `strip_capacity` and
    `capacity` from its step spec).  Capped at STRIP_MAX: a capped value that
    still overflows fails the caller."""
    nz = dims[2]
    base = strip_capacity or max(8192, -(-(nz * 48 * 2) // 128) * 128)
    need = base + int(overflow)
    return min(-(-need // 2048) * 2048 + 2048, capacity, STRIP_MAX)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


def _exclusive_cummax(x: torch.Tensor) -> torch.Tensor:
    """max(x[:, :i]) per column i, 0 for the first."""
    return F.pad(torch.cummax(x, dim=1).values[:, :-1], (1, 0))


def plan_compact(sorted_key, cell_table, grid: GridSpec, capacity: int,
                 smax: int, wcap: int) -> Tuple[Wins, Dict[str, torch.Tensor]]:
    """Per-frame compaction plan, op for op as `pallas_pbf2.py:127-300`, on
    the device of `sorted_key` with no host reads: `plan_pieces`, then
    `plan_intervals`, then `plan_chunks` (the stages `tools/micro_plan.py`
    times one by one).

    Returns (wins, overflows):
      wins = dict(
        meta    (nsub, wcap//128) int32: per slab chunk, strip*8192 + the
                source chunk relative to that strip's start,
        nchunk  (nsub,) int32: slab chunks per sub-block,
        nchunkp (nsub,) int32: nchunk rounded up to UNROLL,
        sstart  (nblocks, 3) int32: 128-aligned per-dx strip start columns)
      overflows = dict(strip_overflow, wcap_overflow), 0-d int32.

    Integer arithmetic runs in int64 (torch indexes with it); every value
    fits int32, so the results are those of the JAX int32 plan.  Two sorts
    take the place of JAX's: `lax.top_k` (the lower index among equal gaps)
    becomes a stable descending sort, and the interval sort by `lo` (not
    stable in JAX) a stable one.  Where two intervals share a `lo`, the strip
    a chunk is read through may differ from JAX's; the absolute source chunk
    of every slot and `nchunk` do not (`source_columns`)."""
    pieces = plan_pieces(sorted_key, cell_table, grid, capacity, smax)
    lo, hi, strip_of = plan_intervals(pieces, cell_table, grid)
    wins, wcap_overflow = plan_chunks(lo, hi, strip_of, pieces["sstart"], smax, wcap)
    i32 = torch.int32
    overflows = dict(strip_overflow=pieces["strip_overflow"].to(i32),
                     wcap_overflow=wcap_overflow.to(i32))
    return wins, overflows


def plan_pieces(sorted_key, cell_table, grid: GridSpec, capacity: int,
                smax: int) -> Dict[str, torch.Tensor]:
    """The plan's first stage: the rows' cells (the tail of non-members
    given the last member's), the per-block per-dx strip starts and the
    strip overflow, and each sub-block's cell range gap-split into NPIECES
    pieces at its top NPIECES-1 cell-id gaps larger than GAP_MIN.  Returns
    dict(pmin, pmax (nsub, NPIECES) int64: the pieces' first and last cells,
    sstart (nblocks, 3) int64: 128-aligned strip starts, strip_overflow
    0-d)."""
    C = capacity
    assert C % BLK == 0
    nblocks = C // BLK
    ncells = grid.ncells
    _, ny, nz = grid.dims
    nynz = ny * nz
    dev = sorted_key.device
    table = cell_table.long()

    lin = torch.clamp(sorted_key.long(), max=ncells - 1)
    # the tail of non-members takes the last member's cell; a 1-element
    # gather keeps the member count on the device
    lin = torch.minimum(lin, lin[torch.clamp(table[ncells:] - 1, min=0)])
    cmin = lin[0::SUB]                                          # (nsub,)
    cmax = lin[SUB - 1::SUB]
    nsub = cmin.shape[0]

    # per-block per-dx strip starts (128-aligned) and content ends
    cmin_b = cmin.reshape(nblocks, NSUB)[:, :1]
    cmax_b = cmax.reshape(nblocks, NSUB)[:, -1:]
    dxo = torch.tensor([-nynz, 0, nynz], device=dev)
    sstart = table[torch.clamp(cmin_b + dxo - nz - 1, 0, ncells)]   # (nblocks, 3)
    send = table[torch.clamp(cmax_b + dxo + nz + 2, 0, ncells)]
    sstart_al = torch.clamp(sstart // WCOL * WCOL, max=max(C - smax, 0))
    need = (send - sstart_al + WCOL - 1) // WCOL * WCOL
    strip_overflow = torch.clamp(need.max() - smax, min=0)

    # gap-split each sub-block's cell range into NPIECES pieces at its top
    # NPIECES-1 cell-id gaps larger than GAP_MIN
    linr = lin[:nsub * SUB].reshape(nsub, SUB)
    gaps = linr[:, 1:] - linr[:, :-1]                           # (nsub, SUB-1)
    gval, gidx = torch.sort(gaps, dim=1, descending=True, stable=True)
    gval, gidx = gval[:, :NPIECES - 1], gidx[:, :NPIECES - 1]
    gidx = torch.sort(torch.where(gval > GAP_MIN, gidx, SUB - 1), dim=1).values
    starts = F.pad(torch.clamp(gidx + 1, max=SUB - 1), (1, 0))  # (nsub, NPIECES)
    ends = F.pad(gidx, (0, 1), value=SUB - 1)
    return dict(pmin=linr.gather(1, starts), pmax=linr.gather(1, ends), sstart=sstart_al,
                strip_overflow=strip_overflow)


def interval_bounds(pieces: Dict[str, torch.Tensor], cell_table, grid: GridSpec
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi), each (nsub, NIV) int64: the NIV raw intervals of each
    sub-block (stencil offset outer, piece inner) gathered from the table."""
    ncells = grid.ncells
    _, ny, nz = grid.dims
    pmin, pmax = pieces["pmin"], pieces["pmax"]
    nsub = pmin.shape[0]
    table = cell_table.long()
    offs = torch.tensor([dx * ny * nz + dy * nz for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                        device=pmin.device)[None, :, None]     # (1, 9, 1)
    lo = table[torch.clamp(pmin[:, None, :] + offs - 1, 0, ncells).reshape(nsub, NIV)]
    hi = table[torch.clamp(pmax[:, None, :] + offs + 2, 0, ncells).reshape(nsub, NIV)]
    return lo, hi


def plan_intervals(pieces: Dict[str, torch.Tensor], cell_table, grid: GridSpec
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plan's second stage: `interval_bounds`, with each interval's dx
    strip, sorted by lo.  Returns (lo, hi, strip_of), each (nsub, NIV)."""
    lo, hi = interval_bounds(pieces, cell_table, grid)
    strip_of = (torch.arange(NIV, device=lo.device) // (3 * NPIECES)).expand(lo.shape)
    lo, order = torch.sort(lo, dim=1, stable=True)
    return lo, hi.gather(1, order), strip_of.gather(1, order)


def plan_chunks(lo, hi, strip_of, sstart_al, smax: int, wcap: int
                ) -> Tuple[Wins, torch.Tensor]:
    """The plan's third stage: the sorted intervals made disjoint by a
    running max, each as the 128-aligned source chunks covering it (chunks
    shared with an earlier interval dropped by the same running max), their
    chains of slab chunks and the owner of each slab chunk by one scatter.
    Returns (wins, wcap_overflow 0-d)."""
    dev = lo.device
    nsub = lo.shape[0]
    ilo = torch.maximum(lo, _exclusive_cummax(hi))
    ilen = torch.clamp(hi - ilo, min=0)
    live = ilen > 0

    a = ilo // WCOL
    bnd = torch.where(live, (ilo + ilen - 1) // WCOL + 1, a)
    srcc0_abs = torch.maximum(a, _exclusive_cummax(torch.where(live, bnd, 0)))
    k = torch.where(live, torch.clamp(bnd - srcc0_abs, min=0), 0)
    sb = torch.repeat_interleave(sstart_al // WCOL, NSUB, dim=0)   # (nsub, 3)
    srcc0 = srcc0_abs - sb.gather(1, strip_of)                      # strip-relative

    dstc0 = torch.cumsum(k, dim=1) - k
    nchunk = dstc0[:, -1] + k[:, -1]
    nj = wcap // WCOL
    nchunkp = (nchunk + UNROLL - 1) // UNROLL * UNROLL
    wcap_overflow = torch.clamp(nchunkp.max() - nj, min=0) * WCOL
    nchunk = torch.clamp(nchunk, max=nj)
    nchunkp = torch.clamp(nchunkp, max=nj)

    # owner of slab chunk j: the last non-empty interval with dstc0 <= j, by
    # one scatter-max of a payload (interval, strip, src-dst delta) and a
    # running max
    pb = 2048
    ival = torch.arange(NIV, device=dev)
    payload = (ival * 4 + strip_of) * pb + (srcc0 - dstc0 + pb // 2)
    scat = torch.full((nsub, nj), -1, dtype=payload.dtype, device=dev)
    scat.scatter_reduce_(1, torch.clamp(dstc0, max=nj - 1),
                         torch.where(k > 0, payload, -1), "amax")
    e = torch.clamp(torch.cummax(scat, dim=1).values, min=0)
    strip_j = e // pb % 4
    delta_j = e % pb - pb // 2
    src_chunk = torch.clamp(delta_j + torch.arange(nj, device=dev), 0, smax // WCOL - 1)

    i32 = torch.int32
    wins = dict(meta=(strip_j * 8192 + src_chunk).to(i32), nchunk=nchunk.to(i32),
                nchunkp=nchunkp.to(i32), sstart=sstart_al.to(i32))
    return wins, wcap_overflow


def source_columns(wins: Wins) -> torch.Tensor:
    """(nsub, wcap//128) int64 absolute first source column of every slab
    chunk: sstart[t // NSUB, strip] + src * 128, decoded from `meta`."""
    meta = wins["meta"].long()
    st = meta // 8192
    block = torch.arange(meta.shape[0], device=meta.device) // NSUB
    start = wins["sstart"].long()[block[:, None], st]
    return start + (meta - st * 8192) * WCOL


def slab_pairs(wins: Wins) -> int:
    """Row-candidate pairs a dense phase evaluates: sum nchunkp*128*32."""
    return int(wins["nchunkp"].long().sum()) * WCOL * SUB


def pstar_pack(pstar, member):
    """The (4, C) pack [1, x|SENTINEL, y, z] whose compaction is the
    lambda2/delta2 candidate slab: non-member slots are blanked in x, so they
    fail every r test.  The ones row is carried for bit parity with the
    Pallas slab; no kernel of the port reads it."""
    bx = torch.where(member, pstar[0], SENTINEL)
    return torch.stack([torch.ones_like(bx), bx, pstar[1], pstar[2]])


def diffuse_packs(cells, member, ptype, alive, dims: Sequence[int]):
    """(acl, pack) for diffuse2: acl (C,) the rows' linear cell ids as fp32,
    pack the (2, C) weight pack [w, bcl|SENTINEL], w = 1 for an alive
    non-obstacle member.  Candidate ids of non-members are blanked so they
    never pass the band test.  The two zero rows that fill the Pallas pack to
    four are not carried."""
    _, ny, nz = dims
    acl = ((cells[0] * ny + cells[1]) * nz + cells[2]).to(torch.float32)
    w = ((ptype != OBSTACLE) & alive & member).to(torch.float32)
    return acl, torch.stack([w, torch.where(member, acl, SENTINEL)])


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def compact_plain(wins: Wins, packed):
    """(nf, C) -> (nf, nsub * wcap): slab chunk j of sub-block t is the 128
    columns from `source_columns` for j < nchunk, SENTINEL after.  Columns
    j >= nchunkp, which the kernel leaves unwritten, are SENTINEL here."""
    nf = packed.shape[0]
    col0 = source_columns(wins)                                 # (nsub, nj)
    nsub, nj = col0.shape
    cols = col0[..., None] + torch.arange(WCOL, device=col0.device)
    vals = packed[:, cols.reshape(-1)].reshape(nf, nsub, nj, WCOL)
    keep = torch.arange(nj, device=col0.device) < wins["nchunk"][:, None].long()
    return torch.where(keep[None, :, :, None], vals, SENTINEL).reshape(nf, nsub * nj * WCOL)


def _slab_blocks(nchunkp, slabs: Sequence[torch.Tensor], max_pairs: int = 1 << 23
                 ) -> Iterator[Tuple[slice, List[torch.Tensor]]]:
    """Yield (sub-blocks, [(F, B, wcap) views of each slab]) for blocks of
    sub-blocks, columns >= nchunkp*128 (undefined in the kernel's slab) set
    to SENTINEL, which the pair math rejects as it rejects the fill."""
    nsub = nchunkp.shape[0]
    wcap = slabs[0].shape[1] // nsub
    col = torch.arange(wcap, device=nchunkp.device)
    per = max(1, max_pairs // (SUB * wcap))
    for t0 in range(0, nsub, per):
        tb = slice(t0, min(nsub, t0 + per))
        defined = col < nchunkp[tb, None].long() * WCOL
        yield tb, [torch.where(defined, s.reshape(s.shape[0], nsub, wcap)[:, tb], SENTINEL)
                   for s in slabs]


def _row_diffs(rows, tb: slice, cand):
    """(3, B, SUB, wcap) row minus candidate: rows (nsub, SUB, 4), cand the
    x, y, z slab rows (3, B, wcap)."""
    return rows[tb, :, :3].permute(2, 0, 1)[..., None] - cand[:, :, None, :]


def lambda2_plain(nchunkp, rows, cands, h: float):
    """Raw lambda (C,) before the mask; what `lambda2_kernel` computes
    (`pallas_pbf2.py:498-540`).  rows (C, 4) [x, y, z, mass]; cands the
    (4, nsub*wcap) pStar slab [1, x|SENTINEL, y, z]."""
    c = PairConstants.of(h)
    nsub = nchunkp.shape[0]
    a = rows.reshape(nsub, SUB, 4)
    p6s = torch.zeros((nsub, SUB), dtype=rows.dtype, device=rows.device)
    g = torch.zeros((3, nsub, SUB), dtype=rows.dtype, device=rows.device)
    for tb, (pc,) in _slab_blocks(nchunkp, (cands,)):
        d = _row_diffs(a, tb, pc[1:4])
        r2 = torch.clamp(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], min=c.eps2)
        u = torch.rsqrt(r2)
        tt = torch.clamp(c.hh - r2, min=0.0)
        p6s[tb] = (tt * tt * tt).sum(-1)
        t2 = torch.clamp(c.h - r2 * u, min=0.0)
        g[:, tb] = (d * (t2 * t2 * u)).sum(-1)
    rho = a[..., 3] * (p6s * c.p6f)
    gc = g * c.c_grad
    norm2 = gc[0] * gc[0] + gc[1] * gc[1] + gc[2] * gc[2]
    return (-(rho * c.rho_recip - 1.0) / (norm2 + c.cfm)).reshape(-1)


def delta2_plain(nchunkp, rows, cands, lamc, h: float):
    """Raw position correction (3, C) before the clamp; what `delta2_kernel`
    computes (`pallas_pbf2.py:566-605`).  rows (C, 4) [x, y, z, lambda];
    cands the pStar slab, lamc the (1, nsub*wcap) lambda slab."""
    c = PairConstants.of(h)
    nsub = nchunkp.shape[0]
    a = rows.reshape(nsub, SUB, 4)
    dp = torch.zeros((3, nsub, SUB), dtype=rows.dtype, device=rows.device)
    for tb, (pc, lc) in _slab_blocks(nchunkp, (cands, lamc)):
        d = _row_diffs(a, tb, pc[1:4])
        r2 = torch.clamp(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], min=c.eps2)
        u = torch.rsqrt(r2)
        tt = torch.clamp(c.hh - r2, min=0.0)
        xq = (tt * tt * tt) * c.xqf
        x2 = xq * xq
        factor = (a[tb, :, 3:4] + lc[0][:, None, :] + c.corr_k * (x2 * x2)) * c.rho_recip
        t2 = torch.clamp(c.h - r2 * u, min=0.0)
        sg = (t2 * t2 * u) * c.skf * factor
        dp[:, tb] = (d * sg).sum(-1)
    return dp.reshape(3, -1)


def diffuse2_plain(nchunkp, acl, cands_c, cands_w, dims: Sequence[int]):
    """(5, C) [sum r, g, b, a, count] over the slab columns whose cell passes
    the band test; what `diffuse2_kernel` computes (`pallas_pbf2.py:631-663`).

    acl (C,) the rows' linear cell ids as fp32; cands_c the (4, S) colour
    slab, cands_w the (2, S) slab [w, bcl|SENTINEL].  With e = |bcl - acl|,
    g1 = min(|e - ny*nz|, e), g2 = min(|g1 - nz|, g1), a column counts with
    weight w iff g2 <= 1: exact on fp32 integers below 2^24.

    The sums run column by column in the kernel's order, and w is 0 or 1,
    so the two agree bit for bit."""
    _, ny, nz = dims
    nynz, nzf = float(np.float32(ny * nz)), float(np.float32(nz))
    nsub = nchunkp.shape[0]
    wcap = cands_c.shape[1] // nsub
    arow = acl.reshape(nsub, SUB)
    cc = cands_c.reshape(4, nsub, wcap)
    wc = cands_w.reshape(2, nsub, wcap)
    limit = nchunkp.long()[:, None] * WCOL
    out = torch.zeros((5, nsub, SUB), dtype=acl.dtype, device=acl.device)
    for j in range(wcap):
        e = torch.abs(wc[1, :, j, None] - arow)                     # (nsub, SUB)
        g1 = torch.minimum(torch.abs(e - nynz), e)
        g2 = torch.minimum(torch.abs(g1 - nzf), g1)
        # columns >= nchunkp*128 are undefined in the kernel's slab: add 0
        ww = torch.where((j < limit) & (g2 <= 1.0), wc[0, :, j, None], 0.0)
        out[:4] += torch.where(ww > 0, ww * cc[:, :, j, None], 0.0)
        out[4] += ww
    return out.reshape(5, -1)


# ---------------------------------------------------------------------------
# CUDA kernel launchers
# ---------------------------------------------------------------------------


def _check(**tensors) -> None:
    """Each value is (tensor, dtype, shape); raise unless all are contiguous
    CUDA tensors of that dtype and shape on one device."""
    dev = next(iter(tensors.values()))[0].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    for name, (t, dtype, shape) in tensors.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
                or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: want a contiguous {dtype} {tuple(shape)} tensor on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def _slab_shape(nchunkp, slab) -> Tuple[int, int]:
    nsub = nchunkp.shape[0]
    wcap = slab.shape[-1] // max(nsub, 1)
    if nsub == 0 or wcap * nsub != slab.shape[-1] or wcap % (UNROLL * WCOL):
        raise ValueError(f"slab width {slab.shape[-1]} is not nsub {nsub} x a multiple "
                         f"of {UNROLL * WCOL}")
    return nsub, wcap


def compact_kernel(wins: Wins, packed):
    """(nf, C) -> (nf, nsub * wcap) slab from `pbf_compact` (replaces
    `make_compact_call`); columns j >= nchunkp are left unwritten."""
    nsub, nj = wins["meta"].shape
    nf, n = packed.shape
    i32 = torch.int32
    _check(packed=(packed, torch.float32, (nf, n)),
           meta=(wins["meta"], i32, (nsub, nj)), nchunk=(wins["nchunk"], i32, (nsub,)),
           nchunkp=(wins["nchunkp"], i32, (nsub,)),
           sstart=(wins["sstart"], i32, (-(-nsub // NSUB), 3)))
    if n != nsub * SUB:
        raise ValueError(f"packed has {n} columns, the plan {nsub} sub-blocks of {SUB}")
    out = torch.empty((nf, nsub * nj * WCOL), dtype=packed.dtype, device=packed.device)
    lib = cuda_build.library()
    with torch.cuda.device(packed.device):
        err = lib.pbf_compact(
            packed.data_ptr(), nf, n, wins["sstart"].data_ptr(), wins["meta"].data_ptr(),
            wins["nchunk"].data_ptr(), wins["nchunkp"].data_ptr(), nsub, nj,
            out.data_ptr(), _stream(packed.device))
    cuda_build.check("pbf_compact", err)
    return out


def lambda2_kernel(nchunkp, rows, cands, h: float):
    """Raw lambda (C,) from `pbf_lambda2` (replaces `make_lambda2_call`)."""
    nsub, wcap = _slab_shape(nchunkp, cands)
    n = nsub * SUB
    _check(nchunkp=(nchunkp, torch.int32, (nsub,)), rows=(rows, torch.float32, (n, 4)),
           cands=(cands, torch.float32, (4, nsub * wcap)))
    c = PairConstants.of(h)
    lam = torch.empty(n, dtype=rows.dtype, device=rows.device)
    lib = cuda_build.library()
    with torch.cuda.device(rows.device):
        err = lib.pbf_lambda2(
            rows.data_ptr(), cands.data_ptr(), nchunkp.data_ptr(), nsub, wcap, c.h, c.hh,
            c.eps2, c.p6f, c.c_grad, c.rho_recip, c.cfm, lam.data_ptr(), _stream(rows.device))
    cuda_build.check("pbf_lambda2", err)
    return lam


def delta2_kernel(nchunkp, rows, cands, lamc, h: float):
    """Raw position correction (3, C) from `pbf_delta2` (replaces
    `make_delta2_call`)."""
    nsub, wcap = _slab_shape(nchunkp, cands)
    n = nsub * SUB
    _check(nchunkp=(nchunkp, torch.int32, (nsub,)), rows=(rows, torch.float32, (n, 4)),
           cands=(cands, torch.float32, (4, nsub * wcap)),
           lamc=(lamc, torch.float32, (1, nsub * wcap)))
    c = PairConstants.of(h)
    dp = torch.empty((3, n), dtype=rows.dtype, device=rows.device)
    lib = cuda_build.library()
    with torch.cuda.device(rows.device):
        err = lib.pbf_delta2(
            rows.data_ptr(), cands.data_ptr(), lamc.data_ptr(), nchunkp.data_ptr(), nsub,
            wcap, c.h, c.hh, c.eps2, c.skf, c.xqf, c.corr_k, c.rho_recip, dp.data_ptr(),
            _stream(rows.device))
    cuda_build.check("pbf_delta2", err)
    return dp


def diffuse2_kernel(nchunkp, acl, cands_c, cands_w, dims: Sequence[int]):
    """(5, C) colour sums and count from `pbf_diffuse2` (replaces
    `make_diffuse2_call`)."""
    nsub, wcap = _slab_shape(nchunkp, cands_c)
    n = nsub * SUB
    _check(nchunkp=(nchunkp, torch.int32, (nsub,)), acl=(acl, torch.float32, (n,)),
           cands_c=(cands_c, torch.float32, (4, nsub * wcap)),
           cands_w=(cands_w, torch.float32, (2, nsub * wcap)))
    _, ny, nz = dims
    out = torch.empty((5, n), dtype=acl.dtype, device=acl.device)
    lib = cuda_build.library()
    with torch.cuda.device(acl.device):
        err = lib.pbf_diffuse2(
            acl.data_ptr(), cands_c.data_ptr(), cands_w.data_ptr(), nchunkp.data_ptr(),
            nsub, wcap, float(np.float32(ny * nz)), float(np.float32(nz)), out.data_ptr(),
            _stream(acl.device))
    cuda_build.check("pbf_diffuse2", err)
    return out


# ---------------------------------------------------------------------------
# Phase wrappers
# ---------------------------------------------------------------------------


class PbfPhases2:
    """The compacted-candidate pipeline for one static spec
    (`PallasPhases2`, `pallas_pbf2.py:675-793`), with a launch counter per
    kernel: `launches[name]` grows by one each time a wrapper launches its
    CUDA kernel, and at no other time.

    Per frame:
        wins, ovf = phases.plan_frame(key, cell_table)
        colour = phases.diffuse(wins, colour, cells, member, ptype, alive, dt)
        for each iteration:
            cands = phases.compact_pstar(wins, pstar, member)
            lam   = phases.lambda_phase(wins, cands, pstar, mass, member, ptype, alive)
            lamc  = phases.compact_lam(wins, lam)
            pstar = phases.delta_phase(wins, cands, lamc, pstar, lam, member, ...)
    """

    def __init__(self, capacity: int, grid: GridSpec, h: float, smax: int, wcap: int):
        if capacity % BLK or wcap % (UNROLL * WCOL):
            raise ValueError(f"capacity {capacity} must be a multiple of {BLK}, wcap "
                             f"{wcap} of {UNROLL * WCOL}")
        # the compaction reads up to smax columns from a strip start clamped
        # to capacity - smax
        if smax > capacity:
            raise ValueError(f"smax {smax} exceeds the capacity {capacity}")
        if grid.ncells >= (1 << 24):
            raise ValueError("the v2 phases need < 2^24 grid cells (f32-exact ids)")
        self.capacity = capacity
        self.grid = grid
        self.h = float(h)
        self.smax = smax
        self.wcap = wcap
        self.launches = {"compact": 0, "lambda2": 0, "delta2": 0, "diffuse2": 0}

    def reset_launches(self) -> None:
        for name in self.launches:
            self.launches[name] = 0

    def plan_frame(self, sorted_key, cell_table):
        return plan_compact(sorted_key, cell_table, self.grid, self.capacity,
                            self.smax, self.wcap)

    def _compact(self, wins: Wins, packed):
        if packed.device.type == "cpu":
            return compact_plain(wins, packed)
        out = compact_kernel(wins, packed)
        self.launches["compact"] += 1
        return out

    def compact_pstar(self, wins: Wins, pstar, member):
        """The (4, S) pStar slab of `pstar_pack`."""
        return self._compact(wins, pstar_pack(pstar, member))

    def compact_lam(self, wins: Wins, lam):
        return self._compact(wins, lam.reshape(1, -1).contiguous())

    def lambda_phase(self, wins: Wins, cands, pstar, mass, member, ptype, alive):
        """lambda (C,), zero where not a fluid, alive member."""
        rows = torch.stack([pstar[0], pstar[1], pstar[2], mass], dim=1)
        if rows.device.type == "cpu":
            lam = lambda2_plain(wins["nchunkp"], rows, cands, self.h)
        else:
            lam = lambda2_kernel(wins["nchunkp"], rows, cands, self.h)
            self.launches["lambda2"] += 1
        return torch.where((ptype == FLUID) & alive & member, lam, 0.0)

    def delta_phase(self, wins: Wins, cands, lamc, pstar, lam, member, ptype, alive,
                    scale, min_bound, max_bound):
        """pStar after one position correction and the bounds clamp, for
        fluid, alive members."""
        rows = torch.stack([pstar[0], pstar[1], pstar[2], lam], dim=1)
        if rows.device.type == "cpu":
            dp = delta2_plain(wins["nchunkp"], rows, cands, lamc, self.h)
        else:
            dp = delta2_kernel(wins["nchunkp"], rows, cands, lamc, self.h)
            self.launches["delta2"] += 1
        return clamp_to_bounds(pstar, dp, ptype, alive & member, scale, min_bound, max_bound)

    def diffuse(self, wins: Wins, colour, cells, member, ptype, alive, dt):
        """Colour after one diffusion step, over the slabs of the colour and
        of `diffuse_packs`' weight pack."""
        cl, wpack = diffuse_packs(cells, member, ptype, alive, self.grid.dims)
        cands_c = self._compact(wins, colour.contiguous())
        cands_w = self._compact(wins, wpack)
        if colour.device.type == "cpu":
            sums = diffuse2_plain(wins["nchunkp"], cl, cands_c, cands_w, self.grid.dims)
        else:
            sums = diffuse2_kernel(wins["nchunkp"], cl, cands_c, cands_w, self.grid.dims)
            self.launches["diffuse2"] += 1
        return mix_colour(colour, sums, ptype, alive & member, dt)
