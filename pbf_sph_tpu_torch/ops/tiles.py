"""Tiled lambda/delta: `sub`-row tiles sharing one set of stencil windows.

Port of the `PallasPhases(sub=..., mxu=...)` variants of
`pbf_sph_tpu/ops/pallas_pbf.py`: the sub-block window plan (`plan_windows`
`:108-191`, `disjoint_windows` `:85-105`) and the lambda/delta kernels with
the centred-coordinate r2 of `_centred_r2_mxu` (`:351-388`).  As in
`ops/phases.py` each kernel has a launcher (`lambda_tile_kernel`,
`delta_tile_kernel`, the CUDA kernels of `csrc/pbf_tiles.cu`) and a plain
PyTorch version of the same signature (`lambda_tile_plain`,
`delta_tile_plain`).  Their redesigns `lambda_tile_cull_kernel` and
`delta_tile_cull_kernel` give the same raw values on every member row while
skipping the 8 x 8 row-candidate blocks that cannot contribute;
`tile_keep_plain` repeats their block test, and the plain versions take its
mask as `keep=`.  `PbfPhases(h, sub, mxu)` runs the plain versions on the
CPU and the cull kernels on the card; `DenseTiles` launches the dense ones.

A tile is `sub` consecutive sorted rows.  Its nine (dx, dy) windows are
`[table[clip(cmin+off-1)], table[clip(cmax+off+2)])`, `cmin`/`cmax` the
cells of its first and last row, so they hold every row's own nine ranges.
A tile spanning more than nz - 3 cells (sparse regions, a z-column wrap) has
overlapping windows; a coverage scan at unit granularity makes them disjoint
so no pair is counted twice (the pair math has no per-pair mask to catch
it).  Every row of a tile takes every candidate of the tile's windows; a
candidate outside its own 27 cells is >= h away, where poly6 and spiky are
exactly 0.  Non-member rows (key >= ncells) give what the per-row kernels
give: lambda 1/CFM, delta 0.

With `mxu=True` r2 is the centred product `|a|^2 + |b|^2 - 2 a.b` of
`_centred_r2_mxu`: coordinates are translated to the tile's centre (the
mean of all `sub` rows, non-member tail rows included, as in Pallas) and
the gradient uses the centred differences.  The sum runs in fp64 and is
rounded to fp32 once, as the card's fp64 tensor-core product does
(`csrc/pbf_tiles.cu` says why fp64); the centre is summed in fp64 and
rounded once too, so kernel and plain version centre bit for bit alike.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops.phases import (
    CellIndex,
    PairConstants,
    _check_cuda,
    _stream,
    keep_hh,
    keep_r2,
)

# rows per tile that csrc/pbf_tiles.cu instantiates (the sweep's 64/32/16,
# and 8 with the tensor-core row block unpadded)
TILE_SUBS = (8, 16, 32, 64)
# rows of a Pallas block: a JAX-legal `sub` is a multiple of 8 dividing it
BLOCK_ROWS = 1024


def check_sub(sub: int) -> int:
    """`sub` as `PallasPhases` takes it (`pallas_pbf.py:663`)."""
    sub = int(sub)
    if sub <= 0 or sub % 8 or BLOCK_ROWS % sub:
        raise ValueError(f"sub must be a multiple of 8 dividing {BLOCK_ROWS}, got {sub}")
    return sub


# ---------------------------------------------------------------------------
# The window plan
# ---------------------------------------------------------------------------


def plan_tiles(index: CellIndex, sub: int) -> torch.Tensor:
    """(ntiles, 9, 2) int32 [lo, hi) absolute offsets of each tile's nine
    disjoint windows, in stencil order (dx outer, dy inner)."""
    sub = check_sub(sub)
    n = index.key.shape[0]
    if n % sub:
        raise ValueError(f"capacity {n} is not a multiple of sub {sub}")
    _, ny, nz = index.grid.dims
    ncells = index.grid.ncells
    table = index.table.long()
    lin = torch.clamp(index.key.long(), max=ncells - 1)
    # the tail of non-members takes the last member's cell, so the last
    # tile's windows stay bounded (`pallas_pbf.py:135-138`); a 1-element
    # gather keeps the member count on the device
    last = lin[torch.clamp(table[ncells:] - 1, min=0)]
    lin = torch.minimum(lin, last)
    # window s is stencil column (dx, dy) = (s // 3 - 1, s % 3 - 1), dy fastest
    s = torch.arange(9, device=lin.device)
    off = (s // 3 - 1) * (ny * nz) + (s % 3 - 1) * nz
    lo = table[torch.clamp(lin[0::sub, None] + off - 1, 0, ncells)]  # (T, 9)
    hi = table[torch.clamp(lin[sub - 1::sub, None] + off + 2, 0, ncells)]
    # The coverage scan: window s starts where windows 0..s-1 end (the
    # running max of their ends, as starts and ends rise with the stencil
    # offset); a window fully covered collapses to empty.  Each end becomes
    # that running max, since hi_s >= lo_s.
    ends = [hi[:, 0]]
    for k in range(1, 9):
        ends.append(torch.maximum(ends[-1], hi[:, k]))
    cover = torch.stack(ends, dim=1)
    lo = torch.maximum(lo, torch.nn.functional.pad(cover[:, :-1], (1, 0)))
    return torch.stack([lo, cover], dim=2).to(torch.int32)


def tile_pairs(tiles: torch.Tensor, sub: int) -> int:
    """Row-candidate pairs a tiled phase evaluates: sub x window lengths."""
    return sub * int((tiles[..., 1] - tiles[..., 0]).long().sum())


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def tile_centres(pstar: torch.Tensor, sub: int) -> torch.Tensor:
    """(3, ntiles) fp32 mean of each tile's rows, summed in fp64."""
    tiles = pstar.shape[1] // sub
    return (pstar.reshape(3, tiles, sub).double().sum(-1) / sub).float()


def centred_r2(ac: torch.Tensor, bc: torch.Tensor,
               acc: torch.dtype = torch.float64) -> torch.Tensor:
    """fp32 r2 = |a|^2 + |b|^2 - 2 a.b of rows `ac` (3, ..., R) against
    candidates `bc` (3, ..., W), (..., R, W), accumulated in `acc`."""
    a, b = ac.to(acc), bc.to(acc)
    a2 = (a * a).sum(0)
    b2 = (b * b).sum(0)
    dot = (a[..., :, None] * b[..., None, :]).sum(0)
    return (a2[..., :, None] + b2[..., None, :] - 2.0 * dot).float()


def _window_starts(tiles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(woff, total): each window's first position in its tile's candidate
    sequence (the nine windows one after the other), (T, 9), and the
    sequence's length, (T,), int64."""
    t64 = tiles.long()
    lens = t64[..., 1] - t64[..., 0]
    return torch.cumsum(lens, 1) - lens, lens.sum(1)


def _window_blocks(tiles: torch.Tensor, rows_per_block: int, sub: int
                   ) -> Iterator[Tuple[slice, int, torch.Tensor, torch.Tensor]]:
    """Yield (tiles, s, idx, valid) for every block of tiles and each window
    s: idx (T, W) candidate indices padded to the widest window W, valid
    masks the padding (whose idx is 0)."""
    t64 = tiles.long()
    per = max(1, rows_per_block // sub)
    for t0 in range(0, t64.shape[0], per):
        tb = slice(t0, min(t64.shape[0], t0 + per))
        for s in range(9):
            lo, hi = t64[tb, s, 0], t64[tb, s, 1]
            width = int((hi - lo).max())
            if width == 0:
                continue
            idx = lo[:, None] + torch.arange(width, device=lo.device)
            valid = idx < hi[:, None]
            yield tb, s, torch.where(valid, idx, 0), valid


def _sequence_blocks(tiles: torch.Tensor, sub: int, rows_per_block: int = 1 << 14
                     ) -> Iterator[Tuple[slice, torch.Tensor, torch.Tensor]]:
    """Yield (tiles, idx, valid) for every block of tiles: idx (T, V) the
    candidate sequence of each tile as the kernels walk it (the nine windows
    one after the other; position v in window s, the count of window starts
    at or below v), padded to V, the longest rounded up to 8 columns; valid
    masks the padding (whose idx is 0)."""
    t64 = tiles.long()
    woff, total = _window_starts(tiles)
    per = max(1, rows_per_block // sub)
    for t0 in range(0, t64.shape[0], per):
        tb = slice(t0, min(t64.shape[0], t0 + per))
        width = -(-int(total[tb].max()) // 8) * 8
        if width == 0:
            continue
        v = torch.arange(width, device=t64.device)
        s = (v[None, :, None] >= woff[tb, None, 1:]).sum(-1)
        idx = t64[tb, :, 0].gather(1, s) + v - woff[tb].gather(1, s)
        valid = v < total[tb, None]
        yield tb, torch.where(valid, idx, 0), valid


def _pairs(tiles, pstar, sub: int, mxu: bool, keep=None, rows_per_block: int = 1 << 14):
    """Yield (tb, d, r2, valid, idx) per block of tiles and window: d is
    (3, T, sub, W) row minus candidate, r2 (T, sub, W) as the route
    computes it; with `keep` (`tile_keep_plain`), valid also drops the pairs
    of the blocks it does not keep."""
    ntiles = pstar.shape[1] // sub
    rows = pstar.reshape(3, ntiles, sub)
    centre = tile_centres(pstar, sub) if mxu else None
    woff = _window_starts(tiles)[0] if keep is not None else None
    for tb, s, idx, valid in _window_blocks(tiles, rows_per_block, sub):
        a, b = rows[:, tb], pstar[:, idx]
        if mxu:
            c = centre[:, tb, None]
            a, b = a - c, b - c
        d = a[..., :, None] - b[..., None, :]
        if mxu:
            r2 = centred_r2(a, b)
        else:
            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        valid = valid[:, None, :]
        if keep is not None:
            pos = woff[tb, s, None] + torch.arange(idx.shape[1], device=idx.device)
            cb = torch.clamp(pos // 8, max=keep.shape[2] - 1)[:, None, :]
            kb = keep[tb].gather(2, cb.expand(-1, keep.shape[1], -1))
            valid = valid & kb.repeat_interleave(8, dim=1)
        yield tb, d, r2, valid, idx


def _member(index: CellIndex, sub: int) -> torch.Tensor:
    return (index.key < index.grid.ncells).reshape(-1, sub)


def tile_keep_plain(tiles, index: CellIndex, pstar, sub: int, mxu: bool, h: float):
    """(ntiles, sub // 8, NB) bool: bit (t, rb, cb) set when the cull
    kernels walk row block rb (rows 8rb..8rb+7) of tile t against column
    block cb (positions 8cb..8cb+7 of its candidate sequence), NB the
    longest sequence's blocks.  A block is kept when `keep_r2` of the gap
    between the box of the row block's member rows and the box of the column
    block's candidates is below `keep_hh(h)`; with `mxu` both boxes are of
    the centred fp32 coordinates.  Plain torch arithmetic in the kernels'
    order, not a kernel: the kernels' test repeated, for the tests and for
    counting kept pairs."""
    sub = check_sub(sub)
    hk = keep_hh(h)
    ntiles, nrb = pstar.shape[1] // sub, sub // 8
    rows = pstar.reshape(3, ntiles, sub)
    member = _member(index, sub).reshape(ntiles, nrb, 8)
    centre = tile_centres(pstar, sub) if mxu else None
    total = _window_starts(tiles)[1]
    nb = max(1, -(-int(total.max()) // 8)) if ntiles else 1
    keep = torch.zeros((ntiles, nrb, nb), dtype=torch.bool, device=pstar.device)
    inf = float("inf")
    for tb, idx, valid in _sequence_blocks(tiles, sub):
        a, b = rows[:, tb], pstar[:, idx]
        if mxu:
            c = centre[:, tb, None]
            a, b = a - c, b - c
        a = a.reshape(3, -1, nrb, 8)
        m = member[tb]
        rlo = torch.where(m, a, inf).amin(-1)[..., None]        # (3, T, nrb, 1)
        rhi = torch.where(m, a, -inf).amax(-1)[..., None]
        b = b.reshape(3, b.shape[1], -1, 8)
        v = valid.reshape(valid.shape[0], -1, 8)
        glo = torch.where(v, b, inf).amin(-1)[:, :, None, :]     # (3, T, 1, NB)
        ghi = torch.where(v, b, -inf).amax(-1)[:, :, None, :]
        gap = torch.clamp(torch.maximum(glo - rhi, rlo - ghi), min=0.0)
        keep[tb, :, :gap.shape[-1]] = keep_r2(*gap) < hk
    return keep


def kept_tile_pairs(keep, tiles) -> int:
    """Row-candidate pairs the cull kernels run the pair chain for: 8 rows
    times the candidates of each kept block."""
    total = _window_starts(tiles)[1]
    cols = torch.clamp(total[:, None] - 8 * torch.arange(keep.shape[2], device=total.device),
                       0, 8)
    return 8 * int((keep.sum(1) * cols).sum())


def lambda_tile_plain(tiles, index: CellIndex, h: float, pstar, mass, sub: int,
                      mxu: bool = False, keep=None):
    """Raw lambda (C,) before the fluid mask; what `lambda_tile_kernel`
    computes (`pallas_pbf.py:425-480`).  With `keep` (`tile_keep_plain`) the
    pairs of the blocks it drops add nothing: what the cull kernel
    computes."""
    c = PairConstants.of(h)
    ntiles = pstar.shape[1] // sub
    p6s = torch.zeros((ntiles, sub), dtype=pstar.dtype, device=pstar.device)
    g = torch.zeros((3, ntiles, sub), dtype=pstar.dtype, device=pstar.device)
    for tb, d, r2, valid, _ in _pairs(tiles, pstar, sub, mxu, keep):
        d2p = torch.clamp(c.hh - r2, min=0.0)
        p6s[tb] += torch.where(valid, d2p * d2p * d2p, 0.0).sum(-1)
        r2c = torch.clamp(r2, min=c.eps2)
        u = torch.rsqrt(r2c)
        tt = torch.clamp(c.h - r2c * u, min=0.0)
        g[:, tb] += (d * torch.where(valid, tt * tt * u, 0.0)).sum(-1)
    member = _member(index, sub)
    # non-member rows: rho = 0 and |grad|^2 = 0, so lambda = 1 / CFM
    rho = torch.where(member, mass.reshape(ntiles, sub) * (p6s * c.p6f), 0.0)
    gc = g * c.c_grad
    norm2 = torch.where(member, gc[0] * gc[0] + gc[1] * gc[1] + gc[2] * gc[2], 0.0)
    return (-(rho * c.rho_recip - 1.0) / (norm2 + c.cfm)).reshape(-1)


def delta_tile_plain(tiles, index: CellIndex, h: float, pstar, lam, sub: int,
                     mxu: bool = False, keep=None):
    """Raw position correction (3, C) before the clamp; what
    `delta_tile_kernel` computes (`pallas_pbf.py:513-567`); `keep` as in
    `lambda_tile_plain`."""
    c = PairConstants.of(h)
    ntiles = pstar.shape[1] // sub
    alam = lam.reshape(ntiles, sub, 1)
    dp = torch.zeros((3, ntiles, sub), dtype=pstar.dtype, device=pstar.device)
    for tb, d, r2, valid, idx in _pairs(tiles, pstar, sub, mxu, keep):
        d2p = torch.clamp(c.hh - r2, min=0.0)
        xq = d2p * d2p * d2p * c.xqf
        x2 = xq * xq
        factor = (alam[tb] + lam[idx][:, None, :] + c.corr_k * x2 * x2) * c.rho_recip
        r2c = torch.clamp(r2, min=c.eps2)
        u = torch.rsqrt(r2c)
        tt = torch.clamp(c.h - r2c * u, min=0.0)
        sg = torch.where(valid, (c.skf * (tt * tt) * u) * factor, 0.0)
        dp[:, tb] += (d * sg).sum(-1)
    return torch.where(_member(index, sub), dp, 0.0).reshape(3, -1)


# ---------------------------------------------------------------------------
# CUDA kernel launchers
# ---------------------------------------------------------------------------


def _check_tiles(index: CellIndex, tiles, sub: int, **tensors) -> None:
    _check_cuda(index, **tensors)
    if sub not in TILE_SUBS:
        raise ValueError(f"csrc/pbf_tiles.cu instantiates sub in {TILE_SUBS}, got {sub}")
    n = index.key.shape[0]
    want = (n // sub, 9, 2)
    if n % sub or tiles.dtype != torch.int32 or tuple(tiles.shape) != want \
            or tiles.device != index.key.device or not tiles.is_contiguous():
        raise ValueError(f"tiles: want a contiguous int32 {want} tensor on "
                         f"{index.key.device} for capacity {n}, sub {sub}")


def _tile_launch(name: str, tiles, index: CellIndex, pstar, w, sub: int, mxu: bool,
                 consts, out) -> None:
    """Launcher `name` of `csrc/pbf_tiles.cu` on the (C, 4) pack (x, y, z, w)
    with the pair constants `consts`, into `out`."""
    cand = torch.stack([pstar[0], pstar[1], pstar[2], w], dim=1)  # (C, 4)
    lib = cuda_build.library()
    with torch.cuda.device(w.device):
        err = getattr(lib, name)(
            cand.data_ptr(), index.key.data_ptr(), tiles.data_ptr(), w.shape[0],
            index.grid.ncells, sub, int(mxu), *consts, out.data_ptr(), _stream(w.device))
    cuda_build.check(name, err)


def lambda_tile_kernel(tiles, index: CellIndex, h: float, pstar, mass, sub: int,
                       mxu: bool = False):
    """Raw lambda (C,) from `pbf_lambda_tile` (replaces
    `make_lambda_call(sub, mxu)`)."""
    _check_tiles(index, tiles, sub, pstar=pstar, mass=mass)
    c = PairConstants.of(h)
    lam = torch.empty_like(mass)
    _tile_launch("pbf_lambda_tile", tiles, index, pstar, mass, sub, mxu,
                 (c.h, c.hh, c.eps2, c.p6f, c.c_grad, c.rho_recip, c.cfm), lam)
    return lam


def delta_tile_kernel(tiles, index: CellIndex, h: float, pstar, lam, sub: int,
                      mxu: bool = False):
    """Raw position correction (3, C) from `pbf_delta_tile` (replaces
    `make_delta_call(sub, mxu)`)."""
    _check_tiles(index, tiles, sub, pstar=pstar, lam=lam)
    c = PairConstants.of(h)
    dp = torch.empty_like(pstar)
    _tile_launch("pbf_delta_tile", tiles, index, pstar, lam, sub, mxu,
                 (c.h, c.hh, c.eps2, c.skf, c.xqf, c.corr_k, c.rho_recip), dp)
    return dp


def lambda_tile_cull_kernel(tiles, index: CellIndex, h: float, pstar, mass, sub: int,
                            mxu: bool = False):
    """Raw lambda (C,) from `pbf_lambda_tile_cull` (redesigns
    `make_lambda_call(sub, mxu)`): `lambda_tile_kernel`'s values on every
    member row, over the blocks `tile_keep_plain` keeps."""
    _check_tiles(index, tiles, sub, pstar=pstar, mass=mass)
    c = PairConstants.of(h)
    lam = torch.empty_like(mass)
    _tile_launch("pbf_lambda_tile_cull", tiles, index, pstar, mass, sub, mxu,
                 (c.h, c.hh, keep_hh(h), c.eps2, c.p6f, c.c_grad, c.rho_recip, c.cfm), lam)
    return lam


def delta_tile_cull_kernel(tiles, index: CellIndex, h: float, pstar, lam, sub: int,
                           mxu: bool = False):
    """Raw position correction (3, C) from `pbf_delta_tile_cull` (redesigns
    `make_delta_call(sub, mxu)`): `delta_tile_kernel`'s values on every
    member row, over the blocks `tile_keep_plain` keeps."""
    _check_tiles(index, tiles, sub, pstar=pstar, lam=lam)
    c = PairConstants.of(h)
    dp = torch.empty_like(pstar)
    _tile_launch("pbf_delta_tile_cull", tiles, index, pstar, lam, sub, mxu,
                 (c.h, c.hh, keep_hh(h), c.eps2, c.skf, c.xqf, c.corr_k, c.rho_recip), dp)
    return dp


class DenseTiles:
    """The dense tile kernels (`lambda_tile_kernel`, `delta_tile_kernel`:
    every row of a tile against every candidate of its windows), which
    `PbfPhases(h, sub, mxu)` no longer launches, counted as "lambda_tile"
    and "delta_tile": raw values, before the wrappers' mask and clamp.  CUDA
    tensors only."""

    def __init__(self, h: float, sub: int, mxu: bool = False):
        self.h = float(h)
        self.sub = check_sub(sub)
        self.mxu = bool(mxu)
        self.launches = {"lambda_tile": 0, "delta_tile": 0}

    def lambda_raw(self, tiles, index: CellIndex, pstar, mass):
        lam = lambda_tile_kernel(tiles, index, self.h, pstar, mass, self.sub, self.mxu)
        self.launches["lambda_tile"] += 1
        return lam

    def delta_raw(self, tiles, index: CellIndex, pstar, lam):
        dp = delta_tile_kernel(tiles, index, self.h, pstar, lam, self.sub, self.mxu)
        self.launches["delta_tile"] += 1
        return dp


class TilePlan:
    """The window plan of the last frame seen, made once a frame and shared
    by its phases (the Pallas `plan_frame`)."""

    def __init__(self, sub: int):
        self.sub = check_sub(sub)
        self._last: Optional[Tuple[CellIndex, torch.Tensor]] = None

    def __call__(self, index: CellIndex) -> torch.Tensor:
        if self._last is None or self._last[0] is not index:
            self._last = (index, plan_tiles(index, self.sub))
        return self._last[1]
