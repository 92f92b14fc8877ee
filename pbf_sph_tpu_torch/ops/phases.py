"""The three neighbour phases of a frame: diffuse, lambda and delta.

Port of `PallasPhases` (`pbf_sph_tpu/ops/pallas_pbf.py:646-737`).  Each
phase has three parts here:

* a kernel launcher (`lambda_kernel`, `delta_kernel`, `diffuse_kernel`) that
  runs the hand-written CUDA kernel of `csrc/pbf_phases.cu` on CUDA tensors;
* its plain PyTorch version (`lambda_plain`, `delta_plain`, `diffuse_plain`)
  with the same signature and semantics;
* a wrapper method on `PbfPhases` that picks between them by the device of
  its tensors alone (CPU -> plain; anything else -> the kernel, which raises
  on a tensor it does not take), counts kernel launches, and applies what the
  Pallas wrappers apply in XLA: lambda's fluid mask, delta's bounds clamp,
  diffuse's mix and clamp.

`PbfPhases.solve`, the solver's iterated λ/Δp, runs them through the
kernels of `ops/cells.py`, which take the mask and the clamp in, and
`PbfPhases.diffuse` runs the per-cell sums and the 27-cell gather of
`ops/diffuse_cells.py`, which take the mix in; the per-row kernels here stay
as the anchors' subject (`lambda_phase`, `delta_phase`, `diffuse_rows`).
`PbfPhases(h, sub, mxu)` runs lambda and delta through the tiled kernels of
`ops/tiles.py` instead (the Pallas `sub`/`mxu` variants).

In place of the Pallas window plan (`wins`) every phase takes the frame's
`CellIndex`: the sorted keys and the dense cell table.  A row walks the nine
(dx, dy) ranges of its cell, `[table[clip(lin+off-1)], table[clip(lin+off+2)])`
with `off = dx*ny*nz + dy*nz`; membership and cell coords are read from the
key, so the Pallas arguments `memberf` and `cells` are not needed.  Semantics
are those of the Pallas kernels: non-member rows (key >= ncells) gather
nothing, and lambda/delta mask candidates by geometry alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.core.constants import DEFAULT_CONSTANTS as K
from pbf_sph_tpu_torch.core.types import FLUID, OBSTACLE
from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops.grid import GridSpec
from pbf_sph_tpu_torch.ops.kernels import poly6_factor, spiky_kernel_factor


@dataclass(frozen=True)
class CellIndex:
    """One frame's neighbour index: cell-sorted keys and the cell table."""

    grid: GridSpec
    key: torch.Tensor  # (C,) int32, sorted; >= ncells for non-members
    table: torch.Tensor  # (ncells+1,) int32, from build_cell_table


@dataclass(frozen=True)
class PairConstants:
    """fp32 constants of the pair math, folded as the Pallas kernels fold them."""

    h: float
    hh: float
    eps2: float
    p6f: float
    skf: float
    c_grad: float  # skf / RHO, the gradient scale inside |grad C|^2
    xqf: float  # poly6 factor / poly6(CORR_DELTA_Q * h): s_corr's ratio scale
    corr_k: float
    rho_recip: float
    cfm: float

    @staticmethod
    def of(h: float) -> "PairConstants":
        f = np.float32
        p6f = f(poly6_factor(h))
        skf = f(spiky_kernel_factor(h))
        hh = f(h * h)
        cdq = f(K.CORR_DELTA_Q * h)
        p6dq = p6f * (hh - cdq * cdq) ** 3
        rr = f(K.RHO_RECIP)
        return PairConstants(
            h=float(f(h)), hh=float(hh), eps2=float(f(K.EPSILON) * f(K.EPSILON)),
            p6f=float(p6f), skf=float(skf), c_grad=float(skf * rr),
            xqf=float(f(p6f / p6dq)), corr_k=float(f(-K.CORR_K)),
            rho_recip=float(rr), cfm=float(f(K.CFM_EPSILON)),
        )


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def neighbour_ranges(index: CellIndex) -> Tuple[torch.Tensor, torch.Tensor]:
    """(9, C) int64 [lo, hi) of each row's (dx, dy) candidate range, in the
    kernels' order (dx outer, dy inner); empty for non-member rows."""
    _, ny, nz = index.grid.dims
    ncells = index.grid.ncells
    key = index.key.long()
    table = index.table.long()
    member = key < ncells
    lin = torch.where(member, key, 0)
    los, his = [], []
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            base = lin + (ox * ny * nz + oy * nz)
            lo = table[torch.clamp(base - 1, 0, ncells)]
            hi = table[torch.clamp(base + 2, 0, ncells)]
            los.append(lo)
            his.append(torch.where(member, hi, lo))
    return torch.stack(los), torch.stack(his)


def _candidate_blocks(index: CellIndex, rows_per_block: int = 1 << 16
                      ) -> Iterator[Tuple[slice, torch.Tensor, torch.Tensor]]:
    """Yield (rows, idx, valid) for every block of rows and each of the nine
    ranges: idx is (R, L) candidate indices padded to the widest range L,
    valid masks the padding (whose idx is 0)."""
    lo, hi = neighbour_ranges(index)
    width = int((hi - lo).max()) if lo.numel() else 0
    steps = torch.arange(width, device=lo.device)
    n = lo.shape[1]
    for r0 in range(0, n, rows_per_block):
        rows = slice(r0, min(n, r0 + rows_per_block))
        for s in range(9):
            idx = lo[s, rows, None] + steps
            valid = idx < hi[s, rows, None]
            yield rows, torch.where(valid, idx, 0), valid


def lambda_plain(index: CellIndex, h: float, pstar, mass):
    """Raw lambda (C,) before the fluid mask; what `lambda_kernel` computes."""
    c = PairConstants.of(h)
    p6s = torch.zeros_like(mass)
    g = torch.zeros_like(pstar)
    for rows, idx, valid in _candidate_blocks(index):
        d = pstar[:, rows, None] - pstar[:, idx]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        d2p = torch.clamp(c.hh - r2, min=0.0)
        p6s[rows] += torch.where(valid, d2p * d2p * d2p, 0.0).sum(1)
        r2c = torch.clamp(r2, min=c.eps2)
        u = torch.rsqrt(r2c)
        tt = torch.clamp(c.h - r2c * u, min=0.0)
        sg = torch.where(valid, tt * tt * u, 0.0)
        g[:, rows] += (d * sg).sum(2)
    rho = mass * (p6s * c.p6f)
    gc = g * c.c_grad
    norm2 = gc[0] * gc[0] + gc[1] * gc[1] + gc[2] * gc[2]
    return -(rho * c.rho_recip - 1.0) / (norm2 + c.cfm)


def delta_plain(index: CellIndex, h: float, pstar, lam):
    """Raw position correction (3, C) before the clamp; what `delta_kernel`
    computes."""
    c = PairConstants.of(h)
    dp = torch.zeros_like(pstar)
    for rows, idx, valid in _candidate_blocks(index):
        d = pstar[:, rows, None] - pstar[:, idx]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        d2p = torch.clamp(c.hh - r2, min=0.0)
        xq = d2p * d2p * d2p * c.xqf
        x2 = xq * xq
        corr = c.corr_k * x2 * x2
        factor = (lam[rows, None] + lam[idx] + corr) * c.rho_recip
        r2c = torch.clamp(r2, min=c.eps2)
        u = torch.rsqrt(r2c)
        tt = torch.clamp(c.h - r2c * u, min=0.0)
        sg = torch.where(valid, (c.skf * (tt * tt) * u) * factor, 0.0)
        dp[:, rows] += (d * sg).sum(2)
    return dp


def _decode(lin, grid: GridSpec):
    _, ny, nz = grid.dims
    cx = lin // (ny * nz)
    cy = (lin - cx * (ny * nz)) // nz
    return cx, cy, lin - cx * (ny * nz) - cy * nz


def diffuse_plain(index: CellIndex, colour, nonobs):
    """(5, C) [sum r, sum g, sum b, sum a, count] over the non-obstacle
    candidates in the 27 adjacent cells; what `diffuse_kernel` computes.

    Sums run candidate by candidate in the kernel's order, so the two agree
    bit for bit."""
    out = torch.zeros((5, colour.shape[1]), dtype=colour.dtype, device=colour.device)
    key = index.key.long()
    own = _decode(torch.clamp(key, max=index.grid.ncells - 1), index.grid)
    for rows, idx, valid in _candidate_blocks(index):
        cand = _decode(key[idx], index.grid)
        adj = valid & (nonobs[idx] > 0.5)
        for a in range(3):
            adj &= torch.abs(cand[a] - own[a][rows, None]) <= 1
        for j in range(idx.shape[1]):
            w = adj[:, j]
            out[:4, rows] += torch.where(w, colour[:, idx[:, j]], 0.0)
            out[4, rows] += w.to(colour.dtype)
    return out


# ---------------------------------------------------------------------------
# CUDA kernel launchers
# ---------------------------------------------------------------------------


def _check_cuda(index: CellIndex, **tensors) -> None:
    """Raise on anything the kernels do not take."""
    dev = index.key.device
    n = index.key.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    if index.grid.dims[2] < 3:
        raise ValueError("the nine neighbour ranges are disjoint only for nz >= 3")
    want = dict(key=(torch.int32, (n,)),
                table=(torch.int32, (index.grid.ncells + 1,)))
    tensors = dict(key=index.key, table=index.table, **tensors)
    for name, t in tensors.items():
        dtype, shape = want.get(name, (torch.float32, None))
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor on {dev}, "
                f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: want shape {shape}, got {tuple(t.shape)}")
        if shape is None and t.shape[-1] != n:
            raise ValueError(f"{name}: last dim {t.shape[-1]} != capacity {n}")


def _grid_args(index: CellIndex):
    _, ny, nz = index.grid.dims
    return index.key.shape[0], ny, nz, index.grid.ncells


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def lambda_kernel(index: CellIndex, h: float, pstar, mass):
    """Raw lambda (C,) from `pbf_lambda` (replaces `make_lambda_call`)."""
    _check_cuda(index, pstar=pstar, mass=mass)
    cand = torch.stack([pstar[0], pstar[1], pstar[2], mass], dim=1)  # (C, 4)
    lam = torch.empty_like(mass)
    lambda_launch(index, h, cand, lam)
    return lam


def lambda_launch(index: CellIndex, h: float, cand, lam) -> None:
    """`pbf_lambda` on a (C, 4) pack (x, y, z, mass) into `lam` (C,)."""
    c = PairConstants.of(h)
    lib = cuda_build.library()
    with torch.cuda.device(cand.device):
        err = lib.pbf_lambda(
            cand.data_ptr(), index.key.data_ptr(), index.table.data_ptr(),
            *_grid_args(index), c.h, c.hh, c.eps2, c.p6f, c.c_grad,
            c.rho_recip, c.cfm, lam.data_ptr(), _stream(cand.device))
    cuda_build.check("pbf_lambda", err)


def delta_kernel(index: CellIndex, h: float, pstar, lam):
    """Raw position correction (3, C) from `pbf_delta` (replaces
    `make_delta_call`)."""
    _check_cuda(index, pstar=pstar, lam=lam)
    cand = torch.stack([pstar[0], pstar[1], pstar[2], lam], dim=1)  # (C, 4)
    dp = torch.empty_like(pstar)
    delta_launch(index, h, cand, dp)
    return dp


def delta_launch(index: CellIndex, h: float, cand, dp) -> None:
    """`pbf_delta` on a (C, 4) pack (x, y, z, lambda) into `dp` (3, C)."""
    c = PairConstants.of(h)
    lib = cuda_build.library()
    with torch.cuda.device(cand.device):
        err = lib.pbf_delta(
            cand.data_ptr(), index.key.data_ptr(), index.table.data_ptr(),
            *_grid_args(index), c.h, c.hh, c.eps2, c.skf, c.xqf, c.corr_k,
            c.rho_recip, dp.data_ptr(), _stream(cand.device))
    cuda_build.check("pbf_delta", err)


def diffuse_kernel(index: CellIndex, colour, nonobs):
    """(5, C) colour sums and count from `pbf_diffuse` (replaces
    `make_diffuse_call`)."""
    _check_cuda(index, colour=colour, nonobs=nonobs)
    lib = cuda_build.library()
    packed = colour.t().contiguous()  # (C, 4)
    out = torch.empty((5, colour.shape[1]), dtype=colour.dtype, device=colour.device)
    with torch.cuda.device(colour.device):
        err = lib.pbf_diffuse(
            packed.data_ptr(), nonobs.data_ptr(), index.key.data_ptr(),
            index.table.data_ptr(), *_grid_args(index), out.data_ptr(),
            _stream(colour.device))
    cuda_build.check("pbf_diffuse", err)
    return out


# ---------------------------------------------------------------------------
# Phase wrappers
# ---------------------------------------------------------------------------


def clamp_to_bounds(pstar, dp, ptype, alive, scale, min_bound, max_bound):
    """pstar + dp clamped to the bounds in world units, for fluid rows only
    (`pallas_pbf.py:706-713`)."""
    return clamp_fluid(pstar, dp, (ptype == FLUID) & alive, scale, min_bound, max_bound)


def clamp_fluid(pstar, dp, fluid, scale, min_bound, max_bound):
    """`clamp_to_bounds` with the fluid mask given."""
    rows = []
    for a in range(3):
        moved = torch.clamp((pstar[a] + dp[a]) * scale, min_bound[a], max_bound[a]) / scale
        rows.append(torch.where(fluid, moved, pstar[a]))
    return torch.stack(rows)


def mix_colour(colour, sums, ptype, alive, dt):
    """Colour mixed toward 1.33x the neighbour mean with weight dt/750 and
    clamped to [0.03, 1], for fluid rows with a neighbour
    (`pallas_pbf.py:728-737`)."""
    cnt = sums[4]
    cnt_safe = torch.clamp(cnt, min=1.0)
    upd = (ptype == FLUID) & alive & (cnt > 0.5)
    rate = dt / torch.full_like(dt, 750.0)
    rows = []
    for a in range(4):
        target = (sums[a] / cnt_safe) * 1.33
        mixed = colour[a] + rate * (target - colour[a])
        rows.append(torch.where(upd, torch.clamp(mixed, 0.03, 1.0), colour[a]))
    return torch.stack(rows)


def nonobstacle(ptype, alive, dtype=torch.float32):
    """1.0 where a candidate counts toward diffusion.  Candidates in the
    ranges are members by construction, so only the non-obstacle test is left
    of the Pallas `nonobs * memberf`."""
    return ((ptype != OBSTACLE) & alive).to(dtype)


class PbfPhases:
    """The three phase wrappers of one solver, with a launch counter per
    kernel: `launches[name]` grows by one each time the wrapper launches its
    CUDA kernel, and at no other time.

    `diffuse` runs the kernels of `ops/diffuse_cells.py`
    ("diffuse_cell_sums", "diffuse_cells"), `diffuse_rows` the per-row
    kernel above ("diffuse").  `sub` and `mxu` mirror `PallasPhases(...,
    sub, mxu)`: with the defaults (`sub=None, mxu=False`) `solve` runs the
    iterated solve through the kernels of `ops/cells.py` ("lambda_cells",
    "delta_cells"), and
    `lambda_phase`/`delta_phase` run the per-row kernels above; any other
    setting runs both through the tiled kernels of `ops/tiles.py` (`sub` 64
    when only `mxu` is given), counted under "lambda_tile" and
    "delta_tile"."""

    def __init__(self, h: float, sub=None, mxu: bool = False):
        from pbf_sph_tpu_torch.ops import tiles

        self.h = float(h)
        self.mxu = bool(mxu)
        self.plan = None
        self.launches = {"diffuse": 0, "diffuse_cell_sums": 0, "diffuse_cells": 0,
                         "lambda": 0, "delta": 0}
        if sub is not None or self.mxu:
            self.plan = tiles.TilePlan(64 if sub is None else sub)
            self.launches.update(lambda_tile=0, delta_tile=0)
        else:
            self.launches.update(lambda_cells=0, delta_cells=0)

    def reset_launches(self) -> None:
        for name in self.launches:
            self.launches[name] = 0

    def lambda_phase(self, index: CellIndex, pstar, mass, ptype, alive):
        """lambda (C,), zero where not fluid and alive (`pallas_pbf.py:690-697`)."""
        cpu = pstar.device.type == "cpu"
        if self.plan is not None:
            from pbf_sph_tpu_torch.ops import tiles

            args = (self.plan(index), index, self.h, pstar, mass, self.plan.sub, self.mxu)
            if cpu:
                lam = tiles.lambda_tile_plain(*args)
            else:
                lam = tiles.lambda_tile_kernel(*args)
                self.launches["lambda_tile"] += 1
        elif cpu:
            lam = lambda_plain(index, self.h, pstar, mass)
        else:
            lam = lambda_kernel(index, self.h, pstar, mass)
            self.launches["lambda"] += 1
        return torch.where((ptype == FLUID) & alive, lam, 0.0)

    def delta_phase(self, index: CellIndex, pstar, lam, ptype, alive,
                    scale, min_bound, max_bound):
        """pstar after one position correction and the bounds clamp."""
        cpu = pstar.device.type == "cpu"
        if self.plan is not None:
            from pbf_sph_tpu_torch.ops import tiles

            args = (self.plan(index), index, self.h, pstar, lam, self.plan.sub, self.mxu)
            if cpu:
                dp = tiles.delta_tile_plain(*args)
            else:
                dp = tiles.delta_tile_kernel(*args)
                self.launches["delta_tile"] += 1
        elif cpu:
            dp = delta_plain(index, self.h, pstar, lam)
        else:
            dp = delta_kernel(index, self.h, pstar, lam)
            self.launches["delta"] += 1
        return clamp_to_bounds(pstar, dp, ptype, alive, scale, min_bound, max_bound)

    def solve(self, index: CellIndex, pstar, mass, ptype, alive, iteration: int,
              scale, min_bound, max_bound, mark=None, refresh_lam=None,
              refresh_pstar=None):
        """pstar (3, C) after `iteration` rounds of lambda, then delta and the
        bounds clamp (`jax_solver.py:328-339`); `mark(name)` after each
        stage.  With the defaults the rounds run on two (C, 4) packs made
        once ("packs") through the kernels of `ops/cells.py`; the tiled
        variants take the rounds phase by phase.

        `refresh_lam` ((C,) -> (C,)) and `refresh_pstar` ((3, C) -> (3, C))
        are the slab engine's halo hooks (`jax_solver.py:318-350`).  On the
        packs λ writes pack B = (xyz, λ) and Δp writes the clamped pStar into
        pack A's xyz, so `refresh_lam` applies to B's λ column after each λ
        launch and `refresh_pstar` to A's xyz after each Δp launch; nothing
        else moves between the launches.  A ghost row is fluid and alive, so
        λ writes it a value from its partial neighbourhood, which the refresh
        overwrites before Δp reads it.  With both None the launches follow
        each other with nothing between them."""
        mark = mark or (lambda name: None)
        if self.plan is not None:
            for _ in range(iteration):
                lam = self.lambda_phase(index, pstar, mass, ptype, alive)
                if refresh_lam is not None:
                    lam = refresh_lam(lam)
                mark("lambda")
                pstar = self.delta_phase(index, pstar, lam, ptype, alive,
                                         scale, min_bound, max_bound)
                if refresh_pstar is not None:
                    pstar = refresh_pstar(pstar)
                mark("delta")
            return pstar
        from pbf_sph_tpu_torch.ops import cells

        fluid = (ptype == FLUID) & alive
        pack_a = torch.stack([pstar[0], pstar[1], pstar[2], mass], dim=1)  # (C, 4)
        pack_b = torch.empty_like(pack_a)
        bounds = (scale, min_bound, max_bound)
        mark("packs")
        cpu = pstar.device.type == "cpu"
        for _ in range(iteration):
            if cpu:
                cells.lambda_cells_plain(index, self.h, pack_a, fluid, pack_b)
            else:
                cells.lambda_cells_kernel(index, self.h, pack_a, fluid, pack_b)
                self.launches["lambda_cells"] += 1
            if refresh_lam is not None:
                pack_b[:, 3] = refresh_lam(pack_b[:, 3])
            mark("lambda")
            if cpu:
                cells.delta_cells_plain(index, self.h, pack_b, fluid, *bounds, pack_a)
            else:
                cells.delta_cells_kernel(index, self.h, pack_b, fluid, *bounds, pack_a)
                self.launches["delta_cells"] += 1
            if refresh_pstar is not None:
                pack_a[:, :3] = refresh_pstar(pack_a[:, :3].T).T
            mark("delta")
        return pack_a[:, :3].T

    def diffuse(self, index: CellIndex, colour, ptype, alive, dt):
        """Colour after one diffusion step: the per-cell colour sums, then
        the 27-cell gather with the mix (`ops/diffuse_cells.py`)."""
        from pbf_sph_tpu_torch.ops import diffuse_cells as dc

        if colour.device.type == "cpu":
            pack = dc.diffuse_cell_sums_plain(index, colour, ptype, alive)
            return dc.diffuse_cells_plain(index, pack, colour, ptype, alive, dt)
        pack = dc.diffuse_cell_sums_kernel(index, colour, ptype, alive)
        self.launches["diffuse_cell_sums"] += 1
        colour = dc.diffuse_cells_kernel(index, pack, colour, ptype, alive, dt)
        self.launches["diffuse_cells"] += 1
        return colour

    def diffuse_rows(self, index: CellIndex, colour, ptype, alive, dt):
        """`diffuse` through the per-row kernel and `mix_colour`
        (`pallas_pbf.py:715-737`)."""
        nonobs = nonobstacle(ptype, alive, colour.dtype)
        if colour.device.type == "cpu":
            sums = diffuse_plain(index, colour, nonobs)
        else:
            sums = diffuse_kernel(index, colour, nonobs)
            self.launches["diffuse"] += 1
        return mix_colour(colour, sums, ptype, alive, dt)
