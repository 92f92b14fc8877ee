"""The iterated λ/Δp solve on two (C, 4) packs, with the mask and clamp inside.

The main path's λ and Δp (`csrc/pbf_cells.cu`, `pbf_lambda_cells` and
`pbf_delta_cells`), redesigned for Hopper from the per-row kernels of
`ops/phases.py`.  They compute what `PbfPhases.lambda_phase` and
`delta_phase` compute, the wrappers' mask and clamp included, on two packs a
frame makes once: A = (x, y, z, mass) and B = (x, y, z, λ).  λ reads A and
writes B with λ masked to fluid rows; Δp reads B and writes the clamped pStar
into A's xyz.  As in `ops/phases.py` each kernel has a launcher
(`lambda_cells_kernel`, `delta_cells_kernel`) and a plain PyTorch version of
the same signature (`lambda_cells_plain`, `delta_cells_plain`);
`PbfPhases.solve` picks between them by the device of the packs alone.

Both kernels walk a row's nine ranges in the per-row kernels' order and
read the candidates from the pack in device memory.  Staging them in shared
memory per run of cells was built and measured slower on the card; it is
kept as a measurement in `tools/cells_staged.py`, which reuses the plain
versions' sums here (`lambda_cells_from`, `delta_cells_from`) over its own
walk.

The plain versions sum each row's pairs one by one in the kernels' order and
round each fused multiply-add of the kernels once, so on the card the two
agree to the last bits even over the thousands of pairs of an
over-compressed row.
"""

from __future__ import annotations

import torch

from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops.phases import (
    CellIndex,
    PairConstants,
    _candidate_blocks,
    _stream,
    clamp_fluid,
)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """a * b + c rounded once to fp32, as the card's FFMA (the product of two
    fp32 values is exact in float64)."""
    return (a.double() * b.double() + (c.double() if torch.is_tensor(c) else c)).float()


def _fma_into(acc, a, b, valid) -> None:
    """acc (K, R) = fma(a[..., j], b[..., j], acc) for each candidate j in
    turn, where valid: a row's pairs summed one by one in the kernels' order.
    A padded pair adds an exact 0, which leaves every fp32 sum as it is."""
    prod = torch.where(valid, a.double() * b.double(), 0.0)
    for j in range(prod.shape[-1]):
        acc.copy_(prod[..., j] + acc)


def _pair_geometry(c: PairConstants, x, rows, idx):
    """d (3, R, L), d2p and the spiky factor u * max(h - r, 0)^2's parts (tt,
    u), with the kernels' fused multiply-adds (csrc/pbf_cells_pair.cuh)."""
    d = x[:, rows, None] - x[:, idx]
    r2 = _fma(d[2], d[2], _fma(d[0], d[0], d[1] * d[1]))
    d2p = torch.clamp(c.hh - r2, min=0.0)
    r2c = torch.clamp(r2, min=c.eps2)
    u = torch.rsqrt(r2c)
    tt = torch.clamp(_fma(-r2c, u, c.h), min=0.0)
    return d, d2p, tt, u


def lambda_cells_plain(index: CellIndex, h: float, pack_a, fluid, pack_b) -> None:
    """pack_b = (pack_a's xyz, λ where fluid else 0): what `lambda_cells_kernel`
    writes, pair by pair in its order and with its fused multiply-adds."""
    lambda_cells_from(_candidate_blocks(index), h, pack_a, fluid, pack_b)


def lambda_cells_from(blocks, h: float, pack_a, fluid, pack_b) -> None:
    """`lambda_cells_plain` over the candidate blocks of a walk, (rows, idx,
    valid) as `ops/phases.py::_candidate_blocks` yields them, in the
    kernel's order."""
    c = PairConstants.of(h)
    x, mass = pack_a[:, :3].T, pack_a[:, 3]
    sums = torch.zeros((4, mass.shape[0]), dtype=mass.dtype, device=mass.device)
    for rows, idx, valid in blocks:
        d, d2p, tt, u = _pair_geometry(c, x, rows, idx)
        sg = (tt * tt) * u
        # p6s += d2p^2 * d2p and g += d * sg, as four fused sums at once
        _fma_into(sums[:, rows], torch.cat([(d2p * d2p)[None], d]),
                  torch.stack([d2p, sg, sg, sg]), valid)
    p6s, g = sums[0], sums[1:]
    rho = mass * (p6s * c.p6f)
    gc = g * c.c_grad
    norm2 = _fma(gc[2], gc[2], _fma(gc[0], gc[0], gc[1] * gc[1]))
    lam = -_fma(rho, torch.full_like(rho, c.rho_recip), -1.0) / (norm2 + c.cfm)
    pack_b[:, :3] = pack_a[:, :3]
    pack_b[:, 3] = torch.where(fluid, lam, 0.0)


def delta_cells_plain(index: CellIndex, h: float, pack_b, fluid, scale, min_bound,
                      max_bound, pack_a) -> None:
    """pack_a's xyz = pStar after one position correction and the bounds
    clamp, from pack_b = (pStar, λ): what `delta_cells_kernel` writes, pair by
    pair in its order and with its fused multiply-adds."""
    delta_cells_from(_candidate_blocks(index), h, pack_b, fluid, scale, min_bound, max_bound,
                     pack_a)


def delta_cells_from(blocks, h: float, pack_b, fluid, scale, min_bound, max_bound,
                     pack_a) -> None:
    """`delta_cells_plain` over the candidate blocks of a walk, as
    `lambda_cells_from`."""
    c = PairConstants.of(h)
    x, lam = pack_b[:, :3].T, pack_b[:, 3]
    dp = torch.zeros((3, lam.shape[0]), dtype=lam.dtype, device=lam.device)
    for rows, idx, valid in blocks:
        d, d2p, tt, u = _pair_geometry(c, x, rows, idx)
        xq = d2p * d2p * d2p * c.xqf
        x2 = xq * xq
        factor = _fma(c.corr_k * x2, x2, lam[rows, None] + lam[idx]) * c.rho_recip
        sg = (c.skf * (tt * tt) * u) * factor
        _fma_into(dp[:, rows], d, sg, valid)
    pack_a[:, :3] = clamp_fluid(x, dp, fluid, scale, min_bound, max_bound).T


# ---------------------------------------------------------------------------
# CUDA kernel launchers
# ---------------------------------------------------------------------------


def _check_cells(index: CellIndex, src, dst, fluid, **bounds) -> None:
    """Raise on anything the kernels do not take."""
    dev, n = index.key.device, index.key.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    if index.grid.dims[2] < 3:
        raise ValueError("the nine neighbour ranges are disjoint only for nz >= 3")
    want = dict(key=(torch.int32, (n,)), table=(torch.int32, (index.grid.ncells + 1,)),
                src=(torch.float32, (n, 4)), dst=(torch.float32, (n, 4)),
                fluid=(torch.bool, (n,)), scale=(torch.float32, ()),
                min_bound=(torch.float32, (3,)), max_bound=(torch.float32, (3,)))
    tensors = dict(key=index.key, table=index.table, src=src, dst=dst, fluid=fluid, **bounds)
    for name, t in tensors.items():
        dtype, shape = want[name]
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: want a contiguous {dtype} {shape} tensor on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")
    if src.data_ptr() == dst.data_ptr():
        raise ValueError("the packs read and written must not alias")


def _grid_args(index: CellIndex):
    _, ny, nz = index.grid.dims
    return index.key.shape[0], ny, nz, index.grid.ncells


def lambda_cells_kernel(index: CellIndex, h: float, pack_a, fluid, pack_b) -> None:
    """`pbf_lambda_cells`: pack_b = (pack_a's xyz, masked λ) (replaces
    `make_lambda_call` and the wrapper's mask)."""
    _check_cells(index, pack_a, pack_b, fluid)
    with torch.cuda.device(pack_a.device):
        err = cuda_build.library().pbf_lambda_cells(
            *lambda_cells_args(index, h, pack_a, fluid, pack_b))
    cuda_build.check("pbf_lambda_cells", err)


def lambda_cells_args(index: CellIndex, h: float, pack_a, fluid, pack_b):
    """The arguments of the C launcher `pbf_lambda_cells`."""
    c = PairConstants.of(h)
    return (pack_a.data_ptr(), index.key.data_ptr(), index.table.data_ptr(), fluid.data_ptr(),
            *_grid_args(index), c.h, c.hh, c.eps2, c.p6f, c.c_grad, c.rho_recip, c.cfm,
            pack_b.data_ptr(), _stream(pack_a.device))


def delta_cells_kernel(index: CellIndex, h: float, pack_b, fluid, scale, min_bound,
                       max_bound, pack_a) -> None:
    """`pbf_delta_cells`: pack_a's xyz = clamped pStar + Δp (replaces
    `make_delta_call` and the wrapper's clamp)."""
    _check_cells(index, pack_b, pack_a, fluid, scale=scale, min_bound=min_bound,
                 max_bound=max_bound)
    with torch.cuda.device(pack_b.device):
        err = cuda_build.library().pbf_delta_cells(*delta_cells_args(
            index, h, pack_b, fluid, scale, min_bound, max_bound, pack_a))
    cuda_build.check("pbf_delta_cells", err)


def delta_cells_args(index: CellIndex, h: float, pack_b, fluid, scale, min_bound, max_bound,
                     pack_a):
    """The arguments of the C launcher `pbf_delta_cells`."""
    c = PairConstants.of(h)
    return (pack_b.data_ptr(), index.key.data_ptr(), index.table.data_ptr(), fluid.data_ptr(),
            scale.data_ptr(), min_bound.data_ptr(), max_bound.data_ptr(), *_grid_args(index),
            c.h, c.hh, c.eps2, c.skf, c.xqf, c.corr_k, c.rho_recip, pack_a.data_ptr(),
            _stream(pack_b.device))
