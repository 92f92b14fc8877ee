"""Precision of a centred matmul r² for the pair phases.

Port of `tools/precision_centered.py`.  It asks whether a tensor-core r²
(r² = |a|² + |b|² − 2 a·b as one K = 5 matmul) and a factored gradient sum
(Σ (a−b) sg = a Σsg − Σ b sg) hold fp32 precision once each sub-block is
translated to its centroid.  On the JAX tool's jittered-lattice scene (a
12³ lattice of spacing h/2 about 8 sim units from the origin, 64 rows and
every candidate within 2.5h, padded to 128 lanes far away) it reports the
ρ and gradient errors, relative to the largest magnitude, of

  A) fp32 per-pair math (rows 1b/2b's structure: r² from differences, rsqrt),
  B) fp32 centred matmul r² with the per-pair gradient,
  C) fp32 centred matmul r² with the factored gradient,
  D) C uncentred,

against a float64 per-pair oracle, and A-C again with a near-coincident
pair (r = 5e-7) injected.  The variants run in torch on the card and on the
CPU.  The matmuls run in fp32 with TF32 off (`torch.backends.cuda.matmul.
allow_tf32 = False`), the counterpart of the JAX tool's Precision.HIGHEST:
a TF32 r² would be a different, coarser experiment.

    python -m pbf_sph_tpu_torch.tools.precision_centered [--devices cpu]

On the card it runs the variants there and on the CPU; with `--devices cpu`
only on the CPU.  JSON last.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.tools import study

H = 0.1
HH = np.float32(H * H)
HF = np.float32(H)
EPS2 = np.float32(1e-16)
SUB = 64


def scene(seed: int = 7) -> Tuple[np.ndarray, np.ndarray]:
    """(rows (64, 3), candidates (NB, 3)) float64, the JAX tool's scene."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"), -1)
    pts = (grid.reshape(-1, 3) * (H / 2) + 8.0
           + rng.uniform(-0.01, 0.01, (grid.size // 3, 3)))
    rng.shuffle(pts)
    a = pts[:SUB]
    near = pts[(np.abs(pts - a.mean(0)) < 2.5 * H).all(1)]
    nb = -(-len(near) // 128) * 128
    pad = np.full((nb - len(near), 3), 1e3)
    return a, np.concatenate([near, pad])


def near_coincident(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """b with its first candidate 3e-7 from row 0 on each axis (r = 5e-7)."""
    b2 = b.copy()
    b2[0] = a[0] + 3e-7
    return b2


def pair_oracle_f64(a, b):
    """Per pair in float64: (ρ sums (SUB,), gradient sums (SUB, 3))."""
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64)
    d = a[:, None, :] - b[None, :, :]
    r2 = (d * d).sum(-1)
    r = torch.sqrt(r2)
    p6 = torch.where(r2 <= H * H, (H * H - r2) ** 3, 0.0)
    ok = (r >= 1e-8) & (r <= H)
    sg = torch.where(ok, (H - r) ** 2 / torch.where(ok, r, 1.0), 0.0)
    return p6.sum(1), (d * sg[..., None]).sum(1)


def variant_a(a, b):
    """fp32 per pair: r² from the differences, rsqrt."""
    d = a[:, None, :] - b[None, :, :]
    r2 = (d * d).sum(-1)
    tt = torch.clamp(float(HH) - r2, min=0.0)
    p6 = tt * tt * tt
    r2c = torch.clamp(r2, min=float(EPS2))
    u = 1.0 / torch.sqrt(r2c)
    t2 = torch.clamp(float(HF) - r2c * u, min=0.0)
    sg = t2 * t2 * u
    return p6.sum(1), (d * sg[..., None]).sum(1)


def _sg_p6(r2):
    r2 = torch.clamp(r2, min=float(EPS2))
    tt = torch.clamp(float(HH) - r2, min=0.0)
    p6 = tt * tt * tt
    u = torch.rsqrt(r2)
    t2 = torch.clamp(float(HF) - r2 * u, min=0.0)
    # the factored gradient cannot rely on d = 0 to cancel the self pair's
    # sg ~ 1/EPS: zero it, as the reference's r >= EPS test does
    sg = torch.where(r2 > float(EPS2), t2 * t2 * u, 0.0)
    return p6, sg


def variant_bc(a, b, centred: bool = True, factored: bool = False):
    """The K = 5 matmul r² (centred on the rows' mean or not), then the
    per-pair or the factored gradient."""
    if centred:
        c = a.mean(0)
        a, b = a - c, b - c
    a2 = (a * a).sum(1)
    b2 = (b * b).sum(1)
    one_a = torch.ones((a.shape[0], 1), dtype=a.dtype, device=a.device)
    one_b = torch.ones((b.shape[0], 1), dtype=b.dtype, device=b.device)
    A = torch.cat([a, a2[:, None], one_a], 1)
    B = torch.cat([-2.0 * b, one_b, b2[:, None]], 1)
    r2 = A @ B.T
    p6, sg = _sg_p6(r2)
    if factored:
        grad = a * sg.sum(1)[:, None] - sg @ b
    else:
        d = a[:, None, :] - b[None, :, :]
        grad = (d * sg[..., None]).sum(1)
    return p6.sum(1), grad


VARIANTS = {
    "A per-pair fp32 (rows 1b/2b)": lambda a, b: variant_a(a, b),
    "B centred matmul r2, per-pair grad": lambda a, b: variant_bc(a, b, True, False),
    "C centred matmul r2 + factored grad": lambda a, b: variant_bc(a, b, True, True),
    "D uncentred matmul r2 + factored grad": lambda a, b: variant_bc(a, b, False, True),
}


def errors(a, b, device, names=tuple(VARIANTS)) -> Dict[str, Tuple[float, float]]:
    """{variant: (ρ relative error, gradient relative error)} of each
    variant of `names` in fp32 on `device` against the float64 oracle."""
    rho64, grad64 = pair_oracle_f64(a, b)
    gscale = float(grad64.abs().max())
    a32 = torch.as_tensor(a, dtype=torch.float32, device=device)
    b32 = torch.as_tensor(b, dtype=torch.float32, device=device)
    out = {}
    for name in names:
        rho, grad = (t.double().cpu() for t in VARIANTS[name](a32, b32))
        out[name] = (float((rho - rho64).abs().max() / rho64.abs().max()),
                     float((grad - grad64).abs().max() / gscale))
    return out


def main(argv=None) -> int:
    device, argv = study.pop_device(sys.argv[1:] if argv is None else argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = study.card_line(device)
    print(card)
    print("matmuls in fp32 with TF32 off")
    a, b = scene()
    print(f"rows={len(a)} cands={len(b)} (true {int((b < 1e2).all(1).sum())})")
    devices = [device] + ([torch.device("cpu")] if device.type == "cuda" else [])
    res = {"card": card, "tf32": False, "errors": {}}
    for dev in devices:
        for tag, cands, names in (
                ("lattice", b, tuple(VARIANTS)),
                ("near-coincident pair (r = 5e-7)", near_coincident(a, b), tuple(VARIANTS)[:3])):
            errs = errors(a, cands, dev, names)
            print(f"{dev}, {tag}:")
            for name, (e_rho, e_grad) in errs.items():
                print(f"  {name:40s} rho relerr {e_rho:9.2e}   grad relerr {e_grad:9.2e}")
            res["errors"][f"{dev} {tag}"] = errs
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
