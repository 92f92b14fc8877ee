"""The port's rate anchor (`pbf_sph_tpu_torch/tools/anchor_rate.py`) against
the JAX package's `tools/anchor_rate.py`.

The JAX tool lives in `tools/`, outside the package; it is loaded from its
file, and its Pallas kernels run in interpret mode on the CPU
(`pltpu.force_tpu_interpret_mode`), at small sizes: the issue kernels at 4
streams x 4 rounds x 8 iterations, the bodies at nunroll 2, nch 2, 3
iterations, the row kernel at 1 block.  The port's `Anchor` wrappers run
their plain versions on these CPU tensors and launch nothing.

Tolerances: the issue tiles and the bodies' per-row sums rtol 1e-5, atol
1e-6 (fp32 sums in another order); λ of the row kernel atol 1e-9 (every sum
is 0, λ = 1/CFM_EPSILON).  The bodies are also held against a float64 numpy
evaluation of the same pair sums on random rows and strips, rtol 1e-5.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pbf_sph_tpu_torch.core.constants import DEFAULT_CONSTANTS as K
from pbf_sph_tpu_torch.ops.phases import PairConstants
from pbf_sph_tpu_torch.tools import anchor_rate as ar

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the tier runs several test
    processes at once, and torch's default pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def jax_anchor():
    spec = importlib.util.spec_from_file_location(
        "anchor_rate_reference", REPO / "tools" / "anchor_rate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def interpreted(fn):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn())


@pytest.mark.parametrize("op", ar.OPS)
def test_issue_plain_matches_pallas(op):
    build, per_iter = jax_anchor().build_issue(op, nstreams=4, unroll=4)
    want = interpreted(build(8))
    anchor = ar.Anchor()
    got = anchor.issue(torch.full(ar.TILE, 1.0000001), op, 4, 4, 8)
    assert per_iter == 16 * ar.OPS_PER_ROUND[op]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert anchor.launches == dict.fromkeys(ar.KERNELS, 0)


@pytest.mark.parametrize("which", ["lambda", "delta"])
def test_body_plain_matches_pallas(which):
    want = interpreted(jax_anchor().build_body(which, nunroll=2, nch=2)(3)).sum(axis=1)
    rows = torch.full((5, ar.SUB), 0.05)
    strip = torch.full((4, 2 * ar.WCOL), 0.055)
    anchor = ar.Anchor()
    got = anchor.body(rows, strip, which, 2, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert anchor.launches == dict.fromkeys(ar.KERNELS, 0)


def pair_sums_f64(rows, strip, which, nunroll, niter, stride):
    """Each row's sum of its pairs' summed carries, in float64, chunk by chunk
    in the kernel's order of reads."""
    c = PairConstants.of(ar.H)
    a = rows.numpy().astype(np.float64)
    b = strip.numpy().astype(np.float64)
    d = a[:3, :, None] - b[:3, None, :]
    r2 = (d * d).sum(0)
    d2p = np.maximum(c.hh - r2, 0.0)
    r2c = np.maximum(r2, c.eps2)
    u = 1.0 / np.sqrt(r2c)
    tt = np.maximum(c.h - r2c * u, 0.0)
    if which == "lambda":
        terms = d2p ** 3 + d.sum(0) * (tt * tt * u)
    else:
        corr = c.corr_k * (d2p ** 3 * c.xqf) ** 4
        factor = (a[3][:, None] + b[3][None, :] + corr) * c.rho_recip
        terms = d.sum(0) * (c.skf * tt * tt * u * factor)
    nch = b.shape[1] // ar.WCOL
    out = np.zeros(a.shape[1])
    for i in range(niter):
        for k in range(nunroll):
            chunk = (k + i * stride) % nch
            out += terms[:, chunk * ar.WCOL:(chunk + 1) * ar.WCOL].sum(1)
    return out


@pytest.mark.parametrize("which", ["lambda", "delta"])
@pytest.mark.parametrize("seed", [0, 1])
def test_body_plain_matches_float64(which, seed):
    rows, strip = ar.random_body_inputs(seed, nch=3)
    got = ar.body_plain(rows, strip, which, nunroll=5, niter=4, stride=seed + 1)
    want = pair_sums_f64(rows, strip, which, 5, 4, seed + 1)
    assert np.all(want != 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_chunk_reads_count_every_read():
    reads = ar.chunk_reads(nch=3, nunroll=5, niter=4, stride=2)
    assert reads.tolist() == [7, 7, 6] and int(reads.sum()) == 5 * 4


def test_rowfix_plain_matches_pallas():
    build, per_iter = jax_anchor().build_subfix()
    want = interpreted(build(1))
    rows = torch.full((5, ar.ROWS), 0.05)
    index = ar.rowfix_index(rows)
    anchor = ar.Anchor()
    got = anchor.rowfix(rows, index, 1)
    assert per_iter == 16 and got.shape == want.shape == (1, ar.ROWS)
    assert bool((index.key < index.grid.ncells).all())  # memberf 0.05: members
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(want, 1.0 / np.float32(K.CFM_EPSILON), rtol=1e-6)
    assert anchor.launches == dict.fromkeys(ar.KERNELS, 0)


def test_rowfix_table_entries_are_the_range_ends():
    """The row kernel's bound counts each cell-table entry it can read once:
    both clipped ends of the nine ranges of every member row."""
    rows = torch.full((5, ar.ROWS), 0.05)
    rows[4, ::3] = 0  # non-member rows read no table entry
    dims = (14, 10, 9)  # the top rows' ranges clip at ncells
    index = ar.rowfix_index(rows, dims)
    ncells = index.grid.ncells
    ends = set()
    for lin in index.key.tolist():
        if lin >= ncells:
            continue
        for ox in (-1, 0, 1):
            for oy in (-1, 0, 1):
                base = lin + ox * dims[1] * dims[2] + oy * dims[2]
                ends |= {min(max(base - 1, 0), ncells), min(max(base + 2, 0), ncells)}
    assert ar.rowfix_table_entries(index) == len(ends)


def sass_listing(name, pair_ops, npairs):
    """A `cuobjdump -sass` listing of one kernel whose loop holds `npairs`
    copies of `pair_ops`, closed by a backward branch."""
    lines = [f"\t\tFunction : {name}", "        /*0000*/                   MOV R1, R2 ;"]
    addr = 0x10
    for _ in range(npairs):
        for op in pair_ops:
            lines.append(f"        /*{addr:04x}*/                   {op} R3, R4, R5 ;")
            addr += 0x10
    lines.append(f"        /*{addr:04x}*/              @!P0 BRA 0x10 ;")
    lines.append(f"        /*{addr + 0x10:04x}*/                   EXIT ;")
    return "\n".join(lines)


def test_sass_pair_loop_counts_fp32_per_pair():
    """The SASS parser finds the pair loop and its fp32 instructions a pair,
    the counts by which the body kernels are held to the phase kernels'."""
    pair = ["LDG.E.128.CONSTANT", "FADD", "FFMA", "FFMA", "FMNMX", "MUFU.RSQ", "FMUL"]
    text = "\n".join([sass_listing("phase_kernel", pair, 4),
                      sass_listing("body_kernel", pair[1:] + ["LDS.128"], 8),
                      sass_listing("drifted_kernel", pair + ["FMUL"], 4)])
    funcs = ar.parse_sass(text)
    assert set(funcs) == {"phase_kernel", "body_kernel", "drifted_kernel"}
    phase = ar.fp32_per_pair(ar.pair_loop(funcs["phase_kernel"]))
    assert phase == {"FFMA": 2.0, "FADD": 1.0, "FMUL": 1.0, "FMNMX": 1.0}
    assert ar.pair_loop(funcs["phase_kernel"])["LDG.E.128.CONSTANT"] == 4
    assert ar.fp32_per_pair(ar.pair_loop(funcs["body_kernel"])) == phase
    assert ar.fp32_per_pair(ar.pair_loop(funcs["drifted_kernel"])) != phase
