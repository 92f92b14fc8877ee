"""The port's window micro-benchmark (`pbf_sph_tpu_torch/tools/micro_window.py`)
against the JAX package's `tools/micro_window.py`.

The JAX tool lives in `tools/`, outside the package; it is loaded from its
file, and its Pallas kernels run in interpret mode on the CPU
(`pltpu.force_tpu_interpret_mode`) at nblocks 1, each output computed once
(prod ~17 s, guarded ~13 s, static ~7 s, the flat bodies ~3 s each).  The
port's `MicroWindow` wrappers run their plain versions on these CPU tensors
and launch nothing.

Tolerances: plain against Pallas rtol 1e-5, atol 1e-12 (λ is ~1e-7; both
sum a (64, 128) carry chunk by chunk and then the lanes, the lane sum in
another order); plain against a float64 evaluation on random inputs, at
W 128 and W 1, rtol 1e-4 (fp32 sums of up to a few thousand terms; the
random rows keep ci far from 0, so nothing amplifies the rounding).
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pbf_sph_tpu_torch.ops.phases import PairConstants
from pbf_sph_tpu_torch.tools import anchor_rate as ar
from pbf_sph_tpu_torch.tools import micro_window as mw

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
def jax_window():
    spec = importlib.util.spec_from_file_location(
        "micro_window_reference", REPO / "tools" / "micro_window.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def pallas_lambda(body):
    """The interpreted Pallas kernel's (1, 1024) λ of `body` at nblocks 1."""
    jw = jax_window()
    build = {"prod": jw.build_prod_structure, "guarded": jw.build_guarded,
             "flat": lambda n: jw.build_flat(n, False),
             "flat_fused": lambda n: jw.build_flat(n, True),
             "static": jw.build_static_fused}[body]
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(build(1)())


def test_tables_equal_the_jax_tool():
    jw = jax_window()
    np.testing.assert_array_equal(mw.make_wins_table().numpy(), np.asarray(jw.make_wins_table()))
    np.testing.assert_array_equal(mw.make_flat_table().numpy(), np.asarray(jw.make_flat_table()))
    assert (mw.SMAX, mw.MAXC, mw.CHUNKS_CENSUS) == (jw.SMAX, jw.MAXC, jw.CHUNKS_CENSUS)


@pytest.mark.parametrize("body", mw.JAX_BODIES)
def test_plain_matches_pallas(body):
    want = pallas_lambda(body)
    win = mw.MicroWindow()
    got = win.run(body, mw.tool_inputs(), 1)
    assert got.shape == want.shape == (1, mw.ROWS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-12)
    assert win.launches == dict.fromkeys(mw.KERNELS, 0)


def test_prod_counts_its_sentinel_chunks():
    """The tool's strip is not blanked: prod's 4 sentinel chunks add pairs,
    so its λ differs from guarded's, whose 10 chunks flat and static share."""
    x = mw.tool_inputs()
    chunks = {b: [len(c) for c in mw.body_chunks(b, x)] for b in mw.BODIES}
    assert chunks["prod"] == [mw.CHUNKS_CENSUS] * mw.NSUB
    assert all(chunks[b] == [10] * mw.NSUB for b in ("guarded", "flat", "flat_fused", "static"))
    lam = {b: pallas_lambda(b) for b in ("prod", "guarded", "flat")}
    assert abs(lam["prod"][0, 0] - lam["guarded"][0, 0]) > 1e-8
    np.testing.assert_allclose(lam["flat"], lam["guarded"], rtol=1e-5)
    for body in ("prod", "guarded"):  # pbf_lambda's fused loads read the same values
        np.testing.assert_allclose(mw.run_plain(body + "_fused", x).numpy(), lam[body],
                                   rtol=1e-5, atol=1e-12)


def window_offsets(wins, guarded, width, smax):
    """The chunk offsets of each sub-block, read from the JAX tool's loops
    (`tools/micro_window.py:158-170,209-220`)."""
    w = np.asarray(wins).reshape(-1)
    out = []
    for t in range(mw.NSUB):
        offs = []
        for s in range(9):
            lo, hi = int(w[t * 18 + 2 * s]), int(w[t * 18 + 2 * s + 1])
            c0 = lo // width
            nchunk = -(-(hi - c0 * width) // width) if hi > lo else 0
            steps = range(nchunk) if guarded else [0] + list(range(1, nchunk))
            offs += [min((c0 + i) * width, smax) for i in steps]
        out.append(offs)
    return out


def offsets_f64(body, x):
    if body.split("_")[0] in ("prod", "guarded"):
        return window_offsets(x.wins, body.startswith("guarded"), x.width, x.smax)
    if body == "static":
        return [[((s * 7 + t) % 40) * x.nper * x.width + c * x.width
                 for s in range(x.nwin) for c in range(x.nper)] for t in range(mw.NSUB)]
    v = np.asarray(x.tbl).reshape(-1)
    return [list(v[t * x.stride + 1:t * x.stride + 1 + v[t * x.stride]])
            for t in range(mw.NSUB)]


def lambda_f64(body, x):
    """(1024,) λ in float64: each sub-block's rows against the W columns of
    each of its chunks, then the tool's epilogue."""
    c = PairConstants.of(mw.H)
    rows = x.rows.numpy().astype(np.float64)
    strip = x.strip.numpy().astype(np.float64)
    sums = np.zeros((4, mw.ROWS))
    for t, offs in enumerate(offsets_f64(body, x)):
        r = slice(t * 64, (t + 1) * 64)
        for o in offs:
            d = rows[:3, r, None] - strip[:3, None, o:o + x.width]
            r2 = (d * d).sum(0)
            r2c = np.maximum(r2, c.eps2)
            u = 1.0 / np.sqrt(r2c)
            sg = np.maximum(c.h - r2c * u, 0.0) ** 2 * u
            sums[0, r] += (np.maximum(c.hh - r2, 0.0) ** 3).sum(1)
            sums[1:, r] += (d * sg).sum(2)
    mass, memberf = rows[3], rows[4]
    rho = mass * sums[0] * c.p6f * memberf
    norm2 = ((sums[1:] * c.c_grad * memberf) ** 2).sum(0)
    return -(rho * c.rho_recip - 1.0) / (norm2 + c.cfm)


@pytest.mark.parametrize("width", mw.WIDTHS)
@pytest.mark.parametrize("body", mw.BODIES)
def test_plain_matches_float64(body, width):
    x = mw.random_inputs(3, width)
    got = mw.run_plain(body, x)
    want = lambda_f64(body, x)
    offs = offsets_f64(body, x)
    assert max(map(len, offs)) > 0 and len({tuple(o) for o in offs}) == mw.NSUB  # all differ
    np.testing.assert_allclose(got.numpy()[0], want, rtol=1e-4)


@pytest.mark.parametrize("k, m", [(9, 19), (7, 19), (0, 5)])
def test_census_tables(k, m):
    """k windows of m candidates a sub-block at W 1, the rest empty at smax:
    guarded, flat and static read the same k*m candidates, prod one
    sentinel candidate more for each empty window; the fused bodies read
    what their split ones read."""
    x = mw.census_inputs(k, m)
    guarded = mw.body_chunks("guarded", x)
    assert x.stride == k * m + 1 and x.tbl.numel() == mw.NSUB * (k * m + 1)
    for t, offs in enumerate(guarded):
        assert len(offs) == len(set(offs)) == k * m
        assert all(0 <= o < mw.SMAX for o in offs)
        assert mw.body_chunks("flat", x)[t] == offs
        assert sorted(mw.body_chunks("static", x)[t]) == sorted(offs)
        assert mw.body_chunks("prod", x)[t] == offs + [mw.SMAX] * (9 - k)
    assert mw.body_pairs("prod", x) == 64 * mw.NSUB * (k * m + 9 - k)
    for body in ("prod", "guarded", "flat"):
        assert mw.body_chunks(body + "_fused", x) == mw.body_chunks(body, x)
    assert mw.body_pairs("guarded", x) == mw.body_pairs("static", x) == 64 * mw.NSUB * k * m
    with pytest.raises(ValueError, match="census"):
        mw.census_tables(k, 300)


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


def test_sass_check_holds_each_body_to_pbf_lambda():
    """Every body's pair loop must hold pbf_lambda's fp32 opcodes a pair and
    its candidate bytes; a drifted or short body fails the check."""
    math = ["FADD", "FFMA", "FFMA", "FMNMX", "MUFU.RSQ", "FMUL"]
    loads = {"split": ["LDG.E.CONSTANT"] * 3, "fused": ["LDG.E.128.CONSTANT"]}
    listings = [sass_listing("_Z13lambda_kernelEPK6float4ii", math + loads["fused"], 4)]
    for body in mw.BODIES:
        for width in mw.WIDTHS:
            ops = math + loads["fused" if body in mw.FUSED else "split"]
            if body.startswith("flat") and width == 1:
                ops = ops + ["LDG.E.CONSTANT"]  # the offset of each candidate
            if (body, width) == ("guarded", 1):
                ops = ops + ["FMUL"]  # drifted from pbf_lambda's loop
            if (body, width) == ("static", 128):
                ops = ops[:-1]  # the candidate load hoisted out of the loop
            listings.append(sass_listing(f"_ZN12_GLOBAL__N_1{mw.sass_pattern(body, width)}v",
                                         ops, 8))
    report = mw.check_funcs(ar.parse_sass("\n".join(listings)))
    assert set(report) == {f"{b} W{w}" for b in mw.BODIES for w in mw.WIDTHS}
    assert {k for k, r in report.items() if not r["ok"]} == {"guarded W1", "static W128"}
    assert report["flat W1"]["load_bytes_per_pair"] == 16
    assert report["flat_fused W128"]["load_bytes_per_pair"] == 16
    assert report["prod W128"]["load_bytes_per_pair"] == 12
