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
import re
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


# ---------------------------------------------------------------------------
# The blocked kernel (rows 7.1-b to 7.4-b): its plain versions, launchers,
# constants, cases and SASS check
# ---------------------------------------------------------------------------


def cpu_cases(width):
    """`parity_cases` but the long windows: the tool's or census inputs,
    random ones, and at W 1 every window empty."""
    return {k: x for k, x in mw.parity_cases(width, "cpu").items() if k != "long"}


def original_plain(body, x):
    """The plain version of `body`'s original, called with its own
    arguments."""
    fused = body in mw.FUSED
    cand = x.pack if fused else x.strip
    if body in mw.WINDOW_BODIES:
        plain = mw.guarded_plain if body.startswith("guarded") else mw.prod_plain
        return plain(x.wins, x.rows, cand, 1, x.width, x.smax, fused)
    if body in mw.FLAT_BODIES:
        return mw.flat_plain(x.tbl, x.rows, cand, 1, fused, x.width, x.stride)
    return mw.static_plain(x.rows, x.pack, 1, x.nwin, x.nper, x.width)


@pytest.mark.parametrize("width", mw.WIDTHS)
@pytest.mark.parametrize("body", mw.BLOCKED_BODIES)
def test_blocked_bodies_are_the_plain_versions_on_cpu(body, width):
    """On CPU tensors a blocked body returns its original's plain version
    (`prod_plain`, `guarded_plain`, `flat_plain`, `static_plain`) exactly,
    split or fused, and launches nothing; flat and static also on the long
    case (their lists of several stage rounds, an empty flat list)."""
    win = mw.MicroWindow()
    cases = (cpu_cases(width) if body in mw.WINDOW_BODIES
             else mw.parity_cases(width, "cpu"))
    for case, x in cases.items():
        got = win.run(body, x, 1)
        assert got.shape == (1, mw.ROWS) and torch.equal(got, original_plain(body, x)), case
        assert torch.equal(got, mw.run_plain(mw.BLOCKED_OF[body], x)), case
    assert win.launches == dict.fromkeys(mw.KERNELS, 0)


def test_blocked_launchers_refuse_cpu_tensors():
    for width in mw.WIDTHS:
        x = mw.random_inputs(0, width)
        for body in mw.BLOCKED_BODIES:
            with pytest.raises(ValueError, match="CUDA tensors"):
                mw.run_kernel(body, x, 1)
            with pytest.raises(ValueError, match="CUDA tensors"):
                mw.window_blocks(body, x, 2)
        with pytest.raises(ValueError, match="CUDA tensors"):
            mw.prod_blocked_kernel(x.wins, x.rows, x.strip, 1, width)
        with pytest.raises(ValueError, match="CUDA tensors"):
            mw.guarded_blocked_kernel(x.wins, x.rows, x.pack, 1, width, fused=True)
        with pytest.raises(ValueError, match="CUDA tensors"):
            mw.flat_blocked_kernel(x.tbl, x.rows, x.strip, 1, False, width, x.stride)
        with pytest.raises(ValueError, match="CUDA tensors"):
            mw.static_blocked_kernel(x.rows, x.pack, 1, x.nwin, x.nper, width)
    with pytest.raises(ValueError, match="is not one of"):
        mw.window_blocks("pbf_lambda", mw.tool_inputs(), 1)


def test_launcher_signatures_are_the_cu_ones():
    """Every launcher of csrc/micro_window.cu has a ctypes signature in
    `cuda_build.SIGNATURES` with its own argument types, and every kernel
    the tool names has a launcher."""
    from pbf_sph_tpu_torch.ops import cuda_build

    src = (REPO / "pbf_sph_tpu_torch" / "csrc" / "micro_window.cu").read_text()
    block = src[src.index('extern "C" {'):]
    kinds = {"const void*": cuda_build._P, "void*": cuda_build._P, "int": cuda_build._I,
             "float": cuda_build._F}
    found = {}
    for name, args in re.findall(r"^int (\w+)\(([^)]*)\)", block, re.M):
        found[name] = [kinds[" ".join(a.split()[:-1])] for a in args.split(",")]
    assert set(found) == set(mw.KERNELS)
    for name, argtypes in found.items():
        assert cuda_build.SIGNATURES[name] == argtypes, name


def test_blocked_constants_are_the_cu_ones():
    """R (kBlockedRows) and the stage buffer (kStage) that the tool and its
    checks take are the .cu's: R from 2 on, dividing a sub-block and a trip
    of 16 pairs; the stage whole chunks at W 128."""
    src = (REPO / "pbf_sph_tpu_torch" / "csrc" / "micro_window.cu").read_text()
    rows = re.search(r"constexpr int kBlockedRows = (\d+);", src)
    stage = re.search(r"constexpr int kStage = (\d+);", src)
    assert rows is not None and int(rows.group(1)) == mw.BLOCKED_ROWS >= 2
    assert stage is not None and int(stage.group(1)) == mw.BLOCKED_STAGE
    assert mw.SUB % mw.BLOCKED_ROWS == 0 and 16 % mw.BLOCKED_ROWS == 0
    assert mw.BLOCKED_STAGE % mw.WCOL == 0


@pytest.mark.parametrize("width", mw.WIDTHS)
def test_parity_cases_reach_the_blocked_edges(width):
    """The cases the card holds the blocked kernels to: an empty window, a
    ragged hi (off a chunk's end), a window clipped at smax, and chunk lists
    of more than two stage rounds, windows, flat lists (in a table of their
    own stride) and static offsets, with an empty flat list beside them; at
    W 1 also every window of every sub-block empty; the tool's, census and
    random flat and static cases as before."""
    cases = mw.parity_cases(width, "cpu")
    wins = np.asarray(cases["random"].wins).reshape(-1)[:mw.NSUB * mw.WIN_STRIDE]
    lo, hi = wins[0::2], wins[1::2]
    assert (lo == hi).any() and (hi > mw.SMAX).any()
    assert ((hi > lo) & (hi % width != 0)).any() if width > 1 else (hi - lo > 1).any()
    stage_chunks = mw.BLOCKED_STAGE // width
    for body in ("prod", "guarded", "flat", "static"):
        long_chunks = [len(c) for c in mw.body_chunks(body, cases["long"])]
        assert max(long_chunks) > 2 * stage_chunks, (body, long_chunks)
    long_flat = [len(c) for c in mw.body_chunks("flat", cases["long"])]
    assert long_flat[:2] == [0, mw.LONG_FLAT[width]]
    assert cases["long"].stride == mw.LONG_FLAT[width] + 1 != cases["random"].stride
    assert (cases["long"].nwin, cases["long"].nper) == mw.LONG_STATIC[width]
    mw.static_plain(cases["long"].rows, cases["long"].pack, 1, *mw.LONG_STATIC[width],
                    width=width)  # in range: 40 x nper x W within the pack
    assert (cases["random"].stride, cases["random"].nwin, cases["random"].nper) == (
        mw.MAXC + 1, *((4, 1) if width > 1 else (7, 5)))
    if width == 1:
        assert mw.body_pairs("guarded", cases["empty"]) == 0
        assert mw.body_chunks("prod", cases["empty"]) == [[mw.SMAX] * 9] * mw.NSUB
        assert mw.body_pairs("flat", cases["empty"]) == mw.body_pairs("static",
                                                                      cases["empty"]) == 0


MATH = ["FADD", "FFMA", "FFMA", "FMNMX", "MUFU.RSQ", "FMUL"]


# the flat W 1 instances, whose original loads an offset a pair
FLAT_W1 = {"flat_blocked W1", "flat_blocked_fused W1"}


def blocked_listing(pairs_a_read, extra=(), only=None):
    """A listing with pbf_lambda's kernel (one LDG.128 a pair) and every
    blocked instantiation, whose loop holds 16 / pairs_a_read reads
    (LDS.128), each followed by `pairs_a_read` copies of the pair and
    `extra` (only in the instances named in `only`, if given)."""
    listings = [sass_listing("_Z13lambda_kernelEPK6float4ii", MATH + ["LDG.E.128.CONSTANT"], 4)]
    for body in mw.BLOCKED_BODIES:
        for width in mw.WIDTHS:
            more = list(extra) if only is None or f"{body} W{width}" in only else []
            listings.append(sass_listing(
                f"_ZN12_GLOBAL__N_1{mw.sass_pattern(body, width)}EEvT0_PKfS4_PK6float4"
                "iifffffffPf", ["LDS.128"] + MATH * pairs_a_read + more, 16 // pairs_a_read))
    return ar.parse_sass("\n".join(listings))


@pytest.mark.parametrize("case, ok", [
    ("R pairs a read", True),
    ("1 pair a read", False),
    ("an fp32 op more", False),
    ("a global load in the loop", False),
    ("local memory", False),
    ("the flat list's load in the loop", False),
])
def test_sass_blocked_check(case, ok):
    """The blocked kernels' SASS case: R MUFU.RSQ a LDS.128 and pbf_lambda's
    fp32 opcodes a pair pass; one pair a read, a drifted pair, a global load
    in the pair loop (in every instance, or only flat's offset load at W 1,
    left in the pair loop) and a local-memory access (a spill) fail."""
    r = mw.BLOCKED_ROWS
    ldg = ["LDG.E.CONSTANT"]
    funcs = {"R pairs a read": lambda: blocked_listing(r),
             "1 pair a read": lambda: blocked_listing(1),
             "an fp32 op more": lambda: blocked_listing(r, ["FMUL"] * r),
             "a global load in the loop": lambda: blocked_listing(r, ldg),
             "local memory": lambda: blocked_listing(r, ["STL"]),
             "the flat list's load in the loop": lambda: blocked_listing(r, ldg, FLAT_W1)}[case]()
    report = mw.check_blocked(funcs)
    assert set(report) == {f"{b} W{w}" for b in mw.BLOCKED_BODIES for w in mw.WIDTHS}
    hit = FLAT_W1 if case == "the flat list's load in the loop" else set(report)
    for name, rep in report.items():
        assert rep["ok"] is (ok if name in hit else True), (name, rep)
        assert rep["pairs_a_loop"] == 16 and rep["rows"] == r
        assert rep["same_as_phase"] is (case != "an fp32 op more")
        assert (rep["ldg_in_loop"] > 0) is ("load in the loop" in case and name in hit)
        assert (rep["local"] > 0) is (case == "local memory")


@pytest.mark.parametrize("ladder", list(mw.LADDERS))
def test_ladders_step_through_named_bodies(ladder):
    """Every ladder's steps are bodies the tool runs, then `pbf_lambda`;
    the blocked JAX-order ladder is the JAX-order one with every rung
    blocked."""
    steps = [name for name, _ in mw.LADDERS[ladder]]
    assert steps[-1] == "pbf_lambda" and set(steps[:-1]) <= set(mw.ALL_BODIES)
    assert len(set(steps)) == len(steps)
    if ladder == "blocked_jax_ladder":
        jax = [name for name, _ in mw.LADDERS["ladder"]][:-1]
        assert [mw.BLOCKED_OF[b] for b in steps[:-1]] == jax
        assert set(steps[:-1]) <= set(mw.BLOCKED_BODIES)


def test_sass_diff_finds_what_a_refactor_moved():
    """sass_diff on recorded listings: the same loop under another name and
    other constant-bank operands is the same loop; an instruction more in
    the loop or before it shows as unmatched and in the opcode deltas."""
    from pbf_sph_tpu_torch.tools import sass_diff as sd

    def listing(name, before, loop):
        lines = [f"\t\tFunction : {name}"]
        for i, op in enumerate(before + loop):
            lines.append(f"        /*{0x10 * i:04x}*/                   {op} ;")
        n = len(before) + len(loop)
        lines.append(f"        /*{0x10 * n:04x}*/              @!P0 BRA 0x{0x10 * len(before):x} ;")
        lines.append(f"        /*{0x10 * (n + 1):04x}*/                   EXIT ;")
        return "\n".join(lines)

    loop = ["LDS.128 R4, [R2]", "FADD R3, R4, -R8", "MUFU.RSQ R5, R3"]
    a = sd.parse(listing("_Z3oldv", ["MOV R1, c[0x0][0x28]", "S2R R0, SR_TID.X"], loop))
    b = sd.parse(listing("_Z3newv", ["MOV R1, c[0x0][0x30]", "S2R R0, SR_TID.X"], loop))
    c = sd.parse(listing("_Z3newv", ["MOV R1, c[0x0][0x30]"], loop + ["FMUL R3, R3, R3"]))
    same = sd.compare(sd.one(a, "3old"), sd.one(b, "3new"))
    assert same == dict(insts=[7, 7], same_opcodes=True, loops=[1, 1], same_loops=1,
                        unmatched=[0, 0], more_in_a={}, more_in_b={})
    moved = sd.compare(sd.one(a, "3old"), sd.one(c, "3new"))
    assert moved["loops"] == [1, 1] and moved["same_loops"] == 0
    # the S2R, the FMUL and the loop's branch, whose target moved
    assert moved["unmatched"] == [2, 2] and not moved["same_opcodes"]
    assert moved["more_in_a"] == {"S2R": 1} and moved["more_in_b"] == {"FMUL": 1}

