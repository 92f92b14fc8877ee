"""The port's compaction building blocks (`pbf_sph_tpu_torch/tools/micro_roll.py`)
against the JAX package's `tools/micro_roll.py` and three probes of
`tools/micro_vpu.py`.

The JAX tools live in `tools/`, outside the package, and are loaded from
their files; only the loaded module objects change.  micro_roll's source
runs with its one `REP = 512` line set to REP = 2 (REP is a local of `main`,
so no module attribute reaches it) and N = 150 on the module (three laps of
the 64-entry shift table), and its `timed` replaced: it keeps each jitted
kernel's output on the tool's own inputs and runs the same kernel on seeded
inputs of the same shapes.  micro_vpu's kernels are closures of its `main`,
so its `pl` is replaced by a proxy whose `pallas_call` keeps each call, and
`bench_streams` and `timed` are stubbed (the arithmetic and MXU probes are
other rows); the test reruns each kept call on seeded inputs.  Every Pallas
kernel runs in interpret mode on the CPU (`pltpu.force_tpu_interpret_mode`),
~12 s in all, cached.  The port's `MicroRoll` wrappers run their plain
versions on these CPU tensors and launch nothing.

Tolerances: a)-e) and rows 7.13-7.15 bit for bit, NaN in the same places
(rolls, selects and copies; the part output starts as NaN, as the
interpreter leaves it).  f) rtol 1e-5, atol 1e-7 x max|value| against the
interpreted kernel (torch and XLA sum the 128 columns in other orders: 2.9e-6
at most on the tool's inputs, where |value| is 7.6, and 8.9e-8 on the seeded
ones), and within 1e-5 x the sum of |term| of a float64 evaluation.
"""

import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pbf_sph_tpu_torch.tools import anchor_rate as ar
from pbf_sph_tpu_torch.tools import micro_roll as mr

REPO = Path(__file__).resolve().parent.parent
TEST_REP, TEST_N = 2, 150
SEED = 7
LAM_ATOL_SHARE = 1e-7
LABELS = ("a", "b", "c", "d", "e", "f")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the tier runs several test
    processes at once, and torch's default pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_tool(name: str, source=None):
    path = REPO / "tools" / f"{name}.py"
    if source is None:
        spec = importlib.util.spec_from_file_location(f"{name}_reference", path)
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        return tool
    tool = types.ModuleType(f"{name}_reference")
    tool.__file__ = str(path)
    exec(compile(source, str(path), "exec"), tool.__dict__)
    return tool


def seeded_roll_args():
    """The seeded inputs of each micro_roll kernel, in the tool's order."""
    xl = mr.random_lanes_inputs(SEED)
    xp = mr.random_part_inputs(SEED)
    xf = mr.random_lam_inputs(SEED)
    parts = (xp.strips.numpy(), xp.meta.numpy())
    return [(xl.x.numpy(), xl.shifts.numpy()), (xl.x.numpy(),), parts, parts, parts,
            (xf.rows.numpy(), xf.cands.numpy())]


def rerun(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args))


@functools.lru_cache(maxsize=None)
def roll_outputs():
    """label -> (tool-input args, output on them, output on the seeded
    inputs, the jitted kernel) of the interpreted micro_roll kernels a..f."""
    source = (REPO / "tools" / "micro_roll.py").read_text()
    assert source.count("    REP = 512\n") == 1
    tool = load_tool("micro_roll", source.replace("    REP = 512\n", f"    REP = {TEST_REP}\n"))
    tool.N = TEST_N
    seeded = seeded_roll_args()
    kept = []

    def keep(fn, *args, reps=5):
        on_seeded = np.asarray(fn(*seeded[len(kept)]))
        kept.append(([np.asarray(a) for a in args], np.asarray(fn(*args)), on_seeded,
                      functools.partial(rerun, fn)))
        return 1.0

    tool.timed = keep
    with pltpu.force_tpu_interpret_mode():
        tool.main()
    assert len(kept) == len(LABELS)
    return dict(zip(LABELS, kept))


@functools.lru_cache(maxsize=None)
def vpu_calls():
    """kernel name -> (the kept pallas_call, jitted) of micro_vpu's rot,
    unal and dma probes, with the tool's own verdicts printed by its main."""
    import jax
    from jax.experimental import pallas as real_pl

    tool = load_tool("micro_vpu")
    kept = {}

    class PallasProxy:
        def __getattr__(self, name):
            return getattr(real_pl, name)

        def pallas_call(self, kernel, **kwargs):
            call = real_pl.pallas_call(kernel, **kwargs)
            kept[kernel.__name__] = call
            return call

    tool.pl = PallasProxy()
    tool.bench_streams = lambda nstreams, op: (1.0, 1.0)
    tool.timed = lambda fn, *args, reps=20: 1.0
    with pltpu.force_tpu_interpret_mode():
        tool.main()
    assert {"rot_kernel", "unal_kernel", "dma_kernel"} <= set(kept)
    return {name: jax.jit(kept[name]) for name in ("rot_kernel", "unal_kernel", "dma_kernel")}


def run_vpu(name, x, s):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(vpu_calls()[name](np.asarray(x), np.asarray([s], np.int32)))


def assert_bits(got, want):
    _, same = mr.bit_equal(torch.tensor(np.asarray(got)), torch.tensor(np.asarray(want)))
    assert same, (got, want)


def test_tool_inputs_are_the_tools():
    out = roll_outputs()
    xl, xp, xf = mr.lanes_inputs(), mr.part_inputs(), mr.lam_inputs()
    np.testing.assert_array_equal(out["a"][0][0], xl.x.numpy())
    np.testing.assert_array_equal(out["a"][0][1], xl.shifts.numpy())
    np.testing.assert_array_equal(out["b"][0][0], xl.x.numpy())
    for label in "cde":
        np.testing.assert_array_equal(out[label][0][0], xp.strips.numpy())
        np.testing.assert_array_equal(out[label][0][1], xp.meta.numpy())
    np.testing.assert_array_equal(out["f"][0][0], xf.rows.numpy())
    np.testing.assert_array_equal(out["f"][0][1], xf.cands.numpy())


@pytest.mark.parametrize("case", ["tool", "seeded"])
@pytest.mark.parametrize("label", mr.LANES)
def test_lanes_match_pallas(label, case):
    _, on_tool, on_seeded, _ = roll_outputs()[label]
    x = mr.lanes_inputs() if case == "tool" else mr.random_lanes_inputs(SEED)
    wrappers = mr.MicroRoll()
    got = wrappers.lanes(label, x, TEST_N, ncopies=2)
    assert got.shape == (2, mr.ROWS, mr.W)
    for copy in got:
        assert_bits(copy, on_tool if case == "tool" else on_seeded)
    assert wrappers.launches == dict.fromkeys(mr.KERNELS, 0)


def test_lanes_make_minus_zero_plus_zero():
    """On an x of -0.0 the port's + 0.0 of every trip makes +0.0 (IEEE, as
    nvcc keeps it), so its sum is +0.0, and with no trip -0.0.  The
    interpreted Pallas kernel keeps -0.0: XLA's CPU compile folds x + 0.0
    away.  The two agree as values, not in the sign of a zero sum; every
    other input gives the same bits (the tests above)."""
    x = mr.LanesInputs(torch.full((mr.ROWS, mr.W), -0.0), mr.lanes_inputs().shifts)
    port = mr.lanes_plain("b", x, TEST_N)[0].numpy()
    assert not np.signbit(port).any() and not port.any()
    assert np.signbit(mr.lanes_plain("b", x, 0).numpy()).all()
    pallas = roll_outputs()["b"][3](x.x.numpy())
    assert np.signbit(pallas).all() and np.array_equal(pallas, port)
    assert mr.bit_equal(torch.tensor([-0.0]), torch.tensor([0.0])) == (0.0, False)


@pytest.mark.parametrize("case", ["tool", "seeded"])
@pytest.mark.parametrize("label", mr.PARTS)
def test_parts_match_pallas(label, case):
    """Both part wrappers, the original's and the blocked one's, take
    part_plain on CPU tensors and launch nothing."""
    _, on_tool, on_seeded, _ = roll_outputs()[label]
    x = mr.part_inputs() if case == "tool" else mr.random_part_inputs(SEED)
    wrappers = mr.MicroRoll()
    for run in (wrappers.part, wrappers.part_blocked):
        for body in mr.PART_BODIES:
            got = run(label, body, x, nrep=2, npass=2)
            assert got.shape == (2, mr.FIELDS, mr.OUT_COLS)
            for copy in got:
                assert_bits(copy, on_tool if case == "tool" else on_seeded)
    assert wrappers.launches == dict.fromkeys(mr.KERNELS, 0)


def blocked_mirror(label, x, npass):
    """(4, 512) as the blocked kernel decomposes it, and the chunks some
    part writes: each (field, chunk) alone, its 128 columns taken once
    from the NaN-filled output, the structure's parts walked in order, those
    of other chunks skipped, each merged by a select of the unaligned window
    AB[r .. r + 128), and put back once after the last pass."""
    strips, meta = x.strips.numpy(), x.meta.numpy()
    w = mr.W
    out = np.full((mr.FIELDS, mr.OUT_COLS), np.nan, np.float32)
    written = set()
    for f in range(mr.FIELDS):
        for c in range(mr.OUT_COLS // w):
            v = out[f, c * w:(c + 1) * w].copy()
            cols = c * w + np.arange(w)
            for _ in range(npass):
                for p in mr.part_order(label):
                    s0, dst, ln = (int(a) for a in meta[p])
                    if dst // w != c:
                        continue
                    written.add(c)
                    r = s0 % w
                    ba = s0 - r
                    bb = min(ba + w, mr.SM - w)
                    ab = np.concatenate([strips[f, ba:ba + w], strips[f, bb:bb + w]])
                    v = np.where((cols >= dst) & (cols < dst + ln), ab[r:r + w], v)
            out[f, c * w:(c + 1) * w] = v
    return out, sorted(written)


@pytest.mark.parametrize("case", ["tool", 0, 1, 2, 3, 4])
@pytest.mark.parametrize("label", mr.PARTS)
def test_blocked_decomposition_is_part_plain(label, case):
    """The (field, chunk) pieces of a copy are independent: walked alone,
    each skipping the other chunks' parts, they give part_plain bit for bit,
    NaN in place, on the tool's meta and on random_meta's seeds (the bb
    clamp, chunk crossings, overlaps in both orders, an empty part, chunk
    3's last writer); the chunks written are `part_chunks`, the blocked
    kernel's CTAs."""
    x = mr.part_inputs() if case == "tool" else mr.random_part_inputs(case)
    got, written = blocked_mirror(label, x, 2)
    assert_bits(got, mr.part_plain(label, x, 1, 2)[0])
    assert written == mr.part_chunks(label, x.meta)
    assert np.isnan(got).any() and not np.isnan(got).all()


def test_blocked_window_index_arithmetic():
    """The blocked kernel's two window reads, in numpy on every s0 of the
    strip, lane l holding columns j = l + 32k, give `rolled_window`'s
    AB[r .. r + 128): direct's one index ba + ((r + j) & mask), mask 127
    where the clamp makes B = A, else 255; shuffle's roll of the 8 aligned
    slots (A[t + 32i], B[t + 32i] on lane t), sender t = (l + r) mod 32
    sending slot k + (r >> 5) + [t < r mod 32]."""
    w = mr.W
    strip = torch.arange(mr.SM, dtype=torch.float32).expand(mr.FIELDS, -1)
    s0 = np.arange(mr.SM)[:, None, None]
    lane, k = np.arange(32)[None, :, None], np.arange(4)[None, None, :]
    r = s0 % w
    ba = s0 - r
    bb = np.minimum(ba + w, mr.SM - w)
    want = np.stack([mr.rolled_window(strip, int(s))[0].numpy() for s in s0.ravel()])
    want = want.reshape(mr.SM, 4, 32).transpose(0, 2, 1)      # [s0, l, k] = column l + 32k
    mask = np.where(ba == mr.SM - w, w - 1, 2 * w - 1)
    np.testing.assert_array_equal(ba + ((r + lane + 32 * k) & mask), want)
    rq, rr = r >> 5, r & 31
    t = (lane + rr) & 31
    slot = k + rq + (t < rr)
    assert slot.max() == 7
    np.testing.assert_array_equal(np.where(slot < 4, ba + t + 32 * slot, bb + t + 32 * (slot - 4)),
                                  want)


def test_tool_meta_writes_three_chunks():
    """dst = 97p mod 384: parts 0, 1, 4, 5, 8, 9, 12, 13 in chunk 0, 2, 6,
    10, 14 in chunk 1, 3, 7, 11, 15 in chunk 2, none in chunk 3, so the
    blocked kernel runs 3 CTAs of 4 warps a copy; e)'s parts 0-9 reach the
    same three."""
    meta = mr.tool_meta()
    chunks = {c: [p for p in range(mr.NPART) if meta[p, 1] // mr.W == c] for c in range(4)}
    assert chunks == {0: [0, 1, 4, 5, 8, 9, 12, 13], 1: [2, 6, 10, 14], 2: [3, 7, 11, 15], 3: []}
    for label in mr.PARTS:
        assert mr.part_chunks(label, torch.from_numpy(meta)) == [0, 1, 2]
    one = meta.copy()
    one[:, 1] = 3 * mr.W + 5
    assert mr.part_chunks("e", torch.from_numpy(one)) == [3]


def test_e_differs_from_c_and_c_equals_d():
    """e) runs parts 0, 1, 1, 2, ..., 8, 9 and never 10-15, so it leaves
    other columns than c); c) and d) run the same parts in the same order."""
    out = roll_outputs()
    for case in (1, 2):
        c, d, e = (out[label][case] for label in "cde")
        assert_bits(c, d)
        assert not mr.bit_equal(torch.tensor(c), torch.tensor(e))[1]
    assert mr.part_order("e") == [0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9]
    assert mr.part_order("c") == mr.part_order("d") == list(range(16))


@pytest.mark.parametrize("case", ["tool", "seeded"])
@pytest.mark.parametrize("label", mr.PARTS)
def test_nan_columns_are_the_unwritten_ones(label, case):
    """A column is NaN exactly where no part of the structure writes it."""
    x = mr.part_inputs() if case == "tool" else mr.random_part_inputs(SEED)
    pallas = roll_outputs()[label][1 if case == "tool" else 2]
    written = np.zeros(mr.OUT_COLS, bool)
    meta = x.meta.numpy()
    for p in mr.part_order(label):
        c, valid = mr.valid_columns(int(meta[p, 1]), int(meta[p, 2]))
        written[c * 128:(c + 1) * 128] |= valid
    assert 0 < written.sum() < mr.OUT_COLS
    np.testing.assert_array_equal(np.isnan(pallas), np.broadcast_to(~written, pallas.shape))
    assert (~written).sum() * 4 == np.isnan(mr.part_plain(label, x)[0].numpy()).sum()


def own_columns(meta, p, order):
    """(chunk, mask) of the columns part p writes as the last writer of the
    order."""
    c, mine = mr.valid_columns(int(meta[p, 1]), int(meta[p, 2]))
    for q in order[order.index(p) + 1:]:
        cq, vq = mr.valid_columns(int(meta[q, 1]), int(meta[q, 2]))
        if cq == c:
            mine = mine & ~vq
    return c, mine


def test_tool_meta_never_clamps_and_seeded_meta_does():
    """Where ba + 128 > SM - 128 the clamp makes B = A, so `rolled` wraps
    inside the last window: an unclamped read (here from a strip padded
    past SM) differs.  The tool's meta (s0 < SM - 256) never gets there,
    the seeded meta does (parts 0-2 and 15), and the interpreted kernel holds
    the clamped window where such a part is the last writer (part 15 on the
    wrapped lanes)."""
    def clamps(meta):
        s0 = meta[:, 0]
        return (s0 - s0 % 128 + 128 > mr.SM - 128) & (s0 % 128 > 0)

    assert not clamps(mr.tool_meta()).any()
    x = mr.random_part_inputs(SEED)
    meta = x.meta.numpy()
    hit = np.flatnonzero(clamps(meta))
    assert set(hit) >= {0, 1, 2, 15}
    padded = torch.cat([x.strips, x.strips[:, :128] + 1000.0], 1)
    pallas = roll_outputs()["c"][2]
    held = 0
    for p in hit:
        s0 = int(meta[p, 0])
        r, ba = s0 % 128, s0 - s0 % 128
        rolled = mr.rolled_window(x.strips, s0)
        np.testing.assert_array_equal(rolled[:, :128 - r], x.strips[:, s0:s0 + 128 - r])
        np.testing.assert_array_equal(rolled[:, 128 - r:], x.strips[:, ba:ba + r])
        unclamped = padded[:, s0:s0 + 128]
        assert not torch.equal(rolled[:, 128 - r:], unclamped[:, 128 - r:])
        c, own = own_columns(meta, p, mr.part_order("c"))
        np.testing.assert_array_equal(pallas[:, c * 128:(c + 1) * 128][:, own],
                                      rolled.numpy()[:, own])
        held += int(own[128 - r:].sum())   # wrapped lanes the kernel kept
    assert held > 0


def test_seeded_meta_crosses_chunks_and_overlaps():
    """Parts 4-7 run past their chunk's end and lose the tail; parts 8/9 and
    10/11 overlap in one chunk, and the later one's values stand where both
    write."""
    x = mr.random_part_inputs(SEED)
    meta = x.meta.numpy()
    order = mr.part_order("c")
    for p in range(4, 8):
        dst, ln = int(meta[p, 1]), int(meta[p, 2])
        _, valid = mr.valid_columns(dst, ln)
        assert dst % 128 + ln > 128 and valid.sum() == 128 - dst % 128 < ln
    pallas = roll_outputs()["c"][2]
    for first, second in ((8, 9), (10, 11)):
        c1, v1 = mr.valid_columns(int(meta[first, 1]), int(meta[first, 2]))
        c2, own = own_columns(meta, second, order)
        both = v1 & own
        assert c1 == c2 and both.any()
        want = mr.rolled_window(x.strips, int(meta[second, 0])).numpy()[:, both]
        np.testing.assert_array_equal(pallas[:, c1 * 128:(c1 + 1) * 128][:, both], want)
        assert not np.array_equal(
            want, mr.rolled_window(x.strips, int(meta[first, 0])).numpy()[:, both])


@pytest.mark.parametrize("case", ["tool", "seeded"])
def test_lam_matches_pallas(case):
    _, on_tool, on_seeded, _ = roll_outputs()["f"]
    want = on_tool if case == "tool" else on_seeded
    x = mr.lam_inputs() if case == "tool" else mr.random_lam_inputs(SEED)
    wrappers = mr.MicroRoll()
    got = wrappers.lam(x, nrep=2, npass=TEST_REP)
    assert got.shape == (2, mr.LAM_ROWS, 1)
    for copy in got.numpy():
        np.testing.assert_allclose(copy, want, rtol=1e-5,
                                   atol=LAM_ATOL_SHARE * np.abs(want).max())
    assert np.abs(want).max() > 1e-3
    assert wrappers.launches == dict.fromkeys(mr.KERNELS, 0)


def lam_f64(x):
    """(32,) v of f) in float64 and the sum of |term| of each."""
    a = x.rows.numpy().astype(np.float64)[:, :3, None]
    b = x.cands.numpy().astype(np.float64)[None, :3, :]
    d = a - b
    r2 = np.maximum((d * d).sum(1), mr.EPS2)
    u = 1.0 / np.sqrt(r2)
    sg = np.maximum(mr.HF - r2 * u, 0.0) ** 2 * u
    terms = np.concatenate([np.maximum(mr.HH - r2, 0.0)[:, None] ** 3, d * sg[:, None]], 1)
    return terms.sum((1, 2)), np.abs(terms).sum((1, 2))


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_lam_matches_float64(seed):
    x = mr.random_lam_inputs(seed)
    value, mag = lam_f64(x)
    got = mr.lam_plain(x, npass=3)[0, :, 0].numpy()
    assert np.all(np.abs(got - 3 * value) <= 1e-5 * 3 * mag)
    assert np.abs(value).max() > 1e-3


@pytest.mark.parametrize("shift", mr.SEEDED_SHIFTS + mr.WRAPPED_SHIFTS)
def test_rot_matches_pallas_at_every_shift(shift):
    """pltpu.roll takes every int32 shift mod 128, negative and >= 128 too;
    the port's rot takes the same."""
    x = mr.random_vpu_inputs(SEED, shift, 0)
    want = run_vpu("rot_kernel", x.tile, shift)
    assert_bits(mr.MicroRoll().rot(x.tile, x.shift), want)
    np.testing.assert_array_equal(want, np.roll(x.tile.numpy(), shift, 1))


@pytest.mark.parametrize("offset", mr.SEEDED_OFFSETS)
def test_slices_match_pallas_at_every_offset(offset):
    x = mr.random_vpu_inputs(SEED, 0, offset)
    wrappers = mr.MicroRoll()
    for kernel, method in (("unal_kernel", wrappers.unal), ("dma_kernel", wrappers.dma)):
        assert_bits(method(x.wide, offset), run_vpu(kernel, x.wide, offset))
    assert wrappers.launches == dict.fromkeys(mr.KERNELS, 0)


def test_vpu_tool_inputs_are_the_tools():
    """The probes' own inputs (s = 5, o = 37) through the kept calls."""
    x = mr.vpu_inputs()
    assert_bits(mr.rot_plain(x.tile, x.shift), run_vpu("rot_kernel", x.tile, mr.TOOL_SHIFT))
    for kernel in ("unal_kernel", "dma_kernel"):
        assert_bits(mr.slice_plain(x.wide, x.offset), run_vpu(kernel, x.wide, mr.TOOL_OFFSET))
    np.testing.assert_array_equal(mr.slice_plain(x.wide, 37)[0, :3], [37.0, 38.0, 39.0])


@pytest.mark.parametrize("offset", [-1, -37, 385, 400, 512])
def test_slices_refuse_the_offsets_pallas_refuses(offset):
    """The interpreted Pallas slice raises an out-of-bounds read outside
    [0, 384]; the plain versions and the wrappers refuse the same offsets,
    and the launchers refuse them before touching a card."""
    x = mr.vpu_inputs()
    with pytest.raises(Exception, match="Out-of-bounds|out of bounds|INTERNAL"):
        run_vpu("unal_kernel", x.wide, offset)
    for fn in (mr.slice_plain, mr.unal_kernel, mr.dma_kernel, mr.MicroRoll().unal,
               mr.MicroRoll().dma):
        with pytest.raises(ValueError, match="offset"):
            fn(x.wide, offset)
    with pytest.raises(ValueError, match="offset"):
        mr.slice_plain(x.wide, 3.0)


def test_parts_refuse_meta_outside_the_buffers():
    x = mr.part_inputs()
    for p, col, value, what in ((3, 0, mr.SM, "s0"), (5, 0, -1, "s0"), (2, 1, 512, "dst"),
                                (7, 2, -1, "len"), (9, 2, 513, "len")):
        meta = x.meta.clone()
        meta[p, col] = value
        bad = mr.PartInputs(x.strips, meta)
        for fn in (lambda: mr.part_plain("c", bad), lambda: mr.part_kernel("d", "shuffle", bad),
                   lambda: mr.part_blocked_kernel("e", "direct", bad),
                   lambda: mr.part_chunks("c", bad.meta)):
            with pytest.raises(ValueError, match=f"part {p}: {what}"):
                fn()
    with pytest.raises(ValueError, match="CPU tensor"):
        mr.part_plain("c", mr.PartInputs(x.strips, x.meta.long()))
    with pytest.raises(ValueError, match="not one of"):
        mr.part_plain("x", x)
    for run in (mr.MicroRoll().part, mr.MicroRoll().part_blocked, mr.part_blocked_kernel):
        with pytest.raises(ValueError, match="not one of"):
            run("c", "gather", x)
    for kernel in (mr.part_kernel, mr.part_blocked_kernel):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernel("c", "shuffle", x)


def test_rot_takes_every_int32_shift():
    """Nothing of int32 is refused: the plain version and pltpu.roll agree
    at the ends of the range; a shift that is not an int32 tensor is."""
    x = mr.random_vpu_inputs(SEED, 0, 0)
    for s in (2**31 - 1, -2**31):
        shift = torch.tensor([s], dtype=torch.int32)
        assert_bits(mr.rot_plain(x.tile, shift), run_vpu("rot_kernel", x.tile, s))
    with pytest.raises(ValueError, match="int32"):
        mr.rot_plain(x.tile, torch.tensor([5]))
    with pytest.raises(ValueError, match="roll body"):
        mr.lanes_plain("c", mr.lanes_inputs())


def test_passes_and_copies_repeat():
    """npass passes leave the part output as one pass does; f)'s acc adds v
    once a pass; the copies are alike."""
    x = mr.random_part_inputs(SEED)
    for label in mr.PARTS:
        assert_bits(mr.part_plain(label, x, 1, 3), mr.part_plain(label, x, 1, 1))
    xf = mr.random_lam_inputs(SEED)
    v = mr.lam_v(xf)
    np.testing.assert_array_equal(mr.lam_plain(xf, 3, 2)[2, :, 0].numpy(), (v + v).numpy())
    assert not mr.lam_plain(xf, 1, 0).any()


def test_lanes_compose_their_shifts():
    """a)'s trips roll by the table in order, so the plain version's single
    roll by the sum equals N rolls one by one."""
    x = mr.random_lanes_inputs(SEED)
    rows = x.x.clone()
    for s in mr.trip_shifts("a", x, 70):
        rows = torch.roll(rows, int(s), 1) + 0.0
    want = rows[0]
    for row in rows[1:]:
        want = want + row
    assert_bits(mr.lanes_plain("a", x, 70)[0, 0], want)


def test_bound_counts_the_functions_work():
    """a) at the tool's shifts moves lanes on 62 of each 64 trips (32 and 64
    move whole slots); b)'s 37 on every trip; a part reads its valid
    columns each pass (the tool's 16 parts: 90 columns each but
    the chunk crossings) and a copy writes the columns some part writes
    once; f) 19 fp32 + 1 MUFU a pair; at 1980 MHz on 132 SMs b) at
    8192 trips and 1 copy needs 262,144 SHFL, 1.003 us."""
    xl = mr.lanes_inputs()
    a, b = mr.lanes_work("a", xl, 128), mr.lanes_work("b", xl, 128)
    assert a["shfl"] == 8 * 4 * 2 * 62 and b["shfl"] == 8 * 4 * 128
    ms, by = mr.bound_ms(mr.lanes_work("b", xl), 1980.0, 132)
    assert by == "operations" and ms == pytest.approx(8 * 4 * 8192 / (132 * 1.98e9) * 1e3)
    xp = mr.part_inputs()
    cols = sum(int(mr.valid_columns(int(d), 90)[1].sum()) for d in xp.meta[:, 1])
    assert cols < 16 * 90
    written = np.zeros(mr.OUT_COLS, bool)
    for d in xp.meta[:, 1]:
        c, valid = mr.valid_columns(int(d), 90)
        written[c * mr.W:(c + 1) * mr.W] |= valid
    assert 0 < written.sum() <= 3 * mr.W
    assert mr.part_work("d", xp, 2, 3)["lsu"] == 2 * 4 * (3 * cols + written.sum())
    e_parts = mr.part_order("e")
    e_cols = sum(int(mr.valid_columns(int(xp.meta[p, 1]), 90)[1].sum()) for p in e_parts)
    e_written = np.zeros(mr.OUT_COLS, bool)
    for p in e_parts:
        c, valid = mr.valid_columns(int(xp.meta[p, 1]), 90)
        e_written[c * mr.W:(c + 1) * mr.W] |= valid
    assert mr.part_work("e", xp)["lsu"] == 4 * (e_cols + e_written.sum())
    w = mr.lam_work(mr.lam_inputs(), 4, 512)
    pairs = 4 * 512 * 32 * 512
    assert w["mufu"] == pairs and w["fp32"] == 19 * pairs + 4 * 512 * 32 * 4
    ms, by = mr.bound_ms(mr.slice_work(), 1980.0, 132)
    assert by == "bytes" and ms == pytest.approx(8192 / 3.35e12 * 1e3)
    assert mr.rot_work(xl.x, torch.tensor([64], dtype=torch.int32))["shfl"] == 0


# ---------------------------------------------------------------------------
# The SASS check, on synthetic listings
# ---------------------------------------------------------------------------


def sass_function(name, loops, before=(), after=()):
    """A `cuobjdump -sass` listing of one kernel: `before`, then each loop of
    `loops` closed by a backward branch, then `after` and EXIT."""
    lines = [f"\t\tFunction : {name}"]
    addr = 0

    def emit(op):
        nonlocal addr
        lines.append(f"        /*{addr:04x}*/                   {op} ;")
        addr += 0x10

    for op in before:
        emit(op)
    for loop in loops:
        top = addr
        for op in loop:
            emit(op)
        emit(f"@P0 BRA 0x{top:x}")
    for op in after:
        emit(op)
    emit("EXIT")
    return "\n".join(lines)


FP32_PAIR = ["FADD R1, R2, R3"] * 6 + ["FFMA R1, R2, R3, R4"] * 7 + \
    ["FMUL R1, R2, R3"] * 5 + ["FMNMX R1, R2, R3, !PT"] * 2 + ["FSETP.GEU.AND P0, PT, R1, R2, PT",
                                                               "FSEL R1, R2, R3, P0"]


def roll_trip(dynamic):
    rows = (["SHFL.IDX PT, R4, R5, R6, 0x1f"] * 4 + ["FSEL R1, R2, R3, P0"] * 8
            + ["FADD R1, RZ, R1"] * 4) * 8
    return (["LDS R6, [R7]"] if dynamic else []) + rows


def part(body):
    if body == "shuffle":
        field = ["LDG.E.128.CONSTANT R4, [R2.64]"] * 2 + ["SHFL.IDX PT, R4, R5, R6, 0x1f"] * 4
    else:
        field = ["LDG.E.CONSTANT R4, [R2.64]"] * 4
    return (field + ["LDG.E.128 R8, [R10.64]", "FSEL R1, R2, R3, P0",
                     "STG.E.128 [R10.64], R8"]) * 4


def visit(body):
    """A blocked kernel's visit: one part on one field, merged by select."""
    if body == "shuffle":
        loads = ["LDG.E.CONSTANT R4, [R2.64]"] * 8 + ["FSEL R1, R2, R3, P0"] * 14 \
            + ["SHFL.IDX PT, R4, R5, R6, 0x1f"] * 4
    else:
        loads = ["LDG.E.CONSTANT R4, [R2.64]"] * 4
    return ["LDC R7, c[0x0][R6+0x210]", "ISETP.NE.AND P0, PT, R7, R8, PT", "@P0 BRA 0x9990"] \
        + loads + ["FSEL R1, R2, R3, P0"] * 4


# the blocked kernels' one load of the output before the pass loop and one
# store after it
BLOCKED_EDGES = (["LDG.E R8, [R10.64]"] * 4, ["STG.E [R10.64], R8"] * 4)


def listing(**override):
    """`pbf_lambda`'s pair loop and each kernel of csrc/micro_roll.cu as the
    built library holds it, with `override` names' bodies replaced (a list
    of loops, or for the VPU kernels the whole body)."""
    prefix = "_ZN12_GLOBAL__N_1"
    funcs = [sass_function(f"{prefix}{ar.PHASE_KERNELS['lambda']}",
                           [["LDG.E.128 R4, [R2.64]"] + FP32_PAIR + ["MUFU.RSQ R6, R7"]])]
    bodies = {"a": [roll_trip(True)], "b": [roll_trip(False)],
              "f": [(["LDS.128 R4, [R5]"] + FP32_PAIR + ["MUFU.RSQ R6, R7"]) * 16
                    + ["SHFL.BFLY PT, R1, R2, R3, 0x1f", "FADD R1, R1, R2"] * 20
                    + ["FADD R1, R1, R2"] * 4]}
    edges = {}
    for label in mr.PARTS:
        for body in mr.PART_BODIES:
            bodies[f"{label} {body}"] = [part(body) * (16 if label == "c" else 1)]
            bodies[f"{label} {body} blocked"] = [visit(body) * (16 if label == "c" else 1)]
            edges[f"{label} {body} blocked"] = BLOCKED_EDGES
    for name, loops in bodies.items():
        before, after = edges.get(name, ((), ()))
        funcs.append(sass_function(f"{prefix}{mr.pattern(name)}EvPKf", override.get(name, loops),
                                   ["MOV R1, c[0x0][0x28]", *before], after))
    vpu = {"vpu_rot": ["LDG.E R4, [R2.64]"] * 32 + ["SHFL.IDX PT, R4, R5, R6, 0x1f"] * 32
           + ["STG.E [R2.64], R4"] * 32,
           "vpu_unal": ["LDG.E.CONSTANT R4, [R2.64]"] * 4 + ["STG.E [R2.64], R4"] * 4,
           "vpu_dma": ["SYNCS.EXCH.64 URZ, [UR4], UR5"] + ["LDGSTS.E [R4], desc[UR4][R2.64]"] * 4
           + ["ARRIVES.LDGSTSBAR.64 [UR4+0x1000]", "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R0], RZ",
              "LDS.128 R4, [R5]", "STG.E.128 [R2.64], R4"]}
    for name, body in vpu.items():
        funcs.append(sass_function(f"{prefix}{mr.pattern(name)}EPKf", [],
                                   override.get(name, body)))
    return "\n".join(funcs)


def test_sass_check_on_a_recorded_listing():
    report = mr.check_funcs(ar.parse_sass(listing()))
    assert mr.short(report) == [], report
    assert report["a"]["shfl_a_trip"] == 32 and report["a"]["plus_zero_kept"]
    assert report["c shuffle"]["SHFL_a_part"] == 16 and report["d direct"]["LDG.32_a_part"] == 16
    assert report["c shuffle blocked"]["SHFL_a_visit"] == 4
    assert report["c shuffle blocked"]["LDG.32_a_visit"] == 8
    assert report["d direct blocked"]["LDG.32_a_visit"] == 4
    assert all(report[f"{label} {body} blocked"]["STG.128_a_visit"] == 0
               for label in mr.PARTS for body in mr.PART_BODIES)
    assert len(report) == 18
    assert report["f"]["pairs_a_pass"] == 16 and report["f"]["fp32_per_pair"] == 22
    assert report["f"]["same_as_pbf_lambda"]


def test_sass_check_reports_a_dropped_plus_zero():
    """nvcc may drop + 0.0 only if it proves no -0.0 reaches it: the check
    says so and still passes on the shuffles."""
    trip = [op for op in roll_trip(False) if not op.startswith("FADD")]
    report = mr.check_funcs(ar.parse_sass(listing(b=[trip])))
    assert mr.short(report) == [] and not report["b"]["plus_zero_kept"]


@pytest.mark.parametrize("name, body", [
    ("a", [roll_trip(True) * 2]),                               # two trips a loop: unrolled
    ("b", [roll_trip(False)[:-20]]),                            # a roll short of its SHFLs
    ("b", [roll_trip(True)]),                                   # a static roll that reads memory
    ("c shuffle", [part("shuffle") * 15]),                      # a part folded away
    ("d direct", [part("shuffle")]),                            # direct compiled to shuffles
    ("e shuffle", [part("shuffle") * 2]),                       # the nested loop unrolled
    ("d shuffle", [part("shuffle") + ["LDL R1, [R1]"]]),        # a spill
    ("d shuffle blocked", [visit("shuffle") + ["STG.E [R10.64], R8"]]),  # the store back
    ("e direct blocked", [visit("direct") + ["LDG.E R8, [R10.64]"]]),  # the output's load back
    ("c direct blocked", [visit("direct") * 16 + ["LDL R1, [R1]"]]),  # a spill
    ("e shuffle blocked", [visit("shuffle") * 2]),              # the nested loop unrolled
    ("d direct blocked", [visit("shuffle")]),                   # direct compiled to shuffles
    ("c shuffle blocked", [visit("shuffle") * 15]),             # a part folded away
    ("f", [(["LDS.128 R4, [R5]"] + FP32_PAIR + ["MUFU.RSQ R6, R7"]) * 16
           + ["SHFL.BFLY PT, R1, R2, R3, 0x1f", "FADD R1, R1, R2"] * 20]),  # v's adds gone
    ("f", [(["LDS.128 R4, [R5]"] + FP32_PAIR[1:] + ["FFMA R1, R2, R3, R4", "MUFU.RSQ R6, R7"])
           * 16 + ["SHFL.BFLY PT, R1, R2, R3, 0x1f", "FADD R1, R1, R2"] * 20
           + ["FADD R1, R1, R2"] * 4]),                         # an FADD became an FFMA
    ("vpu_rot", ["SHFL.IDX PT, R4, R5, R6, 0x1f"] * 28),
    ("vpu_unal", ["LDG.E.128 R4, [R2.64]", "STG.E.128 [R2.64], R4"]),
    ("vpu_dma", ["LDG.E.128 R4, [R2.64]", "STG.E.128 [R2.64], R4"]),
])
def test_sass_check_catches_what_nvcc_may_do(name, body):
    report = mr.check_funcs(ar.parse_sass(listing(**{name: body})))
    assert mr.short(report) == [name], (name, report[name])
