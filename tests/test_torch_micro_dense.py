"""The port's dense-λ micro-benchmark (`pbf_sph_tpu_torch/tools/micro_dense.py`)
against the JAX package's `tools/micro_dense.py`.

The JAX tool lives in `tools/`, outside the package; it is loaded from its
file, and only the loaded module object is changed: NSUB 2, NCH 4, REP 1
and WCAP = NCH * W (computed at import, so set with them), and its `timed`
and `report` replaced: `timed` keeps each kernel's output on the tool's own
inputs and also runs the same jitted kernel on seeded inputs of the same
shapes.  `main()` runs once, its twelve Pallas kernels in interpret mode on
the CPU (`pltpu.force_tpu_interpret_mode`), ~13 s; the outputs are cached.
The port's `MicroDense` wrappers run their plain versions on these CPU
tensors and launch nothing; g)'s redesign gb (`dense_wmxu_blocked`) takes
g)'s plain version, and its column pairing (each 16 x 8 block's sg as the
A operand of one m16n8k8 reduce, A2's constant column as the r2
accumulator's starting value) is mirrored in float64 here (`gb_mirror`)
and held inside `mxu_f64`'s range.

Tolerances, plain version against the interpreted kernels:
* the FPU bodies (a, b, c, e, f, h, i, j, k, l): rtol 1e-5 and atol 1e-7 x
  max|value| (FPU_ATOL_SHARE): the four sums mix signs, and torch and XLA
  add the 128 (512, 2560) columns in other orders (9.3e-10 at most on the
  tool's inputs, whose largest |value| is 0.0071);
* d) and g): their r2 is a2*b2 + 1 - 2 a.b, terms near 1 that cancel to
  ~1e-2, which the interpreted Pallas dot rounds in fp32 where the plain
  version rounds the float64 sum once, as the card's FP64 tensor cores do;
  and their outputs ax*sum(sg) - sum(bx*sg) cancel again.  On the tool's
  inputs atol 1e-4 (MXU_ATOL; 7.4e-6 at most, largest |value| 0.215); on
  the seeded ones, built so that |a||b| ~ 1 and r2 spans h^2, atol 2e-3 x
  max|value| (MXU_SEEDED_SHARE; 5.7e-4 x max|value| = 9.2e-4 at most).
Against a float64 evaluation of the same sums on seeded inputs: the FPU
bodies within 1e-4 x |value| + 1e-5 x the sum of |term| of the value (fp32
terms and sums); d) and g) on a2*b2 + 1 - 2 a.b in float64 at rtol 1e-4,
atol 2e-3 x max|value| (1.1e-3 x max|value| at most; the interpreted Pallas
kernels sit 5.5e-4 from it too).  At the tool's full size no fixed
tolerance serves: one ulp of a2 moves d)/g) by up to 6e-3 x max|value| on
the seeded inputs, so there the tool's `mxu_f64` range (r2 moved by the
rounding of its fp32 operands, fp32 sums in any order) holds the plain
version, the interpreted Pallas kernels and, on the card, the kernels.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pbf_sph_tpu_torch.tools import anchor_rate as ar
from pbf_sph_tpu_torch.tools import micro_dense as md

REPO = Path(__file__).resolve().parent.parent
NSUB, NCH = 2, 4
SEED = 7
FPU_ATOL_SHARE = 1e-7
MXU_ATOL = 1e-4
MXU_SEEDED_SHARE = 2e-3
LABELS = list(md.BODIES)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the tier runs several test
    processes at once, and torch's default pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded():
    return md.random_inputs(SEED, NSUB, NCH)


@functools.lru_cache(maxsize=None)
def jax_outputs():
    """label -> (tool-input args, output on them, output on the seeded
    inputs) of the interpreted JAX kernels, in the tool's order a..l."""
    spec = importlib.util.spec_from_file_location(
        "micro_dense_reference", REPO / "tools" / "micro_dense.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.NSUB, tool.NCH, tool.REP = NSUB, NCH, 1
    tool.WCAP = tool.NCH * tool.W
    x = seeded()
    seeded_args = {"rows": x.rows.numpy(), "cands": x.cands.numpy(), "b2": x.b2.numpy(),
                   "nch": x.nch.numpy().reshape(1, -1), "acl": x.acl_rows.numpy()}
    kept = []

    def keep(fn, *args, reps=5):
        label = LABELS[len(kept)]
        names = {"d": ("rows", "b2"), "g": ("rows", "b2"), "k": ("rows", "cands"),
                 "l": ("acl", "cands"), "b": ("rows", "cands"), "c": ("rows", "cands"),
                 "h": ("rows", "cands")}.get(label, ("nch", "rows", "cands"))
        on_seeded = np.asarray(fn(*[seeded_args[n] for n in names]))
        kept.append(([np.asarray(a) for a in args], np.asarray(fn(*args)), on_seeded))
        return 1.0

    tool.timed = keep
    tool.report = lambda label, dt: None
    with pltpu.force_tpu_interpret_mode():
        tool.main()
    assert len(kept) == len(LABELS)
    return dict(zip(LABELS, kept))


def assert_matches_pallas(label, got, want, case):
    if label in md.MXU:
        atol = MXU_ATOL if case == "tool" else MXU_SEEDED_SHARE * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=FPU_ATOL_SHARE * max(np.abs(want).max(), 1e-30))


def test_tool_inputs_are_the_tools():
    """rows, cands, nchunk, b2s and acl_rows bit for bit as the tool draws
    and builds them."""
    out = jax_outputs()
    x = md.tool_inputs(NSUB, NCH)
    nch, rows, cands = out["a"][0]
    np.testing.assert_array_equal(rows, x.rows.numpy())
    np.testing.assert_array_equal(cands, x.cands.numpy())
    np.testing.assert_array_equal(nch.ravel(), x.nch.numpy())
    np.testing.assert_array_equal(out["d"][0][1], x.b2.numpy())
    np.testing.assert_array_equal(out["l"][0][0], x.acl_rows.numpy())


@pytest.mark.parametrize("label", LABELS)
def test_plain_matches_pallas_on_tool_inputs(label):
    _, want, _ = jax_outputs()[label]
    wrappers = md.MicroDense()
    got = wrappers.run(label, md.tool_inputs(NSUB, NCH), nrep=2)
    assert got.shape == (2, NSUB, md.SUB, 4)
    for copy in got.numpy():
        assert_matches_pallas(label, copy, want, "tool")
    if label == "l":   # the tool's acl rows sit up to 1000 away: every pair masked
        assert not want.any() and not got.any()
    assert wrappers.launches == dict.fromkeys(md.KERNELS, 0)


@pytest.mark.parametrize("label", LABELS)
def test_plain_matches_pallas_on_seeded_inputs(label):
    """Seeded inputs where every test splits; sub-block 1's trip count is
    odd, below NCH, so e), f) and j) drop chunks a) and i) keep."""
    _, _, want = jax_outputs()[label]
    x = seeded()
    assert x.nch.tolist()[0] == NCH and x.nch.tolist()[1] % 2 == 1
    got = md.MicroDense().run(label, x)[0].numpy()
    assert np.abs(got).max() > 1e-3
    assert_matches_pallas(label, got, want, "seeded")


def body_f64(label, x):
    """(nsub, 32, 4) of body `label` in float64, term by term over the
    sub-block's scheduled columns; d)/g) on the TPU tool's r2 = a2*b2 + 1 -
    2 a.b.  Returns (values, sum of |term| of each value)."""
    rows = (x.acl_rows if label == "l" else x.rows).numpy().astype(np.float64)
    cands = x.cands.numpy().astype(np.float64)
    nsub, wcap = rows.shape[0], cands.shape[1] // rows.shape[0]
    counts = x.nch.tolist()
    out, mag = np.zeros((nsub, md.SUB, 4)), np.zeros((nsub, md.SUB, 4))
    for t in range(nsub):
        lead = t - t % 2 if label in md.PAIRED else t
        sched = md.chunk_schedule("c" if label == "k" else label, counts[lead], wcap)
        cols = np.concatenate([np.arange(o, o + w) for o, w in sched] + [np.arange(0)])
        a = rows[t, :, :3].T[:, :, None]
        b = cands[:, t * wcap + cols][:, None, :]
        d = a - b
        if label in md.MXU:
            r2 = ((a * a).sum(0) * (b * b).sum(0) + 1.0 - 2.0 * (a * b).sum(0))
        else:
            r2 = (d * d).sum(0)
        if label == "l":
            m = np.abs(b[0] + b[1] - rows[t, :, 3][:, None]) <= 1.0
            r = np.sqrt(r2)
            ok = m & (r >= md.EPS) & (r <= md.HF)
            p6 = np.where(m & (r2 <= md.HH), (md.HH - r2) ** 3, 0.0)
            sg = np.where(ok, (md.HF - r) ** 2 / np.where(ok, r, 1.0), 0.0)
        else:
            r2 = np.maximum(r2, md.EPS2)
            u = 1.0 / np.sqrt(r2)
            p6 = np.maximum(md.HH - r2, 0.0) ** 3
            sg = np.maximum(md.HF - r2 * u, 0.0) ** 2 * u
        terms = np.stack([p6, d[0] * sg, d[1] * sg, d[2] * sg])
        out[t] = terms.sum(-1).T
        mag[t] = np.abs(terms).sum(-1).T
    return out, mag


@pytest.mark.parametrize("label", LABELS)
def test_plain_matches_float64(label):
    x = md.random_inputs(SEED + 1, 4, 8)
    got = md.run_plain(label, x)[0].numpy()
    want, mag = body_f64(label, x)
    if label in md.MXU:
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=MXU_SEEDED_SHARE * np.abs(want).max())
    else:
        assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-5 * mag)


@pytest.mark.parametrize("label", md.MXU)
def test_mxu_float64_range_holds_pallas_and_plain(label):
    """The interpreted Pallas kernel (the TPU's fp32 dots) and the plain
    version lie inside `mxu_f64`'s range on the tool's and the seeded inputs,
    and so does this file's float64 evaluation (b2 exact, where `mxu_f64`
    takes B2 as given); a shift of 1e-4 x max|value| leaves the range."""
    _, on_tool, on_seeded = jax_outputs()[label]
    for x, pallas in ((md.tool_inputs(NSUB, NCH), on_tool), (seeded(), on_seeded)):
        f64 = md.mxu_f64(label, x)
        assert md.within_f64(torch.from_numpy(body_f64(label, x)[0])[None], f64)[1]
        assert md.within_f64(torch.from_numpy(pallas)[None], f64)[1]
        plain = md.run_plain(label, x, 2)
        assert md.within_f64(plain, f64)[1]
        shift = 1e-4 * float(f64[0].abs().max())
        assert not md.within_f64(plain + shift, f64)[1]


@pytest.mark.parametrize("case", ["tool", "random"])
def test_mxu_float64_range_at_full_size(case):
    """At the card's size (32 sub-blocks of 20 chunks), where no fixed
    tolerance serves, the plain versions of d) and g), which round as the
    kernel does, lie inside the range, and a shift of 1e-4 x max|value|
    leaves it."""
    x = md.tool_inputs() if case == "tool" else md.random_inputs(0)
    for label in md.MXU:
        f64 = md.mxu_f64(label, x)
        plain = md.run_plain(label, x)
        assert md.within_f64(plain, f64)[1]
        assert not md.within_f64(plain - 1e-4 * float(f64[0].abs().max()), f64)[1]


def test_bound_counts_the_functions_work():
    """The bound counts what the function needs, not what the kernel issues:
    19 fp32 + 1 MUFU a pair-slot for chunk_math, 25 + 2 for l); d)/g)
    2 x (5 + 4) tensor-core flops and 10 fp32 + 1 MUFU a pair, so a
    sub-block copy is 2 x 32 x 2560 x 9 = 1,474,560 flops; at 1980 MHz on
    132 SMs a) at 64 copies takes 0.1003 ms of issue."""
    x = md.tool_inputs()
    pairs = md.REP * md.NSUB * md.WCAP * md.SUB
    w = md.work("a", x, md.REP)
    assert (w["fp32_ops"], w["mufu_ops"], w["tc_flops"]) == (19 * pairs, pairs, 0)
    assert md.work("k", x, md.REP) == w
    assert md.work("l", x, md.REP)["fp32_ops"] == 25 * pairs
    assert md.work("d", x, 1)["tc_flops"] == md.NSUB * 1_474_560
    assert md.work("g", x, md.REP) == md.work("d", x, md.REP)
    ms, by = md.bound_ms(w, 1980.0, 132)
    assert by == "operations" and ms == pytest.approx(20 * pairs / (132 * 128 * 1.98e9) * 1e3)
    ms, by = md.bound_ms(md.work("d", x, md.REP), 1980.0, 132)
    assert by == "operations" and ms == pytest.approx(11 * pairs / (132 * 128 * 1.98e9) * 1e3)
    # a trip count of 0 needs no pair: the dynamic bodies count this run's trips
    few = md.random_inputs(3)
    assert md.work("a", few, 1)["fp32_ops"] == 19 * md.pairs_a_rep(few, "a") < 19 * pairs


def test_mxu_bodies_keep_the_tools_r2():
    """d)/g) compute a2*b2 + 1 - 2 a.b (`tools/micro_dense.py:176-191`), not
    |a - b|^2: on the tool's inputs their sums are 30x c)'s."""
    x = md.tool_inputs(NSUB, NCH)
    c = md.run_plain("c", x)[0]
    for label in md.MXU:
        got = md.run_plain(label, x)[0]
        assert float(got.abs().max()) > 20 * float(c.abs().max())
        np.testing.assert_allclose(got.numpy(), body_f64(label, x)[0], rtol=1e-4, atol=1e-4)


def test_v1_mask_splits_on_seeded_inputs():
    """On the seeded inputs l)'s cell test passes some pairs and fails
    others, and l) differs from c) by what it masks."""
    x = seeded()
    bcl = x.cands[0] + x.cands[1]
    m = ((bcl[None, None, :] - x.acl_rows[:, :, 3:4]).abs() <= 1.0).float().mean()
    assert 0.2 < float(m) < 0.9
    l_out = md.run_plain("l", x)[0]
    assert float((l_out[..., 0] > 0).float().mean()) > 0.5
    assert not torch.allclose(l_out, md.run_plain("a", x)[0], rtol=1e-3)


def test_trip_structure_follows_the_tool():
    """The chunks a pass computes and the pair-slots a lane a trip."""
    assert md.chunk_schedule("a", 7, 2560) == [(c * 128, 128) for c in range(7)]
    assert md.chunk_schedule("i", 7, 2560) == md.chunk_schedule("a", 7, 2560)
    assert md.chunk_schedule("e", 7, 2560) == [(c * 128, 128) for c in range(6)]
    assert md.chunk_schedule("j", 7, 2560) == md.chunk_schedule("e", 7, 2560)
    assert md.chunk_schedule("f", 7, 2560) == [(0, 512)]
    assert md.chunk_schedule("f", 20, 2560) == [(c * 512, 512) for c in range(5)]
    assert md.chunk_schedule("g", 0, 2560) == [(c * 512, 512) for c in range(5)]
    assert md.chunk_schedule("h", 3, 2560) == [(0, 2560)]
    for label in ("b", "c", "d", "k", "l"):
        assert md.chunk_schedule(label, 3, 2560) == [(c * 128, 128) for c in range(20)]
    assert md.chunk_schedule("a", 99, 2560) == md.chunk_schedule("b", 0, 2560)  # clamped
    trips = {label: b.trip for label, b in md.BODIES.items()}
    assert trips == dict(a=4, b=4, c=80, d=4, e=8, f=16, g=16, h=80, i=8, j=16, k=80, l=80)
    x = md.tool_inputs()
    assert md.pairs_a_rep(x, "a") == md.NSUB * md.WCAP * md.SUB == md.pairs_a_rep(x, "h")


def test_passes_repeat_the_carries():
    """npass passes run the chunks again on the same carries: two passes
    give twice one pass's sums."""
    x = seeded()
    for label in ("a", "j", "d"):
        one = md.run_plain(label, x, 1, 1)
        np.testing.assert_allclose(md.run_plain(label, x, 1, 2).numpy(), 2 * one.numpy(),
                                   rtol=1e-5, atol=1e-5 * float(one.abs().max()))


def test_plain_refuses_what_the_kernels_do_not_take():
    x = md.tool_inputs(3, 4)
    with pytest.raises(ValueError, match="odd"):
        md.run_plain("i", x)
    with pytest.raises(ValueError, match="multiple of 512"):
        md.run_plain("g", md.tool_inputs(2, 3))
    with pytest.raises(ValueError, match="not one of"):
        md.run_plain("m", x)
    with pytest.raises(ValueError, match="at least 1"):
        md.run_plain("a", x, 0)


def sass_function(name, loop, before=(), after=()):
    """A `cuobjdump -sass` listing of one kernel: `before`, then `loop` closed
    by a backward branch, then `after` and EXIT.  An entry ("BRA", n) is a
    forward branch over the next n instructions."""
    lines = [f"\t\tFunction : {name}"]
    addr = 0

    def emit(op):
        nonlocal addr
        lines.append(f"        /*{addr:04x}*/                   {op} ;")
        addr += 0x10

    for op in before:
        emit(op)
    top = addr
    for op in loop:
        if isinstance(op, tuple):
            emit(f"@P1 BRA 0x{addr + 0x10 * (op[1] + 1):x}")
        else:
            emit(op)
    emit(f"@P0 BRA 0x{top:x}")
    for op in after:
        emit(op)
    emit("EXIT")
    return "\n".join(lines)


FP32_PAIR = ["FADD R1, R2, R3"] * 6 + ["FFMA R1, R2, R3, R4"] * 7 + \
    ["FMUL R1, R2, R3"] * 5 + ["FMNMX R1, R2, R3, !PT"] * 2 + ["FSETP.GEU.AND P0, PT, R1, R2, PT",
                                                               "FSEL R1, R2, R3, P0"]


def fpu_pair(loads=("LDS.128 R4, [R5]",)):
    return list(loads) + FP32_PAIR + ["MUFU.RSQ R6, R7"]


def v1_pair():
    return ["LDS.128 R4, [R5]"] + FP32_PAIR + ["FADD R1, R2, R3"] * 11 + \
        ["MUFU.RSQ R6, R7", ("BRA", 1), "CALL.REL.NOINC 0x900", "MUFU.RCP R6, R7", ("BRA", 1),
         "CALL.REL.NOINC 0x980"]


# gb's chunk loop as the built library should hold it: per 16 x 8 block an
# r2 DMMA and a reduce DMMA, the epilogue of four values, the block's three
# shared-memory reads; no store, no barrier
GB_LOOP = (["LDS.64 R8, [R2]", "LDS.128 R10, [R3]", "LDS.128 R12, [R4]",
            "DMMA.16x8x4 R14, R8, R10, R14"] + ["MUFU.RSQ R6, R7"] * 4 + FP32_PAIR * 2
           + ["DMMA.16x8x8 R16, R8, R12, R16"]) * 4


def listing(**override):
    """`pbf_lambda`'s pair loop and one function a body, each as the built
    library holds it (22 fp32 and one MUFU.RSQ a pair, the trips of
    `md.BODIES`), with `override` labels' loops replaced."""
    loop = ["LDG.E.128 R4, [R2.64]"] + FP32_PAIR + ["MUFU.RSQ R6, R7"]
    funcs = [sass_function(f"_ZN12_GLOBAL__N_1{ar.PHASE_KERNELS['lambda']}", loop)]
    for label, body in md.BODIES.items():
        name = f"_ZN12_GLOBAL__N_1{md.pattern(label)}EvPKf"
        before = ["MOV R1, c[0x0][0x28]"]
        if label in md.MXU:
            loop = (["DMMA.8x8x4 R8, R10, R12, R8"] * md.DMMA_A_TRIP[label]
                    + ["MUFU.RSQ R6, R7"] * body.trip + FP32_PAIR * (body.trip // 2))
        elif label == "l":
            loop = v1_pair() * body.trip
        elif label == "k":
            before += ["SYNCS.EXCH.64 URZ, [UR4], UR5", "UBLKCP.S.G [UR6], [UR8], UR10",
                       "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R0], RZ"]
            loop = fpu_pair(("LDS R4, [R5]",) * 3) * body.trip
        else:
            loop = fpu_pair() * body.trip + ["ISETP.NE.AND P0, PT, R2, " +
                                             ("0x14" if label == "b" else "R3") + ", PT"]
        funcs.append(sass_function(name, override.get(label, loop), before))
    funcs.append(sass_function(f"_ZN12_GLOBAL__N_1{md.pattern('gb')}EvPKfS1_", override.get(
        "gb", GB_LOOP), ["BAR.SYNC.DEFER_BLOCKING 0x0"], ["STS [R2], R3", "BAR.SYNC 0x0"]))
    return "\n".join(funcs)


def test_sass_check_on_a_recorded_listing():
    report = md.check_funcs(ar.parse_sass(listing()))
    assert md.short(report) == [], report
    assert report["a"]["fp32_per_pair"] == 22 and report["k"]["lds_per_pair"] == 3
    assert all(report[label]["same_as_pbf_lambda"] for label in "abcefhijk")
    assert report["l"]["guards_per_pair"] == 2 and report["l"]["mufu_per_pair"] == 2
    assert report["d"]["dmma_a_trip"] == 8 and report["g"]["dmma_a_trip"] == 32
    assert report["h"]["same_as_c"]


def test_sass_check_catches_what_nvcc_may_do():
    """A body whose fp32 a pair drifts, or keeps its count with another
    opcode than `pbf_lambda`'s, a static loop whose bound is not an
    immediate, an unrolled dynamic loop, an l) without its slow-path guards,
    a d) short of DMMAs: each fails the check."""
    pair = fpu_pair()
    cases = {
        "e": pair[:-2] + pair[-1:],                   # one fp32 instruction fewer
        "c": (pair[:1] + ["FFMA R1, R2, R3, R4"] + pair[2:]) * 80,   # an FADD became an FFMA
        "b": pair * 4 + ["ISETP.NE.AND P0, PT, R2, R3, PT"],
        "a": pair * 8,                                # unrolled x2
        "l": (["LDS.128 R4, [R5]"] + FP32_PAIR + ["MUFU.RSQ R6, R7", "MUFU.RCP R6, R7"]) * 80,
        "d": ["DMMA.8x8x4 R8, R10, R12, R8"] * 4 + ["MUFU.RSQ R6, R7"] * 4,
    }
    for label, loop in cases.items():
        report = md.check_funcs(ar.parse_sass(listing(**{label: loop})))
        assert md.short(report) == [label], (label, report[label])


# ---------------------------------------------------------------------------
# gb: g) redesigned (dense_wmxu_blocked)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["tool", "seeded"])
def test_blocked_plain_matches_pallas(case):
    """gb's wrapper on CPU tensors: g)'s plain version, within g)'s
    tolerances of the interpreted k_wmxu; no launch."""
    _, on_tool, on_seeded = jax_outputs()["g"]
    x = md.tool_inputs(NSUB, NCH) if case == "tool" else seeded()
    wrappers = md.MicroDense()
    got = wrappers.run("gb", x, nrep=2)
    assert torch.equal(got, md.run_plain("g", x, 2))
    for copy in got.numpy():
        assert_matches_pallas("g", copy, on_tool if case == "tool" else on_seeded, case)
    assert wrappers.launches == dict.fromkeys(md.KERNELS, 0)
    assert (md.base("gb"), md.kernel_of("gb"), md.kernel_of("g")) == (
        "g", "dense_wmxu_blocked", "dense_wmxu")


def gb_mirror(x, pairing=lambda k: 2 * k if k < 4 else 2 * (k - 4) + 1):
    """(nsub, 32, 4) of gb on x, in float64 as the kernel pairs its columns:
    warp (rb, grp) takes rows 16rb .. 16rb + 15 and the 16 x 8 blocks cb =
    grp + 16i of each 512-column chunk; a block's r2 = B2 row 4 (A2's
    constant column folded into the accumulator) + A2[:, :4] . B2[:4], then
    rounded to fp32 and the epilogue in fp32; the reduce's A[r][k] and
    B[k][n] are the lane fragments of csrc/dmma.cuh (a_i = A[g + 8 (i & 1)][t
    + 4 (i >> 1)] = the sg lane (g, t) holds at row g + 8 (i & 1), column 2t
    + (i >> 1); b_i = B[t + 4i][g] = [1, bx, by, bz][g] at column 2t + i), so
    k pairs with column `pairing(k)`; alternate blocks sum into two fp64
    accumulators; p6 a lane in fp32, then the lanes' butterfly and the 16
    groups in order; the end as dense_mxu_kernel's."""
    nsub, wcap = md._check_inputs("g", x)
    rows = x.rows[:, :, :3].double()
    b2 = x.b2.double()
    out = torch.empty((nsub, md.SUB, 4), dtype=torch.float32)
    cols = torch.tensor([pairing(k) for k in range(8)])
    for t in range(nsub):
        a = rows[t]                                               # (32, 3)
        a2 = (a * a).sum(1).float().double()
        amat = torch.cat([a, a2[:, None]], 1)                     # A2[:, :4]
        bt = b2[:, t * wcap:(t + 1) * wcap]
        p6 = torch.zeros((16, md.SUB, 4), dtype=torch.float32)    # (grp, row, lane t)
        red = torch.zeros((2, 16, md.SUB, 4), dtype=torch.float64)
        for ch in range(wcap // md.WIDE):
            for i in range(md.WIDE // 8 // 16):
                for grp in range(16):
                    cn = ch * md.WIDE + (grp + 16 * i) * 8
                    blk = bt[:, cn:cn + 8]
                    r2 = (blk[4][None, :] + amat @ blk[:4]).float().clamp_min(md.EPS2)
                    u = torch.rsqrt(r2)
                    tt = (md.HH - r2).clamp_min(0.0)
                    lane_p6 = (tt * tt * tt).reshape(md.SUB, 4, 2)   # column 2t + e
                    p6[grp] += lane_p6[:, :, 0]
                    p6[grp] += lane_p6[:, :, 1]
                    t2 = md._fused_hf_minus(r2, u).clamp_min(0.0)
                    sg = (t2 * t2 * u).double()                     # (32, 8)
                    a_red = sg[:, cols]                             # A[r][k]
                    b_red = blk[4:8, cols].T                        # B[k][n], n < 4
                    red[i % 2, grp] += a_red @ b_red
        lanes = (p6[..., 0] + p6[..., 1]) + (p6[..., 2] + p6[..., 3])   # (grp, row)
        p6s = torch.zeros(md.SUB, dtype=torch.float32)
        tot = torch.zeros((md.SUB, 4), dtype=torch.float64)
        for grp in range(16):
            p6s = p6s + lanes[grp]
            tot = tot + (red[0, grp] + red[1, grp])
        tot = tot.float().double()
        grad = a * tot[:, :1] - tot[:, 1:]
        out[t] = torch.cat([p6s[:, None], grad.float()], 1)
    return out


@pytest.mark.parametrize("case", ["tool", "seeded"])
def test_blocked_mirror_inside_float64_range(case):
    """gb's column pairing in float64 lies inside `mxu_f64`'s range and
    within g)'s tolerances of g)'s plain version, on the tool's and the
    seeded inputs."""
    x = md.tool_inputs(NSUB, NCH) if case == "tool" else md.random_inputs(SEED, NSUB, NCH)
    got = gb_mirror(x)[None]
    assert md.within_f64(got, md.mxu_f64("g", x))[1]
    assert md.close(got, md.run_plain("g", x))[1]


def test_blocked_mirror_catches_a_wrong_pairing():
    """Had the reduce paired k = t + 4 with column 2t (not 2t + 1), the sums
    would leave the float64 range: the pairing is what the range holds."""
    x = md.random_inputs(SEED, NSUB, NCH)
    wrong = gb_mirror(x, pairing=lambda k: 2 * (k % 4))[None]
    assert not md.within_f64(wrong, md.mxu_f64("g", x))[1]
    assert not md.close(wrong, md.run_plain("g", x))[1]


def test_blocked_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        md.run_kernel("gb", md.tool_inputs(NSUB))
    with pytest.raises(ValueError, match="multiple of 512"):
        md.run_plain("gb", md.tool_inputs(2, 3))


@pytest.mark.parametrize("case, ok", [
    ("as built", True),
    ("a barrier in the chunk loop", False),
    ("sg stored to shared memory", False),
    ("local memory", False),
    ("g)'s m8n8k4 count", False),
])
def test_sass_blocked_check(case, ok):
    """gb's SASS check passes its chunk loop as built (2 DMMA a 16 x 8 block,
    16 MUFU.RSQ, no store, no barrier) and catches a barrier or a
    shared-memory store of sg in the loop, a spill anywhere, and g)'s DMMA
    count."""
    loop = {"as built": GB_LOOP,
            "a barrier in the chunk loop": GB_LOOP + ["BAR.SYNC.DEFER_BLOCKING 0x0"],
            "sg stored to shared memory": GB_LOOP + ["STS.64 [R5], R6"],
            "local memory": GB_LOOP + ["LDL R7, [R1]"],
            "g)'s m8n8k4 count": GB_LOOP + ["DMMA.8x8x4 R8, R10, R12, R8"] * 24}[case]
    report = md.check_funcs(ar.parse_sass(listing(gb=loop)))
    assert report["gb"]["ok"] is ok, report["gb"]
    assert md.short(report) == ([] if ok else ["gb"])
    if ok:
        assert (report["gb"]["dmma_a_trip"], report["gb"]["rsq_a_trip"]) == (8, 16)


def test_dense_launcher_signatures_are_the_cu_ones():
    """Every launcher of csrc/micro_dense.cu has a ctypes signature in
    `cuda_build.SIGNATURES` with its own argument types, one for each kernel
    the tool counts."""
    import re

    from pbf_sph_tpu_torch.ops import cuda_build

    src = (REPO / "pbf_sph_tpu_torch" / "csrc" / "micro_dense.cu").read_text()
    block = src[src.index('extern "C" {'):]
    kinds = {"const void*": cuda_build._P, "void*": cuda_build._P, "int": cuda_build._I,
             "float": cuda_build._F}
    found = {}
    for name, args in re.findall(r"^int (\w+)\(([^)]*)\)", block, re.M):
        found[name] = [kinds[" ".join(a.split()[:-1])] for a in args.split(",")]
    assert set(found) == {"dense_loop", "dense_mxu", "dense_scr", "dense_wmxu_blocked"}
    assert {md.kernel_of(label) for label in (*md.BODIES, *md.REDESIGNS)} == set(md.KERNELS)
    for name, argtypes in found.items():
        assert cuda_build.SIGNATURES[name] == argtypes, name
