"""The port's rate anchor (`pbf_sph_tpu_torch/tools/anchor_rate.py`) against
the JAX package's `tools/anchor_rate.py`.

The JAX tool lives in `tools/`, outside the package; it is loaded from its
file, and its Pallas kernels run in interpret mode on the CPU
(`pltpu.force_tpu_interpret_mode`), at small sizes: the issue kernels at 4
streams x 4 rounds x 8 iterations, the bodies at nunroll 2, nch 2, 3
iterations, the row kernel at 1 block.  The port's `Anchor` wrappers run
their plain versions on these CPU tensors and launch nothing; `body` and
its redesign `body_blocked` take the same plain version, and so do `rowfix`
and its redesign `rowfix_blocked`.  The SASS checks (the body's, the blocked
body's against the cells kernels, the blocked row kernel's) run on recorded
listings; the blocked row kernel's warp logic (which lane loads which range
end, when a warp loads each row's ends directly) runs in its Python mirror,
`rowfix_warp_ends`, against direct clipped reads.

Tolerances: the issue tiles and the bodies' per-row sums rtol 1e-5, atol
1e-6 (fp32 sums in another order); λ of the row kernel atol 1e-9 (every sum
is 0, λ = 1/CFM_EPSILON).  The bodies are also held against a float64 numpy
evaluation of the same pair sums on random rows and strips, rtol 1e-5.
"""

import collections
import functools
import importlib.util
import re
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


@functools.lru_cache(maxsize=None)
def interpreted_body(which):
    return interpreted(jax_anchor().build_body(which, nunroll=2, nch=2)(3)).sum(axis=1)


@pytest.mark.parametrize("wrapper, which", [
    pytest.param("body", "lambda", id="lambda"),
    pytest.param("body", "delta", id="delta"),
    pytest.param("body_blocked", "lambda", id="blocked-lambda"),
    pytest.param("body_blocked", "delta", id="blocked-delta"),
])
def test_body_plain_matches_pallas(wrapper, which):
    want = interpreted_body(which)
    rows = torch.full((5, ar.SUB), 0.05)
    strip = torch.full((4, 2 * ar.WCOL), 0.055)
    anchor = ar.Anchor()
    got = getattr(anchor, wrapper)(rows, strip, which, 2, 3)
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


@functools.lru_cache(maxsize=None)
def interpreted_subfix():
    """(output of the interpreted build_subfix kernel at 1 block, its sub-blocks
    an iteration); ~9 s, run once for the row kernel and its redesign."""
    build, per_iter = jax_anchor().build_subfix()
    return interpreted(build(1)), per_iter


def test_rowfix_plain_matches_pallas():
    want, per_iter = interpreted_subfix()
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


def test_blocked_rows_are_the_sources():
    """The R that the wrappers and the SASS check take is the .cu's, at
    least 2, and it divides the λ body's iterations, so that the table line
    can run the blocked body at the body's work."""
    src = (REPO / "pbf_sph_tpu_torch" / "csrc" / "anchor_rate.cu").read_text()
    m = re.search(r"constexpr int kBlockedRows = (\d+);", src)
    assert m is not None and int(m.group(1)) == ar.BLOCKED_ROWS >= 2
    assert ar.BODY_ITERS[1] % ar.BLOCKED_ROWS == 0


def test_blocked_shape_keeps_the_work():
    n, it = ar.blocked_shape(270336, 128)
    assert (n, it) == (270336, 128 // ar.BLOCKED_ROWS)
    assert n * ar.BLOCKED_ROWS * it == 270336 * 128
    with pytest.raises(ValueError, match="divide"):
        ar.blocked_shape(256, 6, rows=4)


def test_body_blocked_kernel_refuses_cpu_tensors():
    rows, strip = ar.random_body_inputs(0, nch=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ar.body_blocked_kernel(rows, strip, "lambda", 2, 3)
    anchor = ar.Anchor()
    torch.testing.assert_close(anchor.body_blocked(rows, strip, "delta", 2, 3, 1),
                               ar.body_plain(rows, strip, "delta", 2, 3, 1), rtol=0, atol=0)
    assert anchor.launches == dict.fromkeys(ar.KERNELS, 0)


CELLS_PAIR = ["FADD", "FADD", "FADD", "FMUL", "FFMA", "FFMA", "FADD", "FMNMX", "FMUL", "FFMA",
              "FMNMX", "MUFU.RSQ", "FFMA", "FMNMX", "FMUL", "FMUL", "FFMA", "FFMA", "FFMA"]


def blocked_listing(pairs_a_read, reads, extra=()):
    """A listing with the cells λ kernel (one LDG.128 a pair) and a blocked
    λ body at R = BLOCKED_ROWS (4) whose loop holds `reads` LDS.128 reads,
    each followed by `pairs_a_read` copies of the cells pair and `extra`."""
    cells = sass_listing(f"_Z{ar.CELLS_KERNELS['lambda']}PK6float4", ["LDG.E.128"] + CELLS_PAIR,
                         4)
    body = ["LDS.128"] + CELLS_PAIR * pairs_a_read + list(extra)
    blocked = sass_listing("_ZN12_GLOBAL__N_119body_blocked_kernelILb1EEEvPKf", body, reads)
    return ar.parse_sass(cells + "\n" + blocked)


@pytest.mark.parametrize("case, ok", [
    ("4 pairs a read", True),
    ("1 pair a read", False),
    ("an fp32 op more", False),
    ("local memory", False),
])
def test_sass_blocked_check(case, ok):
    """The blocked body's SASS case: R MUFU.RSQ a LDS.128 and the cells
    kernels' fp32 opcodes a pair pass; one read a pair, a drifted pair and a
    local-memory access (a spill) fail."""
    funcs = {"4 pairs a read": lambda: blocked_listing(4, 4),
             "1 pair a read": lambda: blocked_listing(1, 16),
             "an fp32 op more": lambda: blocked_listing(4, 4, ["FMUL"] * 4),
             "local memory": lambda: blocked_listing(4, 4, ["STL"])}[case]()
    cells = ar.fp32_per_pair(ar.pair_loop(ar._one(funcs, ar.CELLS_KERNELS["lambda"])))
    assert sum(cells.values()) == 18
    report = ar.check_blocked(funcs, {"lambda": cells})["body_blocked lambda"]
    assert report["ok"] is ok, report
    assert report["pairs_a_loop"] == 16
    assert report["same_as_cells"] is (case != "an fp32 op more")
    assert (report["local"] > 0) is (case == "local memory")


def test_rowfix_blocked_plain_matches_pallas():
    """The redesign's wrapper on CPU tensors: `rowfix_plain`, bit for bit the
    interpreted build_subfix, at 1 and 3 blocks; no launch."""
    want, _ = interpreted_subfix()
    rows = torch.full((5, ar.ROWS), 0.05)
    index = ar.rowfix_index(rows)
    anchor = ar.Anchor()
    for nblocks in (1, 3):
        got = anchor.rowfix_blocked(rows, index, nblocks)
        np.testing.assert_array_equal(got.numpy(), want)
    assert anchor.launches == dict.fromkeys(ar.KERNELS, 0)


def test_rowfix_kernels_refuse_cpu_tensors():
    rows = torch.full((5, ar.ROWS), 0.05)
    index = ar.rowfix_index(rows)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ar.rowfix_blocked_kernel(rows, index, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ar.rowfix_kernel(rows, index, 2, whole=True)


def direct_ends(index, ncells):
    """Each row's nine [lo, hi) read directly, clipped (`walk_direct`); a
    non-member's range empty."""
    lo, hi = ar.ph.neighbour_ranges(index)
    member = index.key < ncells
    return lo, hi, member


def assert_warp_ends_are_direct(index):
    ncells = index.grid.ncells
    lo, hi, shared, entries = ar.rowfix_warp_ends(index)
    want_lo, want_hi, member = direct_ends(index, ncells)
    assert torch.equal(lo[:, member], want_lo[:, member])
    assert torch.equal(hi[:, member], want_hi[:, member])
    assert torch.equal(hi[:, ~member], lo[:, ~member])
    # which lane loads which entry: lane l of a shared warp, range k, loads
    # table[clip(lmin + off_k - 1 + l)]; a direct warp loads no shared entry
    groups = ar.rowfix_warp_rows(ar.ROWS)
    off = ar._ranges_offsets(index)
    for g in range(groups.shape[0]):
        lin = index.key[groups[g]].long()
        lin = lin[lin < ncells]
        if not shared[g]:
            assert (entries[g] == -1).all()
            assert lin.numel() == 0 or int(lin.max() - lin.min()) > ar.ROWFIX_SHARED_SPAN
            continue
        assert int(lin.max() - lin.min()) <= ar.ROWFIX_SHARED_SPAN
        for k in range(9):
            want = [min(max(int(lin.min()) + off[k] - 1 + l, 0), ncells) for l in range(32)]
            assert entries[g, k].tolist() == want
    return shared


def test_rowfix_warp_rows_cover_each_row_once():
    """A pass of the blocked row kernel's warps takes every row once, 32
    consecutive rows a step of a warp (rows 32 apart a thread)."""
    groups = ar.rowfix_warp_rows(ar.ROWS)
    assert tuple(groups.shape) == (ar.ROWS // 32, 32)
    assert torch.equal(groups.reshape(-1).sort().values, torch.arange(ar.ROWS))
    assert bool((groups[:, 1:] - groups[:, :-1] == 1).all())
    with pytest.raises(ValueError, match="not a multiple"):
        ar.rowfix_warp_rows(32 * ar.ROWFIX_ROWS + 32)


@pytest.mark.parametrize("dims", [ar.DAM1M_DIMS, (40, 30, 20)])
def test_rowfix_warp_ends_on_the_tools_index(dims):
    """On the tool's index (two rows a cell): every warp reads its ends by
    one load a range (16 cells a warp), and they are the direct ends."""
    rows = torch.full((5, ar.ROWS), 0.05)
    shared = assert_warp_ends_are_direct(ar.rowfix_index(rows, dims))
    assert bool(shared.all())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rowfix_warp_ends_on_a_sorted_index(seed):
    """On a sorted index with 0-12 rows a cell, a run of 32 empty cells and
    non-member rows: some warps share their ends, some load them directly
    (the run of empty cells, the members beside non-members at the end),
    and every member row's ends are the direct ones."""
    _, index = ar.seeded_rowfix(seed)
    assert not bool((index.key < index.grid.ncells).all())
    shared = assert_warp_ends_are_direct(index)
    assert bool(shared.any()) and not bool(shared.all())


def test_rowfix_warp_ends_clip_at_the_table_ends():
    """Near the grid's ends a shared warp's lanes read clipped entries (0 and
    ncells), and the ends are still the direct ones."""
    rows = torch.full((5, ar.ROWS), 0.05)
    index = ar.rowfix_index(rows, (14, 10, 9))
    lo, hi, shared, entries = ar.rowfix_warp_ends(index)
    ncells = index.grid.ncells
    assert bool(shared.all())
    assert int(entries.max()) == ncells
    assert_warp_ends_are_direct(index)


def test_seeded_rowfix_has_pairs():
    """The seeded index has non-empty ranges (pairs to sum), members sorted,
    memberf matching the key, and its plain λ differs from 1/CFM."""
    rows, index = ar.seeded_rowfix(0)
    ncells = index.grid.ncells
    key = index.key.long()
    assert bool((key[1:] >= key[:-1]).all())
    assert torch.equal(rows[4] != 0, key < ncells)
    lo, hi = ar.ph.neighbour_ranges(index)
    assert int((hi - lo).sum()) > 50 * ar.ROWS
    lam = ar.rowfix_plain(rows, index, 1)
    assert bool(torch.isfinite(lam).all())
    assert float((lam - 1.0 / np.float32(K.CFM_EPSILON)).abs().max()) > 1e-4


def test_rowfix_constants_are_the_sources():
    """R and the shared span that the mirror takes are the .cu's; 32 lanes
    hold the ends lin - 1 .. lin + 2 of a span's cells."""
    src = (REPO / "pbf_sph_tpu_torch" / "csrc" / "anchor_rate.cu").read_text()
    rows = re.search(r"constexpr int kRowfixRows = (\d+);", src)
    span = re.search(r"constexpr int kSharedSpan = (\d+);", src)
    assert rows is not None and int(rows.group(1)) == ar.ROWFIX_ROWS
    assert span is not None and int(span.group(1)) == ar.ROWFIX_SHARED_SPAN
    assert ar.ROWFIX_SHARED_SPAN + 3 == 31
    assert ar.ROWS % (32 * ar.ROWFIX_ROWS) == 0


def test_anchor_launcher_signatures_are_the_cu_ones():
    """Every launcher of csrc/anchor_rate.cu has a ctypes signature in
    `cuda_build.SIGNATURES` with its own argument types."""
    from pbf_sph_tpu_torch.ops import cuda_build

    src = (REPO / "pbf_sph_tpu_torch" / "csrc" / "anchor_rate.cu").read_text()
    block = src[src.index('extern "C" {'):]
    kinds = {"const void*": cuda_build._P, "void*": cuda_build._P, "int": cuda_build._I,
             "float": cuda_build._F}
    found = {}
    for name, args in re.findall(r"^int (\w+)\(([^)]*)\)", block, re.M):
        found[name] = [kinds[" ".join(a.split()[:-1])] for a in args.split(",")]
    assert set(ar.KERNELS) <= set(found)
    for name, argtypes in found.items():
        assert cuda_build.SIGNATURES[name] == argtypes, name


ROWFIX_HEAD = ["LDG.E.CONSTANT R3, desc[UR6][R4.64]", "LDG.E.128.CONSTANT R8, desc[UR6][R8.64]",
               "REDUX.MIN.S32 UR4, R12", "REDUX.MAX.S32 UR5, R4"]


def rowfix_listing(name, shared_loads=9, direct_loads=18, shuffles=18, pair=CELLS_PAIR,
                   extra=()):
    """A listing of one blocked row kernel: the head, the shared ends' loads
    and shuffles, the direct ends' loads, then a range loop of `pair`."""
    before = ROWFIX_HEAD + ["LDG.E.CONSTANT R5, desc[UR6][R12.64]"] * shared_loads \
        + ["SHFL.IDX PT, R17, R5, R27, 0x1f"] * shuffles \
        + ["LDG.E.CONSTANT R6, desc[UR6][R14.64]"] * direct_loads + list(extra)
    lines = [f"\t\tFunction : {name}"]
    addr = 0
    for op in before:
        lines.append(f"        /*{addr:04x}*/                   {op} ;")
        addr += 0x10
    top = addr
    for op in ["LDG.E.128.CONSTANT R12, desc[UR6][R26.64]"] + list(pair):
        lines.append(f"        /*{addr:04x}*/                   {op} R3, R4, R5 ;")
        addr += 0x10
    lines.append(f"        /*{addr:04x}*/              @!P0 BRA 0x{top:x} ;")
    lines.append(f"        /*{addr + 0x10:04x}*/                   EXIT ;")
    return "\n".join(lines)


def rowfix_funcs(**kw):
    return ar.parse_sass(rowfix_listing(
        "_ZN12_GLOBAL__N_121rowfix_blocked_kernelEPK6float4PKiS4_iiiiifffffffPf", **kw))


@pytest.mark.parametrize("case, ok", [
    ("as built", True),
    ("range loop folded", False),
    ("a drifted pair", False),
    ("shared loads missing", False),
    ("direct loads missing", False),
    ("shuffles missing", False),
    ("local memory", False),
])
def test_sass_rowfix_blocked_check(case, ok):
    """The blocked row kernel's SASS check passes the kernel as it was built
    (28 32-bit loads, 18 SHFL, the cells λ pair loop) and catches a
    folded range loop, a pair that drifted from the cells kernels', missing
    table loads or shuffles, and a spill."""
    kw = {"as built": {},
          "range loop folded": {"pair": [op for op in CELLS_PAIR if op != "MUFU.RSQ"]},
          "a drifted pair": {"pair": CELLS_PAIR + ["FMUL"]},
          "shared loads missing": {"shared_loads": 0},
          "direct loads missing": {"direct_loads": 0},
          "shuffles missing": {"shuffles": 2},
          "local memory": {"extra": ["STL [R1], R3"]}}[case]
    cells = ar.fp32_per_pair(collections.Counter(CELLS_PAIR))
    assert sum(cells.values()) == 18
    report = ar.check_rowfix_blocked(rowfix_funcs(**kw), cells)
    r = report["rowfix_blocked"]
    assert r["ok"] is ok, (case, r)
    if case == "as built":
        assert (r["ldg32"], r["shfl"], r["local"]) == (ar.ROWFIX_LOADS, ar.ROWFIX_SHUFFLES, 0)
