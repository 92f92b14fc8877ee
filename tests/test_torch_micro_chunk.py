"""The port's pair-chunk micro-benchmark (`pbf_sph_tpu_torch/tools/micro_chunk.py`)
against the JAX package's `tools/micro_chunk.py`.

The JAX tool lives in `tools/`, outside the package; it is loaded from its
file, and only the loaded module object is changed: its `CHUNKS` is set to
64 (at 4096 an interpreted body takes ~10 s here), and its `timed` is
replaced by one that keeps the output of `fma_ceiling`'s kernel, which the
tool only times.  Its Pallas kernels run in interpret mode on the CPU
(`pltpu.force_tpu_interpret_mode`); each output is computed once.  The
port's `MicroChunk` wrappers run their plain versions on these CPU tensors
and launch nothing.

* `make_bench(body, interleave)`, old and new at interleave 1, 2 and 4, on
  the tool's own inputs (every pair masked out: both exactly 0) and on
  seeded inputs where every mask splits: rtol 1e-5, atol 1e-9 (fp32 sums of
  non-negative terms; torch and XLA round the pair terms in other orders).
* `fma_ceiling(streams)` at 1, 2, 4 and 8 streams over its 16384 trips:
  bit for bit (`torch.addcmul` fuses c*1.000001 + x as XLA does here).
* The plain version against a float64 evaluation of the same sums on
  seeded inputs, both bodies at interleave 1, 2 and 4: rtol 1e-5 (every
  term non-negative, so no sum cancels; 4e-6 at most here).
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pbf_sph_tpu_torch.tools import micro_chunk as mc

REPO = Path(__file__).resolve().parent.parent
CHUNKS = 64
SEED = 3
CASES = [(body, il) for body in mc.BODIES for il in mc.INTERLEAVES]


@functools.lru_cache(maxsize=None)
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "micro_chunk_reference", REPO / "tools" / "micro_chunk.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.CHUNKS = CHUNKS
    return module


@functools.lru_cache(maxsize=None)
def jax_bench(body, interleave, case):
    """The interpreted `make_bench` output (64, 128) on the tool's inputs or
    the seeded ones."""
    tool = jax_tool()
    fn = {"old": tool.chunk_old, "new": tool.chunk_new}[body]
    with pltpu.force_tpu_interpret_mode():
        f, s, rows = tool.make_bench(fn, interleave)
        if case == "random":
            s, rows = (t.numpy() for t in mc.random_inputs(SEED))
        return np.asarray(f(s, rows))


@functools.lru_cache(maxsize=None)
def jax_fma(streams):
    """The interpreted `fma_ceiling(streams)` kernel's output (64, 128)."""
    tool = jax_tool()
    kept = []

    def keep(fn, *args, reps=5):
        kept.append(np.asarray(fn(*args)))
        return 1.0

    tool.timed = keep
    with pltpu.force_tpu_interpret_mode():
        tool.fma_ceiling(streams)
    return kept[0]


def inputs(case):
    if case == "tool":
        s, rows, _ = mc.tool_inputs()
        return s, rows
    return mc.random_inputs(SEED)


@pytest.mark.parametrize("case", ["tool", "random"])
@pytest.mark.parametrize("body,interleave", CASES)
def test_chunk_plain_matches_pallas(body, interleave, case):
    want = jax_bench(body, interleave, case)
    wrappers = mc.MicroChunk()
    got = wrappers.chunk(*inputs(case), body, interleave, CHUNKS).numpy()
    if case == "tool":
        assert not got.any() and not want.any()
    else:
        assert (got > 0).mean() > 0.9   # the seeded inputs reach every slot
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    assert wrappers.launches == dict.fromkeys(mc.KERNELS, 0)


@pytest.mark.parametrize("streams", mc.STREAMS)
def test_fma_plain_matches_pallas(streams):
    want = jax_fma(streams)
    wrappers = mc.MicroChunk()
    got = wrappers.fma(torch.ones(mc.TILE), streams, mc.FMA_ITERS).numpy()
    np.testing.assert_array_equal(got, want)
    assert wrappers.launches == dict.fromkeys(mc.KERNELS, 0)


def chunk_f64(s, rows, body, interleave, nchunks):
    """The output of `make_bench` in float64: each strip chunk's pair terms
    times how often each stream reads it, stream 0's four carries and p6 + gx
    of every other stream."""
    a = rows.numpy().astype(np.float64)[:, :, None]
    b = s.numpy().astype(np.float64)[:, None, :]
    g = np.arange(mc.NCOLS)
    win = (g >= mc.LO) & (g < mc.HI)
    adj = np.abs(b[3] - (a[3] + mc.OFF)) <= 1.0
    d = a[:3] - b[:3]
    r2 = (d * d).sum(0)
    r = np.sqrt(r2)
    if body == "old":
        m = win & adj
        ok = m & (r >= mc.EPS) & (r <= mc.HF)
        p6 = np.where(m & (r2 <= mc.HH), (mc.HH - r2) ** 3, 0.0)
    else:
        q = win & adj & (r2 <= mc.HH)
        ok = q & (r2 >= mc.EPS2)
        p6 = np.where(q, (mc.HH - r2) ** 3, 0.0)
    sg = np.where(ok, (mc.HF - r) ** 2 / np.where(ok, r, 1.0), 0.0)
    terms = np.stack([p6, d[0] * sg, d[1] * sg, d[2] * sg])
    terms = terms.reshape(4, mc.SUB, mc.STRIP_CHUNKS, mc.WCOL)
    trips = mc.chunk_trips(interleave, nchunks).numpy()
    out = np.zeros((mc.SUB, mc.WCOL))
    for k in range(interleave):
        reads = np.bincount(trips[:, k], minlength=mc.STRIP_CHUNKS)
        carries = np.einsum("fajl,j->fal", terms, reads)
        out += carries.sum(0) if k == 0 else carries[0] + carries[1]
    return out


@pytest.mark.parametrize("body,interleave", CASES)
def test_chunk_plain_matches_float64(body, interleave):
    s, rows = mc.random_inputs(SEED + 1)
    got = mc.chunk_plain(s, rows, body, interleave, 128).numpy()
    np.testing.assert_allclose(got, chunk_f64(s, rows, body, interleave, 128), rtol=1e-5)


def test_old_and_new_agree_and_interleave_drops_carries():
    """On seeded inputs the two forms give the same sums, and an interleaved
    body gives less than interleave 1 by its dropped gy and gz (none where a
    slot's odd chunks hold no pair)."""
    s, rows = mc.random_inputs(SEED)
    old = mc.chunk_plain(s, rows, "old", 1, CHUNKS)
    new = mc.chunk_plain(s, rows, "new", 1, CHUNKS)
    torch.testing.assert_close(old, new, rtol=1e-5, atol=1e-9)
    x2 = mc.chunk_plain(s, rows, "new", 2, CHUNKS)
    assert bool((x2 <= new * (1 + 1e-5)).all())   # the sums' rounding
    assert float((x2 < new * (1 - 1e-3)).float().mean()) > 0.9


def test_chunk_trips_follow_the_tool():
    """Stream k of trip i reads chunk (i*interleave + k) mod 32 (`:97`)."""
    t = mc.chunk_trips(4, 64)
    assert t.shape == (16, 4)
    assert t[0].tolist() == [0, 1, 2, 3] and t[8].tolist() == [0, 1, 2, 3]
    assert t[9].tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="multiple"):
        mc.chunk_plain(*inputs("tool"), "new", 4, 6)
    with pytest.raises(ValueError, match="instantiates"):
        mc.chunk_plain(*inputs("tool"), "new", 3, 6)
