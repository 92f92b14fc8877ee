"""The port's loop probes (`pbf_sph_tpu_torch/tools/micro_loop.py`) against
the JAX package's `tools/micro_loop.py`.

The JAX tool lives in `tools/`, outside the package; it is loaded from its
file, and only the loaded module object is changed: its `timed`, which its
`run` calls on each jitted `pallas_call`, is replaced by one that keeps the
output.  Its `main` then runs all 16 bodies at the tool's own trip counts
(N = 65536) with its Pallas kernels in interpret mode on the CPU
(`pltpu.force_tpu_interpret_mode`), once, in the order of `BODIES`.  The
port's `MicroLoop` wrappers run their plain versions on these CPU tensors
and launch nothing.

Tolerances: bit for bit for every body but e) rsqrt: `torch.addcmul` fuses
c*1.000001 + x as XLA does here, and add, mul, where and sub_abs_cmp round
alike.  e) rsqrt rtol 1e-6: the iteration contracts to a fixed point, so a
difference in the last bit of rsqrt does not grow.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pbf_sph_tpu_torch.tools import micro_loop as ml

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
def jax_outputs():
    """label -> the interpreted kernel's output, for the 16 bodies of main."""
    spec = importlib.util.spec_from_file_location(
        "micro_loop_reference", REPO / "tools" / "micro_loop.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    kept = []

    def keep(fn, *args, reps=5):
        kept.append(np.asarray(fn(*args)))
        return 1.0

    module.timed = keep
    with pltpu.force_tpu_interpret_mode():
        module.main()
    assert len(kept) == len(ml.BODIES)
    return dict(zip(ml.BODIES, kept))


@pytest.mark.parametrize("label", list(ml.BODIES))
def test_loop_plain_matches_pallas(label):
    want = jax_outputs()[label]
    body = ml.BODIES[label]
    x = ml.tool_inputs()[body.tile]
    wrappers = ml.MicroLoop()
    got = wrappers.run(label, x, body.trips).numpy()
    assert got.shape == want.shape == body.tile
    if label == "e_rsqrt":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    assert wrappers.launches == dict.fromkeys(ml.KERNELS, 0)


def test_bodies_follow_the_tool():
    """The 16 bodies of the JAX main, with its trips and ops a trip."""
    b = ml.BODIES
    assert list(b) == ["a", "b2", "b4", "b8", "b16", "b32", "c4", "c16", "d1", "d2", "d4",
                       "e_rsqrt", "e_where", "e_mul", "e_add", "e_sub_abs_cmp"]
    assert (b["a"].trips, b["c16"].trips, b["d4"].trips, b["e_add"].trips) == (
        65536, 8192, 16384, 16384)
    assert (b["b32"].ops, b["c16"].ops, b["d2"].ops, b["e_mul"].ops) == (32, 16, 2, 8)
    assert b["d1"].tile == (64, 128) and b["a"].tile == (8, 128)
    with pytest.raises(ValueError, match="instantiates"):
        ml.fma_plain(torch.ones(8, 128), 3, 2)
    with pytest.raises(ValueError, match="instantiates"):
        ml.op_plain(torch.ones(8, 128), "div", 2)
