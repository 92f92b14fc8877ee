"""The port's spatial index against the JAX package's, bit for bit, on CPU.

Random positions made with numpy from a seed, including NaN, +-inf,
negative and out-of-box values, go through `pbf_sph_tpu.ops.grid` and
`pbf_sph_tpu_torch.ops.grid`; every output is an integer and must match
exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbf_sph_tpu.ops import grid as jgrid
from pbf_sph_tpu.ops.curves import morton_encode3 as jax_morton
from pbf_sph_tpu_torch.ops import grid as tgrid
from pbf_sph_tpu_torch.ops.curves import morton_encode3 as torch_morton

H = 0.1
SCALE = 500.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the tier runs several test
    processes at once, and torch's default pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(quirks=True):
    jspec = jgrid.GridSpec.from_bounds((0.0, 0.0, 0.0), (1000.0, 1000.0, 1000.0), SCALE, H)
    tspec = tgrid.GridSpec.from_bounds((0.0, 0.0, 0.0), (1000.0, 1000.0, 1000.0), SCALE, H)
    return (dataclasses.replace(jspec, quirks=quirks),
            dataclasses.replace(tspec, quirks=quirks))


def _pstar(seed, n=4096):
    """(3, n) f32 simulation-unit positions spanning the padded box and
    beyond, with NaN, infinities and huge values mixed in."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.6, 2.6, size=(3, n)).astype(np.float32)
    bad = rng.choice(n, size=64, replace=False)
    p[0, bad[:16]] = np.nan
    p[1, bad[16:32]] = np.inf
    p[2, bad[32:48]] = -np.inf
    p[:, bad[48:]] = rng.choice([-1e12, 1e12, 3e9], size=(3, 16)).astype(np.float32)
    return p


def _cells(pstar, min_ext):
    jc = jgrid.cell_coords(tuple(jnp.asarray(a) for a in pstar), jnp.asarray(min_ext), H)
    tc = tgrid.cell_coords(tuple(torch.from_numpy(a) for a in pstar),
                           torch.from_numpy(min_ext), H)
    return jc, tc


MIN_EXT = np.asarray([-0.2, -0.2, -0.2], np.float32)


def test_gridspec_matches():
    jspec, tspec = _grids()
    assert tspec.extent == jspec.extent and tspec.maxz == jspec.maxz
    assert tspec.dims == jspec.dims and tspec.ncells == jspec.ncells


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_coords_exact(seed):
    jc, tc = _cells(_pstar(seed), MIN_EXT)
    for a in range(3):
        assert tc[a].dtype == torch.int32
        np.testing.assert_array_equal(tc[a].numpy(), np.asarray(jc[a]))


@pytest.mark.parametrize("quirks", [True, False])
def test_sort_key_decode_table_exact(quirks):
    jspec, tspec = _grids(quirks)
    rng = np.random.default_rng(7)
    jc, tc = _cells(_pstar(3), MIN_EXT)
    alive = rng.random(4096) < 0.9

    jkey = np.asarray(jgrid.sort_key(jc, jnp.asarray(alive), jspec))
    tkey = tgrid.sort_key(tc, torch.from_numpy(alive), tspec)
    assert tkey.dtype == torch.int32
    np.testing.assert_array_equal(tkey.numpy(), jkey)
    assert (jkey < jspec.ncells).sum() > 1000  # most particles are members

    # the tables take unsorted and sorted keys alike
    for key in (jkey, np.sort(jkey, kind="stable")):
        jt = np.asarray(jgrid.build_cell_table(jnp.asarray(key), jspec))
        tt = tgrid.build_cell_table(torch.from_numpy(key), tspec)
        assert tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), jt)
        assert int(tgrid.max_cell_occupancy(tt)) == int(jgrid.max_cell_occupancy(jnp.asarray(jt)))

    skey = np.sort(jkey, kind="stable")
    (jx, jy, jz), jm = jgrid.decode_key(jnp.asarray(skey), jspec)
    (tx, ty, tz), tm = tgrid.decode_key(torch.from_numpy(skey), tspec)
    for a, b in ((tx, jx), (ty, jy), (tz, jz), (tm, jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_morton_encode3_on_int32_tensors():
    rng = np.random.default_rng(11)
    xyz = rng.integers(0, 1024, size=(3, 5000), dtype=np.int32)
    xyz[:, :3] = [[0, 1023, 1023], [0, 1023, 0], [0, 1023, 1023]]
    want = np.asarray(jax_morton(*(jnp.asarray(a) for a in xyz)))
    got = torch_morton(*(torch.from_numpy(a) for a in xyz))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) < 2**30
