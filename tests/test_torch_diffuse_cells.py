"""The main path's diffuse (`ops/diffuse_cells.py`) on the CPU.

Its plain versions, the per-cell colour sums and the 27-cell gather with the
mix, are held to:

* the JAX package's `PallasPhases.diffuse` in interpret mode on
  `test_torch_phases.py`'s two scenes: colour atol 1e-6 (as
  `test_torch_phases.py` holds row 3), and the 27-cell count exactly to the
  Pallas kernel's raw count (integers);
* numpy oracles by cell coordinates: in float32, adding in the kernels'
  order (rows of a cell one by one, then the 27 cells dx, dy, dz), bit for
  bit; in float64, within the error bound of a sequential fp32 sum of
  non-negative terms, (adds) x 2^-24 x the sum (the "sparse" scene has runs
  of 216 rows of one colour, whose fp32 sums are 2.1e-6 off float64, so no
  fixed rtol of 1e-6 holds); counts exact;
* the per-row path, `PbfPhases.diffuse_rows` (`diffuse_plain` and
  `mix_colour`): colour atol 1e-6 (the same sums in another fp32 order), the
  count exactly.

Each scene runs as sorted ("scene") and with seeded colours, 10% of the rows
set to OBSTACLE and 5% dead without a new sort ("mixed"), so dead and
obstacle rows sit inside member runs.  A synthetic cell index puts members in
the grid's face and corner cells, where a neighbour wrapped across a column
or the grid would be wrong.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbf_sph_tpu.models.jax_solver import JaxSolver, make_phase_objects
from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
from pbf_sph_tpu_torch.core.types import FLUID, OBSTACLE, Scene
from pbf_sph_tpu_torch.models.torch_solver import (
    TorchSolver,
    advect_and_sort,
    dyn_params_of,
)
from pbf_sph_tpu_torch.ops import diffuse_cells as dc
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.ops.grid import GridSpec, decode_key

CASES = {
    "2cubes": (700, 2, 500.0),
    "sparse": (600, 2, 2500.0),
}
VARIANTS = ("scene", "mixed")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the tier runs several test
    processes at once, and torch's default pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(CASES))
def frame(request):
    mc, cfg, xs = simple_config_with_2_cubes(*CASES[request.param])
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    assert spec.capacity == 1024
    dyn = dyn_params_of(cfg, device="cpu")
    fr = advect_and_sort(spec, state, dyn, scn)
    jspec = JaxSolver(h=cfg.h, use_pallas=True).make_spec(cfg, Scene(), spec.capacity)
    pallas, _ = make_phase_objects(jspec, use_pallas=True)
    wins, ovf = pallas.plan_frame(jnp.asarray(fr.index.key.numpy()),
                                  jnp.asarray(fr.index.table.numpy()))
    assert int(ovf) == 0
    return dict(spec=spec, dyn=dyn, fr=fr, pallas=pallas, wins=wins)


def rows_of(fr, variant):
    """(colour, ptype, alive) of the sorted frame, or its mixed variant."""
    st = fr.state
    if variant == "scene":
        return st.colour, st.ptype, st.alive
    rng = np.random.default_rng(14)
    n = st.ptype.shape[0]
    colour = torch.from_numpy(rng.uniform(0.0, 1.0, (4, n)).astype(np.float32))
    ptype = torch.where(torch.from_numpy(rng.random(n) < 0.1), OBSTACLE, st.ptype)
    alive = st.alive & torch.from_numpy(rng.random(n) >= 0.05)
    return colour, ptype.to(torch.int32), alive


def oracle(index, colour, ptype, alive, dtype):
    """(ncells, 5) per-cell sums and (5, C) 27-cell sums of each member row
    in `dtype`, by cell coordinates: rows added in row order, then the
    padded grid's 27 shifted copies dx, dy, dz."""
    grid = index.grid
    key = index.key.numpy().astype(np.int64)
    member = key < grid.ncells
    counted = member & (ptype.numpy() != OBSTACLE) & alive.numpy()
    values = np.concatenate([colour.numpy(), np.ones((1, len(key)), np.float32)]).astype(dtype)
    cells = np.zeros((grid.ncells, 5), dtype)
    for i in np.flatnonzero(counted):
        cells[key[i]] += values[:, i]
    nx, ny, nz = grid.dims
    box = np.pad(cells.reshape(nx, ny, nz, 5), ((1, 1), (1, 1), (1, 1), (0, 0)))
    summed = np.zeros((nx, ny, nz, 5), dtype)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                summed = summed + box[1 + dx:1 + dx + nx, 1 + dy:1 + dy + ny,
                                      1 + dz:1 + dz + nz]
    rows = np.zeros((5, len(key)), dtype)
    rows[:, member] = summed.reshape(-1, 5)[key[member]].T
    return cells, rows


def assert_sums(got, index, colour, ptype, alive, rows: bool):
    """`got` ((ncells, 5) cell sums, or (5, C) row sums if `rows`) bit for
    bit the float32 oracle, and within a sequential fp32 sum's error bound of
    the float64 one; counts exact."""
    want32, want64 = (oracle(index, colour, ptype, alive, d)[int(rows)]
                      for d in (np.float32, np.float64))
    got = got.numpy()
    if not rows:
        got, want32, want64 = got.T, want32.T, want64.T
    np.testing.assert_array_equal(got, want32)
    np.testing.assert_array_equal(got[4], want64[4])
    adds = want64[4] + (27 if rows else 0)
    np.testing.assert_array_less(np.abs(got[:4] - want64[:4]),
                                 adds * 2.0 ** -24 * want64[:4] + 1e-30)


@pytest.mark.parametrize("variant", VARIANTS)
def test_diffuse_cells_matches_pallas(frame, variant, monkeypatch):
    fr, dyn, pallas = frame["fr"], frame["dyn"], frame["pallas"]
    colour, ptype, alive = rows_of(fr, variant)
    cells, member = decode_key(fr.index.key, frame["spec"].grid)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    # keep the Pallas kernel's raw output (its count is row 4) from the one
    # interpreted call of the wrapper
    raw = []
    kernel = pallas._diffuse
    monkeypatch.setattr(pallas, "_diffuse", lambda *a: raw.append(kernel(*a)) or raw[-1])
    want = np.asarray(pallas.diffuse(
        frame["wins"], j(colour), tuple(j(c) for c in cells), j(member.float()), j(ptype),
        j(alive), j(dyn["dt"])))
    cnt_want = np.asarray(raw[0])[4]
    pack = dc.diffuse_cell_sums_plain(fr.index, colour, ptype, alive)
    sums = dc.neighbour_sums_plain(fr.index, pack)
    np.testing.assert_array_equal(sums[4].numpy(), cnt_want)
    assert cnt_want.max() > 1
    # the colour sums themselves: the mix scales an error in them by
    # dt / 750 * 1.33, so the colour check alone would not see one
    np.testing.assert_allclose(sums[:4].numpy(), np.asarray(raw[0])[:4], rtol=1e-5, atol=0)

    got = dc.diffuse_cells_plain(fr.index, pack, colour, ptype, alive, dyn["dt"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    fluid = ((ptype == FLUID) & alive).numpy()
    assert np.abs(want - colour.numpy())[:, fluid].max() > 0


@pytest.mark.parametrize("variant", VARIANTS)
def test_cell_sums_match_oracle(frame, variant):
    fr = frame["fr"]
    colour, ptype, alive = rows_of(fr, variant)
    pack = dc.diffuse_cell_sums_plain(fr.index, colour, ptype, alive)
    assert pack.shape == (frame["spec"].grid.ncells, dc.PACK_WIDTH)
    assert_sums(pack[:, :5], fr.index, colour, ptype, alive, rows=False)
    assert torch.all(pack[:, 5:] == 0)
    sums = dc.neighbour_sums_plain(fr.index, pack)
    assert_sums(sums, fr.index, colour, ptype, alive, rows=True)
    if variant == "mixed":
        member = (fr.index.key < frame["spec"].grid.ncells).numpy()
        skipped = member & ~((ptype != OBSTACLE) & alive).numpy()
        assert skipped.sum() > 0  # obstacle and dead rows inside member runs


@pytest.mark.parametrize("variant", VARIANTS)
def test_diffuse_matches_rows_path(frame, variant):
    """`PbfPhases.diffuse` against row 3's path, `diffuse_rows`."""
    fr, dyn = frame["fr"], frame["dyn"]
    colour, ptype, alive = rows_of(fr, variant)
    phases = ph.PbfPhases(frame["spec"].h)
    got = phases.diffuse(fr.index, colour, ptype, alive, dyn["dt"])
    want = phases.diffuse_rows(fr.index, colour, ptype, alive, dyn["dt"])
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    want_mix = ph.mix_colour(
        colour, ph.diffuse_plain(fr.index, colour, ph.nonobstacle(ptype, alive)),
        ptype, alive, dyn["dt"])
    assert torch.equal(want, want_mix)
    pack = dc.diffuse_cell_sums_plain(fr.index, colour, ptype, alive)
    sums = dc.neighbour_sums_plain(fr.index, pack)
    rows = ph.diffuse_plain(fr.index, colour, ph.nonobstacle(ptype, alive))
    assert torch.equal(sums[4], rows[4])
    torch.testing.assert_close(sums[:4], rows[:4], rtol=1e-5, atol=0)
    assert all(v == 0 for v in phases.launches.values())


def synthetic_index(counts, extent):
    """A CellIndex with counts[(x, y, z)] rows in each listed cell, sorted by
    linear id, then non-member (key ncells) and dead (ncells + 1) rows."""
    grid = GridSpec(extent=extent, maxz=1 << 30, quirks=False)
    _, ny, nz = grid.dims
    per_cell = torch.zeros(grid.ncells, dtype=torch.int64)
    for (x, y, z), n in counts.items():
        per_cell[(x * ny + y) * nz + z] = n
    key = torch.repeat_interleave(torch.arange(grid.ncells), per_cell)
    key = torch.cat([key, torch.full((3,), grid.ncells), torch.full((2,), grid.ncells + 1)])
    table = torch.nn.functional.pad(torch.cumsum(per_cell, 0), (1, 0))
    return ph.CellIndex(grid, key.to(torch.int32), table.to(torch.int32))


# dims (4, 4, 5): members in all eight corners, on each face, in a z-face
# cell whose linear neighbour is the next column's bottom cell, and a 3x3x3
# block inside
FACES = {
    **{(x, y, z): 2 for x in (0, 3) for y in (0, 3) for z in (0, 4)},
    (0, 2, 2): 3, (3, 1, 2): 1, (2, 0, 3): 2, (1, 3, 1): 2, (2, 2, 0): 1, (1, 2, 4): 3,
    (1, 1, 4): 2, (1, 2, 0): 2,
    **{(x, y, z): 1 for x in (1, 2) for y in (1, 2) for z in (1, 2, 3)},
}


@pytest.mark.parametrize("variant", VARIANTS)
def test_faces_and_corners(variant):
    index = synthetic_index(FACES, (3, 3, 4))
    n = index.key.shape[0]
    rng = np.random.default_rng(7)
    colour = torch.from_numpy(rng.uniform(0.0, 1.0, (4, n)).astype(np.float32))
    ptype = torch.zeros(n, dtype=torch.int32)
    alive = index.key <= index.grid.ncells
    if variant == "mixed":
        ptype[torch.from_numpy(rng.random(n) < 0.2)] = OBSTACLE
        alive &= torch.from_numpy(rng.random(n) >= 0.1)
    key = index.key.long()
    member = key < index.grid.ncells
    # the case is live: member rows one linear id apart in cells that do
    # not touch (the z-wrap), and rows in a corner cell
    lin = key[member]
    cx, cy, cz = ph._decode(lin, index.grid)
    wrap = (lin[:, None] - lin[None, :] == 1) & ((cz[:, None] - cz[None, :]).abs() > 1)
    assert bool(wrap.any())

    pack = dc.diffuse_cell_sums_plain(index, colour, ptype, alive)
    assert_sums(pack[:, :5], index, colour, ptype, alive, rows=False)
    sums = dc.neighbour_sums_plain(index, pack)
    assert_sums(sums, index, colour, ptype, alive, rows=True)
    assert float(sums[4][~member].abs().max()) == 0
    rowwise = ph.diffuse_plain(index, colour, ph.nonobstacle(ptype, alive))
    assert torch.equal(sums[4], rowwise[4])
    torch.testing.assert_close(sums[:4], rowwise[:4], atol=0, rtol=1e-6)

    dt = torch.tensor(np.float32(0.0125))
    phases = ph.PbfPhases(0.1)
    got = phases.diffuse(index, colour, ptype, alive, dt)
    want = phases.diffuse_rows(index, colour, ptype, alive, dt)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    keep = ~(((ptype == FLUID) & alive) & member & (sums[4] > 0.5))
    assert torch.equal(got[:, keep], colour[:, keep])
    assert not torch.equal(got, colour)


def test_launchers_refuse_cpu_tensors():
    """The launchers never fall back to the plain versions."""
    index = synthetic_index({(1, 1, 1): 2}, (3, 3, 4))
    n = index.key.shape[0]
    colour = torch.zeros((4, n))
    ptype = torch.zeros(n, dtype=torch.int32)
    alive = torch.ones(n, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dc.diffuse_cell_sums_kernel(index, colour, ptype, alive)
    pack = torch.zeros((index.grid.ncells, dc.PACK_WIDTH))
    with pytest.raises(ValueError, match="CUDA tensors"):
        dc.diffuse_cells_kernel(index, pack, colour, ptype, alive, torch.tensor(0.01))
