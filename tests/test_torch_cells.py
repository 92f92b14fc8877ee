"""The main path's λ/Δp solve (`ops/cells.py`) and its staged walk
(`tools/cells_staged.py`) on the CPU.

The runs the staged kernels cut (`plan_runs`, their plain version) are
integers and
are held exactly: every member row lies in one run of its CTA, a run starts
exactly at a jump in cell id of a column (nz) or more, and each row's nine
sub-ranges, mapped through its CTA's staged union, are the candidate rows
of `ops/phases.py::neighbour_ranges`.  Synthetic cell indexes cover a
z-wrap, an empty column, a column longer than a CTA, a union larger than
the stage of shared memory and a CTA with more jumps than runs.

The plain versions `lambda_cells_plain`/`delta_cells_plain` and the staged
walk's `lambda_staged_plain`/`delta_staged_plain` are held to the
JAX package's `PallasPhases` in interpret mode on `test_torch_phases.py`'s
two scenes (λ atol 1e-6, rtol 1e-5 as `test_pallas_interpret.py` holds the
Pallas λ; pStar after one Δp and the clamp atol 1e-5 in simulation units),
and to the per-row plain versions with the wrappers' mask and clamp at the
same tolerances (fp32 sums blocked by pieces against unblocked ones).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbf_sph_tpu.models.jax_solver import JaxSolver, make_phase_objects
from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
from pbf_sph_tpu_torch.core.types import FLUID, Scene
from pbf_sph_tpu_torch.models.torch_solver import (
    TorchSolver,
    advect_and_sort,
    dyn_params_of,
)
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.ops.grid import GridSpec, decode_key
from pbf_sph_tpu_torch.tools import bench_cells as bc
from pbf_sph_tpu_torch.tools import cells_staged as cs

CASES = {
    "2cubes": (700, 2, 500.0),
    "sparse": (600, 2, 2500.0),
}


def synthetic_index(counts, extent=(3, 3, 9), capacity=None):
    """A CellIndex with counts[(x, y, z)] rows in each listed cell, sorted
    by linear id, and non-member rows (key ncells) to the capacity."""
    grid = GridSpec(extent=extent, maxz=1 << 30, quirks=False)
    _, ny, nz = grid.dims
    per_cell = torch.zeros(grid.ncells, dtype=torch.int64)
    for (x, y, z), n in counts.items():
        per_cell[(x * ny + y) * nz + z] = n
    key = torch.repeat_interleave(torch.arange(grid.ncells), per_cell)
    capacity = capacity or int(key.numel()) + 5
    key = torch.cat([key, torch.full((capacity - key.numel(),), grid.ncells)])
    table = torch.nn.functional.pad(torch.cumsum(per_cell, 0), (1, 0))
    return ph.CellIndex(grid, key.to(torch.int32), table.to(torch.int32))


def _column(x, y, zs, n):
    return {(x, y, z): n for z in zs}


SYNTHETIC = {
    # column (1, 1) filled to its top cell, (1, 2) from its bottom: the ids
    # run on across the column boundary, and so does a run
    "zwrap": (_column(1, 1, range(6, 10), 3) | _column(1, 2, range(0, 4), 3), 16),
    # column (1, 2) empty between two filled ones: a jump starts a run
    "empty_column": (_column(1, 1, range(2, 6), 2) | _column(1, 3, range(2, 6), 2), 16),
    # one column of 56 rows, longer than a CTA of 16, and a cell of 20 split
    "long_column": (_column(2, 2, range(0, 10), 4) | {(2, 2, 5): 20}, 16),
    # a 3^3 block of 100-row cells: a CTA in its centre stages 9 x 300 rows,
    # more than one stage of shared memory
    "over_cap": ({(x, y, z): 100 for x in (1, 2, 3) for y in (1, 2, 3) for z in (4, 5, 6)},
                 cs.ROWS),
    # two rows in the bottom cell of eight columns: every column a jump,
    # more runs than the cap, whose last run then spans the jumps
    "capped": ({(x, y, 0): 2 for x in (1, 2) for y in range(4)}, 16),
}


def check_plan(index, size):
    """Every exactness property of the runs, in integers."""
    runs = cs.plan_runs(index, size)
    n, ncells = index.key.shape[0], index.grid.ncells
    nctas = -(-n // size)
    nseg = cs.SUBRUNS * cs.SEGMENTS
    assert runs.seg.shape == (nctas, nseg) and runs.start.shape == (nctas, nseg + 1)
    assert runs.sub.shape == (n,)
    key = index.key.long()
    member = key < ncells
    nz = index.grid.dims[2]
    cta = torch.arange(n) // size
    # every member row in exactly one run (its CTA's run `sub`): within a CTA
    # the runs are consecutive ranges of rows, the first at row 0, and a run
    # starts exactly where the cell id jumps by a column or more, until the cap
    for b in range(nctas):
        rows = slice(b * size, min(n, (b + 1) * size))
        m = member[rows]
        if not bool(m.any()):
            assert runs.start[b, -1] == 0
            continue
        sub, k = runs.sub[rows][m], key[rows][m]
        jump = torch.cat([torch.zeros(1, dtype=torch.bool), (k[1:] - k[:-1]) >= nz])
        assert torch.equal(sub, torch.clamp(torch.cumsum(jump, 0), max=cs.SUBRUNS - 1))
        # the union holds a run's segments iff the run has rows
        for q in range(cs.SUBRUNS):
            seg = slice(q * cs.SEGMENTS, (q + 1) * cs.SEGMENTS)
            length = runs.start[b, seg.stop] - runs.start[b, seg.start]
            assert bool(length > 0) == bool((sub == q).any())
    assert bool((runs.start[:, 1:] >= runs.start[:, :-1]).all())
    assert not bool(runs.start[:, 0].any())

    staged, base = cs.staged_rows(runs)
    assert staged.numel() == int(runs.start[:, -1].sum())
    # the union is the segments end to end
    for b in range(nctas):
        for s in range(nseg):
            u0, u1 = int(runs.start[b, s]), int(runs.start[b, s + 1])
            got = staged[int(base[b]) + u0:int(base[b]) + u1]
            assert torch.equal(got, torch.arange(int(runs.seg[b, s]),
                                                 int(runs.seg[b, s]) + u1 - u0))
    # each row's sub-ranges, through the staged copy, are its candidate rows,
    # inside its own run's segments
    lo, hi = ph.neighbour_ranges(index)
    lo_u, hi_u = cs.run_ranges(index, runs)
    assert torch.equal(hi_u - lo_u, hi - lo)
    for s in range(9):
        col = runs.sub * cs.SEGMENTS + s
        inside = (lo_u[s] >= runs.start[cta, col]) & (hi_u[s] <= runs.start[cta, col + 1])
        assert bool(inside[member].all())
        width = int((hi[s] - lo[s]).max())
        steps = torch.arange(width)
        valid = steps < (hi[s] - lo[s])[:, None]
        slot = torch.where(valid, base[cta][:, None] + lo_u[s][:, None] + steps, 0)
        want = lo[s][:, None] + steps
        assert torch.equal(torch.where(valid, staged[slot], -1), torch.where(valid, want, -1))
    return runs


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_plan_on_synthetic_cells(name):
    counts, size = SYNTHETIC[name]
    index = synthetic_index(counts)
    runs = check_plan(index, size)
    stats = cs.plan_stats(runs)
    _, ny, nz = index.grid.dims
    key = index.key.long()
    member = key < index.grid.ncells
    run = (torch.arange(key.shape[0]) // size) * cs.SUBRUNS + runs.sub
    cols = [(key[member & (run == r)] // nz).unique().tolist() for r in run[member].unique()]
    if name == "zwrap":
        # one run holds the top of (1, 1) and the bottom of (1, 2)
        assert [1 * ny + 1, 1 * ny + 2] in cols
    if name == "empty_column":
        # no run holds rows of both filled columns
        assert all(len(c) == 1 for c in cols) and len(cols) == 2
    if name == "long_column":
        assert stats["ctas"] == -(-key.shape[0] // size) and stats["runs"] == -(-56 // size)
    if name == "over_cap":
        assert stats["over_cap"] >= 1 and stats["union_max"] > cs.STAGE
    if name == "capped":
        assert stats["ctas_at_cap"] >= 1


def test_plan_splits_a_cell_with_one_union():
    """A cell of more rows than a CTA is split over CTAs with the same union."""
    index = synthetic_index({(2, 2, 5): 40, (2, 2, 4): 3, (2, 3, 5): 2}, capacity=64)
    runs = check_plan(index, 8)
    cell = (2 * 4 + 2) * 10 + 5
    inner = [b for b in range(runs.seg.shape[0])
             if bool((index.key[b * 8:(b + 1) * 8] == cell).all())]
    assert len(inner) >= 3
    for b in inner[1:]:
        assert torch.equal(runs.seg[b, :9], runs.seg[inner[0], :9])
        assert torch.equal(runs.start[b], runs.start[inner[0]])


@pytest.fixture(scope="module", params=sorted(CASES))
def frame(request):
    mc, cfg, xs = simple_config_with_2_cubes(*CASES[request.param])
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, device="cpu")
    fr = advect_and_sort(spec, state, dyn, scn)

    jspec = JaxSolver(h=cfg.h, use_pallas=True).make_spec(cfg, Scene(), spec.capacity)
    pallas, _ = make_phase_objects(jspec, use_pallas=True)
    wins, ovf = pallas.plan_frame(jnp.asarray(fr.index.key.numpy()),
                                  jnp.asarray(fr.index.table.numpy()))
    assert int(ovf) == 0
    st = fr.state
    cells_, member = decode_key(fr.index.key, spec.grid)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jargs = dict(memberf=j(member.float()), ptype=j(st.ptype), alive=j(st.alive),
                 cells=tuple(j(c) for c in cells_), pstar=j(fr.pstar), mass=j(st.mass))
    return dict(spec=spec, dyn=dyn, fr=fr, pallas=pallas, wins=wins, j=jargs,
                fluid=(st.ptype == FLUID) & st.alive,
                scale=torch.tensor(spec.scale, dtype=torch.float32),
                pack_a=torch.stack([fr.pstar[0], fr.pstar[1], fr.pstar[2], st.mass], dim=1))


@pytest.mark.parametrize("size", [cs.ROWS, 16])
def test_real_plans_are_exact(frame, size):
    check_plan(frame["fr"].index, size)


def _pallas_lambda(frame):
    ja = frame["j"]
    return frame["pallas"].lambda_phase(frame["wins"], ja["pstar"], ja["mass"], ja["memberf"],
                                        ja["ptype"], ja["alive"], ja["cells"])


@pytest.mark.parametrize("staged", [False, True])
def test_lambda_cells_matches_pallas(frame, staged):
    fr = frame["fr"]
    pack_b = torch.empty_like(frame["pack_a"])
    bc.WALKS[staged][2](fr.index, frame["spec"].h, frame["pack_a"], frame["fluid"], pack_b)
    want = np.asarray(_pallas_lambda(frame))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(pack_b[:, 3].numpy(), want, atol=1e-6, rtol=1e-5)
    assert torch.equal(pack_b[:, :3], frame["pack_a"][:, :3])


@pytest.mark.parametrize("staged", [False, True])
def test_delta_cells_matches_pallas(frame, staged):
    fr, dyn, ja, spec = frame["fr"], frame["dyn"], frame["j"], frame["spec"]
    lam = _pallas_lambda(frame)
    want = np.asarray(frame["pallas"].delta_phase(
        frame["wins"], ja["pstar"], lam, ja["memberf"], ja["ptype"], ja["alive"],
        jnp.float32(spec.scale), jnp.asarray(dyn["min_bound"].numpy()),
        jnp.asarray(dyn["max_bound"].numpy()), ja["cells"]))
    pack_b = frame["pack_a"].clone()
    pack_b[:, 3] = torch.from_numpy(np.array(lam))
    pack_a = frame["pack_a"].clone()
    bc.WALKS[staged][3](fr.index, spec.h, pack_b, frame["fluid"], frame["scale"],
                        dyn["min_bound"], dyn["max_bound"], pack_a)
    assert np.abs(want - fr.pstar.numpy()).max() > 0
    np.testing.assert_allclose(pack_a[:, :3].T.numpy(), want, atol=1e-5, rtol=0)
    assert torch.equal(pack_a[:, 3], fr.state.mass)


@pytest.mark.parametrize("staged", [False, True])
def test_cells_match_per_row_plain_with_glue(frame, staged):
    fr, dyn, spec = frame["fr"], frame["dyn"], frame["spec"]
    st, h = fr.state, spec.h
    pack_b = torch.empty_like(frame["pack_a"])
    bc.WALKS[staged][2](fr.index, h, frame["pack_a"], frame["fluid"], pack_b)
    lam = torch.where(frame["fluid"], ph.lambda_plain(fr.index, h, fr.pstar, st.mass), 0.0)
    torch.testing.assert_close(pack_b[:, 3], lam, atol=1e-6, rtol=1e-5)
    pack_a = frame["pack_a"].clone()
    bounds = (frame["scale"], dyn["min_bound"], dyn["max_bound"])
    bc.WALKS[staged][3](fr.index, h, pack_b, frame["fluid"], *bounds, pack_a)
    moved = ph.clamp_to_bounds(fr.pstar, ph.delta_plain(fr.index, h, fr.pstar, pack_b[:, 3]),
                               st.ptype, st.alive, *bounds)
    torch.testing.assert_close(pack_a[:, :3].T, moved, atol=1e-5, rtol=0)


def test_walks_agree_bit_for_bit(frame):
    """The staged walk finds the direct walk's candidates, in its order,
    through the plan: the plain versions of both give the same bits."""
    fr, dyn, spec = frame["fr"], frame["dyn"], frame["spec"]
    bounds = (frame["scale"], dyn["min_bound"], dyn["max_bound"])
    out = []
    for staged in (False, True):
        pack_b = torch.empty_like(frame["pack_a"])
        bc.WALKS[staged][2](fr.index, spec.h, frame["pack_a"], frame["fluid"], pack_b)
        pack_a = frame["pack_a"].clone()
        bc.WALKS[staged][3](fr.index, spec.h, pack_b, frame["fluid"], *bounds, pack_a)
        out.append((pack_b, pack_a))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


@pytest.mark.parametrize("staged", [False, True])
def test_solve_matches_phase_by_phase(frame, staged):
    """`PbfPhases.solve` on its packs, or the same rounds through the staged
    walk's wrappers (`cells_staged.StagedCells`), against the per-row
    wrappers; no kernel launch on the CPU.  Two rounds on the 2-cube scene,
    one on the over-compressed sparse one, where a second round amplifies the
    fp32 sum-order difference of the first chaotically
    (`test_pallas_interpret.py` keeps its chained checks out of such scenes
    for the same reason)."""
    fr, dyn, spec = frame["fr"], frame["dyn"], frame["spec"]
    st = fr.state
    rounds = 1 if spec.grid.dims == (9, 9, 9) else 2
    bounds = (frame["scale"], dyn["min_bound"], dyn["max_bound"])
    phases = ph.PbfPhases(spec.h)
    if staged:
        wrappers = cs.StagedCells(spec.h)
        pack_a, pack_b = frame["pack_a"].clone(), torch.empty_like(frame["pack_a"])
        for _ in range(rounds):
            wrappers.lambda_cells(fr.index, pack_a, frame["fluid"], pack_b)
            wrappers.delta_cells(fr.index, pack_b, frame["fluid"], *bounds, pack_a)
        got = pack_a[:, :3].T
        assert torch.equal(pack_a[:, 3], st.mass)
        assert wrappers.launches == {"lambda_cells_staged": 0, "delta_cells_staged": 0}
    else:
        marks = []
        got = phases.solve(fr.index, fr.pstar, st.mass, st.ptype, st.alive, rounds, *bounds,
                           marks.append)
        assert marks == ["packs"] + ["lambda", "delta"] * rounds
    want = fr.pstar
    for _ in range(rounds):
        lam = phases.lambda_phase(fr.index, want, st.mass, st.ptype, st.alive)
        want = phases.delta_phase(fr.index, want, lam, st.ptype, st.alive, *bounds)
    assert got.shape == (3, spec.capacity)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert all(v == 0 for v in phases.launches.values())


def test_cells_launchers_refuse_cpu_tensors(frame):
    """A launcher never falls back to the plain version, either walk's."""
    fr, dyn, spec = frame["fr"], frame["dyn"], frame["spec"]
    pack_b = torch.empty_like(frame["pack_a"])
    for lam_kernel, delta_kernel, _, _ in bc.WALKS.values():
        with pytest.raises(ValueError, match="CUDA tensors"):
            lam_kernel(fr.index, spec.h, frame["pack_a"], frame["fluid"], pack_b)
        with pytest.raises(ValueError, match="CUDA tensors"):
            delta_kernel(fr.index, spec.h, pack_b, frame["fluid"], frame["scale"],
                         dyn["min_bound"], dyn["max_bound"], frame["pack_a"])


def test_staged_sizes_match_the_source():
    """The staged walk's plain version cuts runs and pieces with the sizes
    that csrc/cells_staged.cu compiles by default."""
    assert cs.source_sizes() == (cs.ROWS, cs.STAGE, cs.SUBRUNS)


def _listing(name, loop, after=()):
    """A `cuobjdump -sass` listing of one kernel with one loop."""
    lines, addr = [f"\t\tFunction : {name}"], 0
    for op in ("S2R", *loop, "@P0 BRA 0x10", *after, "EXIT"):
        lines.append(f"        /*{addr:04x}*/                   {op} ;")
        addr += 0x10
    return "\n".join(lines)


PAIR = ["FADD", "FADD", "FADD", "FMUL", "FFMA", "FFMA", "FADD", "FMNMX", "FMUL", "FFMA",
        "FMNMX", "MUFU.RSQ", "FFMA", "FMNMX", "FMUL", "FMUL", "FFMA", "FFMA", "FFMA"]
GUARDED = PAIR[:11] + ["FSETP.GEU.AND P1, PT, R2, 1.1754943508222875079e-38, PT",
                       "FSEL", "FMUL", "MUFU.RSQ", "@!P1 FMUL"] + PAIR[12:]


@pytest.mark.parametrize("fault", [None, "other", "local", "guard"])
def test_sass_check_of_the_cells_kernels(fault):
    """bench_cells.check_funcs on synthetic listings: each walk's pair loop is
    the per-row one without rsqrtf's guard, with one float4 read a pair from
    device memory (direct) or shared memory (staged) and none of the other."""
    prefix = "_ZN12_GLOBAL__N_1"
    body = GUARDED if fault == "guard" else PAIR
    listings = [_listing(f"{prefix}{name}", ["LDG.E.128"] + GUARDED)
                for name in bc.ar.PHASE_KERNELS.values()]
    for walks, _ in bc.KERNELS.values():
        for suffix, new in walks.items():
            read, other = ("LDS.128", "LDG.E") if suffix else ("LDG.E.128.CONSTANT", "LDS")
            loop = [read] + body + ([other] if fault == "other" else [])
            after = ("STL [R1], R2",) if fault == "local" else ()
            listings.append(_listing(f"{prefix}{new}EPK6float4", loop, after))
    report = bc.check_funcs(bc.ar.parse_sass("\n".join(listings)))
    assert set(report) == {"pbf_lambda_cells", "pbf_delta_cells", "pbf_lambda_cells_staged",
                           "pbf_delta_cells_staged"}
    for r in report.values():
        assert r["ok"] is (fault is None)
        assert r["per_row_fp32_per_pair"] == len(GUARDED) - 1
    if fault is None:
        assert report["pbf_lambda_cells"]["fp32_per_pair"] == 18
