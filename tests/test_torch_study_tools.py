"""The port's study tools (`pbf_sph_tpu_torch/tools/`: roofline,
precision_centered, load_balance, multichip_model, micro_extract,
bench_mc_split) and the sharded dry run (`parallel/dryrun.py`) on the CPU,
against the JAX package's tools where those compute the same thing.

The JAX tools live in `tools/`, outside the package; each is loaded from
its file with its top-level `jax.config.update(...)` statements left out
(`tools/precision_centered.py` would switch the process to float64), and
the nested functions of `tools/load_balance.py`'s `main` are compiled on
their own, their free variables given.

* roofline: the census (candidate pairs rows 1b/2b walk) equal to a brute
  count from the cell table, cell by cell, on the sort-time frame of
  dam_break(1500, 2) and on its (2,2,1) and (2,2,2) supercells;
  `true_neighbours` equal to the JAX tool's on 256 rows of that frame.
* precision_centered: each variant's ρ and gradient against the JAX
  tool's on its scene and the near-coincident one, relative to the oracle's
  largest magnitude: ρ within 1e-6 for every variant, the per-pair
  gradients (A, B) within 1e-6, the factored ones (C, D) within 1e-3 (a Σsg
  against Σ b sg cancellation whose fp32 rounding follows the matmul's
  order: the JAX tool's own error there is 4.6e-4); the float64 oracles
  within 1e-15.
* load_balance: `col_hist`, `slab_fracs` and `rebalance_bounds` equal to
  the JAX tool's on seeded positions.
* multichip_model: the exchange census of one slab frame (D = 4) and one
  tile frame (2x2), 700 particles and 2 iterations, equal to the byte model (`exchange_bytes`,
  `exchanges_a_frame`); `slab_bytes` equal to the JAX tool's `ici_bytes`
  at its caps; `project` equal to the JAX tool's `project` (its census and
  byte model given the port's, the same rates, rest and link) at every N
  both run, to 1e-12 relative.
* analyze_wcap: the printed census at every gap split G equal to the JAX
  tool's on dam_break(1500)'s frame-0 cells.
* micro_plan: on the dam_break(1500, 2) frame its stages' pieces run in
  order, the gather-only stage gives the intervals the sort then orders,
  and the chunk stage gives `plan_compact`'s wins (by construction: the
  plan composes the same stages).
* analyze_mc_windows: its node-candidate pairs equal a brute count of the
  members in each node's 27 cells on a 2-cube surface frame, node by node.
* `dryrun_multichip(4)` on the CPU: every overflow 0, a mesh, the alive
  count equal to the particles gathered from the ranks and to the
  single-chip solver's after the same frame and scene.
* every tool's `main` at a small size on the CPU, its last line JSON.

torch runs on one intra-op thread in this module.
"""

import ast
import collections
import dataclasses
import functools
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.scene import simple_config_with_2_cubes
from pbf_sph_tpu_torch.core.types import Scene
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, advect_and_sort, dyn_params_of
from pbf_sph_tpu_torch.parallel import dryrun
from pbf_sph_tpu_torch.tools import (
    analyze_mc_windows,
    analyze_wcap,
    bench_mc_split,
    load_balance,
    micro_extract,
    micro_plan,
    multichip_model,
    precision_centered,
    roofline,
    study,
)
from pbf_sph_tpu_torch.tools import phases2 as p2

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


def _is_config_update(node) -> bool:
    return (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)
            and ast.unparse(node.value.func) == "jax.config.update")


@functools.lru_cache(maxsize=None)
def jax_tool(name: str) -> types.ModuleType:
    """tools/<name>.py loaded without its top-level jax.config.update calls."""
    path = REPO / "tools" / f"{name}.py"
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body if not _is_config_update(n)]
    module = types.ModuleType(f"{name}_reference")
    module.__file__ = str(path)
    exec(compile(tree, str(path), "exec"), module.__dict__)
    return module


def jax_nested(name: str, func: str, **free):
    """The function `func` defined inside tools/<name>.py's `main`, compiled
    on its own with its free variables `free`."""
    path = REPO / "tools" / f"{name}.py"
    main = next(n for n in ast.parse(path.read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    node = next(n for n in ast.walk(main) if isinstance(n, ast.FunctionDef) and n.name == func)
    ns = dict(np=np, jax=jax, jnp=jnp, **free)
    exec(compile(ast.Module(body=[node], type_ignores=[]), str(path), "exec"), ns)
    return ns[func], ns


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def frame():
    """(spec, sort-time frame) of dam_break(1500, 2) on the CPU."""
    _, cfg, xs = dam_break(1500, solver_iter=2)
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    return spec, advect_and_sort(spec, state, dyn_params_of(cfg, device="cpu"), scn)


def brute_pairs(key: np.ndarray, table: np.ndarray, dims) -> np.ndarray:
    """Per member row, the members of every cell lin + dx*ny*nz + dy*nz + dz
    inside [0, ncells) (the walk's linear ranges), cell by cell."""
    _, ny, nz = dims
    ncells = int(np.prod(dims))
    counts = np.diff(table)
    lin = key[key < ncells].astype(np.int64)
    total = np.zeros(len(lin), np.int64)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                c = lin + dx * ny * nz + dy * nz + dz
                ok = (c >= 0) & (c < ncells)
                total += np.where(ok, counts[np.clip(c, 0, ncells - 1)], 0)
    return total


@pytest.mark.parametrize("div", [None, (2, 2, 1), (2, 2, 2)])
def test_census_matches_brute_count(div):
    spec, fr = frame()
    if div is None:
        key, table, dims = fr.index.key, fr.index.table, spec.grid.dims
    else:
        key, table, dims = roofline.supercell_index(fr.pstar, fr.state.alive, fr.min_extent,
                                                    spec.h, spec.grid.dims, div)
        assert int(table[-1]) == int(fr.state.alive.sum())
    got = roofline.row_pairs(key, table, dims).numpy()
    want = brute_pairs(key.numpy(), table.numpy(), dims)
    assert len(got) == int(table[int(np.prod(dims))]) > 1000
    np.testing.assert_array_equal(got, want)
    assert roofline.summary(torch.from_numpy(got))["pairs"] == int(want.sum())


def test_true_neighbours_match_jax():
    spec, fr = frame()
    members = int(fr.index.table[-1])
    got = roofline.true_neighbours(fr.pstar, members, spec.h, nsample=256)
    want = jax_tool("roofline").true_neighbours(fr.pstar.numpy(), members, spec.h,
                                                nsample=256)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 1  # each row counts itself


# ---------------------------------------------------------------------------
# precision_centered
# ---------------------------------------------------------------------------

PRECISION_CASES = [(v, s) for s in ("lattice", "near") for v in "ABCD"
                   if not (s == "near" and v == "D")]


@pytest.mark.parametrize("variant,scene", PRECISION_CASES)
def test_precision_variants_match_jax(variant, scene):
    tool = jax_tool("precision_centered")
    a, b = precision_centered.scene()
    if scene == "near":
        b = precision_centered.near_coincident(a, b)
    rho64, grad64 = tool.pair_oracle_f64(a, b)
    prho, pgrad = precision_centered.pair_oracle_f64(a, b)
    np.testing.assert_allclose(prho.numpy(), rho64, rtol=0, atol=1e-15)
    np.testing.assert_allclose(pgrad.numpy(), grad64, rtol=0, atol=1e-15)
    jax_fn = {"A": lambda: tool.variant_a(a, b),
              "B": lambda: tool.variant_bc(a, b, True, False),
              "C": lambda: tool.variant_bc(a, b, True, True),
              "D": lambda: tool.variant_bc(a, b, False, True)}[variant]
    name = next(k for k in precision_centered.VARIANTS if k.startswith(variant))
    a32, b32 = (torch.as_tensor(x, dtype=torch.float32) for x in (a, b))
    rho, grad = (t.double().numpy() for t in precision_centered.VARIANTS[name](a32, b32))
    jrho, jgrad = (np.asarray(t, np.float64) for t in jax_fn())
    rs, gs = np.abs(rho64).max(), np.abs(grad64).max()
    assert np.abs(rho - jrho).max() / rs <= 1e-6
    assert np.abs(grad - jgrad).max() / gs <= (1e-6 if variant in "AB" else 1e-3)


# ---------------------------------------------------------------------------
# load_balance
# ---------------------------------------------------------------------------


def test_slab_fractions_match_jax():
    rng = np.random.default_rng(5)
    _, cfg, _ = dam_break(20_000, solver_iter=6)
    scale, h, gx, n_dev = float(cfg.scale), float(cfg.h), 40, 8
    min_bound = np.asarray(cfg.min_bound, np.float32) + np.float32(rng.uniform(-90, 90))
    span = (gx - 4) * h * scale
    pos = np.stack([rng.uniform(min_bound[0] - 50, min_bound[0] + span, 6000),
                    rng.uniform(0, 500, 6000), rng.uniform(0, 500, 6000)]).astype(np.float32)
    alive = rng.uniform(size=6000) < 0.9
    col_hist, _ = jax_nested("load_balance", "col_hist", scale=scale, h=h, gx=gx)
    state = collections.namedtuple("State", "position alive")(jnp.asarray(pos),
                                                                jnp.asarray(alive))
    want = np.asarray(col_hist(state, {"min_bound": jnp.asarray(min_bound)}))
    got = load_balance.col_hist(torch.from_numpy(pos), torch.from_numpy(alive),
                                torch.tensor(min_bound[0]), scale, h, gx).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] > 0 and got.sum() == alive.sum()

    cdf = np.cumsum(got)
    slab_fracs, ns = jax_nested("load_balance", "slab_fracs", gx=gx, cdf=cdf)
    rebalance, _ = jax_nested("load_balance", "rebalance_bounds", n_dev=n_dev, gx=gx,
                              min_slab_w=3)
    fixed = np.minimum(np.arange(n_dev + 1, dtype=np.int64) * 5, gx)
    bounds = load_balance.initial_bounds(cdf, n_dev, gx)
    for _ in range(3):
        for b in (fixed, bounds):
            np.testing.assert_array_equal(load_balance.slab_fracs(b, cdf, gx), slab_fracs(b))
        new = load_balance.rebalance_bounds(bounds, got, n_dev, gx)
        np.testing.assert_array_equal(new, rebalance(bounds, got))
        bounds = new
        got = np.roll(got, 1)
        cdf = ns["cdf"] = np.cumsum(got)


# ---------------------------------------------------------------------------
# multichip_model
# ---------------------------------------------------------------------------


def test_exchange_census_matches_the_byte_model():
    census = multichip_model.exchange_census("cpu", count=700, iteration=2)
    assert set(census) == {"slabs D=4 (fixed)", "tiles 2x2 (rebalancing)"}
    for c in census.values():
        assert c["exchanges"] == c["model_exchanges"]
        assert c["exchange_bytes"] == c["model_bytes"] > 0
    assert census["slabs D=4 (fixed)"]["all_reduces"] == 0
    assert census["tiles 2x2 (rebalancing)"]["all_reduces"] == 1  # the x and y histograms
    tool = jax_tool("multichip_model")
    for count, n, gy, gz, reb in ((1_000_000, 4, 88, 88, True), (1_000_000, 16, 88, 88, True),
                                  (128_000, 2, 47, 47, False), (20_000, 8, 25, 25, True)):
        per_dir, caps = tool.ici_bytes(count, n, gy, gz, 6, reb)
        assert multichip_model.slab_bytes(caps["migrate_cap"], caps["ghost_cap"], 6) == per_dir


def synthetic_cells(seed=11, n=30_000, dims=(40, 20, 18)):
    """Seeded cells of a dam-like column: denser at low x and y."""
    rng = np.random.default_rng(seed)
    cx = np.minimum((rng.beta(1.3, 2.5, n) * dims[0]).astype(np.int64), dims[0] - 1)
    cy = np.minimum((rng.beta(1.0, 3.0, n) * dims[1]).astype(np.int64), dims[1] - 1)
    cz = rng.integers(0, dims[2], n)
    return cx, cy, cz, dims


def test_projection_matches_jax(monkeypatch):
    cx, cy, cz, dims = synthetic_cells()
    rates, rest, bw, lat, ncoll = (3.1e11, 2.4e11), 1.7e-3, 2.5e10, 3e-6, 102

    def per_dir_of(n):
        return multichip_model.slab_bytes(1000 + 37 * n, 4096, 6)

    def census_slab(lin_sorted, table, dims):
        return int(roofline.row_pairs(torch.from_numpy(lin_sorted), torch.from_numpy(table),
                                      dims).sum())

    tool = jax_tool("multichip_model")
    monkeypatch.setattr(tool, "RATE_LAMBDA", rates[0])
    monkeypatch.setattr(tool, "RATE_DELTA", rates[1])
    monkeypatch.setattr(tool, "T_LOCAL_1M", rest)
    monkeypatch.setattr(tool, "ICI_BW", bw)
    monkeypatch.setattr(tool, "ICI_LAT", lat)
    monkeypatch.setattr(tool, "census_slab", census_slab)
    monkeypatch.setattr(tool, "ici_bytes", lambda count, n, gy, gz: (per_dir_of(n), {}))
    want = tool.project(cx, cy, cz, dims, len(cx))
    got = multichip_model.project(cx, cy, cz, dims, len(cx), rates, rest, per_dir_of, bw,
                                  lat, ncoll)
    common = sorted(set(want) & set(got))
    assert common == [1, 2, 4, 8, 13]
    for n in common:
        np.testing.assert_allclose(got[n][:5], want[n], rtol=1e-12, atol=0, err_msg=str(n))


# ---------------------------------------------------------------------------
# analyze_wcap, micro_plan, analyze_mc_windows
# ---------------------------------------------------------------------------


def test_wcap_census_matches_jax(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["analyze_wcap.py", "1500"])
    jax_tool("analyze_wcap").main()
    want = [line for line in capsys.readouterr().out.splitlines() if line.startswith("G=")]
    assert analyze_wcap.main(["1500", "--devices", "cpu"]) == 0
    got = [line.split("  <-")[0] for line in capsys.readouterr().out.splitlines()
           if line.startswith("G=")]
    assert len(want) == len(analyze_wcap.SPLITS) and got == want


def test_micro_plan_stages():
    """The timed stages on the dam_break(1500, 2) frame: s1's pieces run in
    order over each sub-block's cells, s2a gives the intervals s2 orders, and
    s3 gives the whole plan's wins (`plan_compact` composes the same three
    stages, so that last holds by construction; the plan's own check is
    against JAX, in test_torch_phases2.py)."""
    spec, fr = frame()
    key, table = fr.index.key, fr.index.table
    calls = micro_plan.stages(key, table, spec.grid, spec.capacity)
    pieces = calls["s1 lin+topk+pieces"]()
    pmin, pmax = pieces["pmin"], pieces["pmax"]
    assert bool((pmin <= pmax).all()) and bool((pmax[:, :-1] <= pmin[:, 1:]).all())
    lin = torch.clamp(key.long(), max=spec.grid.ncells - 1)[: pmin.shape[0] * p2.SUB]
    assert int(pmax.max()) <= int(lin.max()) and int(pmin.min()) >= int(lin.min())
    lo, hi = calls["s2a gather only"]()
    slo, shi, strip_of = calls["s2 gather+sort"]()
    assert torch.equal(torch.sort(lo, dim=1).values, slo)
    assert torch.equal(torch.sort(hi, dim=1).values, torch.sort(shi, dim=1).values)
    assert bool((strip_of >= 0).all()) and bool((strip_of < 3).all())
    wins, _ = calls["s3 chains+scatter"]()
    whole, _ = calls["full plan_compact"]()
    assert all(torch.equal(wins[k], whole[k]) for k in whole)
    assert int(whole["nchunk"].sum()) > 0


def test_mc_windows_pairs_match_brute_count():
    _, spec, state, dyn, scn, _ = study.settled(study.workload_of("cubes:800"), "cpu", 1)
    fr = advect_and_sort(spec, state, dyn, scn)
    got = analyze_mc_windows.census(fr.index, spec.surface)
    # brute: per node, the members whose cell lies within one of the node's
    # cell on every axis
    from pbf_sph_tpu_torch.ops import mc_field as mf

    _, cell, skip = mf.lattice_nodes(spec.surface, spec.grid.extent, "cpu")
    _, ny, nz = spec.grid.dims
    key = fr.index.key.long()
    lin = key[key < spec.grid.ncells]
    pc = torch.stack([lin // (ny * nz), lin // nz % ny, lin % nz])     # (3, members)
    near = ((cell.long()[:, :, None] - pc[:, None, :]).abs() <= 1).all(0)
    per_node = (near.sum(1) * ~skip).numpy()
    assert got["nodes"]["pairs"] == int(per_node.sum()) > 0
    assert got["nodes"]["live"] == int((per_node > 0).sum())
    assert got["nodes"]["per_live"]["max"] == int(per_node.max())
    assert got["nodes"]["live"] + got["nodes"]["vacuum"] == got["nodes"]["nodes"]


# ---------------------------------------------------------------------------
# the dry run and the tools' mains
# ---------------------------------------------------------------------------


def test_dryrun_multichip_4_conserves_and_meshes():
    out = dryrun.dryrun_multichip(4, "cpu")
    for k in ("migrate_dropped", "migrate_deferred", "ghost_dropped", "spawn_dropped",
              "strip_overflow", "query_overflow", "mc_emit_overflow"):
        assert out[k] == 0, k
    assert out["extent_ok"] == 4 and out["tri_count"] > 0
    assert out["alive_count"] == out["gathered"]
    assert 0 < out["alive_count"] <= out["particles"] + out["spawned"]
    # the same frame and scene on the single-chip solver
    mc, cfg, xs = simple_config_with_2_cubes(800, 2, 500.0)
    cfg = cfg.replace(surface=dataclasses.replace(mc, resolution=1.0))
    _, single = TorchSolver(h=cfg.h, device="cpu").advance(cfg, dryrun.dryrun_scene(), xs)
    assert out["alive_count"] == len(single)
    assert out["spawned"] == 4 and out["particles"] == len(xs)


MAINS = {
    "analyze_mc_windows": (analyze_mc_windows, ["cubes:800", "1"], "nodes"),
    "analyze_wcap": (analyze_wcap, ["1500"], "census"),
    "bench_mc_split": (bench_mc_split, ["cubes:600", "1"], "ms"),
    "micro_extract": (micro_extract, ["cubes:800", "64"], "parity"),
    "micro_plan": (micro_plan, ["1500", "1"], "overflows"),
    "roofline": (roofline, ["600", "1"], "census"),
    "precision_centered": (precision_centered, [], "errors"),
    "load_balance": (load_balance, ["600", "4", "2"], "peak_frac"),
    "multichip_model": (multichip_model, ["600", "--census", "600", "1"], "slabs"),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_runs_on_cpu(name, capsys):
    module, argv, key = MAINS[name]
    assert module.main(argv + ["--devices", "cpu"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert key in last
    if name == "micro_extract":
        assert last["live_rows"] > 0
        assert all(p["max_diff"] == 0.0 for p in last["parity"].values())
    if name == "micro_plan":
        assert len(last["ms"]) == 5 and last["overflows"]["wcap_overflow"] == 0
