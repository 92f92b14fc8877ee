"""The port stands alone: no jax, no JAX package, no hidden device choice."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pbf_sph_tpu_torch.core.configs import dam_break
from pbf_sph_tpu_torch.core.types import Scene
from pbf_sph_tpu_torch import bench
from pbf_sph_tpu_torch.models import BACKENDS, DEVICE_BACKENDS, make_solver
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, dyn_params_of
from pbf_sph_tpu_torch.ops import mc_field as mf
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.ops import tiles as tl
from pbf_sph_tpu_torch.parallel import dryrun, sharded2d
from pbf_sph_tpu_torch.parallel.comm import run_ranks
from pbf_sph_tpu_torch.tools import anchor_rate as ar
from pbf_sph_tpu_torch.tools import bench_phases
from pbf_sph_tpu_torch.tools import micro_chunk as mch
from pbf_sph_tpu_torch.tools import micro_dense as md
from pbf_sph_tpu_torch.tools import micro_loop as ml
from pbf_sph_tpu_torch.tools import micro_mc_field as mcb
from pbf_sph_tpu_torch.tools import micro_vpu as mv
from pbf_sph_tpu_torch.tools import micro_window as mw
from pbf_sph_tpu_torch.tools import phases2 as p2

REPO = Path(__file__).resolve().parent.parent

IMPORT_ALL = """
import importlib, pkgutil, sys
import pbf_sph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pbf_sph_tpu_torch.__path__, "pbf_sph_tpu_torch.")]
assert {"pbf_sph_tpu_torch.tools.phases2", "pbf_sph_tpu_torch.tools.bench_phases",
        "pbf_sph_tpu_torch.tools.anchor_rate",
        "pbf_sph_tpu_torch.tools.micro_window",
        "pbf_sph_tpu_torch.tools.micro_mc_field",
        "pbf_sph_tpu_torch.tools.micro_chunk",
        "pbf_sph_tpu_torch.tools.micro_loop",
        "pbf_sph_tpu_torch.tools.micro_dense",
        "pbf_sph_tpu_torch.tools.micro_roll",
        "pbf_sph_tpu_torch.tools.micro_vpu",
        "pbf_sph_tpu_torch.tools.bench_cells",
        "pbf_sph_tpu_torch.tools.cells_staged",
        "pbf_sph_tpu_torch.cli", "pbf_sph_tpu_torch.utils.stopwatch",
        "pbf_sph_tpu_torch.utils.export", "pbf_sph_tpu_torch.utils.render",
        "pbf_sph_tpu_torch.visualise", "pbf_sph_tpu_torch.parallel",
        "pbf_sph_tpu_torch.parallel.comm", "pbf_sph_tpu_torch.parallel.sharded",
        "pbf_sph_tpu_torch.parallel.sharded2d", "pbf_sph_tpu_torch.parallel.dryrun",
        "pbf_sph_tpu_torch.tools.study", "pbf_sph_tpu_torch.tools.bench_mc_split",
        "pbf_sph_tpu_torch.tools.micro_extract", "pbf_sph_tpu_torch.tools.roofline",
        "pbf_sph_tpu_torch.tools.precision_centered",
        "pbf_sph_tpu_torch.tools.load_balance",
        "pbf_sph_tpu_torch.tools.multichip_model",
        "pbf_sph_tpu_torch.models.numpy_solver", "pbf_sph_tpu_torch.models.cpp_solver",
        "pbf_sph_tpu_torch.native.build", "pbf_sph_tpu_torch.tools.analyze_wcap",
        "pbf_sph_tpu_torch.tools.micro_plan",
        "pbf_sph_tpu_torch.tools.analyze_mc_windows"} <= set(names)
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pbf_sph_tpu"))
assert not bad, bad
from pbf_sph_tpu_torch.ops import cuda_build
assert cuda_build.library.cache_info().currsize == 0  # nothing built at import
print(len(names))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the tier runs several test
    processes at once, and torch's default pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 55  # every module of the package


def test_cuda_solver_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSolver(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_solver("torch", device="cuda")


def test_default_device_is_cuda(monkeypatch):
    """Without a device the solver, the engines' ThreadComm ranks and a
    rank's state ask for CUDA, and without a card they raise; nothing picks
    the CPU by itself.  The host oracles are the other backends: they take
    no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSolver()
    for impl in DEVICE_BACKENDS:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_solver(impl)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_solver("gather", dtype="float64")
    # the engines' entries: ThreadComm ranks and a rank's state, slab or tile
    with pytest.raises(RuntimeError, match="CUDA"):
        run_ranks(1, lambda comm: comm.rank)
    mc, cfg, xs = dam_break(1200, solver_iter=2)
    spec = sharded2d.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h)
    whole = sharded2d.distribute_particles_2d(xs, spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded2d.local_state(whole, 0, spec)
    assert run_ranks(1, lambda comm: comm.rank, "cpu") == [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert TorchSolver().device == torch.device("cuda")
    assert make_solver("gather").device == torch.device("cuda")
    assert DEVICE_BACKENDS == ("torch", "gather")
    assert BACKENDS == ("torch", "gather", "cpp", "numpy")


@pytest.mark.parametrize("env", [{}, {"PBF_BENCH_IMPL": "gather"},
                                 {"PBF_BENCH_IMPL": "gather", "PBF_BENCH_FP64": "1"}])
def test_bench_needs_a_card(monkeypatch, env):
    """bench.py runs on the card or fails, for either backend."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PBF_BENCH_COUNT", "1000")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()


def test_bench_refuses_fp64_on_torch(monkeypatch):
    monkeypatch.setenv("PBF_BENCH_COUNT", "1000")
    monkeypatch.setenv("PBF_BENCH_FP64", "1")
    with pytest.raises(ValueError, match="FP64 is not supported for the torch backend"):
        bench.main()


def test_cpu_run_launches_no_kernel():
    mc, cfg, xs = dam_break(2000, solver_iter=2)
    solver = TorchSolver(h=cfg.h, device="cpu")
    _, out = solver.advance(cfg, Scene(), xs)
    assert len(out) == len(xs)
    assert solver.phases.launches == {"diffuse": 0, "diffuse_cell_sums": 0,
                                      "diffuse_cells": 0, "lambda": 0, "delta": 0,
                                      "lambda_cells": 0, "delta_cells": 0}


def test_kernel_launchers_refuse_cpu_tensors():
    """A launcher never falls back to the plain version."""
    mc, cfg, xs = dam_break(2000, solver_iter=2, surface=True)
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    index = ph.CellIndex(spec.grid, torch.zeros(spec.capacity, dtype=torch.int32),
                         torch.zeros(spec.grid.ncells + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ph.lambda_kernel(index, spec.h, state.position, state.mass)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ph.delta_kernel(index, spec.h, state.position, state.mass)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ph.diffuse_kernel(index, state.colour, state.mass)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mf.mc_field_kernel(index, spec.surface, spec.h, spec.scale, state.position,
                           state.colour, state.mass, torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        mf.mc_field_cells_kernel(index, spec.surface, spec.h, spec.scale, state.position,
                                 state.colour, state.ptype, state.alive, torch.zeros(3),
                                 torch.zeros(()))
    with pytest.raises(ValueError, match="CUDA tensors"):
        mf.mc_field_cells_launch(index, spec.surface, spec.h, spec.scale, state.position,
                                 state.colour, state.ptype, state.alive, torch.zeros(3),
                                 torch.zeros(()), torch.empty((8, 1)))


def test_tile_launchers_refuse_cpu_tensors():
    """The tiled launchers never fall back to their plain versions either."""
    mc, cfg, xs = dam_break(2000, solver_iter=2)
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    index = ph.CellIndex(spec.grid, torch.zeros(spec.capacity, dtype=torch.int32),
                         torch.zeros(spec.grid.ncells + 1, dtype=torch.int32))
    tiles = tl.plan_tiles(index, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tl.lambda_tile_kernel(tiles, index, spec.h, state.position, state.mass, 32, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tl.delta_tile_kernel(tiles, index, spec.h, state.position, state.mass, 32, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tl.lambda_tile_cull_kernel(tiles, index, spec.h, state.position, state.mass, 32, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tl.delta_tile_cull_kernel(tiles, index, spec.h, state.position, state.mass, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tl.DenseTiles(spec.h, 32).lambda_raw(tiles, index, state.position, state.mass)


def test_phases2_launchers_refuse_cpu_tensors():
    """The v2 launchers never fall back to their plain versions."""
    mc, cfg, xs = dam_break(2000, solver_iter=2)
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    n = spec.capacity
    key = torch.sort(torch.randint(0, spec.grid.ncells, (n,), dtype=torch.int32)).values
    table = torch.searchsorted(key, torch.arange(spec.grid.ncells + 1, dtype=torch.int32),
                               out_int32=True)
    phases = p2.PbfPhases2(n, spec.grid, spec.h, n, 512)
    wins, _ = phases.plan_frame(key, table)
    slab = torch.zeros((4, n // p2.SUB * 512))
    with pytest.raises(ValueError, match="CUDA tensors"):
        p2.compact_kernel(wins, state.position)
    with pytest.raises(ValueError, match="CUDA tensors"):
        p2.lambda2_kernel(wins["nchunkp"], torch.zeros((n, 4)), slab, spec.h)
    with pytest.raises(ValueError, match="CUDA tensors"):
        p2.delta2_kernel(wins["nchunkp"], torch.zeros((n, 4)), slab, slab[:1], spec.h)
    with pytest.raises(ValueError, match="CUDA tensors"):
        p2.diffuse2_kernel(wins["nchunkp"], torch.zeros(n), slab, slab[:2], spec.grid.dims)
    member = torch.ones(n, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors"):
        p2.lambda2_cull_kernel(wins["nchunkp"], torch.zeros((n, 4)), slab, member, spec.h)
    with pytest.raises(ValueError, match="CUDA tensors"):
        p2.delta2_cull_kernel(wins["nchunkp"], torch.zeros((n, 4)), slab, slab[:1], member,
                              spec.h)
    with pytest.raises(ValueError, match="CUDA tensors"):
        p2.diffuse2_cull_kernel(wins["nchunkp"], torch.zeros(n), slab, slab[:2], member,
                                spec.grid.dims)
    assert phases.launches == {"compact": 0, "lambda2": 0, "delta2": 0, "diffuse2": 0}


def test_dense_phases2_refuses_cpu_tensors():
    """`DensePhases2`, the dense λ2/Δp2/diffuse2 kernels' counted wrapper, has
    no CPU path: a CPU tensor raises and counts no launch."""
    n = 64
    nchunkp = torch.full((n // p2.SUB,), 4, dtype=torch.int32)
    slab = torch.zeros((4, n // p2.SUB * 512))
    dense = p2.DensePhases2(0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dense.lambda_raw(nchunkp, torch.zeros((n, 4)), slab)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dense.delta_raw(nchunkp, torch.zeros((n, 4)), slab, slab[:1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        dense.diffuse_raw(nchunkp, torch.zeros(n), slab, slab[:2], (4, 4, 4))
    assert dense.launches == {"lambda2": 0, "delta2": 0, "diffuse2": 0}


def test_bench_phases_needs_a_card(monkeypatch):
    """The v2/v1 bench tool measures on the card or fails; it never times
    the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        bench_phases.main(["2000", "1"])


def test_surface_steps_on_cpu_without_launches():
    mc, cfg, xs = dam_break(4096, solver_iter=2, surface=True)
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    assert spec.surface is not None
    _, out = solver.step_device(spec, state, dyn_params_of(cfg, device="cpu"), scn)
    assert out["mesh_vs"].shape == (3, 3 * spec.surface.tri_capacity)
    assert 0 < int(out["tri_count"]) <= spec.surface.tri_capacity
    assert int(out["mc_emit_overflow"]) == int(out["mc_strip_overflow"]) == 0
    res, _ = solver.advance(cfg, Scene(), xs)
    assert len(res.mesh) > 0 and len(res.mesh) % 3 == 0
    assert solver.launches == {"diffuse": 0, "diffuse_cell_sums": 0, "diffuse_cells": 0,
                               "lambda": 0, "delta": 0, "lambda_cells": 0,
                               "delta_cells": 0, "mc_field_cells": 0, "mc_field": 0}


def test_anchor_launchers_refuse_cpu_tensors():
    """The rate anchor's launchers never fall back to their plain versions."""
    rows = torch.full((5, ar.ROWS), 0.05)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ar.issue_kernel(torch.ones(ar.TILE), "fma", 16, 16, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ar.body_kernel(torch.ones((5, ar.SUB)), torch.ones((4, 2 * ar.WCOL)), "lambda", 2, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ar.rowfix_kernel(rows, ar.rowfix_index(rows), 1)
    anchor = ar.Anchor()
    anchor.issue(torch.ones(ar.TILE), "max", 4, 4, 2)
    assert anchor.launches == dict.fromkeys(ar.KERNELS, 0)


def test_anchor_rate_needs_a_card(monkeypatch):
    """The rate anchor measures on the card or fails; it never times the
    plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        ar.main(["1"])


def test_window_launchers_refuse_cpu_tensors():
    """The window micro-benchmark's launchers never fall back to their plain
    versions."""
    for width in mw.WIDTHS:
        x = mw.random_inputs(0, width)
        for body in mw.BODIES:
            with pytest.raises(ValueError, match="CUDA tensors"):
                mw.run_kernel(body, x, 1)
    win = mw.MicroWindow()
    win.run("flat_fused", mw.tool_inputs(), 1)
    assert win.launches == dict.fromkeys(mw.KERNELS, 0)


def test_micro_window_needs_a_card(monkeypatch):
    """The window micro-benchmark measures on the card or fails; it never
    times the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        mw.main(["1"])


def test_mc_bisect_launchers_refuse_cpu_tensors():
    """The MC-field bisection's launchers never fall back to their plain
    versions; its wrappers take them for CPU tensors and launch nothing."""
    mc, cfg, xs = dam_break(2000, solver_iter=2, surface=True)
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    index = ph.CellIndex(spec.grid, torch.zeros(spec.capacity, dtype=torch.int32),
                         torch.zeros(spec.grid.ncells + 1, dtype=torch.int32))
    args = (index, spec.surface, spec.h, spec.scale, state.position, state.colour,
            state.mass, torch.zeros(3))
    for body in mcb.BODIES:
        with pytest.raises(ValueError, match="CUDA tensors"):
            mcb.LAUNCHERS[body](*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mf.mc_field_launch("mc_field_loops", *args[:4], state.position.t().contiguous(),
                           state.colour.t().contiguous(), args[-1], torch.empty(0))
    bisect = mcb.McFieldBisect(spec.h)
    assert not bisect("noop", *args[:2], *args[3:]).any()
    assert bisect.launches == dict.fromkeys(mcb.KERNELS, 0)



def test_mc_field_reports_row4_launches_since_reset(monkeypatch):
    """Row 4's launcher counts a launch of `mc_field` only where it launches
    (a CPU tensor raises first), and McField reports row 4's count since its
    last reset beside its own, so a path that reached row 4 would show."""
    monkeypatch.setitem(mf.ROW4_LAUNCHES, "mc_field", 5)
    mc, cfg, xs = dam_break(2000, solver_iter=2, surface=True)
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    index = ph.CellIndex(spec.grid, torch.zeros(spec.capacity, dtype=torch.int32),
                         torch.zeros(spec.grid.ncells + 1, dtype=torch.int32))
    assert solver.launches["mc_field"] == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        mf.mc_field_launch("mc_field", index, spec.surface, spec.h, spec.scale,
                           state.position.t().contiguous(), state.colour.t().contiguous(),
                           torch.zeros(3), torch.empty(0))
    assert mf.ROW4_LAUNCHES["mc_field"] == 5 and solver.launches["mc_field"] == 0
    mf.ROW4_LAUNCHES["mc_field"] += 2
    assert solver.launches["mc_field"] == 2
    assert solver.mc_field.launches == {"mc_field_cells": 0, "mc_field": 2}
    solver.reset_launches()
    assert solver.mc_field.launches == {"mc_field_cells": 0, "mc_field": 0}

def test_micro_mc_field_needs_a_card(monkeypatch):
    """The MC-field bisection measures on the card or fails; it never times
    the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        mcb.main(["mc128k", "1"])


def test_chunk_launchers_refuse_cpu_tensors():
    """The pair-chunk micro-benchmark's launchers never fall back to their
    plain versions; its wrappers take them for CPU tensors and launch
    nothing."""
    s, rows, x = mch.tool_inputs()
    for body in mch.BODIES:
        with pytest.raises(ValueError, match="CUDA tensors"):
            mch.chunk_kernel(s, rows, body, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mch.fma_kernel(x, 4, 8)
    wrappers = mch.MicroChunk()
    assert not wrappers.chunk(s, rows, "old", 4, 8).any()
    wrappers.fma(x, 2, 3)
    assert wrappers.launches == dict.fromkeys(mch.KERNELS, 0)


def test_micro_chunk_needs_a_card(monkeypatch):
    """The pair-chunk micro-benchmark measures on the card or fails; it
    never times the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        mch.main(["1"])


def test_loop_launchers_refuse_cpu_tensors():
    """The loop probes' launchers never fall back to their plain versions;
    the wrapper takes them for CPU tensors and launches nothing."""
    xs = ml.tool_inputs()
    for label, body in ml.BODIES.items():
        with pytest.raises(ValueError, match="CUDA tensors"):
            ml.run_kernel(label, xs[body.tile], 2)
    wrappers = ml.MicroLoop()
    for label, body in ml.BODIES.items():
        assert wrappers.run(label, xs[body.tile], 2).shape == body.tile
    assert wrappers.launches == dict.fromkeys(ml.KERNELS, 0)


def test_micro_loop_needs_a_card(monkeypatch):
    """The loop probes measure on the card or fail; they never time the
    plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        ml.main(["1"])


def test_dense_launchers_refuse_cpu_tensors():
    """The dense-λ micro-benchmark's launchers never fall back to their
    plain versions; the wrapper takes them for CPU tensors and launches
    nothing."""
    x = md.tool_inputs()
    for label in md.BODIES:
        with pytest.raises(ValueError, match="CUDA tensors"):
            md.run_kernel(label, x)
    wrappers = md.MicroDense()
    small = md.tool_inputs(2, 4)
    for label in md.BODIES:
        assert wrappers.run(label, small, 2).shape == (2, 2, md.SUB, 4)
    assert wrappers.launches == dict.fromkeys(md.KERNELS, 0)


def test_micro_dense_needs_a_card(monkeypatch):
    """The dense-λ micro-benchmark measures on the card or fails; it never
    times the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        md.main(["1"])


def test_vpu_launchers_refuse_cpu_tensors():
    """The op-stream, dot and reshape launchers never fall back to their
    plain versions; the wrapper takes them for CPU tensors and launches
    nothing."""
    x = mv.tool_inputs(rows=8)
    for launch in (lambda: mv.streams_kernel(x.x, "fma", 1, 2),
                   lambda: mv.dot_kernel(x.a, x.b, 2), lambda: mv.dot2_kernel(x.a2, x.b2, 2),
                   lambda: mv.tr_kernel(x.t, "direct", 2), lambda: mv.tr_kernel(x.t, "restage", 2)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch()
    wrappers = mv.MicroVpu()
    assert wrappers.streams(x.x, "div", 2, 2).shape == (8, 128)
    assert wrappers.dot(x.a, x.b, 2, 3).shape == (3, 64, 8)
    assert wrappers.dot2(x.a2, x.b2, 2).shape == (1, 64, 128)
    assert wrappers.tr(x.t, "restage", 2).shape == (1, 64, 1)
    assert wrappers.launches == dict.fromkeys(mv.KERNELS, 0)


def test_micro_vpu_needs_a_card(monkeypatch):
    """The op-stream, dot and reshape tool measures on the card or fails; it
    never times the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        mv.main(["1"])


@pytest.mark.parametrize("tool", ["bench_mc_split", "micro_extract", "roofline",
                                  "precision_centered", "load_balance", "multichip_model"])
def test_study_tools_need_a_card_unless_asked_for_cpu(monkeypatch, tool):
    """The study tools run on the card unless `--devices cpu` asks for the
    CPU; they never fall back to it."""
    import importlib

    module = importlib.import_module(f"pbf_sph_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        module.main([])


def test_dryrun_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(2)
