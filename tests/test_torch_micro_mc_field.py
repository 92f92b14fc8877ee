"""The port's MC-field bisection (`pbf_sph_tpu_torch/tools/micro_mc_field.py`)
against the JAX package's `tools/micro_mc_field.py`, on `test_torch_mc.py`'s
two field scenes.

The JAX tool lives in `tools/`, outside the package; it is loaded from its
file, and its `make_variant` gets the Pallas scaffolding in interpret mode
(`_phase_pallas` with interpret=True, set on the loaded module object: its
call passes no `interpret`, and the static unroll of 128 sub-blocks that
the TPU path takes would blow up the CPU compile).  Its inputs are built from
the port's frame as the tool's `inputs` builds them, with `plan_mc_windows`
and the `PallasMcField` of `make_phase_objects`; each variant's output is
computed once.  Its rows are cell-sorted nodes; `static["row_lat"]` puts
them back in lattice order.

* noop: both zero.  rows: bit for bit (the same fp32 adds and multiplies,
  each rounded).
* loops: the port walks each node's exact ranges; the Pallas body sums whole
  128-lane chunks of its sub-block's union windows, many more slots.  So the
  port's plain version is held to a float64 sum over `node_ranges`, and the
  interpreted JAX body to a float64 model of its lane set, both rtol 1e-5.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbf_sph_tpu.core.types as jtypes
from pbf_sph_tpu.models.jax_solver import JaxSolver, make_phase_objects
from pbf_sph_tpu.ops import pallas_pbf
from pbf_sph_tpu.ops.pallas_mc import plan_mc_windows
from pbf_sph_tpu_torch.core.configs import WORKLOADS
from pbf_sph_tpu_torch.core.types import OBSTACLE, Scene
from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, dyn_params_of, solve_frame
from pbf_sph_tpu_torch.ops import mc_field as mf
from pbf_sph_tpu_torch.ops.grid import decode_key
from pbf_sph_tpu_torch.tools import anchor_rate as ar
from pbf_sph_tpu_torch.tools import micro_mc_field as mcb
from test_torch_mc import FIELD_SCENES

REPO = Path(__file__).resolve().parent.parent
SCENES = sorted(FIELD_SCENES)


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
def jax_tool():
    """tools/micro_mc_field.py, its Pallas calls interpreted.  Loading it sets
    the JAX compilation cache; the test session's settings are put back."""
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        "micro_mc_field_reference", REPO / "tools" / "micro_mc_field.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for k, v in keep.items():
        jax.config.update(k, v)
    module._phase_pallas = functools.partial(pallas_pbf._phase_pallas, interpret=True)
    return module


@functools.lru_cache(maxsize=None)
def port_frame(scene):
    """The port's frame up to finalise on the CPU: (spec, dyn, fr, st, cfg)."""
    mc, cfg, xs = FIELD_SCENES[scene]()
    solver = TorchSolver(h=cfg.h, device="cpu")
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, device="cpu")
    fr, st, _ = solve_frame(spec, solver.phases, state, dyn, scn)
    return spec, dyn, fr, st, cfg


@functools.lru_cache(maxsize=None)
def jax_inputs(scene):
    """(PallasMcField, wins, packed, rows) of the port's frame, as the JAX
    tool's `inputs` (`tools/micro_mc_field.py:128-141`) makes them."""
    spec, dyn, fr, st, cfg = port_frame(scene)
    jspec = JaxSolver(h=cfg.h, use_pallas=True).make_spec(cfg, jtypes.Scene(), spec.capacity)
    assert jspec.grid.extent == spec.grid.extent
    _, mcf = make_phase_objects(jspec, use_pallas=True)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    wins, overflow = plan_mc_windows(j(fr.index.table), mcf.static, spec.grid.ncells,
                                     mcf.capacity, mcf.smax, mcf.sub)
    assert int(overflow) == 0
    cells, member = decode_key(fr.index.key, spec.grid)
    _, ny, nz = spec.grid.dims
    lin = (cells[0] * ny + cells[1]) * nz + cells[2]
    clm = torch.where((st.ptype != OBSTACLE) & st.alive & member, lin.to(torch.float32),
                      -1e9)
    packed = jnp.stack([j(st.position[0]), j(st.position[1]), j(st.position[2]), j(clm),
                        *(j(st.colour[a]) for a in range(4))])
    f32 = jnp.float32
    step = jnp.asarray(spec.h, f32) / jnp.asarray(mcf.mc.resolution, f32)
    scale = jnp.asarray(spec.scale, f32)
    mine = j(fr.min_extent)
    aw = [(mine[a] + jnp.asarray(mcf.static["node_xyz"][a], jnp.int32).astype(f32) * step)
          * scale for a in range(3)]
    meta = jnp.asarray(mcf.static["meta_lin"], jnp.int32).astype(f32)
    return mcf, wins, packed, jnp.stack([aw[0], aw[1], aw[2], meta])


@functools.lru_cache(maxsize=None)
def jax_variant(scene, mode):
    """The interpreted Pallas `mode` variant's (16, lpad) output, kernel rows."""
    mcf, wins, packed, rows = jax_inputs(scene)
    return np.asarray(jax_tool().make_variant(mcf, mode)(wins, packed, rows))


def lattice_order(scene, out):
    """(16, L) of the kernel rows' (16, lpad), in lattice order."""
    mcf = jax_inputs(scene)[0]
    L = mcf.static["L"]
    lat = np.zeros((out.shape[0], L), out.dtype)
    lat[:, mcf.static["row_lat"][:L]] = out[:, :L]
    return lat


def field_args(scene):
    spec, dyn, fr, st, _ = port_frame(scene)
    return mcb.field_args(spec, fr, st)


def bisect_args(scene):
    """`McFieldBisect`'s arguments after the body: field_args without h."""
    args = field_args(scene)
    return args[:2] + args[3:]


@pytest.mark.parametrize("scene", SCENES)
def test_noop_and_rows_match_pallas(scene):
    bisect = mcb.McFieldBisect(port_frame(scene)[0].h)
    noop = bisect("noop", *bisect_args(scene))
    assert noop.shape == (9, jax_inputs(scene)[0].static["L"])
    assert not noop.any() and not jax_variant(scene, "noop").any()
    rows = bisect("rows", *bisect_args(scene))
    want = lattice_order(scene, jax_variant(scene, "rows"))
    np.testing.assert_array_equal(rows.numpy(), want[:9])
    assert not want[9:].any()
    _, _, skip = mf.lattice_nodes(port_frame(scene)[0].surface,
                                  port_frame(scene)[0].grid.extent, "cpu")
    assert int(skip.sum()) == 1 and len(np.unique(want[0])) > 1000
    assert bisect.launches == dict.fromkeys(mcb.KERNELS, 0)


@pytest.mark.parametrize("scene", SCENES)
def test_zero_fill_takes_noop_plain_on_cpu(scene):
    """`mc_field_zero_fill`, noop's redesign, on CPU tensors: noop_plain's
    (9, L) zeros, as the interpreted noop variant; nothing launched, and its
    launcher refuses a CPU output."""
    bisect = mcb.McFieldBisect(port_frame(scene)[0].h)
    got = bisect("zero_fill", *bisect_args(scene))
    assert got.shape == (9, jax_inputs(scene)[0].static["L"]) and got.dtype == torch.float32
    assert torch.equal(got, mcb.noop_plain(*field_args(scene)))
    assert not jax_variant(scene, "noop").any()
    assert bisect.launches == dict.fromkeys(mcb.KERNELS, 0)
    with pytest.raises(ValueError, match="CUDA"):
        mcb.zero_fill_launch(torch.zeros(8))


@pytest.mark.parametrize("scene", SCENES)
def test_loops_plain_matches_float64(scene):
    """Row 0 is sum p.x * ax over every candidate of the node's nine ranges
    (no key, z-wrap, obstacle or distance test), evaluated here node by node."""
    spec, dyn, fr, st, _ = port_frame(scene)
    got = mcb.loops_plain(*field_args(scene))
    node, cell, skip = mf.lattice_nodes(spec.surface, spec.grid.extent, "cpu")
    ax = mf._node_positions(node, spec.surface, spec.h, spec.scale,
                            fr.min_extent)[0].numpy().astype(np.float64)
    lo, hi, _ = (t.numpy() for t in mf.node_ranges(fr.index, cell, skip))
    px = st.position[0].numpy().astype(np.float64)
    want = np.zeros(node.shape[1])
    for i in np.flatnonzero((hi > lo).any(0)):
        want[i] = sum(px[lo[s, i]:hi[s, i]].sum() for s in range(9)) * ax[i]
    assert np.count_nonzero(want) > 100 and want[skip.numpy()] == 0
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=0)
    assert not got[1:].any()


def pallas_lane_model(scene):
    """(row 0 (lpad,), lane slots (lpad,)) of the JAX loops body in float64:
    each node row sums, over the nine windows of its sub-block, every lane of
    the whole 128-lane chunks that cover the window (`_window_loop`), its
    strip's packed x times the row's ax."""
    mcf, wins, packed, rows = jax_inputs(scene)
    w = np.asarray(wins)[:, 0, :].astype(np.int64)
    csum = np.concatenate([[0.0], np.cumsum(np.asarray(packed)[0].astype(np.float64))])
    ax = np.asarray(rows)[0].astype(np.float64)
    sub, wcol = mcf.sub, pallas_pbf.WCOL
    nsub_b = pallas_pbf.BLK // sub
    total = np.zeros(w.shape[0] * nsub_b)
    slots = np.zeros_like(total, dtype=np.int64)
    for b in range(w.shape[0]):
        sstart = [w[b, nsub_b * 18 + 6 * k] for k in range(3)]
        for t in range(nsub_b):
            for s in range(9):
                lo, hi = w[b, t * 18 + 2 * s], w[b, t * 18 + 2 * s + 1]
                c0 = lo // wcol
                nchunk = -(-(hi - c0 * wcol) // wcol) if hi > lo else 0
                a = sstart[s // 3] + c0 * wcol
                total[b * nsub_b + t] += csum[a + nchunk * wcol] - csum[a]
                slots[b * nsub_b + t] += nchunk * wcol
    return np.repeat(total, sub) * ax, np.repeat(slots, sub)


@pytest.mark.parametrize("scene", SCENES)
def test_jax_loops_matches_its_lane_set(scene):
    """The interpreted Pallas loops against the float64 model of its lanes;
    it visits more slots than the port's loops visits candidates."""
    mcf = jax_inputs(scene)[0]
    out = jax_variant(scene, "loops")
    want, slots = pallas_lane_model(scene)
    np.testing.assert_allclose(out[0], want, rtol=1e-5, atol=0)
    assert not out[1:].any()
    spec, dyn, fr, st, _ = port_frame(scene)
    _, cell, skip = mf.lattice_nodes(spec.surface, spec.grid.extent, "cpu")
    lo, hi, _ = mf.node_ranges(fr.index, cell, skip)
    candidates = int((hi - lo).sum())
    assert slots[:mcf.static["L"]].sum() > candidates > 0


@pytest.mark.parametrize("scene", SCENES)
def test_wrapper_pieces_compose_to_mcfield(scene):
    spec, dyn, fr, st, _ = port_frame(scene)
    args = (fr.index, spec.surface, spec.scale, st.position, st.colour, st.ptype, st.alive,
            fr.min_extent, dyn["mc_particle_size"])
    field = mf.McField(spec.h)
    want = field(*args)
    got = mcb.field_by_pieces(spec.h, *args)
    for g, w in zip(got, want):
        assert torch.equal(torch.nan_to_num(g, nan=7.0), torch.nan_to_num(w, nan=7.0))
        assert torch.equal(torch.isnan(g), torch.isnan(w))
    assert field.launches == {"mc_field_cells": 0, "mc_field": 0}
    bisect = mcb.McFieldBisect(spec.h)
    for body in mcb.BODIES:
        bisect(body, *bisect_args(scene))
    assert bisect.launches == dict.fromkeys(mcb.KERNELS, 0)


def test_work_counts_the_inputs_each_body_reads():
    """At mc128k's shapes (L 103,823, C 130,048): noop and rows ~0.0011 ms,
    loops ~0.0019 ms, all bound by bytes."""
    mc, cfg, _ = WORKLOADS["mc128k"]()
    spec = TorchSolver(h=cfg.h, device="cpu").make_spec(cfg, Scene(), 130_048)
    index = mf.CellIndex(spec.grid, torch.zeros(130_048, dtype=torch.int32),
                         torch.zeros(spec.grid.ncells + 1, dtype=torch.int32))
    assert int(np.prod(spec.surface.sample)) == 103_823
    ms = {b: mcb.bound_ms(*mcb.work(b, index, spec.surface, 3_500_000, 300_000))
          for b in ("noop", "rows", "loops", "full")}
    assert all(by == "bytes" for _, by in ms.values())
    assert abs(ms["noop"][0] - 0.00112) < 2e-5 and abs(ms["rows"][0] - ms["noop"][0]) < 1e-7
    assert abs(ms["loops"][0] - 0.00186) < 2e-5
    assert ms["full"][0] > ms["loops"][0]


def test_cells_shape_matches_the_source():
    """ops/mc_field.py's CELLS_LANES is csrc/mc_field_cells.cu's default G,
    its one build knob, and the sweep's first G."""
    src = (REPO / "pbf_sph_tpu_torch" / "csrc" / "mc_field_cells.cu").read_text()
    assert re.findall(r"#define (MC_FIELD_CELLS_\w+) (\d+)", src) == [
        ("MC_FIELD_CELLS_LANES", str(mf.CELLS_LANES))]
    assert mcb.SWEEP_LANES[0] == mf.CELLS_LANES
    assert len(set(mcb.SWEEP_LANES)) == len(mcb.SWEEP_LANES)
    assert all(g & (g - 1) == 0 and 1 <= g <= 32 for g in mcb.SWEEP_LANES)


def test_cells_work_counts_what_row_4b_reads():
    """At mc128k's shapes (L 103,823, C 130,048): row 4b moves ~8.0 MB, so
    ~0.0024 ms at 3.35 TB/s, bound by bytes; 4 bytes a node fewer out than
    full, and ptype and alive in place of the packs and keys."""
    mc, cfg, _ = WORKLOADS["mc128k"]()
    spec = TorchSolver(h=cfg.h, device="cpu").make_spec(cfg, Scene(), 130_048)
    index = mf.CellIndex(spec.grid, torch.zeros(130_048, dtype=torch.int32),
                         torch.zeros(spec.grid.ncells + 1, dtype=torch.int32))
    nbytes, flops = mcb.work("cells", index, spec.surface, 3_496_500, 1_000_000)
    assert nbytes == 33 * 130_048 + 4 * (spec.grid.ncells + 1) + 16 + 32 * 103_823
    assert flops == 10 * 3_496_500 + 14 * 1_000_000 + 14 * 103_823
    ms, by = mcb.bound_ms(nbytes, flops)
    assert by == "bytes" and abs(ms - 0.0024) < 1e-4


def test_cells_agree_catches_each_fault():
    """`cells_agree`, 3n's check, on the CPU: the plain version agrees with
    row 4's post-passed plain sums, and a v off by 1%, a c where the count
    is 0, a NaN where it is not and a non-zero skip node each fail their
    check alone."""
    spec, dyn, fr, st, _ = port_frame("dam4096")
    size = dyn["mc_particle_size"]
    got = mf.mc_field_cells_plain(*mcb.cells_args(spec, fr, st, size))
    want = mf.post_pass(mf.mc_field_plain(*mcb.field_args(spec, fr, st)), spec.surface,
                        spec.grid.extent, size)
    _, _, skip = mf.lattice_nodes(spec.surface, spec.grid.extent, "cpu")
    assert all(ok for ok, _ in mcb.cells_agree(got, want, skip).values())
    assert mcb.bits_equal(got, got.clone()) and not mcb.bits_equal(got, torch.flip(got, [1]))
    empty = int(torch.nonzero(torch.isnan(got[4]))[0])
    full = int(torch.nonzero(got[0] > 1e-3)[0])
    faults = {"v": lambda t: t[0].mul_(1.01), "c NaN pattern": lambda t: t[4:8, empty].fill_(0.5),
              "n": lambda t: t[1:4, full].fill_(float("nan")),
              "skip node 0": lambda t: t.__setitem__((slice(None), skip), 1.0)}
    for name, fault in faults.items():
        bad = got.clone()
        fault(bad)
        failed = {k for k, (ok, _) in mcb.cells_agree(bad, want, skip).items() if not ok}
        assert name in failed, (name, failed)


def test_pieces_field_is_row_4s_call():
    """`PiecesField`, the stage's "before", returns row 4's call and counts
    no launch on the CPU."""
    spec, dyn, fr, st, _ = port_frame("dam4096")
    args = (fr.index, spec.surface, spec.scale, st.position, st.colour, st.ptype, st.alive,
            fr.min_extent, dyn["mc_particle_size"])
    field = mcb.PiecesField(spec.h)
    for g, w in zip(field(*args), mcb.field_by_pieces(spec.h, *args)):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    assert field.launches == {"mc_field": 0}
    solver = mcb.pieces_solver(spec.h, "cpu")
    assert isinstance(solver.mc_field, mcb.PiecesField)


@pytest.mark.parametrize("noop, zeros, loses", [
    ([2.4, 2.5, 2.3], [2.1, 2.2, 2.0], True),     # 9% over, ranges apart
    ([2.3, 2.5, 2.2], [2.1, 2.25, 2.0], False),   # 9% over, ranges overlap
    ([2.2, 2.25, 2.2], [2.1, 2.15, 2.1], False),  # ranges apart, but 4.8% over
    ([2.0, 2.1, 1.9], [2.3, 2.4, 2.2], False),    # noop faster
])
def test_noop_loses_needs_its_median_over_and_the_ranges_apart(noop, zeros, loses):
    """Row 7.20a's rule: mc_field_noop loses to torch.zeros((9, L)) only if
    its median of the turns is over the call's by more than 5% and its
    fastest turn is slower than the call's slowest."""
    assert mcb.noop_loses({"noop": noop, "zeros": zeros}) is loses


def sass_listing(name, body_ops, copies):
    """A `cuobjdump -sass` listing of one kernel: a prologue, then (when
    `copies`) a loop of `copies` x `body_ops` closed by a backward branch."""
    lines = [f"\t\tFunction : {name}", "        /*0000*/                   MOV R1, R2 ;"]
    addr = 0x10
    for _ in range(copies):
        for op in body_ops:
            lines.append(f"        /*{addr:04x}*/                   {op} R3, R4, R5 ;")
            addr += 0x10
    if copies:
        lines.append(f"        /*{addr:04x}*/              @!P0 BRA 0x10 ;")
        addr += 0x10
    lines.append(f"        /*{addr:04x}*/                   EXIT ;")
    lines.append(f"        /*{addr + 0x10:04x}*/                   BRA 0x{addr + 0x10:x};")
    return "\n".join(lines)


def full_listing(loops):
    """A listing whose innermost loops hold the opcode counts `loops`."""
    lines = ["\t\tFunction : _ZN12_GLOBAL__N_115mc_field_kernelILi3EEEvPK6float4",
             "        /*0000*/                   MOV R1, R2 ;"]
    addr = 0x10
    for loop in loops:
        start = addr
        for op, n in loop.items():
            for _ in range(n - (op == "BRA")):  # BRA: forward ones, then the back edge
                inst = "@P1 BRA 0xfff00" if op == "BRA" else f"{op} R3, R4, R5"
                lines.append(f"        /*{addr:04x}*/                   {inst} ;")
                addr += 0x10
        lines.append(f"        /*{addr:04x}*/              @!P0 BRA 0x{start:x} ;")
        addr += 0x10
    lines.append(f"        /*{addr:04x}*/                   EXIT ;")
    lines.append(f"        /*{addr + 0x10:04x}*/                   BRA 0x{addr + 0x10:x};")
    return "\n".join(lines)


def test_sass_check():
    """noop and rows must have no loop, loops one 16-byte load and one FFMA
    a candidate and nothing else loaded, full the parent's loop opcodes; a
    narrowed load, a folded body or a changed full loop fails."""
    name = "_ZN12_GLOBAL__N_1{}v".format
    walk = ["IADD3", "ISETP.GE.AND", "LDG.E.128.CONSTANT", "FFMA"]
    parent = mcb.PARENT_FULL_LOOPS
    cases = {
        "good": (walk, 0, parent[::-1]),
        "narrowed": (["IADD3", "LDG.E.CONSTANT", "FFMA"], 0, parent),
        "rows loop": (walk, 2, parent),
        "full changed": (walk, 0, [dict(parent[0], FADD=parent[0]["FADD"] + 1)] + parent[1:]),
    }
    for case, (loop_ops, rows_copies, full) in cases.items():
        listing = "\n".join([
            sass_listing(name(mcb.sass_pattern("noop")), ["STG.E"], 0),
            sass_listing(name(mcb.sass_pattern("rows")), ["STG.E"], rows_copies),
            sass_listing(name(mcb.sass_pattern("loops")), loop_ops, 4),
            full_listing(full)])
        report = mcb.check_funcs(ar.parse_sass(listing))
        bad = {k for k, r in report.items() if not r["ok"]}
        want = {"good": set(), "narrowed": {"loops"}, "rows loop": {"rows"},
                "full changed": {"full"}}[case]
        assert bad == want, (case, report)
        if case == "good":
            assert report["loops"]["candidates_a_loop"] == 4
            assert report["loops"]["insts_per_candidate"] == 4.25
