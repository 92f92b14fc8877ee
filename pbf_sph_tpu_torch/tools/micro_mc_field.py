"""Bisect the MC-field stage of a surface frame: kernel, wrapper and host.

    python -m pbf_sph_tpu_torch.tools.micro_mc_field [workload] [reps]

Port of `tools/micro_mc_field.py`.  The `mc_field` kernel of a surface
frame sits far above its byte bound, and the "mc field" stage of the frame
takes several times the kernel.  This tool says where both go, with the
three bisection bodies of `csrc/mc_field.cu`, each the JAX tool's variant
(`make_variant`) reduced from the port's own kernel (one thread a lattice
node, in lattice order, the node's exact ranges read from the cell table):

* `mc_field_noop` ("noop"): launch and the (9, L) output, all zeros;
* `mc_field_rows` ("rows"): + the node decode, its cell and world position;
  every row holds ((ax + ay) + az) + meta, meta = the cell's linear id (-1
  for the skip node), the JAX tool's row sum with its `meta_lin`;
* `mc_field_loops` ("loops"): + `mc_field`'s nine-column walk, one 16-byte
  load of the candidate's position and acc += p.x * ax a candidate (its
  y, z and w xor-ed into an integer sink, or ptxas narrows the load); row 0
  holds acc, rows 1-8 zeros.  The JAX body sums whole 128-lane chunks of its
  sub-block's union windows instead, so the two differ by design;
* `mc_field` ("full", `ops/mc_field.py`): + the key read, the z-wrap and
  obstacle tests, the distance mask, the weight, the nine sums and the
  colour loads.

Beside them `mc_field_zero_fill` ("zero_fill") redesigns "noop" for this
card: the same (9, L) zeros by 16-byte stores over a card-filling grid, read
in turns beside noop and `torch.zeros((9, L))` (`noop_turns`).

Each body has a plain PyTorch version of `mc_field_plain`'s signature and a
launcher of `mc_field_kernel`'s; `McFieldBisect` holds the wrappers, which
take the plain version for CPU tensors and the kernel for CUDA ones, and
count launches.

The tool settles the workload (default mc128k; bench20k, res 2.0, is the
second case) and takes one more frame's sort-time index and finalised state;
checks the SASS of the four bodies (cuobjdump) and fails with no time if one
is off; holds each body against its plain version at both workloads; then
reads

* the kernel ladder noop -> rows -> loops -> full on prebuilt packs and a
  prebuilt output, by CUDA events over back-to-back launches and over the
  replay of a CUDA graph of captured launches, with the host's time a
  launch, each step's bound and the SM clock sampled beside;
* noop, zero_fill and `torch.zeros((9, L))` in turns (`noop_turns`);
* the wrapper ladder, the pieces of `McField.__call__` (nonobstacle, the
  (C, 4) packs, the kernel, `post_pass` with its host-side `skip_box`, the
  whole call, and the frame's "mc field" stage): device ms, host ms a call
  and the device work one call launches (`torch.profiler`), and from them the
  stage split into kernel, wrapper device work and host.

The JAX tool's `plan_mc_windows` and its unpermute (gather or sort) have no
counterpart: the port reads its ranges from the cell table inside the kernel
and keeps lattice order.  The last line is one JSON object.  Without a CUDA
device the tool fails.
"""

from __future__ import annotations

import collections
import functools
import json
import sys
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops import mc_field as mf
from pbf_sph_tpu_torch.ops.phases import nonobstacle
from pbf_sph_tpu_torch.tools import anchor_rate as ar

BODIES = ("noop", "rows", "loops")
KERNEL_OF = {"noop": "mc_field_noop", "rows": "mc_field_rows", "loops": "mc_field_loops",
             "zero_fill": "mc_field_zero_fill"}
KERNELS = tuple(KERNEL_OF.values())
BODY_ID = {"noop": 0, "rows": 1, "loops": 2, "full": 3}  # McBody of csrc/mc_field.cu
WORKLOADS = ("bench20k", "mc128k")
SETTLE_FRAMES = 5
GRAPH_LAUNCHES = 100   # launches captured in one CUDA graph
GRAPH_REPLAYS = 5
NOOP_TURNS = 10   # alternations of mc_field_noop and torch.zeros((9, L))
RTOL, ATOL_SCALE = 1e-5, 1e-6   # loops: atol = ATOL_SCALE * max|value| (sums run to ~1e7)
# the bound: published peaks of one H100 SXM (700 W); fp32 operations a
# candidate (loops: its FFMA; full: l, d2 and the compares) and a hit (full:
# the weight and the nine sums), and a node (rows: its position and sum)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FLOP_PER_CANDIDATE = {"noop": 0, "rows": 0, "loops": 2, "full": 10}
FLOP_PER_HIT = {"noop": 0, "rows": 0, "loops": 0, "full": 14}
FLOP_PER_NODE = {"noop": 0, "rows": 12, "loops": 0, "full": 0}
# what each step of the ladder adds to the one before it
LADDER = (("noop", "launch and the (9, L) output stores"),
          ("rows", "the node decode, its cell and world position"),
          ("loops", "the nine-column walk, one 16-byte load a candidate"),
          ("full", "the key read, z-wrap and obstacle tests, distance mask, weight, "
                   "nine sums and colour loads"))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the signature of mc_field_plain)
# ---------------------------------------------------------------------------


def noop_plain(index, mc, h: float, scale: float, position, colour, nonobs, min_extent):
    """(9, L) zeros: what `mc_field_noop` writes."""
    return torch.zeros((9, int(np.prod(mc.sample))), dtype=position.dtype,
                       device=position.device)


def rows_plain(index, mc, h: float, scale: float, position, colour, nonobs, min_extent):
    """(9, L), every row ((ax + ay) + az) + meta: the node's world position
    (`_node_positions`) and its cell's linear id, -1 for the skip node."""
    node, cell, skip = mf.lattice_nodes(mc, index.grid.extent, position.device)
    aw = mf._node_positions(node, mc, h, scale, min_extent)
    _, gny, gnz = index.grid.dims
    lin = ((cell[0] * gny + cell[1]) * gnz + cell[2]).to(aw.dtype)
    meta = torch.where(skip, torch.full_like(lin, -1.0), lin)
    return (((aw[0] + aw[1]) + aw[2]) + meta).expand(9, -1).contiguous()


def loops_plain(index, mc, h: float, scale: float, position, colour, nonobs, min_extent):
    """(9, L): row 0 the sum over the node's nine ranges (`node_ranges`) of
    p.x * ax, every candidate of a range, summed in float64; rows 1-8 zero."""
    node, cell, skip = mf.lattice_nodes(mc, index.grid.extent, position.device)
    aw = mf._node_positions(node, mc, h, scale, min_extent)
    lo, hi, _ = mf.node_ranges(index, cell, skip)
    px = position[0].double()
    csum = torch.cat([px.new_zeros(1), torch.cumsum(px, 0)])
    out = torch.zeros((9, node.shape[1]), dtype=position.dtype, device=position.device)
    out[0] = ((csum[hi] - csum[lo]).sum(0) * aw[0].double()).to(position.dtype)
    return out


PLAIN = {"noop": noop_plain, "rows": rows_plain, "loops": loops_plain, "zero_fill": noop_plain}


# ---------------------------------------------------------------------------
# CUDA kernel launchers (the signature of mc_field_kernel)
# ---------------------------------------------------------------------------


def noop_kernel(index, mc, h: float, scale: float, position, colour, nonobs, min_extent):
    """(9, L) from `mc_field_noop` (replaces `make_variant(mcf, "noop")`)."""
    return mf.mc_field_kernel(index, mc, h, scale, position, colour, nonobs, min_extent,
                              KERNEL_OF["noop"])


def rows_kernel(index, mc, h: float, scale: float, position, colour, nonobs, min_extent):
    """(9, L) from `mc_field_rows` (replaces `make_variant(mcf, "rows")`)."""
    return mf.mc_field_kernel(index, mc, h, scale, position, colour, nonobs, min_extent,
                              KERNEL_OF["rows"])


def loops_kernel(index, mc, h: float, scale: float, position, colour, nonobs, min_extent):
    """(9, L) from `mc_field_loops` (replaces `make_variant(mcf, "loops")`)."""
    return mf.mc_field_kernel(index, mc, h, scale, position, colour, nonobs, min_extent,
                              KERNEL_OF["loops"])


@functools.cache
def zero_fill_ctas(device_index: int) -> int:
    """The card-filling CTA count of `mc_field_zero_fill` on a device."""
    with torch.cuda.device(device_index):
        n = cuda_build.library().mc_field_zero_fill_ctas()
    if n <= 0:
        raise RuntimeError("mc_field_zero_fill: the occupancy query failed")
    return n


def zero_fill_launch(out) -> None:
    """`mc_field_zero_fill` into `out`, a contiguous 16-byte aligned float32
    CUDA tensor (CUDA tensors only)."""
    if out.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {out.device}")
    if out.dtype != torch.float32 or not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError("zero_fill: want a contiguous 16-byte aligned float32 output")
    with torch.cuda.device(out.device):
        err = cuda_build.library().mc_field_zero_fill(
            out.data_ptr(), out.numel(), zero_fill_ctas(out.device.index),
            mf._stream(out.device))
    cuda_build.check("mc_field_zero_fill", err)


def zero_fill_kernel(index, mc, h: float, scale: float, position, colour, nonobs, min_extent):
    """(9, L) from `mc_field_zero_fill` (replaces `make_variant(mcf, "noop")`
    beside `noop_kernel`)."""
    out = torch.empty((9, int(np.prod(mc.sample))), dtype=torch.float32,
                      device=position.device)
    zero_fill_launch(out)
    return out


LAUNCHERS = {"noop": noop_kernel, "rows": rows_kernel, "loops": loops_kernel,
             "zero_fill": zero_fill_kernel}


class McFieldBisect:
    """The three wrappers, with a launch counter per kernel: `launches[name]`
    starts at 0 and grows by one each time a wrapper launches its CUDA
    kernel, and at no other time.  A CPU tensor takes the plain version."""

    def __init__(self, h: float):
        self.h = float(h)
        self.launches = dict.fromkeys(KERNELS, 0)

    def __call__(self, body: str, index, mc, scale: float, position, colour, nonobs,
                 min_extent):
        """Raw (9, L) of `body`."""
        args = (index, mc, self.h, scale, position, colour, nonobs, min_extent)
        if position.device.type == "cpu":
            return PLAIN[body](*args)
        out = LAUNCHERS[body](*args)
        self.launches[KERNEL_OF[body]] += 1
        return out

    def launch(self, body: str, index, mc, scale: float, pos4, col4, min_extent, out) -> None:
        """`body`'s kernel on prebuilt packs into `out` (CUDA tensors only;
        zero_fill reads no pack)."""
        if body == "zero_fill":
            zero_fill_launch(out)
        else:
            mf.mc_field_launch(KERNEL_OF[body], index, mc, self.h, scale, pos4, col4,
                               min_extent, out)
        self.launches[KERNEL_OF[body]] += 1


# ---------------------------------------------------------------------------
# McField.__call__ piece by piece
# ---------------------------------------------------------------------------


def raw_from_packs(index, mc, h: float, scale: float, pos4, col4, min_extent, out) -> None:
    """The raw field into `out` from the (C, 4) packs: `mc_field` on the
    card, its plain version on the CPU."""
    if pos4.device.type == "cpu":
        out.copy_(mf.mc_field_plain(index, mc, h, scale, pos4[:, :3].t(), col4.t(),
                                    pos4[:, 3], min_extent))
    else:
        mf.mc_field_launch("mc_field", index, mc, h, scale, pos4, col4, min_extent, out)


def field_by_pieces(h: float, index, mc, scale: float, position, colour, ptype, alive,
                    min_extent, particle_size):
    """What `McField(h)(...)` returns, from the pieces the wrapper ladder
    times: nonobstacle, the packs, the field from the packs, `post_pass`."""
    nonobs = nonobstacle(ptype, alive, position.dtype)
    pos4, col4 = mf.mc_field_packs(position, colour, nonobs)
    raw = torch.empty((9, int(np.prod(mc.sample))), dtype=position.dtype,
                      device=position.device)
    raw_from_packs(index, mc, h, scale, pos4, col4, min_extent.contiguous(), raw)
    return mf.post_pass(raw, mc, index.grid.extent, particle_size)


# ---------------------------------------------------------------------------
# Work, bound and census
# ---------------------------------------------------------------------------


def work(body: str, index, mc, pairs: int, hits: int = 0):
    """(bytes, fp32 operations) the body must move and do at a frame of
    `pairs` node-candidate pairs and `hits` within h*scale: each input it
    reads once (noop none; rows min_extent; loops the (C, 4) positions and
    the cell table; full both packs, the keys and the table) and the (9, L)
    output once."""
    nodes = int(np.prod(mc.sample))
    cap = index.key.shape[0]
    table = 4 * (index.grid.ncells + 1)
    read = {"noop": 0, "rows": 12, "loops": 16 * cap + table + 12,
            "full": 32 * cap + 4 * cap + table + 12}[body]
    flops = (FLOP_PER_CANDIDATE[body] * pairs + FLOP_PER_HIT[body] * hits
             + FLOP_PER_NODE[body] * nodes)
    return read + 36 * nodes, flops


def bound_ms(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the fp32 rate."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def census(spec, fr, raw) -> dict:
    """The lattice, its nodes, the live ones (one candidate or more), the
    node-candidate pairs, the hits within h*scale (`raw` row 8) and the
    candidates a live node."""
    mc = spec.surface
    _, cell, skip = mf.lattice_nodes(mc, spec.grid.extent, raw.device)
    lo, hi, _ = mf.node_ranges(fr.index, cell, skip)
    per_node = (hi - lo).sum(0)
    live = int((per_node > 0).sum())
    pairs = int(per_node.sum())
    return dict(lattice=list(mc.sample), res=mc.resolution, nodes=int(skip.numel()),
                live=live, pairs=pairs, hits=int(raw[8].sum()),
                per_live=pairs / max(live, 1), max_per_node=int(per_node.max()))


# ---------------------------------------------------------------------------
# The SASS of the built kernels
# ---------------------------------------------------------------------------

# The opcodes of `mc_field`'s candidate loops as csrc/mc_field.cu built them
# before it became a template on its body (cuobjdump -sass, nvcc 12.9,
# sm_90a): the loop unswitched on `half`, the exp path unrolled x2 and the
# sqrt(rsqrt) path (infl 0.5, the one that runs) x4.
PARENT_FULL_LOOPS: List[Dict[str, int]] = [
    {"LDC": 6, "IMAD": 5, "LDG.E.CONSTANT": 2, "BSSY": 2, "IADD3": 7, "ISETP": 7, "BRA": 7,
     "LDG.E.128.CONSTANT": 4, "FSETP": 10, "FADD": 26, "ULDC": 2, "FMUL": 14, "HFMA2": 4,
     "LOP3": 2, "I2FP": 2, "FFMA": 38, "FSEL": 4, "MOV": 4, "SHF": 2, "MUFU.EX2": 2,
     "BSYNC": 2},
    {"LDC": 3, "ULDC": 8, "IMAD": 3, "LDG.E.CONSTANT": 4, "BSSY": 8, "IADD3": 9, "ISETP": 13,
     "BRA": 21, "LDG.E.128.CONSTANT": 8, "FSETP": 16, "FADD": 44, "FMUL": 28, "MUFU.RSQ": 8,
     "MOV": 8, "CALL": 4, "FFMA": 20, "BSYNC": 8},
]


def sass_pattern(body: str) -> str:
    """A unique part of the mangled name of `body`'s instantiation."""
    return f"15mc_field_kernelILi{BODY_ID[body]}E"


def body_loops(sass) -> List[collections.Counter]:
    """The opcode counts of each innermost loop but the trap after the
    kernel's EXIT (a lone BRA to itself)."""
    return [c for c in ar.innermost_loops(sass) if sum(c.values()) > 1]


def same_loops(a, b) -> bool:
    """Equal opcode counts, loop for loop, in any order."""
    key = lambda c: tuple(sorted(c.items()))  # noqa: E731
    return sorted(map(key, a)) == sorted(map(key, b))


def _ldg(loop, wide: bool) -> int:
    return sum(v for k, v in loop.items() if k.startswith("LDG") and ("128" in k) == wide)


def check_sass(lib_path) -> Dict[str, dict]:
    """`check_funcs` of the built library."""
    return check_funcs(ar.sass_functions(lib_path))


def check_funcs(funcs) -> Dict[str, dict]:
    """body -> dict(ok, counts): noop and rows have no loop; each innermost
    loop of loops holds one 16-byte load (LDG.128) and one FFMA (or one
    FMUL and one FADD) a candidate, no other global load and no MUFU; full's
    innermost loops equal `PARENT_FULL_LOOPS` opcode for opcode.  Beside
    them the instructions a candidate of loops and full (full: its loop
    with the most 32-bit key loads, one a candidate)."""
    report = {}
    for body in ("noop", "rows"):
        loops = body_loops(ar._one(funcs, sass_pattern(body)))
        report[body] = dict(ok=not loops, loops=len(loops))
    loops = body_loops(ar._one(funcs, sass_pattern("loops")))
    ok = bool(loops)
    for c in loops:
        n = _ldg(c, True)
        fma = c["FFMA"] == n or (c["FMUL"] == n and c["FADD"] == n)
        ok = ok and n > 0 and fma and _ldg(c, False) == 0 and not any(
            k.startswith("MUFU") for k in c)
    main = max(loops, key=lambda c: _ldg(c, True)) if loops else collections.Counter()
    report["loops"] = dict(ok=ok, loops=len(loops), candidates_a_loop=_ldg(main, True),
                           insts_per_candidate=sum(main.values()) / max(_ldg(main, True), 1))
    full = body_loops(ar._one(funcs, sass_pattern("full")))
    same = same_loops(full, PARENT_FULL_LOOPS)
    main = max(full, key=lambda c: _ldg(c, False)) if full else collections.Counter()
    report["full"] = dict(ok=bool(full) and same, same_as_parent=same, loops=len(full),
                          insts_per_candidate=sum(main.values()) / max(_ldg(main, False), 1),
                          opcodes=[dict(c) for c in full], parent=PARENT_FULL_LOOPS)
    return report


# ---------------------------------------------------------------------------
# Settling, parity and the readings
# ---------------------------------------------------------------------------


@dataclass
class Settled:
    """A surface workload after the warmup, with one more frame's sort-time
    frame `fr` and finalised state `st`: what the field reads."""

    workload: str
    solver: object
    spec: object
    state: object
    dyn: dict
    scn: dict
    fr: object
    st: object


def settle(workload: str, frames: int = SETTLE_FRAMES, device="cuda") -> Settled:
    """`workload` through `TorchSolver`: prepare, the growth warmup of
    `bench.warm_up` over `frames` frames, then one `solve_frame`."""
    from pbf_sph_tpu_torch.bench import warm_up
    from pbf_sph_tpu_torch.core.configs import WORKLOADS as PRESETS
    from pbf_sph_tpu_torch.core.types import Scene
    from pbf_sph_tpu_torch.models.torch_solver import TorchSolver, dyn_params_of, solve_frame

    mc, cfg, xs = PRESETS[workload]()
    solver = TorchSolver(h=cfg.h, device=device)
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, solver.dtype, solver.device)
    spec, state, _ = warm_up(solver, spec, state, dyn, scn, xs, frames)
    fr, st, _ = solve_frame(spec, solver.phases, state, dyn, scn)
    return Settled(workload, solver, spec, state, dyn, scn, fr, st)


def field_args(spec, fr, st):
    """The (index, mc, h, scale, position, colour, nonobs, min_extent) of the
    field at a frame."""
    return (fr.index, spec.surface, spec.h, spec.scale, st.position, st.colour,
            nonobstacle(st.ptype, st.alive), fr.min_extent)


def card_parity(spec, fr, st, tag: str) -> Dict[str, tuple]:
    """Each body's kernel against its plain version at a frame, its launches
    not counted; "body tag" -> (max abs err, within tolerance): noop all
    zero, rows bit for bit, loops rtol 1e-5 with atol 1e-6 x max|value|,
    and zero_fill into a NaN-filled output equal to noop_plain."""
    args = field_args(spec, fr, st)
    res = {}
    for body in BODIES:
        got, want = LAUNCHERS[body](*args), PLAIN[body](*args)
        err = float((got - want).abs().max())
        if body == "noop":
            ok = not bool(got.any()) and not bool(want.any())
        elif body == "rows":
            ok = torch.equal(got, want)
        else:
            atol = ATOL_SCALE * float(want.abs().max())
            ok = torch.allclose(got, want, rtol=RTOL, atol=atol) and bool(want[0].any())
        res[f"{body} {tag}"] = (err, ok)
    want = noop_plain(*args)
    got = torch.full_like(want, float("nan"))
    zero_fill_launch(got)
    res[f"zero_fill {tag}"] = (float((got - want).abs().max()), torch.equal(got, want))
    return res


def host_ms(fn, calls: int) -> float:
    """Host ms a call of fn(): the clock around `calls` calls with no
    synchronise inside, what the host spends enqueueing."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / calls


def graph_ms(fn, launches: int = GRAPH_LAUNCHES, replays: int = GRAPH_REPLAYS) -> float:
    """Device ms a call of fn() from CUDA events around the replays of one
    CUDA graph of `launches` captured calls: no host in the way."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def profile_call(fn, calls: int = 5) -> dict:
    """`torch.profiler` over `calls` calls of fn(): the kernels one call
    launches, their summed device ms (busy), and the device ms of those
    whose name holds "mc_field_kernel"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return dict(kernels=sum(e.count for e in dev) / calls,
                busy_ms=sum(e.self_device_time_total for e in dev) / calls / 1e3,
                field_kernel_ms=sum(e.self_device_time_total for e in dev
                                    if "mc_field_kernel" in e.key) / calls / 1e3)


def kernel_ladder(bisect: McFieldBisect, spec, fr, st, reps: int) -> dict:
    """noop -> rows -> loops -> full at a frame: the three bodies through
    `bisect` (counted), full by `mc_field`'s launcher, all on packs and an
    output made beforehand.  Per step: CUDA events over `reps` back-to-back
    launches, the graph replay (`graph_ms`), host ms a launch, the bound and
    what the step adds; pairs/s for loops and full; the SM clock."""
    from pbf_sph_tpu_torch.tools.bench_kernel_variants import device_ms

    index, mc, h, scale, position, colour, nonobs, mine = field_args(spec, fr, st)
    pos4, col4 = mf.mc_field_packs(position, colour, nonobs)
    mine = mine.contiguous()
    out = torch.empty((9, int(np.prod(mc.sample))), dtype=torch.float32,
                      device=position.device)
    mf.mc_field_launch("mc_field", index, mc, h, scale, pos4, col4, mine, out)
    cen = census(spec, fr, out)
    runs = {body: (lambda b=body: bisect.launch(b, index, mc, scale, pos4, col4, mine, out))
            for body in BODIES}
    runs["full"] = lambda: mf.mc_field_launch("mc_field", index, mc, h, scale, pos4, col4,
                                              mine, out)
    steps = []
    with ar.ClockSampler(position.device) as clock:
        for body, adds in LADDER:
            fn = runs[body]
            ev, gr = device_ms(fn, reps), graph_ms(fn)
            b_ms, b_by = bound_ms(*work(body, index, mc, cen["pairs"], cen["hits"]))
            steps.append(dict(step=body, adds=adds, events_ms=ev, graph_ms=gr,
                              host_us=host_ms(fn, reps) * 1e3, bound_ms=b_ms, bound_by=b_by))
    for i, s in enumerate(steps):
        prev = steps[i - 1] if i else None
        s["step_events_ms"] = s["events_ms"] - prev["events_ms"] if prev else s["events_ms"]
        s["step_graph_ms"] = s["graph_ms"] - prev["graph_ms"] if prev else s["graph_ms"]
        if s["step"] in ("loops", "full"):
            s["pairs_per_s"] = cen["pairs"] / (s["graph_ms"] * 1e-3)
    return dict(census=cen, steps=steps, clocks_sm_mhz=clock.summary())


def noop_turns(bisect: McFieldBisect, spec, fr, st, turns: int = NOOP_TURNS) -> dict:
    """`mc_field_noop` and `mc_field_zero_fill` through `bisect` (counted)
    on packs and an output made beforehand, and `torch.zeros((9, L))`, the
    one call that computes what both write, read in turns: `turns` rounds of
    the three, each reading a CUDA graph of GRAPH_LAUNCHES launches
    (`graph_ms`, the ladder's reader).  {"noop": [ms, ...], "zero_fill":
    [...], "zeros": [...]}."""
    index, mc, h, scale, position, colour, nonobs, mine = field_args(spec, fr, st)
    pos4, col4 = mf.mc_field_packs(position, colour, nonobs)
    mine = mine.contiguous()
    nodes = int(np.prod(mc.sample))
    out = torch.empty((9, nodes), dtype=torch.float32, device=position.device)
    calls = {body: (lambda b=body: bisect.launch(b, index, mc, scale, pos4, col4, mine, out))
             for body in ("noop", "zero_fill")}
    calls["zeros"] = lambda: torch.zeros((9, nodes), dtype=torch.float32, device=position.device)
    res = {name: [] for name in calls}
    for _ in range(turns):
        for name, fn in calls.items():
            res[name].append(graph_ms(fn))
    return res


def noop_loses(turns: dict, margin: float = 0.05, body: str = "noop") -> bool:
    """Whether `noop_turns` shows `body` slower than its call: its median
    over the call's by more than `margin` and the two ranges apart (its
    fastest turn above the call's slowest)."""
    mine, zeros = turns[body], turns["zeros"]
    return bool(np.median(mine) > (1 + margin) * np.median(zeros) and min(mine) > max(zeros))


def wrapper_ladder(s: Settled, reps: int) -> dict:
    """The pieces of `McField.__call__` at the settled frame: per piece
    device ms (CUDA events over `reps` back-to-back calls), host ms a call
    and `profile_call`; the whole call also from a CUDA graph; the "mc field"
    stage of `bench.phase_breakdown` over 5 frames; and the stage split into
    the kernel, the wrapper's other device work and the host (the stage less
    the call's device work)."""
    from pbf_sph_tpu_torch.bench import phase_breakdown
    from pbf_sph_tpu_torch.tools.bench_kernel_variants import device_ms

    spec, fr, st = s.spec, s.fr, s.st
    index, mc, h, scale, position, colour, nonobs, mine = field_args(spec, fr, st)
    pos4, col4 = mf.mc_field_packs(position, colour, nonobs)
    mine = mine.contiguous()
    raw = torch.empty((9, int(np.prod(mc.sample))), dtype=torch.float32,
                      device=position.device)
    size = s.dyn["mc_particle_size"]
    field = mf.McField(h)
    pieces = {
        "nonobstacle": lambda: nonobstacle(st.ptype, st.alive, position.dtype),
        "packs": lambda: mf.mc_field_packs(position, colour, nonobs),
        "kernel": lambda: raw_from_packs(index, mc, h, scale, pos4, col4, mine, raw),
        "post_pass": lambda: mf.post_pass(raw, mc, spec.grid.extent, size),
        "call": lambda: field(index, mc, scale, position, colour, st.ptype, st.alive,
                              fr.min_extent, size),
    }
    res = {}
    for name, fn in pieces.items():
        res[name] = dict(device_ms=device_ms(fn, reps), host_ms=host_ms(fn, reps),
                         **profile_call(fn))
    t0 = time.perf_counter()
    for _ in range(reps):
        mf.skip_box(mc, spec.grid.extent)
    res["skip_box"] = dict(host_ms=(time.perf_counter() - t0) * 1e3 / reps)
    res["call"]["graph_ms"] = graph_ms(pieces["call"], 20, 2)
    _, stages = phase_breakdown(s.solver, spec, s.state, s.dyn, s.scn, 5)
    stage = stages["mc field"]
    call = res["call"]
    kernel = call["field_kernel_ms"]
    res["stage"] = dict(stage_ms=stage, mc_extract_ms=stages["mc extract"],
                        frame_device_ms=sum(stages.values()), kernel_ms=kernel,
                        wrapper_device_ms=call["busy_ms"] - kernel,
                        host_ms=stage - call["busy_ms"])
    return res


def main(argv=None) -> int:
    from pbf_sph_tpu_torch.tools.bench_kernel_variants import card_line

    argv = sys.argv[1:] if argv is None else argv
    workload = argv[0] if argv else "mc128k"
    reps = int(argv[1]) if len(argv) > 1 else 20
    if workload not in WORKLOADS:
        raise SystemExit(f"micro_mc_field: workload {workload!r} is not one of {WORKLOADS}")
    if not torch.cuda.is_available():
        raise SystemExit("micro_mc_field: needs a CUDA device")
    card = card_line()
    print(card)

    settled = {w: settle(w) for w in WORKLOADS}
    s = settled[workload]
    raw = mf.mc_field_kernel(*field_args(s.spec, s.fr, s.st))
    cen = census(s.spec, s.fr, raw)
    print(f"== 1. {workload} settled ({SETTLE_FRAMES} frames, then one frame's sort-time index "
          f"and finalised state): res {cen['res']}, lattice {cen['lattice']} ({cen['nodes']} "
          f"nodes), {cen['live']} live nodes, {cen['pairs']} node-candidate pairs, "
          f"{cen['hits']} within h*scale, {cen['per_live']:.2f} candidates a live node "
          f"(max {cen['max_per_node']})")

    print("== 2. SASS of csrc/mc_field.cu (cuobjdump)")
    cuda_build.library()
    sass = check_sass(cuda_build.library_path())
    for name, r in sass.items():
        print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in r.items()))
    bad = [name for name, r in sass.items() if not r["ok"]]
    if bad:
        raise SystemExit(f"micro_mc_field: the SASS of {bad} is off (a folded or narrowed "
                         f"load, a loop where none belongs, or mc_field's loop changed), so "
                         f"no time is printed")

    parity = {}
    for w, sw in settled.items():
        parity.update(card_parity(sw.spec, sw.fr, sw.st, w))
    print("== 3. each kernel against its plain version: " + ", ".join(
        f"{k} {e:.3e}" for k, (e, _) in parity.items()))
    wrong = [k for k, (_, ok) in parity.items() if not ok]
    if wrong:
        raise SystemExit(f"micro_mc_field: {wrong} disagree with their plain versions")

    bisect = McFieldBisect(s.spec.h)
    kl = kernel_ladder(bisect, s.spec, s.fr, s.st, reps)
    print(f"== 4. kernel ladder at {workload} (prebuilt packs and output; CUDA events over "
          f"{reps} back-to-back launches | a CUDA graph of {GRAPH_LAUNCHES} launches); SM "
          f"clock (nvidia-smi, MHz) {kl['clocks_sm_mhz']}")
    for r in kl["steps"]:
        rate = (f", {r['pairs_per_s'] / 1e9:.2f} G node-candidate pairs/s"
                if "pairs_per_s" in r else "")
        print(f"  {r['step']:5s} {r['events_ms']:.4f} | {r['graph_ms']:.4f} ms (step "
              f"{r['step_events_ms']:+.4f} | {r['step_graph_ms']:+.4f}: {r['adds']}); host "
              f"{r['host_us']:.2f} us a launch; bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}{rate}")

    turns = noop_turns(bisect, s.spec, s.fr, s.st)
    print(f"== 4b. noop, zero_fill and torch.zeros((9, L)) in {NOOP_TURNS} turns (ms in a CUDA "
          f"graph of {GRAPH_LAUNCHES} launches)")
    for name, v in turns.items():
        loses = "" if name == "zeros" else f"; loses to torch.zeros: {noop_loses(turns, body=name)}"
        print(f"  {name:9s} median {np.median(v):.5f}, min-max {min(v):.5f}-{max(v):.5f}{loses}")

    wl = wrapper_ladder(s, reps)
    print(f"== 5. wrapper ladder at {workload}: the pieces of McField.__call__ (device ms "
          f"by CUDA events over {reps} back-to-back calls, host ms a call without a "
          f"synchronise, device work a call by torch.profiler)")
    print("  plan_mc_windows and the unpermute (gather or sort) of the JAX tool have no "
          "counterpart: the kernel reads its ranges from the cell table and keeps "
          "lattice order")
    for name, r in wl.items():
        if name in ("stage", "skip_box"):
            continue
        graph = f"; a CUDA graph of calls {r['graph_ms']:.4f} ms" if "graph_ms" in r else ""
        print(f"  {name:11s} device {r['device_ms']:.4f} ms (events), busy {r['busy_ms']:.4f} "
              f"ms (profiler), host {r['host_ms']:.4f} ms a call; {r['kernels']:g} kernels a "
              f"call{graph}")
    print(f"  skip_box    host {wl['skip_box']['host_ms']:.4f} ms a call (numpy, inside "
          f"post_pass)")
    st = wl["stage"]
    print(f"  the \"mc field\" stage {st['stage_ms']:.4f} ms a frame (phase_breakdown, 5 "
          f"frames; mc extract {st['mc_extract_ms']:.4f}, frame {st['frame_device_ms']:.4f}) "
          f"= kernel {st['kernel_ms']:.4f} + wrapper device work "
          f"{st['wrapper_device_ms']:.4f} + host {st['host_ms']:.4f}")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                      "workload": workload, "reps": reps, "census": cen, "sass": sass,
                      "parity": {k: e for k, (e, _) in parity.items()},
                      "kernel_ladder": kl, "noop_turns": turns, "wrapper_ladder": wl,
                      "launches": bisect.launches}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
