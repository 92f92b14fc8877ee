"""Loop overhead, ILP, latency and op rates on the card, as the TPU tool reads them.

    python -m pbf_sph_tpu_torch.tools.micro_loop [reps]

Port of `tools/micro_loop.py`.  The chunk bodies of `micro_chunk` are read
against these: the cost of a loop trip, what independent carries buy, the
latency of a dependent FMA and the rate of each op the pair bodies use.
The 16 bodies of the JAX tool's `main` (`:48-117`), which its `run` (`:34`)
launches, run on the three hand-written kernels of `csrc/micro_loop.cu`
(x8 = 1.0000001 on (8, 128), N = 65536):

* `loop_fma`: a) one carry c*1.000001 + x over N trips; b) 2-32 carries
  from x + s over N trips, summed; d) 1-4 carries on (64, 128) ones over
  N/4 trips (the carries of `csrc/micro_fma.cuh`, which `chunk_fma` shares);
* `loop_chain`: c) a chain of 4 or 16 dependent FMAs a trip over N/8 trips;
* `loop_op`: e) 8 carries from x + s over N/4 trips of one op: rsqrt(c +
  x), where(c > x, c, x) + 1e-7, c*1.000001, c + x or where(|c - x| <= 1,
  c + x, x), summed.

Each has a plain PyTorch version of the same signature, vectorised over the
carries on a (k, 8, 128) tensor, one torch op a trip (the FMAs by
`torch.addcmul`, fused as the kernels' FFMA); `MicroLoop` holds the
wrappers, which take the plain version for a CPU tensor and the kernel for a
CUDA one, and count launches.  A kernel runs `nblocks` CTAs of 1024 threads,
one (8, 128) tile a CTA; the JAX size is one copy (1 CTA, or 8 for (64,
128)), and the tool also fills the card.

The tool prints the card line; checks the SASS (cuobjdump: each trip loop
holds its body's ops once, not unrolled: a) one FFMA and the loop's own
instructions, b) and d) k FFMAs, c) k FFMAs, e) eight of its op, with the
fp32 instructions the card computes it with); holds each kernel against
its plain version on the tool's inputs and on seeded ones at fewer trips;
then reads every body as the marginal between two trip counts, with CUDA
events, at the JAX size and at the full card, in ns a trip and ns an op,
beside the rate anchor's fma 16-stream rate and serial latency read in the
same run, while `nvidia-smi` samples the SM clock.  The last line is one
JSON object.  Without a CUDA device the tool fails.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.ops import phases as ph
from pbf_sph_tpu_torch.tools import anchor_rate as ar
from pbf_sph_tpu_torch.tools import micro_chunk as mc

N = 65536                   # the JAX tool's trips
X8 = 1.0000001              # its (8, 128) input
TILE8, TILE64 = (8, 128), (64, 128)
CTA = mc.CTA
OPS = ("rsqrt", "where", "mul", "add", "sub_abs_cmp")
OP_CARRIES = 8
KERNELS = ("loop_fma", "loop_chain", "loop_op")
KERNEL_ID = {"loop_fma": 0, "loop_chain": 1, "loop_op": 2}   # micro_loop_fill's
PARITY_DIV = 64             # a check on the card runs 1/64 of the JAX trips
RTOL_RSQRT = 1e-6           # e) rsqrt, kernel against plain (see card_parity)


@dataclass(frozen=True)
class Body:
    """One body of the JAX tool's main: its kernel, the carries (a, b, d),
    chain length (c) or op (e), its output tile, trips and ops a trip."""

    kernel: str
    variant: object
    tile: Tuple[int, int]
    trips: int
    ops: int


def _bodies() -> Dict[str, Body]:
    bodies = {"a": Body("loop_fma", 1, TILE8, N, 1)}
    for k in (2, 4, 8, 16, 32):
        bodies[f"b{k}"] = Body("loop_fma", k, TILE8, N, k)
    for k in (4, 16):
        bodies[f"c{k}"] = Body("loop_chain", k, TILE8, N // 8, k)
    for k in (1, 2, 4):
        bodies[f"d{k}"] = Body("loop_fma", k, TILE64, N // 4, k)
    for op in OPS:
        bodies[f"e_{op}"] = Body("loop_op", op, TILE8, N // 4, OP_CARRIES)
    return bodies


BODIES = _bodies()   # in the order of the JAX main
FMA_CARRIES = (1, 2, 4, 8, 16, 32)
CHAINS = (4, 16)


def variant_id(kernel: str, variant) -> int:
    return OPS.index(variant) if kernel == "loop_op" else int(variant)


# ---------------------------------------------------------------------------
# Inputs and plain PyTorch versions
# ---------------------------------------------------------------------------


def tool_inputs(device="cpu") -> Dict[Tuple[int, int], torch.Tensor]:
    """The JAX tool's inputs by tile: x8 = 1.0000001 on (8, 128), ones on
    (64, 128)."""
    return {TILE8: torch.full(TILE8, X8, device=device), TILE64: torch.ones(TILE64, device=device)}


def random_inputs(seed: int, device="cpu") -> Dict[Tuple[int, int], torch.Tensor]:
    """x = 1 + U(0, 1e-3) on each tile, from `seed`."""
    rng = np.random.default_rng(seed)
    return {t: torch.from_numpy((1 + 1e-3 * rng.random(t)).astype(np.float32)).to(device)
            for t in (TILE8, TILE64)}


def _check_x(x) -> None:
    if tuple(x.shape) not in (TILE8, TILE64):
        raise ValueError(f"x: want {TILE8} or {TILE64}, got {tuple(x.shape)}")


def _check_variant(kernel: str, variant) -> None:
    allowed = {"loop_fma": FMA_CARRIES, "loop_chain": CHAINS, "loop_op": OPS}[kernel]
    if variant not in allowed:
        raise ValueError(f"{kernel}: csrc/micro_loop.cu instantiates {allowed}, not {variant!r}")


def fma_plain(x, carries: int, niter: int, nblocks: Optional[int] = None):
    """a), b), d): `carries` carries from x + s, niter trips of c*1.000001 +
    x, summed (`tools/micro_loop.py:47-66, 80-94`)."""
    _check_x(x)
    _check_variant("loop_fma", carries)
    return mc.fma_carries_plain(x, carries, niter)


def chain_plain(x, k: int, niter: int, nblocks: Optional[int] = None):
    """c): one carry from x, niter trips of k dependent c*1.000001 + x
    (`:68-78`)."""
    _check_x(x)
    _check_variant("loop_chain", k)
    scale = torch.tensor(mc.FMA_SCALE, dtype=x.dtype, device=x.device)
    c = x
    for _ in range(niter):
        for _ in range(k):
            c = torch.addcmul(x, c, scale)
    return c


def _op_round(op: str, c, x):
    if op == "rsqrt":
        return torch.rsqrt(c + x)
    if op == "where":
        return torch.where(c > x, c, x) + 1e-7
    if op == "mul":
        return c * mc.FMA_SCALE
    if op == "add":
        return c + x
    return torch.where((c - x).abs() <= 1.0, c + x, x)


def op_plain(x, op: str, niter: int, nblocks: Optional[int] = None):
    """e): 8 carries from x + s, niter trips of `op`, summed (`:96-117`)."""
    _check_x(x)
    _check_variant("loop_op", op)
    c = x + torch.arange(OP_CARRIES, dtype=x.dtype, device=x.device).reshape(-1, 1, 1)
    for _ in range(niter):
        c = _op_round(op, c, x)
    acc = c[0]
    for s in range(1, OP_CARRIES):
        acc = acc + c[s]
    return acc


PLAIN = {"loop_fma": fma_plain, "loop_chain": chain_plain, "loop_op": op_plain}


# ---------------------------------------------------------------------------
# CUDA kernel launchers
# ---------------------------------------------------------------------------


def fill_blocks(device, kernel: str, variant) -> int:
    """CTAs that fill every SM of the card at the kernel's occupancy."""
    lib = cuda_build.library()
    with torch.cuda.device(device):
        n = lib.micro_loop_fill(KERNEL_ID[kernel], variant_id(kernel, variant))
    if n <= 0:
        raise ValueError(f"csrc/micro_loop.cu has no {kernel} kernel at {variant!r}")
    return n


def _loop_kernel(kernel: str, x, variant, niter: int, nblocks: Optional[int]):
    _check_x(x)
    _check_variant(kernel, variant)
    tile = tuple(x.shape)
    dev = ar._check_card(x=(x, torch.float32, tile))
    nelem = x.numel()
    nb = nelem // CTA if nblocks is None else nblocks
    if nb < nelem // CTA:
        raise ValueError(f"nblocks {nb} < {nelem // CTA}: the output needs them")
    out = torch.empty(nb * CTA, dtype=torch.float32, device=dev)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = getattr(lib, kernel)(x.data_ptr(), nelem, variant_id(kernel, variant), niter, nb,
                                   out.data_ptr(), ph._stream(dev))
    cuda_build.check(kernel, err)
    return out[:nelem].view(tile)


def fma_kernel(x, carries: int, niter: int, nblocks: Optional[int] = None):
    """From `loop_fma` over nblocks CTAs (default: one copy of x)."""
    return _loop_kernel("loop_fma", x, carries, niter, nblocks)


def chain_kernel(x, k: int, niter: int, nblocks: Optional[int] = None):
    """From `loop_chain`."""
    return _loop_kernel("loop_chain", x, k, niter, nblocks)


def op_kernel(x, op: str, niter: int, nblocks: Optional[int] = None):
    """From `loop_op`."""
    return _loop_kernel("loop_op", x, op, niter, nblocks)


LAUNCH = {"loop_fma": fma_kernel, "loop_chain": chain_kernel, "loop_op": op_kernel}


def run_plain(label: str, x, niter: int, nblocks: Optional[int] = None):
    b = BODIES[label]
    return PLAIN[b.kernel](x, b.variant, niter, nblocks)


def run_kernel(label: str, x, niter: int, nblocks: Optional[int] = None):
    b = BODIES[label]
    return LAUNCH[b.kernel](x, b.variant, niter, nblocks)


class MicroLoop:
    """The three wrappers, with a launch counter per kernel: `launches[name]`
    starts at 0 and grows by one each time a wrapper launches its CUDA
    kernel, and at no other time.  A CPU tensor takes the plain version,
    where nblocks means nothing."""

    def __init__(self):
        self.launches = dict.fromkeys(KERNELS, 0)

    def run(self, label: str, x, niter: int, nblocks: Optional[int] = None):
        if x.device.type == "cpu":
            return run_plain(label, x, niter, nblocks)
        out = run_kernel(label, x, niter, nblocks)
        self.launches[BODIES[label].kernel] += 1
        return out


# ---------------------------------------------------------------------------
# The SASS of the built kernels
# ---------------------------------------------------------------------------


def sass_pattern(kernel: str, variant) -> str:
    name = {"loop_fma": "15loop_fma_kernel", "loop_chain": "17loop_chain_kernel",
            "loop_op": "14loop_op_kernel"}[kernel]
    return f"{name}ILi{variant_id(kernel, variant)}E"


# e)'s opcode that counts one op, eight a trip
OP_MAIN = {"rsqrt": "MUFU.RSQ", "where": "FADD", "mul": "FMUL", "add": "FADD",
           "sub_abs_cmp": "FSETP"}


def op_loop(sass: ar.Sass, op: str) -> dict:
    """e)'s trip loop: the innermost loop with its main opcode; ok if it
    holds 8 of it a trip, one trip a loop; the fp32 and MUFU instructions a
    trip as the card computes the op (where: FMNMX or FSETP + FSEL)."""
    key = OP_MAIN[op]
    loops = [c for c in ar.innermost_loops(sass) if c[key]]
    if not loops:
        return dict(ok=False)
    c = loops[0]
    fp32 = {k: c[k] for k in ar.FP32_OPCODES if c[k]}
    return dict(ok=len(loops) == 1 and c[key] == OP_CARRIES, main=key,
                fp32_per_trip=sum(fp32.values()), mufu_per_trip=mc._mufu(c),
                insts_per_trip=sum(c.values()), fp32=fp32,
                fmnmx=bool(c["FMNMX"]) if op == "where" else None)


def check_sass(lib_path) -> Dict[str, dict]:
    """`check_funcs` of the built library."""
    return check_funcs(ar.sass_functions(lib_path))


def check_funcs(funcs) -> Dict[str, dict]:
    """"kernel variant" -> dict(ok, counts): every loop_fma and loop_chain
    instantiation's trip loop holds its FFMAs once (a: 1 FFMA and the loop's
    own instructions) and no other fp32 instruction; every loop_op
    instantiation 8 of its op once."""
    report = {}
    for k in FMA_CARRIES:
        r = mc.fma_loop(ar._one(funcs, sass_pattern("loop_fma", k)), k)
        r["ok"] = r["ok"] and r["trips_a_loop"] == 1
        report[f"loop_fma {k}"] = r
    for k in CHAINS:
        r = mc.fma_loop(ar._one(funcs, sass_pattern("loop_chain", k)), k)
        r["ok"] = r["ok"] and r["trips_a_loop"] == 1
        report[f"loop_chain {k}"] = r
    for op in OPS:
        report[f"loop_op {op}"] = op_loop(ar._one(funcs, sass_pattern("loop_op", op)), op)
    return report


def fp32_mufu_per_trip(report: Dict[str, dict], label: str) -> Tuple[float, float]:
    """The fp32 and MUFU instructions a thread issues a trip of `label`, as
    the SASS holds them."""
    b = BODIES[label]
    r = report[f"{b.kernel} {b.variant}"]
    if b.kernel == "loop_op":
        return r["fp32_per_trip"], r["mufu_per_trip"]
    return r["ffma_per_trip"], 0.0


# ---------------------------------------------------------------------------
# Parity and the readings
# ---------------------------------------------------------------------------


def card_parity(device, seed: int = 0) -> Dict[str, Tuple[float, bool]]:
    """Each body's kernel against its plain version on the card at 1/64 of
    its JAX trips over 2 copies, its launches not counted; "label case" ->
    (max abs err, within tolerance), on the tool's inputs and on
    `random_inputs`.  Exact for all but rsqrt (the same fused FMAs, adds,
    multiplies and selects, each rounded once); e) rsqrt rtol 1e-6 (the
    card's MUFU rsqrt against torch's on the same card: the iteration
    contracts to a fixed point, so the difference does not grow)."""
    res = {}
    for case, xs in (("tool", tool_inputs(device)), ("random", random_inputs(seed, device))):
        for label, b in BODIES.items():
            x = xs[b.tile]
            n = b.trips // PARITY_DIV
            got = run_kernel(label, x, n, 2 * x.numel() // CTA)
            want = run_plain(label, x, n)
            rtol = RTOL_RSQRT if label == "e_rsqrt" else 0.0
            res[f"{label} {case}"] = (float((got - want).abs().max()),
                                      torch.allclose(got, want, rtol=rtol, atol=0.0))
    return res


def read_body(ml: MicroLoop, label: str, nblocks: int, xs, reps: int) -> dict:
    """One body's reading through `ml` at nblocks: the marginal between a
    quarter of its JAX trips and all of them; ns a trip and an op of the
    grid, ns a trip and an op of one copy (the JAX tool's numbers at one
    copy), and element ops a second."""
    b = BODIES[label]
    x = xs[b.tile]
    sizes = (b.trips // 4, b.trips)
    dt, t_lo, t_hi = ar.marginal(lambda n: ml.run(label, x, n, nblocks), sizes, reps)
    dtrips = sizes[1] - sizes[0]
    copies = nblocks * CTA / x.numel()
    ns_trip = dt * 1e9 / dtrips
    return dict(nblocks=nblocks, trips=list(sizes), ms=[t_lo, t_hi], ns_per_trip=ns_trip,
                ns_per_op=ns_trip / b.ops, ns_per_copy_op=ns_trip / b.ops / copies,
                lane_ops_per_s=dtrips * b.ops * nblocks * CTA / dt)


def read_all(ml: MicroLoop, device, reps: int) -> dict:
    """Every body at the JAX size and with the card filled, through `ml`
    (counted), at the tool's inputs; the anchor's fma 16x16 rate and serial
    latency beside them; the SM clock sampled."""
    xs = tool_inputs(device)
    anchor = ar.Anchor()
    res = {"bodies": {}}
    with ar.ClockSampler(device) as clock:
        for label, b in BODIES.items():
            geo = {"jax": b.tile[0] * b.tile[1] // CTA,
                   "card": fill_blocks(device, b.kernel, b.variant)}
            res["bodies"][label] = {g: read_body(ml, label, nb, xs, reps) for g, nb in geo.items()}
        res["anchor_fma"] = mc.anchor_fma(anchor, device, reps)
        res["anchor_serial"] = mc.anchor_fma(anchor, device, reps, serial=True)
    res["clocks_sm_mhz"] = clock.summary()
    return res


def _line(label: str, r: dict) -> str:
    """The JAX tool's print of `label` (`:56-107`) from reading r."""
    b = BODIES[label]
    per, op = r["ns_per_trip"], r["ns_per_op"]
    if label == "a":
        return f"a) fori 1x(8,128) fma:  {per:7.2f} ns/iter"
    if label.startswith("b"):
        return f"b) fori {b.variant:2d}x(8,128) fma: {per:7.2f} ns/iter -> {op:6.2f} ns/fma"
    if label.startswith("c"):
        return (f"c) fori chain {b.variant:2d} fma:  {per:7.2f} ns/iter -> {op:6.2f} ns/fma "
                f"(latency)")
    if label.startswith("d"):
        return (f"d) fori {b.variant}x(64,128) fma: {per:7.2f} ns/iter -> {op:6.2f} ns/op, "
                f"{op / 8:5.2f} ns/slot")
    return f"e) 8x(8,128) {b.variant:12s}: {op:6.2f} ns/op"


def main(argv=None) -> int:
    from pbf_sph_tpu_torch.tools.bench_kernel_variants import card_line

    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 10
    if not torch.cuda.is_available():
        raise SystemExit("micro_loop: needs a CUDA device")
    card = card_line()
    print(card)
    device = torch.device("cuda", torch.cuda.current_device())

    print("== SASS of csrc/micro_loop.cu (cuobjdump)")
    cuda_build.library()
    sass = check_sass(cuda_build.library_path())
    for name, r in sass.items():
        print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in r.items()))
    if mc.short(sass):
        raise SystemExit(f"micro_loop: the SASS of {mc.short(sass)} is off: the compiler "
                         f"unrolled or folded a trip, so no rate is printed")
    parity = card_parity(device)
    print("== each kernel against its plain version: " + ", ".join(
        f"{k} {e:.3e}" for k, (e, _) in parity.items()))
    wrong = [k for k, (_, ok) in parity.items() if not ok]
    if wrong:
        raise SystemExit(f"micro_loop: {wrong} disagree with their plain versions")

    ml = MicroLoop()
    res = read_all(ml, device, reps)
    fma = res["anchor_fma"]
    serial = res["anchor_serial"]
    print(f"== SM clock beside the readings (nvidia-smi, MHz): {res['clocks_sm_mhz']}; the "
          f"rate anchor: fma 16x16 {fma['rate'] / 1e12:.3f} T FFMA/s, serial "
          f"{serial['ns_per_op']:.3f} ns a dependent FFMA (one warp an SM)")
    for geo, what in (("jax", "the JAX size: one copy, 1 CTA of 1024 threads (d: 8)"),
                      ("card", "the card filled")):
        print(f"== {what}; marginal between a quarter of the trips and all")
        for label, r in res["bodies"].items():
            g = r[geo]
            mark = ""
            if label in ("a", "b16", "c4", "c16"):
                mark = (f"   [{g['lane_ops_per_s'] / fma['rate']:.3f} of the anchor's fma rate; "
                        f"{g['ns_per_op'] / serial['ns_per_op']:.2f}x its serial ns an FFMA]")
            print(f"  {_line(label, g)}  ({g['nblocks']} CTAs, "
                  f"{g['lane_ops_per_s'] / 1e12:.3f} T lane-ops/s){mark}")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "reps": reps,
                      "sass": sass, "parity": {k: e for k, (e, _) in parity.items()},
                      "readings": res, "launches": ml.launches}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
