"""The transport of the slab and tile engines: what their steps ask of the
device mesh.

The JAX package's sharded steps run under `shard_map` and reach their
neighbours through `ppermute` and `psum` (`pbf_sph_tpu/parallel/sharded.py`,
`sharded2d.py`).  The port's step holds a communicator of one rank instead,
with this interface:

* `rank`, `size`;
* `exchange_peers(lo, hi, to_lo, to_hi) -> (from_lo, from_hi)`: `lo` and
  `hi` are ranks or None; `to_lo` goes to `lo`, `to_hi` to `hi`, and
  `from_lo` is what `lo` sent to its `hi` (this rank), `from_hi` what `hi`
  sent to its `lo`.  Each payload is a dict of tensors, with the same keys,
  shapes and dtypes on every rank and in both arguments.  A side with no
  peer (None) receives zeros of the same shapes and dtypes (`valid` False
  included), which is `ppermute`'s fill for a device that no pair targets.
  Every rank of the group calls it together, with or without peers;
* `exchange(to_left, to_right) -> (from_left, from_right)`: its rank +- 1
  case, not periodic (the slab engine's neighbours);
* `all_reduce_sum(t)`: the sum of `t` over the ranks, the same bits on
  every rank.

`MeshAxis` is one axis of an NX x NY mesh numbered x-major (rank = mx*NY +
my, as the JAX package's `make_mesh2d`): its `rank`/`size` along the axis,
its `exchange` with the neighbours along it (r +- NY along x, r +- 1 along y
within one mesh column), and `all_reduce_sum` over the whole group.  It
takes the place of `ppermute(..., "x"|"y", ...)` and of `psum(..., ("x",
"y"))`.

Two implementations:

* `DistComm` over `torch.distributed`, the product path: NCCL between cards,
  gloo on the CPU.  An exchange is one `batch_isend_irecv` group, each dict
  packed into one buffer per dtype, so a frame makes O(1) messages an
  exchange whatever the number of fields; bool travels as uint8 (NCCL has no
  bool).
* `ThreadComm`: `size` ranks as threads of one process on one device
  (`run_ranks`), with barriers and shared slots; the port's counterpart of
  the JAX tests' virtual CPU mesh, and the way to run the engines at more
  than one rank on one card.  Every rank enqueues on the device's current
  stream, which orders a sender's writes before the reads a receiver
  enqueues after the barrier, so no event is needed; a second barrier keeps
  a sender's buffers alive until every receiver has enqueued its copy.  A
  rank that raises aborts the barrier, and `run_ranks` re-raises its
  exception: a failing rank fails the call and never hangs it.

`all_gather_fixed` and `all_gather_cat` gather a tensor from every rank over
`all_reduce_sum` alone (each rank's bits in its own slot, zeros elsewhere,
summed as integers: exact for any value, NaN and -0.0 included).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

Tensors = Dict[str, torch.Tensor]

# seconds a ThreadComm rank waits at a barrier for the others
DEFAULT_TIMEOUT = 600.0


def _zeros_like(template: Tensors) -> Tensors:
    return {k: torch.zeros_like(v) for k, v in template.items()}


def _check_like(got: Tensors, template: Tensors) -> None:
    """Refuse a payload whose keys, shapes or dtypes differ from the
    receiver's own."""
    if list(got) != list(template):
        raise ValueError(f"exchange keys {list(got)} != {list(template)}")
    for k, v in got.items():
        t = template[k]
        if v.shape != t.shape or v.dtype != t.dtype:
            raise ValueError(f"exchange {k}: {v.dtype} {tuple(v.shape)} != "
                             f"{t.dtype} {tuple(t.shape)}")


def _line_peers(index: int, size: int, stride: int,
                base: int = 0) -> Tuple[Optional[int], Optional[int]]:
    """The ranks beside position `index` of a line of `size` positions,
    position i being rank base + i * stride; None past an end."""
    lo = base + (index - 1) * stride if index > 0 else None
    hi = base + (index + 1) * stride if index + 1 < size else None
    return lo, hi


def require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} needs a CUDA device, but torch.cuda.is_available() "
                           "is False (pass device='cpu' to run on the CPU)")
    return device


class MeshAxis:
    """One axis of an NX x NY mesh of `comm`'s ranks, numbered x-major:
    `axis` 0 pairs rank r with r +- NY, axis 1 with r +- 1 inside r's mesh
    column.  `rank`/`size` are along the axis; `all_reduce_sum` is over the
    whole group."""

    def __init__(self, comm, shape: Tuple[int, int], axis: int):
        nx, ny = shape
        if comm.size != nx * ny:
            raise ValueError(f"a {nx}x{ny} mesh needs {nx * ny} ranks, the group has "
                             f"{comm.size}")
        mx, my = divmod(comm.rank, ny)
        self.comm = comm
        if axis == 0:
            self.rank, self.size = mx, nx
            self.peers = _line_peers(mx, nx, ny, my)
        else:
            self.rank, self.size = my, ny
            self.peers = _line_peers(my, ny, 1, mx * ny)

    def exchange(self, to_lo: Tensors, to_hi: Tensors) -> Tuple[Tensors, Tensors]:
        return self.comm.exchange_peers(*self.peers, to_lo, to_hi)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce_sum(t)


# ---------------------------------------------------------------------------
# ThreadComm
# ---------------------------------------------------------------------------


class _Shared:
    """What the ranks of one `run_ranks` call share."""

    def __init__(self, size: int, device: torch.device, timeout: float):
        self.size = size
        self.device = device
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.slots: List[Any] = [None] * size


class ThreadComm:
    """One rank of `run_ranks`: its ranks are threads of this process on one
    device."""

    def __init__(self, rank: int, shared: _Shared):
        self.rank = rank
        self.size = shared.size
        self.device = shared.device
        self._s = shared

    def _check(self, tensors) -> None:
        for t in tensors:
            if t.device != self.device:
                raise ValueError(
                    f"ThreadComm ranks share one device ({self.device}); got a "
                    f"tensor on {t.device}")

    def _post(self, value) -> List[Any]:
        """Put `value` in this rank's slot and wait for every rank's."""
        self._s.slots[self.rank] = value
        self._s.barrier.wait()
        return self._s.slots

    def exchange_peers(self, lo: Optional[int], hi: Optional[int], to_lo: Tensors,
                       to_hi: Tensors) -> Tuple[Tensors, Tensors]:
        self._check(list(to_lo.values()) + list(to_hi.values()))
        _check_like(to_lo, to_hi)
        slots = self._post((lo, hi, to_lo, to_hi))
        out, err = [], None
        # from lo: what lo sent to its hi; from hi: what hi sent to its lo
        for peer, side, template in ((lo, 1, to_hi), (hi, 0, to_lo)):
            if peer is None:
                out.append(_zeros_like(template))
            elif slots[peer][side] != self.rank:
                err = ValueError(f"rank {self.rank} pairs with {peer}, which pairs with "
                                 f"{slots[peer][side]}")
            else:
                sent = slots[peer][2 + side]
                _check_like(sent, template)
                out.append({k: v.clone() for k, v in sent.items()})
        # the senders' buffers stay alive until every copy is enqueued (a
        # refused pairing waits too, so that the other ranks do not)
        self._s.barrier.wait()
        if err is not None:
            raise err
        return out[0], out[1]

    def exchange(self, to_left: Tensors, to_right: Tensors) -> Tuple[Tensors, Tensors]:
        return self.exchange_peers(*_line_peers(self.rank, self.size, 1), to_left, to_right)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        self._check([t])
        slots = self._post(t)
        total = slots[0].clone()
        for r in range(1, self.size):  # rank order: the same bits on every rank
            total = total + slots[r]
        self._s.barrier.wait()
        return total


def run_ranks(n: int, fn: Callable[[ThreadComm], Any], device="cuda",
              timeout: float = DEFAULT_TIMEOUT) -> List[Any]:
    """Run `fn(comm)` for ranks 0..n-1 as threads on `device` (the card
    unless the caller asks for the CPU; without a card a CUDA device
    raises); returns their results in rank order.  Every barrier wait is
    bounded by `timeout` seconds.  If a rank raises, the barrier is aborted
    so that no rank waits for it, and its exception is raised here."""
    device = require_device(device)
    shared = _Shared(n, device, timeout)
    stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
    results: List[Any] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n

    def body(rank: int) -> None:
        try:
            comm = ThreadComm(rank, shared)
            if stream is None:
                results[rank] = fn(comm)
            else:
                torch.cuda.set_device(device)
                with torch.cuda.stream(stream):
                    results[rank] = fn(comm)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors[rank] = e
            shared.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,), name=f"rank {r}/{n}", daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    failed_at = None
    while any(t.is_alive() for t in threads):
        for t in threads:
            t.join(0.05)
        if failed_at is None and any(e is not None for e in errors):
            failed_at = time.monotonic()
        if failed_at is not None and time.monotonic() - failed_at > timeout:
            break  # a rank that neither returns nor waits: give up on it
    raised = [(r, e) for r, e in enumerate(errors) if e is not None]
    if raised:
        # the first rank's own error, not a rank the abort broke out of a wait
        own = [(r, e) for r, e in raised if not isinstance(e, threading.BrokenBarrierError)]
        r, err = (own or raised)[0]
        err.add_note(f"raised on rank {r} of {n} (ThreadComm)")
        raise err
    stuck = [t.name for t in threads if t.is_alive()]
    if stuck:
        raise TimeoutError(f"ranks still running after a failure: {stuck}")
    return results


# ---------------------------------------------------------------------------
# DistComm
# ---------------------------------------------------------------------------


def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.uint8 if dtype == torch.bool else dtype


def _groups(template: Tensors) -> List[Tuple[torch.dtype, List[str]]]:
    """The keys of a dict grouped by wire dtype, in an order every rank
    derives alike."""
    by = {}
    for k, v in template.items():
        by.setdefault(_wire_dtype(v.dtype), []).append(k)
    return sorted(by.items(), key=lambda kv: str(kv[0]))


class DistComm:
    """A rank of a `torch.distributed` process group on `device` (one card a
    rank with NCCL, the CPU with gloo).  The group must be initialised."""

    def __init__(self, device, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = torch.device(device)
        # the first call on a group must involve every rank before any
        # point-to-point call does (batch_isend_irecv's NCCL rule)
        self.all_reduce_sum(torch.zeros(1, dtype=torch.int32, device=self.device))

    def _check(self, tensors) -> None:
        for t in tensors:
            if t.device != self.device:
                raise ValueError(f"DistComm rank {self.rank} is on {self.device}; "
                                 f"got a tensor on {t.device}")

    def exchange_peers(self, lo: Optional[int], hi: Optional[int], to_lo: Tensors,
                       to_hi: Tensors) -> Tuple[Tensors, Tensors]:
        dist = self._dist
        self._check(list(to_lo.values()) + list(to_hi.values()))
        _check_like(to_lo, to_hi)
        ops, recvs = [], []
        for peer, send, template in ((lo, to_lo, to_hi), (hi, to_hi, to_lo)):
            if peer is None:
                recvs.append(None)
                continue
            bufs = []
            for tag, (wire, keys) in enumerate(_groups(template)):
                sbuf = torch.cat([send[k].reshape(-1).to(wire) for k in keys])
                rbuf = torch.empty(sum(template[k].numel() for k in keys), dtype=wire,
                                   device=self.device)
                ops.append(dist.P2POp(dist.isend, sbuf, peer, self.group, tag))
                ops.append(dist.P2POp(dist.irecv, rbuf, peer, self.group, tag))
                bufs.append((keys, rbuf))
            recvs.append((template, bufs))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        got = []
        for recv, template in zip(recvs, (to_hi, to_lo)):
            if recv is None:
                got.append(_zeros_like(template))
                continue
            out = {}
            for keys, rbuf in recv[1]:
                off = 0
                for k in keys:
                    t = template[k]
                    out[k] = rbuf[off:off + t.numel()].reshape(t.shape).to(t.dtype)
                    off += t.numel()
            got.append({k: out[k] for k in template})
        return got[0], got[1]

    def exchange(self, to_left: Tensors, to_right: Tensors) -> Tuple[Tensors, Tensors]:
        return self.exchange_peers(*_line_peers(self.rank, self.size, 1), to_left, to_right)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        self._check([t])
        out = t.clone()
        self._dist.all_reduce(out, op=self._dist.ReduceOp.SUM, group=self.group)
        return out


# ---------------------------------------------------------------------------
# Gathers over all_reduce_sum
# ---------------------------------------------------------------------------

_BITS = {torch.float64: torch.int64, torch.float32: torch.int32,
         torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _to_bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bool:
        return t.to(torch.int32)
    t = t.contiguous()
    return t.view(_BITS[t.dtype]) if t.dtype in _BITS else t


def _from_bits(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bool:
        return b != 0
    return b.view(dtype) if dtype in _BITS else b


def all_gather_fixed(comm, t: torch.Tensor) -> torch.Tensor:
    """(size, *t.shape): every rank's `t` (the same shape on every rank), in
    rank order, on every rank."""
    bits = _to_bits(t)
    buf = torch.zeros((comm.size,) + tuple(t.shape), dtype=bits.dtype, device=t.device)
    buf[comm.rank] = bits
    return _from_bits(comm.all_reduce_sum(buf), t.dtype)


def all_gather_cat(comm, t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (..., n_rank), the lengths free and the leading shape
    alike, concatenated along the last axis in rank order, on every rank.
    Reads the lengths back to the host."""
    n = torch.tensor([t.shape[-1]], dtype=torch.int64, device=t.device)
    counts = all_gather_fixed(comm, n)[:, 0].tolist()
    off = sum(counts[:comm.rank])
    bits = _to_bits(t)
    buf = torch.zeros(tuple(t.shape[:-1]) + (sum(counts),), dtype=bits.dtype, device=t.device)
    buf[..., off:off + t.shape[-1]] = bits
    return _from_bits(comm.all_reduce_sum(buf), t.dtype)


def gather_rank_values(comm, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """(len(values), size) int64 of 0-d integer tensors, every rank's in its
    column: a frame's per-rank counters in one collective."""
    v = torch.stack([x.reshape(()).to(torch.int64) for x in values])
    return all_gather_fixed(comm, v).T
