"""The transport of the slab engine: what its step asks of the device mesh.

The JAX package's sharded step runs under `shard_map` and reaches its
neighbours through `ppermute` and `psum` (`pbf_sph_tpu/parallel/sharded.py`).
The port's step holds a communicator of one rank instead, with this
interface:

* `rank`, `size`;
* `exchange(to_left, to_right) -> (from_left, from_right)`: each argument a
  dict of tensors, with the same keys, shapes and dtypes on every rank and in
  both arguments.  It is not periodic: a rank with no neighbour on a side
  receives zeros of the same shapes and dtypes from that side (`valid` False
  included), which is `ppermute`'s fill for a device that no pair targets;
* `all_reduce_sum(t)`: the sum of `t` over the ranks, the same bits on
  every rank.

Two implementations:

* `DistComm` over `torch.distributed`, the product path: NCCL between cards,
  gloo on the CPU.  An exchange is one `batch_isend_irecv` group, each dict
  packed into one buffer per dtype, so a frame makes O(1) messages an
  exchange whatever the number of fields; bool travels as uint8 (NCCL has no
  bool).
* `ThreadComm`: `size` ranks as threads of one process on one device
  (`run_ranks`), with barriers and shared slots; the port's counterpart of
  the JAX tests' virtual CPU mesh, and the way to run the engine at D > 1 on
  one card.  Every rank enqueues on the device's current stream, which
  orders a sender's writes before the reads a receiver enqueues after the
  barrier, so no event is needed; a second barrier keeps a sender's buffers
  alive until every receiver has enqueued its copy.  A rank that raises
  aborts the barrier, and `run_ranks` re-raises its exception: a failing
  rank fails the call and never hangs it.

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

    def exchange(self, to_left: Tensors, to_right: Tensors) -> Tuple[Tensors, Tensors]:
        self._check(list(to_left.values()) + list(to_right.values()))
        _check_like(to_left, to_right)
        slots = self._post((to_left, to_right))
        out = []
        # from the left: what the left neighbour sent right; from the right:
        # what the right neighbour sent left
        for nbr, side, template in ((self.rank - 1, 1, to_right),
                                    (self.rank + 1, 0, to_left)):
            if 0 <= nbr < self.size:
                sent = slots[nbr][side]
                _check_like(sent, template)
                out.append({k: v.clone() for k, v in sent.items()})
            else:
                out.append(_zeros_like(template))
        # the senders' buffers stay alive until every copy is enqueued
        self._s.barrier.wait()
        return out[0], out[1]

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        self._check([t])
        slots = self._post(t)
        total = slots[0].clone()
        for r in range(1, self.size):  # rank order: the same bits on every rank
            total = total + slots[r]
        self._s.barrier.wait()
        return total


def run_ranks(n: int, fn: Callable[[ThreadComm], Any], device="cpu",
              timeout: float = DEFAULT_TIMEOUT) -> List[Any]:
    """Run `fn(comm)` for ranks 0..n-1 as threads on `device`; returns their
    results in rank order.  Every barrier wait is bounded by `timeout`
    seconds.  If a rank raises, the barrier is aborted so that no rank waits
    for it, and its exception is raised here."""
    device = torch.device(device)
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

    def exchange(self, to_left: Tensors, to_right: Tensors) -> Tuple[Tensors, Tensors]:
        dist = self._dist
        self._check(list(to_left.values()) + list(to_right.values()))
        _check_like(to_left, to_right)
        ops, recvs = [], []
        for peer, send, template in ((self.rank - 1, to_left, to_right),
                                     (self.rank + 1, to_right, to_left)):
            if not 0 <= peer < self.size:
                continue
            bufs = []
            for tag, (wire, keys) in enumerate(_groups(template)):
                sbuf = torch.cat([send[k].reshape(-1).to(wire) for k in keys])
                rbuf = torch.empty(sum(template[k].numel() for k in keys), dtype=wire,
                                   device=self.device)
                ops.append(dist.P2POp(dist.isend, sbuf, peer, self.group, tag))
                ops.append(dist.P2POp(dist.irecv, rbuf, peer, self.group, tag))
                bufs.append((keys, rbuf))
            recvs.append((peer, template, bufs))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        got = {}
        for peer, template, bufs in recvs:
            out = {}
            for keys, rbuf in bufs:
                off = 0
                for k in keys:
                    t = template[k]
                    out[k] = rbuf[off:off + t.numel()].reshape(t.shape).to(t.dtype)
                    off += t.numel()
            got[peer] = {k: out[k] for k in template}
        from_left = got.get(self.rank - 1) or _zeros_like(to_right)
        from_right = got.get(self.rank + 1) or _zeros_like(to_left)
        return from_left, from_right

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
