"""Multi-process runtime: a ``torch.distributed`` world and the
host-sharded data plane.

Counterpart of ``predictionio_tpu/parallel/multihost.py``. Where the JAX
package brings up ``jax.distributed`` and assembles per-host arrays into
global ``jax.Array``s, the port follows PyTorch's own idiom: one device
per process, a ``torch.distributed`` world over the processes (NCCL for
a rank on a CUDA device, gloo for a rank on the CPU), and explicit
collectives. Every process runs the same program; each reads its own
entity-hash shard of the event store and the columns are reassembled
over the world (``exchange_columns``).

One process is the degenerate case: with no world every helper is the
identity, so engines written against this module run unchanged from one
process to many.

The helpers carry host data (strings, counts, the npz wire blob of a
columnar read) in tensors on the collective device: the rank's card
under NCCL, the CPU under gloo. Device tensors go through
:func:`all_gather_rows`, which under gloo stages a CUDA tensor through
host memory (``_gloo_host_staged``; gloo gathers no CUDA tensor) and
never does so under NCCL; :func:`all_reduce_sum`, :func:`gather_shards`
and :func:`ring_shift` (the trainers' sum over an axis group, their
differentiable gather, and the ring attention's neighbour exchange)
stage the same way.

A world this module brings up leaves when its process ends: an exit
hook runs :func:`shutdown` (a barrier over the world's store, bounded
by ``EXIT_BARRIER_SECONDS``, then ``destroy_process_group``). A rank
that ends with a live gloo or NCCL group can abort in the group's
teardown at interpreter exit, after its work is done.
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os
import time
from typing import Callable, Iterable, List, Optional, TypeVar

import numpy as np
import torch
import torch.distributed as dist

from predictionio_torch.parallel.context import DeviceLike

log = logging.getLogger(__name__)

T = TypeVar("T")

#: this rank's device, set by initialize_from_env (None: no world yet,
#: or a world that someone else set up and no device was asked for)
_rank_device: Optional[torch.device] = None

#: the store of a world initialize_from_env brought up (None: no world,
#: or one the caller brought up); the exit barrier runs over it
_store: Optional[dist.Store] = None

#: how long the exit barrier waits for the other ranks: a rank whose
#: peer died leaves after this long instead of hanging
EXIT_BARRIER_SECONDS = 30.0

_exit_hook_registered = False


def _stable_hash(s: str) -> int:
    # imported here: data.storage imports modules that import this
    # package
    from predictionio_torch.data.storage import stable_hash

    return stable_hash(s)


def _world() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_device(device: DeviceLike = None,
                process_id: Optional[int] = None) -> torch.device:
    """The device a rank computes on: ``device`` when the caller names
    one (``"cpu"`` included), else ``cuda:{process_id % cards}``. A rank
    with no CUDA and no device asked for raises, as the single-process
    default does."""
    if device is not None:
        from predictionio_torch.parallel.context import resolve_device

        return resolve_device(device)
    if _rank_device is not None and process_id is None:
        return _rank_device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "predictionio_torch runs each rank on a CUDA device and none "
            "is available; pass device='cpu' (CLI: --device cpu) to run "
            "the ranks on the CPU")
    pid = process_index() if process_id is None else process_id
    return torch.device("cuda", pid % torch.cuda.device_count())


def initialize_from_env(device: DeviceLike = None) -> bool:
    """Bring up the ``torch.distributed`` world from the environment;
    idempotent.

      PIO_COORDINATOR_ADDRESS  host:port of process 0 (opts in)
      PIO_NUM_PROCESSES        world size
      PIO_PROCESS_ID           this process's rank

    A rank on a CUDA device joins over NCCL, a rank on the CPU over
    gloo; ``device`` names the rank's device (``"cpu"``), else it is
    ``cuda:{rank % cards}``, made the current CUDA device. Returns True
    when a world is up after the call. A world that is already up (set
    up by this call earlier, or by the caller with its own backend) is
    left as it is, and the call returns True. Raises when only some of
    the variables are set. A world this call brings up is left at
    process exit (:func:`shutdown` from an ``atexit`` hook)."""
    global _rank_device, _store, _exit_hook_registered
    if _world():
        if device is not None or (_rank_device is None
                                  and torch.cuda.is_available()):
            _rank_device = rank_device(device, dist.get_rank())
            if _rank_device.type == "cuda":
                torch.cuda.set_device(_rank_device)
        return True
    addr = os.environ.get("PIO_COORDINATOR_ADDRESS")
    if not addr:
        return False
    num_s = os.environ.get("PIO_NUM_PROCESSES")
    pid_s = os.environ.get("PIO_PROCESS_ID")
    if num_s is None or pid_s is None:
        raise RuntimeError(
            "PIO_COORDINATOR_ADDRESS is set but PIO_NUM_PROCESSES / "
            "PIO_PROCESS_ID are missing: all three are required for "
            "multi-process mode")
    num, pid = int(num_s), int(pid_s)
    dev = rank_device(device, pid)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    host, port = addr.rsplit(":", 1)
    # the store is made here (what init_method="tcp://" would make) so
    # that the exit barrier can run over it
    from torch.distributed.constants import default_pg_timeout

    store = dist.TCPStore(host, int(port), num, pid == 0,
                          timeout=default_pg_timeout)
    dist.init_process_group(backend, store=store, world_size=num, rank=pid)
    _rank_device, _store = dev, store
    if not _exit_hook_registered:
        atexit.register(_leave_at_exit)
        _exit_hook_registered = True
    log.info("torch.distributed up: rank %d/%d over %s on %s", pid, num,
             backend, dev)
    return True


def _exit_barrier(timeout: float) -> None:
    """Every rank of the world at this point, over the store: the last
    to arrive sets a key the others wait for, and process 0, whose
    process hosts the store, leaves only after the others have seen it.
    Raises (``DistStoreError``, ``TimeoutError``) when a rank does not
    come within ``timeout`` seconds, a peer that died for one."""
    n = dist.get_world_size()
    store = _store
    if store is None or n == 1:
        return
    wait = datetime.timedelta(seconds=timeout)
    if store.add("pio_exit/arrived", 1) == n:
        store.set("pio_exit/all", "1")
    else:
        store.wait(["pio_exit/all"], wait)
    if process_index() != 0:
        store.add("pio_exit/left", 1)
        return
    deadline = time.monotonic() + timeout
    while store.add("pio_exit/left", 0) < n - 1:
        if time.monotonic() > deadline:
            raise TimeoutError(f"ranks still in the exit barrier after "
                               f"{timeout} s")
        time.sleep(0.005)


def shutdown() -> None:
    """Leave the world: a barrier of every rank (a world this module
    brought up; bounded by ``EXIT_BARRIER_SECONDS``, after which the
    rank leaves without it), then ``destroy_process_group``. Every rank
    calls it, or the exit hook does; a no-op without a world, so a
    second call does nothing."""
    global _rank_device, _store
    if _world():
        try:
            _exit_barrier(EXIT_BARRIER_SECONDS)
        except (RuntimeError, TimeoutError) as e:
            # DistStoreError and DistNetworkError are RuntimeErrors: a
            # peer that died or left before the barrier
            log.warning("leaving the world without the exit barrier: %s",
                        e)
        dist.destroy_process_group()
    _rank_device, _store = None, None


def _leave_at_exit() -> None:
    try:
        shutdown()
    except Exception:  # noqa: BLE001 — exit proceeds; say why it failed
        log.exception("leaving the torch.distributed world at exit failed")


def process_index() -> int:
    return dist.get_rank() if _world() else 0


def process_count() -> int:
    return dist.get_world_size() if _world() else 1


def _collective_device(group=None) -> torch.device:
    """Where a collective of ``group`` takes its tensors: the rank's card
    under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return (_rank_device if _rank_device is not None
                else torch.device("cuda", torch.cuda.current_device()))
    return torch.device("cpu")


def host_shard_by_entity(
    items: Iterable[T],
    entity_id: Callable[[T], str],
    n_hosts: Optional[int] = None,
    host: Optional[int] = None,
) -> List[T]:
    """This process's slice of a record stream, split by entity id:
    all of one entity's records land on one process (the reference's
    HBase rowkey prefix hashing, hbase/HBEventsUtil.scala RowKey:81)."""
    n = n_hosts if n_hosts is not None else process_count()
    h = host if host is not None else process_index()
    if n <= 1:
        return list(items)
    return [x for x in items if _stable_hash(entity_id(x)) % n == h]


def host_shard_slice(n_total: int, n_hosts: Optional[int] = None,
                     host: Optional[int] = None) -> slice:
    """Contiguous ``[start, stop)`` slice of a length-``n_total`` axis
    owned by this process (balanced to within 1)."""
    n = n_hosts if n_hosts is not None else process_count()
    h = host if host is not None else process_index()
    base, extra = divmod(n_total, n)
    start = h * base + min(h, extra)
    return slice(start, start + base + (1 if h < extra else 0))


def _gather_sizes(size: int, group=None) -> List[int]:
    """Every rank's ``size`` in rank order."""
    t = torch.tensor([size], dtype=torch.int64,
                     device=_collective_device(group))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return [int(p.item()) for p in parts]


def _gather_bytes(raw: bytes, group=None) -> List[bytes]:
    """Every rank's ``raw`` in rank order (lengths may differ)."""
    lens = _gather_sizes(len(raw), group)
    buf = torch.zeros(max(max(lens), 1), dtype=torch.uint8)
    if raw:
        buf[:len(raw)] = torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
    buf = buf.to(_collective_device(group))
    parts = [torch.empty_like(buf) for _ in lens]
    dist.all_gather(parts, buf, group=group)
    return [p[:m].cpu().numpy().tobytes() for p, m in zip(parts, lens)]


def broadcast_string(s: str) -> str:
    """Process 0's string on every process (identity with one). The
    workflow's single-writer coordination: every rank runs the same
    train, but one EngineInstance row and one model blob may exist per
    run, so all agree on process 0's instance id."""
    if process_count() == 1:
        return s
    dev = _collective_device()
    raw = s.encode("utf-8")
    size = torch.tensor([len(raw)], dtype=torch.int64, device=dev)
    dist.broadcast(size, src=0)
    if process_index() == 0:
        buf = torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
    else:
        buf = torch.zeros(int(size.item()), dtype=torch.uint8)
    buf = buf.to(dev)
    if buf.numel():
        dist.broadcast(buf, src=0)
    return buf.cpu().numpy().tobytes().decode("utf-8")


def barrier(name: str) -> None:
    """Block until every process reaches this point (no-op with one).
    ``name`` must match across processes: each rank contributes the hash
    of its name, and a rank that reached another barrier raises."""
    if process_count() == 1:
        return
    h = _stable_hash(name) & 0x7FFFFFFFFFFF
    t = torch.tensor([h, -h], dtype=torch.int64, device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if int(t[0]) != h or -int(t[1]) != h:
        raise RuntimeError(f"barrier {name!r} met a process at another "
                           "barrier")


def exchange_columns(cols, time_ordered: bool = False):
    """All-exchange of per-process columnar read shards: every process
    hands in the ``EventColumns`` it read (its entity-hash shard,
    ``find_columnar(shard_index=process_index())``) and receives the
    merged full columns. The shards concatenate in process order, so
    every process assembles identical columns; pass ``time_ordered``
    where global time order matters (a shard's order does not survive
    the concatenation). One process: ``merge_columns([cols])``."""
    from predictionio_torch.data.storage import (columns_to_npz,
                                                 merge_columns,
                                                 npz_to_columns)

    if process_count() == 1:
        return merge_columns([cols], time_ordered=time_ordered)
    parts = [npz_to_columns(b) for b in _gather_bytes(columns_to_npz(cols))]
    return merge_columns(parts, time_ordered=time_ordered)


def _gloo_host_staged(x: torch.Tensor, n: int, group) -> List[torch.Tensor]:
    """gloo host staging: gloo's all_gather takes no CUDA tensor, so a
    CUDA ``x`` crosses through host memory and the parts go back to its
    device. Only a gloo group takes this path."""
    host = x.cpu()
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=group)
    return [p.to(x.device) for p in parts]


def _p2p_peer(group, group_rank: int) -> int:
    return (group_rank if group is None
            else dist.get_global_rank(group, group_rank))


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks) concatenated along
    dim 0 in rank order, on ``x``'s device. NCCL gathers device tensors
    where they lie; a CUDA tensor in a gloo group is staged through host
    memory (``_gloo_host_staged``)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    if x.device.type == "cuda" and dist.get_backend(group) == "gloo":
        parts = _gloo_host_staged(x, n, group)
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=0)


def gather_rows_to_host(x: torch.Tensor, group=None,
                        dst: Optional[int] = None) -> Optional[torch.Tensor]:
    """Every rank's ``x`` concatenated along dim 0 in rank order, where
    the ranks' row counts may differ (a table's slabs), in host memory:
    on every rank of ``group`` (the world for None), or, with ``dst`` (a
    global rank), on that rank alone and None elsewhere; a group
    without ``dst`` moves nothing. The parts cross one at a time
    (broadcast, or send and receive to ``dst``), so a rank's card holds
    at most one part beside its own: a table sharded because no card
    holds it is never whole on a card."""
    me = dist.get_rank()
    n = dist.get_world_size(group)
    ranks = [_p2p_peer(group, r) for r in range(n)]
    if dst is not None and dst not in ranks:
        return None
    lens = _gather_sizes(x.shape[0], group)
    dev = _collective_device(group)
    own = x.detach().to(dev).contiguous()
    out = (torch.empty((sum(lens), *x.shape[1:]), dtype=x.dtype)
           if dst in (None, me) else None)
    start = 0
    for src, k in zip(ranks, lens):
        part = own if src == me else None
        if k and dst is None:
            if part is None:
                part = own.new_empty((k, *x.shape[1:]))
            dist.broadcast(part, src, group=group)
        elif k and src != dst:
            if me == dst:
                part = own.new_empty((k, *x.shape[1:]))
                dist.recv(part, src, group=group)
            elif me == src:
                dist.send(own, dst, group=group)
        if out is not None and k:
            out[start:start + k] = part
        start += k
    return out


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group`` (the world for
    None), as a new tensor on ``x``'s device; ``x`` is left as it is.
    NCCL sums device tensors where they lie; a CUDA tensor in a gloo
    group is summed through host memory."""
    if dist.get_world_size(group) == 1:
        return x.detach().clone()
    staged = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    out = x.detach().cpu() if staged else x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device) if staged else out


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """One step round ``group``'s ring (the world for None): ``x`` goes
    to the next rank (group rank ``r`` -> ``r + 1 mod n``) and the call
    returns what the previous rank sent, of ``x``'s shape and dtype, on
    ``x``'s device (``batch_isend_irecv``; a CUDA tensor in a gloo group
    crosses through host memory)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    r = dist.get_rank(group)
    staged = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    send = (x.detach().cpu() if staged else x.detach()).contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, _p2p_peer(group, (r + 1) % n), group),
        dist.P2POp(dist.irecv, recv, _p2p_peer(group, (r - 1) % n), group)])
    for req in reqs:
        req.wait()  # graftlint: disable=JT12 — the process group's timeout bounds a send or receive as it does every collective here
    return recv.to(x.device) if staged else recv


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.lo = dist.get_rank(group) * x.shape[dim]
        ctx.size, ctx.dim = x.shape[dim], dim
        whole = all_gather_rows(x.movedim(dim, 0).contiguous(), group)
        return whole.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.lo, ctx.size), None, None


def gather_shards(x: torch.Tensor, group=None, dim: int = 0
                  ) -> torch.Tensor:
    """Every rank's shard of ``x`` along ``dim``, in rank order, as a
    differentiable op for code in which every rank computes the same
    loss of the whole: the gradient of a rank's shard is its slice of
    the whole's gradient."""
    return _GatherShards.apply(x, group, dim)


def global_array(local, mesh=None, *spec,
                 device: DeviceLike = None) -> torch.Tensor:
    """This process's shard as a tensor on its device (``device``, else
    the rank's, else the card). ``local`` is its contiguous shard of
    axis 0 (``host_shard_slice``); ``mesh`` and ``spec`` are accepted
    for the JAX package's signature, where they name the global array's
    sharding: here the shards stay where they are and the ops run
    explicit collectives over them. One process: the whole array."""
    return torch.as_tensor(np.asarray(local), device=rank_device(device))


def to_host(x) -> np.ndarray:
    """A row-sharded tensor (each rank holds its rows, which may number
    differently) gathered in rank order to host numpy on every rank;
    with one process, ``x`` as numpy."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if process_count() == 1:
        return x.detach().cpu().numpy()
    return gather_rows_to_host(x).numpy()


def all_hosts_sum(x, mesh=None) -> np.ndarray:
    """Sum a small host-local array over the processes (per-process
    event counts and the like); the identity with one process."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    t = torch.as_tensor(x.astype(np.float64), device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.cpu().numpy()
