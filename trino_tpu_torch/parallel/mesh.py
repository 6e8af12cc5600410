"""The port's device mesh: the counterpart of ``jax.sharding.Mesh`` and of
the ``jax.lax`` collectives the SPMD tier (parallel/spmd.py) and the hash
exchange (parallel/exchange.py) call inside ``shard_map``.

A :class:`Mesh` is ``size`` ranks, each with its device and a
``torch.distributed`` process group. JAX's ``shard_map`` traces one program
for every device; here each rank runs the executor eagerly, one thread a
rank (:meth:`Mesh.run`), and the collectives are the groups' own calls:

- ``all_gather``: every rank's arrays stacked along rows (``_gather_flat``);
- ``all_to_all``: equal fixed-capacity blocks, block ``d`` of every rank
  landing on rank ``d``;
- ``any``: a MAX all-reduce of the deferred error flags, so every rank
  agrees on a regrowth and on the errors it raises.

Each collective packs its arrays into one byte buffer (every dtype, bool
and int16 included, travels as uint8), so an exchange of a page is one
collective call however many columns it has.

Backends:

- ``Mesh.threads(n, device)``: every rank in this process, gloo groups
  over one ``HashStore`` (the CPU, and several ranks on one GPU: NCCL
  refuses two ranks on one card). Gloo takes CUDA tensors for every
  collective called here (chip_smoke.py's phase spmd runs them on an
  H100), so blocks on the card go to gloo as they are, and gloo stages
  them through host memory itself; no copy of this module moves them.
- ``Mesh.threads(n, [devices])`` with a card a rank, or one rank on a
  card: NCCL groups.
- ``Mesh.world(device)``: one rank a process under
  ``torch.distributed.init_process_group``; the same SPMD code runs there.

Every group has a timeout. A rank that raises destroys its group, so a
peer waiting in a collective fails at once (its connection closes) rather
than at the timeout; :meth:`Mesh.run` joins its threads with a deadline,
re-raises the first rank's exception and rebuilds the groups before the
next run.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

# the collectives a rank makes, by name, for CollectiveStats
OPS = ("all_gather", "all_to_all", "any")
# how long Mesh.run waits for its rank threads before it raises
RUN_TIMEOUT_S = 3600.0


@dataclasses.dataclass
class CollectiveStats:
    """Calls, bytes and seconds of the collectives, by op, summed over the
    ranks: ``bytes`` is what the ranks handed to the group (each rank's
    send buffer), ``seconds`` the host wall each rank spent in the call,
    the wait for its peers included."""

    calls: Dict[str, int] = dataclasses.field(default_factory=lambda: dict.fromkeys(OPS, 0))
    bytes: Dict[str, int] = dataclasses.field(default_factory=lambda: dict.fromkeys(OPS, 0))
    seconds: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(OPS, 0.0))

    def __post_init__(self):
        self._lock = threading.Lock()

    def add(self, op: str, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.calls[op] += 1
            self.bytes[op] += nbytes
            self.seconds[op] += seconds

    def snapshot(self) -> dict:
        with self._lock:
            return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                    "seconds": dict(self.seconds)}


def _as_bytes(a: torch.Tensor) -> torch.Tensor:
    """A tensor's storage as a flat uint8 tensor (a view where possible)."""
    a = a.contiguous()
    if a.dtype == torch.bool:
        a = a.view(torch.uint8)
    return a.reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor, rows: int) -> torch.Tensor:
    """``rows`` rows of ``like``'s row shape and dtype from a flat uint8
    tensor."""
    b = b.reshape(-1)  # a copy where the slice is not contiguous
    if b.storage_offset() % like.element_size():
        b = b.clone()  # a dtype view needs an aligned start
    if like.dtype == torch.bool:
        return b.view(torch.bool).reshape((rows,) + tuple(like.shape[1:]))
    return b.view(like.dtype).reshape((rows,) + tuple(like.shape[1:]))


class Comm:
    """One rank's view of the mesh: its rank, device, group and the typed
    collectives. Every rank of a mesh must make the same sequence of
    calls, with equal shapes."""

    def __init__(self, rank: int, size: int, device: torch.device, groups: dict,
                 stats: CollectiveStats):
        self.rank, self.size, self.device = rank, size, device
        # the mesh's rank -> group map, not the group itself: dropping a
        # failed rank's entry destroys its group (see Mesh._drop)
        self._groups, self.stats = groups, stats

    @property
    def group(self):
        group = self._groups.get(self.rank)
        if group is None:
            raise RuntimeError(f"mesh rank {self.rank}: its group was closed after a failure")
        return group

    def all_gather(self, arrays: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each array ``[n, ...]`` gathered from every rank into
        ``[size * n, ...]``, rank 0's rows first."""
        parts = [_as_bytes(a) for a in arrays]
        buf = torch.cat(parts) if parts else torch.empty(0, dtype=torch.uint8,
                                                         device=self.device)
        out = torch.empty((self.size * buf.numel(),), dtype=torch.uint8, device=buf.device)
        t0 = time.perf_counter()
        self.group._allgather_base(out, buf).wait()
        self.stats.add("all_gather", int(buf.numel()), time.perf_counter() - t0)
        out = out.view(self.size, buf.numel())
        res, off = [], 0
        for a, p in zip(arrays, parts):
            res.append(_from_bytes(out[:, off:off + p.numel()], a, self.size * a.shape[0]))
            off += p.numel()
        return res

    def all_to_all(self, arrays: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each array ``[size, cap, ...]``: block ``d`` goes to rank ``d``;
        returns ``[size * cap, ...]`` with the block from rank ``s`` at
        rows ``[s * cap, (s + 1) * cap)``."""
        return self.all_to_all_start(arrays).wait()

    def all_to_all_start(self, arrays: List[torch.Tensor]) -> "PendingAllToAll":
        """Issue :meth:`all_to_all` without waiting for it: the caller
        computes while the blocks travel and calls ``wait()`` for them."""
        t0 = time.perf_counter()
        parts = [_as_bytes(a).view(self.size, -1) for a in arrays]
        buf = torch.cat(parts, dim=1).contiguous()
        out = torch.empty_like(buf)
        work = self.group.alltoall_base(out, buf, [], [])
        return PendingAllToAll(self, work, out, arrays, [p.shape[1] for p in parts],
                               int(buf.numel()), time.perf_counter() - t0)

    def any(self, flags: torch.Tensor) -> torch.Tensor:
        """bool[k]: flag i fired on any rank."""
        if flags.numel() == 0:
            return flags
        import torch.distributed as dist

        t = flags.to(torch.int32)
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.MAX
        t0 = time.perf_counter()
        self.group.allreduce([t], opts).wait()
        self.stats.add("any", int(t.numel() * 4), time.perf_counter() - t0)
        return t > 0


class PendingAllToAll:
    """An issued all-to-all: ``wait()`` returns the received arrays."""

    def __init__(self, comm: Comm, work, out, arrays, widths, nbytes: int, issue_s: float):
        self.comm, self.work, self.out, self.arrays = comm, work, out, arrays
        self.widths, self.nbytes, self.issue_s = widths, nbytes, issue_s

    def wait(self) -> List[torch.Tensor]:
        t0 = time.perf_counter()
        self.work.wait()
        # seconds spent issuing and waiting, not the compute in between
        self.comm.stats.add("all_to_all", self.nbytes,
                            self.issue_s + time.perf_counter() - t0)
        size, res, off = self.comm.size, [], 0
        for a, w in zip(self.arrays, self.widths):
            res.append(_from_bytes(self.out[:, off:off + w], a[0], size * a.shape[1]))
            off += w
        return res


_GENERATIONS = itertools.count()


class Mesh:
    """``size`` ranks with their devices and process groups; ``local``
    lists the ranks this process runs (all of them for a thread mesh)."""

    def __init__(self, devices: List[torch.device], backend: str, timeout_s: float,
                 local: Optional[List[int]] = None, groups=None):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.backend = backend
        self.timeout_s = float(timeout_s)
        self.local = list(range(self.size)) if local is None else list(local)
        self.stats = CollectiveStats()
        self._groups = groups  # rank -> group; None until built
        self._world = groups is not None  # groups owned by init_process_group

    # ------------------------------------------------------------ make
    @classmethod
    def threads(cls, n: int, device="cuda", timeout_s: float = 60.0) -> "Mesh":
        """``n`` ranks in this process. ``device`` is one device for every
        rank or a list of ``n``; CUDA asked for without a GPU raises. The
        groups are NCCL where every rank has a card of its own (or ``n`` is
        1 on a card), gloo otherwise."""
        devices = list(device) if isinstance(device, (list, tuple)) else [device] * n
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for a mesh of {n} ranks")
        devices = [torch.device(d) for d in devices]
        if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh was asked for, but torch.cuda.is_available() "
                               "is False")
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if d.type == "cuda" and d.index is None else d for d in devices]
        distinct = len({str(d) for d in devices}) == n
        backend = "nccl" if devices[0].type == "cuda" and distinct else "gloo"
        return cls(devices, backend, timeout_s)

    @classmethod
    def world(cls, device, timeout_s: float = 60.0) -> "Mesh":
        """This process's rank of the default group of
        ``torch.distributed.init_process_group``."""
        import torch.distributed as dist

        from torch.distributed.distributed_c10d import _get_default_group

        size, rank = dist.get_world_size(), dist.get_rank()
        devices = [torch.device(device)] * size
        return cls(devices, dist.get_backend(), timeout_s, local=[rank],
                   groups={rank: _get_default_group()})

    def _build_groups(self) -> None:
        """One group a rank over a fresh store prefix, built in parallel
        (each constructor waits for every rank to connect)."""
        import torch.distributed as dist

        store = dist.PrefixStore(f"mesh{next(_GENERATIONS)}", dist.HashStore())
        timeout = datetime.timedelta(seconds=self.timeout_s)
        groups: Dict[int, object] = {}
        errors: List[BaseException] = []

        def make(rank):
            try:
                if self.backend == "nccl":
                    opts = dist.ProcessGroupNCCL.Options()
                    opts._timeout = timeout
                    with torch.cuda.device(self.devices[rank]):
                        groups[rank] = dist.ProcessGroupNCCL(store, rank, self.size, opts)
                else:
                    groups[rank] = dist.ProcessGroupGloo(store, rank, self.size, timeout)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=make, args=(r,), daemon=True)
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.timeout_s + 5)
        if errors or len(groups) != self.size:
            raise RuntimeError(f"building the mesh's {self.backend} groups failed: "
                               f"{errors[:1] or 'a rank did not connect'}")
        self._groups = groups

    def comm(self, rank: int) -> Comm:
        if self._groups is None:
            self._build_groups()
        return Comm(rank, self.size, self.devices[rank], self._groups, self.stats)

    def _drop(self, rank: int) -> None:
        """Destroy a failed rank's group (the map holds its one reference):
        its connections close, so its peers' pending collectives end with
        an error at once, and theirs in turn. A world group belongs to
        ``init_process_group`` and stays."""
        if self._groups is not None and not self._world:
            self._groups[rank] = None

    # ------------------------------------------------------------- run
    def run(self, fn: Callable[[Comm], object]) -> List[object]:
        """``fn(comm)`` on every local rank, one thread a rank; the results
        in rank order. The first rank's exception is re-raised here; a
        rank still running at the deadline raises too. After a failure the
        groups are rebuilt at the next run."""
        comms = [self.comm(r) for r in self.local]
        if len(comms) == 1 and self._world:
            return [fn(comms[0])]
        results: Dict[int, object] = {}
        failures: List[tuple] = []
        lock = threading.Lock()

        def body(comm):
            try:
                if comm.device.type == "cuda":
                    torch.cuda.set_device(comm.device)
                results[comm.rank] = fn(comm)
            except BaseException as e:  # noqa: BLE001 — handed to the caller
                with lock:
                    failures.append((time.perf_counter(), comm.rank, e))
                self._drop(comm.rank)

        threads = [threading.Thread(target=body, args=(c,), name=f"mesh-rank{c.rank}",
                                    daemon=True) for c in comms]
        deadline = time.monotonic() + RUN_TIMEOUT_S
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        alive = [t.name for t in threads if t.is_alive()]
        if (failures or alive) and not self._world:
            for c in comms:
                self._drop(c.rank)
            self._groups = None  # rebuilt by the next comm()
        if failures:
            raise sorted(failures, key=lambda f: f[0])[0][2]
        if alive:
            raise TimeoutError(f"mesh ranks {alive} still running after {RUN_TIMEOUT_S} s")
        return [results[c.rank] for c in comms]

    def close(self) -> None:
        """Release the groups (a world mesh leaves the default group to
        its owner); NCCL groups shut their communicators down first."""
        if self._groups is not None and not self._world:
            for r, group in list(self._groups.items()):
                if self.backend == "nccl" and group is not None:
                    group.shutdown()
                self._drop(r)
        self._groups = None
