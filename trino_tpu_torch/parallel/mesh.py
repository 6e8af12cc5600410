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
next run. On CUDA each rank thread runs on a stream of its own, ordered
after the caller's stream on entry and before it on return.

A rank's collectives are its *schedule*: one :class:`Step` a call (a
blocking call, or the issue and the join of an overlapped all-to-all).
A :class:`RankProgram` attached to a rank's ``Comm`` records the schedule
of an eager run, and captures the same body as CUDA graph segments cut at
the collectives, which it then replays (the SPMD tier's counterpart of
``jax.jit`` over ``shard_map``, parallel/spmd.py). Gloo moves blocks
through host memory and cannot run inside a graph, so every collective,
NCCL's too, runs eagerly between two segments on buffers fixed at capture.
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
# a step's kind: a blocking call, or the issue and the join of an
# overlapped all-to-all
KINDS = ("call", "start", "wait")
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


class ScheduleError(RuntimeError):
    """The ranks' collective schedules differ, or a capture left the
    schedule its warm-up recorded."""


@dataclasses.dataclass(frozen=True)
class Step:
    """One collective of a rank's schedule: the op, its kind (``KINDS``),
    the bytes the rank sends and receives, and for a ``wait`` the index of
    the ``start`` it joins."""

    op: str
    kind: str
    send_bytes: int
    recv_bytes: int
    pair: int = -1

    def row(self) -> List[int]:
        return [OPS.index(self.op), KINDS.index(self.kind), self.send_bytes,
                self.recv_bytes, self.pair]

    @classmethod
    def from_row(cls, row) -> "Step":
        return cls(OPS[row[0]], KINDS[row[1]], *(int(v) for v in row[2:]))


def _max_opts():
    import torch.distributed as dist

    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.MAX
    return opts


class Comm:
    """One rank's view of the mesh: its rank, device, group and the typed
    collectives. Every rank of a mesh must make the same sequence of
    calls, with equal shapes. ``program``, when set, records this run's
    schedule or captures it (:class:`RankProgram`)."""

    def __init__(self, rank: int, size: int, device: torch.device, groups: dict,
                 stats: CollectiveStats):
        self.rank, self.size, self.device = rank, size, device
        # the mesh's rank -> group map, not the group itself: dropping a
        # failed rank's entry destroys its group (see Mesh._drop)
        self._groups, self.stats = groups, stats
        self.program: Optional["RankProgram"] = None
        self._steps = 0  # collectives made so far this run
        self._works: Dict[int, tuple] = {}  # issued all-to-alls by step index

    def attach(self, program: Optional["RankProgram"]) -> None:
        """Start a pass of the body: its steps count from 0 again, made
        under ``program`` (or plainly with None)."""
        self.program, self._steps, self._works = program, 0, {}

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
        out = self._step("all_gather", "call", buf, self.size * buf.numel())
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
        buf, widths = self._a2a_buffer(arrays)
        out = self._step("all_to_all", "call", buf, buf.numel())
        return _a2a_views(out.view(self.size, -1), arrays, widths, self.size)

    def all_to_all_start(self, arrays: List[torch.Tensor]) -> "PendingAllToAll":
        """Issue :meth:`all_to_all` without waiting for it: the caller
        computes while the blocks travel and calls ``wait()`` for them."""
        buf, widths = self._a2a_buffer(arrays)
        index = self._steps
        out = self._step("all_to_all", "start", buf, buf.numel())
        return PendingAllToAll(self, index, out, arrays, widths)

    def _a2a_buffer(self, arrays):
        parts = [_as_bytes(a).view(self.size, -1) for a in arrays]
        return torch.cat(parts, dim=1).contiguous(), [p.shape[1] for p in parts]

    def any(self, flags: torch.Tensor) -> torch.Tensor:
        """bool[k]: flag i fired on any rank."""
        if flags.numel() == 0:
            return flags
        t = flags.to(torch.int32)
        self._step("any", "call", t, t.numel() * t.element_size())  # reduced in place
        return t > 0

    # ----------------------------------------------------------- steps
    def _step(self, op: str, kind: str, buf: Optional[torch.Tensor], recv: int,
              pair: int = -1) -> Optional[torch.Tensor]:
        """Make this run's next collective: run it (recording it when a
        program records), or, under capture, cut the segment there. Returns
        the receive buffer (the send buffer for ``any``, which reduces in
        place; None for a ``wait``)."""
        index = self._steps
        self._steps += 1
        nbytes = 0 if buf is None else int(buf.numel()) * buf.element_size()
        step = Step(op, kind, nbytes, 0 if kind == "wait" else int(recv), pair)
        prog = self.program
        if prog is not None and prog.capturing:
            return prog.cut(index, step, buf)
        out = _recv_buffer(step, buf, self.device)
        self._exec(index, step, buf, out, self._works)
        if prog is not None:
            prog.record(step)
        return out

    def _exec(self, index: int, step: Step, buf, out, works: Dict[int, tuple]) -> float:
        """Run one step on its buffers, on the caller's current stream;
        an issued all-to-all waits in ``works`` for its join. Returns the
        host seconds spent in the call. (No local names the group: a
        failed call's traceback must not keep it alive, see Mesh._drop.)"""
        t0 = time.perf_counter()
        if step.op == "all_gather":
            self.group._allgather_base(out, buf).wait()
        elif step.op == "any":
            self.group.allreduce([buf], _max_opts()).wait()
        elif step.kind == "wait":
            work, nbytes, issue_s = works.pop(step.pair)
            work.wait()
        else:
            work = self.group.alltoall_base(out.view(buf.shape), buf, [], [])
            if step.kind == "call":
                work.wait()
        seconds = time.perf_counter() - t0
        if step.kind == "start":
            works[index] = (work, step.send_bytes, seconds)
        elif step.kind == "wait":
            # seconds spent issuing and waiting, not the compute in between
            self.stats.add(step.op, nbytes, issue_s + seconds)
        else:
            self.stats.add(step.op, step.send_bytes, seconds)
        return seconds

    def agree(self, schedule: List[Step]) -> None:
        """Raise :class:`ScheduleError` unless every rank recorded this
        schedule, naming the first step that differs. Two all-gathers of
        its own (the lengths, then the padded steps), outside any
        schedule and any capture."""
        n = torch.tensor([len(schedule)], dtype=torch.int64, device=self.device)
        lens = torch.empty(self.size, dtype=torch.int64, device=self.device)
        self.group._allgather_base(lens, n).wait()
        lens = lens.tolist()
        width = max(max(lens), 1)
        mine = torch.full((width, 5), -1, dtype=torch.int64)
        if schedule:
            mine[:len(schedule)] = torch.tensor([s.row() for s in schedule], dtype=torch.int64)
        mine = mine.reshape(-1).to(self.device)
        table = torch.empty(self.size * width * 5, dtype=torch.int64, device=self.device)
        self.group._allgather_base(table, mine).wait()
        rows = table.view(self.size, width, 5).tolist()
        for i in range(max(lens)):
            want = Step.from_row(rows[0][i]) if i < lens[0] else None
            for r in range(1, self.size):
                got = Step.from_row(rows[r][i]) if i < lens[r] else None
                if got != want:
                    raise ScheduleError(
                        f"mesh ranks disagree at step {i}: rank 0 {want or 'made no step'}, "
                        f"rank {r} {got or 'made no step'} ({lens[0]} and {lens[r]} steps)")


def _recv_buffer(step: Step, buf, device) -> Optional[torch.Tensor]:
    """A step's receive buffer: fresh bytes (each rank's block), the send
    buffer itself for the in-place ``any``, none for a ``wait``."""
    if step.kind == "wait":
        return None
    if step.op == "any":
        return buf
    return torch.empty((step.recv_bytes,), dtype=torch.uint8, device=device)


def _a2a_views(out, arrays, widths, size) -> List[torch.Tensor]:
    res, off = [], 0
    for a, w in zip(arrays, widths):
        res.append(_from_bytes(out[:, off:off + w], a[0], size * a.shape[1]))
        off += w
    return res


class PendingAllToAll:
    """An issued all-to-all: ``wait()`` returns the received arrays."""

    def __init__(self, comm: Comm, index: int, out, arrays, widths):
        self.comm, self.index, self.out = comm, index, out
        self.arrays, self.widths = arrays, widths

    def wait(self) -> List[torch.Tensor]:
        self.comm._step("all_to_all", "wait", None, 0, pair=self.index)
        return _a2a_views(self.out.view(self.comm.size, -1), self.arrays, self.widths,
                          self.comm.size)


class RankProgram:
    """One rank's body as CUDA graph segments cut at its collectives.

    An eager run with the program attached records the rank's schedule
    (``record``). :meth:`capture` runs the body again under capture: each
    collective ends the open segment, allocates its receive buffer once
    outside any capture, keeps the send buffer the segment computed (it
    lives in the graph pool, refreshed by every replay) and begins the
    next segment; nothing is sent. The views the body takes of a receive
    buffer are taken inside the next segment, so every replay reads the
    same addresses. :meth:`replay` replays segment 0, runs step 0 on its
    fixed buffers, replays segment 1, and so on, on the caller's current
    stream (the rank's own): a collective waits on the stream its segment
    was replayed on. The segments share one graph pool and replay in
    capture order. Captures are ``thread_local``: the other ranks' threads
    keep copying and synchronizing their own streams meanwhile."""

    def __init__(self, rank: int, device: torch.device):
        self.rank, self.device = rank, device
        self.schedule: List[Step] = []
        self.capturing = False
        self.segments: List = []
        self.bufs: List[tuple] = []  # (send, receive) a step, fixed at capture
        self.pool = None
        self._open = None  # the segment being captured
        self.outputs = None  # the captured body's result
        self.store = None  # what the caller keeps alive beside the graphs
        self.stats: dict = {}  # the caller's record of this capture

    def record(self, step: Step) -> None:
        self.schedule.append(step)

    def capture(self, body: Callable[[], object]) -> object:
        """``body()`` under segmented capture; its result (tensors in the
        graph pool or receive buffers, rewritten by each replay)."""
        self.pool = torch.cuda.graph_pool_handle()
        self.capturing = True
        try:
            self._begin()
            result = body()
            self._end()
        except BaseException:
            # close the open capture before the caller destroys the group
            self._abort()
            raise
        finally:
            self.capturing = False
        if len(self.bufs) != len(self.schedule):
            self.reset()
            raise ScheduleError(f"mesh rank {self.rank}: the capture made {len(self.bufs)} "
                                f"collectives, its warm-up {len(self.schedule)}")
        self.outputs = result
        return result

    def cut(self, index: int, step: Step, buf) -> Optional[torch.Tensor]:
        """Step ``index`` met under capture: end the segment, check the
        step against the warm-up's, fix its buffers, begin the next."""
        self._end()
        if index >= len(self.schedule) or self.schedule[index] != step:
            want = self.schedule[index] if index < len(self.schedule) else "no step"
            raise ScheduleError(f"mesh rank {self.rank}: capture step {index} {step} differs "
                                f"from its warm-up's {want}")
        out = _recv_buffer(step, buf, self.device)
        self.bufs.append((buf, out))
        self._begin()
        return out

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self._open = graph

    def _end(self) -> None:
        graph, self._open = self._open, None
        graph.capture_end()
        self.segments.append(graph)

    def _abort(self) -> None:
        graph, self._open = self._open, None
        if graph is not None:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # an invalidated capture still ends, with an error
        self.reset()

    def replay(self, comm: Comm) -> tuple:
        """Replay the segments with the steps between them: (host seconds
        in the replays' launches, host seconds in the collectives)."""
        works: Dict[int, tuple] = {}
        launch_s = collective_s = 0.0
        for i, step in enumerate(self.schedule):
            t0 = time.perf_counter()
            self.segments[i].replay()
            launch_s += time.perf_counter() - t0
            buf, out = self.bufs[i]
            collective_s += comm._exec(i, step, buf, out, works)
        t0 = time.perf_counter()
        self.segments[-1].replay()
        launch_s += time.perf_counter() - t0
        return launch_s, collective_s

    def pool_bytes(self) -> int:
        """Device bytes the caching allocator holds in this program's
        graph pool."""
        pool = tuple(self.pool)
        return sum(int(seg["total_size"]) for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def buffer_bytes(self) -> int:
        """Bytes of the receive buffers fixed at capture."""
        return sum(int(out.numel()) * out.element_size() for buf, out in self.bufs
                   if out is not None and out is not buf)

    def reset(self) -> None:
        """Drop the graphs, their pool and the fixed buffers (the caller
        has synchronized the rank's stream)."""
        for graph in self.segments:
            graph.reset()
        self.segments, self.bufs, self.pool = [], [], None
        self.outputs = self.store = None


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
        self._streams: Dict[int, object] = {}  # rank -> its CUDA stream

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
    def stream(self, rank: int):
        """The CUDA stream rank ``rank``'s thread runs on (made once)."""
        stream = self._streams.get(rank)
        if stream is None:
            stream = self._streams[rank] = torch.cuda.Stream(self.devices[rank])
        return stream

    def run(self, fn: Callable[[Comm], object]) -> List[object]:
        """``fn(comm)`` on every local rank, one thread a rank; the results
        in rank order. The first rank's exception is re-raised here; a
        rank still running at the deadline raises too. After a failure the
        groups are rebuilt at the next run. A CUDA rank runs on its own
        stream (``stream``), which first waits for the caller's current
        stream; the caller's stream waits for every rank's on return."""
        comms = [self.comm(r) for r in self.local]
        callers = {c.rank: (torch.cuda.current_stream(c.device), self.stream(c.rank))
                   for c in comms if c.device.type == "cuda"}

        def call(comm):
            if comm.rank not in callers:
                return fn(comm)
            caller, stream = callers[comm.rank]
            torch.cuda.set_device(comm.device)
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                return fn(comm)

        try:
            if len(comms) == 1 and self._world:
                return [call(comms[0])]
            return self._run_threads(comms, call)
        finally:
            for caller, stream in callers.values():
                caller.wait_stream(stream)

    def _run_threads(self, comms: List[Comm], call) -> List[object]:
        results: Dict[int, object] = {}
        failures: List[tuple] = []
        lock = threading.Lock()

        def body(comm):
            try:
                results[comm.rank] = call(comm)
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
