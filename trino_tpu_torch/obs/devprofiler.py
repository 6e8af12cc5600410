"""Device execution profiler: kernel ledger, compile ledger, utilization.

The port of trino_tpu/obs/devprofiler.py. It attributes the inside of a
query's device work, the device half of Trino's operator stats
(``OperatorStats``' wall per operator): wall against device seconds per
dispatch.

Three stores per process (bounded rings, O(1) append under a short lock,
fan-out outside the lock):

- a **kernel ledger**: per-query rollups keyed ``(plan_node_id, operator,
  tier, node)`` of launches, wall seconds, device seconds and input/output
  bytes. ``wall - device`` is the per-operator dispatch overhead. Device
  seconds are measured (a ``torch.cuda.synchronize`` per plan node, CUDA
  events around a graph replay) only under the ``device_profiling`` session
  property; otherwise they are the host wall (``estimated=True`` rows), so
  a plain query never pays a sync.
- a **compile ledger**: a bounded ring of compile events, each naming its
  tier, plan fingerprint (cache/plan_key.py), shape signature, seconds and
  cache ``hit``/``miss``. On the card a compile is the compiled tier's
  capture: the first ``run()`` of a ``CompiledQuery`` warms up and captures
  a CUDA graph (a miss); a replay of that graph is a hit.
- a **utilization sampler**: monotonic process counters (launches, busy
  seconds, compiles in flight) sampled on the worker's announce tick into a
  ring (launches/sec, busy fraction).

``count_launch`` is two adds under one short lock. Metrics fan out when a
query's rows fold (``record_query_kernels``) or a compile is recorded, never
per dispatch. Nothing here touches a tensor: a status read on a worker's
HTTP thread may call every read method while task threads launch work.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

# compile events are rare (one per capture); 256 is hours of history
COMPILE_CAPACITY = 256
# the announce loop samples about every 0.5 s: ~2 minutes of history
UTILIZATION_CAPACITY = 240
# per-query kernel rollups kept after the query folds (LRU)
MAX_QUERY_PROFILES = 64

TIERS = ("eager", "compiled", "spmd")


def merge_kernel_rows(dst: Dict[tuple, dict], rows: List[dict]) -> Dict[tuple, dict]:
    """Fold serialized kernel rows (the ``kernelStats`` wire shape) into a
    ``(planNodeId, operator, tier, nodeId)``-keyed accumulator."""
    for row in rows or []:
        key = (row.get("planNodeId", ""), row.get("operator", ""),
               row.get("tier", "eager"), row.get("nodeId", ""))
        agg = dst.get(key)
        if agg is None:
            agg = {"planNodeId": key[0], "operator": key[1], "tier": key[2],
                   "nodeId": key[3], "launches": 0, "wallS": 0.0, "deviceS": 0.0,
                   "inputBytes": 0, "outputBytes": 0, "estimated": False}
            dst[key] = agg
        agg["launches"] += int(row.get("launches", 0))
        agg["wallS"] += float(row.get("wallS", 0.0))
        agg["deviceS"] += float(row.get("deviceS", 0.0))
        agg["inputBytes"] += int(row.get("inputBytes", 0))
        agg["outputBytes"] += int(row.get("outputBytes", 0))
        agg["estimated"] = bool(agg["estimated"] or row.get("estimated"))
    return dst


class DeviceProfiler:
    """One process's device profiler (the coordinator's and each worker's;
    in-process test clusters share one)."""

    def __init__(self, node_id: str = "", compile_capacity: int = COMPILE_CAPACITY,
                 utilization_capacity: int = UTILIZATION_CAPACITY,
                 max_query_profiles: int = MAX_QUERY_PROFILES):
        self.node_id = node_id
        self._lock = threading.Lock()
        self._compiles: "deque[dict]" = deque(maxlen=compile_capacity)
        self._utilization: "deque[dict]" = deque(maxlen=utilization_capacity)
        # queryId -> {(planNodeId, operator, tier, nodeId) -> rollup}
        self._queries: "OrderedDict[str, Dict[tuple, dict]]" = OrderedDict()
        self._max_query_profiles = max_query_profiles
        self._launches_total = 0
        self._busy_s_total = 0.0
        self._compiles_total = 0
        self._compile_inflight = 0
        # the previous sample, for the rates
        self._last_sample_ts: Optional[float] = None
        self._last_launches = 0
        self._last_busy_s = 0.0
        self._recorder = None

    def attach_recorder(self, recorder) -> None:
        """Mirror compile events into the process flight recorder
        (obs/flightrecorder.py), so a FAILED query's postmortem shows a
        recompile storm before the failure."""
        self._recorder = recorder

    # --------------------------------------------------------- hot path
    def count_launch(self, wall_s: float, busy_s: float, n: int = 1) -> None:
        """Zero-sync accounting for ``n`` dispatches: two adds under a
        short lock. ``busy_s`` is measured device seconds, 0 when
        estimated (the wall is charged then)."""
        with self._lock:
            self._launches_total += n
            self._busy_s_total += busy_s if busy_s > 0 else wall_s

    # ----------------------------------------------------- compile ring
    def compile_started(self) -> None:
        with self._lock:
            self._compile_inflight += 1

    def record_compile(self, tier: str, fingerprint: str, shape_sig: str, compile_s: float,
                       cache: str, query_id: str = "", started: bool = False) -> None:
        """Append one compile event (``cache`` is ``"hit"`` or ``"miss"``)
        and observe the tiered compile-seconds histogram outside the lock.
        ``started=True`` pairs with an earlier :meth:`compile_started`."""
        rec = {"ts": time.time(), "nodeId": self.node_id, "queryId": query_id, "tier": tier,
               "fingerprint": fingerprint, "shapeSig": shape_sig,
               "compileS": round(float(compile_s), 6), "cache": cache}
        with self._lock:
            self._compiles.append(rec)
            self._compiles_total += 1
            if started and self._compile_inflight > 0:
                self._compile_inflight -= 1
        from trino_tpu_torch.obs import metrics as M

        M.COMPILE_SECONDS_TIERED.observe(float(compile_s), tier, cache)
        if self._recorder is not None:
            self._recorder.record(
                "compile", "device/compile-event", tier=tier, cache=cache,
                fingerprint=fingerprint, shapeSig=shape_sig,
                compileS=round(float(compile_s), 6), queryId=query_id)

    # ------------------------------------------------------- query fold
    def record_query_kernels(self, query_id: str, rows: List[dict],
                             node_id: Optional[str] = None) -> None:
        """Fold a query's kernel rows into the per-query store, and bump
        the per-operator launch and dispatch-overhead metrics once a fold."""
        if not rows:
            return
        node = node_id if node_id is not None else self.node_id
        stamped = [dict(r, nodeId=r.get("nodeId") or node) for r in rows]
        with self._lock:
            store = self._queries.get(query_id)
            if store is None:
                store = self._queries[query_id] = {}
                while len(self._queries) > self._max_query_profiles:
                    self._queries.popitem(last=False)
            else:
                self._queries.move_to_end(query_id)
            merge_kernel_rows(store, stamped)
        from trino_tpu_torch.obs import metrics as M

        for row in stamped:
            op = row.get("operator", "")
            launches = int(row.get("launches", 0))
            if launches:
                M.KERNEL_LAUNCHES.inc(launches, op)
            overhead = max(0.0, float(row.get("wallS", 0.0)) - float(row.get("deviceS", 0.0)))
            if overhead > 0:
                M.KERNEL_DISPATCH_OVERHEAD.inc(overhead, op)

    # ----------------------------------------------------- announce tick
    def sample_utilization(self) -> dict:
        """One announce tick: launches/sec and busy fraction since the
        last tick."""
        now = time.time()
        with self._lock:
            launches, busy_s = self._launches_total, self._busy_s_total
            prev_ts = self._last_sample_ts
            dt = (now - prev_ts) if prev_ts is not None else 0.0
            d_launches = launches - self._last_launches
            d_busy = busy_s - self._last_busy_s
            self._last_sample_ts, self._last_launches, self._last_busy_s = now, launches, busy_s
            sample = {
                "ts": now, "nodeId": self.node_id, "launchesTotal": launches,
                "launchesPerS": round(d_launches / dt, 3) if dt > 0 else 0.0,
                "busyFraction": round(min(1.0, d_busy / dt), 4) if dt > 0 else 0.0,
                "compileInflight": self._compile_inflight,
                "compilesTotal": self._compiles_total,
            }
            self._utilization.append(sample)
        return sample

    # ------------------------------------------------------------- reads
    def kernel_rows(self, query_id: Optional[str] = None) -> List[dict]:
        """Per-(query, plan node, operator, tier, node) rollup rows."""
        with self._lock:
            if query_id is not None:
                stores = {query_id: dict(self._queries.get(query_id, {}))}
            else:
                stores = {qid: dict(s) for qid, s in self._queries.items()}
            rows = []
            for qid, store in stores.items():
                for agg in store.values():
                    row = dict(agg, queryId=qid)
                    row["dispatchOverheadS"] = round(max(0.0, row["wallS"] - row["deviceS"]), 6)
                    rows.append(row)
        rows.sort(key=lambda r: (r["queryId"], r["planNodeId"], r["operator"], r["nodeId"]))
        return rows

    def compile_rows(self, query_id: Optional[str] = None,
                     limit: Optional[int] = None) -> List[dict]:
        """Oldest-first copy of the compile ring, optionally of one query."""
        with self._lock:
            records = list(self._compiles)
        if query_id is not None:
            records = [r for r in records if r.get("queryId") == query_id]
        if limit is not None and len(records) > limit:
            records = records[-limit:]
        return records

    def utilization_rows(self, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            samples = list(self._utilization)
        if limit is not None and len(samples) > limit:
            samples = samples[-limit:]
        return samples

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return {"launchesTotal": self._launches_total,
                    "busySTotal": round(self._busy_s_total, 6),
                    "compilesTotal": self._compiles_total,
                    "compileInflight": self._compile_inflight}

    def profile_snapshot(self, query_id: str) -> dict:
        """This process's block of a query profile: the query's kernel
        rollups, its compile events and recent utilization."""
        return {"nodeId": self.node_id, "kernels": self.kernel_rows(query_id),
                "compiles": self.compile_rows(query_id),
                "utilization": self.utilization_rows(limit=8)}

    def __len__(self) -> int:
        with self._lock:
            return len(self._compiles)


def shape_signature(arrays) -> str:
    """Short, stable signature of input shapes and dtypes (the compile
    ledger's ``shapeSig``). Dtypes are named as numpy names them
    (``int32``, not ``torch.int32``), so a tensor and a numpy array of one
    shape and dtype sign alike."""
    parts = []
    for arr in arrays:
        shape = tuple(getattr(arr, "shape", ()) or ())
        dtype = str(getattr(arr, "dtype", type(arr).__name__))
        if dtype.startswith("torch."):
            dtype = dtype[len("torch."):]
        parts.append(f"{dtype}{[int(d) for d in shape]}")
    digest = hashlib.sha256(";".join(parts).encode()).hexdigest()[:12]
    return f"{digest}:{len(parts)}"


# the per-process profiler; servers stamp node_id at start-up
DEVICE_PROFILER = DeviceProfiler()
