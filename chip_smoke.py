"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build: compiles trino_tpu_torch/csrc/merge_unique_sorted.cu with nvcc
   for sm_90a from the checkout.
2. kernel: the merge kernel against its plain PyTorch version on the card,
   exact equality, at the SF1 join shapes of TPC-H Q2, Q17 and Q18, ragged
   sizes, empty sides, the INT32_MAX null-slot edge, probe 16M x build 4M,
   probe 1M x build 16M (a build much denser than the probe), a probe of
   2M + 777 keys (over a thousand full tiles and a ragged last one) against
   a sparser and a denser build, and a block_build sweep (128, 2048, 8192)
   on one input whose outputs must be equal. For each shape it prints the
   wrapper-inclusive time of back-to-back calls (CUDA events; the summary's
   ``ms``, as since the first slice), the kernel's device time (a CUDA
   graph of many launches, so host overhead drops out; ``device_ms``), the
   wrapper's host microseconds per call, the plain version's time, the
   library call's (torch.searchsorted + equality gather, never called by
   the port) wrapper-inclusive and device times, and the byte bound. The
   bound counts what the function must move: each probe key read and each
   output written once, and the build read once or one 32-byte sector per
   probe key where that is less, 8 * np + min(4 * nb, 32 * np) bytes over
   3.35 TB/s. Its compare work is a few integer steps a key, far below the card's integer
   rate, so bytes bound it and no operation term is counted. Last, a 1 x 1
   call: its wrapper-inclusive time (the summary's ``launch_floor_ms``, as
   before, though it measures the wrapper and not a launch), device time
   and host microseconds.
3. tpch: all 22 TPC-H queries at SF1 through trino_tpu_torch.Session on
   CUDA, each run twice in one session (cold: the first run, which also
   generates the tables it is the first to scan; warm: the second). Each
   run's rows must equal trino_tpu_torch/testdata/tpch_sf1_expected.json
   (written by the JAX package), its join-tier selections must equal the
   reference's recorded there, and a query whose reference selects the
   merge-pallas tier must launch the merge kernel. Prints one line a query:
   rows, cold and warm wall, merge-kernel launches, tier counts, rows and
   bytes staged and the staging phase seconds (scan, decode, transfer).
4. cache: a second session with ``device_cache_enabled=true`` runs the 22
   queries at SF1, all cold (empty device and host caches), then all warm.
   Each run's rows must equal the expected rows and its join tiers the
   reference's recorded with the cache on (``tiers_cached`` in
   trino_tpu_torch/testdata/plane_expected.json: Q5 and Q9 take the merge
   tier through a cached sorted build). Every warm run must stage zero rows,
   copy zero scanned-column bytes host->device and look every scan up as a
   hit, and the warm runs must leave every cached tensor bitwise as the
   cold runs made it. Prints a line a query (walls, cache lookups, rows
   and bytes staged, the staging phase seconds) and the cache's resident
   bytes beside ``torch.cuda.memory_allocated``.
5. analytics: a third session, uncached, over the tpcds catalog runs
   TPC-DS q95 and q64 (tests/tpcds_sql.py), their wide variants and eight
   queries of window functions, UNION ALL / UNION / INTERSECT / EXCEPT and
   the statistical and sketch aggregates over TPC-DS and TPC-H tables, all
   at SF1, each cold then warm. Rows must equal
   trino_tpu_torch/testdata/analytics_sf1_expected.json (written by the
   JAX package: tests/test_torch_tpcds.py --write-expected), doubles within
   a relative 1e-8 and q64's tie groups as multisets, with the reference's
   join tiers; a query whose reference selects merge-pallas must launch the
   merge kernel. Prints one line a query, as phase tpch does, with the
   card's name and power limit.
6. scalar: a fourth session, uncached, runs eleven queries at SF1 that
   reach every scalar function family of trino_tpu_torch/ops/expr_lower.py
   (date and timestamp extracts, differences, truncations, formats and
   casts; the strings, regexps, pads, JSON scalars and varbinary hashes
   over part, customer, orders and lineitem; mod, abs, truncate, bitwise,
   bit_count and the trigonometric family over lineitem; coalesce and
   nullif over the NULLs of a TPC-DS outer join, one varchar coalesce
   across two dictionaries), each cold then warm. Rows must equal
   trino_tpu_torch/testdata/scalar_sf1_expected.json (written by the JAX
   package: tests/test_torch_scalar_sql.py --write-expected; the varchar
   coalesce's rows are the reference's for the CASE form), doubles within
   a relative 1e-8. Prints one line a query: rows, cold and warm wall and
   the seconds of host passes over vocabularies and tables of days (and
   their share of the wall). Then a random() query over lineitem (the row
   count, every draw in [0, 1), the mean within 0.001 of 0.5, drawn from
   the session's CUDA generator) and the transcendental functions on the
   card against numpy on the host: log10(10^k) exact for k in -300..300
   (with how many the raw torch.log10 missed), and a seeded sample of
   each function within a relative 1e-8. Then phase nested, in a fifth
   session, uncached: ten queries at SF1 over arrays, maps and rows
   (array_agg per customer and the array functions over it, UNNEST of it
   plain and WITH ORDINALITY, histogram, map_agg per order over lineitem
   and UNNEST of the maps, the lambdas, ROW fields and array equality, and
   MATCH_RECOGNIZE's V-shape over daily revenue per ship mode), each cold
   then warm, against trino_tpu_torch/testdata/nested_sf1_expected.json
   (written by the JAX package: tests/test_torch_nested_sql.py
   --write-expected), doubles within a relative 1e-8, with the seconds of
   the host passes beside each wall; and CREATE TABLE AS of per-customer
   arrays into the memory catalog, read twice in a cached session: a miss,
   then a hit staging nothing, both with the reference's rows.
7. mainpath: the merge kernel against its plain version, exact, on the
   very build and probe tensors the cold runs of phases tpch, cache and
   analytics handed to it (one row a launch, with phase kernel's times),
   and every TPC-H query whose reference selects merge-pallas must have
   handed it some in the first two sessions.
8. sf10: first the pinned double-buffered host->device copy of the
   staging module on its own (int32, int64, float64 and bool columns of
   4M + 3 rows in 1 MiB blocks, and a column of five int64 split parts
   narrowed to int32 in 1 MiB and 32 MiB blocks; bitwise equal, read on the
   consuming stream at once); then TPC-H Q3 at SF10 in a cached session, cold then warm:
   rows equal to the JAX package's, the warm run staging nothing.
9. spill: Q3 (joins), Q18 (aggregation under a semi join) and Q13 (left
   join) at SF1 in a cached session under ``query_max_device_memory`` of a
   quarter of the largest working set the reference's unbudgeted run
   handed its spill decision. Each must spill into 4 or more partitions
   and return the reference's rows (a tie group of the ORDER BY compared
   as a multiset).
10. dml: in a session over shared catalogs, CREATE TABLE AS from
   tpch.tiny.orders into the memory catalog, then INSERT, UPDATE, DELETE,
   DROP and CREATE TABLE AS again, each followed by a cached aggregate
   over the table: the read after each statement must miss, a repeated
   read hit, and every read return the rows the JAX package recorded for
   the same sequence; no entry of an older table version may stay.
11. statements (run after phase mainpath, in the sessions of phases tpch
   and cache, before phase sf10): EXPLAIN of the 22 TPC-H queries, whose
   text must equal the reference's; EXPLAIN ANALYZE of Q17 and Q18 cold and
   warm, whose plan lines and every node's ``rows=`` must equal the
   reference's and whose header's planning + execution must equal its
   total within 0.1 ms, then five pairs of the query with and without
   ANALYZE (the cost of the stats, recorded), and EXPLAIN ANALYZE VERBOSE
   of Q18 with ``device_profiling`` (printed); PREPARE / EXECUTE of Q17
   and Q18 with ``?`` for their constants (rows equal the expected, the
   reference's arity message, EXECUTE after DEALLOCATE refused); Q6 with a
   routine (CREATE FUNCTION), whose rows are Q6's and whose plan is its
   hand-written form's, then DROP FUNCTION. Every Q17 and Q18 run must
   launch the merge kernel, counted from 0 before it. Then, in the cached
   session, a transaction over a memory copy of SF1 orders cut by
   ``o_orderdate < date '1992-07-01'``: the read inside it bypasses the
   device cache, a second session over the same catalogs reads the
   committed count, ROLLBACK restores it, a COMMIT publishes, the next read
   misses and the one after hits. Last, at tiny, table(sequence(...)), the
   blackhole catalog, a sqlite database written from tpch.tiny into a
   temporary directory (its join with lineitem and the pushed-down
   constraint in EXPLAIN) and the SHOW and SET/RESET SESSION statements.
   Every answer equals trino_tpu_torch/testdata/statements_sf1_expected.json
   (written by the JAX package: tests/test_torch_statements.py
   --write-expected).

12. compiled (run after phase nested, before phase mainpath): the compiled
   tier (trino_tpu_torch/exec/compiled.py). Each of the 22 TPC-H queries at
   SF1 is built into a CompiledQuery (phase-1 dynamic filters on the host,
   staging, capacity hints), captured into one CUDA graph on its first run
   and run five times, first in an uncached session, then in a cached one
   where a second build of the same query must stage 0 rows and copy 0
   bytes host->device. Rows of the first and fifth run must equal
   tpch_sf1_expected.json; the join tiers of each capture must equal those
   of a trace of the JAX package's CompiledQuery at SF1
   (trino_tpu_torch/testdata/compiled_sf1_expected.json, written by
   tests/test_torch_compiled_tpch.py --write-expected: Q17 is the one query
   whose compiled reference selects merge-pallas), and its graph must hold
   the merge launch. The wrapper counts the warm-up's launches, which must
   equal the launches it recorded into the graph while capturing (those it
   does not count); one more replay of every graph that holds merge
   launches runs under torch.profiler, and the merge kernels the card ran
   in it must equal what the graph holds (the profiler can drop a buffer of
   events, which only lowers the count, so up to three such replays run). The kernel's inputs of each
   warm-up (the same body the graph runs, at the same shapes) join phase
   mainpath. The path's launch count is the warm-ups' plus the graph's
   per replay. Then TPC-DS q95 and q64 at
   SF1 (rows as phase analytics) and Q13 with its join hint cut to a quarter,
   which must capture again and give the expected rows. One line a query:
   build seconds (phase 1, staging), warm-up and capture seconds of every
   capture, the first run's wall and the median of the later replays
   (host clock around ``run()``, synchronised), the same query's eager warm
   wall from phase tpch or analytics, the graph pool's bytes beside
   ``torch.cuda.memory_allocated``, recompiles and merge launches.

13. distributed (run after phase compiled, before phase mainpath): a port
   CoordinatorServer and two in-process WorkerServers on the card, over
   HTTP on localhost. The EXPLAIN (TYPE DISTRIBUTED) text of the 22 TPC-H
   queries at SF1 must equal
   trino_tpu_torch/testdata/distributed_sf1_expected.json (written by the
   JAX package by planning only: tests/test_torch_cluster.py
   --write-expected), and at least one plan must hold a [hash] fragment.
   Then each query runs cold and warm through the statement protocol
   (StatementClient): rows equal tpch_sf1_expected.json after the
   protocol's JSON rounding, doubles within a relative 1e-8, the query
   taking the distributed path; Q6 and Q17 run once more through a dbapi
   cursor with ``?`` parameters. One line a query: walls, fragments, tasks,
   join tiers, merge launches (counted from 0 before each run; a cold run's
   kernel inputs join phase mainpath), the serde's wire, logical and raw
   bytes, and the host seconds of encode (compress within it), decode
   (decompress within it) and hash partitioning, summed over the threads
   that spent them. Last, a second coordinator with two worker subprocesses
   (``python -m trino_tpu_torch.server.worker --device cuda:0``, each with
   its own CUDA context and tables) runs Q1, Q17 and Q18: rows checked, and
   the tasks must have run on both processes. ``distributed_total`` sums
   the walls beside phase tpch's eager walls. On the same in-process
   cluster, before the subprocesses, the repeat-query path: Q1 and Q18 with
   ``result_cache_enabled`` twice each (a MISS, then a HIT read from the
   X-Trino-Tpu-Cache header that creates no task; rows as expected), a
   SELECT over a memory table that misses after an INSERT, a repeated Q6
   served from the plan cache (no optimize span), a materialized view of
   the Q3 shape below whose refresh runs distributed and a SELECT that
   reads it (rows as phase matview's reference), Q6 and Q17 through a
   dbapi cursor with ? and the result cache on (binding A twice, binding B
   twice: MISS, HIT, MISS, HIT; binding B's MISS a plan-cache hit, each HIT
   answered by the dispatcher's serving index without the plan cache), arrays
   and maps of decimals and dates through the protocol (the flat columns'
   strings), and 32 concurrent Q6 of which one executes and 31 are
   answered from its result (``distributed_caches``). Adaptive execution
   is on by default: each query's line carries its plan changes and the
   task-status reads its coordinator made, a query whose ``plan/adapt``
   span carries an error fails the phase, and Q9, Q18, Q21 and every query
   whose default run changed its plan run once more with
   ``adaptive_execution_enabled=false`` (rows checked, walls beside the
   default run's).

14. matview (after phase distributed, before phase mainpath): in a cached
   session at SF1, Q3's join and aggregate of microbench/matview.py with
   its ORDER BY and LIMIT 10, cold and warm; then CREATE MATERIALIZED VIEW
   q3rev over the join and aggregate (storage in the memory catalog): its
   refresh must warm every stored row onto the card (``MV_WARM_ROWS``, 0
   ``MV_WARM_FAILURES``), the next two runs must substitute the view with
   rows bit for bit the base runs', the first a device-cache hit staging 0
   rows and 0 host-to-device bytes, EXPLAIN must equal the reference's
   (``[mv: tpch.sf1.q3rev]`` under its substitution header), and with
   ``materialized_view_substitution`` off the base plan must run. In an
   uncached session, a view of Q18's join and aggregate without its ORDER
   BY and LIMIT, whose refresh runs eager Q18's plan: its join tiers and
   row count must equal the reference's and its merge launches are the
   path's (inputs to phase mainpath); Q18 then reads it with the expected
   rows. Last, the staleness matrix of microbench/matview.py at tiny on
   the card (``staleness_matrix``): 0 incorrect substitutions. The answers
   come from trino_tpu_torch/testdata/matview_sf1_expected.json (written
   by the JAX package: tests/test_torch_matview.py --write-expected).

15. adaptive (after phase matview, before phase mainpath): a port
   CoordinatorServer and two in-process WorkerServers on the card at SF1.
   Both join flips under a lie about customer's row count (10 with
   ``join_max_broadcast_rows=20000``: broadcast->partitioned with buildRows
   150000; 10^9 with 200000: partitioned->broadcast), each run's rows equal
   to the adaptation-off run's and the eager session's, the superseded
   tasks canceled; ``adaptive_capacity_reseed`` on Q3 and Q18 (a
   capacity-reseed change, the expected rows); the hot-key join (90% of
   lineitem's rows on one key) run with adaptation off, a real
   AdaptivePlanner over its stage stats, and the salted producers it makes
   run through the coordinator's task seam (the unsalted rows; the hot
   partition's probe rows more than 4x the others' before, and spread
   after); distributed EXPLAIN ANALYZE of Q1 and Q18, plain and VERBOSE with
   ``device_profiling`` (``[tasks=2`` on every scheduled fragment, each
   scan's ``rows=`` its table's count or, under dynamic filters, the same
   rows in both runs, the outermost aggregation's ``rows=`` the result's row
   count, ``launches=``/``dispatch_overhead=`` on the scan lines from
   measured kernel rows); last, one CompiledQuery of Q17 run twice: the
   compile ledger records a miss then a hit under one fingerprint, the
   CompiledBody row counts both runs and the graph holds the merge kernel,
   whose warm-up inputs join phase mainpath (path ``adaptive``). No
   ``plan/adapt`` span of the phase may carry an error.

16. serving (after phase adaptive, before phase mainpath): the serving plane
   at SF1 on the card, in seven checks, each printed as one line with the
   card. (1) A coordinator with two executor lanes and a dispatch queue of
   4, two in-process workers, 32 concurrent StatementClients sending Q6
   with the result cache off: every row as expected, 429s answered
   (``DISPATCH_REJECTED`` and the clients' ``submit_retries`` >= 1), no
   thread a query (new threads beside the clients' and the HTTP servers'
   connection handlers belong to at most twice the lanes' queries at once);
   the wall, p50 and p99. (2) On it, Q1 and Q18 with the result cache:
   MISS, then a HIT served by the dispatcher (``DISPATCH_CACHE_SERVED`` +1,
   no task, no plan-cache lookup), and a memory table's SELECT missing
   after an INSERT. (3) The reference's two-tenant resource-group config
   (its ``${USER}`` groups at limit 1): user a's second Q3 queues while
   user b's runs, a source ``etl-1`` runs in ``global.etl``, and a query
   parked past its group's queue timeout fails EXCEEDED_QUEUE_TIMEOUT and
   is in the coordinator's history. (4) A cached eager session: Q17 and
   Q18 cold and warm under group ``global.a`` (``CACHE_SHARES`` 0.5, the
   device cache's budget 2 x (a's bytes + the largest storm entry)), then
   group ``global.b``'s scans of TPC-H and TPC-DS tables (at most three
   columns each) past the budget: a's entries and bytes
   survive, every device-cache eviction in the memory ledger is b's, a
   warm Q17 and Q18 after it stage 0 rows (rows and tiers as phase cache,
   merge launches the path's, their cold inputs to phase mainpath), and
   evicting the cache leaves none of its tensors alive and drops
   ``torch.cuda.memory_allocated`` by at least its bytes.
   (5) A worker whose pool holds a running Q1's reservation but not that
   plus its warm device cache sheds the cache (a ``pool-overflow`` ledger
   event, the cache under the pool less the reservation) and Q1 finishes
   with its rows. (6) Two workers whose pools (64 MiB, or half the peak
   reservation of an unlimited run where that is less) the orders x
   lineitem join overflows: it fails EXCEEDED_CLUSTER_MEMORY (the script
   feeds the workers' announces to the cluster memory manager every 2 ms
   while it runs), its
   postmortem's memory block has the reference's keys, ``select count(*)
   from nation`` then finishes with 25, and the announce's
   ``deviceMemoryBytes`` equals ``torch.cuda.mem_get_info``'s total.
   (7) A coordinator with a password file and a JWT secret: 401 without
   credentials, Basic and Bearer accepted, 403 on another user's query,
   the created and completed events (the failed one with its error), and
   ``/v1/metrics`` with the dispatch and resource-group series.
17. observe (after phase serving, before phase mainpath): the observability
   plane at SF1 on a port coordinator with two in-process workers and an
   OTLP stub collector in this process. Q1, Q3 and Q18 distributed, cold
   and warm (rows as expected): each query's exchange-pull bytes in the
   flow ledger equal its ``EXCHANGE_BYTES`` delta and its staging-transfer
   bytes its ``STAGED_H2D_BYTES`` delta, exactly, and ``/flows`` shows the
   same pulls; each warm query's trace holds a task span of every task
   (but a superseded producer's) on both workers, under the query's trace
   id and the coordinator's schedule span, and its timeline's exclusive
   phases and residual make up the wall within 1 ms. Through SQL:
   ``system.runtime.queries`` has the six queries FINISHED with their row
   counts, ``tasks`` their tasks on both workers, ``nodes`` 2 active, and
   ``transfers`` Q3's link totals of ``/flows``. The collector holds every
   span of Q1's trace. The cached Q17 and Q18 (``device_cache_enabled``,
   ``device_profiling``), each joined with the first worker's row of
   ``system.runtime.nodes`` so that it runs on the coordinator's executor,
   where the merge kernel launches (on the distributed path it does not),
   cold and warm: rows and cached tiers as phase cache, at least one
   merge launch each, a measured ``Join`` row on ``coordinator`` in
   ``system.runtime.kernels`` and device seconds at most wall seconds
   (cold inputs to phase mainpath, path ``observe``). A system page lies on
   the card. Q17's CompiledQuery twice: ``system.runtime.compiles`` shows
   a miss then a hit under its fingerprint (path ``observe_compiled``).
   ``system.runtime.device_cache`` equals the cache's entries and bytes; a
   metric series through ``system.metrics`` equals ``/v1/metrics``; a system
   query twice with the result cache on is a BYPASS and enters no cache.
   ``CALL system.runtime.kill_query`` fails a running Q18 with its reason
   and its tasks answer 404; EXPLAIN ANALYZE of Q18 prints "Phase ledger:"
   phases its timeline has and "Data flow:" bytes its ``/flows`` has; the
   CLI as a subprocess (``--execute``) prints Q1's rows as the table and
   ``[cache: HIT]``; the OTLP exporters dropped nothing. Recorded: the
   walls beside phase distributed's, the host microseconds of one
   ``record_transfer`` and the records a query.
18. fte (after phase observe, before phase mainpath): the fault-tolerant
   tier and the spooled result protocol at SF1 on a port coordinator with
   two in-process workers, ``TRINO_TPU_SPOOL_DIR`` a fresh directory. Q1,
   Q3, Q9 and Q18 under ``retry_policy=TASK``, cold and warm: rows as
   expected, read by their consumers off the spool, and no file of the
   query (``.tmp`` ones included) left once the client has its answer;
   their warm walls beside phase distributed's. Q3 with the first attempt
   of slot 0 of its hash stage failing and Q18 with that of its source
   stage: rows as expected, that attempt the one retried, the winner's
   attempt 1; then ``torch.cuda.memory_allocated()`` (once the frees
   deferred behind the staging copy's stream have landed) back at the
   phase's start and at its value after the clean runs, but for the device
   cache's growth, and no worker reservation left.
   Every attempt of one slot failing: "failed after 3 attempts" and no file
   left. Q1's stages run through the coordinator's scheduler seam, their
   tasks deleted from the workers (404), and the root fragment's gather
   reading their spool files (``SPOOL_READS`` one a file,
   ``EXCHANGE_BYTES`` unmoved), Q1's rows. Q1 with its first source
   attempt of slot 0 sleeping 60 s and the speculation constants at 0.5 s
   and 1.5x: finished in under 30 s with the rows, ``.0.0.a1`` in the
   speculation history, nothing left in flight, the loser gone from its
   worker. The hot-key join of phase adaptive under the tier: one
   skew-mitigation change from the scheduler itself, the hot partition over
   4x the rest, rows equal to adaptation off. Spooled results: an export of
   lineitem's four integer columns written by the workers (2 MiB segments,
   at least 6), fetched in parallel by a StatementClient, its row count and
   column sums equal an eager Session's, every segment acked (0 bytes held),
   ``/flows``' spool-write and segment-fetch bytes equal to the
   ``RESULT_SEGMENT_BYTES`` written and served deltas, a segment-fetch phase
   in its timeline; a ``Range`` GET 206 with the whole GET's bytes and 416
   past the end; orders sorted by key through the coordinator's store, in
   order. Last, the cached Q18 joined with a row of system.runtime.nodes
   runs on the coordinator's executor and spools there, cold and warm: rows
   as expected, at least one merge launch each (the cold run's inputs to
   phase mainpath, path ``fte``). Recorded: walls, spool bytes a query, the
   segment fetch rate.

With ``--profile`` it also runs each query once more (warm) in each of the
five sessions (tpch, cache, analytics, scalar, nested) under
torch.profiler and prints the device time by kernel, the device's busy
share of the wall, the device launches and the largest device item; one
replay of each TPC-H query's graph the same way (the merge kernel's symbol
must show in Q17's); and it times the DML sequence over tpch.sf1.orders (1.5M
rows), holding each read's cache disposition to the reference's.

The last three lines of standard output are the kernel summary
``{"kernels": [...]}``, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import subprocess
import sys
import time
import types

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)
TIERS = ("dense", "fused", "merge-sorted", "merge-pallas", "legacy")
INT32_MAX = 2**31 - 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, by CUDA
    events around ``iters`` calls after two warm-up calls."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``launches`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events. The
    host's cost per call drops out; the graph's gaps between kernels stay."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del graph
    torch.cuda.synchronize()
    return ms


def host_us(fn, iters: int) -> float:
    """Host microseconds per call of ``fn`` (the enqueue: no synchronise
    inside the loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / iters
    torch.cuda.synchronize()
    return us


def bound_bytes(nb: int, np_: int) -> int:
    """What the function must move: the probe read and the output written
    once, the build read once or one 32-byte sector a probe key."""
    return 8 * np_ + min(4 * nb, 32 * np_)


def library_merge(build, probe):
    """The same function as one library search plus an equality gather."""
    import torch

    pos = torch.searchsorted(build, probe)
    hit = build[pos.clamp(max=build.shape[0] - 1)] == probe
    return torch.where(hit, pos.to(torch.int32), torch.full_like(probe, -1))


def kernel_cases(rng):
    """(name, build, probe, block_build) as host int32 arrays."""
    import numpy as np

    def sorted_unique(n, hi):
        return np.sort(rng.choice(hi, size=n, replace=False)).astype(np.int32)

    def probe_over(n, hi):
        return np.sort(rng.integers(0, hi, size=n)).astype(np.int32)

    cases = [
        ("q17_sf1", sorted_unique(256, 200_000), probe_over(6113, 200_000), 2048),
        ("q18_sf1", sorted_unique(65, 6_000_000), probe_over(455, 6_000_000), 2048),
        ("ragged", sorted_unique(3001, 50_000), probe_over(5003, 50_000), 256),
        ("empty_probe", sorted_unique(100, 1000), np.zeros(0, np.int32), 2048),
        ("empty_build", np.zeros(0, np.int32), probe_over(100, 1000), 2048),
    ]
    # the null-slot edge: a dead-row INT32_MAX build tail and probe slots
    # holding INT32_MAX itself
    b = np.concatenate([np.arange(0, 1000, 2, dtype=np.int32),
                        np.full(7, INT32_MAX, np.int32)])
    p = np.sort(np.concatenate([probe_over(3000, 1200),
                                np.full(5, INT32_MAX, np.int32)])).astype(np.int32)
    cases.append(("int32_max_edge", b, p, 256))
    cases.append(("large_16m_4m", sorted_unique(4 << 20, 1 << 30),
                  probe_over(16 << 20, 1 << 30), 2048))
    # a build 16x denser than the probe: each probe tile spans about 32K
    # build keys, many ring chunks
    cases.append(("large_1m_16m", sorted_unique(16 << 20, 1 << 30),
                  probe_over(1 << 20, 1 << 30), 2048))
    # over a thousand full probe tiles and a ragged last one, against a
    # sparser build (one-chunk spans) and a denser one (several chunks)
    cases.append(("ragged_2m_1m", sorted_unique(1 << 20, 1 << 30),
                  probe_over((2 << 20) + 777, 1 << 30), 2048))
    cases.append(("ragged_2m_8m", sorted_unique(8 << 20, 1 << 30),
                  probe_over((2 << 20) + 777, 1 << 30), 2048))
    # one input, three block_build values: the outputs must be equal
    b = sorted_unique(1 << 16, 1 << 24)
    p = probe_over(1 << 20, 1 << 24)
    for bb in (128, 2048, 8192):
        cases.append((f"sweep_bb{bb}", b, p, bb))
    # Q2's SF1 shape: a build of 1024 slots, 804 live partkeys and a dead
    # INT32_MAX tail of 220, against 1024 probe keys that all match (517
    # distinct); drawn last so the shapes above keep their earlier inputs
    live = sorted_unique(804, 200_000)
    b = np.concatenate([live, np.full(220, INT32_MAX, np.int32)])
    p = np.sort(rng.choice(live, size=1024)).astype(np.int32)
    cases.insert(2, ("q2_sf1", b, p, 2048))
    return cases


def check_and_time(name, b, p, bb, **extra):
    """The merge kernel against its plain version on the card at one input
    (exact), then its times; returns (row, the kernel's output)."""
    import torch

    from trino_tpu_torch.ops import merge

    got = merge.merge_unique_sorted(b, p, block_build=bb)
    want = merge.merge_unique_sorted_plain(b, p, block_build=bb)
    torch.cuda.synchronize()
    if got.dtype != torch.int32 or got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"merge kernel != plain at {name}: first bad {bad}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()) \
        if got.numel() else 0
    nb, np_ = b.shape[0], p.shape[0]
    nbytes = bound_bytes(nb, np_)
    big = np_ >= (1 << 20)
    call = lambda: merge.merge_unique_sorted(b, p, block_build=bb)  # noqa: E731
    lib = lambda: library_merge(b, p)  # noqa: E731
    row = {
        "shape": name, "build": nb, "probe": np_, "block_build": bb, **extra,
        "max_abs_err": err,
        "kernel_device_ms": graph_ms(call, 20 if big else 200),
        "kernel_ms": time_ms(call, 20 if big else 200),
        "wrapper_host_us": host_us(call, 20 if big else 500),
        "plain_ms": time_ms(lambda: merge.merge_unique_sorted_plain(b, p, block_build=bb),
                            2 if big else 20),
        "library_device_ms": graph_ms(lib, 20 if big else 200) if nb and np_ else None,
        "library_ms": time_ms(lib, 20 if big else 200) if nb and np_ else None,
        "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
        "bytes": nbytes,
    }
    row["bound_share"] = (row["bound_ms"] / row["kernel_device_ms"]
                          if nbytes and np_ and nb else None)
    print("kernel", json.dumps(row), flush=True)
    return row, got


def phase_kernel(device):
    import numpy as np
    import torch

    from trino_tpu_torch.ops import merge

    rng = np.random.default_rng(1234)
    rows = []
    sweep_out = None
    for name, b_np, p_np, bb in kernel_cases(rng):
        b = torch.from_numpy(b_np).to(device)
        p = torch.from_numpy(p_np).to(device)
        row, got = check_and_time(name, b, p, bb)
        if name.startswith("sweep_"):
            if sweep_out is not None and not torch.equal(got, sweep_out):
                raise AssertionError(f"merge kernel output changes with block_build at {name}")
            sweep_out = got
        rows.append(row)
        del b, p, got
        torch.cuda.empty_cache()
    one_b = torch.zeros(1, dtype=torch.int32, device=device)
    one_p = torch.zeros(1, dtype=torch.int32, device=device)
    one = lambda: merge.merge_unique_sorted(one_b, one_p)  # noqa: E731
    call_1x1 = {"wrapper_call_ms_1x1": time_ms(one, 500),
                "kernel_device_ms_1x1": graph_ms(one, 200),
                "wrapper_host_us_1x1": host_us(one, 2000)}
    print("kernel", json.dumps(call_1x1), flush=True)
    return rows, call_1x1


def jsonable(v):
    """A result value in the expected files' form: decimals and dates as
    strings, arrays and rows as lists, maps as {"map": [[key, value], ...]}
    in the order of the keys' text."""
    if v is None or isinstance(v, (int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    if isinstance(v, dict):
        return {"map": [[jsonable(k), jsonable(x)]
                        for k, x in sorted(v.items(), key=lambda kv: str(kv[0]))]}
    return str(v)


def jsonable_rows(rows):
    return [[jsonable(v) for v in r] for r in rows]


def tier_counts(metric, tiers):
    return {t: metric.value(t) for t in tiers}


def testdata(name):
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "trino_tpu_torch", "testdata", name)) as f:
        return json.load(f)


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def plane_counters():
    """The staging and device-cache counters a run moves."""
    from trino_tpu_torch.obs import metrics as M

    return {"hits": M.DEVICE_CACHE_HITS.value(), "misses": M.DEVICE_CACHE_MISSES.value(),
            "build_hits": M.DEVICE_CACHE_BUILD_HITS.value(),
            "staged_rows": M.STAGED_ROWS.value(), "h2d_bytes": M.STAGED_H2D_BYTES.value(),
            **{f"{ph}_s": M.STAGING_PHASE_SECONDS.value(ph)
               for ph in ("scan", "decode", "transfer", "host-cache")}}


def counters_delta(before):
    now = plane_counters()
    return {k: now[k] - before[k] for k in before}


def timed_execute(session, sql, device):
    """(result, wall seconds, plane counter deltas) of one statement."""
    c0 = plane_counters()
    sync(device)
    t0 = time.perf_counter()
    res = session.execute(sql)
    sync(device)
    return res, time.perf_counter() - t0, counters_delta(c0)


def rows_close(got, want, rel_tol):
    """Equal rows, except that two floats may differ by ``rel_tol``."""
    import math

    def close(a, b):
        if isinstance(a, float) and isinstance(b, float):
            return math.isclose(a, b, rel_tol=rel_tol, abs_tol=1e-12) or \
                (math.isnan(a) and math.isnan(b))
        return a == b

    return len(got) == len(want) and all(
        len(g) == len(w) and all(close(a, b) for a, b in zip(g, w))
        for g, w in zip(got, want))


def check_rows(what, got, want, sort_keys=None, rel_tol=None):
    """Exact rows in order; with ``sort_keys`` (the ORDER BY's column
    positions) a tie group may differ in order and is compared as a
    multiset; with ``rel_tol`` doubles may differ by that much."""
    if got == want or (rel_tol is not None and rows_close(got, want, rel_tol)):
        return
    same_order = sort_keys is not None and len(got) == len(want) and \
        [[r[k] for k in sort_keys] for r in got] == [[r[k] for k in sort_keys] for r in want]
    if same_order and sorted(map(repr, got)) == sorted(map(repr, want)):
        return
    same = sorted(map(repr, got)) == sorted(map(repr, want))
    raise AssertionError(
        f"{what}: rows differ from the expected rows: {len(got)} vs {len(want)} rows"
        f"{' (same rows, another order)' if same else ''}; first got {got[:2]}, "
        f"want {want[:2]}")


class MergeCapture:
    """Wraps the merge kernel's wrapper while the queries run: keeps the
    inputs of every cold run for phase mainpath (the wrapper still counts
    each launch, and the capture launches nothing). Nothing is kept while a
    CUDA graph is being captured: a clone then copies no data yet."""

    def __init__(self):
        self.captured = []  # (path, query, build, probe, block_build)
        self.now = None  # (path, query, run)

    def __enter__(self):
        import torch

        from trino_tpu_torch.ops import merge

        self.wrapper = merge.merge_unique_sorted

        def capture(build, probe, block_build=2048):
            if self.now is not None and self.now[2] == "cold" and \
                    not torch.cuda.is_current_stream_capturing():
                self.captured.append((self.now[0], self.now[1], build.clone(),
                                      probe.clone(), block_build))
            return self.wrapper(build, probe, block_build=block_build)

        merge.merge_unique_sorted = capture
        return self

    def __exit__(self, *exc):
        from trino_tpu_torch.ops import merge

        merge.merge_unique_sorted = self.wrapper
        self.now = None


def run_checked(session, device, path, q, label, sql, want_rows, want_tiers, cap,
                sort_keys=None, rel_tol=None):
    """One run of query ``q``: rows and join tiers checked, merge launches
    counted from 0 just before it; returns (wall, launches, counters)."""
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.ops import merge

    cap.now = (path, q, label)
    merge.launches = 0
    t0_tiers = tier_counts(M.FUSED_JOIN_SELECTIONS, want_tiers)
    res, wall, counters = timed_execute(session, sql, device)
    launches = merge.launches
    cap.now = None
    tiers = {t: v - t0_tiers[t]
             for t, v in tier_counts(M.FUSED_JOIN_SELECTIONS, want_tiers).items()}
    what = f"{q if isinstance(q, str) else f'Q{q}'} ({path}, {label})"
    check_rows(what, jsonable_rows(res.rows), want_rows, sort_keys, rel_tol)
    if tiers != want_tiers:
        raise AssertionError(f"{what} join tiers {tiers} != the reference's {want_tiers}")
    if want_tiers.get("merge-pallas", 0) >= 1 and launches < 1:
        raise AssertionError(f"{what} selected merge-pallas but did not "
                             f"launch the merge kernel: launches={launches}")
    return wall, launches, counters, len(res.rows)


def phase_tpch(device, expected, cap):
    from trino_tpu_torch import Session

    session = Session(properties={"catalog": "tpch", "schema": "sf1",
                                  "fused_join_pallas": True}, device=device)
    out = {}
    for q in range(1, 23):
        entry = expected[str(q)]
        runs = []
        for label in ("cold", "warm"):
            wall, launches, c, nrows = run_checked(
                session, device, "tpch", q, label, entry["sql"], entry["rows"],
                entry["tiers"], cap)
            runs.append({"run": label, "wall_s": wall, "merge_launches": launches,
                         "staged_rows": c["staged_rows"], "h2d_bytes": c["h2d_bytes"],
                         **{k: c[k] for k in ("scan_s", "decode_s", "transfer_s")}})
        out[q] = runs
        print("tpch", json.dumps({"query": f"Q{q}", "scale": "sf1", "rows": nrows,
                                  "tiers": entry["tiers"], "runs": runs}), flush=True)
    return out, session


STATS_COST_ORDER = ("off", "on", "off", "on")


def tpch_stats_cost(session, device, expected):
    """The cost of per-operator stats on the eager tier: the 22 warm in the
    uncached session, passes in turns with ``Executor.collect_stats`` set
    off by this script and on (the default)."""
    from trino_tpu_torch.exec.executor import Executor

    sums = {"off": [], "on": []}
    for label in STATS_COST_ORDER:
        Executor.collect_stats = label == "on"
        try:
            wall = 0.0
            for q in range(1, 23):
                entry = expected[str(q)]
                res, w, _c = timed_execute(session, entry["sql"], device)
                check_rows(f"Q{q} (tpch, stats {label})", jsonable_rows(res.rows),
                           entry["rows"])
                wall += w
        finally:
            Executor.collect_stats = True
        sums[label].append(wall)
    out = {f"stats_{k}_warm_wall_s": v for k, v in sums.items()}
    print("tpch_stats_cost", json.dumps(out), flush=True)
    return out


def cached_tensors():
    """Every tensor of every resident device-cache entry."""
    from trino_tpu_torch.devcache import DEVICE_CACHE

    out = {}
    for e in DEVICE_CACHE.entries():
        v = e.value
        if hasattr(v, "columns"):
            ts = [t for c in v.columns for t in (c.values, c.nulls, c.hi) if t is not None]
            ts += [v.sel] if v.sel is not None else []
        else:  # a sorted build
            ts = list(v.cols) + [v.rows, v.live]
        out[e.key] = ts
    return out


def phase_cache(device, expected, plane, cap):
    """The 22 queries in a cached session: all cold, then all warm."""
    import torch

    from trino_tpu_torch import Session
    from trino_tpu_torch.devcache import DEVICE_CACHE, HOST_CACHE

    DEVICE_CACHE.invalidate_all()
    HOST_CACHE.invalidate_all()
    session = Session(properties={"catalog": "tpch", "schema": "sf1", "fused_join_pallas": True,
                                  "device_cache_enabled": True}, device=device)
    runs = {q: {} for q in range(1, 23)}
    for label in ("cold", "warm"):
        if label == "warm":
            snapshot = {k: [t.clone() for t in ts] for k, ts in cached_tensors().items()}
        for q in range(1, 23):
            entry = expected[str(q)]
            wall, launches, c, nrows = run_checked(
                session, device, "cache", q, label, entry["sql"], entry["rows"],
                plane["tiers_cached"][str(q)][label], cap)
            runs[q][label] = {"wall_s": wall, "merge_launches": launches, **c}
        if label == "warm":
            for q in range(1, 23):
                cold, warm = runs[q]["cold"], runs[q]["warm"]
                if warm["staged_rows"] or warm["h2d_bytes"] or warm["misses"] \
                        or warm["hits"] != cold["hits"] + cold["misses"]:
                    raise AssertionError(
                        f"Q{q} (cache, warm) was not served from the cache: staged "
                        f"{warm['staged_rows']} rows, {warm['h2d_bytes']} bytes, "
                        f"{warm['misses']} misses, {warm['hits']} hits of "
                        f"{cold['hits'] + cold['misses']} lookups")
            after = cached_tensors()
            if after.keys() != snapshot.keys() or not all(
                    torch.equal(t, s) for k in after for t, s in zip(after[k], snapshot[k])):
                raise AssertionError("a warm run changed a cached tensor or entry")
            del snapshot
    for q in range(1, 23):
        print("cache", json.dumps({
            "query": f"Q{q}", "tiers": plane["tiers_cached"][str(q)]["warm"],
            **{f"{label}_{k}": v for label in ("cold", "warm")
               for k, v in runs[q][label].items()}}), flush=True)
    resident = {"resident_bytes": DEVICE_CACHE.cached_bytes(), "entries": len(DEVICE_CACHE),
                "host_tier_bytes": HOST_CACHE.cached_bytes(), "budget_bytes": DEVICE_CACHE.max_bytes,
                "memory_allocated": torch.cuda.memory_allocated(device) if device.type == "cuda"
                else None}
    print("cache_total", json.dumps({
        **{f"{label}_{k}": sum(runs[q][label][k] for q in runs)
           for label in ("cold", "warm")
           for k in ("wall_s", "staged_rows", "h2d_bytes", "scan_s", "decode_s", "transfer_s")},
        **resident}), flush=True)
    return runs, resident, session


ANALYTICS_REL_TOL = 1e-8  # doubles at SF1: float sums in another order


def phase_analytics(device, analytics, cap, card):
    """TPC-DS q95, q64 and their wide variants and the eight window, set
    and aggregate queries at SF1 in an uncached session, cold then warm:
    rows (doubles within ANALYTICS_REL_TOL, the tie groups of q64's partial
    ORDER BY as multisets) and join tiers equal the reference's, and a
    query whose reference selects merge-pallas launches the merge kernel."""
    from trino_tpu_torch import Session

    session = Session(properties=dict(analytics["properties"]), device=device)
    out = {}
    for name, entry in analytics["queries"].items():
        runs = []
        for label in ("cold", "warm"):
            wall, launches, c, nrows = run_checked(
                session, device, "analytics", name, label, entry["sql"], entry["rows"],
                entry["tiers"], cap, entry["sort_keys"], ANALYTICS_REL_TOL)
            runs.append({"run": label, "wall_s": wall, "merge_launches": launches,
                         "staged_rows": c["staged_rows"], "h2d_bytes": c["h2d_bytes"],
                         **{k: c[k] for k in ("scan_s", "decode_s", "transfer_s")}})
        out[name] = runs
        print("analytics", json.dumps({"query": name, "scale": "sf1", "rows": nrows,
                                       "tiers": entry["tiers"], "runs": runs, "card": card}),
              flush=True)
    return out, session


SCALAR_REL_TOL = 1e-8  # doubles at SF1, as phase analytics


def phase_scalar(device, scalar, card):
    """The scalar-family queries at SF1 in an uncached session, cold then
    warm: rows equal the reference's (doubles within SCALAR_REL_TOL); the
    seconds of host passes over vocabularies and tables of days beside each
    wall."""
    from trino_tpu_torch import Session
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.ops import merge

    session = Session(properties=dict(scalar["properties"]), device=device)
    out = {}
    for name, entry in scalar["queries"].items():
        runs = []
        for label in ("cold", "warm"):
            merge.launches = 0
            host0 = M.SCALAR_HOST_SECONDS.value()
            res, wall, c = timed_execute(session, entry["sql"], device)
            host_s = M.SCALAR_HOST_SECONDS.value() - host0
            check_rows(f"{name} (scalar, {label})", jsonable_rows(res.rows), entry["rows"],
                       rel_tol=SCALAR_REL_TOL)
            runs.append({"run": label, "wall_s": wall, "vocab_host_s": host_s,
                         "vocab_host_share": host_s / wall, "merge_launches": merge.launches,
                         "staged_rows": c["staged_rows"], "h2d_bytes": c["h2d_bytes"],
                         **{k: c[k] for k in ("scan_s", "decode_s", "transfer_s")}})
        out[name] = runs
        print("scalar", json.dumps({"query": name, "scale": "sf1", "rows": len(res.rows),
                                    "runs": runs, "card": card}), flush=True)
    return out, session


NESTED_REL_TOL = 1e-8  # doubles at SF1, as phase analytics


def phase_nested(device, nested, card):
    """The nested-type queries at SF1 in an uncached session, cold then
    warm: rows equal the reference's (doubles within NESTED_REL_TOL), the
    seconds of the host passes (the MATCH_RECOGNIZE matcher, the ORDER BY
    of pages with arrays) beside each wall. Then n_ctas_cached: CREATE
    TABLE AS of per-customer arrays into the memory catalog, and one
    aggregate over it read twice in a cached session: a miss, then a hit
    that stages nothing, both with the reference's rows."""
    from trino_tpu_torch import Session
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.ops import merge

    session = Session(properties=dict(nested["properties"]), device=device)
    out = {}
    for name, entry in nested["queries"].items():
        runs = []
        for label in ("cold", "warm"):
            merge.launches = 0
            host0 = M.NESTED_HOST_SECONDS.value()
            res, wall, c = timed_execute(session, entry["sql"], device)
            host_s = M.NESTED_HOST_SECONDS.value() - host0
            check_rows(f"{name} (nested, {label})", jsonable_rows(res.rows), entry["rows"],
                       rel_tol=NESTED_REL_TOL)
            runs.append({"run": label, "wall_s": wall, "host_s": host_s,
                         "host_share": host_s / wall, "merge_launches": merge.launches,
                         "staged_rows": c["staged_rows"], "h2d_bytes": c["h2d_bytes"],
                         **{k: c[k] for k in ("scan_s", "decode_s", "transfer_s")}})
        out[name] = runs
        print("nested", json.dumps({"query": name, "scale": "sf1", "rows": len(res.rows),
                                    "runs": runs, "card": card}), flush=True)
    ctas = nested["ctas"]
    cached = Session(properties={**nested["properties"], "device_cache_enabled": True},
                     device=device)
    merge.launches = 0
    _res, ctas_wall, _c = timed_execute(cached, ctas["sql"], device)
    runs = [{"run": "ctas", "wall_s": ctas_wall, "merge_launches": merge.launches}]
    for label in ("miss", "hit"):
        merge.launches = 0
        res, wall, c = timed_execute(cached, ctas["read_sql"], device)
        check_rows(f"n_ctas_cached ({label})", jsonable_rows(res.rows), ctas["rows"])
        runs.append({"run": label, "wall_s": wall, "merge_launches": merge.launches,
                     **{k: c[k] for k in ("hits", "misses", "staged_rows", "h2d_bytes")}})
    miss, hit = runs[1], runs[2]
    if miss["misses"] < 1 or hit["misses"] or hit["hits"] < 1 or hit["staged_rows"] \
            or hit["h2d_bytes"]:
        raise AssertionError(f"n_ctas_cached: the first read must miss and the second hit "
                             f"staging nothing: {runs[1:]}")
    out["n_ctas_cached"] = runs
    print("nested", json.dumps({"query": "n_ctas_cached", "scale": "sf1", "rows": len(res.rows),
                                "runs": runs, "card": card}), flush=True)
    return out, session


COMPILED_REPLAYS = 5  # synchronised replays of each captured query


PROFILED_REPLAY_TRIES = 3  # the profiler can drop a buffer of a replay's events


def replay_merge_kernels(cq, device, want):
    """Replays of ``cq``'s graph under torch.profiler, until one shows
    ``want`` merge kernels or PROFILED_REPLAY_TRIES have run: (the most merge
    kernels a trace showed, their device milliseconds, each trace's device
    events). A dropped buffer can only lower a trace's count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best, best_ms, traces = -1, None, []
    for _ in range(PROFILED_REPLAY_TRIES):
        sync(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cq.run()
            torch.cuda.synchronize(device)
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        traces.append(sum(e.count for e in events))
        merge = [e for e in events if "merge_unique" in e.key]
        n = sum(e.count for e in merge)
        if n > best:
            best = n
            best_ms = sum(e.self_cuda_time_total if getattr(e, "self_device_time_total", None)
                          is None else e.self_device_time_total for e in merge) / 1e3
        if n == want:
            break
    return best, best_ms, traces


def run_compiled(session, device, path, name, sql, want_rows, want, cap, sort_keys=None,
                 rel_tol=None, replays=COMPILED_REPLAYS, cut_join_hints=False,
                 mainpath=None):
    """Build ``sql`` into a CompiledQuery and run it ``replays`` times (the
    first run captures its graph, and again after each overflow): the rows
    of the first and last run are checked, the join tiers a capture against
    the reference's (``want``: its tiers over its recompiles + 1 traces),
    and the merge kernel's launches: the wrapper's count of the warm-ups
    against what it recorded into the graphs, and one profiled replay of a
    graph that holds merge launches against the kernels the card ran. The
    warm-ups' merge inputs go to ``cap`` under the path ``mainpath``.
    Returns the record printed for the query and the CompiledQuery, closed."""
    from trino_tpu_torch.exec.compiled import CompiledQuery
    from trino_tpu_torch.exec.query import plan_sql
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.ops import merge
    import torch

    what = f"{name} ({path}, compiled)"
    merge.launches = 0
    tiers0 = tier_counts(M.FUSED_JOIN_SELECTIONS, TIERS)
    c0 = plane_counters()
    sync(device)
    t0 = time.perf_counter()
    cq = CompiledQuery.build(session, plan_sql(session, sql))
    build_s = time.perf_counter() - t0
    build_counters = counters_delta(c0)
    if cut_join_hints:
        cq.capacity_hints = {k: max(v // 4, 1) if k.startswith("join:") else v
                             for k, v in cq.capacity_hints.items()}
    walls = []
    cap.now = (mainpath, name, "cold") if mainpath else None
    for i in range(replays):
        sync(device)
        t = time.perf_counter()
        page = cq.run()
        sync(device)
        walls.append(time.perf_counter() - t)
        if i in (0, replays - 1):
            check_rows(f"{what} run {i + 1}", jsonable_rows(page.to_pylist()), want_rows,
                       sort_keys, rel_tol)
        if i == 0:
            after_first = {"memory_allocated": torch.cuda.memory_allocated(device),
                           "memory_reserved": torch.cuda.memory_reserved(device)} \
                if device.type == "cuda" else {}
    cap.now = None
    warmup_launches = merge.launches
    tiers = {t: v - tiers0[t] for t, v in tier_counts(M.FUSED_JOIN_SELECTIONS, TIERS).items()}
    in_graph = cq.captures[-1]["merge_launches"]
    if want is not None:
        ref_traces, traces = want["recompiles"] + 1, cq.recompiles + 1
        if any(tiers[t] * ref_traces != want["tiers"][t] * traces for t in TIERS):
            raise AssertionError(f"{what} join tiers {tiers} over {traces} captures != the "
                                 f"reference's {want['tiers']} over {ref_traces} traces")
        if want["tiers"].get("merge-pallas", 0) >= 1 and in_graph < 1:
            raise AssertionError(f"{what} selected merge-pallas but its graph holds no "
                                 f"merge launch: {cq.captures}")
    if warmup_launches != sum(c["merge_launches"] for c in cq.captures):
        raise AssertionError(f"{what}: the warm-ups launched the merge kernel "
                             f"{warmup_launches} times, the graphs hold {cq.captures}")
    profiled = profiled_ms = traces = None
    if in_graph:
        profiled, profiled_ms, traces = replay_merge_kernels(cq, device, in_graph)
        if profiled != in_graph:
            raise AssertionError(f"{what}: profiled replays ran at most {profiled} merge "
                                 f"kernels (device events a trace: {traces}), the graph "
                                 f"holds {in_graph}")
    replayed = sum(c["merge_launches"] * c["replays"] for c in cq.captures)
    record = {
        "query": name, "session": path, "rows": len(want_rows), "recompiles": cq.recompiles,
        "build_s": build_s, "phase1_s": cq.phase1_s, "staging_s": cq.staging_s,
        "df_apply_s": cq.df_apply_s,
        "warmup_s": sum(c["warmup_s"] for c in cq.captures),
        "capture_s": sum(c["capture_s"] for c in cq.captures),
        "captures": cq.captures, "first_run_s": walls[0],
        "replay_walls_s": walls[1:], "replay_median_s": sorted(walls[1:])[len(walls[1:]) // 2]
        if len(walls) > 1 else None,
        "pool_bytes": cq.captures[-1]["pool_bytes"] if cq.captures else 0,
        **after_first, "merge_launches": warmup_launches + replayed,
        "merge_launches_warmup": warmup_launches, "merge_launches_replayed": replayed,
        "profiled_replay_merge_kernels": profiled,
        "profiled_replay_merge_device_ms": profiled_ms, "profiled_replay_events": traces,
        "tiers": tiers,
        "fresh_staged_rows": cq.fresh_staged_rows, "cache_hits": cq.cache_hits,
        "staged_rows": build_counters["staged_rows"], "h2d_bytes": build_counters["h2d_bytes"]}
    cq.close()
    return record, cq


def phase_compiled(device, expected, compiled, analytics, eager_walls, cap, card):
    """The compiled tier (trino_tpu_torch/exec/compiled.py): the 22 TPC-H
    queries at SF1, each built into a CompiledQuery, captured into one CUDA
    graph and replayed, in an uncached session and then in a cached one,
    where a second build must stage nothing; TPC-DS q95 and q64 at SF1; Q13
    with its join hint cut to a quarter, which must capture again."""
    from trino_tpu_torch import Session

    props = {"catalog": "tpch", "schema": "sf1", "fused_join_pallas": True}
    out = []
    for path, extra in (("uncached", {}), ("cached", {"device_cache_enabled": True})):
        session = Session(properties={**props, **extra}, device=device)
        for q in range(1, 23):
            entry = expected[str(q)]
            rec, _ = run_compiled(session, device, path, f"Q{q}", entry["sql"], entry["rows"],
                                  compiled["queries"][str(q)], cap,
                                  mainpath=f"compiled_{path}")
            rec["eager_warm_wall_s"] = eager_walls.get(f"Q{q}")
            if path == "cached":
                # a second build of the same query: every scan a cache hit
                warm, _ = run_compiled(session, device, path, f"Q{q}", entry["sql"],
                                       entry["rows"], compiled["queries"][str(q)], cap,
                                       replays=1)
                if warm["fresh_staged_rows"] or warm["staged_rows"] or warm["h2d_bytes"]:
                    raise AssertionError(
                        f"Q{q} (cached, compiled): the second build staged "
                        f"{warm['fresh_staged_rows']} rows, {warm['h2d_bytes']} bytes")
                rec["warm_build"] = {k: warm[k] for k in (
                    "build_s", "staging_s", "fresh_staged_rows", "cache_hits", "h2d_bytes",
                    "first_run_s", "merge_launches")}
            out.append(rec)
            print("compiled", json.dumps({**rec, "card": card}), flush=True)
    session = Session(properties=dict(analytics["properties"]), device=device)
    for name in ("q95", "q64"):
        entry = analytics["queries"][name]
        rec, _ = run_compiled(session, device, "analytics", name, entry["sql"], entry["rows"],
                              None, cap, entry["sort_keys"], ANALYTICS_REL_TOL)
        rec["eager_warm_wall_s"] = eager_walls.get(name)
        out.append(rec)
        print("compiled", json.dumps({**rec, "card": card}), flush=True)
    session = Session(properties=props, device=device)
    rec, _ = run_compiled(session, device, "overflow", "Q13", expected["13"]["sql"],
                          expected["13"]["rows"], None, cap, replays=2, cut_join_hints=True)
    if rec["recompiles"] < 1:
        raise AssertionError(f"Q13 with its join hint cut to a quarter did not capture "
                             f"again: {rec}")
    out.append(rec)
    print("compiled", json.dumps({**rec, "card": card}), flush=True)
    return out


def phase_profile_compiled(device, expected, compiled, card):
    """``--profile``: one replay of each TPC-H query's graph under
    torch.profiler: the kernels it launched, its device busy share, and the
    merge kernel's symbol in the replays of the queries whose reference
    selects merge-pallas."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trino_tpu_torch import Session
    from trino_tpu_torch.exec.compiled import CompiledQuery
    from trino_tpu_torch.exec.query import plan_sql

    session = Session(properties={"catalog": "tpch", "schema": "sf1",
                                  "fused_join_pallas": True}, device=device)
    for q in range(1, 23):
        cq = CompiledQuery.build(session, plan_sql(session, expected[str(q)]["sql"]))
        cq.run()  # capture
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cq.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        cq.close()
        by_kernel = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.key.startswith("Activity Buffer"):
                continue
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            if dev_us > 0:
                by_kernel.append((dev_us, e.count, e.key))
        by_kernel.sort(reverse=True)
        device_s = sum(us for us, _, _ in by_kernel) / 1e6
        merge_seen = any("merge_unique" in k for _, _, k in by_kernel)
        if compiled["queries"][str(q)]["tiers"].get("merge-pallas", 0) >= 1 and not merge_seen:
            raise AssertionError(f"Q{q}: the profiled replay shows no merge kernel: "
                                 f"{[k for _, _, k in by_kernel[:20]]}")
        print("profile", json.dumps({
            "session": "compiled", "query": f"Q{q}", "wall_s": wall, "device_s": device_s,
            "device_busy_share": device_s / wall if wall else None,
            "device_launches": sum(c for _, c, _ in by_kernel), "merge_kernel_seen": merge_seen,
            "top": [{"kernel": k[:80], "calls": c, "device_ms": us / 1e3}
                    for us, c, k in by_kernel[:8]], "card": card}), flush=True)


DIST_PROPS = {"catalog": "tpch", "schema": "sf1", "fused_join_pallas": True}
DIST_REL_TOL = 1e-8  # doubles at SF1: partial and final sums add in another order
DIST_PROCESS_QUERIES = (1, 17, 18)
# run once more with adaptive_execution_enabled=false, beside the default,
# with every query whose default run changed its plan
DIST_ADAPTIVE_OFF = (9, 18, 21)
# Q6 and Q17 with ? for their constants, and the bindings
DIST_PARAMS = {
    6: (("date '1994-01-01'", "0.06 - 0.01", "0.06 + 0.01", "< 24"),
        ("?", "?", "?", "< ?"), None),
    17: (("'Brand#23'", "'MED BOX'"), ("?", "?"), ("Brand#23", "MED BOX")),
}


def dist_counters():
    """The counters of the distributed path, and the join tiers."""
    from trino_tpu_torch.obs import metrics as M

    return {"wire_bytes": M.SERDE_BYTES.value("encode", "zlib")
            + M.SERDE_BYTES.value("encode", "none"),
            "logical_bytes": M.SERDE_BYTES.value("encode", "logical"),
            "raw_bytes": M.SERDE_BYTES.value("encode", "none"),
            "exchange_bytes": M.EXCHANGE_BYTES.value(),
            **{f"{k}_s": M.SERDE_SECONDS.value(k)
               for k in ("encode", "compress", "decode", "decompress")},
            "partition_s": M.PARTITION_SECONDS.value(),
            "tasks": M.TASKS_TOTAL.value(),
            **{f"tier_{t}": M.FUSED_JOIN_SELECTIONS.value(t) for t in TIERS}}


def dist_execute(coord, client, sql, device, what):
    """(rows, wall, counter deltas, query info) of one statement through
    the coordinator, the merge kernel's launches counted from 0."""
    from trino_tpu_torch.ops import merge

    merge.launches = 0
    c0 = dist_counters()
    sync(device)
    t0 = time.perf_counter()
    _cols, rows = client.execute(sql, timeout=600.0)
    sync(device)
    wall = time.perf_counter() - t0
    c1 = dist_counters()
    delta = {k: c1[k] - c0[k] for k in c0}
    delta["merge_launches"] = merge.launches
    q = coord.get_query(client.query_id)
    adapt_failures(q, what)
    delta["status_polls"] = q.status_polls
    return rows, wall, delta, q.info()


def adapt_failures(q, what):
    """Raise when a rule of the adaptive re-planner failed in query ``q``:
    the coordinator swallows a rule's error by design and records it on an
    errored ``plan/adapt`` span."""
    errors = [sp.attributes["error"] for sp in q.tracer.spans()
              if sp.name == "plan/adapt" and "error" in sp.attributes]
    if errors:
        raise AssertionError(f"{what}: the adaptive re-planner failed: {errors}")


def start_workers(coord_url, n, device):
    """``n`` worker subprocesses (``python -m trino_tpu_torch.server.worker``),
    each with its own CUDA context, announcing to ``coord_url``."""
    import tempfile

    from trino_tpu_torch.server import wire

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["TRINO_TPU_INTERNAL_SECRET"] = wire.get_secret()
    procs = []
    for i in range(n):
        log = tempfile.TemporaryFile()
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "trino_tpu_torch.server.worker", "--coordinator", coord_url,
             "--node-id", f"proc{i}", "--device", str(device)],
            env=env, cwd=here, stdout=subprocess.DEVNULL, stderr=log), log))
    return procs


def stop_workers(procs):
    for p, _ in procs:
        p.terminate()
    for p, log in procs:
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=20)
        log.close()


def dist_timed(client, sql, device):
    """(rows, wall, tasks created) of one statement through ``client``."""
    from trino_tpu_torch.obs import metrics as M

    t0 = M.TASKS_TOTAL.value()
    sync(device)
    t = time.perf_counter()
    _cols, rows = client.execute(sql, timeout=600.0)
    sync(device)
    return rows, time.perf_counter() - t, M.TASKS_TOTAL.value() - t0


def dist_caches(coord, device, expected, mvexp, card):
    """The repeat-query path on the coordinator and its two workers: the
    result cache (Q1 and Q18 MISS then HIT, the hit creating no task; a
    memory table's SELECT missing after an INSERT; 32 concurrent Q6 with
    one execution), the plan cache on a repeat, a view whose refresh runs
    distributed and a SELECT reading it, Q6 and Q17 through a dbapi
    cursor with ? (a new binding a MISS that takes its plan from the plan
    cache, a repeated one a HIT that the serving index answers), and arrays
    and maps of decimals and dates through the protocol."""
    import threading

    from trino_tpu_torch.client import dbapi
    from trino_tpu_torch.client.remote import StatementClient
    from trino_tpu_torch.obs import metrics as M

    props = {k: str(v) for k, v in DIST_PROPS.items()}
    out = {"card": card}
    rc = StatementClient(coord.base_url, {**props, "result_cache_enabled": "true"})
    for q in (1, 18):
        runs = []
        for want in ("MISS", "HIT"):
            rows, wall, tasks = dist_timed(rc, expected[str(q)]["sql"], device)
            check_rows(f"Q{q} (result cache, {want})", rows, expected[str(q)]["rows"],
                       rel_tol=DIST_REL_TOL)
            if rc.cache_status != want or (tasks == 0) != (want == "HIT"):
                raise AssertionError(f"Q{q} (result cache): {rc.cache_status} creating {tasks} "
                                     f"tasks, want {want}")
            runs.append({"status": rc.cache_status, "wall_s": wall, "tasks": tasks})
        out[f"Q{q}"] = runs
    pc = StatementClient(coord.base_url, props)
    h0 = M.PLAN_CACHE_HITS.value()
    for _ in range(2):
        rows, wall, _t = dist_timed(pc, expected["6"]["sql"], device)
        check_rows("Q6 (plan cache)", rows, expected["6"]["rows"], rel_tol=DIST_REL_TOL)
    spans = {sp["name"] for sp in coord.get_query(pc.query_id).tracer.to_dicts()}
    if M.PLAN_CACHE_HITS.value() - h0 < 1 or "plan-cache/hit" not in spans or "optimize" in spans:
        raise AssertionError(f"Q6 repeated: no plan-cache hit ({sorted(spans)})")
    out["plan_cache_hits"] = M.PLAN_CACHE_HITS.value() - h0
    mc = StatementClient(coord.base_url, {"catalog": "memory", "schema": "default",
                                          "result_cache_enabled": "true"})
    mc.execute("create table dist_rc as select o_orderkey, o_totalprice from tpch.tiny.orders")
    sel = "select count(*), sum(o_totalprice) from dist_rc"
    seen = []
    for stmt in (sel, sel, "insert into dist_rc values (0, 1.00)", sel, sel):
        _c, rows = mc.execute(stmt, timeout=600.0)
        if stmt == sel:
            seen.append((mc.cache_status, rows[0][0]))
    mc.execute("drop table dist_rc")
    if seen != [("MISS", 15000), ("HIT", 15000), ("MISS", 15001), ("HIT", 15001)]:
        raise AssertionError(f"memory table under the result cache: {seen}")
    # a view whose refresh runs distributed, then a SELECT reading it
    vc = StatementClient(coord.base_url, props)
    created, refresh_s, tasks = dist_timed(vc, "create materialized view q3dist as " + mv_q3(),
                                           device)
    base = mv_q3() + MV_Q3_TAIL
    rows, wall, _t = dist_timed(vc, base, device)
    check_rows("Q3 from q3dist", rows, mvexp["q3"]["rows"])
    if tasks == 0 or vc.stats.get("mvNames") != [f"tpch.{DIST_PROPS['schema']}.q3dist"]:
        raise AssertionError(f"q3dist: refresh created {tasks} tasks, the SELECT read "
                             f"{vc.stats.get('mvNames')}")
    vc.execute("drop materialized view q3dist")
    out["q3dist"] = {"create_s": refresh_s, "refresh_tasks": tasks,
                     "substituted_wall_s": wall}
    # Q6 and Q17 with ? through a dbapi cursor, the result cache on
    conn = dbapi.connect(coord.base_url, catalog="tpch", schema=DIST_PROPS["schema"],
                         fused_join_pallas="True", result_cache_enabled="true")
    cur = conn.cursor()
    import datetime
    import decimal

    bindings = {6: [(datetime.date(1994, 1, 1), decimal.Decimal("0.05"),
                     decimal.Decimal("0.07"), 24),
                    (datetime.date(1995, 1, 1), decimal.Decimal("0.05"),
                     decimal.Decimal("0.07"), 24)],
                17: [("Brand#23", "MED BOX"), ("Brand#12", "MED BOX")]}
    for q, (literals, marks, _params) in DIST_PARAMS.items():
        sql = expected[str(q)]["sql"]
        for lit, mark in zip(literals, marks):
            sql = sql.replace(lit, mark, 1)
        runs = []
        for i, binding in enumerate((bindings[q][0], bindings[q][0], bindings[q][1],
                                     bindings[q][1])):
            h0, s0 = M.PLAN_CACHE_HITS.value(), M.DISPATCH_CACHE_SERVED.value()
            t0 = time.perf_counter()
            cur.execute(sql, binding)
            runs.append({"status": cur.cache_status, "wall_s": time.perf_counter() - t0,
                         "plan_cache_hits": M.PLAN_CACHE_HITS.value() - h0,
                         "served": M.DISPATCH_CACHE_SERVED.value() - s0})
            got = jsonable_rows(cur.fetchall())
            if i < 2:
                check_rows(f"Q{q} (dbapi, result cache)", got, expected[str(q)]["rows"],
                           rel_tol=DIST_REL_TOL)
            elif i == 2:
                new_rows = got
            elif got != new_rows:
                raise AssertionError(f"Q{q} (dbapi): a repeated binding gave other rows")
        # a new binding's EXECUTE binds into the cached parameterized plan (one
        # plan-cache hit); a repeated one is answered by the serving index,
        # which neither plans nor reads the plan cache
        if [r["status"] for r in runs] != ["MISS", "HIT", "MISS", "HIT"] or \
                [(r["plan_cache_hits"], r["served"]) for r in runs[1:]] != [(0, 1), (1, 0),
                                                                             (0, 1)]:
            raise AssertionError(f"Q{q} (dbapi): {runs}")
        out[f"dbapi_Q{q}"] = runs
    # arrays and maps of decimals and dates through the protocol
    _c, flat = pc.execute("select o_orderkey, o_totalprice, o_orderdate from orders "
                          "where o_custkey = 1", timeout=600.0)
    _c, nested = pc.execute("select array_agg(o_totalprice), array_agg(o_orderdate), "
                            "map_agg(o_orderkey, o_totalprice) from orders where o_custkey = 1",
                            timeout=600.0)
    (prices, dates, by_key), = nested
    if sorted(prices) != sorted(r[1] for r in flat) or \
            sorted(dates) != sorted(r[2] for r in flat) or \
            by_key != {str(r[0]): r[1] for r in flat}:
        raise AssertionError(f"nested values through the protocol: {nested[0]} vs {flat}")
    # 32 identical queries at once: one execution, 31 answered from it
    results = []
    m0 = (M.RESULT_CACHE_MISSES.value(), M.RESULT_CACHE_HITS.value(),
          M.RESULT_CACHE_SINGLE_FLIGHT_WAITS.value())
    sql6 = expected["6"]["sql"]

    def run_one():
        client = StatementClient(coord.base_url, {**props, "result_cache_enabled": "true"})
        _cols, rows = client.execute(sql6, timeout=600.0)
        results.append((client.cache_status, rows))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run_one) for _ in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600.0)
    flight = {"wall_s": time.perf_counter() - t0,
              "misses": M.RESULT_CACHE_MISSES.value() - m0[0],
              "hits": M.RESULT_CACHE_HITS.value() - m0[1],
              "waits": M.RESULT_CACHE_SINGLE_FLIGHT_WAITS.value() - m0[2]}
    if len(results) != 32 or sorted(s for s, _ in results) != ["HIT"] * 31 + ["MISS"] or \
            (flight["misses"], flight["hits"]) != (1, 31):
        raise AssertionError(f"32 concurrent Q6: {flight}, {[s for s, _ in results]}")
    for _s, rows in results:
        check_rows("Q6 (32 at once)", rows, expected["6"]["rows"], rel_tol=DIST_REL_TOL)
    out["single_flight"] = flight
    print("distributed_caches", json.dumps(out), flush=True)
    return out


def dist_stats_default(coord, client, device, expected):
    """Per-operator stats are on by default: a plain distributed Q1 leaves
    operators on every task of ``system.runtime.tasks``, and its scans'
    rows in ``trino_tpu_operator_rows_total{operator="TableScan"}`` equal
    ``select count(*) from lineitem``. Then the 22 warm twice more, first
    with ``Executor.collect_stats`` set off by this script (the workers run
    in this process), then on, to record what the stats cost: the off pass
    between two passes with them on."""
    from trino_tpu_torch.exec.executor import Executor
    from trino_tpu_torch.obs import metrics as M

    _c, count = client.execute("select count(*) from lineitem", timeout=600.0)
    scan0 = M.OPERATOR_ROWS.value("TableScan")
    _c, rows = client.execute(expected["1"]["sql"], timeout=600.0)
    check_rows("Q1 (distributed, stats)", rows, expected["1"]["rows"], rel_tol=DIST_REL_TOL)
    qid = client.query_id
    # a task adds its series as its thread ends, just after its last page
    deadline = time.monotonic() + 10.0
    while M.OPERATOR_ROWS.value("TableScan") - scan0 < count[0][0] and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    scanned = M.OPERATOR_ROWS.value("TableScan") - scan0
    _c, tasks = client.execute("select task_id, operators from system.runtime.tasks "
                               f"where query_id = '{qid}'", timeout=600.0)
    if not tasks or any(ops <= 0 for _t, ops in tasks) or scanned != count[0][0]:
        raise AssertionError(f"Q1 (distributed): operators a task {tasks}, TableScan rows "
                             f"{scanned} (lineitem {count[0][0]}): stats not kept by default")
    walls = {"off": {}, "on": {}}
    for label in ("off", "on"):
        Executor.collect_stats = label == "on"
        try:
            for q in range(1, 23):
                entry = expected[str(q)]
                rows, walls[label][f"Q{q}"], _t = dist_timed(client, entry["sql"], device)
                check_rows(f"Q{q} (distributed, stats {label})", rows, entry["rows"],
                           rel_tol=DIST_REL_TOL)
        finally:
            Executor.collect_stats = True
    return {"q1_tasks": len(tasks), "q1_operators": [ops for _t, ops in tasks],
            "q1_scan_rows": scanned,
            **{f"stats_{k}_warm_wall_s": sum(v.values()) for k, v in walls.items()},
            **{f"stats_{k}_walls_s": v for k, v in walls.items()}}


def phase_distributed(device, expected, dist, mvexp, cap, eager, card):
    """The coordinator and two in-process workers on the card: the 22
    TPC-H queries' distributed plans against the reference's, their rows
    cold and warm through the statement protocol, Q6 and Q17 through a
    dbapi cursor with ? parameters, the caches and views (``dist_caches``);
    then Q1, Q17 and Q18 through two worker subprocesses."""
    from trino_tpu_torch.client import dbapi
    from trino_tpu_torch.client.remote import StatementClient
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.worker import WorkerServer

    t_phase = time.perf_counter()
    coord = CoordinatorServer(device=device)
    coord.start()
    workers = [WorkerServer(coordinator_url=coord.base_url, node_id=f"w{i}", device=device)
               for i in range(2)]
    out = {}
    try:
        for w in workers:
            w.start()
        if not coord.registry.wait_for_workers(2, timeout=30.0):
            raise AssertionError("distributed: the in-process workers did not announce")
        client = StatementClient(coord.base_url, {k: str(v) for k, v in DIST_PROPS.items()})
        hashed = []
        for q in range(1, 23):
            sql = expected[str(q)]["sql"]
            _c, plan = client.execute(f"explain (type distributed) {sql}", timeout=600.0)
            lines = [r[0] for r in plan]
            if lines != dist["queries"][str(q)]["explain"]:
                raise AssertionError(f"Q{q} (distributed): EXPLAIN (TYPE DISTRIBUTED) differs "
                                     f"from the reference's: {lines[:6]}")
            if any(" [hash]" in line for line in lines):
                hashed.append(q)
        if not hashed:
            raise AssertionError("distributed: no query's plan has a [hash] fragment")
        for q in range(1, 23):
            entry = expected[str(q)]
            runs = []
            for label in ("cold", "warm"):
                cap.now = ("distributed", q, label)
                rows, wall, d, info = dist_execute(coord, client, entry["sql"], device,
                                                   f"Q{q}")
                cap.now = None
                check_rows(f"Q{q} (distributed, {label})", rows, entry["rows"],
                           rel_tol=DIST_REL_TOL)
                if info["fastPath"] != "distributed":
                    raise AssertionError(f"Q{q} ran {info['fastPath']}, not distributed")
                runs.append({"run": label, "wall_s": wall,
                             "fragments": len(info["fragments"]) + 1,
                             "tasks": sum(len(t) for t in info["fragments"].values()),
                             **{k: v for k, v in d.items() if not k.startswith("tier_")},
                             "tiers": {t: d[f"tier_{t}"] for t in TIERS if d[f"tier_{t}"]},
                             # adaptive execution is on by default
                             "plan_changes": [f"{c['rule']}: {c['description']}"
                                              for c in info["planVersions"]]})
            if q in DIST_ADAPTIVE_OFF or runs[0]["plan_changes"]:
                rows, wall, d, info = dist_execute(
                    coord, StatementClient(coord.base_url, {
                        **{k: str(v) for k, v in DIST_PROPS.items()},
                        "adaptive_execution_enabled": "false"}),
                    entry["sql"], device, f"Q{q} (adaptation off)")
                check_rows(f"Q{q} (distributed, adaptation off)", rows, entry["rows"],
                           rel_tol=DIST_REL_TOL)
                runs.append({"run": "adaptation_off", "wall_s": wall,
                             "status_polls": d["status_polls"],
                             "merge_launches": d["merge_launches"],
                             "plan_changes": info["planVersions"]})
            out[q] = runs
            print("distributed", json.dumps({
                "query": f"Q{q}", "rows": len(entry["rows"]),
                "eager_walls_s": eager.get(q), "runs": runs}), flush=True)
        stats = dist_stats_default(coord, client, device, expected)
        conn = dbapi.connect(coord.base_url, catalog="tpch", schema="sf1",
                             fused_join_pallas="True")
        cur = conn.cursor()
        import datetime
        import decimal

        bindings = {6: (datetime.date(1994, 1, 1), decimal.Decimal("0.05"),
                        decimal.Decimal("0.07"), 24)}
        for q, (literals, marks, params) in DIST_PARAMS.items():
            sql = expected[str(q)]["sql"]
            for lit, mark in zip(literals, marks):
                if lit not in sql:
                    raise AssertionError(f"Q{q}: {lit!r} not in its SQL")
                sql = sql.replace(lit, mark, 1)
            t0 = time.perf_counter()
            cur.execute(sql, params if params is not None else bindings[q])
            wall = time.perf_counter() - t0
            check_rows(f"Q{q} (dbapi, ? parameters)", jsonable_rows(cur.fetchall()),
                       expected[str(q)]["rows"], rel_tol=DIST_REL_TOL)
            print("distributed_dbapi", json.dumps({"query": f"Q{q}", "wall_s": wall}),
                  flush=True)
        t0 = time.perf_counter()
        caches = dist_caches(coord, device, expected, mvexp, card)
        caches_s = time.perf_counter() - t0
    finally:
        cap.now = None
        for w in workers:
            w.stop()
        coord.stop()
    in_process_s = time.perf_counter() - t_phase
    # two worker processes, each with its own CUDA context and tables
    t0 = time.perf_counter()
    coord = CoordinatorServer(device=device)
    coord.start()
    procs = start_workers(coord.base_url, 2, device)
    procs_out = {}
    try:
        if not coord.registry.wait_for_workers(2, timeout=180.0):
            logs = []
            for p, log in procs:
                log.seek(0)
                logs.append(log.read()[-2000:].decode(errors="replace"))
            raise AssertionError(f"distributed: worker subprocesses did not announce: {logs}")
        urls = {n["url"] for n in coord.registry.alive()}
        start_s = time.perf_counter() - t0
        client = StatementClient(coord.base_url, {k: str(v) for k, v in DIST_PROPS.items()})
        for q in DIST_PROCESS_QUERIES:
            entry = expected[str(q)]
            t1 = time.perf_counter()
            _c, rows = client.execute(entry["sql"], timeout=600.0)
            wall = time.perf_counter() - t1
            check_rows(f"Q{q} (worker processes)", rows, entry["rows"], rel_tol=DIST_REL_TOL)
            info = coord.get_query(client.query_id).info()
            ran = {loc.base_url for locs in coord.get_query(client.query_id)
                   .fragment_tasks.values() for loc in locs}
            if ran != urls:
                raise AssertionError(f"Q{q}: tasks ran on {sorted(ran)}, not on both "
                                     f"worker processes {sorted(urls)}")
            procs_out[q] = {"wall_s": wall, "tasks": sum(len(t) for t in
                                                         info["fragments"].values())}
            print("distributed_processes", json.dumps({"query": f"Q{q}", **procs_out[q]}),
                  flush=True)
    finally:
        stop_workers(procs)
        coord.stop()
    summary = {
        "cold_wall_s": sum(r[0]["wall_s"] for r in out.values()),
        "warm_wall_s": sum(r[1]["wall_s"] for r in out.values()),
        "eager_cold_wall_s": sum(w[0] for w in eager.values()),
        "eager_warm_wall_s": sum(w[1] for w in eager.values()),
        "hash_queries": [f"Q{q}" for q in hashed],
        "merge_queries": sorted(f"Q{q}" for q, r in out.items()
                                if any(x.get("merge_launches") for x in r)),
        "plan_changes": {f"Q{q}": r[0]["plan_changes"] + r[1]["plan_changes"]
                         for q, r in out.items() if r[0]["plan_changes"] + r[1]["plan_changes"]},
        "status_polls": {label: sum(r[i]["status_polls"] for r in out.values())
                         for i, label in ((0, "cold"), (1, "warm"))},
        "adaptation_off_wall_s": {f"Q{q}": r[2]["wall_s"] for q, r in out.items() if len(r) > 2},
        "adaptation_on_warm_wall_s": {f"Q{q}": r[1]["wall_s"] for q, r in out.items()
                                      if len(r) > 2},
        **{f"{label}_{k}": sum(r[i][k] for r in out.values())
           for i, label in ((0, "cold"), (1, "warm"))
           for k in ("wire_bytes", "logical_bytes", "raw_bytes", "encode_s", "compress_s",
                     "decode_s", "decompress_s", "partition_s", "tasks")},
        "stats_default": {**stats, "stats_on_first_warm_wall_s": sum(r[1]["wall_s"]
                                                                     for r in out.values())},
        "in_process_phase_s": in_process_s,
        "caches_s": caches_s,
        "result_cache_hit_wall_s": {q: caches[q][1]["wall_s"] for q in ("Q1", "Q18")},
        "processes_start_s": start_s,
        "processes_phase_s": time.perf_counter() - t0,
        "card": card}
    print("distributed_total", json.dumps(summary), flush=True)
    return out


# phase matview: the Q3 join and aggregate of microbench/matview.py (about
# 11.6K groups at SF1), its base query's ORDER BY and LIMIT, and Q18's join
# and aggregate without its ORDER BY and LIMIT (its sum aliased: a view's
# columns are named)
MV_PROPS = {"catalog": "tpch", "schema": "sf1", "fused_join_pallas": True}
MV_Q3_AGG = """
select l_orderkey, o_orderdate, o_shippriority,
       sum(l_extendedprice * (1 - l_discount)) as revenue
from {customer}, {orders}, {lineitem}
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
"""
MV_Q3_TAIL = " order by revenue desc, o_orderdate, l_orderkey limit 10"
MV_Q18_AGG = """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity) as sum_qty
from customer, orders, lineitem
where o_orderkey in (
        select l_orderkey from lineitem
        group by l_orderkey
        having sum(l_quantity) > 300)
    and c_custkey = o_custkey
    and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
"""


def mv_q3(**tables):
    names = {t: tables.get(t, t) for t in ("customer", "orders", "lineitem")}
    return MV_Q3_AGG.format(**names)


def mv_hits(session):
    return sum(mv.hits for mv in session.matviews.snapshot())


def staleness_matrix(device, source_schema="tiny"):
    """The staleness matrix of microbench/matview.py over memory copies of
    customer, orders and lineitem in a cached session on ``device``: after
    each of INSERT, UPDATE, DELETE and DROP + recreate on a base table the
    view must not substitute and the rows must equal, bit for bit, the base
    query's with substitution off; a REFRESH must make it substitute again.
    A substitution while stale counts in
    ``incorrect_freshness_substitutions``; any step that fails raises."""
    from trino_tpu_torch import Session

    s = Session({"catalog": "memory", "schema": "default", "device_cache_enabled": True},
                device=device)
    for t in ("customer", "orders", "lineitem"):
        s.execute(f"create table {t} as select * from tpch.{source_schema}.{t}")
    sql = mv_q3() + MV_Q3_TAIL
    s.execute("create materialized view q3m as " + mv_q3())

    def base_truth():
        s.properties["materialized_view_substitution"] = False
        try:
            return s.execute(sql).rows
        finally:
            s.properties["materialized_view_substitution"] = True

    incorrect = 0
    steps = []

    def check_substituted(expect, step):
        nonlocal incorrect
        before = mv_hits(s)
        rows = s.execute(sql).rows
        substituted = mv_hits(s) > before
        identical = rows == base_truth()
        if substituted and not expect:
            incorrect += 1
        if not identical:
            raise AssertionError(f"staleness matrix {step}: rows differ from the base query's")
        if substituted != expect:
            raise AssertionError(f"staleness matrix {step}: substituted={substituted}, "
                                 f"want {expect}")
        steps.append({"step": step, "substituted": substituted, "bit_identical": identical})

    check_substituted(True, "fresh")
    mutations = [
        ("insert", "insert into orders select * from orders limit 1"),
        ("update", "update lineitem set l_quantity = l_quantity + 1 where l_orderkey = 1"),
        ("delete", "delete from customer where c_custkey = 1"),
        ("drop", None),
    ]
    for name, stmt in mutations:
        if name == "drop":
            s.execute("drop table customer")
            s.execute(f"create table customer as select * from tpch.{source_schema}.customer")
        else:
            s.execute(stmt)
        check_substituted(False, f"{name}-stale")
        s.execute("refresh materialized view q3m")
        check_substituted(True, f"{name}-refreshed")
    s.execute("drop materialized view q3m")
    return {"steps": steps, "incorrect_freshness_substitutions": incorrect,
            "stale_fallback_ok": all(st["bit_identical"] for st in steps)}


def refresh_counters():
    """(MV_REFRESH_SECONDS' sum, its count, warmed rows, warm failures)."""
    from trino_tpu_torch.obs import metrics as M

    _, total, n = M.MV_REFRESH_SECONDS.snapshot()
    return total, n, M.MV_WARM_ROWS.value(), M.MV_WARM_FAILURES.value()


def phase_matview(device, mvexp, expected, cap, card, schema="sf1"):
    """Materialized views on the card. In a cached session at SF1 (storage
    in the memory catalog): Q3's base query without and with its view,
    the view's refresh warming its storage onto the card, EXPLAIN, the
    substitution switched off; in an uncached one, a view of Q18's join and
    aggregate whose refresh runs eager Q18's plan, then Q18 read from it;
    then the staleness matrix at tiny. ``schema``: the tpch scale (the
    tests run the phase at tiny on the CPU)."""
    from trino_tpu_torch import Session
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.ops import merge

    out = {"card": card}
    props = {**MV_PROPS, "schema": schema}
    session = Session(properties={**props, "device_cache_enabled": True}, device=device)
    base_sql = mv_q3() + MV_Q3_TAIL
    want = mvexp["q3"]["rows"]
    walls = {}
    for label in ("cold", "warm"):
        res, walls[f"base_{label}_s"], _c = timed_execute(session, base_sql, device)
        check_rows(f"matview Q3 base ({label})", jsonable_rows(res.rows), want)
    base_rows = res.rows
    r0 = refresh_counters()
    res, walls["create_s"], _c = timed_execute(
        session, "create materialized view q3rev as " + mv_q3(), device)
    r1 = refresh_counters()
    mv = session.matviews.get("tpch", schema, "q3rev")
    view_rows = session.catalogs[mv.storage_catalog].table_row_count(
        mv.storage_schema, mv.storage_table)
    refresh = {"refresh_s": r1[0] - r0[0], "refreshes": r1[1] - r0[1],
               "warmed_rows": r1[2] - r0[2], "warm_failures": r1[3] - r0[3],
               "view_rows": view_rows}
    if refresh["refreshes"] != 1 or refresh["warm_failures"] != 0:
        raise AssertionError(f"matview: the refresh of q3rev {refresh}")
    if view_rows != mvexp["q3"]["view_rows"] or refresh["warmed_rows"] != view_rows:
        raise AssertionError(f"matview: q3rev holds {view_rows} rows and its refresh warmed "
                             f"{refresh['warmed_rows']}, the reference's view "
                             f"{mvexp['q3']['view_rows']}")
    for label in ("cold", "warm"):
        h0 = mv_hits(session)
        res, walls[f"substituted_{label}_s"], c = timed_execute(session, base_sql, device)
        if mv_hits(session) != h0 + 1:
            raise AssertionError(f"matview: Q3 ({label}) did not substitute q3rev")
        if res.rows != base_rows:
            raise AssertionError(f"matview: substituted Q3 ({label}) rows differ from the "
                                 f"base rows")
        if label == "cold" and ((c["staged_rows"], c["h2d_bytes"], c["misses"]) != (0, 0, 0)
                                or c["hits"] < 1):
            raise AssertionError(f"matview: the first substituted run staged {c}: the refresh "
                                 f"did not warm its storage")
        refresh[f"substituted_{label}_cache"] = {k: c[k] for k in ("hits", "misses",
                                                                  "staged_rows", "h2d_bytes")}
    text = session.explain(base_sql)
    lines = text.split("\n")
    if lines != mvexp["q3"]["explain"] or f"[mv: tpch.{schema}.q3rev]" not in text:
        raise AssertionError(f"matview: EXPLAIN differs from the reference's: {lines[:4]}")
    session.properties["materialized_view_substitution"] = False
    h0 = mv_hits(session)
    res, walls["substitution_off_s"], _c = timed_execute(session, base_sql, device)
    session.properties["materialized_view_substitution"] = True
    if res.rows != base_rows or mv_hits(session) != h0:
        raise AssertionError("matview: with substitution off Q3 read the view or other rows")
    session.execute("drop materialized view q3rev")
    out["q3"] = {**walls, **refresh, "hits": mv.hits}
    print("matview", json.dumps({"view": "q3rev", **out["q3"], "card": card}), flush=True)

    # Q18's join and aggregate: its refresh runs eager Q18's plan
    eager = Session(properties=dict(props), device=device)
    want18 = mvexp["q18"]
    t0_tiers = tier_counts(M.FUSED_JOIN_SELECTIONS, TIERS)
    merge.launches = 0
    cap.now = ("matview", "Q18view", "cold")
    r0 = refresh_counters()
    _res, create18_s, _c = timed_execute(eager, "create materialized view q18agg as "
                                         + MV_Q18_AGG, device)
    r1 = refresh_counters()
    cap.now = None
    launches = merge.launches
    tiers = {t: v - t0_tiers[t] for t, v in tier_counts(M.FUSED_JOIN_SELECTIONS, TIERS).items()}
    mv18 = eager.matviews.get("tpch", schema, "q18agg")
    rows18 = eager.catalogs[mv18.storage_catalog].table_row_count(
        mv18.storage_schema, mv18.storage_table)
    if tiers != want18["tiers"] or rows18 != want18["view_rows"]:
        raise AssertionError(f"matview: q18agg's refresh took tiers {tiers} into {rows18} rows, "
                             f"the reference's {want18['tiers']} into {want18['view_rows']}")
    if want18["tiers"].get("merge-pallas", 0) >= 1 and launches < 1:
        raise AssertionError("matview: q18agg's refresh selected merge-pallas but did not "
                             "launch the merge kernel")
    h0 = mv_hits(eager)
    res, q18_s, _c = timed_execute(eager, expected["18"]["sql"], device)
    check_rows("matview Q18 from q18agg", jsonable_rows(res.rows), expected["18"]["rows"])
    if mv_hits(eager) != h0 + 1:
        raise AssertionError("matview: Q18 did not substitute q18agg")
    eager.execute("drop materialized view q18agg")
    out["q18"] = {"create_s": create18_s, "refresh_s": r1[0] - r0[0], "view_rows": rows18,
                  "tiers": tiers, "merge_launches": launches, "substituted_q18_s": q18_s}
    print("matview", json.dumps({"view": "q18agg", **out["q18"], "card": card}), flush=True)

    t0 = time.perf_counter()
    matrix = staleness_matrix(device)
    if matrix["incorrect_freshness_substitutions"] != 0 or not matrix["stale_fallback_ok"]:
        raise AssertionError(f"matview: staleness matrix {matrix}")
    out["staleness"] = {"steps": len(matrix["steps"]), "incorrect_freshness_substitutions":
                        matrix["incorrect_freshness_substitutions"],
                        "wall_s": time.perf_counter() - t0}
    print("matview_staleness", json.dumps(out["staleness"]), flush=True)
    return out


# phase adaptive: the adaptive distributed path on a coordinator and two
# in-process workers. The join flips under a lie about customer's row count
# (the lie, join_max_broadcast_rows and the direction, by schema), the hot-key
# join (90% of lineitem's rows on key 1, projected in a subquery so the join
# is an equi-join on a column), and the plan of every statement
ADAPTIVE_FLIP_SQL = ("select c_mktsegment, count(*) c from customer, orders "
                     "where c_custkey = o_custkey group by c_mktsegment order by 1")
ADAPTIVE_FLIPS = {
    "sf1": ((10, 20_000, "broadcast->partitioned"), (10**9, 200_000, "partitioned->broadcast")),
    "tiny": ((10, 200, "broadcast->partitioned"), (10**6, 2_000, "partitioned->broadcast")),
}
ADAPTIVE_SKEW_SQL = ("select count(*) c, sum(p.v) s from (select case when l_orderkey % 10 < 9 "
                     "then cast(1 as bigint) else l_orderkey end as k, l_orderkey as v "
                     "from lineitem) p, orders o where p.k = o.o_orderkey")
ADAPTIVE_SKEW_PROPS = {"join_max_broadcast_rows": "100", "adaptive_skew_threshold": "4"}
ADAPTIVE_RESEED_QUERIES = (3, 18)
ADAPTIVE_EXPLAIN_QUERIES = (1, 18)


class lying_row_count:
    """Within the block, the port's TPC-H connector claims ``rows`` for
    ``table`` (the planner's estimate; the data stays as it is)."""

    def __init__(self, table, rows):
        self.table, self.rows = table, rows

    def __enter__(self):
        from trino_tpu_torch.connector.tpch.connector import TpchConnector

        self.orig = orig = TpchConnector.table_row_count
        table, rows = self.table, self.rows

        def lying(conn, schema, t):
            return rows if t == table else orig(conn, schema, t)

        TpchConnector.table_row_count = lying
        return self

    def __exit__(self, *exc):
        from trino_tpu_torch.connector.tpch.connector import TpchConnector

        TpchConnector.table_row_count = self.orig


def adaptive_execute(coord, props, sql, device, what):
    """(rows, wall, query) of one statement through the coordinator; fails
    when a rule of the re-planner failed."""
    from trino_tpu_torch.client.remote import StatementClient

    client = StatementClient(coord.base_url, {k: str(v) for k, v in props.items()})
    sync(device)
    t0 = time.perf_counter()
    _cols, rows = client.execute(sql, timeout=600.0)
    sync(device)
    wall = time.perf_counter() - t0
    q = coord.get_query(client.query_id)
    adapt_failures(q, what)
    return rows, wall, q


def run_fragments(coord, props, fragments):
    """Schedule ``fragments`` as given, one task a worker each through the
    coordinator's ``_create_task`` (the task seam the cluster tests use),
    and run the root fragment on the coordinator: (rows, the query whose
    slot records hold the tasks' stats)."""
    from trino_tpu_torch.server.coordinator import QueryExecution
    from trino_tpu_torch.sql.planner import plan as P
    from trino_tpu_torch.sql.planner.fragmenter import RemoteSourceNode

    q = QueryExecution(f"salted{time.time_ns() & 0xFFFFFF:x}", "", dict(props), coord.registry,
                       coord.session_factory)
    session = coord.session_factory(dict(props))
    workers = coord.registry.alive()
    counts = {}
    for frag in fragments:
        for node in P.walk_plan(frag.root):
            if isinstance(node, RemoteSourceNode):
                counts[node.fragment_id] = (len(workers) if frag.partitioning in ("source", "hash")
                                            else 1)
    q.fragments = fragments
    try:
        for frag in fragments:
            q._schedule_fragment(session, frag, workers, counts)
        rows = q._run_root_fragment(session, fragments).to_pylist()
        q._sweep_task_stats()
    finally:
        q._cancel_tasks()
    return jsonable_rows(rows), q


def adaptive_flips(coord, device, schema, eager):
    """Both join flips under the lie: the change recorded with the actual
    build rows, rows equal the adaptation-off run's and the eager session's,
    the superseded tasks canceled (their workers answer 404)."""
    from trino_tpu_torch.server import wire

    props = {"catalog": "tpch", "schema": schema}
    want = jsonable_rows(eager.execute(ADAPTIVE_FLIP_SQL).rows)
    customers = eager.execute("select count(*) from customer").rows[0][0]
    out = []
    for lie, limit, direction in ADAPTIVE_FLIPS[schema]:
        p = {**props, "join_max_broadcast_rows": limit}
        with lying_row_count("customer", lie):
            off, off_s, _q = adaptive_execute(coord, {**p, "adaptive_execution_enabled": "false"},
                                              ADAPTIVE_FLIP_SQL, device, direction)
            rows, wall, q = adaptive_execute(coord, p, ADAPTIVE_FLIP_SQL, device, direction)
        check_rows(f"{direction} (adaptation off)", off, want)
        check_rows(direction, rows, want)
        changes = [c for c in q.plan_versions if c["rule"] == "join-distribution"]
        if [c["description"] for c in changes] != [direction] or \
                changes[0]["detail"]["buildRows"] != customers:
            raise AssertionError(f"{direction}: plan changes {q.plan_versions}, want one flip "
                                 f"with buildRows {customers}")
        for fid in changes[0]["supersedes"]:
            for loc in q.fragment_tasks[fid]:
                status, _b, _h = wire.http_request(
                    "GET", f"{loc.base_url}/v1/task/{loc.task_id}/status", timeout=10.0)
                if status != 404:
                    raise AssertionError(f"{direction}: superseded task {loc.task_id} still "
                                         f"answers {status}")
        out.append({"direction": direction, "lie": lie, "limit": limit, "wall_s": wall,
                    "off_wall_s": off_s, "change": changes[0],
                    "tasks": sum(len(t) for t in q.fragment_tasks.values())})
    return out


def adaptive_reseed(coord, device, schema, expected):
    """adaptive_capacity_reseed on Q3 and Q18: a capacity-reseed change, and
    the expected rows."""
    out = []
    for qn in ADAPTIVE_RESEED_QUERIES:
        entry = expected[str(qn)]
        rows, wall, q = adaptive_execute(
            coord, {"catalog": "tpch", "schema": schema, "fused_join_pallas": "true",
                    "adaptive_capacity_reseed": "true"}, entry["sql"], device, f"Q{qn} reseed")
        check_rows(f"Q{qn} (capacity reseed)", rows, entry["rows"], rel_tol=DIST_REL_TOL)
        reseeds = [c for c in q.plan_versions if c["rule"] == "capacity-reseed"]
        if not reseeds:
            raise AssertionError(f"Q{qn}: no capacity-reseed change: {q.plan_versions}")
        out.append({"query": f"Q{qn}", "wall_s": wall, "changes": [
            {"fragment": c["fragment"], "runtimeRows": c["detail"]["runtimeRows"]}
            for c in reseeds]})
    return out


def adaptive_salted(coord, device, schema, eager):
    """The hot-key join: its stage stats from a finished run with adaptation
    off (on the pipelined path the rule never sees a flushed probe), a real
    AdaptivePlanner over them, and its salted producers run through the
    task seam: the unsalted rows, the hot partition more than 4x the other
    probe rows before, and spread after."""
    import copy

    from trino_tpu_torch.adaptive import AdaptivePlanner, RuntimeStatsProvider
    from trino_tpu_torch.sql.planner.fragmenter import fresh_fragment_ids

    props = {"catalog": "tpch", "schema": schema, **ADAPTIVE_SKEW_PROPS}
    want = jsonable_rows(eager.execute(ADAPTIVE_SKEW_SQL).rows)
    rows, wall, q = adaptive_execute(coord, {**props, "adaptive_execution_enabled": "false"},
                                     ADAPTIVE_SKEW_SQL, device, "hot-key join")
    check_rows("hot-key join (unsalted)", rows, want)
    frags = copy.deepcopy(q.fragments)
    by_id = {f.id: f for f in frags}
    entries = [dict(e) for e in q.task_stats.values()]
    planner = AdaptivePlanner(coord.session_factory(props), RuntimeStatsProvider(lambda: entries),
                              len(coord.registry.alive()), fresh_fragment_ids(frags))
    join_frag = next(f for f in frags if f.partitioning == "hash")
    new, changes, errors = planner.adapt_fragment(join_frag, by_id)
    if errors or [c.rule for c in changes] != ["skew-mitigation"]:
        raise AssertionError(f"hot-key join: the re-planner gave {changes}, errors {errors}")
    detail = changes[0].detail
    probe, hot = detail["probePartitionRows"], detail["hotPartitions"]
    others = sum(probe) - sum(probe[h] for h in hot)
    if len(hot) != 1 or probe[hot[0]] <= 4 * others:
        raise AssertionError(f"hot-key join: hot partitions {hot} of probe rows {probe}")
    salted = [f for f in frags if f.id not in changes[0].supersedes]
    for nf in new:
        salted.insert(salted.index(join_frag), nf)
    t0 = time.perf_counter()
    salted_rows, sq = run_fragments(coord, props, salted)
    salted_s = time.perf_counter() - t0
    check_rows("hot-key join (salted)", salted_rows, want)
    spread = [sum(col) for col in zip(*(e["stats"]["partitionRows"]
                                        for e in sq.task_stats.values()
                                        if e["fragment"] == new[0].id))]
    if sum(spread) != sum(probe) or max(spread) > 2 * min(spread):
        raise AssertionError(f"hot-key join: salted probe partition rows {spread}")
    return {"unsalted_wall_s": wall, "salted_wall_s": salted_s, "hot": hot,
            "probe_partition_rows": probe, "build_partition_rows": detail["buildPartitionRows"],
            "salted_probe_partition_rows": spread}


def adaptive_explain(coord, device, schema, expected, eager):
    """Distributed EXPLAIN ANALYZE of Q1 and Q18, plain and VERBOSE with
    device_profiling: two tasks a scheduled fragment, each scan's rows= its
    table's rows (a scan with dynamic filters: the rows they keep, at most
    the table's, equal in both runs), the outermost aggregation's rows= the
    result's row count;
    VERBOSE puts launches= and dispatch_overhead= on the scan lines, from
    measured kernel rows (device seconds within the wall)."""
    import re

    counts, scan_rows = {}, {}
    out = []
    for qn in ADAPTIVE_EXPLAIN_QUERIES:
        entry = expected[str(qn)]
        for verbose in (False, True):
            props = {"catalog": "tpch", "schema": schema, "fused_join_pallas": "true",
                     **({"device_profiling": "true"} if verbose else {})}
            what = f"EXPLAIN ANALYZE {'VERBOSE ' if verbose else ''}Q{qn}"
            plan, wall, q = adaptive_execute(
                coord, props, f"explain analyze {'verbose ' if verbose else ''}{entry['sql']}",
                device, what)
            lines = [r[0] for r in plan]
            heads = [ln for ln in lines if ln.startswith("Fragment ") and "[single]" not in ln]
            if not heads or not all("[tasks=2," in ln for ln in heads):
                raise AssertionError(f"{what}: fragment headers {heads}")
            scans = [ln for ln in lines if "- TableScan tpch." in ln]
            for i, ln in enumerate(scans):
                table = re.search(r"TableScan tpch\.\w+\.(\w+)", ln).group(1)
                rows = int(re.search(r" rows=(\d+)\]", ln).group(1))
                if table not in counts:
                    counts[table] = eager.execute(f"select count(*) from {table}").rows[0][0]
                # a scan with dynamic filters reads the rows their domains
                # keep: fewer, and the same in both runs of the query
                pruned = "dynamic_filters=" in ln
                if (rows != counts[table] and not pruned) or not 0 < rows <= counts[table] or \
                        scan_rows.setdefault((qn, i), rows) != rows:
                    raise AssertionError(f"{what}: {table} has {counts[table]} rows: {ln}")
                if verbose and not ("launches=" in ln and "dispatch_overhead=" in ln):
                    raise AssertionError(f"{what}: no kernel annotation on {ln}")
            agg = next(ln for ln in lines if "- Aggregation [final]" in ln
                       or "- Aggregation [single]" in ln)
            if f" rows={len(entry['rows'])}]" not in agg:
                raise AssertionError(f"{what}: {len(entry['rows'])} result rows, {agg}")
            kernels = q.kernel_rows_live()
            if verbose and (not kernels or any(
                    r["estimated"] or r["deviceS"] > r["wallS"] for r in kernels)):
                raise AssertionError(f"{what}: kernel rows {kernels[:3]}")
            out.append({"query": f"Q{qn}", "verbose": verbose, "wall_s": wall,
                        "header": lines[0], "scans": len(scans),
                        "kernel_rows": len(kernels),
                        "device_s": sum(r["deviceS"] for r in kernels),
                        "kernel_wall_s": sum(r["wallS"] for r in kernels)})
    return out


def adaptive_compile_ledger(device, expected, compiled, cap, schema, path="adaptive"):
    """One CompiledQuery of Q17 run twice: the compile ledger records a miss
    then a hit under one fingerprint, the CompiledBody row counts both runs,
    and on the card the graph holds the merge kernel (the warm-up's inputs
    go to phase mainpath under ``path``)."""
    from trino_tpu_torch import Session
    from trino_tpu_torch.exec.compiled import CompiledQuery
    from trino_tpu_torch.exec.query import plan_sql
    from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER
    from trino_tpu_torch.ops import merge

    session = Session({"catalog": "tpch", "schema": schema, "fused_join_pallas": True},
                      device=device)
    entry = expected["17"]
    cq = CompiledQuery.build(session, plan_sql(session, entry["sql"]))
    merge.launches = 0
    events, walls = [], []
    for run in ("cold", "warm"):
        # the compile ring is bounded (earlier phases may have filled it):
        # this run's events are the ones stamped after it began
        ts0 = time.time()
        cap.now = (path, "Q17", run)
        sync(device)
        t0 = time.perf_counter()
        page = cq.run()
        sync(device)
        walls.append(time.perf_counter() - t0)
        cap.now = None
        check_rows(f"Q17 (compile ledger, {run})", jsonable_rows(page.to_pylist()),
                   entry["rows"], rel_tol=DIST_REL_TOL)
        events += [e for e in DEVICE_PROFILER.compile_rows() if e["ts"] >= ts0]
    launches = merge.launches
    if [e["cache"] for e in events] != ["miss", "hit"] or \
            events[0]["fingerprint"] != events[1]["fingerprint"] or events[1]["compileS"] != 0:
        raise AssertionError(f"Q17 compile ledger: {events}")
    (row,) = cq.kernel_stats.values()
    if row["operator"] != "CompiledBody" or row["launches"] != 2:
        raise AssertionError(f"Q17 CompiledBody row: {row}")
    in_graph = cq.captures[-1]["merge_launches"] if cq.captures else 0
    want_merge = compiled["queries"]["17"]["tiers"].get("merge-pallas", 0) >= 1 \
        if compiled is not None else False
    if device.type == "cuda" and want_merge and in_graph < 1:
        raise AssertionError(f"Q17: its graph holds no merge launch: {cq.captures}")
    replayed = sum(c["merge_launches"] * c["replays"] for c in cq.captures)
    cq.close()
    return {"events": [{k: e[k] for k in ("cache", "compileS", "shapeSig", "ts")}
                       for e in events],
            "fingerprint": events[0]["fingerprint"], "body_row": row, "walls_s": walls,
            "merge_in_graph": in_graph, "merge_launches": launches + replayed}


def phase_adaptive(device, expected, compiled, cap, card, schema="sf1"):
    """The adaptive distributed path on a port coordinator and two
    in-process workers: both join flips, capacity reseeding of Q3 and Q18,
    the salted hot-key join, distributed EXPLAIN ANALYZE [VERBOSE] of Q1 and
    Q18; then the compile ledger over Q17's CompiledQuery. Every query of
    the phase fails it when a plan/adapt span carries an error."""
    from trino_tpu_torch import Session
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.worker import WorkerServer

    t_phase = time.perf_counter()
    eager = Session({"catalog": "tpch", "schema": schema}, device=device)
    coord = CoordinatorServer(device=device)
    coord.start()
    workers = [WorkerServer(coordinator_url=coord.base_url, node_id=f"aw{i}", device=device)
               for i in range(2)]
    out = {"card": card}
    try:
        for w in workers:
            w.start()
        if not coord.registry.wait_for_workers(2, timeout=30.0):
            raise AssertionError("adaptive: the in-process workers did not announce")
        for name, step in (("flips", lambda: adaptive_flips(coord, device, schema, eager)),
                           ("reseed", lambda: adaptive_reseed(coord, device, schema, expected)),
                           ("salted", lambda: adaptive_salted(coord, device, schema, eager)),
                           ("explain", lambda: adaptive_explain(coord, device, schema, expected,
                                                                eager))):
            t0 = time.perf_counter()
            out[name] = step()
            out[f"{name}_s"] = time.perf_counter() - t0
            print("adaptive", json.dumps({"step": name, "seconds": out[f"{name}_s"],
                                          "result": out[name]}), flush=True)
    finally:
        for w in workers:
            w.stop()
        coord.stop()
    t0 = time.perf_counter()
    out["compile_ledger"] = adaptive_compile_ledger(device, expected, compiled, cap, schema)
    out["compile_ledger_s"] = time.perf_counter() - t0
    print("adaptive", json.dumps({"step": "compile_ledger", "seconds": out["compile_ledger_s"],
                                  "result": out["compile_ledger"]}), flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print("adaptive_total", json.dumps({k: v for k, v in out.items()
                                        if k.endswith("_s") or k in ("card",)}), flush=True)
    return out


# ------------------------------------------------------------ phase serving
# the reference's E2E_CFG (tests/test_resource_groups.py) with the per-user
# template's limit at 1, so a user's second query must queue
SERVING_E2E_CFG = {
    "root_groups": [{
        "name": "global", "hard_concurrency_limit": 16, "max_queued": 100,
        "sub_groups": [
            {"name": "adhoc",
             "sub_groups": [{"name": "${USER}", "hard_concurrency_limit": 1,
                             "max_queued": 2}]},
            {"name": "etl", "hard_concurrency_limit": 4, "weight": 3}]}],
    "selectors": [
        {"source": "etl-.*", "group": "global.etl"},
        {"group": "global.adhoc.${USER}"}]}
SERVING_AGING_CFG = {
    "root_groups": [{"name": "global", "sub_groups": [
        {"name": "aging", "hard_concurrency_limit": 1, "queue_timeout_ms": 1}]}],
    "selectors": [{"user": "ager", "group": "global.aging"}, {"group": "global"}]}
SERVING_CLIENTS = 32
SERVING_KILL_POOL = 64 << 20
# group b's scans in the cache-share storm, at most three columns each (so
# no entry outgrows the headroom the budget leaves): (table, columns), then
# pairs of lineitem's columns until the storm is past the budget
SERVING_STORM_COLUMNS = 3
SERVING_STORM = (
    ("tpch.{s}.partsupp", ("ps_partkey", "ps_suppkey", "ps_availqty")),
    ("tpch.{s}.partsupp", ("ps_supplycost",)),
    ("tpch.{s}.supplier", ("s_suppkey", "s_nationkey", "s_acctbal")),
    ("tpch.{s}.customer", ("c_custkey", "c_nationkey", "c_acctbal")),
    ("tpcds.{s}.store_sales", ("ss_sold_date_sk", "ss_item_sk", "ss_customer_sk")),
    ("tpcds.{s}.store_sales", ("ss_cdemo_sk", "ss_hdemo_sk", "ss_addr_sk")),
    ("tpcds.{s}.store_sales", ("ss_store_sk", "ss_promo_sk", "ss_ticket_number")),
    ("tpcds.{s}.store_sales", ("ss_quantity", "ss_wholesale_cost", "ss_list_price")),
    ("tpcds.{s}.store_sales", ("ss_coupon_amt", "ss_net_profit")),
    ("tpcds.{s}.catalog_sales", ("cs_sold_date_sk", "cs_item_sk", "cs_order_number")),
    ("tpcds.{s}.catalog_sales", ("cs_quantity", "cs_ext_list_price")),
    ("tpcds.{s}.web_sales", ("ws_sold_date_sk", "ws_ship_date_sk", "ws_item_sk")),
    ("tpcds.{s}.web_sales", ("ws_order_number", "ws_warehouse_sk", "ws_ship_addr_sk")),
    ("tpcds.{s}.web_sales", ("ws_web_site_sk", "ws_ext_ship_cost", "ws_net_profit")),
) + tuple(("tpch.{s}.lineitem", pair) for pair in itertools.combinations(
    ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity", "l_extendedprice",
     "l_discount", "l_tax", "l_shipdate", "l_commitdate", "l_receiptdate"), 2))


def serving_props(schema, **extra):
    """The statement protocol's session properties of the phase."""
    return {**{k: str(v) for k, v in DIST_PROPS.items()}, "schema": schema, **extra}


def serving_cluster(device, n_workers, prefix, worker_kw=None, **coord_kw):
    """A port coordinator and ``n_workers`` in-process workers on the card."""
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.worker import WorkerServer

    coord = CoordinatorServer(device=device, **coord_kw)
    coord.start()
    workers = [WorkerServer(coordinator_url=coord.base_url, node_id=f"{prefix}{i}",
                            device=device, **(worker_kw or {})) for i in range(n_workers)]
    for w in workers:
        w.start()
    if n_workers and not coord.registry.wait_for_workers(n_workers, timeout=30.0):
        serving_stop(coord, workers)
        raise AssertionError(f"serving: workers {prefix}* did not announce")
    return coord, workers


def serving_stop(coord, workers):
    for w in workers:
        w.stop()
    coord.stop()


def ledger_mark():
    """A uniquely owned marker event: the ledger's events after it are a
    check's own."""
    from trino_tpu_torch.obs.memledger import MEMORY_LEDGER

    owner = f"chip-smoke-marker:{time.time_ns()}"
    MEMORY_LEDGER.record_event("watermark", "device", owner, 0)
    return owner


def ledger_since(marker):
    from trino_tpu_torch.obs.memledger import MEMORY_LEDGER

    events = MEMORY_LEDGER.snapshot()
    for i in range(len(events) - 1, -1, -1):
        if events[i]["owner"] == marker:
            return events[i + 1:]
    raise AssertionError("the ledger's ring wrapped past a check's marker")


def thread_census(baseline):
    """Threads started since ``baseline`` (a set of idents), by kind: this
    script's clients, the HTTP servers' connection handlers, the helpers of
    a query (stats poller, exchange pullers, worker tasks; named after the
    query or its task ids), the bounded staging and coordinator pools and
    the rest."""
    import threading

    out = {"client": 0, "http": 0, "pool": 0, "query": 0, "other": 0, "queries": set(),
           "names": []}
    for t in threading.enumerate():
        if t.ident in baseline:
            continue
        name = t.name
        if name.startswith("serving-client-"):
            out["client"] += 1
        elif "process_request_thread" in name:
            out["http"] += 1
        elif name.startswith(("staging-io", "coord-io")):
            # the process's bounded staging pool and the coordinator's
            # bounded pool of pulls from the workers, grown on demand
            out["pool"] += 1
        elif name.split(":", 1)[0] in ("stats", "exchange", "task"):
            out["query"] += 1
            out["queries"].add(name.split(":", 1)[1].split(".", 1)[0])
        else:
            out["other"] += 1
            out["names"].append(name)
    return out


def serving_overload(device, expected, card, schema):
    """Check 1: 32 clients against two lanes and a 4-deep queue; then the
    serving index on the same coordinator (check 2)."""
    import statistics
    import threading

    from trino_tpu_torch.client.remote import StatementClient
    from trino_tpu_torch.obs import metrics as M

    lanes = 2
    coord, workers = serving_cluster(device, 2, "sv", executor_lanes=lanes,
                                     dispatch_queue_capacity=4)
    try:
        props = serving_props(schema, result_cache_enabled="false")
        q6 = expected["6"]
        # one warm-up run: the workers' first scan of lineitem
        StatementClient(coord.base_url, props).execute(q6["sql"], timeout=600.0)
        rejected0 = M.DISPATCH_REJECTED.value("queue-full")
        baseline = {t.ident for t in threading.enumerate()}
        results, errors, lat, retries = {}, [], [], []
        start = threading.Barrier(SERVING_CLIENTS + 1)

        def client(i):
            c = StatementClient(coord.base_url, props)
            start.wait()
            t0 = time.perf_counter()
            try:
                results[i] = c.execute(q6["sql"], timeout=300.0)[1]
                lat.append(time.perf_counter() - t0)
                retries.append(c.submit_retries)
            except Exception as e:  # noqa: BLE001 — the assertion below
                errors.append(f"client {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(i,), name=f"serving-client-{i}")
                   for i in range(SERVING_CLIENTS)]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        peak = {"client": 0, "http": 0, "pool": 0, "query": 0, "other": 0, "queries": 0}
        other_names = set()
        while any(t.is_alive() for t in threads):
            c = thread_census(baseline)
            for k in ("client", "http", "pool", "query", "other"):
                peak[k] = max(peak[k], c[k])
            peak["queries"] = max(peak["queries"], len(c["queries"]))
            other_names.update(c["names"])
            time.sleep(0.005)
        wall = time.perf_counter() - t0
        for t in threads:
            t.join()
        if errors:
            raise AssertionError(f"serving overload: {errors[:3]}")
        for i in range(SERVING_CLIENTS):
            check_rows(f"Q6 (serving, client {i})", results[i], q6["rows"],
                       rel_tol=DIST_REL_TOL)
        rejected = M.DISPATCH_REJECTED.value("queue-full") - rejected0
        if rejected < 1 or sum(retries) < 1:
            raise AssertionError(f"serving overload: {rejected} rejections, "
                                 f"{sum(retries)} client retries (want >= 1 each)")
        # no thread a query: besides the clients and the HTTP servers'
        # connection handlers, only the helpers of the queries the lanes run
        # (a query that just finished may overlap the next one) and nothing
        # else
        if peak["queries"] > 2 * lanes or peak["other"] > 0:
            raise AssertionError(f"serving overload: threads of {peak['queries']} queries at "
                                 f"once (lanes {lanes}), other new threads "
                                 f"{sorted(other_names)}")
        lat.sort()
        out = {"clients": SERVING_CLIENTS, "lanes": lanes, "queue_capacity": 4,
               "wall_s": wall, "p50_s": statistics.median(lat),
               "p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
               "max_s": lat[-1], "rejected": rejected, "client_retries": sum(retries),
               "peak_new_threads": peak, "card": card}
        print("serving", json.dumps({"check": "overload", **out}), flush=True)
        out["index"] = serving_index(coord, device, expected, card, schema)
        return out
    finally:
        serving_stop(coord, workers)


def serving_index(coord, device, expected, card, schema):
    """Check 2: Q1 and Q18 with the result cache: MISS, then a HIT served
    by the dispatcher without a task or a plan-cache lookup; a memory
    table's SELECT misses after an INSERT."""
    from trino_tpu_torch.client.remote import StatementClient
    from trino_tpu_torch.obs import metrics as M

    client = StatementClient(coord.base_url, serving_props(schema, result_cache_enabled="true"))
    out = {}
    for q in (1, 18):
        entry = expected[str(q)]
        runs = []
        for want in ("MISS", "HIT"):
            c0 = (M.DISPATCH_CACHE_SERVED.value(), M.TASKS_TOTAL.value(),
                  M.PLAN_CACHE_HITS.value())
            sync(device)
            t0 = time.perf_counter()
            _cols, rows = client.execute(entry["sql"], timeout=600.0)
            wall = time.perf_counter() - t0
            d = [a - b for a, b in zip((M.DISPATCH_CACHE_SERVED.value(), M.TASKS_TOTAL.value(),
                                        M.PLAN_CACHE_HITS.value()), c0)]
            check_rows(f"Q{q} (serving index, {want})", rows, entry["rows"],
                       rel_tol=DIST_REL_TOL)
            if client.cache_status != want:
                raise AssertionError(f"Q{q} (serving index): {client.cache_status}, want {want}")
            if want == "HIT" and d != [1, 0, 0]:
                raise AssertionError(f"Q{q} (serving index): the HIT served {d[0]}, created "
                                     f"{d[1]} tasks, {d[2]} plan-cache hits (want 1, 0, 0)")
            runs.append({"status": want, "wall_s": wall, "served": d[0], "tasks": d[1],
                         "plan_cache_hits": d[2]})
        out[f"Q{q}"] = runs
    mem = StatementClient(coord.base_url, {"catalog": "memory", "schema": "default",
                                           "result_cache_enabled": "true"})
    mem.execute("create table memory.default.serving_t as "
                "select n_nationkey, n_regionkey from tpch.tiny.nation")
    sql = "select count(*), sum(n_regionkey) from memory.default.serving_t"
    seen = []
    for step in ("read", "read", "insert", "read", "read"):
        if step == "insert":
            mem.execute("insert into memory.default.serving_t values (100, 4)")
            continue
        rows = mem.execute(sql)[1]
        seen.append((mem.cache_status, rows))
    if seen != [("MISS", [[25, 50]]), ("HIT", [[25, 50]]), ("MISS", [[26, 54]]),
                ("HIT", [[26, 54]])]:
        raise AssertionError(f"serving index over a memory table: {seen}")
    out["memory_table"] = [s for s, _ in seen]
    print("serving", json.dumps({"check": "index", **out, "card": card}), flush=True)
    return out


def serving_groups(device, expected, card, schema):
    """Check 3: two users of ``global.adhoc.${USER}`` at limit 1 (a's
    second Q3 queues while b's runs), a source ``etl-1`` in
    ``global.etl``, and a query aged out of its group typed, in the
    history."""
    import threading

    from trino_tpu_torch.client.remote import StatementClient

    props = serving_props(schema)
    q3 = expected["3"]
    coord, workers = serving_cluster(device, 2, "rg", executor_lanes=4,
                                     resource_groups_config=SERVING_E2E_CFG)
    out = {}
    try:
        StatementClient(coord.base_url, props).execute(q3["sql"], timeout=600.0)  # warm-up
        a1 = coord.submit(q3["sql"], props, user="a")
        a2 = coord.submit(q3["sql"], props, user="a")
        b1 = coord.submit(q3["sql"], props, user="b")
        queued_seen = 0
        while not all(q.state.is_terminal() for q in (a1, a2, b1)):
            queued, _cap = coord.resource_groups.queue_state("global.adhoc.a")
            queued_seen = max(queued_seen, queued)
            time.sleep(0.002)
        for q in (a1, a2, b1):
            if q.state.get() != "FINISHED":
                raise AssertionError(f"serving groups: {q.query_id} {q.state.get()}: "
                                     f"{q.failure}")
            check_rows("Q3 (serving groups)", jsonable_rows(q.rows), q3["rows"],
                       rel_tol=DIST_REL_TOL)

        def started(q):
            return min(s["start"] for s in q.tracer.to_dicts() if s["name"] == "query")

        out["a2_started_after_a1_ended"] = started(a2) >= a1.ended_at
        out["b1_started_before_a1_ended"] = started(b1) < a1.ended_at
        out["a_queued_seen"] = queued_seen
        out["groups"] = [a1.resource_group, b1.resource_group]
        if not (out["a2_started_after_a1_ended"] and out["b1_started_before_a1_ended"]
                and queued_seen >= 1 and out["groups"] == ["global.adhoc.a", "global.adhoc.b"]):
            raise AssertionError(f"serving groups: {out}")
        etl = StatementClient(coord.base_url, props, user="c", source="etl-1")
        etl.execute(expected["6"]["sql"], timeout=600.0)
        out["etl_group"] = etl.stats["resourceGroup"]
        if out["etl_group"] != "global.etl":
            raise AssertionError(f"serving groups: source etl-1 ran in {out['etl_group']}")
    finally:
        serving_stop(coord, workers)
    coord, workers = serving_cluster(device, 0, "ag", executor_lanes=0,
                                     resource_groups_config=SERVING_AGING_CFG)
    try:
        q = coord.submit("select 1", {"catalog": "tpch", "schema": "tiny",
                                      "short_query_fast_path": "true"}, user="ager")
        time.sleep(0.15)  # parked past the 1 ms timeout, no lanes yet
        coord.dispatcher.start_lanes(1)
        state = q.state.wait_for_terminal(30.0)
        deadline = time.time() + 10
        rec = None
        while rec is None and time.time() < deadline:
            rec = next((r for r in coord.history.snapshot() if r["queryId"] == q.query_id), None)
            time.sleep(0.01)
        out["aged"] = {"state": state, "failure": (q.failure or "")[:120],
                       "history": rec and {k: rec[k] for k in ("state", "resourceGroup")}}
        if state != "FAILED" or "EXCEEDED_QUEUE_TIMEOUT" not in (q.failure or "") or \
                out["aged"]["history"] != {"state": "FAILED", "resourceGroup": "global.aging"}:
            raise AssertionError(f"serving groups (aging): {out['aged']}")
    finally:
        serving_stop(coord, [])
    print("serving", json.dumps({"check": "groups", **out, "card": card}), flush=True)
    return out


def serving_cache_shares(device, expected, plane, cap, card, schema):
    """Check 4: Q17 and Q18 warm in a cached eager session under group
    global.a (share 0.5), then group global.b's storm of scans past the
    device cache's budget: a's entries and bytes survive, every device
    eviction is b's, a warm Q17 and Q18 stage 0 rows; evicting the cache
    frees its bytes on the card."""
    import gc
    import weakref

    import torch

    from trino_tpu_torch import Session
    from trino_tpu_torch.devcache import DEVICE_CACHE, HOST_CACHE
    from trino_tpu_torch.server import resource_groups as rg

    DEVICE_CACHE.invalidate_all()
    HOST_CACHE.invalidate_all()
    shares_before = rg.CACHE_SHARES.snapshot()
    budget_before = DEVICE_CACHE.max_bytes
    rg.CACHE_SHARES.configure({"global.a": 0.5})
    session = Session(properties={"catalog": "tpch", "schema": schema, "fused_join_pallas": True,
                                  "device_cache_enabled": True}, device=device)
    out = {"launches": 0, "card": card}

    def grouped(group, fn):
        tok = rg.set_current_group(group)
        try:
            return fn()
        finally:
            rg.reset_current_group(tok)

    def run_a(label):
        runs = {}
        for q in (17, 18):
            entry = expected[str(q)]
            wall, launches, c, _n = grouped("global.a", lambda: run_checked(
                session, device, "serving", q, label, entry["sql"], entry["rows"],
                plane["tiers_cached"][str(q)]["warm" if label != "cold" else "cold"], cap))
            out["launches"] += launches
            runs[f"Q{q}"] = {"wall_s": wall, "merge_launches": launches,
                             "staged_rows": c["staged_rows"], "h2d_bytes": c["h2d_bytes"]}
        return runs

    try:
        out["cold"] = run_a("cold")
        out["warm"] = run_a("warm")
        a_bytes = DEVICE_CACHE.group_bytes().get("global.a", 0)
        a_keys = {e.key for e in DEVICE_CACHE.entries() if e.group == "global.a"}
        # the budget: a's carve-out (half) holds its warm set, and b passes its
        # own half before the cache is full, however large one storm entry
        # (at most the widest table's rows x 3 columns x 8 bytes) is: the
        # carve-out prefers a group over its share, else the LRU head
        lineitem_rows = session.execute("select count(*) from lineitem").rows[0][0]
        max_entry = lineitem_rows * SERVING_STORM_COLUMNS * 8
        DEVICE_CACHE._max_bytes = 2 * (a_bytes + max_entry)
        out.update({"a_bytes": a_bytes, "max_storm_entry_bytes": max_entry,
                    "budget_bytes": DEVICE_CACHE.max_bytes})
        mark = ledger_mark()
        storm = Session(properties={"catalog": "tpch", "schema": schema,
                                    "device_cache_enabled": True}, device=device)
        admitted = 0
        for table, cols in SERVING_STORM:
            sql = "select count(*), " + ", ".join(f"max({c})" for c in cols) + \
                " from " + table.format(s=schema)
            grouped("global.b", lambda: storm.execute(sql))
            admitted = sum(e["bytes"] for e in ledger_since(mark)
                           if e["kind"] == "admit" and e["owner"] == "device-cache:global.b")
            if admitted > 1.5 * DEVICE_CACHE.max_bytes:
                break
        events = [e for e in ledger_since(mark) if e["owner"].startswith("device-cache")
                  and e["kind"] in ("evict", "shed", "release")]
        out["storm"] = {"admitted_b": admitted, "evictions": len(events),
                        "evicted_bytes": sum(e["bytes"] for e in events),
                        "owners": sorted({e["owner"] for e in events})}
        if admitted <= DEVICE_CACHE.max_bytes - a_bytes or not events:
            raise AssertionError(f"serving cache shares: the storm did not overflow the "
                                 f"budget: {out['storm']}")
        if out["storm"]["owners"] != ["device-cache:global.b"]:
            raise AssertionError(f"serving cache shares: evictions of {out['storm']['owners']}")
        keys_after = {e.key for e in DEVICE_CACHE.entries() if e.group == "global.a"}
        out["a_bytes_after"] = DEVICE_CACHE.group_bytes().get("global.a", 0)
        if keys_after != a_keys or out["a_bytes_after"] != a_bytes:
            raise AssertionError(f"serving cache shares: global.a's entries did not survive "
                                 f"({len(keys_after)} of {len(a_keys)}, {out['a_bytes_after']} "
                                 f"of {a_bytes} bytes)")
        out["after_storm"] = run_a("after-storm")
        for q, r in out["after_storm"].items():
            if r["staged_rows"] or r["h2d_bytes"]:
                raise AssertionError(f"{q} (serving, after the storm) staged {r}")
        if out["launches"] < 1:
            raise AssertionError("serving cache shares: Q17 and Q18 launched no merge kernel")
        # evicting frees the entries' device memory
        del storm
        gc.collect()
        torch.cuda.synchronize(device)
        entries = len(DEVICE_CACHE)
        tensors = entry_tensors([e.value for e in DEVICE_CACHE.entries()])
        storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                    for t in tensors}
        refs = [weakref.ref(t) for t in tensors]
        del tensors
        before = torch.cuda.memory_allocated(device)
        freed = DEVICE_CACHE.evict_to(0)
        gc.collect()
        torch.cuda.synchronize(device)
        drop = before - torch.cuda.memory_allocated(device)
        out["evict_all"] = {"entries": entries, "freed_bytes": freed,
                            "storages": len(storages), "storage_bytes": sum(storages.values()),
                            "memory_allocated_drop": drop,
                            "tensors_alive": sum(r() is not None for r in refs)}
        # every tensor of the evicted entries is gone, so their storages are
        # back with the allocator: the drop is at least the evicted bytes
        # (each storage rounded up to a block). Other threads of the process
        # free memory too while this runs, so the drop has no upper bound here
        if out["evict_all"]["tensors_alive"] or drop < freed:
            raise AssertionError(f"serving cache shares: evicting {out['evict_all']}")
    finally:
        rg.CACHE_SHARES.configure(shares_before)
        DEVICE_CACHE._max_bytes = budget_before
        DEVICE_CACHE.invalidate_all()
        HOST_CACHE.invalidate_all()
    print("serving", json.dumps({"check": "cache_shares", **out}), flush=True)
    return out


def entry_tensors(values):
    """The tensors the cache entries' values hold (pages, columns, sorted
    builds: walked through their attributes)."""
    import torch

    out, seen = [], set()

    def walk(v, depth=0):
        if depth > 8 or id(v) in seen:
            return
        seen.add(id(v))
        if torch.is_tensor(v):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x, depth + 1)
        elif hasattr(v, "__dict__") and not isinstance(v, type):
            for x in vars(v).values():
                walk(x, depth + 1)

    for v in values:
        walk(v)
    return out


class AnnouncePoller:
    """While a block runs, take every worker's announce (``announce_payload``:
    the pool-overflow shed, the memory sample) every 2 ms and feed it to the
    coordinator's cluster memory manager, as the announce loop does every
    0.5 s; ``ticks`` keeps (node, reservation, device-cache bytes) of each."""

    def __init__(self, coord, workers):
        import threading

        self.coord, self.workers = coord, workers
        self.ticks = []
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._poll)

    def _poll(self):
        while not self._done.is_set():
            for w in self.workers:
                p = w.announce_payload()
                self.coord.cluster_memory.update(w.node_id, p)
                self.ticks.append((w.node_id, p["memoryBytes"], p["deviceCacheBytes"]))
            time.sleep(0.002)

    def peak(self):
        return max((m for _n, m, _c in self.ticks), default=0)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join()


def serving_pool_overflow(device, expected, card, schema):
    """Check 5: a worker whose pool holds a running Q1's reservation but not
    that plus its warm device cache sheds the cache (``pool-overflow``),
    and Q1 finishes with the expected rows."""
    from trino_tpu_torch.client.remote import StatementClient
    from trino_tpu_torch.devcache import DEVICE_CACHE

    DEVICE_CACHE.invalidate_all()
    coord, workers = serving_cluster(device, 1, "po")
    w = workers[0]
    props = serving_props(schema, device_cache_enabled="true")
    q1 = expected["1"]
    out = {"card": card}

    def run_polled():
        """Q1 under the announce poller."""
        with AnnouncePoller(coord, workers) as poller:
            t0 = time.perf_counter()
            rows = StatementClient(coord.base_url, props).execute(q1["sql"], timeout=600.0)[1]
            wall = time.perf_counter() - t0
        check_rows("Q1 (serving, pool overflow)", rows, q1["rows"], rel_tol=DIST_REL_TOL)
        return wall, [(m, c) for _n, m, c in poller.ticks]

    try:
        out["first_wall_s"], ticks = run_polled()  # fills the cache: no pool yet
        reservation = max(m for m, _ in ticks)
        cached = DEVICE_CACHE.cached_bytes()
        if not reservation or not cached:
            raise AssertionError(f"serving pool overflow: reservation {reservation}, "
                                 f"cached {cached}")
        w.memory_limit_bytes = reservation + cached // 2
        mark = ledger_mark()
        out["second_wall_s"], ticks = run_polled()
        sheds = [e for e in ledger_since(mark)
                 if e["kind"] == "shed" and e.get("reason") == "pool-overflow"]
        held = [(m, c) for m, c in ticks if m]
        out.update({"reservation_bytes": reservation, "cached_bytes": cached,
                    "limit_bytes": w.memory_limit_bytes,
                    "shed_bytes": sum(e["bytes"] for e in sheds), "shed_events": len(sheds),
                    "cached_after": DEVICE_CACHE.cached_bytes(),
                    "ticks_with_reservation": len(held)})
        if not sheds or not any(c <= w.memory_limit_bytes - m for m, c in held):
            raise AssertionError(f"serving pool overflow: {out}")
        if coord.cluster_memory.kills:
            raise AssertionError(f"serving pool overflow killed {coord.cluster_memory.kills}")
    finally:
        serving_stop(coord, workers)
        DEVICE_CACHE.invalidate_all()
    print("serving", json.dumps({"check": "pool_overflow", **out}), flush=True)
    return out


SERVING_KILL_SQL = ("select o_orderpriority, count(*) c, sum(l_quantity) q "
                    "from orders, lineitem where o_orderkey = l_orderkey "
                    "group by o_orderpriority order by o_orderpriority")


def serving_killer(device, card, schema):
    """Check 6: two workers whose pools the orders x lineitem join at SF1
    overflows: it fails EXCEEDED_CLUSTER_MEMORY with a postmortem (the
    announce poller feeds the workers' reservations to the cluster memory
    manager every 2 ms while it runs); then a small query finishes. A
    worker's pool is 64 MiB, or half the peak reservation an unlimited run
    of the join showed where that is less (the port streams the join's
    scans a split at a time)."""
    import torch

    coord, workers = serving_cluster(device, 2, "kw")
    props = {"catalog": "tpch", "schema": schema}
    out = {"card": card}
    try:
        payload = workers[0].announce_payload()
        out["device_memory_bytes"] = payload["deviceMemoryBytes"]
        if payload["deviceMemoryBytes"] != torch.cuda.mem_get_info(device)[1]:
            raise AssertionError(f"announce deviceMemoryBytes {payload['deviceMemoryBytes']} != "
                                 f"mem_get_info {torch.cuda.mem_get_info(device)[1]}")
        with AnnouncePoller(coord, workers) as poller:
            free = coord.submit(SERVING_KILL_SQL, props)
            free.state.wait_for_terminal(300.0)
        out["unlimited"] = {"state": free.state.get(), "peak_worker_reservation": poller.peak()}
        if free.state.get() != "FINISHED" or not poller.peak():
            raise AssertionError(f"serving killer: the unlimited run {out['unlimited']}: "
                                 f"{free.failure}")
        out["pool_bytes"] = min(SERVING_KILL_POOL, poller.peak() // 2)
        for w in workers:
            w.memory_limit_bytes = out["pool_bytes"]
        t0 = time.perf_counter()
        with AnnouncePoller(coord, workers) as poller:
            big = coord.submit(SERVING_KILL_SQL, props)
            big.state.wait_for_terminal(300.0)
        out["kill_wall_s"] = time.perf_counter() - t0
        out["peak_worker_reservation"] = poller.peak()
        out["state"] = big.state.get()
        # an announce that still carries the victim's tasks (their cancel is
        # on its way) names it again: the history may repeat the one victim
        out["kills"] = [q for q, _ in coord.cluster_memory.kills]
        if out["state"] != "FAILED" or "EXCEEDED_CLUSTER_MEMORY" not in (big.failure or "") \
                or set(out["kills"]) != {big.query_id}:
            raise AssertionError(f"serving killer: {out}, failure {(big.failure or '')[:300]}")
        deadline = time.time() + 30
        while big.postmortem is None and time.time() < deadline:
            time.sleep(0.01)
        pm = big.postmortem or {}
        mem = (pm.get("coordinator") or {}).get("memory") or {}
        out["postmortem_memory_keys"] = sorted(mem)
        out["postmortem_workers"] = len(pm.get("workers") or ())
        if set(mem) != {"nodeId", "pools", "topConsumers", "sheds"}:
            raise AssertionError(f"serving killer: postmortem memory {sorted(mem)}")
        t0 = time.perf_counter()
        small = coord.submit("select count(*) from nation", {"catalog": "tpch", "schema": schema})
        state = small.state.wait_for_terminal(120.0)
        out["small"] = {"state": state, "rows": small.rows, "wall_s": time.perf_counter() - t0}
        if state != "FINISHED" or small.rows != [(25,)]:
            raise AssertionError(f"serving killer: the small query {out['small']}: "
                                 f"{small.failure}")
    finally:
        serving_stop(coord, workers)
    print("serving", json.dumps({"check": "killer", **out}, default=str), flush=True)
    return out


def serving_auth_events(device, card):
    """Check 7 (host side): a coordinator with a password file and a JWT
    secret: 401 without credentials, Basic and Bearer accepted, 403 on
    another user's query, the created and completed events (a failed
    query's carrying its error), and /v1/metrics with the serving series."""
    import base64
    import urllib.error
    import urllib.request

    from trino_tpu_torch.server import auth
    from trino_tpu_torch.server.events import EventListener

    secret = b"chip-smoke-jwt-secret"
    pw = auth.PasswordFileAuthenticator({"alice": auth.hash_password("wonder"),
                                         "bob": auth.hash_password("tinker")})
    coord, _ = serving_cluster(device, 0, "au", authenticator=auth.Authenticator(
        password=pw, jwt=auth.JwtAuthenticator(secret)))

    class Events(EventListener):
        def __init__(self):
            self.created, self.completed = [], []

        def query_created(self, event):
            self.created.append(event)

        def query_completed(self, event):
            self.completed.append(event)

    events = Events()
    coord.events.add(events)
    session = {"X-Trino-Session-Catalog": "tpch", "X-Trino-Session-Schema": "tiny",
               "X-Trino-Session-Short_query_fast_path": "true"}

    def request(path, data=None, method="GET", headers=None):
        req = urllib.request.Request(coord.base_url + path, data=data, method=method,
                                     headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read() or b"null")
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("WWW-Authenticate")

    def basic(user, password):
        return {"Authorization": "Basic " + base64.b64encode(f"{user}:{password}".encode())
                .decode()}

    out = {"card": card}
    try:
        out["no_credentials"] = request("/v1/statement", b"select 1", "POST", session)
        status, body = request("/v1/statement", b"select 41 + 1", "POST",
                               {**session, **basic("alice", "wonder")})
        qid = body["id"]
        coord.get_query(qid).state.wait_for_terminal(60.0)
        tok = auth.make_jwt({"sub": "bob", "exp": time.time() + 300}, secret)
        bstatus, bbody = request("/v1/statement", b"select 1", "POST",
                                 {**session, "Authorization": f"Bearer {tok}"})
        out["basic"] = [status, coord.get_query(qid).user]
        out["bearer"] = [bstatus, coord.get_query(bbody["id"]).user]
        out["other_user"] = request(f"/v1/query/{qid}", headers=basic("bob", "tinker"))[0]
        out["owner"] = request(f"/v1/query/{qid}", headers=basic("alice", "wonder"))[0]
        bad = coord.submit("select no_such_column from nation", {"catalog": "tpch",
                                                                   "schema": "tiny"})
        bad.state.wait_for_terminal(60.0)
        deadline = time.time() + 10
        while len(events.completed) < 3 and time.time() < deadline:
            time.sleep(0.01)
        done = {e.query_id: e for e in events.completed}
        out["events"] = {"created": len(events.created), "completed": len(events.completed),
                         "failed_error": bool(done.get(bad.query_id) and
                                              done[bad.query_id].error)}
        with urllib.request.urlopen(coord.base_url + "/v1/metrics", timeout=60) as resp:
            page = resp.read().decode()
        series = ("trino_tpu_dispatch_queue_depth", "trino_tpu_executor_lanes_busy",
                  "trino_tpu_resource_group_running", "trino_tpu_resource_group_queue_seconds",
                  "trino_tpu_queries_total", "trino_tpu_query_seconds")
        out["metrics_missing"] = [s for s in series if f"\n{s}" not in page]
        if (out["no_credentials"] != (401, 'Basic realm="trino-tpu", Bearer')
                or out["basic"] != [200, "alice"] or out["bearer"] != [200, "bob"]
                or out["other_user"] != 403 or out["owner"] != 200
                or out["events"] != {"created": 3, "completed": 3, "failed_error": True}
                or out["metrics_missing"]):
            raise AssertionError(f"serving auth and events: {out}")
    finally:
        serving_stop(coord, [])
    print("serving", json.dumps({"check": "auth_events", **out}), flush=True)
    return out


def phase_serving(device, expected, plane, cap, card, schema="sf1"):
    """The serving plane on the card (server/dispatch.py, resource groups,
    cluster memory, the memory ledger, authentication and events): seven
    checks; the merge launches of check 4's Q17 and Q18 are the path's."""
    t_phase = time.perf_counter()
    out = {}
    for name, step in (
            ("overload", lambda: serving_overload(device, expected, card, schema)),
            ("groups", lambda: serving_groups(device, expected, card, schema)),
            ("cache_shares", lambda: serving_cache_shares(device, expected, plane, cap, card,
                                                          schema)),
            ("pool_overflow", lambda: serving_pool_overflow(device, expected, card, schema)),
            ("killer", lambda: serving_killer(device, card, schema)),
            ("auth_events", lambda: serving_auth_events(device, card))):
        t0 = time.perf_counter()
        out[name] = step()
        out[f"{name}_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    print("serving_total", json.dumps({k: v for k, v in out.items() if k.endswith("_s")}
                                      | {"card": card}), flush=True)
    return out


# ------------------------------------------------------------- phase observe
OBSERVE_DIST_QUERIES = (1, 3, 18)
OBSERVE_CACHED_QUERIES = (17, 18)
OBSERVE_KILL_REASON = "observe: killed by kill_query"
# where a cached query joins one row of system.runtime.nodes (the worker it
# names): a plan that scans the system catalog, a process-local catalog,
# runs whole on the coordinator's own executor, where exchanged pages play
# no part and the merge kernel launches as in an eager session
OBSERVE_GATES = {17: ("from lineitem, part", "where p_partkey = l_partkey"),
                 18: ("from customer, orders, lineitem", "and o_orderkey = l_orderkey")}
OUT_OF_WALL = ("segment-fetch", "client-drain", "unattributed")


def observe_gated(sql, q, node_id):
    """Query ``q``'s SQL joined with the one row of system.runtime.nodes
    whose node id is ``node_id``: the same rows while that worker is known."""
    frm, cond = OBSERVE_GATES[q]
    if sql.count(frm) != 1 or sql.count(cond) != 1:
        raise AssertionError(f"Q{q}: the gate's anchors are not in its SQL once")
    return sql.replace(frm, frm + ", system.runtime.nodes").replace(
        cond, f"{cond} and node_id = '{node_id}'")


def flow_totals():
    """Bytes and records of the process's flow ledger by link."""
    from trino_tpu_torch.obs.flowledger import FLOW_LEDGER

    out = {}
    for r in FLOW_LEDGER.transfer_rows():
        b, n = out.get(r["link"], (0, 0))
        out[r["link"]] = (b + r["bytes"], n + r["transfers"])
    return out


def observe_execute(coord, client, sql, device, cap=None, label=None):
    """(rows, wall, deltas, execution) of one statement through the
    coordinator: the exchange and staging counters against the flow
    ledger's links, the ledger's data-plane records, merge launches."""
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.ops import merge

    merge.launches = 0
    c0 = (M.EXCHANGE_BYTES.value(), M.STAGED_H2D_BYTES.value(), flow_totals())
    if cap is not None:
        cap.now = label
    try:
        sync(device)
        t0 = time.perf_counter()
        _cols, rows = client.execute(sql, timeout=600.0)
        sync(device)
        wall = time.perf_counter() - t0
    finally:
        if cap is not None:
            cap.now = None
    launches = merge.launches
    ex1, h2d1, f1 = M.EXCHANGE_BYTES.value(), M.STAGED_H2D_BYTES.value(), flow_totals()

    def link(f, name, i):
        return f.get(name, (0, 0))[i]

    d = {"exchange_bytes": ex1 - c0[0], "h2d_bytes": h2d1 - c0[1],
         "pull_bytes": link(f1, "exchange-pull", 0) - link(c0[2], "exchange-pull", 0),
         "staged_bytes": link(f1, "staging-transfer", 0) - link(c0[2], "staging-transfer", 0),
         "records": sum(n for k, (_b, n) in f1.items() if k != "control")
         - sum(n for k, (_b, n) in c0[2].items() if k != "control"),
         "merge_launches": launches}
    if d["pull_bytes"] != d["exchange_bytes"] or d["staged_bytes"] != d["h2d_bytes"]:
        raise AssertionError(f"observe: the flow ledger's links disagree with the counters: {d}")
    return rows, wall, d, coord.get_query(client.query_id)


def observe_trace(coord, q, worker_urls):
    """The query's trace holds a task span of every task (but those of
    superseded producers), on both workers,
    under the query's trace id and parented under the coordinator's
    schedule span; the timeline's phases are exclusive and with the
    residual make up the wall within 1 ms."""
    from trino_tpu_torch.server import wire

    spans = q.tracer.to_dicts() + q.worker_spans()
    (schedule,) = [s for s in spans if s["name"] == "schedule"]
    tasks = [s for s in spans if s["name"] == "task"]
    # a producer the adaptive re-planner superseded was canceled, and its
    # worker dropped it with its spans
    superseded = {fid for ch in q.plan_versions for fid in ch.get("supersedes", ())}
    where = {loc.task_id: loc.base_url for fid, locs in q.fragment_tasks.items()
             if fid not in superseded for loc in locs}
    got = {t["attributes"]["task_id"] for t in tasks
           if int(t["attributes"]["task_id"].split(".")[-3]) not in superseded}
    if got != set(where) or {where[t] for t in got} != worker_urls:
        raise AssertionError(f"observe: task spans of {sorted(got)}, tasks {sorted(where)}")
    if {t["parentId"] for t in tasks} != {schedule["spanId"]}:
        raise AssertionError("observe: task spans not parented under the schedule span")
    for task_id, url in where.items():
        dump = wire.json_request("GET", f"{url}/v1/task/{task_id}/spans")
        if dump["traceId"] != q.tracer.trace_id:
            raise AssertionError(f"observe: task {task_id} traced under {dump['traceId']}")
    tl = q.timeline_dict()
    phases = {p: v for p, v in tl["phases"].items() if p not in OUT_OF_WALL}
    if min(phases.values()) < 0 or sum(phases.values()) > tl["wallS"] + 1e-5 or \
            abs(sum(phases.values()) + tl["unattributedS"] - tl["wallS"]) > 1e-3:
        raise AssertionError(f"observe: the timeline does not make up the wall: {tl}")
    return {"spans": len(spans), "task_spans": len(tasks), "timeline": tl}


def observe_sql(client, sql):
    return client.execute(sql, timeout=120.0)[1]


def phase_observe(device, expected, plane, compiled, cap, card, dist_walls, schema="sf1",
                  kill_props=None):
    """The observability plane on a port coordinator with two in-process
    workers, an OTLP stub collector in this process and the flow ledger,
    the phase ledger and the system catalog read through SQL.
    ``kill_props``: session properties added to the query it kills (the
    CPU test holds it running with ``slow_injection``)."""
    import urllib.request

    from trino_tpu_torch.client.cli import format_table
    from trino_tpu_torch.client.remote import StatementClient
    from trino_tpu_torch.devcache import DEVICE_CACHE
    from trino_tpu_torch.exec.executor import Executor
    from trino_tpu_torch.exec.query import plan_sql
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.obs import otlp
    from trino_tpu_torch.obs.flowledger import FlowLedger
    from trino_tpu_torch.obs.timeline import summarize
    from trino_tpu_torch.server import wire

    t_phase = time.perf_counter()
    collector = otlp.StubCollector().start()
    os.environ[otlp.ENDPOINT_ENV] = collector.endpoint
    try:
        coord, workers = serving_cluster(device, 2, "ow")
    finally:
        del os.environ[otlp.ENDPOINT_ENV]
    dropped0 = sum(M.OTLP_DROPPED.value(r) for r in ("overflow", "send-error"))
    props = serving_props(schema)
    client = StatementClient(coord.base_url, props)
    urls = {w.base_url for w in workers}
    out = {"card": card, "launches": 0}
    try:
        # traffic: Q1, Q3 and Q18 distributed, cold then warm
        traffic = {}
        for q in OBSERVE_DIST_QUERIES:
            entry = expected[str(q)]
            for label in ("cold", "warm"):
                rows, wall, d, ex = observe_execute(coord, client, entry["sql"], device)
                check_rows(f"Q{q} (observe, {label})", rows, entry["rows"], rel_tol=DIST_REL_TOL)
                if ex.fast_path != "distributed":
                    raise AssertionError(f"Q{q} (observe) ran {ex.fast_path}")
                flows = ex.flows_dict()
                pulled = sum(r["bytes"] for r in flows["transfers"] if r["link"] == "exchange-pull")
                if pulled != d["exchange_bytes"]:
                    raise AssertionError(f"Q{q} (observe): /flows pulled {pulled} bytes, "
                                         f"EXCHANGE_BYTES moved {d['exchange_bytes']}")
                traffic[(q, label)] = (ex, len(rows))
                out.setdefault("walls", {})[f"Q{q}_{label}_s"] = wall
                out.setdefault("flows", {})[f"Q{q}_{label}"] = d
                if label == "cold" and q == 1:
                    out["otlp_query"] = ex
        for q in OBSERVE_DIST_QUERIES:
            out.setdefault("trace", {})[f"Q{q}"] = observe_trace(coord, traffic[(q, "warm")][0],
                                                                 urls)
        # the system tables over that traffic
        qrows = {r[0]: r for r in observe_sql(
            client, "select query_id, state, result_rows from system.runtime.queries")}
        for (q, label), (ex, n) in traffic.items():
            if qrows.get(ex.query_id, [None])[1:] != ["FINISHED", n]:
                raise AssertionError(f"Q{q} ({label}) in system.runtime.queries: "
                                     f"{qrows.get(ex.query_id)}, want FINISHED {n} rows")
        for q in OBSERVE_DIST_QUERIES:
            ex = traffic[(q, "warm")][0]
            on = {r[0] for r in observe_sql(client, "select worker_uri from system.runtime.tasks "
                                                    f"where query_id = '{ex.query_id}'")}
            if on != urls:
                raise AssertionError(f"Q{q}: system.runtime.tasks on {on}, not {urls}")
        active = observe_sql(client, "select count(*) from system.runtime.nodes "
                                     "where state = 'active'")
        if active != [[2]]:
            raise AssertionError(f"observe: system.runtime.nodes active {active}")
        q3 = traffic[(3, "warm")][0]
        table = {r[0]: r[1] for r in observe_sql(
            client, "select link, sum(bytes) from system.runtime.transfers where owner like "
                    f"'task:{q3.query_id}.%' or owner = 'drain:{q3.query_id}' or owner = "
                    f"'query:{q3.query_id}' group by link")}
        by_link = {}
        for r in q3.flows_dict()["transfers"]:
            by_link[r["link"]] = by_link.get(r["link"], 0) + r["bytes"]
        if table != by_link:
            raise AssertionError(f"Q3: system.runtime.transfers {table} != /flows {by_link}")
        out["q3_links"] = by_link
        # OTLP: every span of Q1's trace reached the collector
        ex = out.pop("otlp_query")
        want = len(ex.tracer.to_dicts()) + len(ex.worker_spans())
        deadline = time.time() + 20.0
        got = 0
        while time.time() < deadline:
            got = sum(sp["traceId"] == ex.tracer.trace_id for sp in collector.spans())
            if got >= want:
                break
            time.sleep(0.05)
        if got != want:
            raise AssertionError(f"observe: the OTLP collector got {got} of Q1's {want} spans")
        out["otlp_spans"] = got
        # kernel rows: the cached Q17 and Q18 on the coordinator's executor,
        # gated on the first worker's row of system.runtime.nodes
        cached = serving_props(schema, device_cache_enabled="true", device_profiling="true")
        cclient = StatementClient(coord.base_url, cached)
        kernels = {}
        for q in OBSERVE_CACHED_QUERIES:
            entry = expected[str(q)]
            sql = observe_gated(entry["sql"], q, "ow0")
            for label in ("cold", "warm"):
                t0_tiers = tier_counts(M.FUSED_JOIN_SELECTIONS, TIERS)
                rows, wall, d, ex = observe_execute(coord, cclient, sql, device, cap,
                                                    ("observe", q, label))
                tiers = {t: v - t0_tiers[t]
                         for t, v in tier_counts(M.FUSED_JOIN_SELECTIONS, TIERS).items()}
                check_rows(f"Q{q} (observe, cached, {label})", rows, entry["rows"],
                           rel_tol=DIST_REL_TOL)
                want_tiers = plane["tiers_cached"][str(q)][label] if plane else None
                if want_tiers is not None and tiers != want_tiers:
                    raise AssertionError(f"Q{q} (observe, cached, {label}) tiers {tiers} != "
                                         f"{want_tiers}")
                if ex.fast_path != "local-catalog":
                    raise AssertionError(f"Q{q} (observe, cached) ran {ex.fast_path}")
                krows = observe_sql(cclient, "select node_id, operator, launches, wall_seconds, "
                                             "device_seconds, estimated from system.runtime."
                                             f"kernels where query_id = '{ex.query_id}'")
                joins = [r for r in krows if r[0] == "coordinator" and r[1] == "Join"]
                if not joins or any(r[5] for r in joins) or \
                        any(r[4] > r[3] + 1e-9 for r in krows):
                    raise AssertionError(f"Q{q} (observe, cached): kernel rows {krows}")
                if device.type == "cuda" and (want_tiers or {}).get("merge-pallas", 0) >= 1 \
                        and d["merge_launches"] < 1:
                    raise AssertionError(f"Q{q} (observe, cached): no merge launch")
                out["launches"] += d["merge_launches"]
                kernels[f"Q{q}_{label}"] = {"wall_s": wall, "merge_launches": d["merge_launches"],
                                            "tiers": tiers, "join_rows": joins}
        out["kernels"] = kernels
        # no system scan leaves the card: a system page is on the device
        session = coord.session_factory(dict(props))
        page = Executor(session).execute_checked(
            plan_sql(session, "select node_id from system.runtime.nodes"))
        if page.columns[0].values.device.type != device.type:
            raise AssertionError(f"observe: a system scan landed on {page.columns[0].values.device}")
        # the compile ledger: Q17's CompiledQuery twice, read through SQL
        ledger = adaptive_compile_ledger(device, expected, compiled, cap, schema,
                                         path="observe_compiled")
        out["launches"] += ledger["merge_launches"]
        crows = observe_sql(client, "select cache, compile_seconds from system.runtime.compiles "
                                    f"where fingerprint = '{ledger['fingerprint']}' and "
                                    f"created_at >= {ledger['events'][0]['ts']} order by created_at")
        if [r[0] for r in crows] != ["miss", "hit"] or crows[1][1] != 0:
            raise AssertionError(f"observe: system.runtime.compiles {crows}")
        out["compiles"] = crows
        # the device cache's table equals the cache
        dc = observe_sql(client, "select count(*), sum(entry_bytes) from system.runtime."
                                 "device_cache where tier = 'hbm'")
        if dc != [[len(DEVICE_CACHE.snapshot()), DEVICE_CACHE.cached_bytes()]] or not dc[0][0]:
            raise AssertionError(f"observe: system.runtime.device_cache {dc} != "
                                 f"{len(DEVICE_CACHE.snapshot())} entries, "
                                 f"{DEVICE_CACHE.cached_bytes()} bytes")
        out["device_cache"] = dc[0]
        # a metric series through SQL equals the Prometheus page's
        name = "trino_tpu_exchange_requests_total"
        (value,) = observe_sql(client, f"select value from system.metrics where name = '{name}'")
        page_text = urllib.request.urlopen(coord.base_url + "/v1/metrics").read().decode()
        line = next(ln for ln in page_text.splitlines() if ln.startswith(name + " "))
        if float(line.split()[-1]) != value[0] or value[0] <= 0:
            raise AssertionError(f"observe: {name} {value} in SQL, {line!r} on /v1/metrics")
        # a system query bypasses both caches
        entries0 = len(coord.query_cache.results)
        rc = StatementClient(coord.base_url, dict(props, result_cache_enabled="true"))
        for _ in range(2):
            rc.execute("select query_id, state from system.runtime.queries", timeout=120.0)
            if rc.cache_status != "BYPASS":
                raise AssertionError(f"observe: a system query's cache {rc.cache_status}")
        if len(coord.query_cache.results) != entries0 or \
                any(e["catalog"] == "system" for e in DEVICE_CACHE.snapshot()):
            raise AssertionError("observe: a system query entered a cache")
        # kill_query on a running Q18
        victim = coord.submit(expected["18"]["sql"], dict(props, **(kill_props or {})))
        deadline = time.time() + 120.0
        while time.time() < deadline and not (
                victim.state.get() == "RUNNING" and victim.query_stats()["totalSplits"]):
            if victim.state.is_terminal():
                raise AssertionError(f"observe: Q18 ended before the kill: {victim.failure}")
            time.sleep(0.01)
        (msg,) = observe_sql(client, f"call system.runtime.kill_query('{victim.query_id}', "
                                     f"'{OBSERVE_KILL_REASON}')")
        victim.state.wait_for_terminal(60.0)
        state = observe_sql(client, "select state, failure from system.runtime.queries where "
                                    f"query_id = '{victim.query_id}'")
        gone = {wire.http_request("GET", f"{loc.base_url}/v1/task/{loc.task_id}/status",
                                  timeout=5.0)[0]
                for locs in victim.fragment_tasks.values() for loc in locs}
        if msg != [f"killed {victim.query_id}"] or state[0][0] != "FAILED" or \
                OBSERVE_KILL_REASON not in (state[0][1] or "") or gone != {404}:
            raise AssertionError(f"observe: kill_query {msg}, {state}, task statuses {gone}")
        out["kill"] = {"state": state[0][0], "task_statuses": sorted(gone)}
        # EXPLAIN ANALYZE of Q18: its ledger and flow lines agree with the
        # query's timeline and flows
        _c, plan = client.execute("explain analyze " + expected["18"]["sql"], timeout=600.0)
        text = [r[0] for r in plan]
        ex = coord.get_query(client.query_id)
        tl, flows = ex.timeline_dict(), ex.flows_dict()
        ledger_line = next(ln for ln in text if ln.startswith("Phase ledger: "))
        flow_line = next(ln for ln in text if ln.startswith("Data flow: "))
        named = [part.rsplit(" ", 1)[0] for part in
                 ledger_line[len("Phase ledger: "):].split(" (")[0].split(" · ")]
        mb = {}
        for r in flows["transfers"]:
            mb[r["link"]] = mb.get(r["link"], 0) + r["bytes"]
        shown = dict(part.split(" @ ")[0].split(" ") for part in
                     flow_line[len("Data flow: "):].split(", "))
        if not named or any(tl["phases"][p] <= 0 for p in named) or \
                any(f"{mb.get(link, 0) / 1e6:.1f}MB" != v for link, v in shown.items()):
            raise AssertionError(f"observe: EXPLAIN ANALYZE {ledger_line!r}, {flow_line!r} "
                                 f"against {tl['phases']}, {mb}")
        out["explain"] = {"phase_ledger": ledger_line, "data_flow": flow_line,
                          "summary": summarize(tl)}
        # the CLI as a subprocess: Q1's rows as the table, then a HIT
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = here + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
                                    else "")
        cli_props = dict(props, result_cache_enabled="true")
        cols, rows = StatementClient(coord.base_url, cli_props).execute(
            expected["1"]["sql"], timeout=600.0)
        table = format_table(cols, rows)
        cli = []
        for _ in range(2):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "trino_tpu_torch.client.cli", "--server", coord.base_url,
                 "--catalog", "tpch", "--schema", schema]
                + [a for k, v in cli_props.items() if k not in ("catalog", "schema")
                   for a in ("--session", f"{k}={v}")]
                + ["--execute", expected["1"]["sql"]],
                env=env, cwd=here, capture_output=True, text=True, timeout=300)
            if res.returncode != 0 or not res.stdout.startswith(table + "\n"):
                raise AssertionError(f"observe: the CLI printed {res.stdout[:600]!r} "
                                     f"{res.stderr[-600:]!r}")
            cli.append((time.perf_counter() - t0, res.stdout.strip().split("\n")[-1]))
        if "[cache: HIT]" not in cli[1][1]:
            raise AssertionError(f"observe: the CLI's repeat printed {cli[1][1]!r}")
        out["cli"] = {"walls_s": [w for w, _ in cli], "summary": cli[1][1]}
        dropped = sum(M.OTLP_DROPPED.value(r) for r in ("overflow", "send-error")) - dropped0
        if dropped:
            raise AssertionError(f"observe: the OTLP exporters dropped {dropped}")
    finally:
        cap.now = None
        serving_stop(coord, workers)
        collector.stop()
    # the host cost of one flow-ledger record, against the records a query made
    led = FlowLedger(node_id="cost")
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        led.record_transfer("exchange-pull", "task:cost", 0, 0.0, pages=1)
    us = (time.perf_counter() - t0) / n * 1e6
    out["record_transfer_us"] = us
    out["records_a_query"] = {k: d["records"] for k, d in out["flows"].items()}
    out["walls_vs_distributed"] = {
        f"Q{q}": {"observe_warm_s": out["walls"][f"Q{q}_warm_s"],
                  "distributed_warm_s": dist_walls.get(q) if dist_walls else None}
        for q in OBSERVE_DIST_QUERIES}
    out["phase_s"] = time.perf_counter() - t_phase
    print("observe", json.dumps(out, default=str), flush=True)
    return out


FTE_QUERIES = (1, 3, 9, 18)
FTE_RUNS = ("cold", "warm")
# speculation as the reference's test patches it: a first attempt past
# 1.5x its siblings' median (0.5 s at least) gets a twin
FTE_SPECULATION = (0.5, 1.5)
FTE_SLOW_S = 60
# the export shape (a pass-through of lineitem's integer columns) and the
# sorted shape spooled through the coordinator's store; the segment target
# a scale (several a worker at SF1, where a 4 MiB chunk of these columns
# compresses to about 1 MiB; one a worker at tiny)
FTE_EXPORT_SQL = "select l_orderkey, l_partkey, l_suppkey, l_linenumber from lineitem"
FTE_EXPORT_CHECK = ("select count(*), sum(l_orderkey), sum(l_partkey), sum(l_suppkey), "
                    "sum(l_linenumber) from lineitem")
FTE_SORTED_SQL = "select o_orderkey, o_custkey from orders order by o_orderkey"
FTE_SORTED_CHECK = "select count(*), sum(o_orderkey), sum(o_custkey) from orders"
FTE_SEGMENT_BYTES = {"sf1": 2 << 20, "tiny": 64 << 10}
FTE_MIN_SEGMENTS = {"sf1": 6, "tiny": 2}


def spool_files(spool, query_id):
    """The files of ``query_id`` in the spool directory and its segment
    store, ``.tmp`` files included."""
    out = []
    for d in (spool, os.path.join(spool, "result-segments")):
        if os.path.isdir(d):
            out += [f for f in os.listdir(d) if f.startswith(query_id + ".")]
    return sorted(out)


def fte_execute(coord, props, sql, device, spool, what, cap=None, label=None):
    """(rows, wall, query, deltas) of one statement through the coordinator:
    no file of the query left in the spool, no failed adaptive rule, the
    merge launches counted from 0 and the spool counters' deltas."""
    from trino_tpu_torch.client.remote import StatementClient
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.ops import merge

    client = StatementClient(coord.base_url, {k: str(v) for k, v in props.items()})
    merge.launches = 0
    c0 = (M.SPOOL_READS.value(), M.SPOOL_BYTES.value(), M.EXCHANGE_BYTES.value())
    if cap is not None:
        cap.now = label
    try:
        sync(device)
        t0 = time.perf_counter()
        _cols, rows = client.execute(sql, timeout=600.0)
        sync(device)
        wall = time.perf_counter() - t0
    finally:
        if cap is not None:
            cap.now = None
    q = coord.get_query(client.query_id)
    adapt_failures(q, what)
    left = spool_files(spool, q.query_id)
    if left:
        raise AssertionError(f"{what}: files of the query left in the spool: {left}")
    d = {"merge_launches": merge.launches, "spool_reads": M.SPOOL_READS.value() - c0[0],
         "spool_bytes": M.SPOOL_BYTES.value() - c0[1],
         "exchange_bytes": M.EXCHANGE_BYTES.value() - c0[2]}
    return rows, wall, q, d, client


def fte_stage(coord, props, sql, partitioning):
    """The id of the first fragment of ``sql``'s distributed plan with that
    partitioning (source or hash)."""
    from trino_tpu_torch.exec.query import plan_sql
    from trino_tpu_torch.sql.planner.fragmenter import fragment_plan

    session = coord.session_factory({k: str(v) for k, v in props.items()})
    frags = fragment_plan(plan_sql(session, sql), session)
    return next(f.id for f in frags if f.partitioning == partitioning)


def fte_retry(coord, props, q, entry, partitioning, device, spool):
    """``entry``'s query with its first attempt of slot 0 of a stage of
    ``partitioning`` failing: the expected rows, that attempt the one retry
    (a CUDA error would be another), the winner's attempt 1."""
    fid = fte_stage(coord, props, entry["sql"], partitioning)
    key = f".{fid}.0.a0"
    rows, wall, ex, d, _c = fte_execute(coord, {**props, "failure_injection": key}, entry["sql"],
                                        device, spool, f"Q{q} (fte retry {key})")
    check_rows(f"Q{q} (fte, retried {partitioning} stage)", rows, entry["rows"],
               rel_tol=DIST_REL_TOL)
    slot = f"{ex.query_id}.{fid}.0"
    if ex.retried_tasks != [slot + ".a0"] or ex.task_attempts.get(slot + ".a1") != 1:
        raise AssertionError(f"Q{q} (fte retry): retried {ex.retried_tasks}, attempts "
                             f"{ex.task_attempts}")
    return {"query": f"Q{q}", "stage": partitioning, "key": key, "wall_s": wall,
            "retried": [t.replace(ex.query_id, "<q>") for t in ex.retried_tasks]}


def fte_read_back(coord, workers, props, entry, device, spool):
    """A consumer reads finished producers' outputs from the spool after
    their tasks are gone from the workers: Q1's source stage runs under the
    tier through the task seam, its tasks are deleted (404), and the root
    fragment's gather reads the spool files (``SPOOL_READS`` up by each,
    ``EXCHANGE_BYTES`` not counting them) and gives Q1's rows."""
    from trino_tpu_torch.exec.query import plan_sql
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.server import wire
    from trino_tpu_torch.server.coordinator import QueryExecution
    from trino_tpu_torch.sql.planner import plan as P
    from trino_tpu_torch.sql.planner.fragmenter import RemoteSourceNode, fragment_plan

    props = {k: str(v) for k, v in props.items()}
    q = QueryExecution(f"fteread{time.time_ns() & 0xFFFFFF:x}", "", dict(props), coord.registry,
                       coord.session_factory)
    session = coord.session_factory(dict(props))
    fragments = fragment_plan(plan_sql(session, entry["sql"]), session)
    workers_alive = coord.registry.alive()
    counts = {node.fragment_id: (len(workers_alive) if f.partitioning in ("source", "hash")
                                 else 1)
              for f in fragments for node in P.walk_plan(f.root)
              if isinstance(node, RemoteSourceNode)}
    q.fragments = fragments
    try:
        for frag in fragments:
            q._schedule_fragment(session, frag, workers_alive, counts, fte=True)
        producers = [loc for locs in q.fragment_tasks.values() for loc in locs]
        for loc in producers:
            q._cancel_attempt(loc)
            status = wire.http_request("GET", f"{loc.base_url}/v1/task/{loc.task_id}/status",
                                       timeout=10.0)[0]
            if status != 404:
                raise AssertionError(f"fte read-back: task {loc.task_id} still answers {status}")
        root_inputs = {node.fragment_id for node in P.walk_plan(fragments[-1].root)
                       if isinstance(node, RemoteSourceNode)}
        c0 = (M.SPOOL_READS.value(), M.SPOOL_BYTES.value(), M.EXCHANGE_BYTES.value())
        rows = jsonable_rows(q._run_root_fragment(session, fragments).to_pylist())
        reads = M.SPOOL_READS.value() - c0[0]
        nbytes = M.SPOOL_BYTES.value() - c0[1]
        exch = M.EXCHANGE_BYTES.value() - c0[2]
    finally:
        q._cancel_tasks()
        q._cleanup_spool()
    check_rows("Q1 (fte read-back)", rows, entry["rows"], rel_tol=DIST_REL_TOL)
    want_reads = sum(len(q.fragment_tasks[fid]) for fid in root_inputs)
    if reads != want_reads or nbytes <= 0 or exch != 0:
        raise AssertionError(f"fte read-back: {reads} spool reads (want {want_reads}), "
                             f"{nbytes} spool bytes, {exch} exchange bytes")
    if spool_files(spool, q.query_id):
        raise AssertionError(f"fte read-back: files left {spool_files(spool, q.query_id)}")
    return {"spool_reads": reads, "spool_bytes": nbytes, "exchange_bytes": exch}


def fte_spooled(coord, workers, props, schema, sql, check_sql, mode, device, spool, what):
    """One spooled SELECT fetched by a StatementClient: its mode, at least
    ``FTE_MIN_SEGMENTS`` segments (the export), the row count and column
    sums equal an eager Session's, every segment acked (no bytes held), the
    flow ledger's spool-write and segment-fetch bytes equal the segment
    counters' deltas, and a segment-fetch phase in the timeline."""
    from trino_tpu_torch.client.session import Session
    from trino_tpu_torch.obs import metrics as M

    w0 = (M.RESULT_SEGMENT_BYTES.value("written"), M.RESULT_SEGMENT_BYTES.value("served"))
    rows, wall, q, _d, client = fte_execute(coord, props, sql, device, spool, what)
    written = M.RESULT_SEGMENT_BYTES.value("written") - w0[0]
    served = M.RESULT_SEGMENT_BYTES.value("served") - w0[1]
    if client.stats["spooled"] != mode or q.spooled != mode:
        raise AssertionError(f"{what}: spooled {client.stats['spooled']}, want {mode}")
    segments = len(q.result_segments)
    if mode == "worker-direct" and segments < FTE_MIN_SEGMENTS[schema]:
        raise AssertionError(f"{what}: {segments} segments")
    (want,) = Session({"catalog": "tpch", "schema": schema}, device=device).execute(
        check_sql).rows
    got = [len(rows)] + [sum(r[i] for r in rows) for i in range(len(want) - 1)]
    if got != [int(v) for v in want]:
        raise AssertionError(f"{what}: count and sums {got}, the eager session's {list(want)}")
    if mode == "coordinator" and any(rows[i][0] >= rows[i + 1][0] for i in range(len(rows) - 1)):
        raise AssertionError(f"{what}: rows out of order")
    held = [w.segments.held_bytes() for w in workers] + [coord.segments.held_bytes()]
    if any(held):
        raise AssertionError(f"{what}: segment bytes still held after the acks: {held}")
    flows = {}
    for r in q.flows_dict()["transfers"]:
        flows[r["link"]] = flows.get(r["link"], 0) + r["bytes"]
    if flows.get("spool-write", 0) != written or flows.get("segment-fetch", 0) != served or \
            written != served or written != sum(e["bytes"] for e in q.result_segments):
        raise AssertionError(f"{what}: /flows spool-write {flows.get('spool-write')} and "
                             f"segment-fetch {flows.get('segment-fetch')}, counters written "
                             f"{written} served {served}")
    tl = q.timeline_dict()
    if not tl["phases"].get("segment-fetch", 0) > 0:
        raise AssertionError(f"{what}: no segment-fetch phase in {tl['phases']}")
    return {"wall_s": wall, "rows": len(rows), "segments": segments, "bytes": written,
            "fetch_s": client.segment_fetch_s,
            "fetch_mb_s": client.spooled_bytes / client.segment_fetch_s / 1e6
            if client.segment_fetch_s > 0 else None,
            "segment_fetch_phase_s": tl["phases"]["segment-fetch"]}


def fte_ranges(coord, props, sql):
    """``Range`` on a worker's segment: 206 with the same bytes as a whole
    GET, 416 past the end; then every segment acked."""
    from trino_tpu_torch.server import wire

    q = coord.submit(sql, {k: str(v) for k, v in props.items()})
    if q.state.wait_for_terminal(600.0) != "FINISHED" or not q.result_segments:
        raise AssertionError(f"fte ranges: {q.state.get()} {q.failure}")
    try:
        seg = q.result_segments[0]
        status, full, _h = wire.http_request("GET", seg["uri"], timeout=60.0)
        s206, part, h206 = wire.http_request("GET", seg["uri"], timeout=60.0,
                                             headers={"Range": "bytes=4-1027"})
        s416, _b, _h = wire.http_request("GET", seg["uri"], timeout=60.0,
                                         headers={"Range": f"bytes={seg['bytes']}-"})
    finally:
        for e in q.result_segments:
            wire.http_request("DELETE", e["ackUri"], timeout=10.0)
    if (status, len(full), s206, part, s416) != (200, seg["bytes"], 206, full[4:1028], 416) or \
            h206.get("Content-Range") != f"bytes 4-1027/{seg['bytes']}":
        raise AssertionError(f"fte ranges: {status} {len(full)}/{seg['bytes']}, {s206} "
                             f"{h206.get('Content-Range')}, {s416}")
    return {"segments": len(q.result_segments), "statuses": [status, s206, s416]}


def settled_allocated(device):
    """``torch.cuda.memory_allocated`` once the frees deferred behind a side
    stream have landed: a tensor staged on the pinned copy's stream
    (``record_stream``) is returned to the allocator only when it next
    allocates and finds that stream's work done."""
    import torch

    sync(device)
    torch.empty((1,), device=device)
    return torch.cuda.memory_allocated(device)


def phase_fte(device, expected, plane, cap, card, dist_walls, schema="sf1", extra_props=None):
    """The fault-tolerant tier and the spooled result protocol on a port
    coordinator with two in-process workers, with TRINO_TPU_SPOOL_DIR a
    fresh directory. ``extra_props``: session properties of every query (the
    CPU test's plan shapes at tiny)."""
    import shutil
    import tempfile

    import torch

    from trino_tpu_torch.devcache import DEVICE_CACHE
    from trino_tpu_torch.server import wire
    from trino_tpu_torch.server.coordinator import QueryExecution

    t_phase = time.perf_counter()
    spool = tempfile.mkdtemp(prefix="trino-tpu-spool-")
    old_spool = os.environ.get("TRINO_TPU_SPOOL_DIR")
    os.environ["TRINO_TPU_SPOOL_DIR"] = spool  # before the servers: their segment stores
    cuda = device.type == "cuda"
    coord = workers = None
    out = {"card": card, "launches": 0}
    try:
        coord, workers = serving_cluster(device, 2, "fw")
        base = {**serving_props(schema), **(extra_props or {})}
        fte = {**base, "retry_policy": "TASK"}
        mem0 = (settled_allocated(device), DEVICE_CACHE.cached_bytes()) if cuda else None
        # the four queries under the tier, rows as expected
        walls = {}
        for q in FTE_QUERIES:
            entry = expected[str(q)]
            for label in FTE_RUNS:
                rows, wall, ex, d, _c = fte_execute(coord, fte, entry["sql"], device, spool,
                                                    f"Q{q} (fte, {label})")
                check_rows(f"Q{q} (fte, {label})", rows, entry["rows"], rel_tol=DIST_REL_TOL)
                if ex.fast_path != "distributed" or ex.retried_tasks or d["spool_reads"] < 1:
                    raise AssertionError(f"Q{q} (fte, {label}): path {ex.fast_path}, retried "
                                         f"{ex.retried_tasks}, spool reads {d['spool_reads']}")
                walls[f"Q{q}_{label}_s"] = wall
                out.setdefault("spool", {})[f"Q{q}_{label}"] = {
                    "reads": d["spool_reads"], "bytes": d["spool_bytes"],
                    "exchange_bytes": d["exchange_bytes"]}
        out["walls"] = walls
        if cuda:
            mem_clean = (settled_allocated(device), DEVICE_CACHE.cached_bytes())
        out["walls_vs_distributed"] = {
            f"Q{q}": {"fte_warm_s": walls[f"Q{q}_{FTE_RUNS[-1]}_s"],
                      "distributed_warm_s": (dist_walls or {}).get(q)} for q in FTE_QUERIES}
        # retries: the first attempt of one hash-stage task of Q3, and of one
        # source-stage task of Q18
        out["retries"] = [fte_retry(coord, fte, 3, expected["3"], "hash", device, spool),
                          fte_retry(coord, fte, 18, expected["18"], "source", device, spool)]
        if cuda:
            # the failed, retried and finished attempts keep no tensor: the
            # card holds what it held at the phase's start (and after the
            # same queries ran clean), but for the device cache's growth
            mem1 = (settled_allocated(device), DEVICE_CACHE.cached_bytes())
            if max(mem1[0] - mem0[0], mem1[0] - mem_clean[0]) > max(0, mem1[1] - mem0[1]):
                raise AssertionError(f"fte: memory_allocated {mem0[0]} at the start, "
                                     f"{mem_clean[0]} after the clean runs, {mem1[0]} after "
                                     f"the retries; device cache {mem_clean[1]} -> {mem1[1]}")
            out["memory_allocated"] = {"start": mem0[0], "clean": mem_clean[0],
                                       "after_retries": mem1[0]}
        if any(w.tasks.query_memory() for w in workers):
            raise AssertionError(f"fte: reservations left {[w.tasks.query_memory() for w in workers]}")
        # retries run out: every attempt of slot 0 of Q1's source stage fails
        from trino_tpu_torch.client.remote import RemoteQueryError, StatementClient

        client = StatementClient(coord.base_url, {**fte, "failure_injection": ".0.0.a"})
        try:
            client.execute(expected["1"]["sql"], timeout=600.0)
            raise AssertionError("fte: Q1 with every attempt failing finished")
        except RemoteQueryError as e:
            if "failed after 3 attempts" not in str(e):
                raise
        ex = coord.get_query(client.query_id)
        if spool_files(spool, ex.query_id) or ex.retried_tasks != [
                f"{ex.query_id}.0.0.a{i}" for i in range(3)]:
            raise AssertionError(f"fte: out of attempts, retried {ex.retried_tasks}, files "
                                 f"{spool_files(spool, ex.query_id)}")
        out["out_of_attempts"] = str(ex.failure).split("\n")[0]
        # the spool read-back of gone producers
        out["read_back"] = fte_read_back(coord, workers, base, expected["1"], device, spool)
        # speculation: slot 0's first attempt of Q1's source stage sleeps
        saved = (QueryExecution.SPECULATION_MIN_S, QueryExecution.SPECULATION_FACTOR)
        QueryExecution.SPECULATION_MIN_S, QueryExecution.SPECULATION_FACTOR = FTE_SPECULATION
        try:
            rows, wall, ex, _d, _c = fte_execute(
                coord, {**fte, "slow_injection": f".0.0.a0:{FTE_SLOW_S}"}, expected["1"]["sql"],
                device, spool, "Q1 (fte, speculation)")
        finally:
            QueryExecution.SPECULATION_MIN_S, QueryExecution.SPECULATION_FACTOR = saved
        check_rows("Q1 (fte, speculation)", rows, expected["1"]["rows"], rel_tol=DIST_REL_TOL)
        loser = f"{ex.query_id}.0.0.a0"
        statuses = {w.base_url: wire.http_request("GET", f"{w.base_url}/v1/task/{loser}/status",
                                                  timeout=10.0)[0] for w in workers}
        if wall > FTE_SLOW_S / 2 or f"{ex.query_id}.0.0.a1" not in ex.speculation_history or \
                ex.speculative_tasks or set(statuses.values()) != {404}:
            raise AssertionError(f"fte speculation: wall {wall}, history "
                                 f"{list(ex.speculation_history)}, in flight "
                                 f"{ex.speculative_tasks}, the loser's statuses {statuses}")
        out["speculation"] = {"wall_s": wall, "history": [
            t.replace(ex.query_id, "<q>") for t in ex.speculation_history]}
        # skew salting through the scheduler
        skew = {**fte, **ADAPTIVE_SKEW_PROPS}
        off, off_s, _q, _d, _c = fte_execute(coord, {**skew, "adaptive_execution_enabled": "false"},
                                             ADAPTIVE_SKEW_SQL, device, spool,
                                             "hot-key join (fte, adaptation off)")
        rows, wall, ex, _d, _c = fte_execute(coord, skew, ADAPTIVE_SKEW_SQL, device, spool,
                                             "hot-key join (fte)")
        check_rows("hot-key join (fte, salted)", rows, off)
        changes = [c for c in ex.plan_versions if c["rule"] == "skew-mitigation"]
        if len(changes) != 1:
            raise AssertionError(f"fte hot-key join: plan changes {ex.plan_versions}")
        detail = changes[0]["detail"]
        pr, hot = detail["probePartitionRows"], detail["hotPartitions"]
        if len(hot) != 1 or pr[hot[0]] <= 4 * (sum(pr) - pr[hot[0]]):
            raise AssertionError(f"fte hot-key join: hot {hot} of probe rows {pr}")
        spread = [sum(col) for col in zip(*(
            e["stats"]["partitionRows"] for e in ex.task_stats.values()
            if e["fragment"] == changes[0]["newFragments"][0] and e["state"] == "FINISHED"))]
        out["skew"] = {"off_wall_s": off_s, "wall_s": wall, "hot": hot,
                       "probe_partition_rows": pr, "salted_probe_partition_rows": spread}
        # spooled results: worker-direct, then the coordinator's store
        spooled = {**base, "spooled_results_enabled": "true",
                   "spooled_results_threshold_bytes": "1",
                   "spooled_results_segment_bytes": str(FTE_SEGMENT_BYTES[schema])}
        out["worker_direct"] = fte_spooled(coord, workers, spooled, schema, FTE_EXPORT_SQL,
                                           FTE_EXPORT_CHECK, "worker-direct", device, spool,
                                           "export (worker-direct)")
        out["ranges"] = fte_ranges(coord, spooled, FTE_EXPORT_SQL)
        out["coordinator"] = fte_spooled(coord, workers, spooled, schema, FTE_SORTED_SQL,
                                         FTE_SORTED_CHECK, "coordinator", device, spool,
                                         "sorted (coordinator)")
        # the kernel on this path: the cached Q18 joined with a row of
        # system.runtime.nodes runs on the coordinator's executor and spools
        # into the coordinator's store
        kprops = {**spooled, "device_cache_enabled": "true"}
        sql = observe_gated(expected["18"]["sql"], 18, "fw0")
        kernel = {}
        for label in ("cold", "warm"):
            rows, wall, ex, d, client = fte_execute(coord, kprops, sql, device, spool,
                                                    f"Q18 (fte, spooled, {label})", cap,
                                                    ("fte", 18, label))
            check_rows(f"Q18 (fte, spooled, {label})", rows, expected["18"]["rows"],
                       rel_tol=DIST_REL_TOL)
            if ex.fast_path != "local-catalog" or ex.spooled != "coordinator":
                raise AssertionError(f"Q18 (fte, spooled): {ex.fast_path}, {ex.spooled}")
            if cuda and d["merge_launches"] < 1:
                raise AssertionError(f"Q18 (fte, spooled, {label}): no merge launch")
            out["launches"] += d["merge_launches"]
            kernel[label] = {"wall_s": wall, "merge_launches": d["merge_launches"],
                             "segments": len(ex.result_segments)}
        out["kernel"] = kernel
    finally:
        if cap is not None:
            cap.now = None
        if coord is not None:
            serving_stop(coord, workers)
        if old_spool is None:
            os.environ.pop("TRINO_TPU_SPOOL_DIR", None)
        else:
            os.environ["TRINO_TPU_SPOOL_DIR"] = old_spool
        shutil.rmtree(spool, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print("fte", json.dumps(out, default=str), flush=True)
    return out


# phase procplane: the executor-process plane on the card. The routed
# statements are single-stage plans a child can own (the fast path; at SF1
# lineitem's 6M rows need the scan guard and the gather threshold raised so
# Q1's final aggregation is not hash-distributed); Q3 needs workers and
# bounces to the dispatch lane
PROCPLANE_POINT = "select o_orderkey, o_totalprice from orders where o_orderkey = 7"
PROCPLANE_PREPARED = "select o_orderkey, o_totalprice from orders where o_orderkey = ?"
PROCPLANE_KEYS = (7, 32)
PROCPLANE_CLIENTS = 16
PROCPLANE_LANES = 8
PROCPLANE_PROCESSES = 2
PROCPLANE_NOT_PLANNED = ("parse", "analyze/plan", "optimize")


def procplane_props(schema, **extra):
    """The statement protocol's session properties of phase procplane."""
    return {"catalog": "tpch", "schema": schema, "fused_join_pallas": "true",
            "short_query_fast_path": "true", "fast_path_max_scan_rows": "8000000",
            "gather_max_rows_per_device": "8000000", **extra}


def procplane_queries(expected):
    """(name, sql) of the phase: the point lookup, Q1 and Q6, which route
    to a child, and Q3, which bounces."""
    return [("point", PROCPLANE_POINT), ("Q1", expected["1"]["sql"]),
            ("Q6", expected["6"]["sql"]), ("Q3", expected["3"]["sql"])]


def plane_counts():
    from trino_tpu_torch.obs import metrics as M

    return {k: M.EXECUTOR_PLANE_QUERIES.value(k) for k in ("process", "inline", "bounced")}


def plane_delta(before, what, want):
    got = {k: v - before[k] for k, v in plane_counts().items()}
    if got != want:
        raise AssertionError(f"procplane: {what}: executor-plane queries {got} != {want}")


def procplane_run(coord, props, sql, device, user="procplane"):
    """(rows, wall, query) of one statement through the statement protocol."""
    from trino_tpu_torch.client.remote import StatementClient

    client = StatementClient(coord.base_url, props, user=user)
    sync(device)
    t0 = time.perf_counter()
    _cols, rows = client.execute(sql, timeout=600.0)
    sync(device)
    return rows, time.perf_counter() - t0, coord.get_query(client.query_id)


def child_elapsed_s(q):
    """The child's own wall of a forwarded query (its synthetic task slot)."""
    (entry,) = [e for k, e in q.task_stats.items() if ".proc" in k]
    return float(entry["stats"]["elapsedS"])


def compute_apps():
    """The lines of ``nvidia-smi --query-compute-apps=pid,used_memory``: one
    a process that holds a context on the card. (In a container whose pid
    namespace is not the one nvidia-smi reads, every line names pid 1.)"""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def nvidia_fds(pid):
    """The NVIDIA device files process ``pid`` holds open (a CUDA context
    holds ``/dev/nvidia<N>``)."""
    base = f"/proc/{pid}/fd"
    found = set()
    try:
        for fd in os.listdir(base):
            try:
                target = os.readlink(os.path.join(base, fd))
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                found.add(target)
    except OSError:
        pass
    return sorted(found)


def procplane_concurrency(coord, props, sql, want, device):
    """PROCPLANE_CLIENTS concurrent clients, one user each, of one query:
    wall, p50 and p99 of their latencies, and the planes that ran them."""
    import statistics
    import threading

    lat, errors, planes = [], [], []
    start = threading.Barrier(PROCPLANE_CLIENTS + 1)

    def client(i):
        start.wait()
        try:
            rows, wall, q = procplane_run(coord, props, sql, device, user=f"procplane-{i}")
            check_rows(f"procplane concurrency client {i}", rows, want, rel_tol=DIST_REL_TOL)
            lat.append(wall)
            planes.append(q.plane)
        except Exception as e:  # noqa: BLE001 — the assertion below
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,), name=f"procplane-client-{i}")
               for i in range(PROCPLANE_CLIENTS)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"procplane concurrency: {errors[:3]}")
    lat.sort()
    return {"clients": PROCPLANE_CLIENTS, "wall_s": wall, "p50_s": statistics.median(lat),
            "p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))], "max_s": lat[-1],
            "planes": sorted(set(planes))}


def routed_planes(routed):
    return {r["plane"] for r in routed.values()}


def phase_procplane(device, expected, procexp, card, schema="sf1"):
    """A port coordinator with the executor-process plane (two children on
    the coordinator's device) and two in-process workers: the point lookup,
    Q1 and Q6 routed to the children cold and warm, with the reference's
    rows; Q3 bounced to the dispatch lane; a memory table and a cached Q6
    kept on the dispatch side; PREPARE, EXECUTE twice and DEALLOCATE; the
    children's contexts on the card; the same walls and a 16-client storm
    of Q6 against a thread-plane coordinator at the same lanes; no child
    left 10 s after ``stop()``. ``procexp``: the point rows by key."""
    import torch

    from trino_tpu_torch.client.remote import RemoteQueryError, StatementClient
    from trino_tpu_torch.ops import merge

    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    props = procplane_props(schema)
    queries = dict(procplane_queries(expected))
    want = {"point": procexp["rows"][str(PROCPLANE_KEYS[0])], "Q1": expected["1"]["rows"],
            "Q6": expected["6"]["rows"], "Q3": expected["3"]["rows"]}
    out = {"card": card, "launches": 0,
           "not_run": "the view replication and the filesystem DML case need pyarrow, which "
                      "this machine lacks; tests/test_torch_matview.py and "
                      "tests/test_torch_process_plane.py hold them on the CPU"}
    merge.launches = 0
    free0 = torch.cuda.mem_get_info(device)[0] if cuda else None
    coord, workers = serving_cluster(device, 2, "pp", executor_plane="process",
                                     executor_processes=PROCPLANE_PROCESSES,
                                     executor_lanes=PROCPLANE_LANES)
    plane = coord.dispatcher.process_plane
    stopped = False
    try:
        if plane.device != str(device):
            raise AssertionError(f"procplane: children on {plane.device}, not {device}")
        t0 = time.perf_counter()
        plane._ensure_children()  # the boot, apart from the first query's wall
        out["boot_s"] = time.perf_counter() - t0
        pids = plane.children_pids()
        # routed, cold and warm: every run on a child. The dispatch process
        # touches the card in none of them, so the card's free bytes fall by
        # what the child that ran it took (its context at its first query,
        # then its allocator's blocks)
        c0 = plane_counts()
        routed = {}
        grown = {}
        free = free0
        for name in ("point", "Q1", "Q6"):
            for label in ("cold", "warm"):
                rows, wall, q = procplane_run(coord, props, queries[name], device)
                if cuda:
                    now = torch.cuda.mem_get_info(device)[0]
                    grown[q.plane] = grown.get(q.plane, 0) + free - now
                    free = now
                check_rows(f"{name} (procplane, {label})", rows, want[name],
                           rel_tol=DIST_REL_TOL)
                if not q.plane.startswith("executor-process:") or q.fast_path != "fast-path":
                    raise AssertionError(f"{name} (procplane, {label}) ran on {q.plane} "
                                         f"({q.fast_path}), not on an executor process")
                child_s = child_elapsed_s(q)
                routed[f"{name}_{label}"] = {"plane": q.plane, "wall_s": wall,
                                             "child_elapsed_s": child_s,
                                             "forward_overhead_s": wall - child_s}
        plane_delta(c0, "routed", {"process": 6, "inline": 0, "bounced": 0})
        out["routed"] = routed
        out["free_after_warm_bytes"] = torch.cuda.mem_get_info(device)[0] if cuda else None
        # bounced: Q3 needs workers, which a child has not
        c0 = plane_counts()
        rows, wall, q = procplane_run(coord, props, queries["Q3"], device)
        check_rows("Q3 (procplane, bounced)", rows, want["Q3"], rel_tol=DIST_REL_TOL)
        bounced = [sp for sp in q.tracer.spans()
                   if sp.name == "dispatch/forward" and sp.attributes.get("bounced")]
        if q.plane != "dispatch-lane" or q.fast_path != "distributed" or not bounced:
            raise AssertionError(f"Q3 (procplane): {q.plane}, {q.fast_path}, bounce spans "
                                 f"{len(bounced)}: not bounced to the dispatch lane")
        plane_delta(c0, "Q3", {"process": 1, "inline": 0, "bounced": 1})
        out["bounced_q3_wall_s"] = wall
        # the dispatch side: a memory table, a query on the device cache
        c0 = plane_counts()
        procplane_run(coord, props, "create table memory.default.procplane as "
                                    "select n_nationkey, n_name from nation", device)
        rows, _w, q = procplane_run(coord, props, "select count(*) from memory.default.procplane",
                                    device)
        check_rows("memory table (procplane)", rows, [[25]])
        planes = [q.plane]
        rows, _w, q = procplane_run(coord, {**props, "device_cache_enabled": "true"},
                                    queries["Q6"], device)
        check_rows("Q6 cached (procplane)", rows, want["Q6"], rel_tol=DIST_REL_TOL)
        planes.append(q.plane)
        if planes != ["dispatch-lane", "dispatch-lane"]:
            raise AssertionError(f"procplane: dispatch-side statements ran on {planes}")
        plane_delta(c0, "dispatch side", {"process": 0, "inline": 3, "bounced": 0})
        # prepared statements: the second EXECUTE plans nothing in its child
        c0 = plane_counts()
        client = StatementClient(coord.base_url, props, user="procplane")
        client.execute(f"PREPARE procplane_point FROM {PROCPLANE_PREPARED}", timeout=600.0)
        executes = []
        for key in PROCPLANE_KEYS:
            _c, rows = client.execute(f"EXECUTE procplane_point USING {key}", timeout=600.0)
            check_rows(f"EXECUTE USING {key} (procplane)", rows, procexp["rows"][str(key)])
            executes.append(coord.get_query(client.query_id))
        names = {s["name"] for s in executes[1].extra_spans}
        if (not all(q.plane.startswith("executor-process:") for q in executes)
                or "plan-cache/hit" not in names or names & set(PROCPLANE_NOT_PLANNED)):
            raise AssertionError(f"procplane: EXECUTE on {[q.plane for q in executes]}, child "
                                 f"spans {sorted(names)}")
        client.execute("DEALLOCATE PREPARE procplane_point", timeout=600.0)
        try:
            client.execute("EXECUTE procplane_point USING 7", timeout=600.0)
        except RemoteQueryError as e:
            if "prepared statement not found" not in str(e):
                raise
        else:
            raise AssertionError("procplane: EXECUTE after DEALLOCATE succeeded")
        plane_delta(c0, "prepared", {"process": 3, "inline": 2, "bounced": 0})
        # a child the routed statements missed runs Q6 once on its own (as
        # a user that the routing sends there), so each child's context and
        # first allocations are measured apart
        c0 = plane_counts()
        storm = {**props, "result_cache_enabled": "false"}
        for i in range(PROCPLANE_PROCESSES):
            if f"executor-process:{i}" in routed_planes(routed):
                continue
            user = next(f"procplane-{u}" for u in range(64) if plane.child_for(plane.route_key(
                types.SimpleNamespace(sql=queries["Q6"], user=f"procplane-{u}",
                                      session_properties=storm)))["index"] == i)
            free = torch.cuda.mem_get_info(device)[0] if cuda else None
            rows, _w, q = procplane_run(coord, storm, queries["Q6"], device, user=user)
            check_rows(f"Q6 (procplane, {user})", rows, want["Q6"], rel_tol=DIST_REL_TOL)
            if q.plane != f"executor-process:{i}":
                raise AssertionError(f"procplane: {user}'s Q6 ran on {q.plane}, not child {i}")
            if cuda:
                grown[q.plane] = free - torch.cuda.mem_get_info(device)[0]
        # 16 clients of Q6, one user each (sticky by user: both children),
        # twice: the first storm grows the children's allocators
        free = torch.cuda.mem_get_info(device)[0] if cuda else None
        storms = [procplane_concurrency(coord, storm, queries["Q6"], want["Q6"], device)
                  for _ in range(2)]
        if cuda:
            out["storms_growth_bytes"] = free - torch.cuda.mem_get_info(device)[0]
        out["concurrency_process"] = storms
        plane_delta(c0, "concurrency", {
            "process": 2 * PROCPLANE_CLIENTS + PROCPLANE_PROCESSES - len(routed_planes(routed)),
            "inline": 0, "bounced": 0})
        if any(len(st["planes"]) != PROCPLANE_PROCESSES for st in storms):
            raise AssertionError(f"procplane: the storms ran on {[st['planes'] for st in storms]}")
        # the children hold their own contexts on the card: nvidia-smi lists
        # a context for this process and one for each child, and each child
        # holds the card's device file open
        if cuda:
            apps = compute_apps()
            fds = {str(p): nvidia_fds(p) for p in pids}
            out["compute_apps"] = apps
            out["child_nvidia_fds"] = fds
            if len(apps) != 1 + len(pids) or not all(
                    any(re.fullmatch(r"/dev/nvidia\d+", f) for f in held)
                    for held in fds.values()):
                raise AssertionError(f"procplane: nvidia-smi lists {len(apps)} contexts, not "
                                     f"this process's and {len(pids)} children's ({apps}), "
                                     f"or a child holds no card open ({fds})")
            out["child_growth_bytes"] = grown
            out["free_before_boot_bytes"] = free0
            free_before_stop = torch.cuda.mem_get_info(device)[0]
        t0 = time.perf_counter()
        serving_stop(coord, workers)
        stopped = True
        out["stop_s"] = time.perf_counter() - t0
        deadline = time.monotonic() + 10.0
        alive = list(pids)
        while alive and time.monotonic() < deadline:
            alive = [p for p in alive if pid_alive(p)]
            time.sleep(0.05)
        if alive:
            raise AssertionError(f"procplane: child pids {alive} alive 10 s after stop()")
        if cuda:
            # what the children held, back on the card once they ended
            out["children_released_bytes"] = \
                torch.cuda.mem_get_info(device)[0] - free_before_stop
            out["compute_apps_after_stop"] = compute_apps()
    finally:
        if not stopped:
            serving_stop(coord, workers)
    # the same queries through a thread-plane coordinator at the same lanes
    coord, workers = serving_cluster(device, 0, "pt", executor_lanes=PROCPLANE_LANES)
    try:
        thread = {}
        for name in ("point", "Q1", "Q6"):
            for label in ("cold", "warm"):
                rows, wall, q = procplane_run(coord, props, queries[name], device)
                check_rows(f"{name} (thread plane, {label})", rows, want[name],
                           rel_tol=DIST_REL_TOL)
                thread[f"{name}_{label}"] = {"plane": q.plane, "wall_s": wall}
        out["thread_plane"] = thread
        out["concurrency_thread"] = [procplane_concurrency(coord, storm, queries["Q6"],
                                                           want["Q6"], device)
                                     for _ in range(2)]
    finally:
        serving_stop(coord, workers)
    out["launches"] = merge.launches
    out["phase_s"] = time.perf_counter() - t_phase
    print("procplane", json.dumps(out), flush=True)
    return out


def pid_alive(pid):
    """Whether ``pid`` names a live process (a zombie counts as ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def check_random(session, device):
    """random() over every lineitem row at SF1, drawn on the card from the
    session's generator."""
    gen = session.generator
    state = gen.get_state().clone()
    (n,) = session.execute("select count(*) from lineitem").rows[0]
    t0 = time.perf_counter()
    (row,) = session.execute(
        "select count(*), min(r), max(r), avg(r) from (select random() as r from lineitem)").rows
    wall = time.perf_counter() - t0
    count, lo, hi, mean = row
    drew = not bool((gen.get_state() == state).all())
    line = {"rows": count, "min": lo, "max": hi, "mean": mean, "wall_s": wall,
            "generator_device": str(gen.device), "generator_advanced": drew}
    print("scalar_random", json.dumps(line), flush=True)
    if count != n or not 0.0 <= lo <= hi < 1.0 or abs(mean - 0.5) > 0.001 \
            or gen.device.type != "cuda" or device.type != "cuda" or not drew:
        raise AssertionError(f"random() over lineitem: {line} (want {n} rows in [0, 1), the "
                             f"mean within 0.001 of 0.5, drawn by the session's CUDA generator)")
    return line


def lowered_on(device, name, *arrays):
    """The port's lowering of ``name`` over float64 columns on ``device``,
    back on the host."""
    import torch

    from trino_tpu_torch import types as T
    from trino_tpu_torch.data.page import Column
    from trino_tpu_torch.ops import expr_lower as L
    from trino_tpu_torch.sql import ir

    cols = [Column(T.DOUBLE, torch.from_numpy(a).to(device)) for a in arrays]
    call = ir.Call(T.DOUBLE, name, tuple(ir.ColumnRef(T.DOUBLE, i, f"c{i}")
                                         for i in range(len(arrays))))
    return L.lower(call, L.LowerCtx(cols, len(arrays[0]), None, device)).vals.cpu().numpy()


def check_transcendentals(device):
    """log10 of every power of ten from 1e-300 to 1e300 exact, and each
    transcendental function on a seeded sample within SCALAR_REL_TOL of
    numpy on the host."""
    import numpy as np
    import torch

    ks = np.arange(-300, 301)
    tens = np.array([float(f"1e{k}") for k in ks])
    raw = torch.log10(torch.from_numpy(tens).to(device)).cpu().numpy()
    got = lowered_on(device, "log10", tens)
    bad = ks[got != ks].tolist()
    line = {"log10_powers": len(ks), "raw_torch_log10_inexact": int((raw != ks).sum()),
            "raw_inexact_k": ks[raw != ks].tolist()[:12], "port_inexact_k": bad}
    rng = np.random.default_rng(2026)
    n = 1 << 16
    wide = rng.normal(0.0, 10.0, n)
    unit = rng.uniform(-1.0, 1.0, n)
    pos = rng.lognormal(0.0, 20.0, n)
    cases = {"sin": (np.sin, wide), "cos": (np.cos, wide), "tan": (np.tan, wide),
             "asin": (np.arcsin, unit), "acos": (np.arccos, unit), "atan": (np.arctan, wide),
             "sinh": (np.sinh, unit * 20), "cosh": (np.cosh, unit * 20), "tanh": (np.tanh, unit),
             "cbrt": (np.cbrt, wide * 1e3), "log2": (np.log2, pos), "log10": (np.log10, pos),
             "ln": (np.log, pos), "exp": (np.exp, unit * 50), "degrees": (np.degrees, wide),
             "radians": (np.radians, wide), "sqrt": (np.sqrt, pos)}
    worst = {}
    for fn, (ref, x) in cases.items():
        g, w = lowered_on(device, fn, x), ref(x)
        worst[fn] = float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-300)))
    for fn, ref, a, b in (("atan2", np.arctan2, wide, unit), ("power", np.power, pos, unit * 3)):
        g, w = lowered_on(device, fn, a, b), ref(a, b)
        worst[fn] = float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-300)))
    line["max_rel_err"] = worst
    print("scalar_transcendental", json.dumps(line), flush=True)
    if bad or any(e > SCALAR_REL_TOL for e in worst.values()):
        raise AssertionError(f"transcendental functions on the card: {line}")
    return line


def phase_mainpath(captured, merge_queries):
    """The merge kernel against its plain version on the very inputs the
    cold runs of both sessions and the compiled tier's warm-ups gave it
    (exact), with the same times as phase kernel; one row a launch, named
    after its path and query. ``merge_queries``: path -> the queries whose
    reference selects merge-pallas there."""
    import torch

    for path, want in merge_queries.items():
        got = sorted({q for p, q, *_ in captured if p == path})
        if got != want:
            raise AssertionError(f"{path}: merge kernel inputs captured for queries {got}, "
                                 f"want {want}")
    rows = []
    seen = {}
    for path, q, b, p, bb in captured:
        seen[(path, q)] = seen.get((path, q), 0) + 1
        name = str(q).lower() if isinstance(q, str) else f"q{q}"
        row, _ = check_and_time(f"{name}_sf1_{path}_mainpath_{seen[(path, q)]}", b, p, bb,
                                live_build=int((b != INT32_MAX).sum().item()))
        rows.append(row)
    del captured[:]
    torch.cuda.empty_cache()
    return rows


def phase_transfer(device):
    """The pinned double-buffered copy (exec/staging.py) on the card, for
    each dtype a scan stages: more than two blocks, bitwise the input, and
    read by the consuming stream straight after the call."""
    import numpy as np
    import torch

    from trino_tpu_torch.exec import staging

    rng = np.random.default_rng(5)
    out = []
    for dtype in (np.int32, np.int64, np.float64, np.bool_):
        arr = (rng.integers(0, 2, size=(1 << 22) + 3).astype(np.bool_) if dtype is np.bool_
               else rng.integers(-2**30, 2**30, size=(1 << 22) + 3).astype(dtype))
        prof = staging.StageProfile()
        got = staging.blocked_transfer(device, prof, block_bytes=1 << 20)(arr)
        total = got.to(torch.float64).sum()  # on the consuming stream, no sync first
        want_blocks = -(-arr.nbytes // ((1 << 20) // arr.itemsize * arr.itemsize))
        if prof.transfer_blocks != want_blocks or not np.array_equal(got.cpu().numpy(), arr) \
                or float(total.item()) != float(arr.astype(np.float64).sum()):
            raise AssertionError(f"blocked transfer of {arr.dtype}: {prof.transfer_blocks} "
                                 f"blocks (want {want_blocks}) or a wrong copy")
        out.append({"dtype": str(arr.dtype), "bytes": int(arr.nbytes),
                    "blocks": prof.transfer_blocks})
    # a column as per-split int64 parts narrowed to int32 on the way: packed
    # into the pinned buffers across block edges (more than two blocks), or
    # copied one part into each slice (at most two)
    parts = [rng.integers(-2**30, 2**30, size=n) for n in (700_001, 0, 1_300_000, 9, 524_288)]
    want = np.concatenate(parts).astype(np.int32)
    for block_bytes in (1 << 20, 32 << 20):
        prof = staging.StageProfile()
        got = staging.blocked_transfer(device, prof, block_bytes=block_bytes)(parts, np.int32)
        total = got.to(torch.int64).sum()
        want_blocks = -(-want.nbytes // block_bytes) if want.nbytes > 2 * block_bytes else 0
        if got.dtype != torch.int32 or prof.transfer_blocks != want_blocks \
                or not np.array_equal(got.cpu().numpy(), want) \
                or int(total.item()) != int(want.astype(np.int64).sum()):
            raise AssertionError(f"transfer of {len(parts)} parts in {block_bytes}-byte blocks: "
                                 f"{prof.transfer_blocks} blocks (want {want_blocks}) or a "
                                 f"wrong copy")
        out.append({"parts": len(parts), "dtype": "int64->int32", "bytes": int(want.nbytes),
                    "block_bytes": block_bytes, "blocks": prof.transfer_blocks})
    print("transfer", json.dumps(out), flush=True)


def phase_sf10(device, plane):
    """Q3 at SF10 in a cached session, cold then warm."""
    import torch

    from trino_tpu_torch import Session
    from trino_tpu_torch.devcache import DEVICE_CACHE

    entry = plane["sf10"]["3"]
    session = Session(properties={"catalog": "tpch", "schema": "sf10", "fused_join_pallas": True,
                                  "device_cache_enabled": True}, device=device)
    out = {}
    for label in ("cold", "warm"):
        res, wall, c = timed_execute(session, entry["sql"], device)
        check_rows(f"Q3 at SF10 ({label})", jsonable_rows(res.rows), entry["rows"])
        out[label] = {"wall_s": wall, **c}
    if out["warm"]["staged_rows"] or out["warm"]["h2d_bytes"] or out["warm"]["misses"]:
        raise AssertionError(f"Q3 at SF10 (warm) was not served from the cache: {out['warm']}")
    line = {"query": "Q3", "scale": "sf10", "rows": len(entry["rows"]),
            **{f"{label}_{k}": v for label in out for k, v in out[label].items()},
            "cache_resident_gib": DEVICE_CACHE.cached_bytes() / 2**30,
            "memory_allocated_gib": (torch.cuda.memory_allocated(device) / 2**30
                                     if device.type == "cuda" else None)}
    print("sf10", json.dumps(line), flush=True)
    return line


SPILL_SORT_KEYS = {"3": (1, 2), "18": (4, 3), "13": (1, 0)}  # ORDER BY positions


def phase_spill(device, plane):
    """The spill queries at SF1 under the reference's budgets, cache on."""
    from trino_tpu_torch import Session
    from trino_tpu_torch.exec.executor import Executor
    from trino_tpu_torch.exec.query import plan_sql

    lines = []
    for q, entry in plane["spill"].items():
        props = {"catalog": "tpch", "schema": "sf1", "fused_join_pallas": True,
                 "device_cache_enabled": True}
        # the largest working set the unbudgeted run hands the spill decision
        s = Session(dict(props), device=device)
        unbudgeted = Executor(s)
        unbudgeted.execute_checked(plan_sql(s, entry["sql"]))
        s = Session(dict(props, query_max_device_memory=entry["budget"]), device=device)
        ex = Executor(s)
        sync(device)
        t0 = time.perf_counter()
        rows = ex.execute_checked(plan_sql(s, entry["sql"])).to_pylist()
        sync(device)
        wall = time.perf_counter() - t0
        check_rows(f"Q{q} under a {entry['budget']}-byte budget", jsonable_rows(rows),
                   entry["rows"], SPILL_SORT_KEYS.get(q))
        spills = [{"kind": e.kind, "partitions": e.partitions,
                   "projected_bytes": e.projected_bytes} for e in ex.memory.spills]
        if not spills or max(e["partitions"] for e in spills) < 4:
            raise AssertionError(f"Q{q} under a {entry['budget']}-byte budget spilled "
                                 f"{spills}: want a spill of 4 or more partitions")
        line = {"query": f"Q{q}", "budget": entry["budget"],
                "peak_projected": unbudgeted.memory.peak_projected,
                "reference_peak_projected": entry["peak_projected"], "wall_s": wall,
                "spills": spills, "reference_spills": entry["spills"],
                "cache_bytes_yielded": ex.memory.shed_bytes, "peak": ex.memory.peak}
        print("spill", json.dumps(line), flush=True)
        lines.append(line)
    return lines


def phase_dml(device, plane, scale="tiny"):
    """The DML sequence over shared catalogs: every statement invalidates
    and no stale entry survives. At ``tiny`` every read equals the
    reference's rows; ``sf1`` (``--profile``) runs the same statements over
    a copy of tpch.sf1.orders to time them."""
    from trino_tpu_torch import Session
    from trino_tpu_torch.connector.registry import default_catalogs
    from trino_tpu_torch.devcache import DEVICE_CACHE

    catalogs = default_catalogs()
    session = Session(properties={"catalog": "tpch", "schema": scale,
                                  "device_cache_enabled": True},
                      device=device, catalogs=catalogs)
    memory_conn = catalogs["memory"]
    DEVICE_CACHE.invalidate_all()  # no entry of an earlier run's memory.db.orders
    tag = "dml" if scale == "tiny" else f"dml_{scale}"
    lines = []
    for i, step in enumerate(plane["dml"]["steps"]):
        sql = step["sql"].replace("tpch.tiny.", f"tpch.{scale}.")
        res, wall, c = timed_execute(session, sql, device)
        what = f"{tag} step {i} ({sql[:40]})"
        if scale == "tiny":
            check_rows(what, jsonable_rows(res.rows), step["rows"])
        if step["kind"] == "read":
            got = "hit" if (c["hits"], c["misses"]) == (1, 0) else \
                "miss" if (c["hits"], c["misses"]) == (0, 1) else str(c)
            if got != step["disposition"]:
                raise AssertionError(f"{what}: cache {got}, the reference's {step['disposition']}")
            version = memory_conn.data_version("db", "orders")
            held = {e["version"] for e in DEVICE_CACHE.snapshot()
                    if (e["catalog"], e["table"]) == ("memory", "orders")}
            if held != {str(version)}:
                raise AssertionError(f"{what}: cache holds versions {held} of memory.db.orders, "
                                     f"the table is at {version}")
        line = {"step": i, "kind": step["kind"], "sql": sql[:60], "wall_s": wall,
                "disposition": step["disposition"], "staged_rows": c["staged_rows"],
                "h2d_bytes": c["h2d_bytes"]}
        print(tag, json.dumps(line), flush=True)
        lines.append(line)
    return lines


def explain_plan_lines(text):
    """EXPLAIN ANALYZE text -> (the header's total, planning and execution
    milliseconds, the plan lines without the bracketed stats, each node's
    ``rows=``)."""
    import re

    m = re.match(r"Query wall time: ([\d.]+)ms \(planning ([\d.]+)ms, "
                 r"execution ([\d.]+)ms\)", text.split("\n")[0])
    if m is None:
        raise AssertionError(f"EXPLAIN ANALYZE header: {text.splitlines()[0]!r}")
    lines = [ln for ln in text.split("\n") if ln.lstrip().startswith("- ")]
    rows = [int(re.search(r"rows=(\d+)\]", ln).group(1)) for ln in lines]
    return tuple(map(float, m.groups())), [ln.split("  [")[0] for ln in lines], rows


STATS_PAIRS = 5  # plain / EXPLAIN ANALYZE pairs a query and session


def statement_rows(session, sql):
    return jsonable_rows(session.execute(sql).rows)


def phase_statements(sessions, device, stmts, expected, card):
    """The statement surface at SF1 in the uncached and the cached session:
    EXPLAIN of the 22 TPC-H queries, EXPLAIN ANALYZE of Q17 and Q18 cold
    and warm (and VERBOSE with device_profiling), PREPARE/EXECUTE of Q17
    and Q18, a routine in Q6; then transactions in the cached session over
    a memory copy of a cut of orders, and the connectors at tiny. Returns
    the merge kernel's launches in the EXPLAIN ANALYZE and EXECUTE runs."""
    from trino_tpu_torch.ops import merge

    launches = 0

    def counted(what, fn):
        nonlocal launches
        merge.launches = 0
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        wall = time.perf_counter() - t0
        n = merge.launches
        if n < 1:
            raise AssertionError(f"{what} selected merge-pallas but launched the merge "
                                 f"kernel no time")
        launches += n
        return out, wall, n

    for label, session in sessions:
        bad = [q for q, e in stmts["explain"].items()
               if session.explain(e["sql"]) != e["text"]]
        if bad:
            raise AssertionError(f"EXPLAIN ({label}) differs from the reference's for "
                                 f"queries {bad}")
        print("statements", json.dumps({"session": label, "check": "explain",
                                        "queries": len(stmts["explain"])}), flush=True)
        for q in ("17", "18"):
            want = stmts["explain_analyze"][q]
            line = {"session": label, "check": f"explain_analyze Q{q}", "card": card}
            for run in ("cold", "warm"):
                text, wall, n = counted(
                    f"EXPLAIN ANALYZE Q{q} ({label}, {run})",
                    lambda: "\n".join(r[0] for r in session.execute(
                        "explain analyze " + want["sql"]).rows))
                (total, plan_ms, exec_ms), lines, rows = explain_plan_lines(text)
                if lines != want["plan"] or rows != want["rows"]:
                    raise AssertionError(f"EXPLAIN ANALYZE Q{q} ({label}, {run}): plan "
                                         f"{lines == want['plan']}, rows {rows} vs the "
                                         f"reference's {want['rows']}")
                if abs(plan_ms + exec_ms - total) > 0.1 + 1e-9:
                    raise AssertionError(f"EXPLAIN ANALYZE Q{q} header: {total} != "
                                         f"{plan_ms} + {exec_ms}")
                line.update({f"{run}_wall_s": wall, f"{run}_merge_launches": n,
                             f"{run}_header_ms": [total, plan_ms, exec_ms]})
            # the cost of the stats: the query's wall with and without
            # ANALYZE, in STATS_PAIRS pairs that alternate which runs first
            walls = {"plain": [], "analyze": []}
            runs = {"plain": lambda: session.execute(want["sql"]).rows,
                    "analyze": lambda: session.execute("explain analyze " + want["sql"]).rows}
            for i in range(STATS_PAIRS):
                for kind in (("plain", "analyze") if i % 2 == 0 else ("analyze", "plain")):
                    walls[kind].append(counted(f"Q{q} ({label}, {kind})", runs[kind])[1])
            for kind, ws in walls.items():
                line[f"{kind}_wall_s"] = ws
                line[f"{kind}_median_s"] = sorted(ws)[len(ws) // 2]
            line["analyze_overhead_s"] = line["analyze_median_s"] - line["plain_median_s"]
            print("statements", json.dumps(line), flush=True)
        session.set_property("device_profiling", True)
        text, wall, _n = counted(f"EXPLAIN ANALYZE VERBOSE Q18 ({label})", lambda: "\n".join(
            r[0] for r in session.execute(
                "explain analyze verbose " + stmts["explain_analyze"]["18"]["sql"]).rows))
        session.set_property("device_profiling", False)
        print(f"statements: EXPLAIN ANALYZE VERBOSE Q18 ({label}, device_profiling=true, "
              f"{wall:.3f} s)\n{text}", flush=True)
        for q in ("17", "18"):
            prep = stmts["prepared"][q]
            session.execute(f"prepare stmt_q{q} from {prep['sql']}")
            got, wall, n = counted(f"EXECUTE Q{q} ({label})", lambda: statement_rows(
                session, f"execute stmt_q{q} using {prep['using']}"))
            check_rows(f"EXECUTE Q{q} ({label})", got, expected[q]["rows"])
            errors = []
            for sql in (f"execute stmt_q{q} using {prep['using']}, 1",
                        f"deallocate prepare stmt_q{q}", f"execute stmt_q{q} using 1"):
                try:
                    session.execute(sql)
                except ValueError as e:
                    errors.append(str(e))
            nparams = len(prep["using"].split(","))
            want_errors = [f"prepared statement expects {nparams} parameters, got "
                           f"{nparams + 1}", f"prepared statement not found: stmt_q{q}"]
            if errors != want_errors:
                raise AssertionError(f"EXECUTE Q{q} ({label}) errors {errors}, want "
                                     f"{want_errors}")
            print("statements", json.dumps({"session": label, "check": f"execute Q{q}",
                                            "wall_s": wall, "merge_launches": n,
                                            "errors": errors, "card": card}), flush=True)
        udf = stmts["udf"]
        session.execute(udf["create"])
        got = statement_rows(session, udf["sql"])
        check_rows(f"Q6 with a routine ({label})", got, expected["6"]["rows"])
        if session.explain(udf["sql"]) != session.explain(udf["handwritten_sql"]):
            raise AssertionError("Q6 with a routine is not its hand-written form")
        session.execute(udf["drop"])
        try:
            session.execute(udf["sql"])
        except Exception:  # noqa: BLE001 — any refusal: the routine is gone
            pass
        else:
            raise AssertionError("the routine ran after DROP FUNCTION")
        print("statements", json.dumps({"session": label, "check": "udf q6"}), flush=True)
    return launches


def phase_transactions(session, device, stmts):
    """START TRANSACTION / INSERT / ROLLBACK / COMMIT in the cached session
    over a memory copy of a cut of SF1 orders: the reads inside the
    transaction bypass the device cache; a second session over the same
    catalogs reads the committed count; after COMMIT a read misses and the
    next one hits. Every read equals the reference's."""
    from trino_tpu_torch import Session

    other = Session(properties=dict(session.properties), device=device,
                    catalogs=session.catalogs)
    lines = []
    for step in stmts["transactions"]:
        res, wall, c = timed_execute(session, step["sql"], device)
        label = step["label"]
        check_rows(f"transactions: {label}", jsonable_rows(res.rows), step["rows"])
        line = {"step": label, "wall_s": wall, "hits": c["hits"], "misses": c["misses"],
                "staged_rows": c["staged_rows"]}
        if label == "read_in_txn":
            if (c["hits"], c["misses"]) != (0, 0) or not c["staged_rows"]:
                raise AssertionError(f"the read inside the transaction did not bypass the "
                                     f"device cache: {c}")
            committed = next(s["rows"] for s in stmts["transactions"]
                             if s["label"] == "read_committed")
            res_o, _w, _c = timed_execute(other, step["sql"], device)
            check_rows("a second session during the transaction", jsonable_rows(res_o.rows),
                       committed)
            line["other_session_rows"] = jsonable_rows(res_o.rows)
        if label in ("read_after_commit", "read_again"):
            want = (0, 1) if label == "read_after_commit" else (1, 0)
            if (c["hits"], c["misses"]) != want:
                raise AssertionError(f"{label}: cache hits/misses {(c['hits'], c['misses'])}, "
                                     f"want {want}")
        print("statements_txn", json.dumps(line), flush=True)
        lines.append(line)
    session.execute("drop table memory.stmt.orders")
    return lines


def phase_connectors(device, stmts):
    """The connectors and the metadata statements at tiny: a sqlite
    database written from tpch.tiny into a temporary directory (stdlib
    sqlite3, through the sqlite connector's write path) and registered by
    TRINO_TPU_SQLITE_DB; every answer equals the reference's."""
    import tempfile

    from trino_tpu_torch import Session
    from trino_tpu_torch.connector.sqlite import SqliteConnector

    props = {"catalog": "tpch", "schema": "tiny"}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tpch_tiny.db")
        source = Session(properties=dict(props), device=device)
        conn = SqliteConnector(path)
        for table in stmts["sqlite_tables"]:
            meta = source.catalogs["tpch"].get_table("tiny", table)
            conn.create_table("main", table, [(c.name, c.type) for c in meta.columns],
                              source.execute(f"select * from tpch.tiny.{table}").rows)
        os.environ["TRINO_TPU_SQLITE_DB"] = path
        try:
            session = Session(properties=dict(props), device=device)
            for step in stmts["connectors"]:
                res, wall, _c = timed_execute(session, step["sql"], device)
                check_rows(f"connectors: {step['name']}", jsonable_rows(res.rows),
                           step["rows"])
                print("statements_connectors", json.dumps(
                    {"step": step["name"], "rows": len(res.rows), "wall_s": wall}), flush=True)
            join = next(s["sql"] for s in stmts["connectors"] if s["name"] == "sqlite_join")
            scan = next(ln for ln in session.explain(join).split("\n")
                        if "sqlite.main.orders" in ln).strip()
            if scan != stmts["sqlite_scan_line"]:
                raise AssertionError(f"the sqlite scan {scan!r} != the reference's "
                                     f"{stmts['sqlite_scan_line']!r}")
            swallowed = session.catalogs["blackhole"].rows_swallowed
            print("statements_connectors", json.dumps(
                {"sqlite_scan": scan, "blackhole_rows_swallowed": swallowed}), flush=True)
        finally:
            del os.environ["TRINO_TPU_SQLITE_DB"]


def phase_profile(session, queries, label):
    """``--profile``: one more warm run of each (name, sql) under
    torch.profiler: device time by kernel name and the device's busy share
    of the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, sql in queries:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            session.execute(sql)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events only (kernels and copies): the operator rows
        # of key_averages() repeat their kernels' time, and the profiler's
        # own buffer requests are not work of the query
        by_kernel = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.key.startswith("Activity Buffer"):
                continue
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            if dev_us > 0:
                by_kernel.append((dev_us, e.count, e.key))
        by_kernel.sort(reverse=True)
        device_s = sum(us for us, _, _ in by_kernel) / 1e6
        print("profile", json.dumps({
            "session": label, "query": name, "wall_s": wall, "device_s": device_s,
            "device_busy_share": device_s / wall if wall else None,
            "device_launches": sum(c for _, c, _ in by_kernel),
            "top": [{"kernel": k[:80], "calls": c, "device_ms": us / 1e3}
                    for us, c, k in by_kernel[:8]]}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from trino_tpu_torch.ops import merge

    card = card_line()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib = merge.build_library()
    build_s = time.perf_counter() - t0
    print("build", json.dumps({"library": os.path.basename(str(lib)),
                               "seconds": build_s, "nvcc_flags": merge.NVCC_FLAGS}),
          flush=True)
    if merge.build_log.strip():
        print(merge.build_log.strip(), flush=True)
    rows, call_1x1 = phase_kernel(device)
    expected = testdata("tpch_sf1_expected.json")["queries"]
    plane = testdata("plane_expected.json")
    analytics = testdata("analytics_sf1_expected.json")
    scalar = testdata("scalar_sf1_expected.json")
    nested = testdata("nested_sf1_expected.json")
    profiling = "--profile" in sys.argv[1:]
    with MergeCapture() as cap:
        tpch, session = phase_tpch(device, expected, cap)
        tpch_stats_cost(session, device, expected)
        cache_runs, _resident, cached_session = phase_cache(device, expected, plane, cap)
        analytics_runs, analytics_session = phase_analytics(device, analytics, cap, card)
        scalar_runs, scalar_session = phase_scalar(device, scalar, card)
        check_random(scalar_session, device)
        check_transcendentals(device)
        nested_runs, nested_session = phase_nested(device, nested, card)
        compiled = testdata("compiled_sf1_expected.json")
        eager_walls = {**{f"Q{q}": runs[1]["wall_s"] for q, runs in tpch.items()},
                       **{name: runs[1]["wall_s"] for name, runs in analytics_runs.items()}}
        compiled_runs = phase_compiled(device, expected, compiled, analytics, eager_walls,
                                       cap, card)
        mvexp = testdata("matview_sf1_expected.json")
        dist_runs = phase_distributed(
            device, expected, testdata("distributed_sf1_expected.json"), mvexp, cap,
            {q: (runs[0]["wall_s"], runs[1]["wall_s"]) for q, runs in tpch.items()}, card)
        matview = phase_matview(device, mvexp, expected, cap, card)
        adaptive = phase_adaptive(device, expected, compiled, cap, card)
        serving = phase_serving(device, expected, plane, cap, card)
        observe = phase_observe(device, expected, plane, compiled, cap, card,
                                {q: dist_runs[q][1]["wall_s"] for q in OBSERVE_DIST_QUERIES})
        fte = phase_fte(device, expected, plane, cap, card,
                        {q: dist_runs[q][1]["wall_s"] for q in FTE_QUERIES})
        procplane = phase_procplane(device, expected, testdata("procplane_sf1_expected.json"),
                                    card)
    eager_merge = sorted(int(q) for q, e in expected.items()
                         if e["tiers"].get("merge-pallas", 0) >= 1)
    compiled_merge = sorted(f"Q{q}" for q, e in compiled["queries"].items()
                            if e["tiers"].get("merge-pallas", 0) >= 1)
    dist_merge = sorted(q for q, runs in dist_runs.items() if runs[0]["merge_launches"])
    matview_merge = ["Q18view"] if mvexp["q18"]["tiers"].get("merge-pallas", 0) >= 1 else []
    rows += phase_mainpath(cap.captured, {
        "tpch": eager_merge, "cache": eager_merge,
        "compiled_uncached": compiled_merge, "compiled_cached": compiled_merge,
        "distributed": dist_merge, "matview": matview_merge,
        "adaptive": ["Q17"] if "Q17" in compiled_merge else [],
        "serving": [q for q in (17, 18)
                    if plane["tiers_cached"][str(q)]["cold"].get("merge-pallas", 0) >= 1],
        "observe": [q for q in OBSERVE_CACHED_QUERIES
                    if plane["tiers_cached"][str(q)]["cold"].get("merge-pallas", 0) >= 1],
        "observe_compiled": ["Q17"] if "Q17" in compiled_merge else [],
        "fte": [18]})
    if profiling:
        tpch_sql = [(f"Q{q}", expected[str(q)]["sql"]) for q in range(1, 23)]
        phase_profile(session, tpch_sql, "uncached")
        phase_profile(cached_session, tpch_sql, "cached")
        phase_profile(analytics_session,
                      [(n, e["sql"]) for n, e in analytics["queries"].items()], "analytics")
        phase_profile(scalar_session,
                      [(n, e["sql"]) for n, e in scalar["queries"].items()], "scalar")
        phase_profile(nested_session,
                      [(n, e["sql"]) for n, e in nested["queries"].items()], "nested")
        phase_profile_compiled(device, expected, compiled, card)
    statements = testdata("statements_sf1_expected.json")
    statement_launches = phase_statements(
        (("uncached", session), ("cached", cached_session)), device, statements, expected, card)
    phase_transactions(cached_session, device, statements)
    phase_connectors(device, statements)
    del session, cached_session, analytics_session, scalar_session, nested_session
    phase_transfer(device)
    phase_sf10(device, plane)
    phase_spill(device, plane)
    phase_dml(device, plane)
    if profiling:
        phase_dml(device, plane, "sf1")
    main_shape = next(r for r in rows if r["shape"] == "q17_sf1")
    # each path's launches, counted from 0 just before each of its runs
    launches_by_path = {
        "tpch": sum(run["merge_launches"] for runs in tpch.values() for run in runs),
        "cache": sum(run["merge_launches"] for runs in cache_runs.values()
                     for run in runs.values()),
        "analytics": sum(run["merge_launches"] for runs in analytics_runs.values()
                         for run in runs),
        "scalar": sum(run["merge_launches"] for runs in scalar_runs.values() for run in runs),
        "statements": statement_launches,
        "nested": sum(run["merge_launches"] for runs in nested_runs.values() for run in runs),
        "compiled": sum(rec["merge_launches"] + rec.get("warm_build", {}).get("merge_launches", 0)
                        for rec in compiled_runs),
        "distributed": sum(run["merge_launches"] for runs in dist_runs.values()
                           for run in runs),
        "matview": matview["q18"]["merge_launches"],
        "adaptive": adaptive["compile_ledger"]["merge_launches"],
        "serving": serving["cache_shares"]["launches"],
        "observe": observe["launches"],
        "fte": fte["launches"],
        "procplane": procplane["launches"]}
    for path, n in launches_by_path.items():
        if n < 1 and path not in ("analytics", "scalar", "nested", "distributed", "matview",
                                  "procplane"):
            raise AssertionError(f"the 22 queries of path {path} launched the merge kernel "
                                 f"no time")
    # as since the first slice: the launches of the uncached session's cold
    # runs (launches_by_path has every run of both sessions)
    launches = sum(run["merge_launches"] for runs in tpch.values() for run in runs
                   if run["run"] == "cold")
    for path, by_query in (("tpch", tpch), ("analytics", analytics_runs),
                           ("scalar", scalar_runs), ("nested", nested_runs)):
        print(f"{path}_total", json.dumps({
            f"{label}_wall_s": sum(run["wall_s"] for runs in by_query.values()
                                   for run in runs if run["run"] == label)
            for label in ("cold", "warm")}), flush=True)
    for path in ("uncached", "cached"):
        recs = [r for r in compiled_runs if r["session"] == path]
        print("compiled_total", json.dumps({
            "session": path, "replay_median_s": sum(r["replay_median_s"] for r in recs),
            "eager_warm_wall_s": sum(r["eager_warm_wall_s"] for r in recs),
            "build_s": sum(r["build_s"] for r in recs),
            "warmup_s": sum(r["warmup_s"] for r in recs),
            "capture_s": sum(r["capture_s"] for r in recs),
            "recompiles": sum(r["recompiles"] for r in recs),
            "max_pool_bytes": max(r["pool_bytes"] for r in recs), "card": card}), flush=True)
    summary = {
        "name": "merge_unique_sorted",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/merge_unique_sorted.cu",
        "replaces": "trino_tpu/ops/merge_pallas.py:99",
        "launches": launches,
        "launches_by_path": launches_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_shape["kernel_ms"],
        "device_ms": main_shape["kernel_device_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_shape["library_ms"],
        "library_device_ms": main_shape["library_device_ms"],
        "shape": "q17_sf1 build 256 x probe 6113",
        "launch_floor_ms": call_1x1["wrapper_call_ms_1x1"],
        **call_1x1,
        "shapes": rows,
    }
    print(json.dumps({"kernels": [summary]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
