"""Plan fragments and the split aggregation steps of the port against the
JAX package.

- ``fragment_plan`` and ``EXPLAIN (TYPE DISTRIBUTED)`` of the 22 TPC-H
  queries and TPC-DS q64 and q95 at ``tiny``, with the default gather
  threshold and with ``gather_max_rows_per_device=1`` (every grouped final
  aggregation hash-distributed): fragment ids, partitionings, output
  partition channels and the plan text equal.
- ``aggregate_partial`` -> (``aggregate_intermediate``) ->
  ``aggregate_final`` for every aggregate ``_partial_states`` handles,
  ``approx_percentile`` included, over the same rows split into 1, 2 and 3
  pages, grouped by a bigint with NULLs, by a varchar (the direct layout)
  and globally: the partial-state rows and the final rows equal the JAX
  functions' (doubles within a relative 1e-9: the packages sum floats in
  another order).
- No plan node of a fragment carries a tensor: every TPC-H fragment's task
  request pickles through a Pickler that refuses tensors.
"""
import io
import os
import pickle
import sys
from decimal import Decimal

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_sql_both import BothSessions, assert_rows_match  # noqa: E402
from tpcds_sql import Q64, Q95  # noqa: E402
from tpch_sql import QUERIES  # noqa: E402

from trino_tpu.exec.executor import Executor as JaxExecutor  # noqa: E402
from trino_tpu.exec.query import plan_sql as jax_plan_sql  # noqa: E402
from trino_tpu.sql.planner import fragmenter as jfrag  # noqa: E402
from trino_tpu.sql.planner import plan as JP  # noqa: E402

from trino_tpu_torch.exec.executor import Executor as TorchExecutor  # noqa: E402
from trino_tpu_torch.exec.query import plan_sql as torch_plan_sql  # noqa: E402
from trino_tpu_torch.server.task import TaskRequest  # noqa: E402
from trino_tpu_torch.sql.planner import fragmenter as tfrag  # noqa: E402
from trino_tpu_torch.sql.planner import plan as TP  # noqa: E402

TINY = {"catalog": "tpch", "schema": "tiny"}
HASHED = {**TINY, "gather_max_rows_per_device": 1}
TPCDS = {"catalog": "tpcds", "schema": "tiny", "fused_join_pallas": True}

_SESSIONS = {}


def both(props):
    key = tuple(sorted(props.items()))
    if key not in _SESSIONS:
        _SESSIONS[key] = BothSessions(props)
    return _SESSIONS[key]


PLAN_CASES = ([(f"Q{q}", QUERIES[q], TINY) for q in sorted(QUERIES)]
              + [(f"Q{q}", QUERIES[q], HASHED) for q in sorted(QUERIES)]
              + [("q64", Q64, TPCDS), ("q95", Q95, TPCDS)])


def _shape(fragments):
    return [(f.id, f.partitioning, f.output_partition_channels) for f in fragments]


@pytest.mark.parametrize(
    "name,sql,props", PLAN_CASES,
    ids=[f"{n}-{'hash' if 'gather_max_rows_per_device' in p else p['catalog']}"
         for n, _, p in PLAN_CASES])
def test_fragments_and_distributed_explain_equal_reference(name, sql, props):
    b = both(props)
    jf = jfrag.fragment_plan(jax_plan_sql(b.jax, sql), b.jax)
    tf = tfrag.fragment_plan(torch_plan_sql(b.torch, sql), b.torch)
    assert _shape(tf) == _shape(jf)
    assert tfrag.format_fragments(tf) == jfrag.format_fragments(jf)
    explain = f"explain (type distributed) {sql}"
    assert b.torch.execute(explain).rows == b.jax.execute(explain).rows
    if props is HASHED and name in ("Q3", "Q10", "Q13", "Q18"):
        assert any(f.partitioning == "hash" for f in tf)


class _NoTensorPickler(pickle.Pickler):
    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            raise AssertionError(f"a plan carries a tensor of shape {tuple(obj.shape)}")
        return None


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_task_requests_pickle_without_tensors(q):
    """The coordinator pickles each fragment into its task request: a CUDA
    tensor there would copy its data into the request and tie it to the
    sender's device. After a run of the query through the executor the
    plan still holds none."""
    b = both(HASHED)
    root = torch_plan_sql(b.torch, QUERIES[q])
    TorchExecutor(b.torch).execute_checked(root)
    for frag in tfrag.fragment_plan(root, b.torch):
        splits = {}
        for node in TP.walk_plan(frag.root):
            if isinstance(node, TP.TableScanNode):
                conn = b.torch.catalogs[node.catalog]
                splits[node.id] = conn.get_splits(node.schema, node.table, 2,
                                                  constraint=node.constraint)
        req = TaskRequest(f"q.{frag.id}.0.a0", "q", frag.root, splits, {}, dict(HASHED),
                          output_partition_channels=frag.output_partition_channels)
        buf = io.BytesIO()
        _NoTensorPickler(buf).dump(req)
        back = TaskRequest.from_bytes(buf.getvalue())
        assert tfrag.format_fragments([tfrag.PlanFragment(frag.id, frag.partitioning,
                                                          back.fragment_root)]) == \
            tfrag.format_fragments([frag])


# ------------------------------------------------------ aggregation steps
AGG_TABLE = [("g", "bigint"), ("s", "varchar"), ("x", "double"), ("i", "bigint"),
             ("d", "decimal(12,2)"), ("ld", "decimal(38,2)"), ("b", "boolean")]


def _agg_rows(n=240, seed=21):
    rng = np.random.default_rng(seed)

    def maybe(v, rate=0.1):
        return None if rng.random() < rate else v

    words = ["ab", "cd", "ef", "gh", "ij"]
    return [(maybe(int(rng.integers(0, 9))), words[int(rng.integers(0, 5))],
             maybe(float(rng.normal(3, 10))), maybe(int(rng.integers(-10**6, 10**6))),
             maybe(Decimal(int(rng.integers(-10**6, 10**6))).scaleb(-2)),
             maybe(Decimal(int(rng.integers(-10**9, 10**9))).scaleb(-2)),
             maybe(bool(rng.integers(0, 2))))
            for _ in range(n)]


AGGREGATES = [
    "count(*)", "count(x)", "sum(i)", "sum(x)", "sum(d)", "sum(ld)", "avg(i)", "avg(x)",
    "avg(d)", "min(x)", "max(i)", "min(d)", "max(ld)", "stddev(x)", "stddev_samp(i)",
    "stddev_pop(x)", "variance(d)", "var_samp(x)", "var_pop(i)",
    "approx_percentile(x, 0.5)", "approx_percentile(i, 0.9)", "bool_and(b)", "bool_or(b)",
    "count_if(b)",
]
KEYS = {"bigint": "g", "varchar": "s", "global": None}
MERGEABLE = ("count", "sum", "avg", "min", "max", "count_if")


@pytest.fixture(scope="module")
def agg_sessions():
    b = BothSessions(TINY)
    b.create_table("default", "agg_t", AGG_TABLE, _agg_rows())
    return b


def _agg_node(P, root):
    return next(n for n in P.walk_plan(root) if isinstance(n, P.AggregationNode))


def _steps(P, ex_cls, session, root, splits):
    """(partial-state rows, final rows, folded final rows or None) of the
    aggregation in ``root`` with its input cut into ``splits`` pages."""
    agg = _agg_node(P, root)
    page = ex_cls(session).execute(agg.source).compact()
    n = page.num_rows
    step = -(-n // splits)
    parts = [page.slice_rows(lo, min(n, lo + step)) for lo in range(0, n, step)]
    partial = P.AggregationNode(agg.source, list(agg.group_channels), agg.aggregates,
                                step="partial", names=agg.names)
    k = len(agg.group_channels)
    final = P.AggregationNode(agg.source, list(range(k)), agg.aggregates, step="final",
                              names=agg.names)
    states = []
    for part in parts:
        ex = ex_cls(session)
        states.append(ex.aggregate_partial(partial, part).compact())
        ex.raise_errors()
    gathered = states[0]
    for s in states[1:]:
        gathered = type(gathered).concat_pages(gathered, s)
    ex = ex_cls(session)
    out = ex.aggregate_final(final, gathered)
    ex.raise_errors()
    folded = None
    if all(c.function in MERGEABLE for c in agg.aggregates):
        running = None
        for s in states:
            pg = s if running is None else type(s).concat_pages(running, s)
            running = ex_cls(session).aggregate_intermediate(final, pg).compact()
        folded = ex_cls(session).aggregate_final(final, running).to_pylist()
    state_rows = sorted((r for s in states for r in s.to_pylist()), key=repr)
    return state_rows, out.to_pylist(), folded


@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("agg", AGGREGATES)
def test_partial_intermediate_final_equal_reference(agg_sessions, agg, key):
    col = KEYS[key]
    sql = (f"select {col}, {agg} from memory.default.agg_t group by {col}" if col
           else f"select {agg} from memory.default.agg_t")
    b = agg_sessions
    jroot, troot = jax_plan_sql(b.jax, sql), torch_plan_sql(b.torch, sql)
    fn = agg.split("(")[0]
    for splits in (1, 2, 3):
        js, jf, jfold = _steps(JP, JaxExecutor, b.jax, jroot, splits)
        ts, tf, tfold = _steps(TP, TorchExecutor, b.torch, troot, splits)
        what = f"{agg} by {key}, {splits} pages"
        assert_rows_match(ts, js, f"{what}: partial states")
        assert_rows_match(sorted(tf, key=repr), sorted(jf, key=repr), f"{what}: final")
        assert (tfold is None) == (jfold is None) == (fn not in MERGEABLE)
        if tfold is not None:
            assert_rows_match(sorted(tfold, key=repr), sorted(jfold, key=repr),
                              f"{what}: intermediate fold")
    # the split result equals the single-step aggregation
    single = b.torch.execute(sql).rows
    if fn != "approx_percentile":
        assert_rows_match(sorted(tf, key=repr), sorted(single, key=repr),
                          f"{agg} by {key}: split vs single step")


def test_intermediate_refuses_what_does_not_merge(agg_sessions):
    b = agg_sessions
    root = torch_plan_sql(b.torch, "select g, stddev(x) from memory.default.agg_t group by g")
    agg = _agg_node(TP, root)
    page = TorchExecutor(b.torch).execute(agg.source).compact()
    partial = TP.AggregationNode(agg.source, [0], agg.aggregates, step="partial")
    states = TorchExecutor(b.torch).aggregate_partial(partial, page)
    final = TP.AggregationNode(agg.source, [0], agg.aggregates, step="final")
    with pytest.raises(NotImplementedError, match="intermediate merge of stddev"):
        TorchExecutor(b.torch).aggregate_intermediate(final, states)
