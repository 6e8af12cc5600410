"""Window functions: trino_tpu_torch/ops/window.py against
trino_tpu/ops/window.py on the same numpy inputs (made from a seed), and
the SQL of tests/test_window.py through both Sessions on the CPU.

Left out of the SQL: ``test_distributed_window_matches_local`` (the
8-device SPMD runner is not ported).
"""
import os
import sys
from decimal import Decimal

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp  # noqa: E402

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from trino_tpu.ops import window as jwin  # noqa: E402
from test_torch_sql_both import BothSessions  # noqa: E402

from trino_tpu_torch.ops import window as twin  # noqa: E402

N = 257


def _inputs(seed, with_sel=True):
    """(partition keys, order keys, sel, value column) as numpy arrays."""
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 9, N).astype(np.int64)
    pk_valid = rng.random(N) > 0.1
    ok1 = rng.integers(0, 12, N).astype(np.int32)  # ties: peers
    ok2 = rng.normal(0.0, 1.0, N)
    ok2_valid = rng.random(N) > 0.15
    sel = rng.random(N) > 0.2 if with_sel else None
    x = rng.integers(-1000, 1000, N).astype(np.int64)
    x_valid = rng.random(N) > 0.2
    return (pk, pk_valid), (ok1, ok2, ok2_valid), sel, (x, x_valid)


def _layouts(seed, with_sel=True, no_partition=False):
    (pk, pkv), (o1, o2, o2v), sel, x = _inputs(seed, with_sel)

    def make(mod, arr):
        pkeys = [] if no_partition else [(arr(pk), arr(pkv))]
        okeys = [((arr(o1), None), False, None), ((arr(o2), arr(o2v)), True, True)]
        s = None if sel is None else arr(sel)
        return mod.build_layout(pkeys, okeys, s, N)

    return make(jwin, jnp.asarray), make(twin, torch.from_numpy), x


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same(got, want, what):
    """Equal dtypes and values (floats within 1e-9 relative)."""
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} != the reference's {w.dtype}"
    if g.dtype.kind == "f":
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12, err_msg=what)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


def assert_lowered(got, want, what):
    assert_same(got[0], want[0], what)
    assert (got[1] is None) == (want[1] is None), what
    if got[1] is not None:
        assert_same(got[1], want[1], what + " valid")


@pytest.mark.parametrize("seed,with_sel,no_partition", [
    (1, True, False), (2, False, False), (3, True, True)])
def test_layout_equals_reference(seed, with_sel, no_partition):
    jl, tl, _ = _layouts(seed, with_sel, no_partition)
    for f in ("order", "inv", "part_start", "part_end", "peer_start", "peer_end",
              "part_id", "dense_peer"):
        assert_same(getattr(tl, f), getattr(jl, f), f)


@pytest.mark.parametrize("seed", [4, 5])
def test_ranking_functions_equal_reference(seed):
    jl, tl, _ = _layouts(seed)
    for name in ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist"):
        assert_lowered(getattr(twin, name)(tl), getattr(jwin, name)(jl), name)
    for k in (1, 3, 4, 7, 300):
        assert_lowered(twin.ntile(tl, k), jwin.ntile(jl, k), f"ntile({k})")


FRAMES = [("running", None, None), ("rows_running", None, None),
          ("partition", None, None), ("rows_offset", -2, 0), ("rows_offset", -3, -1),
          ("rows_offset", 0, None), ("rows_offset", None, 2), ("rows_offset", 1, 3)]


@pytest.mark.parametrize("frame,lo,hi", FRAMES)
def test_frame_aggregates_equal_reference(frame, lo, hi):
    jl, tl, (x, xv) = _layouts(6)
    jarg, targ = (jnp.asarray(x), jnp.asarray(xv)), (torch.from_numpy(x), torch.from_numpy(xv))
    what = f"{frame}[{lo},{hi}]"
    assert_lowered(twin.agg_sum(tl, targ, frame, torch.int64, lo, hi),
                   jwin.agg_sum(jl, jarg, frame, np.dtype(np.int64), lo, hi), "sum " + what)
    xf = x.astype(np.float64) / 7.0
    assert_lowered(twin.agg_sum(tl, (torch.from_numpy(xf), None), frame, torch.float64, lo, hi),
                   jwin.agg_sum(jl, (jnp.asarray(xf), None), frame, np.dtype(np.float64),
                                lo, hi), "float sum " + what)
    assert_lowered(twin.agg_count(tl, targ, frame, lo, hi),
                   jwin.agg_count(jl, jarg, frame, lo, hi), "count " + what)
    assert_lowered(twin.agg_count(tl, None, frame, lo, hi),
                   jwin.agg_count(jl, None, frame, lo, hi), "count(*) " + what)
    for first in (True, False):
        assert_lowered(twin.edge_value(tl, targ, frame, first, lo, hi),
                       jwin.edge_value(jl, jarg, frame, first, lo, hi), f"edge {first} {what}")
    for nth in (1, 2, 5):
        assert_lowered(twin.nth_value(tl, targ, nth, frame, lo, hi),
                       jwin.nth_value(jl, jarg, nth, frame, lo, hi), f"nth {nth} {what}")


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64, np.bool_])
def test_minmax_and_shifts_equal_reference(dtype):
    jl, tl, (x, xv) = _layouts(7)
    xd = (x > 0) if dtype is np.bool_ else x.astype(dtype)
    jarg, targ = (jnp.asarray(xd), jnp.asarray(xv)), (torch.from_numpy(xd), torch.from_numpy(xv))
    for is_min in (True, False):
        assert_lowered(twin.agg_minmax(tl, targ, "partition", is_min),
                       jwin.agg_minmax(jl, jarg, "partition", is_min), f"minmax {is_min}")
    for off in (1, 2, 5):
        for lead in (True, False):
            assert_lowered(twin.shifted_value(tl, targ, off, lead),
                           jwin.shifted_value(jl, jarg, off, lead), f"shift {off} {lead}")


def test_running_minmax_refused():
    _, tl, (x, xv) = _layouts(8)
    with pytest.raises(NotImplementedError):
        twin.agg_minmax(tl, (torch.from_numpy(x), None), "running", True)


# ---------------------------------------------------------------- the SQL
ROWS = []
_rng = np.random.default_rng(11)
for _i in range(200):
    _dept = int(_rng.integers(0, 6))
    _salary = int(_rng.integers(1000, 9000))
    ROWS.append((_i, _dept, _salary, None if _i % 23 == 0 else int(_rng.integers(0, 50))))


@pytest.fixture(scope="module")
def both():
    b = BothSessions()
    b.create_table("t", "emp", [("id", "bigint"), ("dept", "bigint"), ("salary", "bigint"),
                                ("bonus", "bigint")], ROWS)
    b.create_table("t", "ev", [("id", "bigint"), ("name", "varchar")],
                   [(1, "alpha"), (2, "beta"), (3, "gamma"), (4, None)])
    b.create_table("t", "kwcols", [("row", "bigint"), ("rows", "bigint"),
                                   ("range", "bigint"), ("current", "bigint")], [(1, 2, 3, 4)])
    return b


WINDOW_SQL = {
    "ranking": """select id, rank() over (partition by dept order by salary desc),
                  dense_rank() over (partition by dept order by salary desc),
                  row_number() over (partition by dept order by salary desc, id)
           from memory.t.emp order by id""",
    "running_and_partition": """select id,
                  sum(salary) over (partition by dept order by id),
                  count(*) over (partition by dept),
                  sum(bonus) over (partition by dept),
                  min(salary) over (partition by dept),
                  max(salary) over (partition by dept)
           from memory.t.emp order by id""",
    "rows_frame_and_peers": """select id,
                  sum(salary) over (partition by dept order by salary),
                  sum(salary) over (partition by dept order by salary
                                    rows between unbounded preceding and current row)
           from memory.t.emp order by id""",
    "lag_lead_first_last": """select id,
                  lag(salary) over (partition by dept order by id),
                  lead(salary, 2) over (partition by dept order by id),
                  first_value(salary) over (partition by dept order by id),
                  last_value(salary) over (partition by dept order by id)
           from memory.t.emp order by id""",
    "without_partition": """select id, rank() over (order by salary desc, id),
                  sum(salary) over (order by id)
           from memory.t.emp order by id""",
    "over_group_by": """select dept, sum(salary) s,
                  rank() over (order by sum(salary) desc)
           from memory.t.emp group by dept order by dept""",
    "null_partition_keys": """select id, count(*) over (partition by bonus),
                  row_number() over (partition by bonus order by id)
           from memory.t.emp order by id""",
    "in_expression": """select id, salary - avg(salary) over (partition by dept) d
           from memory.t.emp order by id""",
    "only_in_order_by": """select id from memory.t.emp
           order by rank() over (partition by dept order by salary desc), id""",
    "varchar_values": """select id, lag(name) over (order by id),
                  first_value(name) over (order by id)
           from memory.t.ev order by id""",
    "keywords_stay_identifiers": "select row, rows, range, current from memory.t.kwcols",
    "ntile_percent_rank_cume_dist": """select id,
               ntile(4) over (partition by dept order by salary, id),
               percent_rank() over (partition by dept order by salary, id),
               cume_dist() over (partition by dept order by salary, id)
        from memory.t.emp order by id""",
    "rows_offset_rolling": """select id,
               sum(salary) over (partition by dept order by id
                                 rows between 3 preceding and current row),
               sum(salary) over (partition by dept order by id
                                 rows between 2 preceding and 2 following),
               count(bonus) over (partition by dept order by id
                                  rows between 1 preceding and 1 following),
               avg(salary) over (partition by dept order by id
                                 rows between 3 preceding and 1 preceding)
        from memory.t.emp order by id""",
    "rows_offset_unbounded_following": """select id,
               sum(salary) over (partition by dept order by id
                                 rows between current row and unbounded following)
        from memory.t.emp order by id""",
    "nth_value_and_frames": """select id,
               nth_value(salary, 3) over (partition by dept order by salary, id
                                          rows between unbounded preceding
                                          and unbounded following),
               first_value(salary) over (partition by dept order by id
                                         rows between 2 preceding and current row)
        from memory.t.emp order by id""",
}


@pytest.mark.parametrize("name", sorted(WINDOW_SQL))
def test_window_sql_equals_reference(both, name):
    rows = both.check(WINDOW_SQL[name])
    assert rows


def test_varchar_window_values_rows(both):
    assert both.check(WINDOW_SQL["varchar_values"]) == [
        (1, None, "alpha"), (2, "alpha", "alpha"), (3, "beta", "alpha"), (4, "gamma", "alpha")]


def test_running_minmax_rejected_in_both(both):
    ref, got = both.check_raises(
        "select min(salary) over (partition by dept order by id) from memory.t.emp")
    assert "running frame" in ref and "running frame" in got


def test_window_over_decimal_and_dates_tpch():
    """Decimal sums and dates through a window over TPC-H tiny, with a
    filter so dead rows ride the layout."""
    b = BothSessions({"catalog": "tpch", "schema": "tiny"})
    b.check("""select o_orderkey, o_orderdate,
                      sum(o_totalprice) over (partition by o_orderstatus order by o_orderdate,
                                              o_orderkey),
                      avg(o_totalprice) over (partition by o_orderpriority),
                      lag(o_orderdate) over (partition by o_custkey order by o_orderkey),
                      max(o_orderdate) over (partition by o_custkey)
               from orders where o_custkey < 100 order by o_orderkey""")


def test_window_two_limb_argument_narrowed():
    """A long-decimal argument (two limbs) is narrowed to its low word for
    the window, as in the reference."""
    b = BothSessions()
    b.create_table("t", "ld", [("g", "bigint"), ("v", "decimal(30,2)")],
                   [(i % 3, Decimal(i * 1000003 - 7) / 100) for i in range(40)])
    rows = b.check("select g, v, sum(v) over (partition by g order by v), "
                   "lag(v) over (partition by g order by v) from memory.t.ld order by g, v")
    assert len(rows) == 40
