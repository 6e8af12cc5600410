"""The blackhole, sqlite and filesystem connectors of the port against the
JAX package's, on the CPU: every case of the reference's
tests/test_sqlite_connector.py and tests/test_filesystem_connector.py,
and test_ddl_dml.py's ``test_blackhole_swallows`` and
``test_delete_update_sqlite``, each run as one scenario through both
packages over the same files, the results compared (rows exact, doubles
within the tolerance of tests/test_torch_sql_both.py). Then the port's
catalog registry against the reference's, with ``TRINO_TPU_SQLITE_DB`` and
``TRINO_TPU_FS_ROOT``.

The filesystem cases need ``pyarrow`` (every path of that connector reads
and writes through it) and skip where it is not installed.
"""
import datetime
import os
import sqlite3
import sys
import types
from decimal import Decimal

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from test_torch_sql_both import assert_rows_match  # noqa: E402
from trino_tpu import types as JT  # noqa: E402
from trino_tpu.client.session import Session as JaxSession  # noqa: E402
from trino_tpu.connector import predicate as jax_predicate  # noqa: E402
from trino_tpu.connector.registry import default_catalogs as jax_default_catalogs  # noqa: E402
from trino_tpu.connector.sqlite import SqliteConnector as JaxSqlite  # noqa: E402
from trino_tpu.exec.executor import Executor as JaxExecutor  # noqa: E402
from trino_tpu.exec.query import plan_sql as jax_plan_sql  # noqa: E402

from trino_tpu_torch import Session as TorchSession  # noqa: E402
from trino_tpu_torch import types as TT  # noqa: E402
from trino_tpu_torch.connector import predicate as torch_predicate  # noqa: E402
from trino_tpu_torch.connector.registry import default_catalogs  # noqa: E402
from trino_tpu_torch.connector.sqlite import SqliteConnector as TorchSqlite  # noqa: E402
from trino_tpu_torch.exec.executor import Executor as TorchExecutor  # noqa: E402
from trino_tpu_torch.exec.query import plan_sql as torch_plan_sql  # noqa: E402


def _filesystem(pkg_name):
    if pkg_name == "jax":
        from trino_tpu.connector.filesystem.connector import FileSystemConnector
    else:
        from trino_tpu_torch.connector.filesystem.connector import FileSystemConnector
    return FileSystemConnector


JAX = types.SimpleNamespace(
    name="jax", T=JT, P=jax_predicate, Sqlite=JaxSqlite, Executor=JaxExecutor,
    plan_sql=jax_plan_sql, session=lambda props: JaxSession(dict(props)))
TORCH = types.SimpleNamespace(
    name="torch", T=TT, P=torch_predicate, Sqlite=TorchSqlite, Executor=TorchExecutor,
    plan_sql=torch_plan_sql, session=lambda props: TorchSession(dict(props), device="cpu"))


def assert_same(got, want):
    """Nested results equal; lists of row tuples under the tolerance."""
    if isinstance(want, list) and want and all(isinstance(r, tuple) for r in want):
        assert isinstance(got, list)
        assert_rows_match(got, want)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, type(want)) and len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            assert_same(g, w)
    else:
        assert got == want


def both(scenario, tmp_path):
    """Run ``scenario(pkg, directory)`` for each package in a directory of
    its own; the port's results must equal the reference's."""
    out = {}
    for pkg in (JAX, TORCH):
        d = tmp_path / pkg.name
        d.mkdir()
        out[pkg.name] = scenario(pkg, d)
    assert_same(out["torch"], out["jax"])
    return out["torch"]


# ------------------------------------------------------------------ sqlite
# tests/test_sqlite_connector.py


def _orders_db(d):
    db = str(d / "db.sqlite")
    con = sqlite3.connect(db)
    con.execute("create table orders (id integer, customer text, total double,"
                " placed date, open boolean)")
    con.executemany("insert into orders values (?,?,?,?,?)", [
        (1, "alice", 10.5, "2024-01-05", 1),
        (2, "bob", 20.0, "2024-02-11", 0),
        (3, "alice", 7.25, "2024-02-20", 1),
        (4, None, None, None, None),
    ])
    con.commit()
    con.close()
    return db


def _sqlite_session(pkg, db):
    s = pkg.session({"catalog": "sqlite", "schema": "main"})
    s.catalogs["sqlite"] = pkg.Sqlite(db)
    return s


def sqlite_metadata(pkg, d):
    conn = _sqlite_session(pkg, _orders_db(d)).catalogs["sqlite"]
    meta = conn.get_table("main", "orders")
    st = conn.column_stats("main", "orders", "id")
    out = [conn.list_tables("main"), [(c.name, str(c.type)) for c in meta.columns],
           conn.table_row_count("main", "orders"), (st.low, st.high, st.ndv)]
    assert out[2] == 4 and out[3] == (1, 4, 4)
    return out


def sqlite_scan_query(pkg, d):
    rows = _sqlite_session(pkg, _orders_db(d)).execute(
        "select id, customer, total, placed, open from orders order by id").rows
    assert rows[0] == (1, "alice", 10.5, datetime.date(2024, 1, 5), True)
    assert rows[3] == (4, None, None, None, None)
    return rows


def sqlite_aggregation_and_filter(pkg, d):
    rows = _sqlite_session(pkg, _orders_db(d)).execute(
        "select customer, count(*), sum(total) from orders"
        " where open group by customer order by customer").rows
    assert rows == [("alice", 2, 17.75)]
    return rows


def sqlite_constraint_pushdown_reduces_scan(pkg, d):
    conn = _sqlite_session(pkg, _orders_db(d)).catalogs["sqlite"]
    (split,) = conn.get_splits("main", "orders", 1)
    td = pkg.P.TupleDomain({"id": pkg.P.Domain.range(low=2, high=3)})
    td2 = pkg.P.TupleDomain({"customer": pkg.P.Domain.from_values(["bob"])})
    out = [sorted(conn.scan(split, ["id"], constraint=td)["id"].values.tolist()),
           conn.scan(split, ["id", "customer"], constraint=td2)["id"].values.tolist()]
    assert out == [[2, 3], [2]]
    return out


def sqlite_date_pushdown(pkg, d):
    rows = _sqlite_session(pkg, _orders_db(d)).execute(
        "select id from orders where placed >= date '2024-02-01' order by id").rows
    assert rows == [(2,), (3,)]
    return rows


def sqlite_ctas_and_insert_roundtrip(pkg, d):
    s = _sqlite_session(pkg, _orders_db(d))
    out = [s.execute("create table sqlite.main.summary as select customer, sum(total) as t "
                     "from orders where customer is not null group by customer").rows,
           s.execute("select customer, t from summary order by customer").rows,
           s.execute("insert into summary values ('carol', 1.0)").rows,
           s.execute("select count(*) from summary").rows,
           s.execute("drop table sqlite.main.summary").rows,
           "summary" in s.catalogs["sqlite"].list_tables("main")]
    assert out[1] == [("alice", 17.75), ("bob", 20.0)] and out[3] == [(3,)] and not out[-1]
    return out


def sqlite_decimal_column(pkg, d):
    s = pkg.session({"catalog": "sqlite", "schema": "main"})
    s.catalogs["sqlite"] = pkg.Sqlite(str(d / "d.sqlite"))
    s.catalogs["sqlite"].create_table(
        "main", "prices", [("id", pkg.T.BIGINT), ("p", pkg.T.decimal(10, 2))],
        [(1, Decimal("10.25")), (2, Decimal("4.50"))])
    out = [s.execute("select id, p from prices order by id").rows,
           s.execute("select sum(p) from prices").rows]
    assert out == [[(1, Decimal("10.25")), (2, Decimal("4.50"))], [(Decimal("14.75"),)]]
    return out


def sqlite_multi_split_scan(pkg, d):
    db = str(d / "m.sqlite")
    con = sqlite3.connect(db)
    con.execute("create table nums (v integer)")
    con.executemany("insert into nums values (?)", [(i,) for i in range(1000)])
    con.commit()
    con.close()
    s = _sqlite_session(pkg, db)
    conn = s.catalogs["sqlite"]
    seen = []
    for sp in conn.get_splits("main", "nums", 4):
        seen.extend(conn.scan(sp, ["v"])["v"].values.tolist())
    out = [sorted(seen), s.execute("select count(*), sum(v) from nums").rows]
    assert out == [list(range(1000)), [(1000, 499500)]]
    return out


# tests/test_ddl_dml.py::test_delete_update_sqlite
def sqlite_delete_update(pkg, d):
    db = str(d / "dml.sqlite")
    con = sqlite3.connect(db)
    con.execute("create table t (k integer, v text)")
    con.executemany("insert into t values (?,?)", [(i, f"v{i}") for i in range(1, 6)])
    con.commit()
    con.close()
    s = _sqlite_session(pkg, db)
    out = [s.execute("delete from t where k > 3").rows,
           s.execute("update t set v = 'x' where k = 1").rows,
           s.execute("select k, v from t order by k").rows]
    con = sqlite3.connect(db)
    out.append(con.execute("select count(*) from t").fetchone())
    con.close()
    assert out == [[(2,)], [(1,)], [(1, "x"), (2, "v2"), (3, "v3")], (3,)]
    return out


SQLITE_CASES = [sqlite_metadata, sqlite_scan_query, sqlite_aggregation_and_filter,
                sqlite_constraint_pushdown_reduces_scan, sqlite_date_pushdown,
                sqlite_ctas_and_insert_roundtrip, sqlite_decimal_column,
                sqlite_multi_split_scan, sqlite_delete_update]


@pytest.mark.parametrize("scenario", SQLITE_CASES, ids=lambda f: f.__name__)
def test_sqlite_cases(scenario, tmp_path):
    both(scenario, tmp_path)


# --------------------------------------------------------------- blackhole
# tests/test_ddl_dml.py::test_blackhole_swallows


def test_blackhole_swallows(tmp_path):
    def scenario(pkg, d):
        s = pkg.session({"catalog": "memory", "schema": "default"})
        out = [s.execute("create table blackhole.default.sink (x bigint, y varchar)").rows,
               s.execute("insert into blackhole.default.sink values (1, 'a'), (2, 'b')").rows,
               s.catalogs["blackhole"].rows_swallowed,
               s.execute("select count(*) from blackhole.default.sink").rows,
               s.execute("select x, y from blackhole.default.sink").rows,
               s.execute("create table blackhole.default.s2 as "
                         "select n_nationkey from tpch.tiny.nation").rows,
               s.catalogs["blackhole"].rows_swallowed,
               s.catalogs["blackhole"].data_version("default", "sink")]
        assert out[1:5] == [[(2,)], 2, [(0,)], []] and out[6] == 27
        return out

    both(scenario, tmp_path)


# -------------------------------------------------------------- filesystem
# tests/test_filesystem_connector.py (pyarrow)


def _fs_session(pkg, d, fmt="parquet"):
    s = pkg.session({"catalog": "filesystem", "schema": "lake"})
    s.catalogs["filesystem"] = _filesystem(pkg.name)(str(d), default_format=fmt)
    return s


def fs_ctas_roundtrip_from_tpch(pkg, d):
    s = _fs_session(pkg, d)
    (n,) = s.execute("create table lake.li as select l_orderkey, l_quantity, l_shipdate, "
                     "l_returnflag from tpch.tiny.lineitem where l_orderkey < 1000").rows[0]
    rows = s.execute("select l_returnflag, count(*), sum(l_quantity) from li "
                     "group by l_returnflag order by l_returnflag").rows
    want = s.execute("select l_returnflag, count(*), sum(l_quantity) from tpch.tiny.lineitem "
                     "where l_orderkey < 1000 group by l_returnflag order by l_returnflag").rows
    assert n > 0 and rows == want
    return [n, rows]


def fs_types_roundtrip(pkg, d):
    s = _fs_session(pkg, d)
    s.execute("create table lake.t (b bigint, i integer, d double, dt date, "
              "dec decimal(12,2), s varchar, fl boolean)")
    s.execute("insert into lake.t values "
              "(1, 2, 3.5, date '2020-05-01', 12.34, 'hello', true), "
              "(4, 5, 6.5, date '2021-06-02', 56.78, 'world', false)")
    rows = s.execute("select b, i, d, dt, dec, s, fl from t order by b").rows
    assert rows == [
        (1, 2, 3.5, datetime.date(2020, 5, 1), Decimal("12.34"), "hello", True),
        (4, 5, 6.5, datetime.date(2021, 6, 2), Decimal("56.78"), "world", False)]
    return rows


def fs_nulls_roundtrip(pkg, d):
    s = _fs_session(pkg, d)
    s.execute("create table lake.n (x bigint, s varchar)")
    s.execute("insert into lake.n values (1, 'a'), (null, null), (3, 'c')")
    rows = s.execute("select x, s from n order by x nulls first").rows
    assert rows == [(None, None), (1, "a"), (3, "c")]
    return rows


def fs_row_group_pruning(pkg, d):
    import pyarrow as pa
    import pyarrow.parquet as pq

    conn = _filesystem(pkg.name)(str(d))
    (d / "lake").mkdir()
    pq.write_table(pa.table({"k": pa.array(np.arange(4000, dtype=np.int64))}),
                   str(d / "lake" / "seq.parquet"), row_group_size=1000)
    total_rgs = sum(len(sp.info) for sp in conn.get_splits("lake", "seq", 8))
    td = pkg.P.TupleDomain({"k": pkg.P.Domain.range(low=2500, high=2600)})
    kept = [rg for sp in conn.get_splits("lake", "seq", 8, constraint=td) for rg in sp.info]
    s = pkg.session({"catalog": "filesystem", "schema": "lake"})
    s.catalogs["filesystem"] = conn
    ex = pkg.Executor(s)
    rows = ex.execute_checked(pkg.plan_sql(
        s, "select count(*) from seq where k between 2500 and 2600")).to_pylist()
    out = [total_rgs, kept, rows, sum(ex.scan_stats.values())]
    assert out == [4, [2], [(101,)], 1000]
    return out


def fs_dictionary_strings_pushdown(pkg, d):
    s = _fs_session(pkg, d)
    s.execute("create table lake.flags as select l_returnflag, l_linestatus "
              "from tpch.tiny.lineitem where l_orderkey < 4000")
    rows = s.execute("select l_returnflag, count(*) from flags "
                     "group by l_returnflag order by l_returnflag").rows
    want = s.execute("select l_returnflag, count(*) from tpch.tiny.lineitem "
                     "where l_orderkey < 4000 group by l_returnflag order by l_returnflag").rows
    assert rows == want
    return rows


def fs_all_null_string_column_scans(pkg, d):
    import pyarrow as pa
    import pyarrow.parquet as pq

    s = _fs_session(pkg, d)
    os.makedirs(d / "lake", exist_ok=True)
    pq.write_table(pa.table({"k": pa.array([1, 2, 3], pa.int64()),
                             "s": pa.array([None, None, None], pa.string())}),
                   str(d / "lake" / "allnull.parquet"))
    rows = s.execute("select k, s from lake.allnull order by k").rows
    assert rows == [(1, None), (2, None), (3, None)]
    return rows


def fs_orc_ctas_roundtrip_and_insert(pkg, d):
    s = _fs_session(pkg, d, "orc")
    s.execute("create table lake.li_orc as select l_orderkey, l_quantity, l_shipdate, "
              "l_returnflag from tpch.tiny.lineitem where l_orderkey < 500")
    exists = os.path.exists(d / "lake" / "li_orc.orc")
    got = s.execute("select l_returnflag, count(*), sum(l_quantity) from li_orc "
                    "group by l_returnflag order by l_returnflag").rows
    want = s.execute("select l_returnflag, count(*), sum(l_quantity) from tpch.tiny.lineitem "
                     "where l_orderkey < 500 group by l_returnflag order by l_returnflag").rows
    s.execute("insert into li_orc values (9999, 1.00, date '1999-01-01', 'N')")
    n = s.execute("select count(*) from li_orc where l_orderkey = 9999").rows
    assert exists and got == want and n == [(1,)]
    return [got, n]


def fs_orc_multi_stripe_scan(pkg, d):
    import pyarrow as pa
    import pyarrow.orc as porc

    s = _fs_session(pkg, d, "orc")
    (d / "lake").mkdir(exist_ok=True)
    porc.write_table(pa.table({"k": pa.array(range(20000), type=pa.int64()),
                               "v": pa.array([float(i) * 0.5 for i in range(20000)])}),
                     str(d / "lake" / "wide.orc"), stripe_size=4096)
    stripes = porc.ORCFile(str(d / "lake" / "wide.orc")).nstripes
    got = s.execute("select count(*), min(k), max(k), sum(v) from wide").rows
    assert stripes > 1 and got == [(20000, 0, 19999, sum(i * 0.5 for i in range(20000)))]
    return got


def fs_orc_and_parquet_coexist(pkg, d):
    s = _fs_session(pkg, d, "orc")
    s.execute("create table lake.t_orc as select 1 a")
    s.catalogs["fs2"] = _filesystem(pkg.name)(str(d), default_format="parquet")
    s.execute("create table fs2.lake.t_pq as select 2 a")
    rows = s.execute("select * from lake.t_orc union all select * from fs2.lake.t_pq "
                     "order by 1").rows
    assert rows == [(1,), (2,)]
    return rows


def fs_csv_and_json_readonly_tables(pkg, d):
    s = _fs_session(pkg, d)
    (d / "lake").mkdir(exist_ok=True)
    (d / "lake" / "regions.csv").write_text("code,name\n1,NORTH\n2,SOUTH\n3,EAST\n")
    (d / "lake" / "events.json").write_text(
        '{"id": 1, "kind": "click"}\n{"id": 2, "kind": "view"}\n')
    out = ["regions" in s.catalogs["filesystem"].list_tables("lake"),
           s.execute("select code, name from regions order by code").rows,
           s.execute("select e.kind, r.name from events e join regions r "
                     "on e.id = r.code order by e.kind").rows]
    assert out == [True, [(1, "NORTH"), (2, "SOUTH"), (3, "EAST")],
                   [("click", "NORTH"), ("view", "SOUTH")]]
    return out


def fs_text_tables_are_read_only(pkg, d):
    s = _fs_session(pkg, d)
    (d / "lake").mkdir(exist_ok=True)
    (d / "lake" / "ro.csv").write_text("a,b\n1,2\n")
    with pytest.raises(NotImplementedError, match="read-only") as e:
        s.execute("insert into ro values (3, 4)")
    return str(e.value)


FS_CASES = [fs_ctas_roundtrip_from_tpch, fs_types_roundtrip, fs_nulls_roundtrip,
            fs_row_group_pruning, fs_dictionary_strings_pushdown,
            fs_all_null_string_column_scans, fs_orc_ctas_roundtrip_and_insert,
            fs_orc_multi_stripe_scan, fs_orc_and_parquet_coexist,
            fs_csv_and_json_readonly_tables, fs_text_tables_are_read_only]


@pytest.mark.parametrize("scenario", FS_CASES, ids=lambda f: f.__name__)
def test_filesystem_cases(scenario, tmp_path):
    pytest.importorskip("pyarrow")
    both(scenario, tmp_path)


def test_filesystem_parquet_against_distributed_reference(tmp_path):
    """test_distributed_parquet_scan: the reference's SPMD run over an
    8-device CPU mesh and the port's local run give the same rows (the
    port's multi-device tier is ROADMAP queue 1, item 7)."""
    pytest.importorskip("pyarrow")
    import jax
    from jax.sharding import Mesh

    from trino_tpu.parallel.spmd import DistributedQuery

    sql = "select count(*), sum(o_totalprice) from dist"
    got = {}
    for pkg in (JAX, TORCH):
        d = tmp_path / pkg.name
        s = _fs_session(pkg, d)
        s.execute("create table lake.dist as select o_orderkey, o_totalprice "
                  "from tpch.tiny.orders")
        got[pkg.name] = s.execute(sql).rows
        if pkg is JAX:
            mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
            got["jax_distributed"] = DistributedQuery.build(
                s, jax_plan_sql(s, sql), mesh).run().to_pylist()
    assert got["torch"] == got["jax"] == got["jax_distributed"]


def test_filesystem_import_needs_no_pyarrow():
    """The connector imports pyarrow only when a table is touched."""
    import subprocess

    code = ("import sys; import trino_tpu_torch.connector.registry as r; r.default_catalogs(); "
            "print('pyarrow' in sys.modules)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=repo, env={**os.environ, "PYTHONPATH": repo}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


# ---------------------------------------------------------------- registry


def test_registry_matches_the_reference(tmp_path, monkeypatch):
    """The port registers the reference's catalogs (but ``system``, which
    waits for the server-side modules), ``sqlite`` only with
    TRINO_TPU_SQLITE_DB, and the filesystem root from TRINO_TPU_FS_ROOT."""
    for env in ("TRINO_TPU_SQLITE_DB", "TRINO_TPU_FS_ROOT"):
        monkeypatch.delenv(env, raising=False)
    assert set(default_catalogs()) == set(jax_default_catalogs()) - {"system"}
    assert "sqlite" not in default_catalogs()
    db = str(tmp_path / "env.sqlite")
    sqlite3.connect(db).close()
    monkeypatch.setenv("TRINO_TPU_SQLITE_DB", db)
    monkeypatch.setenv("TRINO_TPU_FS_ROOT", str(tmp_path / "fsroot"))
    port, ref = default_catalogs(), jax_default_catalogs()
    assert set(port) == set(ref) - {"system"}
    assert isinstance(port["sqlite"], TorchSqlite) and port["sqlite"]._path == db
    assert port["filesystem"].root == ref["filesystem"].root == str(tmp_path / "fsroot")
    assert port["memory"].supports_transactions and not port["blackhole"].supports_transactions


# ------------------------------------------ device cache over filesystem
# tests/test_device_cache.py::test_invalidation_matrix_filesystem


def test_invalidation_matrix_filesystem(tmp_path):
    """INSERT, UPDATE, DELETE and DROP + CTAS on a Parquet table each
    invalidate a warm device-cache entry (the file's mtime and size are its
    data_version): a miss, then a hit, with the reference's rows."""
    pytest.importorskip("pyarrow")
    from test_torch_devcache import _warm_then
    from trino_tpu.devcache import DEVICE_CACHE as JAX_DEVICE_CACHE
    from trino_tpu.obs import metrics as jax_metrics

    from trino_tpu_torch.devcache import DEVICE_CACHE, HOST_CACHE
    from trino_tpu_torch.obs import metrics as torch_metrics

    results = {}
    try:
        for pkg, metrics in ((JAX, jax_metrics), (TORCH, torch_metrics)):
            for c in (DEVICE_CACHE, HOST_CACHE, JAX_DEVICE_CACHE):
                c.invalidate_all()
            s = pkg.session({"catalog": "filesystem", "schema": "lake",
                             "device_cache_enabled": True})
            s.catalogs["filesystem"] = _filesystem(pkg.name)(str(tmp_path / pkg.name))
            s.execute("create table t as select x a, x * 2 b from table(sequence(0, 99)) t(x)")
            sql = "select sum(a), sum(b), count(*) from t"

            def drop_and_ctas(s=s):
                s.execute("drop table t")
                s.execute("create table t as select 7 a, 8 b")

            steps = [lambda s=s: s.execute("insert into t values (1000, 2000)"),
                     lambda s=s: s.execute("update t set b = 0 where a = 1000"),
                     lambda s=s: s.execute("delete from t where a >= 50"),
                     drop_and_ctas]
            results[pkg.name] = [_warm_then(s, metrics, sql, m) for m in steps]
    finally:
        for c in (DEVICE_CACHE, HOST_CACHE, JAX_DEVICE_CACHE):
            c.invalidate_all()
    assert results["torch"] == results["jax"] == [
        [(5950, 11900, 101)], [(5950, 9900, 101)], [(1225, 2450, 50)], [(7, 8, 1)]]
