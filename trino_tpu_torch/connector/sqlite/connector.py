"""SQLite connector: the walking skeleton of the reference's JDBC plugin
family (the port of trino_tpu/connector/sqlite/connector.py; a scan builds
host ``ColumnData`` with ``column_data_from_python``).

Reference: ``plugin/trino-base-jdbc`` (JdbcMetadata / JdbcSplitManager /
JdbcRecordSetProvider, predicate pushdown via ``QueryBuilder`` compiling a
TupleDomain into a WHERE clause) and its concrete plugins (trino-postgresql,
trino-mysql, ...). SQLite via the stdlib driver stands in for the remote
RDBMS: metadata comes from ``sqlite_master``/``PRAGMA table_info``, splits
are rowid ranges, scans SELECT only the requested columns with the
constraint compiled to SQL (pushdown happens IN the remote engine — the
whole point of the JDBC family), and writes go through CREATE TABLE/INSERT.

Type mapping (reference: each JDBC plugin's StandardColumnMappings):
INTEGER->bigint, REAL/FLOAT/DOUBLE->double, TEXT/CHAR->varchar,
DATE->date, BOOLEAN->boolean, NUMERIC/DECIMAL(p,s)->decimal.
"""
from __future__ import annotations

import dataclasses
import re
import sqlite3
import threading
from typing import Dict, List, Optional

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.connector import spi
from trino_tpu_torch.connector.predicate import Domain, TupleDomain
from trino_tpu_torch.data.dictionary import Dictionary
from trino_tpu_torch.data.page import column_data_from_python

_SPLIT_ROWS = 250_000  # rowid range per split (JdbcSplitManager's analog)


@dataclasses.dataclass(frozen=True)
class SqlitePushdown:
    """Opaque table handle carrying negotiated pushdown (reference: the
    JdbcTableHandle's limit/sortOrder/groupingSets state that QueryBuilder
    compiles into the remote SELECT)."""

    limit: Optional[int] = None
    order: tuple = ()  # ((column, ascending, nulls_first), ...)
    group_by: Optional[tuple] = None  # grouping column names
    aggs: tuple = ()  # ((function, column|None, output_name, output_type), ...)

    def __repr__(self):
        parts = []
        if self.aggs:
            gb = ", ".join(self.group_by or ())
            parts.append(f"aggregate[{', '.join(f'{f}({c or chr(42)})' for f, c, _, _ in self.aggs)}"
                         + (f" group by {gb}" if gb else "") + "]")
        if self.order:
            parts.append("sort[" + ", ".join(
                f"{c} {'asc' if a else 'desc'}" for c, a, _ in self.order) + "]")
        if self.limit is not None:
            parts.append(f"limit[{self.limit}]")
        return " ".join(parts) or "none"


def _type_from_sqlite(decl: str) -> T.Type:
    d = (decl or "").strip().lower()
    m = re.match(r"(?:numeric|decimal)\s*\((\d+)\s*,\s*(\d+)\)", d)
    if m:
        return T.decimal(int(m.group(1)), int(m.group(2)))
    if "int" in d:
        return T.BIGINT
    if any(k in d for k in ("real", "floa", "doub")):
        return T.DOUBLE
    if "bool" in d:
        return T.BOOLEAN
    if "date" in d:
        return T.DATE
    # TEXT affinity catch-all (sqlite is dynamically typed)
    return T.varchar()


def _sqlite_decl(t: T.Type) -> str:
    if t.is_integer_kind:
        return "INTEGER"
    if t.is_floating:
        return "DOUBLE"
    if t == T.BOOLEAN:
        return "BOOLEAN"
    if t == T.DATE:
        return "DATE"
    if t.is_decimal:
        assert isinstance(t, T.DecimalType)
        return f"DECIMAL({t.precision},{t.scale})"
    return "TEXT"


class SqliteConnector(spi.Connector):
    name = "sqlite"
    coordinator_only = False  # a shared db file is reachable from workers

    def __init__(self, path: str):
        self._path = path
        self._local = threading.local()

    def _conn(self) -> sqlite3.Connection:
        # sqlite connections are not thread-safe; one per engine thread
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self._path)
            self._local.conn = conn
        return conn

    def data_version(self, schema: str, table: str):
        """Database-file mtime+size, including the WAL sidecar: coarser
        than per-table (any write invalidates every table's cached
        results) but safe — in journal_mode=WAL a commit lands in the
        ``-wal`` file and may leave the main db file untouched until
        checkpoint, so the sidecars participate in the token."""
        import os

        parts = []
        for suffix in ("", "-wal", "-shm"):
            try:
                st = os.stat(self._path + suffix)
                parts.append(f"{st.st_mtime_ns}:{st.st_size}")
            except OSError:
                parts.append("absent")
        if parts[0] == "absent":
            return None  # no database file: unversioned
        return "|".join(parts)

    # ------------------------------------------------------------ metadata
    def list_schemas(self) -> List[str]:
        return ["main"]

    def list_tables(self, schema: str) -> List[str]:
        cur = self._conn().execute(
            "select name from sqlite_master where type = 'table' order by name"
        )
        return [r[0] for r in cur.fetchall()]

    def get_table(self, schema: str, table: str) -> Optional[spi.TableMetadata]:
        if not re.fullmatch(r"\w+", table):
            return None
        cur = self._conn().execute(f"PRAGMA table_info({table})")
        cols = cur.fetchall()
        if not cols:
            return None
        return spi.TableMetadata(
            schema, table,
            [spi.ColumnMetadata(c[1], _type_from_sqlite(c[2])) for c in cols],
        )

    def table_row_count(self, schema: str, table: str) -> Optional[int]:
        if self.get_table(schema, table) is None:
            return None
        (n,) = self._conn().execute(f"select count(*) from {table}").fetchone()
        return int(n)

    def column_stats(self, schema: str, table: str, column: str):
        meta = self.get_table(schema, table)
        if meta is None:
            return None
        try:
            t = meta.columns[meta.column_index(column)].type
        except KeyError:
            return None
        if not (t.is_integer_kind or t == T.DATE or t.is_decimal):
            return None
        _check_ident(column)
        lo, hi, ndv = self._conn().execute(
            f'select min("{column}"), max("{column}"), count(distinct "{column}")'
            f" from {table}"
        ).fetchone()
        if lo is None or hi is None:
            return None
        conv = _to_repr_fn(t)
        return spi.ColumnStats(low=conv(lo), high=conv(hi), ndv=int(ndv))

    # ----------------------------------------------------------- pushdown
    def apply_limit(self, schema, table, handle, count: int):
        h = handle or SqlitePushdown()
        if h.limit is not None and h.limit <= count:
            return None  # already at least as narrow — fixpoint
        return dataclasses.replace(h, limit=count)

    def apply_topn(self, schema, table, handle, count: int, order):
        h = handle or SqlitePushdown()
        want = tuple((o.column, o.ascending, o.nulls_first) for o in order)
        for c, _a, _n in want:
            if not re.fullmatch(r"\w+", c):
                return None
        if h.order == want and h.limit is not None and h.limit <= count:
            return None
        if h.aggs:
            return None  # ordering over pushed aggregates: not composed yet
        return dataclasses.replace(h, order=want, limit=count)

    def apply_aggregation(self, schema, table, handle, group_columns, aggregates):
        h = handle or SqlitePushdown()
        if h.aggs or h.limit is not None or h.order:
            return None  # aggregation must be innermost
        meta = self.get_table(schema, table)
        if meta is None:
            return None
        col_types = {c.name: c.type for c in meta.columns}
        for c in group_columns:
            if c not in col_types or not re.fullmatch(r"\w+", c):
                return None
        out_cols = [spi.ColumnMetadata(c, col_types[c]) for c in group_columns]
        specs = []
        for i, a in enumerate(aggregates):
            # exactness gate: sqlite sums of INTEGER-affinity columns are
            # exact int64; float/fractional-decimal arithmetic differs from
            # the engine's, so decline (the reference's JDBC plugins gate
            # applyAggregate the same way via type mappings)
            if a.function == "count" and a.column is None:
                specs.append(("count", None, f"agg{i}", a.output_type))
            elif a.function in ("count", "min", "max", "sum"):
                t = col_types.get(a.column)
                if t is None or not re.fullmatch(r"\w+", a.column or ""):
                    return None
                exact = (t.is_integer_kind or t == T.DATE
                         or (t.is_decimal and isinstance(t, T.DecimalType)
                             and t.scale == 0))
                if a.function != "count" and not exact:
                    return None
                specs.append((a.function, a.column, f"agg{i}", a.output_type))
            else:
                return None
            out_cols.append(spi.ColumnMetadata(f"agg{i}", a.output_type))
        new_handle = dataclasses.replace(
            h, group_by=tuple(group_columns), aggs=tuple(specs))
        return new_handle, out_cols

    # -------------------------------------------------------------- splits
    def get_splits(self, schema, table, target_splits, constraint=None,
                   handle=None) -> List[spi.Split]:
        _check_ident(table)
        if handle is not None and (
                handle.aggs or handle.limit is not None or handle.order):
            # pushed aggregation/topN/limit is a GLOBAL statement: one split
            # (the remote engine does the work; splitting would make the
            # guarantee per-range)
            return [spi.Split(table, schema, 0, 1 << 62, info=handle)]
        row = self._conn().execute(
            f"select min(rowid), max(rowid) from {table}"
        ).fetchone()
        lo, hi = (row or (None, None))
        if lo is None:
            return [spi.Split(table, schema, 0, -1, info=handle)]
        lo, hi = int(lo), int(hi)
        n = hi - lo + 1
        parts = max(1, min(target_splits, (n + _SPLIT_ROWS - 1) // _SPLIT_ROWS))
        bounds = [lo + n * i // parts for i in range(parts)] + [hi + 1]
        return [
            spi.Split(table, schema, bounds[i], bounds[i + 1] - 1, info=handle)
            for i in range(parts)
        ]

    # ---------------------------------------------------------------- scan
    def scan(self, split: spi.Split, columns: List[str], constraint=None):
        meta = self.get_table(split.schema, split.table)
        assert meta is not None
        h: Optional[SqlitePushdown] = split.info if isinstance(
            split.info, SqlitePushdown) else None
        col_types = {c.name: c.type for c in meta.columns}
        where, params = [], []
        if h is None or not (h.aggs or h.limit is not None or h.order):
            where, params = ["rowid between ? and ?"], [split.lo, split.hi]
        if constraint is not None:
            w, p = _compile_constraint(constraint, col_types)
            where += w
            params += p
        where_sql = f' where {" and ".join(where)}' if where else ""
        if h is not None and h.aggs:
            # the handle defines output names: group columns + aggN aliases
            sel_parts = [f'"{c}"' for c in h.group_by]
            for fn, col, alias, _t in h.aggs:
                expr = "count(*)" if col is None else f'{fn}("{col}")'
                sel_parts.append(f"{expr} as {alias}")
            gb = (" group by " + ", ".join(f'"{c}"' for c in h.group_by)
                  if h.group_by else "")
            sql = (f"select {', '.join(sel_parts)} from {split.table}"
                   f"{where_sql}{gb}")
        else:
            for c in columns:
                _check_ident(c)
            sel = ", ".join(f'"{c}"' for c in columns)
            order_sql = ""
            if h is not None and h.order:
                terms = []
                for c, asc, nf in h.order:
                    nulls = "nulls first" if nf else "nulls last"
                    terms.append(f'"{c}" {"asc" if asc else "desc"} {nulls}')
                order_sql = " order by " + ", ".join(terms)
            limit_sql = (f" limit {int(h.limit)}"
                         if h is not None and h.limit is not None else "")
            sql = (f"select {sel} from {split.table}{where_sql}"
                   f"{order_sql}{limit_sql}")
        rows = self._conn().execute(sql, params).fetchall()
        out: Dict[str, spi.ColumnData] = {}
        if h is not None and h.aggs:
            names = list(h.group_by) + [alias for _, _, alias, _ in h.aggs]
            types = [col_types[c] for c in h.group_by] + [t for _, _, _, t in h.aggs]
            assert list(columns) == names, (columns, names)
            for i, (cname, t) in enumerate(zip(names, types)):
                pycol = [_from_sql_value(t, r[i]) for r in rows]
                out[cname] = column_data_from_python(t, pycol)
            return out
        for i, cname in enumerate(columns):
            t = col_types[cname]
            pycol = [_from_sql_value(t, r[i]) for r in rows]
            out[cname] = column_data_from_python(t, pycol)
        return out

    # --------------------------------------------------------------- write
    def create_table(self, schema: str, name: str, schema_def, rows) -> None:
        _check_ident(name)
        for c, _ in schema_def:
            _check_ident(c)
        if self.get_table(schema, name) is not None:
            raise ValueError(f"table already exists: {schema}.{name}")
        cols = ", ".join(f'"{c}" {_sqlite_decl(t)}' for c, t in schema_def)
        conn = self._conn()
        conn.execute(f'create table {name} ({cols})')
        if rows:
            ph = ", ".join("?" * len(schema_def))
            conn.executemany(
                f"insert into {name} values ({ph})",
                [tuple(_to_sql_value(t, v) for (_, t), v in zip(schema_def, r))
                 for r in rows],
            )
        conn.commit()

    def insert_rows(self, schema: str, table: str, rows) -> int:
        meta = self.get_table(schema, table)
        if meta is None:
            raise KeyError(f"sqlite.{schema}.{table} does not exist")
        if rows:
            ph = ", ".join("?" * len(meta.columns))
            conn = self._conn()
            conn.executemany(
                f"insert into {table} values ({ph})",
                [tuple(_to_sql_value(c.type, v) for c, v in zip(meta.columns, r))
                 for r in rows],
            )
            conn.commit()
        return len(rows)

    def overwrite_rows(self, schema: str, table: str, rows) -> None:
        """DELETE-all + re-insert inside one sqlite transaction (the
        engine hands back the surviving/modified row set)."""
        meta = self.get_table(schema, table)
        if meta is None:
            raise KeyError(f"sqlite.{schema}.{table} does not exist")
        _check_ident(table)
        conn = self._conn()
        conn.execute(f"delete from {table}")
        if rows:
            ph = ", ".join("?" * len(meta.columns))
            conn.executemany(
                f"insert into {table} values ({ph})",
                [tuple(_to_sql_value(c.type, v) for c, v in zip(meta.columns, r))
                 for r in rows],
            )
        conn.commit()

    def drop_table(self, schema: str, table: str) -> None:
        _check_ident(table)
        conn = self._conn()
        conn.execute(f"drop table if exists {table}")
        conn.commit()


def _check_ident(name: str) -> None:
    """Identifiers are interpolated into remote SQL: restrict to word
    characters (the reference's QueryBuilder quotes through the JDBC
    driver; sqlite3 has no identifier binding)."""
    if not re.fullmatch(r"\w+", name):
        raise ValueError(f"invalid sqlite identifier: {name!r}")


def _to_repr_fn(t: T.Type):
    """SQL value -> engine storage repr (for stats)."""
    if t == T.DATE:
        import datetime

        def conv(v):
            if isinstance(v, str):
                return (datetime.date.fromisoformat(v) - datetime.date(1970, 1, 1)).days
            return int(v)

        return conv
    if t.is_decimal:
        scale = t.scale if isinstance(t, T.DecimalType) else 0
        return lambda v: int(round(float(v) * 10**scale))
    return lambda v: int(v)


def _from_sql_value(t: T.Type, v):
    """sqlite driver value -> Python value in the engine's expected kind."""
    if v is None:
        return None
    if t == T.DATE:
        return v  # ISO string or days; column_data_from_python takes both
    if t == T.BOOLEAN:
        return bool(v)
    if t.is_decimal:
        from decimal import Decimal

        return Decimal(str(v))
    return v


def _to_sql_value(t: T.Type, v):
    if v is None:
        return None
    if t == T.DATE:
        return str(v)
    if t.is_decimal:
        return str(v)
    if t == T.BOOLEAN:
        return int(bool(v))
    if t.is_floating:
        return float(v)  # engine literals may arrive as Decimal
    if t.is_integer_kind:
        return int(v)
    return v


def _compile_constraint(td: TupleDomain, col_types) -> tuple:
    """TupleDomain -> (WHERE conjuncts, bind params): the reference's
    QueryBuilder.toPredicate — pushdown evaluated by the remote engine."""
    where, params = [], []
    for column, dom in (td.domains or {}).items():
        if column not in col_types or dom.is_all():
            continue
        if not re.fullmatch(r"\w+", column):
            continue  # advisory constraint: skip rather than interpolate
        t = col_types[column]
        if t.is_decimal and (not isinstance(t, T.DecimalType) or t.scale != 0):
            # fractional decimals bind as floats, whose rounding past 2^53
            # could DROP matching rows remotely (the constraint is advisory
            # — over-approximation only) — skip the pushdown
            continue
        conv = _param_fn(t)
        q = f'"{column}"'
        parts = []
        if dom.values is not None:
            vals = sorted(dom.values, key=str)
            if not vals:
                parts.append("1 = 0")
            elif len(vals) <= 500:
                ph = ", ".join("?" * len(vals))
                parts.append(f"{q} in ({ph})")
                params.extend(conv(v) for v in vals)
            # else: too many keys — skip (advisory constraint)
        else:
            if dom.low is not None:
                parts.append(f"{q} >{'=' if dom.low_inclusive else ''} ?")
                params.append(conv(dom.low))
            if dom.high is not None:
                parts.append(f"{q} <{'=' if dom.high_inclusive else ''} ?")
                params.append(conv(dom.high))
        if not parts:
            if not dom.null_allowed:
                where.append(f"({q} is not null)")
            continue
        pred = " and ".join(parts)
        if dom.null_allowed:
            pred = f"({pred} or {q} is null)"
        where.append(f"({pred})")
    return where, params


def _param_fn(t: T.Type):
    """Engine storage repr -> SQL bind value."""
    if t == T.DATE:
        import datetime

        return lambda v: (
            (datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))).isoformat()
            if not isinstance(v, str)
            else v
        )
    if t.is_decimal:
        # scale-0 decimals bind as exact ints (sqlite INTEGER affinity
        # compares exactly); fractional decimals never push down (see
        # _compile_constraint) so floats here can't drop rows
        scale = t.scale if isinstance(t, T.DecimalType) else 0
        if scale == 0:
            return lambda v: int(v)
        return lambda v: float(v) / 10**scale
    return lambda v: v
