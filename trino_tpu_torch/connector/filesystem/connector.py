"""Filesystem connector: Parquet/ORC (+ read-only CSV/JSON) tables on
local disk (a copy of trino_tpu/connector/filesystem/connector.py; pyarrow
is imported only when a table is touched).

Reference roles collapsed into one connector: ``lib/trino-parquet``
(``ParquetReader.java:85`` — column readers, row-group pruning by min/max
statistics), ``lib/trino-orc`` (``OrcReader`` — stripes as the scan
granule), the lakehouse connectors' table layout (``plugin/trino-hive``:
a table is a directory of files), and the write path
(``ConnectorPageSink`` → parquet/orc files). Format follows the file
extension; writes use the connector's default_format.

Notes: columns decode straight to the engine's storage reprs —
strings dictionary-encode (pyarrow dictionary arrays pass through without
materializing Python strings when possible), dates to epoch-day int32,
decimals to scaled int64 — so a scanned page is device-transfer-ready.
Splits are row groups; a TupleDomain constraint prunes row groups whose
min/max statistics can't match (the Parquet predicate-pushdown behavior of
``applyFilter`` + row-group filtering).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.connector import spi
from trino_tpu_torch.data.dictionary import Dictionary


def _pa():
    import pyarrow  # noqa: PLC0415 — optional heavy dep, loaded on use

    return pyarrow


def _pq():
    import pyarrow.parquet  # noqa: PLC0415

    return pyarrow.parquet


def _porc():
    import pyarrow.orc  # noqa: PLC0415

    return pyarrow.orc


_EXTS = ("parquet", "orc", "csv", "json")  # csv/json are read-only tables


def _type_from_arrow(at) -> T.Type:
    pa = _pa()
    if pa.types.is_boolean(at):
        return T.BOOLEAN
    if pa.types.is_int8(at) or pa.types.is_int16(at) or pa.types.is_int32(at):
        return T.INTEGER
    if pa.types.is_integer(at):
        return T.BIGINT
    if pa.types.is_floating(at):
        return T.DOUBLE
    if pa.types.is_date(at):
        return T.DATE
    if pa.types.is_decimal(at):
        return T.decimal(at.precision, at.scale)
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return T.varchar()
    if pa.types.is_dictionary(at):
        return _type_from_arrow(at.value_type)
    raise NotImplementedError(f"unsupported parquet/arrow type: {at}")


def _arrow_from_type(t: T.Type):
    pa = _pa()
    if t == T.BOOLEAN:
        return pa.bool_()
    if t == T.INTEGER:
        return pa.int32()
    if t == T.BIGINT:
        return pa.int64()
    if t == T.DOUBLE:
        return pa.float64()
    if t == T.DATE:
        return pa.date32()
    if t.is_decimal:
        return pa.decimal128(t.precision, t.scale)
    if t.is_varchar:
        return pa.string()
    raise NotImplementedError(f"unsupported type for parquet write: {t}")


class FileSystemConnector(spi.Connector):
    name = "filesystem"

    # rows per row group on write: the scan-parallelism granule (a split =
    # a run of row groups), like the reference's parquet writer block size
    ROW_GROUP_SIZE = 4096

    def __init__(self, root: Optional[str] = None,
                 default_format: str = "parquet"):
        # schema = subdirectory of root, table = <name>.<format> inside it
        self.root = root or os.path.join(os.getcwd(), "fs_catalog")
        assert default_format in ("parquet", "orc")
        self.default_format = default_format

    # ------------------------------------------------------------- layout
    def _table_path(self, schema: str, table: str) -> str:
        """Existing table file (any supported format), else the
        default-format path for writes."""
        for ext in _EXTS:
            p = os.path.join(self.root, schema, f"{table}.{ext}")
            if os.path.exists(p):
                return p
        return os.path.join(self.root, schema, f"{table}.{self.default_format}")

    @staticmethod
    def _is_orc(path: str) -> bool:
        return path.endswith(".orc")

    @staticmethod
    def _text_format(path: str):
        """'csv' / 'json' for the read-only text formats, else None
        (reference roles: the hive connector's CSV/JSON serdes)."""
        for fmt in ("csv", "json"):
            if path.endswith("." + fmt):
                return fmt
        return None

    def _read_text_table(self, path: str):
        """Whole-file arrow table for a text-format table (small reference
        / dimension data; columnar formats are the scan path at scale).
        Cached by (path, mtime): plan-time schema, stats, and the scan
        would otherwise each re-parse the file."""
        key = (path, os.path.getmtime(path))
        cache = getattr(self, "_text_cache", None)
        if cache is None:
            cache = self._text_cache = {}
        hit = cache.get(path)
        if hit is not None and hit[0] == key[1]:
            return hit[1]
        if path.endswith(".csv"):
            import pyarrow.csv as pc

            tbl = pc.read_csv(path)
        else:
            import pyarrow.json as pj

            tbl = pj.read_json(path)
        cache[path] = (key[1], tbl)
        return tbl

    def list_schemas(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d))
        )

    def list_tables(self, schema: str) -> List[str]:
        d = os.path.join(self.root, schema)
        if not os.path.isdir(d):
            return []
        return sorted({
            f.rsplit(".", 1)[0] for f in os.listdir(d)
            if f.rsplit(".", 1)[-1] in _EXTS
        })

    def get_table(self, schema: str, table: str) -> Optional[spi.TableMetadata]:
        path = self._table_path(schema, table)
        if not os.path.exists(path):
            return None
        if self._text_format(path):
            arrow_schema = self._read_text_table(path).schema
        elif self._is_orc(path):
            arrow_schema = _porc().ORCFile(path).schema
        else:
            arrow_schema = _pq().read_schema(path)
        cols = [
            spi.ColumnMetadata(f.name, _type_from_arrow(f.type))
            for f in arrow_schema
        ]
        return spi.TableMetadata(schema, table, cols)

    def data_version(self, schema: str, table: str) -> Optional[str]:
        """Storage-derived version: the table file's mtime+size (the cache
        layer's invalidation token — any rewrite changes it). Missing
        table -> a distinct token too, so create-after-miss invalidates."""
        path = self._table_path(schema, table)
        try:
            st = os.stat(path)
        except OSError:
            return "absent"
        return f"{st.st_mtime_ns}:{st.st_size}"

    def table_row_count(self, schema: str, table: str) -> Optional[int]:
        path = self._table_path(schema, table)
        if not os.path.exists(path):
            return None
        if self._text_format(path):
            return self._read_text_table(path).num_rows
        if self._is_orc(path):
            return _porc().ORCFile(path).nrows
        return _pq().ParquetFile(path).metadata.num_rows

    # ------------------------------------------------------------- splits
    def get_splits(
        self, schema: str, table: str, target_splits: int, constraint=None,
        handle=None,
    ) -> List[spi.Split]:
        """One split per row-group (parquet) or stripe (orc) run; parquet
        row groups whose min/max statistics contradict the constraint are
        pruned (ParquetReader's predicate evaluation on column-chunk
        statistics; pyarrow exposes no stripe statistics, so orc scans
        every stripe — correct, just unpruned)."""
        path = self._table_path(schema, table)
        if self._text_format(path):
            return [spi.Split(table, schema, 0, 0, info=None)]
        if self._is_orc(path):
            n_stripes = _porc().ORCFile(path).nstripes
            keep = list(range(n_stripes))
            if not keep:
                return [spi.Split(table, schema, 0, 0, info=())]
            per = max(1, (len(keep) + max(target_splits, 1) - 1)
                      // max(target_splits, 1))
            return [
                spi.Split(table, schema, 0, 0, info=tuple(keep[i : i + per]))
                for i in range(0, len(keep), per)
            ]
        pf = _pq().ParquetFile(path)
        md = pf.metadata
        keep = [
            rg for rg in range(md.num_row_groups)
            if constraint is None or self._row_group_matches(md, rg, constraint)
        ]
        if not keep:
            return []
        # distribute kept row groups over at most target_splits splits
        per = max(1, (len(keep) + max(target_splits, 1) - 1) // max(target_splits, 1))
        return [
            spi.Split(table, schema, 0, 0, info=tuple(keep[i : i + per]))
            for i in range(0, len(keep), per)
        ]

    def _row_group_matches(self, md, rg: int, constraint) -> bool:
        rgm = md.row_group(rg)
        name_to_idx = {rgm.column(i).path_in_schema: i for i in range(rgm.num_columns)}
        for column, dom in constraint.domains.items():
            ci = name_to_idx.get(column)
            if ci is None:
                continue
            stats = rgm.column(ci).statistics
            if stats is None or not stats.has_min_max:
                continue
            lo, hi = _stat_repr(stats.min), _stat_repr(stats.max)
            dlo, dhi = dom.value_bounds()
            try:
                if dlo is not None and hi is not None and hi < dlo:
                    return False
                if dhi is not None and lo is not None and lo > dhi:
                    return False
            except TypeError:
                continue  # incomparable statistic/domain value kinds
        return True

    # --------------------------------------------------------------- scan
    def scan(self, split: spi.Split, columns: List[str], constraint=None) -> Dict[str, spi.ColumnData]:
        path = self._table_path(split.schema, split.table)
        if self._text_format(path):
            tbl = self._read_text_table(path).select(list(columns))
            return {name: _column_data(tbl.column(name)) for name in columns}
        if self._is_orc(path):
            import pyarrow as pa

            f = _porc().ORCFile(path)
            stripes = (list(split.info) if split.info is not None
                       else list(range(f.nstripes)))
            if not stripes:
                tbl = f.schema.empty_table().select(list(columns))
            else:
                parts = [f.read_stripe(i, columns=list(columns))
                         for i in stripes]
                tbl = (pa.Table.from_batches(parts) if parts
                       else f.schema.empty_table().select(list(columns)))
            return {name: _column_data(tbl.column(name)) for name in columns}
        pf = _pq().ParquetFile(path)
        if split.info is not None:
            row_groups = list(split.info)
        else:
            row_groups = list(range(pf.metadata.num_row_groups))
        if not row_groups:  # empty pad split (SPMD over-provisioned devices)
            tbl = pf.schema_arrow.empty_table().select(list(columns))
        else:
            tbl = pf.read_row_groups(row_groups, columns=list(columns))
        out: Dict[str, spi.ColumnData] = {}
        for name in columns:
            out[name] = _column_data(tbl.column(name))
        return out

    # -------------------------------------------------------------- write
    def _write_arrow(self, path: str, tbl) -> None:
        """One write dispatch for both columnar formats (create/insert/
        overwrite all funnel here)."""
        if self._is_orc(path):
            _porc().write_table(tbl, path, stripe_size=64 * 1024)
        else:
            _pq().write_table(tbl, path, row_group_size=self.ROW_GROUP_SIZE)

    @staticmethod
    def _columnize(columns, rows):
        """[(name, type)] + python rows -> arrow table."""
        pa = _pa()
        arrays, fields = [], []
        for i, (cname, ctype) in enumerate(columns):
            at = _arrow_from_type(ctype)
            arrays.append(pa.array(
                [_coerce_py(ctype, r[i]) for r in rows], type=at))
            fields.append(pa.field(cname, at))
        return pa.table(arrays, schema=pa.schema(fields))

    def create_table(self, schema: str, name: str, schema_def, rows) -> None:
        pa = _pa()
        path = self._table_path(schema, name)
        if os.path.exists(path):
            raise ValueError(f"table already exists: {schema}.{name}")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._write_arrow(path, self._columnize(schema_def, rows))

    def insert_rows(self, schema: str, table: str, rows) -> int:
        """Append by rewrite (single-file tables; the multi-file append is
        the lakehouse upgrade)."""
        pa = _pa()
        meta = self.get_table(schema, table)
        if meta is None:
            raise KeyError(f"{self.name}.{schema}.{table} does not exist")
        path = self._table_path(schema, table)
        if self._text_format(path):
            raise NotImplementedError(
                f"{self.name}: {self._text_format(path)} tables are "
                "read-only (write to parquet/orc)")
        old = (_porc().ORCFile(path).read() if self._is_orc(path)
               else _pq().read_table(path))
        arrays = []
        for i, cm in enumerate(meta.columns):
            at = _arrow_from_type(cm.type)
            new = pa.array([_coerce_py(cm.type, r[i]) for r in rows], type=at)
            arrays.append(pa.concat_arrays([old.column(i).combine_chunks(), new]))
        self._write_arrow(
            path, pa.table(arrays, names=[c.name for c in meta.columns]))
        return len(rows)

    def overwrite_rows(self, schema: str, table: str, rows) -> None:
        """Rewrite the table file with the engine-computed row set."""
        meta = self.get_table(schema, table)
        if meta is None:
            raise KeyError(f"{self.name}.{schema}.{table} does not exist")
        path = self._table_path(schema, table)
        fmt = self._text_format(path)
        if fmt:
            raise NotImplementedError(
                f"{self.name}: {fmt} tables are read-only "
                "(write to parquet/orc)")
        self._write_arrow(path, self._columnize(
            [(c.name, c.type) for c in meta.columns], rows))

    def drop_table(self, schema: str, table: str) -> None:
        path = self._table_path(schema, table)
        if os.path.exists(path):
            os.remove(path)


def _coerce_py(t: T.Type, v):
    """Python value -> the arrow type's expected Python kind (the engine's
    implicit widening: int/Decimal into double, int into decimal, ...)."""
    import decimal

    if v is None:
        return None
    if t == T.DOUBLE:
        return float(v)
    if t.is_decimal and not isinstance(v, decimal.Decimal):
        return decimal.Decimal(v)
    if t in (T.BIGINT, T.INTEGER) and not isinstance(v, bool):
        return int(v)
    return v


def _stat_repr(v):
    """Parquet statistic value -> engine storage repr."""
    import datetime
    import decimal

    if isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    if isinstance(v, decimal.Decimal):
        exp = -v.as_tuple().exponent
        return int(v.scaleb(exp))
    return v


def _column_data(chunked) -> spi.ColumnData:
    """Arrow column -> engine ColumnData (storage reprs, dictionary-first
    strings)."""
    pa = _pa()
    arr = chunked.combine_chunks() if hasattr(chunked, "combine_chunks") else chunked
    at = arr.type
    t = _type_from_arrow(at)
    n = len(arr)
    nulls = None
    if arr.null_count:
        nulls = np.asarray(arr.is_null())
    if t.is_varchar:
        # dictionary-encode through arrow (C++-side) — no per-row Python
        dict_arr = arr.dictionary_encode() if not pa.types.is_dictionary(at) else arr
        vocab = dict_arr.dictionary.to_pylist()
        codes = np.asarray(dict_arr.indices.fill_null(-1)).astype(np.int32)
        # engine dictionaries are sorted + order-preserving: recode
        d = Dictionary.build([v for v in vocab if v is not None])
        remap = np.array(
            [d.code_of(v) if v is not None else -1 for v in vocab], dtype=np.int32
        )
        if len(remap) == 0:
            # all-null column: empty vocab would make the remap gather
            # raise (np.where evaluates both branches); one -1 pad keeps
            # the shape machinery happy and every row maps to NULL
            remap = np.array([-1], dtype=np.int32)
        vals = np.where(codes >= 0, remap[np.clip(codes, 0, None)], -1).astype(np.int32)
        return spi.ColumnData(t, vals, nulls, d)
    if t == T.DATE:
        vals = np.asarray(arr.cast(pa.int32())).astype(np.int32)
        return spi.ColumnData(t, vals, nulls)
    if t.is_decimal:
        # decimal128's storage IS the scaled integer: read the 16-byte
        # little-endian values straight from the validity+data buffers
        # (casting through arrow would round to the integral VALUE).
        if arr.offset:
            arr = arr.combine_chunks() if hasattr(arr, "combine_chunks") else arr
            arr = arr.slice(0)  # normalize; buffers() below honors offset via copy
            arr = pa.concat_arrays([arr])
        data = np.frombuffer(arr.buffers()[1], dtype=np.int64)
        vals = np.ascontiguousarray(
            data[2 * arr.offset : 2 * (arr.offset + n) : 2]
        )  # low limb = full value for p <= 18
        if t.precision > 18:
            hi = np.ascontiguousarray(
                data[2 * arr.offset + 1 : 2 * (arr.offset + n) + 1 : 2]
            )
            if not np.array_equal(hi, vals >> 63):
                # genuinely-wide values: two-limb column (Column.hi)
                return spi.ColumnData(t, vals, nulls, hi=hi)
        return spi.ColumnData(t, vals, nulls)
    vals = np.asarray(arr.fill_null(0) if arr.null_count else arr)
    return spi.ColumnData(t, np.asarray(vals, dtype=t.np_dtype), nulls)
