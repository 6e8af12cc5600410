"""Connector SPI.

Reference: ``core/trino-spi/src/main/java/io/trino/spi/connector/`` —
``ConnectorMetadata.java:80``, ``ConnectorSplitManager.java:19``,
``ConnectorPageSource.java:24``. Round-1 surface: metadata (schemas, tables,
columns, row-count stats), split enumeration (for distributed scans), and a
page source that materializes a projected column subset of a split as numpy
arrays (the engine moves them to device). Pushdown: the planner prunes
projections (``columns`` argument) and passes advisory TupleDomain
constraints (connector/predicate.py) to ``get_splits``/``scan``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.data.dictionary import Dictionary


@dataclasses.dataclass(frozen=True)
class ColumnMetadata:
    name: str
    type: T.Type


@dataclasses.dataclass(frozen=True)
class TableMetadata:
    schema: str
    name: str
    columns: Sequence[ColumnMetadata]

    def column_index(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """CBO column statistics (reference: spi/statistics/ColumnStatistics).
    ``low``/``high`` are storage-repr bounds (scaled ints for decimals,
    epoch days for dates); ``ndv`` estimates distinct values."""

    low: Optional[int] = None
    high: Optional[int] = None
    ndv: Optional[int] = None
    null_fraction: float = 0.0

    @property
    def vrange(self) -> Optional[tuple]:
        if self.low is None or self.high is None:
            return None
        return (self.low, self.high)


@dataclasses.dataclass(frozen=True)
class Split:
    """A unit of scan parallelism (reference: spi/connector/ConnectorSplit).
    ``lo``/``hi`` are connector-interpreted bounds (e.g. row or key range)."""

    table: str
    schema: str
    lo: int
    hi: int
    info: object = None


@dataclasses.dataclass(frozen=True)
class SortItem:
    """One ORDER BY term for TopN pushdown (reference:
    spi/connector/SortItem)."""

    column: str
    ascending: bool = True
    nulls_first: bool = False


@dataclasses.dataclass(frozen=True)
class AggregateSpec:
    """One aggregate for aggregation pushdown (reference:
    spi/connector/AggregateFunction): ``column`` None = count(*)."""

    function: str  # count | sum | min | max
    column: Optional[str]
    output_type: T.Type


@dataclasses.dataclass(frozen=True)
class TablePartitioning:
    """Connector-declared physical partitioning (reference:
    ConnectorTablePartitioning + ConnectorNodePartitioningProvider): two
    tables whose partitionings share ``family`` split their rows by the
    SAME key boundaries — split i of one co-locates with split i of the
    other, so a join on the partitioning columns needs no exchange."""

    columns: tuple  # partitioning column names, in key order
    family: str  # co-location domain (same family => aligned splits)


@dataclasses.dataclass
class ColumnData:
    """One scanned column: numpy values (+nulls) host-side; the executor
    transfers to device. Varchar carries the dictionary.

    ``vrange`` is an optional TABLE-WIDE static (min, max) bound on the
    column's storage values (reference: spi/statistics ColumnStatistics
    min/max). Table-wide — not per-split — so every split of a table
    narrows to the same physical dtype (data/page.py Column.vrange) and
    pages stay dtype-compatible across workers."""

    type: T.Type
    values: np.ndarray
    nulls: Optional[np.ndarray] = None
    dictionary: Optional[Dictionary] = None
    vrange: Optional[tuple] = None
    # values are non-decreasing within this part (reference: the sort
    # properties of LocalProperties/ConnectorTableProperties) — monotone
    # generator keys and sorted file layouts declare it; the engine's
    # sorted-input fast paths (group/join without lax.sort) consume it
    sorted: bool = False
    # nested (array/map/row) columns: values = per-row int32 lengths,
    # children = flattened child columns (data/page.py Column.children)
    children: Optional[List["ColumnData"]] = None
    # long-decimal high limb (data/page.py Column.hi)
    hi: Optional[np.ndarray] = None


def concat_column_data(cols: Sequence[ColumnData]) -> ColumnData:
    """Host-side row-wise concat of scanned column parts, merging varchar
    dictionaries when parts disagree (range-dependent vocabularies). The
    single shared implementation for engine scan assembly and connectors."""
    assert cols
    if len(cols) == 1:
        return cols[0]
    from trino_tpu_torch.data.page import merge_vrange

    if cols[0].children is not None:
        # nested: lengths concatenate; flat children concatenate recursively
        vals = np.concatenate([np.asarray(cd.values) for cd in cols])
        nulls = (
            np.concatenate([
                np.asarray(cd.nulls) if cd.nulls is not None
                else np.zeros(len(cd.values), bool)
                for cd in cols
            ])
            if any(cd.nulls is not None for cd in cols)
            else None
        )
        kids = [
            concat_column_data([cd.children[i] for cd in cols])
            for i in range(len(cols[0].children))
        ]
        return ColumnData(cols[0].type, vals, nulls, children=kids)

    vrange = cols[0].vrange
    for cd in cols[1:]:
        vrange = merge_vrange(vrange, cd.vrange)
    d = cols[0].dictionary
    if d is not None:
        for cd in cols[1:]:
            if cd.dictionary.values != d.values:
                d = d.merge(cd.dictionary)
        vals = np.concatenate([
            np.where(
                np.asarray(cd.values) >= 0,
                np.asarray(cd.dictionary.recode_table(d))[
                    np.clip(np.asarray(cd.values), 0, None)],
                -1,
            ).astype(np.int32)
            if cd.dictionary.values != d.values
            else np.asarray(cd.values)
            for cd in cols
        ])
    else:
        vals = np.concatenate([np.asarray(cd.values) for cd in cols])
    nulls = (
        np.concatenate([
            np.asarray(cd.nulls) if cd.nulls is not None
            else np.zeros(len(cd.values), bool)
            for cd in cols
        ])
        if any(cd.nulls is not None for cd in cols)
        else None
    )
    if any(cd.hi is not None for cd in cols):
        hi = np.concatenate([
            np.asarray(cd.hi) if cd.hi is not None
            else (np.asarray(cd.values).astype(np.int64) >> 63)
            for cd in cols
        ])
        return ColumnData(cols[0].type, vals.astype(np.int64), nulls, hi=hi)
    # sortedness survives concat when every part is sorted AND callers pass
    # parts in ascending key order (connector scans enumerate ranges
    # ascending); last-of-prev <= first-of-next is verified cheaply
    srt = all(cd.sorted for cd in cols)
    if srt:
        for a, b in zip(cols, cols[1:]):
            va, vb = np.asarray(a.values), np.asarray(b.values)
            if len(va) and len(vb) and va[-1] > vb[0]:
                srt = False
                break
    return ColumnData(cols[0].type, vals, nulls, d, vrange, srt)


def column_data_from_column(col) -> ColumnData:
    """data/page.py Column -> ColumnData (numpy views; recursive)."""
    return ColumnData(
        col.type,
        np.asarray(col.values),
        np.asarray(col.nulls) if col.nulls is not None else None,
        col.dictionary,
        col.vrange,
        children=(
            [column_data_from_column(k) for k in col.children]
            if col.children is not None
            else None
        ),
        hi=np.asarray(col.hi) if col.hi is not None else None,
    )


def column_data_slice(cd: ColumnData, lo: int, hi: int) -> ColumnData:
    """Row-range slice [lo, hi) — offset-aware for nested columns (child
    flats are sliced by the parent lengths' prefix sums)."""
    nulls = cd.nulls[lo:hi] if cd.nulls is not None else None
    if cd.children is None:
        return ColumnData(cd.type, cd.values[lo:hi], nulls, cd.dictionary,
                          cd.vrange, cd.sorted,
                          hi=cd.hi[lo:hi] if cd.hi is not None else None)
    if cd.type.is_row:
        kids = [column_data_slice(k, lo, hi) for k in cd.children]
        return ColumnData(cd.type, cd.values[lo:hi], nulls, children=kids)
    off = np.concatenate(
        [np.zeros(1, np.int64), np.cumsum(np.asarray(cd.values, dtype=np.int64))]
    )
    clo, chi = int(off[lo]), int(off[hi])
    kids = [column_data_slice(k, clo, chi) for k in cd.children]
    return ColumnData(cd.type, cd.values[lo:hi], nulls, children=kids)


def column_data_take(cd: ColumnData, idx: np.ndarray) -> ColumnData:
    """Row gather (indices or bool mask) — limb- and nested-aware (the
    ColumnData analog of data/page.py host_take)."""
    if idx.dtype == np.bool_:
        idx = np.nonzero(idx)[0]
    nulls = np.asarray(cd.nulls)[idx] if cd.nulls is not None else None
    if cd.children is not None and not cd.type.is_row:
        lens = np.asarray(cd.values, dtype=np.int64)
        off = np.concatenate([np.zeros(1, np.int64), np.cumsum(lens)])
        child_idx = (
            np.concatenate([np.arange(off[i], off[i + 1], dtype=np.int64) for i in idx])
            if len(idx)
            else np.zeros(0, np.int64)
        )
        kids = [column_data_take(k, child_idx) for k in cd.children]
        return ColumnData(cd.type, lens[idx].astype(np.int32), nulls, children=kids)
    kids = (
        [column_data_take(k, idx) for k in cd.children]
        if cd.children is not None
        else None
    )
    # idx from a mask (or any ascending index list) preserves row order, so
    # the sorted-input flag survives; arbitrary permutations must clear it
    order_preserving = len(idx) < 2 or bool(np.all(np.diff(idx) >= 0))
    return ColumnData(
        cd.type,
        np.asarray(cd.values)[idx],
        nulls,
        cd.dictionary,
        cd.vrange,
        cd.sorted and order_preserving,
        children=kids,
        hi=np.asarray(cd.hi)[idx] if cd.hi is not None else None,
    )


class LiveTableProvider:
    """Live-row source for a connector whose tables materialize at SCAN
    time from running-process state instead of stored pages (reference:
    the coordinator-state feeds behind ``connector/system/``'s
    ``QuerySystemTable``/``NodeSystemTable``). The provider contract:

    - ``snapshot_rows`` returns a CONSISTENT point-in-time row list and
      must never hold engine-wide locks while building it (snapshot the
      registry under its lock, compute rows outside), so a query scanning
      the live table that describes itself neither deadlocks nor observes
      a torn state;
    - ``procedure`` resolves a named procedure to a callable
      ``fn(session, *args) -> message`` or None (the CALL surface).
    """

    def snapshot_rows(self, schema: str, table: str) -> List[tuple]:
        raise NotImplementedError

    def procedure(self, schema: str, name: str):
        return None


class Connector:
    """Reference: spi/Plugin.java -> ConnectorFactory -> Connector."""

    # connectors whose schemas each hold exactly one relation named like
    # the schema (the jmx-connector shape) declare this so the planner's
    # two-part-name fallback (``system.metrics`` -> system.metrics.metrics)
    # applies ONLY to them — never silently rerouting a typo'd schema name
    # against ordinary multi-table catalogs
    single_table_schemas = False

    name: str = "connector"
    # True when table state lives only in the creating process (e.g. the
    # in-memory connector): the coordinator must not distribute scans to
    # workers, whose catalog instances would be empty.
    coordinator_only: bool = False
    # True when the connector supports explicit transactions via the
    # copy-on-write overlay protocol (exec/transaction.py; reference:
    # Connector.beginTransaction / isSingleStatementWritesOnly)
    supports_transactions: bool = False

    # --- metadata (ConnectorMetadata) ---
    def list_schemas(self) -> List[str]:
        raise NotImplementedError

    def list_tables(self, schema: str) -> List[str]:
        raise NotImplementedError

    def get_table(self, schema: str, table: str) -> Optional[TableMetadata]:
        raise NotImplementedError

    def table_row_count(self, schema: str, table: str) -> Optional[int]:
        """Stats for the cost-based optimizer (reference: spi/statistics/)."""
        return None

    def column_stats(self, schema: str, table: str, column: str) -> Optional["ColumnStats"]:
        """Per-column statistics for the cost-based optimizer: storage-repr
        (min, max) and distinct-value estimate (reference:
        spi/statistics/ColumnStatistics — low/high value + NDV)."""
        return None

    def primary_key(self, schema: str, table: str) -> Optional[List[str]]:
        """Unique key columns, if any — drives join build-side selection
        (reference: uniqueness constraints via
        spi/connector/ConnectorMetadata getTableProperties)."""
        return None

    def data_version(self, schema: str, table: str) -> Optional[str]:
        """Cheap opaque token that changes whenever the table's DATA (or
        existence/shape) changes — the query cache's invalidation handle
        (trino_tpu/cache/): versions are captured into cache keys at plan
        time, so a mutation makes the next identical query fingerprint
        differently and stale entries miss naturally. Immutable catalogs
        (tpch/tpcds generators) return a constant; stateful ones bump a
        counter (memory) or derive from storage state (filesystem file
        mtime+size). None (the default) means "unversioned": the engine
        cannot invalidate, so queries over this table bypass the cache."""
        return None

    # --- pushdown negotiation (ConnectorMetadata.apply*) ---
    # Each apply_* returns a NEW opaque table handle when the connector can
    # serve the narrowed request, or None to decline; the engine stores the
    # handle on the scan node and keeps its own enforcing operator (split
    # semantics make connector guarantees per-split, not global), exactly
    # like the reference keeps the plan node unless the handle is
    # guaranteed (ConnectorMetadata.java:80 applyLimit/applyTopN/
    # applyAggregation contracts).
    def apply_limit(self, schema: str, table: str, handle, count: int):
        return None

    def apply_topn(self, schema: str, table: str, handle, count: int,
                   order: List["SortItem"]):
        return None

    def apply_aggregation(self, schema: str, table: str, handle,
                          group_columns: List[str],
                          aggregates: List["AggregateSpec"]):
        """-> (handle, output ColumnMetadata list) or None. Output columns
        must be [group columns..., one per aggregate...], with values the
        ENGINE's exact semantics — a connector whose arithmetic differs
        (e.g. float sums for decimals) must decline."""
        return None

    def table_partitioning(self, schema: str, table: str) -> Optional["TablePartitioning"]:
        """Physical partitioning for co-located joins, if any."""
        return None

    def table_function(self, name: str):
        """Connector-provided table function, or None (reference:
        spi/function/table/ConnectorTableFunction). The returned callable
        takes (positional_args, named_args) and returns (column names,
        column types, rows)."""
        return None

    def procedure(self, schema: str, name: str):
        """Connector-provided procedure for ``CALL catalog.schema.name(...)``
        or None (reference: spi/procedure/Procedure + CallTask). The
        returned callable takes ``(session, *constant_args)`` and returns
        an optional result message."""
        return None

    def attach_live_provider(self, provider: "LiveTableProvider") -> None:
        """Bind a LiveTableProvider to this connector (the server that owns
        the live state injects itself after constructing its catalog map).
        Only live-table connectors accept one."""
        raise NotImplementedError(
            f"{self.name}: connector does not accept a live table provider")

    # --- splits (ConnectorSplitManager) ---
    def get_splits(
        self, schema: str, table: str, target_splits: int, constraint=None,
        handle=None,
    ) -> List[Split]:
        """``constraint`` is an ADVISORY TupleDomain (connector/predicate.py;
        reference: ConnectorMetadata.applyFilter + the DynamicFilter the
        split manager receives): a connector may use it to skip splits but
        the engine keeps the enforcing filter, so ignoring it is correct.
        ``handle`` is the pushdown handle minted by apply_* (if any); a
        connector embeds it in Split.info so scan() sees it."""
        raise NotImplementedError

    # --- data (ConnectorPageSource) ---
    def scan(self, split: Split, columns: List[str], constraint=None) -> Dict[str, ColumnData]:
        """``constraint`` as in get_splits — advisory row-reduction only."""
        raise NotImplementedError

    # --- writes (ConnectorMetadata DDL + ConnectorPageSink) ---
    def create_table(self, schema: str, name: str, schema_def, rows) -> None:
        """CREATE TABLE [AS]: register a table with the given columns and
        initial rows (reference: ConnectorMetadata.createTable /
        beginCreateTable + ConnectorPageSink)."""
        raise NotImplementedError(f"{self.name}: connector does not support CREATE TABLE")

    def insert_rows(self, schema: str, table: str, rows) -> int:
        """INSERT: append Python-value rows in table column order; returns
        the row count (reference: beginInsert/finishInsert + page sink)."""
        raise NotImplementedError(f"{self.name}: connector does not support INSERT")

    def drop_table(self, schema: str, table: str) -> None:
        raise NotImplementedError(f"{self.name}: connector does not support DROP TABLE")

    def overwrite_rows(self, schema: str, table: str, rows) -> None:
        """Replace the table's contents with ``rows`` (engine-computed
        DELETE/UPDATE rewrite: the engine evaluates the surviving/modified
        row set with its full expression machinery and hands the result
        back — the whole-table analog of the reference's row-change
        machinery, ConnectorMetadata.beginMerge/MergeSink)."""
        raise NotImplementedError(
            f"{self.name}: connector does not support DELETE/UPDATE")
