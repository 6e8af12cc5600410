"""Table functions (polymorphic table function invocation): a copy of
trino_tpu/exec/table_functions.py.

Reference: ``spi/function/table/`` (ConnectorTableFunction,
TableFunctionProcessorProvider) + the built-in ``sequence`` /
``exclude_columns`` functions under ``operator/table/``. Resolution order:
the session's current catalog connector first (the SPI hook
``Connector.table_function``), then the engine built-ins — mirroring the
reference's catalog-scoped function resolution.

A table function here returns (column names, column types, rows); the
planner materializes it as a constant relation. Functions over TABLE
arguments (exclude_columns' input => TABLE(...)) are not yet modeled —
the argument grammar accepts scalar positional/named arguments.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from trino_tpu_torch import types as T

MAX_ROWS = 10_000_000  # generation guard for sequence()


class TableFunctionError(ValueError):
    pass


def _sequence(args: List, named: Dict) -> Tuple[List[str], List[T.Type], List[tuple]]:
    """sequence(start, stop[, step]) -> one bigint column
    ``sequential_number``, inclusive bounds (reference:
    operator/table/Sequence.java semantics). Positional and named
    arguments MERGE by parameter position (mixing is fine; providing the
    same parameter both ways is an error)."""
    slots = {"start": None, "stop": None, "step": None}
    order = ("start", "stop", "step")
    if len(args) > 3:
        raise TableFunctionError("sequence(start, stop[, step])")
    for pos, v in enumerate(args):
        slots[order[pos]] = v
    for k, v in named.items():
        if k not in slots:
            raise TableFunctionError(f"sequence() has no parameter {k!r}")
        if slots[k] is not None:
            raise TableFunctionError(
                f"sequence() parameter {k!r} given both positionally and by name")
        slots[k] = v
    if slots["stop"] is None:
        raise TableFunctionError("sequence() needs stop")
    start = slots["start"] if slots["start"] is not None else 0
    stop = slots["stop"]
    step = slots["step"] if slots["step"] is not None else 1
    start, stop, step = int(start), int(stop), int(step)
    if step == 0:
        raise TableFunctionError("sequence() step must not be zero")
    n = max(0, (stop - start) // step + 1)
    if n > MAX_ROWS:
        raise TableFunctionError(
            f"sequence() would produce {n} rows (limit {MAX_ROWS})")
    rows = [(start + i * step,) for i in range(n)]
    return ["sequential_number"], [T.BIGINT], rows


_BUILTINS = {
    "sequence": _sequence,
}


def resolve(session, name: str, args: List, named: Dict
            ) -> Tuple[List[str], List[T.Type], List[tuple]]:
    """Evaluate table function ``name`` with constant arguments."""
    catalog = (session.properties or {}).get("catalog")
    conn = session.catalogs.get(catalog) if catalog else None
    if conn is not None:
        fn = conn.table_function(name)
        if fn is not None:
            return fn(args, named)
    builtin = _BUILTINS.get(name)
    if builtin is None:
        raise TableFunctionError(f"unknown table function: {name}")
    return builtin(args, named)
