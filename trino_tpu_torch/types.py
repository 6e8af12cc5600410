"""SQL type system.

Reference: Trino's SPI types (``core/trino-spi/src/main/java/io/trino/spi/type/``,
~90 files: BigintType, IntegerType, DoubleType, BooleanType, VarcharType,
DateType, DecimalType via Int128, TimestampType, ...). Here each SQL type maps
to a fixed-width device representation (TPUs want fixed-width):

- BOOLEAN            -> bool_
- TINYINT/SMALLINT/INTEGER/BIGINT -> int8/int16/int32/int64
- REAL/DOUBLE        -> float32/float64
- DATE               -> int32 (days since 1970-01-01)
- TIMESTAMP(6)       -> int64 (microseconds since epoch)
- DECIMAL(p, s)      -> int64 scaled by 10**s, plus an adaptive high limb
                        for p > 18 columns whose data exceeds int64
                        (ops/int128.py, reference Int128Math.java); results
                        past 10^38 raise DECIMAL_OVERFLOW (see decimal())
- VARCHAR/CHAR       -> int32 dictionary codes; the dictionary (the actual
                        UTF-8 strings) lives host-side (data/dictionary.py).
                        TPUs excel at fixed width; strings are dictionary-first
                        (SURVEY.md §7.1).

Nulls are carried out-of-band as boolean masks on columns, three-valued logic
is implemented in the expression lowering (ops/expr_lower.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Type:
    """A SQL type. Instances are interned/compared by value."""

    name: str  # canonical SQL name, e.g. "bigint", "varchar", "decimal(15,2)"
    np_dtype: Optional[np.dtype]  # device representation; None => not yet supported
    comparable: bool = True
    orderable: bool = True

    def __str__(self) -> str:
        return self.name

    @property
    def is_varchar(self) -> bool:
        # "varchar-kind" = dictionary-coded on device (int32 codes, values
        # host-side). VARBINARY deliberately rides the same machinery —
        # its dictionary stores hex encodings, decoded to bytes at the
        # boundary (to_python/literals) — so joins/grouping/serde work
        # unchanged (reference: VarbinaryType is its own Block type there;
        # here the fixed-width dictionary layout is the TPU-first choice
        # for ALL variable-width values).
        return (self.name.startswith("varchar") or self.name.startswith("char")
                or self.name == "varbinary")

    @property
    def is_varbinary(self) -> bool:
        return self.name == "varbinary"

    @property
    def is_timestamp(self) -> bool:
        return self.name.startswith("timestamp")

    @property
    def is_decimal(self) -> bool:
        return self.name.startswith("decimal")

    @property
    def is_integer_kind(self) -> bool:
        return self.name in ("tinyint", "smallint", "integer", "bigint")

    @property
    def is_floating(self) -> bool:
        return self.name in ("real", "double")

    @property
    def is_numeric(self) -> bool:
        return self.is_integer_kind or self.is_floating or self.is_decimal

    @property
    def is_array(self) -> bool:
        return self.name.startswith("array(")

    @property
    def is_map(self) -> bool:
        return self.name.startswith("map(")

    @property
    def is_row(self) -> bool:
        return self.name.startswith("row(")

    @property
    def is_nested(self) -> bool:
        """Container types: device layout is per-row lengths (int32) plus
        flattened child columns (data/page.py Column.children)."""
        return self.is_array or self.is_map or self.is_row


BOOLEAN = Type("boolean", np.dtype(np.bool_))
TINYINT = Type("tinyint", np.dtype(np.int8))
SMALLINT = Type("smallint", np.dtype(np.int16))
INTEGER = Type("integer", np.dtype(np.int32))
BIGINT = Type("bigint", np.dtype(np.int64))
REAL = Type("real", np.dtype(np.float32))
DOUBLE = Type("double", np.dtype(np.float64))
DATE = Type("date", np.dtype(np.int32))
UNKNOWN = Type("unknown", None)  # type of NULL literal before coercion
# VARBINARY: dictionary-coded like varchar; dictionary entries are HEX
# strings of the bytes (lexicographic hex order == bytes order, so sorts
# and range comparisons agree with the reference's unsigned-byte order).
VARBINARY = Type("varbinary", np.dtype(np.int32), orderable=True)


@dataclasses.dataclass(frozen=True)
class TimestampType(Type):
    """timestamp(p) [with time zone]. Reference: ``spi/type/TimestampType``
    / ``TimestampWithTimeZoneType`` (p in 0..12 there; 0..9 here — the
    picosecond tail would not fit the int64 epoch span). Storage: int64
    count of 10^-p second units since the epoch, UTC. The tz variant
    stores the UTC instant; zone is rendering metadata (the reference
    packs a zone id per value — a fixed-offset subset is supported via
    AT TIME ZONE)."""

    precision: int = 6
    with_tz: bool = False

    def __str__(self) -> str:
        return self.name


def timestamp(precision: int = 6, with_tz: bool = False) -> TimestampType:
    if not 0 <= precision <= 9:
        raise ValueError(f"timestamp precision out of range: {precision}")
    name = f"timestamp({precision})" + (" with time zone" if with_tz else "")
    return TimestampType(name=name, np_dtype=np.dtype(np.int64),
                         precision=precision, with_tz=with_tz)


# TIMESTAMP(6) — microsecond precision, the engine default.
TIMESTAMP = timestamp(6)


@dataclasses.dataclass(frozen=True)
class DecimalType(Type):
    precision: int = 38
    scale: int = 0

    def __str__(self) -> str:
        return self.name


def decimal(precision: int, scale: int) -> DecimalType:
    if not 1 <= precision <= 38:
        raise ValueError(f"decimal precision out of range: {precision}")
    # Storage is a scaled int64, plus an ADAPTIVE second limb for p > 18
    # columns whose data exceeds int64 (data/page.py Column.hi — the
    # reference's short/long decimal split, spi/type/Int128.java, decided
    # per column from the data). Arithmetic routes through the int128 limb
    # kernels (ops/int128.py, reference Int128Math.java); results past the
    # 10^38 cap raise the deferred DECIMAL_OVERFLOW error.
    return DecimalType(
        name=f"decimal({precision},{scale})",
        np_dtype=np.dtype(np.int64),
        precision=precision,
        scale=scale,
    )


@dataclasses.dataclass(frozen=True)
class VarcharType(Type):
    length: Optional[int] = None  # None = unbounded

    def __str__(self) -> str:
        return self.name


def varchar(length: Optional[int] = None) -> VarcharType:
    name = "varchar" if length is None else f"varchar({length})"
    return VarcharType(name=name, np_dtype=np.dtype(np.int32), length=length)


def char(length: int) -> VarcharType:
    # CHAR semantics (pad/compare) are normalized to varchar at load time.
    return VarcharType(name=f"char({length})", np_dtype=np.dtype(np.int32), length=length)


VARCHAR = varchar()


@dataclasses.dataclass(frozen=True)
class ArrayType(Type):
    """array(E). Reference: ``spi/type/ArrayType.java`` + ``spi/block/
    ArrayBlock.java`` (offsets + element block). Device layout here is
    struct-of-arrays: per-row int32 *lengths* ride ``Column.values`` (offsets
    are their prefix sum) and the flattened elements ride ``Column.children
    [0]`` — lengths rather than offsets so a length-n column keeps n slots
    and every row-parallel kernel (sel masks, null masks) applies unchanged."""

    element: Optional["Type"] = None


def array_of(element: Type) -> ArrayType:
    return ArrayType(
        name=f"array({element.name})",
        np_dtype=np.dtype(np.int32),  # physical: per-row element count
        orderable=False,
        element=element,
    )


@dataclasses.dataclass(frozen=True)
class MapType(Type):
    """map(K, V). Reference: ``spi/type/MapType.java`` / ``MapBlock.java``.
    Layout: per-row entry counts + two flattened children (keys, values)."""

    key: Optional["Type"] = None
    value: Optional["Type"] = None


def map_of(key: Type, value: Type) -> MapType:
    return MapType(
        name=f"map({key.name}, {value.name})",
        np_dtype=np.dtype(np.int32),
        comparable=False,
        orderable=False,
        key=key,
        value=value,
    )


@dataclasses.dataclass(frozen=True)
class RowType(Type):
    """row(f1 T1, ...). Reference: ``spi/type/RowType.java`` / ``RowBlock``.
    Layout: one child column per field (no lengths; ``Column.values`` is a
    placeholder zeros array so row-count machinery keeps working)."""

    field_names: Tuple[str, ...] = ()
    field_types: Tuple["Type", ...] = ()


def row_of(fields) -> RowType:
    """fields: sequence of (name|None, Type)."""
    names = tuple(n if n is not None else f"field{i}" for i, (n, _) in enumerate(fields))
    ftypes = tuple(t for _, t in fields)
    inner = ", ".join(
        f"{n} {t.name}" if n is not None else t.name for (n, _), t in zip(fields, ftypes)
    )
    return RowType(
        name=f"row({inner})",
        np_dtype=np.dtype(np.int8),
        orderable=False,
        field_names=names,
        field_types=ftypes,
    )


def type_children(t: Type):
    """The flattened child types a nested column carries, in child order."""
    if isinstance(t, ArrayType):
        return [t.element]
    if isinstance(t, MapType):
        return [t.key, t.value]
    if isinstance(t, RowType):
        return list(t.field_types)
    return []


import re as _re

_TS_RE = _re.compile(r"timestamp(?:\((\d+)\))?( with time zone)?")


def parse_type(s: str) -> Type:
    """Parse a SQL type string, e.g. ``decimal(15,2)``, ``varchar(25)``."""
    s = s.strip().lower()
    simple = {
        "boolean": BOOLEAN,
        "tinyint": TINYINT,
        "smallint": SMALLINT,
        "int": INTEGER,
        "integer": INTEGER,
        "bigint": BIGINT,
        "real": REAL,
        "double": DOUBLE,
        "double precision": DOUBLE,
        "date": DATE,
        "timestamp": TIMESTAMP,
        "varchar": VARCHAR,
        "varbinary": VARBINARY,
        "unknown": UNKNOWN,
    }
    if s in simple:
        return simple[s]
    m = _TS_RE.fullmatch(s)
    if m:
        p = int(m.group(1)) if m.group(1) is not None else 6
        return timestamp(p, with_tz=m.group(2) is not None)
    if s.startswith("decimal(") and s.endswith(")"):
        p, sc = s[len("decimal(") : -1].split(",")
        return decimal(int(p), int(sc))
    if s.startswith("varchar(") and s.endswith(")"):
        return varchar(int(s[len("varchar(") : -1]))
    if s.startswith("char(") and s.endswith(")"):
        return char(int(s[len("char(") : -1]))
    if s.startswith("array(") and s.endswith(")"):
        return array_of(parse_type(s[len("array(") : -1]))
    if s.startswith("map(") and s.endswith(")"):
        k, v = _split_top_level(s[len("map(") : -1])
        return map_of(parse_type(k), parse_type(v))
    if s.startswith("row(") and s.endswith(")"):
        fields = []
        for part in _split_all_top_level(s[len("row(") : -1]):
            part = part.strip()
            # "name type" or bare "type"
            sp = part.find(" ")
            if sp > 0 and not part[:sp].endswith("("):
                try:
                    fields.append((part[:sp], parse_type(part[sp + 1 :])))
                    continue
                except ValueError:
                    pass
            fields.append((None, parse_type(part)))
        return row_of(fields)
    raise ValueError(f"unknown type: {s}")


def _split_all_top_level(s: str):
    """Split on commas not nested inside parentheses."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(s):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(s[start:i])
            start = i + 1
    parts.append(s[start:])
    return parts


def _split_top_level(s: str):
    parts = _split_all_top_level(s)
    if len(parts) != 2:
        raise ValueError(f"expected two type arguments in {s!r}")
    return parts[0].strip(), parts[1].strip()


# ---------------------------------------------------------------------------
# Type coercion (reference: io.trino.type.TypeCoercion / function resolution in
# core/trino-main/.../metadata — simplified numeric promotion lattice).
# ---------------------------------------------------------------------------

_INT_ORDER = ["tinyint", "smallint", "integer", "bigint"]


def common_super_type(a: Type, b: Type) -> Optional[Type]:
    """Least common type two operands coerce to, or None if incompatible."""
    if a == b:
        return a
    if a == UNKNOWN:
        return b
    if b == UNKNOWN:
        return a
    if a.is_integer_kind and b.is_integer_kind:
        ia, ib = _INT_ORDER.index(a.name), _INT_ORDER.index(b.name)
        return parse_type(_INT_ORDER[max(ia, ib)])
    if a.is_floating and b.is_floating:
        return DOUBLE
    if (a.is_floating and b.is_numeric) or (b.is_floating and a.is_numeric):
        return DOUBLE if DOUBLE in (a, b) or a.is_decimal or b.is_decimal else REAL
    if a.is_decimal and b.is_integer_kind:
        return _decimal_int_super(a, b)
    if b.is_decimal and a.is_integer_kind:
        return _decimal_int_super(b, a)
    if a.is_decimal and b.is_decimal:
        assert isinstance(a, DecimalType) and isinstance(b, DecimalType)
        scale = max(a.scale, b.scale)
        ip = max(a.precision - a.scale, b.precision - b.scale)
        return decimal(min(38, ip + scale), scale)
    if a.is_varchar and b.is_varchar:
        return VARCHAR
    if isinstance(a, ArrayType) and isinstance(b, ArrayType):
        e = common_super_type(a.element, b.element)
        return array_of(e) if e is not None else None
    if isinstance(a, MapType) and isinstance(b, MapType):
        k = common_super_type(a.key, b.key)
        v = common_super_type(a.value, b.value)
        return map_of(k, v) if k is not None and v is not None else None
    if isinstance(a, TimestampType) and isinstance(b, TimestampType):
        if a.with_tz != b.with_tz:
            return None
        return timestamp(max(a.precision, b.precision), a.with_tz)
    if a == DATE and isinstance(b, TimestampType) and not b.with_tz:
        return b
    if b == DATE and isinstance(a, TimestampType) and not a.with_tz:
        return a
    return None


def _decimal_int_super(d: Type, i: Type) -> Type:
    assert isinstance(d, DecimalType)
    int_digits = {"tinyint": 3, "smallint": 5, "integer": 10, "bigint": 19}[i.name]
    ip = max(d.precision - d.scale, int_digits)
    return decimal(min(38, ip + d.scale), d.scale)
