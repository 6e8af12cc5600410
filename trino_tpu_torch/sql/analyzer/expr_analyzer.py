"""Expression analysis: parser AST -> typed IR.

Reference: ``core/trino-main/.../sql/analyzer/ExpressionAnalyzer.java``
(3,954 lines) — name resolution against scopes, literal typing, operator
type derivation (decimal precision/scale rules verified against
``io/trino/type/DecimalOperators.java:75,156,236,319,489``), coercion
insertion, and aggregate-call detection.
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.sql import ir
from trino_tpu_torch.sql.analyzer.scope import AnalysisError, Field, Scope
from trino_tpu_torch.sql.parser import ast

# prepared-statement parameter types, scoped to one planning run
# (sql/parser Parameter nodes carry only an index; the types come from the
# EXECUTE binding that triggered planning — server/prepared.py /
# exec/query.py set them around Planner.plan). A contextvar, not a
# constructor argument: ExprAnalyzer is instantiated at dozens of planner
# sites and every one of them must see the same binding.
import contextlib
import contextvars

_PARAM_TYPES: "contextvars.ContextVar[Optional[Tuple[T.Type, ...]]]" = \
    contextvars.ContextVar("prepared_parameter_types", default=None)


@contextlib.contextmanager
def parameter_types(types):
    """Make prepared-statement parameter types visible to every
    ExprAnalyzer created inside the block (one planning run)."""
    token = _PARAM_TYPES.set(tuple(types))
    try:
        yield
    finally:
        _PARAM_TYPES.reset(token)


AGGREGATE_FUNCTIONS = {
    "count", "sum", "avg", "min", "max",
    "stddev", "stddev_samp", "stddev_pop",
    "variance", "var_samp", "var_pop",
    "approx_distinct",
    "approx_percentile",
    "array_agg",
    "bool_and", "bool_or", "every",
    "count_if",
    "arbitrary", "any_value",
    "geometric_mean",
    "checksum",
    "min_by", "max_by",
    "corr", "covar_samp", "covar_pop", "regr_slope", "regr_intercept",
    "histogram", "map_agg",
}

_MONTH_UNITS = {"year": 12, "month": 1}
_DAY_UNITS = {"day": 1}
_SECOND_UNITS = {"day": 86_400, "hour": 3_600, "minute": 60, "second": 1}


def _zone_offset_seconds(zone: str) -> int:
    """Fixed-offset zone id -> seconds east of UTC. 'UTC'/'Z' and
    '[+-]HH:MM' are supported; region ids with DST rules would need
    per-value offsets (documented limitation)."""
    z = zone.strip().upper()
    if z in ("UTC", "Z", "+00:00", "-00:00"):
        return 0
    import re as _re

    m = _re.fullmatch(r"([+-])(\d{2}):(\d{2})", z)
    if not m:
        raise AnalysisError(
            f"unsupported time zone {zone!r} (fixed offsets and UTC only)")
    sign = 1 if m.group(1) == "+" else -1
    return sign * (int(m.group(2)) * 3600 + int(m.group(3)) * 60)


def _timestamp_literal(text: str) -> ir.Constant:
    """TIMESTAMP 'YYYY-MM-DD hh:mm:ss[.fff][+HH:MM]' — precision inferred
    from the fractional digits (0 -> 0, <=3 -> 3, <=6 -> 6, else 9); a
    trailing offset makes it WITH TIME ZONE, normalized to UTC storage
    (reference: TimestampType literal analysis)."""
    s = text.strip().replace(" ", "T", 1) if " " in text.strip() else text.strip()
    frac = ""
    parse_s = s
    dot = s.find(".")
    if dot > 0:
        head, tail = s[:dot], s[dot + 1:]
        rest = ""
        for i, c in enumerate(tail):
            if not c.isdigit():
                frac, rest = tail[:i], tail[i:]
                break
        else:
            frac = tail
        if frac:
            # SQL allows 1..12 fractional digits but Python 3.10's
            # fromisoformat accepts exactly 3 or 6 — normalize for the
            # parse only; `frac` keeps the written digits for precision
            # inference (and the p=9 sub-microsecond remainder below)
            norm = frac[:6].ljust(6 if len(frac) > 3 else 3, "0")
            parse_s = f"{head}.{norm}{rest}"
    try:
        v = datetime.datetime.fromisoformat(parse_s)
    except ValueError:
        raise AnalysisError(f"invalid timestamp literal {text!r}") from None
    p = 0 if not frac else (3 if len(frac) <= 3 else (6 if len(frac) <= 6 else 9))
    with_tz = v.tzinfo is not None
    if with_tz:
        v = v.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    epoch = datetime.datetime(1970, 1, 1)
    delta = v - epoch
    micros = (delta.days * 86_400_000_000 + delta.seconds * 1_000_000
              + delta.microseconds)
    unit = 10 ** p
    extra = 0
    if p == 9 and len(frac) > 6:
        extra = int(frac[6:9].ljust(3, "0"))
    value = micros * unit // 1_000_000 + extra
    return ir.Constant(T.timestamp(p, with_tz), value)


def analyze_literal(lit: ast.Literal) -> ir.Constant:
    if lit.kind == "null":
        return ir.Constant(T.UNKNOWN, None)
    if lit.kind == "boolean":
        return ir.Constant(T.BOOLEAN, bool(lit.value))
    if lit.kind == "string":
        return ir.Constant(T.varchar(), lit.value)
    if lit.kind == "date":
        days = (datetime.date.fromisoformat(lit.value) - datetime.date(1970, 1, 1)).days
        return ir.Constant(T.DATE, days)
    if lit.kind == "timestamp":
        return _timestamp_literal(str(lit.value))
    if lit.kind == "varbinary":
        hexs = str(lit.value).replace(" ", "").lower()
        try:
            bytes.fromhex(hexs)
        except ValueError:
            raise AnalysisError(f"invalid varbinary literal X'{lit.value}'") from None
        # dictionary repr is the hex string (see types.VARBINARY)
        return ir.Constant(T.VARBINARY, hexs)
    if lit.kind == "number":
        text = str(lit.value)
        if "e" in text.lower():
            return ir.Constant(T.DOUBLE, float(text))
        if "." in text:
            intpart, frac = text.split(".")
            scale = len(frac)
            digits = len((intpart.lstrip("-").lstrip("0") or "")) + scale
            digits = max(digits, scale + 1 if intpart.strip("-0") == "" else digits)
            p = max(1, min(38, digits))
            return ir.Constant(T.decimal(p, scale), int(round(float(text) * 10**scale)))
        v = int(text)
        typ = T.INTEGER if -(2**31) <= v < 2**31 else T.BIGINT
        return ir.Constant(typ, v)
    raise AnalysisError(f"unsupported literal kind {lit.kind}")


def arithmetic_result_type(op: str, a: T.Type, b: T.Type) -> T.Type:
    if a == T.UNKNOWN:
        a = b
    if b == T.UNKNOWN:
        b = a
    if a == T.DATE or b == T.DATE:
        # date +/- integer days
        if op in ("+", "-") and (a == T.DATE) != (b == T.DATE):
            return T.DATE
        if op == "-" and a == T.DATE and b == T.DATE:
            return T.BIGINT  # day difference (Trino returns interval day)
        raise AnalysisError(f"cannot apply {op} to {a}, {b}")
    if a.is_floating or b.is_floating:
        return T.DOUBLE if T.DOUBLE in (a, b) or a.is_decimal or b.is_decimal else T.REAL
    if a.is_decimal or b.is_decimal:
        pa, sa = _prec_scale(a)
        pb, sb = _prec_scale(b)
        # verified against reference DecimalOperators.java result signatures
        if op in ("+", "-"):
            s = max(sa, sb)
            return T.decimal(min(38, max(pa - sa, pb - sb) + s + 1), s)
        if op == "*":
            return T.decimal(min(38, pa + pb), sa + sb)
        if op == "/":
            return T.decimal(min(38, pa + sb + max(0, sb - sa)), max(sa, sb))
        if op == "%":
            return T.decimal(min(pb - sb, pa - sa) + max(sa, sb), max(sa, sb))
    out = T.common_super_type(a, b)
    if out is None or not out.is_numeric:
        raise AnalysisError(f"cannot apply {op} to {a}, {b}")
    return out


def _prec_scale(t: T.Type) -> Tuple[int, int]:
    if isinstance(t, T.DecimalType):
        return t.precision, t.scale
    return {"tinyint": 3, "smallint": 5, "integer": 10, "bigint": 19}[t.name], 0


def aggregate_result_type(
    fn: str, arg: Optional[T.Type], arg2: Optional[T.Type] = None
) -> T.Type:
    """Reference: operator/aggregation function signatures."""
    if fn == "count":
        return T.BIGINT
    assert arg is not None
    if fn in ("bool_and", "bool_or", "every"):
        if arg != T.BOOLEAN:
            raise AnalysisError(f"{fn}() expects a boolean argument")
        return T.BOOLEAN
    if fn == "count_if":
        if arg != T.BOOLEAN:
            raise AnalysisError("count_if() expects a boolean argument")
        return T.BIGINT
    if fn in ("arbitrary", "any_value"):
        return arg
    if fn == "geometric_mean":
        if not arg.is_numeric:
            raise AnalysisError(f"geometric_mean() not defined for {arg}")
        return T.DOUBLE
    if fn == "checksum":
        return T.BIGINT
    if fn in ("min_by", "max_by"):
        assert arg2 is not None
        if not arg2.orderable:
            raise AnalysisError(f"{fn}() ordering argument {arg2} is not orderable")
        return arg
    if fn in ("corr", "covar_samp", "covar_pop", "regr_slope", "regr_intercept"):
        assert arg2 is not None
        if not (arg.is_numeric and arg2.is_numeric):
            raise AnalysisError(f"{fn}() expects numeric arguments")
        return T.DOUBLE
    if fn == "histogram":
        if not arg.comparable:
            raise AnalysisError(f"histogram() argument {arg} is not comparable")
        return T.map_of(arg, T.BIGINT)
    if fn == "map_agg":
        assert arg2 is not None
        return T.map_of(arg, arg2)
    if fn == "sum":
        if arg.is_decimal:
            return T.decimal(38, arg.scale)
        if arg.is_floating:
            return T.DOUBLE
        if arg.is_integer_kind:
            return T.BIGINT
        raise AnalysisError(f"sum() not defined for {arg}")
    if fn == "avg":
        if arg.is_decimal:
            return arg
        return T.DOUBLE
    if fn in ("min", "max"):
        return arg
    if fn in ("stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop"):
        if not arg.is_numeric:
            raise AnalysisError(f"{fn}() not defined for {arg}")
        return T.DOUBLE
    if fn == "approx_distinct":
        return T.BIGINT
    if fn == "approx_percentile":
        if not arg.is_numeric:
            raise AnalysisError(f"approx_percentile() not defined for {arg}")
        return arg
    if fn == "array_agg":
        return T.array_of(arg)
    raise AnalysisError(f"unknown aggregate {fn}")


_COMPARISON_OPS = {"=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}
_ARITH_OPS = {"+": "add", "-": "sub", "*": "mul", "/": "div", "%": "mod"}


class ExprAnalyzer:
    """Analyzes one expression against a scope.

    ``replacements`` maps AST subtrees (by structural equality) to
    pre-computed IR — used by the planner to substitute group-by keys and
    aggregate calls with their output channels in post-aggregation
    expressions (reference: QueryPlanner's TranslationMap).
    """

    def __init__(
        self,
        scope: Scope,
        replacements: Optional[Dict[ast.Expression, ir.Expr]] = None,
        allow_aggregates: bool = False,
    ):
        self.scope = scope
        self.replacements = replacements or {}
        self.allow_aggregates = allow_aggregates
        self.outer_refs: List[ir.OuterRef] = []  # correlated refs seen
        self.subqueries: List[Tuple[ast.Expression, object]] = []

    def analyze(self, e: ast.Expression) -> ir.Expr:
        if e in self.replacements:
            return self.replacements[e]
        return self._analyze(e)

    def _analyze(self, e: ast.Expression) -> ir.Expr:
        if isinstance(e, ast.Literal):
            return analyze_literal(e)
        if isinstance(e, ast.Parameter):
            types = _PARAM_TYPES.get()
            if types is None:
                raise AnalysisError(
                    "parameter markers (?) are only valid inside a prepared "
                    "statement executed with EXECUTE ... USING")
            if e.index >= len(types):
                raise AnalysisError(
                    f"prepared statement requires at least {e.index + 1} "
                    f"parameters, but EXECUTE supplied {len(types)}")
            return ir.Parameter(types[e.index], e.index)
        if isinstance(e, ast.Identifier):
            try:
                ch, field, depth = self.scope.resolve(e.parts)
            except AnalysisError as err:
                # niladic datetime keywords (reference: CURRENT_DATE et al
                # parse as parenless function invocations): a bare name
                # matching NO column resolves as the function instead —
                # strictly the not-found case; ambiguity errors (a real
                # column named `now` on both join sides) must propagate
                if (len(e.parts) == 1
                        and e.parts[0].lower() in ("current_date",
                                                   "current_timestamp",
                                                   "localtimestamp", "now")
                        and "cannot be resolved" in str(err)):
                    return self._analyze_function(
                        ast.FunctionCall(e.parts[0].lower(), ()))
                raise
            if depth == 0:
                return ir.ColumnRef(field.type, ch, field.name or "")
            if depth == 1:
                ref = ir.OuterRef(field.type, ch, field.name or "")
                self.outer_refs.append(ref)
                return ref
            raise AnalysisError("correlation depth > 1 not supported")
        if isinstance(e, ast.Comparison):
            left = self.analyze(e.left)
            right = self.analyze(e.right)
            self._check_comparable(left.type, right.type, e.op)
            return ir.Call(T.BOOLEAN, _COMPARISON_OPS[e.op], (left, right))
        if isinstance(e, ast.Arithmetic):
            return self._analyze_arithmetic(e)
        if isinstance(e, ast.Negative):
            v = self.analyze(e.value)
            if isinstance(v, ir.Constant) and v.type.is_numeric:
                return ir.Constant(v.type, -v.value)
            return ir.Call(v.type, "negate", (v,))
        if isinstance(e, ast.LogicalBinary):
            left = self.analyze(e.left)
            right = self.analyze(e.right)
            return ir.Call(T.BOOLEAN, e.op, (left, right))
        if isinstance(e, ast.Not):
            return ir.Call(T.BOOLEAN, "not", (self.analyze(e.value),))
        if isinstance(e, ast.IsNull):
            out = ir.Call(T.BOOLEAN, "is_null", (self.analyze(e.value),))
            if e.negated:
                out = ir.Call(T.BOOLEAN, "not", (out,))
            return out
        if isinstance(e, ast.Between):
            out = ir.Call(
                T.BOOLEAN,
                "between",
                (self.analyze(e.value), self.analyze(e.low), self.analyze(e.high)),
            )
            if e.negated:
                out = ir.Call(T.BOOLEAN, "not", (out,))
            return out
        if isinstance(e, ast.InList):
            args = (self.analyze(e.value),) + tuple(self.analyze(x) for x in e.items)
            out = ir.Call(T.BOOLEAN, "in_list", args)
            if e.negated:
                out = ir.Call(T.BOOLEAN, "not", (out,))
            return out
        if isinstance(e, ast.Like):
            pat = self.analyze(e.pattern)
            args = (self.analyze(e.value), pat)
            out = ir.Call(T.BOOLEAN, "like", args)
            if e.negated:
                out = ir.Call(T.BOOLEAN, "not", (out,))
            return out
        if isinstance(e, ast.SearchedCase):
            whens = tuple(
                (self.analyze(c), self.analyze(v)) for c, v in e.whens
            )
            default = self.analyze(e.default) if e.default is not None else None
            out_type = _case_type([v for _, v in whens], default)
            return ir.Case(out_type, whens, default)
        if isinstance(e, ast.SimpleCase):
            operand = e.operand
            whens = tuple(
                (self.analyze(ast.Comparison("=", operand, c)), self.analyze(v))
                for c, v in e.whens
            )
            default = self.analyze(e.default) if e.default is not None else None
            out_type = _case_type([v for _, v in whens], default)
            return ir.Case(out_type, whens, default)
        if isinstance(e, ast.Cast):
            target = T.parse_type(e.type_name)
            inner = self.analyze(e.value)
            if (target == T.DATE and isinstance(inner, ir.Constant)
                    and inner.type.is_varchar and inner.value is not None):
                # fold cast('1999-2-01' as date) at analysis time — the
                # runtime lowering is dictionary-code based and cannot
                # parse dates (reference: constant folding in
                # IrExpressionInterpreter)
                import datetime

                try:
                    y, m, d = (int(p) for p in str(inner.value).split("-"))
                    days = (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days
                except ValueError:
                    raise AnalysisError(
                        f"cannot cast {inner.value!r} to date") from None
                return ir.Constant(T.DATE, days)
            return ir.Cast(target, inner)
        if isinstance(e, ast.Extract):
            v = self.analyze(e.value)
            time_fields = ("hour", "minute", "second")
            if e.field in time_fields:
                if not isinstance(v.type, T.TimestampType):
                    raise AnalysisError(f"EXTRACT({e.field}) needs a timestamp")
            elif e.field not in ("year", "month", "day", "quarter"):
                raise AnalysisError(f"EXTRACT({e.field}) not supported yet")
            return ir.Call(T.BIGINT, f"extract_{e.field}", (v,))
        if isinstance(e, ast.AtTimeZone):
            v = self.analyze(e.value)
            _zone_offset_seconds(e.zone.strip())  # validate the zone id
            if isinstance(v.type, T.TimestampType) and v.type.with_tz:
                # instant unchanged; zone is rendering metadata (UTC here)
                return v
            if v.type == T.DATE:
                v = ir.Cast(T.timestamp(0), v)
            if not isinstance(v.type, T.TimestampType):
                raise AnalysisError("AT TIME ZONE needs a timestamp")
            # Reference semantics (DateTimeFunctions.atTimeZone): the plain
            # timestamp is a wall-clock reading in the SESSION zone (UTC
            # here), so the INSTANT is unchanged — only the rendering zone
            # becomes `zone`, and this engine renders tz values in UTC.
            p = v.type.precision
            return ir.Cast(T.timestamp(p, True), v)
        if isinstance(e, ast.ArrayConstructor):
            items = tuple(self.analyze(x) for x in e.items)
            et = T.UNKNOWN
            for it in items:
                et2 = T.common_super_type(et, it.type)
                if et2 is None:
                    raise AnalysisError(
                        f"ARRAY elements incompatible: {et} vs {it.type}")
                et = et2
            if et == T.UNKNOWN:
                et = T.BIGINT  # empty / all-null literal defaults
            items = tuple(
                ir.Cast(et, it) if it.type not in (et, T.UNKNOWN) else it for it in items
            )
            return ir.Call(T.array_of(et), "array_ctor", items)
        if isinstance(e, ast.Subscript):
            base = self.analyze(e.base)
            idx = self.analyze(e.index)
            if isinstance(base.type, T.ArrayType):
                if not idx.type.is_integer_kind:
                    raise AnalysisError("array subscript must be an integer")
                return ir.Call(base.type.element, "subscript", (base, idx))
            if isinstance(base.type, T.MapType):
                self._check_comparable(base.type.key, idx.type, "[]")
                return ir.Call(base.type.value, "map_subscript", (base, idx))
            if isinstance(base.type, T.RowType):
                # row[i]: 1-based CONSTANT field ordinal (reference:
                # RowType subscript / DereferenceExpression)
                if not isinstance(idx, ir.Constant) or idx.value is None:
                    raise AnalysisError("row subscript must be a constant")
                i = int(idx.value)
                if not 1 <= i <= len(base.type.field_types):
                    raise AnalysisError(f"row field index {i} out of range")
                return ir.Call(base.type.field_types[i - 1], "row_field",
                               (base, ir.Constant(T.INTEGER, i)))
            raise AnalysisError(f"cannot subscript {base.type}")
        if isinstance(e, ast.FunctionCall):
            return self._analyze_function(e)
        if isinstance(e, (ast.ScalarSubquery, ast.InSubquery, ast.Exists)):
            raise AnalysisError(
                "subquery expression must be planned by the query planner "
                "(appears in unsupported position)"
            )
        raise AnalysisError(f"unsupported expression: {type(e).__name__}")

    def _analyze_arithmetic(self, e: ast.Arithmetic) -> ir.Expr:
        # date +/- interval
        for left_ast, right_ast, sign in ((e.left, e.right, 1), (e.right, e.left, 1)):
            if isinstance(right_ast, ast.IntervalLiteral):
                base = self.analyze(left_ast)
                iv = right_ast
                mult = iv.sign * (1 if e.op == "+" else -1)
                is_ts = isinstance(base.type, T.TimestampType)
                if base.type != T.DATE and not is_ts:
                    raise AnalysisError("interval arithmetic requires a date/timestamp")
                if iv.unit in _MONTH_UNITS:
                    months = iv.value * _MONTH_UNITS[iv.unit] * mult
                    return ir.Call(
                        base.type, "date_add_months", (base, ir.Constant(T.INTEGER, months))
                    )
                if is_ts and iv.unit in _SECOND_UNITS:
                    # day-time intervals over timestamps add in storage units
                    n = (iv.value * _SECOND_UNITS[iv.unit] * mult
                         * 10 ** base.type.precision)
                    return ir.Call(
                        base.type, "add", (base, ir.Constant(T.BIGINT, n)))
                if iv.unit == "day":
                    return ir.Call(
                        base.type,
                        "add",
                        (base, ir.Constant(T.INTEGER, iv.value * mult)),
                    )
                raise AnalysisError(f"interval unit {iv.unit} on date")
        left = self.analyze(e.left)
        right = self.analyze(e.right)
        out = arithmetic_result_type(e.op, left.type, right.type)
        return ir.Call(out, _ARITH_OPS[e.op], (left, right))

    def _analyze_function(self, e: ast.FunctionCall) -> ir.Expr:
        name = e.name
        if name in AGGREGATE_FUNCTIONS:
            raise AnalysisError(
                f"aggregate function {name}() in a non-aggregate context"
                if not self.allow_aggregates
                else f"aggregate {name}() must be substituted by the planner"
            )
        # higher-order array functions take a lambda argument (reference:
        # operator/scalar/ArrayTransformFunction, ArrayAnyMatchFunction, ...)
        if name in ("transform", "any_match", "all_match", "none_match"):
            if len(e.args) != 2 or not isinstance(e.args[1], ast.Lambda):
                raise AnalysisError(f"{name}(array, x -> expression)")
            arr = self.analyze(e.args[0])
            if not isinstance(arr.type, T.ArrayType):
                raise AnalysisError(f"{name}() expects an array")
            lam = e.args[1]
            if len(lam.params) != 1:
                raise AnalysisError(f"{name}() lambda takes one parameter")
            elem_scope = Scope([Field(lam.params[0], arr.type.element)], None)
            body = ExprAnalyzer(elem_scope).analyze(lam.body)
            lam_ir = ir.Lambda(body.type, body, 1)
            if name == "transform":
                return ir.Call(T.array_of(body.type), "transform", (arr, lam_ir))
            if body.type != T.BOOLEAN:
                raise AnalysisError(f"{name}() lambda must return boolean")
            return ir.Call(T.BOOLEAN, name, (arr, lam_ir))
        if any(isinstance(a, ast.Lambda) for a in e.args):
            raise AnalysisError(f"{name}() does not take a lambda argument")
        args = tuple(self.analyze(a) for a in e.args)
        if name == "coalesce":
            t = args[0].type
            for a in args[1:]:
                t2 = T.common_super_type(t, a.type)
                if t2 is None:
                    raise AnalysisError("COALESCE operands are incompatible")
                t = t2
            return ir.Call(t, "coalesce", args)
        if name == "nullif":
            return ir.Call(args[0].type, "nullif", args)
        if name == "abs":
            return ir.Call(args[0].type, "abs", args)
        if name in ("substring", "substr"):
            return ir.Call(T.varchar(), "substring", args)
        if name == "concat":
            return ir.Call(T.varchar(), "concat", args)
        if name in ("lower", "upper", "trim", "ltrim", "rtrim"):
            return ir.Call(T.varchar(), name, args)
        if name == "length":
            return ir.Call(T.BIGINT, "length", args)
        if name in ("to_hex", "from_utf8"):
            if len(args) != 1 or not args[0].type.is_varbinary:
                raise AnalysisError(f"{name}(varbinary)")
            return ir.Call(T.varchar(), name, args)
        if name in ("from_hex", "to_utf8"):
            if len(args) != 1 or not args[0].type.is_varchar \
                    or args[0].type.is_varbinary:
                raise AnalysisError(f"{name}(varchar)")
            return ir.Call(T.VARBINARY, name, args)
        if name in ("md5", "sha256"):
            if len(args) != 1 or not args[0].type.is_varbinary:
                raise AnalysisError(f"{name}(varbinary)")
            return ir.Call(T.VARBINARY, name, args)
        if name in ("round", "ceil", "ceiling", "floor"):
            return ir.Call(args[0].type if args[0].type.is_decimal else T.DOUBLE if args[0].type.is_floating else T.BIGINT, name, args)
        if name in ("sqrt", "cbrt", "ln", "log2", "log10", "exp"):
            if len(args) != 1:
                raise AnalysisError(f"{name}() expects 1 argument")
            return ir.Call(T.DOUBLE, name, args)
        if name == "log":
            if len(args) != 2:
                raise AnalysisError("log(base, x) expects 2 arguments")
            return ir.Call(T.DOUBLE, "log_b", args)
        if name in ("power", "pow"):
            return ir.Call(T.DOUBLE, "power", args)
        if name == "sign":
            t = args[0].type
            return ir.Call(T.DOUBLE if t.is_floating else T.BIGINT, "sign", args)
        if name in ("greatest", "least"):
            t = args[0].type
            for a in args[1:]:
                t2 = T.common_super_type(t, a.type)
                if t2 is None:
                    raise AnalysisError(f"{name} operands are incompatible")
                t = t2
            args = tuple(ir.Cast(t, a) if a.type != t else a for a in args)
            return ir.Call(t, name, args)
        if name == "year":
            return ir.Call(T.BIGINT, "extract_year", args)
        if name == "month":
            return ir.Call(T.BIGINT, "extract_month", args)
        if name == "day":
            return ir.Call(T.BIGINT, "extract_day", args)
        if name in ("day_of_week", "dow"):
            return ir.Call(T.BIGINT, "extract_dow", args)
        if name in ("day_of_year", "doy"):
            return ir.Call(T.BIGINT, "extract_doy", args)
        if name == "week":
            return ir.Call(T.BIGINT, "extract_week", args)
        if name == "date_diff":
            # date_diff(unit, from, to) -> bigint (reference:
            # DateTimeFunctions.diffDate/diffTimestamp)
            if len(args) != 3 or not isinstance(args[0], ir.Constant):
                raise AnalysisError("date_diff('unit', from, to)")
            unit = str(args[0].value).lower()
            a, b = args[1], args[2]
            ts_units = {"second": 1, "minute": 60, "hour": 3600,
                        "day": 86_400, "week": 7 * 86_400}
            date_units = {"day": 1, "week": 7}
            both_date = a.type == T.DATE and b.type == T.DATE
            if both_date and unit in date_units:
                return ir.Call(T.BIGINT, "date_diff_days",
                               (a, b, ir.Constant(T.INTEGER, date_units[unit])))
            if unit in ts_units:
                p = max(t.precision if isinstance(t, T.TimestampType) else 0
                        for t in (a.type, b.type))
                tt = T.timestamp(p)
                return ir.Call(
                    T.BIGINT, "ts_diff_units",
                    (ir.Cast(tt, a), ir.Cast(tt, b),
                     ir.Constant(T.BIGINT, ts_units[unit] * 10 ** p)))
            if unit in ("month", "year"):
                mul = 12 if unit == "year" else 1
                da = a if a.type == T.DATE else ir.Cast(T.DATE, a)
                db = b if b.type == T.DATE else ir.Cast(T.DATE, b)
                return ir.Call(T.BIGINT, "months_between",
                               (da, db, ir.Constant(T.INTEGER, mul)))
            raise AnalysisError(f"date_diff: unsupported unit {unit!r}")
        if name == "date_add":
            # date_add(unit, value, x) (reference: DateTimeFunctions.addDate)
            if len(args) != 3 or not isinstance(args[0], ir.Constant):
                raise AnalysisError("date_add('unit', value, x)")
            unit = str(args[0].value).lower()
            n, x = args[1], args[2]
            if unit in ("month", "year"):
                mul = ir.Constant(T.INTEGER, 12 if unit == "year" else 1)
                months = ir.Call(T.INTEGER, "mul", [n, mul])
                return ir.Call(x.type, "date_add_months", (x, months))
            ts_units = {"second": 1, "minute": 60, "hour": 3600,
                        "day": 86_400, "week": 7 * 86_400}
            if unit not in ts_units:
                raise AnalysisError(f"date_add: unsupported unit {unit!r}")
            if x.type == T.DATE:
                if unit in ("day", "week"):
                    days = ir.Call(T.BIGINT, "mul", [
                        n, ir.Constant(T.INTEGER, ts_units[unit] // 86_400)])
                    return ir.Call(T.DATE, "add", (x, days))
                x = ir.Cast(T.timestamp(0), x)
            if not isinstance(x.type, T.TimestampType):
                raise AnalysisError("date_add over non-temporal value")
            step = ir.Constant(
                T.BIGINT, ts_units[unit] * 10 ** x.type.precision)
            return ir.Call(x.type, "add",
                           (x, ir.Call(T.BIGINT, "mul", [n, step])))
        if name == "to_unixtime":
            if len(args) != 1:
                raise AnalysisError("to_unixtime(timestamp)")
            arg = args[0]
            if arg.type == T.DATE:
                arg = ir.Cast(T.timestamp(0), arg)
            if not isinstance(arg.type, T.TimestampType):
                raise AnalysisError("to_unixtime(timestamp)")
            p = arg.type.precision
            return ir.Call(T.DOUBLE, "div",
                           (ir.Cast(T.DOUBLE, arg),
                            ir.Constant(T.DOUBLE, float(10 ** p))))
        if name == "from_unixtime":
            if len(args) != 1:
                raise AnalysisError("from_unixtime(seconds)")
            return ir.Call(T.timestamp(3), "seconds_to_ts3",
                           (ir.Cast(T.DOUBLE, args[0]),))
        if name == "date_trunc":
            if len(args) != 2 or args[1].type != T.DATE:
                raise AnalysisError("date_trunc(unit, date) expects a date")
            return ir.Call(T.DATE, "date_trunc", args)
        if name == "replace":
            if len(args) not in (2, 3):
                raise AnalysisError("replace(string, search[, replace])")
            return ir.Call(T.varchar(), "replace", args)
        if name == "reverse":
            return ir.Call(T.varchar(), "reverse", args)
        if name in ("strpos", "position"):
            return ir.Call(T.BIGINT, "strpos", args)
        if name == "starts_with":
            return ir.Call(T.BOOLEAN, "starts_with", args)
        if name in ("sin", "cos", "tan", "asin", "acos", "atan",
                    "sinh", "cosh", "tanh", "degrees", "radians"):
            if len(args) != 1:
                raise AnalysisError(f"{name}() expects 1 argument")
            return ir.Call(T.DOUBLE, name, args)
        if name == "atan2":
            if len(args) != 2:
                raise AnalysisError("atan2(y, x) expects 2 arguments")
            return ir.Call(T.DOUBLE, "atan2", args)
        # --- non-deterministic functions (reference: MathFunctions.random /
        # DateTimeFunctions.now; tagged deterministic=false there). They
        # stay symbolic Calls — never constant-folded — so the cache
        # layer's determinism analysis (trino_tpu/cache/determinism.py)
        # sees them in both the AST and the optimized plan.
        if name in ("random", "rand"):
            if args:
                raise AnalysisError("random() takes no arguments")
            return ir.Call(T.DOUBLE, "random", ())
        if name in ("now", "current_timestamp", "localtimestamp"):
            if args:
                raise AnalysisError(f"{name}() takes no arguments")
            return ir.Call(T.timestamp(3), "now", ())
        if name == "current_date":
            if args:
                raise AnalysisError("current_date() takes no arguments")
            return ir.Call(T.DATE, "current_date", ())
        if name == "pi":
            import math

            return ir.Constant(T.DOUBLE, math.pi)
        if name == "e":
            import math

            return ir.Constant(T.DOUBLE, math.e)
        if name == "truncate":
            if len(args) not in (1, 2):
                raise AnalysisError("truncate(x[, decimal_places])")
            if len(args) == 2 and not isinstance(args[1], ir.Constant):
                raise AnalysisError("truncate scale must be a literal")
            t = args[0].type
            return ir.Call(t if t.is_decimal or t.is_floating else T.BIGINT,
                           "truncate", args)
        if name == "mod":
            if len(args) != 2:
                raise AnalysisError("mod(a, b) expects 2 arguments")
            return ir.Call(
                arithmetic_result_type("%", args[0].type, args[1].type), "mod", args)
        # --- regexp / string breadth (reference: operator/scalar/
        # JoniRegexpFunctions, StringFunctions, PadFunctions) ---
        if name == "regexp_like":
            if len(args) != 2:
                raise AnalysisError("regexp_like(string, pattern)")
            return ir.Call(T.BOOLEAN, "regexp_like", args)
        if name == "regexp_extract":
            if len(args) not in (2, 3):
                raise AnalysisError("regexp_extract(string, pattern[, group])")
            return ir.Call(T.varchar(), "regexp_extract", args)
        if name == "regexp_replace":
            if len(args) not in (2, 3):
                raise AnalysisError("regexp_replace(string, pattern[, replacement])")
            return ir.Call(T.varchar(), "regexp_replace", args)
        if name == "regexp_count":
            if len(args) != 2:
                raise AnalysisError("regexp_count(string, pattern)")
            return ir.Call(T.BIGINT, "regexp_count", args)
        if name in ("lpad", "rpad"):
            if len(args) not in (2, 3):
                raise AnalysisError(f"{name}(string, size[, padstring])")
            return ir.Call(T.varchar(), name, args)
        if name == "split_part":
            if len(args) != 3:
                raise AnalysisError("split_part(string, delimiter, index)")
            return ir.Call(T.varchar(), "split_part", args)
        if name == "translate":
            if len(args) != 3:
                raise AnalysisError("translate(string, from, to)")
            return ir.Call(T.varchar(), "translate", args)
        if name == "repeat" and args and args[0].type.is_varchar:
            return ir.Call(T.varchar(), "repeat_str", args)
        if name == "chr":
            return ir.Call(T.varchar(), "chr", args)
        if name == "codepoint":
            return ir.Call(T.BIGINT, "codepoint", args)
        if name == "hamming_distance":
            return ir.Call(T.BIGINT, "hamming_distance", args)
        if name == "levenshtein_distance":
            return ir.Call(T.BIGINT, "levenshtein_distance", args)
        # --- JSON (reference: operator/scalar/JsonFunctions + JsonPath) ---
        if name == "json_extract_scalar":
            if len(args) != 2:
                raise AnalysisError("json_extract_scalar(json, path)")
            return ir.Call(T.varchar(), "json_extract_scalar", args)
        if name == "json_array_length":
            return ir.Call(T.BIGINT, "json_array_length", args)
        # --- datetime breadth (reference: operator/scalar/DateTimeFunctions) ---
        if name == "date_format":
            if len(args) != 2 or args[0].type not in (T.DATE, T.TIMESTAMP):
                raise AnalysisError("date_format(date, format)")
            return ir.Call(T.varchar(), "date_format", args)
        if name == "date_parse":
            if len(args) != 2:
                raise AnalysisError("date_parse(string, format)")
            return ir.Call(T.DATE, "date_parse", args)
        if name == "day_name":
            return ir.Call(T.varchar(), "day_name", args)
        if name == "month_name":
            return ir.Call(T.varchar(), "month_name", args)
        if name == "last_day_of_month":
            return ir.Call(T.DATE, "last_day_of_month", args)
        # --- bitwise (reference: operator/scalar/BitwiseFunctions) ---
        if name in ("bitwise_and", "bitwise_or", "bitwise_xor",
                    "bitwise_left_shift", "bitwise_right_shift"):
            if len(args) != 2:
                raise AnalysisError(f"{name}(a, b)")
            return ir.Call(T.BIGINT, name, args)
        if name == "bitwise_not":
            return ir.Call(T.BIGINT, "bitwise_not", args)
        if name == "bit_count":
            return ir.Call(T.BIGINT, "bit_count", args)
        # --- float classification / misc ---
        if name == "is_nan":
            return ir.Call(T.BOOLEAN, "is_nan", args)
        if name == "is_finite":
            return ir.Call(T.BOOLEAN, "is_finite", args)
        if name == "is_infinite":
            return ir.Call(T.BOOLEAN, "is_infinite", args)
        if name == "nan":
            return ir.Constant(T.DOUBLE, float("nan"))
        if name == "infinity":
            return ir.Constant(T.DOUBLE, float("inf"))
        if name == "typeof":
            if len(args) != 1:
                raise AnalysisError("typeof(x)")
            return ir.Constant(T.varchar(), str(args[0].type))
        if name == "if":
            if len(args) not in (2, 3):
                raise AnalysisError("if(condition, true_value[, false_value])")
            t = args[1].type
            if len(args) == 3:
                t2 = T.common_super_type(t, args[2].type)
                if t2 is None:
                    raise AnalysisError("IF branches are incompatible")
                t = t2
            whens = ((args[0], args[1]),)
            default = args[2] if len(args) == 3 else None
            return ir.Case(t, whens, default)
        # --- array / map functions (reference: operator/scalar/ArrayFunctions,
        # MapKeys/MapValues/MapSubscript, CardinalityFunction) ---
        if name == "cardinality":
            if len(args) != 1 or not (args[0].type.is_array or args[0].type.is_map):
                raise AnalysisError("cardinality() expects an array or map")
            return ir.Call(T.BIGINT, "cardinality", args)
        if name == "contains":
            if len(args) != 2 or not isinstance(args[0].type, T.ArrayType):
                raise AnalysisError("contains(array, value)")
            self._check_comparable(args[0].type.element, args[1].type, "contains")
            return ir.Call(T.BOOLEAN, "contains", args)
        if name == "array_position":
            if len(args) != 2 or not isinstance(args[0].type, T.ArrayType):
                raise AnalysisError("array_position(array, value)")
            self._check_comparable(args[0].type.element, args[1].type, "array_position")
            return ir.Call(T.BIGINT, "array_position", args)
        if name == "element_at":
            if len(args) != 2:
                raise AnalysisError("element_at(container, key)")
            if isinstance(args[0].type, T.ArrayType):
                if not args[1].type.is_integer_kind:
                    raise AnalysisError("element_at(array, index) index must be an integer")
                return ir.Call(args[0].type.element, "element_at", args)
            if isinstance(args[0].type, T.MapType):
                self._check_comparable(args[0].type.key, args[1].type, "element_at")
                return ir.Call(args[0].type.value, "map_element_at", args)
            raise AnalysisError("element_at() expects an array or map")
        if name in ("array_min", "array_max"):
            if len(args) != 1 or not isinstance(args[0].type, T.ArrayType):
                raise AnalysisError(f"{name}(array)")
            return ir.Call(args[0].type.element, name, args)
        if name in ("array_sum",):
            if len(args) != 1 or not isinstance(args[0].type, T.ArrayType):
                raise AnalysisError("array_sum(array)")
            return ir.Call(aggregate_result_type("sum", args[0].type.element), name, args)
        if name == "map_keys":
            if len(args) != 1 or not isinstance(args[0].type, T.MapType):
                raise AnalysisError("map_keys(map)")
            return ir.Call(T.array_of(args[0].type.key), "map_keys", args)
        if name == "map_values":
            if len(args) != 1 or not isinstance(args[0].type, T.MapType):
                raise AnalysisError("map_values(map)")
            return ir.Call(T.array_of(args[0].type.value), "map_values", args)
        if name == "map":
            if len(args) != 2 or not all(isinstance(a.type, T.ArrayType) for a in args):
                raise AnalysisError("map(key_array, value_array)")
            return ir.Call(
                T.map_of(args[0].type.element, args[1].type.element), "map_ctor", args
            )
        if name == "row":
            if not args:
                raise AnalysisError("row() needs at least one field")
            if any(a.type == T.UNKNOWN for a in args):
                raise AnalysisError("row() fields must be typed (cast NULLs)")
            return ir.Call(
                T.row_of([(None, a.type) for a in args]), "row_ctor", args)
        raise AnalysisError(f"unknown function: {name}")

    @staticmethod
    def _check_comparable(a: T.Type, b: T.Type, op: str):
        t = T.common_super_type(a, b)
        if t is None or not t.comparable:
            raise AnalysisError(f"cannot compare {a} {op} {b}")
        if op in ("<", "<=", ">", ">=") and not t.orderable:
            raise AnalysisError(f"type {t} is not orderable for {op}")


def _case_type(values: List[ir.Expr], default: Optional[ir.Expr]) -> T.Type:
    t = T.UNKNOWN
    for v in list(values) + ([default] if default is not None else []):
        t2 = T.common_super_type(t, v.type)
        if t2 is None:
            raise AnalysisError(f"CASE branches incompatible: {t} vs {v.type}")
        t = t2
    return t


def find_aggregates(e: ast.Expression) -> List[ast.FunctionCall]:
    """Collect aggregate FunctionCall subtrees (no nesting inside them).
    Descends into window functions: ``rank() over (order by sum(x))`` uses
    the grouped aggregate as a window input."""
    out: List[ast.FunctionCall] = []

    def visit(x):
        if isinstance(x, ast.FunctionCall) and x.name in AGGREGATE_FUNCTIONS:
            out.append(x)
            return  # don't descend: nested aggregates are invalid anyway
        if isinstance(x, ast.WindowFunction):
            for a in x.args:
                visit(a)
            for p in x.partition_by:
                visit(p)
            for s in x.order_by:
                visit(s.expr)
            return
        if isinstance(x, tuple):
            for y in x:
                visit(y)
            return
        if hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                v = getattr(x, f)
                if isinstance(v, (ast.Expression, tuple)):
                    visit(v)

    visit(e)
    return out


WINDOW_ONLY_FUNCTIONS = {
    "rank", "dense_rank", "row_number", "lag", "lead",
    "first_value", "last_value",
    "ntile", "percent_rank", "cume_dist", "nth_value",
}


def find_windows(e: ast.Expression) -> List[ast.WindowFunction]:
    """Collect window-function subtrees (no window nesting)."""
    out: List[ast.WindowFunction] = []

    def visit(x):
        if isinstance(x, ast.WindowFunction):
            out.append(x)
            return
        if isinstance(x, tuple):
            for y in x:
                visit(y)
            return
        if hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                v = getattr(x, f)
                if isinstance(v, (ast.Expression, tuple)):
                    visit(v)

    visit(e)
    return out


def window_result_type(fn: str, arg: Optional[T.Type]) -> T.Type:
    """Reference: window function signatures (window/ + ranking fns)."""
    if fn in ("rank", "dense_rank", "row_number", "ntile"):
        return T.BIGINT
    if fn in ("percent_rank", "cume_dist"):
        return T.DOUBLE
    if fn in ("lag", "lead", "first_value", "last_value", "nth_value"):
        assert arg is not None
        return arg
    return aggregate_result_type(fn, arg)
