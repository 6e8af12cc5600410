"""Recursive-descent SQL parser.

Reference: ``core/trino-grammar/.../SqlBase.g4`` (ANTLR4, 1420 lines) +
``core/trino-parser/.../AstBuilder.java:369``. Hand-written Pratt-style
parser over the same query surface (round-1 scope: SELECT queries with
joins/subqueries/CTEs/set-ops, EXPLAIN, SHOW).

Grammar precedence (low to high):
  OR < AND < NOT < predicate (comparison, BETWEEN, IN, LIKE, IS) <
  || (concat) < + - < * / % < unary - < primary
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from trino_tpu_torch.sql.parser import ast
from trino_tpu_torch.sql.parser.lexer import Token, tokenize


class ParseError(ValueError):
    pass


def parse_statement(sql: str) -> ast.Statement:
    p = Parser(tokenize(sql))
    stmt = p.statement()
    p.expect_kinds("eof", ";")
    return stmt


def parse_query(sql: str) -> ast.Query:
    stmt = parse_statement(sql)
    if not isinstance(stmt, ast.Query):
        raise ParseError("expected a query")
    return stmt


class Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    # --- token helpers ---
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def advance(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_kw(self, *kws: str, ahead: int = 0) -> bool:
        t = self.peek(ahead)
        return t.kind == "kw" and t.lower in kws

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.text in ops

    def at_soft(self, *kws: str, ahead: int = 0) -> bool:
        """Non-reserved (soft) keyword test: matches ident or kw tokens —
        OVER/PARTITION/ROWS/... stay usable as identifiers elsewhere
        (reference: SqlBase.g4 nonReserved rule)."""
        t = self.peek(ahead)
        return t.kind in ("kw", "ident") and t.lower in kws

    def accept_soft(self, *kws: str) -> bool:
        if self.at_soft(*kws):
            self.advance()
            return True
        return False

    def expect_soft(self, kw: str) -> Token:
        if not self.at_soft(kw):
            t = self.peek()
            raise ParseError(f"expected {kw!r}, got {t.text!r} at {t.pos}")
        return self.advance()

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.advance()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.advance()
            return True
        return False

    def expect_kw(self, kw: str) -> Token:
        if not self.at_kw(kw):
            raise ParseError(f"expected {kw.upper()} but got {self.peek().text!r} at {self.peek().pos}")
        return self.advance()

    def expect_op(self, op: str) -> Token:
        if not self.at_op(op):
            raise ParseError(f"expected {op!r} but got {self.peek().text!r} at {self.peek().pos}")
        return self.advance()

    def expect_kinds(self, *ok) -> None:
        t = self.peek()
        if t.kind == "eof" and "eof" in ok:
            return
        if t.kind == "op" and t.text in ok:
            self.advance()
            if self.peek().kind != "eof":
                raise ParseError(f"trailing input at {self.peek().pos}")
            return
        raise ParseError(f"unexpected input {t.text!r} at {t.pos}")

    def identifier(self) -> str:
        t = self.peek()
        if t.kind == "ident":
            return self.advance().text
        # contextual keywords usable as identifiers (e.g. a column named "year")
        if t.kind == "kw" and t.lower in ("year", "month", "day", "date", "first", "last", "tables", "schemas", "columns", "values", "quarter", "hour", "minute", "second", "if", "session", "set", "reset"):
            return self.advance().text
        raise ParseError(f"expected identifier but got {t.text!r} at {t.pos}")

    # --- statements ---
    def statement(self) -> ast.Statement:
        if self.at_soft("start") and self.at_soft("transaction", ahead=1):
            self.advance()
            self.advance()
            return ast.StartTransaction()
        if self.at_soft("begin") and (
            self.peek(1).kind == "eof" or self.peek(1).text == ";"
        ):
            self.advance()
            return ast.StartTransaction()
        if self.at_soft("prepare") and self.peek(1).kind == "ident":
            self.advance()
            name = self.identifier()
            self.expect_kw("from")
            self._param_counter = 0
            return ast.Prepare(name.lower(), self.statement())
        if self.at_soft("execute") and self.peek(1).kind == "ident":
            self.advance()
            name = self.identifier()
            params: List[ast.Expression] = []
            if self.at_soft("using"):
                self.advance()
                params.append(self.expr())
                while self.accept_op(","):
                    params.append(self.expr())
            return ast.ExecutePrepared(name.lower(), tuple(params))
        if self.at_soft("deallocate"):
            self.advance()
            self.accept_soft("prepare")
            return ast.Deallocate(self.identifier().lower())
        if self.at_soft("call") and self.peek(1).kind in ("ident", "kw"):
            # CALL catalog.schema.procedure(args...) (reference:
            # SqlBase.g4 call rule + sql/tree/Call)
            self.advance()
            name = tuple(self.qualified_name())
            self.expect_op("(")
            args: List[ast.Expression] = []
            if not self.at_op(")"):
                args.append(self.expr())
                while self.accept_op(","):
                    args.append(self.expr())
            self.expect_op(")")
            return ast.Call(name, tuple(args))
        if self.at_soft("commit"):
            self.advance()
            return ast.Commit()
        if self.at_soft("rollback"):
            self.advance()
            return ast.Rollback()
        if self.accept_kw("explain"):
            analyze = bool(self.accept_kw("analyze"))
            verbose = analyze and bool(self.accept_soft("verbose"))
            mode, fmt = "distributed", "text"
            if self.accept_op("("):
                while True:
                    opt = self.identifier().lower()
                    if opt == "type":
                        mode = self.identifier().lower()
                    elif opt == "format":
                        fmt = self.identifier().lower()
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            return ast.Explain(self.statement(), analyze=analyze, mode=mode,
                               fmt=fmt, verbose=verbose)
        if self.accept_kw("create"):
            or_replace = False
            if self.accept_kw("or"):
                if not self.accept_soft("replace"):
                    raise ParseError("expected REPLACE after CREATE OR")
                or_replace = True
            if self.accept_soft("function"):
                # CREATE [OR REPLACE] FUNCTION name(p type, ...) RETURNS
                # type RETURN expr (reference: CreateFunctionTask; body is
                # a scalar SQL expression routine)
                name = tuple(self.qualified_name())
                self.expect_op("(")
                params = []
                if not self.at_op(")"):
                    while True:
                        pname = self.identifier()
                        ptype = self.type_name()
                        params.append((pname.lower(), ptype))
                        if not self.accept_op(","):
                            break
                self.expect_op(")")
                if not self.accept_soft("returns"):
                    raise ParseError("expected RETURNS in CREATE FUNCTION")
                rtype = self.type_name()
                if not self.accept_soft("return"):
                    raise ParseError("expected RETURN <expression> body")
                body = self.expr()
                return ast.CreateFunction(
                    name, tuple(params), rtype, body, or_replace)
            if self.accept_soft("materialized"):
                # CREATE [OR REPLACE] MATERIALIZED VIEW [IF NOT EXISTS]
                # name AS query (reference: SqlBase.g4 createMaterializedView)
                self.expect_soft("view")
                not_exists = False
                if self.accept_kw("if"):
                    self.expect_kw("not")
                    self.expect_kw("exists")
                    not_exists = True
                name = tuple(self.qualified_name())
                self.expect_kw("as")
                return ast.CreateMaterializedView(
                    name, self.query(), not_exists, or_replace)
            if or_replace:
                # accepting-and-ignoring OR REPLACE on tables would
                # silently change semantics
                raise ParseError(
                    "expected FUNCTION or MATERIALIZED VIEW after "
                    "CREATE OR REPLACE")
            self.expect_kw("table")
            not_exists = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                not_exists = True
            name = tuple(self.qualified_name())
            if self.accept_kw("as"):
                return ast.CreateTableAs(name, self.query(), not_exists)
            self.expect_op("(")
            columns = [self._column_def()]
            while self.accept_op(","):
                columns.append(self._column_def())
            self.expect_op(")")
            return ast.CreateTable(name, tuple(columns), not_exists)
        if self.accept_kw("insert"):
            self.expect_kw("into")
            name = tuple(self.qualified_name())
            columns = ()
            # a '(' here is a column list only if NOT opening a query body
            # (a query must start with SELECT/WITH/VALUES or '('); contextual
            # keywords remain usable as column names, matching CREATE TABLE
            if self.at_op("(") and not (
                self.at_kw("select", "with", "values", ahead=1)
                or (self.peek(1).kind == "op" and self.peek(1).text == "(")
            ):
                self.advance()
                cols = [self.identifier()]
                while self.accept_op(","):
                    cols.append(self.identifier())
                self.expect_op(")")
                columns = tuple(cols)
            return ast.Insert(name, columns, self.query())
        if self.accept_soft("delete"):
            self.expect_kw("from")
            name = tuple(self.qualified_name())
            where = self.expr() if self.accept_kw("where") else None
            return ast.Delete(name, where)
        if self.accept_soft("update"):
            name = tuple(self.qualified_name())
            self.expect_kw("set")
            assigns = []
            while True:
                col = self.identifier()
                self.expect_op("=")
                assigns.append((col, self.expr()))
                if not self.accept_op(","):
                    break
            where = self.expr() if self.accept_kw("where") else None
            return ast.Update(name, tuple(assigns), where)
        if self.at_soft("refresh") and self.at_soft("materialized", ahead=1):
            self.advance()
            self.advance()
            self.expect_soft("view")
            return ast.RefreshMaterializedView(tuple(self.qualified_name()))
        if self.accept_kw("drop"):
            if self.accept_soft("function"):
                if_exists = False
                if self.accept_kw("if"):
                    self.expect_kw("exists")
                    if_exists = True
                return ast.DropFunction(tuple(self.qualified_name()), if_exists)
            if self.accept_soft("materialized"):
                self.expect_soft("view")
                if_exists = False
                if self.accept_kw("if"):
                    self.expect_kw("exists")
                    if_exists = True
                return ast.DropMaterializedView(
                    tuple(self.qualified_name()), if_exists)
            self.expect_kw("table")
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return ast.DropTable(tuple(self.qualified_name()), if_exists)
        if self.accept_kw("set"):
            self.expect_kw("session")
            name = self.identifier()
            self.expect_op("=")
            return ast.SetSession(name, self._property_value())
        if self.accept_kw("reset"):
            self.expect_kw("session")
            return ast.ResetSession(self.identifier())
        if self.accept_kw("show"):
            if self.accept_kw("session"):
                return ast.ShowSession()
            if self.accept_kw("tables"):
                schema = None
                if self.accept_kw("from", "in"):
                    schema = tuple(self.qualified_name())
                return ast.ShowTables(schema)
            if self.accept_kw("schemas"):
                catalog = None
                if self.accept_kw("from", "in"):
                    catalog = self.identifier()
                return ast.ShowSchemas(catalog)
            if self.accept_kw("columns"):
                self.expect_kw("from")
                return ast.ShowColumns(tuple(self.qualified_name()))
            raise ParseError(f"unsupported SHOW at {self.peek().pos}")
        if self.accept_kw("describe"):
            return ast.ShowColumns(tuple(self.qualified_name()))
        return self.query()

    def _column_def(self):
        """name type — type text is ident plus optional (n[,m]) suffix."""
        name = self.identifier()
        t = self.peek()
        if t.kind not in ("ident", "kw"):
            raise ParseError(f"expected column type at {t.pos}")
        type_text = self.advance().text
        if self.accept_op("("):
            args = [self.advance().text]
            while self.accept_op(","):
                args.append(self.advance().text)
            self.expect_op(")")
            type_text += "(" + ",".join(args) + ")"
        return (name, type_text)

    def _property_value(self):
        """Literal value of SET SESSION: string | number | boolean."""
        t = self.peek()
        if t.kind == "string":
            return self.advance().text
        if t.kind == "number":
            text = self.advance().text
            return float(text) if "." in text or "e" in text.lower() else int(text)
        if t.kind == "kw" and t.lower in ("true", "false"):
            return self.advance().lower == "true"
        raise ParseError(f"expected literal session value at {t.pos}")

    # --- queries ---
    def query(self) -> ast.Query:
        with_queries: List[ast.WithQuery] = []
        if self.accept_kw("with"):
            while True:
                name = self.identifier()
                col_aliases = None
                if self.accept_op("("):
                    cols = [self.identifier()]
                    while self.accept_op(","):
                        cols.append(self.identifier())
                    self.expect_op(")")
                    col_aliases = tuple(cols)
                self.expect_kw("as")
                self.expect_op("(")
                q = self.query()
                self.expect_op(")")
                with_queries.append(ast.WithQuery(name, q, col_aliases))
                if not self.accept_op(","):
                    break
        body = self.query_body()
        order_by: Tuple[ast.SortItem, ...] = ()
        limit = None
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by = tuple(self.sort_items())
        if self.accept_kw("limit"):
            t = self.advance()
            if t.kind == "kw" and t.lower == "all":
                limit = None
            else:
                limit = int(t.text)
        return ast.Query(body, tuple(with_queries), order_by, limit)

    def sort_items(self) -> List[ast.SortItem]:
        items = []
        while True:
            e = self.expr()
            asc = True
            if self.accept_kw("asc"):
                asc = True
            elif self.accept_kw("desc"):
                asc = False
            nulls_first = None
            if self.accept_kw("nulls"):
                if self.accept_kw("first"):
                    nulls_first = True
                else:
                    self.expect_kw("last")
                    nulls_first = False
            items.append(ast.SortItem(e, asc, nulls_first))
            if not self.accept_op(","):
                return items

    def query_body(self):
        left = self.query_term()
        while self.at_kw("union", "except"):
            op = self.advance().lower
            all_ = bool(self.accept_kw("all"))
            self.accept_kw("distinct")
            right = self.query_term()
            left = ast.SetOperation(op, all_, left, right)
        return left

    def query_term(self):
        left = self.query_primary()
        while self.at_kw("intersect"):
            self.advance()
            all_ = bool(self.accept_kw("all"))
            self.accept_kw("distinct")
            right = self.query_primary()
            left = ast.SetOperation("intersect", all_, left, right)
        return left

    def query_primary(self):
        if self.accept_op("("):
            q = self.query()
            self.expect_op(")")
            return q
        if self.accept_kw("values"):
            rows = [self._values_row()]
            while self.accept_op(","):
                rows.append(self._values_row())
            return ast.Values(tuple(rows))
        return self.query_spec()

    def _values_row(self):
        if self.accept_op("("):
            row = [self.expr()]
            while self.accept_op(","):
                row.append(self.expr())
            self.expect_op(")")
            return tuple(row)
        return (self.expr(),)  # single-column row without parens

    def query_spec(self) -> ast.QuerySpec:
        self.expect_kw("select")
        distinct = False
        if self.accept_kw("distinct"):
            distinct = True
        else:
            self.accept_kw("all")
        items = [self.select_item()]
        while self.accept_op(","):
            items.append(self.select_item())
        from_ = None
        if self.accept_kw("from"):
            from_ = self.relation()
        where = self.expr() if self.accept_kw("where") else None
        group_by: Tuple[ast.Expression, ...] = ()
        grouping_sets = None
        if self.accept_kw("group"):
            self.expect_kw("by")
            if self.at_soft("grouping") and self.at_soft("sets", ahead=1):
                self.advance()
                self.advance()
                self.expect_op("(")
                grouping_sets = [self._grouping_set()]
                while self.accept_op(","):
                    grouping_sets.append(self._grouping_set())
                self.expect_op(")")
            elif self.at_soft("rollup") and self.peek(1).text == "(":
                self.advance()
                self.advance()
                cols = [self.expr()]
                while self.accept_op(","):
                    cols.append(self.expr())
                self.expect_op(")")
                # ROLLUP(a,b) == GROUPING SETS ((a,b),(a),())
                grouping_sets = [tuple(cols[:k]) for k in range(len(cols), -1, -1)]
            elif self.at_soft("cube") and self.peek(1).text == "(":
                self.advance()
                self.advance()
                cols = [self.expr()]
                while self.accept_op(","):
                    cols.append(self.expr())
                self.expect_op(")")
                import itertools as _it

                grouping_sets = [
                    tuple(c for c, keep in zip(cols, mask) if keep)
                    for mask in _it.product([True, False], repeat=len(cols))
                ]
            else:
                gb = [self.expr()]
                while self.accept_op(","):
                    gb.append(self.expr())
                group_by = tuple(gb)
        having = self.expr() if self.accept_kw("having") else None
        return ast.QuerySpec(
            tuple(items), distinct, from_, where, group_by, having,
            grouping_sets=tuple(grouping_sets) if grouping_sets is not None else None,
        )

    def _grouping_set(self) -> tuple:
        if self.accept_op("("):
            if self.at_op(")"):
                self.advance()
                return ()
            cols = [self.expr()]
            while self.accept_op(","):
                cols.append(self.expr())
            self.expect_op(")")
            return tuple(cols)
        return (self.expr(),)

    def select_item(self) -> ast.SelectItem:
        if self.at_op("*"):
            self.advance()
            return ast.SelectItem(ast.Star())
        # qualified star: ident . *
        if self.peek().kind == "ident" and self.peek(1).kind == "op" and self.peek(1).text == "." \
                and self.peek(2).kind == "op" and self.peek(2).text == "*":
            q = self.advance().text
            self.advance()
            self.advance()
            return ast.SelectItem(ast.Star(qualifier=(q,)))
        e = self.expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.identifier()
        elif self.peek().kind == "ident":
            alias = self.advance().text
        return ast.SelectItem(e, alias)

    # --- relations ---
    def relation(self) -> ast.Relation:
        left = self.joined_relation()
        while self.accept_op(","):
            right = self.joined_relation()
            left = ast.Join("implicit", left, right)
        return left

    def joined_relation(self) -> ast.Relation:
        left = self.table_primary()
        while True:
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self.table_primary()
                left = ast.Join("cross", left, right)
                continue
            jt = None
            if self.at_kw("join"):
                jt = "inner"
            elif self.at_kw("inner") and self.at_kw("join", ahead=1):
                self.advance()
                jt = "inner"
            elif self.at_kw("left", "right", "full"):
                jt = self.peek().lower
                self.advance()
                self.accept_kw("outer")
            if jt is None:
                return left
            self.expect_kw("join")
            right = self.table_primary()
            if self.accept_kw("using"):
                self.expect_op("(")
                cols = [self.identifier()]
                while self.accept_op(","):
                    cols.append(self.identifier())
                self.expect_op(")")
                left = ast.Join(jt, left, right, using=tuple(cols))
            else:
                self.expect_kw("on")
                left = ast.Join(jt, left, right, on=self.expr())

    def table_primary(self) -> ast.Relation:
        if self.at_kw("table") and self.peek(1).text == "(":
            # TABLE(fn(arg [, ...])) — polymorphic table function invocation
            # (reference: grammar tableFunctionInvocation +
            # operator/table/). Arguments may be positional or named
            # (name => expr).
            self.advance()
            self.advance()  # (
            fn = self.identifier().lower()
            self.expect_op("(")
            args, named = [], {}
            if not self.at_op(")"):
                while True:
                    if (self.peek().kind == "ident"
                            and self.peek(1).kind == "op"
                            and self.peek(1).text == "=>"):
                        n = self.advance().text.lower()
                        self.advance()  # =>
                        named[n] = self.expr()
                    else:
                        args.append(self.expr())
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
            self.expect_op(")")
            rel: ast.Relation = ast.TableFunctionCall(fn, tuple(args), named)
            return self._maybe_aliased(rel)
        if self.at_soft("unnest") and self.peek(1).text == "(":
            self.advance()
            self.advance()  # (
            exprs = [self.expr()]
            while self.accept_op(","):
                exprs.append(self.expr())
            self.expect_op(")")
            ordinality = False
            if self.at_kw("with") and self.at_soft("ordinality", ahead=1):
                self.advance()
                self.advance()
                ordinality = True
            rel: ast.Relation = ast.Unnest(tuple(exprs), ordinality)
            return self._maybe_aliased(rel)
        if self.accept_op("("):
            if self.at_kw("select", "with", "values"):
                q = self.query()
                self.expect_op(")")
                rel: ast.Relation = ast.SubqueryRelation(q)
            else:
                rel = self.relation()
                self.expect_op(")")
        else:
            rel = ast.Table(tuple(self.qualified_name()))
        return self._maybe_aliased(rel)

    def _maybe_aliased(self, rel: ast.Relation) -> ast.Relation:
        if self.at_soft("match_recognize") and self.peek(1).text == "(":
            # MATCH_RECOGNIZE over the bare relation, then maybe aliased
            return self._maybe_aliased(self._match_recognize(rel))
        alias = None
        col_aliases = None
        if self.accept_kw("as"):
            alias = self.identifier()
        elif self.peek().kind == "ident" and not self.at_soft("match_recognize"):
            alias = self.advance().text
        if alias is not None and self.accept_op("("):
            cols = [self.identifier()]
            while self.accept_op(","):
                cols.append(self.identifier())
            self.expect_op(")")
            col_aliases = tuple(cols)
        if alias is not None:
            rel = ast.AliasedRelation(rel, alias, col_aliases)
        if self.at_soft("match_recognize") and self.peek(1).text == "(":
            # aliasedRelation MATCH_RECOGNIZE (...) [AS m] — the reference
            # grammar's patternRecognition position
            return self._maybe_aliased(self._match_recognize(rel))
        return rel

    def _match_recognize(self, input_rel: ast.Relation) -> ast.Relation:
        """MATCH_RECOGNIZE ( [PARTITION BY ...] [ORDER BY ...]
        [MEASURES e AS n, ...] [ONE ROW PER MATCH]
        [AFTER MATCH SKIP (PAST LAST ROW | TO NEXT ROW)]
        PATTERN (A B+ C*) DEFINE A AS pred, ... )"""
        self.advance()  # match_recognize
        self.expect_op("(")
        partition_by: List[ast.Expression] = []
        order_by: List = []
        measures: List = []
        after_match = "past_last"
        if self.accept_soft("partition"):
            self.expect_kw("by")
            partition_by.append(self.expr())
            while self.accept_op(","):
                partition_by.append(self.expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.expr()
                asc = True
                if self.accept_kw("desc"):
                    asc = False
                else:
                    self.accept_kw("asc")
                order_by.append((e, asc))
                if not self.accept_op(","):
                    break
        if self.accept_soft("measures"):
            while True:
                e = self.expr()
                self.expect_kw("as")
                measures.append((e, self.identifier()))
                if not self.accept_op(","):
                    break
        if self.accept_soft("one"):
            if not (self.accept_soft("row") and self.accept_soft("per")
                    and self.accept_soft("match")):
                raise ParseError("expected ONE ROW PER MATCH")
        if self.accept_soft("after"):
            if not (self.accept_soft("match") and self.accept_soft("skip")):
                raise ParseError("expected AFTER MATCH SKIP")
            if self.accept_soft("past"):
                if not (self.accept_soft("last") and self.accept_soft("row")):
                    raise ParseError("expected PAST LAST ROW")
                after_match = "past_last"
            elif self.accept_soft("to"):
                if not (self.accept_soft("next") and self.accept_soft("row")):
                    raise ParseError(
                        "only SKIP PAST LAST ROW / SKIP TO NEXT ROW supported")
                after_match = "next_row"
            else:
                raise ParseError("expected PAST LAST ROW or TO NEXT ROW")
        if not self.accept_soft("pattern"):
            raise ParseError("MATCH_RECOGNIZE requires PATTERN (...)")
        self.expect_op("(")
        pattern: List = []
        while not self.at_op(")"):
            var = self.identifier().lower()
            quant = "1"
            if self.at_op("*", "+", "?"):
                quant = self.advance().text
            pattern.append((var, quant))
        self.expect_op(")")
        if not pattern:
            raise ParseError("empty PATTERN")
        if not self.accept_soft("define"):
            raise ParseError("MATCH_RECOGNIZE requires DEFINE")
        defines: List = []
        while True:
            var = self.identifier().lower()
            self.expect_kw("as")
            defines.append((var, self.expr()))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return ast.MatchRecognize(
            input_rel, tuple(partition_by), tuple(order_by), tuple(measures),
            after_match, tuple(pattern), tuple(defines))

    def qualified_name(self) -> List[str]:
        parts = [self.identifier()]
        while self.at_op(".") and self.peek(1).kind in ("ident", "kw"):
            self.advance()
            parts.append(self.identifier())
        return parts

    # --- expressions ---
    def expr(self) -> ast.Expression:
        return self.or_expr()

    def or_expr(self) -> ast.Expression:
        left = self.and_expr()
        while self.accept_kw("or"):
            left = ast.LogicalBinary("or", left, self.and_expr())
        return left

    def and_expr(self) -> ast.Expression:
        left = self.not_expr()
        while self.accept_kw("and"):
            left = ast.LogicalBinary("and", left, self.not_expr())
        return left

    def not_expr(self) -> ast.Expression:
        if self.accept_kw("not"):
            return ast.Not(self.not_expr())
        return self.predicate()

    def predicate(self) -> ast.Expression:
        left = self.additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.advance().text
                if op == "!=":
                    op = "<>"
                right = self.additive()
                left = ast.Comparison(op, left, right)
                continue
            negated = False
            if self.at_kw("not") and self.at_kw("between", "in", "like", ahead=1):
                self.advance()
                negated = True
            if self.accept_kw("between"):
                lo = self.additive()
                self.expect_kw("and")
                hi = self.additive()
                left = ast.Between(left, lo, hi, negated)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    q = self.query()
                    self.expect_op(")")
                    left = ast.InSubquery(left, q, negated)
                else:
                    items = [self.expr()]
                    while self.accept_op(","):
                        items.append(self.expr())
                    self.expect_op(")")
                    left = ast.InList(left, tuple(items), negated)
                continue
            if self.accept_kw("like"):
                pattern = self.additive()
                escape = None
                if self.accept_kw("escape"):
                    escape = self.additive()
                left = ast.Like(left, pattern, escape, negated)
                continue
            if self.accept_kw("is"):
                neg = bool(self.accept_kw("not"))
                self.expect_kw("null")
                left = ast.IsNull(left, negated=neg)
                continue
            if negated:
                raise ParseError(f"dangling NOT at {self.peek().pos}")
            return left

    def additive(self) -> ast.Expression:
        left = self.multiplicative()
        while True:
            if self.at_op("+", "-"):
                op = self.advance().text
                left = ast.Arithmetic(op, left, self.multiplicative())
            elif self.at_op("||"):
                self.advance()
                left = ast.FunctionCall("concat", (left, self.multiplicative()))
            else:
                return left

    def multiplicative(self) -> ast.Expression:
        left = self.unary()
        while self.at_op("*", "/", "%"):
            op = self.advance().text
            left = ast.Arithmetic(op, left, self.unary())
        return left

    def unary(self) -> ast.Expression:
        if self.accept_op("-"):
            return ast.Negative(self.unary())
        self.accept_op("+")
        return self.primary()

    def primary(self) -> ast.Expression:
        e = self._primary_base()
        while True:
            if self.at_op("["):
                self.advance()
                idx = self.expr()
                self.expect_op("]")
                e = ast.Subscript(e, idx)
                continue
            if (self.at_kw("at") or self.at_soft("at")) \
                    and self.at_soft("time", ahead=1) \
                    and self.at_soft("zone", ahead=2):
                self.advance()
                self.advance()
                self.advance()
                z = self.advance()
                if z.kind != "string":
                    raise ParseError(f"expected time zone string at {z.pos}")
                e = ast.AtTimeZone(e, z.text)
                continue
            return e

    def _primary_base(self) -> ast.Expression:
        t = self.peek()
        if self.at_op("?"):
            self.advance()
            idx = getattr(self, "_param_counter", 0)
            self._param_counter = idx + 1
            return ast.Parameter(idx)
        if self.at_soft("array") and self.peek(1).text == "[":
            self.advance()
            self.advance()  # [
            items: List[ast.Expression] = []
            if not self.at_op("]"):
                items.append(self.expr())
                while self.accept_op(","):
                    items.append(self.expr())
            self.expect_op("]")
            return ast.ArrayConstructor(tuple(items))
        if t.kind == "number":
            self.advance()
            return ast.Literal("number", t.text)
        if t.kind == "string":
            self.advance()
            return ast.Literal("string", t.text)
        if self.at_kw("null"):
            self.advance()
            return ast.Literal("null", None)
        if self.at_kw("true", "false"):
            self.advance()
            return ast.Literal("boolean", t.lower == "true")
        if self.at_kw("date") and self.peek(1).kind == "string":
            self.advance()
            return ast.Literal("date", self.advance().text)
        if self.at_kw("timestamp") and self.peek(1).kind == "string":
            self.advance()
            return ast.Literal("timestamp", self.advance().text)
        if t.kind == "ident" and t.lower == "x" and self.peek(1).kind == "string":
            self.advance()
            return ast.Literal("varbinary", self.advance().text)
        if self.at_kw("interval"):
            self.advance()
            sign = 1
            if self.accept_op("-"):
                sign = -1
            else:
                self.accept_op("+")
            v = self.advance()
            if v.kind != "string":
                raise ParseError(f"expected interval string at {v.pos}")
            unit_tok = self.advance()
            unit = unit_tok.lower
            if unit not in ("year", "month", "day", "hour", "minute", "second"):
                raise ParseError(f"bad interval unit {unit_tok.text!r}")
            return ast.IntervalLiteral(int(v.text), unit, sign)
        if self.at_kw("case"):
            return self.case_expr()
        if self.at_kw("cast"):
            self.advance()
            self.expect_op("(")
            value = self.expr()
            self.expect_kw("as")
            type_name = self.type_name()
            self.expect_op(")")
            return ast.Cast(value, type_name)
        if self.at_kw("extract"):
            self.advance()
            self.expect_op("(")
            field = self.advance().lower
            self.expect_kw("from")
            value = self.expr()
            self.expect_op(")")
            return ast.Extract(field, value)
        if self.at_kw("substring"):
            self.advance()
            self.expect_op("(")
            value = self.expr()
            if self.accept_kw("from"):
                start = self.expr()
                if self.accept_kw("for"):
                    length = self.expr()
                    self.expect_op(")")
                    return ast.FunctionCall("substring", (value, start, length))
                self.expect_op(")")
                return ast.FunctionCall("substring", (value, start))
            args = [value]
            while self.accept_op(","):
                args.append(self.expr())
            self.expect_op(")")
            return ast.FunctionCall("substring", tuple(args))
        if self.at_kw("exists"):
            self.advance()
            self.expect_op("(")
            q = self.query()
            self.expect_op(")")
            return ast.Exists(q)
        if self.accept_op("("):
            if self.at_kw("select", "with"):
                q = self.query()
                self.expect_op(")")
                return ast.ScalarSubquery(q)
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind == "ident" or (t.kind == "kw" and t.lower in (
            "year", "month", "day", "date", "first", "last", "quarter", "values",
            "if", "session", "set", "reset",
        )):
            # function call or (qualified) identifier
            if self.peek(1).kind == "op" and self.peek(1).text == "(":
                name = self.advance().text
                self.advance()  # (
                if self.accept_op("*"):
                    self.expect_op(")")
                    if self.at_soft("filter") and self.peek(1).text == "(":
                        self.advance()
                        self.advance()
                        self.expect_kw("where")
                        cond = self.expr()
                        self.expect_op(")")
                        return ast.FunctionCall("count_if", (cond,))
                    if self.at_soft("over") and self.peek(1).text == "(":
                        return self.window_suffix(name.lower(), (), is_star=True)
                    return ast.FunctionCall(name.lower(), (), is_star=True)
                distinct = bool(self.accept_kw("distinct"))
                self.accept_kw("all")
                args: List[ast.Expression] = []
                if not self.at_op(")"):
                    args.append(self._arg_or_lambda())
                    while self.accept_op(","):
                        args.append(self._arg_or_lambda())
                self.expect_op(")")
                # FILTER (WHERE cond) — aggregate filter clause; rewritten
                # at parse time: agg(x) FILTER (WHERE c) == agg(CASE WHEN c
                # THEN x END), count(*) == count_if(c) (reference:
                # AggregationNode.Aggregation's filter symbol; the rewrite
                # is exact because aggregates ignore NULL inputs)
                if self.at_soft("filter") and self.peek(1).text == "(":
                    self.advance()
                    self.advance()
                    self.expect_kw("where")
                    cond = self.expr()
                    self.expect_op(")")
                    fn = name.lower()
                    if fn == "count" and not args:
                        return ast.FunctionCall("count_if", (cond,))
                    if distinct or not args:
                        raise ParseError(
                            "FILTER is supported on single-argument aggregates")
                    filtered = ast.SearchedCase(((cond, args[0]),), None)
                    return ast.FunctionCall(fn, (filtered,) + tuple(args[1:]))
                if self.at_soft("over") and self.peek(1).text == "(":
                    if distinct:
                        raise ParseError("DISTINCT window aggregates not supported")
                    return self.window_suffix(name.lower(), tuple(args))
                return ast.FunctionCall(name.lower(), tuple(args), distinct=distinct)
            parts = self.qualified_name()
            return ast.Identifier(tuple(parts))
        raise ParseError(f"unexpected token {t.text!r} at {t.pos}")

    def _arg_or_lambda(self) -> ast.Expression:
        """A function argument: ``x -> expr`` / ``(x, y) -> expr`` lambdas
        or a plain expression."""
        if self.peek().kind == "ident" and self.peek(1).text == "->":
            p = self.identifier()
            self.advance()  # ->
            return ast.Lambda((p,), self.expr())
        if (self.at_op("(") and self.peek(1).kind == "ident"
                and self.peek(2).text in (",", ")")):
            # lookahead for "(a, b, ...) ->"
            save = self.i
            try:
                self.advance()
                ps = [self.identifier()]
                while self.accept_op(","):
                    ps.append(self.identifier())
                if self.at_op(")") and self.peek(1).text == "->":
                    self.advance()
                    self.advance()
                    return ast.Lambda(tuple(ps), self.expr())
            except ParseError:
                pass
            self.i = save
        return self.expr()

    def window_suffix(self, name, args, is_star=False) -> ast.WindowFunction:
        """OVER ( [PARTITION BY ...] [ORDER BY ...] [frame] )"""
        self.expect_soft("over")
        self.expect_op("(")
        partition_by: List[ast.Expression] = []
        order_by: List[ast.SortItem] = []
        frame = None
        if self.accept_soft("partition"):
            self.expect_kw("by")
            partition_by.append(self.expr())
            while self.accept_op(","):
                partition_by.append(self.expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by = self.sort_items()
        if self.at_soft("rows", "range", "groups"):
            mode = self.advance().lower
            if self.accept_kw("between"):
                lo = self._frame_bound()
                self.expect_kw("and")
                hi = self._frame_bound()
            else:
                lo = self._frame_bound()
                hi = "current row"
            frame = (mode, lo, hi)
        self.expect_op(")")
        return ast.WindowFunction(
            name, args, tuple(partition_by), tuple(order_by), is_star, frame
        )

    def _frame_bound(self) -> str:
        if self.accept_soft("unbounded"):
            if self.accept_soft("preceding"):
                return "unbounded preceding"
            self.expect_soft("following")
            return "unbounded following"
        if self.accept_soft("current"):
            self.expect_soft("row")
            return "current row"
        t = self.advance()  # numeric offset
        if self.accept_soft("preceding"):
            return f"{t.text} preceding"
        self.expect_soft("following")
        return f"{t.text} following"

    def case_expr(self) -> ast.Expression:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.expr()
        whens = []
        while self.accept_kw("when"):
            cond = self.expr()
            self.expect_kw("then")
            val = self.expr()
            whens.append((cond, val))
        default = None
        if self.accept_kw("else"):
            default = self.expr()
        self.expect_kw("end")
        if operand is not None:
            return ast.SimpleCase(operand, tuple(whens), default)
        return ast.SearchedCase(tuple(whens), default)

    def type_name(self) -> str:
        base = self.advance().text
        if base.lower() == "row" and self.at_op("("):
            # row fields: [name] type, ...
            self.advance()
            fields = [self._row_field()]
            while self.accept_op(","):
                fields.append(self._row_field())
            self.expect_op(")")
            return f"{base}({', '.join(fields)})"
        if base.lower() in ("array", "map") and self.at_op("("):
            self.advance()
            args = [self.type_name()]
            while self.accept_op(","):
                args.append(self.type_name())
            self.expect_op(")")
            return f"{base}({','.join(args)})"
        parts = [base]
        if self.accept_op("("):
            parts.append("(")
            parts.append(self.advance().text)
            while self.accept_op(","):
                parts.append(",")
                parts.append(self.advance().text)
            self.expect_op(")")
            parts.append(")")
        if base.lower() == "timestamp" and self.at_kw("with"):
            # timestamp [(p)] WITH TIME ZONE
            self.advance()
            if not (self.accept_soft("time") and self.accept_soft("zone")):
                raise ParseError("expected TIME ZONE after WITH")
            parts.append(" with time zone")
        return "".join(parts)

    def _row_field(self) -> str:
        """One ROW type field: ``name type`` or bare ``type``."""
        nxt = self.peek(1)
        if self.peek().kind == "ident" and (
                nxt.kind in ("ident", "kw")
                or (nxt.kind == "op" and nxt.text not in (",", ")", "("))):
            name = self.advance().text
            return f"{name} {self.type_name()}"
        return self.type_name()
