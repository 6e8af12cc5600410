"""SQL lexer.

Reference: the lexer rules at the bottom of
``core/trino-grammar/src/main/antlr4/io/trino/grammar/sql/SqlBase.g4``
(IDENTIFIER / QUOTED_IDENTIFIER / STRING / number / comment rules). Hand
written here: tokens carry position for error messages.
"""
from __future__ import annotations

import dataclasses
from typing import List

KEYWORDS = {
    # kept to what the round-1 grammar understands; grows with the grammar
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "exists", "between", "like", "escape",
    "is", "null", "true", "false", "case", "when", "then", "else", "end",
    "cast", "extract", "interval", "date", "timestamp", "join", "inner",
    "left", "right", "full", "outer", "cross", "on", "using", "union",
    "intersect", "except", "all", "distinct", "with", "asc", "desc",
    "nulls", "first", "last", "explain", "analyze", "show", "tables",
    "schemas", "columns", "describe", "values", "substring", "for", "year",
    "month", "day", "hour", "minute", "second", "quarter", "set", "reset",
    "session", "create", "insert", "into", "drop", "if", "table",
}


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str  # 'kw' | 'ident' | 'number' | 'string' | 'op' | 'eof'
    text: str
    pos: int

    @property
    def lower(self) -> str:
        return self.text.lower()


class LexError(ValueError):
    pass


_OPS = [
    "<>", "!=", ">=", "<=", "||", "=>", "->", "=", "<", ">", "+", "-", "*",
    "/", "%", "(", ")", "[", "]", ",", ".", ";", "?",
]


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i)
            if j < 0:
                raise LexError(f"unterminated block comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise LexError(f"unterminated string literal at {i}")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":  # escaped ''
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            out.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise LexError(f"unterminated quoted identifier at {i}")
            out.append(Token("ident", sql[i + 1 : j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i:
                    if j + 1 < n and (sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                        seen_exp = True
                        j += 2
                    else:
                        break
                else:
                    break
            out.append(Token("number", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            text = sql[i:j]
            kind = "kw" if text.lower() in KEYWORDS else "ident"
            out.append(Token(kind, text, i))
            i = j
            continue
        for op in _OPS:
            if sql.startswith(op, i):
                out.append(Token("op", op, i))
                i += len(op)
                break
        else:
            raise LexError(f"unexpected character {c!r} at position {i}")
    out.append(Token("eof", "", n))
    return out
