"""The parameter count of a prepared statement: ``count_parameters`` of
trino_tpu/server/prepared.py, copied alone. The server's prepared-statement
registry and plan cache are not ported; the local session keeps its
prepared statements itself (``Session.prepared_statements``)."""
from __future__ import annotations

import dataclasses

from trino_tpu_torch.sql.parser import ast


def count_parameters(stmt) -> int:
    """Number of ``?`` markers a parsed statement carries (max index + 1 —
    the parser numbers them left to right)."""
    highest = -1

    def visit(node):
        nonlocal highest
        if isinstance(node, ast.Parameter):
            highest = max(highest, node.index)
        elif isinstance(node, (tuple, list)):
            for x in node:
                visit(x)
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                visit(getattr(node, f.name))

    visit(stmt)
    return highest + 1
