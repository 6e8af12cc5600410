"""Name-resolution scopes.

Reference: ``core/trino-main/.../sql/analyzer/Scope.java`` — a scope is an
ordered list of fields, each optionally qualified by a relation alias;
identifier resolution tries (alias, name) then bare name, erroring on
ambiguity. Correlated references resolve through the parent scope chain.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from trino_tpu_torch import types as T


class AnalysisError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Field:
    name: Optional[str]  # None for anonymous (expression) fields
    type: T.Type
    relation_alias: Optional[str] = None  # the qualifier, if any


@dataclasses.dataclass
class Scope:
    fields: List[Field]
    parent: Optional["Scope"] = None

    def resolve(self, parts: Tuple[str, ...]) -> Tuple[int, Field, int]:
        """Resolve a (possibly qualified) name.

        Returns (channel, field, depth) where depth=0 means this scope,
        1 = parent (a correlated reference), etc.
        """
        matches = self._match(parts)
        if len(matches) > 1:
            raise AnalysisError(f"column reference is ambiguous: {'.'.join(parts)}")
        if matches:
            i = matches[0]
            return i, self.fields[i], 0
        if self.parent is not None:
            ch, f, d = self.parent.resolve(parts)
            return ch, f, d + 1
        raise AnalysisError(f"column cannot be resolved: {'.'.join(parts)}")

    def _match(self, parts: Tuple[str, ...]) -> List[int]:
        name = parts[-1].lower()
        qualifier = parts[-2].lower() if len(parts) >= 2 else None
        out = []
        for i, f in enumerate(self.fields):
            if f.name is None or f.name.lower() != name:
                continue
            if qualifier is not None and (
                f.relation_alias is None or f.relation_alias.lower() != qualifier
            ):
                continue
            out.append(i)
        return out

    def channels_of_alias(self, alias: str) -> List[int]:
        return [
            i
            for i, f in enumerate(self.fields)
            if f.relation_alias is not None and f.relation_alias.lower() == alias.lower()
        ]
