"""Access control: the authorization seam of the engine (a copy of
trino_tpu/server/security.py).

Reference: ``security/AccessControlManager`` + SPI ``SystemAccessControl``
(~50 files of authenticators/authorizers). The engine-facing surface here
is the two checks every query path needs — can this identity run queries,
and can it read this table — with an allow-all default and a rule-based
implementation (the file-based access control plugin's role).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


class AccessDeniedError(PermissionError):
    pass


@dataclasses.dataclass(frozen=True)
class Identity:
    """Who is running the query (reference: spi/security/Identity)."""

    user: str = "anonymous"


class AccessControl:
    """Allow-all default (reference: AllowAllSystemAccessControl)."""

    def check_can_execute_query(self, identity: Identity) -> None:
        pass

    def check_can_select(self, identity: Identity, catalog: str,
                         schema: str, table: str) -> None:
        pass

    def check_can_write(self, identity: Identity, catalog: str,
                        schema: str, table: str) -> None:
        pass


@dataclasses.dataclass(frozen=True)
class TableRule:
    """One rule of the file-based access control format: user pattern +
    catalog/schema/table patterns + allowed privileges."""

    users: Sequence[str]  # exact user names, or "*"
    catalog: str = "*"
    schema: str = "*"
    table: str = "*"
    privileges: Sequence[str] = ("SELECT", "INSERT")

    def matches(self, identity: Identity, catalog: str, schema: str, table: str) -> bool:
        def m(pat: str, v: str) -> bool:
            return pat == "*" or pat == v

        user_ok = "*" in self.users or identity.user in self.users
        return user_ok and m(self.catalog, catalog) and m(self.schema, schema) and m(self.table, table)


class RuleBasedAccessControl(AccessControl):
    """First-matching-rule wins; no match = denied (reference:
    plugin file-based FileBasedSystemAccessControl semantics)."""

    def __init__(self, rules: List[TableRule]):
        self.rules = list(rules)

    def check_can_select(self, identity, catalog, schema, table) -> None:
        for r in self.rules:
            if r.matches(identity, catalog, schema, table):
                if "SELECT" in r.privileges:
                    return
                break
        raise AccessDeniedError(
            f"Access Denied: user {identity.user} cannot select from "
            f"{catalog}.{schema}.{table}")

    def check_can_write(self, identity, catalog, schema, table) -> None:
        for r in self.rules:
            if r.matches(identity, catalog, schema, table):
                if "INSERT" in r.privileges:
                    return
                break
        raise AccessDeniedError(
            f"Access Denied: user {identity.user} cannot write to "
            f"{catalog}.{schema}.{table}")
