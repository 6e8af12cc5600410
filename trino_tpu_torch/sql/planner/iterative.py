"""Iterative rule optimizer: memo + rules + fixpoint loop.

Reference: ``sql/planner/iterative/IterativeOptimizer.java:67`` +
``Memo.java`` + ``Rule.java`` — plans live in a memo of single-node groups
whose children are group references, so a rule rewrite swaps one group's
node without copying the rest of the tree, and the loop re-fires rules
until no pattern matches (or the transformation budget trips). This is the
scaling path past the big-bang pass pipeline in optimizer.py: new rewrites
become local rules instead of new whole-tree recursions.

The memo here is a rewrite memo (one node per group), exactly like the
reference's — not a Cascades exploration memo with alternatives.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from trino_tpu_torch.sql.planner import plan as P


@dataclasses.dataclass
class GroupReference(P.PlanNode):
    """Placeholder child pointing at a memo group (reference:
    iterative/GroupReference.java). Output types/names delegate to the
    group's current node so parents stay type-checkable mid-rewrite."""

    memo: "Memo" = None
    group: int = 0

    @property
    def sources(self):
        return ()

    @property
    def output_types(self):
        return self.memo.node(self.group).output_types

    @property
    def output_names(self):
        return self.memo.node(self.group).output_names


def child_slots(node: P.PlanNode) -> List[Tuple[str, bool]]:
    """(attribute, is_list) slots holding this node's children — the
    channel-positional plan nodes keep children in one of three layouts."""
    if isinstance(node, (P.JoinNode, P.SetOpNode)):
        return [("left", False), ("right", False)]
    if isinstance(node, P.UnionNode):
        return [("sources_", True)]
    if hasattr(node, "source") and node.source is not None:
        return [("source", False)]
    return []


def replace_children(node: P.PlanNode, new_children: Sequence[P.PlanNode]) -> P.PlanNode:
    """Shallow-copy ``node`` with its children replaced (order matches
    ``node.sources``)."""
    clone = dataclasses.replace(node)
    clone.id = node.id  # structural re-wiring keeps identity (id is
    # init=False, so dataclasses.replace would otherwise mint a fresh one)
    it = iter(new_children)
    for attr, is_list in child_slots(node):
        if is_list:
            old = getattr(node, attr)
            setattr(clone, attr, [next(it) for _ in old])
        else:
            setattr(clone, attr, next(it))
    return clone


class Memo:
    """Single-node groups; children of memo-resident nodes are
    GroupReferences (reference: iterative/Memo.java)."""

    def __init__(self, root: P.PlanNode):
        self._groups: Dict[int, P.PlanNode] = {}
        self._next = 0
        self.root_group = self._intern(root)

    def _intern(self, node: P.PlanNode) -> int:
        gid = self._next
        self._next += 1
        self._groups[gid] = self._with_ref_children(node)
        return gid

    def _with_ref_children(self, node: P.PlanNode) -> P.PlanNode:
        children = list(node.sources)
        if not children:
            return node
        refs = [
            c if isinstance(c, GroupReference)
            else GroupReference(memo=self, group=self._intern(c))
            for c in children
        ]
        return replace_children(node, refs)

    def node(self, group: int) -> P.PlanNode:
        return self._groups[group]

    def reachable_groups(self) -> List[int]:
        """Groups reachable from the root — rewrites that drop nodes leave
        orphaned groups behind (the reference memo garbage-collects them;
        here the loop simply skips them)."""
        seen: List[int] = []
        stack = [self.root_group]
        visited = set()
        while stack:
            gid = stack.pop()
            if gid in visited:
                continue
            visited.add(gid)
            seen.append(gid)
            for c in self._groups[gid].sources:
                if isinstance(c, GroupReference):
                    stack.append(c.group)
        return seen

    def replace(self, group: int, node: P.PlanNode) -> None:
        """Install a rewritten node; its NEW (non-reference) children are
        interned as fresh groups."""
        self._groups[group] = self._with_ref_children(node)

    def resolve(self, node: P.PlanNode) -> P.PlanNode:
        """GroupReference -> its group's current node (reference: Lookup)."""
        while isinstance(node, GroupReference):
            node = self._groups[node.group]
        return node

    def extract(self, group: Optional[int] = None) -> P.PlanNode:
        """Materialize the memo back into a plain plan tree."""
        node = self._groups[self.root_group if group is None else group]
        children = [
            self.extract(c.group) if isinstance(c, GroupReference) else c
            for c in node.sources
        ]
        if not children:
            return node
        return replace_children(node, children)


@dataclasses.dataclass
class Context:
    """What a rule sees besides the matched node (reference: Rule.Context —
    lookup + session/stats access + id allocator)."""

    memo: Memo
    session: object

    def resolve(self, node: P.PlanNode) -> P.PlanNode:
        return self.memo.resolve(node)


class Rule:
    """One local rewrite (reference: iterative/Rule.java). ``pattern`` is
    the matched node class; ``apply`` returns the replacement node (whose
    children may be GroupReferences from the matched node, or plain new
    subtrees) or None when the rule decides not to fire — cost gates live
    inside ``apply`` via ``context.session`` stats."""

    pattern: type = P.PlanNode

    def apply(self, node: P.PlanNode, context: Context) -> Optional[P.PlanNode]:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


class IterativeOptimizer:
    """Fire rules to fixpoint over the memo (reference:
    IterativeOptimizer.exploreGroup's top-down loop + re-exploration of
    parents when children change)."""

    def __init__(self, rules: Sequence[Rule], max_transforms: int = 10_000):
        self.rules = list(rules)
        self.max_transforms = max_transforms
        self.fired: List[str] = []  # rule-name log (PlanTester-style asserts)

    def optimize(self, root: P.PlanNode, session=None) -> P.PlanNode:
        memo = Memo(root)
        ctx = Context(memo, session)
        budget = self.max_transforms
        progress = True
        while progress:
            progress = False
            for gid in memo.reachable_groups():
                changed = True
                while changed and budget > 0:
                    changed = False
                    node = memo.node(gid)
                    for rule in self.rules:
                        if not isinstance(node, rule.pattern):
                            continue
                        out = rule.apply(node, ctx)
                        if out is None:
                            continue
                        memo.replace(gid, out)
                        self.fired.append(rule.name)
                        budget -= 1
                        changed = progress = True
                        break
            if budget <= 0:
                break
        return memo.extract()
