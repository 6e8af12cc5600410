"""The adaptive re-planner: rewrite not-yet-scheduled fragments from stats.
The port of trino_tpu/adaptive/replanner.py.

Reference: ``sql/planner/AdaptivePlanner.java`` (re-optimizes the remaining
plan between stage completions using ``RuntimeInfoProvider``) +
``DetermineJoinDistributionType`` re-fired on actual cardinalities. The
coordinator calls :meth:`AdaptivePlanner.adapt_fragment` at every stage
boundary — after the phased-execution build waits, immediately before the
fragment's tasks are created — so every rewrite touches only fragments
whose tasks do not exist yet. Superseded producer stages (their output
shape no longer matches the adapted consumer) are re-run as NEW fragments;
the caller cancels the originals.

Rules, in application order:

1. capacity reseeding (``adaptive_capacity_reseed``): exchange sources of
   the candidate fragment stamp ``runtime_rows`` from completed upstream
   stages — downstream estimates start from truth;
2. join-distribution switch (``adaptive_join_distribution``): with the
   build side stamped, the STATIC distribution rule
   (``stats.join_repartitions``) re-fires; a contradiction flips
   broadcast↔partitioned via the fragmenter's adapted-subtree cuts;
3. skew mitigation (``adaptive_skew_threshold``): hot partitions detected
   from per-partition output bytes re-run both join producers salted —
   probe rows of hot partitions spread across all partitions, build rows
   of hot partitions replicate everywhere (exactness argument in
   ``parallel/exchange.spread_partition_ids``).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch.adaptive.runtime_stats import RuntimeStatsProvider
from trino_tpu_torch.sql.planner import plan as P
from trino_tpu_torch.sql.planner.fragmenter import (
    PlanFragment, RemoteSourceNode, adapt_broadcast_to_partitioned,
    adapt_partitioned_to_broadcast)

# a partition is "hot" only above BOTH the relative threshold
# (adaptive_skew_threshold x the mean of the OTHER partitions) and this
# absolute row floor — tiny stages are trivially imbalanced and never
# worth a producer re-run. Detection runs on ROWS, not bytes: serde
# compression flattens a constant hot key to almost no bytes, inverting
# the byte signal, while join cost tracks rows.
SKEW_MIN_HOT_ROWS = 4096
# replicating hot build partitions to every task costs hot_bytes x tasks;
# past this budget the mitigation would cost more than the skew
SKEW_REPLICATE_MAX_BYTES = 64 << 20


@dataclasses.dataclass
class PlanChange:
    """One versioned plan change (reference: the plan-version snapshots
    AdaptivePlanner records on the query for EXPLAIN/UI)."""

    version: int
    rule: str  # join-distribution | capacity-reseed | skew-mitigation
    fragment: int  # the adapted (consumer) fragment
    description: str  # e.g. "broadcast->partitioned"
    # new producer fragments this change introduced (already in by_id)
    new_fragments: List[int] = dataclasses.field(default_factory=list)
    # producer fragments whose tasks the change orphaned (caller cancels)
    supersedes: List[int] = dataclasses.field(default_factory=list)
    detail: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "rule": self.rule,
            "fragment": self.fragment,
            "description": self.description,
            "newFragments": list(self.new_fragments),
            "supersedes": list(self.supersedes),
            "detail": dict(self.detail),
        }


def _is_leaf(root: P.PlanNode) -> bool:
    """A fragment is re-runnable only when it is a LEAF (scans + local
    operators, no RemoteSourceNode): its inputs re-enumerate from splits,
    whereas an exchange-fed fragment's upstream buffers were already
    drained by the original attempt."""
    return not any(isinstance(n, RemoteSourceNode) for n in P.walk_plan(root))


class AdaptivePlanner:
    """Applies the adaptive rules to one candidate fragment at a time."""

    def __init__(self, session, stats: RuntimeStatsProvider, n_workers: int,
                 id_alloc):
        self.session = session
        self.props = getattr(session, "properties", None) or {}
        self.stats = stats
        self.n_workers = n_workers
        self.id_alloc = id_alloc
        self._version = 0

    def _next_version(self) -> int:
        self._version += 1
        return self._version

    # ------------------------------------------------------------ the hook
    def adapt_fragment(
        self, frag: PlanFragment, by_id: Dict[int, PlanFragment],
    ) -> Tuple[List[PlanFragment], List[PlanChange], List[str]]:
        """Adapt one not-yet-scheduled fragment against the current runtime
        stats. Returns ``(new_fragments, changes, errors)``: the caller
        schedules the new producer fragments BEFORE ``frag``, cancels every
        fragment a change supersedes, records the changes, and reports the
        errors. Rules are exception-isolated from EACH OTHER: a later rule
        blowing up must not discard the audit record of a change an
        earlier rule already applied in place."""
        errors: List[str] = []
        if not bool(self.props.get("adaptive_execution_enabled", True)):
            return [], [], errors
        if _is_leaf(frag.root):
            # no exchange sources — no upstream stage to learn from, and
            # nothing any rule could rewrite; skip the stats sweep
            return [], [], errors
        reseed_on = bool(self.props.get("adaptive_capacity_reseed", False))
        join_rule_on = bool(
            self.props.get("adaptive_join_distribution", True))
        skew_on = int(self.props.get("adaptive_skew_threshold", 8) or 0) > 0
        has_remote_join = any(
            isinstance(n, P.JoinNode)
            and isinstance(n.right, RemoteSourceNode)
            for n in P.walk_plan(frag.root))
        if not reseed_on and not has_remote_join:
            # a join-free consumer (e.g. a hash final-agg stage) with
            # reseeding off: no rule can fire — skip the status sweep
            # instead of paying a full poll round per stage boundary
            return [], [], errors
        self.stats.snapshot()
        changes: List[PlanChange] = []
        new_frags: List[PlanFragment] = []
        if reseed_on:
            try:
                ch = self._reseed_sources(frag)
                if ch is not None:
                    changes.append(ch)
            except Exception as e:  # noqa: BLE001 — rule-isolated
                errors.append(f"capacity-reseed: {e}")
        # snapshot AFTER reseeding (stamps are metadata, not structure):
        # a structural rewrite that fails plan validation restores this —
        # the containment contract (errored plan/adapt span + keep the
        # pre-adaptation plan, never fail the query)
        from trino_tpu_torch.sql.planner.sanity import validation_enabled

        validate = validation_enabled(self.session)
        snapshot = (
            (copy.deepcopy(frag.root), frag.partitioning)
            if validate and has_remote_join and (join_rule_on or skew_on)
            else None)
        if join_rule_on and has_remote_join:
            try:
                flipped = self._maybe_flip_join(frag, by_id)
            except Exception as e:  # noqa: BLE001 — rule-isolated
                errors.append(f"join-distribution: {e}")
                flipped = None
            if flipped is not None and validate:
                flipped = self._contain_invalid(
                    frag, by_id, snapshot, flipped,
                    "join-distribution", errors)
            if flipped is not None:
                frags, ch = flipped
                new_frags.extend(frags)
                changes.append(ch)
                # restructured: one rewrite per round
                return new_frags, changes, errors
        if skew_on and has_remote_join:
            try:
                mitigated = self._maybe_mitigate_skew(frag, by_id)
            except Exception as e:  # noqa: BLE001 — rule-isolated
                errors.append(f"skew-mitigation: {e}")
                mitigated = None
            if mitigated is not None and validate:
                mitigated = self._contain_invalid(
                    frag, by_id, snapshot, mitigated,
                    "skew-mitigation", errors)
            if mitigated is not None:
                frags, ch = mitigated
                new_frags.extend(frags)
                changes.append(ch)
        return new_frags, changes, errors

    def _contain_invalid(self, frag, by_id, snapshot, produced, rule,
                         errors):
        """Validate the post-rewrite fragment graph; a PlanSanityError is
        CONTAINED: restore the pre-adaptation plan from ``snapshot``, pull
        the rule's new fragments back out of ``by_id``, and record the
        error (the coordinator turns it into an errored ``plan/adapt``
        span) — a runtime rewrite must never fail a query that would have
        run fine unadapted. Returns ``produced`` when valid, None when
        rolled back."""
        from trino_tpu_torch.sql.planner.sanity import validate_adapted

        frags, _ch = produced
        try:
            validate_adapted(frag, frags, by_id, phase=f"adaptive:{rule}")
        # any exception, not just PlanSanityError: a plan malformed enough
        # to crash the walker itself (IndexError in a node property, ...)
        # must roll back the same way — the caller swallows whatever
        # escapes here, which would leave the half-rewritten plan live
        except Exception as e:  # noqa: BLE001 — containment contract
            # restore a fresh COPY: a later rule may rewrite (and fail)
            # again, and its restore must not see this rule's mutations
            frag.root, frag.partitioning = (
                copy.deepcopy(snapshot[0]), snapshot[1])
            for f in frags:
                by_id.pop(f.id, None)
            errors.append(f"{rule}: contained plan-validation failure "
                          f"(pre-adaptation plan kept): {e}")
            return None
        return produced

    # --------------------------------------------- rule 2: reseed sources
    def _reseed_sources(self, frag: PlanFragment) -> Optional[PlanChange]:
        """Stamp every exchange source whose producing stage completed with
        its ACTUAL output rows — the TableScanNode.runtime_rows analog on
        fragment boundaries (estimation downstream starts from truth)."""
        stamped: Dict[int, int] = {}
        for node in P.walk_plan(frag.root):
            if not isinstance(node, RemoteSourceNode):
                continue
            if node.runtime_rows is not None:
                continue
            rows = self.stats.output_rows(node.fragment_id)
            if rows is not None:
                node.runtime_rows = rows
                stamped[node.fragment_id] = rows
        if not stamped:
            return None
        return PlanChange(
            version=self._next_version(), rule="capacity-reseed",
            fragment=frag.id,
            description=f"reseeded {len(stamped)} exchange source(s) "
                        "from actual stage rows",
            detail={"runtimeRows": {str(k): v for k, v in stamped.items()}})

    # --------------------------------- rule 1: join-distribution switch
    def _broadcast_limit(self) -> int:
        """The SAME limit resolution the static rule uses — recorded in
        the flip's PlanChange detail, never re-derived independently."""
        from trino_tpu_torch.sql.planner import stats as stats_mod

        return stats_mod.resolved_broadcast_limit(self.props)

    def _maybe_flip_join(
        self, frag: PlanFragment, by_id: Dict[int, PlanFragment],
    ) -> Optional[Tuple[List[PlanFragment], PlanChange]]:
        from trino_tpu_torch.sql.planner.optimizer import reoptimize_distribution

        for j in P.walk_plan(frag.root):
            if not isinstance(j, P.JoinNode) or not j.left_keys:
                continue
            if j.join_type not in ("inner", "semi", "anti", "left"):
                continue
            right = j.right
            if not isinstance(right, RemoteSourceNode):
                continue
            if right.exchange_type not in ("broadcast", "partitioned"):
                continue
            bfrag = by_id.get(right.fragment_id)
            if bfrag is None or not _is_leaf(bfrag.root):
                continue  # the build must be re-runnable from splits
            actual = self.stats.output_rows(right.fragment_id)
            if actual is None:
                continue  # stage still running: nothing to contradict
            # stamp truth, then re-fire the STATIC distribution rule —
            # the adaptive decision IS the planner's own rule on actuals
            prev_stamp = right.runtime_rows
            right.runtime_rows = actual
            try:
                decision = reoptimize_distribution(
                    self.session, j, self.n_workers)
                if (right.exchange_type == "broadcast"
                        and decision == "partitioned"
                        and frag.partitioning == "source"
                        and self._scans_confined_to_probe(frag, j)):
                    build_root = copy.deepcopy(bfrag.root)
                    frags = adapt_broadcast_to_partitioned(
                        frag, j, build_root, self.id_alloc)
                    desc = "broadcast->partitioned"
                elif (right.exchange_type == "partitioned"
                      and frag.partitioning == "hash"
                      and decision == "broadcast"):
                    build_root = copy.deepcopy(bfrag.root)
                    frags = adapt_partitioned_to_broadcast(
                        frag, j, build_root, self.id_alloc)
                    desc = "partitioned->broadcast"
                else:
                    # actuals agree with the scheduled shape: no change —
                    # and the stamp used to decide must not leak into the
                    # plan unless the user opted into reseeding (the flip
                    # itself is always audited via its PlanChange, stamp
                    # included)
                    if not bool(self.props.get("adaptive_capacity_reseed",
                                               False)):
                        right.runtime_rows = prev_stamp
                    continue
            except Exception:
                # a crashed rule must not leak the stamp either: the
                # caller records the error and the plan stays as-was
                right.runtime_rows = prev_stamp
                raise
            change = PlanChange(
                version=self._next_version(), rule="join-distribution",
                fragment=frag.id, description=desc,
                new_fragments=[f.id for f in frags],
                supersedes=[bfrag.id],
                detail={"join": j.id, "buildRows": actual,
                        "limit": self._broadcast_limit()})
            for f in frags:
                by_id[f.id] = f
            return frags, change
        return None

    @staticmethod
    def _scans_confined_to_probe(frag: PlanFragment, j: P.JoinNode) -> bool:
        """The broadcast→partitioned cut moves the probe subtree out of the
        fragment and its task descriptors carry NO splits afterwards — so
        every scan the fragment owns must live inside the probe subtree
        (a scan elsewhere, e.g. under a UNION sibling, would silently read
        nothing)."""
        probe_scans = {n.id for n in P.walk_plan(j.left)
                       if isinstance(n, P.TableScanNode)}
        frag_scans = {n.id for n in P.walk_plan(frag.root)
                      if isinstance(n, P.TableScanNode)}
        return frag_scans == probe_scans

    # -------------------------------------------- rule 3: skew mitigation
    def _maybe_mitigate_skew(
        self, frag: PlanFragment, by_id: Dict[int, PlanFragment],
    ) -> Optional[Tuple[List[PlanFragment], PlanChange]]:
        threshold = int(self.props.get("adaptive_skew_threshold", 8) or 0)
        if frag.partitioning != "hash" or self.n_workers < 2:
            return None
        for j in P.walk_plan(frag.root):
            if not isinstance(j, P.JoinNode) or not j.left_keys:
                continue
            if j.join_type not in ("inner", "semi", "anti", "left"):
                continue
            left, right = j.left, j.right
            if not (isinstance(left, RemoteSourceNode)
                    and isinstance(right, RemoteSourceNode)):
                continue
            if (left.exchange_type != "partitioned"
                    or right.exchange_type != "partitioned"):
                continue
            pfrag = by_id.get(left.fragment_id)
            bfrag = by_id.get(right.fragment_id)
            if pfrag is None or bfrag is None:
                continue
            if not (_is_leaf(pfrag.root) and _is_leaf(bfrag.root)):
                continue  # both producers must be re-runnable
            probe_pr = self.stats.partition_rows(left.fragment_id)
            build_pr = self.stats.partition_rows(right.fragment_id)
            if probe_pr is None or build_pr is None:
                continue  # producers still running / no breakdown yet
            hot = sorted(set(self._hot_partitions(probe_pr, threshold))
                         | set(self._hot_partitions(build_pr, threshold)))
            if not hot or len(hot) >= len(probe_pr):
                continue
            build_pb = self.stats.partition_bytes(right.fragment_id) or []
            replicate_cost = sum(
                build_pb[h] for h in hot if h < len(build_pb)
            ) * self.n_workers
            if replicate_cost > SKEW_REPLICATE_MAX_BYTES:
                continue  # replication would cost more than the skew
            p2 = PlanFragment(
                next(self.id_alloc), "source", copy.deepcopy(pfrag.root),
                output_partition_channels=list(
                    pfrag.output_partition_channels or ()))
            p2.skew_spread_partitions = hot
            b2 = PlanFragment(
                next(self.id_alloc), "source", copy.deepcopy(bfrag.root),
                output_partition_channels=list(
                    bfrag.output_partition_channels or ()))
            b2.skew_replicate_partitions = hot
            left.fragment_id, right.fragment_id = p2.id, b2.id
            change = PlanChange(
                version=self._next_version(), rule="skew-mitigation",
                fragment=frag.id,
                description=f"salted {len(hot)} hot partition(s) "
                            f"{hot}",
                new_fragments=[p2.id, b2.id],
                supersedes=[pfrag.id, bfrag.id],
                detail={"join": j.id, "hotPartitions": hot,
                        "probePartitionRows": list(probe_pr),
                        "buildPartitionRows": list(build_pr)})
            by_id[p2.id], by_id[b2.id] = p2, b2
            return [p2, b2], change
        return None

    @staticmethod
    def _hot_partitions(prows: List[int], threshold: int) -> List[int]:
        """Partitions holding more than ``threshold`` x the mean rows of
        the OTHER partitions (and at least SKEW_MIN_HOT_ROWS — tiny
        stages are noise). Excluding the candidate from the mean keeps the
        ratio meaningful on small clusters: with 2 partitions a fully
        skewed stage is max/mean 2.0 but max/mean-of-others unbounded."""
        total = sum(prows)
        if total <= 0 or len(prows) < 2:
            return []
        return [
            p for p, b in enumerate(prows)
            if b >= SKEW_MIN_HOT_ROWS
            and b > threshold * max((total - b) / (len(prows) - 1), 1.0)
        ]
