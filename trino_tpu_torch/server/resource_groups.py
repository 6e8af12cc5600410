"""Resource groups: hierarchical multi-tenant admission control (a copy of
trino_tpu/server/resource_groups.py).

Reference: ``execution/resourcegroups/InternalResourceGroup.java:75`` +
``FileResourceGroupConfigurationManager`` — a TREE of groups with
concurrency/queue/memory limits, queries mapped to a group by a
first-match SELECTOR chain over (user, source, session property), and
freed slots handed to queued sibling groups by WEIGHTED FAIR scheduling
(deficit counters proportional to group weight, never a global FIFO).

Three layers live here:

- the **config layer** — :class:`GroupSpec` / :class:`SelectorSpec`
  parsed and VALIDATED from a JSON document (``root_groups`` +
  ``selectors``), loadable from the file named by
  ``TRINO_TPU_RESOURCE_GROUPS_CONFIG`` (validation errors fail server
  start, not the first query). Group name segments may be the
  ``${USER}`` template: the node instantiates per user on first match
  (the reference's per-user expansion of ``user.${USER}``).

- the **runtime tree** — :class:`ResourceGroupTree`: per-group bounded
  queues, ``hard_concurrency_limit`` enforced along the whole ancestor
  chain, ``memory_limit_bytes`` checked against the memory ledger's
  live per-query bytes (a group over its memory limit QUEUES new work
  until the ledger shows headroom — never fails it), per-group
  ``queue_timeout_ms`` aging parked queries out as typed
  ``EXCEEDED_QUEUE_TIMEOUT`` failures, and weighted-fair dequeue among
  eligible sibling groups via weight-proportional deficit counters.

- the **cache carve-out registry** — :class:`CacheShares` +
  the current-group context: each group may reserve a ``cache_share``
  fraction of every cache tier's byte budget; the cache eviction loops
  (devcache/cache.py, devcache/hostcache.py, cache/result_cache.py)
  prefer victims from groups OVER their share, so one tenant's scan
  storm cannot evict another tenant's warm state.

``ResourceGroup`` (flat gate) and ``ResourceGroupManager`` (per-user
subgroup manager) remain as the blocking-submit compatibility surface
for callers that inject their own admission gate; a coordinator built
without one runs the tree.

This module imports only the standard library at import time; metric
fan-out imports lazily inside methods.
"""
from __future__ import annotations

import collections
import contextvars
import json
import os
import re
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

ENV_CONFIG = "TRINO_TPU_RESOURCE_GROUPS_CONFIG"

# the typed failure code a query ages out of its group queue with
# (reference: StandardErrorCode.EXCEEDED_QUEUE_TIMEOUT? no — QUERY_QUEUE_FULL
# covers rejection; the queue-timeout failure is EXCEEDED_TIME_LIMIT's
# admission sibling). Clients match on this token in the failure message.
EXCEEDED_QUEUE_TIMEOUT = "EXCEEDED_QUEUE_TIMEOUT"

# the ${USER} template segment of group paths (per-user instantiation)
USER_TEMPLATE = "${USER}"

# every selector field a config may use
SELECTOR_FIELDS = ("user", "source", "session_property", "group")

# every per-group limit knob a config may set
GROUP_KNOBS = ("name", "hard_concurrency_limit", "max_queued",
               "memory_limit_bytes", "weight", "cache_share",
               "queue_timeout_ms", "sub_groups")


# --------------------------------------------------------------- config
class ConfigError(ValueError):
    """Invalid resource-group configuration — raised at parse/validation
    time (server start), never at query time."""


class GroupSpec:
    """One declared group: limits + optional sub-group specs. A spec whose
    name is ``${USER}`` is a TEMPLATE: matching queries instantiate one
    runtime node per user with this spec's limits."""

    def __init__(self, name: str, hard_concurrency_limit: int = 16,
                 max_queued: int = 200,
                 memory_limit_bytes: Optional[int] = None,
                 weight: int = 1, cache_share: Optional[float] = None,
                 queue_timeout_ms: Optional[int] = None,
                 sub_groups: Optional[List["GroupSpec"]] = None):
        self.name = name
        self.hard_concurrency_limit = hard_concurrency_limit
        self.max_queued = max_queued
        self.memory_limit_bytes = memory_limit_bytes
        self.weight = weight
        self.cache_share = cache_share
        self.queue_timeout_ms = queue_timeout_ms
        self.sub_groups = list(sub_groups or [])

    @classmethod
    def from_dict(cls, d: dict, path: str = "") -> "GroupSpec":
        if not isinstance(d, dict):
            raise ConfigError(f"group at '{path or '<root>'}' must be an "
                              f"object, got {type(d).__name__}")
        unknown = set(d) - set(GROUP_KNOBS)
        if unknown:
            raise ConfigError(
                f"group '{path or d.get('name', '?')}': unknown knob(s) "
                f"{sorted(unknown)} (known: {', '.join(GROUP_KNOBS)})")
        name = d.get("name")
        if not name or not isinstance(name, str):
            raise ConfigError(f"group under '{path or '<root>'}' needs a "
                              "non-empty string 'name'")
        if name != USER_TEMPLATE and not re.fullmatch(r"[A-Za-z0-9_\-]+",
                                                      name):
            raise ConfigError(
                f"group name '{name}' must be alphanumeric/_/- or the "
                f"{USER_TEMPLATE} template")
        full = f"{path}.{name}" if path else name

        def _int(knob, default, minimum):
            v = d.get(knob, default)
            if v is None and default is None:
                return None
            if not isinstance(v, int) or isinstance(v, bool) or v < minimum:
                raise ConfigError(f"group '{full}': {knob} must be an "
                                  f"integer >= {minimum}, got {v!r}")
            return v

        share = d.get("cache_share")
        if share is not None and (not isinstance(share, (int, float))
                                  or isinstance(share, bool)
                                  or not 0.0 <= float(share) <= 1.0):
            raise ConfigError(f"group '{full}': cache_share must be a "
                              f"fraction in [0, 1], got {share!r}")
        subs = d.get("sub_groups") or []
        if not isinstance(subs, list):
            raise ConfigError(f"group '{full}': sub_groups must be a list")
        spec = cls(
            name=name,
            hard_concurrency_limit=_int("hard_concurrency_limit", 16, 1),
            max_queued=_int("max_queued", 200, 0),
            memory_limit_bytes=_int("memory_limit_bytes", None, 1),
            weight=_int("weight", 1, 1),
            cache_share=float(share) if share is not None else None,
            queue_timeout_ms=_int("queue_timeout_ms", None, 1),
            sub_groups=[cls.from_dict(s, full) for s in subs],
        )
        seen = set()
        for s in spec.sub_groups:
            if s.name in seen:
                raise ConfigError(f"group '{full}': duplicate sub-group "
                                  f"'{s.name}'")
            seen.add(s.name)
        return spec


class SelectorSpec:
    """One selector of the first-match chain: optional ``user`` /
    ``source`` regexes (full-match) + optional ``session_property``
    ``{"name": ..., "value": ...}`` equality, mapping to a declared
    ``group`` path (segments may be ``${USER}``)."""

    def __init__(self, group: str, user: Optional[str] = None,
                 source: Optional[str] = None,
                 session_property: Optional[dict] = None):
        self.group = group
        self.user_re = re.compile(user) if user else None
        self.source_re = re.compile(source) if source else None
        self.session_property = session_property

    @classmethod
    def from_dict(cls, d: dict, index: int) -> "SelectorSpec":
        if not isinstance(d, dict):
            raise ConfigError(f"selector #{index} must be an object")
        unknown = set(d) - set(SELECTOR_FIELDS)
        if unknown:
            raise ConfigError(
                f"selector #{index}: unknown field(s) {sorted(unknown)} "
                f"(known: {', '.join(SELECTOR_FIELDS)})")
        group = d.get("group")
        if not group or not isinstance(group, str):
            raise ConfigError(f"selector #{index} needs a 'group' path")
        for field in ("user", "source"):
            v = d.get(field)
            if v is not None:
                if not isinstance(v, str):
                    raise ConfigError(f"selector #{index}: {field} must "
                                      "be a regex string")
                try:
                    re.compile(v)
                except re.error as e:
                    raise ConfigError(
                        f"selector #{index}: bad {field} regex: {e}")
        sp = d.get("session_property")
        if sp is not None and (not isinstance(sp, dict)
                               or not isinstance(sp.get("name"), str)
                               or "value" not in sp):
            raise ConfigError(
                f"selector #{index}: session_property must be "
                '{"name": <property>, "value": <expected>}')
        return cls(group=group, user=d.get("user"), source=d.get("source"),
                   session_property=sp)

    def matches(self, user: str, source: str, properties: dict) -> bool:
        if self.user_re is not None and not self.user_re.fullmatch(user):
            return False
        if self.source_re is not None and not self.source_re.fullmatch(
                source or ""):
            return False
        if self.session_property is not None:
            got = properties.get(self.session_property["name"])
            if got is None or str(got) != str(
                    self.session_property["value"]):
                return False
        return True


# the zero-config default: one root group, everyone maps to it — the
# exact admission behavior of the flat pre-tree gate
DEFAULT_CONFIG = {
    "root_groups": [
        {"name": "global", "hard_concurrency_limit": 16,
         "max_queued": 200},
    ],
    "selectors": [{"group": "global"}],
}


def parse_config(doc: dict) -> Tuple[List[GroupSpec], List[SelectorSpec]]:
    """Validated (root specs, selector chain) from a config document.
    Every selector's group path must resolve through declared specs
    (template segments match ``${USER}`` specs)."""
    if not isinstance(doc, dict):
        raise ConfigError("resource-group config must be a JSON object")
    unknown = set(doc) - {"root_groups", "selectors"}
    if unknown:
        raise ConfigError(f"unknown top-level key(s) {sorted(unknown)} "
                          "(known: root_groups, selectors)")
    roots_doc = doc.get("root_groups")
    if not isinstance(roots_doc, list) or not roots_doc:
        raise ConfigError("config needs a non-empty root_groups list")
    roots = [GroupSpec.from_dict(g) for g in roots_doc]
    seen = set()
    for r in roots:
        if r.name == USER_TEMPLATE:
            raise ConfigError("a root group cannot be the ${USER} template")
        if r.name in seen:
            raise ConfigError(f"duplicate root group '{r.name}'")
        seen.add(r.name)
    selectors_doc = doc.get("selectors")
    if not isinstance(selectors_doc, list) or not selectors_doc:
        raise ConfigError("config needs a non-empty selectors list")
    selectors = [SelectorSpec.from_dict(s, i)
                 for i, s in enumerate(selectors_doc)]
    for i, sel in enumerate(selectors):
        if _spec_for_path(roots, sel.group.split(".")) is None:
            raise ConfigError(
                f"selector #{i}: group '{sel.group}' does not match any "
                "declared group path")
    total_share = _sum_shares(roots)
    if total_share > 1.0 + 1e-9:
        raise ConfigError(
            f"cache_share fractions sum to {total_share:g} > 1.0")
    return roots, selectors


def _sum_shares(specs: List[GroupSpec]) -> float:
    total = 0.0
    for s in specs:
        if s.cache_share:
            total += s.cache_share
        total += _sum_shares(s.sub_groups)
    return total


def _spec_for_path(roots: List[GroupSpec],
                   segments: List[str]) -> Optional[GroupSpec]:
    level = roots
    spec = None
    for seg in segments:
        spec = None
        for cand in level:
            if cand.name == seg or cand.name == USER_TEMPLATE:
                spec = cand
                break
        if spec is None:
            return None
        level = spec.sub_groups
    return spec


def load_config_file(path: str) -> Tuple[List[GroupSpec],
                                         List[SelectorSpec]]:
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except OSError as e:
        raise ConfigError(f"cannot read resource-group config {path}: {e}")
    except json.JSONDecodeError as e:
        raise ConfigError(f"resource-group config {path} is not valid "
                          f"JSON: {e}")
    return parse_config(doc)


def config_from_env() -> Tuple[List[GroupSpec], List[SelectorSpec]]:
    """The server-start entry point: the file named by
    ``TRINO_TPU_RESOURCE_GROUPS_CONFIG``, else the zero-config default."""
    path = os.environ.get(ENV_CONFIG)
    if path:
        return load_config_file(path)
    return parse_config(DEFAULT_CONFIG)


# ---------------------------------------------------- cache carve-outs
# the current query's resource group, set by the executor lane around
# execution (and by the dispatch thread around an index serve): cache
# tiers read it at admission time to tag entries with their owner group
_CURRENT_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "trino_tpu_resource_group", default=None)


def set_current_group(name: Optional[str]):
    """Bind the calling context's resource group; returns the reset
    token (pass to :func:`reset_current_group`)."""
    return _CURRENT_GROUP.set(name)


def reset_current_group(token) -> None:
    _CURRENT_GROUP.reset(token)


def current_group() -> Optional[str]:
    return _CURRENT_GROUP.get()


class CacheShares:
    """Per-group cache carve-out fractions, one registry per process
    (every cache tier consults the same shares). A group's share is the
    fraction of a tier's byte budget it is entitled to KEEP under
    pressure: the eviction loops prefer victims from groups holding
    more than ``share × max_bytes``; groups without a configured share
    split the unreserved remainder."""

    def __init__(self):
        self._lock = threading.Lock()
        self._shares: Dict[str, float] = {}
        self._default = 1.0

    def configure(self, shares: Dict[str, float]) -> None:
        with self._lock:
            self._shares = dict(shares)
            reserved = sum(self._shares.values())
            self._default = max(0.05, 1.0 - reserved)

    def share_for(self, group: Optional[str]) -> float:
        with self._lock:
            if group is not None and group in self._shares:
                return self._shares[group]
            return self._default

    def over_share(self, group: Optional[str], group_bytes: int,
                   max_bytes: int) -> bool:
        """Is ``group`` holding more than its carve-out of a tier whose
        budget is ``max_bytes``? Ungrouped bytes count against the
        unreserved remainder."""
        return group_bytes > self.share_for(group) * max_bytes

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._shares)


# the process-wide registry (mirrors DEVICE_CACHE / MEMORY_LEDGER):
# ResourceGroupTree.configure_cache_shares() fills it at server start
CACHE_SHARES = CacheShares()


# ----------------------------------------------------------- runtime tree
class _GroupNode:
    """One runtime group: live counters + the per-group queue (leaf
    groups queue queries; intermediate groups only aggregate). All
    mutation happens under the owning tree's lock."""

    __slots__ = ("name", "segment", "spec", "parent", "children", "queue",
                 "running", "served", "deficit", "query_ids",
                 "dequeued", "timed_out")

    def __init__(self, name: str, segment: str, spec: GroupSpec,
                 parent: Optional["_GroupNode"]):
        self.name = name          # full dotted path
        self.segment = segment    # last path segment (template-expanded)
        self.spec = spec
        self.parent = parent
        self.children: "collections.OrderedDict[str, _GroupNode]" = (
            collections.OrderedDict())
        self.queue: Deque[dict] = collections.deque()
        self.running = 0          # queries running in this subtree
        self.served = 0           # serving-index hits (concurrency-free)
        self.deficit = 0.0        # weighted-fair deficit counter
        self.query_ids: set = set()   # running query ids in this subtree
        self.dequeued = 0
        self.timed_out = 0

    def chain(self) -> List["_GroupNode"]:
        nodes = []
        node = self
        while node is not None:
            nodes.append(node)
            node = node.parent
        return nodes


class ResourceGroupTree:
    """The hierarchical admission runtime the dispatcher drains.

    The dispatch thread classifies (``select``) and parks
    (``enqueue``); executor lanes pull (``dequeue``) — a weighted-fair
    pick that walks the tree top-down choosing among ELIGIBLE children
    by deficit counter (each candidate's deficit grows by its weight
    each round; the winner pays the round's total weight), so siblings
    with weights 3:1 drain 3:1 under sustained load instead of global
    FIFO order. Eligibility at every level = concurrency headroom AND
    memory headroom (live per-query bytes from the memory probe under
    ``memory_limit_bytes``) along the whole ancestor chain.
    """

    def __init__(self, roots: Optional[List[GroupSpec]] = None,
                 selectors: Optional[List[SelectorSpec]] = None):
        if roots is None or selectors is None:
            roots, selectors = parse_config(DEFAULT_CONFIG)
        self._specs = roots
        self._selectors = selectors
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._nodes: Dict[str, _GroupNode] = {}
        self._roots: List[_GroupNode] = [
            self._instantiate(spec, None, spec.name) for spec in roots]
        self._query_groups: Dict[str, _GroupNode] = {}
        # live per-query bytes source (the memory ledger / cluster memory
        # manager): () -> {query_id: bytes}
        self._memory_probe: Optional[Callable[[], Dict[str, int]]] = None
        # recent dequeue timestamps — the drain-rate estimator behind
        # honest Retry-After values instead of a constant
        self._drains: Deque[float] = collections.deque(maxlen=64)
        self._closed = False
        self.configure_cache_shares()

    # ------------------------------------------------------------ build
    def _instantiate(self, spec: GroupSpec, parent: Optional[_GroupNode],
                     segment: str) -> _GroupNode:
        name = (f"{parent.name}.{segment}" if parent else segment)
        node = _GroupNode(name, segment, spec, parent)
        self._nodes[name] = node
        if parent is not None:
            parent.children[segment] = node
        for sub in spec.sub_groups:
            if sub.name != USER_TEMPLATE:
                self._instantiate(sub, node, sub.name)
        return node

    def configure_cache_shares(self) -> None:
        """Publish every configured ``cache_share`` (template shares
        publish lazily as their per-user nodes instantiate)."""
        shares = {name: node.spec.cache_share
                  for name, node in self._nodes.items()
                  if node.spec.cache_share}
        CACHE_SHARES.configure(shares)

    def set_memory_probe(
            self, probe: Callable[[], Dict[str, int]]) -> None:
        self._memory_probe = probe

    # ---------------------------------------------------------- selection
    def select(self, user: str = "anonymous", source: str = "",
               session_properties: Optional[dict] = None) -> str:
        """First-match selector chain -> full group path, instantiating
        ``${USER}`` template nodes on first use. Unmatched queries fall
        into the first root group (admission must never be undefined)."""
        props = session_properties or {}
        target = None
        for sel in self._selectors:
            if sel.matches(user, source, props):
                target = sel.group
                break
        if target is None:
            target = self._specs[0].name
        path = target.replace(USER_TEMPLATE, _safe_segment(user))
        template_path = target
        with self._lock:
            node = self._nodes.get(path)
            if node is None:
                node = self._materialize(template_path, path)
        return node.name

    def _materialize(self, template_path: str, path: str) -> _GroupNode:
        """Create the runtime node(s) for a template-expanded path
        (lock held)."""
        t_segments = template_path.split(".")
        segments = path.split(".")
        node = None
        prefix = ""
        new_share = False
        for t_seg, seg in zip(t_segments, segments):
            prefix = f"{prefix}.{seg}" if prefix else seg
            existing = self._nodes.get(prefix)
            if existing is None:
                parent_specs = (self._specs if node is None
                                else node.spec.sub_groups)
                spec = None
                for cand in parent_specs:
                    if cand.name == t_seg:
                        spec = cand
                        break
                if spec is None:
                    raise KeyError(
                        f"resource group path '{path}' does not resolve "
                        f"at '{prefix}'")
                existing = _GroupNode(prefix, seg, spec, node)
                self._nodes[prefix] = existing
                if node is not None:
                    node.children[seg] = existing
                else:
                    self._roots.append(existing)
                if spec.cache_share:
                    new_share = True
            node = existing
        if new_share:
            self.configure_cache_shares()
        return node

    # ---------------------------------------------------------- admission
    def queue_state(self, group: str) -> Tuple[int, int]:
        """(queued, max_queued) for the group — the precheck read."""
        with self._lock:
            node = self._nodes.get(group)
            if node is None:
                return (0, 0)
            return (len(node.queue), node.spec.max_queued)

    def enqueue(self, group: str, query_id: str, item,
                now: Optional[float] = None) -> int:
        """Park one query in its group queue; returns the number queued
        AHEAD of it. Raises ``IndexError`` (typed by the dispatch
        adapter) when the group queue is at ``max_queued``."""
        now = time.time() if now is None else now
        with self._lock:
            node = self._nodes[group]
            ahead = len(node.queue)
            if ahead >= node.spec.max_queued:
                raise IndexError(ahead)
            node.queue.append({"query_id": query_id, "item": item,
                               "enqueued_at": now})
            self._cond.notify()
        self._set_depth_gauge(group)
        return ahead

    def dequeue(self, timeout: float = 0.5):
        """The weighted-fair drain step one executor lane runs: returns
        ``("run", item, group, waited_s)`` for the next admitted query,
        ``("aged", item, group, waited_s)`` for a query parked past its
        group's ``queue_timeout_ms`` (the caller fails it typed), or
        ``None`` on timeout/close."""
        deadline = time.monotonic() + timeout
        result = None
        gauges = None
        with self._lock:
            while True:
                aged = self._sweep_aged_locked()
                if aged is not None:
                    entry, node, waited = aged
                    node.timed_out += 1
                    result = ("aged", entry["item"], node.name, waited)
                    gauges = (node.name, len(node.queue), node.running)
                    break
                picked = self._pick_locked()
                if picked is not None:
                    entry, node, waited = picked
                    node.dequeued += 1
                    for anc in node.chain():
                        anc.running += 1
                        anc.query_ids.add(entry["query_id"])
                    self._query_groups[entry["query_id"]] = node
                    self._drains.append(time.time())
                    result = ("run", entry["item"], node.name, waited)
                    gauges = (node.name, len(node.queue), node.running)
                    # cascade: finish()/enqueue() wake ONE lane; if more
                    # work is still parked, pass the baton so a second
                    # admittable query (memory freed, sibling slot) is
                    # picked without waiting out the take timeout
                    if any(n.queue for n in self._nodes.values()):
                        self._cond.notify()
                    break
                if self._closed:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
        # metric fan-out OUTSIDE the lock (lock-discipline gate)
        self._publish_gauges(*gauges)
        try:
            from trino_tpu_torch.obs import metrics as M

            M.RESOURCE_GROUP_QUEUE_SECONDS.observe(result[3], result[2])
        except Exception:  # noqa: BLE001 — accounting never fails work
            pass
        return result

    def _sweep_aged_locked(self):
        now = time.time()
        for node in self._nodes.values():
            tmo = node.spec.queue_timeout_ms
            if tmo is None or not node.queue:
                continue
            head = node.queue[0]
            waited = now - head["enqueued_at"]
            if waited * 1000.0 >= tmo:
                node.queue.popleft()
                return (head, node, waited)
        return None

    def _pick_locked(self):
        """One weighted-fair pick: walk from the root level down,
        choosing among eligible siblings by deficit counter."""
        level = self._roots
        while True:
            candidates = [n for n in level if self._eligible_locked(n)]
            if not candidates:
                return None
            if len(candidates) == 1:
                chosen = candidates[0]
            else:
                for c in candidates:
                    c.deficit += c.spec.weight
                chosen = max(candidates, key=lambda c: (c.deficit, c.name))
                chosen.deficit -= sum(c.spec.weight for c in candidates)
            if chosen.queue:
                entry = chosen.queue.popleft()
                return (entry, chosen,
                        time.time() - entry["enqueued_at"])
            level = list(chosen.children.values())

    def _eligible_locked(self, node: _GroupNode) -> bool:
        """Can this subtree start one more query right now? Concurrency
        and memory headroom at this node, and EITHER a queued query here
        or an eligible child — fully recursive, so a pick never descends
        into a subtree that cannot admit (a group over its
        ``memory_limit_bytes`` queues; it never fails the query)."""
        if node.running >= node.spec.hard_concurrency_limit:
            return False
        if node.spec.memory_limit_bytes is not None:
            if self._subtree_bytes_locked(node) >= \
                    node.spec.memory_limit_bytes:
                return False
        if node.queue:
            return True
        return any(self._eligible_locked(c)
                   for c in node.children.values())

    def _subtree_bytes_locked(self, node: _GroupNode) -> int:
        probe = self._memory_probe
        if probe is None or not node.query_ids:
            return 0
        try:
            by_query = probe()
        except Exception:  # noqa: BLE001 — a broken probe never wedges
            return 0      # admission (memory gate degrades open)
        return sum(int(by_query.get(qid, 0)) for qid in node.query_ids)

    def finish(self, query_id: str) -> None:
        """Terminal hook: release the query's slot along its group chain
        and wake the drain loop (a freed slot may admit a sibling)."""
        with self._lock:
            node = self._query_groups.pop(query_id, None)
            if node is None:
                return
            for anc in node.chain():
                anc.running = max(0, anc.running - 1)
                anc.query_ids.discard(query_id)
            # ONE waiter: a freed slot admits at most one parked query
            # directly; dequeue cascades a further notify while queued
            # work remains. notify_all() here woke EVERY idle lane per
            # completion — measurably slower serving on small machines
            # (8 wakeups + tree scans per query for nothing).
            self._cond.notify()
        self._set_gauges(node)

    def note_served(self, group: str) -> None:
        """A serving-index hit for this group: concurrency-free, but it
        must be auditable (the fairness story covers cached repeats)."""
        with self._lock:
            node = self._nodes.get(group)
            if node is None:
                return
            for anc in node.chain():
                anc.served += 1
        try:
            from trino_tpu_torch.obs import metrics as M

            M.RESOURCE_GROUP_SERVED.inc(1, group)
        except Exception:  # noqa: BLE001 — accounting never fails serving
            pass

    # ------------------------------------------------------- retry-after
    def drain_rate(self) -> float:
        """Recent queue drain rate in queries/second (0.0 = no recent
        drains observed)."""
        with self._lock:
            drains = list(self._drains)
        if len(drains) < 2:
            return 0.0
        window = drains[-1] - drains[0]
        if window <= 0:
            return 0.0
        return (len(drains) - 1) / window

    def retry_after_s(self, queued_ahead: int,
                      fallback: float = 1.0) -> float:
        """Honest Retry-After: the time the drain rate needs to clear
        the queue ahead (clamped to [0.1, 30]); the fallback covers a
        queue that has never drained."""
        rate = self.drain_rate()
        if rate <= 0.0:
            return fallback
        return min(30.0, max(0.1, (queued_ahead + 1) / rate))

    # ------------------------------------------------------------- reads
    def total_queued(self) -> int:
        with self._lock:
            return sum(len(n.queue) for n in self._nodes.values())

    def group_of(self, query_id: str) -> Optional[str]:
        with self._lock:
            node = self._query_groups.get(query_id)
            return node.name if node is not None else None

    def state_of(self, node: _GroupNode) -> str:
        """can-run | full | blocked-memory (lock held by callers that
        iterate; reads are plain attribute loads)."""
        if node.running >= node.spec.hard_concurrency_limit:
            return "full"
        if node.spec.memory_limit_bytes is not None and \
                self._subtree_bytes_locked(node) >= \
                node.spec.memory_limit_bytes:
            return "blocked-memory"
        return "can-run"

    def table_rows(self) -> List[tuple]:
        """``system.runtime.resource_groups`` rows, column order matched
        to connector/system/schemas.py."""
        with self._lock:
            rows = []
            for name in sorted(self._nodes):
                n = self._nodes[name]
                rows.append((
                    n.name, self.state_of(n), len(n.queue), n.running,
                    n.served, n.spec.hard_concurrency_limit,
                    n.spec.max_queued, n.spec.memory_limit_bytes,
                    self._subtree_bytes_locked(n), n.spec.weight,
                    n.spec.cache_share, n.spec.queue_timeout_ms,
                ))
        return rows

    def info(self) -> dict:
        """The flat-gate-compatible rollup (the /ui header), plus the
        per-group breakdown."""
        with self._lock:
            root = self._roots[0] if self._roots else None
            return {
                "name": root.name if root else "global",
                "running": sum(r.running for r in self._roots),
                "queued": sum(len(n.queue)
                              for n in self._nodes.values()),
                "hardConcurrencyLimit": (
                    root.spec.hard_concurrency_limit if root else 0),
                "groups": {
                    n.name: {"running": n.running,
                             "queued": len(n.queue),
                             "served": n.served,
                             "weight": n.spec.weight,
                             "state": self.state_of(n)}
                    for n in self._nodes.values()
                },
            }

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._cond.notify_all()

    # ----------------------------------------------------------- metrics
    def _set_depth_gauge(self, group: str) -> None:
        with self._lock:
            node = self._nodes.get(group)
            depth = len(node.queue) if node is not None else 0
            running = node.running if node is not None else 0
        self._publish_gauges(group, depth, running)

    def _set_gauges(self, node: _GroupNode) -> None:
        with self._lock:
            depth, running = len(node.queue), node.running
        self._publish_gauges(node.name, depth, running)

    def _publish_gauges(self, group: str, depth: int,
                        running: int) -> None:
        try:
            from trino_tpu_torch.obs import metrics as M

            M.RESOURCE_GROUP_QUEUED.set(depth, group)
            M.RESOURCE_GROUP_RUNNING.set(running, group)
        except Exception:  # noqa: BLE001 — accounting never fails work
            pass


def _safe_segment(user: str) -> str:
    """A user name as a group path segment (dots would split the path)."""
    return re.sub(r"[^A-Za-z0-9_\-]", "_", user or "anonymous")


# ------------------------------------------------- legacy (flat) gates
class ResourceGroup:
    """Bounded-concurrency admission gate with a FIFO queue — the flat
    blocking-submit compatibility surface (callers that inject their own
    gate into CoordinatorServer keep this contract; the default
    coordinator runs :class:`ResourceGroupTree`)."""

    def __init__(self, name: str = "global", hard_concurrency_limit: int = 16,
                 max_queued: int = 200):
        self.name = name
        self.hard_concurrency_limit = hard_concurrency_limit
        self.max_queued = max_queued
        self._lock = threading.Lock()
        self._running = 0
        self._queue: Deque[threading.Event] = collections.deque()

    def submit(self, timeout: Optional[float] = None,
               user: str = "anonymous") -> bool:
        """Block until admitted (True) or rejected/timed out (False).
        Rejection happens immediately when the queue is full (the
        reference's QUERY_QUEUE_FULL error). ``user`` is ignored by the
        flat group (one queue for everyone); ResourceGroupManager routes
        it to the per-user subgroup."""
        with self._lock:
            if self._running < self.hard_concurrency_limit and not self._queue:
                self._running += 1
                return True
            if len(self._queue) >= self.max_queued:
                return False
            gate = threading.Event()
            self._queue.append(gate)
        if not gate.wait(timeout):
            with self._lock:
                try:
                    self._queue.remove(gate)
                except ValueError:
                    return True  # raced with finish(): already admitted
            return False
        return True

    def finish(self, user: str = "anonymous") -> None:
        with self._lock:
            if self._queue:
                gate = self._queue.popleft()
                gate.set()  # hand the slot over; _running unchanged
            else:
                self._running = max(0, self._running - 1)

    def info(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "running": self._running,
                "queued": len(self._queue),
                "hardConcurrencyLimit": self.hard_concurrency_limit,
            }


class ResourceGroupManager:
    """Per-user subgroup tree under one root: global.user:<name>.

    Admission needs a slot in BOTH the user's subgroup and the root; when a
    query finishes, the freed root slot goes to the queued subgroup with
    the smallest running/weight ratio (weighted fair scheduling,
    reference: InternalResourceGroup.internalStartNext + the weighted
    scheduling policy). Subgroups are created on first use from a template
    (the ``user.${USER}`` expansion of resource-group config files).

    Compatibility surface like :class:`ResourceGroup`; the default
    coordinator's selector-driven tree is :class:`ResourceGroupTree`."""

    def __init__(self, root_concurrency_limit: int = 16,
                 per_user_concurrency_limit: int = 8,
                 per_user_max_queued: int = 100,
                 user_weights: Optional[Dict[str, int]] = None):
        self.root_limit = root_concurrency_limit
        self.user_limit = per_user_concurrency_limit
        self.user_max_queued = per_user_max_queued
        self.user_weights = dict(user_weights or {})
        self._lock = threading.Lock()
        self._root_running = 0
        # user -> state
        self._groups: Dict[str, dict] = {}

    # compatibility with the flat ResourceGroup surface (coordinator calls
    # submit()/finish() without a user for internal work)
    def submit(self, timeout: Optional[float] = None, user: str = "anonymous") -> bool:
        g = self._group(user)
        with self._lock:
            if self._can_start(g):
                self._start(g)
                return True
            if len(g["queue"]) >= self.user_max_queued:
                return False
            gate = threading.Event()
            g["queue"].append(gate)
        if not gate.wait(timeout):
            with self._lock:
                try:
                    g["queue"].remove(gate)
                except ValueError:
                    return True  # raced with a dispatch: already admitted
            return False
        return True

    def finish(self, user: str = "anonymous") -> None:
        with self._lock:
            g = self._groups.get(user)
            if g is not None:
                g["running"] = max(0, g["running"] - 1)
            self._root_running = max(0, self._root_running - 1)
            self._dispatch_next()

    def info(self) -> dict:
        with self._lock:
            return {
                "name": "global",
                "running": self._root_running,
                "queued": sum(len(g["queue"]) for g in self._groups.values()),
                "hardConcurrencyLimit": self.root_limit,
                "subgroups": {
                    u: {"running": g["running"], "queued": len(g["queue"]),
                        "weight": g["weight"]}
                    for u, g in sorted(self._groups.items())
                },
            }

    # ----------------------------------------------------------- internals
    def _group(self, user: str) -> dict:
        with self._lock:
            g = self._groups.get(user)
            if g is None:
                g = {"running": 0, "queue": collections.deque(),
                     "weight": max(1, int(self.user_weights.get(user, 1)))}
                self._groups[user] = g
            return g

    def _can_start(self, g: dict) -> bool:
        return (g["running"] < self.user_limit
                and self._root_running < self.root_limit)

    def _start(self, g: dict) -> None:
        g["running"] += 1
        self._root_running += 1

    def _dispatch_next(self) -> None:
        """Weighted fair pick among queued subgroups with capacity: the
        eligible group with the smallest running/weight starts next."""
        while self._root_running < self.root_limit:
            eligible = [
                g for g in self._groups.values()
                if g["queue"] and g["running"] < self.user_limit
            ]
            if not eligible:
                return
            g = min(eligible, key=lambda g: g["running"] / g["weight"])
            gate = g["queue"].popleft()
            self._start(g)
            gate.set()
