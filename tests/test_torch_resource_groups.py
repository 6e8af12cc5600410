"""The port's resource groups (trino_tpu_torch/server/resource_groups.py)
against the JAX package's (trino_tpu/server/resource_groups.py), on the
CPU.

The cases of the reference's tests/test_resource_groups.py, each run
through both packages: the config layer (the same documents through both
``parse_config``: the same specs, the same errors), file and environment
loading, first-match selectors and ``${USER}`` templates, two limit-1
tenants, the 3:1 weighted drain under a seeded storm (the drain orders
equal), a group over its memory limit queuing, queue aging, ``served``
rollups, the cache carve-out on each package's device cache, a bad config
failing the server's start, the coordinator's group wiring (per-group
429 payloads, the group in the query stats, serving-index hits counted
as served) and a queued query aging out typed on a coordinator, with the
port's query history recording it.

Left out by name: of ``test_coordinator_group_wiring_end_to_end`` the
``system.runtime.resource_groups`` and ``system.runtime.queries`` queries,
and of ``test_queue_aging_fails_typed_with_ledger_and_history`` the phase
ledger and the ``system.runtime.queries`` query (the system catalog and
the timeline are not ported): the tree's ``table_rows`` and the port's
``CoordinatorServer.history`` are read instead.
"""
import json
import random
import time
import types

import pytest

import trino_tpu  # noqa: F401  (turns on JAX x64 first)

PROPS = {"catalog": "tpch", "schema": "tiny", "short_query_fast_path": "true"}


def _package(name):
    import importlib

    root = "trino_tpu" if name == "jax" else "trino_tpu_torch"

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    kw = {"device": "cpu"} if name == "torch" else {}
    return types.SimpleNamespace(
        name=name, kw=kw, M=mod("obs.metrics"), rg=mod("server.resource_groups"),
        dispatch=mod("server.dispatch"), coordinator=mod("server.coordinator"),
        cache=mod("devcache.cache"), result_cache=mod("cache.result_cache"),
        wire=mod("server.wire"))


JAX = _package("jax")
TORCH = _package("torch")
PACKAGES = pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])


def both(case, *args):
    want = case(JAX, *args)
    got = case(TORCH, *args)
    assert got == want, f"{case.__name__}: the port's {got} != the reference's {want}"
    return got


def _tree(pkg, cfg):
    roots, selectors = pkg.rg.parse_config(cfg)
    return pkg.rg.ResourceGroupTree(roots, selectors)


def _wait(q, timeout=30.0):
    state = q.state.wait_for_terminal(timeout)
    assert state == "FINISHED", (state, q.failure)
    return q


def _spec(s):
    return (s.name, s.hard_concurrency_limit, s.max_queued, s.memory_limit_bytes, s.weight,
            s.cache_share, s.queue_timeout_ms, [_spec(c) for c in s.sub_groups])


# ------------------------------------------------------------ config layer
BAD_DOCS = [
    ({"root_groups": [], "selectors": [{"group": "g"}]}, "non-empty root_groups"),
    ({"root_groups": [{"name": "g", "max_threads": 2}], "selectors": [{"group": "g"}]},
     "unknown knob"),
    ({"root_groups": [{"name": "g"}], "selectors": [{"group": "g", "query_type": "adhoc"}]},
     "unknown field"),
    ({"root_groups": [{"name": "g"}], "selectors": [{"group": "nope"}]}, "does not match"),
    ({"root_groups": [{"name": "g", "hard_concurrency_limit": 0}],
      "selectors": [{"group": "g"}]}, "hard_concurrency_limit"),
    ({"root_groups": [{"name": "${USER}"}], "selectors": [{"group": "${USER}"}]},
     "root group cannot"),
    ({"root_groups": [{"name": "a", "cache_share": 0.7}, {"name": "b", "cache_share": 0.6}],
      "selectors": [{"group": "a"}]}, "cache_share"),
    ({"root_groups": [{"name": "g"}], "selectors": [{"group": "g"}], "extra": 1},
     "unknown top-level"),
    ({"root_groups": [{"name": "g", "sub_groups": [{"name": "a"}, {"name": "a"}]}],
      "selectors": [{"group": "g"}]}, "duplicate sub-group"),
    ({"root_groups": [{"name": "g"}], "selectors": [{"group": "g", "user": "("}]},
     "bad user regex"),
]


def _config_layer(pkg):
    ok = {"root_groups": [{"name": "global", "sub_groups": [
        {"name": "a", "weight": 3, "cache_share": 0.25, "queue_timeout_ms": 10},
        {"name": "${USER}", "memory_limit_bytes": 1 << 20}]}],
        "selectors": [{"user": "x.*", "group": "global.a"}, {"group": "global.${USER}"}]}
    roots, selectors = pkg.rg.parse_config(ok)
    out = [[_spec(r) for r in roots], [s.group for s in selectors]]
    for doc, needle in BAD_DOCS:
        with pytest.raises(pkg.rg.ConfigError) as ei:
            pkg.rg.parse_config(doc)
        assert needle in str(ei.value), str(ei.value)
        out.append(str(ei.value))
    return out


def test_config_validation_is_loud():
    both(_config_layer)


def _file_and_env(pkg, tmp_path, monkeypatch):
    doc = {"root_groups": [{"name": "global", "hard_concurrency_limit": 3}],
           "selectors": [{"group": "global"}]}
    path = tmp_path / f"groups-{pkg.name}.json"
    path.write_text(json.dumps(doc))
    roots, _sel = pkg.rg.load_config_file(str(path))
    out = [roots[0].hard_concurrency_limit]
    monkeypatch.setenv(pkg.rg.ENV_CONFIG, str(path))
    roots, _sel = pkg.rg.config_from_env()
    out.append(roots[0].hard_concurrency_limit)
    monkeypatch.delenv(pkg.rg.ENV_CONFIG)
    roots, _sel = pkg.rg.config_from_env()
    out.append(_spec(roots[0]))
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    with pytest.raises(pkg.rg.ConfigError):
        pkg.rg.load_config_file(str(bad))
    return out


def test_config_file_and_env_loading(tmp_path, monkeypatch):
    got = both(_file_and_env, tmp_path, monkeypatch)
    assert got[:2] == [3, 3] and got[2][0] == "global"


def _selectors(pkg):
    tree = _tree(pkg, {
        "root_groups": [{
            "name": "global",
            "sub_groups": [
                {"name": "adhoc",
                 "sub_groups": [{"name": "${USER}", "hard_concurrency_limit": 2}]},
                {"name": "etl"},
                {"name": "props"}]}],
        "selectors": [
            {"source": "etl-.*", "group": "global.etl"},
            {"session_property": {"name": "resource_group", "value": "props"},
             "group": "global.props"},
            {"group": "global.adhoc.${USER}"}]})
    picks = [tree.select("bob", "etl-nightly", {}), tree.select("carol", "", {"resource_group":
                                                                            "props"}),
             tree.select("alice", "", {}), tree.select("bob", "", {}),
             tree.select("d.ave", "", {})]
    return picks, [r[0] for r in tree.table_rows()]


def test_selectors_first_match_and_user_template():
    picks, names = both(_selectors)
    assert picks == ["global.etl", "global.props", "global.adhoc.alice", "global.adhoc.bob",
                     "global.adhoc.d_ave"]
    assert "global.adhoc.alice" in names and "global.adhoc.bob" in names


# --------------------------------------------------- acceptance: isolation
def _two_tenants(pkg):
    tree = _tree(pkg, {
        "root_groups": [{
            "name": "global", "hard_concurrency_limit": 16,
            "sub_groups": [{"name": "a", "hard_concurrency_limit": 1},
                           {"name": "b", "hard_concurrency_limit": 1}]}],
        "selectors": [{"group": "global"}]})
    tree.enqueue("global.a", "a1", "a1")
    tree.enqueue("global.a", "a2", "a2")
    tree.enqueue("global.b", "b1", "b1")
    picked = {tree.dequeue(0.5)[1], tree.dequeue(0.5)[1]}
    none = tree.dequeue(0.05)
    state = tree.queue_state("global.a")
    rows = {r[0]: r[:4] for r in tree.table_rows()}
    tree.finish("a1")
    kind, item, group, _waited = tree.dequeue(0.5)
    return sorted(picked), none, state, rows, (kind, item, group)


def test_two_tenants_limit1_a_queues_while_b_admits():
    picked, none, state, rows, after = both(_two_tenants)
    assert picked == ["a1", "b1"] and none is None and state == (1, 200)
    assert rows["global.a"][1] == "full" and rows["global.a"][2] == 1
    assert rows["global"][3] == 2  # running is a subtree rollup
    assert after == ("run", "a2", "global.a")


def _weighted_storm(pkg, seed):
    tree = _tree(pkg, {
        "root_groups": [{
            "name": "global", "hard_concurrency_limit": 100,
            "sub_groups": [
                {"name": "batch", "hard_concurrency_limit": 100, "weight": 3},
                {"name": "inter", "hard_concurrency_limit": 100, "weight": 1}]}],
        "selectors": [{"group": "global"}]})
    rng = random.Random(seed)
    order = ["batch"] * 20 + ["inter"] * 20
    rng.shuffle(order)
    for i, g in enumerate(order):
        tree.enqueue(f"global.{g}", f"{g}{i}", (g, i))
    drained = [tree.dequeue(0.5) for _ in range(40)]
    assert all(d is not None and d[0] == "run" for d in drained)
    rows = {r[0]: r[9] for r in tree.table_rows()}
    return [d[1] for d in drained], tree.total_queued(), rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_fair_drain_3_to_1_under_storm(seed):
    """The same seeded storm through both trees drains in the same order,
    about three batch queries to one interactive."""
    drained, queued, weights = both(_weighted_storm, seed)
    first20 = [g for g, _ in drained[:20]]
    assert 14 <= first20.count("batch") <= 16, first20
    assert queued == 0  # work-conserving: nothing lost
    assert weights["global.batch"] == 3 and weights["global.inter"] == 1


def _memory_limit(pkg):
    tree = _tree(pkg, {
        "root_groups": [{
            "name": "global", "hard_concurrency_limit": 16,
            "sub_groups": [{"name": "mem", "hard_concurrency_limit": 8,
                            "memory_limit_bytes": 1000}]}],
        "selectors": [{"group": "global"}]})
    live = {}
    tree.set_memory_probe(lambda: live)
    tree.enqueue("global.mem", "m1", "m1")
    out = [tree.dequeue(0.5)[1]]
    live["m1"] = 2000  # m1 balloons past the group's limit
    tree.enqueue("global.mem", "m2", "m2")
    out.append(tree.dequeue(0.15))  # m2 queued, not failed
    row = {r[0]: r for r in tree.table_rows()}["global.mem"]
    out += [row[1], row[8]]
    live["m1"] = 100
    kind, item, _group, _w = tree.dequeue(1.0)
    out.append((kind, item))
    return out


def test_memory_limit_queues_new_work_never_fails_it():
    assert both(_memory_limit) == ["m1", None, "blocked-memory", 2000, ("run", "m2")]


def _queue_timeout(pkg):
    tree = _tree(pkg, {
        "root_groups": [{
            "name": "global",
            "sub_groups": [{"name": "fast", "hard_concurrency_limit": 1,
                            "queue_timeout_ms": 30}]}],
        "selectors": [{"group": "global"}]})
    tree.enqueue("global.fast", "q1", "q1", now=time.time() - 1.0)
    kind, item, group, waited = tree.dequeue(0.5)
    return kind, item, group, waited >= 0.9, pkg.rg.EXCEEDED_QUEUE_TIMEOUT


def test_queue_timeout_ages_out_typed():
    assert both(_queue_timeout) == ("aged", "q1", "global.fast", True, "EXCEEDED_QUEUE_TIMEOUT")


def _served(pkg):
    tree = _tree(pkg, {"root_groups": [{"name": "global", "sub_groups": [{"name": "a"}]}],
                       "selectors": [{"group": "global"}]})
    tree.note_served("global.a")
    tree.note_served("global.a")
    rows = {r[0]: r[4] for r in tree.table_rows()}
    return rows, tree.info()["groups"]["global.a"]["served"]


def test_note_served_rolls_up_the_chain():
    rows, served = both(_served)
    assert rows == {"global": 2, "global.a": 2} and served == 2


def _retry_after(pkg):
    tree = _tree(pkg, {"root_groups": [{"name": "global"}], "selectors": [{"group": "global"}]})
    out = [tree.drain_rate(), tree.retry_after_s(4, fallback=1.0)]
    for i in range(3):
        tree.enqueue("global", f"q{i}", i)
    for _ in range(3):
        tree.dequeue(0.2)
    return out + [tree.drain_rate() > 0, 0.1 <= tree.retry_after_s(4) <= 30.0]


def test_retry_after_from_the_drain_rate():
    assert both(_retry_after) == [0.0, 1.0, True, True]


# ------------------------------------------------ acceptance: carve-outs
def _carveout(pkg):
    cache = pkg.cache.DeviceTableCache(max_bytes=1000)
    before = pkg.rg.CACHE_SHARES.snapshot()
    pkg.rg.CACHE_SHARES.configure({"global.a": 0.5})

    def stage(table, group, nbytes=200):
        tok = pkg.rg.set_current_group(group)
        try:
            cache.lookup_or_stage(pkg.cache.CacheKey("c", "s", table, "v1", "sig", "table", 1),
                                  lambda: (object(), 10, nbytes, 1))
        finally:
            pkg.rg.reset_current_group(tok)

    try:
        stage("ta0", "global.a")
        stage("ta1", "global.a")  # 400 bytes <= a's 500-byte carve-out
        for i in range(8):        # b's storm: 1600 bytes over a 1000-byte budget
            stage(f"tb{i}", "global.b")
        return (sorted(e["table"] for e in cache.snapshot()), cache.group_bytes(),
                cache.cached_bytes())
    finally:
        pkg.rg.CACHE_SHARES.configure(before)


def test_cache_carveout_protects_tenant_warm_set():
    """One tenant's eviction storm reclaims its own over-share bytes; the
    protected tenant's warm entries survive, in both packages alike."""
    tables, groups, total = both(_carveout)
    assert {"ta0", "ta1"} <= set(tables)
    assert groups["global.a"] == 400 and groups["global.b"] <= 600 and total <= 1000


def _result_cache_carveout(pkg):
    cache = pkg.result_cache.ResultCache(max_bytes=20000)
    before = pkg.rg.CACHE_SHARES.snapshot()
    pkg.rg.CACHE_SHARES.configure({"global.a": 0.5})
    rows = [(i, "x" * 40) for i in range(8)]
    try:
        # 1804 bytes an entry: a keeps 3608 of its 10000-byte carve-out while
        # b's twelve overflow the 20000-byte budget
        for key, group in [("a0", "global.a"), ("a1", "global.a")] + [
                (f"b{i}", "global.b") for i in range(12)]:
            tok = pkg.rg.set_current_group(group)
            try:
                assert cache.begin(key)[0] == "lead"
                cache.complete(key, ["k", "v"], rows, ttl_ms=60_000)
            finally:
                pkg.rg.reset_current_group(tok)
        return ([k for k in ("a0", "a1") if cache.peek(k) is not None],
                cache.group_bytes().get("global.a"), cache.cached_bytes() <= 20000)
    finally:
        pkg.rg.CACHE_SHARES.configure(before)


def test_result_cache_carveout_and_peek():
    """The result cache's victims under CACHE_SHARES and its read-only
    ``peek``, through both packages."""
    kept, a_bytes, within = both(_result_cache_carveout)
    assert kept == ["a0", "a1"] and a_bytes and within


# ----------------------------------------------------- end-to-end wiring
E2E_CFG = {
    "root_groups": [{
        "name": "global", "hard_concurrency_limit": 16,
        "max_queued": 100,
        "sub_groups": [
            {"name": "adhoc",
             "sub_groups": [{"name": "${USER}",
                             "hard_concurrency_limit": 2,
                             "max_queued": 2}]},
            {"name": "etl", "hard_concurrency_limit": 4, "weight": 3}]}],
    "selectors": [
        {"source": "etl-.*", "group": "global.etl"},
        {"group": "global.adhoc.${USER}"}]}


def _bad_config(pkg):
    with pytest.raises(pkg.rg.ConfigError) as ei:
        pkg.coordinator.CoordinatorServer(
            resource_groups_config={"root_groups": [], "selectors": []}, **pkg.kw)
    return str(ei.value)


def test_bad_config_fails_server_construction():
    both(_bad_config)


def _group_wiring(pkg):
    coord = pkg.coordinator.CoordinatorServer(executor_lanes=0, resource_groups_config=E2E_CFG,
                                              **pkg.kw)
    coord.start()
    M = pkg.M
    out = {}
    try:
        q1 = coord.submit("select 1", PROPS, user="alice")
        q2 = coord.submit("select 2", PROPS, user="alice")
        out["group"] = q1.resource_group
        with pytest.raises(pkg.dispatch.DispatchRejected) as ei:
            coord.submit("select 3", PROPS, user="alice")
        e = ei.value
        out["rejected"] = (e.resource_group, e.queued_ahead, e.payload()["error"]["resourceGroup"],
                           e.payload()["error"]["queuedAhead"], "global.adhoc.alice" in str(e))
        status, body, headers = pkg.wire.http_request(
            "POST", f"{coord.base_url}/v1/statement", b"select 4", "text/plain",
            headers={"X-Trino-User": "alice",
                     **{f"X-Trino-Session-{k}": v for k, v in PROPS.items()}})
        out["http"] = (status, any(k.lower() == "retry-after" for k in headers),
                       sorted(json.loads(body)["error"]))
        # bob's etl group still admits while alice's queue is full
        q3 = coord.submit("select 5", PROPS, user="bob", source="etl-nightly")
        out["etl"] = q3.resource_group
        coord.dispatcher.start_lanes(4)
        for q in (q1, q2, q3):
            _wait(q)
        out["stats_group"] = q1.query_stats()["resourceGroup"]
        rows = {r[0]: r for r in coord.resource_groups.table_rows()}
        out["tree"] = (sorted(rows), rows["global.etl"][9], all(len(r) == 12 for r in rows.values()))
        props = {"catalog": "memory", "schema": "default", "result_cache_enabled": "true"}
        _wait(coord.submit("create table memory.default.rg (a bigint)", props, user="alice"))
        _wait(coord.submit("insert into memory.default.rg values (1), (2)", props, user="alice"))
        sql = "select count(*) from memory.default.rg"
        _wait(coord.submit(sql, props, user="alice"))  # MISS fills
        served0 = M.RESOURCE_GROUP_SERVED.value("global.adhoc.alice")
        q = _wait(coord.submit(sql, props, user="alice"))
        out["served"] = (q.cache_status, M.RESOURCE_GROUP_SERVED.value("global.adhoc.alice")
                         - served0,
                         {r[0]: r for r in coord.resource_groups.table_rows()}[
                             "global.adhoc.alice"][4] >= 1)
        return out
    finally:
        coord.stop()


def test_coordinator_group_wiring_end_to_end():
    """Two tenants: the per-group typed 429, the group in the query stats
    and the tree's rows, serving-index hits counted as ``served``."""
    got = both(_group_wiring)
    assert got["group"] == "global.adhoc.alice"
    assert got["rejected"] == ("global.adhoc.alice", 2, "global.adhoc.alice", 2, True)
    assert got["http"][:2] == (429, True) and "resourceGroup" in got["http"][2]
    assert got["etl"] == "global.etl" and got["stats_group"] == "global.adhoc.alice"
    assert {"global", "global.adhoc", "global.adhoc.alice", "global.etl"} <= set(got["tree"][0])
    assert got["tree"][1:] == (3, True)
    assert got["served"] == ("HIT", 1, True)


AGING_CFG = {
    "root_groups": [{
        "name": "global",
        "sub_groups": [{"name": "aging", "hard_concurrency_limit": 1,
                        "queue_timeout_ms": 1}]}],
    "selectors": [{"user": "ager", "group": "global.aging"}, {"group": "global"}]}


def _queue_aging(pkg):
    coord = pkg.coordinator.CoordinatorServer(executor_lanes=0, resource_groups_config=AGING_CFG,
                                              **pkg.kw)
    coord.start()
    try:
        t0 = pkg.M.RESOURCE_GROUP_REJECTED.value("global.aging", "queue-timeout")
        q = coord.submit("select 1", PROPS, user="ager")
        time.sleep(0.15)  # parked well past the 1 ms timeout, no lanes
        coord.dispatcher.start_lanes(1)
        state = q.state.wait_for_terminal(30.0)
        return (state, "EXCEEDED_QUEUE_TIMEOUT" in (q.failure or ""),
                "global.aging" in (q.failure or ""),
                pkg.M.RESOURCE_GROUP_REJECTED.value("global.aging", "queue-timeout") - t0), (
                    coord, q)
    finally:
        coord.stop()


def test_queue_aging_fails_typed_with_history():
    """A query parked past its group's ``queue_timeout_ms`` fails typed
    EXCEEDED_QUEUE_TIMEOUT, counted as the group's queue-timeout; the port's
    history records it FAILED under its group."""
    want, _ = _queue_aging(JAX)
    got, (coord, q) = _queue_aging(TORCH)
    assert got == want == ("FAILED", True, True, 1)
    deadline = time.time() + 10
    while not coord.history.snapshot() and time.time() < deadline:
        time.sleep(0.05)
    rec = next(r for r in coord.history.snapshot() if r["queryId"] == q.query_id)
    assert (rec["state"], rec["resourceGroup"]) == ("FAILED", "global.aging")
    assert "EXCEEDED_QUEUE_TIMEOUT" in rec["failure"]
