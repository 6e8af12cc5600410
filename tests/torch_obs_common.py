"""Shared helpers of the observability-plane tests (test_torch_system_catalog,
_flowledger, _phase_ledger, _otlp, _observability): one namespace a package
(the JAX reference and the PyTorch port) with the modules the cases call,
and two in-process clusters, one a package, with the same worker ids."""
import importlib
import json
import time
import types

import trino_tpu  # noqa: F401  (turns on JAX x64 first)

TINY = {"catalog": "tpch", "schema": "tiny"}

# TPC-H Q3, as the reference's flow-ledger tests spell it
Q3_SQL = """
select l_orderkey, o_orderdate, o_shippriority,
       sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate, l_orderkey limit 10
"""


def package(name: str):
    root = "trino_tpu" if name == "jax" else "trino_tpu_torch"

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    return types.SimpleNamespace(
        name=name, root=root, M=mod("obs.metrics"), timeline=mod("obs.timeline"),
        flow=mod("obs.flowledger"), otlp=mod("obs.otlp"), listeners=mod("obs.listeners"),
        trace=mod("obs.trace"), events=mod("server.events"), wire=mod("server.wire"),
        buffer=mod("server.buffer"), system_tables=mod("server.system_tables"),
        system=mod("connector.system.connector"), cli=mod("client.cli"),
        remote=mod("client.remote"), session=mod("client.session"),
        coordinator=mod("server.coordinator"), worker=mod("server.worker"),
        kw={"device": "cpu"} if name == "torch" else {})


JAX = package("jax")
TORCH = package("torch")
BOTH = (JAX, TORCH)


def new_session(pkg, props=None):
    return pkg.session.Session(dict(TINY if props is None else props), **pkg.kw)


def start_cluster(pkg, prefix: str, workers: int = 2):
    coord = pkg.coordinator.CoordinatorServer(**pkg.kw)
    coord.start()
    ws = [pkg.worker.WorkerServer(coordinator_url=coord.base_url, node_id=f"{prefix}{i}",
                                  **pkg.kw) for i in range(workers)]
    for w in ws:
        w.start()
    assert coord.registry.wait_for_workers(workers, timeout=15.0)
    return coord, ws


def stop_cluster(coord, ws):
    for w in ws:
        w.stop()
    coord.stop()


def both_clusters(prefix: str, workers: int = 2):
    """A generator for a module fixture: {"jax": coord, "torch": coord}."""
    started = {}
    try:
        for pkg in BOTH:
            started[pkg.name] = start_cluster(pkg, prefix, workers)
        yield {name: c for name, (c, _ws) in started.items()}
    finally:
        for coord, ws in started.values():
            stop_cluster(coord, ws)


def wait_terminal(q, timeout: float = 120.0) -> str:
    deadline = time.time() + timeout
    while not q.state.is_terminal() and time.time() < deadline:
        time.sleep(0.02)
    return q.state.get()


def client(pkg, coord, props=None):
    return pkg.remote.StatementClient(coord.base_url, dict(TINY if props is None else props))


def execute(pkg, coord, sql, props=None):
    """(client, columns, rows) of one statement through the protocol."""
    c = client(pkg, coord, props)
    cols, rows = c.execute(sql, timeout=120.0)
    return c, cols, rows


def submit(pkg, coord, sql, headers=None):
    status, body, _ = pkg.wire.http_request(
        "POST", f"{coord.base_url}/v1/statement", sql.encode(), "text/plain",
        headers=headers or {})
    assert status < 400, body
    return json.loads(body)


def drain(pkg, payload, deadline_s: float = 120.0):
    """Follow nextUri to the end: (columns, rows); RuntimeError on an
    error payload."""
    columns, rows = [], []
    deadline = time.monotonic() + deadline_s
    while True:
        if "error" in payload:
            raise RuntimeError(payload["error"]["message"])
        if "columns" in payload:
            columns = [c["name"] for c in payload["columns"]]
        rows.extend(payload.get("data", []))
        uri = payload.get("nextUri")
        if uri is None:
            return columns, rows
        assert time.monotonic() < deadline
        status, body, _ = pkg.wire.http_request("GET", uri, timeout=60.0)
        assert status < 400
        payload = json.loads(body)


def query(pkg, coord, sql, headers=None):
    """One statement on a fresh protocol session: (columns, rows)."""
    return drain(pkg, submit(pkg, coord, sql, headers))


def get_json(pkg, coord, path):
    return pkg.wire.json_request("GET", f"{coord.base_url}{path}")


def span_names(node, out=None):
    """Every span name of a trace tree (the trace route's ``root``)."""
    out = [] if out is None else out
    if node is None:
        return out
    for n in (node if isinstance(node, list) else [node]):
        if "name" in n:
            out.append(n["name"])
        span_names(n.get("children") or [], out)
    return out
