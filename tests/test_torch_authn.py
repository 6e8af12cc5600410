"""The port's public-API authentication (trino_tpu_torch/server/auth.py)
and the flat resource-group gates against the JAX package's, on the CPU.

The cases of the reference's tests/test_authn.py: PBKDF2 password hashes
and HS256 JWTs (a hash or a token made by one package verifies in the
other, and both reject the same bad ones), an authenticated cluster of
each package (no or bad credentials: 401 with ``WWW-Authenticate``; Basic
and Bearer accepted, the principal winning over a claimed user; another
user's query: 403 to read and to cancel; the owner reads it), and the
legacy ``ResourceGroupManager``'s per-user limits and weighted pick.
Then the port's own client: ``StatementClient`` with a password or a
token.
"""
import base64
import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

import trino_tpu  # noqa: F401  (turns on JAX x64 first)

SECRET = b"cluster-jwt-secret"


def _package(name):
    import importlib

    root = "trino_tpu" if name == "jax" else "trino_tpu_torch"

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    return types.SimpleNamespace(
        name=name, auth=mod("server.auth"), rg=mod("server.resource_groups"),
        coordinator=mod("server.coordinator"), worker=mod("server.worker"),
        remote=mod("client.remote"), kw={"device": "cpu"} if name == "torch" else {})


JAX = _package("jax")
TORCH = _package("torch")
PAIRS = pytest.mark.parametrize("made,checked", [(JAX, TORCH), (TORCH, JAX), (TORCH, TORCH)],
                                ids=["jax-to-torch", "torch-to-jax", "torch"])


def both(case, *args):
    want = case(JAX, *args)
    got = case(TORCH, *args)
    assert got == want, f"{case.__name__}: the port's {got} != the reference's {want}"
    return got


# ------------------------------------------------------------ credentials
@PAIRS
def test_password_hash_round_trip(made, checked):
    h = made.auth.hash_password("s3cret")
    assert checked.auth.verify_password("s3cret", h)
    assert not checked.auth.verify_password("wrong", h)
    assert not checked.auth.verify_password("s3cret", "garbage")
    # one salt, one hash: both packages derive the same bytes
    salt = bytes(range(16))
    assert made.auth.hash_password("pw", salt=salt, iterations=1000) == \
        checked.auth.hash_password("pw", salt=salt, iterations=1000)


@PAIRS
def test_jwt_round_trip_and_expiry(made, checked):
    auth = checked.auth.JwtAuthenticator(b"k" * 32)
    tok = made.auth.make_jwt({"sub": "alice", "exp": time.time() + 60}, b"k" * 32)
    assert auth.authenticate(tok).user == "alice"
    bad = [made.auth.make_jwt({"sub": "alice", "exp": time.time() - 1}, b"k" * 32),
           made.auth.make_jwt({"sub": "alice"}, b"other-key-000000"),
           made.auth.make_jwt({"exp": time.time() + 60}, b"k" * 32),
           "not.a.jwt"]
    for token in bad:
        with pytest.raises(checked.auth.AuthenticationError):
            auth.authenticate(token)


def _header_errors(pkg):
    a = pkg.auth.Authenticator(
        password=pkg.auth.PasswordFileAuthenticator({"alice": pkg.auth.hash_password("w")}),
        jwt=pkg.auth.JwtAuthenticator(SECRET))
    out = []
    for header in (None, "Basic " + base64.b64encode(b"alice:x").decode(), "Digest abc",
                   "Basic !!!", "Bearer x.y"):
        try:
            out.append(a.authenticate_header(header).user)
        except pkg.auth.AuthenticationError as e:
            out.append(str(e)[:40])
    out.append(a.authenticate_header("Basic " + base64.b64encode(b"alice:w").decode()).user)
    open_cluster = pkg.auth.Authenticator()
    out.append(open_cluster.required)
    return out


def test_authenticate_header_surface():
    got = both(_header_errors)
    assert got[-2:] == ["alice", False]


def test_password_file(tmp_path):
    path = tmp_path / "passwords"
    path.write_text(f"# users\n\nbob:{JAX.auth.hash_password('tinker')}\n")
    pw = TORCH.auth.PasswordFileAuthenticator.from_file(str(path))
    assert pw.authenticate("bob", "tinker").user == "bob"
    with pytest.raises(TORCH.auth.AuthenticationError):
        pw.authenticate("bob", "nope")


# ------------------------------------------------------------ the cluster
def _authed_cluster(pkg):
    pw = pkg.auth.PasswordFileAuthenticator({"alice": pkg.auth.hash_password("wonder"),
                                             "bob": pkg.auth.hash_password("tinker")})
    coord = pkg.coordinator.CoordinatorServer(
        authenticator=pkg.auth.Authenticator(password=pw, jwt=pkg.auth.JwtAuthenticator(SECRET)),
        resource_group=pkg.rg.ResourceGroupManager(root_concurrency_limit=8,
                                                   per_user_concurrency_limit=1), **pkg.kw)
    coord.start()
    worker = pkg.worker.WorkerServer(coordinator_url=coord.base_url, node_id="aw0", **pkg.kw)
    worker.start()
    assert coord.registry.wait_for_workers(1, timeout=15.0)
    return coord, worker


def _request(url, data=None, method="GET", headers=None):
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = resp.read()
            return resp.status, dict(resp.headers), json.loads(body) if body else None
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, dict(e.headers), json.loads(body) if body else None


def _basic(user, pw):
    return {"Authorization": "Basic " + base64.b64encode(f"{user}:{pw}".encode()).decode()}


def _wait_terminal(coord, qid):
    deadline = time.time() + 30
    while not coord.get_query(qid).state.is_terminal() and time.time() < deadline:
        time.sleep(0.05)


def _cluster_case(pkg):
    coord, worker = _authed_cluster(pkg)
    session = {"X-Trino-Session-Catalog": "tpch", "X-Trino-Session-Schema": "tiny"}

    def post(sql, headers=None):
        return _request(f"{coord.base_url}/v1/statement", sql.encode(), "POST",
                        {**session, **(headers or {})})

    out = {}
    try:
        status, headers, body = post("select 1")
        out["none"] = (status, headers.get("WWW-Authenticate"),
                       "Authentication failed" in body["error"]["message"])
        out["bad"] = post("select 1", _basic("alice", "WRONG"))[0]
        status, _h, body = post("select 2 + 2", _basic("alice", "wonder"))
        _wait_terminal(coord, body["id"])
        out["basic"] = (status, coord.get_query(body["id"]).user)
        tok = pkg.auth.make_jwt({"sub": "bob", "exp": time.time() + 300}, SECRET)
        status, _h, body = post("select 1", {"Authorization": f"Bearer {tok}",
                                             "X-Trino-User": "mallory"})
        _wait_terminal(coord, body["id"])
        out["bearer"] = (status, coord.get_query(body["id"]).user)
        status, _h, body = post("select 41 + 1", _basic("alice", "wonder"))
        qid = body["id"]
        _wait_terminal(coord, qid)
        bob = _basic("bob", "tinker")
        out["cross"] = (_request(f"{coord.base_url}/v1/query/{qid}", headers=bob)[0],
                        _request(f"{coord.base_url}/v1/statement/executing/{qid}/0",
                                 method="DELETE", headers=bob)[0],
                        _request(f"{coord.base_url}/v1/statement/executing/{qid}/0",
                                 headers=bob)[0],
                        _request(f"{coord.base_url}/v1/query/{qid}")[0])
        status, _h, info = _request(f"{coord.base_url}/v1/query/{qid}",
                                    headers=_basic("alice", "wonder"))
        out["owner"] = (status, info["user"], info["state"])
        return out
    finally:
        worker.stop()
        coord.stop()


def test_authenticated_cluster():
    """401 without or with bad credentials, Basic and Bearer accepted with
    the principal winning over the claimed user, 403 for another user's
    query (read, cancel, results), 401 without credentials there, and the
    owner reads it: both clusters alike."""
    got = both(_cluster_case)
    assert got["none"] == (401, 'Basic realm="trino-tpu", Bearer', True)
    assert got["bad"] == 401
    assert got["basic"] == (200, "alice") and got["bearer"] == (200, "bob")
    assert got["cross"] == (403, 403, 403, 401)
    assert got["owner"] == (200, "alice", "FINISHED")


def test_port_client_sends_credentials():
    coord, worker = _authed_cluster(TORCH)
    try:
        props = {"catalog": "tpch", "schema": "tiny"}
        client = TORCH.remote.StatementClient(coord.base_url, props, user="alice",
                                              password="wonder")
        assert client.execute("select count(*) from region")[1] == [[5]]
        assert coord.get_query(client.query_id).user == "alice"
        tok = TORCH.auth.make_jwt({"sub": "bob", "exp": time.time() + 300}, SECRET)
        client = TORCH.remote.StatementClient(coord.base_url, props, token=tok)
        assert client.execute("select 1")[1] == [[1]]
        assert coord.get_query(client.query_id).user == "bob"
        with pytest.raises(TORCH.remote.RemoteQueryError, match="401|Authentication"):
            TORCH.remote.StatementClient(coord.base_url, props, user="bob",
                                         password="nope").execute("select 1")
        from trino_tpu_torch.client import dbapi

        with dbapi.connect(coord.base_url, user="alice", password="wonder") as conn:
            cur = conn.cursor()
            cur.execute("select count(*) from nation")
            assert cur.fetchone() == (25,)
    finally:
        worker.stop()
        coord.stop()


# ------------------------------------------------------- flat group gates
def _per_user_limits(pkg):
    mgr = pkg.rg.ResourceGroupManager(root_concurrency_limit=8, per_user_concurrency_limit=1)
    out = [mgr.submit(timeout=1.0, user="alice")]
    admitted = []
    t = threading.Thread(target=lambda: admitted.append(mgr.submit(timeout=10.0, user="alice")),
                         daemon=True)
    t.start()
    deadline = time.time() + 5
    while mgr.info()["subgroups"]["alice"]["queued"] < 1 and time.time() < deadline:
        time.sleep(0.01)
    info = mgr.info()
    out.append((info["subgroups"]["alice"]["running"], info["subgroups"]["alice"]["queued"]))
    out.append(mgr.submit(timeout=1.0, user="bob"))  # bob admitted beside alice's queue
    mgr.finish(user="alice")
    t.join(timeout=5.0)
    out.append(admitted)
    mgr.finish(user="alice")
    mgr.finish(user="bob")
    out.append(mgr.info()["running"])
    return out


def test_per_user_groups_enforce_separate_limits():
    assert both(_per_user_limits) == [True, (1, 1), True, [True], 0]


def _weighted_pick(pkg):
    mgr = pkg.rg.ResourceGroupManager(root_concurrency_limit=2, per_user_concurrency_limit=2,
                                      user_weights={"heavy": 3, "light": 1})
    out = [mgr.submit(timeout=1.0, user="light"), mgr.submit(timeout=1.0, user="light")]
    got = []
    threads = [threading.Thread(target=lambda u=u: got.append((u, mgr.submit(10.0, user=u))),
                                daemon=True) for u in ("heavy", "light")]
    for th in threads:
        th.start()
    deadline = time.time() + 5
    while mgr.info()["queued"] < 2 and time.time() < deadline:
        time.sleep(0.01)
    mgr.finish(user="light")  # one slot frees: heavy (0/3) beats light (1/1)
    deadline = time.time() + 5
    while not got and time.time() < deadline:
        time.sleep(0.01)
    out.append(list(got))
    mgr.finish(user="heavy")
    for th in threads:
        th.join(timeout=5.0)
    return out


def test_weighted_scheduling_prefers_higher_weight():
    assert both(_weighted_pick) == [True, True, [("heavy", True)]]


def _flat_gate(pkg):
    g = pkg.rg.ResourceGroup(hard_concurrency_limit=1, max_queued=0)
    out = [g.submit(timeout=0.1), g.submit(timeout=0.1), g.info()]
    g.finish()
    out.append(g.info())
    return out


def test_flat_resource_group_gate():
    assert both(_flat_gate) == [True, False,
                                {"name": "global", "running": 1, "queued": 0,
                                 "hardConcurrencyLimit": 1},
                                {"name": "global", "running": 0, "queued": 0,
                                 "hardConcurrencyLimit": 1}]
