"""The port's spans inside ``Session.execute``, the eager executor,
``CompiledQuery.run`` and ``Page.to_pylist``, and the registered counters
fed at the same boundaries (``obs/trace.py`` ``timed``): each span nests
inside its parent, each counter equals the sum of its family's outermost
spans, and without a tracer no span is made while the counters still
advance."""
import sys
from decimal import Decimal
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from tpch_sql import QUERIES  # noqa: E402

from trino_tpu_torch import Session  # noqa: E402
from trino_tpu_torch.exec.compiled import CompiledQuery  # noqa: E402
from trino_tpu_torch.exec.executor import Executor  # noqa: E402
from trino_tpu_torch.exec.query import plan_sql  # noqa: E402
from trino_tpu_torch.obs import devprofiler  # noqa: E402
from trino_tpu_torch.obs import metrics as M  # noqa: E402
from trino_tpu_torch.obs import trace  # noqa: E402

TINY = {"catalog": "tpch", "schema": "tiny"}
# each counter's family: the spans that feed it
FAMILIES = {
    M.PLAN_SECONDS: ("parse", "analyze/plan", "optimize", "plan/mv-substitute"),
    M.EXECUTOR_SECONDS: ("exec/run",),
    M.SCALAR_HOST_SECONDS: ("exec/host-pass",),
    M.ROWS_COPY_SECONDS: ("rows/copy",),
}
# the executor's spans inside a plan node's own: they name a part of it
OPERATOR_PARTS = ("exec/dynamic-filter", "exec/window", "exec/set-op")
# a sort of a page holding nested columns (a nested host pass), a long
# decimal, NULLs and a selection
MIXED_SQL = """select x, s, d * d as dd, array[x, 2], row(x, s) from (values
    (1, 'a', cast(1234567890123.45 as decimal(20,2))),
    (null, null, null),
    (3, 'c', cast(-5.50 as decimal(20,2)))) t(x, s, d)
    where x is null or x <> 2 order by x"""
MIXED_ROWS = [(1, "a", Decimal("1524157875323866912056239.9025"), [1, 2], (1, "a")),
              (3, "c", Decimal("30.2500"), [3, 2], (3, "c")),
              (None, None, None, [None, 2], (None, None))]


def _values():
    return {m: m.value() for m in FAMILIES}


@pytest.fixture(scope="module")
def session():
    s = Session(dict(TINY), device="cpu")
    for q in (3, 22):  # the tables staged once, outside the traced runs
        s.execute(QUERIES[q])
    return s


@pytest.fixture(scope="module")
def traced(session):
    """Q3 (joins) and Q22 (substring host passes) through Session.execute
    under a tracer: the tracer, the counters' deltas, the executor."""
    out = {}
    real = Executor.execute_checked
    for q in (3, 22):
        seen = []

        def spy(self, node, seen=seen):
            seen.append(self)
            return real(self, node)

        Executor.execute_checked = spy
        try:
            tracer = trace.Tracer(max_spans=1 << 16)
            before = _values()
            with trace.activate(tracer):
                rows = session.execute(QUERIES[q]).rows
            after = _values()
        finally:
            Executor.execute_checked = real
        out[q] = (tracer, {m: after[m] - before[m] for m in FAMILIES}, seen, rows)
    return out


@pytest.mark.parametrize("q", [3, 22])
def test_session_execute_names_each_layer(traced, q):
    tracer, _, executors, _ = traced[q]
    spans = tracer.spans()
    names = [s.name for s in spans]
    for name in ("parse", "analyze/plan", "optimize", "exec/run", "rows/copy", "rows/convert"):
        assert names.count(name) == 1, (name, names)
    # one exec/<operator> span a plan node execution, named as the kernel
    # ledger names the node; a join's dynamic filter is a span inside its
    # join's, under the join's node
    (ex,) = executors
    nodes = [(s.attributes["node"], s.name[len("exec/"):]) for s in spans
             if s.name.startswith("exec/") and "node" in s.attributes
             and s.name not in OPERATOR_PARTS]
    assert set(nodes) == set(ex.kernel_stats)
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        if s.name == "exec/dynamic-filter":
            assert (s.attributes["node"], "Join") in ex.kernel_stats
            assert by_id[s.parent_id].name == "exec/Join"
    assert len(nodes) == sum(k["launches"] for k in ex.kernel_stats.values())
    assert {"Join", "TableScan", "Output"} <= {op for _, op in nodes}
    passes = [s for s in spans if s.name == "exec/host-pass"]
    if q == 22:
        assert passes and all(s.attributes["fn"] == "substring" for s in passes)
        assert all(s.attributes["entries"] > 0 for s in passes)
        assert all(s.attributes["path"] == "vector" for s in passes)
    else:
        assert not passes


@pytest.mark.parametrize("q", [3, 22])
def test_spans_nest_within_their_parents(traced, q):
    spans = traced[q][0].spans()
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        assert s.duration is not None and s.duration >= 0
        if s.parent_id is None:
            continue
        parent = by_id[s.parent_id]
        assert parent._t0 <= s._t0 + 1e-9
        assert s._t0 + s.duration <= parent._t0 + parent.duration + 1e-9, (s.name, parent.name)
    top = {s.name for s in spans if s.parent_id is None}
    assert top == {"parse", "analyze/plan", "optimize", "exec/run", "rows/copy", "rows/convert"}


def _outermost(spans, family):
    by_id = {s.span_id: s for s in spans}

    def inside(s):
        p = by_id.get(s.parent_id)
        while p is not None:
            if p.name in family:
                return True
            p = by_id.get(p.parent_id)
        return False

    return [s for s in spans if s.name in family and not inside(s)]


@pytest.mark.parametrize("q", [3, 22])
def test_each_counter_is_its_outermost_spans(traced, q):
    tracer, deltas, _, _ = traced[q]
    spans = tracer.spans()
    for counter, family in FAMILIES.items():
        outer = _outermost(spans, family)
        assert deltas[counter] == pytest.approx(sum(s.duration for s in outer), abs=1e-9), \
            counter.name
    assert deltas[M.SCALAR_HOST_SECONDS] > 0 if q == 22 else deltas[M.SCALAR_HOST_SECONDS] == 0


def test_without_a_tracer_no_span_is_made_and_counters_advance(session, monkeypatch):
    made = []
    real = trace.Span.__init__

    def init(self, *a, **k):
        made.append(a[0] if a else k.get("name"))
        real(self, *a, **k)

    monkeypatch.setattr(trace.Span, "__init__", init)
    assert trace.current() is None
    before = _values()
    session.execute(QUERIES[22])
    after = _values()
    assert made == []
    assert all(after[m] > before[m] for m in FAMILIES), {m.name: after[m] - before[m]
                                                       for m in FAMILIES}


def test_a_tracer_without_detail_keeps_the_reference_spans(session):
    """The serving tiers' tracers: the spans the reference also records,
    none of the port's own; the counters advance all the same."""
    tracer = trace.Tracer(detail=False)
    before = _values()
    with trace.activate(tracer):
        session.execute(QUERIES[22])
    after = _values()
    names = {s.name for s in tracer.spans()}
    assert {"parse", "analyze/plan", "optimize"} <= names
    assert not {n for n in names if n.startswith(("exec/", "rows/"))}, names
    assert all(after[m] > before[m] for m in FAMILIES)


def test_q22_substrings_take_the_vector_path(session):
    """Q22's three ``substring(c_phone, 1, 2)`` passes over the ASCII phone
    vocabulary run vectorized, each run of the query again (no memo)."""
    for _ in range(2):
        v0, e0 = M.SUBSTRING_VECTOR_PASSES.value(), M.SUBSTRING_ENTRY_PASSES.value()
        session.execute(QUERIES[22])
        assert M.SUBSTRING_VECTOR_PASSES.value() - v0 == 3
        assert M.SUBSTRING_ENTRY_PASSES.value() - e0 == 0


def test_nested_host_passes_and_rows_keep_their_values(session):
    tracer = trace.Tracer()
    n0 = M.NESTED_HOST_SECONDS.value()
    with trace.activate(tracer):
        rows = session.execute(MIXED_SQL).rows
    nested_s = M.NESTED_HOST_SECONDS.value() - n0
    assert rows == MIXED_ROWS
    assert session.execute(MIXED_SQL).rows == MIXED_ROWS  # and without a tracer
    (sp,) = [s for s in tracer.spans() if s.name == "exec/host-pass"]
    assert sp.attributes == {"fn": "sort_nested", "entries": 3}
    assert nested_s == pytest.approx(sp.duration, abs=1e-9)


def test_to_pylist_copies_then_converts(session):
    page = Executor(session).execute_checked(plan_sql(session, MIXED_SQL))
    tracer = trace.Tracer()
    with trace.activate(tracer):
        rows = page.to_pylist()
    assert rows == MIXED_ROWS
    assert [s.name for s in tracer.spans()] == ["rows/copy", "rows/convert"]
    copy, convert = tracer.spans()
    assert copy._t0 + copy.duration <= convert._t0
    # the column by column path reads the same values
    idx = None if page.sel is None else np.nonzero(page.sel.numpy())[0]
    assert list(zip(*[c.to_python(idx) for c in page.columns])) == rows


def test_compiled_run_splits_device_execute(session, monkeypatch):
    cq = CompiledQuery.build(session, plan_sql(session, QUERIES[3]))
    signed = []
    real = devprofiler.shape_signature

    def sign(arrays):
        signed.append(len(arrays))
        return real(arrays)

    monkeypatch.setattr(devprofiler, "shape_signature", sign)
    first = cq.run().to_pylist()  # the capturing run signs the inputs
    assert len(signed) == 1
    run0, wait0 = M.COMPILED_RUN_SECONDS.value(), M.REPLAY_WAIT_SECONDS.value()
    tracer = trace.Tracer()
    with trace.activate(tracer):
        page = cq.run()
    assert page.to_pylist() == first
    assert len(signed) == 1  # a replay reuses the signature
    spans = tracer.spans()
    (ex,) = [s for s in spans if s.name == "device/execute"]
    kids = [s.name for s in spans if s.parent_id == ex.span_id]
    assert kids == ["device/replay", "device/flag-read", "device/ledger", "device/outputs"]
    (wait,) = [s for s in spans if s.name == "device/flag-read"]
    assert M.COMPILED_RUN_SECONDS.value() - run0 == pytest.approx(ex.duration, abs=1e-9)
    assert M.REPLAY_WAIT_SECONDS.value() - wait0 == pytest.approx(wait.duration, abs=1e-9)
    cq.close()


def test_compiled_capture_span_covers_the_run_alone(session):
    """``device/compile`` times the capturing run; the ledger and the
    outputs' clone of that run follow it, under the same parent."""
    cq = CompiledQuery.build(session, plan_sql(session, QUERIES[3]))
    tracer = trace.Tracer()
    with trace.activate(tracer):
        rows = cq.run().to_pylist()
    assert rows
    spans = tracer.spans()
    (comp,) = [s for s in spans if s.name == "device/compile"]
    assert [s.name for s in spans if s.parent_id == comp.span_id] == [
        "device/replay", "device/flag-read"]
    for name in ("device/ledger", "device/outputs"):
        (sp,) = [s for s in spans if s.name == name]
        assert sp.parent_id == comp.parent_id
        assert sp._t0 >= comp._t0 + comp.duration
    assert not [s for s in spans if s.name == "device/execute"]
    cq.close()


def test_timed_feeds_the_outermost_span_of_a_family():
    reg = M.MetricsRegistry()
    a = reg.counter("t_a_seconds_total", "a")
    b = reg.counter("t_b_seconds_total", "b")
    with trace.timed("outer", a) as sp:
        assert sp is trace.NOOP_SPAN
        with trace.timed("inner", a):
            pass
    once = a.value()
    assert once > 0
    tracer = trace.Tracer()
    with trace.activate(tracer):
        with trace.timed("outer", a, k=1) as outer:
            with trace.timed("inner", a):
                with trace.timed("other", b):
                    pass
        with pytest.raises(ValueError):
            with trace.timed("failing", a):
                raise ValueError("x")
    spans = {s.name: s for s in tracer.spans()}
    assert outer is spans["outer"] and outer.attributes == {"k": 1}
    assert spans["inner"].parent_id == outer.span_id
    assert spans["other"].parent_id == spans["inner"].span_id
    assert a.value() - once == pytest.approx(outer.duration + spans["failing"].duration,
                                             abs=1e-12)
    assert b.value() == pytest.approx(spans["other"].duration, abs=1e-12)


def test_host_time_series_are_registered():
    page = M.REGISTRY.render()
    for m in (M.SCALAR_HOST_SECONDS, M.NESTED_HOST_SECONDS):
        assert m.name.startswith("trino_tpu_") and M.REGISTRY.get(m.name) is m
        assert f"# TYPE {m.name} counter" in page
    assert all(M.REGISTRY.get(n) is not None for n in M.PORT_SERIES)
