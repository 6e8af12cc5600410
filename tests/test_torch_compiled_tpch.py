"""The compiled tier over TPC-H at ``tiny``: the port's CompiledQuery
(trino_tpu_torch/exec/compiled.py, on the CPU) against the JAX package's
(trino_tpu/exec/compiled.py), Q1-Q11 here and Q12-Q22 in
test_torch_compiled_tpch_more.py (a second file, so the xdist
``loadfile`` workers split them). For each query: the rows of the first and
a second ``run()`` equal the reference's compiled rows and the port's eager
rows, the join tiers of the build and first run equal the reference's, and
the build's staged rows per scan, capacity hints and in-body dynamic
filters equal the reference's. Then each query's compiled body, with its
constant store filled, runs under a guard that raises on every host read
of a tensor, every tensor made from host data and every data-dependent
shape: what a CUDA graph capture forbids, pinned down on the CPU.

Tolerance: exact rows (doubles as in the other TPC-H tests: exact).

Also the writer of the compiled tier's SF1 reference (join tiers,
recompiles, staged rows and capacity hints per query), which the GPU smoke
run (chip_smoke.py, phase compiled) compares against:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_compiled_tpch.py --write-expected
"""
import contextlib
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from trino_tpu.client.session import Session as JaxSession  # noqa: E402
from trino_tpu.exec.compiled import CompiledQuery as JaxCompiledQuery  # noqa: E402
from trino_tpu.exec.query import plan_sql as jax_plan_sql  # noqa: E402
from trino_tpu.obs import metrics as jax_metrics  # noqa: E402
from trino_tpu.sql.planner import plan as JP  # noqa: E402
from tpch_sql import QUERIES  # noqa: E402

from trino_tpu_torch import Session as TorchSession  # noqa: E402
from trino_tpu_torch.exec.compiled import CompiledQuery  # noqa: E402
from trino_tpu_torch.exec.query import plan_sql  # noqa: E402
from trino_tpu_torch.obs import metrics as torch_metrics  # noqa: E402
from trino_tpu_torch.sql.planner import plan as TP  # noqa: E402

EXPECTED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "trino_tpu_torch", "testdata", "compiled_sf1_expected.json")
TIERS = ("dense", "fused", "merge-sorted", "merge-pallas", "legacy")


def props(schema="tiny"):
    return {"catalog": "tpch", "schema": schema, "fused_join_pallas": True}


def tier_counts(metric):
    return {t: metric.value(t) for t in TIERS}


def positions(root, walk):
    """Plan node id -> position in the plan walk: the two packages number
    their nodes from their own counters."""
    return {n.id: i for i, n in enumerate(walk(root))}


def norm_hints(hints, pos):
    """Capacity hints keyed by ``<kind>:<plan position>``."""
    return {f"{k.split(':')[0]}:{pos[int(k.split(':')[1])]}": v for k, v in hints.items()}


def build_profile(cq, walk):
    """What a build decided, in plan positions: staged rows per scan,
    capacity hints, in-body dynamic-filter specs."""
    pos = positions(cq.root, walk)
    device_df = {pos[nid]: [(ch, pos[jid], k, tuple(spec)) for ch, jid, k, spec in entries]
                 for nid, entries in cq._device_df.items()}
    return ({pos[nid]: rows for nid, rows in cq.scan_rows.items()},
            norm_hints(cq.capacity_hints, pos), device_df)


def compiled_both(sql, schema="tiny"):
    """Both packages' CompiledQuery over ``sql``: (reference, port) dicts of
    rows of two runs, join-tier deltas of build and first run, and the
    build profile."""
    out = []
    for session, cq_cls, plan, walk, metric in (
            (JaxSession(properties=props(schema)), JaxCompiledQuery, jax_plan_sql,
             JP.walk_plan, jax_metrics.FUSED_JOIN_SELECTIONS),
            (TorchSession(properties=props(schema), device="cpu"), CompiledQuery, plan_sql,
             TP.walk_plan, torch_metrics.FUSED_JOIN_SELECTIONS)):
        t0 = tier_counts(metric)
        cq = cq_cls.build(session, plan(session, sql))
        profile = build_profile(cq, walk)
        first = cq.run().to_pylist()
        t1 = tier_counts(metric)
        second = cq.run().to_pylist()
        out.append({"rows": first, "second": second, "recompiles": cq.recompiles,
                    "tiers": {t: t1[t] - t0[t] for t in TIERS}, "profile": profile,
                    "session": session})
    return out


def check_query(q):
    ref, got = compiled_both(QUERIES[q])
    assert ref["rows"], "the reference returned no rows"
    assert got["rows"] == ref["rows"]
    assert got["second"] == got["rows"] == ref["second"]
    assert got["rows"] == got["session"].execute(QUERIES[q]).rows  # the port's eager tier
    assert got["tiers"] == ref["tiers"]
    assert got["recompiles"] == ref["recompiles"]
    assert got["profile"] == ref["profile"]


@pytest.mark.parametrize("q", list(range(1, 12)))
def test_compiled_tpch_tiny_equals_reference(q):
    check_query(q)


# ------------------------------------------------------- capture guard
_T = torch.Tensor
_HOST_READS = {_T.item, _T.tolist, _T.numpy, _T.__bool__, _T.__int__, _T.__index__,
               _T.__float__}
_HOST_DATA = {torch.tensor, torch.as_tensor}
_DATA_SHAPES = {torch.nonzero, _T.nonzero, torch.unique, _T.unique, torch.unique_consecutive,
                _T.unique_consecutive, torch.masked_select, _T.masked_select, torch.argwhere,
                _T.argwhere, torch.bincount, _T.bincount}


class CaptureGuard(TorchFunctionMode):
    """Raises on what a CUDA graph capture forbids: a host read of a tensor,
    a tensor made from host data, a data-dependent output shape."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if func in _HOST_READS:
            raise AssertionError(f"host read: {name}")
        if func in _HOST_DATA:
            raise AssertionError(f"tensor from host data: {name}")
        if func in _DATA_SHAPES or (func in (torch.repeat_interleave, _T.repeat_interleave)
                                    and "output_size" not in kwargs):
            raise AssertionError(f"data-dependent shape: {name}")
        if func is _T.__getitem__:
            index = args[1] if isinstance(args[1], tuple) else (args[1],)
            for i in index:
                if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
                    raise AssertionError("data-dependent shape: boolean-mask __getitem__")
                if isinstance(i, torch.Tensor) and i.dim() == 0:
                    raise AssertionError("host read: __getitem__ by a 0-d tensor")
                if isinstance(i, (list, np.ndarray)):
                    raise AssertionError("tensor from host data: __getitem__ by a host index")
        return func(*args, **kwargs)


@contextlib.contextmanager
def capture_guard():
    """CaptureGuard, plus torch.from_numpy (which no TorchFunctionMode sees)."""
    from_numpy = torch.from_numpy

    def refused(*args, **kwargs):
        raise AssertionError("tensor from host data: from_numpy")

    torch.from_numpy = refused
    try:
        with CaptureGuard():
            yield
    finally:
        torch.from_numpy = from_numpy


def test_capture_guard_catches_each_kind():
    x = torch.arange(6)
    for fn in (lambda: x.sum().item(), lambda: bool(x[0]), lambda: x.tolist(),
               lambda: x.numpy(), lambda: torch.tensor([1]), lambda: x.nonzero(),
               lambda: x[x > 2], lambda: torch.from_numpy(np.arange(2)),
               lambda: torch.repeat_interleave(x, x), lambda: x[[0, 1]],
               lambda: x[x.argmax()]):
        with pytest.raises(AssertionError), capture_guard():
            fn()
    with capture_guard():
        torch.repeat_interleave(x, x, output_size=15)  # a host shape is fine


@pytest.mark.parametrize("q", list(range(1, 23)))
def test_compiled_body_is_capturable(q):
    """The body of every query, constants filled by a first run, makes no
    host read, no tensor from host data and no data-dependent shape; and it
    gives the first run's rows."""
    s = TorchSession(properties=props(), device="cpu")
    cq = CompiledQuery.build(s, plan_sql(s, QUERIES[q]))
    want = cq.run().to_pylist()
    cq._store.frozen = True
    with capture_guard():
        out_arrays, out_spec, codes, flags = cq._execute_body(count_tiers=False)
    from trino_tpu_torch.exec.page_tree import unflatten_page

    assert unflatten_page(out_spec, out_arrays).to_pylist() == want


# ------------------------------------------------------------ SF1 writer
def write_expected():
    """The JAX CompiledQuery over the 22 queries at SF1 on the CPU: join
    tiers of build and first run, recompiles, staged rows per scan and
    capacity hints (plan positions), and the rows' count and whether they
    equal the eager SF1 rows of tpch_sf1_expected.json exactly."""
    import time

    from test_torch_tpch import EXPECTED as EAGER, jsonable_rows

    with open(EAGER) as f:
        eager = json.load(f)["queries"]
    session = JaxSession(properties=props("sf1"))
    out = {"scale": "sf1", "properties": props("sf1"),
           "writer": "trino_tpu (JAX, CPU) via tests/test_torch_compiled_tpch.py "
           "--write-expected", "queries": {}}
    for q in range(1, 23):
        t = time.time()
        t0 = tier_counts(jax_metrics.FUSED_JOIN_SELECTIONS)
        cq = JaxCompiledQuery.build(session, jax_plan_sql(session, QUERIES[q]))
        scan_rows, hints, _ = build_profile(cq, JP.walk_plan)
        rows = cq.run().to_pylist()
        t1 = tier_counts(jax_metrics.FUSED_JOIN_SELECTIONS)
        out["queries"][str(q)] = {
            "sql": QUERIES[q], "rows": len(rows),
            "rows_equal_eager": jsonable_rows(rows) == eager[str(q)]["rows"],
            "recompiles": cq.recompiles,
            "tiers": {k: t1[k] - t0[k] for k in TIERS},
            "scan_rows": {str(k): v for k, v in scan_rows.items()}, "capacity_hints": hints}
        print(f"Q{q}: {len(rows)} rows, {cq.recompiles} recompiles, "
              f"{time.time() - t:.1f} s", flush=True)
    with open(EXPECTED, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-expected"]:
        write_expected()
    else:
        sys.exit("usage: python tests/test_torch_compiled_tpch.py --write-expected")
