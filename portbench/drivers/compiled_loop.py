"""Traffic driver: the compiled tier, one client replaying captured queries.

Set-up plans each instance with ``plan_sql``, builds it with
``CompiledQuery.build``, runs it once (warm-up and CUDA graph capture) and
then in the cell's warm-up passes; the window replays it (``run()``) and
materializes its rows as Python tuples (``Page.to_pylist()``). Only what
set-up built can be replayed: the traffic sends from one client, with
parameters fixed or one set a stream.
"""
from __future__ import annotations


def setup(run) -> None:
    from trino_tpu_torch import Session
    from trino_tpu_torch.exec.compiled import CompiledQuery
    from trino_tpu_torch.exec.query import plan_sql

    tr = run.traffic
    if tr.clients != 1 or tr.spec["parameters"] == "per_query":
        raise ValueError("compiled_loop replays the graphs set-up built: one client, "
                         "parameters fixed or per_stream")
    cfg = run.config
    session = Session(properties={"catalog": cfg["catalog"], "schema": cfg["schema"],
                                  **cfg["session_properties"]}, device=run.device)
    compiled = {}
    # set-up in query order, not the window's: what a build finds in the
    # device cache shapes its plan, so every seed builds the same graphs
    keys = tr.setup_keys(0)
    for key in keys:
        cq = CompiledQuery.build(session, plan_sql(session, tr.sql[key]))
        cq.run().to_pylist()
        compiled[key] = cq
    run.state.update(session=session, compiled=compiled)
    for _ in range(int(tr.spec["warmup_passes"])):
        for key in keys:
            execute(run, key, 0)


def execute(run, key, client: int):
    cq = run.state["compiled"][key]
    with run.span("replay"):
        page = cq.run()
        if run.recording:
            run.sync()
    with run.span("rows"):
        return page.to_pylist()


def teardown(run) -> None:
    for cq in run.state.pop("compiled", {}).values():
        cq.close()
    run.state.pop("session", None)
