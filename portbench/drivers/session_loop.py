"""Traffic driver: ``Session.execute``, the eager main path, one session a
client.

Set-up opens the sessions and runs the cell's warm-up passes through each,
which fill the device cache where the configuration turns it on; the window
then runs each query through parse, planning, staging or the device cache,
the eager executor and the Python rows of ``QueryResult.rows``.
"""
from __future__ import annotations


def setup(run) -> None:
    from trino_tpu_torch import Session

    cfg, tr = run.config, run.traffic
    run.state["sessions"] = [
        Session(properties={"catalog": cfg["catalog"], "schema": cfg["schema"],
                            **cfg["session_properties"]}, device=run.device)
        for _ in range(tr.clients)]
    # warm-up in query order, not the window's, so every seed fills the
    # device cache alike
    for _ in range(int(tr.spec["warmup_passes"])):
        for client in range(tr.clients):
            for key in tr.setup_keys(client):
                execute(run, key, client)


def execute(run, key, client: int):
    with run.span("execute"):
        return run.state["sessions"][client].execute(run.traffic.sql[key]).rows


def teardown(run) -> None:
    run.state.pop("sessions", None)
