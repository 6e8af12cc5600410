"""Interactive SQL console.

The port of trino_tpu/client/cli.py (reference: ``client/trino-cli``,
``Trino.java:41``, ``Console.java:86``): a readline console with aligned
output, running either against an embedded in-process session (default, on
``--device``: CUDA unless named) or a remote coordinator over the REST
protocol (``--server URL``). After each statement it prints the row count
and wall, the summary of the protocol's stats block (stages, rows, memory,
cache and group, drain rate, stragglers, the phase ledger) and, remotely,
the spooled segments it fetched (``--fetch-streams`` at a time) and the
result-cache disposition (``[cache: HIT]``).

Usage:
    python -m trino_tpu_torch.client.cli [--server URL] [--catalog C] [--schema S]
        [--device cuda|cpu] [--session NAME=VALUE ...]
    python -m trino_tpu_torch.client.cli --execute "select 1"

``--session`` (repeatable, as the Trino CLI's) sets session properties on
every statement, e.g. ``--session result_cache_enabled=true``.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Sequence


def format_table(columns: Sequence[str], rows: Sequence[Sequence]) -> str:
    """ALIGNED output format (the CLI default in the reference)."""
    cells = [[_render(v) for v in row] for row in rows]
    widths = [len(c) for c in columns]
    for row in cells:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))
    sep = "-+-".join("-" * w for w in widths)
    out: List[str] = []
    out.append(" | ".join(c.ljust(w) for c, w in zip(columns, widths)))
    out.append(sep)
    for row in cells:
        out.append(" | ".join(cell.ljust(w) for cell, w in zip(row, widths)))
    return "\n".join(out)


def _render(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _si(n) -> str:
    """Human row counts the way the reference CLI prints them: 6.0M, 1.2K."""
    n = int(n or 0)
    for div, suffix in ((1_000_000_000, "B"), (1_000_000, "M"), (1_000, "K")):
        # the 0.9995 factor rolls values the one-decimal rounding would
        # push to the next unit (999_950 -> "1.0M", never "1000.0K")
        if n >= div * 0.9995:
            return f"{n / div:.1f}{suffix}"
    return str(n)


def render_progress(stats) -> str:
    """One live progress line from a statement-protocol ``stats`` block:
    ``[RUNNING 2/3 stages, 6.0M rows, 1.2s]`` (reference: the CLI's
    StatusPrinter progress bar, reduced to a line)."""
    state = stats.get("state", "?")
    parts = []
    stages = stats.get("stages") or 0
    if stages:
        parts.append(f"{stats.get('completedStages', 0)}/{stages} stages")
    total_splits = stats.get("totalSplits") or 0
    if total_splits:
        parts.append(f"{stats.get('completedSplits', 0)}/{total_splits} splits")
    if stats.get("totalRows"):
        parts.append(f"{_si(stats['totalRows'])} rows")
    if stats.get("elapsedMs") is not None:
        parts.append(f"{stats['elapsedMs'] / 1e3:.1f}s")
    return f"[{state} {', '.join(parts)}]" if parts else f"[{state}]"


def render_summary(stats) -> str:
    """Final one-line stats summary appended to the row-count line."""
    if not stats:
        return ""
    parts = []
    if stats.get("totalRows"):
        parts.append(f"{_si(stats['totalRows'])} rows processed")
    if stats.get("totalSplits"):
        parts.append(
            f"{stats.get('completedSplits', 0)}/{stats['totalSplits']} splits")
    if stats.get("peakBytes"):
        parts.append(f"peak: {stats['peakBytes'] // 1024}KiB")
    mem = stats.get("memory") or {}
    if mem.get("shedBytes"):
        # revocable cache bytes the cluster shed on this query's behalf
        # (memory ledger: queryStats.memory)
        parts.append(f"shed: {mem['shedBytes'] // 1024}KiB")
    if stats.get("adaptations"):
        # the runtime re-planner rewrote fragments mid-query (details:
        # planVersions on GET /v1/query/{id})
        parts.append(f"adapted: {stats['adaptations']} plan change(s)")
    if stats.get("fastPath") == "fast-path":
        # the short-query fast path served this statement coordinator-
        # local (zero task round-trips)
        parts.append("fast-path")
    if stats.get("resourceGroup"):
        # the admission group that gated this query (server/
        # resource_groups.py; live occupancy: system.runtime.resource_groups)
        parts.append(f"group: {stats['resourceGroup']}")
    if stats.get("deviceCacheHits"):
        # scans served warm from the device table cache (zero transfer)
        parts.append(f"warm scans: {stats['deviceCacheHits']}")
    if stats.get("mvHits"):
        # fresh materialized views substituted into this query's plan
        # (the join/aggregate ran at REFRESH time, not now)
        names = stats.get("mvNames") or ()
        parts.append(("mv: " + ", ".join(names)) if names
                     else f"mv hits: {stats['mvHits']}")
    if stats.get("spooled"):
        # the spooled result protocol served a segment manifest instead
        # of inline rows (worker-direct = the coordinator never touched
        # the result data)
        parts.append(
            f"spooled: {stats.get('resultSegments', 0)} segments "
            f"({stats['spooled']})")
    flows = stats.get("flows") or {}
    if flows.get("drainMbPerS") is not None:
        # client-drain throughput from the flow ledger (result bytes
        # serialized to this client over the drain wall)
        parts.append(f"drain: {flows['drainMbPerS']:g} MB/s")
    if flows.get("stragglers"):
        # straggler verdicts (flow ledger): details on
        # GET /v1/query/{id}/flows or system.runtime.stragglers
        parts.append(f"stragglers: {flows['stragglers']}")
    out = f" [{', '.join(parts)}]" if parts else ""
    tl = stats.get("timeline")
    if tl:
        # the completion-time phase ledger: where the wall went
        from trino_tpu_torch.obs.timeline import summarize

        ledger = summarize(tl, max_phases=4)
        if ledger:
            out += f" [phases: {ledger}]"
    return out


class Console:
    def __init__(self, args):
        self.args = args
        props = {"catalog": args.catalog, "schema": args.schema}
        for item in getattr(args, "session", None) or ():
            name, _, value = item.partition("=")
            props[name.strip()] = value.strip()
        if args.server:
            from trino_tpu_torch.client.remote import StatementClient

            self._client = StatementClient(args.server, props,
                                           fetch_streams=getattr(args, "fetch_streams", 4))
            self._session = None
        else:
            from trino_tpu_torch.client.session import Session

            self._client = None
            self._session = Session(props, device=getattr(args, "device", None))

    def run_statement(self, sql: str) -> int:
        t0 = time.monotonic()
        # live progress while the coordinator reports a non-terminal state
        # (remote runs on a tty only: a progress line inside piped output
        # would corrupt it)
        live = self._client is not None and sys.stderr.isatty()
        progress_len = [0]

        def on_stats(stats):
            if not live or stats.get("state") in ("FINISHED", "FAILED",
                                                  "CANCELED"):
                return
            line = render_progress(stats)
            pad = max(0, progress_len[0] - len(line))
            sys.stderr.write("\r" + line + " " * pad)
            sys.stderr.flush()
            progress_len[0] = len(line)

        try:
            if self._client is not None:
                # pass the progress hook only when rendering it (keeps the
                # call compatible with minimal client stand-ins)
                kwargs = {"on_stats": on_stats} if live else {}
                columns, rows = self._client.execute(sql, **kwargs)
            else:
                result = self._session.execute(sql)
                columns, rows = result.column_names, result.rows
        except Exception as e:  # noqa: BLE001 — console surface
            if live and progress_len[0]:
                sys.stderr.write("\r" + " " * progress_len[0] + "\r")
            print(f"Query failed: {e}", file=sys.stderr)
            return 1
        if live and progress_len[0]:
            sys.stderr.write("\r" + " " * progress_len[0] + "\r")
            sys.stderr.flush()
        print(format_table(columns, rows))
        dt = time.monotonic() - t0
        summary = f"({len(rows)} row{'s' if len(rows) != 1 else ''} in {dt:.2f}s)"
        summary += render_summary(getattr(self._client, "stats", None))
        nseg = getattr(self._client, "spooled_segments", 0)
        if nseg:
            # the spooled protocol's client side: the segment bytes fetched
            # in parallel and the rate they came at
            mb = getattr(self._client, "spooled_bytes", 0) / 1e6
            fetch_s = getattr(self._client, "segment_fetch_s", 0.0)
            rate = f" @ {mb / fetch_s:.0f}MB/s" if fetch_s > 0 else ""
            summary += f" [fetched {nseg} segments, {mb:.1f}MB{rate}]"
        cache = getattr(self._client, "cache_status", None)
        if cache:
            # result-cache disposition from the X-Trino-Tpu-Cache header
            # (remote runs only; embedded sessions have no cache in front)
            summary += f" [cache: {cache}]"
        print(summary)
        return 0

    def repl(self) -> int:
        try:
            import readline  # noqa: F401 — line editing side effect
        except ImportError:
            pass
        print("trino-tpu console — end statements with ';', quit/exit to leave")
        buf: List[str] = []
        while True:
            try:
                prompt = "trino> " if not buf else "    -> "
                line = input(prompt)
            except (EOFError, KeyboardInterrupt):
                print()
                return 0
            if not buf and line.strip().lower() in ("quit", "exit"):
                return 0
            buf.append(line)
            text = "\n".join(buf)
            if text.rstrip().endswith(";"):
                buf = []
                sql = text.rstrip().rstrip(";").strip()
                if sql:
                    self.run_statement(sql)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trino-tpu")
    ap.add_argument("--server", default=None, help="coordinator URL (default: embedded)")
    ap.add_argument("--catalog", default="tpch")
    ap.add_argument("--schema", default="tiny")
    ap.add_argument("--execute", "-e", default=None, help="run one statement and exit")
    ap.add_argument("--fetch-streams", type=int, default=4,
                    help="parallel spooled-segment fetch streams "
                         "(remote servers with spooled_results_enabled)")
    ap.add_argument("--device", default=None,
                    help="torch device of the embedded session (default cuda)")
    ap.add_argument("--session", action="append", default=[], metavar="NAME=VALUE",
                    help="a session property for every statement (repeatable)")
    args = ap.parse_args(argv)
    console = Console(args)
    if args.execute:
        return console.run_statement(args.execute)
    return console.repl()


if __name__ == "__main__":
    sys.exit(main())
