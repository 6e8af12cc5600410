"""Device ops: the share of the bandwidth roofline that the profiled
queries' kernels reach.

The least time of a query is the bytes of every column its SQL reads (rows
times the stored width, each column once) over the card's peak bandwidth,
both from the frozen table of the configuration's benchmark,
``bytes/<benchmark>.json``. The share is the sum of the profiled queries'
least times over the kernel time the device trace shows for them, in
percent."""
import json
from pathlib import Path

TABLES = Path(__file__).resolve().parent.parent / "bytes"


def read(run):
    p = run.profile
    path = TABLES / f"{run.config['benchmark']}.json"
    if p is None or not p.queries or p.kernel_s <= 0 or not path.exists():
        return None
    table = json.loads(path.read_text())
    sf = str(run.config["scale_factor"])
    if sf not in table["rows"]:
        return None
    least = sum(table["queries"][str(q)]["bytes"][sf] for q in p.queries) \
        / table["peak_bytes_per_s"]
    return 100.0 * least / p.kernel_s
