"""The TPC-H family's control: the plain reference computed with every decimal
in float64, the nearest precision below the exact decimals TPC-H states, put
in the program's place and judged by the same comparison.

    python portbench/control.py --config tpch-sf1 --seeds 2026 101 102 [--device cuda]

``--seeds`` draw the substitution sets (a cell's traffic file names its own,
``parameter_seed``). Prints one JSON line a set: the answers of the 22 queries
that the comparison refuses (the number each run's ``mismatched_answers`` is
held to, whose limit is 0). The benchmark's own runs do not run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_readings(sf: float, seeds, device: str):
    from portbench.queries.tpch import params as P
    from portbench.reference.compare import same_answer
    from portbench.reference.tables import Tables
    from portbench.reference.tpch import answers

    tables = Tables(sf, device)
    for seed in seeds:
        prm = P.draw(seed, sf)
        t0 = time.perf_counter()
        exact = answers(tables, prm, exact=True)
        t1 = time.perf_counter()
        low = answers(tables, prm, exact=False)
        refused = [q for q in exact if not same_answer(q, low[q], exact[q])]
        yield {"seed": seed, "mismatched_answers": len(refused), "queries": refused,
               "exact_s": t1 - t0, "float64_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    config = json.loads((ROOT / "portbench" / "configs" / f"{args.config}.json").read_text())
    for reading in control_readings(float(config["scale_factor"]), args.seeds, args.device):
        print(json.dumps({"config": args.config, **reading}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
