"""The ``tpcds`` family's controls: the plain reference computed with its
decimals in a precision below the exact decimals the configuration states,
put in the program's place and judged by the same comparison.

    python portbench/control_tpcds.py --config tpcds-sf10 --seeds 2026 101 102 [--device cuda]

Two controls a substitution set. ``float32`` keeps every decimal and every
sum of decimals in float32: the comparison has to refuse it. ``float64`` is
the nearest precision below exact: the six answers are sums of at most 29M
cent values and one quotient, which float64 carries exactly, so it reads as
the exact reference does and shows what the comparison cannot tell apart.

``--seeds`` draw the substitution sets (a cell's traffic file names its own,
``parameter_seed``). Prints one JSON line a set: for each control the
answers the comparison refuses (the number each run's ``mismatched_answers``
is held to, whose limit is 0), the rows of each exact answer, and q95's
exact answer (orders, shipping cost, net profit). The benchmark's own runs
do not run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def float32_arith():
    """The reference's decimal arithmetic with values and sums in float32."""
    import torch

    from portbench.reference.arith import Arith

    class Float32(Arith):
        def __init__(self):
            super().__init__(exact=False)

        def col(self, t, s):
            return t.to(torch.float32) / (10 ** s), s

    return Float32()


def control_reading(tables, prm) -> dict:
    """Both controls against the exact reference over ``tables`` under the
    substitution set ``prm``."""
    from portbench.queries.tpcds import params as P
    from portbench.reference.arith import Arith
    from portbench.reference.tpcds import Q, same_answer

    def run(arith):
        q = Q(tables, arith)
        return {n: getattr(q, f"q{n}")(prm[n]) for n in P.QUERY_IDS}

    t0 = time.perf_counter()
    exact = run(Arith(True))
    reading = {"rows": {q: len(r) for q, r in exact.items()}, "q95": exact[95][0],
               "exact_s": time.perf_counter() - t0}
    for name, arith in (("float32", float32_arith()), ("float64", Arith(False))):
        low = run(arith)
        refused = [q for q in exact if not same_answer(q, low[q], exact[q])]
        reading[name] = {"mismatched_answers": len(refused), "queries": refused}
    return reading


def control_readings(sf: float, seeds, device: str):
    from portbench.queries.tpcds import params as P
    from portbench.reference.tpcds import DsTables

    tables = DsTables(sf, device)
    for seed in seeds:
        yield {"seed": seed, **control_reading(tables, P.draw(seed, sf))}


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
