"""The benchmark's one traffic generator: what each client of a cell sends,
read from the cell's traffic file (``workloads/<cell>.json``).

Keys of a traffic file (all read here or by the harness; an unknown key is
refused):

``driver``           the entry the queries go through, ``drivers/<driver>.py``
``queries``          the benchmark's query numbers; a stream sends them in
                     this order when ``order`` is ``"given"``
``order``            ``"given"``, or ``"seeded"``: each stream sends its own
                     permutation of ``queries``, drawn from the run's seed
``parameters``       ``"fixed"``: one substitution set drawn from
                     ``parameter_seed``, the same work in every run;
                     ``"per_stream"``: one set a stream, drawn from the run's
                     seed; ``"per_query"``: a fresh set for every query sent
``parameter_seed``   the seed of the ``"fixed"`` set
``clients``          how many clients send at once
``arrivals``         ``"closed"``: each client is a stream that sends its next
                     query when its last one has answered; a number: queries
                     a second, arriving at exponential gaps drawn from the
                     seed as one stream, each taken by the first free client
                     (its latency counts the wait)
``warmup_passes``    passes of the queries in set-up
``profiled_passes``  passes of the queries under torch.profiler (``--trace 1``)
``sample_passes``, ``sample_span``
                     besides each instance's last answer and every answer of
                     a stream's first pass, the answers of ``sample_passes``
                     passes drawn from 1 to ``sample_span`` are kept and checked
``compare_at_most``  optional: where the window ran more distinct instances
                     (query and parameters) than this, the check compares a
                     sample of this many, drawn from the seed

An instance is ``(query, set)``: the query's number and the name of its
substitution set; every instance is rendered once.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

KEYS = {"driver", "queries", "order", "parameters", "parameter_seed", "clients", "arrivals",
        "warmup_passes", "profiled_passes", "sample_passes", "sample_span", "compare_at_most"}
OPTIONAL = {"parameter_seed", "compare_at_most"}

Key = Tuple[int, str]


def derive(*words) -> int:
    """A 63-bit seed from a run's seed and the words that name one draw."""
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class Traffic:
    def __init__(self, spec: dict, seed: int, scale_factor: float, params_module):
        unknown = set(spec) - KEYS
        missing = KEYS - OPTIONAL - set(spec)
        if unknown or missing:
            raise ValueError(f"traffic file: unknown keys {sorted(unknown)}, "
                             f"missing {sorted(missing)}")
        if spec["order"] not in ("given", "seeded"):
            raise ValueError(f"order {spec['order']!r}: 'given' or 'seeded'")
        if spec["parameters"] not in ("fixed", "per_stream", "per_query"):
            raise ValueError(f"parameters {spec['parameters']!r}")
        if spec["parameters"] == "fixed" and "parameter_seed" not in spec:
            raise ValueError("fixed parameters need a parameter_seed")
        if spec["arrivals"] != "closed" and not float(spec["arrivals"]) > 0:
            raise ValueError(f"arrivals {spec['arrivals']!r}: 'closed' or a rate above 0")
        self.spec = spec
        self.seed = int(seed)
        self.sf = scale_factor
        self.P = params_module
        self.queries = [int(q) for q in spec["queries"]]
        self.n = len(self.queries)
        self.clients = int(spec["clients"])
        self.closed = spec["arrivals"] == "closed"
        self.rate = None if self.closed else float(spec["arrivals"])
        self.instances: Dict[Key, Tuple[int, dict]] = {}
        self.sql: Dict[Key, str] = {}
        self._sets: Dict[str, dict] = {}
        self._orders: Dict[object, List[int]] = {}

    # ------------------------------------------------------------ instances
    def _instance(self, q: int, name: str, seed: int) -> Key:
        key = (q, name)
        if key not in self.sql:
            if name not in self._sets:
                self._sets[name] = self.P.draw(seed, self.sf)
            prm = self._sets[name][q]
            self.instances[key] = (q, prm)
            self.sql[key] = self.P.render(q, prm)
        return key

    def order(self, stream) -> List[int]:
        """The queries in the order ``stream`` sends them (a client's
        number, or ``"profile"``, which sends as stream 0)."""
        s = stream if isinstance(stream, int) else 0
        if s not in self._orders:
            if self.spec["order"] == "given":
                self._orders[s] = list(self.queries)
            else:
                rng = np.random.default_rng([self.seed, 1, s])
                self._orders[s] = [self.queries[j] for j in rng.permutation(self.n)]
        return self._orders[s]

    def key(self, stream, i: int) -> Key:
        """The instance that ``stream`` sends at its position ``i``."""
        q = self.order(stream)[i % self.n]
        mode = self.spec["parameters"]
        if mode == "fixed":
            return self._instance(q, "fixed", int(self.spec["parameter_seed"]))
        s = stream if isinstance(stream, int) else 0
        if mode == "per_stream":
            return self._instance(q, f"stream{s}", derive(self.seed, 3, s))
        if isinstance(stream, int):
            return self._instance(q, f"{stream}.{i}", derive(self.seed, 4, stream, i))
        return self._instance(q, f"profile.{i}", derive(self.seed, 6, i))

    def setup_keys(self, client: int) -> List[Key]:
        """What set-up runs through ``client``, in query order: its stream's
        instances, or, where every query has fresh parameters, a set of its
        own that the window never sends."""
        if self.spec["parameters"] == "per_query":
            return [self._instance(q, f"warmup{client}", derive(self.seed, 5, client))
                    for q in sorted(self.queries)]
        stream = client if self.closed else 0
        return sorted({self.key(stream, i) for i in range(self.n)})

    def profile_keys(self, passes: int) -> List[Key]:
        """The traced passes: stream 0's order, from one client."""
        return [self.key("profile", i) for i in range(passes * self.n)]

    # --------------------------------------------------------------- sample
    def sample_passes(self) -> set:
        rng = np.random.default_rng([self.seed, 2])
        return {0} | {int(x) for x in rng.integers(1, 1 + int(self.spec["sample_span"]),
                                                   size=int(self.spec["sample_passes"]))}

    def compared(self, keys) -> set:
        """The instances the check compares: all, or a sample drawn from the
        seed of ``compare_at_most``."""
        keys = sorted(set(keys), key=lambda k: (k[0], k[1]))
        cap = self.spec.get("compare_at_most")
        if cap is None or len(keys) <= int(cap):
            return set(keys)
        rng = np.random.default_rng([self.seed, 7])
        return {keys[j] for j in rng.choice(len(keys), size=int(cap), replace=False)}

    def arrival_gaps(self):
        """Open arrivals: the gaps between queries, drawn from the seed."""
        rng = np.random.default_rng([self.seed, 8])
        while True:
            yield float(rng.exponential(1.0 / self.rate))
