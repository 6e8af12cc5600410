"""Host-side predicate helpers: the port's copy of ``domain_mask`` from
trino_tpu/exec/host_eval.py (the engine-side application of a dynamic
filter to scanned host columns). A NaN among a domain's values matches no
row; the JAX package's ``domain_mask`` calls ``int()`` on the largest
value, which raises when that is NaN."""
from __future__ import annotations

import numpy as np

from trino_tpu_torch.connector.predicate import Domain


def domain_mask(dom: Domain, values: np.ndarray, nulls=None) -> np.ndarray:
    """Vectorized Domain.contains over a host column."""
    if dom.values is not None:
        from trino_tpu_torch.connector.predicate import sorted_values_array

        sa = sorted_values_array(dom)
        if sa.dtype.kind == "f":
            sa = sa[~np.isnan(sa)]  # NaN equals nothing, not even NaN
        values = np.asarray(values)
        if len(sa) == 0:
            m = np.zeros(len(values), dtype=bool)
        elif sa.dtype.kind in "iu" and values.dtype.kind in "iu" \
                and int(sa[-1]) - int(sa[0]) + 1 <= max(8 * len(values), 1 << 22):
            # dense-span set: a boolean lookup table turns membership
            # into one bounded gather; cached on the Domain, which is
            # applied to every split of a scan
            lo, hi = int(sa[0]), int(sa[-1])
            cached = getattr(dom, "values_lut", None)
            if cached is not None and cached[0] == lo:
                lut = cached[1]
            else:
                lut = np.zeros(hi - lo + 1, dtype=bool)
                lut[sa.astype(np.int64) - lo] = True
                object.__setattr__(dom, "values_lut", (lo, lut))
            inb = (values >= lo) & (values <= hi)
            idx = np.where(inb, values.astype(np.int64) - lo, 0)
            m = inb & lut[idx]
        else:
            idx = np.clip(np.searchsorted(sa, values), 0, len(sa) - 1)
            m = sa[idx] == values
    else:
        m = np.ones(len(values), dtype=bool)
        if dom.low is not None:
            m &= values >= dom.low if dom.low_inclusive else values > dom.low
        if dom.high is not None:
            m &= values <= dom.high if dom.high_inclusive else values < dom.high
    if nulls is not None:
        m = np.where(np.asarray(nulls), dom.null_allowed, m)
    return m
