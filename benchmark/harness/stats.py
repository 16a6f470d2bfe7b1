"""Percentiles and rates over all the requests of a window.

A request that failed or never finished counts as missing: it enters a
latency percentile as infinitely late, so a tail that reaches it reads
``inf`` (a run with any such request is not correct in any case).
"""

from __future__ import annotations

import math

MISSING = math.inf


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0..100) of ``values``, by linear interpolation
    between the closest ranks (numpy's default), ``inf`` for missing ones."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == MISSING:
        return MISSING if pos > lo or xs[lo] == MISSING else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttft_ms(reqs: list) -> list:
    """Each request's time to first token, from its due time, in ms."""
    return [1e3 * (r.stamps[0] - r.due) if r.done and r.stamps else MISSING
            for r in reqs]


def tpot_ms(reqs: list) -> list:
    """Each request's time per output token after the first: (last token -
    first token) / (n - 1), in ms."""
    out = []
    for r in reqs:
        if not (r.done and len(r.stamps) >= 2):
            out.append(MISSING)
            continue
        out.append(1e3 * (r.stamps[-1] - r.stamps[0]) / (len(r.stamps) - 1))
    return out


def tokens_in(reqs: list, t0: float, t1: float) -> int:
    """Output tokens delivered in [t0, t1), over every request."""
    return sum(sum(1 for s in r.stamps if t0 <= s < t1) for r in reqs)


def spread(values: list) -> float:
    """The distance between the first and the third quartile as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    from statistics import quantiles
    q1, q2, q3 = quantiles(values, n=4)
    return (q3 - q1) / q2
