"""Window arithmetic: rates over all the work and all the time of a window,
and percentiles over all of its requests."""

from __future__ import annotations

import math


def rate(count: int, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return count / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of all the values, interpolated
    linearly between the two nearest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

