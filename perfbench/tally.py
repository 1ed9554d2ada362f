"""Rates, times per step and tails over all the work of a window."""

from __future__ import annotations

import math

__all__ = ["percentile", "rate", "per_step"]


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all
    ``values``: the smallest value with at least ``q`` percent of them at
    or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def rate(amount: float, seconds: float) -> float:
    """All the work of a window over all its time."""
    return amount / seconds


def per_step(total_seconds: float, steps: int) -> float:
    """All the time of some steps over their number."""
    return total_seconds / steps

