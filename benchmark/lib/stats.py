"""Tails and spreads, by Python's ``statistics`` (inclusive quantiles:
linear interpolation between the samples)."""

from __future__ import annotations

import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: int) -> float:
    """The ``q``-th percentile of all ``values``."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles over the
    median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
