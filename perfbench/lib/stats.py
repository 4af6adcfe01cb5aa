"""The end-to-end arithmetic, over all the steps and all the time of a
window."""

import statistics


def rate(units: int, seconds: float) -> float:
    """Units completed in the window over the window's seconds."""
    return units / seconds


def quartiles(values) -> list:
    """The first quartile, the median and the third (Python's default
    method), of a window's step times."""
    values = list(values)
    return statistics.quantiles(values, n=4) if len(values) > 1 else values * 3


def p90(values) -> float:
    """The 90th percentile of all values (statistics' inclusive method:
    linear between the order statistics, no extrapolation)."""
    values = list(values)
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]

