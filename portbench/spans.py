"""The program's own spans in a traced window, against the card's idle time.

The port opens a profiler range for each of its `utils.profiling.timed`
spans while a profiler records; `TraceView.host` holds them with the
calling thread's other host events, on the host's clock, and
`TraceView.device` holds the card's intervals moved onto that clock. A span
is read by its name: its ranges are merged first, so nested or repeated
ranges of one name count once. Every reader here returns None where the
window has no device event or no range of the name (a program that opens no
such span), so the metric is left out.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import yardstick

Interval = Tuple[float, float]


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of (start, end) intervals as disjoint, sorted intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


def overlap(a: List[Interval], b: List[Interval]) -> float:
    """The length of the intersection of two lists of disjoint, sorted
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_ranges(view, name: str) -> Optional[List[Interval]]:
    """The merged ranges of the span `name` in the window, or None where the
    window has no device event or no such range."""
    if not view.device or view.calls <= 0:
        return None
    ranges = merged((s, e) for s, e, n in view.host if n == name)
    return ranges or None


def idle_ms_per_call(view, name: str) -> Optional[float]:
    """Milliseconds a call that the card is idle while `name` is open."""
    ranges = span_ranges(view, name)
    if ranges is None:
        return None
    gaps = yardstick.idle_gaps(((s, e) for _, s, e in view.device), view.window)
    return overlap(ranges, merged(gaps)) / 1e6 / view.calls


def host_ms_per_call(view, name: str) -> Optional[float]:
    """Host milliseconds a call inside `name`."""
    ranges = span_ranges(view, name)
    if ranges is None:
        return None
    return sum(e - s for s, e in ranges) / 1e6 / view.calls
