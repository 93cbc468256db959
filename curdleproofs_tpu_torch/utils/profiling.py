"""Lightweight call metrics for the compute engine.

Every MSM records op counts and wall time into a process-global registry;
`metrics().report()` summarizes. Wall time here is host time around the call,
which for a GPU call includes whatever synchronisation the call itself does
(the MSM ends in a readback, so its time is complete).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator


@dataclass
class _Stat:
    calls: int = 0
    total_time_s: float = 0.0
    total_items: int = 0  # domain-specific size (MSM n, vector width, ...)
    total_point_ops: int = 0  # estimated group operations executed

    def as_dict(self) -> dict:
        return {
            "calls": self.calls,
            "total_time_s": round(self.total_time_s, 4),
            "total_items": self.total_items,
            "total_point_ops": self.total_point_ops,
            "point_ops_per_s": (
                round(self.total_point_ops / self.total_time_s)
                if self.total_time_s > 0
                else None
            ),
        }


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats: Dict[str, _Stat] = defaultdict(_Stat)
        self.enabled = True

    def record(
        self, name: str, seconds: float, items: int = 0, point_ops: int = 0
    ) -> None:
        if not self.enabled:
            return
        with self._lock:
            s = self._stats[name]
            s.calls += 1
            s.total_time_s += seconds
            s.total_items += items
            s.total_point_ops += point_ops

    def report(self) -> Dict[str, dict]:
        with self._lock:
            return {k: v.as_dict() for k, v in sorted(self._stats.items())}

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


_registry = MetricsRegistry()


def metrics() -> MetricsRegistry:
    return _registry


@contextlib.contextmanager
def timed(name: str, items: int = 0, point_ops: int = 0) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _registry.record(name, time.perf_counter() - t0, items, point_ops)
