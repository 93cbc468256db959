"""Lightweight call metrics for the compute engine, and a device trace.

Every MSM records op counts and wall time into a process-global registry;
`metrics_report()` summarizes, and `collect()` scopes measurement to a region
(the JAX package's `utils.profiling`, same names and semantics). Wall time
here is host time around the call, which for a GPU call includes whatever
synchronisation the call itself does (the MSM ends in a readback, so its
time is complete).

`timed(name)` is the one span primitive. It always records into the
registry; while a `torch.profiler` is recording it also opens a
`record_function(name)` around the block, so the span lands in the same
trace as the kernels, on the profiler's host clock. With no profiler running
it reads one flag and never enters `record_function`, which costs
microseconds a span even with nothing recording.

`device_trace(logdir)` is the counterpart of the JAX package's hook of the
same name: a `torch.profiler` trace of a region, over the CPU and, where a
card is present, over CUDA, written into `logdir` as a Chrome trace (open it
in chrome://tracing or Perfetto). `trace_summary` reads the kernels' time,
the device's busy share of the traced window and the launches by name from
the same profile.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from torch.autograd import profiler as _profiler


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

    def record(
        self, name: str, seconds: float, items: int = 0, point_ops: int = 0
    ) -> None:
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


def metrics_report() -> Dict[str, dict]:
    return _registry.report()


class timed:
    """`with timed(name, items, point_ops):` records the block's host seconds
    under `name`, and is a profiler span of that name while a profiler
    records (`torch.autograd.profiler._is_profiler_enabled`, the flag the
    profiler sets on start and clears on stop)."""

    __slots__ = ("name", "items", "point_ops", "t0", "span")

    def __init__(self, name: str, items: int = 0, point_ops: int = 0) -> None:
        self.name = name
        self.items = items
        self.point_ops = point_ops
        self.span = None

    def __enter__(self) -> None:
        if _profiler._is_profiler_enabled:
            self.span = _profiler.record_function(self.name)
            self.span.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        _registry.record(self.name, time.perf_counter() - self.t0, self.items, self.point_ops)
        if self.span is not None:
            self.span.__exit__(*exc)


@contextlib.contextmanager
def collect() -> Iterator[MetricsRegistry]:
    """Scope metrics to a region: resets, yields the registry, leaves the
    collected stats in place for inspection."""
    _registry.reset()
    yield _registry


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    """`torch.profiler` trace around a region: the CPU, and CUDA where a card
    is present. Yields the profile (for `trace_summary`); on exit writes it
    to `logdir` as `trace_<pid>_<ns>.json`, a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def busy_summary(device: Sequence[Tuple[str, float, float]], window: Tuple[float, float]) -> dict:
    """Device intervals (name, start, end) in microseconds inside a traced
    window (start, end) -> the summed device time, the busy share of the
    window (the union of the intervals: overlapping work counts once), and
    the launches and summed milliseconds by name."""
    spans: List[Tuple[float, float]] = sorted((s, e) for _, s, e in device)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name: Dict[str, dict] = {}
    for name, s, e in device:
        entry = by_name.setdefault(name, {"launches": 0, "ms": 0.0})
        entry["launches"] += 1
        entry["ms"] += (e - s) / 1e3
    span = window[1] - window[0]
    return {
        "device_ms": sum(e - s for _, s, e in device) / 1e3,
        "busy_ms": busy / 1e3,
        "window_ms": span / 1e3,
        "busy_share": busy / span if span > 0 else None,
        "by_name": dict(sorted(by_name.items())),
    }


def trace_summary(prof, wall_s: Optional[float] = None) -> dict:
    """`busy_summary` of a finished `device_trace` profile: the events that
    ran on the card (kernels, copies, fills) against a window of `wall_s`
    seconds (the caller's host clock around the traced region: pure Python
    leaves no event) or, without it, the span from the first to the last
    event of the trace."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    device = [(e.name, e.time_range.start, e.time_range.end) for e in events if e.device_type == DeviceType.CUDA]
    if not events:
        return busy_summary([], (0.0, wall_s * 1e6 if wall_s else 0.0))
    start = min(e.time_range.start for e in events)
    end = start + wall_s * 1e6 if wall_s else max(e.time_range.end for e in events)
    return busy_summary(device, (start, end))
