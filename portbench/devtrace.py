"""The traced window: torch.profiler over the CPU and CUDA, read straight
from the profiler's raw events (no per-event tree is built, so a window of a
million launches reads in seconds).

`Recorder` wraps the window. Each call of the entry gets a span of its own
(`portbench.call`), and the port functions a driver names in `TRACE_SPANS`
are wrapped in spans for the length of the window only, so that the host
work open during an idle stretch of the card has a name. `TraceView` is what
the per-layer readers see.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

import yardstick

CALL_SPAN = "portbench.call"
TOP = 10  # entries of each breakdown list


def _wrapped(fn, label: str):
    def inner(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)

    return inner


class Recorder:
    """The profiler around the window, with the driver's `TRACE_SPANS`
    wrapped for its length; `view` reads the events once it has closed."""

    def __init__(self, driver) -> None:
        self.spans: set = set()
        self._saved: List[Tuple[object, str, object, str]] = []
        for mod_name, names in getattr(driver, "TRACE_SPANS", {}).items():
            mod = importlib.import_module(mod_name)
            for name in names:
                fn = getattr(mod, name, None)
                if callable(fn):
                    label = f"{mod_name.split('.', 1)[-1]}.{name}"
                    self._saved.append((mod, name, fn, label))
                    self.spans.add(label)
        self.events = None

    span = staticmethod(record_function)

    def __enter__(self) -> "Recorder":
        for mod, name, fn, label in self._saved:
            setattr(mod, name, _wrapped(fn, label))
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.prof.__exit__(*exc)
        finally:
            for mod, name, fn, _ in self._saved:
                setattr(mod, name, fn)
        if exc[0] is None:
            self.events = raw_events(self.prof)

    def view(self, cell, calls: int) -> "TraceView":
        return TraceView(self.events, self.spans, cell, calls)


def raw_events(prof) -> Tuple[list, list]:
    """(device, host) events as (name, start_ns, end_ns, correlation) and
    (name, start_ns, end_ns, thread, correlation) lists, from the
    profiler's raw results."""
    from torch.autograd import DeviceType

    device, host = [], []
    kin = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    for e in kin.events() if kin is not None else ():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
        else:
            host.append((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(), e.correlation_id()))
    return device, host


def clock_offset(device, host) -> float:
    """How far the card's timestamps lie after the host's: the least time
    from a runtime call (a launch, a copy) to the start of the device event
    it issued, which is at least 0 on one clock. Nought where no pair is
    found."""
    issued = {c: s for n, s, _, _, c in host if c and n.startswith("cuda")}
    deltas = [s - issued[c] for _, s, _, c in device if c in issued]
    return min(deltas) if deltas else 0


class TraceView:
    """The traced window: device intervals, moved onto the host's clock
    (`clock_offset`) and clipped to the window, the calls, the busy time, and
    per call the host tail after its last device event."""

    def __init__(self, events, span_names, cell, calls: int) -> None:
        device, host = events or ([], [])
        device = [d for d in device if d[0] != CALL_SPAN and d[0] not in span_names]
        self.clock_offset_ns = clock_offset(device, host)
        device = [(n, s - self.clock_offset_ns, e - self.clock_offset_ns) for n, s, e, _ in device]
        call_spans = sorted((s, e, t) for n, s, e, t, _ in host if n == CALL_SPAN)
        self.cell = cell
        self.calls = calls
        self.call_spans = [(s, e) for s, e, _ in call_spans]
        if call_spans:
            self.window = (call_spans[0][0], max(e for _, e, _ in call_spans))
            main = call_spans[0][2]
        else:
            self.window, main = (0, 0), None
        w0, w1 = self.window
        self.device = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
        self.window_ns = w1 - w0
        self.busy_ns = yardstick.busy_union((s, e) for _, s, e in self.device)
        self.host = sorted((s, e, n) for n, s, e, t, _ in host if t == main and n != CALL_SPAN and w0 <= s < w1)
        self.span_names = span_names
        self.host_tail_ns = self._tails()

    def _tails(self) -> List[float]:
        """Per call: its end on the host less the end of its last device
        event (calls with no device event are left out)."""
        ends = sorted((s, e) for _, s, e in self.device)
        out, j, last = [], 0, None
        for cs, ce in self.call_spans:
            last = None
            while j < len(ends) and ends[j][0] < ce:
                if ends[j][0] >= cs:
                    last = ends[j][1] if last is None else max(last, ends[j][1])
                j += 1
            if last is not None:
                out.append(max(0.0, ce - last))
        return out

    def device_ms(self, match) -> float:
        return sum(e - s for n, s, e in self.device if match(n)) / 1e6

    def _label(self, stack, t: float) -> str:
        """The host activity open at t: the innermost op, and the port
        function around it where one of the traced ones is open."""
        inner = next((n for s, e, n in reversed(stack) if s <= t <= e), None)
        port = next((n for s, e, n in stack if s <= t <= e and n in self.span_names), None)
        in_call = any(s <= t <= e for s, e in self.call_spans)
        if inner is None:
            return "host Python inside an entry call" if in_call else "harness between calls"
        if port and port != inner:
            return f"{inner} in {port}"
        return inner

    def breakdown(self) -> Optional[dict]:
        if not self.device:
            return None
        by_name: Dict[str, float] = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
        gaps = yardstick.idle_gaps(((s, e) for _, s, e in self.device), self.window)
        # the host op open at each gap's middle, by a sweep over the nested
        # spans of the calling thread
        idle: Dict[str, float] = {}
        stack: List[Tuple[float, float, str]] = []
        j = 0
        for a, b in sorted(gaps):
            t = (a + b) / 2
            while j < len(self.host) and self.host[j][0] <= t:
                stack.append(self.host[j])
                j += 1
            stack = [x for x in stack if x[1] >= t]
            label = self._label(stack, t)
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
        top = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
        return {"device_ops": top(by_name), "idle_gaps": top(idle)}
