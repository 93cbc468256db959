"""The spans of `utils.profiling.timed` inside the sort-based Pippenger
engines: with a `torch.profiler` recording, each span is a profiler range of
its name, nested as the code nests (`msm.pippenger` > `.prep`, `.windows` >
`msm.window.*` once a chunk; `msm.readback`, `msm.combine` once a call); with
no profiler, `timed` never enters `record_function` and still records into
the registry. In the streaming engine, `msm.stream.upload` once a chunk and
once for the GLV sign row, inside `msm.stream.device`, and `msm.stream.redo`
only after a flagged collision. On the CPU, against the host oracle; no JAX."""
import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from curdleproofs_tpu_torch.curve import G1, msm_host
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.ops import msm as tmsm
from curdleproofs_tpu_torch.ops import stream_scan as tstream
from curdleproofs_tpu_torch.ops.fieldspec import from_reference, ints_to_limbs
from curdleproofs_tpu_torch.utils import profiling

torch.set_num_threads(1)

N, C, WB = 24, 4, 24  # 32 lanes after the pad, W = 64 windows: chunks of 24, 24 and 16
CHUNKS = 3
CALL_SPANS = ("msm.pippenger.prep", "msm.pippenger.windows", "msm.readback", "msm.combine")
CHUNK_SPANS = ("msm.window.sort", "msm.window.gather", "msm.window.scan", "msm.window.reduce")


@pytest.fixture(scope="module")
def inputs():
    rng = random.Random(0x5A17)
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(N)]
    scs = [Fr(rng.randrange(FR_MOD)) for _ in range(N)]
    pts[3] = G1.identity()
    scs[5] = Fr(0)
    limbs = np.asarray(ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32)
    return pts, scs, tog.pack_points(pts, "cpu"), limbs


def _pippenger(inputs):
    _, _, tp, limbs = inputs
    return tmsm.msm_pippenger(tp, from_reference(limbs, "cpu"), c=C, window_batch=WB)


def _hostsort(inputs):
    _, _, tp, limbs = inputs
    return tmsm.msm_pippenger_hostsort(tp, limbs, c=C, window_batch=WB)


def _ranges(prof, keep=lambda name: name.startswith("msm.")):
    """The profiler's ranges of the port's spans, by name: [(start, end)] in
    ns, from its raw events (a plain call is most of a million aten ops, too
    many to build `prof.events()` from in a test)."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if keep(name):
            out.setdefault(name, []).append((e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _within(inner, outer) -> bool:
    return all(any(os <= s and e <= oe for os, oe in outer) for s, e in inner)


def test_pippenger_spans_nest_in_the_trace(inputs):
    pts, scs, _, _ = inputs
    calls = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [_pippenger(inputs) for _ in range(calls)]
    want = msm_host(pts, scs)
    assert got == [want] * calls
    r = _ranges(prof)
    assert len(r["msm.pippenger"]) == calls
    for name in CALL_SPANS:
        assert len(r[name]) == calls, name
        assert _within(r[name], r["msm.pippenger"]), name
    for name in CHUNK_SPANS:
        assert len(r[name]) == calls * CHUNKS, name
        assert _within(r[name], r["msm.pippenger.windows"]), name
    # inside each chunk the steps run in order: sort, gather, scan, reduce
    steps = sorted((s, n) for n in CHUNK_SPANS for s, _ in r[n])
    assert [n for _, n in steps] == list(CHUNK_SPANS) * (calls * CHUNKS)
    # the call's own steps in order, none overlapping the next
    order = sorted((s, e, n) for n in CALL_SPANS for s, e in r[n])
    assert [n for _, _, n in order] == list(CALL_SPANS) * calls
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))


def test_hostsort_shares_the_window_and_combine_spans(inputs):
    pts, scs, _, _ = inputs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = _hostsort(inputs)
    assert got == msm_host(pts, scs)
    r = _ranges(prof)
    for name in CHUNK_SPANS[1:]:
        assert len(r[name]) == CHUNKS and _within(r[name], r["msm.hostsort"]), name
    for name in ("msm.readback", "msm.combine"):
        assert len(r[name]) == 1 and _within(r[name], r["msm.hostsort"]), name
    assert not set(r) & {"msm.window.sort", "msm.pippenger.prep", "msm.pippenger.windows"}


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler running")


def test_no_profiler_no_record_function(inputs, monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    pts, scs, _, _ = inputs
    with profiling.collect():
        assert _pippenger(inputs) == msm_host(pts, scs)
        rep = profiling.metrics_report()
    assert rep["msm.pippenger"]["calls"] == 1 and rep["msm.pippenger"]["total_items"] == N
    for name in CALL_SPANS:
        assert rep[name]["calls"] == 1, name
    for name in CHUNK_SPANS:
        assert rep[name]["calls"] == CHUNKS, name


@pytest.mark.parametrize("profiled", [False, True])
def test_timed_records_and_closes_its_span_on_an_error(profiled, monkeypatch):
    if not profiled:
        monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)

    def body():
        with profiling.collect():
            with pytest.raises(ValueError, match="inside"):
                with profiling.timed("span.error", items=3, point_ops=5):
                    raise ValueError("inside")
            with profiling.timed("span.after"):
                pass
            return profiling.metrics_report()

    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            rep = body()
        r = _ranges(prof, keep=lambda name: name.startswith("span."))
        assert len(r["span.error"]) == len(r["span.after"]) == 1
        assert r["span.error"][0][1] <= r["span.after"][0][0]
    else:
        rep = body()
    assert rep["span.error"]["calls"] == 1 and rep["span.error"]["total_items"] == 3
    assert rep["span.error"]["total_point_ops"] == 5 and rep["span.after"]["calls"] == 1
    assert not hasattr(profiling.metrics(), "enabled")


STREAM_W = 33  # pick_window(32) = 4: the GLV halves' 130 bits in 33 windows
STREAM_BATCH = 12  # chunks of 12, 12 and 9 windows


def _open_spans(monkeypatch, name):
    """Each time the span `name` opens in `ops.msm`, the set of its spans
    open around it (a stand-in for `timed` that keeps the nesting and
    delegates to the real one)."""
    real, stack, seen = tmsm.timed, [], []

    class logged:
        def __init__(self, span, *args, **kwargs):
            self.span, self.inner = span, real(span, *args, **kwargs)

        def __enter__(self):
            if self.span == name:
                seen.append(frozenset(stack))
            stack.append(self.span)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            stack.pop()
            return self.inner.__exit__(*exc)

    monkeypatch.setattr(tmsm, "timed", logged)
    return seen


@pytest.mark.parametrize("flagged", [False, True], ids=["clean", "flagged"])
def test_stream_upload_once_a_chunk_and_redo_only_when_flagged(inputs, monkeypatch, flagged):
    """The selection scan's run uploads the sign row and then each chunk's
    tables in a span of their own, inside `msm.stream.device`; a collision
    flag (forced here) sends the call to the redo, whose own uploads (one
    chunk at its default batch) lie inside `msm.stream.redo`."""
    pts, scs, tp, limbs = inputs
    monkeypatch.setattr(tmsm, "SEL_MIN_N", 256)
    monkeypatch.setattr(tstream, "_LANES", 8)
    scan_sel = tstream.scan_records_sel

    def flag_every_window(*args, **kwargs):
        bsel, totals, flags = scan_sel(*args, **kwargs)
        return bsel, totals, torch.ones_like(flags)

    if flagged:
        monkeypatch.setattr(tstream, "scan_records_sel", flag_every_window)
    uploads = _open_spans(monkeypatch, "msm.stream.upload")
    with profiling.collect():
        got = tmsm.msm_pippenger_stream(tp, limbs, window_batch=STREAM_BATCH)
        rep = profiling.metrics_report()
    assert got == msm_host(pts, scs)
    chunks = -(-STREAM_W // STREAM_BATCH)
    assert all("msm.stream.device" in around for around in uploads)
    in_redo = sum("msm.stream.redo" in around for around in uploads)
    assert len(uploads) - in_redo == chunks + 1
    assert rep["msm.stream.upload"]["calls"] == len(uploads)
    if flagged:
        assert rep["msm.stream.redo"]["calls"] == 1 and in_redo == 1 + 1
    else:
        assert "msm.stream.redo" not in rep and in_redo == 0
