"""The readers of the program's own spans (`spans.py` and the four metrics
that use it) on a synthetic traced window: known spans and device intervals,
nested and repeated ranges of one name, a span the card is busy through, a
span on another thread, and windows with no span or no device event."""
from __future__ import annotations

import importlib.util

import devtrace
import spans
from conftest import HERE

MS = 1_000_000  # ns
NEW = ("msm_prep_idle_ms", "msm_enqueue_idle_ms", "msm_readback_wait_ms", "msm_combine_ms")


def reader(name):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    n, c = 367_733, 15


def _host(*spans_ms, thread=7):
    return [(n, s * MS, e * MS, thread, 0) for n, s, e in spans_ms]


CALLS = _host(("portbench.call", 0, 100), ("portbench.call", 120, 200))
SPANS = _host(
    ("msm.pippenger", 0, 100), ("msm.pippenger", 120, 200),
    ("msm.pippenger.prep", 2, 12),
    ("msm.pippenger.prep", 122, 130), ("msm.pippenger.prep", 124, 128),  # nested in itself
    ("msm.pippenger.windows", 12, 60),
    ("msm.window.sort", 15, 20),  # the card busy throughout
    ("msm.pippenger.windows", 130, 170), ("msm.pippenger.windows", 135, 145),
    ("msm.pippenger.windows", 172, 176),  # repeated, the card busy throughout
    ("msm.readback", 60, 75), ("msm.readback", 176, 180),
    ("msm.combine", 75, 98), ("msm.combine", 180, 198),
) + _host(("msm.combine", 100, 190), thread=8)  # another thread: not the caller's
# the card: busy 5-10, 15-25, 30-70, 125-140, 150-179; idle 0-5, 10-15, 25-30,
# 70-125, 140-150, 179-200
DEVICE = [(n, s * MS, e * MS, 0) for n, s, e in (
    ("void curdle::point_kernel<0, 1>", 5, 10), ("CatArrayBatchedCopy", 15, 25),
    ("void curdle::point_kernel<0, 1>", 30, 70), ("direct_copy", 125, 140), ("Memcpy DtoH", 150, 179))]


def _view(device, host, calls=2):
    return devtrace.TraceView((device, host), set(), Cell, calls)


def test_merged_and_overlap():
    assert spans.merged([(5, 9), (0, 2), (1, 3), (3, 4), (6, 7), (8, 8)]) == [(0, 4), (5, 9)]
    assert spans.merged([]) == []
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25), (29, 40)]) == 5 + 5 + 1
    assert spans.overlap([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap([], [(0, 1)]) == 0


def test_the_four_readers_on_a_synthetic_window():
    v = _view(DEVICE, CALLS + SPANS)
    assert v.window == (0, 200 * MS) and v.clock_offset_ns == 0
    got = {name: reader(name)(v) for name in NEW}
    assert got == {
        # prep 2-12 meets the gaps at 2-5 and 10-12; 122-130 (the nested range once) at 122-125
        "msm_prep_idle_ms": (3 + 2 + 3) / 2,
        # 12-60 meets 12-15 and 25-30; 130-170 (one range with its nested one) meets 140-150;
        # 172-176 lies in the card's busy 150-179
        "msm_enqueue_idle_ms": (3 + 5 + 10) / 2,
        "msm_readback_wait_ms": (15 + 4) / 2,
        # the caller's two ranges; the other thread's 100-190 is not counted
        "msm_combine_ms": (23 + 18) / 2,
    }
    assert spans.idle_ms_per_call(v, "msm.window.sort") == 0.0
    assert spans.idle_ms_per_call(v, "msm.pippenger") == (5 + 5 + 5 + 30 + 5 + 10 + 21) / 2


def test_the_readers_read_nothing_without_spans_or_a_card():
    no_spans = _view(DEVICE, CALLS)
    no_card = _view([], CALLS + SPANS)
    empty = _view([], [])
    for name in NEW:
        for v in (no_spans, no_card, empty):
            assert reader(name)(v) is None, name
    assert spans.host_ms_per_call(no_spans, "msm.combine") is None


def test_the_four_metrics_are_declared(manifest):
    """Found by name wherever they stand in `per_layer`; a cell on another
    engine may report them too (`msm.readback` and `msm.combine` are spans
    every engine opens)."""
    bench, _ = manifest
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"]) == ("ms", "lower", "device_trace")
        assert "msm_range_sync_1024" in m["workloads"]
    assert [entries[n]["layer"] for n in NEW] == ["host enqueue"] * 2 + ["readback and combine"] * 2
    assert [entries[n]["moves"] for n in NEW] == ["msm_points_per_s"] * 2 + ["msm_p90_ms"] * 2
