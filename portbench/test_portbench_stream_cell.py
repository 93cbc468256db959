"""The stream engine's cell (`msm_stream_2p16` on `whisk_range_sync_deneb_128`)
as the committed manifest declares it, its four readers on a synthetic
traced window, and its driver run on the CPU: a Deneb-shaped configuration
of 24 bases and its cell, added as new files and appended entries to a copy
of the benchmark the way `tiny_root` adds its own, run through `run.main`
with `SEL_MIN_N` lowered, so the selection scan the cell takes runs here,
on the native prep and on the numpy prep; the control and two planted
faults must read false."""
from __future__ import annotations

import importlib
import json
import shutil

import pytest
import torch

import devtrace
import reference
import run
from conftest import HERE, ROOT, _cpu
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.ops import g1 as og
from curdleproofs_tpu_torch.ops import msm as omsm
from curdleproofs_tpu_torch.ops import stream_scan as ostream
from curdleproofs_tpu_torch.utils import host_native, profiling

CONFIG, CELL, TRAFFIC = "whisk_range_sync_deneb_128", "msm_stream_2p16", "fresh_uniform_stream"
NEW = ("stream_prep_idle_ms", "stream_enqueue_idle_ms", "stream_upload_ms", "scan_sel_roofline_pct")
# the engine-neutral metrics the cell reports beside its own four
SHARED = ("msm_points_per_s", "msm_p90_ms", "device_idle_pct.msm", "msm_kernel_roofline_pct",
          "point_op_ms_per_msm", "scan_copy_ms_per_msm", "msm_host_tail_ms", "msm_readback_wait_ms",
          "msm_combine_ms")
# a Deneb-shaped configuration at a size the CPU runs, its counts worked out
# by hand: one block of a 4-tracker shuffle over 16 candidates,
# round(16 * (1 - (15/16)^4)) = 4 touched, 5 + 3 + 2 * (4 + 4) = 24 bases
TINY_CONFIG, TINY_CELL = "tiny_range_sync_deneb", "tiny_stream_cpu"
TINY_NUMBERS = {"max_request_blocks": 1, "whisk_validators_per_shuffle": 4, "whisk_candidate_trackers_count": 16,
                "shared_bases": 5, "proof_bases_per_proof": 3, "candidates_touched": 4, "bases": 24}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _load(path, name):
    return run.load_file(path, name)


# -- the declaration -----------------------------------------------------------


def test_the_cell_is_declared_by_the_recipe():
    configs = {c["name"]: c for c in BENCH["configs"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert configs[CONFIG]["reduced"] == [] and len(configs[CONFIG]["source"]) <= 200
    assert (cells[CELL]["config"], cells[CELL]["traffic"], cells[CELL]["chips"]) == (CONFIG, TRAFFIC, 1)
    deneb = json.loads((ROOT / configs[CONFIG]["file"]).read_text())
    committed = json.loads((HERE / "configs" / "whisk_range_sync_1024.json").read_text())
    assert set(deneb) == set(committed)  # `derivation` among them
    assert deneb["assumed"].keys() == committed["assumed"].keys()
    assert (deneb["entry"], deneb["max_request_blocks"], deneb["candidates_touched"], deneb["bases"]) == (
        "msm_pippenger_stream", 128, 10_166, 62_319)
    listed = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"] if CELL in m.get("workloads", [])}
    assert set(SHARED) | set(NEW) <= listed
    new = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in NEW}
    assert new.keys() == set(NEW)
    assert all(CELL in m["workloads"] and m["moves"] == "msm_points_per_s" for m in new.values())
    assert [new[n]["layer"] for n in NEW] == ["host prep", "host enqueue", "uploads", "kernels"]
    assert [(new[n]["unit"], new[n]["better"], new[n]["source"]) for n in NEW] == [
        ("ms", "lower", "device_trace")] * 3 + [("%", "higher", "device_trace")]
    traffic = json.loads((HERE / "traffic" / f"{TRAFFIC}.json").read_text())
    assert (traffic["scalars"], traffic["lanes_per_call"], traffic["warmup_calls"], traffic["base_sample"]) == (
        "uniform_below_r", 64, 2, 16)
    driver = _load(HERE / "drivers" / "msm_pippenger_stream.py", "stream_driver_declared")
    for mod_name, names in driver.TRACE_SPANS.items():
        mod = importlib.import_module(mod_name)
        assert all(callable(getattr(mod, n, None)) for n in names), mod_name


def test_scan_sel_work_is_the_glv_lanes_mixed_adds():
    """K1's least time at the cell's size: 10 windows of 124,638 lanes, one
    mixed add each, at the card's multiply rate."""
    mul32 = _load(HERE / "metrics" / "scan_sel_roofline_pct.py", "scan_sel_work").mul32
    assert mul32(62_319, 13) == 10 * 124_638 * 3036
    assert mul32(62_319, 13) / 16.75e12 * 1e3 == pytest.approx(0.2259, abs=1e-4)


# -- the four readers on a synthetic window -------------------------------------

MS = 1_000_000  # ns


class _Cell:
    n, c = 62_319, 13


def _host(*spans_ms):
    return [(n, s * MS, e * MS, 7, 0) for n, s, e in spans_ms]


# two calls of 50 ms: host prep, then the device span with the uploads in it
HOST = _host(
    ("portbench.call", 0, 50), ("portbench.call", 60, 110),
    ("msm.stream.host_prep", 1, 11), ("msm.stream.device", 11, 30),
    ("msm.stream.upload", 12, 14), ("msm.stream.upload", 15, 19),
    ("msm.stream.host_prep", 61, 69), ("msm.stream.device", 69, 90),
    ("msm.stream.upload", 70, 73), ("msm.stream.upload", 74, 77),
)
# the card: busy 8-12, 19-40, 68-71, 77-100; the selection scan 20-22 and
# 80-83, a complete scan 83-95 not counted
DEVICE = [(n, s * MS, e * MS, 0) for n, s, e in (
    ("void curdle::glv_records_kernel(...)", 8, 12),
    ("void curdle::gather_kernel<true>(...)", 19, 20),
    ("void curdle::scan_kernel<false>(unsigned int const*, int const*)", 20, 22),
    ("void curdle::point_kernel<0, 1>(...)", 22, 40),
    ("void curdle::glv_records_kernel(...)", 68, 71),
    ("void curdle::scan_kernel<false>(unsigned int const*, int const*)", 80, 83),
    ("void curdle::point_kernel<0, 1>(...)", 77, 80),
    ("void curdle::scan_kernel<true>(unsigned int const*, int const*)", 83, 95),
    ("Memcpy DtoH", 95, 100))]


def _reader(name):
    return _load(HERE / "metrics" / f"{name}.py", f"portbench_metric_{name}").read


def test_the_four_readers_on_a_synthetic_window():
    v = devtrace.TraceView((DEVICE, HOST), set(), _Cell, 2)
    got = {name: _reader(name)(v) for name in NEW}
    k1_s = (2 + 3) / 1e3
    assert got == pytest.approx({
        # prep 1-11 meets the gap 1-8; 61-69 meets 61-68
        "stream_prep_idle_ms": (7 + 7) / 2,
        # device 11-30 meets 12-19; 69-90 meets 71-77
        "stream_enqueue_idle_ms": (7 + 6) / 2,
        "stream_upload_ms": (2 + 4 + 3 + 3) / 2,
        "scan_sel_roofline_pct": 100 * 2 * 10 * 2 * 62_319 * 3036 / (k1_s * 16.75e12),
    })


def test_the_four_readers_read_nothing_without_spans_or_a_card():
    calls = [h for h in HOST if h[0] == "portbench.call"]
    no_spans = devtrace.TraceView((DEVICE, calls), set(), _Cell, 2)
    no_card = devtrace.TraceView(([], HOST), set(), _Cell, 2)
    no_scan = devtrace.TraceView(([d for d in DEVICE if "scan_kernel<false>" not in d[0]], HOST), set(), _Cell, 2)
    for v in (no_spans, no_card):
        assert {name: _reader(name)(v) for name in NEW[:3]} == dict.fromkeys(NEW[:3]), v
    assert _reader("scan_sel_roofline_pct")(no_card) is None
    assert _reader("scan_sel_roofline_pct")(no_scan) is None


# -- the driver on the CPU ------------------------------------------------------


@pytest.fixture(scope="module")
def stream_root(tmp_path_factory):
    """A copy of the benchmark with the Deneb-shaped tiny configuration, a
    traffic mix of few calls and the cell, declared as the committed cell
    is."""
    root = tmp_path_factory.mktemp("stream_checkout")
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    deneb = json.loads((HERE / "configs" / f"{CONFIG}.json").read_text())
    (root / "portbench" / "configs" / f"{TINY_CONFIG}.json").write_text(
        json.dumps(dict(deneb, name=TINY_CONFIG, **TINY_NUMBERS)))
    traffic = json.loads((HERE / "traffic" / f"{TRAFFIC}.json").read_text())
    traffic.update(name="tiny_stream_c4", window_bits=4, lanes_per_call=4, warmup_calls=1, min_calls=1,
                   base_sample=4)
    (root / "portbench" / "traffic" / "tiny_stream_c4.json").write_text(json.dumps(traffic))
    bench["configs"].append({"name": TINY_CONFIG, "source": "test", "file": f"portbench/configs/{TINY_CONFIG}.json",
                             "reduced": list(TINY_NUMBERS), "why": "a Deneb-shaped response at a size the CPU runs"})
    bench["workloads"].append({"name": TINY_CELL, "config": TINY_CONFIG, "traffic": "tiny_stream_c4", "chips": 1,
                               "why": "the stream cell at 24 bases"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="module", autouse=True)
def bases_once():
    """The bases b_i * G of a seed made once for the whole file: the
    driver's `make_bases` runs the program's scalar multiplication, which
    takes seconds on the CPU, the same for every run of one seed."""
    made = {}
    real = og.scalar_mul

    def scalar_mul(points, scalars):
        key = (scalars.cpu().numpy().tobytes(), points.x.cpu().numpy().tobytes())
        if key not in made:
            made[key] = real(points, scalars)
        return made[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(og, "scalar_mul", scalar_mul)
        yield made


@pytest.fixture
def run_stream(stream_root, capsys, monkeypatch):
    """One run of the tiny cell through `run.main` on the CPU, the selection
    scan switched on at its 256 GLV lanes; returns the result line and how
    many chunks went through the selection and the complete bodies."""
    monkeypatch.setattr(omsm, "SEL_MIN_N", 256)
    monkeypatch.setattr(ostream, "_LANES", 8)  # 32 scan steps, fewer lane-offset adds
    bodies = {"sel": 0, "full": 0}
    for key, name in (("sel", "_stream_window_partials_sel"), ("full", "_stream_window_partials")):
        orig = getattr(omsm, name)

        def spy(*args, _orig=orig, _key=key, **kwargs):
            bodies[_key] += 1
            return _orig(*args, **kwargs)

        monkeypatch.setattr(omsm, name, spy)

    def go(*extra, seed: int = 3_100_000_019, trace: int = 0):
        torch.set_num_threads(2)
        argv = ["--workload", TINY_CELL, "--seed", str(seed), "--seconds", "0", "--trace", str(trace), *extra]
        with profiling.collect():
            assert run.main(argv, root=stream_root, devices=_cpu) == 0
            prep = {k for k in profiling.metrics_report() if k.startswith("msm.stream.host_prep.")}
        out, _ = capsys.readouterr()
        return json.loads(out.strip().splitlines()[-1]), dict(bodies, prep=prep)

    return go


def test_the_tiny_configuration_derives_its_bases(stream_root):
    c = json.loads((stream_root / "portbench" / "configs" / f"{TINY_CONFIG}.json").read_text())
    blocks, per, N = c["max_request_blocks"], c["whisk_validators_per_shuffle"], c["whisk_candidate_trackers_count"]
    assert c["candidates_touched"] == round(N * (1 - (1 - 1 / N) ** (per * blocks)))
    assert c["bases"] == c["shared_bases"] + blocks * c["proof_bases_per_proof"] + \
        c["points_per_tracker"] * (c["candidates_touched"] + blocks * per)


@pytest.mark.parametrize("prep", ["native", "numpy"])
def test_the_stream_cell_is_correct_on_the_selection_scan(run_stream, monkeypatch, prep):
    if prep == "native" and not host_native.available():
        pytest.skip("no C compiler: the native prep is not built")
    if prep == "numpy":
        monkeypatch.setattr(host_native, "available", lambda: False)
    res, seen = run_stream()
    assert res["correct"] is True
    assert res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"msm_points_per_s", "msm_p90_ms", "setup_s"}
    assert res["checks"] == {"mismatched_calls": {"value": 0, "limit": 0},
                             "mismatched_bases": {"value": 0, "limit": 0}}
    # the warm-up call and the timed one, each one chunk on the selection scan
    assert (seen["sel"], seen["full"]) == (2, 0)
    assert seen["prep"] == {f"msm.stream.host_prep.{prep}"}


def test_a_traced_stream_run_reads_only_what_it_finds(run_stream):
    """No device event on the CPU: every reader of the cell stays silent."""
    res, _ = run_stream(trace=1)
    assert res["correct"] is True and res["metrics"] == {}


def test_the_stream_control_fails_every_call(run_stream):
    res, _ = run_stream("--control", "top_window_dropped")
    assert res["correct"] is False
    assert res["checks"]["mismatched_calls"]["value"] == res["attempted"] == 1


def _first_answer(orig):
    first = []

    def f(points, scalars, c=None, window_batch=None, sel_scan=None, routed=None):
        if not first:
            first.append(orig(points, scalars, c=c))
        return first[0]

    return f


def _altered(orig):
    def f(res, c, W):
        return orig(res, c, W) + G1()

    return f


FAULTS = {
    "first_answer_returned": ("msm_pippenger_stream", _first_answer),
    "answer_altered_in_combine": ("_combine_packed", _altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_stream_path_is_caught(run_stream, monkeypatch, fault):
    name, make = FAULTS[fault]
    monkeypatch.setattr(omsm, name, make(getattr(omsm, name)))
    res, _ = run_stream()
    assert res["correct"] is False and res["failed"] == res["attempted"] == 1


def test_same_seed_same_host_scalars(stream_root):
    """The driver's inputs from the seed: the host scalars each call sees,
    one new lane a stride, and the reference's running dot product after
    each call against one worked out afresh."""
    spec = run.cell_spec(stream_root, TINY_CELL)
    driver = _load(stream_root / "portbench" / "drivers" / "msm_pippenger_stream.py", "stream_driver_seed")
    cells = [driver.setup(spec["config"], spec["traffic"], 3_100_000_019, torch.device("cpu")) for _ in range(2)]
    seen = []
    for cell in cells:
        cell.entry = lambda points, scalars: seen.append(scalars.copy())
        for i in range(3):
            cell.call(i)
    a, b = seen[:3], seen[3:]
    assert all((x == y).all() for x, y in zip(a, b))
    assert all(x.dtype.name == "uint32" and x.shape == (16, 24) for x in a)
    assert all(not (x == y).all() for x, y in zip(a, a[1:]))
    cell = cells[0]
    assert all((lanes // cell.stride).tolist() == list(range(cell.lanes)) for _, lanes, _ in cell.rewrites)
    rewrites = [(i, l.numpy(), v.numpy().astype("int64")) for i, l, v in cell.rewrites]
    dots = cell._dots(rewrites, {0, 2})
    assert dots == {i: reference.dot_mod_r(a[i].astype("int64"), cell.b_host) for i in (0, 2)}


def test_set_up_keeps_freed_memory(stream_root, monkeypatch):
    """The driver's set-up fixes the allocator's thresholds before anything
    else, and then a table of the size a call allocates, freed and made
    again, comes back without page faults."""
    import resource

    import numpy as np

    driver = _load(stream_root / "portbench" / "drivers" / "msm_pippenger_stream.py", "stream_driver_memory")
    assert driver.keep_freed_memory() is True
    faults = []
    for _ in range(4):
        before = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        table = np.ones(5 << 20, np.uint8)
        del table
        faults.append(resource.getrusage(resource.RUSAGE_SELF).ru_minflt - before)
    assert sum(faults[1:]) < 64, faults  # 1,280 pages each, were they faulted in again
    calls = []
    monkeypatch.setattr(driver, "keep_freed_memory", lambda: calls.append(1) or True)
    spec = run.cell_spec(stream_root, TINY_CELL)
    driver.setup(spec["config"], spec["traffic"], 3_100_000_019, torch.device("cpu"))
    assert calls == [1]
