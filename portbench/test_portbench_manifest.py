"""BENCHMARK.json against the contract it is written to, and the frozen
yardstick, reference and trace arithmetic on their own. Each contract check
runs over the committed manifest and over `tiny_root`'s, to which a second
configuration, its cell and a per-layer metric are added as a later change
adds them (the `manifest` fixture)."""
from __future__ import annotations

import hashlib
import json
import random
import re

import numpy as np
import pytest

import devtrace
import reference
import yardstick
from conftest import HERE, RANGE_CONFIG, ROOT, TINY_CELL

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def _metrics(bench):
    return bench["end_to_end"] + bench["per_layer"]


def test_keys_and_names(manifest):
    bench, _ = manifest
    assert set(bench) == KEYS["top"]
    for kind, entries in (("config", bench["configs"]), ("workload", bench["workloads"]),
                          ("end_to_end", bench["end_to_end"]), ("per_layer", bench["per_layer"])):
        for e in entries:
            assert set(e) <= KEYS[kind], e
            assert NAME.match(e["name"]), e["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    names = [e["name"] for e in bench["configs"] + bench["workloads"] + _metrics(bench)]
    assert len(names) == len(set(names))
    for m in _metrics(bench):
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [e["why"] for e in bench["configs"] + bench["workloads"]] + [c["source"] for c in bench["configs"]] \
            + [m["layer"] for m in bench["per_layer"]] + bench["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_file_is_found_by_name(manifest):
    bench, root = manifest
    here = root / "portbench"
    cells = {w["name"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/") and (root / c["file"]).is_file()
        config = json.loads((root / c["file"]).read_text())
        assert (here / "drivers" / f"{config['entry']}.py").is_file()
        assert any(w["config"] == c["name"] for w in bench["workloads"])
        for key in c["reduced"]:
            assert not re.search(r"(_dim|_rank|width|size)$", key)
    for w in bench["workloads"]:
        assert (here / "traffic" / f"{w['traffic']}.json").is_file()
        traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
        assert (here / "scalars" / f"{traffic['scalars']}.py").is_file()
    for m in _metrics(bench):
        assert (here / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells


def test_each_cell_reports_what_its_layer_metrics_move(manifest):
    bench, _ = manifest

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        cell = w["name"]
        assert reports(e2e["setup_s"], cell)
        assert any(reports(m, cell) for n, m in e2e.items() if n != "setup_s")
        assert any(reports(m, cell) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in bench["workloads"]]):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_run_seconds_fits_a_full_check(manifest):
    bench, _ = manifest
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
    four = sum(1 for w in bench["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_command_stays_in_paths(manifest):
    bench, _ = manifest
    assert bench["paths"] == ["portbench"]
    assert bench["command"][0] == "python3"
    for word in bench["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert word.startswith("portbench/")


def test_a_cell_and_a_metric_are_added_as_files_only(tiny_root):
    """The fixture added a configuration, a traffic mix and a reader as new
    files; every file the benchmark had is byte for byte as committed."""
    def digest(p):
        return hashlib.sha256(p.read_bytes()).hexdigest()

    for p in HERE.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert digest(tiny_root / "portbench" / p.relative_to(HERE)) == digest(p), p
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    assert TINY_CELL in {w["name"] for w in bench["workloads"]}


# -- the yardstick --------------------------------------------------------


def test_canonical_counts():
    assert yardstick.MUL32_PER_ADD == 4470
    assert yardstick.MUL32_PER_MIXED_ADD == 3036
    assert yardstick.windows(15) == 17
    # 17 windows: 367,733 bases into buckets, then 2 adds for each of 2^15 buckets
    assert yardstick.canonical_mul32(367_733, 15) == 17 * 367_733 * 3036 + 2 * 17 * 32768 * 4470 == 23_959_516_236
    assert yardstick.PEAK_MUL32_PER_S == 67e12 / 4


# every configuration whose file states a `derivation`: the committed ones,
# read where they are committed, and the one `tiny_root` adds
DERIVED = {c["name"]: ROOT / c["file"] for c in BENCH["configs"]
           if "derivation" in json.loads((ROOT / c["file"]).read_text())}


@pytest.mark.parametrize("name", [*DERIVED, RANGE_CONFIG])
def test_configuration_derives_its_bases(name, tiny_root):
    """The configuration's base count from its own numbers (`derivation`)."""
    path = DERIVED.get(name, tiny_root / "portbench" / "configs" / f"{name}.json")
    c = json.loads(path.read_text())
    assert "derivation" in c
    blocks, per = c["max_request_blocks"], c["whisk_validators_per_shuffle"]
    N = c["whisk_candidate_trackers_count"]
    assert c["candidates_touched"] == round(N * (1 - (1 - 1 / N) ** (per * blocks)))
    assert c["bases"] == c["shared_bases"] + blocks * c["proof_bases_per_proof"] + \
        c["points_per_tracker"] * (c["candidates_touched"] + blocks * per)


@pytest.mark.parametrize("seed", range(4))
def test_busy_union_is_the_programs(seed):
    """The frozen copy agrees with the program's `busy_summary`."""
    from curdleproofs_tpu_torch.utils.profiling import busy_summary

    rng = random.Random(seed)
    spans = []
    for _ in range(200):
        s = rng.uniform(0, 1000)
        spans.append((s, s + rng.uniform(0, 30)))
    ours = yardstick.busy_union(spans)
    theirs = busy_summary([("k", s, e) for s, e in spans], (0.0, 2000.0))["busy_ms"] * 1e3
    assert ours == pytest.approx(theirs, rel=1e-12)
    gaps = yardstick.idle_gaps(spans, (0.0, 2000.0))
    assert sum(b - a for a, b in gaps) == pytest.approx(2000.0 - ours, rel=1e-9)


def test_trace_view_on_synthetic_events():
    class Cell:
        n, c = 1 << 21, 15

    host = [("portbench.call", 0, 100, 7, 0), ("ops.msm._combine_packed", 80, 100, 7, 0),
            ("aten::cat", 20, 30, 7, 0), ("portbench.call", 120, 200, 7, 0),
            ("cudaLaunchKernel", 5, 6, 7, 11), ("cudaMemcpyAsync", 85, 86, 7, 12)]
    # the card's clock runs 1,000 ns after the host's: moved back onto it
    device = [("void curdle::point_kernel<0, 1>", 1005, 1040, 11), ("CatArrayBatchedCopy", 1040, 1070, 0),
              ("Memcpy DtoH", 1090, 1095, 12), ("void curdle::point_kernel<0, 1>", 1130, 1180, 0)]
    v = devtrace.TraceView((device, host), {"ops.msm._combine_packed"}, Cell, 2)
    assert v.cell is Cell
    assert v.clock_offset_ns == 1000  # the copy's pair: 1090 - 85 = 1005 is not the least
    assert v.window == (0, 200) and v.window_ns == 200
    assert v.busy_ns == 35 + 30 + 5 + 50
    assert v.host_tail_ns == [5, 20]
    assert v.device_ms(lambda n: "point_kernel" in n) == pytest.approx(85 / 1e6)
    b = v.breakdown()
    labels = dict(b["idle_gaps"])
    assert labels == pytest.approx({
        "host Python inside an entry call": (5 + 20) / 1e9,  # (0, 5) and (180, 200)
        "ops.msm._combine_packed": 20 / 1e9,  # (70, 90)
        "harness between calls": 35 / 1e9,  # (95, 130): its middle lies between the calls
    })
    assert [n for n, _ in b["device_ops"]][0] == "void curdle::point_kernel<0, 1>"


def test_metric_readers_on_a_view():
    import importlib.util

    def reader(name):
        spec = importlib.util.spec_from_file_location(name, HERE / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    class Cell:
        n, c = 1 << 21, 15

    busy = 0.2e9  # 200 ms busy for one MSM
    v = devtrace.TraceView(([("void curdle::point_kernel<0, 1>", 0, busy, 0)], [("portbench.call", 0, 0.25e9, 1, 0)]),
                           set(), Cell, 1)
    roof = reader("msm_kernel_roofline_pct")(v)
    assert roof == pytest.approx(100 * (17 * 2**21 * 3036 + 2 * 17 * 2**15 * 4470) / (0.2 * 16.75e12))
    assert 0 < roof < 100
    assert reader("device_idle_pct.msm")(v) == pytest.approx(20.0)
    assert reader("point_op_ms_per_msm")(v) == pytest.approx(200.0)
    assert reader("scan_copy_ms_per_msm")(v) is None
    assert reader("msm_host_tail_ms")(v) == pytest.approx(50.0)


# -- the reference ----------------------------------------------------------


def test_reference_curve_constants_are_the_programs():
    from curdleproofs_tpu_torch.curve import G1_GEN_X, G1_GEN_Y
    from curdleproofs_tpu_torch.fields import FQ_MOD, FR_MOD

    assert (reference.P, reference.R, reference.GX, reference.GY) == (FQ_MOD, FR_MOD, G1_GEN_X, G1_GEN_Y)
    assert reference.on_curve(reference.G)
    assert reference.mul(reference.R, reference.G) is None
    assert reference.mul(reference.R - 1, reference.G) == (reference.GX, (-reference.GY) % reference.P)


@pytest.mark.parametrize("k", [1, 2, 3, 12345, 2**200 + 17])
def test_reference_mul_against_the_host_backend(k):
    from curdleproofs_tpu_torch.curve import G1
    from curdleproofs_tpu_torch.fields import Fr

    pt = G1() * Fr(k)
    assert reference.mul(k, reference.G) == (pt.x, pt.y)
    assert reference.add(reference.mul(k, reference.G), reference.G) == reference.mul(k + 1, reference.G)


@pytest.mark.parametrize("block", [4, 1 << 20])
def test_dot_mod_r_is_exact(monkeypatch, block):
    monkeypatch.setattr(reference, "DOT_BLOCK", block)
    rng = np.random.default_rng(7)
    n = 37
    s = rng.integers(0, 1 << 16, (16, n))
    b = rng.integers(0, 1 << 16, (16, n))
    s[:, 0] = b[:, 0] = 0xFFFF  # the largest limbs
    want = sum(reference.limbs_to_int(s[:, i]) * reference.limbs_to_int(b[:, i]) for i in range(n)) % reference.R
    assert reference.dot_mod_r(s, b) == want


def test_truncated_clears_the_top_window():
    s = np.full((16, 2), 0xFFFF)
    t = reference.truncated(s, 240)
    assert reference.limbs_to_int(t[:, 0]) == (1 << 240) - 1
    t = reference.truncated(s, 250)
    assert reference.limbs_to_int(t[:, 1]) == (1 << 250) - 1
