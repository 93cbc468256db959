"""A second configuration, added as new files and appended entries the way
the next one will come (`tiny_root`): the manifest holds it as declared, and
`run.main` runs its cell."""
from __future__ import annotations

import json

from conftest import EVERY_ENGINE, HERE, RANGE_CELL, RANGE_CONFIG, TINY_METRIC


def test_the_second_configuration_is_declared_as_the_next_will_be(tiny_root):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    committed = json.loads((HERE / "configs" / "whisk_range_sync_1024.json").read_text())
    (entry,) = [c for c in bench["configs"] if c["name"] == RANGE_CONFIG]
    assert set(json.loads((tiny_root / entry["file"]).read_text())) == set(committed)  # `derivation` among them
    assert next(w for w in bench["workloads"] if w["name"] == RANGE_CELL)["config"] == RANGE_CONFIG
    listed = {m["name"] for m in bench["end_to_end"] + bench["per_layer"] if RANGE_CELL in m.get("workloads", [])}
    assert listed == {m["name"] for m in bench["end_to_end"] if "workloads" in m} | set(EVERY_ENGINE)
    assert bench["per_layer"][-1]["name"] == TINY_METRIC


def test_the_second_configurations_cell_is_correct(run_cell):
    res, _ = run_cell(cell=RANGE_CELL)
    assert res["correct"] is True
    assert res["attempted"] == 3 and res["failed"] == 0
    assert set(res["metrics"]) == {"msm_points_per_s", "msm_p90_ms", "setup_s"}
    assert res["checks"] == {"mismatched_calls": {"value": 0, "limit": 0},
                             "mismatched_bases": {"value": 0, "limit": 0}}
