"""Fixtures of the benchmark's own tests (`python -m pytest portbench -q`).

`tiny_root` copies the benchmark into a temporary checkout and adds three
cells the CPU can run, as a later change would: new files (a configuration
of 37 bases, a second range-sync configuration of two small blocks with
the committed one's keys and its own derivation, two traffic mixes with 4-bit
windows, one of them drawing its scalars by a sampler of its own, a metric
reader) and new entries in the copy of BENCHMARK.json, no file of the
benchmark edited. `manifest` gives each manifest the contract tests hold:
the committed BENCHMARK.json and that copy. `run_cell` runs `run.main`
there on the CPU, past the look for a card, and returns the result line
and the checks printed on standard error.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (ROOT, HERE):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import run  # noqa: E402

TINY_CELL = "tiny_msm_cpu"
TINY_SMALL_CELL = "tiny_msm_cpu_small"
TINY_METRIC = "calls_in_trace"
# a second range-sync configuration, as the next configuration will come:
# the committed one's keys, at a size the CPU runs (two blocks of 4-tracker
# shuffles over 16 candidates), its counts worked out by hand:
# round(16 * (1 - (15/16)^8)) = 6 candidates touched, 11 + 2 * 9 + 2 * (6 + 2 * 4) = 57 bases
RANGE_CONFIG = "tiny_range_sync_2"
RANGE_CELL = "tiny_range_sync_cpu"
RANGE_NUMBERS = {"max_request_blocks": 2, "whisk_validators_per_shuffle": 4, "whisk_candidate_trackers_count": 16,
                 "shared_bases": 11, "proof_bases_per_proof": 9, "candidates_touched": 6, "bases": 57}
# the per-layer metrics every engine's spans feed, which a cell on another
# engine reports too
EVERY_ENGINE = ("msm_readback_wait_ms", "msm_combine_ms")
# a scalar sampler added as a file: values below 2^64
SMALL_SAMPLER = '''"""Scalars uniform below 2^64 (a throwaway sampler)."""
import torch


def draw(gen, n, device):
    s = torch.zeros((16, n), dtype=torch.int32, device=device)
    s[:4] = torch.randint(0, 1 << 16, (4, n), generator=gen, device=device, dtype=torch.int32)
    return s
'''


def _cpu(chips: int):
    return torch.device("cpu")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "portbench" / "configs" / "tiny_msm.json").write_text(
        json.dumps({"name": "tiny_msm", "entry": "msm_pippenger", "bases": 37}))
    committed = json.loads((HERE / "configs" / "whisk_range_sync_1024.json").read_text())
    (root / "portbench" / "configs" / f"{RANGE_CONFIG}.json").write_text(
        json.dumps(dict(committed, name=RANGE_CONFIG, assumed={"sizes": "a size the CPU runs"}, **RANGE_NUMBERS)))
    traffic = json.loads((HERE / "traffic" / "fresh_uniform_c15.json").read_text())
    traffic.update(name="tiny_c4", window_bits=4, lanes_per_call=4, warmup_calls=1, min_calls=3, base_sample=4)
    (root / "portbench" / "traffic" / "tiny_c4.json").write_text(json.dumps(traffic))
    traffic.update(name="tiny_small_c4", scalars="below_2p64")
    (root / "portbench" / "traffic" / "tiny_small_c4.json").write_text(json.dumps(traffic))
    (root / "portbench" / "scalars" / "below_2p64.py").write_text(SMALL_SAMPLER)
    (root / "portbench" / "metrics" / f"{TINY_METRIC}.py").write_text(
        '"""Calls in the traced window (a throwaway reader)."""\n\n\ndef read(view):\n    return view.calls\n')
    bench["configs"].append({"name": "tiny_msm", "source": "test", "file": "portbench/configs/tiny_msm.json",
                             "reduced": ["bases"], "why": "a size the CPU runs"})
    bench["workloads"].append({"name": TINY_CELL, "config": "tiny_msm", "traffic": "tiny_c4", "chips": 1,
                               "why": "the test cell"})
    bench["workloads"].append({"name": TINY_SMALL_CELL, "config": "tiny_msm", "traffic": "tiny_small_c4",
                               "chips": 1, "why": "the test cell, scalars below 2^64"})
    bench["configs"].append({"name": RANGE_CONFIG, "source": "test",
                             "file": f"portbench/configs/{RANGE_CONFIG}.json", "reduced": list(RANGE_NUMBERS),
                             "why": "a range-sync response of two small blocks: 57 bases"})
    bench["workloads"].append({"name": RANGE_CELL, "config": RANGE_CONFIG, "traffic": "tiny_c4", "chips": 1,
                               "why": "the second configuration's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [TINY_CELL, TINY_SMALL_CELL]
            if m in bench["end_to_end"] or m["name"] in EVERY_ENGINE:
                m["workloads"].append(RANGE_CELL)
    bench["per_layer"].append({"name": TINY_METRIC, "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "device", "moves": "msm_points_per_s",
                               "workloads": [TINY_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(params=["committed", "extended"])
def manifest(request):
    """(bench, root): the committed BENCHMARK.json with the repo's root, then
    `tiny_root`'s copy, which holds what later changes add, with its own."""
    root = ROOT if request.param == "committed" else request.getfixturevalue("tiny_root")
    return json.loads((root / "BENCHMARK.json").read_text()), root


@pytest.fixture
def run_cell(tiny_root, capsys):
    def go(*extra, seed: int = 3_000_000_019, trace: int = 0, cell: str = TINY_CELL):
        torch.set_num_threads(2)
        argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0", "--trace", str(trace), *extra]
        assert run.main(argv, root=tiny_root, devices=_cpu) == 0
        out, err = capsys.readouterr()
        return json.loads(out.strip().splitlines()[-1]), err

    return go
