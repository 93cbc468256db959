"""Fixtures of the benchmark's own tests (`python -m pytest portbench -q`).

`tiny_root` copies the benchmark into a temporary checkout and adds two
cells the CPU can run, as a later change would: new files (a configuration
of 37 bases, two traffic mixes with 4-bit windows, one of them drawing its
scalars by a sampler of its own, a metric reader) and new entries in the
copy of BENCHMARK.json, no file of the benchmark edited. `run_cell` runs
`run.main` there on the CPU, past the look for a card, and returns the
result line and the checks printed on standard error.
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
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [TINY_CELL, TINY_SMALL_CELL]
    bench["per_layer"].append({"name": TINY_METRIC, "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "device", "moves": "msm_points_per_s",
                               "workloads": [TINY_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def run_cell(tiny_root, capsys):
    def go(*extra, seed: int = 3_000_000_019, trace: int = 0, cell: str = TINY_CELL):
        torch.set_num_threads(2)
        argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0", "--trace", str(trace), *extra]
        assert run.main(argv, root=tiny_root, devices=_cpu) == 0
        out, err = capsys.readouterr()
        return json.loads(out.strip().splitlines()[-1]), err

    return go
