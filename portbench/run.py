#!/usr/bin/env python3
"""The benchmark of curdleproofs_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with a CUDA card. The cell is an
entry of `workloads` in BENCHMARK.json; everything it needs is found by name:

- its configuration: the file the `configs` entry names, whose `entry`
  names the module that sets the cell up and calls the program,
  `portbench/drivers/<entry>.py`;
- its traffic: `portbench/traffic/<traffic>.json`;
- each metric: a reader `portbench/metrics/<metric name>.py` with a function
  `read(view)` that returns a number, or None where it finds nothing to read.

A driver has `setup(config, traffic, seed, device, control)`, which returns
the cell: `call(i)` (the timed call), `items_per_call`, `collect(results)`
(the answers and the reference's inputs on the host, the program's state
freed) and `check(collected)` (each number compared with its limit, and the
number of calls that failed). What the answer is, and what the reference and
its control are, is the driver's; this file knows none of it.

A run sets up the cell (inputs made on the card from the seed, every shape
warmed up), then calls it back to back for `--seconds`. With `--trace 0` it
reports the end-to-end metrics on the host clock; with `--trace 1` it runs
the same window under torch.profiler and reports the per-layer metrics, the
device's busy time and a breakdown. After the window it checks that no JAX
module was loaded, reads the memory peak, has the driver collect the answers
and free the program's state, then check them. The last line on standard
output is one JSON object; the numbers compared, each with its limit, are
the last lines on standard error and the last key of that object.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
for _p in (HERE.parent, HERE):  # the checkout's root (the program), then the harness
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "curdleproofs_tpu")


class RunError(SystemExit):
    """A run that prints no result: the message goes to standard error and
    the exit code is 2."""

    def __init__(self, message: str) -> None:
        sys.stderr.write(f"portbench: {message}\n")
        super().__init__(2)


def load_file(path: Path, name: str):
    if not path.is_file():
        raise RunError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(root: Path, workload: str) -> dict:
    """The workload's entry, its configuration and traffic files, and the
    metrics that apply to it, from BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())

    def applies(m: dict) -> bool:
        return "workloads" not in m or workload in m["workloads"]

    return {
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def require_devices(chips: int):
    """The card, or no result."""
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: this benchmark measures the card and prints no result without one")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} present")
    return torch.device("cuda:0")


def _gpu_cpulist() -> Optional[List[int]]:
    """The CPUs local to the first visible card, from sysfs."""
    import torch

    props = torch.cuda.get_device_properties(0)
    bus = getattr(props, "pci_bus_id", None)
    if bus is None:
        return None
    addr = f"{getattr(props, 'pci_domain_id', 0):04x}:{bus:02x}:{getattr(props, 'pci_device_id', 0):02x}.0"
    try:
        text = Path(f"/sys/bus/pci/devices/{addr}/local_cpulist").read_text().strip()
    except OSError:
        return None
    cpus: List[int] = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        cpus.extend(range(int(lo), int(hi or lo) + 1))
    return cpus


def pin_host(device) -> int:
    """Pin every thread of this process to the card's local CPUs (those this
    process may use), and size the host thread pools to them."""
    import torch

    if device.type != "cuda":
        return 0
    allowed = os.sched_getaffinity(0)
    cpus = set(_gpu_cpulist() or []) & allowed or allowed
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:
            pass
    os.environ["OMP_NUM_THREADS"] = str(len(cpus))
    torch.set_num_threads(len(cpus))
    return len(cpus)


def quantile(values: List[float], q: float) -> float:
    """The q-quantile by linear interpolation between order statistics."""
    s = sorted(values)
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


class WindowView:
    """What the end-to-end readers see: the window on the host clock."""

    def __init__(self, latencies_s, window_s, items_per_call, setup_s, quantile_fn):
        self.latencies_s = latencies_s
        self.window_s = window_s
        self.calls = len(latencies_s)
        self.items_per_call = items_per_call
        self.setup_s = setup_s
        self.quantile = quantile_fn


def run_window(call: Callable[[int], object], seconds: float, min_calls: int, first: int = 0, span=None):
    """Back-to-back calls, numbered from `first`, until `seconds` have passed
    (and at least `min_calls` were made). Every call ends in a readback, so
    its host time is complete. Returns (results, latencies, start, end)."""
    results, lat = [], []
    t0 = time.perf_counter()
    i, now = first, t0
    while now - t0 < seconds or i - first < min_calls:
        a = time.perf_counter()
        if span is not None:
            with span("portbench.call"):
                results.append(call(i))
        else:
            results.append(call(i))
        now = time.perf_counter()
        lat.append(now - a)
        i += 1
    return results, lat, t0, now


def forbidden_loaded(modules=None) -> List[str]:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (`curdleproofs_tpu_torch` is not one)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN_MODULES))


def read_metrics(root: Path, entries: List[dict], view) -> Dict[str, dict]:
    """Each metric from its reader `portbench/metrics/<name>.py`; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in entries:
        value = load_file(root / "portbench" / "metrics" / f"{m['name']}.py", f"portbench_metric_{m['name']}").read(view)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, root: Optional[Path] = None, devices: Callable = require_devices) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="one of the driver's controls: the reference in the program's place with a "
                         "broken guarantee (a check of the check: `correct` must come out false)")
    args = ap.parse_args(argv)
    root = Path(root) if root else HERE.parent
    spec = cell_spec(root, args.workload)
    device = devices(int(spec["cell"]["chips"]))

    import torch

    pin_host(device)
    driver = load_file(root / "portbench" / "drivers" / f"{spec['config']['entry']}.py",
                       f"portbench_driver_{spec['config']['entry']}")
    traffic = spec["traffic"]
    try:
        cell = driver.setup(spec["config"], traffic, args.seed, device, control=args.control)
    except ValueError as e:
        raise RunError(str(e))
    call = cell.call
    warmup = int(traffic.get("warmup_calls", 1))
    for i in range(warmup):
        call(i)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()
    setup_s = time.perf_counter() - T_START
    min_calls = int(traffic.get("min_calls", 1))

    if args.trace:
        import devtrace

        with devtrace.Recorder(driver) as rec:
            results, lat, t0, t1 = run_window(call, args.seconds, min_calls, warmup, span=rec.span)
    else:
        results, lat, t0, t1 = run_window(call, args.seconds, min_calls, warmup)

    found = forbidden_loaded()
    if found:
        raise RunError(f"modules of JAX or of the JAX package are loaded: {', '.join(found)}")
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": int(spec["cell"]["chips"]),
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0,
    }

    breakdown = None
    if args.trace:
        view = rec.view(cell, len(results))
        sys.stderr.write(f"trace: {len(view.device)} device events in the window, "
                         f"the card's clock {view.clock_offset_ns} ns after the host's\n")
        metrics = read_metrics(root, spec["per_layer"], view)
        if view.window_ns > 0:
            device_info["busy_s"] = view.busy_ns / 1e9
            device_info["window_s"] = view.window_ns / 1e9
        breakdown = view.breakdown()
    else:
        metrics = read_metrics(root, spec["end_to_end"], WindowView(lat, t1 - t0, cell.items_per_call, setup_s, quantile))

    attempted = len(results)
    collected = cell.collect(results)
    del call, results
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = cell.check(collected)
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    for name, v in checks.items():
        sys.stderr.write(f"check {name}: {v['value']} (limit {v['limit']})\n")
    out = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
