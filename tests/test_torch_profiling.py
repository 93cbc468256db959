"""The port's `utils.profiling` (`collect`, `metrics_report`, `device_trace`,
`busy_summary`) and `ops.g1.unpack_scalars`, the counterparts of the JAX
package's names of the same modules: the metrics registry as
tests/test_api_and_metrics.py drives the JAX package's, a device trace on the
CPU landing in a temporary directory, the busy share of synthetic device
intervals, and scalars round-tripped against the JAX package's limbs."""
import json
import random

import numpy as np
import torch

from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_metrics_registry_records_msm():
    from curdleproofs_tpu_torch import msm

    rng = random.Random(5)
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(8)]
    scs = [Fr(rng.randrange(FR_MOD)) for _ in range(8)]
    with profiling.collect() as reg:
        msm(pts, scs, device="cpu")
    assert reg is profiling.metrics()
    rep = profiling.metrics_report()
    assert any(k.startswith("msm.") for k in rep), rep
    entry = next(v for k, v in rep.items() if k.startswith("msm."))
    assert entry["calls"] == 1
    assert entry["total_point_ops"] > 0
    assert entry["point_ops_per_s"] is None or entry["point_ops_per_s"] > 0
    with profiling.collect():  # a new region starts empty
        assert profiling.metrics_report() == {}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    a = torch.arange(64, dtype=torch.int64)
    with profiling.device_trace(str(logdir)) as prof:
        (a * a).sum()
    files = list(logdir.glob("trace_*.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert trace["traceEvents"]
    s = profiling.trace_summary(prof)
    # on the CPU nothing runs on a card
    assert s["device_ms"] == 0 and s["by_name"] == {} and s["window_ms"] > 0
    # the window as the caller's wall clock around the region
    assert profiling.trace_summary(prof, 0.5)["window_ms"] == 500


def test_busy_summary_counts_overlap_once():
    dev = [("k1", 10.0, 20.0), ("k2", 15.0, 30.0), ("k1", 50.0, 60.0), ("copy", 60.0, 61.0)]
    s = profiling.busy_summary(dev, (0.0, 100.0))
    assert s["device_ms"] == (10 + 15 + 10 + 1) / 1e3
    assert s["busy_ms"] == (20 + 11) / 1e3
    assert s["busy_share"] == 0.31
    assert s["by_name"] == {"copy": {"launches": 1, "ms": 0.001}, "k1": {"launches": 2, "ms": 0.02},
                            "k2": {"launches": 1, "ms": 0.015}}
    empty = profiling.busy_summary([], (5.0, 5.0))
    assert empty["busy_share"] is None and empty["device_ms"] == 0


def test_unpack_scalars_round_trips_against_jax():
    from curdleproofs_tpu.ops import g1 as jog

    from curdleproofs_tpu.fields import Fr as JFr
    from curdleproofs_tpu_torch.ops.fieldspec import to_reference

    rng = np.random.default_rng(11)
    vals = [0, 1, FR_MOD - 1] + [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(13)]
    packed = tog.pack_scalars([Fr(v) for v in vals], "cpu")
    jpacked = jog.pack_scalars([JFr(v) for v in vals])
    assert np.array_equal(to_reference(packed), np.asarray(jpacked))
    assert [s.v for s in tog.unpack_scalars(packed)] == vals
    assert [s.v for s in tog.unpack_scalars(np.asarray(jpacked))] == [s.v for s in jog.unpack_scalars(jpacked)] == vals
    assert [s.v for s in tog.unpack_scalars(packed[:, 4])] == [vals[4]]  # one scalar, (16,)
