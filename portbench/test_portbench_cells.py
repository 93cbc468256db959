"""A run of a cell on the CPU at a tiny size: set-up, the window, the
reference's verdict, the control and the faults it must catch, the import
check; and the real cell on the card where there is one."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import reference
import run
from conftest import HERE, ROOT, TINY_CELL, TINY_METRIC, TINY_SMALL_CELL
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.ops import g1 as og
from curdleproofs_tpu_torch.ops import msm as omsm


def test_tiny_cell_is_correct_and_reports_its_metrics(run_cell):
    res, err = run_cell()
    assert res["correct"] is True
    assert res["attempted"] == 3 and res["failed"] == 0
    assert set(res["metrics"]) == {"msm_points_per_s", "msm_p90_ms", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert res["checks"] == {"mismatched_calls": {"value": 0, "limit": 0},
                             "mismatched_bases": {"value": 0, "limit": 0}}
    assert err.strip().splitlines()[-2:] == ["check mismatched_calls: 0 (limit 0)",
                                             "check mismatched_bases: 0 (limit 0)"]


def test_traced_run_reads_only_what_it_finds(run_cell):
    """On the CPU no device event exists: every device reader stays silent
    (no 0 for a share of a roofline), the throwaway counter reads."""
    res, _ = run_cell(trace=1)
    assert res["correct"] is True
    assert res["metrics"] == {TINY_METRIC: {"value": 3, "unit": "calls"}}


def test_a_sampler_added_as_a_file_drives_a_cell(run_cell):
    res, _ = run_cell(cell=TINY_SMALL_CELL)
    assert res["correct"] is True and res["attempted"] == 3


def _cell(tiny_root, seed, cell=TINY_CELL):
    spec = run.cell_spec(tiny_root, cell)
    driver = run.load_file(tiny_root / "portbench" / "drivers" / "msm_pippenger.py", "drv")
    return driver.setup(spec["config"], spec["traffic"], seed, torch.device("cpu"))


def _ints(limbs):
    return [reference.limbs_to_int(col) for col in limbs.T.tolist()]


def test_same_seed_same_inputs(tiny_root):
    a, b = _cell(tiny_root, 2**31 + 7), _cell(tiny_root, 2**31 + 7)
    assert (a.b_host == b.b_host).all() and torch.equal(a.scalars, b.scalars)
    assert torch.equal(a.bases.x, b.bases.x)
    # every value drawn is below r, and no base is the identity
    assert all(0 <= v < reference.R for v in _ints(a.s0_host) + _ints(a.b_host))
    assert not bool(a.bases.inf.any())
    # each call draws the same new lanes on both, one lane a stride
    for i in range(3):
        a.entry = b.entry = lambda *args, **kw: None
        a.call(i), b.call(i)
        (_, la, va), (_, lb, vb) = a.rewrites[-1], b.rewrites[-1]
        assert torch.equal(la, lb) and torch.equal(va, vb)
        assert (la // a.stride).tolist() == list(range(a.lanes))
    assert torch.equal(a.scalars, b.scalars)


def test_each_call_gets_new_scalars_and_the_reference_follows(tiny_root):
    """The reference's running dot product, after each call, against one
    worked out afresh from the scalars the call saw."""
    cell = _cell(tiny_root, 77)
    seen = []
    cell.entry = lambda points, scalars, c=None: seen.append(scalars.clone())
    for i in range(5):
        cell.call(i)
    assert all(not torch.equal(x, y) for x, y in zip(seen, seen[1:]))
    rewrites = [(i, l.numpy(), v.numpy().astype("int64")) for i, l, v in cell.rewrites]
    dots = cell._dots(rewrites, {1, 3, 4})
    assert dots == {i: reference.dot_mod_r(seen[i].numpy().astype("int64"), cell.b_host) for i in (1, 3, 4)}
    truncated = cell._dots(rewrites, {4}, bits=240)
    assert truncated[4] == reference.dot_mod_r(reference.truncated(seen[4].numpy(), 240), cell.b_host)
    assert truncated[4] != dots[4]


def test_control_fails(run_cell):
    res, _ = run_cell("--control", "top_window_dropped")
    assert res["correct"] is False
    assert res["checks"]["mismatched_calls"]["value"] == res["attempted"] == 3


def test_unknown_control_prints_no_result(tiny_root, capsys):
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", TINY_CELL, "--seed", "1", "--seconds", "0", "--control", "none_such"],
                 root=tiny_root, devices=lambda n: torch.device("cpu"))
    assert e.value.code == 2 and capsys.readouterr().out == ""


def _stale(orig):
    first = []

    def f(points, scalars, c=None, window_batch=None):
        if not first:
            first.append(orig(points, scalars, c=c))
        return first[0]

    return f


def _half(orig):
    def f(points, scalars, c=None, window_batch=None):
        h = points.x.shape[-1] // 2
        return orig(og.APoints(points.x[:, :h], points.y[:, :h], points.inf[:h]), scalars[:, :h], c=c)

    return f


def _altered(orig):
    def f(res, c, W):
        return orig(res, c, W) + G1()

    return f


# the faults this cell can have, each planted in the timed path; it runs on
# one card, so it has no exchange between chips to leave out
FAULTS = {
    "state_returned_unchanged": ("msm_pippenger", _stale),
    "half_the_batch_left_out": ("msm_pippenger", _half),
    "answer_altered_where_produced": ("_combine_packed", _altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_in_the_timed_path_is_caught(run_cell, monkeypatch, fault):
    name, make = FAULTS[fault]
    monkeypatch.setattr(omsm, name, make(getattr(omsm, name)))
    res, _ = run_cell()
    assert res["correct"] is False
    assert res["failed"] > 0


def test_import_check_compares_top_level_names_whole():
    assert run.forbidden_loaded(["curdleproofs_tpu_torch", "curdleproofs_tpu_torch.ops.msm", "numpy"]) == []
    assert run.forbidden_loaded(["curdleproofs_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "curdleproofs_tpu", "flax", "jax", "jaxlib"]


def test_cell_loads_no_jax(tiny_root):
    """In a fresh process: after set-up and the window, the run's own check
    passes and no JAX module is loaded."""
    code = (
        "import sys, json, torch; sys.path[:0] = [%r, %r]; import run\n"
        "run.main(['--workload', %r, '--seed', '5', '--seconds', '0'], root=__import__('pathlib').Path(%r),"
        " devices=lambda n: torch.device('cpu'))\n"
        "print(json.dumps([run.forbidden_loaded(), 'curdleproofs_tpu_torch' in sys.modules]))\n"
    ) % (str(ROOT), str(HERE), TINY_CELL, str(tiny_root))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-2])["correct"] is True
    assert json.loads(lines[-1]) == [[], True]  # the port is loaded, and passes


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "msm_range_sync_1024", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.gpu
def test_cell_on_the_card():
    """The committed cell, one short run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "msm_range_sync_1024",
                           "--seed", "4000000001", "--seconds", "2", "--trace", "0"],
                          capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
