"""The port stands alone: importing it (or chip_smoke) pulls in neither jax
nor the JAX package, and its entry points refuse to run without a CUDA device
unless the caller names the CPU."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
import {module}
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "jaxlib" or m == "curdleproofs_tpu" or m.startswith("curdleproofs_tpu."))
print("BAD=" + ",".join(bad))
"""


@pytest.mark.parametrize(
    "module",
    [
        "curdleproofs_tpu_torch",
        "curdleproofs_tpu_torch.ops",
        "curdleproofs_tpu_torch.ops.msm",
        "curdleproofs_tpu_torch.ops.cuda_g1",
        "curdleproofs_tpu_torch.ops.stream_scan",
        "curdleproofs_tpu_torch.ops.gather",
        "curdleproofs_tpu_torch.ops.scan",
        "curdleproofs_tpu_torch.ops.g1",
        "curdleproofs_tpu_torch.ops.vector",
        "curdleproofs_tpu_torch.ops.modarith",
        "curdleproofs_tpu_torch.ops.route",
        "curdleproofs_tpu_torch.ops.glv",
        "curdleproofs_tpu_torch.utils.host_native",
        "curdleproofs_tpu_torch.utils.profiling",
        "curdleproofs_tpu_torch.curve",
        "curdleproofs_tpu_torch.ops.compress",
        "curdleproofs_tpu_torch.vectors",
        "curdleproofs_tpu_torch.transcript",
        "curdleproofs_tpu_torch.transcript.oracle",
        "curdleproofs_tpu_torch.protocol",
        "curdleproofs_tpu_torch.protocol.whisk",
        "curdleproofs_tpu_torch.protocol.shuffle",
        "curdleproofs_tpu_torch.utils.lockstep",
        "curdleproofs_tpu_torch.utils.serde",
        "curdleproofs_tpu_torch.utils.rng",
        "curdleproofs_tpu_torch.utils.errors",
        "curdleproofs_tpu_torch.parallel",
        "curdleproofs_tpu_torch.parallel.distributed",
        "curdleproofs_tpu_torch.parallel.mesh",
        "curdleproofs_tpu_torch.parallel.msm",
        "curdleproofs_tpu_torch.parallel.dryrun",
        "chip_smoke",
    ],
)
def test_import_pulls_in_no_jax(module):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", PROBE.format(module=module)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "BAD=\n" in proc.stdout + "\n", proc.stdout


def test_sources_name_no_jax_import():
    import re

    pat = re.compile(r"^\s*(import jax|from jax|import curdleproofs_tpu(\s|\.|$)|from curdleproofs_tpu(\s|\.))", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "curdleproofs_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_entry_points_refuse_to_run_without_a_card():
    import curdleproofs_tpu_torch as pkg
    from curdleproofs_tpu_torch import G1, Fr, msm
    from curdleproofs_tpu_torch.ops import g1 as og
    from curdleproofs_tpu_torch.ops.fieldspec import from_reference
    from curdleproofs_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    import numpy as np

    pts, scs = [G1()] * 3, [Fr(2)] * 3
    for call in (
        lambda: msm(pts, scs),
        lambda: msm([], []),
        lambda: msm(pts, scs, device="cuda"),
        lambda: msm(pts, scs, method="ladder"),
        lambda: msm(pts, scs, method="pippenger"),
        lambda: msm(pts, scs, method="hostsort"),
        lambda: pkg.scale_points(pts, scs),
        lambda: pkg.scale_points_common(pts, scs[0]),
        lambda: pkg.fold_points(pts, pts, scs[0]),
        lambda: pkg.fold_points_multi(pts, pts, scs),
        lambda: pkg.add_points(pts, pts),
        lambda: og.pack_points(pts),
        lambda: og.pack_scalars(scs),
        lambda: from_reference(np.zeros((24, 1), np.uint32)),
        lambda: resolve_device(None),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert msm(pts, scs, device="cpu") == G1() * Fr(6)
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_wrappers_have_no_cpu_path_for_cuda_requests():
    """A wrapper takes the plain version only because its tensor lies on the
    CPU; the low-level launchers reject CPU tensors outright."""
    from curdleproofs_tpu_torch.ops import cuda_g1

    x = torch.zeros((24, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_g1.point_op("jdbl", [x, x, x])
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_g1.check_tensor("t", x, (24, 4))
    from curdleproofs_tpu_torch.ops.g1 import APoints

    from curdleproofs_tpu_torch.ops import gather as ogather

    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_g1.check_tensor("rowwise_gather table", torch.zeros((2, 3, 4), dtype=torch.int32), (2, 3, 4))
    # a CPU tensor takes the plain version and counts no launch
    ogather.rowwise_gather(torch.zeros((2, 3, 4), dtype=torch.int32), torch.zeros((2, 5), dtype=torch.int32))
    pts = APoints(x, x, torch.zeros(4, dtype=torch.bool))
    sc = torch.zeros((16, 4), dtype=torch.int32)
    for call in (lambda: cuda_g1.scalar_mul(pts, sc), lambda: cuda_g1.scalar_mul_w1(pts, sc)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert all(v == 0 for v in cuda_g1.launch_counts.values())


# ---------------------------------------------------------------------------
# the facade and the environment knobs, against the JAX package
# ---------------------------------------------------------------------------

FACADE_CONSTANTS = ("CURVE_ORDER", "FR_MOD", "FQ_MOD", "G1_GENERATOR", "G1_IDENTITY", "__version__")


def test_facade_has_the_reference_names():
    """Every top-level name of the JAX package (its eager names and the lazy
    protocol names of `models.api`) is a name of the port's facade, with the
    same value where it is a constant."""
    import curdleproofs_tpu as jpkg
    from curdleproofs_tpu.models import api as japi

    import curdleproofs_tpu_torch as pkg

    import types

    # the JAX package's own names: not its submodules, which importing them sets
    eager = [n for n, v in vars(jpkg).items() if not n.startswith("_") and not isinstance(v, types.ModuleType)]
    eager.append("__version__")
    reference = set(eager) | set(japi.__all__)
    assert set(FACADE_CONSTANTS) <= reference
    missing = sorted(n for n in reference if not hasattr(pkg, n))
    assert not missing, missing
    assert reference - {"__version__"} <= set(pkg.__all__) and "__version__" in pkg.__all__
    assert pkg.__version__ == jpkg.__version__ == "0.1.0"
    assert (pkg.CURVE_ORDER, pkg.FR_MOD, pkg.FQ_MOD) == (jpkg.CURVE_ORDER, jpkg.FR_MOD, jpkg.FQ_MOD)
    assert pkg.G1_GENERATOR.to_compressed_bytes() == jpkg.G1_GENERATOR.to_compressed_bytes()
    assert pkg.G1_IDENTITY.to_compressed_bytes() == jpkg.G1_IDENTITY.to_compressed_bytes()
    assert pkg.G1_GENERATOR == pkg.G1() and pkg.G1_IDENTITY == pkg.G1.identity()


# knob -> (module, constant, a value to set, the constant that value gives)
KNOBS = {
    "CURDLEPROOFS_STREAM_GLV": ("ops.msm", "STREAM_GLV", "0", False),
    "CURDLEPROOFS_STREAM_SPLIT": ("ops.msm", "STREAM_SPLIT", "0", 0),
    "CURDLEPROOFS_STREAM_MIN": ("ops.msm", "STREAM_MIN", "4096", 4096),
    "CURDLEPROOFS_SCAN_LANES": ("ops.stream_scan", "_LANES", "64", 64),
}

KNOB_PROBE = """
import json
from curdleproofs_tpu_torch.{module} import {constant} as v
print("VALUE=" + json.dumps(v))
"""


def _read_knob(knob, env_value):
    module, constant, _, _ = KNOBS[knob]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH" and k not in KNOBS}
    if env_value is not None:
        env[knob] = env_value
    proc = subprocess.run(
        [sys.executable, "-c", KNOB_PROBE.format(module=module, constant=constant)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    import json

    return json.loads(proc.stdout.split("VALUE=")[1])


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_knob_is_read_from_the_environment(knob):
    """Each knob the JAX package reads at import, under its name, changes the
    port's constant the same way."""
    _, _, value, want = KNOBS[knob]
    got = _read_knob(knob, value)
    assert got == want and type(got) is type(want)


def test_knob_defaults_are_the_reference_defaults():
    """Unset, each knob gives the JAX package's default (read in this
    process, where neither package saw the variables set by the tests)."""
    if any(k in os.environ for k in KNOBS):
        pytest.skip("a knob is set in this environment")
    from curdleproofs_tpu.ops import msm as jmsm
    from curdleproofs_tpu.ops import stream_scan as jstream

    from curdleproofs_tpu_torch.ops import msm as tmsm
    from curdleproofs_tpu_torch.ops import stream_scan as tstream

    assert (tmsm.STREAM_GLV, tmsm.STREAM_SPLIT, tmsm.STREAM_MIN) == (jmsm.STREAM_GLV, jmsm.STREAM_SPLIT, jmsm.STREAM_MIN)
    assert (tmsm.STREAM_GLV, tmsm.STREAM_SPLIT, tmsm.STREAM_MIN) == (True, 1 << 16, 1 << 14)
    assert tstream._LANES == jstream._LANES == 0


# ---------------------------------------------------------------------------
# the CUDA build under concurrent first use
# ---------------------------------------------------------------------------


def test_cuda_build_runs_once_under_concurrent_first_use(monkeypatch, tmp_path):
    """Two threads making the first launch at once: one `nvcc` a source, the
    temporary names carry process and thread, and both threads get the same
    bindings."""
    import threading
    import time
    import types

    from curdleproofs_tpu_torch.ops import cuda_g1

    started, loaded = [], []

    class FakeCompiler:
        def __init__(self, cmd, **kwargs):
            started.append(cmd)
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self):
            time.sleep(0.2)  # both threads are inside lib() by now
            with open(self.out, "w") as fh:
                fh.write("built")
            return "", ""

    def fake_cdll(path):
        loaded.append(path)
        return types.SimpleNamespace(**{n: (lambda *a: 0) for u in cuda_g1.ENTRY_POINTS.values() for n in u})

    monkeypatch.setattr(cuda_g1, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_g1, "_lib", None)
    monkeypatch.setattr(cuda_g1, "_find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_g1.subprocess, "Popen", FakeCompiler)
    monkeypatch.setattr(cuda_g1.ctypes, "CDLL", fake_cdll)
    barrier = threading.Barrier(2)
    got = [None, None]

    def first_launch(k):
        barrier.wait()
        got[k] = cuda_g1.lib()

    threads = [threading.Thread(target=first_launch, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert got[0] is not None and got[0] is got[1]
    assert len(started) == len(cuda_g1.ENTRY_POINTS)  # one compiler a source
    assert sorted(cmd[-1].rsplit("/", 1)[1] for cmd in started) == sorted(cuda_g1.ENTRY_POINTS)
    for cmd in started:
        tmp = cmd[cmd.index("-o") + 1]
        assert f".{os.getpid()}." in tmp and tmp.endswith(".tmp")
    assert sorted(loaded) == sorted(str(cuda_g1.library_path(u)) for u in cuda_g1.ENTRY_POINTS)
    assert all(os.path.exists(p) for p in loaded)
    assert cuda_g1.lib() is got[0] and len(started) == len(cuda_g1.ENTRY_POINTS)
