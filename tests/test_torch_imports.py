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
