"""`parallel.dryrun.entry()`, the port's counterpart of the JAX package's
single-device entry (`__graft_entry__.entry`): one Pippenger
window-partials step at n = 1024 points and c = 8 bits.

The JAX side is built here the way its `entry()` builds it (the same
deterministic points and scalars, `ops.msm._window_partials` at c = 8),
without importing `__graft_entry__`, whose import builds the JAX package's
native extensions in the tree. Both forwards run once, on the CPU; the
window total and the 32 bucket sums must be the same points (the Jacobian
triples may differ: the port sorts and gathers on its own kernels' plain
versions, `ROADMAP.md`, "One amendment"), and the whole MSM recombined from
them must equal the exact host MSM."""
import hashlib

import numpy as np
import pytest
import torch

from curdleproofs_tpu_torch.curve import G1, msm_host
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.ops import msm as tmsm
from curdleproofs_tpu_torch.parallel import dryrun

torch.set_num_threads(1)

N, C = 1024, 8


def _jax_forward():
    """The JAX entry's forward on its inputs, jitted and run once on the
    CPU: (total, bucket sums) as affine (x, y) integer pairs, None for the
    identity."""
    import jax

    from curdleproofs_tpu.curve import G1 as JG1
    from curdleproofs_tpu.fields import FR_MOD as JFR_MOD
    from curdleproofs_tpu.fields import Fr as JFr
    from curdleproofs_tpu.ops import g1 as jog
    from curdleproofs_tpu.ops import msm as jmsm
    from curdleproofs_tpu.ops.g1 import APoints

    pts, acc, g = [], JG1(), JG1()
    for _ in range(N):
        pts.append(acc)
        acc = acc + g
    scs = [JFr(int.from_bytes(hashlib.sha256(f"7:{i}".encode()).digest(), "little") % JFR_MOD) for i in range(N)]
    points = jog.pack_points(pts)
    digits = jmsm.extract_digits(jog.pack_scalars(scs), C)

    @jax.jit
    def forward(px, py, pinf, digits):
        return jmsm._window_partials(APoints(px, py, pinf), digits, C)

    total, bsums = forward(points.x, points.y, points.inf, digits)
    to_host = lambda jp: [None if p.is_identity() else (p.x, p.y) for p in jog.jpoints_to_host(jp)]
    return to_host(jax.tree_util.tree_map(lambda a: a[:, None], total)), to_host(bsums)


def _affine(points):
    return [None if p.is_identity() else (p.x, p.y) for p in points]


def test_entry_equals_the_jax_forward():
    forward, (packed, digits) = dryrun.entry(device="cpu")
    W = -(-tmsm.FR_BITS // C)
    assert tuple(packed.shape) == (49, N) and tuple(digits.shape) == (W, N) == (32, N)
    assert packed.device.type == "cpu" and digits.device.type == "cpu"
    # the inputs are the JAX entry's, value for value
    pts, scs = dryrun.points_and_scalars(N)
    assert pts[:3] == [G1(), G1() * Fr(2), G1() * Fr(3)]
    assert scs[5] == Fr(int.from_bytes(hashlib.sha256(b"7:5").digest(), "little") % FR_MOD)
    assert np.array_equal(digits.numpy(), tmsm.extract_digits(tog.pack_scalars(scs, "cpu"), C).numpy())

    total, bsums = forward(packed, digits)
    assert tuple(total.x.shape) == (24,) and tuple(bsums.x.shape) == (24, W)
    got_total = tog.jpoints_to_host(tog.JPoints(total.x[:, None], total.y[:, None], total.z[:, None]))
    got_bsums = tog.jpoints_to_host(bsums)

    want_total, want_bsums = _jax_forward()
    assert _affine(got_total) == want_total
    assert _affine(got_bsums) == want_bsums
    # and they are the MSM's: S = sum_w 2^(c w) ((2^c - 1) total - bsums[w])
    assert tmsm._combine_windows_host(got_total[0], got_bsums, C, W) == msm_host(pts, scs)


def test_entry_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.entry()
