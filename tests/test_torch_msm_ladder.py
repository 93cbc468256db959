"""The ladder MSMs of curdleproofs_tpu_torch.ops.msm (`msm_ladder`,
`msm_ladder_segmented`, the ladder branch of `msm()`) vs the JAX package's on
the CPU and vs `msm_host`. CPU only, 17 to 129 lanes; every comparison is
exact equality of points."""
import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curdleproofs_tpu.curve import G1 as JG1
from curdleproofs_tpu.ops import g1 as jog
from curdleproofs_tpu.ops import msm as jmsm
from curdleproofs_tpu_torch import msm, msm_ladder, msm_ladder_segmented
from curdleproofs_tpu_torch.curve import G1, msm_host
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.ops import glv as tglv
from curdleproofs_tpu_torch.ops import msm as tmsm
from curdleproofs_tpu_torch.ops.fieldspec import ints_to_limbs
from curdleproofs_tpu_torch.utils.profiling import metrics

# The lanes here are few: intra-op threads add nothing but spin-waiting, which
# slows every worker of a parallel test run many times over.
torch.set_num_threads(1)

N, K = 24, 4


@functools.lru_cache(maxsize=None)
def _pool():
    rng = random.Random(0x1ADD)
    return tuple(G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(129))


def _scalars(n, seed):
    r = random.Random(seed)
    return [Fr(r.randrange(FR_MOD)) for _ in range(n)]


def _limbs(scalars):
    return np.asarray(ints_to_limbs([s.v for s in scalars], 16), dtype=np.uint32)


def _same_point(t: G1, j: JG1) -> bool:
    return (t.inf and j.inf) or (not t.inf and not j.inf and (t.x, t.y) == (j.x, j.y))


@pytest.fixture(scope="module")
def inputs():
    """24 lanes = 4 segments of 6: an identity base, a repeated base, a zero
    scalar, r - 1, lambda and 2^128 among uniform scalars."""
    pts = list(_pool()[:N])
    pts[3] = G1.identity()
    pts[8] = pts[7]
    scs = _scalars(N, seed=7)
    for i, k in ((5, 0), (9, FR_MOD - 1), (14, tglv.LAMBDA), (20, 1 << 128)):
        scs[i] = Fr(k)
    jpts = jog.pack_points([JG1.identity() if p.inf else JG1(p.x, p.y) for p in pts])
    return dict(pts=pts, scs=scs, sc=_limbs(scs), tp=tog.pack_points(pts, "cpu"), jpts=jpts)


def test_msm_ladder_equals_jax_and_host(inputs):
    metrics().reset()
    got = msm_ladder(inputs["tp"], inputs["sc"])
    assert got == msm_host(inputs["pts"], inputs["scs"])
    assert _same_point(got, jmsm.msm_ladder(inputs["jpts"], jnp.asarray(inputs["sc"])))
    rep = metrics().report()
    assert {"msm.ladder", "msm.ladder.decompose", "msm.ladder.device", "msm.ladder.readback"} <= set(rep)
    assert rep["msm.ladder"]["total_items"] == N
    assert rep["msm.ladder"]["total_point_ops"] == jmsm.ladder_point_ops(N)


def test_msm_ladder_w4_gives_the_same_point(inputs):
    assert msm_ladder(inputs["tp"], inputs["sc"], w=4) == msm_host(inputs["pts"], inputs["scs"])
    assert tmsm.ladder_point_ops(100, w=4) == (132 + 66 + 14 + 15) * 100 + 100
    assert tmsm.ladder_point_ops(100, w=3) == jmsm.ladder_point_ops(100)


def test_msm_ladder_segmented_equals_jax_and_host(inputs):
    m = N // K
    got = msm_ladder_segmented(inputs["tp"], inputs["sc"], K)
    want = [msm_host(inputs["pts"][k * m : (k + 1) * m], inputs["scs"][k * m : (k + 1) * m]) for k in range(K)]
    assert got == want
    jgot = jmsm.msm_ladder_segmented(inputs["jpts"], inputs["sc"], K)
    assert len(jgot) == K and all(_same_point(t, j) for t, j in zip(got, jgot))
    assert "msm.ladder_seg.device" in metrics().report()
    with pytest.raises(ValueError, match="divisible"):
        msm_ladder_segmented(inputs["tp"], inputs["sc"], 5)


def test_msm_naive_is_the_ladder(inputs, monkeypatch):
    seen = []
    monkeypatch.setattr(tmsm, "msm_ladder", lambda p, s: seen.append((p, s)) or "ladder")
    assert tmsm.msm_naive(inputs["tp"], inputs["sc"]) == "ladder" and len(seen) == 1


@pytest.mark.parametrize("n,method", [(17, "auto"), (40, "auto"), (129, "auto"), (20, "ladder"), (3, "ladder")])
def test_msm_goes_through_the_ladder(n, method):
    """`auto` sends 17 <= n < STREAM_MIN to the ladder; `ladder` forces it at
    any size. No pad to 128 lanes: identity and zero-scalar lanes are exact."""
    pts = list(_pool()[:n])
    scs = _scalars(n, seed=n)
    pts[1] = G1.identity()
    scs[2] = Fr(0)
    metrics().reset()
    assert msm(pts, scs, method=method, device="cpu") == msm_host(pts, scs)
    rep = metrics().report()
    assert rep["msm.ladder"]["calls"] == 1 and rep["msm.ladder"]["total_items"] == n
    assert "msm.ladder.pack" in rep and "msm.stream" not in rep


def test_msm_dispatch_and_the_methods_it_lacks(monkeypatch):
    calls = []
    monkeypatch.setattr(tmsm, "msm_ladder", lambda p, s: calls.append(("ladder", p.x.shape[-1])) or G1())
    monkeypatch.setattr(
        tmsm, "msm_pippenger_stream", lambda p, s, c=None: calls.append(("stream", p.x.shape[-1])) or G1()
    )
    monkeypatch.setattr(tmsm, "STREAM_MIN", 32)
    pts, scs = list(_pool()[:32]), _scalars(32, seed=1)
    msm(pts[:16], scs[:16], device="cpu")  # host arithmetic, neither engine
    msm(pts[:17], scs[:17], device="cpu")
    msm(pts[:31], scs[:31], device="cpu")
    msm(pts, scs, device="cpu")
    msm(pts[:5], scs[:5], method="stream", device="cpu")
    assert calls == [("ladder", 17), ("ladder", 31), ("stream", 32), ("stream", 5)]
    for method in ("pippenger", "hostsort"):
        with pytest.raises(NotImplementedError, match="pippenger"):
            msm(pts, scs, method=method, device="cpu")
    with pytest.raises(ValueError, match="length mismatch"):
        msm(pts, scs[:-1], method="ladder", device="cpu")
    assert msm([], [], method="ladder", device="cpu") == G1.identity()
