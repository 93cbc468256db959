"""msm_pippenger_stream(routed=True) of curdleproofs_tpu_torch on the CPU (the
plain versions of the kernels) vs the host oracle and vs the JAX package's
msm_pippenger_stream(routed=True), under the thresholds the JAX package's own
tests lower (ROUTE_MIN_FACTOR = 8; ROUTE_MIN_N = 256 there, the port has no
such threshold). Every comparison is exact."""
import functools
import random

import numpy as np
import pytest
import torch

from curdleproofs_tpu.curve import G1 as JG1
from curdleproofs_tpu.ops import g1 as jog
from curdleproofs_tpu.ops import msm as jmsm
from curdleproofs_tpu.ops import stream_scan as jstream
from curdleproofs_tpu_torch.curve import G1, msm_host
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.ops import msm as tmsm
from curdleproofs_tpu_torch.ops import stream_scan as tstream
from curdleproofs_tpu_torch.ops.fieldspec import ints_to_limbs

# The lanes here are few: intra-op threads add nothing but spin-waiting, which
# slows every worker of a parallel test run many times over.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _pool():
    rng = random.Random(0xABCD)
    return tuple(G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(256))


def _inputs(n):
    """Identity, zero scalars, a repeated base; n pads to 256."""
    r = random.Random(n)
    pts = list(_pool()[: n - 4]) + [G1.identity(), G1()] + [G1() * Fr(3)] * 2
    scs = [Fr(r.randrange(FR_MOD)) for _ in range(n - 3)] + [Fr(0), Fr(0), Fr(5)]
    return pts, scs


def limbs(scalars):
    return np.asarray(ints_to_limbs([s.v for s in scalars], 16), dtype=np.uint32)


def jax_points(pts):
    return jog.pack_points([JG1.identity() if p.inf else JG1(p.x, p.y) for p in pts])


def same_point(t: G1, j: JG1) -> bool:
    return (t.inf and j.inf) or (not t.inf and not j.inf and (t.x, t.y) == (j.x, j.y))


@pytest.fixture
def lowered(monkeypatch):
    monkeypatch.setattr(jmsm, "ROUTE_MIN_N", 256)
    for mod in (tmsm, jmsm):
        monkeypatch.setattr(mod, "ROUTE_MIN_FACTOR", 8)
    monkeypatch.setattr(tmsm, "SEL_MIN_N", 256)
    return monkeypatch


def _spy(monkeypatch):
    """Count the calls of the four device bodies and of the redo."""
    calls = {"direct": 0, "direct_sel": 0, "routed": 0, "routed_sel": 0, "safe": 0, "safe_routed": 0}
    names = {
        "direct": "_stream_window_partials",
        "direct_sel": "_stream_window_partials_sel",
        "routed": "_stream_window_partials_routed",
        "routed_sel": "_stream_window_partials_routed_sel",
    }
    for key, name in names.items():
        orig = getattr(tmsm, name)

        def wrapped(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(tmsm, name, wrapped)
    impl = tmsm._msm_stream_impl

    def spy_impl(points, scalars_np, c, window_batch=None, sel_scan=None, routed=None, _safe=False):
        calls["safe"] += int(_safe)
        calls["safe_routed"] += int(_safe and bool(routed))
        return impl(points, scalars_np, c, window_batch, sel_scan, routed, _safe)

    monkeypatch.setattr(tmsm, "_msm_stream_impl", spy_impl)
    return calls


# name -> (n, lanes, window_batch, sel_scan of the port)
ROUTED = {
    "n200_full_prefix": (200, 0, 13, False),
    "n250_sel_scan": (250, 32, 5, None),
}


@pytest.mark.parametrize("name", sorted(ROUTED))
def test_msm_stream_routed_equals_jax_and_oracle(name, lowered):
    n, lanes, wb, sel_scan = ROUTED[name]
    lowered.setattr(tstream, "_LANES", lanes)
    lowered.setattr(jstream, "_LANES", lanes)
    pts, scs = _inputs(n)
    calls = _spy(lowered)
    got = tmsm.msm_pippenger_stream(
        tog.pack_points(pts, "cpu"), limbs(scs), c=9, window_batch=wb, sel_scan=sel_scan, routed=True
    )
    assert got == msm_host(pts, scs)
    want = jmsm.msm_pippenger_stream(jax_points(pts), limbs(scs), c=9, window_batch=wb, routed=True)
    assert same_point(got, want)
    assert calls["direct"] == calls["direct_sel"] == 0
    if sel_scan is False:
        assert calls["routed"] == -(-15 // wb) and calls["routed_sel"] == 0 and calls["safe"] == 0
    else:  # the repeated base may meet itself in one lane: then one routed redo
        assert calls["routed_sel"] == -(-15 // wb)
        assert calls["routed"] == calls["safe"] * -(-15 // tmsm.ROUTE_WINDOW_BATCH)
        assert calls["safe_routed"] == calls["safe"] <= 1


def test_msm_stream_routed_collision_takes_the_redo_once_routed(lowered):
    """All-equal points and scalars: every lane's second record equals its
    running prefix, the no-doubling scan flags it, and the redo runs on the
    complete scan, still behind the routed gather."""
    lowered.setattr(tstream, "_LANES", 32)
    lowered.setattr(jstream, "_LANES", 32)
    n = 256
    pts, scs = [G1() * Fr(11)] * n, [Fr(7)] * n
    calls = _spy(lowered)
    got = tmsm.msm_pippenger_stream(tog.pack_points(pts, "cpu"), limbs(scs), c=9, routed=True)
    assert got == msm_host(pts, scs)
    chunks = -(-15 // tmsm.ROUTE_WINDOW_BATCH)  # routed: chunks of ROUTE_WINDOW_BATCH windows
    assert calls == {
        "direct": 0, "direct_sel": 0, "routed_sel": chunks, "routed": chunks, "safe": 1, "safe_routed": 1,
    }
    want = jmsm.msm_pippenger_stream(jax_points(pts), limbs(scs), c=9, routed=True)
    assert same_point(got, want)


def test_routed_default_is_the_direct_gather(lowered):
    """routed=None takes the direct bodies, also at a size the routed gather
    could take; routed=True on the same inputs takes the routed ones."""
    lowered.setattr(tstream, "_LANES", 32)
    pts, scs = _inputs(100)  # pads to 128, 256 GLV lanes
    tp, sc = tog.pack_points(pts, "cpu"), limbs(scs)
    want = msm_host(pts, scs)
    calls = _spy(lowered)
    assert tmsm.msm_pippenger_stream(tp, sc, c=10, sel_scan=False) == want
    assert calls["direct"] > 0 and calls["routed"] == calls["routed_sel"] == 0
    assert tmsm.msm_pippenger_stream(tp, sc, c=10, sel_scan=False, routed=True) == want
    assert calls["routed"] > 0 and calls["routed_sel"] == calls["direct_sel"] == 0


def test_routed_constants_equal_jax(monkeypatch):
    assert tmsm.ROUTE_MIN_FACTOR == jmsm.ROUTE_MIN_FACTOR
    assert tmsm.ROUTE_WINDOW_BATCH == 2
    assert tmsm._route_pool() is tmsm._route_pool()
    with pytest.raises(ValueError):  # 256 lanes cannot be routed with factors >= 128
        tmsm.msm_pippenger_stream(
            tog.pack_points(list(_pool()[:100]), "cpu"), limbs([Fr(3)] * 100), c=8, routed=True
        )
