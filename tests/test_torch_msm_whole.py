"""The whole streaming MSM of curdleproofs_tpu_torch, msm(method="stream",
device="cpu"), vs the JAX package's msm_pippenger_stream and vs the host
oracle on every path: edge inputs, non-power-of-two n, the doubling-collision
redo, slot overflow, STREAM_SPLIT slices, GLV on and off. Small sizes with
the thresholds lowered; every comparison is exact."""
import functools
import random

import numpy as np
import pytest
import torch

from curdleproofs_tpu.curve import G1 as JG1
from curdleproofs_tpu.ops import g1 as jog
from curdleproofs_tpu.ops import msm as jmsm
from curdleproofs_tpu_torch import msm
from curdleproofs_tpu_torch.curve import G1, msm_host
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.ops import glv as tglv
from curdleproofs_tpu_torch.ops import msm as tmsm
from curdleproofs_tpu_torch.ops import stream_scan as tstream
from curdleproofs_tpu_torch.ops.fieldspec import ints_to_limbs

# The lanes here are few: intra-op threads add nothing but spin-waiting, which
# slows every worker of a parallel test run many times over.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _pool():
    """256 distinct random points, made once at first use."""
    rng = random.Random(0xABCD)
    return tuple(G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(256))


def rand_points(n):
    if n > 256:
        raise ValueError("the pool holds 256 distinct points")
    return list(_pool()[:n])


def rand_scalars(n, seed=1):
    r = random.Random(seed)
    return [Fr(r.randrange(FR_MOD)) for _ in range(n)]


def limbs(scalars):
    return np.asarray(ints_to_limbs([s.v for s in scalars], 16), dtype=np.uint32)


def jax_points(pts):
    return jog.pack_points([JG1.identity() if p.inf else JG1(p.x, p.y) for p in pts])


def same_point(t: G1, j: JG1) -> bool:
    return (t.inf and j.inf) or (not t.inf and not j.inf and (t.x, t.y) == (j.x, j.y))


EDGE_SCALARS = [0, 1, FR_MOD - 1, tglv.LAMBDA, tglv.LAMBDA + 1, tglv.LAMBDA - 1]


# ---------------------------------------------------------------------------
# the whole MSM
# ---------------------------------------------------------------------------


def _edge_inputs(n):
    pts = rand_points(n - 4) + [G1.identity(), G1()] + [G1() * Fr(3)] * 2
    scs = rand_scalars(n - 3, seed=n) + [Fr(0), Fr(0), Fr(5)]
    pts[2] = pts[3]  # duplicate base
    scs[4] = scs[5] = Fr(7)  # duplicate digits everywhere
    pts[6] = -pts[7]
    return pts, scs


def _distinct_inputs(n):
    """No repeated base, so the no-doubling scan never flags; still an
    identity base, zero scalars and a non-power-of-two n."""
    pts = rand_points(n - 1) + [G1.identity()]
    scs = rand_scalars(n - 2, seed=n) + [Fr(0), Fr(5)]
    return pts, scs


def _lambda_inputs(n):
    pts = rand_points(n - 3) + [G1.identity(), G1()] + [G1() * Fr(3)]
    scs = rand_scalars(n - 6, seed=n) + [Fr(v) for v in EDGE_SCALARS]
    return pts, scs


def _equal_inputs(n):
    return [G1() * Fr(11)] * n, [Fr(7)] * n


# name -> (inputs, c, port settings, expected path)
SEL_ON = dict(SEL_MIN_N=256, _LANES=32)
WHOLE = {
    "edge_inputs_full_prefix": (lambda: _edge_inputs(100), 8, {}, "full"),
    "non_pow2_sel_scan": (lambda: _distinct_inputs(250), 9, SEL_ON, "sel"),
    "edge_inputs_sel_scan": (lambda: _edge_inputs(250), 9, SEL_ON, "sel, redo allowed"),
    "doubling_collision_redo": (lambda: _equal_inputs(256), 9, SEL_ON, "sel+redo"),
    "slot_overflow_full_prefix": (
        lambda: _edge_inputs(250), 9, dict(SEL_ON, SEL_SLOT_OPTIONS=(2, 4)), "full",
    ),
    "stream_split_slices": (lambda: _edge_inputs(200), None, dict(STREAM_SPLIT=128), "full"),
    "glv_on": (lambda: _lambda_inputs(60), 8, dict(STREAM_GLV=True), "full"),
    "glv_off": (lambda: _lambda_inputs(60), 8, dict(STREAM_GLV=False), "full"),
    "duplicate_runs_tiny": (lambda: ([G1() * Fr(11)] * 16, [Fr(1)] * 16), 8, {}, "full"),
}


@pytest.mark.parametrize("name", sorted(WHOLE))
def test_msm_stream_equals_jax_and_oracle(name, monkeypatch):
    make, c, settings, path = WHOLE[name]
    pts, scs = make()
    for k, v in settings.items():
        if k == "_LANES":
            monkeypatch.setattr(tstream, "_LANES", v)
        else:
            monkeypatch.setattr(tmsm, k, v)
    for k in ("STREAM_SPLIT", "STREAM_GLV"):
        if k in settings:
            monkeypatch.setattr(jmsm, k, settings[k])

    calls = {"full": 0, "sel": 0, "safe": 0}
    full, sel, impl = tmsm._stream_window_partials, tmsm._stream_window_partials_sel, tmsm._msm_stream_impl

    def spy_full(*a, **k):
        calls["full"] += 1
        return full(*a, **k)

    def spy_sel(*a, **k):
        calls["sel"] += 1
        return sel(*a, **k)

    def spy_impl(points, scalars_np, c, window_batch=None, sel_scan=None, _safe=False):
        calls["safe"] += int(_safe)
        return impl(points, scalars_np, c, window_batch, sel_scan, _safe)

    monkeypatch.setattr(tmsm, "_stream_window_partials", spy_full)
    monkeypatch.setattr(tmsm, "_stream_window_partials_sel", spy_sel)
    monkeypatch.setattr(tmsm, "_msm_stream_impl", spy_impl)

    got = msm(pts, scs, c=c, method="stream", device="cpu")
    assert got == msm_host(pts, scs)
    want = jmsm.msm_pippenger_stream(jax_points(pts), limbs(scs), c=c)
    assert same_point(got, want)
    if path == "full":
        assert calls["sel"] == 0 and calls["full"] > 0 and calls["safe"] == 0
    elif path == "sel":
        assert calls["sel"] > 0 and calls["full"] == 0 and calls["safe"] == 0
    elif path == "sel+redo":  # flagged fast path, then the complete redo
        assert calls["sel"] > 0 and calls["full"] > 0 and calls["safe"] == 1
    else:  # repeated bases may or may not meet in one lane: exact either way
        assert calls["sel"] > 0 and calls["full"] == calls["safe"] * calls["sel"]


def test_msm_window_chunking_matches_oracle(monkeypatch):
    """window_batch smaller than W: several chunks, the last one short."""
    pts, scs = _edge_inputs(100)
    tp = tog.pack_points(pts, "cpu")
    got = tmsm.msm_pippenger_stream(tp, limbs(scs), c=8, window_batch=7)
    assert got == msm_host(pts, scs)


def test_msm_dispatch():
    pts, scs = rand_points(20), rand_scalars(20)
    assert msm([], [], device="cpu").is_identity()
    assert msm(pts[:16], scs[:16], device="cpu") == msm_host(pts[:16], scs[:16])  # host branch
    with pytest.raises(ValueError):
        msm(pts, scs[:-1], device="cpu")
    # auto between the host threshold and STREAM_MIN: the GLV ladder
    assert msm(pts, scs, device="cpu") == msm_host(pts, scs)
    for method in ("hostsort", "pippenger"):
        with pytest.raises(NotImplementedError, match="pippenger"):
            msm(pts, scs, method=method, device="cpu")
