"""The native host library of curdleproofs_tpu_torch (csrc/host_prep.c, built
here by the C compiler of the machine) vs the port's numpy chain and vs the
JAX package's numpy chain, array for array."""
import random

import numpy as np
import pytest

from curdleproofs_tpu.ops import glv as jglv
from curdleproofs_tpu.ops import msm as jmsm
from curdleproofs_tpu_torch.fields import FR_MOD
from curdleproofs_tpu_torch.ops import glv as tglv
from curdleproofs_tpu_torch.ops import msm as tmsm
from curdleproofs_tpu_torch.ops.fieldspec import ints_to_limbs
from curdleproofs_tpu_torch.utils import host_native

SLOTS = (128, 256)


def _scalars(n, seed, edges=(0, FR_MOD - 1)):
    rng = random.Random(seed)
    vals = [rng.randrange(FR_MOD) for _ in range(n - len(edges))] + list(edges)
    return np.asarray(ints_to_limbs(vals, 16), dtype=np.uint32)


def test_library_builds_with_the_machines_compiler():
    assert host_native.find_cc() is not None
    assert host_native.available()
    host_native.lib()
    assert any(host_native.library_path(omp).exists() for omp in (True, False))
    assert host_native.library_path(True).parent.name == "build"
    assert host_native.openmp_threads() >= 0


def test_glv_decompose_batch_equals_numpy_and_jax():
    sc = np.concatenate(
        [_scalars(200, 3), np.asarray(ints_to_limbs(list(tglv.EDGE_SCALARS), 16), dtype=np.uint32)], axis=1
    )
    k1, neg, k2 = host_native.glv_decompose_batch(sc)
    assert k1.shape == k2.shape == (sc.shape[1], 3) and neg.shape == (sc.shape[1],)
    got = tglv.decompose(sc.astype(np.uint64))  # dispatches to the native call
    for want in (tglv.decompose_numpy(sc.astype(np.uint64)), jglv.decompose(sc.astype(np.uint64))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
    # limbs 9..11 of each half are zero: |k1| and k2 fit 144 bits
    assert not k1.view("<u2").reshape(-1, 12)[:, 9:].any()
    assert not k2.view("<u2").reshape(-1, 12)[:, 9:].any()


def _rounding_turns():
    """Scalars k where k * (lambda + 1) + floor(r / 2) lies within a few of
    a multiple of r, so that the rounded quotient k2 turns over there."""
    inv = pow(tglv.LAMBDA + 1, -1, FR_MOD)
    half = FR_MOD // 2
    rng = random.Random(19)
    ts = [0, 1, 2, -1, -2] + [rng.randrange(-4096, 4096) for _ in range(64)]
    return [((t - half) * inv + off) % FR_MOD for t in ts for off in (-1, 0, 1)]


def _lambda_multiples():
    """a * lambda + b at the ends of the quotient's range, and random k."""
    lam = tglv.LAMBDA
    rng = random.Random(29)
    return [(a * lam + b) % FR_MOD for a in (0, 1, 2, lam - 1, lam, lam + 1) for b in (0, 1, lam - 1)] + [
        rng.randrange(FR_MOD) for _ in range(256)
    ]


GLV_EDGES = {"rounding_turns": _rounding_turns, "lambda_multiples_and_random": _lambda_multiples}


@pytest.mark.parametrize("where", sorted(GLV_EDGES))
def test_glv_decompose_batch_at_its_rounding_edges(where):
    """The native split against the plain-integer reference where the
    rounded quotient turns over, and on multiples of lambda."""
    ks = GLV_EDGES[where]()
    sc = np.asarray(ints_to_limbs(ks, 16), dtype=np.uint32)
    k1, neg, k2 = host_native.glv_decompose_batch(sc)
    for j, k in enumerate(ks):
        mag = int.from_bytes(k1[j].tobytes(), "little")
        got = (-mag if neg[j] else mag, int.from_bytes(k2[j].tobytes(), "little"))
        assert got == tglv.decompose_int(k), k


def test_decompose_falls_back_to_numpy_without_a_compiler(monkeypatch):
    sc = _scalars(40, 5)
    want = tglv.decompose(sc.astype(np.uint64))
    monkeypatch.setattr(host_native, "available", lambda: False)
    monkeypatch.setattr(
        host_native, "glv_decompose_batch", lambda *_: pytest.fail("the native call was taken")
    )
    got = tglv.decompose(sc.astype(np.uint64))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _numpy_chain(mod, glv, sc16, c, L, slots):
    """glv.decompose -> host_digits -> stream_host_prep -> _build_sel, from
    `mod` (an ops.msm module) and `glv` (its ops.glv)."""
    s1, neg, s2 = glv(sc16.astype(np.uint64))
    digits = mod.host_digits(np.concatenate([s1, s2], axis=1).astype(np.uint32), c, bits=130)
    T = digits.shape[1] // L
    ocm, bidx, lidx, e = mod.stream_host_prep(digits, c, L)
    sel = bpos = None
    S = 0
    for S in slots:
        sel, bpos = mod._build_sel(e, T, S)
        if sel is not None:
            break
    else:
        S = 0
    return neg, ocm, bidx, lidx, sel, bpos, S


# n, c, L, slot options, the S the shape must end at
PREP_CASES = {
    "n512_c8_L64_S128": (512, 8, 64, SLOTS, 128),
    "n512_c13_L512_top_window_sparse": (512, 13, 512, SLOTS, None),
    "n512_c8_one_step_forces_S256": (512, 8, 1024, SLOTS, 256),
    "n512_c9_one_step_overflows": (512, 9, 1024, SLOTS, 0),
    "n256_c9_small_slots_overflow": (256, 9, 32, (2, 4), 0),
    "n128_c4_no_slots_asked": (128, 4, 16, (), 0),
}


@pytest.mark.parametrize("name", sorted(PREP_CASES))
def test_msm_prep_batch_equals_both_numpy_chains(name):
    n, c, L, slots, S_want = PREP_CASES[name]
    sc16 = _scalars(n, n + c)
    neg, ocm, bidx, lidx, sel, bpos, S = host_native.msm_prep_batch(sc16, c, L, slots)
    if S_want is not None:
        assert S == S_want
    assert ocm.shape == (-(-130 // c), 2 * n) and ocm.dtype == np.int32
    chains = {
        "port": _numpy_chain(tmsm, tglv.decompose_numpy, sc16, c, L, slots),
        "jax": _numpy_chain(jmsm, jglv.decompose, sc16, c, L, slots),
    }
    for who, (neg_r, ocm_r, bidx_r, lidx_r, sel_r, bpos_r, S_r) in chains.items():
        assert S == S_r, who
        assert neg.dtype == neg_r.dtype and np.array_equal(neg, neg_r), who
        for got, ref in ((ocm, ocm_r), (bidx, bidx_r), (lidx, lidx_r)):
            assert got.dtype == ref.dtype and np.array_equal(got, ref), who
        if S:
            assert sel.dtype == sel_r.dtype and np.array_equal(sel, sel_r), who
            assert bpos.dtype == bpos_r.dtype and np.array_equal(bpos, bpos_r), who
        else:
            assert sel is None and bpos is None


def test_msm_prep_batch_rejects_bad_arguments():
    sc16 = _scalars(64, 1)
    for c, L in ((0, 16), (17, 16), (8, 0), (8, 48)):
        with pytest.raises(ValueError):
            host_native.msm_prep_batch(sc16, c, L, SLOTS)


def test_stream_impl_takes_the_native_prep_and_the_numpy_chain_agrees(monkeypatch):
    """The main path calls the native prep once; with the library made
    unavailable the numpy chain gives the same point."""
    import torch

    from curdleproofs_tpu_torch.curve import G1, msm_host
    from curdleproofs_tpu_torch.fields import Fr
    from curdleproofs_tpu_torch.ops import g1 as tog

    torch.set_num_threads(1)
    rng = random.Random(9)
    n = 98  # pads to 128, 256 GLV lanes
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(8)] * 12 + [G1.identity(), G1()]
    scs = [Fr(rng.randrange(FR_MOD)) for _ in range(n)]
    sc = np.asarray(ints_to_limbs([s.v for s in scs], 16), dtype=np.uint32)
    calls = {"native": 0}
    orig = host_native.msm_prep_batch

    def spy(*a, **k):
        calls["native"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(host_native, "msm_prep_batch", spy)
    want = msm_host(pts, scs)
    tp = tog.pack_points(pts, "cpu")
    assert tmsm.msm_pippenger_stream(tp, sc, c=9, sel_scan=False) == want
    assert calls["native"] == 1
    monkeypatch.setattr(host_native, "available", lambda: False)
    assert tmsm.msm_pippenger_stream(tp, sc, c=9, sel_scan=False) == want
    assert calls["native"] == 1
