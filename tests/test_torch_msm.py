"""curdleproofs_tpu_torch.ops.msm vs the JAX package's ops.msm and vs the
host oracle: host prep array for array and the two device bodies limb for
limb (the whole MSM is in test_torch_msm_whole.py). CPU only, small sizes;
every comparison is exact."""
import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curdleproofs_tpu.curve import G1 as JG1
from curdleproofs_tpu.ops import g1 as jog
from curdleproofs_tpu.ops import glv as jglv
from curdleproofs_tpu.ops import msm as jmsm
from curdleproofs_tpu.ops import route as jroute
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.ops import glv as tglv
from curdleproofs_tpu_torch.ops import msm as tmsm
from curdleproofs_tpu_torch.ops import stream_scan as tstream
from curdleproofs_tpu_torch.ops.fieldspec import from_reference, ints_to_limbs, to_reference

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


def _same(t, j):
    return np.array_equal(to_reference(t), np.asarray(j))


# ---------------------------------------------------------------------------
# host prep
# ---------------------------------------------------------------------------

EDGE_SCALARS = [0, 1, FR_MOD - 1, tglv.LAMBDA, tglv.LAMBDA + 1, tglv.LAMBDA - 1]


def test_glv_constants_and_decompose_equal_jax():
    assert (tglv.BETA, tglv.LAMBDA) == (jglv.BETA, jglv.LAMBDA)
    sc = limbs(rand_scalars(58) + [Fr(v) for v in EDGE_SCALARS])
    got = tglv.decompose(sc.astype(np.uint64))
    want = jglv.decompose(sc.astype(np.uint64))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    s1, neg1, s2 = got
    for i, k in enumerate([s.v for s in rand_scalars(58)] + EDGE_SCALARS):
        k1 = sum(int(s1[j, i]) << (16 * j) for j in range(9))
        k2 = sum(int(s2[j, i]) << (16 * j) for j in range(9))
        assert ((-k1 if neg1[i] else k1) + k2 * tglv.LAMBDA - k) % FR_MOD == 0
        assert tglv.decompose_int(k) == jglv.decompose_int(k)


@pytest.mark.parametrize("c,bits", [(4, 255), (8, 255), (13, 255), (16, 255), (9, 130), (13, 130)])
def test_host_digits_equal_jax(c, bits):
    sc = limbs(rand_scalars(30) + [Fr(0), Fr(FR_MOD - 1)])
    if bits == 130:
        sc = np.concatenate([sc[:9], np.zeros((7, sc.shape[1]), np.uint32)])[:9]
    got = tmsm.host_digits(sc, c, bits=bits)
    want = jmsm.host_digits(sc, c, bits=bits)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_pick_window_and_point_ops_equal_jax():
    for n in (1, 32, 33, 1024, 1025, 1 << 14, 1 << 16, (1 << 16) + 1, 1 << 20):
        assert tmsm.pick_window(n) == jmsm.pick_window(n)
    for n, c in ((100, 8), (1 << 14, 13), (1 << 16, 13)):
        assert tmsm.stream_point_ops(n, c) == jmsm.stream_point_ops(n, c)
    assert (tmsm.STREAM_MIN, tmsm.STREAM_SPLIT, tmsm.HOST_THRESHOLD) == (
        1 << 14,
        1 << 16,
        jmsm.HOST_THRESHOLD,
    )
    assert tmsm.SEL_SLOT_OPTIONS == jmsm.SEL_SLOT_OPTIONS
    assert tmsm.SEL_MIN_N == jmsm.ROUTE_MIN_N


def _prep(n_lanes, c, seed=3):
    r = np.random.default_rng(seed)
    digits = r.integers(0, 1 << c, (3, n_lanes)).astype(np.uint16)
    digits[2] &= 3  # a top-window-like row: few distinct digits, many empty buckets
    return digits


@pytest.mark.parametrize("S", [128, 256])
def test_stream_host_prep_and_build_sel_equal_jax(S):
    c, L, n = 9, 32, 512
    digits = _prep(n, c)
    got = tmsm.stream_host_prep(digits, c, L)
    want = jmsm.stream_host_prep(digits, c, L)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    T = n // L
    gs, gb = tmsm._build_sel(got[3], T, S)
    ws, wb = jmsm._build_sel(want[3], T, S)
    assert np.array_equal(gs, ws) and np.array_equal(gb, wb)


def test_build_sel_escalation_and_overflow_equal_jax():
    T = 8
    e = (np.arange(200, dtype=np.int64) * T + 3).reshape(1, 200)
    assert tmsm._build_sel(e, T, 128) == (None, None) == jmsm._build_sel(e, T, 128)
    gs, gb = tmsm._build_sel(e, T, 256)
    ws, wb = jmsm._build_sel(e, T, 256)
    assert np.array_equal(gs, ws) and np.array_equal(gb, wb)
    row = gs.reshape(T, 256)[3]
    assert (np.sort(row[row >= 0]) == np.arange(200)).all()


def test_combine_windows_host_equal_jax():
    pts = _pool()[:5]
    got = tmsm._combine_windows_host(pts[0], pts[1:], 5, 4)
    want = jmsm._combine_windows_host(
        JG1(pts[0].x, pts[0].y), [JG1(p.x, p.y) for p in pts[1:]], 5, 4
    )
    assert same_point(got, want)


def _affine_horner(total, bsums, c, W):
    """The window combine one affine group operation at a time."""
    big = total * Fr((1 << c) - 1)
    acc = G1.identity()
    for w in reversed(range(W)):
        for _ in range(c):
            acc = acc + acc
        acc = acc + (big - bsums[w])
    return acc


COMBINE_CASES = {
    # name: (total, window sums) as indices into the pool, None the identity,
    # "big" the total times 2^c - 1 (its window term is the identity)
    "random": (0, [1, 2, 3, 4]),
    "identity_total": (None, [1, 2, 3, 4]),
    "identity_windows": (0, [None, None, None, None]),
    "window_term_vanishes": (0, ["big", 1, "big", 2]),
    "equal_terms_double": (0, [1, 1, 1, 1]),
}


@pytest.mark.parametrize("name", sorted(COMBINE_CASES))
def test_combine_windows_host_equals_the_affine_horner(name):
    """The Jacobian Horner (one inversion) against one affine operation at
    a time, where terms vanish, repeat or are the identity."""
    pts = _pool()[:5]
    c, W = 5, 4
    ti, wi = COMBINE_CASES[name]
    total = G1.identity() if ti is None else pts[ti]
    big = total * Fr((1 << c) - 1)
    bsums = [G1.identity() if i is None else big if i == "big" else pts[i] for i in wi]
    assert tmsm._combine_windows_host(total, bsums, c, W) == _affine_horner(total, bsums, c, W)


# ---------------------------------------------------------------------------
# device bodies, limb for limb
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def body_inputs():
    """n = 256 points -> 512 GLV lanes, c = 9, L = 32, T = 16; the first 3 of
    the 15 windows."""
    n, c, L, wb = 256, 9, 32, 3
    pts = rand_points(n - 3) + [G1.identity(), _pool()[0], _pool()[0]]
    sc = limbs(rand_scalars(n - 2, seed=5) + [Fr(0), Fr(5)])
    s1, neg1, s2 = tglv.decompose(sc.astype(np.uint64))
    digits = tmsm.host_digits(np.concatenate([s1, s2], axis=1).astype(np.uint32), c, bits=130)
    n2 = 2 * n
    T = n2 // L
    order_cm, bidx, lidx, e = tmsm.stream_host_prep(digits[:wb], c, L)
    sel, bpos = tmsm._build_sel(e, T, 128)
    assert sel is not None
    tp = tog.pack_points(pts, "cpu")
    jp = jax_points(pts)
    tpacked = tmsm._glv_stream_packed(tp.x, tp.y, tp.inf, from_reference(neg1, "cpu"))
    jpacked = jmsm._glv_stream_packed(jp.x, jp.y, jp.inf, jnp.asarray(neg1))
    return dict(
        T=T, L=L, S=128, n2=n2, order_cm=order_cm, bidx=bidx, lidx=lidx, sel=sel, bpos=bpos,
        tpacked=tpacked, jpacked=jpacked,
    )


def test_glv_stream_packed_equals_jax(body_inputs):
    """The records on the CPU (the plain version, which the card's
    `glv_records` kernel is held against) limb for limb the JAX package's,
    with an identity lane and mixed neg1."""
    packed = body_inputs["tpacked"]
    n = body_inputs["n2"] // 2
    assert tuple(packed.shape) == (49, 2 * n)
    assert _same(packed, body_inputs["jpacked"])
    assert packed[48, :n].any() and not packed[48, :n].all()  # identity lanes beside points
    assert not torch.equal(packed[24:48, :n], packed[24:48, n:])  # some y negated (neg1 mixed)


def test_stream_window_partials_equals_jax(body_inputs, monkeypatch):
    """The full-prefix body on the unsplit scan (SCAN_SPLIT = 1): total and
    bsums limb for limb the JAX package's."""
    monkeypatch.setattr(tstream, "SCAN_SPLIT", 1)
    b = body_inputs
    total, bsums = tmsm._stream_window_partials(
        b["tpacked"],
        from_reference(b["order_cm"], "cpu"),
        from_reference(b["bidx"], "cpu"),
        from_reference(b["lidx"], "cpu"),
        b["T"],
        b["L"],
    )
    jtotal, jbsums = jmsm._stream_window_partials(
        b["jpacked"], jnp.asarray(b["order_cm"]), jnp.asarray(b["bidx"]), jnp.asarray(b["lidx"]),
        b["T"], b["L"],
    )
    for t, j in zip(tuple(total) + tuple(bsums), tuple(jtotal) + tuple(jbsums)):
        assert _same(t, j)


def test_stream_window_partials_default_split_equals_jax_as_points(body_inputs):
    """The full-prefix body at the default split: total and bsums are other
    Jacobian triples of the JAX package's points."""
    b = body_inputs
    assert tstream.split_steps(b["T"]) > 1
    total, bsums = tmsm._stream_window_partials(
        b["tpacked"], from_reference(b["order_cm"], "cpu"), from_reference(b["bidx"], "cpu"),
        from_reference(b["lidx"], "cpu"), b["T"], b["L"],
    )
    jtotal, jbsums = jmsm._stream_window_partials(
        b["jpacked"], jnp.asarray(b["order_cm"]), jnp.asarray(b["bidx"]), jnp.asarray(b["lidx"]),
        b["T"], b["L"],
    )
    for t, j in ((total, jtotal), (bsums, jbsums)):
        want = tog.JPoints(*(from_reference(np.asarray(a), "cpu") for a in j))
        assert tog.jpoints_to_host(tog.JPoints(*(a.reshape(24, -1) for a in t))) == tog.jpoints_to_host(
            tog.JPoints(*(a.reshape(24, -1) for a in want))
        )


def test_sel_body_equals_jax_routed_sel(body_inputs, monkeypatch):
    """The port's sel body against the JAX package's routed sel body fed the
    route factorisation of the same sort order: total, bsums and flags. The
    unsplit scan, whose Jacobian triples are the JAX package's."""
    monkeypatch.setattr(tstream, "SCAN_SPLIT", 1)
    b = body_inputs
    total, bsums, flags = tmsm._stream_window_partials_sel(
        b["tpacked"],
        from_reference(b["order_cm"], "cpu"),
        from_reference(b["sel"], "cpu"),
        from_reference(b["bpos"], "cpu"),
        from_reference(b["lidx"], "cpu"),
        b["T"],
        b["L"],
        b["S"],
    )
    rr, rc = jroute.pick_rc(b["n2"], 8)
    i1, i2, i3 = jroute.decompose(rr, rc, b["order_cm"])
    jtotal, jbsums, jflags = jmsm._stream_window_partials_routed_sel(
        b["jpacked"], jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(i3),
        jnp.asarray(b["sel"]), jnp.asarray(b["bpos"]), jnp.asarray(b["lidx"]),
        b["T"], b["L"], b["S"],
    )
    for t, j in zip(tuple(total) + tuple(bsums), tuple(jtotal) + tuple(jbsums)):
        assert _same(t, j)
    assert to_reference(flags).tolist() == np.asarray(jflags).tolist()


def test_sel_body_split_scan_equals_jax_as_points(body_inputs, monkeypatch):
    """The sel body with the scan split into 4 sub-chains a lane: total and
    bsums are other Jacobian triples of the same points as the JAX package's
    unsplit body, and the same window flags the base these inputs repeat."""
    monkeypatch.setattr(tstream, "SCAN_SPLIT", 4)
    b = body_inputs
    total, bsums, flags = tmsm._stream_window_partials_sel(
        b["tpacked"], from_reference(b["order_cm"], "cpu"), from_reference(b["sel"], "cpu"),
        from_reference(b["bpos"], "cpu"), from_reference(b["lidx"], "cpu"), b["T"], b["L"], b["S"],
    )
    i1, i2, i3 = jroute.decompose(*jroute.pick_rc(b["n2"], 8), b["order_cm"])
    jtotal, jbsums, jflags = jmsm._stream_window_partials_routed_sel(
        b["jpacked"], jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(i3),
        jnp.asarray(b["sel"]), jnp.asarray(b["bpos"]), jnp.asarray(b["lidx"]),
        b["T"], b["L"], b["S"],
    )
    for t, j in ((total, jtotal), (bsums, jbsums)):
        want = tog.JPoints(*(from_reference(np.asarray(a), "cpu") for a in j))
        assert tog.jpoints_to_host(tog.JPoints(*(a.reshape(24, -1) for a in t))) == tog.jpoints_to_host(
            tog.JPoints(*(a.reshape(24, -1) for a in want))
        )
    assert to_reference(flags).tolist() == np.asarray(jflags).tolist() == [0, 0, 1]
