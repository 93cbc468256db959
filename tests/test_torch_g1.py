"""curdleproofs_tpu_torch.ops.g1 / ops.fieldspec vs the JAX package's, limb
for limb. CPU only; every comparison is integer equality."""
import random

import jax
import numpy as np
import pytest
import torch

from curdleproofs_tpu.curve import G1 as JG1
from curdleproofs_tpu.fields import Fr as JFr
from curdleproofs_tpu.ops import g1 as jog
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.ops.fieldspec import from_reference, to_reference

N = 16


def _host_points(seed):
    rng = random.Random(seed)
    return [rng.randrange(1, FR_MOD) for _ in range(N)]


def _pair():
    """Edge lanes as the JAX package's kernel tests build them: identity on
    both sides, doubling, cancellation; plus both-identity."""
    ks, qs = _host_points(17), _host_points(18)
    pts = [G1() * Fr(k) for k in ks]
    qts = [G1() * Fr(k) for k in qs]
    pts[0] = G1.identity()
    qts[1] = G1.identity()
    qts[2] = pts[2]
    qts[3] = -pts[3]
    pts[4] = qts[4] = G1.identity()
    return pts, qts


def _to_jax_host(pts):
    return [JG1.identity() if p.inf else JG1(p.x, p.y) for p in pts]


def _np(t):
    return tuple(np.asarray(a) for a in t)


def _assert_same(tres, jres):
    for t, j in zip(tres, jres):
        assert np.array_equal(to_reference(t), np.asarray(j))


@pytest.fixture(scope="module")
def operands():
    pts, qts = _pair()
    tp, tq = tog.pack_points(pts, "cpu"), tog.pack_points(qts, "cpu")
    jp, jq = jog.pack_points(_to_jax_host(pts)), jog.pack_points(_to_jax_host(qts))
    # Jacobian operands with z != 1: p doubled, q = q + q' on the JAX side,
    # carried over through from_reference so both sides start identical
    jpj = jax.jit(jog._jdbl_formulas)(jog.lift(jp))
    jqj = jax.jit(jog._jadd_formulas)(jog.lift(jq), jog.lift(jp))
    tpj = tog.JPoints(*(from_reference(np.asarray(a), "cpu") for a in jpj))
    tqj = tog.JPoints(*(from_reference(np.asarray(a), "cpu") for a in jqj))
    return dict(pts=pts, qts=qts, tp=tp, tq=tq, jp=jp, jq=jq, jpj=jpj, jqj=jqj, tpj=tpj, tqj=tqj)


def test_pack_points_equals_jax(operands):
    for t, j in zip(operands["tp"], operands["jp"]):
        assert np.array_equal(to_reference(t), np.asarray(j))
    assert operands["tp"].x.dtype == torch.int32 and operands["tp"].inf.dtype == torch.bool


def test_pack_scalars_equals_jax():
    ks = _host_points(3) + [0, FR_MOD - 1]
    t = tog.pack_scalars([Fr(k) for k in ks], "cpu")
    j = jog.pack_scalars([JFr(k) for k in ks])
    assert np.array_equal(to_reference(t), np.asarray(j))


def test_round_trips(operands):
    pts = operands["pts"]
    assert tog.unpack_points(operands["tp"]) == pts
    assert tog.jpoints_to_host(tog.lift(operands["tp"])) == pts
    assert tog.jpoints_to_host(operands["tpj"]) == [p + p for p in pts]
    one = tog.JPoints(*(a[:, 5] for a in operands["tpj"]))
    assert tog.jpoints_to_host(one) == [pts[5] + pts[5]]


def test_reference_layout_round_trip():
    rng = np.random.default_rng(0)
    limbs = rng.integers(0, 1 << 16, (72, 3, 5)).astype(np.uint32)
    t = from_reference(limbs, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (72, 3, 5)
    back = to_reference(t)
    assert back.dtype == np.uint32 and np.array_equal(back, limbs)
    mask = rng.integers(0, 2, (7,)).astype(bool)
    assert np.array_equal(to_reference(from_reference(mask, "cpu")), mask)
    idx = rng.integers(-1, 100, (2, 9)).astype(np.int32)
    assert np.array_equal(to_reference(from_reference(idx, "cpu")).astype(np.int32), idx)
    with pytest.raises(ValueError):
        from_reference(np.array([1 << 31], dtype=np.uint32), "cpu")


def test_jinf_and_lift_equal_jax(operands):
    _assert_same(tog.jinf((2, 3)), jog.jinf((2, 3)))
    _assert_same(tog.lift(operands["tp"]), jog.lift(operands["jp"]))
    assert to_reference(tog.is_inf(tog.lift(operands["tp"]))).tolist() == [
        p.inf for p in operands["pts"]
    ]


CASES = {
    "jdbl_formulas": (
        lambda o: tog._jdbl_formulas(o["tpj"]),
        lambda o: jax.jit(jog._jdbl_formulas)(o["jpj"]),
        lambda o: [p + p + p + p for p in o["pts"]],
    ),
    "jadd_formulas": (
        lambda o: tog._jadd_formulas(o["tpj"], o["tqj"]),
        lambda o: jax.jit(jog._jadd_formulas)(o["jpj"], o["jqj"]),
        lambda o: [p + p + q + p for p, q in zip(o["pts"], o["qts"])],
    ),
    "jadd_formulas_lifted_edges": (
        lambda o: tog._jadd_formulas(tog.lift(o["tp"]), tog.lift(o["tq"])),
        lambda o: jax.jit(jog._jadd_formulas)(jog.lift(o["jp"]), jog.lift(o["jq"])),
        lambda o: [p + q for p, q in zip(o["pts"], o["qts"])],
    ),
    "jmadd_formulas": (
        lambda o: tog._jmadd_formulas(o["tpj"], o["tq"]),
        lambda o: jax.jit(jog._jmadd_formulas)(o["jpj"], o["jq"]),
        lambda o: [p + p + q for p, q in zip(o["pts"], o["qts"])],
    ),
    "jmadd_formulas_lifted_edges": (
        lambda o: tog._jmadd_formulas(tog.lift(o["tp"]), o["tq"]),
        lambda o: jax.jit(jog._jmadd_formulas)(jog.lift(o["jp"]), o["jq"]),
        lambda o: [p + q for p, q in zip(o["pts"], o["qts"])],
    ),
    "jadd_dispatch": (
        lambda o: tog.jadd(o["tpj"], o["tqj"]),
        lambda o: jax.jit(jog._jadd_formulas)(o["jpj"], o["jqj"]),
        None,
    ),
    "jdbl_dispatch": (
        lambda o: tog.jdbl(o["tpj"]),
        lambda o: jax.jit(jog._jdbl_formulas)(o["jpj"]),
        None,
    ),
    "jmadd_dispatch": (
        lambda o: tog.jmadd(o["tpj"], o["tq"]),
        lambda o: jax.jit(jog._jmadd_formulas)(o["jpj"], o["jq"]),
        None,
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_formulas_equal_jax_limb_for_limb(operands, name):
    tfn, jfn, host = CASES[name]
    got = tfn(operands)
    _assert_same(got, jfn(operands))
    if host is not None:
        assert tog.jpoints_to_host(got) == host(operands)


def test_jmadd_flagged_equals_jax(operands):
    """The no-doubling mixed add: same limbs (also where it is wrong by
    design) and the same flag; the flag fires exactly on the P + P lane."""
    tp, tq = tog.lift(operands["tp"]), operands["tq"]
    got, gflag = tog._jmadd_formulas_flagged(tp, tq)
    want, wflag = jax.jit(jog._jmadd_formulas_flagged)(jog.lift(operands["jp"]), operands["jq"])
    _assert_same(got, want)
    assert np.array_equal(to_reference(gflag), np.asarray(wflag))
    assert to_reference(gflag).tolist() == [i == 2 for i in range(N)]
    host = tog.jpoints_to_host(got)
    for i, (p, q) in enumerate(zip(operands["pts"], operands["qts"])):
        if i != 2:
            assert host[i] == p + q
