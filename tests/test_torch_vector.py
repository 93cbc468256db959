"""curdleproofs_tpu_torch.ops.vector vs the JAX package's ops.vector and vs
exact host arithmetic (`P * s`, `a + b`). CPU only, 8 lanes; every comparison
is exact equality of points."""
import random

import pytest
import torch

from curdleproofs_tpu.curve import G1 as JG1
from curdleproofs_tpu.curve import add_host_batch, mul_host_batch
from curdleproofs_tpu.fields import Fr as JFr
from curdleproofs_tpu.ops import vector as jvec
from curdleproofs_tpu_torch import (
    add_points,
    fold_points,
    fold_points_multi,
    scale_points,
    scale_points_common,
)
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import glv as tglv
from curdleproofs_tpu_torch.utils.device import resolve_device

# The lanes here are few: intra-op threads add nothing but spin-waiting, which
# slows every worker of a parallel test run many times over.
torch.set_num_threads(1)

N = 8


def _j(p: G1) -> JG1:
    return JG1.identity() if p.inf else JG1(p.x, p.y)


def _same(got, jgot) -> bool:
    return len(got) == len(jgot) and all(
        (t.inf and j.inf) or (not t.inf and not j.inf and (t.x, t.y) == (j.x, j.y))
        for t, j in zip(got, jgot)
    )


@pytest.fixture(scope="module")
def vecs():
    """a, b: 8 points each with an identity in a, an identity in b, a lane
    with a == b and one with a == -b; scalars with 0, 1, r - 1 and lambda."""
    rng = random.Random(77)
    a = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(N)]
    b = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(N)]
    a[0] = G1.identity()
    b[1] = G1.identity()
    b[2] = a[2]
    b[3] = -a[3]
    s = [Fr(rng.randrange(FR_MOD)) for _ in range(N)]
    for i, k in ((0, 5), (4, 0), (5, 1), (6, FR_MOD - 1), (7, tglv.LAMBDA)):
        s[i] = Fr(k)
    gamma = Fr(rng.randrange(FR_MOD))
    return dict(
        a=a, b=b, s=s, gamma=gamma,
        ja=[_j(p) for p in a], jb=[_j(p) for p in b], js=[JFr(x.v) for x in s], jgamma=JFr(gamma.v),
    )


def test_scale_points_equals_jax_and_host(vecs):
    got = scale_points(vecs["a"], vecs["s"], device="cpu")
    assert got == [p * k for p, k in zip(vecs["a"], vecs["s"])]
    assert _same(got, jvec.scale_points(vecs["ja"], vecs["js"]))
    assert _same(got, mul_host_batch(vecs["ja"], vecs["js"]))


def test_scale_points_common_equals_jax_and_host(vecs):
    got = scale_points_common(vecs["b"], vecs["gamma"], device="cpu")
    assert got == [p * vecs["gamma"] for p in vecs["b"]]
    assert _same(got, jvec.scale_points_common(vecs["jb"], vecs["jgamma"]))


def test_fold_points_equals_jax_and_host(vecs):
    got = fold_points(vecs["a"], vecs["b"], vecs["gamma"], device="cpu")
    assert got == [p + q * vecs["gamma"] for p, q in zip(vecs["a"], vecs["b"])]
    assert _same(got, jvec.fold_points(vecs["ja"], vecs["jb"], vecs["jgamma"]))


def test_fold_points_multi_equals_jax_and_host(vecs):
    got = fold_points_multi(vecs["a"], vecs["b"], vecs["s"], device="cpu")
    assert got == [p + q * k for p, q, k in zip(vecs["a"], vecs["b"], vecs["s"])]
    assert _same(got, jvec.fold_points_multi(vecs["ja"], vecs["jb"], vecs["js"]))


def test_add_points_equals_jax_and_host(vecs):
    got = add_points(vecs["a"], vecs["b"], device="cpu")
    assert got == [p + q for p, q in zip(vecs["a"], vecs["b"])]
    assert got[2] == vecs["a"][2] + vecs["a"][2] and got[3].inf
    assert _same(got, jvec.add_points(vecs["ja"], vecs["jb"]))
    assert _same(got, add_host_batch(vecs["ja"], vecs["jb"]))


def test_single_element_vectors(vecs):
    a, b, s = vecs["a"][5:6], vecs["b"][5:6], vecs["s"][6:7]
    assert fold_points_multi(a, b, s, device="cpu") == [a[0] + b[0] * s[0]]
    assert add_points(a, b, device="cpu") == [a[0] + b[0]]


CALLS = {
    "scale_points": lambda v, n, m, **kw: scale_points(v["a"][:n], v["s"][:m], **kw),
    "scale_points_common": lambda v, n, m, **kw: scale_points_common(v["a"][:n], v["gamma"], **kw),
    "fold_points": lambda v, n, m, **kw: fold_points(v["a"][:n], v["b"][:m], v["gamma"], **kw),
    "fold_points_multi": lambda v, n, m, **kw: fold_points_multi(v["a"][:n], v["b"][:n], v["s"][:m], **kw),
    "add_points": lambda v, n, m, **kw: add_points(v["a"][:n], v["b"][:m], **kw),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_empty_input_mismatch_and_no_card(vecs, name):
    call = CALLS[name]
    assert call(vecs, 0, 0, device="cpu") == []
    if name != "scale_points_common":
        with pytest.raises(ValueError, match=f"{name} length mismatch"):
            call(vecs, 3, 2, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            call(vecs, 2, 2, **kw)
        with pytest.raises(RuntimeError, match="CUDA"):
            call(vecs, 0, 0, **kw)
    assert resolve_device("cpu") == torch.device("cpu")
