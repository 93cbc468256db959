"""The sort-based Pippenger engines of curdleproofs_tpu_torch (msm_pippenger,
msm_pippenger_hostsort, ops.scan.inclusive_scan, extract_digits) and all five
`method` values of msm(), on the CPU, vs the host oracle and vs the JAX
package's functions. Every comparison is exact."""
import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curdleproofs_tpu.curve import G1 as JG1
from curdleproofs_tpu.ops import g1 as jog
from curdleproofs_tpu.ops import msm as jmsm
from curdleproofs_tpu.ops import scan as jscan
from curdleproofs_tpu_torch import msm
from curdleproofs_tpu_torch.curve import G1, msm_host
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.ops import msm as tmsm
from curdleproofs_tpu_torch.ops import scan as tscan
from curdleproofs_tpu_torch.ops.fieldspec import from_reference, ints_to_limbs, to_reference

# The lanes here are few: intra-op threads add nothing but spin-waiting, which
# slows every worker of a parallel test run many times over.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _pool():
    rng = random.Random(0xABCD)
    return tuple(G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(96))


def rand_points(n):
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


@pytest.mark.parametrize("c", [4, 8, 13, 16])
def test_extract_digits_equals_jax_and_host_digits(c):
    scs = rand_scalars(6) + [Fr(0), Fr(FR_MOD - 1)]
    sc = limbs(scs)
    got = tmsm.extract_digits(from_reference(sc, "cpu"), c)
    assert got.dtype == torch.int32
    assert _same(got, jmsm.extract_digits(jnp.asarray(sc), c))
    assert np.array_equal(to_reference(got), tmsm.host_digits(sc, c))
    for j, s in enumerate(scs):
        assert sum(int(got[w, j]) << (c * w) for w in range(got.shape[0])) == s.v
    with pytest.raises(ValueError):
        tmsm.extract_digits(from_reference(sc, "cpu"), 17)


@pytest.mark.parametrize("width,small,vs_jax", [(8, 2048, True), (64, 2048, True), (16, 4, False)])
def test_inclusive_scan_equals_jax(width, small, vs_jax, monkeypatch):
    """Coordinate for coordinate against the JAX package; every prefix against
    the host. SMALL_WIDTH = 4 at 16 lanes forces two recursive levels above
    the fixed-width scan (against the host only: the JAX function compiles
    for a minute at those shapes)."""
    monkeypatch.setattr(tscan, "SMALL_WIDTH", small)
    pts = rand_points(width)
    pts[1] = G1.identity()
    pts[3] = pts[2]  # a doubling inside the scan
    tj = tog.lift(tog.pack_points(pts, "cpu"))
    jj = jog.lift(jax_points(pts))
    got = tscan.inclusive_scan(tj)
    if vs_jax:
        for g, w in zip(got, jscan.inclusive_scan(jj)):
            assert _same(g, w)
    host = tog.jpoints_to_host(got)
    acc = G1.identity()
    for i, p in enumerate(pts):
        acc = acc + p
        assert host[i] == acc, f"prefix {i}"
    with pytest.raises(ValueError):
        tscan.inclusive_scan(tog.JPoints(*(a[:, :3] for a in tj)))


def _edge_inputs(n):
    pts, scs = rand_points(n), rand_scalars(n, seed=n)
    pts[0] = G1.identity()  # infinity base
    scs[1] = Fr(0)  # zero scalar
    pts[2] = pts[3]  # duplicate base (bucket doubling)
    scs[4] = scs[5] = Fr(7)  # duplicate digits everywhere
    pts[6] = -pts[7]
    return pts, scs


# name -> (n, c, window_batch)
SORT_CASES = {
    "edge_inputs_c4": (32, 4, None),
    "c8": (16, 8, None),
    "c6": (16, 6, None),
    "non_pow2_n60": (60, 4, None),
    "tiny_n3": (8, 4, None),
    "small_window_batches": (16, 8, 3),
}


@pytest.mark.parametrize("engine", ["pippenger", "hostsort"])
@pytest.mark.parametrize("name", sorted(SORT_CASES))
def test_sort_engines_equal_oracle(name, engine):
    n, c, wb = SORT_CASES[name]
    pts, scs = _edge_inputs(n)
    if name == "tiny_n3":
        pts, scs = pts[:3], scs[:3]
    tp = tog.pack_points(pts, "cpu")
    if engine == "pippenger":
        got = tmsm.msm_pippenger(tp, from_reference(limbs(scs), "cpu"), c=c, window_batch=wb)
    else:
        got = tmsm.msm_pippenger_hostsort(tp, limbs(scs), c=c, window_batch=wb)
    assert got == msm_host(pts, scs)


def test_sort_engines_equal_jax():
    """One input through both engines of both packages (the JAX functions
    compile for minutes at more shapes than this)."""
    pts, scs = _edge_inputs(32)
    tp, jp = tog.pack_points(pts, "cpu"), jax_points(pts)
    sc = limbs(scs)
    got = tmsm.msm_pippenger(tp, from_reference(sc, "cpu"), c=4)
    assert same_point(got, jmsm.msm_pippenger(jp, jnp.asarray(sc), c=4))
    got = tmsm.msm_pippenger_hostsort(tp, sc, c=5)
    assert same_point(got, jmsm.msm_pippenger_hostsort(jp, sc, c=5))
    assert tmsm.hostsort_point_ops(1 << 12, 8) == jmsm.hostsort_point_ops(1 << 12, 8)
    assert tmsm.LADDER_THRESHOLD == jmsm.LADDER_THRESHOLD


@pytest.mark.parametrize("method", ["auto", "ladder", "stream", "pippenger", "hostsort"])
def test_msm_answers_for_every_method(method):
    pts, scs = _edge_inputs(20)
    assert msm(pts, scs, method=method, device="cpu") == msm_host(pts, scs)


def test_msm_rejects_unknown_method():
    pts, scs = _edge_inputs(20)
    with pytest.raises(ValueError, match="unknown method"):
        msm(pts, scs, method="bogus", device="cpu")
