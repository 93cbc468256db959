"""curdleproofs_tpu_torch ops.route (the route solver, native and pure Python)
and the gathers it feeds (ops.gather.rowwise_gather / routed_gather, plain
versions on the CPU) vs the JAX package's and vs numpy. The native solver is
built here by the C compiler of the machine. Integer equality only."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curdleproofs_tpu.ops import gather as jgather
from curdleproofs_tpu.ops import route as jroute
from curdleproofs_tpu_torch.ops import gather as tgather
from curdleproofs_tpu_torch.ops import route as troute
from curdleproofs_tpu_torch.ops.fieldspec import from_reference, to_reference
from curdleproofs_tpu_torch.utils import host_native

torch.set_num_threads(1)


def _simulate(r, c, i1, i2, i3, inp):
    """Apply the three local gathers exactly as decompose() documents them."""
    s1 = inp.reshape(r, c)[np.arange(r)[:, None], i1]
    s2 = s1[i2, np.arange(c)[:, None]]
    s3 = s2[i3, np.arange(r)[:, None]]
    return s3.reshape(-1)


def _perms(r, c, count, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(r * c) for _ in range(count)]).astype(np.int32)


def _routes(r, c, tables, src, seed=0):
    i1, i2, i3 = tables
    inp = np.random.default_rng(seed).integers(0, 1 << 30, r * c)
    return all(
        np.array_equal(_simulate(r, c, i1[w], i2[w], i3[w], inp), inp[src[w]])
        for w in range(src.shape[0])
    )


@pytest.mark.parametrize("r,c", [(2, 2), (8, 4), (16, 16), (128, 128)])
def test_decompose_py_routes_and_equals_jax(r, c):
    src = _perms(r, c, 2, r * 1000 + c)
    got = troute.decompose_py(r, c, src)
    assert _routes(r, c, got, src)
    want = jroute.decompose_py(r, c, src)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("r,c", [(2, 2), (8, 4), (16, 16), (128, 128), (512, 128), (512, 256), (3, 4), (5, 1)])
def test_native_decompose_routes_permutations(r, c):
    assert host_native.available(), "no C compiler: the native route solver cannot be built"
    src = _perms(r, c, 3, r * c)
    i1, i2, i3 = troute.decompose(r, c, src)
    assert (i1.shape, i2.shape, i3.shape) == ((3, r, c), (3, c, r), (3, r, c))
    assert all(a.dtype == np.int32 for a in (i1, i2, i3))
    assert _routes(r, c, (i1, i2, i3), src)
    # every index is a within-row / within-column index
    assert i1.min() >= 0 and i1.max() < c
    assert i2.min() >= 0 and i2.max() < r
    assert i3.min() >= 0 and i3.max() < c
    # stages 1 and 3 are true within-row permutations
    for w in range(src.shape[0]):
        assert all(len(set(row)) == c for row in i1[w])
        assert all(len(set(row)) == c for row in i3[w])


@pytest.mark.parametrize("solver", ["native", "python"])
def test_identity_and_reverse(solver):
    r, c = 16, 8
    n = r * c
    decompose = troute.decompose if solver == "native" else troute.decompose_py
    ident = np.arange(n, dtype=np.int32)[None]
    rev = ident[:, ::-1].copy()
    for src in (ident, rev):
        assert _routes(r, c, decompose(r, c, src), src)


def test_native_decompose_rejects_bad_arguments():
    with pytest.raises(ValueError):
        troute.decompose(70000, 2, np.zeros((1, 140000), np.int32))  # r over 16 bits
    with pytest.raises(ValueError):
        host_native.route_decompose(4, 3, np.arange(12, dtype=np.int32)[None])  # c not 2^k
    with pytest.raises(ValueError):
        host_native.route_decompose(4, 4, np.full((1, 16), 16, np.int32))  # source out of range


def test_pick_rc_equals_jax():
    for k in range(14, 22):
        assert troute.pick_rc(1 << k) == jroute.pick_rc(1 << k)
    assert troute.pick_rc(1 << 17) == (512, 256)  # the 2n lanes of an n = 2^16 MSM
    assert troute.pick_rc(512, 8) == jroute.pick_rc(512, 8)
    for bad in (1 << 10, (1 << 16) - 1):
        with pytest.raises(ValueError):
            troute.pick_rc(bad)
    assert troute.native_available() == host_native.available()


def test_rowwise_gather_plain_equals_jax_and_numpy():
    """At the JAX test's own shape, indices from -2 (out of range -> 0)."""
    rng = np.random.default_rng(5)
    G_, R, K, M = 6, 5, 16, 24
    tab = rng.integers(0, 1 << 31, (G_, R, K), dtype=np.uint32)
    idx = rng.integers(-2, K + 2, (G_, M)).astype(np.int32)
    idx[0, :3] = [-1, K, K - 1]
    got = tgather.rowwise_gather(from_reference(tab, "cpu"), from_reference(idx, "cpu"))
    assert got.dtype == torch.int32 and tuple(got.shape) == (G_, R, M)
    out = to_reference(got)
    for g in range(G_):
        for m in range(M):
            want = tab[g, :, idx[g, m]] if 0 <= idx[g, m] < K else 0
            assert (out[g, :, m] == want).all()
    jout = jgather.rowwise_gather(jnp.asarray(tab), jnp.asarray(idx))  # Pallas, interpret mode
    assert np.array_equal(out, np.asarray(jout))
    with pytest.raises(ValueError):
        tgather.rowwise_gather(torch.zeros((4, 2, 8), dtype=torch.int32), torch.zeros((3, 5), dtype=torch.int32))


@pytest.mark.parametrize("solver", ["native", "python"])
def test_routed_gather_plain_equals_jax_and_numpy(solver):
    rng = np.random.default_rng(7)
    r, c, W = 16, 8, 3
    n = r * c
    packed = rng.integers(0, 1 << 16, (49, n), dtype=np.uint32)
    src = _perms(r, c, W, 11)
    tables = (troute.decompose if solver == "native" else troute.decompose_py)(r, c, src)
    got = tgather.routed_gather(
        from_reference(packed, "cpu"), *(from_reference(t, "cpu") for t in tables)
    )
    want = np.stack([packed[:, src[w]] for w in range(W)], axis=1)
    assert tuple(got.shape) == (49, W, n) and np.array_equal(to_reference(got), want)
    jgot = jgather.routed_gather(jnp.asarray(packed), *(jnp.asarray(t) for t in tables))
    assert np.array_equal(to_reference(got), np.asarray(jgot))
    with pytest.raises(ValueError):
        tgather.routed_gather(from_reference(packed[:, :-1], "cpu"), *(from_reference(t, "cpu") for t in tables))
