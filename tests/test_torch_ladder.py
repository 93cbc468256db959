"""The plain scalar-multiplication ladders of curdleproofs_tpu_torch.ops.g1
(what the four ladder kernels are held against on the card) vs the JAX
package and vs exact host arithmetic. CPU only, 16 lanes; every comparison is
integer equality."""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curdleproofs_tpu.curve import G1 as JG1
from curdleproofs_tpu.ops import g1 as jog
from curdleproofs_tpu.ops import modarith as jma
from curdleproofs_tpu.ops.fieldspec import FQ_SPEC as JFQ_SPEC
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import cuda_g1
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.ops import glv as tglv
from curdleproofs_tpu_torch.ops import modarith as tma
from curdleproofs_tpu_torch.ops.fieldspec import FQ_SPEC, from_reference, ints_to_limbs, to_reference

# The lanes here are few: intra-op threads add nothing but spin-waiting, which
# slows every worker of a parallel test run many times over.
torch.set_num_threads(1)

N = 16
IDENTITY_LANE, TWIN_LANES = 14, (12, 13)


@pytest.fixture(scope="module")
def lanes():
    """16 lanes: the 14 edge scalars, then an identity base and a uniform
    scalar; lanes 12 and 13 share one base. The GLV split of these scalars
    has lanes with a negative and with a positive k1."""
    rng = random.Random(41)
    ks = list(tglv.EDGE_SCALARS) + [rng.randrange(FR_MOD) for _ in range(N - len(tglv.EDGE_SCALARS))]
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(N)]
    pts[IDENTITY_LANE] = G1.identity()
    pts[TWIN_LANES[1]] = pts[TWIN_LANES[0]]
    sc = np.asarray(ints_to_limbs(ks, 16), dtype=np.uint32)
    s1, neg1, s2 = tglv.decompose(sc.astype(np.uint64))
    assert neg1.any() and not neg1.all()
    jpts = jog.pack_points([JG1.identity() if p.inf else JG1(p.x, p.y) for p in pts])
    return dict(
        ks=ks, pts=pts, sc=sc, s1=s1, neg1=neg1, s2=s2, jpts=jpts,
        want=[p * Fr(k) for p, k in zip(pts, ks)],
        tp=tog.pack_points(pts, "cpu"),
        tsc=from_reference(sc, "cpu"),
    )


@pytest.fixture(scope="module")
def jax_bitwise(lanes):
    """The JAX package's XLA ladder on the same arrays (what its
    `og.scalar_mul` runs on the CPU)."""
    return jax.jit(jog._scalar_mul_xla)(lanes["jpts"], jnp.asarray(lanes["sc"]))


@pytest.fixture(scope="module")
def glv_results(lanes):
    args = (
        lanes["tp"],
        from_reference(lanes["s1"], "cpu"),
        from_reference(lanes["neg1"], "cpu"),
        from_reference(lanes["s2"], "cpu"),
    )
    return {w: tog.scalar_mul_glv(*args, w=w) for w in (3, 4)}


def _as_host(jres):
    """JAX Jacobian result -> the port's host points."""
    return tog.jpoints_to_host(tog.JPoints(*(from_reference(np.asarray(a), "cpu") for a in jres)))


def test_bitwise_plain_ladder_equals_jax_xla_bit_for_bit(lanes, jax_bitwise):
    got = tog._scalar_mul_plain(lanes["tp"], lanes["tsc"])
    for t, j in zip(got, jax_bitwise):
        assert np.array_equal(to_reference(t), np.asarray(j))
    assert tog.jpoints_to_host(got) == lanes["want"]


def test_bitwise_ladder_from_the_zero_triple(lanes, jax_bitwise):
    """`scalar_mul_w1` starts where the kernel starts: the same limbs as the
    (1, 1, 0) start wherever the lane leaves infinity, the zero triple where
    it never does (scalar 0, identity base)."""
    got = tog.scalar_mul_w1(lanes["tp"], lanes["tsc"])
    assert tog.jpoints_to_host(got) == lanes["want"]
    stays_inf = [k == 0 or p.inf for k, p in zip(lanes["ks"], lanes["pts"])]
    assert stays_inf.count(True) == 2
    for t, j in zip(got, jax_bitwise):
        t, j = to_reference(t), np.asarray(j)
        for i, inf in enumerate(stays_inf):
            assert not t[:, i].any() if inf else np.array_equal(t[:, i], j[:, i])


def test_w3_plain_ladder_equals_host_and_jax_as_points(lanes, jax_bitwise):
    got = tog.scalar_mul(lanes["tp"], lanes["tsc"])
    assert tog.jpoints_to_host(got) == lanes["want"]
    assert tog.jpoints_to_host(got) == _as_host(jax_bitwise)
    z = to_reference(got.z)
    assert not z[:, 0].any() and not z[:, IDENTITY_LANE].any()  # the zero triple
    assert not to_reference(got.x)[:, 0].any()


@pytest.mark.parametrize("w", [3, 4])
def test_glv_plain_ladder_equals_host_and_jax_as_points(lanes, jax_bitwise, glv_results, w):
    got = glv_results[w]
    assert tog.jpoints_to_host(got) == lanes["want"]
    assert tog.jpoints_to_host(got) == _as_host(jax_bitwise)
    for a in got:
        a = to_reference(a)
        assert not a[:, 0].any() and not a[:, IDENTITY_LANE].any()


def test_glv_widths_give_equal_points_and_twin_lanes_agree(glv_results):
    h3, h4 = (tog.jpoints_to_host(glv_results[w]) for w in (3, 4))
    assert h3 == h4
    # the two lanes that share a base differ only by their scalars
    a, b = TWIN_LANES
    assert h3[a] != h3[b]


def test_glv_default_width_is_the_package_knob(lanes, monkeypatch):
    seen = []
    monkeypatch.setattr(tog, "_scalar_mul_glv_plain", lambda *a: seen.append(a[-1]))
    args = (lanes["tp"], None, None, None)
    tog.scalar_mul_glv(*args)
    monkeypatch.setattr(cuda_g1, "GLV_W", 4)
    tog.scalar_mul_glv(*args)
    tog.scalar_mul_glv(*args, w=3)
    assert seen == [3, 4, 3]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="window width"):
        tog.scalar_mul_glv(*args, w=5)


@pytest.mark.parametrize("width,rows", [(3, 9), (4, 9), (3, 16), (1, 16)])
def test_window_digits_equal_python_integers(width, rows):
    """Every window position the ladders read, for both scalar lengths."""
    rng = random.Random(rows * 10 + width)
    ks = [rng.getrandbits(16 * rows) for _ in range(6)] + [0, (1 << (16 * rows)) - 1]
    limbs = from_reference(np.asarray(ints_to_limbs(ks, rows), dtype=np.uint32), "cpu")
    top = {(3, 9): 126, (4, 9): 128, (3, 16): 252, (1, 16): 254}[(width, rows)]
    for bitpos in range(top, -1, -width):
        got = tog.window_digit(limbs, bitpos, width).tolist()
        assert got == [(k >> bitpos) & ((1 << width) - 1) for k in ks]
    assert tog.scalar_bit(limbs, 17).tolist() == [(k >> 17) & 1 for k in ks]


def test_reference_layout_takes_glv_halves_and_sign_row(lanes):
    s1 = from_reference(lanes["s1"], "cpu")
    neg = from_reference(lanes["neg1"], "cpu")
    assert s1.dtype == torch.int32 and tuple(s1.shape) == (9, N)
    assert neg.dtype == torch.bool and tuple(neg.shape) == (N,)
    assert np.array_equal(to_reference(s1), lanes["s1"])
    assert np.array_equal(to_reference(neg), lanes["neg1"])


def test_mont_inv_and_to_affine_equal_jax_limb_for_limb(lanes, glv_results):
    p = glv_results[3]
    jp = jog.JPoints(*(jnp.asarray(to_reference(a)) for a in p))
    zinv = tma.mont_inv(FQ_SPEC, p.z)
    assert np.array_equal(to_reference(zinv), np.asarray(jax.jit(lambda z: jma.mont_inv(JFQ_SPEC, z))(jp.z)))
    assert not to_reference(zinv)[:, 0].any()  # 0 -> 0
    got = tog.to_affine(p)
    want = jax.jit(jog.to_affine)(jp)
    for t, j in zip(got, want):
        assert np.array_equal(to_reference(t), np.asarray(j))
    assert tog.unpack_points(got) == lanes["want"]
    one = tma.mont_pow_const(FQ_SPEC, p.x, 0)
    assert np.array_equal(to_reference(one), np.asarray(jma.mont_pow_const(JFQ_SPEC, jp.x, 0)))


def test_tree_reduce_and_jneg_equal_jax_limb_for_limb(lanes, glv_results):
    p = tog.JPoints(*(a[:, :5].contiguous() for a in glv_results[3]))
    jp = jog.JPoints(*(jnp.asarray(to_reference(a)) for a in p))
    for t, j in zip(tog.tree_reduce(p), jax.jit(jog.tree_reduce)(jp)):
        assert np.array_equal(to_reference(t), np.asarray(j))
    total = G1.identity()
    for q in lanes["want"][:5]:
        total = total + q
    assert tog.jpoints_to_host(tog.tree_reduce(p)) == [total]
    for t, j in zip(tog.jneg(p), jog.jneg(jp)):
        assert np.array_equal(to_reference(t), np.asarray(j))


def test_ladder_launchers_reject_cpu_tensors(lanes):
    """The CUDA wrappers never run a plain version: a CPU tensor raises, and
    no launch is counted."""
    before = dict(cuda_g1.launch_counts)
    glv = (from_reference(lanes["s1"], "cpu"), from_reference(lanes["neg1"], "cpu"), from_reference(lanes["s2"], "cpu"))
    for call in (
        lambda: cuda_g1.scalar_mul_glv(lanes["tp"], *glv),
        lambda: cuda_g1.scalar_mul(lanes["tp"], lanes["tsc"]),
        lambda: cuda_g1.scalar_mul_w1(lanes["tp"], lanes["tsc"]),
    ):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    with pytest.raises(ValueError, match="window width"):
        cuda_g1.scalar_mul_glv(lanes["tp"], *glv, w=2)
    assert cuda_g1.launch_counts == before
    assert set(cuda_g1.KERNEL_NAMES) >= {"ladder_glv_w3", "ladder_glv_w4", "ladder_w3", "ladder_w1"}
    assert set(cuda_g1.launch_counts) == set(cuda_g1.KERNEL_NAMES)


@pytest.mark.slow
def test_jax_glv_kernel_interpret_equals_plain_ladder_bit_for_bit(monkeypatch):
    """The JAX package's GLV ladder kernel itself, in interpret mode at 128
    lanes, against the port's plain GLV ladder: all three Jacobian
    coordinates, limb for limb. Takes many minutes on a CPU."""
    from curdleproofs_tpu.ops import pallas_g1 as pg

    monkeypatch.setattr(pg, "_FORCE", "1")
    rng = random.Random(29)
    n = 128
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(n)]
    pts[3] = G1.identity()
    ks = [rng.randrange(FR_MOD) for _ in range(n)]
    ks[: len(tglv.EDGE_SCALARS)] = tglv.EDGE_SCALARS
    sc = np.asarray(ints_to_limbs(ks, 16), dtype=np.uint32)
    s1, neg1, s2 = tglv.decompose(sc.astype(np.uint64))
    jpts = jog.pack_points([JG1.identity() if p.inf else JG1(p.x, p.y) for p in pts])
    want = pg.scalar_mul_glv(jpts, jnp.asarray(s1), jnp.asarray(neg1), jnp.asarray(s2))
    got = tog._scalar_mul_glv_plain(
        tog.pack_points(pts, "cpu"),
        from_reference(s1, "cpu"), from_reference(neg1, "cpu"), from_reference(s2, "cpu"),
        w=pg.GLV_W,
    )
    for t, j in zip(got, want):
        assert np.array_equal(to_reference(t), np.asarray(j))
    assert tog.jpoints_to_host(got) == [p * Fr(k) for p, k in zip(pts, ks)]
