"""curdleproofs_tpu_torch ops.gather / ops.stream_scan / ops.scan vs the JAX
package's, limb for limb. The JAX side runs through the XLA twins of its
Pallas kernels, as its own tests do on the CPU. Integer equality only."""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curdleproofs_tpu.ops import g1 as jog
from curdleproofs_tpu.ops import gather as jgather
from curdleproofs_tpu.ops import scan as jscan
from curdleproofs_tpu.ops import stream_scan as jstream
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.ops import gather as tgather
from curdleproofs_tpu_torch.ops import scan as tscan
from curdleproofs_tpu_torch.ops import stream_scan as tstream
from curdleproofs_tpu_torch.ops.fieldspec import from_reference, to_reference

# The lanes here are few: intra-op threads add nothing but spin-waiting, which
# slows every worker of a parallel test run many times over.
torch.set_num_threads(1)

W, T, L, S = 2, 8, 32, 16


def _same(t, j):
    return np.array_equal(to_reference(t), np.asarray(j))


@pytest.mark.parametrize("shared", [False, True])
def test_gather_matches_jax_with_out_of_range(shared):
    rng = np.random.default_rng(5)
    R, Wg, N, M = 49, 3, 64, 40
    idx = rng.integers(-2, N + 2, (Wg, M)).astype(np.int32)
    idx[0, :3] = [-1, N, N - 1]
    if shared:
        table = rng.integers(0, 1 << 16, (R, N)).astype(np.uint32)
        got = tgather.gather_u32_shared(from_reference(table, "cpu"), from_reference(idx, "cpu"))
        table3 = np.repeat(table[:, None, :], Wg, axis=1)
    else:
        table3 = rng.integers(0, 1 << 16, (R, Wg, N)).astype(np.uint32)
        got = tgather.gather_u32(from_reference(table3, "cpu"), from_reference(idx, "cpu"))
    want = jgather.gather_u32_xla(jnp.asarray(table3), jnp.asarray(idx))
    assert got.dtype == torch.int32
    assert _same(got, want)
    assert not to_reference(got)[:, 0, :2].any()  # -1 and N gather zeros


def test_gather_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        tgather.gather_u32(torch.zeros((4, 2, 8), dtype=torch.int32), torch.zeros((3, 5), dtype=torch.int32))


@pytest.fixture(scope="module")
def records():
    """(49, W*T*L) records of real curve points with infinity records and,
    in lane 0 of window 0, the same point at steps 0 and 1 (p == q)."""
    rng = random.Random(23)
    n = W * T * L
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(n)]  # distinct
    pts[1 * L + 0] = pts[0 * L + 0]  # window 0, lane 0, steps 0 and 1
    pts[T * L + 3 * L + 5] = G1.identity()  # window 1, step 3, lane 5
    pts[T * L + 6] = G1.identity()  # window 1, step 0, lane 6
    ap = tog.pack_points(pts, "cpu")
    rec = torch.cat([ap.x, ap.y, ap.inf.unsqueeze(0).to(torch.int32)], dim=0)
    return rec, jnp.asarray(to_reference(rec))


def test_scan_records_matches_jax(records, monkeypatch):
    """The unsplit scan (SCAN_SPLIT = 1) is the JAX package's, limb for limb."""
    monkeypatch.setattr(tstream, "SCAN_SPLIT", 1)
    rec, jrec = records
    pref, tot = tstream.scan_records(rec, W, T, L)
    jpref, jtot = jax.jit(jstream._scan_records_xla, static_argnums=(1, 2, 3))(jrec, W, T, L)
    assert tuple(pref.shape) == (72, W, T * L) and tuple(tot.shape) == (72, W, L)
    assert _same(pref, jpref)
    assert _same(tot, jtot)


def _points(t):
    t = t.reshape(72, -1)
    return tog.jpoints_to_host(tog.JPoints(t[:24], t[24:48], t[48:]))


def test_scan_records_default_split_equals_jax_as_points(records):
    """At the default split (K sub-chains a lane) every prefix and total is
    the JAX package's point, as another Jacobian triple."""
    rec, jrec = records
    assert tstream.split_steps(T) > 1
    pref, tot = tstream.scan_records(rec, W, T, L)
    jpref, jtot = jax.jit(jstream._scan_records_xla, static_argnums=(1, 2, 3))(jrec, W, T, L)
    assert _points(pref) == _points(from_reference(np.asarray(jpref), "cpu"))
    assert _points(tot) == _points(from_reference(np.asarray(jtot), "cpu"))


def test_scan_records_sel_matches_jax_with_forced_collision(records):
    rec, jrec = records
    rng = np.random.default_rng(9)
    sel = rng.integers(-1, L, (W * T, S)).astype(np.int32)
    sel[0, :3] = [7, 7, -1]  # a repeated lane and an empty slot
    bsel, tot, flags = tstream.scan_records_sel(rec, from_reference(sel, "cpu"), W, T, L, S, split=1)
    jb, jt, jf = jax.jit(jstream.scan_records_sel, static_argnums=(2, 3, 4, 5))(
        jrec, jnp.asarray(sel), W, T, L, S
    )
    assert tuple(bsel.shape) == (72, W, T * S)
    assert _same(bsel, jb)
    assert _same(tot, jt)
    assert to_reference(flags).tolist() == np.asarray(jf).tolist() == [1, 0]
    assert not to_reference(bsel)[:, 0, 2].any()  # the empty slot is the zero triple


def test_scan_sel_out_of_range_lane_is_empty(records):
    rec, _ = records
    sel = np.full((W * T, S), -1, np.int32)
    sel[:, 0] = L  # past the last lane: an empty slot, as in the kernel
    sel[:, 1] = 4
    bsel, _, _ = tstream.scan_records_sel(rec, from_reference(sel, "cpu"), W, T, L, S, split=1)
    pref, _ = tstream.scan_records(rec, W, T, L, split=1)
    got = to_reference(bsel).reshape(72, W, T, S)
    assert not got[..., 0].any()
    want = to_reference(pref).reshape(72, W, T, L)[..., 4]
    # lane 4 never meets p == q, so the no-doubling prefixes equal the complete ones
    assert np.array_equal(got[..., 1], want)


def test_scan_wrappers_check_shapes(records):
    rec, _ = records
    with pytest.raises(ValueError):
        tstream.scan_records(rec, W, T, L + 1)
    with pytest.raises(ValueError):
        tstream.scan_records_sel(rec, torch.zeros((W * T, S + 1), dtype=torch.int32), W, T, L, S)


def test_pick_lanes(monkeypatch):
    assert tstream.pick_lanes(1 << 17) == jstream.pick_lanes(1 << 17) == 512
    assert tstream.pick_lanes(128) == 128
    monkeypatch.setattr(tstream, "_LANES", 32)
    assert tstream.pick_lanes(1 << 17) == 32 and tstream.pick_lanes(16) == 16


@pytest.fixture(scope="module")
def lane_points():
    rng = random.Random(31)
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(2 * 16)]
    pts[3] = G1.identity()
    pts[20] = pts[21]
    ap = tog.pack_points(pts, "cpu")
    tj = tog.lift(tog.APoints(ap.x.reshape(24, 2, 16), ap.y.reshape(24, 2, 16), ap.inf.reshape(2, 16)))
    jj = jog.JPoints(*(jnp.asarray(to_reference(a)) for a in tj))
    return pts, tj, jj


def test_hs_scan_matches_jax(lane_points):
    pts, tj, jj = lane_points
    got = tscan._hs_scan(tj)
    want = jax.jit(jscan._hs_scan)(jj)
    for t, j in zip(got, want):
        assert _same(t, j)
    host = tog.jpoints_to_host(tog.JPoints(*(a[:, 1] for a in got)))
    acc = G1.identity()
    for i, p in enumerate(pts[16:]):
        acc = acc + p
        assert host[i] == acc


@pytest.mark.parametrize("small_width,width", [(8, 16), (2048, 16), (2048, 13)])
def test_tree_reduce_hybrid_matches_jax(lane_points, monkeypatch, small_width, width):
    """SMALL_WIDTH lowered so a halving level above it runs too; width 13
    exercises the padding."""
    pts, tj, jj = lane_points
    monkeypatch.setattr(tscan, "SMALL_WIDTH", small_width)
    monkeypatch.setattr(jscan, "SMALL_WIDTH", small_width)
    tin = tog.JPoints(*(a[..., :width] for a in tj))
    jin = jog.JPoints(*(a[..., :width] for a in jj))
    got = tscan.tree_reduce_hybrid(tin)
    want = jscan.tree_reduce_hybrid(jin)
    for t, j in zip(got, want):
        assert _same(t, j)
    host = tog.jpoints_to_host(got)
    for w in range(2):
        acc = G1.identity()
        for p in pts[16 * w : 16 * w + width]:
            acc = acc + p
        assert host[w] == acc
