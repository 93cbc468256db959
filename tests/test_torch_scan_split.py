"""The split scan and the record-major gather of curdleproofs_tpu_torch
against the JAX package, on the CPU through their plain versions.

`scan_records_sel` with the lane's steps split into K sub-chains computes the
same points as the JAX package's unsplit scan, as other Jacobian triples:
held after normalisation to affine. The record-major gather is held limb for
limb. Integer equality only."""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curdleproofs_tpu.ops import gather as jgather
from curdleproofs_tpu.ops import stream_scan as jstream
from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import g1 as tog
from curdleproofs_tpu_torch.ops import gather as tgather
from curdleproofs_tpu_torch.ops import stream_scan as tstream
from curdleproofs_tpu_torch.ops.fieldspec import from_reference, to_reference

# The lanes here are few: intra-op threads add nothing but spin-waiting, which
# slows every worker of a parallel test run many times over.
torch.set_num_threads(1)

W, T, L, S = 2, 8, 16, 16


@pytest.fixture(scope="module")
def scanned():
    """Records of real points with infinity records and, in lane 0 of
    window 0, the same point at steps 0 and 1 (p == q); a selection with a
    repeated lane, an empty and an out-of-range slot; and the JAX package's
    unsplit scan of them."""
    rng = random.Random(41)
    n = W * T * L
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(n)]
    pts[1 * L + 0] = pts[0 * L + 0]  # window 0, lane 0, steps 0 and 1
    pts[T * L + 3 * L + 5] = G1.identity()  # window 1, step 3, lane 5
    pts[T * L + 6] = G1.identity()  # window 1, step 0, lane 6
    pts[T * L + 7 * L + 9] = G1.identity()  # window 1, last step, lane 9
    ap = tog.pack_points(pts, "cpu")
    rec = torch.cat([ap.x, ap.y, ap.inf.unsqueeze(0).to(torch.int32)], dim=0)
    sel = np.random.default_rng(4).integers(-1, L, (W * T, S)).astype(np.int32)
    sel[0, :4] = [7, 7, -1, L]
    sel[T - 1, :2] = [9, 0]  # window 0, last step
    want = jax.jit(jstream.scan_records_sel, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(to_reference(rec)), jnp.asarray(sel), W, T, L, S
    )
    return rec, from_reference(sel, "cpu"), want


def _host(t: torch.Tensor, keep: np.ndarray):
    """(72, ...) Jacobian limbs -> the host points where `keep` is set."""
    t = t.reshape(72, -1)[:, torch.from_numpy(keep.reshape(-1))]
    return tog.jpoints_to_host(tog.JPoints(t[:24], t[24:48], t[48:]))


@pytest.mark.parametrize("split", [2, 4, 8])
def test_split_scan_equals_jax_as_points(scanned, split):
    rec, sel, (jb, jt, jf) = scanned
    bsel, tot, flags = tstream.scan_records_sel(rec, sel, W, T, L, S, split=split)
    assert tuple(bsel.shape) == (72, W, T * S) and tuple(tot.shape) == (72, W, L)
    # past the collision, lane 0 of window 0 holds wrong points in both scans
    # (that is what the flag says), but not the same wrong points
    keep_b = np.ones((W, T * S), bool)
    keep_b[0] = to_reference(sel).reshape(W, T * S)[0] != 0
    keep_t = np.ones((W, L), bool)
    keep_t[0, 0] = False
    assert _host(bsel, keep_b) == _host(from_reference(np.asarray(jb), "cpu"), keep_b)
    assert _host(tot, keep_t) == _host(from_reference(np.asarray(jt), "cpu"), keep_t)
    # the forced collision is still flagged, and nothing else is
    assert to_reference(flags).tolist() == np.asarray(jf).tolist() == [1, 0]
    assert not to_reference(bsel)[:, 0, 2].any() and not to_reference(bsel)[:, 0, 3].any()


def test_split_one_is_the_unsplit_scan(scanned):
    rec, sel, (jb, jt, jf) = scanned
    for got, want in zip(tstream.scan_records_sel(rec, sel, W, T, L, S, split=1), (jb, jt, jf)):
        assert np.array_equal(to_reference(got), np.asarray(want))


@pytest.fixture(scope="module")
def full_scanned(scanned):
    """The records of `scanned` with lane 11 of window 1 holding one point at
    every step (so the complete add doubles in phase A, in phase B where two
    sub-chain sums are equal, and in phase C), and the JAX package's
    complete scan of them."""
    rec = scanned[0].clone().reshape(49, W, T, L)
    rec[:, 1, :, 11] = rec[:, 1, :1, 11]
    rec = rec.reshape(49, W * T * L)
    want = jax.jit(jstream._scan_records_xla, static_argnums=(1, 2, 3))(jnp.asarray(to_reference(rec)), W, T, L)
    return rec, want


@pytest.mark.parametrize("split", [1, 2, 4])
def test_full_scan_ref_split_equals_jax(full_scanned, split):
    """`scan_records_ref` in `split` sub-chains against the JAX package's
    complete scan: limb for limb unsplit, every prefix and total the same
    point at K > 1."""
    rec, (jp, jt) = full_scanned
    pref, tot = tstream.scan_records_ref(rec, W, T, L, split=split)
    assert tuple(pref.shape) == (72, W, T * L) and tuple(tot.shape) == (72, W, L)
    if split == 1:
        assert np.array_equal(to_reference(pref), np.asarray(jp))
        assert np.array_equal(to_reference(tot), np.asarray(jt))
    else:
        keep_p, keep_t = np.ones((W, T * L), bool), np.ones((W, L), bool)
        assert _host(pref, keep_p) == _host(from_reference(np.asarray(jp), "cpu"), keep_p)
        assert _host(tot, keep_t) == _host(from_reference(np.asarray(jt), "cpu"), keep_t)
    # the all-equal lane: step t holds (t + 1) * P
    r = rec[:, T * L + 11 : T * L + 12]
    base = tog.unpack_points(tog.APoints(r[:24], r[24:48], r[48] != 0))[0]
    lane = pref.reshape(72, W, T, L)[:, 1, :, 11]
    assert _host(lane, np.ones(T, bool)) == [base * Fr(t + 1) for t in range(T)]


def test_split_steps():
    assert tstream.split_steps(256, 8) == 8
    assert tstream.split_steps(8, 16) == 8  # at most T
    assert tstream.split_steps(12, 8) == 4  # a power of two dividing T
    assert tstream.split_steps(7, 4) == 1
    assert tstream.split_steps(256) == tstream.SCAN_SPLIT
    for bad in (0, 3, 64):
        with pytest.raises(ValueError):
            tstream.split_steps(256, bad)


@pytest.mark.parametrize("R,Wg,N,M,shared", [(49, 3, 64, 40, True), (49, 3, 64, 40, False), (72, 2, 50, 130, False), (5, 1, 9, 300, False)])
def test_record_major_gather_equals_jax(R, Wg, N, M, shared):
    rng = np.random.default_rng(R * M)
    idx = rng.integers(-3, N + 3, (Wg, M)).astype(np.int32)
    idx[0, :3] = [-1, N, N - 1]
    table3 = rng.integers(0, 1 << 16, (R, 1 if shared else Wg, N)).astype(np.uint32)
    rec = tgather.record_major(from_reference(table3, "cpu"))
    assert tuple(rec.shape) == (table3.shape[1], N, tgather.record_pitch(R))
    assert tgather.record_pitch(R) % 8 == 0 and tgather.record_pitch(R) - 8 < R
    assert np.array_equal(to_reference(rec[..., :R]), table3.transpose(1, 2, 0))
    got = tgather.gather_records_ref(rec, from_reference(idx, "cpu"), R)
    want = jgather.gather_u32_xla(jnp.asarray(np.broadcast_to(table3, (R, Wg, N))), jnp.asarray(idx))
    assert got.dtype == torch.int32
    assert np.array_equal(to_reference(got), np.asarray(want))
    assert not to_reference(got)[:, 0, :2].any()  # -1 and N gather zeros


@pytest.mark.parametrize("layout", ["records", "rows"])
@pytest.mark.parametrize("shared", [False, True])
def test_gather_u32_in_both_layouts_equals_jax(monkeypatch, layout, shared):
    """`gather_u32` / `gather_u32_shared` with the layout forced either way."""
    monkeypatch.setattr(tgather, "records_pay", lambda *a: layout == "records")
    rng = np.random.default_rng(7)
    R, Wg, N, M = 49, 3, 64, 100
    idx = rng.integers(-3, N + 3, (Wg, M)).astype(np.int32)
    table3 = rng.integers(0, 1 << 16, (R, 1 if shared else Wg, N)).astype(np.uint32)
    t = from_reference(table3, "cpu")
    got = tgather.gather_u32_shared(t[:, 0], from_reference(idx, "cpu")) if shared else tgather.gather_u32(
        t, from_reference(idx, "cpu")
    )
    want = jgather.gather_u32_xla(jnp.asarray(np.broadcast_to(table3, (R, Wg, N))), jnp.asarray(idx))
    assert np.array_equal(to_reference(got), np.asarray(want))


@pytest.mark.parametrize(
    "records,shape,R",
    [
        (True, (3, 64, 56), 49),  # table of 3 windows for 2
        (True, (1, 64, 52), 49),  # pitch not whole sectors
        (True, (1, 64, 56), 57),  # R larger than the pitch
        (False, (48, 1, 64), 49),  # R disagrees with the rows
        (False, (49, 3, 64), 49),  # table of 3 windows for 2
        (False, (49, 64), 49),  # not (R, Wt, N)
    ],
)
def test_gather_layout_rejects_a_table_of_another_shape(records, shape, R):
    """The table's shape must agree with R, its layout and the windows of
    idx: on the card a wrong shape would read out of bounds."""
    idx = torch.zeros((2, 10), dtype=torch.int32)
    with pytest.raises(ValueError):
        tgather.gather_layout(torch.zeros(shape, dtype=torch.int32), idx, R, records=records)


def test_records_pay_at_the_msm_shapes():
    """The copy pays for the sorted-order gather of all records at every
    stream width (n = 2^14, 2^15, 2^16), not for the stitch's 8,191
    boundaries a window out of 32,768 selected prefixes, nor out of the
    small lane-offset table."""
    for n2 in (1 << 15, 1 << 16, 1 << 17):
        assert tgather.records_pay(49, 1, n2, 10, n2)
    assert not tgather.records_pay(72, 10, 128 * 256, 10, 8191)
    assert not tgather.records_pay(72, 10, 512, 10, 8191)
