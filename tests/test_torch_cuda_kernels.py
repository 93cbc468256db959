"""The CUDA kernels against their plain PyTorch versions, on the card.

    python -m pytest tests/test_torch_cuda_kernels.py -q -m gpu

Needs a CUDA device and nvcc; skips elsewhere (`chip_smoke.py` runs the same
comparisons, and more, as a script)."""
import random

import numpy as np
import pytest
import torch

from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.ops import cuda_g1
from curdleproofs_tpu_torch.ops import g1 as og
from curdleproofs_tpu_torch.ops import gather as ogather
from curdleproofs_tpu_torch.ops import glv as oglv
from curdleproofs_tpu_torch.ops import stream_scan as ostream
from curdleproofs_tpu_torch.ops.fieldspec import from_reference, ints_to_limbs

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def points(card):
    rng = random.Random(5)
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(256)]
    qts = pts[1:] + pts[:1]
    pts[0] = G1.identity()
    qts[1] = G1.identity()
    qts[2] = pts[2]
    qts[3] = -pts[3]
    return og.pack_points(pts, card), og.pack_points(qts, card)


def _equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def test_point_op_bodies(points):
    ap, aq = points
    pj, qj = og._jdbl_formulas(og.lift(ap)), og.lift(aq)
    before = cuda_g1.launch_counts["point_op"]
    assert _equal(og.jadd(pj, qj), og._jadd_formulas(pj, qj))
    assert _equal(og.jdbl(pj), og._jdbl_formulas(pj))
    assert _equal(og.jmadd(pj, aq), og._jmadd_formulas(pj, aq))
    assert _equal(og.jmadd(og.lift(ap), aq), og._jmadd_formulas(og.lift(ap), aq))
    assert cuda_g1.launch_counts["point_op"] == before + 4


def test_gather(card):
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.integers(0, 1 << 16, (49, 3, 100)).astype(np.int32)).to(card)
    idx = torch.from_numpy(rng.integers(-2, 102, (3, 77)).astype(np.int32)).to(card)
    assert torch.equal(ogather.gather_u32(table, idx), ogather.gather_u32_ref(table, idx))
    with pytest.raises(ValueError):
        ogather.gather_u32(table.transpose(1, 2), idx)  # shape mismatch, non-contiguous


def test_scans(points, card):
    ap, _ = points
    W, T, L, S = 2, 4, 32, 8
    rec1 = torch.cat([ap.x, ap.y, ap.inf.unsqueeze(0).to(torch.int32)], dim=0)
    rec = rec1.repeat(1, 2)[:, : W * T * L].clone()
    rec[:, 1 * L + 2] = rec[:, 0 * L + 2]  # window 0, lane 2: p == q at step 1
    rec = rec.contiguous()
    sel = torch.from_numpy(
        np.random.default_rng(2).integers(-1, L + 1, (W * T, S)).astype(np.int32)
    ).to(card)
    assert _equal(ostream.scan_records(rec, W, T, L), ostream.scan_records_ref(rec, W, T, L))
    got = ostream.scan_records_sel(rec, sel, W, T, L, S)
    assert _equal(got, ostream.scan_records_sel_ref(rec, sel, W, T, L, S))
    assert got[2].tolist()[0] == 1


@pytest.fixture(scope="module")
def ladder_lanes(card):
    """64 lanes: the edge scalars, an identity base, two equal bases, the
    rest random (about half of them with a negative k1)."""
    rng = random.Random(9)
    n = 64
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(n)]
    ks = list(oglv.EDGE_SCALARS) + [rng.randrange(FR_MOD) for _ in range(n - len(oglv.EDGE_SCALARS))]
    pts[20] = G1.identity()
    pts[22] = pts[21]
    sc = np.asarray(ints_to_limbs(ks, 16), dtype=np.uint32)
    want = [p * Fr(k) for p, k in zip(pts, ks)]
    return og.pack_points(pts, card), sc, want


@pytest.mark.parametrize("w", [3, 4])
def test_ladder_glv(ladder_lanes, card, w):
    ap, sc, want = ladder_lanes
    s1, neg1, s2 = oglv.decompose(sc.astype(np.uint64))
    assert neg1.any() and not neg1.all()
    args = (ap, from_reference(s1, card), from_reference(neg1, card), from_reference(s2, card))
    name = f"ladder_glv_w{w}"
    before = cuda_g1.launch_counts[name]
    got = og.scalar_mul_glv(*args, w=w)
    assert cuda_g1.launch_counts[name] == before + 1
    assert _equal(got, og._scalar_mul_glv_plain(*args, w=w))
    assert og.jpoints_to_host(got) == want


def test_ladder_w3_and_w1(ladder_lanes, card):
    ap, sc, want = ladder_lanes
    sc_d = from_reference(sc, card)
    before = dict(cuda_g1.launch_counts)
    got = og.scalar_mul(ap, sc_d)
    assert cuda_g1.launch_counts["ladder_w3"] == before["ladder_w3"] + 1
    assert cuda_g1.launch_counts["point_op"] == before["point_op"] + 6
    assert _equal(got, og._scalar_mul_w3_plain(ap, sc_d))
    assert og.jpoints_to_host(got) == want
    got = og.scalar_mul_w1(ap, sc_d)
    assert cuda_g1.launch_counts["ladder_w1"] == before["ladder_w1"] + 1
    assert _equal(got, og._scalar_mul_plain(ap, sc_d, acc0=og._jzero(ap.x)))
    assert og.jpoints_to_host(got) == want
