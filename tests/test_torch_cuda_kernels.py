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
from curdleproofs_tpu_torch.ops import stream_scan as ostream

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
