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


# Operands with one of each branch in every stretch of seven lanes, so one
# warp holds groups in different branches: P + P, P + (-P), identity on
# either side, both identity; p and q Jacobian with z != 1, d affine
GROUP_KINDS = ("dbl", "neg", "pinf", "qinf", "both")


def _rescale(a, zs, card):
    """(x z^2, y z^3, z) of affine points, z = 0 where the point is infinity."""
    from curdleproofs_tpu_torch.fields import FQ_MOD
    from curdleproofs_tpu_torch.ops import modarith as ma
    from curdleproofs_tpu_torch.ops.fieldspec import FQ_SPEC

    z = from_reference(np.asarray(ints_to_limbs([v * FQ_SPEC.r_mod % FQ_MOD for v in zs], 24), dtype=np.uint32), card)
    z2 = ma.mont_sqr(FQ_SPEC, z)
    z = torch.where(a.inf.unsqueeze(0), torch.zeros_like(z), z)
    return og.JPoints(ma.mont_mul(FQ_SPEC, a.x, z2), ma.mont_mul(FQ_SPEC, a.y, ma.mont_mul(FQ_SPEC, z2, z)), z)


def _group_operands(m, card):
    rng = random.Random(m)
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(m)]
    qts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(m)]
    for i in range(m):
        kind = GROUP_KINDS[i % 7 - 1] if 1 <= i % 7 <= len(GROUP_KINDS) else None
        if kind == "dbl":
            qts[i] = pts[i]
        elif kind == "neg":
            qts[i] = -pts[i]
        elif kind == "pinf":
            pts[i] = G1.identity()
        elif kind == "qinf":
            qts[i] = G1.identity()
        elif kind == "both":
            pts[i] = qts[i] = G1.identity()
    ap, aq = og.pack_points(pts, card), og.pack_points(qts, card)
    pj = _rescale(ap, [i + 2 for i in range(m)], card)
    qj = _rescale(aq, [3 * i + 5 for i in range(m)], card)
    return pts, qts, pj, qj, aq


@pytest.mark.parametrize("m", [1, 3, 33, 257])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("body", ["jadd", "jdbl", "jmadd"])
def test_point_op_groups(card, body, group, m):
    """Every thread group, ragged widths, every branch in one warp: bit-equal
    to the plain formulas and equal to the host's points."""
    pts, qts, pj, qj, aq = _group_operands(m, card)
    got_fn, want, host = {
        "jadd": (lambda: cuda_g1.jadd(pj, qj, group), og._jadd_formulas(pj, qj), [p + q for p, q in zip(pts, qts)]),
        "jdbl": (lambda: cuda_g1.jdbl(pj, group), og._jdbl_formulas(pj), [p + p for p in pts]),
        "jmadd": (lambda: cuda_g1.jmadd(pj, aq, group), og._jmadd_formulas(pj, aq), [p + q for p, q in zip(pts, qts)]),
    }[body]
    before = cuda_g1.launch_counts["point_op"]
    got = got_fn()
    assert cuda_g1.launch_counts["point_op"] == before + 1
    assert _equal(got, want)
    assert og.jpoints_to_host(got) == host


def test_gather(card):
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.integers(0, 1 << 16, (49, 3, 100)).astype(np.int32)).to(card)
    idx = torch.from_numpy(rng.integers(-2, 102, (3, 77)).astype(np.int32)).to(card)
    before = cuda_g1.launch_counts["gather_u32"]
    assert torch.equal(ogather.gather_u32(table, idx), ogather.gather_u32_ref(table, idx))
    assert cuda_g1.launch_counts["gather_u32"] == before + 1
    with pytest.raises(ValueError):
        ogather.gather_u32(table.transpose(1, 2), idx)  # shape mismatch, non-contiguous


# G, R, K, M: an edge shape (one group, M not a multiple of the block) and
# the three stage shapes of the routed gather at r = 16, c = 8, W = 3
@pytest.mark.parametrize("G,R,K,M", [(1, 5, 16, 300), (6, 49, 700, 24), (16, 49, 8, 24), (24, 49, 16, 16), (48, 49, 8, 8)])
def test_rowwise_gather(card, G, R, K, M):
    rng = np.random.default_rng(G * M)
    table = torch.from_numpy(rng.integers(0, 1 << 31, (G, R, K)).astype(np.int32)).to(card)
    idx = torch.from_numpy(rng.integers(-2, K + 2, (G, M)).astype(np.int32)).to(card)
    before = cuda_g1.launch_counts["rowwise_gather"]
    got = ogather.rowwise_gather(table, idx)
    assert cuda_g1.launch_counts["rowwise_gather"] == before + 1
    assert torch.equal(got, ogather.rowwise_gather_ref(table, idx))
    with pytest.raises(ValueError):
        ogather.rowwise_gather(table.transpose(1, 2), idx)  # non-contiguous


def test_routed_gather(card):
    from curdleproofs_tpu_torch.ops import route as oroute

    rng = np.random.default_rng(3)
    r, c, W = 16, 8, 3
    n = r * c
    packed = rng.integers(0, 1 << 16, (49, n)).astype(np.int32)
    src = np.stack([rng.permutation(n) for _ in range(W)]).astype(np.int32)
    tables = oroute.decompose(r, c, src)
    before = cuda_g1.launch_counts["rowwise_gather"]
    got = ogather.routed_gather(torch.from_numpy(packed).to(card), *(torch.from_numpy(t).to(card) for t in tables))
    assert cuda_g1.launch_counts["rowwise_gather"] == before + 3
    want = np.stack([packed[:, src[w]] for w in range(W)], axis=1)
    assert np.array_equal(got.cpu().numpy(), want)


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


# R, W, N, M, shared: point records, a ragged M over several blocks, the
# Jacobian triples of the stitch, one-word records; in both table layouts
@pytest.mark.parametrize("layout", ["records", "rows"])
@pytest.mark.parametrize("R,W,N,M,shared", [(49, 3, 100, 300, True), (49, 2, 1000, 129, False), (72, 4, 64, 1000, False), (1, 1, 7, 5, False)])
def test_gather_layouts(card, monkeypatch, layout, R, W, N, M, shared):
    monkeypatch.setattr(ogather, "records_pay", lambda *a: layout == "records")
    rng = np.random.default_rng(R * M)
    table = torch.from_numpy(rng.integers(0, 1 << 31, (R, 1 if shared else W, N)).astype(np.int32)).to(card)
    idx = torch.from_numpy(rng.integers(-3, N + 3, (W, M)).astype(np.int32)).to(card)
    before = cuda_g1.launch_counts["gather_u32"]
    got = ogather.gather_u32_shared(table[:, 0], idx) if shared else ogather.gather_u32(table, idx)
    assert cuda_g1.launch_counts["gather_u32"] == before + 1
    assert torch.equal(got, ogather.gather_u32_ref(table.expand(R, W, N), idx))


@pytest.mark.parametrize("split", [1, 2, 4])
def test_scan_sel_split(points, card, split):
    """The split scan against its plain version at the same split, bit for
    bit, with a forced p == q in window 0; and as points against split 1."""
    ap, _ = points
    W, T, L, S = 2, 8, 24, 8
    rec1 = torch.cat([ap.x, ap.y, ap.inf.unsqueeze(0).to(torch.int32)], dim=0)
    rec = rec1.repeat(1, 2)[:, : W * T * L].clone()
    rec[:, 1 * L + 2] = rec[:, 0 * L + 2]  # window 0, lane 2: p == q at step 1
    rec[48, T * L + 5 * L + 3] = 1  # an infinity record in window 1
    rec = rec.contiguous()
    sel = torch.from_numpy(np.random.default_rng(6).integers(-1, L + 1, (W * T, S)).astype(np.int32)).to(card)
    before = cuda_g1.launch_counts["scan_sel"]
    got = ostream.scan_records_sel(rec, sel, W, T, L, S, split=split)
    assert cuda_g1.launch_counts["scan_sel"] == before + 1
    assert _equal(got, ostream.scan_records_sel_ref(rec, sel, W, T, L, S, split=split))
    assert got[2].tolist() == [1, 0]
    one = ostream.scan_records_sel(rec, sel, W, T, L, S, split=1)
    # window 1 never meets p == q, so its points are those of the unsplit scan
    for a, b in ((got[0][:, 1], one[0][:, 1]), (got[1][:, 1], one[1][:, 1])):
        assert og.jpoints_to_host(og.JPoints(a[:24], a[24:48], a[48:])) == og.jpoints_to_host(
            og.JPoints(b[:24], b[24:48], b[48:])
        )


@pytest.mark.parametrize("split", [1, 2, 4, 16])
def test_scan_full_split(points, card, split):
    """The complete scan at `split` sub-chains a lane against its plain
    version at the same split, bit for bit: a forced p == q in window 0, a
    lane of one point at every step in window 1 (the complete add doubles in
    phases A, B and C), an infinity record; every prefix and total the same
    point as the unsplit scan's."""
    ap, _ = points
    W, T, L = 2, 16, 24
    rec1 = torch.cat([ap.x, ap.y, ap.inf.unsqueeze(0).to(torch.int32)], dim=0)
    rec = rec1.repeat(1, 3)[:, : W * T * L].clone()
    rec[:, 1 * L + 2] = rec[:, 0 * L + 2]  # window 0, lane 2: p == q at step 1
    rec = rec.reshape(49, W, T, L)
    rec[:, 1, :, 7] = rec[:, 1, :1, 7]  # window 1, lane 7: all equal
    rec[48, 1, 5, 3] = 1  # an infinity record
    rec = rec.reshape(49, W * T * L).contiguous()
    before = cuda_g1.launch_counts["scan_full"]
    got = ostream.scan_records(rec, W, T, L, split=split)
    assert cuda_g1.launch_counts["scan_full"] == before + 1
    assert _equal(got, ostream.scan_records_ref(rec, W, T, L, split=split))
    one = ostream.scan_records(rec, W, T, L, split=1)
    for a, b in zip(got, one):
        a, b = a.reshape(72, -1), b.reshape(72, -1)
        assert og.jpoints_to_host(og.JPoints(a[:24], a[24:48], a[48:])) == og.jpoints_to_host(
            og.JPoints(b[:24], b[24:48], b[48:])
        )


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


_GLV_PLAIN = {}


@pytest.mark.parametrize("lanes", [5, 64])
@pytest.mark.parametrize("group", ["picked", 1, 2, 4])
@pytest.mark.parametrize("w", [3, 4])
def test_ladder_glv(ladder_lanes, card, w, group, lanes):
    """The GLV ladder at both window widths and every thread group (the
    wrapper's pick through og.scalar_mul_glv): bit-equal to the plain
    ladder, equal to the host's k * P, one launch."""
    ap, sc, want = ladder_lanes
    ap = og.APoints(ap.x[:, :lanes].contiguous(), ap.y[:, :lanes].contiguous(), ap.inf[:lanes].contiguous())
    s1, neg1, s2 = oglv.decompose(np.ascontiguousarray(sc[:, :lanes]).astype(np.uint64))
    if lanes == 64:
        assert neg1.any() and not neg1.all()
    args = (ap, from_reference(s1, card), from_reference(neg1, card), from_reference(s2, card))
    if (w, lanes) not in _GLV_PLAIN:
        _GLV_PLAIN[(w, lanes)] = og._scalar_mul_glv_plain(*args, w=w)
    name = f"ladder_glv_w{w}"
    before = cuda_g1.launch_counts[name]
    got = og.scalar_mul_glv(*args, w=w) if group == "picked" else cuda_g1.scalar_mul_glv(*args, w=w, group=group)
    assert cuda_g1.launch_counts[name] == before + 1
    assert _equal(got, _GLV_PLAIN[(w, lanes)])
    assert og.jpoints_to_host(got) == want[:lanes]


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


_W3_PLAIN = {}


@pytest.mark.parametrize("lanes", [1, 5, 64])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_ladder_w3_groups(ladder_lanes, card, group, lanes):
    """ladder_w3 at every thread group: bit-equal to the plain ladder, equal
    to the host's k * P, one launch."""
    ap, sc, want = ladder_lanes
    ap = og.APoints(ap.x[:, :lanes].contiguous(), ap.y[:, :lanes].contiguous(), ap.inf[:lanes].contiguous())
    sc_d = from_reference(np.ascontiguousarray(sc[:, :lanes]), card)
    if lanes not in _W3_PLAIN:
        _W3_PLAIN[lanes] = og._scalar_mul_w3_plain(ap, sc_d)
    before = cuda_g1.launch_counts["ladder_w3"]
    got = cuda_g1.scalar_mul(ap, sc_d, group)
    assert cuda_g1.launch_counts["ladder_w3"] == before + 1
    assert _equal(got, _W3_PLAIN[lanes])
    assert og.jpoints_to_host(got) == want[:lanes]


@pytest.fixture(scope="module")
def w1_lanes(card):
    """4,096 lanes for ladder_w1: the edge scalars and r + 2 (whose last
    step adds P to P: the complete add's doubling), an identity base, two
    equal bases, then 64 random bases over and over with random scalars; the
    plain ladder's outputs once for all of them (a lane's result depends on
    its own inputs only, so the first m lanes serve every width m) and the
    host's k * P for the first 64."""
    rng = random.Random(13)
    n = 4096
    pool = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(64)]
    pts = [pool[i % 64] for i in range(n)]
    edges = list(oglv.EDGE_SCALARS) + [FR_MOD + 2]
    ks = edges + [rng.randrange(FR_MOD) for _ in range(n - len(edges))]
    pts[len(edges)] = G1.identity()
    pts[len(edges) + 2] = pts[len(edges) + 1]
    ap = og.pack_points(pts, card)
    sc = from_reference(np.asarray(ints_to_limbs(ks, 16), dtype=np.uint32), card)
    plain = og._scalar_mul_plain(ap, sc, acc0=og._jzero(ap.x))
    return ap, sc, plain, [p * Fr(k) for p, k in zip(pts[:64], ks[:64])]


@pytest.mark.parametrize("m", [1, 31, 124, 4096])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_ladder_w1_groups(w1_lanes, card, group, m):
    """ladder_w1 at every thread group and ragged widths: bit-equal to the
    plain bitwise ladder on all three coordinates, the host's k * P on the
    first 64 lanes, one launch."""
    ap, sc, plain, want = w1_lanes
    apm = og.APoints(ap.x[:, :m].contiguous(), ap.y[:, :m].contiguous(), ap.inf[:m].contiguous())
    before = cuda_g1.launch_counts["ladder_w1"]
    got = cuda_g1.scalar_mul_w1(apm, sc[:, :m].contiguous(), group)
    assert cuda_g1.launch_counts["ladder_w1"] == before + 1
    assert _equal(got, [t[:, :m] for t in plain])
    assert og.jpoints_to_host(og.JPoints(*(t[:, :64] for t in got))) == want[:m]


# ---- the Whisk protocol's card paths --------------------------------------


def _trackers(rng, ell):
    from curdleproofs_tpu_torch import curve
    from curdleproofs_tpu_torch.protocol import WhiskTracker

    r_G = curve.mul_host_batch([G1()] * ell, [rng.random_scalar() for _ in range(ell)])
    k_r_G = curve.mul_host_batch(r_G, [rng.random_scalar() for _ in range(ell)])
    a, b = curve.compress_host_batch(r_G), curve.compress_host_batch(k_r_G)
    return [WhiskTracker(a[48 * i : 48 * i + 48], b[48 * i : 48 * i + 48]) for i in range(ell)]


def test_whisk_batch_verify_launches_the_stream_kernels(card, monkeypatch):
    """8 shuffle proofs at ell = 124 verified in one batch, with the merged
    MSM on the streaming Pippenger (STREAM_MIN and DEVICE_MIN lowered) and
    the tracker decode on the card: true, false with a flipped byte, and
    scan_sel, gather_u32 and point_op launched."""
    from curdleproofs_tpu_torch import curve, protocol as P, vectors
    from curdleproofs_tpu_torch.ops import msm as omsm
    from curdleproofs_tpu_torch.utils.rng import ProofRng

    rng = ProofRng(8)
    crs = P.CurdleproofsCrs.new(124, P.N_BLINDERS, rng)
    pres = [_trackers(rng, 124) for _ in range(8)]
    results = P.GenerateWhiskShuffleProofs(crs, pres, ProofRng(9), device=card)
    instances = [(pre, post, proof) for pre, (post, proof) in zip(pres, results)]
    monkeypatch.setattr(vectors, "DEVICE_MIN", 64)
    monkeypatch.setattr(omsm, "STREAM_MIN", 2048)
    monkeypatch.setattr(curve, "DECOMPRESS_DEVICE_MIN", 1024)
    cuda_g1.reset_launch_counts()
    assert P.AreValidWhiskShuffleProofs(crs, instances, device=card)
    launched = dict(cuda_g1.launch_counts)
    assert all(launched[k] >= 1 for k in ("scan_sel", "gather_u32", "point_op")), launched
    bad = bytearray(instances[0][2])
    bad[60] ^= 1
    assert not P.AreValidWhiskShuffleProofs(crs, [instances[0][:2] + (bytes(bad),)] + instances[1:], device=card)


def test_device_decompress_equals_the_host_decoder(card):
    from curdleproofs_tpu_torch import curve
    from curdleproofs_tpu_torch.ops import compress as ocompress

    n = 8192
    rng = random.Random(13)
    pts = curve.mul_host_batch([G1()] * n, [Fr(rng.randrange(FR_MOD)) for _ in range(n)])
    pts[5] = G1.identity()
    blob = curve.compress_host_batch(pts)
    encs = [blob[48 * i : 48 * i + 48] for i in range(n)]
    assert ocompress.batch_decompress_to_host(encs, card) == pts
    assert curve.decompress_host_batch(blob, device=card) == pts  # routed to the card at 8,192
    assert curve.decompress_host_batch(blob, check=True) == pts  # the host decoder


def test_sharded_stream_in_a_world_of_one_equals_msm(card, tmp_path):
    """A NCCL world of one process on the card: msm_sharded_stream at n = 2^14
    (2^15 GLV lanes: the sel path) equals msm(), through scan_sel."""
    from curdleproofs_tpu_torch import curve, msm
    from curdleproofs_tpu_torch.parallel import distributed, make_mesh, msm_sharded_stream
    from curdleproofs_tpu_torch.utils.profiling import metrics

    n = 1 << 14
    rng = random.Random(21)
    pts = curve.mul_host_batch([G1()] * n, [Fr(rng.randrange(1, FR_MOD)) for _ in range(n)])
    scs = [Fr(rng.randrange(FR_MOD)) for _ in range(n)]
    distributed.initialize(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl", device=card)
    try:
        mesh = make_mesh(device=card)
        cuda_g1.reset_launch_counts()
        metrics().reset()
        got = msm_sharded_stream(pts, scs, mesh=mesh)
        launched = dict(cuda_g1.launch_counts)
        spans = metrics().report()
    finally:
        distributed.shutdown()
    assert got == msm(pts, scs, device=card)
    assert launched["scan_sel"] >= 1 and launched["gather_u32"] >= 1 and launched["point_op"] >= 1, launched
    assert "msm.sharded.sel" in spans and "msm.sharded.plain" not in spans


# ---------------------------------------------------------------------------
# the prefix scan's level schedule on the strided point kernel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scan_pool(card):
    """(49, 1024) records of real points with two identities and one point
    twice, to be tiled into scan inputs (tiling repeats points, so the scan
    meets doublings as the sorted buckets do)."""
    from curdleproofs_tpu_torch import curve

    rng = random.Random(41)
    pts = curve.mul_host_batch([G1()] * 1024, [Fr(rng.randrange(1, FR_MOD)) for _ in range(1024)])
    pts[5] = pts[900] = G1.identity()
    pts[7] = pts[6]
    ap = og.pack_points(pts, card)
    return torch.cat([ap.x, ap.y, ap.inf.unsqueeze(0).to(torch.int32)], dim=0)


def _tiled_records(pool, rows, width, seed):
    gen = torch.Generator(device=pool.device).manual_seed(seed)
    idx = torch.randint(0, pool.shape[-1], (rows, width), generator=gen, device=pool.device)
    if width > 1:
        idx[:, 1] = 5  # the identity at lane 1 of every row
    idx[-1, 0] = 900  # the last row starts with the identity
    return pool[:, idx].contiguous()


@pytest.mark.parametrize("rows,width", [(8, 1 << 19), (1, 1 << 19)])
def test_scan_records_at_the_benchmark_shape(scan_pool, rows, width):
    """The card's schedule (27 launches at 2^19 lanes) against its plain twin
    on the card, bit for bit on all 72 rows; the groups picked span 1, 2, 4."""
    from curdleproofs_tpu_torch.ops import scan as oscan

    g = _tiled_records(scan_pool, rows, width, rows)
    before = cuda_g1.launch_counts["point_strided"]
    got = oscan.inclusive_scan_records(g)
    assert cuda_g1.launch_counts["point_strided"] == before + 27 == before + oscan.scan_launches(g)
    want = oscan.inclusive_scan_levels_ref(g)
    assert torch.equal(got, want)


@pytest.mark.parametrize("small", [1, 4, 2048])
@pytest.mark.parametrize("rows,width", [(1, 8), (3, 64), (8, 256), (3, 1), (1, 2)])
def test_scan_records_narrow(scan_pool, monkeypatch, small, rows, width):
    """Narrow widths at zero to eight levels above the fixed-width scan (of
    width one where SMALL_WIDTH is 1), against the twin and against the CPU
    path (lift, inclusive_scan)."""
    from curdleproofs_tpu_torch.ops import scan as oscan

    monkeypatch.setattr(oscan, "SMALL_WIDTH", small)
    g = _tiled_records(scan_pool, rows, width, width)
    got = oscan.inclusive_scan_records(g)
    assert torch.equal(got, oscan.inclusive_scan_levels_ref(g))
    assert torch.equal(got.cpu(), oscan.inclusive_scan_records(g.cpu()))


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("rows,width,small", [(3, 256, 4), (8, 4096, 2048)])
def test_scan_records_every_group(scan_pool, monkeypatch, group, rows, width, small):
    """Every launch of the schedule at each thread group, forced, bit-equal
    to the twin."""
    import functools

    from curdleproofs_tpu_torch.ops import scan as oscan

    monkeypatch.setattr(oscan, "SMALL_WIDTH", small)
    g = _tiled_records(scan_pool, rows, width, group)
    got = oscan._run_schedule(g, functools.partial(cuda_g1.point_strided, group=group))
    assert torch.equal(got, oscan.inclusive_scan_levels_ref(g))


def test_point_strided_refuses_views_that_do_not_fit_the_body(scan_pool, card):
    """The library refuses a launch whose views lack its body's layout: a
    level up at an odd column, a level up named DOWN (no copy), a level down
    named ANY (a copy), a fixed-width step named UP, a body it does not
    have; the schedule's own launches run."""
    from curdleproofs_tpu_torch.ops import scan as oscan

    g = _tiled_records(scan_pool, 3, 256, 3)
    cols, launches = oscan.scan_schedule(256, 4)
    bufs = (g, torch.zeros((72, 3, cols), dtype=torch.int32, device=card),
            torch.zeros((72, 3, 256), dtype=torch.int32, device=card))
    up, down = launches[0], launches[-1]
    fixed = next(s for s in launches if s.kind == oscan.ANY)
    R, S = oscan.RECORDS, oscan.SCRATCH
    odd = oscan.Launch(64, oscan.Operand(R, 1, 2), oscan.Operand(R, 2, 2), oscan.Operand(S, 0), kind=oscan.UP)
    for bad in (odd, up._replace(kind=oscan.DOWN), down._replace(kind=oscan.ANY), fixed._replace(kind=oscan.UP),
                up._replace(kind=3)):
        with pytest.raises(RuntimeError):
            cuda_g1.point_strided(bufs, bad)
    for step in launches:
        cuda_g1.point_strided(bufs, step)
    torch.cuda.synchronize()


def test_sorted_window_partials_equal_the_old_composition(scan_pool, card):
    """At 2^16 lanes and c = 13: the total and the boundary sums of
    `_sorted_window_partials` equal lift -> inclusive_scan -> cat -> gather ->
    tree reduce, the composition it replaced, bit for bit; its span
    `msm.window.scan` counts the schedule's launches."""
    from curdleproofs_tpu_torch.ops import msm as omsm
    from curdleproofs_tpu_torch.ops import scan as oscan
    from curdleproofs_tpu_torch.utils.profiling import collect

    n, c, wb = 1 << 16, 13, 3
    gen = torch.Generator(device=card).manual_seed(7)
    packed = scan_pool[:, torch.randint(0, 1024, (n,), generator=gen, device=card)].contiguous()
    digits = torch.randint(0, 1 << c, (wb, n), generator=gen, device=card, dtype=torch.int32)
    digits[1, : n // 2] = 0  # a long empty-bucket run
    sd, order = torch.sort(digits, dim=-1, stable=True)
    ts = torch.arange((1 << c) - 1, dtype=digits.dtype, device=card)
    e = torch.searchsorted(sd, ts.expand(wb, -1).contiguous(), right=True) - 1
    order, e = order.to(torch.int32).contiguous(), e.to(torch.int32).contiguous()
    with collect() as reg:
        total, bsums = omsm._sorted_window_partials(packed, order, e)
    assert reg.report()["msm.window.scan"]["total_items"] == len(oscan.scan_schedule(n, oscan.SMALL_WIDTH)[1]) == 21

    g = ogather.gather_u32_shared(packed, order)
    P = oscan.inclusive_scan(og.lift(og.APoints(g[:24], g[24:48], g[48] != 0)))
    bg = ogather.gather_u32(torch.cat([P.x, P.y, P.z], dim=0), e)
    want_b = oscan.tree_reduce_hybrid(omsm._split72(bg))
    want_t = og.JPoints(P.x[:, 0, -1], P.y[:, 0, -1], P.z[:, 0, -1])
    assert _equal(total, want_t)
    assert _equal(bsums, want_b)
