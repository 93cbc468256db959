"""The port's protocol and Whisk API (curdleproofs_tpu_torch.protocol) against
the JAX package's, on device="cpu": byte-identical CRS, shuffle proofs,
post-shuffle trackers and tracker proofs under the same ProofRng seed at
ell = 4 and 12 (the JAX side runs its pure-Python backend here), each
package verifying the other's proofs, batched verification with the merged
MSM and the tracker decode on the port's tensor code (DEVICE_MIN and
DECOMPRESS_DEVICE_MIN patched low), serde round trips, the pure-Python
oracle run, and the refusal to run without a card."""
import json

import pytest
import torch

import curdleproofs_tpu.models.api as J
from curdleproofs_tpu.curve import G1 as JG1
from curdleproofs_tpu.utils.rng import ProofRng as JRng
import curdleproofs_tpu_torch as T
from curdleproofs_tpu_torch import curve, vectors
from curdleproofs_tpu_torch.ops import compress as tcompress
from curdleproofs_tpu_torch.utils.profiling import metrics
from curdleproofs_tpu_torch.utils.rng import ProofRng
from curdleproofs_tpu_torch.utils.serde import BufReader

torch.set_num_threads(1)

N_BLINDERS = 4
SEED = 20


def _trackers(G1, Tracker, rng, ell):
    out = []
    for _ in range(ell):
        r_G = G1() * rng.random_scalar()
        out.append(Tracker(r_G.to_compressed_bytes(), (r_G * rng.random_scalar()).to_compressed_bytes()))
    return out


def _make(api, G1, Rng, ell, **kw):
    rng = Rng(SEED + ell)
    crs = api.CurdleproofsCrs.new(ell, N_BLINDERS, rng)
    pre = _trackers(G1, api.WhiskTracker, rng, ell)
    post, proof = api.GenerateWhiskShuffleProof(crs, pre, rng, **kw)
    return crs, pre, post, proof


@pytest.fixture(scope="module", params=[4, 12])
def both(request):
    ell = request.param
    return ell, _make(J, JG1, JRng, ell), _make(T, T.G1, ProofRng, ell, device="cpu")


def _enc(trackers):
    return [(t.r_G, t.k_r_G) for t in trackers]


def test_crs_and_shuffle_proof_are_byte_identical(both):
    ell, (jcrs, jpre, jpost, jproof), (crs, pre, post, proof) = both
    assert crs.to_bytes() == jcrs.to_bytes()
    assert crs.to_json() == jcrs.to_json()
    assert _enc(pre) == _enc(jpre)
    lg_n = (ell + N_BLINDERS).bit_length() - 1
    assert proof == jproof and len(proof) == 48 + 48 * (18 + 10 * lg_n) + 224  # M, then the shuffle proof
    assert _enc(post) == _enc(jpost)


def test_each_package_verifies_the_others_proofs(both):
    _, (jcrs, jpre, jpost, jproof), (crs, pre, post, proof) = both
    assert T.IsValidWhiskShuffleProof(crs, pre, post, jproof, device="cpu")
    assert J.IsValidWhiskShuffleProof(jcrs, jpre, jpost, proof)
    bad = bytearray(proof)
    bad[-40] ^= 1
    assert not T.IsValidWhiskShuffleProof(crs, pre, post, bytes(bad), device="cpu")
    assert not T.IsValidWhiskShuffleProof(crs, post, pre, proof, device="cpu")


def test_tracker_proof_is_byte_identical_and_verifies_both_ways():
    out = {}
    for api, G1, Rng, kw in ((J, JG1, JRng, {}), (T, T.G1, ProofRng, {"device": "cpu"})):
        rng = Rng(44)
        k, r = rng.random_scalar(), rng.random_scalar()
        r_G = G1() * r
        tracker = api.WhiskTracker(r_G.to_compressed_bytes(), (r_G * k).to_compressed_bytes())
        k_commitment = (G1() * k).to_compressed_bytes()
        proof = api.GenerateWhiskTrackerProof(tracker, k, rng, **kw)
        wrong = api.GenerateWhiskTrackerProof(tracker, rng.random_scalar(), rng, **kw)
        out[api] = (tracker, k_commitment, proof, wrong)
    (jt, jkc, jp, jw), (tt, tkc, tp, tw) = out[J], out[T]
    assert tp == jp and tw == jw and len(tp) == 128 and tkc == jkc
    assert T.IsValidWhiskOpeningProof(tt, tkc, jp, device="cpu")
    assert J.IsValidWhiskOpeningProof(jt, jkc, tp)
    assert not T.IsValidWhiskOpeningProof(tt, tkc, tw, device="cpu")


def test_serde_round_trips(both):
    ell, (jcrs, _, _, jproof), (crs, pre, post, proof) = both
    n = ell + N_BLINDERS
    assert T.CurdleproofsCrs.from_json(crs.to_json(), device="cpu").to_bytes() == crs.to_bytes()
    assert T.CurdleproofsCrs.from_bytes(BufReader(crs.to_bytes()), ell, N_BLINDERS).to_bytes() == crs.to_bytes()
    wrapped = T.WhiskShuffleProof.from_bytes(BufReader(proof), n)
    assert wrapped.to_bytes() == proof
    as_json = json.dumps(wrapped.to_json())
    assert as_json == json.dumps(J.WhiskShuffleProof.from_bytes(BufReader(jproof), n).to_json())
    assert T.WhiskShuffleProof.from_json(json.loads(as_json)).to_bytes() == proof
    cols = [curve.decompress_host_batch(b"".join(c)) for c in zip(*_enc(pre))] + [
        curve.decompress_host_batch(b"".join(c)) for c in zip(*_enc(post))
    ]
    vi = T.VerifierInput(*cols, wrapped.M)
    back = T.VerifierInput.from_json(vi.to_json(), device="cpu")
    assert back.to_json() == vi.to_json()
    T.verify_shuffle_proofs(crs, [(wrapped.proof, back)], rng=ProofRng(1), device="cpu")


def test_the_oracle_backends_give_the_same_bytes(monkeypatch):
    """The pure-Python curve and transcript give the native run's bytes."""
    native = _make(T, T.G1, ProofRng, 4, device="cpu")
    monkeypatch.setenv("CURDLEPROOFS_TRANSCRIPT_NATIVE", "0")
    with curve.oracle():
        oracle = _make(T, T.G1, ProofRng, 4, device="cpu")
    assert oracle[0].to_bytes() == native[0].to_bytes()
    assert oracle[3] == native[3] and _enc(oracle[2]) == _enc(native[2])


def test_batched_verification_on_the_tensor_code(monkeypatch):
    """AreValidWhiskShuffleProofs over 3 instances, with the merged MSMs and
    the one-call tracker decode on the port's tensor code on the CPU: true;
    false with one proof byte flipped; false with pre and post swapped."""
    ell = 4
    rng = ProofRng(55)
    crs = T.CurdleproofsCrs.new(ell, N_BLINDERS, rng)
    instances = []
    for _ in range(3):
        pre = _trackers(T.G1, T.WhiskTracker, rng, ell)
        post, proof = T.GenerateWhiskShuffleProof(crs, pre, rng, device="cpu")
        instances.append((pre, post, proof))
    monkeypatch.setattr(vectors, "DEVICE_MIN", 2)
    monkeypatch.setattr(curve, "DECOMPRESS_DEVICE_MIN", 3 * 4 * ell)
    decodes = []
    real = tcompress.batch_decompress_to_host
    monkeypatch.setattr(tcompress, "batch_decompress_to_host", lambda e, d: decodes.append(len(e)) or real(e, d))
    metrics().reset()
    assert T.AreValidWhiskShuffleProofs(crs, instances, device="cpu")
    rep = metrics().report()
    assert decodes == [3 * 4 * ell]
    assert rep["msm.ladder.device"]["calls"] == 2  # the commitments' MSM and the merged one
    assert rep["vectors.pack"]["calls"] == 2
    assert rep["whisk.batch.decode"]["calls"] == rep["whisk.batch.replay"]["calls"] == 1
    pre0, post0, pb0 = instances[0]
    bad = bytearray(pb0)
    bad[60] ^= 1
    assert not T.AreValidWhiskShuffleProofs(crs, [(pre0, post0, bytes(bad))] + instances[1:], device="cpu")
    assert not T.AreValidWhiskShuffleProofs(crs, [(post0, pre0, pb0)] + instances[1:], device="cpu")


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    from curdleproofs_tpu_torch.utils.lockstep import run_lockstep

    rng = ProofRng(3)
    crs = T.CurdleproofsCrs.new(4, N_BLINDERS, rng)
    pre = _trackers(T.G1, T.WhiskTracker, rng, 4)
    post, proof = T.GenerateWhiskShuffleProof(crs, pre, rng, device="cpu")
    tracker, k = pre[0], rng.random_scalar()
    for call in (
        lambda: T.GenerateWhiskShuffleProof(crs, pre, rng),
        lambda: T.GenerateWhiskShuffleProofs(crs, [pre, pre], rng),
        lambda: T.IsValidWhiskShuffleProof(crs, pre, post, proof),
        lambda: T.AssertIsValidWhiskShuffleProof(crs, pre, post, proof),
        lambda: T.AreValidWhiskShuffleProofs(crs, [(pre, post, proof)]),
        lambda: T.GenerateWhiskTrackerProof(tracker, k, rng),
        lambda: T.IsValidWhiskOpeningProof(tracker, tracker.r_G, bytes(128)),
        lambda: T.AssertIsValidWhiskOpeningProof(tracker, tracker.r_G, bytes(128)),
        lambda: T.verify_shuffle_proofs(crs, []),
        lambda: run_lockstep([lambda: 1, lambda: 2]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_point_vectors_route_by_size_and_pass_the_device(monkeypatch):
    """Below DEVICE_MIN a PointVec operation runs on the host backend and
    never sees the device; from DEVICE_MIN it goes to ops.msm / ops.vector
    with the device it was given (stand-ins record the calls, the host
    computes the values), and the packed basis is cached per device."""
    from curdleproofs_tpu_torch.ops import msm as omsm
    from curdleproofs_tpu_torch.ops import vector as ovec
    from curdleproofs_tpu_torch.vectors import PointVec, ScalarVec

    calls, packed_bases = [], []

    def msm(bases, scalars, method, device, packed):
        calls.append(("msm", device))
        packed_bases.append(packed)
        return curve.msm_host(bases, scalars)

    def scale_points(p, s, device):
        calls.append(("scale", device))
        return curve.mul_host_batch(p, s)

    def add_points(a, b, device):
        calls.append(("add", device))
        return curve.add_host_batch(a, b)

    def fold_points(a, b, gamma, device):
        calls.append(("fold", device))
        return curve.add_host_batch(a, curve.mul_host_batch(b, [gamma] * len(b)))

    monkeypatch.setattr(omsm, "msm", msm)
    for name, fn in (("scale_points", scale_points), ("add_points", add_points), ("fold_points", fold_points)):
        monkeypatch.setattr(ovec, name, fn)
    pv, sv, gamma = PointVec([T.G1() * T.Fr(k) for k in (2, 3, 5, 7)]), ScalarVec.of([11, 13, 17, 19]), T.Fr(23)
    want = (pv.msm(sv), pv.scaled(sv).tolist(), pv.add(pv).tolist(), pv.folded(gamma).tolist())
    assert calls == []
    monkeypatch.setattr(vectors, "DEVICE_MIN", 2)
    cpu = torch.device("cpu")
    got = (pv.msm(sv, cpu), pv.scaled(sv, cpu).tolist(), pv.add(pv, cpu).tolist(), pv.folded(gamma, cpu).tolist())
    assert got == want
    assert calls == [("msm", cpu), ("scale", cpu), ("add", cpu), ("fold", cpu)]
    pv.msm(sv, cpu)
    assert packed_bases[1] is packed_bases[0] and packed_bases[0].x.shape == (24, 4)  # packed once
