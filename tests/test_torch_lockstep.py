"""The port's lockstep batch prover (curdleproofs_tpu_torch.utils.lockstep)
on device="cpu": K = 4 shuffle proofs at ell = 4 with every merged point
operation on the tensor path (device_min = 1: `msm_ladder_segmented` for the
MSMs, `ops.vector` for scales, adds and folds, their plain versions here),
byte for byte equal to the thread-mode proofs of the same seed and to the
JAX package's; each merge kind against the host; a diverging schedule
raises. The tensor path costs a plain ladder (about 5 s on the CPU) for
each of the protocol's merged steps, which makes the first test the longest
of the port's CPU tests."""
import pytest
import torch

import curdleproofs_tpu.models.api as J
from curdleproofs_tpu.curve import G1 as JG1
from curdleproofs_tpu.utils.rng import ProofRng as JRng
import curdleproofs_tpu_torch as T
from curdleproofs_tpu_torch.utils import lockstep
from curdleproofs_tpu_torch.utils.profiling import metrics
from curdleproofs_tpu_torch.utils.rng import ProofRng
from curdleproofs_tpu_torch.vectors import PointVec, ScalarVec

torch.set_num_threads(1)

ELL, K = 4, 4


def _trackers(G1, Tracker, rng, ell):
    out = []
    for _ in range(ell):
        r_G = G1() * rng.random_scalar()
        out.append(Tracker(r_G.to_compressed_bytes(), (r_G * rng.random_scalar()).to_compressed_bytes()))
    return out


def _batch(api, G1, Rng, **kw):
    rng = Rng(1234)
    crs = api.CurdleproofsCrs.new(ELL, 4, rng)
    pres = [_trackers(G1, api.WhiskTracker, rng, ELL) for _ in range(K)]
    return crs, pres, api.GenerateWhiskShuffleProofs(crs, pres, Rng(42), **kw)


def _flat(results):
    return [([(t.r_G, t.k_r_G) for t in post], proof) for post, proof in results]


def test_lockstep_proofs_on_the_tensor_path_equal_thread_mode_and_jax(monkeypatch):
    _, _, jres = _batch(J, JG1, JRng)
    crs, pres, thread = _batch(T, T.G1, ProofRng, device="cpu")
    assert _flat(thread) == _flat(jres)

    merges = []
    real_init = lockstep.LockstepContext.__init__

    def every_merge_on_the_tensor_path(self, K, device_min, device):
        real_init(self, K, 1, device)
        merges.append(self)

    monkeypatch.setattr(lockstep.LockstepContext, "__init__", every_merge_on_the_tensor_path)
    monkeypatch.setenv("CURDLEPROOFS_BATCH_PROVE", "lockstep")
    metrics().reset()
    _, _, locked = _batch(T, T.G1, ProofRng, device="cpu")
    assert len(merges) == 1 and merges[0].device == torch.device("cpu")
    assert _flat(locked) == _flat(thread)
    # the merged MSMs went through the segmented ladder, one launch a step
    assert metrics().report()["msm.ladder_seg.device"]["calls"] >= 40
    for pre, (post, proof) in zip(pres, locked):
        assert T.IsValidWhiskShuffleProof(crs, pre, post, proof, device="cpu")


@pytest.mark.parametrize("device_min", [1, 1 << 20])
def test_each_merge_kind_equals_the_host(device_min):
    """msm, scaled, add and folded, merged across 3 workers, on the tensor
    path (device_min 1) and on the host (device_min above every width)."""
    rng = ProofRng(5)
    gen = T.G1()
    pts = [[gen * rng.random_scalar() for _ in range(8)] for _ in range(3)]
    scs = [[rng.random_scalar() for _ in range(8)] for _ in range(3)]
    gammas = [rng.random_scalar() for _ in range(3)]
    pts[0][2] = T.G1.identity()

    def make(i):
        def work():
            pv, sv = PointVec(pts[i]), ScalarVec.of(scs[i])
            return pv.msm(sv), pv.scaled(sv).tolist(), (pv + pv).tolist(), pv.folded(gammas[i]).tolist()

        return work

    got = lockstep.run_lockstep([make(i) for i in range(3)], device_min=device_min, device="cpu")
    for i in range(3):
        pv, sv = PointVec(pts[i]), ScalarVec.of(scs[i])
        assert got[i] == (pv.msm(sv), pv.scaled(sv).tolist(), (pv + pv).tolist(), pv.folded(gammas[i]).tolist())


def test_lockstep_divergence_detected():
    gen = T.G1()
    pv2, pv3 = PointVec([gen, gen + gen]), PointVec([gen, gen, gen])
    sv2, sv3 = ScalarVec.of([1, 2]), ScalarVec.of([1, 2, 3])
    with pytest.raises(lockstep.LockstepError):
        lockstep.run_lockstep([lambda: pv2.msm(sv2), lambda: pv3.msm(sv3)], device="cpu")
