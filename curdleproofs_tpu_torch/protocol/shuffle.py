"""Top-level Curdleproofs shuffle argument.

Ties the same-permutation, same-scalar, and same-MSM sub-arguments together
over one shared Fiat-Shamir oracle, with every verifier equation deferred
into one MSMAccumulator (so one proof — or a batch of many — costs a single
large device MSM). Behaviour parity: curdleproofs.py:29-361; label schedule
SURVEY.md §3.4; wire layout §3.5.

The entry points take `device` (None is the card, and raises without one)
and hand the resolved device to every vector operation and accumulator that
can reach the card; at spec size (n = 128 < vectors.DEVICE_MIN) a single
proof runs on the host backend.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import ClassVar, List, Optional, Tuple

from curdleproofs_tpu_torch.curve import G1, decompress_host_batch
from curdleproofs_tpu_torch.fields import Fr
from curdleproofs_tpu_torch.protocol.folding import SameMSMProof
from curdleproofs_tpu_torch.protocol.primitives import (
    CurdleproofsCrs,
    GroupCommitment,
    MSMAccumulator,
)
from curdleproofs_tpu_torch.protocol.products import SamePermutationProof
from curdleproofs_tpu_torch.protocol.sigma import SameScalarProof
from curdleproofs_tpu_torch.protocol.wire import PT, WireStruct
from curdleproofs_tpu_torch.transcript.oracle import Transcript
from curdleproofs_tpu_torch.utils.device import DeviceArg, resolve_device
from curdleproofs_tpu_torch.utils.errors import VerificationError
from curdleproofs_tpu_torch.utils.rng import ProofRng, default_rng
from curdleproofs_tpu_torch.vectors import PointVec, ScalarVec, as_points, as_scalars

N_BLINDERS = 4

_DOMAIN = b"curdleproofs"
_STEP1 = b"curdleproofs_step1"
_VEC_A = b"curdleproofs_vec_a"


def _bind_instance(
    transcript: Transcript, R, S, T, U, M: G1, ell: int
) -> ScalarVec:
    """Absorb the full shuffle instance and draw the ell challenge weights
    (curdleproofs.py:65-71 and :179-183 — prover and verifier share this)."""
    transcript.absorb(_STEP1, R, S, T, U)
    transcript.absorb(_STEP1, M)
    return as_scalars(transcript.scalars(_VEC_A, ell))


def _msm_bases(crs: CurdleproofsCrs) -> PointVec:
    """The extended same-MSM basis: vec_G, the first two blinder generators,
    then G_t, G_u (curdleproofs.py:136-138)."""
    return crs.vec_G.cat(crs.vec_H[: N_BLINDERS - 2]).cat(
        PointVec([crs.G_t, crs.G_u])
    )


def _padded_columns(crs: CurdleproofsCrs, T: PointVec, U: PointVec):
    """vec_T / vec_U padded with identity + the commitment blinder H slots
    (curdleproofs.py:139-141)."""
    o = G1.identity()
    return (
        T.cat(PointVec([o, o, crs.H, o])),
        U.cat(PointVec([o, o, o, crs.H])),
    )


@dataclass(frozen=True)
class CurdleProofsProof(WireStruct):
    """The complete shuffle proof (48*(18 + 10*lg n) + 224 bytes)."""

    A: G1
    cm_T: GroupCommitment
    cm_U: GroupCommitment
    R: G1
    S: G1
    same_perm_proof: SamePermutationProof
    same_scalar_proof: SameScalarProof
    same_msm_proof: SameMSMProof

    WIRE: ClassVar = (
        ("A", PT),
        ("cm_T", GroupCommitment),
        ("cm_U", GroupCommitment),
        ("R", PT),
        ("S", PT),
        ("same_perm_proof", SamePermutationProof),
        ("same_scalar_proof", SameScalarProof),
        ("same_msm_proof", SameMSMProof),
    )

    @classmethod
    def new(
        cls,
        crs: CurdleproofsCrs,
        vec_R,
        vec_S,
        vec_T,
        vec_U,
        M: G1,
        permutation: List[int],
        k: Fr,
        vec_m_blinders,
        rng: Optional[ProofRng] = None,
        device: DeviceArg = None,
    ) -> "CurdleProofsProof":
        dev = resolve_device(device)
        rng = rng or default_rng()
        R_col, S_col = as_points(vec_R), as_points(vec_S)
        T_col, U_col = as_points(vec_T), as_points(vec_U)

        transcript = Transcript(_DOMAIN)
        vec_a = _bind_instance(
            transcript, R_col, S_col, T_col, U_col, M, len(R_col)
        )

        # commitment A to the permuted challenge weights
        a_blinders = rng.blinders(N_BLINDERS - 2)
        a_blinders_padded = as_scalars(a_blinders + [Fr(0), Fr(0)])
        a_permuted = vec_a.permuted(permutation)
        A = crs.vec_G.msm(a_permuted, dev) + crs.vec_H.msm(a_blinders_padded, dev)

        same_perm_proof = SamePermutationProof.new(
            crs_G_vec=crs.vec_G,
            crs_H_vec=crs.vec_H,
            crs_U=crs.H,
            A=A,
            M=M,
            vec_a=vec_a,
            permutation=permutation,
            vec_a_blinders=a_blinders_padded,
            vec_m_blinders=vec_m_blinders,
            transcript=transcript,
            rng=rng,
            device=dev,
        )

        r_t, r_u = rng.random_scalar(), rng.random_scalar()
        R = R_col.msm(vec_a, dev)
        S = S_col.msm(vec_a, dev)
        cm_T = GroupCommitment.new(crs.G_t, crs.H, R * k, r_t)
        cm_U = GroupCommitment.new(crs.G_u, crs.H, S * k, r_u)

        same_scalar_proof = SameScalarProof.new(
            crs_G_t=crs.G_t,
            crs_G_u=crs.G_u,
            crs_H=crs.H,
            R=R,
            S=S,
            cm_T=cm_T,
            cm_U=cm_U,
            k=k,
            r_t=r_t,
            r_u=r_u,
            transcript=transcript,
            rng=rng,
        )

        T_ext, U_ext = _padded_columns(crs, T_col, U_col)
        same_msm_proof = SameMSMProof.new(
            crs_G_vec=_msm_bases(crs),
            A=A + cm_T.T_1 + cm_U.T_1,
            Z_t=cm_T.T_2,
            Z_u=cm_U.T_2,
            vec_T=T_ext,
            vec_U=U_ext,
            vec_x=a_permuted.cat(as_scalars(a_blinders)).cat(
                ScalarVec.of([r_t, r_u])
            ),
            transcript=transcript,
            rng=rng,
            device=dev,
        )

        return cls(
            A,
            cm_T,
            cm_U,
            R,
            S,
            same_perm_proof,
            same_scalar_proof,
            same_msm_proof,
        )

    def verify(
        self,
        crs: CurdleproofsCrs,
        vec_R,
        vec_S,
        vec_T,
        vec_U,
        M: G1,
        rng: Optional[ProofRng] = None,
        msm_accumulator: Optional[MSMAccumulator] = None,
        device: DeviceArg = None,
    ) -> None:
        """Raises VerificationError on failure. With an externally supplied
        `msm_accumulator`, the final batched MSM check is DEFERRED to the
        caller (see verify_shuffle_proofs), and runs on its device."""
        dev = resolve_device(device)
        R_col, S_col = as_points(vec_R), as_points(vec_S)
        T_col, U_col = as_points(vec_T), as_points(vec_U)

        if T_col[0].is_identity():
            raise VerificationError("vec_T[0] is the identity point")

        deferred = msm_accumulator is not None
        acc = msm_accumulator if deferred else MSMAccumulator(rng=rng, device=dev)

        transcript = Transcript(_DOMAIN)
        vec_a = _bind_instance(
            transcript, R_col, S_col, T_col, U_col, M, len(R_col)
        )

        self.same_perm_proof.verify(
            crs_G_vec=crs.vec_G,
            crs_H_vec=crs.vec_H,
            crs_U=crs.H,
            crs_G_sum=crs.G_sum,
            crs_H_sum=crs.H_sum,
            A=self.A,
            M=M,
            vec_a=vec_a,
            n_blinders=N_BLINDERS,
            transcript=transcript,
            msm_accumulator=acc,
        )
        self.same_scalar_proof.verify(
            crs_G_t=crs.G_t,
            crs_G_u=crs.G_u,
            crs_H=crs.H,
            R=self.R,
            S=self.S,
            cm_T=self.cm_T,
            cm_U=self.cm_U,
            transcript=transcript,
            msm_accumulator=acc,
        )
        T_ext, U_ext = _padded_columns(crs, T_col, U_col)
        self.same_msm_proof.verify(
            crs_G_vec=_msm_bases(crs),
            A=self.A + self.cm_T.T_1 + self.cm_U.T_1,
            Z_t=self.cm_T.T_2,
            Z_u=self.cm_U.T_2,
            vec_T=T_ext,
            vec_U=U_ext,
            transcript=transcript,
            msm_accumulator=acc,
        )
        acc.accumulate_check(self.R, R_col, vec_a)
        acc.accumulate_check(self.S, S_col, vec_a)
        if not deferred:
            acc.verify()


def verify_shuffle_proofs(
    crs: CurdleproofsCrs,
    instances: List[Tuple[CurdleProofsProof, "VerifierInput"]],
    rng: Optional[ProofRng] = None,
    workers: Optional[int] = None,
    device: DeviceArg = None,
) -> None:
    """Batched verification: N proofs share ONE deferred MSM, and the
    per-proof transcript/accumulation work runs across a thread pool (the
    native backend releases the GIL, so host cores parallelize it).
    Soundness holds via the per-check random linear combination.
    Raises VerificationError if any proof fails (BASELINE config 4). The
    merged MSM runs on `device`."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    # Each worker gets its OWN rng, derived sequentially on this thread:
    # a shared seeded Random consumed under thread interleaving would make
    # "deterministic given seed" a lie (soundness is unaffected either way —
    # any unpredictable-to-the-prover combination scalars work).
    rngs = [rng.spawn() if rng is not None else None for _ in instances]
    dev = resolve_device(device)

    def check_one(pair):
        (proof, vi), local_rng = pair
        local = MSMAccumulator(rng=local_rng)
        proof.verify(
            crs,
            vi.vec_R,
            vi.vec_S,
            vi.vec_T,
            vi.vec_U,
            vi.M,
            msm_accumulator=local,
            device=dev,
        )
        return local

    workers = workers or min(8, os.cpu_count() or 1, max(1, len(instances)))
    jobs = list(zip(instances, rngs))
    if workers > 1 and len(instances) > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            locals_ = list(pool.map(check_one, jobs))
    else:
        locals_ = [check_one(job) for job in jobs]

    acc = MSMAccumulator(rng=rng, device=dev)
    for local in locals_:
        acc.absorb(local)
    acc.verify()


def shuffle_permute_and_commit_input(
    crs: CurdleproofsCrs,
    vec_R,
    vec_S,
    permutation: List[int],
    k: Fr,
    rng: Optional[ProofRng] = None,
    device: DeviceArg = None,
) -> Tuple[List[G1], List[G1], G1, List[Fr]]:
    """Re-randomize both tracker columns by k (two batched point-scale
    dispatches), permute, and commit to the permutation
    (curdleproofs.py:301-321)."""
    dev = resolve_device(device)
    rng = rng or default_rng()

    vec_T = as_points(vec_R).scaled(k, dev).permuted(permutation).tolist()
    vec_U = as_points(vec_S).scaled(k, dev).permuted(permutation).tolist()

    vec_m_blinders = rng.blinders(N_BLINDERS)
    M = crs.vec_G.msm(
        ScalarVec.of(range(crs.ell)).permuted(permutation), dev
    ) + crs.vec_H.msm(as_scalars(vec_m_blinders), dev)
    return vec_T, vec_U, M, vec_m_blinders


class VerifierInput:
    """The public statement a shuffle proof is verified against."""

    __slots__ = ("vec_R", "vec_S", "vec_T", "vec_U", "M")

    def __init__(self, vec_R, vec_S, vec_T, vec_U, M: G1) -> None:
        self.vec_R = list(vec_R)
        self.vec_S = list(vec_S)
        self.vec_T = list(vec_T)
        self.vec_U = list(vec_U)
        self.M = M

    def to_json(self) -> str:
        cols = {
            name: [
                e.hex()
                for e in as_points(getattr(self, name)).compressed()
            ]
            for name in ("vec_R", "vec_S", "vec_T", "vec_U")
        }
        cols["M"] = self.M.to_compressed_bytes().hex()
        return json.dumps(cols)

    @classmethod
    def from_json(cls, json_str: str, device: DeviceArg = None) -> "VerifierInput":
        d = json.loads(json_str)
        cols = [
            decompress_host_batch(bytes.fromhex("".join(d[name])), device=device)
            for name in ("vec_R", "vec_S", "vec_T", "vec_U")
        ]
        M = G1.from_compressed_bytes_unchecked(bytes.fromhex(d["M"]))
        return cls(*cols, M)
