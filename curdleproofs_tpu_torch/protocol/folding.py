"""Bulletproofs-style folding arguments: the inner-product argument (IPA)
and the three-way same-MSM argument.

Both share the same skeleton: split every vector in half, commit to the
cross terms (L/R points), draw a challenge gamma, and fold lo + gamma * hi
— lg2(n) rounds. Here each fold is ONE batched call on ScalarVec/PointVec
(device kernel or native host batch by size) instead of the reference's
per-element Python loops (ipa.py:142-151, same_msm.py:122-131), and the
verifier's O(n) challenge-product vector is built by iterated doubling with
a single batched inversion.

Transcript schedules are bit-exact with the reference:
  IPA      ipa.py:97-139   (ipa_step1 / ipa_alpha / ipa_beta / ipa_loop / ipa_gamma)
  SameMSM  same_msm.py:79-119 (same_msm_step1 / same_msm_alpha / same_msm_loop /
                               same_msm_gamma)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, List, Optional, Tuple

from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import FR_MOD, Fr
from curdleproofs_tpu_torch.protocol.primitives import MSMAccumulator
from curdleproofs_tpu_torch.protocol.wire import FR, PT, ROUNDS, WireStruct
from curdleproofs_tpu_torch.transcript.oracle import Transcript
from curdleproofs_tpu_torch.utils.device import DeviceArg
from curdleproofs_tpu_torch.utils.errors import InvalidInputError
from curdleproofs_tpu_torch.utils.rng import ProofRng, default_rng
from curdleproofs_tpu_torch.vectors import PointVec, ScalarVec, as_points, as_scalars

MAX_ROUNDS = 31  # proofs beyond 2^31 elements are malformed by construction


def _require_pow2(n: int, what: str) -> None:
    if n <= 0 or n & (n - 1):
        raise InvalidInputError(f"{what} size must be a power of two, got {n}")


def fold_exponents(gammas: List[Fr], n: int) -> ScalarVec:
    """The verifier's challenge-product vector vec_s, vectorized.

    s[i] = prod of gammas[j] over the set bits j of i (big-endian over
    lg2(n) bits) — the quantity the reference assembles per-element from
    bitstrings (ipa.py:164-184, util.py:71-78). Built here by doubling:
    processing challenges last-round-first appends (block * gamma) to the
    block, reaching length n in lg2(n) vector steps.
    """
    vals = [1]
    for g in reversed([g.v for g in gammas]):
        vals += [v * g % FR_MOD for v in vals]
    if len(vals) != n:
        raise InvalidInputError("challenge count does not match vector size")
    return ScalarVec.of(vals)


def get_verification_scalars_bitstring(n: int, lg_n: int) -> List[List[int]]:
    """Set-bit positions of each i in lg_n-wide big-endian form (kept as a
    reference oracle for fold_exponents; util.py:71-78 behaviour)."""
    return [
        [j for j in range(lg_n) if (i >> (lg_n - 1 - j)) & 1] for i in range(n)
    ]


def _round_challenges(
    transcript: Transcript,
    loop_label: bytes,
    gamma_label: bytes,
    round_points: List[PointVec],
    rounds: int,
) -> Tuple[ScalarVec, ScalarVec]:
    """Re-derive per-round gammas by replaying the L/R points into the
    transcript; returns (gammas, gammas^-1) with one batched inversion."""
    gammas: List[Fr] = []
    for i in range(rounds):
        transcript.absorb(loop_label, [pv[i] for pv in round_points])
        gammas.append(transcript.scalar(gamma_label))
    gv = ScalarVec.of(gammas)
    return gv, gv.inverted()


def generate_ipa_blinders(c, d, rng: Optional[ProofRng] = None):
    """Blinders (r, z) satisfying <r,d> + <z,c> = 0 and <r,z> = 0: sample
    all but the last two z freely, then solve the two linear constraints
    (construction of ipa.py:27-48). Returns Fr lists."""
    rng = rng or default_rng()
    cs, ds = as_scalars(c), as_scalars(d)
    n = len(cs)
    r = as_scalars(rng.blinders(n))
    z_head = as_scalars(rng.blinders(n - 2))

    omega = r.dot(ds) + z_head.dot(cs[: n - 2])
    delta = r[: n - 2].dot(z_head)

    c_pen_inv = cs[n - 2].inverse()
    z_last = (r[n - 2] * c_pen_inv * omega - delta) * (
        r[n - 1] - r[n - 2] * c_pen_inv * cs[n - 1]
    ).inverse()
    z_pen = -c_pen_inv * (z_last * cs[n - 1] + omega)
    z = z_head.cat(ScalarVec.of([z_pen, z_last]))

    if r.dot(ds) + z.dot(cs) != Fr(0) or r.dot(z) != Fr(0):
        raise ArithmeticError("IPA blinder constraints unsatisfied")
    return r.tolist(), z.tolist()


@dataclass(frozen=True)
class IPA(WireStruct):
    """Proof that z = <c, d> under C = <c, G>, D = <d, G'>."""

    B_c: G1
    B_d: G1
    vec_L_C: PointVec
    vec_R_C: PointVec
    vec_L_D: PointVec
    vec_R_D: PointVec
    c_final: Fr
    d_final: Fr

    WIRE: ClassVar = (
        ("B_c", PT),
        ("B_d", PT),
        ("vec_L_C", ROUNDS),
        ("vec_R_C", ROUNDS),
        ("vec_L_D", ROUNDS),
        ("vec_R_D", ROUNDS),
        ("c_final", FR),
        ("d_final", FR),
    )

    @classmethod
    def new(
        cls,
        crs_G_vec,
        crs_G_prime_vec,
        crs_H: G1,
        C: G1,
        D: G1,
        z: Fr,
        vec_c,
        vec_d,
        transcript: Transcript,
        rng: Optional[ProofRng] = None,
        device: DeviceArg = None,
    ) -> "IPA":
        rng = rng or default_rng()
        cs, ds = as_scalars(vec_c), as_scalars(vec_d)
        G, Gp = as_points(crs_G_vec), as_points(crs_G_prime_vec)
        n = len(cs)
        _require_pow2(n, "IPA")
        if len(ds) != n:
            raise InvalidInputError("len(vec_c) != len(vec_d)")

        r, zb = generate_ipa_blinders(cs, ds, rng)
        r, zb = ScalarVec.of(r), ScalarVec.of(zb)
        B_c, B_d = G.msm(r, device), Gp.msm(zb, device)

        transcript.absorb(b"ipa_step1", C, D)
        transcript.absorb(b"ipa_step1", z)
        transcript.absorb(b"ipa_step1", B_c, B_d)
        alpha = transcript.scalar(b"ipa_alpha")
        beta = transcript.scalar(b"ipa_beta")

        cs = r + cs * alpha
        ds = zb + ds * alpha
        H = crs_H * beta

        L_C: List[G1] = []
        R_C: List[G1] = []
        L_D: List[G1] = []
        R_D: List[G1] = []
        while len(cs) > 1:
            c_lo, c_hi = cs.split()
            d_lo, d_hi = ds.split()
            G_lo, G_hi = G.split()
            Gp_lo, Gp_hi = Gp.split()

            lc = G_hi.msm(c_lo, device) + H * c_lo.dot(d_hi)
            ld = Gp_lo.msm(d_hi, device)
            rc = G_lo.msm(c_hi, device) + H * c_hi.dot(d_lo)
            rd = Gp_hi.msm(d_lo, device)
            L_C.append(lc)
            L_D.append(ld)
            R_C.append(rc)
            R_D.append(rd)

            transcript.absorb(b"ipa_loop", lc, ld, rc, rd)
            gamma = transcript.scalar(b"ipa_gamma")
            gamma_inv = gamma.inverse()

            cs = c_lo + c_hi * gamma_inv
            ds = d_lo + d_hi * gamma
            G = G.folded(gamma, device)
            Gp = Gp.folded(gamma_inv, device)

        return cls(
            B_c,
            B_d,
            PointVec(L_C),
            PointVec(R_C),
            PointVec(L_D),
            PointVec(R_D),
            cs[0],
            ds[0],
        )

    def verification_scalars(
        self, n: int, transcript: Transcript
    ) -> Tuple[ScalarVec, ScalarVec, ScalarVec, ScalarVec]:
        rounds = len(self.vec_L_C)
        if rounds > MAX_ROUNDS:
            raise InvalidInputError("proof too large")
        if n != (1 << rounds):
            raise InvalidInputError("fold-round count does not match n")
        gammas, gammas_inv = _round_challenges(
            transcript,
            b"ipa_loop",
            b"ipa_gamma",
            [self.vec_L_C, self.vec_L_D, self.vec_R_C, self.vec_R_D],
            rounds,
        )
        s = fold_exponents(gammas.tolist(), n)
        return gammas, gammas_inv, s, s.inverted()

    def verify(
        self,
        crs_G_vec,
        crs_H: G1,
        C: G1,
        D: G1,
        inner_prod: Fr,
        vec_u,
        transcript: Transcript,
        msm_accumulator: MSMAccumulator,
    ) -> None:
        G = as_points(crs_G_vec)
        n = len(G)

        transcript.absorb(b"ipa_step1", C, D)
        transcript.absorb(b"ipa_step1", inner_prod)
        transcript.absorb(b"ipa_step1", self.B_c, self.B_d)
        alpha = transcript.scalar(b"ipa_alpha")
        beta = transcript.scalar(b"ipa_beta")

        gammas, gammas_inv, s, s_inv = self.verification_scalars(n, transcript)

        # check 1:  <gamma, L_C> + (B_c + alpha*C + alpha^2*z*beta*H)
        #           + <gamma^-1, R_C>  =?  <c_final*s, G> + c_final*d_final*beta*H
        # FULLY deferred: every non-proof point (C, crs_H, the L/R vector)
        # moves to the base side with negated weights, so the verifier does
        # ZERO eager group work here — the whole equation rides the one
        # batched MSM. (An eager 2*log(n)-point host MSM per check used to
        # dominate batched verification's per-proof wall.)
        lr_weights = gammas.cat(gammas_inv)
        neg_lr = -lr_weights
        lrc = self.vec_L_C.cat(self.vec_R_C)
        msm_accumulator.accumulate_check(
            self.B_c,
            G.append(crs_H).append(C).cat(lrc),
            (s * self.c_final)
            .cat(
                ScalarVec.of(
                    [
                        (self.c_final * self.d_final - alpha * alpha * inner_prod)
                        * beta,
                        -alpha,
                    ]
                )
            )
            .cat(neg_lr),
        )

        # check 2: the D-side, expressed over G via vec_u so the rescaled
        # basis G' never materializes (grand_prod.py:148-155 trick)
        lrd = self.vec_L_D.cat(self.vec_R_D)
        msm_accumulator.accumulate_check(
            self.B_d,
            G.append(D).cat(lrd),
            (s_inv * as_scalars(vec_u) * self.d_final)
            .cat(ScalarVec.of([-alpha]))
            .cat(neg_lr),
        )


@dataclass(frozen=True)
class SameMSMProof(WireStruct):
    """Proof that A = <x, G>, Z_t = <x, T>, Z_u = <x, U> share one x."""

    B_a: G1
    B_t: G1
    B_u: G1
    vec_L_A: PointVec
    vec_L_T: PointVec
    vec_L_U: PointVec
    vec_R_A: PointVec
    vec_R_T: PointVec
    vec_R_U: PointVec
    x_final: Fr

    WIRE: ClassVar = (
        ("B_a", PT),
        ("B_t", PT),
        ("B_u", PT),
        ("vec_L_A", ROUNDS),
        ("vec_L_T", ROUNDS),
        ("vec_L_U", ROUNDS),
        ("vec_R_A", ROUNDS),
        ("vec_R_T", ROUNDS),
        ("vec_R_U", ROUNDS),
        ("x_final", FR),
    )

    @classmethod
    def new(
        cls,
        crs_G_vec,
        A: G1,
        Z_t: G1,
        Z_u: G1,
        vec_T,
        vec_U,
        vec_x,
        transcript: Transcript,
        rng: Optional[ProofRng] = None,
        device: DeviceArg = None,
    ) -> "SameMSMProof":
        rng = rng or default_rng()
        G = as_points(crs_G_vec)
        T, U = as_points(vec_T), as_points(vec_U)
        x = as_scalars(vec_x)
        _require_pow2(len(x), "same-MSM")

        r = as_scalars(rng.blinders(len(x)))
        B_a, B_t, B_u = G.msm(r, device), T.msm(r, device), U.msm(r, device)

        transcript.absorb(b"same_msm_step1", A, Z_t, Z_u)
        transcript.absorb(b"same_msm_step1", T, U)
        transcript.absorb(b"same_msm_step1", B_a, B_t, B_u)
        alpha = transcript.scalar(b"same_msm_alpha")

        x = r + x * alpha

        rounds: List[List[G1]] = [[], [], [], [], [], []]  # LA LT LU RA RT RU
        while len(x) > 1:
            x_lo, x_hi = x.split()
            G_lo, G_hi = G.split()
            T_lo, T_hi = T.split()
            U_lo, U_hi = U.split()

            emitted = (
                G_hi.msm(x_lo, device),
                T_hi.msm(x_lo, device),
                U_hi.msm(x_lo, device),
                G_lo.msm(x_hi, device),
                T_lo.msm(x_hi, device),
                U_lo.msm(x_hi, device),
            )
            for bucket, pt in zip(rounds, emitted):
                bucket.append(pt)

            transcript.absorb(b"same_msm_loop", emitted)
            gamma = transcript.scalar(b"same_msm_gamma")

            x = x_lo + x_hi * gamma.inverse()
            G = G.folded(gamma, device)
            T = T.folded(gamma, device)
            U = U.folded(gamma, device)

        return cls(B_a, B_t, B_u, *map(PointVec, rounds), x[0])

    def verify(
        self,
        crs_G_vec,
        A: G1,
        Z_t: G1,
        Z_u: G1,
        vec_T,
        vec_U,
        transcript: Transcript,
        msm_accumulator: MSMAccumulator,
    ) -> None:
        G = as_points(crs_G_vec)
        T, U = as_points(vec_T), as_points(vec_U)
        n = len(T)
        rounds = len(self.vec_L_A)
        if rounds > MAX_ROUNDS:
            raise InvalidInputError("proof too large")
        if n != (1 << rounds):
            raise InvalidInputError("fold-round count does not match n")

        transcript.absorb(b"same_msm_step1", A, Z_t, Z_u)
        transcript.absorb(b"same_msm_step1", T, U)
        transcript.absorb(b"same_msm_step1", self.B_a, self.B_t, self.B_u)
        alpha = transcript.scalar(b"same_msm_alpha")

        gammas, gammas_inv = _round_challenges(
            transcript,
            b"same_msm_loop",
            b"same_msm_gamma",
            [
                self.vec_L_A,
                self.vec_L_T,
                self.vec_L_U,
                self.vec_R_A,
                self.vec_R_T,
                self.vec_R_U,
            ],
            rounds,
        )
        weights = fold_exponents(gammas.tolist(), n) * self.x_final
        # fully deferred (see IPA.verify): statement point and L/R vectors
        # join the base side with negated weights — no eager group ops
        neg_lr = -(gammas.cat(gammas_inv))
        for L, R, B_x, X, basis in (
            (self.vec_L_A, self.vec_R_A, self.B_a, A, G),
            (self.vec_L_T, self.vec_R_T, self.B_t, Z_t, T),
            (self.vec_L_U, self.vec_R_U, self.B_u, Z_u, U),
        ):
            msm_accumulator.accumulate_check(
                B_x,
                basis.append(X).cat(L.cat(R)),
                weights.cat(ScalarVec.of([-alpha])).cat(neg_lr),
            )
