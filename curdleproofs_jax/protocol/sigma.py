"""Sigma-protocols: the same-scalar argument and the tracker opening proof.

Both are constant-size three-move protocols made non-interactive by the
shared Fiat-Shamir oracle. Inside a full shuffle verification the
same-scalar equations feed the deferred-MSM batcher like every other
sub-argument (even O(1) equations cost ~8 eager scalar muls, which
dominated batched verification once the big checks were deferred); the
standalone path and the tracker opening proof check direct point
equalities, as the reference does (same_scalar.py:101-111).

  SameScalar  proves cm_T, cm_U commit to R*k, S*k under one secret k
              (same_scalar.py:14-111; labels sameexp_points /
              same_scalar_alpha)
  TrackerOpening  Chaum-Pedersen dlog-equality for k_G = k*G and
              k_r_G = k*r_G, a 128-byte proof (opening.py:22-76; labels
              tracker_opening_proof / tracker_opening_proof_challenge)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional

from curdleproofs_jax.curve import G1, G1_GENERATOR
from curdleproofs_jax.fields import Fr
from curdleproofs_jax.protocol.primitives import GroupCommitment
from curdleproofs_jax.protocol.wire import FR, PT, WireStruct
from curdleproofs_jax.transcript.oracle import Transcript
from curdleproofs_jax.utils.errors import check
from curdleproofs_jax.utils.rng import ProofRng, default_rng


@dataclass(frozen=True)
class SameScalarProof(WireStruct):
    """Proof that cm_T = Com(R*k) and cm_U = Com(S*k) share the scalar k."""

    cm_A: GroupCommitment
    cm_B: GroupCommitment
    z_k: Fr
    z_t: Fr
    z_u: Fr

    WIRE: ClassVar = (
        ("cm_A", GroupCommitment),
        ("cm_B", GroupCommitment),
        ("z_k", FR),
        ("z_t", FR),
        ("z_u", FR),
    )

    @staticmethod
    def _bind_statement(
        transcript: Transcript,
        R: G1,
        S: G1,
        cm_T: GroupCommitment,
        cm_U: GroupCommitment,
        cm_A: GroupCommitment,
        cm_B: GroupCommitment,
    ) -> Fr:
        transcript.absorb(
            b"sameexp_points",
            R,
            S,
            cm_T.T_1,
            cm_T.T_2,
            cm_U.T_1,
            cm_U.T_2,
            cm_A.T_1,
            cm_A.T_2,
            cm_B.T_1,
            cm_B.T_2,
        )
        return transcript.scalar(b"same_scalar_alpha")

    @classmethod
    def new(
        cls,
        crs_G_t: G1,
        crs_G_u: G1,
        crs_H: G1,
        R: G1,
        S: G1,
        cm_T: GroupCommitment,
        cm_U: GroupCommitment,
        k: Fr,
        r_t: Fr,
        r_u: Fr,
        transcript: Transcript,
        rng: Optional[ProofRng] = None,
    ) -> "SameScalarProof":
        rng = rng or default_rng()
        r_a, r_b, r_k = (rng.random_scalar() for _ in range(3))

        cm_A = GroupCommitment.new(crs_G_t, crs_H, R * r_k, r_a)
        cm_B = GroupCommitment.new(crs_G_u, crs_H, S * r_k, r_b)
        alpha = cls._bind_statement(transcript, R, S, cm_T, cm_U, cm_A, cm_B)

        return cls(
            cm_A, cm_B, r_k + k * alpha, r_a + r_t * alpha, r_b + r_u * alpha
        )

    def verify(
        self,
        crs_G_t: G1,
        crs_G_u: G1,
        crs_H: G1,
        R: G1,
        S: G1,
        cm_T: GroupCommitment,
        cm_U: GroupCommitment,
        transcript: Transcript,
        msm_accumulator=None,
    ) -> None:
        alpha = self._bind_statement(
            transcript, R, S, cm_T, cm_U, self.cm_A, self.cm_B
        )
        if msm_accumulator is not None:
            # deferred form: Com(G, H; T, r) = (G*r, T + H*r), so each
            # commitment equality is two point equations pushed into the
            # batched accumulator with negated challenge weights — zero
            # eager group ops (the direct path below costs ~8 scalar muls,
            # the dominant per-proof term after the L/R deferral)
            from curdleproofs_jax.vectors import as_points, as_scalars

            for (cm, stmt, base, zr, comm) in (
                (self.cm_A, cm_T, R, self.z_t, crs_G_t),
                (self.cm_B, cm_U, S, self.z_u, crs_G_u),
            ):
                msm_accumulator.accumulate_check(
                    cm.T_1,
                    as_points([comm, stmt.T_1]),
                    as_scalars([zr, -alpha]),
                )
                msm_accumulator.accumulate_check(
                    cm.T_2,
                    as_points([base, crs_H, stmt.T_2]),
                    as_scalars([self.z_k, zr, -alpha]),
                )
            return
        ok_t = (
            GroupCommitment.new(crs_G_t, crs_H, R * self.z_k, self.z_t)
            == self.cm_A + cm_T * alpha
        )
        ok_u = (
            GroupCommitment.new(crs_G_u, crs_H, S * self.z_k, self.z_u)
            == self.cm_B + cm_U * alpha
        )
        check(ok_t and ok_u, "same-scalar sigma-protocol check failed")


@dataclass(frozen=True)
class TrackerOpeningProof(WireStruct):
    """Chaum-Pedersen proof of knowledge of k with k_G = k*G, k_r_G = k*r_G."""

    A: G1
    B: G1
    s: Fr

    WIRE: ClassVar = (("A", PT), ("B", PT), ("s", FR))

    @staticmethod
    def _challenge(
        transcript: Transcript, k_G: G1, k_r_G: G1, r_G: G1, A: G1, B: G1
    ) -> Fr:
        transcript.absorb(
            b"tracker_opening_proof", k_G, G1_GENERATOR, k_r_G, r_G, A, B
        )
        return transcript.scalar(b"tracker_opening_proof_challenge")

    @classmethod
    def new(
        cls,
        k_r_G: G1,
        r_G: G1,
        k_G: G1,
        k: Fr,
        transcript: Transcript,
        rng: Optional[ProofRng] = None,
    ) -> "TrackerOpeningProof":
        rng = rng or default_rng()
        nonce = rng.random_scalar()
        A = G1_GENERATOR * nonce
        B = r_G * nonce
        challenge = cls._challenge(transcript, k_G, k_r_G, r_G, A, B)
        return cls(A, B, nonce - challenge * k)

    def verify(
        self, transcript: Transcript, k_r_G: G1, r_G: G1, k_G: G1
    ) -> None:
        challenge = self._challenge(
            transcript, k_G, k_r_G, r_G, self.A, self.B
        )
        ok = (
            G1_GENERATOR * self.s + k_G * challenge == self.A
            and r_G * self.s + k_r_G * challenge == self.B
        )
        check(ok, "tracker opening proof check failed")
