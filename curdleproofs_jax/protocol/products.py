"""Product arguments: grand-product and the Neff same-permutation reduction.

GrandProduct reduces  prod_i b_i = P  to one inner-product argument over a
beta-rescaled basis (grand_prod.py:23-177 semantics; labels gprod_step1 /
gprod_alpha / gprod_step2 / gprod_beta). SamePermutation reduces "A and M
commit to the same permutation" to a grand product of the factors
a_sigma(i) + sigma(i)*alpha + beta (same_perm.py:21-120; labels
same_perm_step1 / same_perm_alpha / same_perm_beta).

All O(n) work — beta-power ladders, basis rescaling, partial products,
factor assembly — is one ScalarVec/PointVec call each; the verifier needs
no rescaled bases at all thanks to the vec_u + G_sum/H_sum substitution
(grand_prod.py:148-158).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, List, Optional

from curdleproofs_jax.curve import G1
from curdleproofs_jax.fields import Fr
from curdleproofs_jax.protocol.folding import IPA
from curdleproofs_jax.protocol.primitives import MSMAccumulator
from curdleproofs_jax.protocol.wire import FR, PT, WireStruct
from curdleproofs_jax.transcript.oracle import Transcript
from curdleproofs_jax.utils.rng import ProofRng, default_rng
from curdleproofs_jax.vectors import PointVec, ScalarVec, as_points, as_scalars


def get_permutation(vec, permutation: List[int]):
    """[vec[sigma[i]]] (reference util.py:93-96)."""
    return [vec[int(i)] for i in permutation]


@dataclass(frozen=True)
class GrandProductProof(WireStruct):
    """Proof that the committed vector b satisfies prod_i b_i = P."""

    C: G1
    r_p: Fr
    ipa_proof: IPA

    WIRE: ClassVar = (("C", PT), ("r_p", FR), ("ipa_proof", IPA))

    @classmethod
    def new(
        cls,
        crs_G_vec,
        crs_H_vec,
        crs_U: G1,
        B: G1,
        gprod_result: Fr,
        vec_b,
        vec_b_blinders,
        transcript: Transcript,
        rng: Optional[ProofRng] = None,
    ) -> "GrandProductProof":
        rng = rng or default_rng()
        G, Hv = as_points(crs_G_vec), as_points(crs_H_vec)
        b = as_scalars(vec_b)
        b_blinders = as_scalars(vec_b_blinders)
        ell, nb = len(G), len(Hv)

        transcript.absorb(b"gprod_step1", B)
        transcript.absorb(b"gprod_step1", gprod_result)
        alpha = transcript.scalar(b"gprod_alpha")

        # running partial products c = [1, b0, b0*b1, ...] and commitment
        c = ScalarVec.of([1]).cat(b[: ell - 1].prefix_products())
        c_blinders = as_scalars(rng.blinders(nb))
        C = G.msm(c) + Hv.msm(c_blinders)

        shifted_blinders = b_blinders + alpha
        r_p = shifted_blinders.dot(c_blinders)

        transcript.absorb(b"gprod_step2", C)
        transcript.absorb(b"gprod_step2", r_p)
        beta = transcript.scalar(b"gprod_beta")
        beta_inv = beta.inverse()

        # power ladders, one vector op each
        beta_pows = ScalarVec.powers(beta, ell + 2)  # beta^0 .. beta^{ell+1}
        inv_pows = ScalarVec.powers(beta_inv, ell + 2)
        beta_ell, beta_next = beta_pows[ell], beta_pows[ell + 1]
        inv_next = inv_pows[ell + 1]

        # rescaled prover basis (verifier reconstructs it implicitly)
        G_scaled = G.scaled(inv_pows[1 : ell + 1])
        H_scaled = Hv.scaled(inv_next)

        # d_i = b_i * beta^{i+1} - beta^i
        d = b * beta_pows[1 : ell + 1] - beta_pows[:ell]
        d_blinders = shifted_blinders * beta_next

        D = (
            B
            - G_scaled.msm(beta_pows[:ell])
            + H_scaled.msm(ScalarVec.fill(alpha * beta_next, nb))
        )

        z = r_p * beta_next + gprod_result * beta_ell - Fr(1)
        full_c = c.cat(c_blinders)
        full_d = d.cat(d_blinders)
        if full_c.dot(full_d) != z:
            raise ArithmeticError("grand-product IPA statement inconsistent")

        ipa_proof = IPA.new(
            crs_G_vec=G.cat(Hv),
            crs_G_prime_vec=G_scaled.cat(H_scaled),
            crs_H=crs_U,
            C=C,
            D=D,
            z=z,
            vec_c=full_c,
            vec_d=full_d,
            transcript=transcript,
            rng=rng,
        )
        return cls(C, r_p, ipa_proof)

    def verify(
        self,
        crs_G_vec,
        crs_H_vec,
        crs_U: G1,
        crs_G_sum: G1,
        crs_H_sum: G1,
        B: G1,
        gprod_result: Fr,
        n_blinders: int,
        transcript: Transcript,
        msm_accumulator: MSMAccumulator,
    ) -> None:
        G, Hv = as_points(crs_G_vec), as_points(crs_H_vec)
        ell = len(G)

        transcript.absorb(b"gprod_step1", B)
        transcript.absorb(b"gprod_step1", gprod_result)
        alpha = transcript.scalar(b"gprod_alpha")

        transcript.absorb(b"gprod_step2", self.C)
        transcript.absorb(b"gprod_step2", self.r_p)
        beta = transcript.scalar(b"gprod_beta")
        beta_inv = beta.inverse()

        # u_i = beta^-(i+1) for the G block, beta^-(ell+1) for the H block
        inv_pows = ScalarVec.powers(beta_inv, ell + 2)
        vec_u = inv_pows[1 : ell + 1].cat(
            ScalarVec.fill(inv_pows[ell + 1], n_blinders)
        )

        # D reconstructed from CRS sums only (grand_prod.py:148-158)
        D = B - crs_G_sum * beta_inv + crs_H_sum * alpha
        z = self.r_p * beta ** (ell + 1) + gprod_result * beta ** ell - Fr(1)

        self.ipa_proof.verify(
            crs_G_vec=G.cat(Hv),
            crs_H=crs_U,
            C=self.C,
            D=D,
            inner_prod=z,
            vec_u=vec_u,
            transcript=transcript,
            msm_accumulator=msm_accumulator,
        )


@dataclass(frozen=True)
class SamePermutationProof(WireStruct):
    """Proof that commitments A and M open to the same permutation."""

    B: G1
    grand_prod_proof: GrandProductProof

    WIRE: ClassVar = (("B", PT), ("grand_prod_proof", GrandProductProof))

    @classmethod
    def new(
        cls,
        crs_G_vec,
        crs_H_vec,
        crs_U: G1,
        A: G1,
        M: G1,
        vec_a,
        permutation: List[int],
        vec_a_blinders,
        vec_m_blinders,
        transcript: Transcript,
        rng: Optional[ProofRng] = None,
    ) -> "SamePermutationProof":
        rng = rng or default_rng()
        G = as_points(crs_G_vec)
        a = as_scalars(vec_a)
        ell = len(G)

        transcript.absorb(b"same_perm_step1", A, M)
        transcript.absorb(b"same_perm_step1", a)
        alpha = transcript.scalar(b"same_perm_alpha")
        beta = transcript.scalar(b"same_perm_beta")

        # grand product over a_sigma(i) + sigma(i)*alpha + beta
        sigma = ScalarVec.of(permutation)
        factors = a.permuted(permutation) + sigma * alpha + beta
        B = A + M * alpha + G.msm(ScalarVec.fill(beta, ell))

        grand_prod_proof = GrandProductProof.new(
            crs_G_vec=G,
            crs_H_vec=crs_H_vec,
            crs_U=crs_U,
            B=B,
            gprod_result=factors.product(),
            vec_b=factors,
            vec_b_blinders=as_scalars(vec_a_blinders)
            + as_scalars(vec_m_blinders) * alpha,
            transcript=transcript,
            rng=rng,
        )
        return cls(B, grand_prod_proof)

    def verify(
        self,
        crs_G_vec,
        crs_H_vec,
        crs_U: G1,
        crs_G_sum: G1,
        crs_H_sum: G1,
        A: G1,
        M: G1,
        vec_a,
        n_blinders: int,
        transcript: Transcript,
        msm_accumulator: MSMAccumulator,
    ) -> None:
        G = as_points(crs_G_vec)
        a = as_scalars(vec_a)
        ell = len(G)

        transcript.absorb(b"same_perm_step1", A, M)
        transcript.absorb(b"same_perm_step1", a)
        alpha = transcript.scalar(b"same_perm_alpha")
        beta = transcript.scalar(b"same_perm_beta")

        # the identity permutation's factor product (verifier side)
        factors = a + ScalarVec.of(range(ell)) * alpha + beta

        msm_accumulator.accumulate_check(
            self.B - A - M * alpha, G, ScalarVec.fill(beta, ell)
        )
        self.grand_prod_proof.verify(
            crs_G_vec=G,
            crs_H_vec=crs_H_vec,
            crs_U=crs_U,
            crs_G_sum=crs_G_sum,
            crs_H_sum=crs_H_sum,
            B=self.B,
            gprod_result=factors.product(),
            n_blinders=n_blinders,
            transcript=transcript,
            msm_accumulator=msm_accumulator,
        )
