"""Per-argument round-trip + negative tests (reference test strategy §4:
test_ipa/test_gprod/test_same_permutation_proof/test_same_msm/
test_same_scalar_arg/test_group_commit/test_tracker_opening_proof, sized for
CI on the CPU backend)."""
import pytest

from curdleproofs_jax.curve import G1, g1_sum
from curdleproofs_jax.fields import Fr, fr_inner_product
from curdleproofs_jax.models.commitment import GroupCommitment
from curdleproofs_jax.models.crs import CurdleproofsCrs
from curdleproofs_jax.models.grand_product import GrandProductProof
from curdleproofs_jax.models.ipa import IPA, generate_ipa_blinders
from curdleproofs_jax.models.msm_accumulator import MSMAccumulator
from curdleproofs_jax.models.opening import TrackerOpeningProof
from curdleproofs_jax.models.same_msm import SameMSMProof
from curdleproofs_jax.models.same_permutation import (
    SamePermutationProof,
    get_permutation,
)
from curdleproofs_jax.models.same_scalar import SameScalarProof
from curdleproofs_jax.ops.msm import msm as compute_msm
from curdleproofs_jax.transcript.fiat_shamir import CurdleproofsTranscript
from curdleproofs_jax.utils.errors import ProofError
from curdleproofs_jax.utils.rng import ProofRng

N = 64
N_BLINDERS = 4
ELL = N - N_BLINDERS


def make_rng(seed=42):
    return ProofRng(seed)


def random_points(rng, n):
    g = G1()
    return [g * rng.random_scalar() for n_ in range(n)]


def test_ipa_round_trip_and_soundness():
    rng = make_rng(1)
    n = N
    crs_G_vec = random_points(rng, n)
    vec_u = rng.blinders(n)
    crs_G_prime_vec = [g * u for g, u in zip(crs_G_vec, vec_u)]
    crs_H = G1() * rng.random_scalar()

    vec_b = rng.blinders(n)
    vec_c = rng.blinders(n)
    z = fr_inner_product(vec_b, vec_c)

    B = compute_msm(crs_G_vec, vec_b)
    C = compute_msm(crs_G_prime_vec, vec_c)

    prover_transcript = CurdleproofsTranscript(b"ipa")
    proof = IPA.new(
        crs_G_vec=crs_G_vec,
        crs_G_prime_vec=crs_G_prime_vec,
        crs_H=crs_H,
        C=B,
        D=C,
        z=z,
        vec_c=list(vec_b),
        vec_d=list(vec_c),
        transcript=prover_transcript,
        rng=rng,
    )

    verifier_transcript = CurdleproofsTranscript(b"ipa")
    acc = MSMAccumulator(rng=make_rng(9))
    proof.verify(
        crs_G_vec=crs_G_vec,
        crs_H=crs_H,
        C=B,
        D=C,
        inner_prod=z,
        vec_u=list(vec_u),
        transcript=verifier_transcript,
        msm_accumulator=acc,
    )
    acc.verify()

    # soundness: wrong inner product must fail the batched check
    bad_transcript = CurdleproofsTranscript(b"ipa")
    bad_acc = MSMAccumulator(rng=make_rng(10))
    proof.verify(
        crs_G_vec=crs_G_vec,
        crs_H=crs_H,
        C=B,
        D=C,
        inner_prod=z + Fr(1),
        vec_u=list(vec_u),
        transcript=bad_transcript,
        msm_accumulator=bad_acc,
    )
    with pytest.raises(ProofError):
        bad_acc.verify()


def test_ipa_blinders_constraints():
    rng = make_rng(2)
    c = rng.blinders(16)
    d = rng.blinders(16)
    r, z = generate_ipa_blinders(c, d, rng)
    assert fr_inner_product(r, d) + fr_inner_product(z, c) == Fr(0)
    assert fr_inner_product(r, z) == Fr(0)


def test_grand_product_round_trip_and_soundness():
    rng = make_rng(3)
    n_blinders = N_BLINDERS
    ell = ELL
    crs_G_vec = random_points(rng, ell)
    crs_H_vec = random_points(rng, n_blinders)
    crs_U = G1() * rng.random_scalar()
    crs_G_sum = g1_sum(crs_G_vec)
    crs_H_sum = g1_sum(crs_H_vec)

    vec_b = rng.blinders(ell)
    vec_b_blinders = rng.blinders(n_blinders)
    gprod_result = Fr(1)
    for b in vec_b:
        gprod_result = gprod_result * b

    B = compute_msm(crs_G_vec, vec_b) + compute_msm(crs_H_vec, vec_b_blinders)

    prover_transcript = CurdleproofsTranscript(b"gprod")
    proof = GrandProductProof.new(
        crs_G_vec=crs_G_vec,
        crs_H_vec=crs_H_vec,
        crs_U=crs_U,
        B=B,
        gprod_result=gprod_result,
        vec_b=vec_b,
        vec_b_blinders=vec_b_blinders,
        transcript=prover_transcript,
        rng=rng,
    )

    verifier_transcript = CurdleproofsTranscript(b"gprod")
    acc = MSMAccumulator(rng=make_rng(11))
    proof.verify(
        crs_G_vec=crs_G_vec,
        crs_H_vec=crs_H_vec,
        crs_U=crs_U,
        crs_G_sum=crs_G_sum,
        crs_H_sum=crs_H_sum,
        B=B,
        gprod_result=gprod_result,
        n_blinders=n_blinders,
        transcript=verifier_transcript,
        msm_accumulator=acc,
    )
    acc.verify()

    # soundness: wrong product result
    bad_transcript = CurdleproofsTranscript(b"gprod")
    bad_acc = MSMAccumulator(rng=make_rng(12))
    proof.verify(
        crs_G_vec=crs_G_vec,
        crs_H_vec=crs_H_vec,
        crs_U=crs_U,
        crs_G_sum=crs_G_sum,
        crs_H_sum=crs_H_sum,
        B=B,
        gprod_result=gprod_result * Fr(2),
        n_blinders=n_blinders,
        transcript=bad_transcript,
        msm_accumulator=bad_acc,
    )
    with pytest.raises(ProofError):
        bad_acc.verify()


def test_same_permutation_round_trip():
    rng = make_rng(4)
    n_blinders = N_BLINDERS
    ell = ELL
    crs_G_vec = random_points(rng, ell)
    crs_H_vec = random_points(rng, n_blinders)
    crs_U = G1() * rng.random_scalar()
    crs_G_sum = g1_sum(crs_G_vec)
    crs_H_sum = g1_sum(crs_H_vec)

    permutation = rng.permutation(ell)
    vec_a = rng.blinders(ell)
    vec_a_blinders = rng.blinders(n_blinders)
    vec_m_blinders = rng.blinders(n_blinders)

    vec_a_permuted = get_permutation(vec_a, permutation)
    A = compute_msm(crs_G_vec, vec_a_permuted) + compute_msm(
        crs_H_vec, vec_a_blinders
    )
    M = compute_msm(crs_G_vec, [Fr(i) for i in permutation]) + compute_msm(
        crs_H_vec, vec_m_blinders
    )

    prover_transcript = CurdleproofsTranscript(b"same_perm")
    proof = SamePermutationProof.new(
        crs_G_vec=crs_G_vec,
        crs_H_vec=crs_H_vec,
        crs_U=crs_U,
        A=A,
        M=M,
        vec_a=vec_a,
        permutation=permutation,
        vec_a_blinders=vec_a_blinders,
        vec_m_blinders=vec_m_blinders,
        transcript=prover_transcript,
        rng=rng,
    )

    verifier_transcript = CurdleproofsTranscript(b"same_perm")
    acc = MSMAccumulator(rng=make_rng(13))
    proof.verify(
        crs_G_vec=crs_G_vec,
        crs_H_vec=crs_H_vec,
        crs_U=crs_U,
        crs_G_sum=crs_G_sum,
        crs_H_sum=crs_H_sum,
        A=A,
        M=M,
        vec_a=vec_a,
        n_blinders=n_blinders,
        transcript=verifier_transcript,
        msm_accumulator=acc,
    )
    acc.verify()


def test_same_msm_round_trip():
    rng = make_rng(5)
    n = 32
    crs_G_vec = random_points(rng, n)
    vec_T = random_points(rng, n)
    vec_U = random_points(rng, n)
    vec_x = rng.blinders(n)

    A = compute_msm(crs_G_vec, vec_x)
    Z_t = compute_msm(vec_T, vec_x)
    Z_u = compute_msm(vec_U, vec_x)

    prover_transcript = CurdleproofsTranscript(b"same_msm")
    proof = SameMSMProof.new(
        crs_G_vec=crs_G_vec,
        A=A,
        Z_t=Z_t,
        Z_u=Z_u,
        vec_T=vec_T,
        vec_U=vec_U,
        vec_x=list(vec_x),
        transcript=prover_transcript,
        rng=rng,
    )

    verifier_transcript = CurdleproofsTranscript(b"same_msm")
    acc = MSMAccumulator(rng=make_rng(14))
    proof.verify(
        crs_G_vec=crs_G_vec,
        A=A,
        Z_t=Z_t,
        Z_u=Z_u,
        vec_T=vec_T,
        vec_U=vec_U,
        transcript=verifier_transcript,
        msm_accumulator=acc,
    )
    acc.verify()


def test_same_scalar_round_trip():
    rng = make_rng(6)
    crs_G_t = G1() * rng.random_scalar()
    crs_G_u = G1() * rng.random_scalar()
    crs_H = G1() * rng.random_scalar()
    R = G1() * rng.random_scalar()
    S = G1() * rng.random_scalar()
    k, r_t, r_u = rng.random_scalar(), rng.random_scalar(), rng.random_scalar()

    cm_T = GroupCommitment.new(crs_G_t, crs_H, R * k, r_t)
    cm_U = GroupCommitment.new(crs_G_u, crs_H, S * k, r_u)

    prover_transcript = CurdleproofsTranscript(b"same_scalar")
    proof = SameScalarProof.new(
        crs_G_t=crs_G_t,
        crs_G_u=crs_G_u,
        crs_H=crs_H,
        R=R,
        S=S,
        cm_T=cm_T,
        cm_U=cm_U,
        k=k,
        r_t=r_t,
        r_u=r_u,
        transcript=prover_transcript,
        rng=rng,
    )

    verifier_transcript = CurdleproofsTranscript(b"same_scalar")
    proof.verify(
        crs_G_t=crs_G_t,
        crs_G_u=crs_G_u,
        crs_H=crs_H,
        R=R,
        S=S,
        cm_T=cm_T,
        cm_U=cm_U,
        transcript=verifier_transcript,
    )

    # tampered statement must fail
    bad_transcript = CurdleproofsTranscript(b"same_scalar")
    with pytest.raises(ProofError):
        proof.verify(
            crs_G_t=crs_G_t,
            crs_G_u=crs_G_u,
            crs_H=crs_H,
            R=S,
            S=R,
            cm_T=cm_T,
            cm_U=cm_U,
            transcript=bad_transcript,
        )


def test_group_commitment_homomorphism():
    rng = make_rng(7)
    G = G1() * rng.random_scalar()
    H = G1() * rng.random_scalar()
    A = G1() * rng.random_scalar()
    B = G1() * rng.random_scalar()
    r_a, r_b = rng.random_scalar(), rng.random_scalar()

    com_a = GroupCommitment.new(G, H, A, r_a)
    com_b = GroupCommitment.new(G, H, B, r_b)
    assert com_a + com_b == GroupCommitment.new(G, H, A + B, r_a + r_b)
    assert com_a * Fr(3) == GroupCommitment.new(G, H, A * Fr(3), r_a * Fr(3))
    assert com_a != com_b


def test_tracker_opening_proof():
    rng = make_rng(8)
    k = rng.random_scalar()
    r = rng.random_scalar()
    k_G = G1() * k
    r_G = G1() * r
    k_r_G = r_G * k

    proof = TrackerOpeningProof.new(
        k_r_G=k_r_G,
        r_G=r_G,
        k_G=k_G,
        k=k,
        transcript=CurdleproofsTranscript(b"whisk_opening_proof"),
        rng=rng,
    )
    proof.verify(CurdleproofsTranscript(b"whisk_opening_proof"), k_r_G, r_G, k_G)

    # wrong statement fails
    with pytest.raises(ProofError):
        proof.verify(
            CurdleproofsTranscript(b"whisk_opening_proof"), k_G, r_G, k_r_G
        )


def test_crs_validation():
    with pytest.raises(ProofError):
        CurdleproofsCrs.new(ell=13, n_blinders=4, rng=make_rng(15))  # 17 not pow2
    crs = CurdleproofsCrs.new(ell=4, n_blinders=4, rng=make_rng(16))
    assert crs.ell == 4 and crs.n_blinders == 4
    assert crs.G_sum == g1_sum(crs.vec_G)
    assert crs.H_sum == g1_sum(crs.vec_H)
    # serde round-trips
    assert CurdleproofsCrs.from_json(crs.to_json()).to_json() == crs.to_json()
    from curdleproofs_jax.utils.serde import BufReader

    rt = CurdleproofsCrs.from_bytes(BufReader(crs.to_bytes()), 4, 4)
    assert rt.to_bytes() == crs.to_bytes()
