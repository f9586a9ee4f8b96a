"""End-to-end shuffle argument, serde round-trips, negative tests and the
Whisk byte-level API (reference test_curdleproofs.py:576-798 equivalents)."""
import pytest

from curdleproofs_jax.curve import G1
from curdleproofs_jax.fields import Fr
from curdleproofs_jax.models.crs import CurdleproofsCrs
from curdleproofs_jax.models.shuffle import (
    N_BLINDERS,
    CurdleProofsProof,
    VerifierInput,
    shuffle_permute_and_commit_input,
)
from curdleproofs_jax.models.whisk import (
    BLSPubkey,
    GenerateWhiskShuffleProof,
    GenerateWhiskTrackerProof,
    IsValidWhiskOpeningProof,
    IsValidWhiskShuffleProof,
    WhiskTracker,
)
from curdleproofs_jax.utils.errors import ProofError
from curdleproofs_jax.utils.rng import ProofRng
from curdleproofs_jax.utils.serde import BufReader

N = 64
ELL = N - N_BLINDERS


def build_shuffle(seed=21):
    rng = ProofRng(seed)
    crs = CurdleproofsCrs.new(ELL, N_BLINDERS, rng)
    permutation = rng.permutation(ELL)
    k = rng.random_scalar()
    gen = G1()
    vec_R = [gen * rng.random_scalar() for _ in range(ELL)]
    vec_S = [gen * rng.random_scalar() for _ in range(ELL)]
    vec_T, vec_U, M, vec_m_blinders = shuffle_permute_and_commit_input(
        crs, vec_R, vec_S, permutation, k, rng
    )
    proof = CurdleProofsProof.new(
        crs=crs,
        vec_R=vec_R,
        vec_S=vec_S,
        vec_T=vec_T,
        vec_U=vec_U,
        M=M,
        permutation=permutation,
        k=k,
        vec_m_blinders=vec_m_blinders,
        rng=rng,
    )
    return crs, vec_R, vec_S, vec_T, vec_U, M, proof


@pytest.fixture(scope="module")
def shuffle_instance():
    return build_shuffle()


def test_shuffle_argument_verifies(shuffle_instance):
    crs, vec_R, vec_S, vec_T, vec_U, M, proof = shuffle_instance
    proof.verify(crs, vec_R, vec_S, vec_T, vec_U, M)


def test_shuffle_permute_semantics(shuffle_instance):
    # vec_T/vec_U really are k-scaled permutations of vec_R/vec_S
    rng = ProofRng(99)
    crs = CurdleproofsCrs.new(4, 4, rng)
    vec_R = [G1() * rng.random_scalar() for _ in range(4)]
    vec_S = [G1() * rng.random_scalar() for _ in range(4)]
    perm = [2, 0, 3, 1]
    k = rng.random_scalar()
    vec_T, vec_U, M, _ = shuffle_permute_and_commit_input(
        crs, vec_R, vec_S, perm, k, rng
    )
    assert vec_T == [vec_R[i] * k for i in perm]
    assert vec_U == [vec_S[i] * k for i in perm]


def test_bad_shuffle_arguments_fail(shuffle_instance):
    crs, vec_R, vec_S, vec_T, vec_U, M, proof = shuffle_instance
    # swapped R/S columns
    with pytest.raises(ProofError):
        proof.verify(crs, vec_S, vec_R, vec_T, vec_U, M)
    # re-permuted T/U (valid shuffle but different permutation than proven)
    perm2 = list(range(1, ELL)) + [0]
    vec_T2 = [vec_T[i] for i in perm2]
    vec_U2 = [vec_U[i] for i in perm2]
    with pytest.raises(ProofError):
        proof.verify(crs, vec_R, vec_S, vec_T2, vec_U2, M)
    # re-scaled T/U
    two = Fr(2)
    with pytest.raises(ProofError):
        proof.verify(
            crs, vec_R, vec_S, [t * two for t in vec_T], [u * two for u in vec_U], M
        )
    # leading identity tracker rejected outright
    with pytest.raises(ProofError):
        proof.verify(
            crs, vec_R, vec_S, [G1.identity()] + vec_T[1:], vec_U, M
        )


def test_proof_serde_round_trip(shuffle_instance):
    crs, vec_R, vec_S, vec_T, vec_U, M, proof = shuffle_instance
    n = ELL + N_BLINDERS

    # bytes round trip, fixed layout size (SURVEY.md §3.5):
    data = proof.to_bytes()
    import math

    lg_n = int(math.log2(n))
    assert len(data) == 48 * (18 + 10 * lg_n) + 32 * 7
    proof2 = CurdleProofsProof.from_bytes(BufReader(data), n)
    assert proof2.to_bytes() == data
    proof2.verify(crs, vec_R, vec_S, vec_T, vec_U, M)

    # json round trip
    proof3 = CurdleProofsProof.from_json(proof.to_json())
    assert proof3.to_bytes() == data

    # verifier input json round trip
    vi = VerifierInput(vec_R, vec_S, vec_T, vec_U, M)
    vi2 = VerifierInput.from_json(vi.to_json())
    assert vi2.vec_R == vec_R and vi2.M == M


def test_serde_full_json_flow(shuffle_instance):
    """The reference's test_serde flow (test_curdleproofs.py:673-733):
    serialize CRS + proof + VerifierInput to JSON, deserialize all three,
    and verify the DESERIALIZED proof against the DESERIALIZED crs/statement
    — proving the JSON layer is lossless end to end, not just per object."""
    crs, vec_R, vec_S, vec_T, vec_U, M, proof = shuffle_instance
    vi = VerifierInput(vec_R, vec_S, vec_T, vec_U, M)

    deser_proof = CurdleProofsProof.from_json(proof.to_json())
    deser_crs = CurdleproofsCrs.from_json(crs.to_json())
    deser_vi = VerifierInput.from_json(vi.to_json())

    deser_proof.verify(
        deser_crs,
        deser_vi.vec_R,
        deser_vi.vec_S,
        deser_vi.vec_T,
        deser_vi.vec_U,
        deser_vi.M,
    )


def test_batched_verification(shuffle_instance):
    from curdleproofs_jax.models.shuffle import verify_shuffle_proofs

    crs, vec_R, vec_S, vec_T, vec_U, M, proof = shuffle_instance
    # a second independent proof over the same CRS
    rng = ProofRng(77)
    permutation = rng.permutation(ELL)
    k = rng.random_scalar()
    gen = G1()
    vec_R2 = [gen * rng.random_scalar() for _ in range(ELL)]
    vec_S2 = [gen * rng.random_scalar() for _ in range(ELL)]
    vec_T2, vec_U2, M2, m_blinders2 = shuffle_permute_and_commit_input(
        crs, vec_R2, vec_S2, permutation, k, rng
    )
    proof2 = CurdleProofsProof.new(
        crs=crs,
        vec_R=vec_R2,
        vec_S=vec_S2,
        vec_T=vec_T2,
        vec_U=vec_U2,
        M=M2,
        permutation=permutation,
        k=k,
        vec_m_blinders=m_blinders2,
        rng=rng,
    )

    instances = [
        (proof, VerifierInput(vec_R, vec_S, vec_T, vec_U, M)),
        (proof2, VerifierInput(vec_R2, vec_S2, vec_T2, vec_U2, M2)),
    ]
    verify_shuffle_proofs(crs, instances)  # one aggregated MSM for both

    # seeded + threaded: each worker gets a rng spawned sequentially on the
    # caller's thread, so a fixed seed is deterministic regardless of thread
    # interleaving (spawn order is defined, consumption order is not)
    verify_shuffle_proofs(crs, instances, rng=ProofRng(7), workers=2)
    a, b = ProofRng(5), ProofRng(5)
    assert [a.spawn().random_scalar() for _ in range(4)] == [
        b.spawn().random_scalar() for _ in range(4)
    ]

    # one bad instance poisons the batch
    bad = [
        instances[0],
        (proof2, VerifierInput(vec_S2, vec_R2, vec_T2, vec_U2, M2)),
    ]
    with pytest.raises(ProofError):
        verify_shuffle_proofs(crs, bad)


def test_whisk_shuffle_proof_api():
    rng = ProofRng(33)
    crs = CurdleproofsCrs.new(ELL, N_BLINDERS, rng)
    gen = G1()
    pre = []
    for _ in range(ELL):
        r = rng.random_scalar()
        k = rng.random_scalar()
        r_G = gen * r
        pre.append(
            WhiskTracker(
                BLSPubkey(r_G.to_compressed_bytes()),
                BLSPubkey((r_G * k).to_compressed_bytes()),
            )
        )
    post, proof_bytes = GenerateWhiskShuffleProof(crs, pre, rng)
    assert len(post) == ELL
    assert IsValidWhiskShuffleProof(crs, pre, post, proof_bytes)
    # tampered proof fails (flip one byte deep in the proof body)
    bad = bytearray(proof_bytes)
    bad[100] ^= 1
    assert not IsValidWhiskShuffleProof(crs, pre, post, bytes(bad))
    # truncated proof fails cleanly
    assert not IsValidWhiskShuffleProof(crs, pre, post, proof_bytes[:100])
    # wrong tracker ordering fails
    assert not IsValidWhiskShuffleProof(crs, post, pre, proof_bytes)


def test_whisk_tracker_proof_api():
    rng = ProofRng(44)
    k = rng.random_scalar()
    r = rng.random_scalar()
    gen = G1()
    r_G = gen * r
    k_r_G = r_G * k
    k_G = gen * k
    tracker = WhiskTracker(
        BLSPubkey(r_G.to_compressed_bytes()), BLSPubkey(k_r_G.to_compressed_bytes())
    )
    k_commitment = BLSPubkey(k_G.to_compressed_bytes())

    proof = GenerateWhiskTrackerProof(tracker, k, rng)
    assert len(proof) == 128
    assert IsValidWhiskOpeningProof(tracker, k_commitment, proof)

    # wrong k fails
    other = GenerateWhiskTrackerProof(tracker, rng.random_scalar(), rng)
    assert not IsValidWhiskOpeningProof(tracker, k_commitment, other)


def test_whisk_batched_verification():
    from curdleproofs_jax.models.whisk import (
        AreValidWhiskShuffleProofs,
        GenerateWhiskShuffleProof,
    )

    rng = ProofRng(55)
    ell = 12
    crs = CurdleproofsCrs.new(ell, N_BLINDERS, rng)
    gen = G1()
    instances = []
    for _ in range(3):
        pre = []
        for _ in range(ell):
            r, k = rng.random_scalar(), rng.random_scalar()
            r_G = gen * r
            pre.append(
                WhiskTracker(
                    BLSPubkey(r_G.to_compressed_bytes()),
                    BLSPubkey((r_G * k).to_compressed_bytes()),
                )
            )
        post, proof_bytes = GenerateWhiskShuffleProof(crs, pre, rng)
        instances.append((pre, post, proof_bytes))

    assert AreValidWhiskShuffleProofs(crs, instances)
    # one bad instance poisons the batch
    pre0, post0, pb0 = instances[0]
    bad = bytearray(pb0)
    bad[60] ^= 1
    assert not AreValidWhiskShuffleProofs(
        crs, [(pre0, post0, bytes(bad))] + instances[1:]
    )
    # swapped pre/post fails
    assert not AreValidWhiskShuffleProofs(
        crs, [(post0, pre0, pb0)] + instances[1:]
    )
