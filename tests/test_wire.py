"""Wire-codec robustness: layout sizes, truncation, malformed encodings
(reference behaviour: BufReader underrun/ValueError -> verifier returns
False at the Whisk boundary)."""
import math

import pytest

from curdleproofs_jax.curve import G1
from curdleproofs_jax.fields import Fr
from curdleproofs_jax.models.crs import CurdleproofsCrs
from curdleproofs_jax.models.opening import TrackerOpeningProof
from curdleproofs_jax.models.shuffle import (
    N_BLINDERS,
    CurdleProofsProof,
    shuffle_permute_and_commit_input,
)
from curdleproofs_jax.models.whisk import WhiskShuffleProof
from curdleproofs_jax.transcript.oracle import Transcript
from curdleproofs_jax.utils.errors import SerdeError
from curdleproofs_jax.utils.rng import ProofRng
from curdleproofs_jax.utils.serde import BufReader

ELL = 12
N = ELL + N_BLINDERS


@pytest.fixture(scope="module")
def proof_bytes():
    rng = ProofRng(7)
    crs = CurdleproofsCrs.new(ELL, N_BLINDERS, rng)
    gen = G1()
    vec_R = [gen * rng.random_scalar() for _ in range(ELL)]
    vec_S = [gen * rng.random_scalar() for _ in range(ELL)]
    perm = rng.permutation(ELL)
    k = rng.random_scalar()
    vec_T, vec_U, M, mb = shuffle_permute_and_commit_input(
        crs, vec_R, vec_S, perm, k, rng
    )
    proof = CurdleProofsProof.new(
        crs=crs, vec_R=vec_R, vec_S=vec_S, vec_T=vec_T, vec_U=vec_U, M=M,
        permutation=perm, k=k, vec_m_blinders=mb, rng=rng,
    )
    return WhiskShuffleProof(M, proof).to_bytes()


def test_layout_size(proof_bytes):
    lg_n = int(math.log2(N))
    assert len(proof_bytes) == 48 + 48 * (18 + 10 * lg_n) + 32 * 7


def test_truncation_raises(proof_bytes):
    for cut in (0, 1, 47, len(proof_bytes) // 2, len(proof_bytes) - 1):
        with pytest.raises(SerdeError):
            WhiskShuffleProof.from_bytes(BufReader(proof_bytes[:cut]), N)


def test_bad_point_encoding_raises(proof_bytes):
    bad = bytearray(proof_bytes)
    bad[0] &= 0x7F  # clear the compression flag of the first point
    with pytest.raises(SerdeError):
        WhiskShuffleProof.from_bytes(BufReader(bytes(bad)), N)


def test_noncanonical_scalar_raises(proof_bytes):
    # the trailing scalar is x_final; force it >= r
    bad = bytearray(proof_bytes)
    bad[-32:] = b"\xff" * 32
    with pytest.raises(SerdeError):
        WhiskShuffleProof.from_bytes(BufReader(bytes(bad)), N)


def test_roundtrip_and_json(proof_bytes):
    w = WhiskShuffleProof.from_bytes(BufReader(proof_bytes), N)
    assert w.to_bytes() == proof_bytes
    again = WhiskShuffleProof.from_json(w.to_json())
    assert again.to_bytes() == proof_bytes


def test_opening_proof_wire():
    rng = ProofRng(8)
    k, r = rng.random_scalar(), rng.random_scalar()
    r_G = G1() * r
    proof = TrackerOpeningProof.new(
        k_r_G=r_G * k, r_G=r_G, k_G=G1() * k, k=k,
        transcript=Transcript(b"whisk_opening_proof"), rng=rng,
    )
    data = proof.to_bytes()
    assert len(data) == 128
    rt = TrackerOpeningProof.from_bytes(BufReader(data))
    assert rt.to_bytes() == data
    assert rt == proof  # dataclass equality over points/scalars


def test_wire_fuzz_corruption_is_typed(proof_bytes):
    """Random single-byte corruptions and truncations must either decode
    (and then fail verification) or raise a typed ProofError — never an
    unhandled exception type (the Whisk bool wrappers rely on this)."""
    import random

    from curdleproofs_jax.utils.errors import ProofError

    rng = random.Random(99)
    for _ in range(60):
        bad = bytearray(proof_bytes)
        mode = rng.randrange(3)
        if mode == 0:
            bad[rng.randrange(len(bad))] ^= 1 << rng.randrange(8)
            data = bytes(bad)
        elif mode == 1:
            data = bytes(bad[: rng.randrange(len(bad))])
        else:
            data = bytes(bad) + bytes(rng.randrange(1, 64))
        try:
            w = WhiskShuffleProof.from_bytes(BufReader(data), N)
            assert w.to_bytes() == data[: len(w.to_bytes())]
        except ProofError:
            pass  # typed rejection is the contract
