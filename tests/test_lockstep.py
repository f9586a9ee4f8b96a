"""Lockstep batch proving: K provers, coalesced point-ops, one dispatch/step.

Covers utils/lockstep.py + GenerateWhiskShuffleProofs (SURVEY §2.3 batch
parallelism on the proving side). Oracle: every batched proof must verify
under the unmodified per-proof verifier, and a seeded batch is bit-identical
across runs (spawn-order determinism)."""
import pytest

from curdleproofs_jax.curve import G1
from curdleproofs_jax.models.crs import CurdleproofsCrs
from curdleproofs_jax.models.whisk import (
    BLSPubkey,
    GenerateWhiskShuffleProofs,
    IsValidWhiskShuffleProof,
    WhiskTracker,
)
from curdleproofs_jax.utils.rng import ProofRng

ELL = 12
K = 3


def _trackers(rng, ell):
    gen = G1()
    out = []
    for _ in range(ell):
        r_G = gen * rng.random_scalar()
        out.append(
            WhiskTracker(
                BLSPubkey(r_G.to_compressed_bytes()),
                BLSPubkey((r_G * rng.random_scalar()).to_compressed_bytes()),
            )
        )
    return out


@pytest.fixture(scope="module")
def setup():
    rng = ProofRng(1234)
    crs = CurdleproofsCrs.new(ELL, 4, rng)
    pres = [_trackers(rng, ELL) for _ in range(K)]
    return crs, pres


def test_batch_proving_verifies(setup):
    crs, pres = setup
    results = GenerateWhiskShuffleProofs(crs, pres, ProofRng(7))
    assert len(results) == K
    for pre, (post, proof_bytes) in zip(pres, results):
        assert IsValidWhiskShuffleProof(crs, pre, post, proof_bytes)
    # cross-pairing must fail: proof 0 does not validate trackers of proof 1
    post1, _ = results[1]
    _, proof0 = results[0]
    assert not IsValidWhiskShuffleProof(crs, pres[1], post1, proof0)


def test_batch_proving_deterministic(setup):
    crs, pres = setup
    a = GenerateWhiskShuffleProofs(crs, pres, ProofRng(42))
    b = GenerateWhiskShuffleProofs(crs, pres, ProofRng(42))
    for (post_a, bytes_a), (post_b, bytes_b) in zip(a, b):
        assert bytes_a == bytes_b
        assert [t.r_G for t in post_a] == [t.r_G for t in post_b]


def test_batch_single_instance(setup):
    crs, pres = setup
    (post, proof_bytes), = GenerateWhiskShuffleProofs(crs, pres[:1], ProofRng(9))
    assert IsValidWhiskShuffleProof(crs, pres[0], post, proof_bytes)


def test_lockstep_divergence_detected():
    from curdleproofs_jax.utils.lockstep import LockstepError, run_lockstep
    from curdleproofs_jax.vectors import PointVec, ScalarVec

    gen = G1()
    pv2 = PointVec([gen, gen + gen])
    pv3 = PointVec([gen, gen, gen])
    sv2, sv3 = ScalarVec.of([1, 2]), ScalarVec.of([1, 2, 3])

    with pytest.raises(LockstepError):
        run_lockstep([lambda: pv2.msm(sv2), lambda: pv3.msm(sv3)])


def test_lockstep_merged_ops_match_host():
    """Each merged op kind agrees with the unbatched host path."""
    from curdleproofs_jax.utils.lockstep import run_lockstep
    from curdleproofs_jax.vectors import PointVec, ScalarVec
    from curdleproofs_jax.fields import Fr

    rng = ProofRng(5)
    gen = G1()
    pts = [[gen * rng.random_scalar() for _ in range(8)] for _ in range(3)]
    scs = [[rng.random_scalar() for _ in range(8)] for _ in range(3)]
    gammas = [rng.random_scalar() for _ in range(3)]

    def make(i):
        def work():
            pv, sv = PointVec(pts[i]), ScalarVec.of(scs[i])
            return (
                pv.msm(sv),
                pv.scaled(sv).tolist(),
                (pv + pv).tolist(),
                pv.folded(gammas[i]).tolist(),
            )

        return work

    got = run_lockstep([make(i) for i in range(3)])
    for i in range(3):
        pv, sv = PointVec(pts[i]), ScalarVec.of(scs[i])
        assert got[i][0] == pv.msm(sv)
        assert got[i][1] == pv.scaled(sv).tolist()
        assert got[i][2] == (pv + pv).tolist()
        assert got[i][3] == pv.folded(gammas[i]).tolist()
