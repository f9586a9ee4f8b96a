"""Public API facade re-exports and the metrics/observability subsystem."""


def test_public_api_facade():
    import curdleproofs_jax as cp

    # reference facade parity (curdleproofs/__init__.py:1-15)
    for name in (
        "GenerateWhiskShuffleProof",
        "IsValidWhiskShuffleProof",
        "GenerateWhiskTrackerProof",
        "IsValidWhiskOpeningProof",
        "WhiskTracker",
        "TrackerOpeningProof",
        "CurdleproofsCrs",
        "N_BLINDERS",
        "CurdleProofsProof",
        "VerifierInput",
        "shuffle_permute_and_commit_input",
        "verify_shuffle_proofs",
        "Fr",
        "G1",
    ):
        assert getattr(cp, name) is not None, name


def test_metrics_registry_records_msm():
    import random

    from curdleproofs_jax.curve import G1
    from curdleproofs_jax.fields import FR_MOD, Fr
    from curdleproofs_jax.ops.msm import msm
    from curdleproofs_jax.utils.profiling import collect, metrics_report

    rng = random.Random(5)
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(8)]
    scs = [Fr(rng.randrange(FR_MOD)) for _ in range(8)]
    with collect():
        msm(pts, scs)
    rep = metrics_report()
    assert any(k.startswith("msm.") for k in rep), rep
    entry = next(v for k, v in rep.items() if k.startswith("msm."))
    assert entry["calls"] == 1
    assert entry["total_point_ops"] > 0
    assert entry["point_ops_per_s"] is None or entry["point_ops_per_s"] > 0
