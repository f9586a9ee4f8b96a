"""Compatibility alias — implementation: protocol/shuffle.py."""
from curdleproofs_jax.protocol.shuffle import (  # noqa: F401
    N_BLINDERS,
    CurdleProofsProof,
    VerifierInput,
    shuffle_permute_and_commit_input,
    verify_shuffle_proofs,
)
