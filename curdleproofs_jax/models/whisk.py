"""Compatibility alias — implementation: protocol/whisk.py."""
from curdleproofs_jax.protocol.whisk import (  # noqa: F401
    BLSPubkey,
    SerializedWhiskTrackerProof,
    WhiskShuffleProofBytes,
    WhiskShuffleProof,
    WhiskTracker,
    AreValidWhiskShuffleProofs,
    GenerateWhiskShuffleProof,
    GenerateWhiskShuffleProofs,
    GenerateWhiskTrackerProof,
    AssertIsValidWhiskOpeningProof,
    AssertIsValidWhiskShuffleProof,
    IsValidWhiskOpeningProof,
    IsValidWhiskShuffleProof,
)
