"""Public protocol API facade (mirrors reference curdleproofs/__init__.py:1-15)."""

from curdleproofs_jax.models.commitment import GroupCommitment
from curdleproofs_jax.models.crs import CurdleproofsCrs
from curdleproofs_jax.models.ipa import IPA, generate_ipa_blinders
from curdleproofs_jax.models.grand_product import GrandProductProof
from curdleproofs_jax.models.msm_accumulator import MSMAccumulator
from curdleproofs_jax.models.opening import TrackerOpeningProof
from curdleproofs_jax.models.same_msm import SameMSMProof
from curdleproofs_jax.models.same_permutation import SamePermutationProof
from curdleproofs_jax.models.same_scalar import SameScalarProof
from curdleproofs_jax.models.shuffle import (
    N_BLINDERS,
    CurdleProofsProof,
    VerifierInput,
    shuffle_permute_and_commit_input,
    verify_shuffle_proofs,
)
from curdleproofs_jax.models.whisk import (
    AreValidWhiskShuffleProofs,
    BLSPubkey,
    GenerateWhiskShuffleProof,
    GenerateWhiskShuffleProofs,
    GenerateWhiskTrackerProof,
    IsValidWhiskOpeningProof,
    IsValidWhiskShuffleProof,
    AssertIsValidWhiskOpeningProof,
    AssertIsValidWhiskShuffleProof,
    WhiskShuffleProof,
    WhiskTracker,
)

__all__ = [
    "GroupCommitment",
    "CurdleproofsCrs",
    "IPA",
    "generate_ipa_blinders",
    "GrandProductProof",
    "MSMAccumulator",
    "TrackerOpeningProof",
    "SameMSMProof",
    "SamePermutationProof",
    "SameScalarProof",
    "N_BLINDERS",
    "CurdleProofsProof",
    "VerifierInput",
    "shuffle_permute_and_commit_input",
    "verify_shuffle_proofs",
    "AreValidWhiskShuffleProofs",
    "BLSPubkey",
    "GenerateWhiskShuffleProof",
    "GenerateWhiskShuffleProofs",
    "GenerateWhiskTrackerProof",
    "IsValidWhiskOpeningProof",
    "IsValidWhiskShuffleProof",
    "AssertIsValidWhiskOpeningProof",
    "AssertIsValidWhiskShuffleProof",
    "WhiskShuffleProof",
    "WhiskTracker",
]
