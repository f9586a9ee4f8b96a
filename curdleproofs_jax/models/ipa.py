"""Compatibility alias — implementation: protocol/folding.py."""
from curdleproofs_jax.protocol.folding import (  # noqa: F401
    IPA,
    fold_exponents,
    generate_ipa_blinders,
    get_verification_scalars_bitstring,
)
