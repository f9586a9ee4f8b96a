"""Compatibility alias — implementation: protocol/folding.py."""
from curdleproofs_jax.protocol.folding import SameMSMProof  # noqa: F401
