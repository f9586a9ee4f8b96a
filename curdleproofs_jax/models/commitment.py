"""Compatibility alias — implementation: protocol/primitives.py."""
from curdleproofs_jax.protocol.primitives import GroupCommitment  # noqa: F401
