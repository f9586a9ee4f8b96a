"""Compatibility alias — implementation: protocol/sigma.py."""
from curdleproofs_jax.protocol.sigma import TrackerOpeningProof  # noqa: F401
