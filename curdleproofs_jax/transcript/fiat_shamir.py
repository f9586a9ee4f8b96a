"""Compatibility alias — implementation: transcript/oracle.py."""
from curdleproofs_jax.transcript.oracle import (  # noqa: F401
    CurdleproofsTranscript,
    Transcript,
)
