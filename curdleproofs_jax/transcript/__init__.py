from curdleproofs_jax.transcript.keccak import keccak_f1600
from curdleproofs_jax.transcript.strobe import Strobe128
from curdleproofs_jax.transcript.oracle import (
    CurdleproofsTranscript,
    MerlinTranscript,
    Transcript,
)

__all__ = [
    "keccak_f1600",
    "Strobe128",
    "Transcript",
    "MerlinTranscript",
    "CurdleproofsTranscript",
]
