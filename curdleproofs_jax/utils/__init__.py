from curdleproofs_jax.utils.errors import ProofError, SerdeError, VerificationError
from curdleproofs_jax.utils.serde import BufReader
from curdleproofs_jax.utils.rng import ProofRng, default_rng

__all__ = [
    "ProofError",
    "SerdeError",
    "VerificationError",
    "BufReader",
    "ProofRng",
    "default_rng",
]
