"""curdleproofs_jax — the Curdleproofs zero-knowledge shuffle argument on JAX.

A from-scratch JAX/XLA implementation of the Curdleproofs shuffle argument
(Ethereum Whisk), with BLS12-381 limb arithmetic, G1 kernels and Pippenger
MSM running on the GPU, and a bit-exact Merlin/STROBE Fiat–Shamir
transcript on host. Public API mirrors the reference package facade
(curdleproofs/__init__.py:1-15).
"""

from curdleproofs_jax.fields import Fr, CURVE_ORDER, FR_MOD, FQ_MOD
from curdleproofs_jax.curve import G1, G1_GENERATOR, G1_IDENTITY

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy re-exports of the protocol layer to keep bare field/curve imports
    # light (jax only loads when ops/models are touched).
    from curdleproofs_jax.models import api

    try:
        return getattr(api, name)
    except AttributeError:
        raise AttributeError(f"module 'curdleproofs_jax' has no attribute {name!r}")
