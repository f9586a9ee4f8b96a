from curdleproofs_jax.models import api  # noqa: F401
