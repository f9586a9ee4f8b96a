from curdleproofs_jax.parallel.mesh import make_mesh, make_mesh_2d
from curdleproofs_jax.parallel.msm import msm_sharded

__all__ = ["make_mesh", "make_mesh_2d", "msm_sharded"]
