"""The mesh, the precision policy and the random streams. The JAX package's
`data_sharding` and `replicated_sharding` are JAX-only: they are
`NamedSharding`s of a global array, which torch does not have; the port
places each rank's rows by rank (`core/mesh.py`)."""

from medvae_tpu_torch.core.mesh import MeshSpec, create_mesh
from medvae_tpu_torch.core.precision import Policy, default_policy
from medvae_tpu_torch.core.rng import RngStream, set_seed

__all__ = ["MeshSpec", "create_mesh", "Policy", "default_policy", "RngStream", "set_seed"]
