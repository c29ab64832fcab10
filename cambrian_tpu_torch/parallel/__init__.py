from .mesh import AXES, MeshConfig, create_mesh
from .sharding import batch_sharding, infer_param_shardings, replicated, shard_model
