"""Device mesh construction (cambrian_tpu/parallel/mesh.py).

Three named axes, as in the JAX package:

    data  -- pure data parallelism (outermost): the model replicated;
    fsdp  -- parameter and optimizer sharding (FSDP2, ZeRO-3);
    model -- tensor parallelism (innermost, so its collectives ride the
             fastest links).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group's ranks, one device a rank. Together, data and fsdp are the
HSDP layout: parameters sharded over fsdp and replicated over data
(``parallel/sharding.py``).
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

AXES = ("data", "fsdp", "model")


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    fsdp: int = -1     # -1: absorb remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int]:
        known = [x for x in (self.data, self.fsdp, self.model) if x != -1]
        prod = int(np.prod(known)) if known else 1
        free = n_devices // prod
        dims = tuple(free if x == -1 else x for x in (self.data, self.fsdp, self.model))
        if int(np.prod(dims)) != n_devices:
            raise ValueError(
                f"mesh {dims} does not cover {n_devices} devices"
            )
        return dims


def create_mesh(config: Optional[MeshConfig] = None, device_type: Optional[str] = None):
    """A (data, fsdp, model) ``DeviceMesh`` over the process group's world:
    ``config`` resolved against the world size, ``model`` innermost. The
    device type is ``cuda`` unless the caller asks for ``cpu`` (gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised process group "
                           "(parallel.distributed.initialize_distributed)")
    dims = (config or MeshConfig()).resolve(dist.get_world_size())
    return init_device_mesh(device_type or "cuda", dims, mesh_dim_names=AXES)


def axis_sizes(mesh) -> dict:
    """{axis: size} of a ``DeviceMesh``, or of a mapping of axis sizes (the
    pure functions of ``parallel/sharding.py`` take either)."""
    if isinstance(mesh, dict):
        return {a: int(mesh.get(a, 1)) for a in AXES}
    return {a: int(mesh.size(mesh.mesh_dim_names.index(a))) for a in AXES}
