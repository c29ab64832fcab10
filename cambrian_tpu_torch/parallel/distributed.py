"""Multi-process runtime (cambrian_tpu/parallel/distributed.py): one process
a GPU, joined by ``torch.distributed``.

Launch modes:

- ``torchrun --nproc_per_node N -m cambrian_tpu_torch.train.train ...``:
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous come from the
  environment (``env://``), in place of the TPU pod's metadata;
- explicit: ``--coordinator_address host:port --num_processes N
  --process_id I`` (``tcp://host:port``; an address with a scheme, such as
  ``file:///tmp/rdv``, is used as it is);
- one process: no flags, no ``torchrun`` environment -> nothing happens.

The backend is NCCL when a GPU is present and gloo on the CPU.
"""

import logging
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import axis_sizes

logger = logging.getLogger(__name__)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> bool:
    """Idempotently join the multi-process runtime. Returns True if a
    process group is up (this call's or an earlier one)."""
    if dist.is_initialized():
        return True
    env = os.environ
    torchrun = "RANK" in env and "WORLD_SIZE" in env
    explicit = coordinator_address is not None or (
        num_processes is not None and num_processes > 1)
    if not explicit and not torchrun:
        return False
    cuda = torch.cuda.is_available()
    backend = "nccl" if cuda else "gloo"
    if explicit:
        address = coordinator_address or "localhost:29500"
        init_method = address if "://" in address else f"tcp://{address}"
        dist.init_process_group(backend, init_method=init_method,
                                world_size=num_processes or 1, rank=process_id or 0)
    else:
        dist.init_process_group(backend, init_method="env://")
    if cuda:
        if "LOCAL_RANK" in env:
            local = int(env["LOCAL_RANK"])
        elif local_device_ids:
            local = int(local_device_ids[0])
        else:
            local = dist.get_rank() % torch.cuda.device_count()
        torch.cuda.set_device(local)
    logger.info("distributed runtime up: rank %d of %d (%s)", dist.get_rank(),
                dist.get_world_size(), backend)
    return True


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def dp_coordinate(mesh) -> Tuple[int, int]:
    """(index, size) of this rank along the flattened (data, fsdp) axes,
    data outermost: the block of the global batch it holds, as JAX's
    ``batch_sharding`` places rows. (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    sizes = axis_sizes(mesh)
    data, fsdp, _ = mesh.get_coordinate()
    return data * sizes["fsdp"] + fsdp, sizes["data"] * sizes["fsdp"]


def dp_all_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the (data, fsdp) axes of ``mesh``, in place (ranks
    that differ only on ``model`` hold the same rows and are not summed)."""
    if mesh is not None:
        for axis in ("data", "fsdp"):
            if axis_sizes(mesh)[axis] > 1:
                dist.all_reduce(t, group=mesh.get_group(axis))
    return t


def put_global_batch(batch, mesh, device=None):
    """This rank's rows of a global host batch, on ``device``.

    Every rank builds the same global batch (the index stream is seeded, so
    this needs no communication); each takes the block of rows of its
    (data, fsdp) coordinate (``dp_coordinate``) and copies it to its device.
    Ranks that differ only on ``model`` take the same rows. Lists (the
    per-tower images and masks) are split item by item."""
    index, size = dp_coordinate(mesh)

    def put(x):
        if isinstance(x, (list, tuple)):
            return [put(v) for v in x]
        t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
        if t.shape[0] % size:
            raise ValueError(f"a global batch of {t.shape[0]} rows does not split over "
                             f"{size} (data, fsdp) ranks")
        n = t.shape[0] // size
        return t[index * n:(index + 1) * n].to(device, non_blocking=True)

    return {k: put(v) for k, v in batch.items()}
