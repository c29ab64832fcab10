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


# -- the vocab-parallel layout and its collectives --------------------------
#
# The JAX package lays the token embedding and the LM head out over vocab on
# the (model, fsdp) axes together, model-major (``P(("model", "fsdp"),
# None)``), replicated over data; the batch's rows lie over (data, fsdp).
# ``VocabParallel`` is that layout of one V-row tensor on a rank; the
# functions below are the collectives the lookup, the head and the loss
# (``models/cambrian.py``) share. Each runs its collective whatever the size
# of its group, one rank included.

_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` concatenated along dim 0, in group order."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather(out, x.contiguous(), group=group)
    return out


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the group, this rank's block of dim 0 kept."""
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),) + tuple(x.shape[1:]))
    _reduce_scatter(out, x.contiguous(), group=group)
    return out


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the group, in place."""
    dist.all_reduce(x, op=op, group=group)
    return x


class ScatterRows(torch.autograd.Function):
    """``reduce_scatter_rows``; the backward gathers the rows' gradient
    (``all_gather_rows``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_rows(g, ctx.group), None


class SumOver(torch.autograd.Function):
    """Partial sums added over the group. The ranks of the group hold the
    same rows downstream, so each rank's gradient is already the whole one:
    the backward passes it through (Megatron's reduce)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class VocabParallel:
    """The layout of a tensor of ``vocab`` rows (the token embedding, the LM
    head) on this rank of a (data, fsdp, model) mesh, by the JAX rule.

    Where ``vocab`` divides by n = model x fsdp (``split``), the n ranks of
    a data index each hold ``rows`` = V/n rows from ``start``, slab number
    model index x fsdp + fsdp index; otherwise the tensor is whole on every
    rank, as ``_fit_spec`` drops the axes. The tensors are
    DTensors on ``placement_mesh``, the mesh's axes in the order (data,
    model, fsdp), so that two ``Shard(0)`` split V model-major and
    ``spec_of`` reads ``(("model", "fsdp"), None)``."""

    def __init__(self, mesh, vocab: int):
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import Replicate, Shard

        sizes = axis_sizes(mesh)
        _, fsdp, model = mesh.get_coordinate()
        self.mesh = mesh
        self.vocab = vocab
        self.split = vocab % (sizes["model"] * sizes["fsdp"]) == 0
        n = sizes["model"] * sizes["fsdp"] if self.split else 1
        self.rows = vocab // n
        self.start = (model * sizes["fsdp"] + fsdp if self.split else 0) * self.rows
        self.fsdp, self.fsdp_index = sizes["fsdp"], fsdp
        self.fsdp_group = mesh.get_group("fsdp")
        self.model_group = mesh.get_group("model")
        # the permuted mesh and the (model, fsdp) group of each data index,
        # made once a mesh (every rank makes them together). Not
        # ``DeviceMesh._flatten``: DTensor would then gather the permuted
        # mesh's two axes in one collective in rank order, which is not the
        # layout's
        if not hasattr(mesh, "_vocab_groups"):
            placement_mesh = DeviceMesh(mesh.device_type, mesh.mesh.permute(0, 2, 1),
                                        mesh_dim_names=("data", "model", "fsdp"))
            groups = [dist.new_group(ranks.flatten().tolist()) for ranks in mesh.mesh]
            mesh._vocab_groups = (placement_mesh, groups)
        self.placement_mesh, groups = mesh._vocab_groups
        self.vocab_group = groups[mesh.get_coordinate()[0]]
        self.placements = ((Replicate(), Shard(0), Shard(0)) if self.split
                           else (Replicate(),) * 3)
        # the (data, fsdp) axes whose ranks hold other rows and the same
        # slab: a gradient of the tensor is summed over them
        self.grad_axes = ("data",) if self.split else ("data", "fsdp")

    def distribute(self, t: torch.Tensor):
        """A DTensor of the layout from ``t``, whole and the same on every
        rank: each rank keeps its slab, with no communication."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t.detach(), self.placement_mesh, self.placements,
                                 src_data_rank=None)

    def sum_grad(self, grad: torch.Tensor) -> torch.Tensor:
        """A gradient of the layout (its local slab, in place) summed over
        the ranks that hold the same slab and other rows."""
        local = grad._local_tensor if hasattr(grad, "placements") else grad
        for axis in self.grad_axes:
            all_reduce(local, self.mesh.get_group(axis))
        return grad

    def gather_vocab(self, z: torch.Tensor) -> torch.Tensor:
        """Whole-vocab rows from slab columns: ``z`` [fsdp x B, ..., V/n]
        holds this slab's columns of the rows of every fsdp rank of the data
        index (``all_gather_rows`` over fsdp); returns this rank's own B rows
        over the whole vocab [B, ..., V], the slabs in vocab order."""
        mine = torch.empty_like(z)
        dist.all_to_all_single(mine, z.contiguous(), group=self.fsdp_group)
        every = all_gather_rows(mine, self.model_group)   # dim 0: (model, fsdp, row)
        m, f = dist.get_world_size(self.model_group), self.fsdp
        b = z.shape[0] // f
        every = every.reshape(m, f, b, *z.shape[1:])
        order = list(range(2, every.dim() - 1)) + [0, 1, every.dim() - 1]
        return every.permute(*order).reshape(b, *z.shape[1:-1], self.vocab)

