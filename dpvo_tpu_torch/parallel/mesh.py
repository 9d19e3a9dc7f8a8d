"""Process groups for multi-device runs (``torch.distributed``).

Counterpart of ``dpvo_tpu/parallel/mesh.py``: where the JAX package builds a
1-D device mesh in one process, the port runs one process per device.

- ``make_mesh`` joins the default process group (or takes the one already
  joined) and returns it with this rank's device; it raises when the world
  size is not ``n_devices`` rather than run on fewer devices than asked.
- ``shard_batch`` takes this rank's rows of the leading axis.
- ``replicate`` broadcasts a tensor (or a module's parameters and
  buffers) from rank 0.

The backend is named, never switched on the fly: NCCL for CUDA devices and
gloo for the CPU by default; a caller may name gloo for CUDA tensors (two
ranks on one card, which NCCL refuses).  The port uses only ``all_reduce``
and ``broadcast``, the collectives gloo supports on CUDA tensors.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device

DEFAULT_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(n_devices=None, device="cuda", backend=None,
              init_method="env://", rank=-1, world_size=-1):
    """Join the default process group and return (group, device).

    ``device`` "cuda" picks ``cuda:LOCAL_RANK`` (the launcher's local rank,
    else the rank modulo the visible cards); "cuda:i" or "cpu" is taken as
    given.  ``init_method``, ``rank`` and ``world_size`` go to
    ``init_process_group`` when this process has not joined one yet
    (``env://`` with -1 reads torchrun's MASTER_ADDR/PORT, RANK and
    WORLD_SIZE)."""
    dev = torch.device(device)
    backend = backend or DEFAULT_BACKEND[dev.type]
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    if dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()!r}, "
                           f"not the {backend!r} asked for")
    world, r = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and world != n_devices:
        raise RuntimeError(f"make_mesh({n_devices}) but the world has "
                           f"{world} rank(s)")
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", r))
        dev = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dist.group.WORLD, dev


def shard_batch(batch, group=None):
    """This rank's rows of the leading axis of an array, or of every array
    in a dict of them; the leading size must divide by the world size."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, group) for k, v in batch.items()}
    world = dist.get_world_size(group)
    n = batch.shape[0]
    if n % world:
        raise ValueError(f"a leading axis of {n} does not split over "
                         f"{world} ranks")
    b = n // world
    r = dist.get_rank(group)
    return batch[r * b:(r + 1) * b]


def replicate(tree, group=None):
    """Broadcast from rank 0, in place: a module's parameters and buffers,
    or a tensor.  Returns ``tree``."""
    tensors = ([*tree.parameters(), *tree.buffers()]
               if isinstance(tree, torch.nn.Module) else [tree])
    src = dist.get_global_rank(group, 0) if group is not None else 0
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)
    return tree
