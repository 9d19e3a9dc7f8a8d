"""Multi-device runs on ``torch.distributed``, one process per device:
``mesh`` (process group, batch rows, broadcast), ``launch`` (spawned ranks
on one host), ``infer_step`` (edge-sharded tracking update) and
``train_step`` (the training step, on one device or data-parallel)."""
from .mesh import make_mesh, shard_batch, replicate
from .train_step import make_train_step

__all__ = ["make_mesh", "shard_batch", "replicate", "make_train_step"]
