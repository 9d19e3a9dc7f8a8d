"""Multi-device runs on ``torch.distributed``, one process per device:
``mesh`` (process group, batch rows, broadcast), ``launch`` (spawned ranks
on one host), ``infer_step`` (edge-sharded tracking update) and
``train_step`` (the training step, on one device or data-parallel)."""
