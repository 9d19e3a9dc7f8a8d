"""Training logger: running means flushed every SUM_FREQ steps, TensorBoard
when available, JSONL always.

Copy of ``dpvo_tpu/utils/logger.py`` (this package imports nothing of
``dpvo_tpu``).
"""
from __future__ import annotations

import json
import os
import time

SUM_FREQ = 100


class Logger:
    def __init__(self, name, scheduler=None, logdir="runs"):
        self.total_steps = 0
        self.running_loss = {}
        self.name = name
        self.scheduler = scheduler
        self.dir = os.path.join(logdir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.writer = SummaryWriter(self.dir)
        except Exception:
            pass

    def _flush(self):
        means = {k: v / SUM_FREQ for k, v in self.running_loss.items()}
        rec = dict(step=self.total_steps, time=time.time(), **means)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.writer is not None:
            for k, v in means.items():
                self.writer.add_scalar(k, v, self.total_steps)
        msg = " ".join(f"{k}={v:.4f}" for k, v in means.items())
        print(f"[{self.total_steps:6d}] {msg}")
        self.running_loss = {}

    def push(self, metrics):
        self.total_steps += 1
        for k, v in metrics.items():
            self.running_loss[k] = self.running_loss.get(k, 0.0) + float(v)
        if self.total_steps % SUM_FREQ == 0:
            self._flush()

    def write_dict(self, results):
        rec = dict(step=self.total_steps, **{k: float(v)
                                             for k, v in results.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.writer is not None:
            for k, v in results.items():
                self.writer.add_scalar(k, float(v), self.total_steps)

    def close(self):
        self.jsonl.close()
        if self.writer is not None:
            self.writer.close()
