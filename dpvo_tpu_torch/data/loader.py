"""Multi-process training data loader.

Counterpart of ``dpvo_tpu/data/loader.py``: torch's DataLoader worker pool
(8 workers and prefetch 4 by default).  Batches come out as tuples of
numpy arrays.

With ``shard=(rank, world)`` (one process per device) a rank loads only
its rows of each global batch of ``batch_size * world`` samples
(``RowSampler``, seeded with ``seed``), each sample drawn from a seed of
its own, so the global batch does not depend on which rank loads which
row.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.utils.data as td


class _Wrap(td.Dataset):
    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        if isinstance(i, tuple):          # (index, seed) from RowSampler
            i, seed = i
            np.random.seed(seed)          # the readers draw from numpy's
        return self.ds[i]


class RowSampler(td.Sampler):
    """Rank ``rank``'s rows of global batches of ``batch_size * world``
    shuffled indices, each as (index, seed).  Epoch e's permutation and
    seeds come from a generator seeded with ``seed + e``, so every rank
    draws the same ones whatever else it runs; drops the last partial
    global batch."""

    def __init__(self, n, batch_size, rank, world, seed=0):
        self.n, self.b, self.rank, self.world = n, batch_size, rank, world
        self.seed, self.epoch = seed, 0

    def __len__(self):
        return self.n // (self.b * self.world)

    def __iter__(self):
        g = torch.Generator().manual_seed(self.seed + self.epoch)
        self.epoch += 1
        perm = torch.randperm(self.n, generator=g).tolist()
        seeds = torch.randint(2 ** 32, (self.n,), generator=g).tolist()
        size = self.b * self.world
        for s in range(0, len(self) * size, size):
            rows = range(s + self.rank * self.b, s + (self.rank + 1) * self.b)
            yield [(perm[j], seeds[j]) for j in rows]


def _collate(samples):
    return tuple(np.stack([np.asarray(x[j]) for x in samples])
                 for j in range(len(samples[0])))


def make_loader(dataset, batch_size=1, num_workers=8, prefetch=4,
                shuffle=True, shard=None, seed=0):
    """Batches of ``batch_size`` samples; with ``shard=(rank, world)``
    this rank's ``batch_size`` rows of each shuffled global batch
    (``RowSampler`` from ``seed``)."""
    kw = dict(num_workers=num_workers, collate_fn=_collate,
              prefetch_factor=prefetch if num_workers > 0 else None,
              persistent_workers=num_workers > 0)
    if shard is not None:
        return td.DataLoader(_Wrap(dataset), batch_sampler=RowSampler(
            len(dataset), batch_size, *shard, seed=seed), **kw)
    return td.DataLoader(_Wrap(dataset), batch_size=batch_size,
                         shuffle=shuffle, drop_last=True, **kw)
