"""Multi-process training data loader.

Counterpart of ``dpvo_tpu/data/loader.py``: torch's DataLoader worker pool
(8 workers and prefetch 4 by default).  Batches come out as tuples of
numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch.utils.data as td


class _Wrap(td.Dataset):
    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]


def _collate(samples):
    return tuple(np.stack([np.asarray(x[j]) for x in samples])
                 for j in range(len(samples[0])))


def make_loader(dataset, batch_size=1, num_workers=8, prefetch=4,
                shuffle=True):
    return td.DataLoader(
        _Wrap(dataset), batch_size=batch_size, shuffle=shuffle,
        num_workers=num_workers, collate_fn=_collate,
        prefetch_factor=prefetch if num_workers > 0 else None,
        persistent_workers=num_workers > 0, drop_last=True)
