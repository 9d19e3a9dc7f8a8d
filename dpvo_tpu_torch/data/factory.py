"""Dataset factory.

Copy of ``dpvo_tpu/data/factory.py``; the Redwood reader is not ported yet
(ROADMAP.md Queue 1 item 15) and raises.
"""
from __future__ import annotations


def dataset_factory(dataset_list, **kwargs):
    """Create a concatenated dataset from a list of names."""
    from .tartan import TartanAir

    dataset_map = {"tartan": (TartanAir,)}
    db_list = []
    for key in dataset_list:
        if key == "redwood":
            raise NotImplementedError(
                "the Redwood reader is not ported yet (ROADMAP.md Queue 1 "
                "item 15)")
        (cls,) = dataset_map[key]
        db = cls(**kwargs)
        print(f"Dataset {key} has {len(db)} images")
        db_list.append(db)
    return ConcatDataset(db_list)


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.lengths = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self.lengths)

    def __getitem__(self, idx):
        idx = idx % len(self)
        for d, L in zip(self.datasets, self.lengths):
            if idx < L:
                return d[idx]
            idx -= L
        raise IndexError
