#!/usr/bin/env python
"""Build the Redwood scene_info pickle offline, with a frame stride, using
the PyTorch port's reader (the counterpart of
``scripts/build_redwood_pickle.py``; the same arguments and the same
strided pickle, which either package's reader loads).

    python scripts/build_redwood_pickle_torch.py --root datasets/redwood \
        --mode train --stride 2 [--device cpu]

The co-visibility graph is computed on ``--device`` (default cuda).
"""
import argparse
import os
import os.path as osp
import pickle
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True)
    parser.add_argument("--mode", default="train",
                        choices=["train", "validation", "test"])
    parser.add_argument("--stride", type=int, default=1,
                        help="keep every Nth frame")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args()

    from dpvo_tpu_torch.data.redwood import Redwood
    from dpvo_tpu_torch.device import resolve_device

    # build without the automatic cache, apply the stride, save by hand
    class _NoCache(Redwood):
        def _load_or_build_scene_info(self, _):
            return self._build_dataset()

        def _build_dataset_index(self):
            self.dataset_index = []

    ds = _NoCache(mode=args.mode, datapath=args.root, aug=False,
                  device=resolve_device(args.device))
    info = ds.scene_info

    if args.stride > 1:
        for d in info.values():
            d["images"] = d["images"][::args.stride]
            d["depths"] = d["depths"][::args.stride]
            d["poses"] = d["poses"][::args.stride]
            d["intrinsics"] = d["intrinsics"][::args.stride]
            # rebuild the graph on the strided sequence
            d["graph"] = ds.build_frame_graph(d["poses"], d["depths"],
                                              d["intrinsics"])

    cache_dir = osp.join(args.root, "cache")
    os.makedirs(cache_dir, exist_ok=True)
    path = osp.join(cache_dir, f"Redwood_{args.mode}.pickle")
    with open(path, "wb") as f:
        pickle.dump(info, f)
    print(f"saved {path} ({len(info)} scenes)")


if __name__ == "__main__":
    main()
