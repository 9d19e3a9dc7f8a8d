"""Weights for the port's modules.

``params_from_jax`` carries the JAX package's flax parameter trees (as
nested dicts of numpy arrays) into the port's module state dicts, so both
packages can run the same network:

- Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
- Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW;
- LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``.

Module paths match because the port's submodules carry the flax names.

``load_network`` reads the JAX package's native checkpoint, an ``.npz`` of
flattened ``patchify/...`` and ``update/...`` keys
(``dpvo_tpu/utils/checkpoint.py`` ``save_network``), with numpy alone.
"""
from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(tree) -> dict[str, torch.Tensor]:
    """One flax param tree ({"params": ...} or its inside) -> state dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {}
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf, dtype=np.float32)
        *mod, name = path
        if name == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)        # HWIO -> OIHW
            elif a.ndim == 2:
                a = a.T                            # (in, out) -> (out, in)
            else:
                raise ValueError(f"unexpected kernel rank at {path}")
            name = "weight"
        elif name == "scale":
            name = "weight"
        elif name != "bias":
            raise ValueError(f"unexpected flax leaf {path}")
        sd[".".join((*mod, name))] = torch.tensor(a)
    return sd


def params_from_jax(p_params, u_params):
    """(Patchifier state dict, Update state dict) from the JAX package's
    (params_patchify, params_update) flax trees."""
    return flax_to_state_dict(p_params), flax_to_state_dict(u_params)


def load_network(path):
    """(Patchifier state dict, Update state dict) from a checkpoint file:
    the JAX package's ``.npz``, its flattened keys split at each ``/`` into
    flax trees.  The reference's ``.pth`` is not read yet (ROADMAP.md Queue
    1 item 14) and raises."""
    if str(path).endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"{path}: .pth checkpoints are not read by the port yet "
            "(ROADMAP.md Queue 1 item 14); convert to the .npz format")
    trees = {"patchify": {}, "update": {}}
    with np.load(path) as data:
        for key in data.files:
            prefix, rest = key.split("/", 1)
            *inner, leaf = rest.split("/")
            node = trees[prefix]
            for k in inner:
                node = node.setdefault(k, {})
            node[leaf] = data[key]
    return params_from_jax(trees["patchify"], trees["update"])
