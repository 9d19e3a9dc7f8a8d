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
(``dpvo_tpu/utils/checkpoint.py`` ``save_network``), with numpy alone, and
the reference's trained VONet ``.pth`` (``load_torch_network``: torch
layouts already, so ``convert_state_dict`` only renames);
``save_network`` writes that layout (``state_dict_to_flax``, the inverse of
``flax_to_state_dict``), so the JAX package reads the port's checkpoints.

``save_train_state`` / ``load_train_state`` keep a whole training state
(parameters, the optimizer's moments and count, the step) in an ``.npz`` of
the port's own, keyed by parameter name.
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


def state_dict_to_flax(sd) -> dict:
    """A module state dict -> its flax param tree ({"params": ...}) of
    numpy arrays: Linear ``weight`` -> Dense ``kernel`` (in, out), Conv2d
    OIHW -> HWIO, LayerNorm ``weight`` -> ``scale``.  LayerNorm is told
    apart from a bias-free layer by its 1-D weight."""
    tree = {}
    for name, v in sd.items():
        a = v.detach().float().cpu().numpy()
        *mod, leaf = name.split(".")
        if leaf == "weight":
            if a.ndim == 4:
                a, leaf = a.transpose(2, 3, 1, 0), "kernel"
            elif a.ndim == 2:
                a, leaf = a.T, "kernel"
            else:
                leaf = "scale"
        elif leaf != "bias":
            raise ValueError(f"unexpected state dict entry {name}")
        node = tree
        for k in mod:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": tree}


def params_from_jax(p_params, u_params):
    """(Patchifier state dict, Update state dict) from the JAX package's
    (params_patchify, params_update) flax trees."""
    return flax_to_state_dict(p_params), flax_to_state_dict(u_params)


def load_network(path):
    """(Patchifier state dict, Update state dict) from a checkpoint file:
    the reference's ``.pth``/``.pt`` (``load_torch_network``), or the JAX
    package's ``.npz``, its flattened keys split at each ``/`` into flax
    trees."""
    if str(path).endswith((".pth", ".pt")):
        return load_torch_network(path)
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


def load_torch_network(path):
    """(Patchifier state dict, Update state dict or None) from the
    reference's VONet ``.pth`` (e.g. the trained ``dpvo.pth``)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    return convert_state_dict(raw)


# reference VONet name (after ``module.`` is stripped) -> the port's, for
# the submodules whose names differ (net.py's nn.Sequential indices)
_ENCODER_NAMES = {f"layer{i}.{b}.": f"layer{i}_{b}."
                  for i in (1, 2) for b in (0, 1)}
_UPDATE_NAMES = {
    "corr.0.": "corr1.", "corr.2.": "corr2.", "corr.3.": "corr_norm.",
    "corr.5.": "corr3.", "c1.0.": "c1_0.", "c1.2.": "c1_1.",
    "c2.0.": "c2_0.", "c2.2.": "c2_1.", "gru.0.": "gru_norm1.",
    "gru.1.gate.0.": "gru_res1.gate.", "gru.1.res.0.": "gru_res1.res1.",
    "gru.1.res.2.": "gru_res1.res2.", "gru.2.": "gru_norm2.",
    "gru.3.gate.0.": "gru_res2.gate.", "gru.3.res.0.": "gru_res2.res1.",
    "gru.3.res.2.": "gru_res2.res2.", "d.1.": "d.", "w.1.": "w.",
    "norm.": "norm.", "agg_kk.": "agg_kk.", "agg_ij.": "agg_ij.",
}


def _rename(name, table):
    for old, new in table.items():
        if name.startswith(old):
            return new + name[len(old):]
    raise KeyError(f"unexpected reference VONet entry {name!r}")


def convert_state_dict(raw):
    """A reference VONet state dict (name -> tensor or array) ->
    (Patchifier state dict or None, Update state dict or None).

    Strips ``module.`` (DataParallel) and drops the legacy
    ``update.lmbda``, as the reference's loader does; the rest is a
    rename onto the port's submodules.  Convs are OIHW and linears
    (out, in) on both sides, so every tensor is copied as fp32 unchanged.
    ``patchify.*.downsample.0`` becomes ``downsample``; the norms are
    parameter-free, so only convs carry encoder weights."""
    p_sd, u_sd = {}, {}
    for key, v in raw.items():
        key = key.replace("module.", "")
        if "update.lmbda" in key:
            continue
        v = (v.detach().to("cpu", torch.float32).clone() if torch.is_tensor(v)
             else torch.tensor(np.asarray(v, np.float32)))
        prefix, _, name = key.partition(".")
        if prefix == "patchify":
            enc, _, rest = name.partition(".")
            rest = rest.replace("downsample.0.", "downsample.")
            if rest.startswith("layer"):
                rest = _rename(rest, _ENCODER_NAMES)
            p_sd[f"{enc}.{rest}"] = v
        elif prefix == "update":
            u_sd[_rename(name, _UPDATE_NAMES)] = v
        else:
            raise KeyError(f"unexpected reference VONet entry {key!r}")
    return p_sd or None, u_sd or None


def save_network(path, patchifier, update_mod):
    """Write the two modules' weights as the JAX package's ``.npz``
    (``patchify/params/...`` and ``update/params/...`` keys)."""
    flat = {}
    for prefix, module in (("patchify", patchifier), ("update", update_mod)):
        for key, a in _flatten(state_dict_to_flax(module.state_dict())):
            flat["/".join((prefix,) + key)] = a
    np.savez(path, **flat)


def save_train_state(path, state):
    """Parameters, the optimizer's moments and count, and the step of a
    ``parallel.train_step.TrainState``, keyed by parameter name."""
    names = [f"{prefix}.{n}" for prefix, m in state.modules().items()
             for n, _ in m.named_parameters()]
    opt = state.opt.state_dict()
    flat = {"step": np.int64(state.step), "count": np.int64(opt["count"])}
    for prefix, m in state.modules().items():
        for n, p in m.named_parameters():
            flat[f"param/{prefix}.{n}"] = p.detach().cpu().numpy()
    for n, mu, nu in zip(names, opt["mu"], opt["nu"]):
        flat[f"mu/{n}"] = mu.cpu().numpy()
        flat[f"nu/{n}"] = nu.cpu().numpy()
    np.savez(path, **flat)


@torch.no_grad()
def load_train_state(path, state):
    """Restore what ``save_train_state`` wrote into ``state`` (built as for
    a fresh run: the same modules and optimizer) on its device; raises when
    the parameter names differ.  Returns the state."""
    with np.load(path) as data:
        names = [f"{prefix}.{n}" for prefix, m in state.modules().items()
                 for n, _ in m.named_parameters()]
        saved = sorted(k[6:] for k in data.files if k.startswith("param/"))
        if saved != sorted(names):
            raise ValueError(f"{path}: parameters differ from the model's")
        params = [p for m in state.modules().values()
                  for p in m.parameters()]
        for n, p in zip(names, params):
            p.copy_(torch.from_numpy(data[f"param/{n}"]))
        dev = params[0].device
        state.opt.load_state_dict({
            "mu": [torch.from_numpy(data[f"mu/{n}"]).to(dev) for n in names],
            "nu": [torch.from_numpy(data[f"nu/{n}"]).to(dev) for n in names],
            "count": int(data["count"])})
        state.step = int(data["step"])
    return state
