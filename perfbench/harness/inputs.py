"""What a run feeds both sides, made from ``--seed``: the weights and the
frames.

The weights are drawn on the device in one call, as PyTorch draws a fresh
layer's (uniform within 1/sqrt(fan in), layer norms one and zero), in the
type they are served in.  The frames are a seeded uint8 image twice the
frame's width, rolled ``roll_px`` pixels a frame; ``FrameFeed`` copies frame
t, a view of that image tiled to three widths, into one of two pinned host
buffers and uploads it one frame ahead of its use.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference.model import param_shapes


def make_weights(seed, device, dtype):
    """-> {name: tensor} keyed as the program's state dicts."""
    shapes = param_shapes()
    sizes = [int(np.prod(s)) for s in shapes.values()]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        if "norm" in name.split(".")[0]:
            part = (torch.ones_like(part) if name.endswith("weight")
                    else torch.zeros_like(part))
        else:
            w_shape = shapes[name.rsplit(".", 1)[0] + ".weight"]
            part = part / float(np.prod(w_shape[1:])) ** 0.5
        out[name] = part.reshape(shape).to(dtype)
    return out


def split_weights(weights):
    """-> (patchifier state dict, update state dict)."""
    patch = {k: v for k, v in weights.items() if k[:5] in ("fnet.", "inet.")}
    return patch, {k: v for k, v in weights.items() if k not in patch}


class Frames:
    """Frame t of the rolling sequence (H, W, 3) uint8: the seeded image
    rolled left ``roll_px * t`` pixels, cut to the frame's width."""

    def __init__(self, seed, ht, wd, roll_px):
        self.wd, self.roll = wd, roll_px
        base = np.random.default_rng(seed).integers(
            0, 255, size=(ht, 2 * wd, 3), dtype=np.uint8)
        self.tiled = np.concatenate([base, base[:, :wd]], axis=1)

    def host(self, t):
        """Frame t as a view (no copy)."""
        off = self.roll * t % (2 * self.wd)
        return self.tiled[:, off:off + self.wd]

    def device(self, t, device):
        return torch.from_numpy(np.ascontiguousarray(self.host(t))).to(device)


class FrameFeed:
    """Frames on the device one frame ahead of use: each copied into one of
    two pinned host buffers and sent with ``non_blocking``; a buffer is
    refilled only after its last copy's event."""

    def __init__(self, frames: Frames, device):
        self.frames, self.device = frames, device
        self.cuda = device.type == "cuda"
        if self.cuda:
            shape = frames.host(0).shape
            self.host = [torch.empty(shape, dtype=torch.uint8,
                                     pin_memory=True) for _ in range(2)]
            self.host_np = [h.numpy() for h in self.host]
            self.done = [None, None]
        self.next = None

    def _send(self, t):
        if not self.cuda:
            return torch.from_numpy(np.ascontiguousarray(self.frames.host(t)))
        i = t % 2
        if self.done[i] is not None:
            self.done[i].synchronize()
        np.copyto(self.host_np[i], self.frames.host(t))
        img = self.host[i].to(self.device, non_blocking=True)
        self.done[i] = torch.cuda.Event()
        self.done[i].record()
        return img

    def get(self, t):
        """Frame t, and frame t + 1 sent."""
        img = self.next if self.next is not None else self._send(t)
        self.next = self._send(t + 1)
        return img
