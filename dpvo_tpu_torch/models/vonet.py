"""Patchifier, centroid selection and the flax-like initialisers (PyTorch).

Counterpart of ``dpvo_tpu/models/vonet.py``: the two CNN encoders and the
patch extraction at sampled centroids, and ``VONet``, the Patchifier and
the Update operator in one module.  Layouts are channels-last like the
JAX package.  ``init_flax_like`` draws a module's weights as flax
initialises the JAX package's (``lecun_normal`` kernels, zero biases,
LayerNorm ones and zeros), so a from-scratch training run starts from the
same distribution.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import corr as corr_ops
from .encoder import BasicEncoder4
from .update import DIM, CorrDense, Update


def normalize_images(images_u8):
    """uint8 (..., H, W, 3) -> 2 * (x / 255) - 0.5, channel order kept."""
    return 2.0 * (images_u8.float() / 255.0) - 0.5


def image_gradient(images):
    """Intensity gradient for GRADIENT_BIAS centroid selection.
    images (N, H, W, 3) normalized -> (N, H/4, W/4)."""
    gray = ((images + 0.5) * (255.0 / 2)).sum(dim=-1)
    dx = gray[..., :-1, 1:] - gray[..., :-1, :-1]
    dy = gray[..., 1:, :-1] - gray[..., :-1, :-1]
    g = F.pad(torch.sqrt(dx ** 2 + dy ** 2), (0, 1, 0, 1))
    N, H, W = g.shape
    return g.reshape(N, H // 4, 4, W // 4, 4).mean(dim=(2, 4))


class Patchifier(nn.Module):
    """Feature extraction + patch sampling."""

    def __init__(self, patch_size=3):
        super().__init__()
        self.patch_size = patch_size
        self.fnet = BasicEncoder4(output_dim=128, norm_fn="instance")
        self.inet = BasicEncoder4(output_dim=DIM, norm_fn="none")

    def encode(self, images):
        """(N, H, W, 3) normalized -> fmap (N, h, w, 128), imap
        (N, h, w, DIM), /4 resolution, scaled by 1/4."""
        return self.fnet(images) / 4.0, self.inet(images) / 4.0

    def forward(self, images, coords, disps=None):
        """images (N, H, W, 3) normalized; coords (N, M, 2) feature-res
        centroids.  Returns (fmap, gmap (N, M, P, P, 128), imap_p (N, M, DIM),
        patches (N, M, 3, P, P) [x, y, d], index (N*M,), clr (N, M, 3))."""
        N = images.shape[0]
        P = self.patch_size
        M = coords.shape[1]
        fmap, imap = self.encode(images)
        h, w = fmap.shape[1:3]

        imap_p = corr_ops.patchify(imap, coords, 0)[:, :, 0, 0, :]
        gmap = corr_ops.patchify(fmap, coords, P // 2)
        clr = corr_ops.patchify(images, 4 * (coords + 0.5), 0)[:, :, 0, 0, :]

        dev = images.device
        if disps is None:
            disps = torch.ones((N, h, w), device=dev)
        y, x = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                              torch.arange(w, device=dev, dtype=torch.float32),
                              indexing="ij")
        grid = torch.stack([x.expand(disps.shape), y.expand(disps.shape),
                            disps.float()], dim=-1)
        patches = corr_ops.patchify(grid, coords, P // 2)  # (N, M, P, P, 3)
        patches = patches.permute(0, 1, 4, 2, 3)

        index = torch.arange(N, device=dev).repeat_interleave(M)
        return fmap, gmap, imap_p, patches, index, clr


def select_centroids(gen, strat, n, h, w, M, gradient=None):
    """Patch centroid sampling -> (n, M, 2) float [x, y] at feature res.
    ``gen`` is the torch.Generator on the target device."""
    dev = gen.device
    if strat == "RANDOM":
        x = torch.randint(1, w - 1, (n, M), generator=gen, device=dev)
        y = torch.randint(1, h - 1, (n, M), generator=gen, device=dev)
    elif strat == "GRADIENT_BIAS":
        if gradient is None:
            raise ValueError("GRADIENT_BIAS needs the image gradient")
        x = torch.randint(1, w - 1, (n, 3 * M), generator=gen, device=dev)
        y = torch.randint(1, h - 1, (n, 3 * M), generator=gen, device=dev)
        coords = torch.stack([x, y], dim=-1).float()
        g = corr_ops.patchify(gradient[..., None], coords, 0)[:, :, 0, 0, 0]
        ix = torch.argsort(g, dim=1, stable=True)[:, -M:]
        x = torch.take_along_dim(x, ix, dim=1)
        y = torch.take_along_dim(y, ix, dim=1)
    else:
        raise NotImplementedError(
            f"Patch centroid selection not implemented: {strat}")
    return torch.stack([x, y], dim=-1).float()


class VONet(nn.Module):
    """The Patchifier and the Update operator in one module, under the JAX
    VONet's names (``patchify``, ``update``), so its parameter tree loads
    whole (``utils.checkpoint.flax_to_state_dict``)."""

    def __init__(self, patch_size=3):
        super().__init__()
        self.P = patch_size
        self.RES = 4
        self.patchify = Patchifier(patch_size)
        self.update = Update(patch_size)

    def forward(self, images, coords, net, inp, corr, ii, jj, kk,
                valid=None):
        """Both submodules once, as the JAX ``__call__`` wires them: ->
        (the Patchifier's outputs, the Update's)."""
        return (self.patchify(images, coords),
                self.update(net, inp, corr, ii, jj, kk, valid))


@torch.no_grad()
def init_flax_like(module: nn.Module, gen: torch.Generator):
    """Re-draw every weight of ``module`` in place from ``gen`` (on the
    module's device) as flax's defaults would: Linear, Conv2d and CorrDense
    kernels ``lecun_normal`` (a normal of std sqrt(1 / fan_in) / .8796
    truncated at two of its stds), biases zero, LayerNorm scale one and
    bias zero.  Returns the module."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, CorrDense)):
            fan_in = m.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return module
