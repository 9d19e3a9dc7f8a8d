"""CNN feature encoders (PyTorch).

Counterpart of ``dpvo_tpu/models/encoder.py``: ``ResidualBlock``, the
/4-resolution ``BasicEncoder4`` (conv7x7 s2 -> 2 residual blocks (32) ->
2 residual blocks (64, first stride 2) -> 1x1 conv), which the Patchifier
runs, and the /8-resolution ``BasicEncoder`` (two more blocks at 128, first
stride 2), which nothing runs but the JAX package exports.  fnet uses
instance norm, inet none.  The public layout is channels-last (N, H, W, C)
like the JAX package; inside, the NCHW view of an NHWC tensor is PyTorch's
channels_last memory format, which cuDNN runs natively.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

DIM = 32  # base width


def instance_norm(x, eps=1e-5):
    """InstanceNorm2d(affine=False) over the spatial axes of NCHW ``x``,
    statistics in fp32, result in the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=(-2, -1), keepdim=True)
    var = x32.var(dim=(-2, -1), unbiased=False, keepdim=True)
    return ((x32 - mean) / torch.sqrt(var + eps)).to(x.dtype)


def _norm(norm_fn, x):
    if norm_fn == "instance":
        return instance_norm(x)
    if norm_fn == "none":
        return x
    raise NotImplementedError(norm_fn)


class ResidualBlock(nn.Module):
    """3x3-conv residual block."""

    def __init__(self, in_planes, planes, norm_fn="instance", stride=1):
        super().__init__()
        self.norm_fn = norm_fn
        self.stride = stride
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride,
                               padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        if stride != 1:
            self.downsample = nn.Conv2d(in_planes, planes, 1, stride=stride)

    def forward(self, x):
        y = F.relu(_norm(self.norm_fn, self.conv1(x)))
        y = F.relu(_norm(self.norm_fn, self.conv2(y)))
        if self.stride != 1:
            x = _norm(self.norm_fn, self.downsample(x))
        return F.relu(x + y)


class BasicEncoder4(nn.Module):
    """/4-resolution encoder: (N, H, W, 3) -> (N, H/4, W/4, output_dim)."""

    def __init__(self, output_dim=128, norm_fn="instance"):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(3, DIM, 7, stride=2, padding=3)
        self.layer1_0 = ResidualBlock(DIM, DIM, norm_fn, 1)
        self.layer1_1 = ResidualBlock(DIM, DIM, norm_fn, 1)
        self.layer2_0 = ResidualBlock(DIM, 2 * DIM, norm_fn, 2)
        self.layer2_1 = ResidualBlock(2 * DIM, 2 * DIM, norm_fn, 1)
        self.conv2 = nn.Conv2d(2 * DIM, output_dim, 1)

    def forward(self, x):
        dt = self.conv1.weight.dtype
        x = x.to(dt).permute(0, 3, 1, 2)           # channels_last NCHW view
        x = F.relu(_norm(self.norm_fn, self.conv1(x)))
        x = self.layer1_0(x)
        x = self.layer1_1(x)
        x = self.layer2_0(x)
        x = self.layer2_1(x)
        return self.conv2(x).permute(0, 2, 3, 1)


class BasicEncoder(nn.Module):
    """/8-resolution encoder: (N, H, W, 3) -> (N, H/8, W/8, output_dim)."""

    def __init__(self, output_dim=128, norm_fn="instance"):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(3, DIM, 7, stride=2, padding=3)
        self.layer1_0 = ResidualBlock(DIM, DIM, norm_fn, 1)
        self.layer1_1 = ResidualBlock(DIM, DIM, norm_fn, 1)
        self.layer2_0 = ResidualBlock(DIM, 2 * DIM, norm_fn, 2)
        self.layer2_1 = ResidualBlock(2 * DIM, 2 * DIM, norm_fn, 1)
        self.layer3_0 = ResidualBlock(2 * DIM, 4 * DIM, norm_fn, 2)
        self.layer3_1 = ResidualBlock(4 * DIM, 4 * DIM, norm_fn, 1)
        self.conv2 = nn.Conv2d(4 * DIM, output_dim, 1)

    def forward(self, x):
        dt = self.conv1.weight.dtype
        x = x.to(dt).permute(0, 3, 1, 2)           # channels_last NCHW view
        x = F.relu(_norm(self.norm_fn, self.conv1(x)))
        for layer in (self.layer1_0, self.layer1_1, self.layer2_0,
                      self.layer2_1, self.layer3_0, self.layer3_1):
            x = layer(x)
        return self.conv2(x).permute(0, 2, 3, 1)
