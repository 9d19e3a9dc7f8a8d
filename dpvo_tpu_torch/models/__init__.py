"""Network modules of the port (PyTorch ``nn.Module``s)."""
from .encoder import BasicEncoder, BasicEncoder4, ResidualBlock
from .blocks import GatedResidual, SoftAgg, grad_clip, grad_zero
from .update import Update, DIM
from .vonet import VONet, Patchifier, normalize_images, select_centroids

__all__ = [
    "BasicEncoder", "BasicEncoder4", "ResidualBlock",
    "GatedResidual", "SoftAgg", "grad_clip", "grad_zero",
    "Update", "DIM", "VONet", "Patchifier", "normalize_images",
    "select_centroids",
]
