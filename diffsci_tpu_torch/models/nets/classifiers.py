"""A minimal ResNet classifier, 1D/2D/3D, on the NC* layout.

Port of ``diffsci_tpu/models/nets/classifiers.py``: ``ClassifierResBlock``
and ``MinimalResNet``. Module names are the torch reference's
(``in_conv``, ``res_blocks.{i}`` with ``norm1``, ``conv1``, ``norm2``,
``conv2``, ``out``), so its state dicts load with
``load_state_dict(strict=True)``. The GroupNorms take flax's eps, 1e-6,
as the JAX package's do.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.utils import resolve_device

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}


class ClassifierResBlock(nn.Module):
    """x + conv2(SiLU(norm2(conv1(SiLU(norm1(x)))))), with the largest
    group count ≤ ``num_groups`` that divides ``channels``."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 num_groups: int = 8, dimension: int = 2):
        super().__init__()
        g = min(num_groups, channels)
        while channels % g:
            g -= 1
        conv = _CONV[dimension]
        self.norm1 = nn.GroupNorm(g, channels, eps=1e-6)
        self.conv1 = conv(channels, channels, kernel_size,
                          padding=kernel_size // 2)
        self.norm2 = nn.GroupNorm(g, channels, eps=1e-6)
        self.conv2 = conv(channels, channels, kernel_size,
                          padding=kernel_size // 2)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        return x + self.conv2(F.silu(self.norm2(h)))


class MinimalResNet(nn.Module):
    """conv-in -> ``n_layers`` residual blocks -> global mean pool ->
    linear head; ``features`` is the pooled trunk. Built on ``device``
    (default: the CUDA card)."""

    def __init__(self, in_channels: int = 1, out_classes: int = 1,
                 model_channels: int = 32, n_layers: int = 8,
                 dimension: int = 2, kernel_size: int = 3,
                 num_groups: int = 8,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        self.in_conv = _CONV[dimension](in_channels, model_channels,
                                        kernel_size,
                                        padding=kernel_size // 2)
        self.res_blocks = nn.ModuleList([
            ClassifierResBlock(model_channels, kernel_size, num_groups,
                               dimension) for _ in range(n_layers)])
        self.out = nn.Linear(model_channels, out_classes)
        self.to(device)

    def features(self, x):
        h = self.in_conv(x)
        for block in self.res_blocks:
            h = block(h)
        return h.mean(dim=tuple(range(2, h.ndim)))

    def forward(self, x):
        return self.out(self.features(x))


__all__ = ["ClassifierResBlock", "MinimalResNet"]
