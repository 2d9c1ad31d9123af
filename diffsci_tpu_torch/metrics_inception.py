"""The pytorch-fid InceptionV3 (pool3, 2048-d features) for FID.

Port of ``diffsci_tpu/metrics_inception.py``. The reference's headline
quality numbers are Inception-FID scores (via pytorch-fid /
torchmetrics). This module provides:

- ``InceptionV3FID``: pytorch-fid's InceptionV3 up to pool3, NCHW, with
  pytorch-fid's (torchvision's) module and parameter names, so that a
  pytorch-fid ``state_dict`` loads by name; including pytorch-fid's
  deviations from stock torchvision (average pools inside the Inception
  blocks that do not count padding, and a max-pool branch in the final
  InceptionE block).
- ``load_weights``: the ``pt_inception-2015-12-05`` file into the net (the
  ``fc.*`` head dropped).
- ``inception_fid_features``: resize to 299x299 (bilinear, antialias off,
  as pytorch-fid resizes), scale to [-1, 1], run the net.

The weights file is not in the repository and cannot be downloaded here,
so the tests and the smoke run use synthetic weights (``init(seed)``, the
distributions flax's defaults draw); with the file, ``load_weights`` makes
the features comparable with the reference's FID pipeline.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.utils import resolve_device


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm (eps 1e-3, running statistics) + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_nip(x):
    """3x3 average pool, stride 1, padding 1, dividing by the number of
    valid elements under the window (pytorch-fid's count_include_pad=False
    patch)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x):
    """3x3 max pool, stride 2, no padding (VALID)."""
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nip(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_nip(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    """``pool``: "avg" (pytorch-fid's Mixed_7b) or "max" (Mixed_7c: a 3x3
    max pool, stride 1, over -inf padding)."""

    def __init__(self, in_channels: int, pool: str = "avg"):
        super().__init__()
        if pool not in ("avg", "max"):
            raise ValueError(f"pool must be 'avg' or 'max', got {pool!r}")
        self.pool = pool
        self.branch1x1 = BasicConv2d(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        if self.pool == "max":
            # max_pool2d pads with -inf
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool_nip(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3FID(nn.Module):
    """pytorch-fid's InceptionV3 up to pool3: x [B, 3, 299, 299] in
    [-1, 1] -> [B, 2048]. Built on ``device`` (default: the CUDA card)
    with torch's default weights; ``init(seed)`` draws flax's defaults,
    ``load_weights`` loads pytorch-fid's file."""

    def __init__(self, device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool="avg")
        self.Mixed_7c = InceptionE(2048, pool="max")
        self.eval()
        self.to(device)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))    # global average pool -> [B, 2048]

    @torch.no_grad()
    def init(self, seed: int = 0) -> "InceptionV3FID":
        """Synthetic weights with the JAX net's scale: every convolution
        kernel lecun-normal (a normal of variance 1/fan_in truncated at two
        standard deviations, flax's default), BatchNorm scale 1 and bias
        0, running mean 0 and variance 1. Drawn on the CPU from ``seed``,
        so one seed gives the same weights on every device."""
        generator = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                # flax's truncated normal: unit variance after truncation
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                m.weight.copy_(w * std)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        return self


def load_weights(path: str, device=None) -> InceptionV3FID:
    """An ``InceptionV3FID`` holding a pytorch-fid / torchvision checkpoint
    file's weights (``torch.load(weights_only=True)``; the ``fc.*``
    classifier head, unused for FID features, is dropped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    net = InceptionV3FID(device=device)
    net.load_state_dict(sd, strict=True)
    return net


@torch.no_grad()
def inception_fid_features(net: InceptionV3FID, x,
                           batch_size: int = 64) -> np.ndarray:
    """x: [N, H, W, C] in [0, 1] (numpy or a tensor; C = 1 is repeated to
    RGB). Returns the [N, 2048] pool3 features as float32 numpy, each
    batch resized to 299x299 like pytorch-fid (bilinear,
    ``align_corners=False``, no antialiasing, also when minifying), scaled
    to [-1, 1] and run on the net's device."""
    device = next(net.parameters()).device
    outs = []
    for i in range(0, x.shape[0], batch_size):
        xb = torch.as_tensor(x[i:i + batch_size], dtype=torch.float32,
                             device=device).movedim(-1, 1)
        if xb.shape[1] == 1:
            xb = xb.expand(-1, 3, -1, -1)
        xb = F.interpolate(xb, size=(299, 299), mode="bilinear",
                           align_corners=False, antialias=False)
        outs.append(net(xb * 2.0 - 1.0).cpu().numpy())
    return np.concatenate(outs, axis=0)


__all__ = ["BasicConv2d", "InceptionA", "InceptionB", "InceptionC",
           "InceptionD", "InceptionE", "InceptionV3FID",
           "inception_fid_features", "load_weights"]
