"""Common network layers on the NC* layout ([B, C, *spatial]).

Port of the parts of ``diffsci_tpu/models/nets/layers.py`` that PUNetG's
serving path runs: ``conv_layer`` ('default'), ``DownSampler``,
``UpSampler``, ``GaussianFourierProjection``, ``GroupLNorm``/
``GroupRMSNorm`` with ``fuse_silu``, ``ResnetTimeBlock`` and
``ResnetBlockC``. Module and parameter names are the original torch
reference's (``gnorm1.weight``, ``timeblock.net.0.weight``, ...), so its
state dicts load with ``load_state_dict(strict=True)``.

Every layer takes the number of spatial dims at construction
(``dimension``), since torch convolutions are rank-specific.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.kernels import fused_norm

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@torch.no_grad()
def init_parameters(module: nn.Module, seed: int) -> None:
    """Re-draw every parameter and random buffer of ``module`` from
    ``seed``. The draws are made on the CPU and copied, so one seed gives
    the same weights on every device. Convolutions and dense layers take
    uniform(±1/√fan_in) (PyTorch's default bound), torch's GroupNorm and
    LayerNorm ones and zeros (the JAX package's norm init); the port's own
    layers their ``reset_parameters(generator)``."""
    generator = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for p in (m.weight, m.bias):
                if p is not None:
                    p.copy_((torch.rand(p.shape, generator=generator) * 2
                             - 1) * bound)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            # their reset_parameters() takes no generator
            if m.weight is not None:
                nn.init.ones_(m.weight)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
        elif any(True for _ in m.parameters(recurse=False)):
            raise TypeError(f"no initialization rule for {type(m).__name__}")


def conv_layer(convolution_type: str, dimension: int, in_channels: int,
               out_channels: int, kernel_size: int, use_bias: bool = True):
    """A stride-1 convolution with 'SAME' padding."""
    if convolution_type != "default":
        raise NotImplementedError(
            f"convolution_type {convolution_type!r} is not ported yet")
    if kernel_size % 2 != 1:
        raise ValueError(f"'SAME' padding needs an odd kernel size, got "
                         f"{kernel_size}")
    return _CONV[dimension](in_channels, out_channels, kernel_size,
                            padding=kernel_size // 2, bias=use_bias)


class DownSampler(nn.Module):
    """MaxPool(scale) then conv."""

    def __init__(self, dimension: int, in_channels: int, out_channels: int,
                 scale_factor: int = 2, kernel_size: int = 3,
                 use_bias: bool = True, convolution_type: str = "default"):
        super().__init__()
        self.dimension = dimension
        self.scale_factor = scale_factor
        self.conv = conv_layer(convolution_type, dimension, in_channels,
                               out_channels, kernel_size, use_bias)

    def forward(self, x):
        s = self.scale_factor
        return self.conv(_MAX_POOL[self.dimension](x, s, s))


class UpSampler(nn.Module):
    """Nearest upsample then conv."""

    def __init__(self, dimension: int, in_channels: int, out_channels: int,
                 scale_factor: int = 2, kernel_size: int = 3,
                 use_bias: bool = True, convolution_type: str = "default"):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv = conv_layer(convolution_type, dimension, in_channels,
                               out_channels, kernel_size, use_bias)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=self.scale_factor,
                                       mode="nearest"))


class GaussianFourierProjection(nn.Module):
    """sin/cos random-feature time embedding; ``W`` is a buffer."""

    def __init__(self, embed_dim: int, scale: float = 30.0):
        super().__init__()
        self.scale = scale
        self.register_buffer("W", torch.empty(embed_dim // 2))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.W.copy_(torch.randn(self.W.shape, generator=generator)
                     * self.scale)

    def forward(self, x):
        xp = 2 * math.pi * x[..., None] * self.W
        return torch.cat([torch.sin(xp), torch.cos(xp)], dim=-1)


class _GroupNormBase(nn.Module):
    """Group normalization over (C // G, *spatial) on [B, C, *spatial].

    With ``fuse_silu`` SiLU follows the norm; when, in addition,
    G == C and the norm is affine (PUNetG's configuration) the pair is
    kernel K2 (``kernels/fused_norm.py``). The other cases take the plain
    path of the JAX package's layer: the shifted one-pass variance for
    'ln'."""
    subtract_mean = False

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 affine: bool = True, fuse_silu: bool = False):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels do not split into "
                             f"{num_groups} groups")
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.affine = affine
        self.fuse_silu = fuse_silu
        if affine:
            self.weight = nn.Parameter(torch.ones(num_channels))
            self.bias = nn.Parameter(torch.zeros(num_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.affine:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x):
        if self.fuse_silu and self.affine and \
                self.num_groups == self.num_channels:
            kind = "ln" if self.subtract_mean else "rms"
            return fused_norm.norm_silu(x.contiguous(), self.weight,
                                        self.bias, kind, self.eps)
        B, C = x.shape[:2]
        sp = tuple(x.shape[2:])
        G = self.num_groups
        xg = x.reshape((B, G, C // G) + sp)
        dims = tuple(range(2, xg.ndim))
        if self.subtract_mean:
            if sp and sp[0] >= 2:
                # shifted one-pass variance, shifted by the mean of the
                # first spatial row (see the JAX layer for the bound)
                m0 = xg[:, :, :, :1].mean(dim=dims, keepdim=True)
                xs = xg - m0
                mean_s = xs.mean(dim=dims, keepdim=True)
                var = (xs * xs).mean(dim=dims, keepdim=True) - mean_s ** 2
                xg = (xs - mean_s) / torch.sqrt(var.clamp_min(0.0) + self.eps)
            else:
                xc = xg - xg.mean(dim=dims, keepdim=True)
                var = (xc * xc).mean(dim=dims, keepdim=True)
                xg = xc / torch.sqrt(var + self.eps)
        else:
            ms = (xg * xg).mean(dim=dims, keepdim=True)
            xg = xg / torch.sqrt(ms + self.eps)
        x = xg.reshape((B, C) + sp)
        if self.affine:
            shape = (1, C) + (1,) * len(sp)
            x = x * self.weight.view(shape) + self.bias.view(shape)
        if self.fuse_silu:
            x = F.silu(x)
        return x


class GroupRMSNorm(_GroupNormBase):
    """RMS over (C // G, *spatial)."""
    subtract_mean = False


class GroupLNorm(_GroupNormBase):
    """Mean-subtracted norm over (C // G, *spatial): torch GroupNorm."""
    subtract_mean = True


def make_norm(kind: str, num_groups: int, num_channels: int,
              affine: bool = True, fuse_silu: bool = False):
    if kind == "GroupLN":
        return GroupLNorm(num_groups, num_channels, affine=affine,
                          fuse_silu=fuse_silu)
    if kind == "GroupRMS":
        return GroupRMSNorm(num_groups, num_channels, affine=affine,
                            fuse_silu=fuse_silu)
    raise NotImplementedError(f"norm {kind!r} is not ported yet")


class ResnetTimeBlock(nn.Module):
    """Time-embedding MLP embed -> 4x -> 4x -> out with SiLU, on [B, E]
    inputs, broadcast over space."""

    def __init__(self, embed_channels: int, output_channels: int):
        super().__init__()
        hidden = 4 * embed_channels
        self.net = nn.Sequential(
            nn.Linear(embed_channels, hidden), nn.SiLU(),
            nn.Linear(hidden, hidden), nn.SiLU(),
            nn.Linear(hidden, output_channels))

    def forward(self, te, spatial_ndim: int):
        h = self.net(te)
        return h.reshape(tuple(h.shape) + (1,) * spatial_ndim)


class ResnetBlockC(nn.Module):
    """norm -> SiLU -> conv, + time bias, norm -> SiLU -> dropout -> conv,
    + skip. Both norms have one group per channel."""

    def __init__(self, dimension: int, channels: int,
                 time_embed_dim: int | None, kernel_size: int = 3,
                 dropout: float = 0.0, first_norm: str = "GroupLN",
                 second_norm: str = "GroupRMS", affine_norm: bool = True,
                 convolution_type: str = "default", use_bias: bool = True):
        super().__init__()
        self.gnorm1 = make_norm(first_norm, channels, channels, affine_norm,
                                fuse_silu=True)
        self.conv1 = conv_layer(convolution_type, dimension, channels,
                                channels, kernel_size, use_bias)
        self.timeblock = (ResnetTimeBlock(time_embed_dim, channels)
                          if time_embed_dim is not None else None)
        self.gnorm2 = make_norm(second_norm, channels, channels, affine_norm,
                                fuse_silu=True)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = conv_layer(convolution_type, dimension, channels,
                                channels, kernel_size, use_bias)

    def forward(self, x, te=None):
        h = self.conv1(self.gnorm1(x))
        if self.timeblock is not None:
            h = h + self.timeblock(te, x.ndim - 2)
        h = self.conv2(self.dropout(self.gnorm2(h)))
        return h + x
