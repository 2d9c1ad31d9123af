"""Common network layers on the NC* layout ([B, C, *spatial]).

Port of ``diffsci_tpu/models/nets/layers.py``: ``conv_layer`` ('default',
'circular' with ``circular_dims``, 'mp'), ``CircularConv``,
``DownSampler``, ``UpSampler``, ``CornerPool``, the Fourier projections
(``GaussianFourierProjection``, ``...Vector``,
``ConvolutionalFourierProjection``), the group norms (``GroupLNorm``,
``GroupRMSNorm``, ``GroupPixNorm``, the identity) with ``fuse_silu``,
``ResnetTimeBlock`` (plain or magnitude-preserving), ``ResnetBlockC``,
``BatchDropout``, ``ConditionDrop`` and ``SwiGLU``, and ``linear_resize``
(``jax.image.resize``'s 'linear'). Module and parameter
names are the original torch reference's (``gnorm1.weight``,
``timeblock.net.0.weight``, ...), so its state dicts load with
``load_state_dict(strict=True)``.

Every layer takes the number of spatial dims at construction
(``dimension``), since torch convolutions are rank-specific. A
spatially-varying time embedding is [B, E, *spatial] here (the JAX
package's is channels-last).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.kernels import fused_norm
from diffsci_tpu_torch.models.nets.normed import _CONV as _CONV_FN
from diffsci_tpu_torch.models.nets.normed import (MagnitudePreservingConv,
                                                  MagnitudePreservingDense)
from diffsci_tpu_torch.utils import unset

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@torch.no_grad()
def init_parameters(module: nn.Module, seed: int) -> None:
    """Re-draw every parameter and random buffer of ``module`` from
    ``seed``. The draws are made on the CPU and copied, so one seed gives
    the same weights on every device. Convolutions (transposed too) and
    dense layers take uniform(±1/√fan_in) (PyTorch's default bound),
    torch's GroupNorm, LayerNorm, RMSNorm and BatchNorm ones and zeros (the
    JAX package's norm init), an ``nn.Embedding`` (flax's ``nn.Embed``, a
    class embedding) torch's N(0, 1); the port's own layers their
    ``reset_parameters(generator)``."""
    generator = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear,
                          nn.ConvTranspose1d, nn.ConvTranspose2d,
                          nn.ConvTranspose3d)):
            uniform_fan_in_(m, generator)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm, nn.RMSNorm)):
            # their reset_parameters() takes no generator
            if m.weight is not None:
                nn.init.ones_(m.weight)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
        elif hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
        elif any(True for _ in m.parameters(recurse=False)):
            raise TypeError(f"no initialization rule for {type(m).__name__}")


def uniform_fan_in_(m: nn.Module, generator: torch.Generator) -> None:
    """``m.weight`` and ``m.bias`` from uniform(±1/√fan_in)."""
    bound = 1.0 / math.sqrt(m.weight[0].numel())
    for p in (m.weight, m.bias):
        if p is not None:
            p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1)
                    * bound)


def holder(**children) -> nn.Module:
    """A module that only holds ``children`` under their names, so that a
    torch reference's nesting (``encoder.layers.0.input_blocks.1``) keeps
    its state-dict keys."""
    module = nn.Module()
    for name, child in children.items():
        setattr(module, name, child)
    return module


def conv_layer(convolution_type: str, dimension: int, in_channels: int,
               out_channels: int, kernel_size: int, use_bias: bool = True,
               circular_dims=None):
    """A stride-1 convolution with 'SAME' padding: 'default' (zeros),
    'circular' (periodic on ``circular_dims``, None = every spatial dim)
    or 'mp' (magnitude preserving)."""
    if kernel_size % 2 != 1:
        raise ValueError(f"'SAME' padding needs an odd kernel size, got "
                         f"{kernel_size}")
    if convolution_type == "default":
        return _CONV[dimension](in_channels, out_channels, kernel_size,
                                padding=kernel_size // 2, bias=use_bias)
    if convolution_type == "circular":
        return CircularConv(dimension, in_channels, out_channels,
                            kernel_size, use_bias, circular_dims)
    if convolution_type == "mp":
        return MagnitudePreservingConv(dimension, in_channels, out_channels,
                                       kernel_size, use_bias)
    raise ValueError(f"Invalid convolution type: {convolution_type}")


def linear_resize(x, size):
    """[B, C, *spatial] resized to ``size`` as ``jax.image.resize(...,
    method='linear')`` does: a triangle filter per axis on half-pixel
    centres, widened by the inverse scale when downsampling (antialias),
    its weights renormalized at the borders."""
    for axis, (n_in, n_out) in enumerate(zip(x.shape[2:], size)):
        if n_in == n_out:
            continue
        inv = n_in / n_out
        kernel_scale = max(inv, 1.0)
        sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
        dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[
            :, None]).abs() / kernel_scale
        w = (1.0 - dist).clamp_min(0.0)                   # [in, out]
        total = w.sum(0, keepdim=True)
        w = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                        w / torch.where(total != 0, total, 1.0), 0.0)
        inside = (sample >= -0.5) & (sample <= n_in - 0.5)
        w = torch.where(inside[None, :], w, 0.0)
        x = torch.movedim(torch.tensordot(
            x, w.to(x.dtype).to(x.device), dims=([axis + 2], [0])), -1,
            axis + 2)
    return x


class CircularConv(nn.Module):
    """Convolution with periodic padding on ``circular_dims`` (indices of
    spatial axes; None = all) and zero padding on the others. Parameters
    ``weight`` [out, in, *k] and ``bias``, as a torch convolution's."""

    def __init__(self, dimension: int, in_channels: int, out_channels: int,
                 kernel_size: int, use_bias: bool = True,
                 circular_dims=None):
        super().__init__()
        self.dimension = dimension
        self.pad = kernel_size // 2
        self.circular = (set(range(dimension)) if circular_dims is None
                         else set(circular_dims))
        self.weight = nn.Parameter(unset(
            out_channels, in_channels, *(kernel_size,) * dimension))
        self.bias = nn.Parameter(torch.zeros(out_channels)) \
            if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        uniform_fan_in_(self, generator)

    def forward(self, x):
        p = self.pad
        if self.circular == set(range(self.dimension)):
            x = F.pad(x, [p] * (2 * self.dimension), mode="circular")
        else:
            for d in range(self.dimension):
                axis = 2 + d
                if d in self.circular:
                    x = torch.cat([x.narrow(axis, x.shape[axis] - p, p), x,
                                   x.narrow(axis, 0, p)], dim=axis)
                else:
                    pads = [0] * (2 * self.dimension)
                    k = 2 * (self.dimension - 1 - d)
                    pads[k:k + 2] = [p, p]
                    x = F.pad(x, pads)
        return _CONV_FN[self.dimension](x, self.weight, self.bias)


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


class CornerPool(nn.Module):
    """Strided subsampling picking each window's corner element."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x):
        return x[(slice(None), slice(None))
                 + (slice(None, None, self.stride),) * (x.ndim - 2)]


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
        self.register_buffer("W", unset(embed_dim // 2))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.W.copy_(torch.randn(self.W.shape, generator=generator)
                     * self.scale)

    def forward(self, x):
        xp = 2 * math.pi * x[..., None] * self.W
        return torch.cat([torch.sin(xp), torch.cos(xp)], dim=-1)


class GaussianFourierProjectionVector(nn.Module):
    """Vector-input variant: x [..., input_dim] -> [..., embed_dim]."""

    def __init__(self, input_dim: int, embed_dim: int, scale: float = 30.0):
        super().__init__()
        self.scale = scale
        self.register_buffer("W", unset(input_dim, embed_dim // 2))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.W.copy_(torch.randn(self.W.shape, generator=generator)
                     * self.scale)

    def forward(self, x):
        xp = 2 * math.pi * x @ self.W
        return torch.cat([torch.sin(xp), torch.cos(xp)], dim=-1)


class ConvolutionalFourierProjection(nn.Module):
    """Per-pixel random-feature channel embedding on [B, C, *spatial]: a
    fixed random 1x1 projection (buffers ``W`` [C, E/2] and ``bias``)
    followed by sin/cos."""

    def __init__(self, input_dim: int, embed_dim: int, scale: float = 30.0,
                 use_bias: bool = True):
        super().__init__()
        self.scale = scale
        self.register_buffer("W", unset(input_dim, embed_dim // 2))
        if use_bias:
            self.register_buffer("bias", unset(embed_dim // 2))
        else:
            self.bias = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        for t in (self.W, self.bias):
            if t is not None:
                t.copy_(torch.randn(t.shape, generator=generator)
                        * self.scale)

    def forward(self, x):
        xc = torch.einsum("bc...,cd->bd...", x, 2 * math.pi * self.W)
        if self.bias is not None:
            xc = xc + self.bias.reshape((1, -1) + (1,) * (x.ndim - 2))
        return torch.cat([torch.sin(xc), torch.cos(xc)], dim=1)


class _GroupNormBase(nn.Module):
    """Group normalization over (C // G, *spatial) (``spatial``) or over
    C // G alone, per pixel, on [B, C, *spatial].

    With ``fuse_silu`` SiLU follows the norm; when, in addition, the norm
    is spatial, affine and per channel (G == C: PUNetG's configuration)
    the pair is kernel K2 (``kernels/fused_norm.py``), the JAX package's
    rule (``diffsci_tpu/kernels/fused_norm.py:276-289``). The other cases
    take the plain path of the JAX package's layer: the shifted one-pass
    variance for 'ln'."""
    subtract_mean = False
    spatial = True

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

    @property
    def fused(self) -> bool:
        """Whether the forward takes K2 (and its backward K3)."""
        return (self.fuse_silu and self.affine and self.spatial
                and self.num_groups == self.num_channels)

    def forward(self, x):
        if self.fused:
            kind = "ln" if self.subtract_mean else "rms"
            return fused_norm.norm_silu(x.contiguous(), self.weight,
                                        self.bias, kind, self.eps)
        B, C = x.shape[:2]
        sp = tuple(x.shape[2:])
        G = self.num_groups
        xg = x.reshape((B, G, C // G) + sp)
        dims = tuple(range(2, xg.ndim)) if self.spatial else (2,)
        if self.subtract_mean:
            if self.spatial and sp and sp[0] >= 2:
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


class GroupPixNorm(_GroupNormBase):
    """RMS over C // G only, per pixel."""
    subtract_mean = False
    spatial = False


_NORMS = {"GroupLN": GroupLNorm, "GroupRMS": GroupRMSNorm,
          "GroupPix": GroupPixNorm}


def make_norm(kind: str, num_groups: int, num_channels: int,
              affine: bool = True, fuse_silu: bool = False):
    """'GroupLN', 'GroupRMS', 'GroupPix'; any other name is the identity
    norm (SiLU alone under ``fuse_silu``)."""
    if kind in _NORMS:
        return _NORMS[kind](num_groups, num_channels, affine=affine,
                            fuse_silu=fuse_silu)
    return nn.SiLU() if fuse_silu else nn.Identity()


class ResnetTimeBlock(nn.Module):
    """Time-embedding MLP embed -> 4x -> 4x -> out with SiLU (dense or
    magnitude-preserving layers). On [B, E] it is broadcast over space; on
    a spatially-varying [B, E, *spatial] it runs pointwise over the
    channel axis."""

    def __init__(self, embed_channels: int, output_channels: int,
                 magnitude_preserving: bool = False):
        super().__init__()
        dense = MagnitudePreservingDense if magnitude_preserving \
            else nn.Linear
        hidden = 4 * embed_channels
        self.net = nn.Sequential(
            dense(embed_channels, hidden), nn.SiLU(),
            dense(hidden, hidden), nn.SiLU(),
            dense(hidden, output_channels))

    def forward(self, te, spatial_ndim: int):
        if te.ndim == 2:
            h = self.net(te)
            return h.reshape(tuple(h.shape) + (1,) * spatial_ndim)
        return self.net(te.movedim(1, -1)).movedim(-1, 1)


class ResnetBlockC(nn.Module):
    """norm -> SiLU -> conv, + time bias, norm -> SiLU -> dropout -> conv,
    + skip (when ``output_channels`` is None) + ``extra_residual(x)``. Both
    norms have one group per channel. A spatially-varying time embedding
    of another resolution is corner-pooled down or nearest-upsampled to
    the block's."""

    def __init__(self, dimension: int, channels: int,
                 time_embed_dim: int | None, kernel_size: int = 3,
                 dropout: float = 0.0, first_norm: str = "GroupLN",
                 second_norm: str = "GroupRMS", affine_norm: bool = True,
                 convolution_type: str = "default", use_bias: bool = True,
                 output_channels: int | None = None,
                 extra_residual: nn.Module | None = None):
        super().__init__()
        out_ch = output_channels or channels
        self.has_residual = output_channels is None
        self.gnorm1 = make_norm(first_norm, channels, channels, affine_norm,
                                fuse_silu=True)
        self.conv1 = conv_layer(convolution_type, dimension, channels,
                                out_ch, kernel_size, use_bias)
        self.timeblock = (ResnetTimeBlock(
            time_embed_dim, out_ch,
            magnitude_preserving=convolution_type == "mp")
            if time_embed_dim is not None else None)
        self.gnorm2 = make_norm(second_norm, out_ch, out_ch, affine_norm,
                                fuse_silu=True)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = conv_layer(convolution_type, dimension, out_ch,
                                out_ch, kernel_size, use_bias)
        self.extra_residual = extra_residual

    def forward(self, x, te=None):
        h = self.conv1(self.gnorm1(x))
        if self.timeblock is not None:
            h = h + self._rescale_yt(self.timeblock(te, x.ndim - 2), h)
        h = self.conv2(self.dropout(self.gnorm2(h)))
        if self.has_residual:
            h = h + x
        if self.extra_residual is not None:
            h = h + self.extra_residual(x)
        return h

    @staticmethod
    def _rescale_yt(yt, y):
        yt_dims, y_dims = tuple(yt.shape[2:]), tuple(y.shape[2:])
        if yt_dims == (1,) * len(y_dims) or yt_dims == y_dims:
            return yt
        factor = yt_dims[0] / y_dims[0]
        if factor > 1:
            return yt[(slice(None), slice(None))
                      + (slice(None, None, int(factor)),) * len(y_dims)]
        return F.interpolate(yt, scale_factor=int(1 / factor),
                             mode="nearest")


class BatchDropout(nn.Module):
    """Drop whole batch elements in training (a draw of torch's default
    generator)."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape[0], device=x.device) > self.rate
        return x * keep.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)


class ConditionDrop(nn.Module):
    """CFG training: replace the condition embedding of a sample by a
    (learnable, ``null_embedding`` [1, hidden]) null embedding with
    probability ``rate``. ``keep`` ([B] bool) is the draw; when None in
    training it is drawn from torch's default generator (the train step
    draws it from its own, before the network runs). The embedding is
    [B, hidden] or spatially varying [B, hidden, *spatial]."""

    def __init__(self, rate: float, hidden_dim: int,
                 null_is_learnable: bool = True):
        super().__init__()
        self.rate = rate
        if null_is_learnable:
            self.null_embedding = nn.Parameter(unset(1, hidden_dim))
        else:
            self.register_buffer("null_embedding",
                                 torch.zeros(1, hidden_dim),
                                 persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if isinstance(self.null_embedding, nn.Parameter):
            self.null_embedding.copy_(torch.randn(
                self.null_embedding.shape, generator=generator))

    def forward(self, x, keep=None):
        if not self.training or self.rate == 0.0:
            return x
        if keep is None:
            keep = torch.rand(x.shape[0], device=x.device) < 1.0 - self.rate
        null = self.null_embedding.reshape((1, -1) + (1,) * (x.ndim - 2))
        return torch.where(keep.reshape((-1,) + (1,) * (x.ndim - 1)), x,
                           null.to(x.dtype))


class SwiGLU(nn.Module):
    """a(x) · SiLU(b(x)) with two dense layers."""

    def __init__(self, in_dims: int, out_dims: int):
        super().__init__()
        self.a = nn.Linear(in_dims, out_dims)
        self.b = nn.Linear(in_dims, out_dims)

    def forward(self, x):
        return self.a(x) * F.silu(self.b(x))
