"""KL autoencoder of latent diffusion (LDM's ``AutoencoderKL``), 2D and 3D.

Port of ``diffsci_tpu/models/nets/vae.py``: ``DDConfig``, the blocks
(``LDMResnetBlock``: GroupNorm → swish → conv twice, a 1×1 or 3×3
shortcut; ``LDMAttnBlock``: single-head attention over the spatial tokens;
``LDMLinearAttnBlock``; ``LDMDownsample`` with LDM's (0, 1) pad before a
stride-2 conv; ``LDMUpsample``: nearest ×2 and a conv), ``VAEEncoder``,
``VAEDecoder``, ``DiagonalGaussianDistribution`` and ``AutoencoderKL``,
one implementation for ``dimension`` 2 and 3.

Tensors are [B, C, *spatial] and the parameter names are the torch
reference's (``encoder.down.{i}.block.{j}.norm1``, ``mid.attn_1.q``,
``quant_conv``, ...), so a reference state dict loads with
``load_state_dict``; the attention's q, k, v and proj_out are 1×1
convolutions there and run here as one matrix product each. The norms
are ``F.group_norm`` (up to 32 groups, eps 1e-6) and the attention a
plain matmul and softmax, as the JAX package's flax GroupNorm and einsum:
no kernel of the port is on this path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.parallel.tensor_parallel import as_linear
from diffsci_tpu_torch.utils import resolve_device


def swish(x):
    """x · sigmoid(x), the blocks' activation (``F.silu`` in them)."""
    return x * torch.sigmoid(x)


@dataclasses.dataclass(frozen=True)
class DDConfig:
    """The autoencoder's shape (the reference's ``autoencoderldm2d.py``
    defaults: 256² single-channel fields to 32² × 4 latents)."""
    double_z: bool = True
    z_channels: int = 4
    resolution: int = 256
    in_channels: int = 1
    out_ch: int = 1
    ch: int = 32
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Sequence[int] = ()
    dropout: float = 0.0
    has_mid_attn: bool = True
    dimension: int = 2
    attn_type: str = "vanilla"  # 'vanilla' | 'linear' | 'none'

    def __post_init__(self):
        object.__setattr__(self, "ch_mult", tuple(self.ch_mult))
        object.__setattr__(self, "attn_resolutions",
                           tuple(self.attn_resolutions))

    def export_description(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["ch_mult"] = list(self.ch_mult)
        d["attn_resolutions"] = list(self.attn_resolutions)
        return d

    @classmethod
    def from_description(cls, description: dict):
        return cls(**description)


def _conv(dimension: int, cin: int, cout: int, k: int, stride: int = 1,
          padding: int | None = None, bias: bool = True) -> nn.Module:
    conv = (nn.Conv2d, nn.Conv3d)[dimension - 2]
    return conv(cin, cout, k, stride=stride,
                padding=k // 2 if padding is None else padding, bias=bias)


def _norm(channels: int) -> nn.GroupNorm:
    """GroupNorm with eps 1e-6 and 32 groups, or the largest count below
    that divides a narrow layer's channels."""
    groups = min(32, channels)
    while channels % groups:
        groups -= 1
    return nn.GroupNorm(groups, channels, eps=1e-6)


def _tokens(x):
    """[B, C, *spatial] -> [B, N, C]."""
    return x.flatten(2).transpose(1, 2)


def _untokens(h, like):
    return h.transpose(1, 2).reshape(like.shape)


def _linear(conv: nn.Module, h, bias: bool = True):
    """A 1×1 convolution (or ``VAENet``'s wrapper of one, whose layer is
    ``conv``) as a matrix product over tokens [B, N, C]; under tensor
    parallelism the whole product (``parallel.tensor_parallel.as_linear``).
    """
    return as_linear(getattr(conv, "conv", conv), h, bias)


class LDMResnetBlock(nn.Module):
    """GroupNorm → swish → conv → GroupNorm → swish → dropout → conv, plus
    the input through a 1×1 (``nin_shortcut``) or 3×3 (``conv_shortcut``)
    convolution where the width changes."""

    def __init__(self, in_channels: int, out_channels: int | None = None,
                 conv_shortcut: bool = False, dropout: float = 0.0,
                 dimension: int = 2):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = _norm(in_channels)
        self.conv1 = _conv(dimension, in_channels, out_channels, 3)
        self.norm2 = _norm(out_channels)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = _conv(dimension, out_channels, out_channels, 3)
        if in_channels != out_channels:
            if conv_shortcut:
                self.conv_shortcut = _conv(dimension, in_channels,
                                           out_channels, 3)
            else:
                self.nin_shortcut = _conv(dimension, in_channels,
                                          out_channels, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(self.dropout(F.silu(self.norm2(h))))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        elif hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class LDMAttnBlock(nn.Module):
    """Single-head attention over the flattened spatial tokens with a
    residual: softmax(q kᵀ/√C) v, then ``proj_out``."""

    def __init__(self, channels: int, dimension: int = 2,
                 num_groups: int | None = None):
        super().__init__()
        self.norm = _norm(channels) if num_groups is None else \
            nn.GroupNorm(num_groups, channels, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (
            _conv(dimension, channels, channels, 1) for _ in range(4))

    def forward(self, x):
        h = _tokens(self.norm(x))
        q, k, v = (_linear(m, h) for m in (self.q, self.k, self.v))
        w = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(x.shape[1]),
                          dim=-1)
        return x + _untokens(_linear(self.proj_out, w @ v), x)


class LDMLinearAttnBlock(nn.Module):
    """Linear attention with ``heads`` heads and a residual: the keys'
    softmax over tokens, context = kᵀv, out = q·context, then ``to_out``
    (the JAX package's block: no norm, a bias-free ``to_qkv``)."""

    def __init__(self, channels: int, dimension: int = 2, heads: int = 4):
        super().__init__()
        self.heads = heads
        self.to_qkv = _conv(dimension, channels, 3 * channels, 1, bias=False)
        self.to_out = _conv(dimension, channels, channels, 1)

    def forward(self, x):
        B, C = x.shape[:2]
        qkv = _linear(self.to_qkv, _tokens(x), bias=False)

        def heads(t):
            return t.reshape(B, -1, self.heads, C // self.heads).transpose(
                1, 2)

        q, k, v = (heads(t) for t in qkv.chunk(3, dim=-1))
        context = torch.softmax(k, dim=-2).transpose(2, 3) @ v  # [B,H,d,e]
        out = (q @ context).transpose(1, 2).reshape(B, -1, C)
        return x + _untokens(_linear(self.to_out, out), x)


def _make_attn(attn_type: str, channels: int, dimension: int) -> nn.Module:
    if attn_type == "vanilla":
        return LDMAttnBlock(channels, dimension)
    if attn_type == "linear":
        return LDMLinearAttnBlock(channels, dimension)
    return nn.Identity()


class LDMDownsample(nn.Module):
    """A stride-2 3^d conv after LDM's asymmetric (0, 1) pad of every
    spatial axis, or a 2^d average pool without ``with_conv``."""

    def __init__(self, channels: int, with_conv: bool = True,
                 dimension: int = 2):
        super().__init__()
        self.dimension = dimension
        if with_conv:
            self.conv = _conv(dimension, channels, channels, 3, stride=2,
                              padding=0)

    def forward(self, x):
        if hasattr(self, "conv"):
            return self.conv(F.pad(x, (0, 1) * self.dimension))
        return (F.avg_pool2d, F.avg_pool3d)[self.dimension - 2](x, 2, 2)


class LDMUpsample(nn.Module):
    """Nearest ×2 on every spatial axis, then a 3^d conv."""

    def __init__(self, channels: int, with_conv: bool = True,
                 dimension: int = 2):
        super().__init__()
        if with_conv:
            self.conv = _conv(dimension, channels, channels, 3)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x) if hasattr(self, "conv") else x


class _Level(nn.Module):
    """One resolution of the encoder or decoder: ``block``, ``attn`` and
    its ``downsample`` or ``upsample`` (the reference's layout)."""

    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class _Mid(nn.Module):
    def __init__(self, channels: int, cfg: DDConfig):
        super().__init__()
        self.block_1 = LDMResnetBlock(channels, dropout=cfg.dropout,
                                      dimension=cfg.dimension)
        if cfg.has_mid_attn:
            self.attn_1 = LDMAttnBlock(channels, cfg.dimension)
        self.block_2 = LDMResnetBlock(channels, dropout=cfg.dropout,
                                      dimension=cfg.dimension)

    def forward(self, h):
        h = self.block_1(h)
        if hasattr(self, "attn_1"):
            h = self.attn_1(h)
        return self.block_2(h)


def _level_forward(level: _Level, h):
    for i, block in enumerate(level.block):
        h = block(h)
        if len(level.attn):
            h = level.attn[i](h)
    return h


class VAEEncoder(nn.Module):
    """conv_in, ``num_res_blocks`` blocks a level (attention at
    ``attn_resolutions``) with a downsample between levels, the mid block,
    GroupNorm → swish → conv_out to 2·z_channels moments (``double_z``)."""

    def __init__(self, config: DDConfig):
        super().__init__()
        cfg, d = config, config.dimension
        self.config = cfg
        self.conv_in = _conv(d, cfg.in_channels, cfg.ch, 3)
        in_mult = (1,) + cfg.ch_mult
        res = cfg.resolution
        self.down = nn.ModuleList()
        for i, mult in enumerate(cfg.ch_mult):
            level, block_in = _Level(), cfg.ch * in_mult[i]
            for _ in range(cfg.num_res_blocks):
                level.block.append(LDMResnetBlock(
                    block_in, cfg.ch * mult, dropout=cfg.dropout,
                    dimension=d))
                block_in = cfg.ch * mult
                if res in cfg.attn_resolutions:
                    level.attn.append(_make_attn(cfg.attn_type, block_in, d))
            if i != len(cfg.ch_mult) - 1:
                level.downsample = LDMDownsample(block_in, dimension=d)
                res //= 2
            self.down.append(level)
        self.mid = _Mid(block_in, cfg)
        self.norm_out = _norm(block_in)
        self.conv_out = _conv(d, block_in, (2 if cfg.double_z else 1)
                              * cfg.z_channels, 3)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = _level_forward(level, h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VAEDecoder(nn.Module):
    """conv_in from z_channels, the mid block, ``num_res_blocks + 1``
    blocks a level from the coarsest up with an upsample between levels,
    GroupNorm → swish → conv_out (tanh with ``tanh_out``)."""

    def __init__(self, config: DDConfig, tanh_out: bool = False):
        super().__init__()
        cfg, d = config, config.dimension
        self.config, self.tanh_out = cfg, tanh_out
        n = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        res = cfg.resolution // 2 ** (n - 1)
        self.conv_in = _conv(d, cfg.z_channels, block_in, 3)
        self.mid = _Mid(block_in, cfg)
        levels = []
        for i in reversed(range(n)):
            level, block_out = _Level(), cfg.ch * cfg.ch_mult[i]
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(LDMResnetBlock(
                    block_in, block_out, dropout=cfg.dropout, dimension=d))
                block_in = block_out
                if res in cfg.attn_resolutions:
                    level.attn.append(_make_attn(cfg.attn_type, block_in, d))
            if i != 0:
                level.upsample = LDMUpsample(block_in, dimension=d)
                res *= 2
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)
        self.norm_out = _norm(block_in)
        self.conv_out = _conv(d, block_in, cfg.out_ch, 3)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = _level_forward(level, h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return torch.tanh(h) if self.tanh_out else h


class DiagonalGaussianDistribution:
    """The posterior of moments [B, 2c, *spatial]: mean and log-variance
    (clipped to [-30, 20]) split on the channel axis."""

    def __init__(self, parameters, deterministic: bool = False):
        self.parameters = parameters
        self.mean, logvar = parameters.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.deterministic = deterministic
        if deterministic:
            self.std = torch.zeros_like(self.mean)
            self.var = torch.zeros_like(self.mean)
        else:
            self.std = torch.exp(0.5 * self.logvar)
            self.var = torch.exp(self.logvar)

    def sample(self, generator=None, eps=None):
        """mean + std·ε, ε a unit normal draw from ``generator`` unless
        given (``eps``, of the mean's shape)."""
        if eps is None:
            eps = torch.randn(self.mean.shape, generator=generator,
                              dtype=self.mean.dtype, device=self.mean.device)
        return self.mean + self.std * eps.to(self.mean.dtype)

    def _axes(self):
        return tuple(range(1, self.mean.ndim))

    @staticmethod
    def _reduce(x, axes, reduce_mean: bool):
        return x.mean(dim=axes) if reduce_mean else x.sum(dim=axes)

    def _kl_core(self, other):
        if other is None:
            return self.mean ** 2 + self.var - 1.0 - self.logvar
        return ((self.mean - other.mean) ** 2 / other.var
                + self.var / other.var - 1.0 - self.logvar + other.logvar)

    def kl(self, other=None, reduce_mean: bool = False):
        """KL to N(0, 1) or to ``other``, per item [B]."""
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], device=self.mean.device)
        return 0.5 * self._reduce(self._kl_core(other), self._axes(),
                                  reduce_mean)

    def kl_thresholded(self, other=None, threshold: float = 0.5):
        """Per latent channel KL, the mean over the spatial axes, floored
        at ``threshold`` (free bits): [B, c]."""
        axes = tuple(range(2, self.mean.ndim))
        core = self._kl_core(other)
        per = 0.5 * (core.mean(dim=axes) if axes else core)
        return per.clamp_min(threshold)

    def modified_hellinger(self, other=None, reduce_mean: bool = False):
        if other is None:
            other_mean = torch.zeros_like(self.mean)
            other_var = torch.ones_like(self.var)
        else:
            other_mean, other_var = other.mean, other.var
        sum_var = self.var + other_var
        log_term = 2 * torch.log(sum_var / (2 * self.std
                                            * torch.sqrt(other_var)))
        mean_term = (self.mean - other_mean) ** 2 / sum_var
        return 0.25 * self._reduce(log_term + mean_term, self._axes(),
                                   reduce_mean)

    def wasserstein(self, other=None, reduce_mean: bool = False):
        """2-Wasserstein² between diagonal Gaussians, per item."""
        if other is None:
            other_mean = torch.zeros_like(self.mean)
            other_std = torch.ones_like(self.std)
        else:
            other_mean, other_std = other.mean, other.std
        core = (self.mean - other_mean) ** 2 + (self.std - other_std) ** 2
        return self._reduce(core, self._axes(), reduce_mean)

    def nll(self, sample, axes=None):
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], device=self.mean.device)
        if axes is None:
            axes = self._axes()
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + self.logvar
                               + (sample - self.mean) ** 2 / self.var,
                               dim=axes)

    def mode(self):
        return self.mean


class AutoencoderKL(nn.Module):
    """The KL autoencoder: encoder → 1×1 ``quant_conv`` → a
    ``DiagonalGaussianDistribution``; 1×1 ``post_quant_conv`` → decoder,
    on ``device`` (default: the CUDA card)."""

    def __init__(self, config: DDConfig, embed_dim: int = 4,
                 device: torch.device | str | None = None):
        super().__init__()
        self.config, self.embed_dim = config, embed_dim
        d = config.dimension
        self.encoder = VAEEncoder(config)
        self.decoder = VAEDecoder(config)
        factor = 2 if config.double_z else 1
        self.quant_conv = _conv(d, factor * config.z_channels,
                                factor * embed_dim, 1)
        self.post_quant_conv = _conv(d, embed_dim, config.z_channels, 1)
        self.to(resolve_device(device))

    def encode_moments(self, x):
        return self.quant_conv(self.encoder(x))

    def encode(self, x) -> DiagonalGaussianDistribution:
        return DiagonalGaussianDistribution(self.encode_moments(x))

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x, generator=None, sample_posterior: bool = True,
                eps=None):
        posterior = self.encode(x)
        z = posterior.sample(generator, eps) if sample_posterior \
            else posterior.mode()
        return self.decode(z), posterior

    def export_description(self) -> dict[str, Any]:
        return dict(config=self.config.export_description(),
                    embed_dim=self.embed_dim)
