"""VAENet: the dimension-agnostic (1D, 2D, 3D) VAE of the porous-media
work, with minimal-receptive-field blocks, an optional time embedding and
a patched convolution.

Port of ``diffsci_tpu/models/nets/vaenet.py``: ``divide_dims``,
``patched_conv``, ``VAENetConfig``, the blocks (``_StdResBlock``:
GroupNorm → swish → conv twice, a time bias after the first conv, a 1×1
shortcut where the width changes; ``MinimalResnetBlock``: one 3^d conv
under a sigmoid gate of a 1×1 conv, +2 receptive field a block instead of
+4), ``_TimeEmbed``, ``VAENetEncoder``, ``VAENetDecoder`` and ``VAENet``
with ``receptive_radius``.

Tensors are [B, C, *spatial] and the names are the torch reference's
(``encoder.down.{i}.block.{j}.conv1.conv``, ``mid.attn_1.q.conv``,
``decoder.up.{i}.upsample.conv.conv``, ...): the reference wraps each
convolution of a block, of the attention, of conv_in/conv_out and of the
(post_)quant_conv and upsample in its patched-convolution module, whose
layer is ``conv`` (``_Conv`` here), so its state dicts load strictly. The
norms are GroupNorm with eps 1e-6 (the group count lowered until it
divides the width, as the JAX package's ``_gnorm``) and the attention the
port's plain ``LDMAttnBlock``: no kernel of the port is on this path, as
none of the JAX package's is.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import pathlib
from typing import Any, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.models.nets.layers import GaussianFourierProjection
from diffsci_tpu_torch.models.nets.vae import (LDMAttnBlock,
                                               LDMLinearAttnBlock)
from diffsci_tpu_torch.utils import resolve_device

_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)


def divide_dims(ub: int, window_size: int, lb: int = 0):
    """[lb, ub) split into windows of ``window_size`` (the last shorter)."""
    patches = []
    n = -(-(ub - lb) // window_size)
    for i in range(n):
        lo = lb + i * window_size
        hi = min(ub, lb + (i + 1) * window_size)
        patches.append((lo, hi))
    return patches


def patched_conv(x, conv_apply, patch_size: int, padding: int):
    """A size-keeping convolution of x [B, C, *spatial] window by window,
    to bound the peak activation memory: x is zero-padded by ``padding``
    on every spatial side and ``conv_apply`` (an unpadded convolution)
    runs on each window of ``patch_size`` with its halo."""
    spatial = x.shape[2:]
    xp = F.pad(x, (padding, padding) * len(spatial))
    out = None
    for windows in itertools.product(*[divide_dims(d, patch_size)
                                       for d in spatial]):
        src = [slice(None), slice(None)]
        dst = [slice(None), slice(None)]
        for lo, hi in windows:
            src.append(slice(lo, hi + 2 * padding))
            dst.append(slice(lo, hi))
        res = conv_apply(xp[tuple(src)])
        if out is None:
            out = x.new_zeros((x.shape[0], res.shape[1]) + tuple(spatial),
                              dtype=res.dtype)
        out[tuple(dst)] = res
    return out


@dataclasses.dataclass(frozen=True)
class VAENetConfig:
    """VAENet's shape (the JAX package's fields and defaults: 3D, 64³ × 1
    to 16³ × 4 latents, ch 32, mult (1, 2, 4), two blocks a level, a
    middle attention)."""
    dimension: int = 3
    in_channels: int = 1
    out_channels: int = 1
    z_channels: int = 4
    z_dim: int = 4
    ch: int = 32
    ch_mult: Sequence[int] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Sequence[int] = ()
    dropout: float = 0.0
    resolution: int = 64
    has_mid_attn: bool = True
    resamp_with_conv: bool = True
    attn_type: str = "vanilla"
    tanh_out: bool = False
    input_bias: bool = True
    output_bias: bool = True
    with_time_emb: bool = False
    double_z: bool = True
    num_groups: int = 32
    minimal_rf_mode: bool = False

    def __post_init__(self):
        if self.dimension not in (1, 2, 3):
            raise ValueError(f"dimension {self.dimension} is not 1, 2 or 3")
        object.__setattr__(self, "ch_mult", tuple(self.ch_mult))
        object.__setattr__(self, "attn_resolutions",
                           tuple(self.attn_resolutions))

    @property
    def num_resolutions(self):
        return len(self.ch_mult)

    def export_description(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["ch_mult"] = list(self.ch_mult)
        d["attn_resolutions"] = list(self.attn_resolutions)
        return d

    @classmethod
    def from_description(cls, description: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in description.items() if k in names})

    @classmethod
    def from_config_file(cls, config_file: pathlib.Path | str):
        import yaml
        with open(config_file) as f:
            return cls.from_description(yaml.safe_load(f))


class _Conv(nn.Module):
    """A size-keeping k^d convolution held as ``conv``, the name the torch
    reference's patched-convolution wrapper gives its layer
    (``LDMAttnBlock`` applies a 1×1 one to tokens through its ``conv``)."""

    def __init__(self, dimension: int, cin: int, cout: int, k: int,
                 bias: bool = True):
        super().__init__()
        self.conv = _CONVS[dimension - 1](cin, cout, k, padding=k // 2,
                                          bias=bias)

    def forward(self, x):
        return self.conv(x)


def _gnorm(channels: int, num_groups: int) -> nn.GroupNorm:
    """GroupNorm, eps 1e-6, with ``num_groups`` lowered until it divides
    ``channels``."""
    g = min(num_groups, channels)
    while channels % g:
        g -= 1
    return nn.GroupNorm(g, channels, eps=1e-6)


class _StdResBlock(nn.Module):
    """norm1 → swish → conv1 (+ ``temb_proj`` of swish(temb)) → norm2 →
    swish → dropout → conv2, plus x (through ``nin_shortcut`` where the
    width changes)."""

    def __init__(self, cin: int, cout: int, dimension: int, dropout: float,
                 num_groups: int, temb_channels: int | None):
        super().__init__()
        self.norm1 = _gnorm(cin, num_groups)
        self.conv1 = _Conv(dimension, cin, cout, 3)
        if temb_channels is not None:
            self.temb_proj = nn.Linear(temb_channels, cout)
        self.norm2 = _gnorm(cout, num_groups)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = _Conv(dimension, cout, cout, 3)
        if cin != cout:
            self.nin_shortcut = _Conv(dimension, cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        h = _add_time(self, h, temb)
        h = self.conv2(self.dropout(F.silu(self.norm2(h))))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class MinimalResnetBlock(nn.Module):
    """norm1 → swish → conv1 (+ ``temb_proj``) → dropout, gated by
    sigmoid(``gate``(x)), a 1×1 conv, plus x (through ``nin_shortcut``
    where the width changes)."""

    def __init__(self, cin: int, cout: int, dimension: int, dropout: float,
                 num_groups: int, temb_channels: int | None):
        super().__init__()
        self.norm1 = _gnorm(cin, num_groups)
        self.conv1 = _Conv(dimension, cin, cout, 3)
        if temb_channels is not None:
            self.temb_proj = nn.Linear(temb_channels, cout)
        self.dropout = nn.Dropout(dropout)
        self.gate = _Conv(dimension, cin, cout, 1)
        if cin != cout:
            self.nin_shortcut = _Conv(dimension, cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.dropout(_add_time(self, h, temb))
        gate = torch.sigmoid(self.gate(x))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + gate * h


def _add_time(block: nn.Module, h, temb):
    """h + the block's projection of swish(temb), over every position."""
    if temb is None:
        return h
    t = block.temb_proj(F.silu(temb))
    return h + t.reshape(t.shape + (1,) * (h.ndim - 2))


class _Attn(LDMAttnBlock):
    """``LDMAttnBlock`` with ``num_groups`` groups (not lowered, as in the
    JAX package) and q, k, v, proj_out as the reference's wrapped 1×1
    convolutions, for any dimension."""

    def __init__(self, channels: int, dimension: int, num_groups: int):
        nn.Module.__init__(self)
        self.norm = nn.GroupNorm(num_groups, channels, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (
            _Conv(dimension, channels, channels, 1) for _ in range(4))


class _LinearAttn(LDMLinearAttnBlock):
    """``LDMLinearAttnBlock`` (4 heads) with 1×1 convolutions of the
    network's dimension."""

    def __init__(self, channels: int, dimension: int, heads: int = 4):
        nn.Module.__init__(self)
        self.heads = heads
        conv = _CONVS[dimension - 1]
        self.to_qkv = conv(channels, 3 * channels, 1, bias=False)
        self.to_out = conv(channels, channels, 1)


def _make_attn(cfg: VAENetConfig, channels: int) -> nn.Module:
    if cfg.attn_type == "vanilla":
        return _Attn(channels, cfg.dimension, cfg.num_groups)
    if cfg.attn_type == "linear":
        return _LinearAttn(channels, cfg.dimension)
    return nn.Identity()


class _Downsample(nn.Module):
    """A stride-2 3^d ``conv`` after LDM's (0, 1) pad of every spatial
    axis, or a 2^d average pool."""

    def __init__(self, channels: int, with_conv: bool, dimension: int):
        super().__init__()
        self.dimension = dimension
        if with_conv:
            self.conv = _CONVS[dimension - 1](channels, channels, 3,
                                              stride=2)

    def forward(self, x):
        if hasattr(self, "conv"):
            return self.conv(F.pad(x, (0, 1) * self.dimension))
        return (F.avg_pool1d, F.avg_pool2d,
                F.avg_pool3d)[self.dimension - 1](x, 2, 2)


class _Upsample(nn.Module):
    """Nearest ×2 on every spatial axis, then a wrapped 3^d ``conv``."""

    def __init__(self, channels: int, with_conv: bool, dimension: int):
        super().__init__()
        if with_conv:
            self.conv = _Conv(dimension, channels, channels, 3)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x) if hasattr(self, "conv") else x


class _TimeEmbed(nn.Module):
    """Fourier features of t (``fourier``), a linear layer to 4·ch, SiLU,
    a linear layer."""

    def __init__(self, ch: int):
        super().__init__()
        self.fourier = GaussianFourierProjection(ch)
        self.linear_1 = nn.Linear(ch, 4 * ch)
        self.linear_2 = nn.Linear(4 * ch, 4 * ch)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(self.fourier(t))))


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class _Mid(nn.Module):
    def __init__(self, cfg: VAENetConfig, channels: int, temb: int | None):
        super().__init__()
        self.block_1 = _make_block(cfg, channels, channels, temb)
        if cfg.has_mid_attn:
            self.attn_1 = _Attn(channels, cfg.dimension, cfg.num_groups)
        self.block_2 = _make_block(cfg, channels, channels, temb)

    def forward(self, h, temb):
        h = self.block_1(h, temb)
        if hasattr(self, "attn_1"):
            h = self.attn_1(h)
        return self.block_2(h, temb)


def _make_block(cfg: VAENetConfig, cin: int, cout: int,
                temb: int | None) -> nn.Module:
    cls = MinimalResnetBlock if cfg.minimal_rf_mode else _StdResBlock
    return cls(cin, cout, cfg.dimension, cfg.dropout, cfg.num_groups, temb)


def _level_forward(level: _Level, h, temb):
    for i, block in enumerate(level.block):
        h = block(h, temb)
        if len(level.attn):
            h = level.attn[i](h)
    return h


def _time(module: nn.Module, time):
    """The time embedding, or None without one or without a time."""
    if not hasattr(module, "time_embed") or time is None:
        return None
    return module.time_embed(time)


class VAENetEncoder(nn.Module):
    """conv_in, ``num_res_blocks`` blocks a level (attention at
    ``attn_resolutions``) with a downsample between levels, the middle
    (block, attention, block), GroupNorm → swish → conv_out to
    2·z_channels, then ``quant_conv`` (1×1) to the 2·z_dim moments
    (z_channels and z_dim without ``double_z``)."""

    def __init__(self, config: VAENetConfig):
        super().__init__()
        cfg, d = config, config.dimension
        self.config = cfg
        temb = 4 * cfg.ch if cfg.with_time_emb else None
        if cfg.with_time_emb:
            self.time_embed = _TimeEmbed(cfg.ch)
        self.conv_in = _Conv(d, cfg.in_channels, cfg.ch, 3,
                             bias=cfg.input_bias)
        res, block_in = cfg.resolution, cfg.ch
        self.down = nn.ModuleList()
        for i, mult in enumerate(cfg.ch_mult):
            level = _Level()
            for _ in range(cfg.num_res_blocks):
                level.block.append(_make_block(cfg, block_in, cfg.ch * mult,
                                               temb))
                block_in = cfg.ch * mult
                if res in cfg.attn_resolutions:
                    level.attn.append(_make_attn(cfg, block_in))
            if i != cfg.num_resolutions - 1:
                level.downsample = _Downsample(block_in, cfg.resamp_with_conv,
                                               d)
                res //= 2
            self.down.append(level)
        self.mid = _Mid(cfg, block_in, temb)
        self.norm_out = _gnorm(block_in, cfg.num_groups)
        factor = 2 if cfg.double_z else 1
        self.conv_out = _Conv(d, block_in, factor * cfg.z_channels, 3)
        self.quant_conv = _Conv(d, factor * cfg.z_channels,
                                factor * cfg.z_dim, 1)

    def forward(self, x, time=None):
        temb = _time(self, time)
        h = self.conv_in(x)
        for level in self.down:
            h = _level_forward(level, h, temb)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h, temb)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return self.quant_conv(h)


class VAENetDecoder(nn.Module):
    """``post_quant_conv`` (1×1, z_dim to z_channels), conv_in, the
    middle, ``num_res_blocks + 1`` blocks a level from the coarsest up with
    an upsample between levels, GroupNorm → swish → conv_out (tanh with
    ``tanh_out``)."""

    def __init__(self, config: VAENetConfig):
        super().__init__()
        cfg, d = config, config.dimension
        self.config = cfg
        temb = 4 * cfg.ch if cfg.with_time_emb else None
        if cfg.with_time_emb:
            self.time_embed = _TimeEmbed(cfg.ch)
        n = cfg.num_resolutions
        block_in = cfg.ch * cfg.ch_mult[-1]
        res = cfg.resolution // 2 ** (n - 1)
        self.post_quant_conv = _Conv(d, cfg.z_dim, cfg.z_channels, 1)
        self.conv_in = _Conv(d, cfg.z_channels, block_in, 3)
        self.mid = _Mid(cfg, block_in, temb)
        levels = []
        for i in reversed(range(n)):
            level, block_out = _Level(), cfg.ch * cfg.ch_mult[i]
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(_make_block(cfg, block_in, block_out,
                                               temb))
                block_in = block_out
                if res in cfg.attn_resolutions:
                    level.attn.append(_make_attn(cfg, block_in))
            if i != 0:
                level.upsample = _Upsample(block_in, cfg.resamp_with_conv, d)
                res *= 2
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)
        self.norm_out = _gnorm(block_in, cfg.num_groups)
        self.conv_out = _Conv(d, block_in, cfg.out_channels, 3,
                              bias=cfg.output_bias)

    def forward(self, z, time=None):
        temb = _time(self, time)
        h = self.conv_in(self.post_quant_conv(z))
        h = self.mid(h, temb)
        for level in reversed(self.up):
            h = _level_forward(level, h, temb)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return torch.tanh(h) if self.config.tanh_out else h


class VAENet(nn.Module):
    """Encoder and decoder on ``device`` (default: the CUDA card).
    ``encode`` gives the moments [B, 2·z_dim, *latent] (a posterior draw
    with a generator or ``eps``), ``decode`` takes z [B, z_dim, *latent];
    ``time`` [B] conditions both when ``with_time_emb``."""

    def __init__(self, config: VAENetConfig,
                 device: torch.device | str | None = None):
        super().__init__()
        self.config = config
        self.encoder = VAENetEncoder(config)
        self.decoder = VAENetDecoder(config)
        self.to(resolve_device(device))

    def encode(self, x, time=None, generator=None, eps=None):
        z = self.encoder(x, time)
        if generator is not None or eps is not None:
            mean, logvar = z.chunk(2, dim=1)
            std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
            if eps is None:
                eps = torch.randn(mean.shape, generator=generator,
                                  dtype=mean.dtype, device=mean.device)
            z = mean + std * eps
        return z

    def decode(self, z, time=None):
        return self.decoder(z, time)

    def encode_moments(self, x, time=None):
        """The posterior's moments (the encoder applies ``quant_conv``):
        the hook ``VAEModel`` reads."""
        return self.encoder(x, time)

    def forward(self, x, time=None):
        moments = self.encode(x, time)
        return moments, self.decode(moments[:, :self.config.z_dim], time)

    def export_description(self) -> dict[str, Any]:
        return {"config": self.config.export_description()}

    def receptive_radius(self) -> int:
        """The decoder's receptive radius in latent units, for an exact
        tiled decode."""
        cfg = self.config
        per_block = 1 if cfg.minimal_rf_mode else 2
        r = 1.0 + 2 * per_block          # conv_in, the middle
        scale = 1.0
        for i_level in reversed(range(cfg.num_resolutions)):
            r += (cfg.num_res_blocks + 1) * per_block / scale
            if i_level != 0:
                scale *= 2
        r += 1.0 / scale
        return math.ceil(r)
