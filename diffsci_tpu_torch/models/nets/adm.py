"""ADM: the Dhariwal/Nichol UNet with FiLM time conditioning, 2D and 3D,
on the NC* layout.

Port of ``diffsci_tpu/models/nets/adm.py``: ``ADMConfig`` (with
``middle_channel``, ``extended_channel_expansion``,
``middle_block_attn_config``, ``num_blocks_middle_block`` and the
description round-trip), ``ADMBlock``, ``ADMTimeEmbedding`` and ``ADM``
(decoder types 1 and 2, ``space_to_depth``, ``conditional_embedding``
with ``cond_dropout``, ``convolution_type='mp'``). The network takes and
returns [B, C, *spatial]. Module names are the torch reference's
(``time_embedding.projection``/``mlp``, ``input_layer``,
``encoder.layers.{i}.input_blocks.{j}``, ``middle_block.middle_blocks.{j}``,
``decoder.layers.{i}.input_blocks.{j}``, ``output_layer``; a block's
``norm1``, ``conv1``, ``norm2``, ``embed_linear``, ``conv2``,
``convresidual``, ``attn``), so its state dicts load with
``load_state_dict(strict=True)``.

A block's norms have ``num_groups`` groups (1 by default) and SiLU is a
separate call, as in the JAX package: they take the plain path, not
kernel K2 (whose case is one group per channel). The middle block's
attention is ``SpatialSelfAttention``: with ``attn_backend='flash'`` it
runs kernels K4-K6 at ≥ 2048 tokens, at any head dim (ADM's defaults
give one head of 256 channels).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.models.nets import layers
from diffsci_tpu_torch.models.nets.attention import SpatialSelfAttention
from diffsci_tpu_torch.utils import (depth_to_space, resolve_device,
                                     space_to_depth)

_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@dataclasses.dataclass(frozen=True)
class ADMConfig:
    """The JAX package's ADMConfig: same fields, same defaults."""
    input_channels: int = 1
    output_channels: int = 1
    dimension: int = 2
    model_channels: int = 64
    time_embed_dim: int = 64
    output_embed_dim: int = 256
    channel_expansion: Sequence[int] = (2, 4)
    number_resnet_downward_block: int = 2
    number_resnet_upward_block: int = 2
    number_resnet_attn_block: int = 2
    number_resnet_before_attn_block: int = 2
    number_resnet_after_attn_block: int = 2
    kernel_size: int = 3
    time_projection_scale: float = 30.0
    transition_scale_factor: int = 2
    transition_kernel_size: int = 3
    dropout: float = 0.0
    cond_dropout: float = 0.0
    first_resblock_norm: str = "GroupLN"
    second_resblock_norm: str = "GroupRMS"
    affine_norm: bool = True
    convolution_type: str = "default"
    num_groups: int = 1
    skip_integration_type: str = "concat"
    attn_residual: bool = True
    attn_heads: int = 1
    attn_type: str = "default"
    attn_backend: str = "xla"
    space_to_depth: int = 1
    decoder_type: int = 1

    def __post_init__(self):
        object.__setattr__(self, "channel_expansion",
                           tuple(self.channel_expansion))

    @property
    def middle_channel(self):
        return self.model_channels * self.channel_expansion[-1]

    @property
    def extended_channel_expansion(self):
        return [1] + list(self.channel_expansion)

    @property
    def middle_block_attn_config(self):
        """Which middle blocks attend: none of the ``before`` blocks, all
        but the last of the ``attn`` blocks, none of the ``after``
        blocks."""
        return ([False] * self.number_resnet_before_attn_block
                + [True] * (self.number_resnet_attn_block - 1) + [False]
                + [False] * self.number_resnet_after_attn_block)

    @property
    def num_blocks_middle_block(self):
        return (self.number_resnet_before_attn_block
                + self.number_resnet_attn_block
                + self.number_resnet_after_attn_block)

    def export_description(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["channel_expansion"] = list(self.channel_expansion)
        return d

    @classmethod
    def from_description(cls, description: dict):
        return cls(**description)


def nearest_upsample(x, scale: int):
    """Nearest-neighbour upsampling of every spatial dim of [B, C, *sp]."""
    for axis in range(2, x.ndim):
        x = x.repeat_interleave(scale, dim=axis)
    return x


class ADMBlock(nn.Module):
    """[skip concat/add] -> norm1 -> SiLU -> [resample] -> conv1 -> norm2,
    FiLM h·te1 + te2 from ``embed_linear`` of the embedding, SiLU ->
    dropout -> conv2, + ``convresidual`` (1×1) of the resampled input,
    then [attention]. ``channels_in`` counts the skip's channels when
    ``has_skip`` concatenates."""

    def __init__(self, dimension: int, channels_in: int, channels_out: int,
                 embed_dim: int, has_skip: bool = False,
                 resample: str | None = None, resample_type: str = "avg",
                 resample_factor: int = 2, has_residual: bool = False,
                 has_attn: bool = False, first_norm: str = "GroupLN",
                 second_norm: str = "GroupRMS", affine_norm: bool = True,
                 conv_type: str = "default", num_groups: int = 1,
                 pdrop: float = 0.0, attn_type: str = "default",
                 attn_heads: int = 1, attn_residual: bool = True,
                 attn_backend: str = "xla",
                 skip_integration_type: str = "concat"):
        super().__init__()
        self.has_skip = has_skip
        self.resample = resample
        self.resample_type = resample_type
        self.resample_factor = resample_factor
        self.skip_integration_type = skip_integration_type
        nd = dimension
        self.norm1 = layers.make_norm(first_norm, num_groups, channels_in,
                                      affine_norm)
        self.conv1 = layers.conv_layer(conv_type, nd, channels_in,
                                       channels_out, 3)
        self.norm2 = layers.make_norm(second_norm, num_groups, channels_out,
                                      affine_norm)
        self.embed_linear = nn.Linear(embed_dim, 2 * channels_out)
        self.dropout = nn.Dropout(pdrop)
        self.conv2 = layers.conv_layer(conv_type, nd, channels_out,
                                       channels_out, 3)
        self.convresidual = (layers.conv_layer(conv_type, nd, channels_in,
                                               channels_out, 1)
                             if has_residual else None)
        self.attn = (SpatialSelfAttention(channels_out, attn_heads,
                                          attn_type=attn_type,
                                          attn_residual=attn_residual,
                                          backend=attn_backend)
                     if has_attn else None)

    def _resample(self, x):
        f = self.resample_factor
        if self.resample == "downsample":
            pool = _AVG_POOL if self.resample_type == "avg" else _MAX_POOL
            return pool[x.ndim - 2](x, f)
        if self.resample == "upsample":
            return nearest_upsample(x, f)
        return x

    def forward(self, x, te, skip=None):
        if skip is not None and self.has_skip:
            if self.skip_integration_type == "concat":
                x = torch.cat([x, skip], dim=1)
            elif self.skip_integration_type == "add":
                x = x + skip
            else:
                raise ValueError(f"Invalid skip integration type "
                                 f"{self.skip_integration_type}")
        h = self._resample(F.silu(self.norm1(x)))
        h = self.norm2(self.conv1(h))
        te1, te2 = self.embed_linear(te).chunk(2, dim=-1)
        bshape = te1.shape + (1,) * (x.ndim - 2)
        h = h * te1.reshape(bshape) + te2.reshape(bshape)
        h = self.conv2(self.dropout(F.silu(h)))
        if self.convresidual is not None:
            h = h + self.convresidual(self._resample(x))
        if self.attn is not None:
            h = self.attn(h)
        return h


class ADMTimeEmbedding(nn.Module):
    """SiLU(MLP(fourier(t)) + ye): ``projection`` (buffer ``W``) and
    ``mlp`` (Linear, SiLU, Linear)."""

    def __init__(self, embed_dim: int, output_dim: int,
                 projection_scale: float = 30.0):
        super().__init__()
        self.projection = layers.GaussianFourierProjection(
            embed_dim, projection_scale)
        self.mlp = nn.Sequential(nn.Linear(embed_dim, output_dim), nn.SiLU(),
                                 nn.Linear(output_dim, output_dim))

    def forward(self, t, ye=None):
        te = self.mlp(self.projection(t))
        if ye is not None:
            te = te + ye
        return F.silu(te)


class ADM(nn.Module):
    """``net(x, t=None, y=None)`` with x [B, C_in, *spatial], t [B] and y
    the condition fed to ``conditional_embedding``. Built on ``device``
    (default: the CUDA card)."""

    def __init__(self, config: ADMConfig,
                 conditional_embedding: nn.Module | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        nd, mc = cfg.dimension, cfg.model_channels
        ext = cfg.extended_channel_expansion
        s2d = cfg.space_to_depth ** nd
        concat = cfg.skip_integration_type == "concat"

        def block(cin, cout, resample=None, has_attn=False, has_skip=False):
            return ADMBlock(
                nd, cin, cout, cfg.output_embed_dim, has_skip=has_skip,
                resample=resample,
                resample_type="avg" if resample == "downsample"
                else "nearest",
                resample_factor=cfg.transition_scale_factor,
                has_residual=True, has_attn=has_attn,
                first_norm=cfg.first_resblock_norm,
                second_norm=cfg.second_resblock_norm,
                affine_norm=cfg.affine_norm,
                conv_type=cfg.convolution_type, num_groups=cfg.num_groups,
                pdrop=cfg.dropout, attn_type=cfg.attn_type,
                attn_heads=cfg.attn_heads, attn_residual=cfg.attn_residual,
                attn_backend=cfg.attn_backend,
                skip_integration_type=cfg.skip_integration_type)

        self.conditional_embedding = conditional_embedding
        self.cond_dropout = nn.Dropout(cfg.cond_dropout)
        self.time_embedding = ADMTimeEmbedding(
            cfg.time_embed_dim, cfg.output_embed_dim,
            cfg.time_projection_scale)
        self.input_layer = layers.conv_layer(
            cfg.convolution_type, nd, cfg.input_channels * s2d, mc,
            cfg.kernel_size)

        if cfg.decoder_type not in (1, 2):
            raise ValueError(f"Invalid decoder type {cfg.decoder_type}")
        n_down = cfg.number_resnet_downward_block
        self.encoder = layers.holder(layers=nn.ModuleList([
            layers.holder(input_blocks=nn.ModuleList([
                block(mc * ext[i], mc * ext[i + 1 if j == n_down - 1 else i],
                      resample="downsample" if j == n_down - 1 else None)
                for j in range(n_down)]))
            for i in range(len(ext) - 1)]))
        self.middle_block = layers.holder(middle_blocks=nn.ModuleList([
            block(cfg.middle_channel, cfg.middle_channel, has_attn=attn)
            for attn in cfg.middle_block_attn_config]))
        # type 1 joins the skip once, at the level's entry; type 2 in every
        # block, before its norm
        n_up = cfg.number_resnet_upward_block
        rev = ext[::-1]
        levels = []
        for i in range(len(rev) - 1):
            cin, cout = mc * rev[i], mc * rev[i + 1]
            width = 2 * cin if concat else cin
            keep = width if cfg.decoder_type == 1 else cin
            levels.append(layers.holder(input_blocks=nn.ModuleList([
                block(width, cout if j == n_up - 1 else keep,
                      resample="upsample" if j == n_up - 1 else None,
                      has_skip=cfg.decoder_type == 2)
                for j in range(n_up)])))
        self.decoder = layers.holder(layers=nn.ModuleList(levels))
        self.output_layer = layers.conv_layer(
            cfg.convolution_type, nd, mc, cfg.output_channels * s2d,
            cfg.kernel_size)
        self.to(device)

    def forward(self, x, t=None, y=None):
        cfg = self.config
        if x.ndim != cfg.dimension + 2:
            raise ValueError(f"expected [B, C, *{cfg.dimension}D spatial], "
                             f"got {tuple(x.shape)}")
        if cfg.space_to_depth > 1:
            x = space_to_depth(x, cfg.space_to_depth)
        if y is not None:
            ye = self.cond_dropout(self.conditional_embedding(y))
        elif self.conditional_embedding is not None:
            ye = x.new_zeros((x.shape[0], cfg.output_embed_dim))
        else:
            ye = None
        if t is None:
            t = x.new_zeros((x.shape[0],))
        te = self.time_embedding(t, ye)

        x = self.input_layer(x)
        skips = []
        for level in self.encoder.layers:
            for blk in level.input_blocks:
                x = blk(x, te)
            skips.append(x)
        for blk in self.middle_block.middle_blocks:
            x = blk(x, te)
        for level in self.decoder.layers:
            skip = skips.pop()
            if cfg.decoder_type == 1:
                x = (torch.cat([x, skip], dim=1)
                     if cfg.skip_integration_type == "concat" else x + skip)
                for blk in level.input_blocks:
                    x = blk(x, te)
            else:
                for blk in level.input_blocks:
                    x = blk(x, te, skip=skip)
        x = self.output_layer(x)
        if cfg.space_to_depth > 1:
            x = depth_to_space(x, cfg.space_to_depth)
        return x

    def export_description(self) -> dict[str, Any]:
        cemb = getattr(self.conditional_embedding, "export_description",
                       None)
        return dict(kind="adm", config=self.config.export_description(),
                    conditional_embedding_args=cemb() if cemb else None,
                    has_conditional_embedding=(
                        self.conditional_embedding is not None))


__all__ = ["ADM", "ADMBlock", "ADMConfig", "ADMTimeEmbedding",
           "nearest_upsample"]
