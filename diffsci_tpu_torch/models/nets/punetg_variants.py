"""PUNetG variants on the NC* layout: the encoder and decoder halves, the
deterministic (regression) UNet and the temporal slice-embedding UNet.

Port of ``diffsci_tpu/models/nets/punetg_variants.py``:
``EncoderFlattener``, ``PUNetGEncoder``, ``PUNetGDecoder``,
``PUNetGDeterministic``, ``PUNetVConfig``, ``ResnetSliceBlock``,
``SliceResnetBlockC`` and ``PUNetV``. They are built from the port's
``ResnetBlockC`` and samplers, so their norms run kernels K2 and K3 where
PUNetG's do. Module names are the torch reference's: the encoder's
``convin``, ``time_projection``, ``downward_blocks``, ``downsamplers`` and
``bottom_blocks`` (0: before, 1: attention resnets, 2: attention, 3:
after), the decoder's ``time_projection``, ``upsamplers``,
``upward_blocks`` and ``convout``, PUNetV's PUNetG names; so their state
dicts load with ``load_state_dict(strict=True)``. Slice embeddings are
[B, T, C, *spatial] here (the JAX package's are channels last).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.models.nets import layers
from diffsci_tpu_torch.models.nets.attention import SpatialSelfAttention
from diffsci_tpu_torch.models.nets.punetg import PUNetG, PUNetGConfig
from diffsci_tpu_torch.utils import resolve_device

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}


def _group_norm(channels: int, max_groups: int):
    """flax's GroupNorm (eps 1e-6) with the largest group count ≤
    ``max_groups`` that divides ``channels``."""
    g = min(max_groups, channels)
    while channels % g:
        g -= 1
    return nn.GroupNorm(g, channels, eps=1e-6)


class EncoderFlattener(nn.Module):
    """Global mean pool over space, then ``linear``."""

    def __init__(self, in_channels: int, output_channels: int):
        super().__init__()
        self.linear = nn.Linear(in_channels, output_channels)

    def forward(self, x):
        return self.linear(x.mean(dim=tuple(range(2, x.ndim))))


def _resnets(cfg, mult: int, n: int, use_time: bool):
    return nn.ModuleList([layers.ResnetBlockC(
        cfg.dimension, mult * cfg.model_channels,
        time_embed_dim=cfg.model_channels if use_time else None,
        kernel_size=cfg.kernel_size, dropout=cfg.dropout,
        first_norm=cfg.first_resblock_norm,
        second_norm=cfg.second_resblock_norm, affine_norm=cfg.affine_norm,
        convolution_type=cfg.convolution_type, use_bias=cfg.bias)
        for _ in range(n)])


def _transition(cfg):
    return dict(scale_factor=cfg.transition_scale_factor,
                kernel_size=cfg.transition_kernel_size, use_bias=cfg.bias,
                convolution_type=cfg.convolution_type)


class PUNetGEncoder(nn.Module):
    """The down path and the attention bottleneck of PUNetG (the
    attention blocks in sequence, without PUNetG's additive branch),
    optionally projected to a flat embedding (``projection``,
    ``output_channels``). ``use_time_embedding`` adds the time path; it
    then needs t."""

    def __init__(self, config: PUNetGConfig, use_time_embedding: bool = False,
                 output_channels: Optional[int] = None,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.use_time_embedding = use_time_embedding
        nd, mc = cfg.dimension, cfg.model_channels
        ext = cfg.extended_channel_expansion
        self.convin = layers.conv_layer(
            cfg.convolution_type, nd,
            cfg.input_channels + (0 if cfg.bias else 1), mc,
            cfg.in_out_kernel_size, cfg.bias)
        self.time_projection = (layers.GaussianFourierProjection(
            mc, cfg.time_projection_scale) if use_time_embedding else None)
        self.downward_blocks = nn.ModuleList([
            _resnets(cfg, m, cfg.number_resnet_downward_block,
                     use_time_embedding) for m in ext[:-1]])
        self.downsamplers = nn.ModuleList([
            layers.DownSampler(nd, ext[i] * mc, ext[i + 1] * mc,
                               **_transition(cfg))
            for i in range(len(ext) - 1)])
        bot = ext[-1]
        self.bottom_blocks = nn.ModuleList([
            _resnets(cfg, bot, cfg.number_resnet_before_attn_block,
                     use_time_embedding),
            _resnets(cfg, bot, cfg.number_resnet_attn_block,
                     use_time_embedding),
            nn.ModuleList([SpatialSelfAttention(
                bot * mc, num_heads=cfg.num_heads, attn_type=cfg.attn_type,
                attn_residual=cfg.attn_residual,
                magnitude_preserving=cfg.magnitude_preserving)
                for _ in range(max(cfg.number_resnet_attn_block - 1, 0))]),
            _resnets(cfg, bot, cfg.number_resnet_after_attn_block,
                     use_time_embedding)])
        self.projection = (EncoderFlattener(bot * mc, output_channels)
                           if output_channels is not None else None)
        self.to(device)

    def forward(self, x, t=None, return_intermediate_outputs: bool = False):
        cfg = self.config
        if not cfg.bias:
            x = torch.cat([x, x.new_ones((x.shape[0], 1) + x.shape[2:])],
                          dim=1)
        x = self.convin(x)
        te = None
        if self.use_time_embedding:
            if t is None:
                raise ValueError("an encoder built with use_time_embedding "
                                 "needs t")
            te = self.time_projection(t)
        skips = []
        for blocks, down in zip(self.downward_blocks, self.downsamplers):
            for block in blocks:
                x = block(x, te)
            skips.append(x)
            x = down(x)
        before, attn_res, attn, after = self.bottom_blocks
        for block in before:
            x = block(x, te)
        for j, block in enumerate(attn_res):
            x = block(x, te)
            if j < len(attn):
                x = attn[j](x)
        for block in after:
            x = block(x, te)
        if self.projection is not None:
            x = self.projection(x)
        if return_intermediate_outputs:
            return x, skips
        return x


class PUNetGDecoder(nn.Module):
    """The up path of PUNetG with optional additive skips
    (``intermediate_outputs``, the encoder's), then ``convout``."""

    def __init__(self, config: PUNetGConfig, use_time_embedding: bool = False,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.use_time_embedding = use_time_embedding
        nd, mc = cfg.dimension, cfg.model_channels
        rev = list(reversed(cfg.extended_channel_expansion))
        self.time_projection = (layers.GaussianFourierProjection(
            mc, cfg.time_projection_scale) if use_time_embedding else None)
        self.upsamplers = nn.ModuleList([
            layers.UpSampler(nd, rev[i] * mc, rev[i + 1] * mc,
                             **_transition(cfg))
            for i in range(len(rev) - 1)])
        self.upward_blocks = nn.ModuleList([
            _resnets(cfg, m, cfg.number_resnet_upward_block,
                     use_time_embedding) for m in rev[1:]])
        self.convout = layers.conv_layer(cfg.convolution_type, nd, mc,
                                         cfg.output_channels,
                                         cfg.in_out_kernel_size, cfg.bias)
        self.to(device)

    def forward(self, x, t=None, intermediate_outputs=None):
        te = None
        if self.use_time_embedding:
            if t is None:
                raise ValueError("a decoder built with use_time_embedding "
                                 "needs t")
            te = self.time_projection(t)
        skips = list(intermediate_outputs) if intermediate_outputs else None
        for up, blocks in zip(self.upsamplers, self.upward_blocks):
            x = up(x)
            if skips:
                x = x + skips.pop()
            for block in blocks:
                x = block(x, te)
        return self.convout(x)


class PUNetGDeterministic(nn.Module):
    """PUNetG (``unet``) called without a time: a direct regression net.
    ``net(x, t=None, y=None)`` ignores t."""

    def __init__(self, config: PUNetGConfig,
                 conditional_embedding: nn.Module | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.config = config
        self.unet = PUNetG(config, conditional_embedding, device=device)
        # never called with a time, so it holds no time projection (as
        # neither the JAX package's nor the torch reference's does)
        self.unet.time_projection = None

    def forward(self, x, t=None, y=None):
        return self.unet(x, None, y)

    def export_description(self) -> dict[str, Any]:
        return dict(config=self.config.export_description(),
                    deterministic=True)


@dataclasses.dataclass(frozen=True)
class PUNetVConfig(PUNetGConfig):
    """PUNetGConfig and the slice embeddings' channels."""
    slice_embed_channels: Optional[int] = None


class ResnetSliceBlock(nn.Module):
    """Temporal slices [B, T, C, *spatial] -> a [B, out, *target]
    embedding: each slice resized to the feature map
    (``layers.linear_resize``), masked, through GroupNorm/SiLU/conv ×2 and
    GroupNorm/conv (hidden 4·C), then averaged over the unmasked
    slices."""

    def __init__(self, dimension: int, input_channels: int,
                 output_channels: int):
        super().__init__()
        self.input_channels = input_channels
        inter = 4 * input_channels
        self.norm1 = _group_norm(input_channels, 32)
        self.conv1 = _CONV[dimension](input_channels, inter, 3, padding=1)
        self.norm2 = _group_norm(inter, 32)
        self.conv2 = _CONV[dimension](inter, inter, 3, padding=1)
        self.norm3 = _group_norm(inter, 32)
        self.conv3 = _CONV[dimension](inter, output_channels, 3, padding=1)

    def forward(self, slice_embeddings, temporal_mask=None,
                target_spatial_size=None):
        B, T, C = slice_embeddings.shape[:3]
        spatial = tuple(slice_embeddings.shape[3:])
        if C != self.input_channels:
            raise ValueError(f"slice embeddings have {C} channels, expected "
                             f"{self.input_channels}")
        x = slice_embeddings.reshape((B * T, C) + spatial)
        if target_spatial_size is not None and \
                tuple(target_spatial_size) != spatial:
            spatial = tuple(target_spatial_size)
            x = layers.linear_resize(x, spatial)
        nd = len(spatial)
        if temporal_mask is not None:
            x = x * temporal_mask.reshape((B * T,) + (1,) * (nd + 1)).to(
                x.dtype)
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        h = self.conv3(self.norm3(h))
        h = h.reshape((B, T) + h.shape[1:])
        if temporal_mask is not None:
            m = temporal_mask.reshape((B, T) + (1,) * (nd + 1)).to(h.dtype)
            return (h * m).sum(1) / m.sum(1).clamp_min(1.0)
        return h.mean(1)


class SliceResnetBlockC(layers.ResnetBlockC):
    """``ResnetBlockC`` without its skip (the torch reference passes
    ``output_channels``), with the slice embedding (``slice_embedding``)
    added after the time bias."""

    def __init__(self, dimension: int, channels: int, time_embed_dim: int,
                 slice_embed_channels: Optional[int], **kwargs):
        super().__init__(dimension, channels, time_embed_dim,
                         output_channels=channels, **kwargs)
        self.slice_embedding = (ResnetSliceBlock(dimension,
                                                 slice_embed_channels,
                                                 channels)
                                if slice_embed_channels is not None
                                else None)

    def forward(self, x, te=None, slice_embeddings=None,
                temporal_mask=None):
        h = self.conv1(self.gnorm1(x))
        h = h + self.timeblock(te, x.ndim - 2)
        if slice_embeddings is not None and self.slice_embedding is not None:
            h = h + self.slice_embedding(slice_embeddings, temporal_mask,
                                         x.shape[2:])
        return self.conv2(self.dropout(self.gnorm2(h)))


class PUNetV(nn.Module):
    """PUNetG whose blocks also take temporal slice embeddings,
    ``y['yb']`` [B, T, C, *spatial] with ``y['temporal_mask']`` [B, T];
    the rest of y goes to ``conditional_embedding``."""

    def __init__(self, config: PUNetVConfig,
                 conditional_embedding: nn.Module | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        nd, mc = cfg.dimension, cfg.model_channels
        ext = cfg.extended_channel_expansion

        def blocks(mult, n):
            return nn.ModuleList([SliceResnetBlockC(
                nd, mult * mc, mc, cfg.slice_embed_channels,
                kernel_size=cfg.kernel_size, dropout=cfg.dropout,
                first_norm=cfg.first_resblock_norm,
                second_norm=cfg.second_resblock_norm,
                affine_norm=cfg.affine_norm,
                convolution_type=cfg.convolution_type, use_bias=cfg.bias)
                for _ in range(n)])

        self.convin = layers.conv_layer(
            cfg.convolution_type, nd,
            cfg.input_channels + (0 if cfg.bias else 1), mc,
            cfg.in_out_kernel_size, cfg.bias)
        self.time_projection = layers.GaussianFourierProjection(
            mc, cfg.time_projection_scale)
        self.conditional_embedding = conditional_embedding
        self.cond_dropout = nn.Dropout(cfg.cond_dropout)
        self.downward_blocks = nn.ModuleList([
            blocks(m, cfg.number_resnet_downward_block) for m in ext[:-1]])
        self.downsamplers = nn.ModuleList([
            layers.DownSampler(nd, ext[i] * mc, ext[i + 1] * mc,
                               **_transition(cfg))
            for i in range(len(ext) - 1)])
        bot = ext[-1]
        self.before_block = blocks(bot, cfg.number_resnet_before_attn_block)
        self.attn_resnet_block = blocks(bot, cfg.number_resnet_attn_block)
        self.attn_block = nn.ModuleList([
            SpatialSelfAttention(bot * mc, num_heads=cfg.num_heads,
                                 attn_type=cfg.attn_type,
                                 attn_residual=cfg.attn_residual)
            for _ in range(max(cfg.number_resnet_attn_block - 1, 0))])
        self.after_block = blocks(bot, cfg.number_resnet_after_attn_block)
        rev = list(reversed(ext))
        self.upsamplers = nn.ModuleList([
            layers.UpSampler(nd, rev[i] * mc, rev[i + 1] * mc,
                             **_transition(cfg))
            for i in range(len(rev) - 1)])
        self.upward_blocks = nn.ModuleList([
            blocks(m, cfg.number_resnet_upward_block) for m in rev[1:]])
        self.convout = layers.conv_layer(cfg.convolution_type, nd, mc,
                                         cfg.output_channels,
                                         cfg.in_out_kernel_size, cfg.bias)
        self.to(device)

    def forward(self, x, t=None, y=None):
        cfg = self.config
        if not cfg.bias:
            x = torch.cat([x, x.new_ones((x.shape[0], 1) + x.shape[2:])],
                          dim=1)
        x = self.convin(x)
        te = (x.new_zeros((x.shape[0], cfg.model_channels)) if t is None
              else self.time_projection(t))
        yb = mask = None
        if y is not None:
            y = dict(y)
            yb = y.pop("yb", None)
            mask = y.pop("temporal_mask", None)
            y = y or None
        if y is not None:
            ye = (self.conditional_embedding(y)
                  if self.conditional_embedding is not None else y)
            te = te + self.cond_dropout(ye)
        skips = []
        for blks, down in zip(self.downward_blocks, self.downsamplers):
            for block in blks:
                x = block(x, te, yb, mask)
            skips.append(x)
            x = down(x)
        for block in self.before_block:
            x = block(x, te, yb, mask)
        xa = x
        for j, block in enumerate(self.attn_resnet_block):
            xa = block(xa, te, yb, mask)
            if j < len(self.attn_block):
                xa = self.attn_block[j](xa)
        x = x + xa
        for block in self.after_block:
            x = block(x, te, yb, mask)
        for up, blks in zip(self.upsamplers, self.upward_blocks):
            x = up(x) + skips.pop()
            for block in blks:
                x = block(x, te, yb, mask)
        return self.convout(x)

    def export_description(self) -> dict[str, Any]:
        return dict(config=self.config.export_description())


__all__ = ["EncoderFlattener", "PUNetGDecoder", "PUNetGDeterministic",
           "PUNetGEncoder", "PUNetV", "PUNetVConfig", "ResnetSliceBlock",
           "SliceResnetBlockC"]
