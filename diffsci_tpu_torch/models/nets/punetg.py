"""PUNetG: the UNet score network, 2D and 3D, on the NC* layout.

Port of ``diffsci_tpu/models/nets/punetg.py:32-267``. The network takes and
returns [B, C, *spatial] (the torch reference's layout, in which its
fixtures are stored); ``KarrasNet`` moves the channel axis at the model
boundary. Module names follow the torch reference (``downward_blocks``,
``downsamplers``, ``before_block``, ``attn_resnet_block``, ``attn_block``,
``after_block``, ``upsamplers``, ``upward_blocks``, ``convin``,
``convout``, ``time_projection``), so its state dicts load with
``load_state_dict(strict=True)``.

Not ported yet (raise at construction): space_to_depth > 1,
in_embedding, convolution types other than 'default', cosine or
magnitude-preserving attention, bias-free convolutions and cond_drop.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.models.nets import layers
from diffsci_tpu_torch.models.nets.attention import SpatialSelfAttention
from diffsci_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class PUNetGConfig:
    """The JAX package's PUNetGConfig: same fields, same defaults."""
    input_channels: int = 1
    output_channels: int = 1
    dimension: int = 2
    model_channels: int = 64
    channel_expansion: Sequence[int] = (2, 4)
    number_resnet_downward_block: int = 2
    number_resnet_upward_block: int = 2
    number_resnet_attn_block: int = 2
    number_resnet_before_attn_block: int = 2
    number_resnet_after_attn_block: int = 2
    kernel_size: int = 3
    in_out_kernel_size: int = 3
    in_embedding: bool = False
    time_projection_scale: float = 30.0
    input_projection_scale: float = 1.0
    transition_scale_factor: int = 2
    transition_kernel_size: int = 3
    dropout: float = 0.0
    cond_dropout: float = 0.0
    cond_drop: float = 0.0
    cond_drop_learnable: bool = True
    first_resblock_norm: str = "GroupLN"
    second_resblock_norm: str = "GroupRMS"
    affine_norm: bool = True
    convolution_type: str = "default"
    num_groups: int = 1
    attn_residual: bool = False
    attn_type: str = "default"
    num_heads: int = 1
    attn_backend: str = "xla"
    bias: bool = True
    space_to_depth: int = 1

    def __post_init__(self):
        object.__setattr__(self, "channel_expansion",
                           tuple(self.channel_expansion))

    @property
    def extended_channel_expansion(self):
        return [1] + list(self.channel_expansion)


def _check_ported(cfg: PUNetGConfig) -> None:
    unported = {"space_to_depth": cfg.space_to_depth != 1,
                "in_embedding": cfg.in_embedding,
                "bias=False": not cfg.bias,
                "cond_drop": cfg.cond_drop > 0}
    missing = [name for name, hit in unported.items() if hit]
    if missing:
        raise NotImplementedError(f"PUNetG options not ported yet: {missing}")


class PUNetG(nn.Module):
    """UNet score network. ``forward(x, t=None, y=None)`` with x
    [B, C_in, *spatial], t [B] (the preconditioned noise conditioner) and
    y the condition fed to ``conditional_embedding``. Built on ``device``
    (default: the CUDA card)."""

    def __init__(self, config: PUNetGConfig,
                 conditional_embedding: nn.Module | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        _check_ported(cfg)
        nd, mc = cfg.dimension, cfg.model_channels
        ext = cfg.extended_channel_expansion

        def conv(cin, cout, k):
            return layers.conv_layer(cfg.convolution_type, nd, cin, cout, k,
                                     cfg.bias)

        def resnets(mult, n):
            return nn.ModuleList([layers.ResnetBlockC(
                nd, mult * mc, time_embed_dim=mc,
                kernel_size=cfg.kernel_size, dropout=cfg.dropout,
                first_norm=cfg.first_resblock_norm,
                second_norm=cfg.second_resblock_norm,
                affine_norm=cfg.affine_norm,
                convolution_type=cfg.convolution_type, use_bias=cfg.bias)
                for _ in range(n)])

        transition = dict(scale_factor=cfg.transition_scale_factor,
                          kernel_size=cfg.transition_kernel_size,
                          use_bias=cfg.bias,
                          convolution_type=cfg.convolution_type)
        self.convin = conv(cfg.input_channels, mc, cfg.in_out_kernel_size)
        self.time_projection = layers.GaussianFourierProjection(
            mc, cfg.time_projection_scale)
        self.conditional_embedding = conditional_embedding
        self.cond_dropout = nn.Dropout(cfg.cond_dropout)
        self.downward_blocks = nn.ModuleList([
            resnets(m, cfg.number_resnet_downward_block) for m in ext[:-1]])
        self.downsamplers = nn.ModuleList([
            layers.DownSampler(nd, ext[i] * mc, ext[i + 1] * mc,
                               **transition)
            for i in range(len(ext) - 1)])
        bot = ext[-1]
        self.before_block = resnets(bot, cfg.number_resnet_before_attn_block)
        self.attn_resnet_block = resnets(bot, cfg.number_resnet_attn_block)
        self.attn_block = nn.ModuleList([
            SpatialSelfAttention(bot * mc, num_heads=cfg.num_heads,
                                 attn_type=cfg.attn_type,
                                 attn_residual=cfg.attn_residual,
                                 magnitude_preserving=(
                                     cfg.convolution_type == "mp"),
                                 backend=cfg.attn_backend)
            for _ in range(max(cfg.number_resnet_attn_block - 1, 0))])
        self.after_block = resnets(bot, cfg.number_resnet_after_attn_block)
        rev = list(reversed(ext))
        self.upsamplers = nn.ModuleList([
            layers.UpSampler(nd, rev[i] * mc, rev[i + 1] * mc, **transition)
            for i in range(len(rev) - 1)])
        self.upward_blocks = nn.ModuleList([
            resnets(m, cfg.number_resnet_upward_block) for m in rev[1:]])
        self.convout = conv(mc, cfg.output_channels, cfg.in_out_kernel_size)
        self.to(device)

    def forward(self, x, t=None, y=None):
        cfg = self.config
        if x.ndim != cfg.dimension + 2:
            raise ValueError(f"expected [B, C, *{cfg.dimension}D spatial], "
                             f"got {tuple(x.shape)}")
        x = self.convin(x)
        if t is not None:
            te = self.time_projection(t)
        else:
            te = torch.zeros((x.shape[0], cfg.model_channels),
                             dtype=x.dtype, device=x.device)
        if y is not None:
            ye = (self.conditional_embedding(y)
                  if self.conditional_embedding is not None else y)
            if ye.ndim > te.ndim:
                raise NotImplementedError(
                    "spatially-varying condition embeddings are not ported "
                    "yet")
            te = te + self.cond_dropout(ye)

        skips = []
        sf = cfg.transition_scale_factor
        for blocks, down in zip(self.downward_blocks, self.downsamplers):
            for block in blocks:
                x = block(x, te)
            skips.append(x)
            # odd-size levels: pad up to the downsample multiple; the
            # decoder crops back to the recorded skip shape
            pads = [(-d) % sf for d in x.shape[2:]]
            if any(pads):
                x = F.pad(x, [p for d in reversed(pads) for p in (0, d)])
            x = down(x)

        for block in self.before_block:
            x = block(x, te)
        xa = x
        for j, block in enumerate(self.attn_resnet_block):
            xa = block(xa, te)
            if j < len(self.attn_block):
                xa = self.attn_block[j](xa)
        x = x + xa
        for block in self.after_block:
            x = block(x, te)

        for up, blocks in zip(self.upsamplers, self.upward_blocks):
            x = up(x)
            skip = skips.pop()
            if x.shape[2:] != skip.shape[2:]:
                x = x[(slice(None), slice(None))
                      + tuple(slice(0, d) for d in skip.shape[2:])]
            x = x + skip
            for block in blocks:
                x = block(x, te)
        return self.convout(x)
