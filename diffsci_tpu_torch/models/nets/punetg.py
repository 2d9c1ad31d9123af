"""PUNetG: the UNet score network, 2D and 3D, on the NC* layout.

Port of ``diffsci_tpu/models/nets/punetg.py``: ``PUNetGConfig``,
``PUNetG`` with every option of the JAX network (space_to_depth, the
bias-free ones channel, the Fourier ``in_embedding`` stem, circular and
magnitude-preserving convolutions, cosine and mp attention, the GroupPix
and identity norms, spatially-varying conditions, ``cond_drop``),
``PUNetGCond`` (channel-concatenated conditions), and
``calculate_receptive_field``. The network takes and returns
[B, C, *spatial] (the torch reference's layout, in which its fixtures are
stored); ``KarrasNet`` moves the channel axis of x at the model boundary.
Conditions go to the network as given: a spatially-varying condition or
embedding is [B, C, *spatial] here, where the JAX package's is channels
last. Module names follow the torch reference (``downward_blocks``,
``downsamplers``, ``before_block``, ``attn_resnet_block``, ``attn_block``,
``after_block``, ``upsamplers``, ``upward_blocks``, ``convin``,
``convout``, ``time_projection``, ``cond_drop``), so its state dicts load
with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.models.nets import layers
from diffsci_tpu_torch.models.nets.attention import SpatialSelfAttention
from diffsci_tpu_torch.utils import (depth_to_space, resolve_device,
                                     space_to_depth)


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

    @property
    def magnitude_preserving(self):
        return self.convolution_type == "mp"

    def export_description(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["channel_expansion"] = list(self.channel_expansion)
        return d

    @classmethod
    def from_description(cls, description: dict):
        description = dict(description)
        if "channel_expansion" in description:
            description["channel_expansion"] = tuple(
                description["channel_expansion"])
        return cls(**description)

    @classmethod
    def from_config_file(cls, config_file: pathlib.Path | str):
        import yaml
        with open(config_file) as f:
            return cls.from_description(yaml.safe_load(f))


def _embedding_description(embedding) -> dict:
    export = getattr(embedding, "export_description", None)
    return dict(conditional_embedding_args=export() if export else None,
                has_conditional_embedding=embedding is not None)


class PUNetG(nn.Module):
    """UNet score network. ``forward(x, t=None, y=None, cond_keep=None)``
    with x [B, C_in, *spatial], t [B] (the preconditioned noise
    conditioner), y the condition fed to ``conditional_embedding``, and
    ``cond_keep`` ([B] bool) the draw of ``ConditionDrop`` in training.
    ``extra_residual`` (a module of x) is added in every ResnetBlockC. Built
    on ``device`` (default: the CUDA card)."""

    def __init__(self, config: PUNetGConfig,
                 conditional_embedding: nn.Module | None = None,
                 extra_residual: nn.Module | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        nd, mc = cfg.dimension, cfg.model_channels
        ext = cfg.extended_channel_expansion
        s2d = cfg.space_to_depth ** nd

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
                convolution_type=cfg.convolution_type, use_bias=cfg.bias,
                extra_residual=extra_residual)
                for _ in range(n)])

        transition = dict(scale_factor=cfg.transition_scale_factor,
                          kernel_size=cfg.transition_kernel_size,
                          use_bias=cfg.bias,
                          convolution_type=cfg.convolution_type)
        in_ch = cfg.input_channels * s2d + (0 if cfg.bias else 1)
        if cfg.in_embedding:
            self.convin = layers.ConvolutionalFourierProjection(
                in_ch, mc, scale=cfg.input_projection_scale,
                use_bias=cfg.bias)
        else:
            self.convin = conv(in_ch, mc, cfg.in_out_kernel_size)
        self.time_projection = layers.GaussianFourierProjection(
            mc, cfg.time_projection_scale)
        self.conditional_embedding = conditional_embedding
        self.cond_drop = (layers.ConditionDrop(
            cfg.cond_drop, mc, null_is_learnable=cfg.cond_drop_learnable)
            if cfg.cond_drop and cfg.cond_drop > 0 else None)
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
                                     cfg.magnitude_preserving),
                                 backend=cfg.attn_backend)
            for _ in range(max(cfg.number_resnet_attn_block - 1, 0))])
        self.after_block = resnets(bot, cfg.number_resnet_after_attn_block)
        rev = list(reversed(ext))
        self.upsamplers = nn.ModuleList([
            layers.UpSampler(nd, rev[i] * mc, rev[i + 1] * mc, **transition)
            for i in range(len(rev) - 1)])
        self.upward_blocks = nn.ModuleList([
            resnets(m, cfg.number_resnet_upward_block) for m in rev[1:]])
        self.convout = conv(mc, cfg.output_channels * s2d,
                            cfg.in_out_kernel_size)
        self.to(device)

    def forward(self, x, t=None, y=None, cond_keep=None):
        cfg = self.config
        if x.ndim != cfg.dimension + 2:
            raise ValueError(f"expected [B, C, *{cfg.dimension}D spatial], "
                             f"got {tuple(x.shape)}")
        s2d = cfg.space_to_depth
        if s2d > 1:
            x = space_to_depth(x, s2d)
        if not cfg.bias:
            x = torch.cat([x, x.new_ones((x.shape[0], 1) + x.shape[2:])],
                          dim=1)
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
                # spatially-varying condition [B, C, *sp]: lift te to
                # [B, C, 1, ...]
                if s2d > 1 and ye.shape[2:] != x.shape[2:]:
                    raise ValueError(
                        f"space_to_depth>1 folds x to {tuple(x.shape[2:])} "
                        "but the spatially-varying condition embedding is "
                        f"{tuple(ye.shape[2:])}; fold the conditioning to "
                        "the same resolution (e.g. utils.space_to_depth) "
                        "or use a non-spatial embedding")
                te = te.reshape(tuple(te.shape) + (1,) * (ye.ndim - te.ndim))
            if self.cond_drop is not None:
                ye = self.cond_drop(ye, cond_keep)
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
        x = self.convout(x)
        if s2d > 1:
            x = depth_to_space(x, s2d)
        return x

    def export_description(self) -> dict[str, Any]:
        return dict(kind="punetg", config=self.config.export_description(),
                    **_embedding_description(self.conditional_embedding))


class PUNetGCond(nn.Module):
    """PUNetG with channel-concatenated conditioning: the
    ``channel_conditional_items`` of the condition dict ([B or 1, c,
    *spatial] each) join x as channels, the rest flow to the embedding.
    The inner network is ``unet`` (its ``input_channels`` counts both)."""

    def __init__(self, config: PUNetGConfig,
                 conditional_embedding: nn.Module | None = None,
                 extra_residual: nn.Module | None = None,
                 channel_conditional_items: Sequence[str] = (),
                 device: torch.device | str | None = None):
        super().__init__()
        self.channel_conditional_items = tuple(channel_conditional_items)
        self.unet = PUNetG(config, conditional_embedding, extra_residual,
                           device=device)
        self.config = config

    def forward(self, x, t=None, y=None, cond_keep=None):
        items = self.channel_conditional_items
        y_cat = torch.cat([y[item] for item in items], dim=1)
        if y_cat.shape[0] == 1 and x.shape[0] > 1:
            y_cat = y_cat.expand((x.shape[0],) + y_cat.shape[1:])
        y_rest = {k: v for k, v in y.items() if k not in items} or None
        return self.unet(torch.cat([x, y_cat.to(x.dtype)], dim=1), t,
                         y_rest, cond_keep)

    def export_description(self) -> dict[str, Any]:
        return dict(kind="punetg_cond",
                    config=self.config.export_description(),
                    channel_conditional_items=list(
                        self.channel_conditional_items),
                    **_embedding_description(
                        self.unet.conditional_embedding))


def calculate_receptive_field(config: PUNetGConfig) -> dict:
    """Theoretical receptive field of a PUNetG in input pixels, as the
    JAX package computes it (``diffsci_tpu/models/nets/punetg.py:312-``):
    every conv adds (k - 1)·stride, the stride doubling at each
    DownSampler's pool and halving back at each UpSampler; global
    attention at the bottleneck makes it infinite; ``space_to_depth=s``
    multiplies every stride by s. Returns {'rf', 'has_attention',
    'num_attention_layers', 'trace', 'feasible_chunking',
    'downsampling_factor' (finite rf only), 'config_summary'}."""
    trace: list[str] = []
    summary = dict(
        number_resnet_attn_block=config.number_resnet_attn_block,
        number_resnet_downward_block=config.number_resnet_downward_block,
        number_resnet_upward_block=config.number_resnet_upward_block,
        number_resnet_before_attn_block=(
            config.number_resnet_before_attn_block),
        number_resnet_after_attn_block=config.number_resnet_after_attn_block,
        kernel_size=config.kernel_size,
        in_out_kernel_size=config.in_out_kernel_size,
        transition_kernel_size=config.transition_kernel_size,
        transition_scale_factor=config.transition_scale_factor,
        channel_expansion=list(config.channel_expansion),
        space_to_depth=config.space_to_depth)

    num_attention_layers = max(config.number_resnet_attn_block - 1, 0)
    if num_attention_layers > 0:
        trace.append(f"ATTENTION: {num_attention_layers} global attention "
                     "layer(s) flatten all spatial dims -> RF infinite")
        return dict(rf=float("inf"), has_attention=True,
                    num_attention_layers=num_attention_layers, trace=trace,
                    feasible_chunking=False, config_summary=summary)

    s2d = max(int(config.space_to_depth), 1)
    rf, stride = s2d, s2d
    trace.append(f"initial: rf={rf} stride={stride}"
                 + (f" (space_to_depth={s2d})" if s2d > 1 else ""))

    def conv(rf, k, stride, name):
        add = (k - 1) * stride
        trace.append(f"{name} (k={k}): rf {rf} -> {rf + add}")
        return rf + add

    def resblock(rf, stride, name):
        add = 2 * (config.kernel_size - 1) * stride
        trace.append(f"{name} (2x k={config.kernel_size}): "
                     f"rf {rf} -> {rf + add}")
        return rf + add

    if config.in_embedding:
        trace.append("convin (Fourier embedding): no rf change")
    else:
        rf = conv(rf, config.in_out_kernel_size, stride, "convin")

    levels = len(config.channel_expansion)
    for lv in range(levels):
        for j in range(config.number_resnet_downward_block):
            rf = resblock(rf, stride, f"down[{lv}].res[{j}]")
        pool = config.transition_scale_factor
        rf += (pool - 1) * stride
        stride *= pool
        trace.append(f"down[{lv}].maxpool (k={pool}): rf={rf} "
                     f"stride={stride}")
        rf = conv(rf, config.transition_kernel_size, stride,
                  f"down[{lv}].conv")

    for j in range(config.number_resnet_before_attn_block):
        rf = resblock(rf, stride, f"before[{j}]")
    for j in range(config.number_resnet_attn_block):
        rf = resblock(rf, stride, f"attn_res[{j}]")
    for j in range(config.number_resnet_after_attn_block):
        rf = resblock(rf, stride, f"after[{j}]")

    for lv in range(levels - 1, -1, -1):
        stride //= config.transition_scale_factor
        trace.append(f"up[{lv}].upsample: no rf change, stride={stride}")
        rf = conv(rf, config.transition_kernel_size, stride,
                  f"up[{lv}].conv")
        for j in range(config.number_resnet_upward_block):
            rf = resblock(rf, stride, f"up[{lv}].res[{j}]")

    rf = conv(rf, config.in_out_kernel_size, stride, "convout")
    trace.append(f"final rf={rf}")
    return dict(
        rf=rf, has_attention=False, num_attention_layers=0, trace=trace,
        feasible_chunking=True,
        downsampling_factor=(config.transition_scale_factor ** levels) * s2d,
        config_summary=summary)
