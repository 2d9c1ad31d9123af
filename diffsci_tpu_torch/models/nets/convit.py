"""ConVit: a conv-ViT hybrid on the NC* layout: depthwise convolutions and
learned-RoPE attention at a compressed resolution, a ConvSwiGLU FFN, and a
gated fusion of the attention and convolution pathways.

Port of ``diffsci_tpu/models/nets/convit.py``: ``ConVitConfig`` (with
``from_config_file``, which imports ``yaml`` only when called),
``ChannelRMSNorm``, ``LearnedRoPE``, ``ConVitAttention`` (softmax and
linear; the linear path's value norm is taken before RoPE),
``ConvSwiGLU``, ``_SwiGLU``, ``ConVitBlock`` and ``ConVit``, for 1, 2 or
3 positional dims. The network takes and returns [B, C, *pos]; attention
and RoPE work channels-last inside, as the JAX package does. Module names
are the torch reference's (``convin``, ``blocks.{i}``, ``normout``,
``convout``, ``time_embedding``; a block's ``embedding_projection``,
``norm_1``, ``downsample.conv``, ``attention`` with ``q/k/v_proj_tensor``,
``out_proj_tensor``, the buffer ``scale`` and ``rope_layer.angles``,
``upsample.conv``, ``depthwise_conv``, ``pointwise_conv``,
``fusion_weight``, ``norm_2``, ``ffn``), so its state dicts load with
``load_state_dict(strict=True)``. ConVit's attention is a plain einsum in
both packages: no kernel.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.models.nets import layers
from diffsci_tpu_torch.utils import resolve_device, unset

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T = {1: nn.ConvTranspose1d, 2: nn.ConvTranspose2d,
           3: nn.ConvTranspose3d}
_BATCH_NORM = {1: nn.BatchNorm1d, 2: nn.BatchNorm2d, 3: nn.BatchNorm3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_LINEAR_MODE = {1: "linear", 2: "bilinear", 3: "trilinear"}


@dataclasses.dataclass(frozen=True)
class ConVitConfig:
    """The JAX package's ConVitConfig: same fields, same defaults."""
    in_channels: int = 1
    embed_dim: int = 64
    num_pos_dims: int = 2
    out_channels: Optional[int] = None
    num_layers: int = 6
    num_heads: int = 8
    ffn_expansion_factor: int = 4
    attn_compression_factor: int = 2
    rope_freq: float = 1.0
    with_conv_on_upsample: bool = False
    with_conv_on_downsample: bool = False
    kernel_size_conv: int = 1
    kernel_size_in_out: int = 1
    kernel_size_depthwise: int = 3
    has_time_embedding: bool = False
    has_conditional_embedding: bool = False
    fourier_projection_scale: float = 30.0
    relative_positioning: bool = False
    linear_attention: bool = False
    input_batch_norm: bool = False
    condition_dropout: float = 0.1

    @property
    def has_embedding(self):
        return self.has_time_embedding or self.has_conditional_embedding

    def export_description(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_description(cls, description: dict):
        return cls(**description)

    @classmethod
    def from_config_file(cls, config_file: pathlib.Path | str):
        import yaml
        with open(config_file) as f:
            return cls.from_description(yaml.safe_load(f))


def _same_conv(nd: int, cin: int, cout: int, k: int, groups: int = 1):
    """A stride-1 convolution with 'SAME' padding (odd k)."""
    return _CONV[nd](cin, cout, k, padding=k // 2, groups=groups)


class ChannelRMSNorm(nn.Module):
    """RMS over the channel axis (1), per position, with eps the dtype's
    machine epsilon; times ``weight`` when ``element_wise_affine``."""

    def __init__(self, channel_dim: int, element_wise_affine: bool = True):
        super().__init__()
        self.weight = (nn.Parameter(torch.ones(channel_dim))
                       if element_wise_affine else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.weight is not None:
            nn.init.ones_(self.weight)

    def forward(self, x):
        eps = torch.finfo(x.dtype).eps
        x = x / torch.sqrt(torch.mean(x * x, dim=1, keepdim=True) + eps)
        if self.weight is not None:
            x = x * self.weight.reshape((1, -1) + (1,) * (x.ndim - 2))
        return x


class LearnedRoPE(nn.Module):
    """Learned rotary position embedding over N positional dims; x
    [B, *pos, d] (channels last) with d even; ``angles`` [N, d/2]."""

    def __init__(self, embed_dim: int, num_pos_dims: int = 1,
                 base_freq: float = 1.0, relative_positioning: bool = False):
        super().__init__()
        self.base_freq = base_freq
        self.relative_positioning = relative_positioning
        self.angles = nn.Parameter(unset(num_pos_dims, embed_dim // 2))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.angles.copy_(torch.randn(self.angles.shape, generator=generator)
                          * self.base_freq)

    def forward(self, x):
        pos_dims = x.shape[1:-1]
        grids = torch.meshgrid(*[
            torch.arange(d, dtype=x.dtype, device=x.device)
            / (d if self.relative_positioning else 1) for d in pos_dims],
            indexing="ij")
        positions = torch.stack(grids, dim=-1)           # [*pos, N]
        angles = torch.einsum("...p,ph->...h", positions,
                              self.angles.to(x.dtype))
        xr = x.reshape(x.shape[:-1] + (-1, 2))
        cos, sin = torch.cos(angles), torch.sin(angles)
        out = torch.stack([xr[..., 0] * cos - xr[..., 1] * sin,
                           xr[..., 0] * sin + xr[..., 1] * cos], dim=-1)
        return out.reshape(x.shape)


class ConVitAttention(nn.Module):
    """Per-head projection tensors [d, dh, h] + RoPE + softmax or linear
    attention, on x [B, *pos, d] (channels last). ``scale`` is √dh."""

    def __init__(self, embed_dim: int, num_heads: int, num_pos_dims: int = 1,
                 rope_freq: float = 1.0, relative_positioning: bool = False,
                 linear_attention: bool = False):
        super().__init__()
        d, h = embed_dim, num_heads
        dh = d // h
        self.num_pos_dims = num_pos_dims
        self.linear_attention = linear_attention
        for n in ("q", "k", "v", "out"):
            setattr(self, f"{n}_proj_tensor",
                    nn.Parameter(unset(d, dh, h)))
        self.register_buffer("scale", torch.tensor(math.sqrt(dh)))
        self.rope_layer = LearnedRoPE(dh, num_pos_dims, rope_freq,
                                      relative_positioning)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, dh, _ = self.q_proj_tensor.shape
        bound = 6 / math.sqrt(d + dh)
        for n in ("q", "k", "v", "out"):
            w = getattr(self, f"{n}_proj_tensor")
            w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1)
                    * bound)
        self.scale.fill_(math.sqrt(dh))

    def _rope(self, t):
        # [B, *pos, dh, h] -> per head [B·h, *pos, dh] and back
        moved = t.movedim(-1, 1)
        out = self.rope_layer(moved.reshape((-1,) + t.shape[1:-1]))
        return out.reshape(moved.shape).movedim(1, -1)

    def forward(self, x):
        scale = self.scale.to(x.dtype)
        q = torch.einsum("...d,dvh->...vh", x, self.q_proj_tensor)
        k = torch.einsum("...d,dvh->...vh", x, self.k_proj_tensor)
        v = torch.einsum("...d,dvh->...vh", x, self.v_proj_tensor)
        if self.linear_attention:
            q = (F.elu(q) + 1) / scale
            k = F.elu(k) + 1
            ksum = k.sum(dim=tuple(range(1, 1 + self.num_pos_dims)))
            # taken before RoPE, as in the torch reference
            vnorm = torch.einsum("b...kh,bkh->b...h", q, ksum) + \
                torch.finfo(v.dtype).eps
        q, k = self._rope(q), self._rope(k)
        if self.linear_attention:
            kv = torch.einsum("b...kh,b...vh->bkvh", k, v)
            out = torch.einsum("b...kh,bkvh->b...vh", q, kv)
            out = out / vnorm[..., None, :]
        else:
            B, pos = x.shape[0], x.shape[1:-1]
            dh, h = q.shape[-2:]
            T = math.prod(pos)
            logits = torch.einsum("btdh,bsdh->bhts", q.reshape(B, T, dh, h),
                                  k.reshape(B, T, dh, h)) / scale
            w = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhts,bsdh->btdh", w, v.reshape(B, T, dh, h))
            out = out.reshape((B,) + tuple(pos) + (dh, h))
        return torch.einsum("...vh,dvh->...d", out, self.out_proj_tensor)


class ConvSwiGLU(nn.Module):
    """out(SiLU(in(x)) · gate(x)) with 'SAME' convolutions of
    ``kernel_size`` (``linear_in``, ``linear_gate``, ``linear_out``), and
    a final ``ChannelRMSNorm`` when ``final_rms``."""

    def __init__(self, dimension: int, embed_dim: int,
                 expansion_factor: int = 4, kernel_size: int = 1,
                 final_rms: bool = False):
        super().__init__()
        hidden = embed_dim * expansion_factor
        self.linear_in = _same_conv(dimension, embed_dim, hidden, kernel_size)
        self.linear_gate = _same_conv(dimension, embed_dim, hidden,
                                      kernel_size)
        self.linear_out = _same_conv(dimension, hidden, embed_dim,
                                     kernel_size)
        self.rms = ChannelRMSNorm(embed_dim) if final_rms else None

    def forward(self, x):
        out = self.linear_out(F.silu(self.linear_in(x)) * self.linear_gate(x))
        return self.rms(out) if self.rms is not None else out


class _SwiGLU(nn.Module):
    """Dense SwiGLU on [B, d] (hidden 4·d) with a final RMSNorm whose eps
    is float32's machine epsilon, as the torch reference's."""

    def __init__(self, embed_dim: int, final_rms: bool = False):
        super().__init__()
        self.linear_in = nn.Linear(embed_dim, 4 * embed_dim)
        self.linear_gate = nn.Linear(embed_dim, 4 * embed_dim)
        self.linear_out = nn.Linear(4 * embed_dim, embed_dim)
        self.rms = (nn.RMSNorm(embed_dim,
                               eps=float(torch.finfo(torch.float32).eps))
                    if final_rms else None)

    def forward(self, x):
        out = self.linear_out(F.silu(self.linear_in(x)) * self.linear_gate(x))
        return self.rms(out) if self.rms is not None else out


class ConVitBlock(nn.Module):
    """x + fuse(attention at 1/f resolution, its depthwise-conv pathway),
    then + ConvSwiGLU; both halves see RMS-normed x plus the projected
    embedding."""

    def __init__(self, config: ConVitConfig):
        super().__init__()
        cfg = self.config = config
        nd, d, f = cfg.num_pos_dims, cfg.embed_dim, cfg.attn_compression_factor
        self.embedding_projection = (_SwiGLU(d, final_rms=True)
                                     if cfg.has_embedding else None)
        self.norm_1 = ChannelRMSNorm(d)
        self.downsample = (
            layers.holder(conv=_CONV[nd](d, d, 2 * f, stride=f))
            if cfg.with_conv_on_downsample else None)
        self.attention = ConVitAttention(d, cfg.num_heads, nd, cfg.rope_freq,
                                         cfg.relative_positioning,
                                         cfg.linear_attention)
        self.upsample = (
            layers.holder(conv=_CONV_T[nd](d, d, 2 * f, stride=f))
            if cfg.with_conv_on_upsample else None)
        self.depthwise_conv = _same_conv(nd, d, d, cfg.kernel_size_depthwise,
                                         groups=d)
        self.pointwise_conv = _CONV[nd](d, d, 1)
        self.fusion_weight = nn.Parameter(torch.zeros(()))
        self.norm_2 = ChannelRMSNorm(d)
        self.ffn = ConvSwiGLU(nd, d, cfg.ffn_expansion_factor,
                              cfg.kernel_size_conv)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.fusion_weight)

    def _down(self, h):
        f = self.config.attn_compression_factor
        if self.downsample is None:
            return _AVG_POOL[h.ndim - 2](h, f)
        # flax's 'SAME' for kernel 2f, stride f: f//2 before, the rest after
        pads = [p for _ in range(h.ndim - 2) for p in (f // 2, f - f // 2)]
        return self.downsample.conv(F.pad(h, pads))

    def _up(self, h):
        f = self.config.attn_compression_factor
        size = tuple(s * f for s in h.shape[2:])
        if self.upsample is None:
            return F.interpolate(h, size=size,
                                 mode=_LINEAR_MODE[h.ndim - 2],
                                 align_corners=False)
        # flax's 'SAME' transposed convolution (lax.conv_transpose pads
        # the dilated input by ceil((3f - 2) / 2) before): the torch
        # convolution without padding, cropped to f·size
        k = 2 * f
        start = (k - 1) - (3 * f - 1) // 2
        out = self.upsample.conv(h)
        return out[(slice(None), slice(None))
                   + tuple(slice(start, start + s) for s in size)]

    def forward(self, x, emb=None):
        cfg = self.config
        if emb is not None:
            if not cfg.has_embedding:
                raise ValueError("Conditional embedding is not supported "
                                 "when has_embedding=False")
            emb = self.embedding_projection(emb)
            emb = emb.reshape(emb.shape + (1,) * cfg.num_pos_dims)
        else:
            emb = 0.0
        x0 = x
        h = self._down(self.norm_1(x) + emb)
        h = self.attention(h.movedim(1, -1)).movedim(-1, 1)
        h = self._up(h)
        hc = self.pointwise_conv(F.silu(self.depthwise_conv(h)))
        gate = torch.sigmoid(self.fusion_weight)
        x = (1 - gate) * h + gate * hc + x0
        return self.ffn(self.norm_2(x) + emb) + x


class ConVit(nn.Module):
    """``net(x, t=None, y=None)`` with x [B, in_channels, *pos]; the time
    embedding (``has_time_embedding``) and the condition embedding
    (``has_conditional_embedding``, with ``BatchDropout`` of
    ``condition_dropout`` in training) are summed and projected in every
    block. Built on ``device`` (default: the CUDA card)."""

    def __init__(self, config: ConVitConfig,
                 conditional_embedding: nn.Module | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        nd = cfg.num_pos_dims
        out_ch = cfg.out_channels or cfg.in_channels
        self.time_embedding = (layers.GaussianFourierProjection(
            cfg.embed_dim, cfg.fourier_projection_scale)
            if cfg.has_time_embedding else None)
        self.conditional_embedding = conditional_embedding
        self.condition_dropout = (layers.BatchDropout(cfg.condition_dropout)
                                  if cfg.condition_dropout > 0.0 else None)
        self.input_batch_norm = (_BATCH_NORM[nd](cfg.in_channels,
                                                 momentum=0.01)
                                 if cfg.input_batch_norm else None)
        self.convin = _same_conv(nd, cfg.in_channels, cfg.embed_dim,
                                 cfg.kernel_size_in_out)
        self.blocks = nn.ModuleList([ConVitBlock(cfg)
                                     for _ in range(cfg.num_layers)])
        self.normout = ChannelRMSNorm(cfg.embed_dim)
        self.convout = _same_conv(nd, cfg.embed_dim, out_ch,
                                  cfg.kernel_size_in_out)
        self.to(device)

    def forward(self, x, t=None, y=None):
        cfg = self.config
        if x.ndim != cfg.num_pos_dims + 2:
            raise ValueError(f"expected [B, C, *{cfg.num_pos_dims}D pos], "
                             f"got {tuple(x.shape)}")
        emb = None
        if t is not None and self.time_embedding is not None:
            emb = self.time_embedding(t)
        if y is not None and cfg.has_conditional_embedding:
            ye = self.conditional_embedding(y)
            if self.condition_dropout is not None:
                ye = self.condition_dropout(ye)
            emb = ye if emb is None else emb + ye
        if self.input_batch_norm is not None:
            x = self.input_batch_norm(x)
        x = self.convin(x)
        for block in self.blocks:
            x = block(x, emb)
        return self.convout(self.normout(x))

    def export_description(self) -> dict[str, Any]:
        cemb = getattr(self.conditional_embedding, "export_description",
                       None)
        return dict(kind="convit", config=self.config.export_description(),
                    conditional_embedding_args=cemb() if cemb else None,
                    has_conditional_embedding=(
                        self.conditional_embedding is not None))


__all__ = ["ChannelRMSNorm", "ConVit", "ConVitAttention", "ConVitBlock",
           "ConVitConfig", "ConvSwiGLU", "LearnedRoPE"]
