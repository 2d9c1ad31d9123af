"""DDPM UNet: the architecture behind ``diffusers.UNet2DModel``, on NC*.

Port of ``diffsci_tpu/models/nets/ddpm_unet.py``: ``timestep_embedding``,
``ResnetBlock``, ``AttentionBlock``, ``DownBlock``, ``UpBlock`` and
``UNet2D``. Module and parameter names are diffusers' public state-dict
names (``time_embedding.linear_1``, ``down_blocks.{i}.resnets.{j}.norm1``,
``...attentions.{j}.to_q``, ``to_out.0``, ``downsamplers.0.conv``,
``mid_block.resnets.{0,1}``, ``mid_block.attentions.0``,
``up_blocks.{i}.upsamplers.0.conv``, ``conv_norm_out``, ``conv_out``), so a
``UNet2DModel.state_dict()`` of the same architecture loads with
``load_state_dict``.

The network takes and returns [B, C, *spatial]; torch convolutions are
rank-specific, so the number of spatial dims is given at construction
(``dimension``: 1, 2 or 3) where the JAX module infers it from its input.
The norms are torch's GroupNorm followed by SiLU, as the JAX module's are
flax's (no fused kernel). Attention: 'xla' is plain attention with a
float32 softmax; 'flash' takes kernel K4 (``kernels/flash_attention.py``)
at T ≥ 2048 tokens and plain attention below, the JAX package's gate.

Under a bf16 ``compute_dtype`` the sinusoidal embedding is computed in
float32 from the (bf16) timesteps and cast to the time MLP's dtype, as
diffusers casts it, and every layer runs in bf16. The JAX module's type
promotion instead carries every layer after the first time-bias add in
float32 (its time path stays float32), so its bf16 output lies closer to
its float32 one (tests/test_torch_ddpm.py measures both gaps).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.kernels import flash_attention
from diffsci_tpu_torch.utils import resolve_device

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}
_BACKENDS = ("xla", "flash")


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True, freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """diffusers ``get_timestep_embedding``: [sin | cos] halves over a
    log-spaced frequency ladder, [cos | sin] with ``flip_sin_to_cos``, a
    zero column appended for odd ``dim``. float32 [B, dim]."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / (
            half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class ResnetBlock(nn.Module):
    """diffusers ``ResnetBlock2D`` (time-bias variant): GN - SiLU - conv3,
    + time bias, GN - SiLU - dropout - conv3, + (1x1-conv) shortcut."""

    def __init__(self, dimension: int, in_channels: int, out_channels: int,
                 temb_channels: int, groups: int = 32, eps: float = 1e-5,
                 dropout: float = 0.0):
        super().__init__()
        conv = _CONV[dimension]
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = conv(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = conv(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (conv(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        t = self.time_emb_proj(F.silu(temb))
        h = h + t.reshape(t.shape + (1,) * (x.ndim - 2))
        h = self.conv2(self.dropout(F.silu(self.norm2(h))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock(nn.Module):
    """diffusers ``Attention`` inside Attn{Down,Up}Block2D / UNetMidBlock2D:
    GN pre-norm, biased linear q/k/v/out, ``heads = C // head_dim`` heads
    of ``head_dim``, float32 softmax, residual add."""

    def __init__(self, channels: int, head_dim: int = 8, groups: int = 32,
                 eps: float = 1e-5, backend: str = "xla"):
        super().__init__()
        if backend not in _BACKENDS:
            raise ValueError(f"attention backend must be one of {_BACKENDS}")
        self.heads = max(channels // head_dim, 1)
        self.head_dim = head_dim
        self.backend = backend
        inner = self.heads * head_dim
        self.group_norm = nn.GroupNorm(groups, channels, eps=eps)
        self.to_q = nn.Linear(channels, inner)
        self.to_k = nn.Linear(channels, inner)
        self.to_v = nn.Linear(channels, inner)
        self.to_out = nn.ModuleList([nn.Linear(inner, channels)])

    def forward(self, x):
        B, C = x.shape[:2]
        H, dh = self.heads, self.head_dim
        tokens = self.group_norm(x).reshape(B, C, -1).transpose(1, 2)

        def to_heads(a):                      # [B, T, H·dh] -> [B, H, T, dh]
            return a.reshape(B, -1, H, dh).transpose(1, 2)

        q, k, v = (to_heads(proj(tokens))
                   for proj in (self.to_q, self.to_k, self.to_v))
        if self.backend == "flash":
            o = flash_attention.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous())
        else:
            logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
            weights = torch.softmax(logits.float(), dim=-1)
            o = torch.matmul(weights.to(v.dtype), v)
        o = self.to_out[0](o.transpose(1, 2).reshape(B, -1, H * dh))
        return o.transpose(1, 2).reshape(x.shape) + x


class Downsample(nn.Module):
    """Stride-2 3x3 conv, padding 1 (``downsamplers.0``)."""

    def __init__(self, dimension: int, channels: int):
        super().__init__()
        self.conv = _CONV[dimension](channels, channels, 3, stride=2,
                                     padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x then a 3x3 conv (``upsamplers.0``)."""

    def __init__(self, dimension: int, channels: int):
        super().__init__()
        self.conv = _CONV[dimension](channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class DownBlock(nn.Module):
    """``DownBlock2D`` / ``AttnDownBlock2D``: ``num_layers`` resnets (each
    output a skip), then an optional stride-2 conv downsample (also a
    skip)."""

    def __init__(self, dimension: int, in_channels: int, out_channels: int,
                 temb_channels: int, num_layers: int = 2,
                 add_attention: bool = False, add_downsample: bool = True,
                 groups: int = 32, head_dim: int = 8, eps: float = 1e-5,
                 dropout: float = 0.0, backend: str = "xla"):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(dimension, in_channels if j == 0 else out_channels,
                        out_channels, temb_channels, groups, eps, dropout)
            for j in range(num_layers)])
        self.attentions = nn.ModuleList([
            AttentionBlock(out_channels, head_dim, groups, eps, backend)
            for _ in range(num_layers)]) if add_attention else None
        self.downsamplers = nn.ModuleList([
            Downsample(dimension, out_channels)]) if add_downsample else None

    def forward(self, x, temb):
        skips = []
        for j, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[j](x)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class UpBlock(nn.Module):
    """``UpBlock2D`` / ``AttnUpBlock2D``: ``num_layers`` resnets, each
    preceded by concatenating the matching down-path skip (latest first),
    then an optional nearest-2x + conv upsample. ``skip_channels`` lists
    the channels of the skips in the order they are taken."""

    def __init__(self, dimension: int, in_channels: int,
                 skip_channels: Sequence[int], out_channels: int,
                 temb_channels: int, add_attention: bool = False,
                 add_upsample: bool = True, groups: int = 32,
                 head_dim: int = 8, eps: float = 1e-5, dropout: float = 0.0,
                 backend: str = "xla"):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(dimension, (in_channels if j == 0 else out_channels)
                        + skip, out_channels, temb_channels, groups, eps,
                        dropout)
            for j, skip in enumerate(skip_channels)])
        self.attentions = nn.ModuleList([
            AttentionBlock(out_channels, head_dim, groups, eps, backend)
            for _ in skip_channels]) if add_attention else None
        self.upsamplers = nn.ModuleList([
            Upsample(dimension, out_channels)]) if add_upsample else None

    def forward(self, x, skips, temb):
        skips = list(skips)
        for j, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[j](x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    """``UNetMidBlock2D``: resnet, attention, resnet."""

    def __init__(self, dimension: int, channels: int, temb_channels: int,
                 groups: int, head_dim: int, eps: float, dropout: float,
                 backend: str):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(dimension, channels, channels, temb_channels, groups,
                        eps, dropout) for _ in range(2)])
        self.attentions = nn.ModuleList([
            AttentionBlock(channels, head_dim, groups, eps, backend)])

    def forward(self, x, temb):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x)
        return self.resnets[1](x, temb)


class TimestepEmbedding(nn.Module):
    """linear - SiLU - linear to ``4 * block_out_channels[0]`` features."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, channels)
        self.linear_2 = nn.Linear(channels, channels)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class UNet2D(nn.Module):
    """``diffusers.UNet2DModel`` equivalent (the HFNet-used surface), any
    spatial rank. ``attn_down`` / ``attn_up`` are per-block attention flags.
    Input [B, in_channels, *spatial] with every spatial dim divisible by
    ``2 ** (len(block_out_channels) - 1)``; t: [B] or a scalar."""

    def __init__(self, block_out_channels: Sequence[int] = (64, 128, 256),
                 in_channels: int = 1, out_channels: int = 1,
                 attn_down: Sequence[bool] = (), attn_up: Sequence[bool] = (),
                 layers_per_block: int = 2, norm_num_groups: int = 32,
                 head_dim: int = 8, norm_eps: float = 1e-5,
                 dropout: float = 0.0, flip_sin_to_cos: bool = True,
                 freq_shift: float = 0.0, backend: str = "xla",
                 dimension: int = 2,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        blocks = tuple(block_out_channels)
        n = len(blocks)
        # the constructor's arguments, for export_description
        self.block_out_channels = blocks
        self.in_channels, self.out_channels = in_channels, out_channels
        self.attn_down, self.attn_up = tuple(attn_down), tuple(attn_up)
        self.layers_per_block = layers_per_block
        self.norm_num_groups, self.head_dim = norm_num_groups, head_dim
        self.norm_eps, self.dropout = norm_eps, dropout
        self.backend, self.dimension = backend, dimension
        attn_down = tuple(attn_down) or (False,) * n
        attn_up = tuple(attn_up) or (False,) * n
        if len(attn_down) != n or len(attn_up) != n:
            raise ValueError("attn_down/attn_up must have one flag per "
                             f"block ({n}), got {attn_down}/{attn_up}")
        self.block0 = blocks[0]
        self.flip_sin_to_cos = flip_sin_to_cos
        self.freq_shift = freq_shift
        temb = 4 * blocks[0]
        common = dict(groups=norm_num_groups, head_dim=head_dim,
                      eps=norm_eps, dropout=dropout, backend=backend)

        self.conv_in = _CONV[dimension](in_channels, blocks[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(blocks[0], temb)
        skips = [blocks[0]]
        downs, cin = [], blocks[0]
        for i, ch in enumerate(blocks):
            downs.append(DownBlock(dimension, cin, ch, temb,
                                   layers_per_block,
                                   add_attention=attn_down[i],
                                   add_downsample=i < n - 1, **common))
            skips += [ch] * (layers_per_block + (i < n - 1))
            cin = ch
        self.down_blocks = nn.ModuleList(downs)
        self.mid_block = MidBlock(dimension, blocks[-1], temb, **common)
        ups, prev = [], blocks[-1]
        for i, ch in enumerate(blocks[::-1]):
            take = [skips.pop() for _ in range(layers_per_block + 1)]
            ups.append(UpBlock(dimension, prev, take, ch, temb,
                               add_attention=attn_up[i],
                               add_upsample=i < n - 1, **common))
            prev = ch
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = nn.GroupNorm(norm_num_groups, blocks[0],
                                          eps=norm_eps)
        self.conv_out = _CONV[dimension](blocks[0], out_channels, 3,
                                         padding=1)
        self.to(device)

    def export_description(self) -> dict:
        """``{"kind": "unet2d", "config": ...}`` with the JAX package's
        fields; ``dimension`` only when it is not 2 (the JAX module infers
        it from its input)."""
        from diffsci_tpu_torch.models.nets.describe import \
            plain_module_description
        desc = plain_module_description(self, "unet2d")
        if self.dimension == 2:
            del desc["config"]["dimension"]
        return desc

    def forward(self, x, t):
        t = torch.as_tensor(t, device=x.device)
        if t.ndim == 0:
            t = t.expand(x.shape[0])
        emb = timestep_embedding(t, self.block0, self.flip_sin_to_cos,
                                 self.freq_shift)
        temb = self.time_embedding(
            emb.to(self.time_embedding.linear_1.weight.dtype))

        h = self.conv_in(x)
        skips = [h]
        for block in self.down_blocks:
            h, s = block(h, temb)
            skips.extend(s)
        h = self.mid_block(h, temb)
        for block in self.up_blocks:
            per_up = len(block.resnets)
            take, skips = skips[-per_up:], skips[:-per_up]
            h = block(h, take, temb)
        return self.conv_out(F.silu(self.conv_norm_out(h)))
