"""Spatial self-attention over flattened tokens, on [B, C, *spatial].

Port of ``diffsci_tpu/models/nets/attention.py``'s default path:
``MultiHeadAttention`` (dot attention, biased projections) and
``SpatialSelfAttention``. Parameters keep ``torch.nn.MultiheadAttention``'s
names (``in_proj_weight``, ``in_proj_bias``, ``out_proj``) so the reference
state dicts load; the projections are ``F.linear`` calls and the attention
is the port's own (``kernels/flash_attention.py``), never
``nn.MultiheadAttention.forward``.

Backends: 'xla' keeps its name and means no kernel (plain PyTorch
attention); 'flash' takes kernel K4 for T ≥ 2048 tokens and plain
attention below, the JAX package's shape gate.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.kernels import flash_attention
from diffsci_tpu_torch.kernels.flash_attention import dot_product_attention

_BACKENDS = ("xla", "flash")


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention with a packed, biased q/k/v projection and
    a biased output projection."""

    def __init__(self, embed_dim: int, num_heads: int, backend: str = "xla"):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} does not split into "
                             f"{num_heads} heads")
        if backend not in _BACKENDS:
            raise ValueError(f"attention backend must be one of {_BACKENDS}")
        self.num_heads = num_heads
        self.backend = backend
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_out, fan_in = self.in_proj_weight.shape[0] // 3, \
            self.in_proj_weight.shape[1]
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        self.in_proj_weight.copy_(
            (torch.rand(self.in_proj_weight.shape, generator=generator)
             * 2 - 1) * bound)
        nn.init.zeros_(self.in_proj_bias)

    def forward(self, x):
        # x: [B, T, C]
        B, T, C = x.shape
        H = self.num_heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        qkv = qkv.view(B, T, 3, H, C // H).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                  # [B, H, T, dh]
        if self.backend == "flash":
            o = flash_attention.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous())
        else:
            o = dot_product_attention(q, k, v)
        o = o.transpose(1, 2).reshape(B, T, C)
        return F.linear(o, self.out_proj.weight, self.out_proj.bias)


class SpatialSelfAttention(nn.Module):
    """Global attention over the flattened spatial dims, any rank."""

    def __init__(self, channels: int, num_heads: int = 1,
                 attn_type: str = "default", attn_residual: bool = False,
                 magnitude_preserving: bool = False, backend: str = "xla"):
        super().__init__()
        if attn_type != "default" or magnitude_preserving:
            raise NotImplementedError(
                "cosine and magnitude-preserving attention are not ported "
                "yet")
        self.attn_residual = attn_residual
        self.mhattn = MultiHeadAttention(channels, num_heads, backend)

    def forward(self, x):
        B, C = x.shape[:2]
        tokens = x.reshape(B, C, -1).transpose(1, 2)       # [B, T, C]
        out = self.mhattn(tokens).transpose(1, 2).reshape(x.shape)
        if self.attn_residual:
            out = x + out
        return out
