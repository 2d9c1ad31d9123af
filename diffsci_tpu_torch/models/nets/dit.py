"""DiT: patchify -> adaLN transformer blocks -> unpatchify, on [B, C, H, W].

Port of ``diffsci_tpu/models/nets/dit.py``: ``patchify``, ``unpatchify``,
``adaln_modulate``, ``positional_encoding_2d``, ``DiTBlock`` and
``DiffusionTransformer`` (``embed`` -> blocks -> ``head``). The network
takes and returns [B, C, H, W]; a token's features are flattened in the
JAX package's (p1, p2, C) order, so the converted ``token_embed`` and
``token_head`` weights line up. The attention is the port's
``MultiHeadAttention`` (packed, biased projections), so
``attn_backend='flash'`` runs kernels K4-K6 at T ≥ 2048 tokens. As in the
JAX package the 2D sin/cos positions are added after the token embedding
and the constructor's arguments are keyword-only.

Parameter names (there is no torch reference state dict of this net):
``time_proj`` (buffer ``W``), ``time_mlp_in/mid/out``, ``token_embed``,
``blocks.{i}`` (``adaln``, ``norm1``, ``attn``, ``norm2``, ``mlp_in``,
``mlp_out``) and ``token_head``; ``convert.from_jax_variables`` maps the
JAX package's onto them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.models.nets import layers
from diffsci_tpu_torch.models.nets.attention import MultiHeadAttention
from diffsci_tpu_torch.utils import resolve_device


def patchify(x, patch_size: int):
    """[B, C, H, W] -> [B, (H/p)·(W/p), p·p·C] tokens, each token's
    features in (p1, p2, C) order."""
    B, C, H, W = x.shape
    p = patch_size
    x = x.reshape(B, C, H // p, p, W // p, p)
    x = x.permute(0, 2, 4, 3, 5, 1)            # B, h, w, p1, p2, C
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify(x, patch_size: int, H: int, W: int, C: int):
    """Inverse of ``patchify``: [B, T, p·p·C] -> [B, C, H, W]."""
    B = x.shape[0]
    p = patch_size
    x = x.reshape(B, H // p, W // p, p, p, C)
    x = x.permute(0, 5, 1, 3, 2, 4)            # B, C, h, p1, w, p2
    return x.reshape(B, C, H, W)


def adaln_modulate(x, shift, scale):
    """x·(1 + scale) + shift, per sample over the tokens."""
    return x * (1 + scale[:, None]) + shift[:, None]


def positional_encoding_2d(h: int, w: int, dembed: int,
                           denominator: float = 10000.0) -> np.ndarray:
    """2D interleaved sin/cos positions [h·w, dembed] (float64): the
    sin/cos of each token's row, then of its column, over dembed/4
    frequencies."""
    return _positions(h, w, dembed, torch.zeros((), dtype=torch.float64),
                      denominator).numpy()


def _positions(h: int, w: int, dembed: int, like,
               denominator: float = 10000.0) -> torch.Tensor:
    """``positional_encoding_2d`` computed on ``like``'s device in float64
    and cast to its dtype (no host copy, so a CUDA graph can capture
    it)."""
    d1 = dembed // 2
    idx = torch.arange(0, d1, 2, dtype=torch.float64, device=like.device)
    div = denominator ** (idx / d1)

    def encode(pos):
        a = pos[:, None] / div
        return torch.stack([torch.sin(a), torch.cos(a)], dim=-1).reshape(
            pos.shape[0], -1)

    rows = torch.arange(h, dtype=torch.float64,
                        device=like.device).repeat_interleave(w)
    cols = torch.arange(w, dtype=torch.float64, device=like.device).repeat(h)
    return torch.cat([encode(rows), encode(cols)], dim=-1).to(like.dtype)


class DiTBlock(nn.Module):
    """adaLN block: the conditioning's SiLU through ``adaln`` gives shift,
    scale and gate for the attention half and the MLP half. The
    LayerNorms take flax's eps, 1e-6."""

    def __init__(self, nembed: int, nheads: int, mlp_factor: int = 4,
                 attn_backend: str = "xla"):
        super().__init__()
        self.adaln = nn.Linear(nembed, 6 * nembed)
        self.norm1 = nn.LayerNorm(nembed, eps=1e-6)
        self.attn = MultiHeadAttention(nembed, nheads, attn_backend)
        self.norm2 = nn.LayerNorm(nembed, eps=1e-6)
        self._build_mlp(nembed, mlp_factor)

    def _build_mlp(self, nembed: int, mlp_factor: int) -> None:
        self.mlp_in = nn.Linear(nembed, mlp_factor * nembed)
        self.mlp_out = nn.Linear(mlp_factor * nembed, nembed)

    def mlp(self, h):
        return self.mlp_out(F.silu(self.mlp_in(h)))

    def forward(self, x, c):
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaln(F.silu(c)).chunk(6, dim=-1)
        h = adaln_modulate(self.norm1(x), shift_msa, scale_msa)
        x = x + gate_msa[:, None] * self.attn(h)
        h = adaln_modulate(self.norm2(x), shift_mlp, scale_mlp)
        return x + gate_mlp[:, None] * self.mlp(h)


class DiffusionTransformer(nn.Module):
    """``net(x, t=None, y=None)`` with x [B, nchannels, H, W] (H and W
    multiples of ``patch_size``), t [B] and y an embedding [B, nembed]
    (or ``{"y": ...}``) added to the time embedding. Built on ``device``
    (default: the CUDA card)."""

    def __init__(self, *, nembed: int = 64, nheads: int = 4,
                 mlp_factor: int = 4, nblocks: int = 6, patch_size: int = 4,
                 nchannels: int = 1, attn_backend: str = "xla",
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        self.nembed = nembed
        self.nheads = nheads
        self.mlp_factor = mlp_factor
        self.nblocks = nblocks
        self.patch_size = patch_size
        self.nchannels = nchannels
        self.attn_backend = attn_backend
        self.time_proj = layers.GaussianFourierProjection(nembed)
        self.time_mlp_in = nn.Linear(nembed, 4 * nembed)
        self.time_mlp_mid = nn.Linear(4 * nembed, 4 * nembed)
        self.time_mlp_out = nn.Linear(4 * nembed, nembed)
        self.token_embed = nn.Linear(nchannels * patch_size ** 2, nembed)
        self.blocks = nn.ModuleList(self._blocks())
        self.token_head = nn.Linear(nembed, nchannels * patch_size ** 2)
        self.to(device)

    def _blocks(self) -> list:
        return [DiTBlock(self.nembed, self.nheads, self.mlp_factor,
                         self.attn_backend) for _ in range(self.nblocks)]

    def embed(self, x, t=None, y=None):
        """Everything before the blocks: the time embedding (plus y), and
        the patch tokens with their positions. Returns (tokens, te)."""
        B, C, H, W = x.shape
        if C != self.nchannels:
            raise ValueError(f"input has {C} channels but nchannels="
                             f"{self.nchannels}")
        if t is None:
            t = x.new_zeros((B,))
        te = self.time_proj(t)
        h = F.silu(self.time_mlp_in(te))
        h = F.silu(self.time_mlp_mid(h))
        te = te + self.time_mlp_out(h)
        if y is not None:
            te = te + (y["y"] if isinstance(y, dict) else y)
        tokens = self.token_embed(patchify(x, self.patch_size))
        p = self.patch_size
        tokens = tokens + _positions(H // p, W // p, self.nembed,
                                     tokens)[None]
        return tokens, te

    def head(self, tokens, H: int, W: int):
        """Everything after the blocks: the output projection and
        unpatchify back to [B, nchannels, H, W]."""
        return unpatchify(self.token_head(tokens), self.patch_size, H, W,
                          self.nchannels)

    def forward(self, x, t=None, y=None):
        H, W = x.shape[2:]
        tokens, te = self.embed(x, t, y)
        for block in self.blocks:
            tokens = block(tokens, te)
        return self.head(tokens, H, W)

    def export_description(self) -> dict[str, Any]:
        return dict(kind="dit", config=dict(
            nembed=self.nembed, nheads=self.nheads,
            mlp_factor=self.mlp_factor, nblocks=self.nblocks,
            patch_size=self.patch_size, nchannels=self.nchannels,
            attn_backend=self.attn_backend))


__all__ = ["DiTBlock", "DiffusionTransformer", "adaln_modulate",
           "patchify", "positional_encoding_2d", "unpatchify"]
