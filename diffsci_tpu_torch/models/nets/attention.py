"""Spatial self-attention over flattened tokens, on [B, C, *spatial].

Port of ``diffsci_tpu/models/nets/attention.py``. Two modules hold the
projections:
- ``MultiHeadAttention``: the 'default' path (dot attention, biased
  projections). Parameters keep ``torch.nn.MultiheadAttention``'s names
  (``in_proj_weight``, ``in_proj_bias``, ``out_proj``) so the reference
  state dicts load; the projections are ``F.linear`` calls and the
  attention is the port's own (``kernels/flash_attention.py``), never
  ``nn.MultiheadAttention.forward``.
- ``EinsumMultiHeadAttention``: the reference's in-house module of the
  cosine and magnitude-preserving paths, per-head projections
  ``{q,k,v,o}_proj_matrix`` [H, C, dh] without biases, each divided by
  sqrt(fan_in) (``fan_in_scaled``) and, when magnitude preserving,
  normalized first (``_norm_weight``).

Backends: 'xla' keeps its name and means no kernel (plain PyTorch
attention); 'flash' takes kernel K4 for dot attention at T ≥ 2048 tokens
and plain attention below, the JAX package's shape gate. Cosine attention
is plain in both packages.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.kernels import flash_attention
from diffsci_tpu_torch.kernels.flash_attention import dot_product_attention
from diffsci_tpu_torch.models.nets.normed import normalize, stored
from diffsci_tpu_torch.utils import unset

_BACKENDS = ("xla", "flash")


def _norm_dims(kind: str) -> tuple:
    return (1,) if kind in ("q", "k", "v") else (0, 2)


def _norm_weight(w, kind: str, eps: float = 1e-4, reduce=None):
    """Magnitude-preserving projection normalization of w [H, C, dh]: q, k
    and v over the model axis (1), o over (heads, dhead)."""
    return normalize(w, eps, dim=_norm_dims(kind), reduce=reduce)


def cosine_attention(q, k, v, eps: float = 1e-8):
    """Cosine-similarity attention: softmax of the unit-normalized q kᵀ,
    unscaled, times v; q, k, v: [..., T, d]."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + eps)
    k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + eps)
    logits = torch.matmul(q, k.transpose(-1, -2))
    return torch.matmul(torch.softmax(logits, dim=-1), v)


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
        self.in_proj_weight = nn.Parameter(unset(3 * embed_dim, embed_dim))
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
        return self.out_proj(o)


class EinsumMultiHeadAttention(nn.Module):
    """Self-attention with per-head projection tensors [H, C, dh]
    (``q_proj_matrix``, ..., ``o_proj_matrix``), no biases. ``attn_type``
    'dot' or 'cosine'. The projections are divided by sqrt(C) (q, k, v)
    and sqrt(H·dh) (o) when ``fan_in_scaled`` or ``magnitude_preserving``,
    and normalized first when ``magnitude_preserving``. A copy without
    gradients may hoist those weights (``hoist_from``, see
    ``models/nets/normed.py``)."""
    hoisted = False

    def __init__(self, embed_dim: int, num_heads: int,
                 attn_type: str = "dot", magnitude_preserving: bool = False,
                 fan_in_scaled: bool = False, backend: str = "xla"):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} does not split into "
                             f"{num_heads} heads")
        if backend not in _BACKENDS:
            raise ValueError(f"attention backend must be one of {_BACKENDS}")
        if attn_type not in ("dot", "cosine"):
            raise ValueError(f"attn_type must be 'dot' or 'cosine', got "
                             f"{attn_type!r}")
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.attn_type = attn_type
        self.magnitude_preserving = magnitude_preserving
        self.scaled = fan_in_scaled or magnitude_preserving
        self.backend = backend
        shape = (num_heads, embed_dim, embed_dim // num_heads)
        for n in "qkvo":
            setattr(self, f"{n}_proj_matrix",
                    nn.Parameter(unset(*shape)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal(1) when magnitude preserving, else Glorot uniform over
        fan_in = H·C, fan_out = H·dh (flax's xavier_uniform on the last
        two axes)."""
        for n in "qkvo":
            w = getattr(self, f"{n}_proj_matrix")
            if self.magnitude_preserving:
                w.copy_(torch.randn(w.shape, generator=generator))
            else:
                H, C, dh = w.shape
                bound = math.sqrt(6.0 / (H * C + H * dh))
                w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1)
                        * bound)

    def unit_dims(self) -> dict:
        """name -> the dims a unit's norm sums over (``_norm_weight``)."""
        return {f"{n}_proj_matrix": _norm_dims(n) for n in "qkvo"}

    def projections(self) -> list:
        """The effective q, k, v, o projection tensors."""
        ws = [getattr(self, f"{n}_proj_matrix") for n in "qkvo"]
        return ws if self.hoisted else self._effective(ws, (None,) * 4)

    def _effective(self, ws, reduces) -> list:
        """The effective projections of the raw ``ws`` (``reduces``: of
        blocks split across their units, ``stored``)."""
        if self.magnitude_preserving:
            ws = [_norm_weight(w, n, reduce=r)
                  for w, n, r in zip(ws, "qkvo", reduces)]
        if self.scaled:
            H, C = self.num_heads, self.embed_dim
            ws = [w / math.sqrt(C) for w in ws[:3]] + \
                [ws[3] / math.sqrt(H * (C // H))]
        return list(ws)

    @torch.no_grad()
    def hoist_from(self, master: "EinsumMultiHeadAttention") -> None:
        ws, reduces = zip(*(stored(master, f"{n}_proj_matrix")
                            for n in "qkvo"))
        for n, w in zip("qkvo", master._effective(ws, reduces)):
            self._parameters[f"{n}_proj_matrix"].copy_(w)
        self.hoisted = True

    @torch.no_grad()
    def renormalize_(self, eps: float = 1e-4) -> None:
        """Re-project magnitude-preserving projections onto the sphere."""
        if self.magnitude_preserving:
            for n in "qkvo":
                w, reduce = stored(self, f"{n}_proj_matrix")
                w.copy_(_norm_weight(w, n, eps, reduce))

    def forward(self, x):
        # x: [B, T, C]
        wq, wk, wv, wo = self.projections()
        q = torch.einsum("btc,hcd->bhtd", x, wq)
        k = torch.einsum("btc,hcd->bhtd", x, wk)
        v = torch.einsum("btc,hcd->bhtd", x, wv)
        if self.attn_type == "cosine":
            o = cosine_attention(q, k, v)
        elif self.backend == "flash":
            o = flash_attention.flash_attention(q.contiguous(),
                                                k.contiguous(),
                                                v.contiguous())
        else:
            o = dot_product_attention(q, k, v)
        return torch.einsum("bhtd,hcd->btc", o, wo)


class SpatialSelfAttention(nn.Module):
    """Global attention over the flattened spatial dims, any rank:
    ``MultiHeadAttention`` for attn_type 'default' without magnitude
    preservation, else the in-house ``EinsumMultiHeadAttention`` (cosine
    when attn_type is 'cosine', dot otherwise)."""

    def __init__(self, channels: int, num_heads: int = 1,
                 attn_type: str = "default", attn_residual: bool = False,
                 magnitude_preserving: bool = False, backend: str = "xla"):
        super().__init__()
        self.attn_residual = attn_residual
        if attn_type == "default" and not magnitude_preserving:
            self.mhattn = MultiHeadAttention(channels, num_heads, backend)
        else:
            self.mhattn = EinsumMultiHeadAttention(
                channels, num_heads,
                attn_type="cosine" if attn_type == "cosine" else "dot",
                magnitude_preserving=magnitude_preserving,
                fan_in_scaled=True, backend=backend)

    def forward(self, x):
        B, C = x.shape[:2]
        tokens = x.reshape(B, C, -1).transpose(1, 2)       # [B, T, C]
        out = self.mhattn(tokens).transpose(1, 2).reshape(x.shape)
        if self.attn_residual:
            out = x + out
        return out
