"""Physics conditioning embedders for porous-media generation.

Port of ``diffsci_tpu/models/nets/embedders.py:20-216``: positional
encoding, two-point correlation and pore-size distribution curves (plain
and through a post-LN transformer encoder), the porosity scalar, a
composite that sums sub-embeddings over one condition dict, and the
date/geo Fourier projections. A condition is a dict of tensors (curves
[B, T], porosity [B] or [B, 1]); an embedder returns [B, dembed] (or
[B, T, dembed] for an unreduced curve). Module names are the torch
reference's (``pos_encoder``, ``gaussian_proj``, ``net.{i}``,
``encoder.layers.{i}.self_attn`` / ``linear1`` / ``linear2`` / ``norm1`` /
``norm2``, ``embedder``), so its state dicts load; the reference's
``pos_encoder.div_term`` buffer is not kept (the encoding recomputes it,
as the JAX package does).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.models.nets.attention import MultiHeadAttention
from diffsci_tpu_torch.models.nets.layers import GaussianFourierProjection


def _mlp(widths: Sequence[int]) -> nn.Sequential:
    """Linear/SiLU stack over ``widths`` (``net.0``, ``net.2``, ...)."""
    mods = []
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        if i:
            mods.append(nn.SiLU())
        mods.append(nn.Linear(a, b))
    return nn.Sequential(*mods)


class PositionalEncoding1d(nn.Module):
    """Interleaved sin/cos positions: x [...] -> [..., dembed]."""

    def __init__(self, dembed: int, denominator: float = 10000.0):
        super().__init__()
        self.dembed = dembed
        self.denominator = denominator

    def forward(self, x):
        idx = torch.arange(0, self.dembed, 2, device=x.device,
                           dtype=torch.float32)
        div = torch.pow(torch.tensor(self.denominator, device=x.device),
                        idx / self.dembed).to(x.dtype)
        s = torch.sin(x[..., None] / div)
        c = torch.cos(x[..., None] / div)
        return torch.stack([s, c], dim=-1).reshape(
            tuple(x.shape) + (self.dembed,))

    def export_description(self):
        return {"dembed": self.dembed, "denominator": self.denominator}


class _CurveEmbedder(nn.Module):
    """Positions of the curve's abscissae plus Fourier features of its
    values, optionally mean-reduced over the curve."""
    keys: tuple = ()

    def __init__(self, dembed: int, reduction: str | None = None,
                 scale: float = 30.0):
        super().__init__()
        self.dembed, self.reduction, self.scale = dembed, reduction, scale
        self.pos_encoder = PositionalEncoding1d(dembed)
        self.gaussian_proj = GaussianFourierProjection(dembed, scale)

    def _values(self, v):
        return v

    def forward(self, data):
        pos, val = (data[k] for k in self.keys)
        x = self.pos_encoder(pos) + self.gaussian_proj(self._values(val))
        if self.reduction == "mean":
            x = x.mean(dim=-2)
        return x

    def export_description(self):
        return {"dembed": self.dembed, "reduction": self.reduction,
                "scale": self.scale}


class TwoPointCorrelationEmbedder(_CurveEmbedder):
    """Embed (distance, probability) curves: ``tpc_dist``, ``tpc_prob``."""
    keys = ("tpc_dist", "tpc_prob")

    def _values(self, prob):
        return -torch.log(prob + 1e-6)


class PoreSizeDistEmbedder(_CurveEmbedder):
    """Embed pore-size distributions: ``psd_centers``, ``psd_cdf``."""
    keys = ("psd_centers", "psd_cdf")


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer with torch.nn.TransformerEncoderLayer's
    defaults (ReLU) and names, flax's LayerNorm epsilon (1e-6):
    x = norm1(x + MHA(x)), then x = norm2(x + linear2(relu(linear1(x))))."""

    def __init__(self, dmodel: int, nhead: int, ffn_expansion: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(dmodel, nhead)
        self.linear1 = nn.Linear(dmodel, dmodel * ffn_expansion)
        self.linear2 = nn.Linear(dmodel * ffn_expansion, dmodel)
        self.norm1 = nn.LayerNorm(dmodel, eps=1e-6)
        self.norm2 = nn.LayerNorm(dmodel, eps=1e-6)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class TransformerEncoder(nn.Module):
    def __init__(self, dmodel: int, nhead: int, ffn_expansion: int,
                 num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(dmodel, nhead, ffn_expansion)
            for _ in range(num_layers)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class _CurveTransformer(nn.Module):
    """Sequence attention over a curve's points, mean-pooled."""
    embedder_cls = None

    def __init__(self, dembed: int, nhead: int = 4, ffn_expansion: int = 4,
                 num_layers: int = 2, scale: float = 30.0):
        super().__init__()
        self.dembed, self.nhead = dembed, nhead
        self.ffn_expansion, self.num_layers = ffn_expansion, num_layers
        self.embedder = self.embedder_cls(dembed, None, scale)
        self.encoder = TransformerEncoder(dembed, nhead, ffn_expansion,
                                          num_layers)

    def forward(self, data):
        return self.encoder(self.embedder(data)).mean(dim=-2)

    def export_description(self):
        return {"dembed": self.dembed, "nhead": self.nhead,
                "ffn_expansion": self.ffn_expansion,
                "num_layers": self.num_layers}


class TwoPointCorrelationTransformer(_CurveTransformer):
    embedder_cls = TwoPointCorrelationEmbedder


class PoreSizeDistTransformer(_CurveTransformer):
    embedder_cls = PoreSizeDistEmbedder


class PorosityEmbedder(nn.Module):
    """Scalar porosity conditioner (``porosity``, [B] or [B, 1]): Fourier
    features, then Linear/SiLU dembed -> 4·dembed -> 4·dembed -> dembed."""

    def __init__(self, dembed: int, scale: float = 30.0):
        super().__init__()
        self.dembed, self.scale = dembed, scale
        self.gaussian_proj = GaussianFourierProjection(dembed, scale)
        self.net = _mlp([dembed, 4 * dembed, 4 * dembed, dembed])

    def forward(self, data):
        x = data["porosity"]
        if x.ndim >= 1 and x.shape[-1] == 1:
            x = x[..., 0]
        return self.net(self.gaussian_proj(x))

    def export_description(self):
        return {"dembed": self.dembed, "scale": self.scale}


class CompositeEmbedder(nn.Module):
    """Sum of sub-embeddings over the same condition dict."""

    def __init__(self, embedders: Sequence[nn.Module]):
        super().__init__()
        self.embedders = nn.ModuleList(embedders)

    def forward(self, data):
        out = None
        for emb in self.embedders:
            e = emb(data)
            out = e if out is None else out + e
        return out

    def export_description(self):
        return {f"embedder_{i}": e.export_description()
                for i, e in enumerate(self.embedders)
                if hasattr(e, "export_description")}


class DateGaussianFourierProjection(nn.Module):
    """Day-of-year cyclic embedding: (sin, cos) of the year's phase, then
    Linear/SiLU/Linear."""

    def __init__(self, embed_dim: int, scale: float = 30.0):
        super().__init__()
        self.net = _mlp([2, embed_dim, embed_dim])

    def forward(self, day_of_year):
        phase = 2 * math.pi * day_of_year / 365.25
        return self.net(torch.stack([torch.sin(phase), torch.cos(phase)],
                                    dim=-1))


class GeoGaussianFourierProjection(nn.Module):
    """Lat/lon (degrees, [..., 2]) embedding through the unit sphere's
    xyz, then Linear/SiLU/Linear."""

    def __init__(self, embed_dim: int, scale: float = 30.0):
        super().__init__()
        self.net = _mlp([3, embed_dim, embed_dim])

    def forward(self, latlon):
        lat = torch.deg2rad(latlon[..., 0])
        lon = torch.deg2rad(latlon[..., 1])
        xyz = torch.stack([torch.cos(lat) * torch.cos(lon),
                           torch.cos(lat) * torch.sin(lon),
                           torch.sin(lat)], dim=-1)
        return self.net(xyz)
