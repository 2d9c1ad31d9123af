"""Toy MLP noise networks on [B, dim] inputs.

Port of ``diffsci_tpu/models/nets/mlp.py``: ``MLPUncond`` (concat(x, t))
and ``MLPCond`` (concat(x, t, y)), a Linear/ReLU stack whose parameters
keep the reference's ``net.{i}`` names (``net.0``, ``net.2``, ...), so its
state dicts load directly. Dropout, when asked for, is applied after each
ReLU without a slot in ``net``, so the names do not move.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.utils import resolve_device


class _MLP(nn.Module):
    """[x, t, ...] of width dim + extra -> hidden Linear/ReLU stack -> dim."""

    def __init__(self, dim: int, extra: int, hidden_dims: Sequence[int],
                 dropout: float, device):
        super().__init__()
        self.dim, self.hidden_dims = dim, tuple(hidden_dims)
        widths = [dim + extra] + list(hidden_dims)
        layers = []
        for i, o in zip(widths[:-1], widths[1:]):
            layers += [nn.Linear(i, o), nn.ReLU()]
        self.net = nn.Sequential(*layers, nn.Linear(widths[-1], dim))
        self.dropout = dropout
        self.to(resolve_device(device))

    def export_description(self) -> dict:
        """``{"kind": "mlp" or "mlp_cond", "config": ...}`` with the JAX
        package's fields."""
        from diffsci_tpu_torch.models.nets.describe import \
            plain_module_description
        return plain_module_description(self, self.kind)

    def _stack(self, h):
        for layer in self.net:
            h = layer(h)
            if isinstance(layer, nn.ReLU) and self.dropout > 0:
                h = F.dropout(h, self.dropout, self.training)
        return h


class MLPUncond(_MLP):
    """concat(x, t) -> hidden stack -> dim; t defaults to zeros."""
    kind = "mlp"

    def __init__(self, dim: int, hidden_dims: Sequence[int] = (10,),
                 dropout: float = 0.0,
                 device: torch.device | str | None = None):
        super().__init__(dim, 1, hidden_dims, dropout, device)

    def forward(self, x, t=None, y=None):
        if t is None:
            t = torch.zeros(x.shape[:1], dtype=x.dtype, device=x.device)
        return self._stack(torch.cat([x, t[..., None]], dim=-1))


class MLPCond(_MLP):
    """concat(x, t, y) -> hidden stack -> dim; y [B, ydim] or [1, ydim]
    (broadcast over the batch), a dict holding it under "y", or zeros when
    absent."""
    kind = "mlp_cond"

    def __init__(self, dim: int, ydim: int,
                 hidden_dims: Sequence[int] = (10,), dropout: float = 0.0,
                 device: torch.device | str | None = None):
        super().__init__(dim, 1 + ydim, hidden_dims, dropout, device)
        self.ydim = ydim

    def forward(self, x, t=None, y=None):
        B = x.shape[0]
        if t is None:
            t = torch.zeros((B,), dtype=x.dtype, device=x.device)
        if y is None:
            y = torch.zeros((B, self.ydim), dtype=x.dtype, device=x.device)
        if isinstance(y, dict):
            y = y["y"]
        y = y.expand((B,) + tuple(y.shape[1:]))
        return self._stack(torch.cat([x, t[..., None], y], dim=-1))
