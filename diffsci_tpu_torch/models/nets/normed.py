"""Magnitude-preserving (EDM2 forced-weight-norm) layers.

Port of ``diffsci_tpu/models/nets/normed.py:26-80``. A layer stores its raw
weight and applies ``normalize(w) / sqrt(fan_in)`` on every forward; the
train step re-projects the stored weights onto the sphere after the
optimizer (``models/karras/train.py:renormalize_mp_weights``). Weights are
in torch's layout, the output axis first (Linear [out, in], conv
[out, in, *k]), so the norm runs over every axis but the first where the
JAX package's HWIO / [in, out] layout has it over every axis but the last.
The parameter keeps the torch reference's name ``weight``, so its state
dicts load; the JAX package's leaf is ``w_mp`` (``convert.py`` maps it).

Hoisting: a copy of a network that runs without gradients (the sampler's
cast copy, ``models/compute.py``) takes each layer's normalized, scaled
weight once, when its masters change (``hoist_from``), and its forward
then uses the stored weight as it is. The math is the forward's; only
where it runs moves, out of every network call of a sampling loop, as XLA
hoists the loop-invariant normalization out of the JAX package's scan.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.utils import unset

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def normalize(w: torch.Tensor, eps: float = 1e-4, dim=None,
              reduce=None) -> torch.Tensor:
    """Per-output-unit normalization: divide by the vector norm over ``dim``
    (default: every axis but the first, the output axis) with
    alpha = sqrt(n_units / numel). ``reduce`` (a block of a tensor split
    across its units, ``stored``): the sums of squares -> (their sums over
    the blocks, the number of blocks)."""
    if dim is None:
        dim = tuple(range(1, w.ndim))
    sq, ranks = torch.sum(w * w, dim=dim, keepdim=True), 1
    if reduce is not None:
        sq, ranks = reduce(sq)
    n = torch.sqrt(sq)
    alpha = math.sqrt(n.numel() / (w.numel() * ranks))
    return w / (eps + alpha * n)


def stored(module: nn.Module, name: str) -> tuple:
    """(the tensor ``module`` stores as ``name``, the ``reduce`` that
    ``normalize`` over its ``unit_dims()`` takes for it, or None). A
    layout that stores a block of it split across its units registers that
    reduce in ``module.unit_sums`` (FSDP, ``parallel/fsdp.py``)."""
    return (module._parameters[name],
            getattr(module, "unit_sums", {}).get(name))


class _MagnitudePreserving(nn.Module):
    """A raw ``weight`` (normal(1) init), an optional zero ``bias``, and
    the effective weight normalize(w) / sqrt(fan_in)."""
    hoisted = False

    def _init_weight(self, shape, use_bias: bool) -> None:
        self.weight = nn.Parameter(unset(*shape))
        self.bias = nn.Parameter(torch.zeros(shape[0])) if use_bias else None
        self.fan_in = self.weight[0].numel()

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator))
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def effective_weight(self) -> torch.Tensor:
        if self.hoisted:
            return self.weight
        return normalize(self.weight) / math.sqrt(self.fan_in)

    def unit_dims(self) -> dict:
        """name -> the dims a unit's norm sums over: the weight's all but
        the output axis."""
        return {"weight": tuple(range(1, self._parameters["weight"].ndim))}

    @torch.no_grad()
    def hoist_from(self, master: "_MagnitudePreserving") -> None:
        """Store ``master``'s effective weight (in this copy's dtype) and
        use it as it is from now on."""
        w, reduce = stored(master, "weight")
        self._parameters["weight"].copy_(
            normalize(w, reduce=reduce) / math.sqrt(self.fan_in))
        self.hoisted = True

    @torch.no_grad()
    def renormalize_(self, eps: float = 1e-4) -> None:
        """Re-project the stored weight onto the unit sphere."""
        w, reduce = stored(self, "weight")
        w.copy_(normalize(w, eps, reduce=reduce))


class MagnitudePreservingDense(_MagnitudePreserving):
    """y = x · (normalize(w) / sqrt(in))ᵀ + b."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True):
        super().__init__()
        self._init_weight((out_features, in_features), use_bias)

    def forward(self, x):
        return F.linear(x, self.effective_weight(), self.bias)


class MagnitudePreservingConv(_MagnitudePreserving):
    """Stride-1 'SAME' convolution by normalize(w) / sqrt(in · k^d), on
    [B, C, *spatial]."""

    def __init__(self, dimension: int, in_channels: int, out_channels: int,
                 kernel_size: int, use_bias: bool = True):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"'SAME' padding needs an odd kernel size, got "
                             f"{kernel_size}")
        self.dimension = dimension
        self.padding = kernel_size // 2
        self._init_weight((out_channels, in_channels)
                          + (kernel_size,) * dimension, use_bias)

    def forward(self, x):
        return _CONV[self.dimension](x, self.effective_weight(), self.bias,
                                     padding=self.padding)
