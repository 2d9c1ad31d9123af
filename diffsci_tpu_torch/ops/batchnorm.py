"""EDM batch normalizers: whiten data into the sigma_data scale before
diffusion.

Port of ``diffsci_tpu/ops/batchnorm.py:16-84``. Data are channels-last
([B, *spatial, C]), as ``KarrasModel`` holds them. The running ``mean`` and
``var`` are buffers. The JAX module returns its statistics' update as a
mutable collection; here ``batch_statistics`` and ``momentum_update``
compute it and the caller writes it into the buffers (the train step does,
after the backward pass), so a loss that runs twice (``remat``) updates
them once. Over a mesh (``batch_ranks`` > 1, which ``parallel.replicate``
sets on the network of the train state it places) the batch statistics
are summed over the ranks of the default process group.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn



class DimensionAgnosticBatchNorm(nn.Module):
    """Per-channel running-stat normalizer that also rescales to ``sigma``.
    ``num_channels=None`` keeps one scalar mean and variance."""

    def __init__(self, num_channels: int | None = None, eps: float = 1e-5,
                 affine: bool = False, momentum: float = 0.1,
                 sigma: float = 1.0):
        super().__init__()
        nc = num_channels if num_channels is not None else 1
        self.num_channels = num_channels
        self.eps = eps
        self.affine = affine
        self.momentum = momentum
        self.sigma = sigma
        # the ranks whose rows make one batch (``parallel.replicate``)
        self.batch_ranks = 1
        self.register_buffer("mean", torch.zeros(nc))
        self.register_buffer("var", torch.ones(nc))
        if affine:
            self.weight = nn.Parameter(torch.ones(nc))
            self.bias = nn.Parameter(torch.zeros(nc))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mean.zero_()
        self.var.fill_(1.0)
        if self.affine:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)

    def batch_statistics(self, x):
        """Mean and population variance of ``x`` (``jnp.var``: divided by
        the count, not count - 1), over every axis but the channels (the
        last) or over all of them, each of shape [num_channels or 1].
        Over ``batch_ranks`` > 1 ranks, over every rank's rows (a rank
        whose rows repeat another's adds a copy of its terms to both sums
        and to the count)."""
        dims = tuple(range(x.ndim - 1)) if self.num_channels is not None \
            else tuple(range(x.ndim))
        nc = self.mean.shape[0]
        if self.batch_ranks == 1:
            mean = x.mean(dim=dims)
            var = x.var(dim=dims, unbiased=False)
        else:
            # x is one rank's rows, and the statistics are the global
            # batch's (two-pass, as jnp.var)
            from torch.distributed.nn.functional import all_reduce
            count = self.batch_ranks * (x.numel() // math.prod(
                x.shape[d] for d in range(x.ndim) if d not in dims))
            mean = all_reduce(x.sum(dim=dims)) / count
            var = all_reduce(((x - mean) ** 2).sum(dim=dims)) / count
        return mean.reshape(-1).expand(nc), var.reshape(-1).expand(nc)

    def momentum_update(self, mean, var) -> dict:
        """The running statistics after one batch's ``mean`` and ``var``,
        by buffer name (not written)."""
        m = self.momentum
        return {"mean": (1 - m) * self.mean + m * mean,
                "var": (1 - m) * self.var + m * var}

    def forward(self, x, use_running_stats: bool = True):
        """(x - mean) / sqrt(var + eps), affine, times ``sigma``: by the
        running statistics, or by ``x``'s own when ``use_running_stats`` is
        False."""
        if use_running_stats:
            mean, var = self.mean, self.var
        else:
            mean, var = self.batch_statistics(x)
        if self.num_channels is None:
            mean, var = mean[0], var[0]
        x = (x - mean) / torch.sqrt(var + self.eps)
        if self.affine:
            x = x * self.weight + self.bias
        return x * self.sigma

    def unnormalize(self, x):
        """The inverse by the stored statistics."""
        x = x / self.sigma
        if self.affine:
            x = (x - self.bias) / self.weight
        mean, var = self.mean, self.var
        if self.num_channels is None:
            mean, var = mean[0], var[0]
        return x * torch.sqrt(var + self.eps) + mean


class ConstantBatchNorm:
    """normalize = x / sigma."""

    def __init__(self, sigma: float = 1.0):
        self.sigma = sigma

    def normalize(self, x):
        return x / self.sigma

    def unnormalize(self, x):
        return x * self.sigma


class IdentityBatchNorm:

    def normalize(self, x):
        return x

    def unnormalize(self, x):
        return x
