"""Training-time noise-level sampler and loss weight lambda(sigma).

Port of ``diffsci_tpu/ops/noise_samplers.py:16-48``: the EDM sampler's
log-normal sigma draw and loss weight. The draw takes an explicit
``torch.Generator`` in place of a JAX key.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class NoiseSampler:
    def loss_weighting(self, sigma):
        raise NotImplementedError

    def sample(self, shape, generator=None, device=None, out=None):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class EDMNoiseSampler(NoiseSampler):
    """Log-normal sigma; lambda = (sigma^2 + sigma_d^2) / (sigma sigma_d)^2."""
    sigma_data: float = 0.5
    prior_mean: float = -1.2
    prior_std: float = 1.2
    tag = "edm"

    def loss_weighting(self, sigma):
        return (sigma ** 2 + self.sigma_data ** 2) / (
            (sigma * self.sigma_data) ** 2)

    def sample(self, shape, generator=None, device=None, out=None):
        """sigma = exp(N(prior_mean, prior_std^2)) of ``shape``, drawn with
        ``generator`` on ``device`` (the generator's device by default), or
        into ``out`` (a CUDA graph's static input) with the same numbers."""
        if out is None:
            if device is None and generator is not None:
                device = generator.device
            out = torch.empty(shape, device=device)
        torch.randn(shape, generator=generator, out=out)
        return out.mul_(self.prior_std).add_(self.prior_mean).exp_()
