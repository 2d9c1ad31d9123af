"""Training-time noise-level sampler and loss weight lambda(sigma).

Port of ``diffsci_tpu/ops/noise_samplers.py:16-48``: the EDM sampler's
parameters and loss weight, which ``KarrasModelConfig.from_edm`` holds.
The log-normal sigma draw arrives with the training slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NoiseSampler:
    def loss_weighting(self, sigma):
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
