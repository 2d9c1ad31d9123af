"""Karras preconditioners: c_skip / c_out / c_in / c_noise.

Port of ``diffsci_tpu/ops/preconditioners.py:18-62`` (the base class and
the EDM preconditioner) on torch tensors.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class KarrasPreconditioner:
    def skip_scaling(self, sigma):
        raise NotImplementedError

    def output_scaling(self, sigma):
        raise NotImplementedError

    def input_scaling(self, sigma):
        raise NotImplementedError

    def noise_conditioner(self, sigma):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class EDMPreconditioner(KarrasPreconditioner):
    """Karras et al. 2022, Table 1."""
    sigma_data: float = 0.5
    tag = "edm"

    def skip_scaling(self, sigma):
        return self.sigma_data ** 2 / (sigma ** 2 + self.sigma_data ** 2)

    def output_scaling(self, sigma):
        return sigma * self.sigma_data / torch.sqrt(
            sigma ** 2 + self.sigma_data ** 2)

    def input_scaling(self, sigma):
        return 1.0 / torch.sqrt(sigma ** 2 + self.sigma_data ** 2)

    def noise_conditioner(self, sigma):
        return 0.5 * torch.log(sigma)
