"""Karras preconditioners: c_skip / c_out / c_in / c_noise.

Port of ``diffsci_tpu/ops/preconditioners.py``: the base class with
``coefficients``, and the EDM, VP, VE, SR3 and null preconditioners, on
torch tensors (the VP preconditioner's c_noise goes through its scheduling
functions' ``inverse_noise``).
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

    def coefficients(self, sigma):
        """(c_skip, c_out, c_in, c_noise) for a batch of sigmas."""
        return (self.skip_scaling(sigma), self.output_scaling(sigma),
                self.input_scaling(sigma), self.noise_conditioner(sigma))

    def export_description(self):
        return {"tag": self.tag, "extra_args": {}}


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

    def export_description(self):
        return {"tag": self.tag, "extra_args": {"sigma_data": self.sigma_data}}


@dataclasses.dataclass(frozen=True)
class VPPreconditioner(KarrasPreconditioner):
    """VP: c_noise = (M - 1) sigma^{-1}(sigma), through the scheduling
    functions' ``inverse_noise``."""
    scheduling: object = None  # SchedulingFunctions with .inverse_noise
    M: int = 1000
    tag = "vp"

    def skip_scaling(self, sigma):
        return 1.0 + 0.0 * sigma

    def output_scaling(self, sigma):
        return -sigma

    def input_scaling(self, sigma):
        return 1.0 / torch.sqrt(sigma ** 2 + 1.0)

    def noise_conditioner(self, sigma):
        return (self.M - 1) * self.scheduling.inverse_noise(sigma)


@dataclasses.dataclass(frozen=True)
class VEPreconditioner(KarrasPreconditioner):
    tag = "ve"

    def skip_scaling(self, sigma):
        return 1.0 + 0.0 * sigma

    def output_scaling(self, sigma):
        return sigma

    def input_scaling(self, sigma):
        return 1.0 + 0.0 * sigma

    def noise_conditioner(self, sigma):
        return torch.log(0.5 * sigma)


@dataclasses.dataclass(frozen=True)
class SR3Preconditioner(KarrasPreconditioner):
    """Super-resolution preconditioner: EDM's skip and output scalings
    halved."""
    sigma_data: float = 0.5
    tag = "sr3"

    def skip_scaling(self, sigma):
        return self.sigma_data ** 2 / (2 * (sigma ** 2 + self.sigma_data ** 2))

    def output_scaling(self, sigma):
        return sigma * self.sigma_data / (
            2 * torch.sqrt(sigma ** 2 + self.sigma_data ** 2))

    def input_scaling(self, sigma):
        return 1.0 / torch.sqrt(sigma ** 2 + self.sigma_data ** 2)

    def noise_conditioner(self, sigma):
        return 0.5 * torch.log(sigma)

    def export_description(self):
        return {"tag": self.tag, "extra_args": {"sigma_data": self.sigma_data}}


@dataclasses.dataclass(frozen=True)
class NullPreconditioner(KarrasPreconditioner):
    """Identity wiring: D(x; sigma) = F(x, sigma)."""
    tag = "null"

    def skip_scaling(self, sigma):
        return 0.0 * sigma

    def output_scaling(self, sigma):
        return 1.0 + 0.0 * sigma

    def input_scaling(self, sigma):
        return 1.0 + 0.0 * sigma

    def noise_conditioner(self, sigma):
        return sigma
