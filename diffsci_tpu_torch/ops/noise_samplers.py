"""Training-time noise-level samplers and loss weights lambda(sigma).

Port of ``diffsci_tpu/ops/noise_samplers.py``: the EDM (log-normal), VP
(uniform t through sigma(t)), VE (log-uniform) and uniform samplers. A
draw takes an explicit ``torch.Generator`` in place of a JAX key and makes
one draw of ``shape`` (normal for EDM, uniform otherwise), transformed in
place, so that it can fill a CUDA graph's static input (``out=``).
"""

from __future__ import annotations

import dataclasses
import math

import torch


def _buffer(shape, generator, device, out):
    if out is None:
        if device is None and generator is not None:
            device = generator.device
        out = torch.empty(shape, device=device)
    return out


@dataclasses.dataclass(frozen=True)
class NoiseSampler:
    def loss_weighting(self, sigma):
        raise NotImplementedError

    def sample(self, shape, generator=None, device=None, out=None):
        """sigma of ``shape``, drawn with ``generator`` on ``device`` (the
        generator's device by default), or into ``out`` (a CUDA graph's
        static input) with the same numbers."""
        raise NotImplementedError

    def export_description(self):
        return {"tag": self.tag, "extra_args": {}}


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
        """sigma = exp(N(prior_mean, prior_std^2))."""
        out = _buffer(shape, generator, device, out)
        torch.randn(shape, generator=generator, out=out)
        return out.mul_(self.prior_std).add_(self.prior_mean).exp_()

    def export_description(self):
        return {"tag": self.tag,
                "extra_args": {"sigma_data": self.sigma_data,
                               "prior_mean": self.prior_mean,
                               "prior_std": self.prior_std}}


@dataclasses.dataclass(frozen=True)
class VPNoiseSampler(NoiseSampler):
    """Uniform t in [epsilon, 1] mapped through sigma(t); lambda =
    sigma^-2."""
    scheduling: object = None  # SchedulingFunctions with .noise
    epsilon: float = 1e-3
    tag = "vp"

    def loss_weighting(self, sigma):
        return 1.0 / (sigma ** 2)

    def sample(self, shape, generator=None, device=None, out=None):
        out = _buffer(shape, generator, device, out)
        torch.rand(shape, generator=generator, out=out)
        out.mul_(1.0 - self.epsilon).add_(self.epsilon)
        return out.copy_(self.scheduling.noise(out))


@dataclasses.dataclass(frozen=True)
class VENoiseSampler(NoiseSampler):
    """Log-uniform sigma in [sigma_min, sigma_max]; lambda = sigma^-2."""
    sigma_min: float = 0.02
    sigma_max: float = 100.0
    tag = "ve"

    def loss_weighting(self, sigma):
        return 1.0 / (sigma ** 2)

    def sample(self, shape, generator=None, device=None, out=None):
        out = _buffer(shape, generator, device, out)
        torch.rand(shape, generator=generator, out=out)
        lo = math.log(self.sigma_min)
        return out.mul_(math.log(self.sigma_max) - lo).add_(lo).exp_()

    def export_description(self):
        return {"tag": self.tag,
                "extra_args": {"sigma_min": self.sigma_min,
                               "sigma_max": self.sigma_max}}


@dataclasses.dataclass(frozen=True)
class UniformNoiseSampler(NoiseSampler):
    """Uniform sigma in [t, T] with the EDM weighting."""
    t: float = 0.0
    T: float = 1.0
    sigma_data: float = 0.5
    tag = "uniform"

    def loss_weighting(self, sigma):
        return (sigma ** 2 + self.sigma_data ** 2) / (
            (sigma * self.sigma_data) ** 2)

    def sample(self, shape, generator=None, device=None, out=None):
        out = _buffer(shape, generator, device, out)
        torch.rand(shape, generator=generator, out=out)
        return out.mul_(self.T - self.t).add_(self.t)

    def export_description(self):
        return {"tag": self.tag,
                "extra_args": {"t": self.t, "T": self.T,
                               "sigma_data": self.sigma_data}}
