"""Noise/scale scheduling functions sigma(t), s(t).

Port of ``diffsci_tpu/ops/scheduling.py``: the base class, the EDM, VP and
VE schedules and ``name_to_scheduling_functions``. The methods are plain
arithmetic, so they take Python floats, numpy arrays and torch tensors
alike (a tensor gets torch's exp/sqrt/log, anything else numpy's): the
schedulers build their time grids in numpy (float64), the per-step math
evaluates them on float32 tensors as the JAX package's scan does, and the
training noise samplers and preconditioners call them on device tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _exp(a):
    return torch.exp(a) if torch.is_tensor(a) else np.exp(a)


def _sqrt(a):
    return torch.sqrt(a) if torch.is_tensor(a) else np.sqrt(a)


def _log(a):
    return torch.log(a) if torch.is_tensor(a) else np.log(a)


@dataclasses.dataclass(frozen=True)
class SchedulingFunctions:
    """Base: sigma(t) noise schedule and s(t) scale schedule + derivatives.

    ``constant_scaling`` selects the unscaled probability-flow branch of
    ``Scheduler.make_rhs``; ``has_pf_score_multiplier`` replaces
    s(t)^2 sigma'(t) sigma(t) with a closed form, ``has_pf_scale_multiplier``
    s'(t)/s(t); ``identity_noise`` marks sigma(t) = t, letting grids skip
    ``inverse_noise``.
    """
    constant_scaling: bool = False
    identity_noise: bool = False
    has_pf_score_multiplier: bool = False
    has_pf_scale_multiplier: bool = False

    def scale(self, t):
        raise NotImplementedError

    def scale_deriv(self, t):
        raise NotImplementedError

    def noise(self, t):
        raise NotImplementedError

    def inverse_noise(self, sigma):
        raise NotImplementedError

    def noise_deriv(self, t):
        raise NotImplementedError

    def pf_score_multiplier(self, t):
        """s(t)^2 sigma'(t) sigma(t) in closed form (when flagged)."""
        raise NotImplementedError

    def pf_scale_multiplier(self, t):
        """s'(t)/s(t) in closed form (when flagged)."""
        raise NotImplementedError

    def export_description(self):
        return {"tag": self.tag, "extra_args": {}}


@dataclasses.dataclass(frozen=True)
class EDMSchedulingFunctions(SchedulingFunctions):
    """Karras EDM: sigma(t) = t, s(t) = 1."""
    constant_scaling: bool = True
    identity_noise: bool = True
    tag = "EDM"

    def scale(self, t):
        return 1.0 + 0.0 * t

    def scale_deriv(self, t):
        return 0.0 * t

    def noise(self, t):
        return 1.0 * t

    def inverse_noise(self, sigma):
        return 1.0 * sigma

    def noise_deriv(self, t):
        return 1.0 + 0.0 * t


@dataclasses.dataclass(frozen=True)
class VPSchedulingFunctions(SchedulingFunctions):
    """Variance-preserving exponential beta schedule: s(t) = exp(-e(t)/2),
    sigma(t) = sqrt(exp(e(t)) - 1) with e(t) = beta_d t^2/2 + beta_min t."""
    beta_data: float = 19.9
    beta_min: float = 0.1
    tag = "VP"

    def _exponent(self, t):
        return 0.5 * self.beta_data * t ** 2 + self.beta_min * t

    def _exponent_deriv(self, t):
        return self.beta_data * t + self.beta_min

    def scale(self, t):
        return _exp(-self._exponent(t) / 2)

    def scale_deriv(self, t):
        return -self._exponent_deriv(t) / 2 * _exp(-self._exponent(t) / 2)

    def noise(self, t):
        return _sqrt(_exp(self._exponent(t)) - 1.0)

    def inverse_noise(self, sigma):
        y = _log(sigma ** 2 + 1.0)
        delta = self.beta_min ** 2 + 2 * self.beta_data * y
        return (-self.beta_min + _sqrt(delta)) / self.beta_data

    def noise_deriv(self, t):
        e = _exp(self._exponent(t))
        return self._exponent_deriv(t) * e / (2 * _sqrt(e - 1.0))

    def pf_score_multiplier(self, t):
        return 0.5 * self._exponent_deriv(t)

    def pf_scale_multiplier(self, t):
        return -0.5 * self._exponent_deriv(t)

    def export_description(self):
        return {"tag": self.tag,
                "extra_args": {"beta_data": self.beta_data,
                               "beta_min": self.beta_min}}


@dataclasses.dataclass(frozen=True)
class VESchedulingFunctions(SchedulingFunctions):
    """Variance-exploding: sigma(t) = sqrt(t), s(t) = 1."""
    constant_scaling: bool = True
    has_pf_score_multiplier: bool = True
    tag = "VE"

    def scale(self, t):
        return 1.0 + 0.0 * t

    def scale_deriv(self, t):
        return 0.0 * t

    def noise(self, t):
        return _sqrt(t)

    def inverse_noise(self, sigma):
        return sigma ** 2

    def noise_deriv(self, t):
        return 0.5 / _sqrt(t)

    def pf_score_multiplier(self, t):
        return 0.5 + 0.0 * t


def name_to_scheduling_functions(name: str, **kwargs) -> SchedulingFunctions:
    if name == "EDM":
        return EDMSchedulingFunctions()
    if name == "VP":
        return VPSchedulingFunctions(**kwargs)
    if name == "VE":
        return VESchedulingFunctions(**kwargs)
    raise ValueError(f"Unknown scheduling function name: {name}")
