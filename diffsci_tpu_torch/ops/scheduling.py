"""Noise/scale scheduling functions sigma(t), s(t).

Port of ``diffsci_tpu/ops/scheduling.py:22-86`` (the base class and the EDM
schedule). The methods are plain arithmetic, so they take Python floats,
numpy arrays and torch tensors alike: the schedulers build their time grids
in numpy and the per-step math uses the same objects.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SchedulingFunctions:
    """Base: sigma(t) noise schedule and s(t) scale schedule + derivatives.

    ``constant_scaling`` selects the unscaled probability-flow branch of
    ``Scheduler.make_rhs``; ``has_pf_score_multiplier`` replaces
    sigma'(t) sigma(t) with a closed form; ``identity_noise`` marks
    sigma(t) = t, letting grids skip ``inverse_noise``.
    """
    constant_scaling: bool = False
    identity_noise: bool = False
    has_pf_score_multiplier: bool = False

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
        raise NotImplementedError


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


def name_to_scheduling_functions(name: str) -> SchedulingFunctions:
    if name == "EDM":
        return EDMSchedulingFunctions()
    raise ValueError(f"scheduling functions {name!r} are not ported yet")
