"""EMA weight tracking: traditional decay / half-life and EDM2 power-function
profiles.

Port of ``diffsci_tpu/models/karras/ema.py:23-166``. The JAX package keeps
its shadows in an immutable pytree updated inside the jitted step; here
the shadows are f32 tensors on the parameters' device, one dict
``name -> tensor`` per profile, updated in place under ``torch.no_grad()``
with ``torch._foreach_*``. The update counter and the decays are computed
on the host, so an update never waits on the device; the decays reach the
device as 0-d tensors filled before each update (``set_decays``), which
the tensor part of the update (``apply``) reads, so a CUDA graph of that
part replays with each update's decays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch


def power_function_exp_from_std(std: float) -> float:
    """EDM2 power-function EMA: relative std -> exponent (the largest real
    root of x^3 + 7x^2 + (16 - std^-2)x + (12 - std^-2))."""
    if std <= 0:
        raise ValueError("Power-function EMA std must be positive")
    target = float(std) ** -2
    roots = np.roots([1.0, 7.0, 16.0 - target, 12.0 - target])
    return float(np.max(roots.real))


def power_function_beta(std: float, next_update: int) -> float:
    """Per-update decay (1 - 1/t)^(exp + 1), 0 on the first update."""
    if next_update <= 1:
        return 0.0
    return (1.0 - 1.0 / next_update) ** (power_function_exp_from_std(std)
                                         + 1.0)


@dataclasses.dataclass
class EMAState:
    """Shadow copies, one ``name -> f32 tensor`` dict per profile; per
    profile the decay β and 1 − β of the update in progress as 0-d f32
    tensors on the shadows' device; and the number of updates so far."""
    profiles: tuple
    decays: tuple
    num_updates: int = 0


@dataclasses.dataclass(frozen=True)
class EMATracker:
    """EMA updater; the configuration is fixed, the state an ``EMAState``.

    ema_type: 'traditional' (fixed decay, or a half-life with ramp-up) or
    'power' (EDM2 profiles, one per entry of ``power_function_stds``)."""
    ema_type: str = "traditional"
    decay: float = 0.999
    halflife_steps: float | None = None
    rampup_ratio: float | None = None
    power_function_stds: Sequence[float] = (0.05,)
    profile_index: int = 0
    update_every: int = 1

    def __post_init__(self):
        if self.ema_type not in ("traditional", "power"):
            raise ValueError("ema_type must be 'traditional' or 'power'")
        if not 0.0 <= self.decay < 1.0:
            raise ValueError("EMA decay must be in [0, 1)")
        if len(self.power_function_stds) == 0:
            raise ValueError("power_function_stds must not be empty")
        if self.update_every < 1:
            raise ValueError("update_every must be >= 1")

    @property
    def num_profiles(self) -> int:
        return len(self.power_function_stds) if self.ema_type == "power" \
            else 1

    def init(self, params: dict) -> EMAState:
        """Shadows start as f32 copies of ``params`` (name -> tensor)."""
        with torch.no_grad():
            profiles = tuple({k: p.detach().float().clone()
                              for k, p in params.items()}
                             for _ in range(self.num_profiles))
        device = next(iter(params.values())).device if params else None
        decays = tuple((torch.zeros((), device=device),
                        torch.zeros((), device=device))
                       for _ in range(self.num_profiles))
        return EMAState(profiles=profiles, decays=decays)

    def _traditional_beta(self, next_update: int) -> float:
        if self.halflife_steps is None:
            return self.decay
        hl = self.halflife_steps
        if self.rampup_ratio is not None:
            hl = min(hl, max(float(next_update), 1.0) * self.rampup_ratio)
        return 0.5 ** (1.0 / max(hl, 1e-8))

    def betas(self, next_update: int) -> list[float]:
        """Per-profile decay for update number ``next_update``."""
        if self.ema_type == "power":
            return [power_function_beta(s, next_update)
                    for s in self.power_function_stds]
        return [self._traditional_beta(next_update)]

    def update(self, state: EMAState, params: dict) -> EMAState:
        """shadow <- beta·shadow + (1 - beta)·param for every profile, in
        place; returns ``state``: ``advance``, then ``set_decays`` and
        ``apply`` when the shadows move."""
        betas = self.advance(state)
        if betas is not None:
            self.set_decays(state, betas)
            self.apply(state, params)
        return state

    def advance(self, state: EMAState) -> list[float] | None:
        """Count one update. Returns the per-profile decays when the
        shadows move on it, else None.

        With ``update_every = K > 1`` the shadows move only on every K-th
        call, with the K per-step decays folded into one: for the power
        profile exactly, by telescoping prod_{i=t-K+1..t} ((i-1)/i)^(e+1)
        = ((t-K)/t)^(e+1); for the traditional profile as the product of
        the K per-step betas."""
        state.num_updates += 1
        t = state.num_updates
        K = self.update_every
        if t % K:
            return None
        if K == 1:
            return self.betas(t)
        if self.ema_type == "power":
            return [(max(t - K, 0) / max(t, 1))
                    ** (power_function_exp_from_std(s) + 1.0)
                    for s in self.power_function_stds]
        return [math.prod(self.betas(t - (K - 1 - j))[0] for j in range(K))]

    @staticmethod
    def set_decays(state: EMAState, betas: list[float]) -> None:
        """Fill each profile's β and 1 − β, in float32 as the JAX package
        computes 1 − β."""
        for (beta, rest), b in zip(state.decays, betas):
            b32 = np.float32(b)
            beta.fill_(float(b32))
            rest.fill_(float(np.float32(1.0) - b32))

    @staticmethod
    def apply(state: EMAState, params: dict) -> None:
        """shadow <- β·shadow + (1 − β)·param with the decays of
        ``state.decays``: device work only, which a graph can capture."""
        with torch.no_grad():
            for profile, (beta, rest) in zip(state.profiles, state.decays):
                shadows = list(profile.values())
                torch._foreach_mul_(shadows, beta)
                torch._foreach_add_(shadows, torch._foreach_mul(
                    [params[k].detach().float() for k in profile], rest))

    def get_params(self, state: EMAState,
                   profile_index: int | None = None) -> dict:
        """The shadows of the selected profile (clamped to the range)."""
        idx = self.profile_index if profile_index is None else profile_index
        return state.profiles[min(max(idx, 0), self.num_profiles - 1)]
