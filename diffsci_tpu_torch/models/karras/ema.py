"""EMA weight tracking: traditional decay / half-life and EDM2 power-function
profiles.

Port of ``diffsci_tpu/models/karras/ema.py``, post-hoc synthesis
included. The JAX package keeps
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

    @property
    def profile_names(self) -> list[str]:
        if self.ema_type == "power":
            return [f"power_std_{s:g}" for s in self.power_function_stds]
        return ["traditional"]

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

    def export_description(self) -> dict:
        return dict(ema_type=self.ema_type, decay=self.decay,
                    halflife_steps=self.halflife_steps,
                    rampup_ratio=self.rampup_ratio,
                    power_function_stds=list(self.power_function_stds),
                    profile_index=self.profile_index,
                    update_every=self.update_every)


# --- post-hoc EMA synthesis (Karras et al., arXiv:2312.02696 §3.3) --------
#
# A power-function EMA with exponent γ snapshotted at training time t
# averages the parameter trajectory with response
# r(τ) = ((γ+1)/t)·(τ/t)^γ on [0, t]. Any target profile is approximated
# post hoc by the least-squares combination of stored snapshots, so the
# EMA length can be chosen after training. The inner products have closed
# forms: the solve is a small float64 problem on the host, the synthesis
# one weighted f32 sum of shadows by name.


def _power_response_dot(t_a, gamma_a, t_b, gamma_b):
    """<r_a, r_b> for two power-function responses (closed form):
    integral_0^min(ta,tb) r_a(tau) r_b(tau) dtau."""
    t_a = np.asarray(t_a, np.float64)
    t_b = np.asarray(t_b, np.float64)
    gamma_a = np.asarray(gamma_a, np.float64)
    gamma_b = np.asarray(gamma_b, np.float64)
    t_ratio = t_a / t_b
    t_exp = np.where(t_a < t_b, gamma_b, -gamma_a)
    t_max = np.maximum(t_a, t_b)
    num = (gamma_a + 1.0) * (gamma_b + 1.0) * t_ratio ** t_exp
    den = (gamma_a + gamma_b + 1.0) * t_max
    return num / den


def solve_posthoc_weights(snap_ts, snap_stds, target_t, target_std):
    """Least-squares weights over stored snapshots reproducing the target
    profile: A w = b with A_ij = <r_i, r_j>, b_i = <r_i, r_target>, in
    float64. ``snap_ts``: the training steps of the snapshots; stds are
    relative stds (through the same cubic as training's EMA)."""
    snap_ts = np.asarray(snap_ts, np.float64)
    gammas = np.array([power_function_exp_from_std(s) for s in snap_stds],
                      np.float64)
    tg = float(target_t)
    gg = power_function_exp_from_std(target_std)
    A = _power_response_dot(snap_ts[:, None], gammas[:, None],
                            snap_ts[None, :], gammas[None, :])
    b = _power_response_dot(snap_ts, gammas, tg, gg)
    return np.linalg.solve(A, b)


def accumulate_weighted(acc: dict | None, weight: float,
                        shadows: dict) -> dict:
    """acc + weight·shadows in f32, by name (acc None: weight·shadows),
    one ``torch._foreach`` call; ``shadows`` on acc's device."""
    names = list(shadows)
    values = [shadows[k].float() for k in names]
    if acc is None:
        return dict(zip(names, torch._foreach_mul(values, float(
            np.float32(weight)))))
    torch._foreach_add_([acc[k] for k in names], values,
                        alpha=float(np.float32(weight)))
    return acc


def synthesize_posthoc_ema(snapshots, snap_ts, snap_stds, target_std,
                           target_t=None) -> dict:
    """Combine stored EMA shadows (``name -> tensor`` dicts, possibly
    interleaved from several profiles) taken at training steps ``snap_ts``
    with relative stds ``snap_stds`` into the ``target_std`` profile at
    ``target_t`` (default: the latest snapshot step). Returns the
    weighted f32 sum by name, on the snapshots' device."""
    if not (len(snapshots) == len(snap_ts) == len(snap_stds)):
        raise ValueError("snapshots/snap_ts/snap_stds length mismatch")
    if len(snapshots) == 0:
        raise ValueError("need at least one snapshot")
    if target_t is None:
        target_t = max(snap_ts)
    w = solve_posthoc_weights(snap_ts, snap_stds, target_t, target_std)
    acc = None
    with torch.no_grad():
        for wi, snap in zip(w, snapshots):
            acc = accumulate_weighted(acc, wi, snap)
    return acc
