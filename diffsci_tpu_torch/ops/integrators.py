"""ODE/SDE integrator steps.

Port of ``diffsci_tpu/ops/integrators.py``: Euler, Heun,
Euler–Maruyama, the Karras churn integrator and DPM-Solver++(2M). A step
is a plain function of the state; ``t`` and ``dt`` arrive as 0-d float32
CPU tensors from the scheduler's host-side grid, and every per-step
scalar (σ(t), the churn's t_noise, DPM++2M's h and r) is computed from
them in float32, as the JAX package's scan computes it on the device.
Those scalars reach the tensor arithmetic as Python floats (``host``),
which a CUDA graph keyed on the grid bakes in; a runtime knob (the
Langevin gate under ``langevin_scale``) stays a device tensor.

Randomness is drawn before the loop: a step that injects noise reads it
from ``extras["noise"]``, its row of the pre-drawn sequence. Host-side
per-step data (the churn's γ, the Langevin gate) comes from
``scan_extras`` and the scheduler. The Heun endpoint case (t + dt == 0)
is decided by the scheduler from the grid, which calls
``step(..., endpoint=True)`` to drop the second evaluation. The
multistep DPM++2M threads its carry (the previous denoiser and step
size) through the loop; which branch a step takes is decided on the host
from the grid, as the JAX package's ``jnp.where`` decides it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

# rhs(x, t, gate=1.0) -> dx/dt, with t a 0-d float32 CPU tensor
RHSFn = Callable[..., torch.Tensor]


def f32(v) -> torch.Tensor:
    """A grid number as a 0-d float32 CPU tensor."""
    return torch.as_tensor(v, dtype=torch.float32)


def host(v):
    """A per-step coefficient for tensor arithmetic: a CPU tensor (grid
    math) as a Python float, which a CUDA graph bakes in; a device tensor
    (a runtime knob) as it is."""
    if torch.is_tensor(v) and v.device.type == "cpu":
        return float(v)
    return v


@dataclasses.dataclass(frozen=True)
class Integrator:
    stochastic: bool = False
    evaluates_endpoint: bool = False  # whether step() calls rhs at t + dt
    draws_noise = False  # whether step() reads extras["noise"]
    has_carry = False    # multistep integrators thread extra loop state

    def scan_extras(self, t: np.ndarray, dt: np.ndarray,
                    nsteps: int) -> dict:
        """Host-side per-step arrays (float32), read at step i as
        ``extras[name]``."""
        return {}

    def step(self, x, t, dt, rhs: RHSFn, noise_strength, extras: dict,
             endpoint: bool = False):
        raise NotImplementedError

    def init_carry(self, x):
        return None

    def step_carry(self, x, carry, t, dt, rhs, noise_strength, extras,
                   endpoint: bool = False):
        """(x, carry) -> (x_next, carry_next); by default a stateless
        step."""
        return self.step(x, t, dt, rhs, noise_strength, extras,
                         endpoint=endpoint), carry


@dataclasses.dataclass(frozen=True)
class EulerIntegrator(Integrator):
    """x <- x + dt * rhs(x, t)."""
    tag = "euler"

    def step(self, x, t, dt, rhs, noise_strength, extras,
             endpoint: bool = False):
        return x + host(dt) * rhs(x, t)


@dataclasses.dataclass(frozen=True)
class HeunIntegrator(Integrator):
    """Second-order Heun with the EDM endpoint rule: at t + dt == 0 the
    corrector slope equals the predictor slope, so the update is an Euler
    step."""
    evaluates_endpoint: bool = True
    tag = "heun"

    def step(self, x, t, dt, rhs, noise_strength, extras,
             endpoint: bool = False):
        rhs_euler = rhs(x, t)
        if endpoint:
            return x + host(dt) * rhs_euler
        x_euler = x + host(dt) * rhs_euler
        rhs_heun = rhs(x_euler, t + dt)  # float32 sum, as in the JAX scan
        return x + 0.5 * (rhs_euler + rhs_heun) * host(dt)


@dataclasses.dataclass(frozen=True)
class EulerMaruyamaIntegrator(Integrator):
    """Stochastic Euler–Maruyama: x <- x + rhs dt + g(t) N(0, I)
    sqrt(|dt|). The Langevin gate reaches both the drift's Langevin term
    (inside rhs) and the noise strength g."""
    stochastic: bool = True
    draws_noise = True
    tag = "euler-maruyama"

    def step(self, x, t, dt, rhs, noise_strength, extras,
             endpoint: bool = False):
        gate = extras.get("gate", 1.0)
        drift = x + rhs(x, t, gate) * host(dt)
        g = noise_strength(t, gate)
        return drift + host(g) * extras["noise"] * host(
            torch.sqrt(torch.abs(dt)))


@dataclasses.dataclass(frozen=True)
class KarrasIntegrator(Integrator):
    """EDM stochastic churn: raise the noise level by γ (computed per step
    on the host, with the S_churn/nsteps cap and the [S_tmin, S_tmax]
    window), then take a Heun step from the churned state down to t + dt.
    Needs the scheduling functions to convert between t and σ."""
    s_churn: float = 40.0
    s_tmin: float = 0.05
    s_tmax: float = 50.0
    s_noise: float = 1.003
    scheduling: object = None  # SchedulingFunctions
    evaluates_endpoint: bool = True
    draws_noise = True
    tag = "karras"

    def scan_extras(self, t: np.ndarray, dt: np.ndarray, nsteps: int) -> dict:
        backstep = min(self.s_churn / nsteps, math.sqrt(2.0) - 1.0)
        gamma = np.full(t.shape, backstep, dtype=np.float64)
        if self.s_tmin is not None:
            inside = (t >= self.s_tmin) & (t <= self.s_tmax)
            gamma = np.where(inside, gamma, 0.0)
        return {"gamma": gamma.astype(np.float32)}

    def step(self, x, t, dt, rhs, noise_strength, extras,
             endpoint: bool = False):
        sf = self.scheduling
        gamma = extras["gamma"]
        sigma = sf.noise(t)
        sigma_noise = sigma + gamma * sigma
        t_noise = sf.inverse_noise(sigma_noise)
        scale = sf.scale(t)
        scale_noise = sf.scale(t_noise)
        # the clamp keeps a rounding-negative difference at γ = 0 from
        # taking the square root of a negative number
        std = scale_noise * torch.sqrt(
            torch.clamp(sigma_noise ** 2 - sigma ** 2, min=0.0))
        x_noise = (host(scale_noise / scale) * x
                   + host(std * self.s_noise) * extras["noise"])

        rhs_euler = rhs(x_noise, t_noise)
        dt_noise = (t + dt) - t_noise
        x_euler = x_noise + host(dt_noise) * rhs_euler
        if endpoint:
            return x_euler
        rhs_heun = rhs(x_euler, t + dt)
        return x_noise + 0.5 * (rhs_euler + rhs_heun) * host(dt_noise)


@dataclasses.dataclass(frozen=True)
class DPMSolverPlusPlus2M(Integrator):
    """DPM-Solver++(2M) (Lu et al. 2022) in the σ parameterisation, one
    network call a step, for identity-scale grids (EDM, VE), where the
    denoiser is D = x - σ·rhs:

        h        = ln(σ) - ln(σ_next)
        r        = h_prev / h
        D~       = (1 + 1/(2r)) D - 1/(2r) D_prev     (first order: D~ = D)
        x_next   = (σ_next/σ) x + (1 - σ_next/σ) D~

    It drops to first order on the first step, on the step to σ = 0 and
    on any step whose σ does not decrease, as the JAX package does."""
    tag = "dpmpp2m"
    has_carry = True

    def init_carry(self, x):
        return {"d_prev": None, "h_prev": f32(0.0), "has_prev": False}

    def step_carry(self, x, carry, t, dt, rhs, noise_strength, extras,
                   endpoint: bool = False):
        eps = 1e-20
        sigma = t
        sigma_next = t + dt
        d = x - host(sigma) * rhs(x, sigma)
        ratio = sigma_next / torch.clamp(sigma, min=eps)
        h = (torch.log(torch.clamp(sigma, min=eps))
             - torch.log(torch.clamp(sigma_next, min=eps)))
        r = carry["h_prev"] / torch.clamp(h, min=eps)
        use_2m = (carry["has_prev"] and bool(sigma_next > 0)
                  and bool(h > eps) and bool(carry["h_prev"] > eps))
        if use_2m:
            coef = 1.0 / (2.0 * torch.clamp(r, min=eps))
            d_tilde = host(1.0 + coef) * d - host(coef) * carry["d_prev"]
        else:
            d_tilde = d
        x_next = host(ratio) * x + host(1.0 - ratio) * d_tilde
        return x_next, {"d_prev": d, "h_prev": h, "has_prev": True}


def name_to_integrator(name: str, scheduling=None) -> Integrator:
    if name == "euler":
        return EulerIntegrator()
    if name == "heun":
        return HeunIntegrator()
    if name == "euler-maruyama":
        return EulerMaruyamaIntegrator()
    if name == "karras":
        return KarrasIntegrator(scheduling=scheduling)
    if name == "dpmpp2m":
        return DPMSolverPlusPlus2M()
    raise ValueError(f"Unknown integrator: {name}")
