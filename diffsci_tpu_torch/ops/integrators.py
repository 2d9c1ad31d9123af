"""Deterministic ODE integrator steps.

Port of ``diffsci_tpu/ops/integrators.py:33-86`` (Euler and Heun). A step
is a plain function of the state; ``t`` and ``dt`` arrive as float32
scalars from the scheduler's host-side grid. The Heun endpoint case
(t + dt == 0) is decided by the scheduler from the grid, which calls
``step(..., endpoint=True)`` to drop the second evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# rhs(x, t) -> dx/dt, with t a float32 scalar
RHSFn = Callable[[torch.Tensor, float], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Integrator:
    evaluates_endpoint: bool = False  # whether step() calls rhs at t + dt

    def step(self, x, t, dt, rhs: RHSFn, endpoint: bool = False):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class EulerIntegrator(Integrator):
    """x <- x + dt * rhs(x, t)."""
    tag = "euler"

    def step(self, x, t, dt, rhs, endpoint: bool = False):
        return x + float(dt) * rhs(x, t)


@dataclasses.dataclass(frozen=True)
class HeunIntegrator(Integrator):
    """Second-order Heun with the EDM endpoint rule: at t + dt == 0 the
    corrector slope equals the predictor slope, so the update is an Euler
    step."""
    evaluates_endpoint: bool = True
    tag = "heun"

    def step(self, x, t, dt, rhs, endpoint: bool = False):
        rhs_euler = rhs(x, t)
        if endpoint:
            return x + float(dt) * rhs_euler
        x_euler = x + float(dt) * rhs_euler
        rhs_heun = rhs(x_euler, t + dt)  # float32 sum, as in the JAX scan
        return x + 0.5 * (rhs_euler + rhs_heun) * float(dt)


def name_to_integrator(name: str) -> Integrator:
    integrators = {"euler": EulerIntegrator, "heun": HeunIntegrator}
    if name not in integrators:
        raise ValueError(f"integrator {name!r} is not ported yet")
    return integrators[name]()
