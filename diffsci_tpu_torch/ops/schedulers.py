"""Schedulers: time grids and deterministic probability-flow propagation.

Port of the deterministic part of ``diffsci_tpu/ops/schedulers.py``
(``Scheduler.make_rhs``, the step engine ``_run_steps``,
``propagate``/``propagate_backward`` and ``EDMScheduler``). Grids are built
on the host in numpy (float64), and each step's t and dt are cast to
float32 as the JAX package's ``pack()`` does. The scan becomes a Python
loop over the grid; the Heun endpoint step (the grid landing exactly on
t = 0) is split off statically, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from diffsci_tpu_torch.ops import integrators as integrators_lib
from diffsci_tpu_torch.ops import scheduling as scheduling_lib

ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x, sigma[B])


class Scheduler:
    """Owns the scheduling functions, the integrator and the initial noise
    scale."""

    def __init__(self, scheduling: scheduling_lib.SchedulingFunctions,
                 integrator: integrators_lib.Integrator,
                 maximum_scale: float):
        self.scheduling = scheduling
        self.integrator = integrator
        self.maximum_scale = float(maximum_scale)

    def create_steps(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def make_rhs(self, score_fn: ScoreFn):
        """Probability-flow right-hand side rhs(x, t) for a
        constant-scaling schedule; ``score_fn`` receives sigma broadcast to
        the batch."""
        sf = self.scheduling
        if not sf.constant_scaling:
            raise NotImplementedError(
                "scaled (VP-style) schedules are not ported yet")

        def rhs(x, t):
            sigma = sf.noise(t)
            sigma_b = torch.full((x.shape[0],), float(sigma), dtype=x.dtype,
                                 device=x.device)
            if sf.has_pf_score_multiplier:
                mult = sf.pf_score_multiplier(t)
            else:
                mult = sigma * sf.noise_deriv(t)
            return -float(mult) * score_fn(x, sigma_b)

        return rhs

    def _run_steps(self, x, integrator, rhs, t_steps: np.ndarray,
                   dt_steps: np.ndarray, record_history: bool):
        """Run len(dt_steps) integrator steps, splitting off a final
        endpoint step when the integrator evaluates rhs at t + dt and the
        grid lands exactly on zero."""
        nsteps = len(dt_steps)
        history = [x] if record_history else None
        if nsteps == 0:
            return x[None] if record_history else x
        t_end = float(t_steps[-1] + dt_steps[-1])
        split_endpoint = integrator.evaluates_endpoint and t_end == 0.0
        t32 = t_steps.astype(np.float32)
        dt32 = dt_steps.astype(np.float32)
        for i in range(nsteps):
            endpoint = split_endpoint and i == nsteps - 1
            x = integrator.step(x, t32[i], dt32[i], rhs, endpoint=endpoint)
            if record_history:
                history.append(x)
        if record_history:
            return torch.stack(history, dim=0)
        return x

    def propagate(self, x, score_fn: ScoreFn, nsteps: int = 100,
                  record_history: bool = False, backward: bool = True,
                  integrator: integrators_lib.Integrator | str | None = None):
        integrator = self._resolve_integrator(integrator)
        t = self.create_steps(nsteps + 1)
        skip = 0
        if not backward:
            t = t[::-1]
            skip = 1
        dt = np.diff(t)
        out = self._run_steps(x, integrator, self.make_rhs(score_fn),
                              t[skip:nsteps], dt[skip:nsteps],
                              record_history)
        if record_history and not backward:
            # forward history: index 0 is the clean original
            out = torch.cat([x[None], out], dim=0)
        return out

    def propagate_backward(self, x, score_fn: ScoreFn, nsteps: int = 100,
                           record_history: bool = False, integrator=None):
        return self.propagate(x, score_fn, nsteps, record_history,
                              backward=True, integrator=integrator)

    def _resolve_integrator(self, integrator):
        if integrator is None:
            return self.integrator
        if isinstance(integrator, str):
            return integrators_lib.name_to_integrator(integrator)
        return integrator


class EDMScheduler(Scheduler):
    """Karras rho-grid scheduler with the Heun integrator."""

    def __init__(self, sigma_min: float = 0.002, sigma_max: float = 80.0,
                 exponent_steps: float = 7.0,
                 scheduling: str | scheduling_lib.SchedulingFunctions = "EDM"):
        if isinstance(scheduling, str):
            scheduling = scheduling_lib.name_to_scheduling_functions(
                scheduling)
        super().__init__(scheduling, integrators_lib.HeunIntegrator(),
                         maximum_scale=sigma_max)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.exponent_steps = float(exponent_steps)

    def create_steps(self, n: int) -> np.ndarray:
        if n < 3:
            raise ValueError(
                f"EDM sigma grid needs at least 2 sampling steps (got "
                f"n={n} grid points); the Karras rho-spacing formula "
                f"divides by n-2")
        rho = self.exponent_steps
        s = np.arange(n - 1, dtype=np.float64) / (n - 2)
        start = self.sigma_max ** (1 / rho)
        end = self.sigma_min ** (1 / rho)
        steps = (start + s * (end - start)) ** rho
        if not self.scheduling.identity_noise:
            steps = np.asarray(self.scheduling.inverse_noise(steps))
        return np.concatenate([steps, np.zeros(1)])
