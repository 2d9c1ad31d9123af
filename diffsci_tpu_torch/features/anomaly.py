"""Diffusion-based anomaly detection: AnoDDPM and DDAD.

Port of ``diffsci_tpu/features/anomaly.py``, with its two departures from
the reference it was modelled on (``anomaly.py:1-22`` there):

- AnoDDPM noises the input to grid step k and reconstructs it by a
  partial backward propagation with its integrator, Euler–Maruyama by
  default (the reference, by a fault, always used deterministic Heun);
  the per-sample reconstruction error is the anomaly signal.
- DDAD reconstructs with a guided score, score + w·(y_t − x), pulling the
  trajectory toward the noised input; its guidance frame y_t is indexed
  by step (the reference indexed it by the time value).

Draws come from an explicit ``torch.Generator`` before each loop, in the
JAX package's order; ``apply_eps=`` (the initial noising) and
``noise_seq=`` (AnoDDPM: the integrator's per-step noise; DDAD: the
stochastic forward pass's) replay them. The loops run eagerly.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from diffsci_tpu_torch.ops import integrators as integrators_lib
from diffsci_tpu_torch.ops import schedulers as schedulers_lib
from diffsci_tpu_torch.ops.integrators import f32, host
from diffsci_tpu_torch.ops.schedulers import draw_noise

ScoreFn = Callable


def _summed_error(x_initial, x_rec, spatial_dims: int):
    axes = tuple(range(x_initial.ndim - spatial_dims, x_initial.ndim))
    return ((x_initial - x_rec) ** 2).sum(dim=axes)


class AnomalyDetector:
    def __init__(self, scheduler: schedulers_lib.Scheduler):
        self.scheduler = scheduler
        self.scheduling = scheduler.scheduling


class AnoDDPM(AnomalyDetector):
    """Noise to step ``step``, reconstruct by partial backward
    propagation."""

    def __init__(self, scheduler: schedulers_lib.Scheduler,
                 integrator=None):
        super().__init__(scheduler)
        self.integrator = integrator or \
            integrators_lib.EulerMaruyamaIntegrator()

    def reconstruct(self, x_initial, score_fn: ScoreFn, step: int,
                    nsteps: int = 100, record_history: bool = False,
                    generator=None, apply_eps=None, noise_seq=None):
        """The draws: the noising ε, then the integrator's noise
        ([nsteps − step, *x.shape] for a stochastic one)."""
        x_noised = self.scheduler.apply_noise(x_initial, nsteps, step,
                                              eps=apply_eps,
                                              generator=generator)
        return self.scheduler.propagate_partial(
            x_noised, score_fn, nsteps, initial_step=step, final_step=nsteps,
            record_history=record_history, integrator=self.integrator,
            noise_seq=noise_seq, generator=generator)

    def reconstruction_error(self, x_initial, score_fn: ScoreFn, step: int,
                             nsteps: int = 100, spatial_dims: int = 1,
                             generator=None, apply_eps=None,
                             noise_seq=None):
        """Squared error summed over the trailing ``spatial_dims`` axes
        (the channel axis among them, in a channels-last layout)."""
        x_rec = self.reconstruct(x_initial, score_fn, step, nsteps,
                                 generator=generator, apply_eps=apply_eps,
                                 noise_seq=noise_seq)
        return _summed_error(x_initial, x_rec, spatial_dims)


class DDAD(AnomalyDetector):
    """Guided reconstruction: the score plus w·(y_t − x), y_t the input's
    stochastic forward history at the step's grid time."""

    def _rhs(self, score_fn, y_t, w):
        sf = self.scheduling

        def rhs(xx, tt, gate=1.0):
            sigma = sf.noise(tt)
            sigma_b = torch.full((xx.shape[0],), float(sigma),
                                 dtype=xx.dtype, device=xx.device)
            if sf.constant_scaling:
                mult = (sf.pf_score_multiplier(tt)
                        if sf.has_pf_score_multiplier
                        else sigma * sf.noise_deriv(tt))
                score = score_fn(xx, sigma_b) + w * (y_t - xx)
                return -host(mult) * score
            s = sf.scale(tt)
            mult = (sf.pf_score_multiplier(tt) if sf.has_pf_score_multiplier
                    else s * sf.noise_deriv(tt) * sf.noise(tt))
            score = score_fn(xx / host(s), sigma_b) + w * (y_t - xx / host(s))
            return host(sf.scale_deriv(tt) / s) * xx - host(mult) * score

        return rhs

    def reconstruct(self, x_initial, score_fn: ScoreFn, nsteps: int = 100,
                    initial_step: int = 0, w: float = 3.0, integrator=None,
                    record_history: bool = False, generator=None,
                    apply_eps=None, noise_seq=None, step_noise=None):
        """The draws: the noising ε, the forward pass's noise
        ([nsteps − 1, *x.shape]), then a stochastic integrator's
        (``step_noise``)."""
        integrator = integrator or integrators_lib.HeunIntegrator()
        sched = self.scheduler
        x = sched.apply_noise(x_initial, nsteps, initial_step, eps=apply_eps,
                              generator=generator)
        # the input's stochastic forward history, reversed so that index k
        # is the guidance frame at backward grid time t[k]
        fwd = sched.propagate_forward(x_initial, score_fn, nsteps,
                                      record_history=True, stochastic=True,
                                      noise_seq=noise_seq,
                                      generator=generator)
        y_hist = fwd.flip(0)
        t = sched.create_steps(nsteps + 1)
        dt = np.diff(t)
        t_steps, dt_steps = t[initial_step:nsteps], dt[initial_step:nsteps]
        n = len(dt_steps)
        split_endpoint = (integrator.evaluates_endpoint
                          and float(t_steps[-1] + dt_steps[-1]) == 0.0)
        extras_np = integrator.scan_extras(t_steps, dt_steps, nsteps)
        if integrator.draws_noise and step_noise is None:
            step_noise = draw_noise(generator, n, x)
        t32 = torch.from_numpy(t_steps.astype(np.float32))
        dt32 = torch.from_numpy(dt_steps.astype(np.float32))
        history = [x]
        for i in range(n):
            extras = {name: f32(v[i]) for name, v in extras_np.items()}
            if integrator.draws_noise:
                extras["noise"] = step_noise[i]
            x = integrator.step(
                x, t32[i], dt32[i],
                self._rhs(score_fn, y_hist[initial_step + i], w),
                sched.noise_injection, extras,
                endpoint=split_endpoint and i == n - 1)
            history.append(x)
        return torch.stack(history, dim=0) if record_history else x

    def reconstruction_error(self, x_initial, score_fn: ScoreFn,
                             step: int = 0, nsteps: int = 100,
                             w: float = 3.0, integrator=None,
                             spatial_dims: int = 1, generator=None,
                             apply_eps=None, noise_seq=None):
        x_rec = self.reconstruct(x_initial, score_fn, nsteps, step, w,
                                 integrator, generator=generator,
                                 apply_eps=apply_eps, noise_seq=noise_seq)
        return _summed_error(x_initial, x_rec, spatial_dims)
