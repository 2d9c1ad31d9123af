"""RePaint inpainting as a feature.

Port of ``diffsci_tpu/features/inpainting.py``: the known region is noised
to every grid level by the exact Gaussian forward marginal
y_k = s(t_k)·x + s(t_k)·σ(t_k)·ε_k, and the resampling loop is the
scheduler's ``repaint`` (``ops/schedulers.py``). The draws, in order:
ε of the noised history ([nsteps + 1, *x.shape]), x_T, then RePaint's
re-noise jumps; ``eps=``, ``noise=`` and ``renoise_noises=`` replay them.
"""

from __future__ import annotations

from typing import Callable

import torch

from diffsci_tpu_torch.ops import schedulers as schedulers_lib
from diffsci_tpu_torch.ops.integrators import f32, host
from diffsci_tpu_torch.ops.schedulers import draw_noise


class Inpainting:
    def __init__(self, scheduler: schedulers_lib.Scheduler):
        self.scheduler = scheduler
        self.scheduling = scheduler.scheduling


class RePaint(Inpainting):
    """RePaint (Lugmayr et al., 2022) over a scheduler and a score."""

    def __init__(self, scheduler: schedulers_lib.Scheduler,
                 integrator=None):
        super().__init__(scheduler)
        self.integrator = integrator

    def gaussian_noised_history(self, x, nsteps: int, generator=None,
                                eps=None):
        """The known image at every backward grid time t[k], k = 0..nsteps:
        y[k] = s(t_k)·x + s(t_k)·σ(t_k)·ε_k, with ε [nsteps + 1, *x.shape]
        drawn from ``generator`` or replayed (``eps``)."""
        t = self.scheduler.create_steps(nsteps + 1)
        sf = self.scheduling
        if eps is None:
            eps = draw_noise(generator, nsteps + 1, x)
        frames = []
        for k in range(nsteps + 1):
            tk = f32(float(t[k]))
            scale, sigma = sf.scale(tk), sf.noise(tk)
            frames.append(host(scale) * x + host(scale * sigma) * eps[k])
        return torch.stack(frames, dim=0)

    def reconstruct(self, x_initial, score_fn: Callable, mask,
                    n_resamples: int = 2, resample_steps: int = 2,
                    nsteps: int = 100, record_history: bool = False,
                    generator=None, eps=None, noise=None,
                    renoise_noises=None):
        """Inpaint ``x_initial`` where ``mask == 0``; ``mask == 1`` marks
        the known region."""
        y_noised = self.gaussian_noised_history(x_initial, nsteps, generator,
                                                eps)
        if noise is None:
            noise = draw_noise(generator, 1, x_initial)[0]
        x = noise * self.scheduler.maximum_scale
        return self.scheduler.repaint(
            x, y_noised, mask, score_fn, nsteps=nsteps, rsteps=resample_steps,
            nresamples=n_resamples, record_history=record_history,
            integrator=self.integrator, renoise_noises=renoise_noises,
            generator=generator)
