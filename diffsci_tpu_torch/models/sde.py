"""The Song-style SDE stack: VP, subVP and VE schedulers, the
Euler–Maruyama and probability-flow samplers, and the denoising
score-matching loss.

Port of ``diffsci_tpu/models/sde.py``: the schedulers (VP constant,
linear and custom, subVP, VE and VE-sqrt), ``sde_loss_fn`` (the 1/std
weighting; ``t=`` and ``eps=`` replay the draws), ``sde_sampler``
(Euler–Maruyama on the reverse SDE), ``pf_sampler`` (Euler or Heun on the
probability-flow ODE, carrying the exact next grid time: t + dt recomputed
in float32 can round below Tmin and give a NaN sqrt(β)) and ``SDEModel``.

SDE: dX = f(t, X) dt + g(t) dW with
- VP:    f = −β(t)·X/2, g = sqrt(β(t)), std²(t) = 1 − exp(−B(t)), B = ∫β
- subVP: the same drift, g = sqrt(β(t)·(1 − exp(−2B(t)))),
         std²(t) = (1 − exp(−B(t)))²
- VE:    f = 0, g = sqrt(d[σ²]/dt), std²(t) = σ²(t)

The network predicts the noise (score = −ε̂/std); samples are
channels-last and ``RuntimeNet`` moves the channel axis at the network
boundary. The grids are float32 of the float64 linspace (and, for the
Euler–Maruyama steps, of its float64 differences), as in the JAX package.
Randomness is an explicit ``torch.Generator``: x_T, then one draw a step;
``noise_seq`` [nsteps, *x.shape] replays the steps' draws.

On a CUDA device ``SDEModel.sample`` replays one CUDA graph of a step
per step, as ``DDPMModel.sample`` does: t and dt (or the next t) are 0-d
device tensors and the step's noise a static input, filled before each
replay, so a 1000-step request captures one network call (two for Heun)
and not a thousand.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from diffsci_tpu_torch.models.ddpm import _draw
from diffsci_tpu_torch.models.runtime import (RuntimeConfig, RuntimeMixin,
                                              RuntimeNet, fill_draw)
from diffsci_tpu_torch.ops import losses
from diffsci_tpu_torch.utils import bcast_right, graphs, resolve_device


class SDEScheduler:
    """T, Tmin and the variance floor (``stabilizer``, 1e-8) that keeps
    the score finite as t → 0; t are float32 tensors."""

    def __init__(self, T: float = 1.0, Tmin: float = 1e-5,
                 stabilizer: float = 1e-8):
        self.T = T
        self.Tmin = Tmin
        self.stabilizer = stabilizer

    def mean(self, t, x):
        raise NotImplementedError

    def std2_(self, t):
        raise NotImplementedError

    def std2(self, t):
        return self.std2_(t) + self.stabilizer

    def std(self, t):
        return torch.sqrt(self.std2(t))

    def drift_term(self, t, x):
        raise NotImplementedError

    def diffusion_term(self, t):
        raise NotImplementedError

    def sample(self, shape, generator=None, device=None, out=None):
        """The training time (the JAX package's ``sample_time``), t = Tmin
        + u·(T − Tmin) with u uniform, of ``shape`` (or into ``out``): the
        draw the train step makes into σ's slot."""
        def draw(t):
            torch.rand(t.shape, generator=generator, out=t)
            t.mul_(self.T - self.Tmin).add_(self.Tmin)

        return fill_draw(shape, generator, device, out, draw)

    def sample_fully_noised(self, nbatch: int, xshape, generator=None,
                            device=None):
        noise = torch.randn((nbatch,) + tuple(xshape), generator=generator,
                            device=device)
        return self.prior_scale(noise) * noise

    def prior_scale(self, x):
        """std(T), broadcast against x [B, ...]."""
        return bcast_right(self.std(x.new_full((x.shape[0],), self.T)), x)

    def sample_noise_at_t(self, t, x, generator=None):
        """(x_noised, noise)."""
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype)
        return self.mean(t, x) + bcast_right(self.std(t), x) * noise, noise


class VPScheduler(SDEScheduler):

    def beta(self, t):
        raise NotImplementedError

    def betaint(self, t):
        raise NotImplementedError

    def mean(self, t, x):
        return x * torch.exp(-0.5 * bcast_right(self.betaint(t), x))

    def std2_(self, t):
        # −expm1, not 1 − exp: 1 − exp(−x) can fall below −stabilizer for
        # tiny x and give a NaN sqrt
        return -torch.expm1(-self.betaint(t))

    def drift_term(self, t, x):
        return -0.5 * bcast_right(self.beta(t), x) * x

    def diffusion_term(self, t):
        return torch.sqrt(self.beta(t))


class VPSchedulerConstant(VPScheduler):
    def __init__(self, T=1.0, Tmin=1e-5, coef: float = 1.0):
        super().__init__(T, Tmin)
        self.coef = coef

    def beta(self, t):
        return self.coef + 0.0 * t

    def betaint(self, t):
        return self.coef * t


class VPSchedulerLinear(VPScheduler):
    def __init__(self, T=1.0, Tmin=1e-5, coef: float = 1.0):
        super().__init__(T, Tmin)
        self.coef = coef

    def beta(self, t):
        return self.coef * t

    def betaint(self, t):
        return 0.5 * self.coef * t ** 2


class VPSchedulerCustom(VPScheduler):
    def __init__(self, beta: Callable, betaint: Callable, T=1.0, Tmin=1e-5):
        super().__init__(T, Tmin)
        self._beta = beta
        self._betaint = betaint

    def beta(self, t):
        return self._beta(t)

    def betaint(self, t):
        return self._betaint(t)


class SubVPScheduler(VPSchedulerLinear):
    """Sub-VP (Song et al., eq. 29): the shrunken variance and its
    matching diffusion."""

    def std2_(self, t):
        return torch.expm1(-self.betaint(t)) ** 2

    def diffusion_term(self, t):
        return torch.sqrt(self.beta(t) * -torch.expm1(-2 * self.betaint(t)))


class VEScheduler(SDEScheduler):
    """σ(t) geometric between sigma_min and sigma_max."""

    def __init__(self, sigma_min: float = 0.01, sigma_max: float = 50.0,
                 T: float = 1.0, Tmin: float = 1e-5):
        super().__init__(T, Tmin)
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max

    def sigma(self, t):
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** (
            t / self.T)

    def mean(self, t, x):
        return x

    def std2_(self, t):
        return self.sigma(t) ** 2

    def drift_term(self, t, x):
        return torch.zeros_like(x)

    def diffusion_term(self, t):
        log_ratio = np.log(self.sigma_max / self.sigma_min)
        return self.sigma(t) * math.sqrt(2.0 * log_ratio / self.T)


class VESchedulerSqrt(SDEScheduler):
    """g(t) = sqrt(2t): std²(t) = t²."""

    def mean(self, t, x):
        return x

    def std2_(self, t):
        return t ** 2

    def drift_term(self, t, x):
        return torch.zeros_like(x)

    def diffusion_term(self, t):
        return torch.sqrt(2.0 * t)


def _metric(name: str):
    return losses.huber if name == "huber" else losses.mse


def sde_loss_fn(scheduler: SDEScheduler, noise_predictor, x, y=None,
                train: bool = True, loss_metric: str = "mse",
                loss_scale_factor: float = 1.0, t=None, eps=None,
                generator=None):
    """Denoising score matching with the 1/std weighting:
    scale·mean(metric(ε̂(x_t, t), ε)/std(t)), x_t = mean(t, x) +
    std(t)·ε, ``noise_predictor(x, t, y, train=)``. t (uniform on
    [Tmin, T]) and ε are drawn from ``generator`` in that order unless
    ``t``/``eps`` replay them."""
    if t is None:
        t = scheduler.sample((x.shape[0],), generator, device=x.device)
    std = bcast_right(scheduler.std(t), x)
    if eps is None:
        x_noised, noise = scheduler.sample_noise_at_t(t, x, generator)
    else:
        noise = torch.as_tensor(eps, dtype=x.dtype, device=x.device)
        x_noised = scheduler.mean(t, x) + std * noise
    pred = noise_predictor(x_noised, t, y, train=train)
    raw = _metric(loss_metric)(pred, noise)
    return loss_scale_factor * (raw / std).mean()


def _score(scheduler, noise_predictor, x, t, y):
    return -noise_predictor(x, t, y) / bcast_right(scheduler.std(t), x)


def em_step(scheduler, noise_predictor, x, t, dt, noise, y=None):
    """One reverse-SDE Euler–Maruyama step from the 0-d tensors t and
    dt (< 0): x + (f − g²·score)·dt + g·sqrt(−dt)·noise."""
    tb = t.expand(x.shape[0])
    score = _score(scheduler, noise_predictor, x, tb, y)
    g = bcast_right(scheduler.diffusion_term(tb), x)
    drift = scheduler.drift_term(tb, x) - g ** 2 * score
    return x + drift * dt + g * noise * torch.sqrt(-dt)


def pf_step(scheduler, noise_predictor, x, t, t_next, y=None,
            method: str = "heun"):
    """One probability-flow step from t to t_next (0-d tensors) on
    dx = (f − g²·score/2) dt, Euler or Heun."""
    def rhs(xc, tt):
        tb = tt.expand(xc.shape[0])
        score = _score(scheduler, noise_predictor, xc, tb, y)
        g = bcast_right(scheduler.diffusion_term(tb), xc)
        return scheduler.drift_term(tb, xc) - 0.5 * g ** 2 * score

    dt = t_next - t
    r1 = rhs(x, t)
    if method == "euler":
        return x + dt * r1
    xe = x + dt * r1
    return x + 0.5 * dt * (r1 + rhs(xe, t_next))


def em_grid(scheduler, nsteps: int):
    """(t, dt) of each Euler–Maruyama step, float32 of linspace(T, Tmin,
    nsteps + 1) and of its float64 differences."""
    ts = np.linspace(scheduler.T, scheduler.Tmin, nsteps + 1)
    return ts[:-1].astype(np.float32), np.diff(ts).astype(np.float32)


def pf_grid(scheduler, nsteps: int):
    """(t, t_next) of each probability-flow step, float32."""
    ts = np.linspace(scheduler.T, scheduler.Tmin, nsteps + 1).astype(
        np.float32)
    return ts[:-1], ts[1:]


def sde_sampler(scheduler: SDEScheduler, noise_predictor, nsamples: int,
                shape, y=None, nsteps: int = 1000,
                record_history: bool = False, generator=None,
                noise_seq=None, x_T=None):
    """Reverse-SDE Euler–Maruyama sampling: x_T = std(T)·N(0, 1), then
    ``nsteps`` steps from T to Tmin, each with one draw (``noise_seq``
    replays them). ``x_T`` replaces the start. Returns x, or the
    [nsteps, *x.shape] states after each step with ``record_history``."""
    x = scheduler.sample_fully_noised(
        nsamples, shape, generator, getattr(generator, "device", None)) \
        if x_T is None else torch.as_tensor(x_T, dtype=torch.float32)
    t_grid, dt_grid = em_grid(scheduler, nsteps)
    history = []
    for i in range(nsteps):
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype) if noise_seq is None else \
            torch.as_tensor(noise_seq[i], dtype=x.dtype, device=x.device)
        x = em_step(scheduler, noise_predictor, x,
                    x.new_full((), float(t_grid[i])),
                    x.new_full((), float(dt_grid[i])), noise, y)
        if record_history:
            history.append(x)
    return torch.stack(history) if record_history else x


def pf_sampler(scheduler: SDEScheduler, noise_predictor, nsamples: int,
               shape, y=None, nsteps: int = 1000,
               record_history: bool = False, method: str = "heun", x0=None,
               generator=None):
    """Probability-flow ODE sampling, Euler or Heun, from std(T)·N(0, 1)
    or ``x0``. Returns x, or the states after each step with
    ``record_history``."""
    x = scheduler.sample_fully_noised(
        nsamples, shape, generator, getattr(generator, "device", None)) \
        if x0 is None else torch.as_tensor(x0, dtype=torch.float32)
    t_grid, tn_grid = pf_grid(scheduler, nsteps)
    history = []
    for t, tn in zip(t_grid, tn_grid):
        x = pf_step(scheduler, noise_predictor, x, x.new_full((), float(t)),
                    x.new_full((), float(tn)), y, method)
        if record_history:
            history.append(x)
    return torch.stack(history) if record_history else x


class SDEModel(RuntimeMixin):
    """The SDE runtime around a noise network ``net(x, t, y)`` on
    [B, C, *spatial] (state-dict names ``model.*``). ``config.noisesampler``
    is the scheduler (its t draw), so ``make_train_step(model, tx,
    loss_fn=lambda x, t, y, mask, eps: model.loss_fn(x, y, t=t,
    eps=eps))`` trains it."""

    def __init__(self, model: nn.Module, scheduler: SDEScheduler,
                 conditional: bool = False,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.scheduler = scheduler
        self.conditional = conditional
        self.compute_dtype = None
        self.autoencoder = None
        self.config = RuntimeConfig(noisesampler=scheduler)
        self.net = RuntimeNet(model).to(self.device).eval()
        self._reset_runtime()

    def noise_predictor(self, x, t, y=None, train: bool = False):
        return self._network(train)(x, t, y)

    def loss_fn(self, x, y=None, train: bool = True, **kwargs):
        """``sde_loss_fn`` on this model (``loss_metric``,
        ``loss_scale_factor``, ``t``, ``eps``, ``generator``)."""
        return sde_loss_fn(self.scheduler, self.noise_predictor, x, y, train,
                           **kwargs)

    @torch.inference_mode()
    def sample(self, nsamples: int, shape, generator=None, y=None,
               nsteps: int = 1000, probability_flow: bool = False,
               record_history: bool = False, method: str = "heun",
               noise_seq=None):
        """Samples by ``sde_sampler`` (Euler–Maruyama; ``noise_seq``
        replays the steps' draws) or, with ``probability_flow``,
        ``pf_sampler`` (``method`` "heun" or "euler"). The draws from
        ``generator``: x_T, then one a step. On a CUDA device each step
        replays the graph of ``compile_sampler``; on the CPU the loop runs
        eagerly."""
        x_shape = (nsamples,) + tuple(shape)
        sched = self.scheduler
        if self.device.type != "cuda":
            x = _draw(torch.empty(x_shape, device=self.device), generator)
            x = sched.prior_scale(x) * x
            if probability_flow:
                return pf_sampler(sched, self.noise_predictor, nsamples,
                                  shape, y, nsteps, record_history, method,
                                  x0=x)
            return sde_sampler(sched, self.noise_predictor, nsamples, shape,
                               y, nsteps, record_history, generator,
                               noise_seq, x_T=x)
        graph = self.compile_sampler(nsamples, shape, y, probability_flow,
                                     method)
        x, t, aux, noise, ys = graph.inputs
        _draw(x, generator)
        x.mul_(sched.prior_scale(x))
        graphs.fill(ys, y)
        if probability_flow:
            grid = pf_grid(sched, nsteps)
        else:
            grid = em_grid(sched, nsteps)
        if noise_seq is not None:
            noise_seq = torch.as_tensor(noise_seq, dtype=x.dtype,
                                        device=x.device)
        history = []
        for i in range(nsteps):
            t.fill_(float(grid[0][i]))
            aux.fill_(float(grid[1][i]))
            if not probability_flow:
                if noise_seq is None:
                    _draw(noise, generator)
                else:
                    noise.copy_(noise_seq[i])
            graph.replay()
            if record_history:
                history.append(x.clone())
        return torch.stack(history) if record_history else x.clone()

    @torch.inference_mode()
    def compile_sampler(self, nsamples: int, shape, y=None,
                        probability_flow: bool = False,
                        method: str = "heun", nsteps: int | None = None):
        """The CUDA graph of one step for (nsamples, shape, y's shapes, the
        sampler, ``method``; not for ``nsteps``), which updates its input x
        in place from its inputs t and dt (Euler–Maruyama: and the step's
        noise) or t and the next t (probability flow). Static inputs
        (``graph.inputs``): x, t, dt or the next t, the noise, y. Returns
        the ``utils.graphs.Graph``; None on the CPU."""
        if self.device.type != "cuda":
            return None
        cache = self._graph_cache()
        key = (nsamples, tuple(shape), graphs.condition_key(y),
               probability_flow, method if probability_flow else None)
        graph = cache.graphs.get(key)
        if graph is not None:
            return graph
        x = torch.ones((nsamples,) + tuple(shape), device=self.device)
        t = torch.full((), float(self.scheduler.T), device=self.device)
        aux = torch.full((), -1e-3 if not probability_flow else
                         float(self.scheduler.T) - 1e-3, device=self.device)
        noise = torch.zeros_like(x)
        ys = graphs.static_like(y, self.device)
        graphs.fill(ys, y)
        sched, pred = self.scheduler, self.noise_predictor

        def step():
            if probability_flow:
                x.copy_(pf_step(sched, pred, x, t, aux, ys, method))
            else:
                x.copy_(em_step(sched, pred, x, t, aux, noise, ys))

        cache.warmup(step)
        graph = cache.capture(key, step)
        graph.inputs = (x, t, aux, noise, ys)
        return graph
