"""DDPM v1: the conventions of the reference's deprecated first DDPM
stack, kept for reproducing its checkpoints and results.

Port of ``diffsci_tpu/models/ddpm_v1.py``:

- ``DDPMSchedulerV1``: 1-indexed t ∈ {1..T}; β interpolates linearly with
  s = (t − 1)/(T − 1) between beta0 and beta1; ᾱ is a host table (the
  float64 cumulative product over 1..T, stored as float32, one device
  copy a device) gathered at int(t) − 1, clipped; ``schedule(reverse=)``
  honours its argument;
- ``DDPMModuleV1``: the ε-prediction loss with the optional "default" λ
  weighting λ = β²/(2·β·α·(1 − ᾱ)) and the mse or Huber (δ 1) metric,
  ``apply_noise``, ``backward`` (DDPM with noise type 1 or 2, DDIM with
  noise type 0, 1 or 2; ``None`` resolves per sampler, 1 for DDPM and 0
  for DDIM; the t = 1 step adds no noise; DDIM's predicted term divides
  by sqrt(α_t), not sqrt(ᾱ_t), reproduced as the reference executes it)
  and ``sample``;
- ``default_v1_optimizer``: AdamW(1e-3, betas (0.9, 0.999), wd 1e-4)
  with no clip, over ``cosine_restarts_schedule`` when a restart period
  is given.

The updates are plain torch, as the JAX package computes them in plain
``jnp`` (no fused kernel). Samples are channels-last and ``RuntimeNet``
moves the channel axis at the network boundary. ``noise_seq`` [T, ...]
(t = T first) replays the steps' draws.

On a CUDA device ``sample`` (and ``backward``) replay one CUDA graph of
a step per t, as ``DDPMModel.sample`` does: t is a 0-d device tensor and
the step's noise a static input, filled before each replay. The train
step draws t ∈ {1..T} by ``config.noisesampler`` (the scheduler).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from diffsci_tpu_torch.models.ddpm import _draw
from diffsci_tpu_torch.models.karras.train import (AdamWClip,
                                                   cosine_restarts_schedule)
from diffsci_tpu_torch.models.runtime import (RuntimeConfig, RuntimeMixin,
                                              RuntimeNet, fill_draw)
from diffsci_tpu_torch.utils import bcast_right, graphs, resolve_device


class DDPMSchedulerV1:
    """β, α, σ and ᾱ over t = 1..T; t are float32 tensors."""

    def __init__(self, beta0: float = 1e-4, beta1: float = 2e-2,
                 T: int = 1000):
        self.beta0 = float(beta0)
        self.beta1 = float(beta1)
        self.T = int(T)
        t = np.arange(1, self.T + 1, dtype=np.float64)
        s = (t - 1.0) / (self.T - 1.0)
        beta = self.beta0 * (1.0 - s) + self.beta1 * s
        self._calpha_np = np.cumprod(1.0 - beta).astype(np.float32)
        self._tables: dict = {}

    def beta(self, t):
        s = (t - 1.0) / (self.T - 1.0)
        return self.beta0 * (1.0 - s) + self.beta1 * s

    def alpha(self, t):
        return 1.0 - self.beta(t)

    def sigma(self, t):
        return torch.sqrt(self.beta(t))

    def calpha(self, t):
        """ᾱ at int(t) (truncated, as an int32 cast), from the table."""
        t = torch.as_tensor(t)
        table = self._tables.get(t.device)
        if table is None:
            table = torch.from_numpy(self._calpha_np).to(t.device)
            self._tables[t.device] = table
        return table[(t.to(torch.int64) - 1).clamp(0, self.T - 1)]

    def sample(self, shape, generator=None, device=None, out=None):
        """Uniform integer t in {1..T} as float32, of ``shape`` (an int
        is the batch) or into ``out``: the draw the train step makes into
        σ's slot."""
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        return fill_draw(shape, generator, device, out,
                         lambda t: torch.randint(1, self.T + 1, t.shape,
                                                 generator=generator, out=t))

    def schedule(self, reverse: bool = False) -> np.ndarray:
        t = np.arange(1, self.T + 1)
        return t[::-1] if reverse else t


class DDPMModuleV1(RuntimeMixin):
    """The v1 runtime around a noise network ``net(x, t)`` (or
    ``net(x, t, y)`` when ``conditional``) on [B, C, *spatial]
    (state-dict names ``model.*``)."""

    def __init__(self, model: nn.Module,
                 scheduler: DDPMSchedulerV1 | None = None,
                 conditional: bool = False, loss_type: str = "mse",
                 loss_scale_factor: float = 1.0,
                 loss_scaling: str = "constant",
                 device: torch.device | str | None = None):
        if loss_type not in ("mse", "huber"):
            raise ValueError(f"loss_type {loss_type} not recognized")
        self.device = resolve_device(device)
        self.scheduler = scheduler or DDPMSchedulerV1()
        self.conditional = conditional
        self.loss_type = loss_type
        self.loss_scale_factor = float(loss_scale_factor)
        self.loss_scaling = loss_scaling
        self.compute_dtype = None
        self.autoencoder = None
        self.config = RuntimeConfig(noisesampler=self.scheduler)
        self.net = RuntimeNet(model).to(self.device).eval()
        self._reset_runtime()

    def _net(self, x, t, y):
        """The network in eval mode, as the JAX package applies it (also
        in the loss)."""
        net = self._network(False)
        return net(x, t, y) if self.conditional else net(x, t)

    def _metric(self, pred, target):
        if self.loss_type == "mse":
            return (pred - target) ** 2
        d = (pred - target).abs()  # Huber, δ = 1 (torch's default)
        return torch.where(d < 1.0, 0.5 * d ** 2, d - 0.5)

    def loss_fn(self, x, t=None, y=None, noise=None, generator=None):
        """scale·mean(λ·metric(ε̂(x_t, t), ε)), x_t = sqrt(ᾱ_t)·x +
        sqrt(1 − ᾱ_t)·ε. t (uniform in {1..T}) and ε are drawn from
        ``generator`` in that order unless ``t``/``noise`` replay them."""
        if self.conditional != (y is not None):
            raise ValueError("a conditional module takes y, an "
                             "unconditional one none")
        sched = self.scheduler
        if t is None:
            t = sched.sample(x.shape[0], generator, device=x.device)
        calpha = bcast_right(sched.calpha(t), x)
        if self.loss_scaling == "default":
            beta = sched.beta(t)
            alpha = 1.0 - beta
            lambd = bcast_right(beta ** 2 / (2 * beta * alpha
                                             * (1 - sched.calpha(t))), x)
        else:
            lambd = 1.0
        if noise is None:
            noise = torch.randn(x.shape, generator=generator,
                                device=x.device, dtype=x.dtype)
        x_noised = torch.sqrt(calpha) * x + torch.sqrt(1 - calpha) * noise
        pred = self._net(x_noised, t, y)
        loss = (lambd * self._metric(pred, noise)).mean()
        return self.loss_scale_factor * loss

    def apply_noise(self, x, t, noise=None, generator=None):
        calpha = bcast_right(self.scheduler.calpha(t), x)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator,
                                device=x.device, dtype=x.dtype)
        return torch.sqrt(calpha) * x + torch.sqrt(1 - calpha) * noise

    def step(self, x, t, noise, y=None, sampler: str = "ddpm",
             noise_type: int = 1):
        """One reverse step at t (a 0-d tensor); ``noise`` counts only
        where t > 1."""
        sched = self.scheduler
        tb = t.expand(x.shape[0])
        calpha = bcast_right(sched.calpha(tb), x)
        alpha = bcast_right(1.0 - sched.beta(tb), x)
        eps = self._net(x, tb, y)
        z = torch.where(t > 1.0, noise, torch.zeros_like(noise))
        if sampler == "ddpm":
            if noise_type == 1:
                sig = torch.sqrt(1 - alpha)
            elif noise_type == 2:
                calpha_prev = calpha / alpha
                sig = torch.sqrt((1 - alpha) * (1 - calpha_prev)
                                 / (1 - calpha))
            else:
                sig = 0.0
            return (x - (1 - alpha) / torch.sqrt(1 - calpha) * eps) \
                / torch.sqrt(alpha) + sig * z
        if sampler == "ddim":
            calpha_prev = calpha / alpha
            if noise_type == 1:
                sig = torch.sqrt(1 - alpha)
            elif noise_type == 2:
                sig = torch.sqrt((1 - alpha) * (1 - calpha_prev)
                                 / (1 - calpha))
            else:
                sig = torch.zeros_like(alpha)
            predicted = (x - torch.sqrt(1 - calpha) * eps) / torch.sqrt(alpha)
            pointing = torch.sqrt(torch.clamp(
                1 - calpha_prev - sig ** 2, min=0.0)) * eps
            return predicted + pointing + sig * z
        raise ValueError(f"sampler {sampler!r} not recognized")

    @torch.inference_mode()
    def backward(self, x, y=None, noise_type: int | None = None,
                 sampler: str = "ddpm", noise_seq=None, generator=None):
        """The reverse process T..1 from x; each step draws its noise from
        ``generator`` (one generator a row for a list) unless
        ``noise_seq`` ([T, *x.shape], t = T first) replays them. On a CUDA
        device each step replays the graph of ``compile_sampler``."""
        if noise_type is None:
            noise_type = 0 if sampler == "ddim" else 1
        if y is not None and y.ndim == x.ndim - 1:
            y = y[None]  # a single conditioning row
        T = self.scheduler.T
        ts = self.scheduler.schedule(reverse=True).astype(np.float32)
        if noise_seq is not None:
            noise_seq = torch.as_tensor(noise_seq, dtype=x.dtype,
                                        device=x.device)
        graph = self.compile_sampler(x.shape[0], x.shape[1:], y, sampler,
                                     noise_type)
        if graph is None:
            t, noise = x.new_zeros(()), torch.empty_like(x)
        else:
            xs, t, noise, ys = graph.inputs
            xs.copy_(x)
            graphs.fill(ys, y)
            x = xs
        for i in range(T):
            t.fill_(float(ts[i]))
            if noise_seq is None:
                _draw(noise, generator)
            else:
                noise.copy_(noise_seq[i])
            if graph is None:
                x = self.step(x, t, noise, y, sampler, noise_type)
            else:
                graph.replay()
        return x.clone()

    @torch.inference_mode()
    def sample(self, nsamples: int, shape, generator=None, y=None,
               nsteps: int | None = None, **kw):
        """Samples: x_T drawn from ``generator`` (a list: one a row), then
        ``backward`` (``noise_type``, ``sampler``, ``noise_seq``).
        ``nsteps``, when given (as ``SamplerService`` passes it), must be
        the scheduler's T: v1 has no shortened grid."""
        if nsteps is not None and nsteps != self.scheduler.T:
            raise ValueError(f"v1 samples over its T = {self.scheduler.T} "
                             f"steps, not {nsteps}")
        x = _draw(torch.empty((nsamples,) + tuple(shape),
                              device=self.device), generator)
        return self.backward(x, y=y, generator=generator, **kw)

    @torch.inference_mode()
    def compile_sampler(self, nsamples: int, shape, y=None,
                        sampler: str = "ddpm", noise_type: int | None = None,
                        nsteps: int | None = None):
        """The CUDA graph of one reverse step for (nsamples, shape, y's
        shapes, the sampler, the noise type; not ``nsteps``, v1 always
        runs T), which updates its input x in place from its inputs t and
        noise. Static inputs (``graph.inputs``): x, t, the noise, y.
        Returns the ``utils.graphs.Graph``; None on the CPU."""
        if self.device.type != "cuda":
            return None
        if noise_type is None:
            noise_type = 0 if sampler == "ddim" else 1
        cache = self._graph_cache()
        key = (nsamples, tuple(shape), graphs.condition_key(y), sampler,
               noise_type)
        graph = cache.graphs.get(key)
        if graph is not None:
            return graph
        x = torch.zeros((nsamples,) + tuple(shape), device=self.device)
        t = torch.full((), float(self.scheduler.T), device=self.device)
        noise = torch.zeros_like(x)
        ys = graphs.static_like(y, self.device)
        graphs.fill(ys, y)

        def step():
            x.copy_(self.step(x, t, noise, ys, sampler, noise_type))

        cache.warmup(step)
        graph = cache.capture(key, step)
        graph.inputs = (x, t, noise, ys)
        return graph


def default_v1_optimizer(learning_rate: float = 1e-3,
                         weight_decay: float = 1e-4,
                         restart_period: int | None = None,
                         n_restarts: int = 10) -> AdamWClip:
    """v1's training defaults: AdamW(1e-3, betas (0.9, 0.999), wd 1e-4)
    with no gradient clip, over ``cosine_restarts_schedule`` when
    ``restart_period`` (in steps) is given."""
    lr = learning_rate
    if restart_period is not None:
        lr = cosine_restarts_schedule(learning_rate, restart_period,
                                      n_restarts=n_restarts)
    return AdamWClip(lr, weight_decay, 0.9, 0.999, grad_clip=None)
