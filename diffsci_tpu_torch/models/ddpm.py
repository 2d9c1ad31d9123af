"""DDPM v2: discrete-time denoising diffusion (DDPM / DDIM).

Port of ``diffsci_tpu/models/ddpm.py``: the ᾱ schedulers (classical,
exp, cosine), the integrators (classical DDPM type 1 and 2, generalized
DDPM and DDIM), ``DDPMModelConfig`` and ``DDPMModel`` (ε-prediction loss
and sampling). The classical ᾱ table for t = 0..T is built once on the
host in float64, cast to float32, and looked up by a rounded, clipped
index, as in the JAX package. The backward loop runs t = T, ..., 1 as a
Python loop; each step folds its coefficients to [B] and applies
x' = a·x + b·ε + c·noise with kernel K7 (``fused_lincomb3``), each forward
(noising) step x' = a·x + b·noise with K1 (``fused_axby``).

Randomness is an explicit ``torch.Generator``; ``noise_seq`` [T, *x.shape]
replays fixed per-step draws instead (the cross-framework test hook).
On a CUDA device ``DDPMModel.sample`` replays one CUDA graph of a backward
step per t, with t and the step's noise as the graph's static inputs: the
counterpart of the JAX package's ``lax.scan`` over ``{"t", "noise"}``
(``diffsci_tpu/models/ddpm.py:138-151``).
Samples are channels-last, as in the JAX package; ``noise_predictor``
moves the channel axis at the network boundary (x, and y when it is
spatial). With ``compute_dtype`` it casts x, t and y to it, as the JAX
package does: bf16 rounds t (999 becomes 1000, 501 becomes 500).
``sample(mesh=...)`` samples data-parallel, one process a rank.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from diffsci_tpu_torch.kernels import fused_precondition as fp
from diffsci_tpu_torch.models.compute import ComputeDtypeMixin
from diffsci_tpu_torch.models.nets.layers import init_parameters
from diffsci_tpu_torch.ops import losses
from diffsci_tpu_torch.utils import (bcast_right, dict_map, graphs,
                                     resolve_device)


def _draw(out: torch.Tensor, generator) -> torch.Tensor:
    """Fill ``out`` ([B, *shape]) from ``generator``, or, given a list of
    generators (one a row, as the service's dispatcher passes them), row i
    from the i-th alone and rows past them with zeros. Returns ``out``."""
    if isinstance(generator, (list, tuple)):
        out.zero_()
        for row, g in zip(out, generator):
            torch.randn(row.shape, generator=g, out=row)
    else:
        torch.randn(out.shape, generator=generator, out=out)
    return out


class DDPMScheduler:
    """ᾱ schedule over T discrete steps; t are float32 tensors."""

    def __init__(self, T: int = 1000):
        self.T = T

    def calpha_norm(self, s):
        raise NotImplementedError

    def calpha(self, t, T: int | None = None):
        T = self.T if T is None else T
        return self.calpha_norm(t / T)

    def alpha(self, t, T: int | None = None):
        return self.calpha(t, T) / self.calpha(t - 1, T)

    def beta(self, t, T: int | None = None):
        return 1 - self.alpha(t, T)


class ClassicalDDPMScheduler(DDPMScheduler):
    """Linear-β schedule with a host-built ᾱ table (float64 cumulative
    product, stored as float32), one device copy per (T, device)."""

    def __init__(self, beta1T: float = 20.0, beta0: float = 1e-4,
                 T: int = 1000):
        super().__init__(T)
        self.beta1T = beta1T
        self.beta0 = beta0
        self._tables: dict[tuple, torch.Tensor] = {}

    def _table(self, T: int, device) -> torch.Tensor:
        key = (T, torch.device(device))
        if key not in self._tables:
            ts = np.arange(1, T + 1, dtype=np.float64)
            s = (ts - 1) / (T - 1)
            alphas = 1.0 - (self.beta0 * (1 - s) + self.beta1T / T * s)
            table = np.concatenate([[1.0], np.cumprod(alphas)])
            self._tables[key] = torch.from_numpy(
                table.astype(np.float32)).to(device)
        return self._tables[key]

    def calpha(self, t, T: int | None = None):
        T = self.T if T is None else T
        t = torch.as_tensor(t, dtype=torch.float32)
        idx = torch.round(t).long().clamp(0, T)
        return self._table(T, t.device)[idx]

    def beta(self, t, T: int | None = None):
        T = self.T if T is None else T
        s = (t - 1) / (T - 1)
        return self.beta0 * (1 - s) + self.beta1T / T * s

    def alpha(self, t, T: int | None = None):
        return 1.0 - self.beta(t, T)


class ExpDDPMScheduler(DDPMScheduler):
    def __init__(self, beta_data: float = 19.9, beta0: float = 1e-4,
                 T: int = 1000):
        super().__init__(T)
        self.beta_data = beta_data
        self.beta0 = beta0

    def calpha_norm(self, s):
        return torch.exp(-0.5 * (self.beta_data * s ** 2 + self.beta0))


class CosineDDPMScheduler(DDPMScheduler):
    def __init__(self, stabilizer: float = 0.008, T: int = 1000):
        super().__init__(T)
        self.stabilizer = stabilizer
        self.f0 = math.cos(stabilizer / (1 + stabilizer) * math.pi / 2) ** 2

    def calpha_norm(self, s):
        ft = torch.cos((self.stabilizer + s) / (1 + self.stabilizer)
                       * math.pi / 2) ** 2
        return ft / self.f0


def _name_to_scheduler(name: str) -> DDPMScheduler:
    return {"classical": ClassicalDDPMScheduler,
            "exp": ExpDDPMScheduler,
            "cosine": CosineDDPMScheduler}[name]()


class DDPMIntegratorBase:
    """Backward (sampling) and forward (noising) propagation over
    t = T, ..., 1."""

    def __init__(self, scheduler: DDPMScheduler):
        self.scheduler = scheduler

    def step_backward(self, x, t, noise_predictor, T, noise=None,
                      generator=None):
        raise NotImplementedError

    def step_forward(self, x, t, T, noise=None, generator=None):
        raise NotImplementedError

    def _propagate(self, step, x, nsteps, record_history, noise_seq):
        T = self.scheduler.T if nsteps is None else nsteps
        ts = torch.arange(T, 0, -1, dtype=torch.float32, device=x.device)
        if noise_seq is not None:
            noise_seq = torch.as_tensor(noise_seq, dtype=x.dtype,
                                        device=x.device)
        history = [x] if record_history else None
        for i in range(T):
            x = step(x, ts[i], T,
                     None if noise_seq is None else noise_seq[i])
            if record_history:
                history.append(x)
        return torch.stack(history) if record_history else x

    def propagate_backward(self, x, noise_predictor,
                           nsteps: int | None = None,
                           record_history: bool = False, noise_seq=None,
                           generator=None):
        """Sample from x (white noise at t = T) with ``noise_predictor(x,
        t)``. ``noise_seq`` [T, *x.shape] replays fixed per-step draws in
        place of draws from ``generator``. Returns x at t = 0, or
        [T + 1, *x.shape] with ``record_history``."""
        def step(xc, t, T, noise):
            return self.step_backward(xc, t, noise_predictor, T, noise,
                                      generator)
        return self._propagate(step, x, nsteps, record_history, noise_seq)

    def propagate_forward(self, x, nsteps: int | None = None,
                          record_history: bool = False, noise_seq=None,
                          generator=None):
        """Noise x over T forward steps; as ``propagate_backward``."""
        def step(xc, t, T, noise):
            return self.step_forward(xc, t, T, noise, generator)
        return self._propagate(step, x, nsteps, record_history, noise_seq)

    @staticmethod
    def _noise(x, noise, generator):
        if noise is None:
            return torch.randn(x.shape, generator=generator, device=x.device,
                               dtype=x.dtype)
        return noise


class ClassicalDDPMIntegrator(DDPMIntegratorBase):
    """DDPM-paper formulation."""

    def noise_injector(self, t, T):
        raise NotImplementedError

    def step_backward(self, x, t, noise_predictor, T, noise=None,
                      generator=None):
        # coefficients at [B]; the update is one pass of K7
        tb = t.expand(x.shape[0])
        sigma_t = self.noise_injector(tb, T)
        calpha_t = self.scheduler.calpha(tb, T)
        alpha_t = self.scheduler.alpha(tb, T)
        beta_t = 1 - alpha_t
        eps = noise_predictor(x, tb)
        noise = self._noise(x, noise, generator)
        inv_sa = 1.0 / torch.sqrt(alpha_t)
        a = inv_sa
        b = -beta_t / torch.sqrt(1 - calpha_t) * inv_sa
        return fp.fused_lincomb3(x, eps, noise, a, b, sigma_t)

    def step_forward(self, x, t, T, noise=None, generator=None):
        tb = t.expand(x.shape[0])
        beta_t = self.scheduler.beta(tb, T)
        noise = self._noise(x, noise, generator)
        return fp.fused_axby(x, noise, torch.sqrt(1 - beta_t),
                             torch.sqrt(beta_t))


class ClassicalDDPMIntegratorType1(ClassicalDDPMIntegrator):
    """σ_t = sqrt(β_t)."""

    def noise_injector(self, t, T):
        return torch.sqrt(self.scheduler.beta(t, T))


class ClassicalDDPMIntegratorType2(ClassicalDDPMIntegrator):
    """σ_t² = (1 − ᾱ_{t−1}) / (1 − ᾱ_t) · β_t."""

    def noise_injector(self, t, T):
        calpha_prev = self.scheduler.calpha(t - 1, T)
        calpha = self.scheduler.calpha(t, T)
        beta = self.scheduler.beta(t, T)
        return torch.sqrt((1 - calpha_prev) / (1 - calpha) * beta)


class GeneralizedDDPMIntegrator(DDPMIntegratorBase):
    """DDIM-paper formulation."""

    def noise_injector(self, t, T):
        raise NotImplementedError

    def step_backward(self, x, t, noise_predictor, T, noise=None,
                      generator=None):
        tb = t.expand(x.shape[0])
        sigma_t = self.noise_injector(tb, T)
        calpha_t = self.scheduler.calpha(tb, T)
        calpha_prev = self.scheduler.calpha(tb - 1, T)
        eps = noise_predictor(x, tb)
        noise = self._noise(x, noise, generator)
        # x0_dir + xt_dir + σ·noise folded to a·x + b·ε + c·noise
        inv_sca = 1.0 / torch.sqrt(calpha_t)
        a = torch.sqrt(calpha_prev) * inv_sca
        xt_factor = torch.relu(1 - calpha_prev - sigma_t ** 2)
        b = torch.sqrt(xt_factor) - a * torch.sqrt(1 - calpha_t)
        return fp.fused_lincomb3(x, eps, noise, a, b, sigma_t)

    def step_forward(self, x, t, T, noise=None, generator=None):
        tb = t.expand(x.shape[0])
        calpha_t = self.scheduler.calpha(tb, T)
        calpha_prev = self.scheduler.calpha(tb - 1, T)
        noise = self._noise(x, noise, generator)
        ratio = calpha_t / calpha_prev
        return fp.fused_axby(x, noise, torch.sqrt(ratio), 1 - ratio)


class DDPMIntegrator(GeneralizedDDPMIntegrator):
    def noise_injector(self, t, T):
        calpha_t = self.scheduler.calpha(t, T)
        calpha_prev = self.scheduler.calpha(t - 1, T)
        return torch.sqrt((1 - calpha_prev) / (1 - calpha_t)
                          * (1 - calpha_t / calpha_prev))


class DDIMIntegrator(GeneralizedDDPMIntegrator):
    """Deterministic DDIM: σ = 0 (the noise is still drawn, times 0)."""

    def noise_injector(self, t, T):
        return 0.0 * t


class DDPMModelConfig:
    """Scheduler, integrator and the loss metric ("huber" or "mse")."""

    def __init__(self, scheduler: DDPMScheduler,
                 integrator: DDPMIntegratorBase,
                 loss_metric: str = "huber"):
        self.scheduler = scheduler
        self.integrator = integrator
        self.loss_metric = loss_metric

    @classmethod
    def from_classical_ddpm(cls, integrator_type: int = 1,
                            scheduler: str = "classical"):
        sched = _name_to_scheduler(scheduler)
        integ = (ClassicalDDPMIntegratorType1(sched) if integrator_type == 1
                 else ClassicalDDPMIntegratorType2(sched))
        return cls(sched, integ)

    @classmethod
    def from_ddpm(cls, scheduler: str = "classical"):
        sched = _name_to_scheduler(scheduler)
        return cls(sched, DDPMIntegrator(sched))

    @classmethod
    def from_ddim(cls, scheduler: str = "classical"):
        sched = _name_to_scheduler(scheduler)
        return cls(sched, DDIMIntegrator(sched))


_LOSSES = {"mse": losses.mse, "huber": losses.huber}


class DDPMModel(ComputeDtypeMixin):
    """ε-prediction runtime around a noise network ``net(x, t, y=None)`` on
    [B, C, *spatial] (or [B, dim] for the MLPs): loss and discrete-time
    sampling. The network's weights live in ``self.net`` (state-dict names
    as the network's own, e.g. ``unet.conv_in.weight``)."""

    def __init__(self, model: nn.Module, config: DDPMModelConfig,
                 conditional: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 device: torch.device | str | None = None):
        """``compute_dtype`` (e.g. ``torch.bfloat16``): the network runs
        with its parameters and inputs cast to it; ᾱ math, the updates,
        the sampler state and the loss stay float32."""
        if config.loss_metric not in _LOSSES:
            raise ValueError(
                f"loss_type {config.loss_metric} not recognized")
        self._loss = _LOSSES[config.loss_metric]
        self.device = resolve_device(device)
        self.config = config
        self.conditional = conditional
        self.compute_dtype = compute_dtype
        self.net = model.to(self.device).eval()
        self._reset_cast()

    def to(self, device) -> "DDPMModel":
        self.device = resolve_device(device)
        self.net.to(self.device)
        return self

    def init(self, seed: int = 0) -> dict:
        """Draw every weight from ``seed`` (device-independent); returns
        the state dict."""
        init_parameters(self.net, seed)
        return self.net.state_dict()

    def noise_predictor(self, x, t, y=None, train: bool = False):
        """ε(x, t, y) for channels-last x and t [B]; float32 out under a
        ``compute_dtype``."""
        cd = self.compute_dtype
        net = self._network(train)
        if cd is not None:
            x, t = x.to(cd), t.to(cd)
            y = dict_map(lambda v: v.to(cd) if v.is_floating_point() else v,
                         y)
        if torch.is_tensor(y) and y.ndim > 2:
            y = y.movedim(-1, 1)
        out = net(x.movedim(-1, 1), t, y).movedim(1, -1)
        # K7 takes contiguous tensors; a same-dtype .to() would alias
        if cd is None:
            return out.contiguous()
        return out.to(torch.float32, memory_format=torch.contiguous_format)

    def sample_timestep(self, nsamples: int, generator=None):
        """Uniform integer t in [1, T], as float32."""
        return torch.randint(1, self.config.scheduler.T + 1, (nsamples,),
                             generator=generator,
                             device=self.device).float()

    def loss_fn(self, x, t, y=None, train: bool = True, eps=None,
                generator=None):
        """ε-matching loss: mean over elements of metric(ε̂(x_t, t), ε)
        with x_t = sqrt(ᾱ_t)·x + sqrt(1 − ᾱ_t)·ε. ``eps`` replays a fixed
        draw in place of one from ``generator``; dropout, when the network
        has any, draws from torch's default generator of the device."""
        noise = (torch.randn(x.shape, generator=generator, device=x.device,
                             dtype=x.dtype)
                 if eps is None else torch.as_tensor(eps, dtype=x.dtype,
                                                     device=x.device))
        calpha = bcast_right(self.config.scheduler.calpha(t), x)
        x_noised = torch.sqrt(calpha) * x + torch.sqrt(1 - calpha) * noise
        eps_pred = self.noise_predictor(x_noised, t, y, train=train)
        return self._loss(eps_pred, noise).mean()

    @torch.inference_mode()
    def sample(self, nsamples: int, shape, generator=None, y=None,
               nsteps: int | None = None, record_history: bool = False,
               mesh=None):
        """Samples from white noise drawn on the model's device with
        ``generator``, which also draws each step's noise. ``shape`` is
        channels-last without the batch dim, e.g. (32, 32, 3); ``nsteps``
        defaults to the scheduler's T. ``generator`` may be a list of
        generators, one a row, as the service's dispatcher passes them:
        row i's x_T and step noise are then drawn from the i-th alone, in
        the same order, so a row depends on its own generator only.

        On a CUDA device each step replays the graph of
        ``compile_sampler``: before it, t is copied into the graph's input
        and the step's noise drawn into its own, one draw a step in the
        eager order, so one seed gives the eager loop's draws. On the CPU
        the loop runs eagerly.

        ``mesh`` (a ``DeviceMesh`` with a ``data`` axis; every rank calls):
        data-parallel sampling, as ``KarrasModel.sample(mesh=...)``: each
        rank draws the whole batch's x_T and step noise, runs its rows,
        and the rows are all-gathered in rank order; ``nsamples`` must
        divide the axis."""
        T = self.config.scheduler.T if nsteps is None else nsteps
        x_shape = (nsamples,) + tuple(shape)
        if mesh is not None:
            return self._sample_on_mesh(mesh, nsamples, shape, generator, y,
                                        nsteps, T, record_history)
        if self.device.type != "cuda":
            x = _draw(torch.empty(x_shape, device=self.device), generator)
            noise_seq = None
            if isinstance(generator, (list, tuple)):
                noise_seq = torch.stack([
                    _draw(torch.empty(x_shape, device=self.device),
                          generator) for _ in range(T)])

            def noise_predictor(xx, tt):
                return self.noise_predictor(xx, tt, y)

            return self.config.integrator.propagate_backward(
                x, noise_predictor, nsteps, record_history=record_history,
                noise_seq=noise_seq, generator=generator)
        graph = self.compile_sampler(nsamples, shape, y, nsteps)
        x, t, noise, ys = graph.inputs
        _draw(x, generator)
        graphs.fill(ys, y)
        ts = torch.arange(T, 0, -1, dtype=torch.float32, device=self.device)
        history = [x.clone()] if record_history else None
        for i in range(T):
            t.copy_(ts[i])
            _draw(noise, generator)
            graph.replay()
            if record_history:
                history.append(x.clone())
        return torch.stack(history) if record_history else x.clone()

    def _sample_on_mesh(self, mesh, nsamples, shape, generator, y, nsteps,
                        T, record_history):
        """``sample(mesh=...)``'s body."""
        from diffsci_tpu_torch.parallel.mesh import (data_rows, gather_batch,
                                                     rows_of)
        rows = data_rows(mesh, nsamples)
        x_shape = (nsamples,) + tuple(shape)
        x = _draw(torch.empty(x_shape, device=self.device), generator)[rows]
        y = rows_of(y, rows, nsamples)
        if self.device.type != "cuda":
            noise_seq = torch.stack([
                _draw(torch.empty(x_shape, device=self.device),
                      generator)[rows] for _ in range(T)])

            def noise_predictor(xx, tt):
                return self.noise_predictor(xx, tt, y)

            out = self.config.integrator.propagate_backward(
                x, noise_predictor, nsteps, record_history=record_history,
                noise_seq=noise_seq)
        else:
            graph = self.compile_sampler(x.shape[0], shape, y, nsteps)
            xs, t, noise, ys = graph.inputs
            xs.copy_(x)
            graphs.fill(ys, y)
            every = torch.empty(x_shape, device=self.device)
            ts = torch.arange(T, 0, -1, dtype=torch.float32,
                              device=self.device)
            history = [xs.clone()] if record_history else None
            for i in range(T):
                t.copy_(ts[i])
                noise.copy_(_draw(every, generator)[rows])
                graph.replay()
                if record_history:
                    history.append(xs.clone())
            out = torch.stack(history) if record_history else xs.clone()
        return gather_batch(out, mesh, dim=1 if record_history else 0)

    @torch.inference_mode()
    def compile_sampler(self, nsamples: int, shape, y=None,
                        nsteps: int | None = None):
        """The CUDA graph of one backward step for (nsamples, shape, T, y's
        shapes), which updates its input x in place from its inputs t and
        noise: on its first use the step runs once eagerly on the capture
        stream (the warm-up, which also puts the ᾱ table on the device)
        and is captured. Returns the ``utils.graphs.Graph``; None on the
        CPU, where nothing is captured."""
        if self.device.type != "cuda":
            return None
        cache = self._graph_cache()
        T = self.config.scheduler.T if nsteps is None else nsteps
        key = (nsamples, tuple(shape), T, graphs.condition_key(y))
        graph = cache.graphs.get(key)
        if graph is not None:
            return graph
        x = torch.zeros((nsamples,) + tuple(shape), device=self.device)
        t = torch.full((), float(T), device=self.device)
        noise = torch.zeros_like(x)
        ys = graphs.static_like(y, self.device)
        graphs.fill(ys, y)

        def noise_predictor(xx, tt):
            return self.noise_predictor(xx, tt, ys)

        def step():
            x.copy_(self.config.integrator.step_backward(
                x, t, noise_predictor, T, noise))

        cache.warmup(step)
        graph = cache.capture(key, step)
        graph.inputs = (x, t, noise, ys)
        return graph
