"""Stochastic interpolants and flow matching: paths x_t = α(t)·x₀ +
σ(t)·ε, the flow-field loss, flow↔score conversion, ODE and SDE
integration, and inpainting with soft masks and RePaint-style
resampling.

Port of ``diffsci_tpu/models/si.py``: ``SIScheduler`` (linear, cosine,
``finterpolation``, ``edm``), ``SIModelConfig`` and ``SIModel``: ``init``,
the initial norms (a constant, the identity, or the running-stat
``DimensionAgnosticBatchNorm`` with its statistics as buffers beside the
network, ``initial_norm.mean``/``.var``), ``encode``/``decode`` through the
autoencoder protocol of ``KarrasModel``, ``get_flow_field`` (the identity,
"edm" or a callable preconditioner, guidance, ``integrate_on_sigma``),
the flow→score conversion, ``sample_timestep``, ``loss_fn``,
``integration_step`` (Euler, Heun, Euler–Maruyama),
``integrate_flow_field`` (Heun over the first N−2 intervals of
linspace(1, 0, N), then one Euler step: 2N−3 network calls; or
Euler–Maruyama throughout under ``noise_injection``), ``sample``,
``create_soft_mask`` and ``inpaint``.

Samples are channels-last, as in the JAX package; ``RuntimeNet`` moves
the channel axis of x at the network boundary. With ``compute_dtype`` the
network runs on a cast copy of its weights with x, t and y cast, output
back to float32 (``ComputeDtypeMixin``); the path, the norm and the loss
stay float32. Randomness is an explicit ``torch.Generator``: ``sample``
draws x_T, then the Euler–Maruyama loop's [N−1, B, *shape] noise, before
the loop runs (``noise_seq`` replays the loop's draws in
``integrate_flow_field``; ``eps=`` the loss's).

The train step: ``config.noisesampler`` draws t by ``sample_timestep``'s
rule into the slot where σ travels, and ``loss_fn`` takes the train
step's arguments (``cond_keep``, ``return_updates`` with the running
norm's statistics, ``z_eps``), so ``create_train_state`` and
``make_train_step`` train an ``SIModel`` as they train a
``KarrasModel``.

On a CUDA device ``sample`` replays one CUDA graph of the whole loop per
key (``compile_sampler``, as ``KarrasModel``'s): the grid of a key is
fixed by its nsteps, so each step's t is a constant of the graph; x_T,
the loop's noise and y are static inputs filled before each replay, and
the running norm's statistics are buffers it reads in place. So
``SamplerService`` serves an ``SIModel`` unchanged. ``inpaint`` runs
eagerly, as in the JAX package. ``sample(mesh=...)`` samples
data-parallel, one process a rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Literal

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.models.nets.layers import ConditionDrop
from diffsci_tpu_torch.models.runtime import (RuntimeMixin, RuntimeNet,
                                              fill_draw)
from diffsci_tpu_torch.ops import losses
from diffsci_tpu_torch.ops.batchnorm import (ConstantBatchNorm,
                                             DimensionAgnosticBatchNorm,
                                             IdentityBatchNorm)
from diffsci_tpu_torch.ops.schedulers import draw_rows
from diffsci_tpu_torch.utils import (bcast_right, dict_expand_dims, dict_map,
                                     graphs, resolve_device)


@dataclasses.dataclass(frozen=True)
class SIScheduler:
    """Interpolation path x_t = α(t)·x₀ + σ(t)·ε, its derivatives and
    σ⁻¹, as functions of tensors."""
    alpha_fn: Callable
    sigma_fn: Callable
    alpha_fn_dot: Callable
    sigma_fn_dot: Callable
    sigma_fn_inv: Callable

    @classmethod
    def linear(cls):
        return cls(alpha_fn=lambda t: 1.0 - t,
                   sigma_fn=lambda t: 1.0 * t,
                   alpha_fn_dot=lambda t: -1.0 + 0.0 * t,
                   sigma_fn_dot=lambda t: 1.0 + 0.0 * t,
                   sigma_fn_inv=lambda s: 1.0 * s)

    @classmethod
    def cosine(cls):
        h = math.pi / 2
        return cls(alpha_fn=lambda t: torch.cos(t * h),
                   sigma_fn=lambda t: torch.sin(t * h),
                   alpha_fn_dot=lambda t: -h * torch.sin(t * h),
                   sigma_fn_dot=lambda t: h * torch.cos(t * h),
                   sigma_fn_inv=lambda s: torch.arcsin(s) / h)

    @classmethod
    def finterpolation(cls, f, finv, fdot, sigma_min: float,
                       sigma_max: float):
        """Constant-α path interpolating f⁻¹(σ) linearly."""
        lo, hi = finv(sigma_min), finv(sigma_max)

        def sigma_fn(t):
            return f((1 - t) * lo + t * hi)

        def sigma_fn_inv(s):
            return (finv(s) - lo) / (hi - lo)

        def sigma_fn_dot(t):
            return fdot((1 - t) * lo + t * hi) * (hi - lo)

        return cls(alpha_fn=lambda t: 1.0 + 0.0 * t,
                   sigma_fn=sigma_fn,
                   alpha_fn_dot=lambda t: 0.0 * t,
                   sigma_fn_dot=sigma_fn_dot,
                   sigma_fn_inv=sigma_fn_inv)

    @classmethod
    def edm(cls, exponent: float = 7.0, sigma_min: float = 0.02,
            sigma_max: float = 80.0):
        return cls.finterpolation(
            f=lambda x: x ** exponent,
            finv=lambda x: x ** (1 / exponent),
            fdot=lambda x: exponent * x ** (exponent - 1),
            sigma_min=sigma_min, sigma_max=sigma_max)

    @classmethod
    def get_interpolator(cls, name: str, **kwargs):
        factories = {"linear": cls.linear, "cosine": cls.cosine,
                     "edm": cls.edm, "finterpolation": cls.finterpolation}
        if name not in factories:
            raise ValueError(f"Invalid interpolator: {name}")
        return factories[name](**kwargs)


class SITimeSampler:
    """The train step's draw of t (``SIModel.sample_timestep``'s rule):
    uniform on [0, 1), σ⁻¹(exp(pstd·N + pmean)) under "edm", or a dict
    weighting's ``weighting_sampler(generator, n)``."""

    def __init__(self, config: "SIModelConfig"):
        self.config = config

    def sample(self, shape, generator=None, device=None, out=None):
        cfg = self.config
        lw = cfg.loss_weighting

        def draw(t):
            if isinstance(lw, dict):
                t.copy_(lw["weighting_sampler"](generator, t.shape[0]))
            elif lw == "uniform":
                torch.rand(t.shape, generator=generator, out=t)
            elif lw == "edm":
                torch.randn(t.shape, generator=generator, out=t)
                t.mul_(cfg.pstd).add_(cfg.pmean).exp_()
                t.copy_(cfg.scheduler.sigma_fn_inv(t))
            else:
                raise ValueError(f"Invalid weighting class: {lw}")

        return fill_draw(shape, generator, device, out, draw)


class SIModelConfig:
    """The path, the initial norm (False: identity, a number: divide by
    it, True: running statistics scaled to ``sigma_data``), autonomous
    flow (the network takes no t), the preconditioner (None or
    "identity", "edm", or a callable ``pre(net, x, t, y=y)``), the loss
    weighting ("uniform", "edm" or a dict of ``weighting_sampler`` and
    ``weighting_function``), the metric ("mse" or "huber"), and the
    autoencoder's flags. ``noisesampler``: the train step's t draw."""

    def __init__(self,
                 scheduler: SIScheduler | str = "linear",
                 scheduler_args: dict | None = None,
                 initial_norm: bool | float = False,
                 autonomous_flow: bool = False,
                 precondition_fn: Callable | str | None = None,
                 loss_weighting: str | dict = "uniform",
                 loss_metric: Literal["mse", "huber"] = "huber",
                 sigma_data: float = 0.5,
                 pmean: float = -1.2,
                 pstd: float = 1.2,
                 autoencoder_is_conditional: bool = False,
                 encode_condition: bool = False):
        if isinstance(scheduler, str):
            scheduler = SIScheduler.get_interpolator(
                scheduler, **(scheduler_args or {}))
        self.scheduler = scheduler
        self.initial_norm = initial_norm
        self.autonomous_flow = autonomous_flow
        self.precondition_fn = precondition_fn
        self.loss_weighting = loss_weighting
        self.loss_metric = loss_metric
        self.sigma_data = sigma_data
        self.pmean = pmean
        self.pstd = pstd
        self.autoencoder_is_conditional = autoencoder_is_conditional
        self.encode_condition = encode_condition
        self.noisesampler = SITimeSampler(self)


def _batched(y, nsamples: int) -> bool:
    probe = y["y"] if isinstance(y, dict) and "y" in y else (
        next(iter(y.values())) if isinstance(y, dict) else y)
    return hasattr(probe, "shape") and probe.ndim > 0 and \
        probe.shape[0] == nsamples


class SIModel(RuntimeMixin):
    """The flow-matching runtime around a flow network ``net(x, t, y)``
    (or ``net(x, y)`` for an autonomous flow) on [B, C, *spatial]. The
    network's weights live in ``self.net`` (``RuntimeNet``: state-dict
    names ``model.*``, and ``initial_norm.mean``/``.var`` with the running
    norm)."""

    def __init__(self, model: nn.Module, config: SIModelConfig,
                 autoencoder=None,
                 compute_dtype: torch.dtype | None = None,
                 device: torch.device | str | None = None):
        """``compute_dtype`` (e.g. ``torch.bfloat16``): the network runs
        with its parameters and inputs cast to it; the path, the norm and
        the loss stay float32. ``autoencoder``: a latent model's (the
        ``KarrasModel`` protocol, [B, C, *spatial])."""
        self.device = resolve_device(device)
        self.config = config
        self.autoencoder = autoencoder
        self.compute_dtype = compute_dtype
        init_norm = config.initial_norm
        bnorm = None
        if isinstance(init_norm, (float, int)) and not isinstance(
                init_norm, bool):
            self.initial_norm = ConstantBatchNorm(float(init_norm))
        elif init_norm:
            bnorm = DimensionAgnosticBatchNorm(sigma=config.sigma_data)
            self.initial_norm = None
        else:
            self.initial_norm = IdentityBatchNorm()
        self.has_running_norm = bnorm is not None
        if config.loss_metric == "mse":
            self._loss = losses.mse
        elif config.loss_metric == "huber":
            self._loss = losses.huber
        else:
            raise ValueError(f"Invalid loss metric: {config.loss_metric}")
        self.net = RuntimeNet(model, bnorm).to(self.device).eval()
        drops = [m.rate for m in self.net.model.modules()
                 if isinstance(m, ConditionDrop) and m.rate > 0]
        self.cond_drop_rate = drops[0] if drops else None
        self._reset_runtime()

    # ------------------------------------------------------------------
    # the initial norm
    # ------------------------------------------------------------------
    def _norm_fwd(self, x, train: bool):
        """normalize(x) -> (x, updates): with the running norm in training,
        by x's own statistics, ``updates`` holding the running statistics
        after this batch by buffer name (the train step writes them)."""
        if not self.has_running_norm:
            return self.initial_norm.normalize(x), {}
        bnorm = self.net.initial_norm
        if train:
            mean, var = bnorm.batch_statistics(x)
            updates = {f"initial_norm.{k}": v for k, v in
                       bnorm.momentum_update(mean, var).items()}
            return bnorm(x, use_running_stats=False), updates
        return bnorm(x), {}

    def _norm_inv(self, x):
        if not self.has_running_norm:
            return self.initial_norm.unnormalize(x)
        return self.net.initial_norm.unnormalize(x)

    def encode(self, x, y=None, z_eps=None):
        """Data -> the flow's space: the autoencoder's encode of a latent
        model (``z_eps``: its posterior draw), else x. Returns (x, y)."""
        if self.autoencoder is None:
            return x, y
        cfg = self.config
        if cfg.encode_condition and not cfg.autoencoder_is_conditional:
            raise ValueError(
                "Cannot encode condition if autoencoder is not conditional")
        x, y_enc = self._ae_encode(x, y, z_eps,
                                   cfg.autoencoder_is_conditional)
        return x, (y_enc if cfg.encode_condition else y)

    def decode(self, x, y=None):
        if self.autoencoder is None:
            return x, y
        return self._ae_decode(x, y, self.config.autoencoder_is_conditional
                               ), y

    def draw_cond_keep(self, batch: int, generator=None, out=None):
        """The condition-drop mask [B] (bool, keep with probability
        1 − rate), into ``out`` when given; None when the network drops no
        condition."""
        if self.cond_drop_rate is None:
            return None
        keep = torch.rand(batch, generator=generator,
                          device=self.device) < 1.0 - self.cond_drop_rate
        return keep if out is None else out.copy_(keep)

    # ------------------------------------------------------------------
    # the preconditioned flow
    # ------------------------------------------------------------------
    def _apply_net(self, x, t, y, train=False, variables=None,
                   cond_keep=None):
        """The network on x (and t), with ``compute_dtype``: parameters and
        floating inputs cast to it, output back to float32."""
        net = self._network(train, variables)
        cd = self.compute_dtype
        if cd is not None:
            x = x.to(cd)
            t = None if t is None else t.to(cd)
            y = dict_map(lambda v: v.to(cd) if v.is_floating_point() else v,
                         y)
        if self.config.autonomous_flow:
            args = (x,) if y is None else (x, y)
        else:
            args = (x, t, y) if cond_keep is None else (x, t, y, cond_keep)
        out = net(*args)
        return out if cd is None else out.float()

    def _raw_flow(self, x, t, y, train=False, variables=None,
                  cond_keep=None):
        pre = self.config.precondition_fn
        sch = self.config.scheduler
        if pre is None or pre == "identity":
            return self._apply_net(x, t, y, train, variables, cond_keep)
        if pre == "edm":
            sigma_data = self.config.sigma_data
            sigma = bcast_right(sch.sigma_fn(t), x)
            sigma_dot = bcast_right(sch.sigma_fn_dot(t), x)
            cin = 1.0 / torch.sqrt(sigma_data ** 2 + sigma ** 2)
            cout = sigma * sigma_data / torch.sqrt(sigma_data ** 2
                                                   + sigma ** 2)
            cskip = sigma_data ** 2 / (sigma_data ** 2 + sigma ** 2)
            cnoise = 0.5 * torch.log(sch.sigma_fn(t))
            denoiser = cskip * x + cout * self._apply_net(
                cin * x, cnoise, y, train, variables, cond_keep)
            return sigma_dot / sigma * (x - denoiser)
        if callable(pre):
            # the float32 network in eval mode, as the JAX package applies
            # it here
            self.net.train(False)
            net = self.net if variables is None else (
                lambda *a: torch.func.functional_call(self.net, variables, a))
            return pre(net, x, t, y=y)
        raise ValueError(f"Invalid precondition function: {pre}")

    def get_flow_field(self, x, t, y=None, guidance: float = 1.0,
                       integrate_on_sigma: bool = False, train=False,
                       variables=None, cond_keep=None):
        """v(x, t) (x channels-last, t [B]); with guidance g ≠ 1 and a
        condition, g·v(y) + (1 − g)·v(None) (two network calls); divided
        by σ'(t) when ``integrate_on_sigma``."""
        v = self._raw_flow(x, t, y, train, variables, cond_keep)
        if guidance != 1.0 and y is not None:
            v_uncond = self._raw_flow(x, t, None, train, variables)
            v = guidance * v + (1 - guidance) * v_uncond
        if integrate_on_sigma:
            v = v / bcast_right(self.config.scheduler.sigma_fn_dot(t), v)
        return v

    def get_score_field_from_flow_field(self, flow, x, t):
        """score = (α·v − α'·x) / (σ·(α'·σ − α·σ'))."""
        sch = self.config.scheduler
        a = bcast_right(sch.alpha_fn(t), flow)
        s = bcast_right(sch.sigma_fn(t), flow)
        ad = bcast_right(sch.alpha_fn_dot(t), flow)
        sd = bcast_right(sch.sigma_fn_dot(t), flow)
        return (a * flow - ad * x) / (s * (ad * s - a * sd))

    def get_score_field(self, x, t, y=None, guidance: float = 1.0,
                        integrate_on_sigma: bool = False, variables=None):
        v = self.get_flow_field(x, t, y, guidance, integrate_on_sigma,
                                variables=variables)
        return self.get_score_field_from_flow_field(v, x, t)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def sample_timestep(self, nsamples: int, generator=None):
        """t [nsamples] by the loss weighting's rule
        (``config.noisesampler``), on the model's device."""
        return self.config.noisesampler.sample((nsamples,), generator,
                                               device=self.device)

    def _weighting_function(self, t):
        lw = self.config.loss_weighting
        if isinstance(lw, dict):
            return lw["weighting_function"](t)
        return 1.0 + 0.0 * t  # uniform and edm both weigh uniformly

    def loss_fn(self, x, t, y=None, mask=None, train: bool = True,
                eps=None, generator=None, variables=None, cond_keep=None,
                return_updates: bool = False, z_eps=None):
        """The flow-matching loss: mean over elements of
        metric(v(x_t, t), α'(t)·x + σ'(t)·ε)·w(t) with x_t = α(t)·x +
        σ(t)·ε, x encoded and normalized first (the running norm by the
        batch's statistics when ``train``); masked elements (mask == 1)
        weigh 0. x is channels-last, t [B]. ``eps`` replays the noise draw,
        ``cond_keep`` the condition drop's mask (else drawn from
        ``generator`` after ε, in training, when the network drops
        conditions), ``z_eps`` a latent model's posterior draw (else drawn
        before ε when its autoencoder samples one). Returns the scalar
        loss, and with ``return_updates`` (loss, the running norm's
        statistics after this batch by buffer name)."""
        if z_eps is None:
            z_eps = self._draw_posterior(x, generator)
        x, y = self.encode(x, y, z_eps)
        x, updates = self._norm_fwd(x, train)
        noise = (torch.randn(x.shape, generator=generator, device=x.device,
                             dtype=x.dtype)
                 if eps is None else torch.as_tensor(eps, dtype=x.dtype,
                                                     device=x.device))
        if cond_keep is None and train and y is not None:
            cond_keep = self.draw_cond_keep(x.shape[0], generator)
        t_b = bcast_right(t, x)
        sch = self.config.scheduler
        x_noised = sch.alpha_fn(t_b) * x + sch.sigma_fn(t_b) * noise
        v = self.get_flow_field(x_noised, t, y, train=train,
                                variables=variables, cond_keep=cond_keep)
        target = sch.alpha_fn_dot(t_b) * x + sch.sigma_fn_dot(t_b) * noise
        loss = self._loss(v, target) * self._weighting_function(t_b)
        if mask is not None:
            loss = loss * (1 - mask.expand_as(loss))
        loss = loss.mean()
        return (loss, updates) if return_updates else loss

    # ------------------------------------------------------------------
    # integration
    # ------------------------------------------------------------------
    def integration_step(self, x, t_curr, t_next, y=None,
                         guidance: float = 1.0, method: str = "euler",
                         integrate_on_sigma: bool = False, noise=None,
                         generator=None, variables=None):
        """One step from t_curr to t_next ([B] each) by "euler", "heun" or
        "euler_maruyama" (``noise``: its draw, else drawn from
        ``generator``)."""
        sch = self.config.scheduler
        if not integrate_on_sigma:
            dt = t_next - t_curr
        else:
            dt = sch.sigma_fn(t_next) - sch.sigma_fn(t_curr)
        dt = bcast_right(dt, x)

        def flow(xx, tt):
            return self.get_flow_field(xx, tt, y, guidance,
                                       integrate_on_sigma,
                                       variables=variables)

        if method == "euler":
            return x + dt * flow(x, t_curr)
        if method == "heun":
            v1 = flow(x, t_curr)
            x_euler = x + dt * v1
            v2 = flow(x_euler, t_next)
            return x + dt * (v1 + v2) / 2
        if method == "euler_maruyama":
            v = flow(x, t_curr)
            score = self.get_score_field_from_flow_field(v, x, t_curr)
            omega = bcast_right(sch.sigma_fn(t_curr), x)
            x = x + dt * (v - 0.5 * omega * score)
            if noise is None:
                noise = torch.randn(x.shape, generator=generator,
                                    device=x.device, dtype=x.dtype)
            return x + torch.sqrt(omega * torch.abs(dt)) * noise
        raise ValueError(f"Invalid integration method: {method}")

    def integrate_flow_field(self, x, nsteps: int, y=None,
                             guidance: float = 1.0,
                             return_history: bool = False,
                             integrate_on_sigma: bool = False,
                             noise_injection: bool = False,
                             noise_seq=None, generator=None,
                             variables=None):
        """Heun over linspace(1, 0, nsteps) with a final Euler step, or
        Euler–Maruyama throughout when ``noise_injection`` (``noise_seq``
        [nsteps − 1, *x.shape] replays its draws, else drawn from
        ``generator`` step by step). The grid is float32 of the float64
        linspace, as in the JAX package. Returns the result through the
        inverse initial norm, or [nsteps, *x.shape] with
        ``return_history``."""
        ts = np.linspace(1.0, 0.0, nsteps).astype(np.float32)
        B = x.shape[0]
        if noise_seq is not None:
            noise_seq = torch.as_tensor(noise_seq, dtype=x.dtype,
                                        device=x.device)
        history = [x] if return_history else None
        for i in range(nsteps - 1):
            tc = x.new_full((B,), float(ts[i]))
            tn = x.new_full((B,), float(ts[i + 1]))
            if noise_injection:
                method = "euler_maruyama"
            else:
                method = "heun" if i < nsteps - 2 else "euler"
            x = self.integration_step(
                x, tc, tn, y, guidance, method, integrate_on_sigma,
                noise=None if noise_seq is None else noise_seq[i],
                generator=generator, variables=variables)
            if return_history:
                history.append(x)
        if return_history:
            return self._norm_inv(torch.stack(history))
        return self._norm_inv(x)

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def _sigma_init(self) -> float:
        """σ(1) as float32 (x_T's scale)."""
        return float(self.config.scheduler.sigma_fn(torch.tensor(1.0)))

    def _sample_shape(self, shape, is_latent_shape: bool) -> tuple:
        if is_latent_shape:
            return tuple(shape)
        return self.latent_shape((1,) + tuple(shape))[1:]

    def _sampler_inputs(self, nsamples, shape, nsteps, noise_injection):
        """(x_T, the loop's noise [nsteps − 1, nsamples, *shape] or None)
        on the model's device."""
        x = torch.zeros((nsamples,) + tuple(shape), device=self.device)
        noise = torch.zeros((nsteps - 1,) + tuple(x.shape),
                            device=self.device) if noise_injection else None
        return x, noise

    @staticmethod
    def _draw_inputs(inputs, generator, orig_noise=None):
        """Fill x_T (or copy ``orig_noise``), then the loop's noise, from
        ``generator``, or row i from the i-th of a list of generators
        (``draw_rows``), as the service's dispatcher passes them."""
        x, noise = inputs
        if isinstance(generator, (list, tuple)):
            draw_rows(generator, x, noise)
        else:
            if orig_noise is None:
                torch.randn(x.shape, generator=generator, out=x)
            if noise is not None:
                torch.randn(noise.shape, generator=generator, out=noise)
        if orig_noise is not None:
            x.copy_(orig_noise)
        return inputs

    def _sample_loop(self, x, noise, y, guidance, nsteps,
                     integrate_on_sigma, noise_injection, decode: bool):
        yb = dict_expand_dims(y, 0) if (
            y is not None and not _batched(y, x.shape[0])) else y
        out = self.integrate_flow_field(
            x * self._sigma_init(), nsteps, yb, guidance,
            integrate_on_sigma=integrate_on_sigma,
            noise_injection=noise_injection, noise_seq=noise)
        if decode:
            out, _ = self.decode(out, y)
        return out

    @torch.inference_mode()
    def sample(self, nsamples: int, shape, generator=None, y=None,
               guidance: float = 1.0, nsteps: int = 30,
               is_latent_shape: bool = False,
               integrate_on_sigma: bool = False,
               noise_injection: bool = False,
               return_latents: bool = False, orig_noise=None, mesh=None):
        """Samples from white noise scaled by σ(1). ``shape`` is
        channels-last without the batch dim; a latent model samples in
        its latent shape (the shape itself when ``is_latent_shape``) and
        decodes unless ``return_latents``. ``orig_noise`` replaces the x_T
        draw. ``generator`` may be a list of generators, one a row, as the
        service's dispatcher passes them: row i's x_T and loop noise then
        come from the i-th alone. On a CUDA device the loop, decode
        included, is the graph of ``compile_sampler``; on the CPU it runs
        eagerly on the same draws.

        ``mesh`` (a ``DeviceMesh`` with a ``data`` axis; every rank calls):
        data-parallel sampling, as ``KarrasModel.sample(mesh=...)``: each
        rank draws the whole batch's x_T (or takes ``orig_noise``'s) and
        loop noise, runs its rows, and the rows are all-gathered in rank
        order; ``nsamples`` must divide the axis."""
        if mesh is not None:
            return self._sample_on_mesh(
                mesh, nsamples, shape, generator, y, guidance, nsteps,
                is_latent_shape, integrate_on_sigma, noise_injection,
                return_latents, orig_noise)
        if self.device.type != "cuda":
            inputs = self._draw_inputs(self._sampler_inputs(
                nsamples, self._sample_shape(shape, is_latent_shape),
                nsteps, noise_injection), generator, orig_noise)
            return self._sample_loop(*inputs, y, guidance, nsteps,
                                     integrate_on_sigma, noise_injection,
                                     not return_latents)
        graph = self.compile_sampler(nsamples, shape, y, guidance, nsteps,
                                     is_latent_shape, integrate_on_sigma,
                                     noise_injection, return_latents)
        self._draw_inputs(graph.inputs[:2], generator, orig_noise)
        graphs.fill(graph.inputs[2], y)
        graph.replay()
        return graph.outputs.clone()

    def _sample_on_mesh(self, mesh, nsamples, shape, generator, y, guidance,
                        nsteps, is_latent_shape, integrate_on_sigma,
                        noise_injection, return_latents, orig_noise):
        """``sample(mesh=...)``'s body."""
        from diffsci_tpu_torch.parallel.mesh import (data_rows, gather_batch,
                                                     rows_of)
        rows = data_rows(mesh, nsamples)
        x, noise = self._draw_inputs(self._sampler_inputs(
            nsamples, self._sample_shape(shape, is_latent_shape), nsteps,
            noise_injection), generator, orig_noise)
        x = x[rows]
        noise = None if noise is None else noise[:, rows]
        y = rows_of(y, rows, nsamples)
        if self.device.type != "cuda":
            out = self._sample_loop(x, noise, y, guidance, nsteps,
                                    integrate_on_sigma, noise_injection,
                                    not return_latents)
        else:
            graph = self.compile_sampler(
                x.shape[0], shape, y, guidance, nsteps, is_latent_shape,
                integrate_on_sigma, noise_injection, return_latents)
            graph.inputs[0].copy_(x)
            if noise is not None:
                graph.inputs[1].copy_(noise)
            graphs.fill(graph.inputs[2], y)
            graph.replay()
            out = graph.outputs.clone()
        return gather_batch(out, mesh)

    @torch.inference_mode()
    def compile_sampler(self, nsamples: int, shape, y=None,
                        guidance: float = 1.0, nsteps: int = 30,
                        is_latent_shape: bool = False,
                        integrate_on_sigma: bool = False,
                        noise_injection: bool = False,
                        return_latents: bool = False):
        """The CUDA graph of ``sample``'s loop for (nsamples, shape,
        guidance, nsteps, y's shapes, the flags): static inputs
        (``graph.inputs``) x_T, the loop's noise (or None) and y. On its
        first use the loop runs once eagerly on the capture stream (the
        warm-up) and is captured; ``SamplerService.warmup`` calls this for
        every bucket. Returns the ``utils.graphs.Graph``; None on the
        CPU."""
        if self.device.type != "cuda":
            return None
        cache = self._graph_cache()
        key = (nsamples, tuple(shape), float(guidance), nsteps,
               graphs.condition_key(y), is_latent_shape, integrate_on_sigma,
               noise_injection, return_latents)
        graph = cache.graphs.get(key)
        if graph is not None:
            return graph
        x, noise = self._sampler_inputs(
            nsamples, self._sample_shape(shape, is_latent_shape), nsteps,
            noise_injection)
        ys = graphs.static_like(y, self.device)
        graphs.fill(ys, y)

        def loop():
            return self._sample_loop(x, noise, ys, guidance, nsteps,
                                     integrate_on_sigma, noise_injection,
                                     not return_latents)

        cache.warmup(loop)
        graph = cache.capture(key, loop)
        graph.inputs = (x, noise, ys)
        return graph

    # ------------------------------------------------------------------
    # inpainting with soft masks
    # ------------------------------------------------------------------
    def create_soft_mask(self, mask, falloff: int):
        """Cosine-smoothed boundary of a mask [*spatial, C] (channels-last,
        1 = known): the mean of the mask and of its complement over a
        (2·falloff + 1)^d window, padding counted (flax's ``avg_pool`` with
        "SAME"), as soft = m/(m + m̄), then (1 − cos(π·soft))/2."""
        if falloff <= 0:
            return mask
        m = mask[None].float().movedim(-1, 1)
        pool = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[m.ndim - 3]
        k = 2 * falloff + 1
        m_dil = pool(m, k, stride=1, padding=falloff, count_include_pad=True)
        m_ero = pool(1 - m, k, stride=1, padding=falloff,
                     count_include_pad=True)
        soft = m_dil / (m_dil + m_ero + 1e-8)
        return ((1 - torch.cos(soft * math.pi)) / 2)[0].movedim(0, -1)

    @torch.inference_mode()
    def inpaint(self, x_orig, mask, nsamples: int = 1, generator=None,
                y=None, guidance: float = 1.0, nsteps: int = 30,
                integrate_on_sigma: bool = False, mask_falloff: int = 0,
                resample_steps: int = 0, mask_start_t: float = 1.0,
                orig_noise=None):
        """RePaint-style inpainting with soft masks: Euler–Maruyama steps,
        each followed (below ``mask_start_t``) by the known region of
        ``x_orig`` ([*spatial, C], noised to the step's t) blended in by
        the soft mask (``mask``: 1 = known), with ``resample_steps``
        re-noisings per step. The draws from ``generator``: x_T, then per
        step and resampling round the step's noise, the patch's, and in a
        resampling round the re-noising's and its patch's. Runs eagerly on
        the model's device."""
        sch = self.config.scheduler
        x_orig = torch.as_tensor(x_orig, dtype=torch.float32,
                                 device=self.device)
        mask = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
        soft = self.create_soft_mask(mask, mask_falloff)
        x_orig, _ = self._norm_fwd(x_orig[None], train=False)

        def randn(shape):
            return torch.randn(shape, generator=generator,
                               device=self.device)

        x = randn((nsamples,) + tuple(x_orig.shape[1:])) \
            if orig_noise is None else torch.as_tensor(
                orig_noise, dtype=torch.float32, device=self.device)
        ts = np.linspace(1.0, 0.0, nsteps)
        x = x * self._sigma_init()
        B = x.shape[0]

        def at(t):
            t = torch.tensor(float(np.float32(t)), device=self.device)
            return sch.alpha_fn(t), sch.sigma_fn(t)

        for i in range(nsteps - 1):
            tc = x.new_full((B,), float(np.float32(ts[i])))
            tn = x.new_full((B,), float(np.float32(ts[i + 1])))
            for r in range(resample_steps + 1):
                x = self.integration_step(x, tc, tn, y, guidance,
                                          "euler_maruyama",
                                          integrate_on_sigma,
                                          noise=randn(x.shape))
                if ts[i + 1] <= mask_start_t:
                    alpha, sigma = at(ts[i + 1])
                    patch = alpha * x_orig + sigma * randn(x_orig.shape)
                    x = (1 - soft) * x + soft * patch
                    if r < resample_steps and i + 1 < nsteps - 1:
                        a_j, s_j = at(ts[i])
                        x = a_j * x + s_j * randn(x.shape)
                        patch_j = a_j * x_orig + s_j * randn(x_orig.shape)
                        x = (1 - soft) * x + soft * patch_j
        return self._norm_inv(x)
