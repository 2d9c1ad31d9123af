"""KarrasModel: the Karras denoiser runtime for training and sampling.

Port of ``diffsci_tpu/models/karras/module.py`` without latent models:
``KarrasModelConfig`` (``from_edm``, ``from_vp``, ``from_ve``,
``conditional_sr3``, ``loss_metric``, ``has_edm_batch_norm``,
``dynamic_loss_weight``, ``spatial_shape``/``focus_radius``, the tag and
``extra_args`` of ``export_description``), ``IntervalGuidance``,
``DynamicLossWeight``, ``KarrasNet`` (the network, the dynamic loss
weight and the EDM batch norm), and ``KarrasModel``'s ``init``,
``encode``/``decode``, ``get_denoiser`` (with ``compute_dtype``, CFG, the
guidance interval and the ``fused_precondition`` policy), ``loss_fn``,
``get_score``, ``sample`` (any integrator, stochastic,
``langevin_scale``), ``sample_restart``, ``propagate_white_noise``,
``propagate_toward_sample``, ``propagate_partial_toward_sample``,
``propagate_toward_noise``, ``inpaint``, ``repaint``, ``sample_parallel``
(sliding-window Picard), ``interpolate_images`` and ``sample_and_filter``;
and ``select_batch``, ``export_description`` and
``karras_model_from_description`` (the JAX package's description,
key for key).

The network's weights live in the module, so the methods take no
``variables`` unless the caller swaps other weights in (``variables=``, a
state dict, e.g. EMA shadows). Randomness is an explicit
``torch.Generator``: a sampler draws x_T, then every later draw of its
loop in one tensor (``ops.schedulers.draw_noise``), before the loop runs;
the loss draws ε, then the condition-drop mask. Sample shapes and samples
are channels-last ([B, *spatial, C]) as in the JAX package; ``KarrasNet``
moves the channel axis of x at the network boundary (a reshape for
C = 1), and conditions reach the network as given.

On a CUDA device ``sample`` and ``sample_restart`` replay one CUDA graph
of the whole sampling loop per key, as the JAX package runs one jitted
program per key (``_jitted_sampler``,
``diffsci_tpu/models/karras/module.py:605-643``). The loop bakes its grid
into the graph as Python floats (σ, the score multiplier, dt, the churn's
γ), right for a graph keyed on nsteps and the integrator; the draws and
``langevin_scale`` are static inputs filled before each replay, so a γ
sweep replays one graph. An ``IntervalGuidance`` is part of the key like
a float guidance; its band test is made per row on the device from σ.
The EDM batch norm's running statistics are buffers that a graph reads
in place, so a sampler sees the statistics of the latest train step.
``sample_parallel`` replays one graph of a Picard sweep per key and
reads the frontier between replays (``ops/parallel_sampling.py``).
``inpaint``, ``repaint``, ``propagate_toward_noise``,
``propagate_partial_toward_sample``, ``interpolate_images`` and the
filter of ``sample_and_filter`` run eagerly on the card, as the JAX
package does not jit them whole.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from diffsci_tpu_torch.kernels import fused_precondition
from diffsci_tpu_torch.models.compute import ComputeDtypeMixin
from diffsci_tpu_torch.models.nets.layers import ConditionDrop, init_parameters
from diffsci_tpu_torch.ops import (losses, noise_samplers, preconditioners,
                                   schedulers)
from diffsci_tpu_torch.ops.batchnorm import DimensionAgnosticBatchNorm
from diffsci_tpu_torch.ops.parallel_sampling import PicardWindow
from diffsci_tpu_torch.ops.schedulers import draw_noise, draw_rows
from diffsci_tpu_torch.utils import (bcast_right, dict_expand_dims, dict_map,
                                     get_minibatch_sizes, graphs,
                                     linear_interpolation, resolve_device)


@dataclasses.dataclass(frozen=True)
class IntervalGuidance:
    """CFG restricted to a noise-level band (Kynkäänniemi et al.,
    arXiv:2404.07724): pass anywhere a ``guidance`` float goes and the
    scale applies for σ in [sigma_lo, sigma_hi], 1 elsewhere. Hashable, so
    a sampler's graph key holds it like a float."""
    scale: float
    sigma_lo: float
    sigma_hi: float


def _guidance_key(guidance):
    return guidance if isinstance(guidance, IntervalGuidance) \
        else float(guidance)


def _extra(kwargs: dict) -> dict:
    """The keyword arguments a preset records in ``extra_args``."""
    return {k: v for k, v in kwargs.items()
            if k in ("loss_metric", "spatial_shape", "focus_radius")}


class KarrasModelConfig:
    """The math configuration: preconditioner, training noise sampler,
    sampling scheduler, the training loss metric ("huber", "mse",
    "weighted_gaussian", "smoothed_indicator" or a one-key dict such as
    ``{"huber": {"delta": ...}}``; ``spatial_shape`` and ``focus_radius``
    for "weighted_gaussian"), the EDM batch norm and the dynamic loss
    weight's width, with the preset's ``tag`` and ``extra_args``."""

    def __init__(self, preconditioner: preconditioners.KarrasPreconditioner,
                 noisesampler: noise_samplers.NoiseSampler,
                 noisescheduler: schedulers.Scheduler,
                 loss_metric="huber", tag: str = "custom",
                 has_edm_batch_norm: bool = False,
                 dynamic_loss_weight: int | None = None,
                 extra_args: dict | None = None,
                 spatial_shape: tuple | None = None,
                 focus_radius: float | None = None):
        self.preconditioner = preconditioner
        self.noisesampler = noisesampler
        self.noisescheduler = noisescheduler
        self.loss_metric = loss_metric
        self.tag = tag
        self.has_edm_batch_norm = has_edm_batch_norm
        self.dynamic_loss_weight = dynamic_loss_weight
        self.spatial_shape = spatial_shape
        self.focus_radius = focus_radius
        self.extra_args = extra_args if extra_args is not None else {}

    @property
    def has_dynamic_loss_weight(self) -> bool:
        return self.dynamic_loss_weight is not None

    def update_loss_metric(self, loss_config) -> None:
        """Set the loss metric (a model built after this call uses it)."""
        self.loss_metric = loss_config
        if "loss_metric" in self.extra_args:
            self.extra_args["loss_metric"] = loss_config

    @classmethod
    def from_edm(cls, sigma_data: float = 0.5, prior_mean: float = -1.2,
                 prior_std: float = 1.2, **kwargs):
        extra = dict(sigma_data=sigma_data, prior_mean=prior_mean,
                     prior_std=prior_std, **_extra(kwargs))
        return cls(
            preconditioner=preconditioners.EDMPreconditioner(sigma_data),
            noisesampler=noise_samplers.EDMNoiseSampler(
                sigma_data, prior_mean, prior_std),
            noisescheduler=schedulers.EDMScheduler(),
            tag="edm", extra_args=extra, **kwargs)

    @classmethod
    def from_vp(cls, beta_data: float = 19.9, beta_min: float = 0.1,
                epsilon_min: float = 1e-3, epsilon_sampler: float = 1e-5,
                M: int = 1000, **kwargs):
        sched = schedulers.VPScheduler(epsilon_min=epsilon_min,
                                       beta_data=beta_data,
                                       beta_min=beta_min)
        extra = dict(beta_data=beta_data, beta_min=beta_min,
                     epsilon_min=epsilon_min, epsilon_sampler=epsilon_sampler,
                     M=M, **_extra(kwargs))
        return cls(
            preconditioner=preconditioners.VPPreconditioner(
                scheduling=sched.scheduling, M=M),
            noisesampler=noise_samplers.VPNoiseSampler(
                scheduling=sched.scheduling, epsilon=epsilon_sampler),
            noisescheduler=sched, tag="vp", extra_args=extra, **kwargs)

    @classmethod
    def from_ve(cls, sigma_min: float = 0.02, sigma_max: float = 100.0,
                **kwargs):
        extra = dict(sigma_min=sigma_min, sigma_max=sigma_max,
                     **_extra(kwargs))
        return cls(
            preconditioner=preconditioners.VEPreconditioner(),
            noisesampler=noise_samplers.VENoiseSampler(sigma_min, sigma_max),
            noisescheduler=schedulers.VEScheduler(sigma_min, sigma_max),
            tag="ve", extra_args=extra, **kwargs)

    @classmethod
    def conditional_sr3(cls, sigma_min: float = 0.02,
                        sigma_max: float = 100.0, sigma_data: float = 0.5,
                        **kwargs):
        extra = dict(sigma_min=sigma_min, sigma_max=sigma_max,
                     sigma_data=sigma_data, **_extra(kwargs))
        return cls(
            preconditioner=preconditioners.SR3Preconditioner(sigma_data),
            noisesampler=noise_samplers.EDMNoiseSampler(sigma_data),
            noisescheduler=schedulers.EDMScheduler(sigma_min=sigma_min,
                                                   sigma_max=sigma_max),
            tag="conditionalSR3", extra_args=extra, **kwargs)

    def export_description(self) -> dict:
        return dict(tag=self.tag, extra_args=self.extra_args)

    @classmethod
    def load_from_description_with_tag(cls, description: dict):
        tag = description["tag"]
        if tag == "custom":
            raise ValueError("Cannot load from a custom tag")
        factory = {"edm": cls.from_edm, "vp": cls.from_vp,
                   "ve": cls.from_ve,
                   "conditionalSR3": cls.conditional_sr3}.get(tag)
        if factory is None:
            raise ValueError(f"Unknown tag: {tag}")
        return factory(**description["extra_args"])


class DynamicLossWeight(nn.Module):
    """EDM2's learned log-weight of the loss by noise level: a linear
    layer over cos(c_noise · W + b), W normal and b uniform Fourier
    buffers (``fourier_weights``, ``fourier_bias``) scaled by ``scale``."""

    def __init__(self, nhidden: int, scale: float = 1.0):
        super().__init__()
        self.scale = scale
        self.register_buffer("fourier_weights", torch.empty(nhidden))
        self.register_buffer("fourier_bias", torch.empty(nhidden))
        self.linear = nn.Linear(nhidden, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.fourier_weights.copy_(torch.randn(
            self.fourier_weights.shape, generator=generator) * self.scale)
        self.fourier_bias.copy_(torch.rand(
            self.fourier_bias.shape, generator=generator) * self.scale)

    def forward(self, cnoise):
        h = torch.cos(cnoise[:, None] * self.fourier_weights
                      + self.fourier_bias)
        return self.linear(h)[:, 0]


class KarrasNet(nn.Module):
    """Wraps the score network (state-dict prefix ``model.``) and moves
    the channel axis of x: channels-last in and out, NC* inside. Holds the
    ``DynamicLossWeight`` (``dlw``) and the EDM batch norm (``bnorm``)
    when the configuration has them, so one module holds every trained
    tensor."""

    def __init__(self, model: nn.Module,
                 dynamic_loss_weight: int | None = None,
                 edm_batch_norm_sigma: float | None = None):
        super().__init__()
        self.model = model
        if dynamic_loss_weight is not None:
            self.dlw = DynamicLossWeight(dynamic_loss_weight)
        if edm_batch_norm_sigma is not None:
            self.bnorm = DimensionAgnosticBatchNorm(
                sigma=edm_batch_norm_sigma)

    def forward(self, x, cnoise, y=None, cond_keep=None):
        x = x.movedim(-1, 1)
        out = self.model(x, cnoise, y) if cond_keep is None else \
            self.model(x, cnoise, y, cond_keep=cond_keep)
        return out.movedim(1, -1).contiguous()


def _needs_unsqueeze(y, x) -> bool:
    """Sample-time conditions without the batch dim get one, so they
    broadcast over the batch."""
    if y is None:
        return False
    probe = y["y"] if isinstance(y, dict) and "y" in y else (
        next(iter(y.values())) if isinstance(y, dict) else y)
    return hasattr(probe, "shape") and (probe.ndim == 0 or
                                        probe.shape[0] != x.shape[0])


class KarrasModel(ComputeDtypeMixin):
    """The denoiser runtime around a score network
    ``net(x, t, y=None)`` on [B, C, *spatial]."""

    def __init__(self, model: nn.Module, config: KarrasModelConfig,
                 conditional: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 fused_precondition: bool | str = "sample",
                 device: torch.device | str | None = None,
                 norm: float = 1.0, masked: bool = False):
        """``compute_dtype`` (e.g. ``torch.bfloat16``): the network runs
        with its parameters and input cast to this dtype, while the
        preconditioning, the combine, the sampler state, the dynamic loss
        weight and the batch norm stay float32.

        ``fused_precondition``: route the combine D = c_skip·x + c_out·F
        through kernel K1 — "sample" (default) when ``train`` is False,
        True always, False never.

        ``norm``: data are divided by it after the batch norm (``encode``)
        and multiplied back before it (``decode``).

        ``masked``: training batches carry a loss mask (``select_batch``)."""
        self.device = resolve_device(device)
        self.config = config
        self.conditional = conditional
        self.masked = masked
        self.compute_dtype = compute_dtype
        self.fused_precondition = fused_precondition
        self.norm = norm
        self.net = KarrasNet(
            model, config.dynamic_loss_weight,
            config.extra_args.get("sigma_data", 0.5)
            if config.has_edm_batch_norm else None).to(self.device).eval()
        self._loss_metric = losses.make_loss_metric(
            config.loss_metric, config.spatial_shape, config.focus_radius)
        drops = [m.rate for m in self.net.model.modules()
                 if isinstance(m, ConditionDrop) and m.rate > 0]
        self.cond_drop_rate = drops[0] if drops else None
        self._reset_cast()

    def to(self, device) -> "KarrasModel":
        self.device = resolve_device(device)
        self.net.to(self.device)
        return self

    def init(self, seed: int = 0) -> dict:
        """Draw every weight from ``seed`` (device-independent); returns
        the state dict."""
        init_parameters(self.net, seed)
        return self.net.state_dict()

    def select_batch(self, batch):
        """A loader's batch -> (x, y, mask): (x, y, mask) when conditional
        and masked, (x, mask) when masked, (x, y) when conditional, else x
        alone (``diffsci_tpu/models/karras/module.py:862-875``)."""
        if self.conditional and self.masked:
            x, y, mask = batch
        elif self.masked:
            (x, mask), y = batch, None
        elif self.conditional:
            (x, y), mask = batch, None
        else:
            x, y, mask = batch, None, None
        return x, y, mask

    def export_description(self) -> dict:
        """The model as plain data, key for key the JAX package's
        (``module.py:876-883``): the configuration's tag, the flags and the
        network's description. The latent keys are those of a pixel-space
        model."""
        net_export = getattr(self.net.model, "export_description", None)
        return dict(config_description=self.config.export_description(),
                    conditional=self.conditional, masked=self.masked,
                    autoencoder=False, autoencoder_conditional=False,
                    encode_y=False,
                    net=net_export() if net_export else None)

    def encode(self, x, y=None, train: bool = False):
        """Data -> diffusion space: the EDM batch norm (by ``x``'s own
        statistics when ``train``, else by the running ones), then / norm.
        Returns (x, y, updates): ``updates`` holds the batch norm's running
        statistics after this batch, by state-dict name, when ``train``
        (the train step writes them), else nothing."""
        updates = {}
        if self.config.has_edm_batch_norm:
            bnorm = self.net.bnorm
            if train:
                mean, var = bnorm.batch_statistics(x)
                updates = {f"bnorm.{k}": v for k, v in
                           bnorm.momentum_update(mean, var).items()}
                x = bnorm(x, use_running_stats=False)
            else:
                x = bnorm(x)
        if self.norm != 1.0:
            x = x / self.norm
        return x, y, updates

    def decode(self, x):
        """Diffusion space -> data: · norm, then the inverse of the EDM
        batch norm by its running statistics (the identity for a model
        without either)."""
        if self.norm != 1.0:
            x = x * self.norm
        if self.config.has_edm_batch_norm:
            x = self.net.bnorm.unnormalize(x)
        return x

    def draw_cond_keep(self, batch: int, generator=None, out=None):
        """The condition-drop mask [B] (bool, keep with probability
        1 - rate) from ``generator``, into ``out`` when given; None when
        the network drops no condition."""
        if self.cond_drop_rate is None:
            return None
        u = torch.rand(batch, generator=generator, device=self.device)
        keep = u < 1.0 - self.cond_drop_rate
        if out is None:
            return keep
        out.copy_(keep)
        return out

    # ------------------------------------------------------------------
    def get_denoiser(self, x, sigma, y=None, guidance: float = 1.0,
                     train: bool = False, variables=None, cond_keep=None):
        """D(x; sigma) = c_skip x + c_out F(c_in x, c_noise, y), with
        classifier-free guidance when guidance != 1: base =
        (1 - g)·F(·, None) + g·F(·, y), both network calls made and the
        combine (K1) run once on the guided base. An ``IntervalGuidance``
        sets g per row: its scale where σ lies in its band, 1 elsewhere.
        x is channels-last, sigma [B]. ``train`` runs the network in
        training mode (dropout, the condition drop by ``cond_keep``) and
        takes the plain combine under the default
        ``fused_precondition="sample"``. Returns (denoiser, c_noise)."""
        interval = None
        if isinstance(guidance, IntervalGuidance):
            interval = (guidance.sigma_lo, guidance.sigma_hi)
            guidance = guidance.scale
        pre = self.config.preconditioner
        c_skip_vec = pre.skip_scaling(sigma)
        c_out_vec = pre.output_scaling(sigma)
        c_in = bcast_right(pre.input_scaling(sigma), x)
        cnoise = pre.noise_conditioner(sigma)
        scaled = c_in * x

        net = self._network(train, variables)
        cd = self.compute_dtype
        if cd is not None:
            scaled = scaled.to(cd)
            cnoise_in = cnoise.to(cd)
            y = dict_map(lambda v: v.to(cd) if v.is_floating_point() else v,
                         y)
        else:
            cnoise_in = cnoise

        def net_fwd(yy, keep=None):
            out = net(scaled, cnoise_in, yy, keep)
            return out.float() if cd is not None else out

        if self.conditional and guidance != 0.0:
            base = net_fwd(y, cond_keep)
            if guidance != 1.0:
                uncond = net_fwd(None)
                if interval is None:
                    base = (1.0 - guidance) * uncond + guidance * base
                else:
                    lo, hi = interval
                    g = torch.where((sigma >= lo) & (sigma <= hi),
                                    guidance, 1.0).to(base.dtype)
                    g = bcast_right(g, base)
                    base = (1.0 - g) * uncond + g * base
        else:
            base = net_fwd(None)
        use_fused = (self.fused_precondition is True
                     or (self.fused_precondition == "sample" and not train))
        if use_fused:
            return fused_precondition.denoise_combine(
                x, base, c_skip_vec, c_out_vec), cnoise
        return (bcast_right(c_out_vec, x) * base
                + bcast_right(c_skip_vec, x) * x), cnoise

    # ------------------------------------------------------------------
    def loss_fn(self, x, sigma, y=None, mask=None, train: bool = True,
                eps=None, generator=None, variables=None, cond_keep=None,
                return_updates: bool = False):
        """The Karras training loss of the configuration (EDM, VP, VE,
        SR3: its preconditioner and its noise sampler's λ): with x encoded
        (``encode``: the EDM batch norm by the batch's statistics when
        ``train``), the mean over elements of
        λ(σ)/e^u · metric(D(x + σ·ε; σ), x) + u, masked elements
        (mask == 1) weighted 0, where u is the dynamic loss weight's
        log-weight of c_noise (0 without one); a metric that reduces
        itself gives mean(λ/e^u)·metric + mean(u). x is channels-last,
        sigma [B]. ``eps`` replays a fixed unit-noise draw in place of one
        from ``generator``, and ``cond_keep`` ([B] bool) the condition
        drop's mask, else drawn from ``generator`` after ε in training
        (the cross-framework tests feed the same draws to both packages).
        Dropout, when the network has any, draws from torch's default
        generator of the device. Returns the scalar loss, and with
        ``return_updates`` (loss, updates): the batch norm's running
        statistics after this batch, by state-dict name (the JAX
        package's mutable collection)."""
        x, y, updates = self.encode(x, y, train=train)
        sigma_b = bcast_right(sigma, x)
        if eps is None:
            eps = torch.randn(x.shape, generator=generator, device=x.device,
                              dtype=x.dtype)
        if cond_keep is None and train and self.conditional and y is not None:
            cond_keep = self.draw_cond_keep(x.shape[0], generator)
        denoiser, cnoise = self.get_denoiser(
            x + sigma_b * eps, sigma, y, train=train, variables=variables,
            cond_keep=cond_keep)
        weight = self.config.noisesampler.loss_weighting(sigma_b)
        bias = torch.zeros_like(weight)
        if self.config.has_dynamic_loss_weight:
            modifier = bcast_right(self._loss_weight_modifier(
                cnoise, variables), x)
            weight = weight / torch.exp(modifier)
            bias = bias + modifier
        raw = self._loss_metric(denoiser, x, mask)
        if self._loss_metric.reduces_internally or raw.ndim == 0:
            loss = weight.mean() * raw + bias.mean()
        else:
            loss = self._apply_mask_weight(raw, weight, bias, mask)
        return (loss, updates) if return_updates else loss

    def _loss_weight_modifier(self, cnoise, variables=None):
        """The dynamic loss weight's log-weight of c_noise, in float32 on
        the master weights (or on ``variables``' ``dlw.*`` tensors)."""
        dlw = self.net.dlw
        if variables is None:
            return dlw(cnoise)
        tensors = dict(dlw.named_parameters())
        tensors.update({k[4:]: v for k, v in variables.items()
                        if k.startswith("dlw.")})
        return torch.func.functional_call(dlw, tensors, (cnoise,))

    @staticmethod
    def _apply_mask_weight(loss, weight, bias, mask):
        """mean(weight · loss + bias) with masked elements of loss
        zeroed."""
        if mask is not None:
            loss = loss * (1.0 - mask.expand_as(loss))
        return (weight * loss + bias).mean()

    def get_score(self, x, sigma, y=None, guidance: float = 1.0):
        denoiser, _ = self.get_denoiser(x, sigma, y, guidance)
        return (denoiser - x) / bcast_right(sigma, x) ** 2

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def sample(self, nsamples: int, shape, generator=None, y=None,
               guidance: float = 1.0, nsteps: int = 100,
               record_history: bool = False,
               maximum_batch_size: int | None = None, integrator=None,
               stochastic: bool = False, langevin_scale=None):
        """Generate samples from white noise drawn on the model's device
        with ``generator``. ``shape`` is channels-last without the batch
        dim, e.g. (28, 28, 1). ``integrator``: None (the scheduler's, or
        its stochastic one when ``stochastic``), a name ("euler", "heun",
        "euler-maruyama", "karras", "dpmpp2m") or an integrator.
        ``langevin_scale``: a number multiplying the scheduler's Langevin
        gate (stochastic sampling); with ``langevin_const=1`` it is γ.

        The draws: x_T, then the loop's noise, one [n, nsamples, *shape]
        tensor for its n noisy steps. On a CUDA device the loop is the
        graph of ``compile_sampler``: the draws go into its static inputs,
        ``y`` and ``langevin_scale`` too, and the graph is replayed; the
        samples are a copy of its output. On the CPU the loop runs
        eagerly on the same draws."""
        if maximum_batch_size is not None:
            outs = [self.sample(n, shape, generator, y, guidance, nsteps,
                                record_history, None, integrator,
                                stochastic, langevin_scale)
                    for n in get_minibatch_sizes(nsamples,
                                                 maximum_batch_size)]
            return torch.cat(outs, dim=1 if record_history else 0)
        if self.device.type != "cuda":
            x, noise, gate = self._draw_inputs(
                self._sampler_inputs(nsamples, shape, nsteps, integrator,
                                     stochastic, langevin_scale),
                generator, langevin_scale)
            return self.decode(self._propagate_white_noise(
                x, y, guidance, nsteps, record_history, integrator,
                stochastic, gate_scale=gate, noise_seq=noise))
        graph = self.compile_sampler(nsamples, shape, y, guidance, nsteps,
                                     record_history, integrator, stochastic,
                                     langevin_scale)
        self._draw_inputs(graph.inputs[:3], generator, langevin_scale)
        graphs.fill(graph.inputs[3], y)
        graph.replay()
        return graph.outputs.clone()

    def _sampler_inputs(self, nsamples, shape, nsteps, integrator,
                        stochastic, langevin_scale):
        """(x_T, the loop's noise [n, nsamples, *shape] or None, the
        Langevin scale as a 0-d tensor or None) on the model's device."""
        x = torch.zeros((nsamples,) + tuple(shape), device=self.device)
        n = self.config.noisescheduler.noise_steps(nsteps, stochastic,
                                                   integrator)
        noise = torch.zeros((n,) + tuple(x.shape), device=self.device) \
            if n else None
        gate = None if langevin_scale is None else torch.zeros(
            (), device=self.device)
        return x, noise, gate

    @staticmethod
    def _draw_inputs(inputs, generator, langevin_scale):
        """Fill a sampler's inputs in place: x_T, then the loop's noise,
        from ``generator``, and the Langevin scale. Returns them.
        ``generator`` may be a list of generators, one a row
        (``ops.schedulers.draw_rows``: row i's x_T and loop noise from the
        i-th alone), as the service's dispatcher draws."""
        if isinstance(generator, (list, tuple)):
            draw_rows(generator, inputs[0], inputs[1])
        else:
            for t in inputs[:2]:
                if t is not None:
                    torch.randn(t.shape, generator=generator, out=t)
        if inputs[2] is not None:
            inputs[2].fill_(float(langevin_scale))
        return inputs

    @torch.inference_mode()
    def compile_sampler(self, nsamples: int, shape, y=None,
                        guidance: float = 1.0, nsteps: int = 100,
                        record_history: bool = False, integrator=None,
                        stochastic: bool = False, langevin_scale=None):
        """The CUDA graph of ``sample``'s loop for (nsamples, shape,
        guidance, nsteps, record_history, y's shapes, the integrator,
        ``stochastic``, whether ``langevin_scale`` is given), as the JAX
        package's ``_jitted_sampler`` keys its executables; not for
        ``langevin_scale``'s value, which the graph reads from a 0-d
        device tensor. Static inputs (``graph.inputs``): x_T, the noise of
        the noisy steps ([n, nsamples, *shape], None for a deterministic
        loop), the Langevin scale and y's tensors. On its first use the
        loop runs once eagerly on the capture stream (the warm-up) and is
        captured; ``SamplerService.warmup`` calls this for every bucket. A
        loop that cannot be captured raises. Returns the
        ``utils.graphs.Graph``; None on the CPU, where nothing is
        captured."""
        if self.device.type != "cuda":
            return None
        cache = self._graph_cache()
        key = (nsamples, tuple(shape), _guidance_key(guidance), nsteps,
               record_history, graphs.condition_key(y), integrator,
               stochastic, langevin_scale is not None)
        graph = cache.graphs.get(key)
        if graph is not None:
            return graph
        x, noise, gate = self._sampler_inputs(nsamples, shape, nsteps,
                                              integrator, stochastic,
                                              langevin_scale)
        ys = graphs.static_like(y, self.device)
        graphs.fill(ys, y)

        def loop():
            return self.decode(self._propagate_white_noise(
                x, ys, guidance, nsteps, record_history, integrator,
                stochastic, gate_scale=gate, noise_seq=noise))

        cache.warmup(loop)
        graph = cache.capture(key, loop)
        graph.inputs = (x, noise, gate, ys)
        return graph

    @torch.inference_mode()
    def sample_parallel(self, nsamples: int, shape, generator=None, y=None,
                        guidance: float = 1.0, nsteps: int = 100,
                        window: int = 16, tol: float = 1e-3,
                        stochastic: bool = False,
                        return_sweeps: bool = False):
        """Parallel-in-time sampling by sliding-window Picard
        (``ops/parallel_sampling.py``): each sweep is one denoiser call of
        batch window·nsamples over the steps after the converged frontier,
        which advances by one or more steps a sweep; ``tol=0`` gives
        sequential Euler in nsteps sweeps. ``stochastic``: Euler–Maruyama,
        its noise drawn before the loop. The draws are ``sample``'s: x_T,
        then (stochastic) the loop's [nsteps, nsamples, *shape] noise, so
        one seed gives ``sample(..., integrator="euler")`` (or
        ``stochastic=True`` with "euler-maruyama") at ``tol=0``. As in the
        JAX package the result is not decoded. On a CUDA device a sweep is
        one graph (``compile_parallel``), replayed while the host reads
        the frontier after every replay; on the CPU the same
        sweep runs eagerly. Returns the samples (and the sweep count if
        ``return_sweeps``)."""
        smax = self.config.noisescheduler.maximum_scale
        if self.device.type != "cuda":
            pw, inputs = self._picard_state(nsamples, shape, nsteps, window,
                                            tol, stochastic)
            x, noise, _ = self._draw_inputs(inputs, generator, None)
            score = self._score(y, guidance, x)
            pw.reset(x * smax, noise)
            sweeps = pw.run(lambda: pw.sweep(score))
        else:
            graph = self.compile_parallel(nsamples, shape, y, guidance,
                                          nsteps, window, tol, stochastic)
            x, noise, _ = self._draw_inputs(graph.inputs[:3], generator,
                                            None)
            graphs.fill(graph.inputs[3], y)
            pw = graph.picard
            pw.reset(x * smax, noise)
            sweeps = pw.run(graph.replay)
        out = pw.result.clone()
        return (out, sweeps) if return_sweeps else out

    def _picard_state(self, nsamples, shape, nsteps, window, tol,
                      stochastic):
        """A ``PicardWindow`` for the batch and its draws' tensors (x_T,
        the noise [nsteps, nsamples, *shape] or None, None)."""
        x_shape = (nsamples,) + tuple(shape)
        pw = PicardWindow(self.config.noisescheduler, x_shape, nsteps,
                          window, tol, stochastic, device=self.device)
        noise = torch.zeros((nsteps,) + x_shape, device=self.device) \
            if stochastic else None
        return pw, (torch.zeros(x_shape, device=self.device), noise, None)

    @torch.inference_mode()
    def compile_parallel(self, nsamples: int, shape, y=None,
                         guidance: float = 1.0, nsteps: int = 100,
                         window: int = 16, tol: float = 1e-3,
                         stochastic: bool = False):
        """The CUDA graph of one Picard sweep of ``sample_parallel`` for
        (nsamples, shape, guidance, nsteps, window, tol, ``stochastic``,
        y's shapes). Static inputs (``graph.inputs``): x_T, the noise (or
        None), None and y's tensors; ``graph.picard`` is the
        ``PicardWindow`` whose state the sweep updates in place. None on
        the CPU."""
        if self.device.type != "cuda":
            return None
        cache = self._graph_cache()
        key = ("picard", nsamples, tuple(shape), _guidance_key(guidance),
               nsteps, window, float(tol), stochastic,
               graphs.condition_key(y))
        graph = cache.graphs.get(key)
        if graph is not None:
            return graph
        pw, inputs = self._picard_state(nsamples, shape, nsteps, window,
                                        tol, stochastic)
        ys = graphs.static_like(y, self.device)
        graphs.fill(ys, y)
        score = self._score(ys, guidance, inputs[0])
        pw.reset(inputs[0], inputs[1])

        def body():
            pw.sweep(score)

        cache.warmup(body)
        graph = cache.capture(key, body)
        graph.inputs = inputs + (ys,)
        graph.picard = pw
        return graph

    @torch.inference_mode()
    def sample_restart(self, nsamples: int, shape, generator=None, y=None,
                       guidance: float = 1.0, nsteps: int = 18,
                       restarts=((0.05, 2.0, 2),)):
        """Restart sampling (Xu et al., arXiv:2306.14878; see
        ``Scheduler.restart_propagate_backward``): deterministic ODE
        segments with K re-noise jumps per ``(sigma_lo, sigma_hi, K)``
        interval. The draws: x_T, then one [sum K, nsamples, *shape]
        tensor for the jumps. On a CUDA device one graph per (nsamples,
        shape, nsteps, restarts, guidance, y's shapes) is replayed with
        the draws in its static inputs; on the CPU the loop runs eagerly
        on the same draws."""
        sched = self.config.noisescheduler
        restarts = tuple(tuple(r) for r in restarts)
        x = torch.zeros((nsamples,) + tuple(shape), device=self.device)
        inputs = (x, torch.zeros((sched.restart_jumps(restarts),)
                                 + tuple(x.shape), device=self.device), None)

        def loop(x, noises, y):
            return sched._restart(x * sched.maximum_scale,
                                  self._score(y, guidance, x), nsteps,
                                  restarts, None, noises)

        if self.device.type != "cuda":
            x, noises, _ = self._draw_inputs(inputs, generator, None)
            return loop(x, noises, y)
        cache = self._graph_cache()
        key = ("restart", nsamples, tuple(shape), nsteps, restarts,
               _guidance_key(guidance), graphs.condition_key(y))
        graph = cache.graphs.get(key)
        if graph is None:
            ys = graphs.static_like(y, self.device)
            graphs.fill(ys, y)
            def body():
                return loop(*inputs[:2], ys)

            cache.warmup(body)
            graph = cache.capture(key, body)
            graph.inputs = inputs[:2] + (None, ys)
        self._draw_inputs(graph.inputs[:3], generator, None)
        graphs.fill(graph.inputs[3], y)
        graph.replay()
        return graph.outputs.clone()

    def _score(self, y, guidance, x):
        """The learned score (x, σ) -> ∇log p with y given a batch dim
        where it has none."""
        y = dict_expand_dims(y, 0) if _needs_unsqueeze(y, x) else y

        def score_fn(xx, sigma):
            return self.get_score(xx, sigma, y, guidance)

        return score_fn

    def _propagate_white_noise(self, x, y, guidance, nsteps, record_history,
                               integrator, stochastic, gate_scale=None,
                               noise_seq=None, generator=None):
        x = x * self.config.noisescheduler.maximum_scale
        return self.propagate_toward_sample(
            x, y, guidance, nsteps, record_history, integrator, stochastic,
            gate_scale=gate_scale, noise_seq=noise_seq, generator=generator)

    @torch.inference_mode()
    def propagate_white_noise(self, x, y=None, guidance: float = 1.0,
                              nsteps: int = 100,
                              record_history: bool = False, integrator=None,
                              stochastic: bool = False, noise_seq=None,
                              generator=None):
        """x is unit white noise (channels-last); scaled to the scheduler's
        maximum scale and integrated to a sample in the diffusion space
        (not decoded, as in the JAX package: ``decode`` maps it back
        through the batch norm). ``noise_seq``
        ([n, *x.shape], n the noisy steps): the stochastic loop's noise,
        else drawn from ``generator`` before the loop."""
        return self._propagate_white_noise(
            x, y, guidance, nsteps, record_history, integrator, stochastic,
            noise_seq=noise_seq, generator=generator)

    @torch.inference_mode()
    def propagate_toward_sample(self, x, y=None, guidance: float = 1.0,
                                nsteps: int = 100,
                                record_history: bool = False,
                                integrator=None, stochastic: bool = False,
                                gate_scale=None, noise_seq=None,
                                generator=None):
        """Backward propagation with the learned score."""
        return self.config.noisescheduler.propagate_backward(
            x, self._score(y, guidance, x), nsteps,
            record_history=record_history, stochastic=stochastic,
            integrator=integrator, noise_seq=noise_seq,
            gate_scale=gate_scale, generator=generator)

    @torch.inference_mode()
    def propagate_partial_toward_sample(self, x, initial_step: int,
                                        final_step: int | None = None,
                                        y=None, nsteps: int = 100,
                                        record_history: bool = False,
                                        integrator=None,
                                        analytical_score=None,
                                        interp_fn=None,
                                        guidance: float = 1.0,
                                        generator=None):
        """Backward propagation over grid steps [initial_step, final_step),
        the learned score optionally blended with ``analytical_score`` by
        ``interp_fn(sigma)`` (1 = learned only)."""
        if final_step is None:
            final_step = nsteps

        def score_fn(xx, sigma):
            trained = self.get_score(xx, sigma, y, guidance)
            if interp_fn is not None:
                if analytical_score is None:
                    raise ValueError("interp_fn needs analytical_score")
                alpha = bcast_right(interp_fn(sigma), xx)
                return alpha * trained + (1 - alpha) * analytical_score(
                    xx, sigma)
            return trained

        return self.config.noisescheduler.propagate_partial(
            x, score_fn, nsteps, initial_step, final_step,
            record_history=record_history, integrator=integrator,
            generator=generator)

    @torch.inference_mode()
    def propagate_toward_noise(self, x, y=None, nsteps: int = 100,
                               record_history: bool = False,
                               stochastic_integration: bool = False,
                               generator=None):
        """Forward (noising) propagation with the learned score."""
        return self.config.noisescheduler.propagate_forward(
            x, self._score(y, 1.0, x), nsteps, record_history=record_history,
            stochastic=stochastic_integration, generator=generator)

    @torch.inference_mode()
    def inpaint(self, x_orig, mask, y=None, nsteps: int = 100,
                record_history: bool = False,
                maximum_batch_size: int | None = None,
                mode: str = "inpaint", rsteps: int = 10,
                nresamples: int = 10, generator=None):
        """Known-region-preserving generation: ``mask == 1`` marks the
        known region of ``x_orig``. The known image is noised along the
        grid by a stochastic forward pass, then a backward pass from white
        noise splices it in after every step ("inpaint") or with RePaint
        resampling ("repaint", ``rsteps``, ``nresamples``). The draws,
        before any loop: x_T, then one tensor of the forward pass's
        nsteps - 1 noisy steps followed by RePaint's re-noise jumps. Runs
        eagerly on every device."""
        if maximum_batch_size is not None:
            outs, start = [], 0
            for bs in get_minibatch_sizes(x_orig.shape[0],
                                          maximum_batch_size):
                outs.append(self.inpaint(
                    x_orig[start:start + bs], mask, y, nsteps,
                    record_history, None, mode, rsteps, nresamples,
                    generator))
                start += bs
            return torch.cat(outs, dim=1 if record_history else 0)
        sched = self.config.noisescheduler
        noise = torch.randn(x_orig.shape, generator=generator,
                            dtype=x_orig.dtype, device=x_orig.device)
        n_fwd = sched.noise_steps(nsteps, stochastic=True, backward=False)
        n_renoise = nresamples * (nsteps // rsteps - 1) \
            if mode == "repaint" else 0
        draws = draw_noise(generator, n_fwd + n_renoise, x_orig)
        score_fn = self._score(y, 1.0, x_orig)
        fwd_hist = sched.propagate_forward(
            x_orig, score_fn, nsteps, record_history=True, stochastic=True,
            noise_seq=draws[:n_fwd])
        y_noised = fwd_hist.flip(0)  # index k = backward grid time t[k]
        noise = noise * sched.maximum_scale
        if mode == "inpaint":
            return sched.inpaint(noise, y_noised, mask, score_fn, nsteps,
                                 record_history=record_history)
        return sched.repaint(noise, y_noised, mask, score_fn, nsteps, rsteps,
                             nresamples, record_history=record_history,
                             renoise_noises=draws[n_fwd:])

    def repaint(self, x_orig, mask, y=None, nsteps: int = 100,
                record_history: bool = False,
                maximum_batch_size: int | None = None, rsteps: int = 10,
                nresamples: int = 10, generator=None):
        return self.inpaint(x_orig, mask, y, nsteps, record_history,
                            maximum_batch_size, mode="repaint",
                            rsteps=rsteps, nresamples=nresamples,
                            generator=generator)

    @torch.inference_mode()
    def interpolate_images(self, x1, x2, ninterp: int,
                           jitter: float | None = 1e-2, y=None,
                           nsteps: int = 100, record_history: bool = False,
                           generator=None):
        """Interpolate between two images through the noise space: both
        (jittered by ``jitter``·ε from ``generator``, unless None) are
        propagated to noise by the learned pf-ODE, joined by
        ``linear_interpolation`` at ``ninterp`` inner points and
        propagated back: [ninterp + 2, *x1.shape] (with
        ``record_history``, the backward history)."""
        x = torch.stack([x1, x2], dim=0)
        if jitter is not None:
            x = x + jitter * torch.randn(x.shape, generator=generator,
                                         dtype=x.dtype, device=x.device)
        yb = dict_expand_dims(y, 0) if y is not None else None
        x_noised = self.propagate_toward_noise(x, yb, nsteps)
        x_interp = linear_interpolation(x_noised[0], x_noised[1], ninterp)
        return self.propagate_toward_sample(x_interp, y=yb, nsteps=nsteps,
                                            record_history=record_history)

    @torch.inference_mode()
    def sample_and_filter(self, nsamples: int, shape, filter_fn,
                          generator=None, y=None, guidance: float = 1.0,
                          nsteps: int = 100,
                          maximum_batch_size: int | None = None,
                          integrator=None,
                          return_only_positives: bool = False) -> dict:
        """Sample, then keep the verdict of ``filter_fn`` (a predicate on
        the encoded samples, [B] bool) on each: dict(samples, filter,
        hit_rate). ``maximum_batch_size`` splits the request by
        ``get_minibatch_sizes``, ``generator`` threaded through the
        chunks in turn; ``return_only_positives`` drops the rows that fail
        the filter."""
        if maximum_batch_size is not None:
            samples, filters = [], []
            for bs in get_minibatch_sizes(nsamples, maximum_batch_size):
                res = self.sample_and_filter(
                    bs, shape, filter_fn, generator, y, guidance, nsteps,
                    None, integrator, return_only_positives)
                samples.append(res["samples"])
                filters.append(res["filter"])
            filt = torch.cat(filters, 0)
            return dict(samples=torch.cat(samples, 0), filter=filt,
                        hit_rate=float(filt.sum()) / nsamples)
        samples = self.sample(nsamples, shape, generator, y=y,
                              guidance=guidance, nsteps=nsteps,
                              integrator=integrator)
        enc, _, _ = self.encode(samples, y)
        filt = filter_fn(enc)
        if return_only_positives:
            samples = samples[filt]
            filt = filt[filt]
        return dict(samples=samples, filter=filt,
                    hit_rate=float(filt.sum()) / nsamples)


def karras_model_from_description(description: dict,
                                  conditional_embedding=None,
                                  device: torch.device | str | None = None,
                                  **model_kwargs) -> KarrasModel:
    """Rebuild a ``KarrasModel`` on ``device`` from its description (the
    port's or the JAX package's ``export_description``, e.g. a
    checkpoint's ``description.json``): the net by its ``kind``
    (``models/nets/describe.py``; descriptions without one rebuild as
    PUNetG), the configuration by its tag. ``model_kwargs`` go to
    ``KarrasModel`` (e.g. ``compute_dtype``).

    Raises for what a description alone cannot rebuild: no net entry, a
    conditional embedding (pass the module as ``conditional_embedding``;
    its config is in ``description['net']['conditional_embedding_args']``)
    and a latent model (``autoencoder: true``), which the port has no
    autoencoder for yet."""
    from diffsci_tpu_torch.models.nets.describe import net_from_description

    device = resolve_device(device)
    net_desc = description.get("net") or {}
    if not net_desc.get("config", net_desc):
        raise ValueError(
            "description has no net config (checkpoints saved before the "
            "descriptions became self-contained); rebuild the net "
            "explicitly or re-export the description")
    if net_desc.get("has_conditional_embedding") \
            and conditional_embedding is None:
        raise ValueError(
            "checkpoint was trained with a conditional embedding; pass "
            "the embedding module via conditional_embedding= (its config "
            "is in description['net']['conditional_embedding_args'])")
    if description.get("autoencoder"):
        raise ValueError("checkpoint is a latent-diffusion model; the port "
                         "has no autoencoder yet")
    net = net_from_description(net_desc,
                               conditional_embedding=conditional_embedding,
                               device=device)
    config = KarrasModelConfig.load_from_description_with_tag(
        description["config_description"])
    return KarrasModel(net, config,
                       conditional=description.get("conditional", False),
                       masked=description.get("masked", False),
                       device=device, **model_kwargs)
