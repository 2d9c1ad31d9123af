"""KarrasModel: the Karras denoiser runtime for training and sampling.

Port of ``diffsci_tpu/models/karras/module.py``: ``KarrasModelConfig``
(``from_edm``, ``from_vp``, ``from_ve``, ``conditional_sr3``,
``loss_metric``, ``has_edm_batch_norm``, ``dynamic_loss_weight``,
``spatial_shape``/``focus_radius``, the six ``autoregressive_loss_*``
fields of ``models/karras/ensemble.py``, the tag and ``extra_args`` of
``export_description``), ``IntervalGuidance``,
``DynamicLossWeight``, ``KarrasNet`` (the network, the dynamic loss
weight and the EDM batch norm), and ``KarrasModel``'s ``init``,
``encode``/``decode``, ``get_denoiser`` (with ``compute_dtype``, CFG, the
guidance interval and the ``fused_precondition`` policy), ``loss_fn``,
``get_score``, ``sample`` (any integrator, stochastic,
``langevin_scale``, latent shapes), ``sample_restart``, ``propagate_white_noise``,
``propagate_toward_sample``, ``propagate_partial_toward_sample``,
``propagate_toward_noise``, ``inpaint``, ``repaint``, ``sample_parallel``
(sliding-window Picard), ``interpolate_images`` and ``sample_and_filter``;
and ``select_batch``, ``export_description`` and
``karras_model_from_description`` (the JAX package's description,
key for key).

A latent model (``autoencoder=``, e.g. ``models.vae.BoundAutoencoder``)
diffuses in its autoencoder's latent space: ``encode`` maps data through
the autoencoder (then the batch norm and / norm), ``decode`` back, the
loss may be a ``MultiSpaceLoss`` over latent and pixel terms, and
``sample`` draws x_T in the latent shape and decodes its result unless
``return_in_latent_space``. The autoencoder takes and returns
[B, C, *spatial] tensors (``encode(x, y=None, eps=None)``,
``decode(z, y=None)``); the model moves the channel axis at its boundary
as ``KarrasNet`` does at the network's, so latents are channels-last
like every sample. A posterior draw (``eps``, when the autoencoder's
``sample_posterior`` is set) is made by the model from the caller's
generator before the loss's ε, and replays as ``z_eps=``.

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
γ), right for a graph keyed on nsteps, the integrator and the scheduler
(``Scheduler.graph_key``: a swapped ``config.noisescheduler`` with
another ``langevin_const`` gets its own graph); the draws and
``langevin_scale`` are static inputs filled before each replay, so a γ
sweep by ``langevin_scale`` replays one graph. An ``IntervalGuidance``
is part of the key like a float guidance; its band test is made per row
on the device from σ.
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
                                     linear_interpolation, resolve_device,
                                     unset)


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


def _ar_extra(kwargs: dict) -> dict:
    """The keyword arguments a preset records in ``extra_args``."""
    return {k: v for k, v in kwargs.items()
            if k.startswith("autoregressive_")
            or k in ("loss_metric", "spatial_shape", "focus_radius")}


class KarrasModelConfig:
    """The math configuration: preconditioner, training noise sampler,
    sampling scheduler, the training loss metric ("huber", "mse",
    "weighted_gaussian", "smoothed_indicator" or a one-key dict such as
    ``{"huber": {"delta": ...}}``; ``spatial_shape`` and ``focus_radius``
    for "weighted_gaussian"; "crps" for ensembles; ``{"losses": [...]}``
    for a ``MultiSpaceLoss``), the EDM batch norm and the dynamic loss
    weight's width, with the preset's ``tag`` and ``extra_args``. The
    ``autoregressive_loss_*`` fields configure
    ``EnsembleKarrasModel.autoregressive_loss_fn``: the horizons, the
    in-step sampler's steps, guidance, maximum batch and integrator, and
    the horizons' weights."""

    def __init__(self, preconditioner: preconditioners.KarrasPreconditioner,
                 noisesampler: noise_samplers.NoiseSampler,
                 noisescheduler: schedulers.Scheduler,
                 loss_metric="huber", tag: str = "custom",
                 has_edm_batch_norm: bool = False,
                 dynamic_loss_weight: int | None = None,
                 extra_args: dict | None = None,
                 autoregressive_loss_steps: int = 1,
                 autoregressive_loss_diffusion_steps: int = 100,
                 autoregressive_loss_guidance: float = 1.0,
                 autoregressive_loss_weights: list | None = None,
                 autoregressive_loss_maximum_batch_size: int | None = None,
                 autoregressive_loss_integrator=None,
                 spatial_shape: tuple | None = None,
                 focus_radius: float | None = None):
        self.preconditioner = preconditioner
        self.noisesampler = noisesampler
        self.noisescheduler = noisescheduler
        self.loss_metric = loss_metric
        self.tag = tag
        self.has_edm_batch_norm = has_edm_batch_norm
        self.dynamic_loss_weight = dynamic_loss_weight
        self.autoregressive_loss_steps = autoregressive_loss_steps
        self.autoregressive_loss_diffusion_steps = \
            autoregressive_loss_diffusion_steps
        self.autoregressive_loss_guidance = autoregressive_loss_guidance
        self.autoregressive_loss_weights = autoregressive_loss_weights
        self.autoregressive_loss_maximum_batch_size = \
            autoregressive_loss_maximum_batch_size
        self.autoregressive_loss_integrator = autoregressive_loss_integrator
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
                     prior_std=prior_std, **_ar_extra(kwargs))
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
                     M=M, **_ar_extra(kwargs))
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
                     **_ar_extra(kwargs))
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
                     sigma_data=sigma_data, **_ar_extra(kwargs))
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
        self.register_buffer("fourier_weights", unset(nhidden))
        self.register_buffer("fourier_bias", unset(nhidden))
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
                 norm: float = 1.0, masked: bool = False,
                 autoencoder=None, autoencoder_conditional: bool = False,
                 encode_y: bool = False, decode_original_y: bool = False):
        """``compute_dtype`` (e.g. ``torch.bfloat16``): the network runs
        with its parameters and input cast to this dtype, while the
        preconditioning, the combine, the sampler state, the dynamic loss
        weight and the batch norm stay float32.

        ``fused_precondition``: route the combine D = c_skip·x + c_out·F
        through kernel K1 — "sample" (default) when ``train`` is False,
        True always, False never.

        ``norm``: data are divided by it after the batch norm (``encode``)
        and multiplied back before it (``decode``).

        ``masked``: training batches carry a loss mask (``select_batch``).

        ``autoencoder``: a latent model's autoencoder (module docstring);
        ``autoencoder_conditional`` passes y to it, ``encode_y`` takes the
        encoded y back from its ``encode`` (which then returns (z, y)),
        ``decode_original_y`` decodes a sample with the caller's y rather
        than the encoded one."""
        self.device = resolve_device(device)
        self.config = config
        self.conditional = conditional
        self.masked = masked
        self.compute_dtype = compute_dtype
        self.fused_precondition = fused_precondition
        self.norm = norm
        self.autoencoder = autoencoder
        self.autoencoder_conditional = autoencoder_conditional
        self.encode_y = encode_y
        self.decode_original_y = decode_original_y
        self._latent_shapes: dict = {}
        self.net = KarrasNet(
            model, config.dynamic_loss_weight,
            config.extra_args.get("sigma_data", 0.5)
            if config.has_edm_batch_norm else None).to(self.device).eval()
        self._set_loss_metric()
        drops = [m.rate for m in self.net.model.modules()
                 if isinstance(m, ConditionDrop) and m.rate > 0]
        self.cond_drop_rate = drops[0] if drops else None
        self._reset_cast()

    @property
    def latent_model(self) -> bool:
        return self.autoencoder is not None

    def _set_loss_metric(self) -> None:
        """The configuration's metric, or a ``MultiSpaceLoss`` (pixel terms
        decode through the autoencoder) for a ``{"losses": [...]}``
        config."""
        cfg = self.config.loss_metric
        self._multi_space = None
        self._loss_metric = None
        if isinstance(cfg, dict) and "losses" in cfg:
            self._multi_space = losses.MultiSpaceLoss(
                cfg, self._ae_decode if self.latent_model else None)
        else:
            self._loss_metric = losses.make_loss_metric(
                cfg, self.config.spatial_shape, self.config.focus_radius)

    def _ae_decode(self, z, y=None):
        """The autoencoder's decode of channels-last latents, channels-last
        out."""
        z = z.movedim(-1, 1)
        out = self.autoencoder.decode(z, y=y) \
            if self.autoencoder_conditional else self.autoencoder.decode(z)
        return out.movedim(1, -1).contiguous()

    def latent_shape(self, x_shape) -> tuple:
        """The diffusion space's shape of data of ``x_shape`` (with its
        batch axis, channels-last): ``x_shape`` itself for a pixel model,
        the autoencoder's latent shape for a latent model (found once per
        shape by encoding zeros of one item)."""
        x_shape = tuple(x_shape)
        if not self.latent_model:
            return x_shape
        probe = self._latent_shapes.get(x_shape[1:])
        if probe is None:
            x = torch.zeros((1, x_shape[-1]) + x_shape[1:-1],
                            device=self.device)
            with torch.no_grad():
                z = self.autoencoder.encode(x)
            z = z[0] if isinstance(z, tuple) else z
            probe = tuple(z.movedim(1, -1).shape[1:])
            self._latent_shapes[x_shape[1:]] = probe
        return x_shape[:1] + probe

    def draws_posterior(self) -> bool:
        """Whether the model draws a posterior sample for its
        autoencoder's encode."""
        return self.latent_model and bool(
            getattr(self.autoencoder, "sample_posterior", False))

    def _draw_posterior(self, x, generator=None):
        """The posterior draw for encoding x (the latent's shape) from
        ``generator``, or None when the model draws none."""
        if not self.draws_posterior():
            return None
        return torch.randn(self.latent_shape(x.shape), generator=generator,
                           device=x.device, dtype=x.dtype)

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
        (``module.py:876-883``): the configuration's tag, the flags (the
        autoencoder's presence, not its weights) and the network's
        description."""
        net_export = getattr(self.net.model, "export_description", None)
        return dict(config_description=self.config.export_description(),
                    conditional=self.conditional, masked=self.masked,
                    autoencoder=self.autoencoder is not None,
                    autoencoder_conditional=self.autoencoder_conditional,
                    encode_y=self.encode_y,
                    net=net_export() if net_export else None)

    def encode(self, x, y=None, train: bool = False, z_eps=None):
        """Data -> diffusion space: through the autoencoder of a latent
        model (a posterior sample with ``z_eps``, a unit draw of the
        latent's shape, when its ``sample_posterior`` is set; else the
        mode), the EDM batch norm (by ``x``'s own statistics when
        ``train``, else by the running ones), then / norm. Returns (x, y,
        updates): ``updates`` holds the batch norm's running statistics
        after this batch, by state-dict name, when ``train`` (the train
        step writes them), else nothing."""
        updates = {}
        if self.latent_model:
            xn = x.movedim(-1, 1)
            eps = None if z_eps is None else z_eps.movedim(-1, 1)
            if self.autoencoder_conditional:
                out = self.autoencoder.encode(xn, y=y, eps=eps)
                if self.encode_y:
                    out, y = out
            else:
                out = self.autoencoder.encode(xn, eps=eps)
            x = out.movedim(1, -1).contiguous()
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

    def decode(self, x, y=None, record_history: bool = False):
        """Diffusion space -> data: · norm, the inverse of the EDM batch
        norm by its running statistics, then the autoencoder's decode of a
        latent model (the identity for a model without any).
        ``record_history``: x is a history [T, B, ...], decoded in one
        call."""
        if record_history and self.latent_model:
            flat = self.decode(x.reshape((-1,) + tuple(x.shape[2:])), y)
            return flat.reshape(tuple(x.shape[:2]) + tuple(flat.shape[1:]))
        if self.norm != 1.0:
            x = x * self.norm
        if self.config.has_edm_batch_norm:
            x = self.net.bnorm.unnormalize(x)
        if self.latent_model:
            x = self._ae_decode(x, y)
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
                return_updates: bool = False, z_eps=None):
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
        A latent model encodes x first (``z_eps``: its posterior draw,
        else drawn from ``generator`` before ε when the autoencoder samples
        its posterior), and a ``MultiSpaceLoss`` compares the denoiser with
        x in the latent space and, decoded, in the pixel space (the pixel
        terms against the data x and ``mask``).
        Dropout, when the network has any, draws from torch's default
        generator of the device. Returns the scalar loss, and with
        ``return_updates`` (loss, updates): the batch norm's running
        statistics after this batch, by state-dict name (the JAX
        package's mutable collection)."""
        x_pixel = x
        if z_eps is None:
            z_eps = self._draw_posterior(x, generator)
        x, y, updates = self.encode(x, y, train=train, z_eps=z_eps)
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
        if self._multi_space is not None:
            raw = self._multi_space.compute_loss(
                denoiser_latent=denoiser, target_latent=x,
                target_pixel=x_pixel, mask_latent=mask,
                mask_pixel=mask)["total"]
            reduces = True          # every term is reduced to a scalar
        else:
            raw = self._loss_metric(denoiser, x, mask)
            reduces = self._loss_metric.reduces_internally or raw.ndim == 0
        if reduces:
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

    def get_score(self, x, sigma, y=None, guidance: float = 1.0,
                  variables=None):
        denoiser, _ = self.get_denoiser(x, sigma, y, guidance,
                                        variables=variables)
        return (denoiser - x) / bcast_right(sigma, x) ** 2

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def sample(self, nsamples: int, shape, generator=None, y=None,
               guidance: float = 1.0, nsteps: int = 100,
               record_history: bool = False,
               maximum_batch_size: int | None = None, integrator=None,
               stochastic: bool = False, langevin_scale=None,
               is_latent_shape: bool = False,
               return_in_latent_space: bool = False, mesh=None):
        """Generate samples from white noise drawn on the model's device
        with ``generator``. ``shape`` is channels-last without the batch
        dim, e.g. (28, 28, 1). ``integrator``: None (the scheduler's, or
        its stochastic one when ``stochastic``), a name ("euler", "heun",
        "euler-maruyama", "karras", "dpmpp2m") or an integrator.
        ``langevin_scale``: a number multiplying the scheduler's Langevin
        gate (stochastic sampling); with ``langevin_const=1`` it is γ.
        ``return_in_latent_space``: the loop's result, not decoded.

        A latent model samples in the latent shape of ``shape`` (a data
        shape; the latent shape itself when ``is_latent_shape``); with
        ``encode_y`` (and not ``is_latent_shape``) y goes through the
        autoencoder's encode first, with zeros for the data, and the
        result is decoded with that y, or with the caller's under
        ``decode_original_y``.

        The draws: x_T, then the loop's noise, one [n, nsamples, *shape]
        tensor for its n noisy steps. On a CUDA device the loop, decode
        included, is the graph of ``compile_sampler``: the draws go into
        its static inputs, ``y`` and ``langevin_scale`` too, and the graph
        is replayed; the samples are a copy of its output. On the CPU the
        loop runs eagerly on the same draws.

        ``mesh`` (a ``DeviceMesh`` with a ``data`` axis; every rank calls):
        data-parallel sampling. Each rank draws the whole batch's x_T and
        noise, as one process does, runs the loop (its graph) on its rows,
        and the rows are all-gathered in rank order, so every rank returns
        the single-process samples; ``nsamples`` must divide the axis."""
        if mesh is not None:
            from diffsci_tpu_torch.parallel.mesh import data_rows
            data_rows(mesh, nsamples)
        if maximum_batch_size is not None:
            outs = [self.sample(n, shape, generator, y, guidance, nsteps,
                                record_history, None, integrator,
                                stochastic, langevin_scale, is_latent_shape,
                                return_in_latent_space, mesh)
                    for n in get_minibatch_sizes(nsamples,
                                                 maximum_batch_size)]
            return torch.cat(outs, dim=1 if record_history else 0)
        y_loop, y_dec = self._sample_conditions(nsamples, shape, y,
                                                is_latent_shape)
        if mesh is not None:
            return self._sample_on_mesh(
                mesh, nsamples, shape, generator, y_loop, y_dec, guidance,
                nsteps, record_history, integrator, stochastic,
                langevin_scale, is_latent_shape, return_in_latent_space)
        if self.device.type != "cuda":
            x, noise, gate = self._draw_inputs(
                self._sampler_inputs(
                    nsamples, self._sample_shape(shape, is_latent_shape),
                    nsteps, integrator, stochastic, langevin_scale),
                generator, langevin_scale)
            return self._sample_loop(
                x, y_loop, y_dec, guidance, nsteps, record_history,
                integrator, stochastic, gate, noise,
                not return_in_latent_space)
        graph = self.compile_sampler(nsamples, shape, y, guidance, nsteps,
                                     record_history, integrator, stochastic,
                                     langevin_scale, is_latent_shape,
                                     return_in_latent_space)
        self._draw_inputs(graph.inputs[:3], generator, langevin_scale)
        graphs.fill(graph.inputs[3], y_loop)
        graphs.fill(graph.inputs[4], y_dec)
        graph.replay()
        return graph.outputs.clone()

    def _sample_on_mesh(self, mesh, nsamples, shape, generator, y_loop,
                        y_dec, guidance, nsteps, record_history, integrator,
                        stochastic, langevin_scale, is_latent_shape,
                        return_in_latent_space):
        """``sample(mesh=...)``'s body: the whole batch's draws, this
        rank's rows through the loop (its CUDA graph on the card), the
        rows gathered."""
        from diffsci_tpu_torch.parallel.mesh import (data_rows, gather_batch,
                                                     rows_of)
        rows = data_rows(mesh, nsamples)
        k = rows.stop - rows.start
        x, noise, gate = self._draw_inputs(
            self._sampler_inputs(
                nsamples, self._sample_shape(shape, is_latent_shape),
                nsteps, integrator, stochastic, langevin_scale),
            generator, langevin_scale)
        x = x[rows]
        noise = None if noise is None else noise[:, rows]
        y_loop = rows_of(y_loop, rows, nsamples)
        y_dec = rows_of(y_dec, rows, nsamples)
        if self.device.type != "cuda":
            out = self._sample_loop(
                x, y_loop, y_dec, guidance, nsteps, record_history,
                integrator, stochastic, gate, noise,
                not return_in_latent_space)
        else:
            graph = self._compile_loop(
                k, shape, y_loop, y_dec, guidance, nsteps, record_history,
                integrator, stochastic, langevin_scale, is_latent_shape,
                return_in_latent_space)
            for static, value in zip(graph.inputs[:2], (x, noise)):
                if static is not None:
                    static.copy_(value)
            if gate is not None:
                graph.inputs[2].copy_(gate)
            graphs.fill(graph.inputs[3], y_loop)
            graphs.fill(graph.inputs[4], y_dec)
            graph.replay()
            out = graph.outputs.clone()
        return gather_batch(out, mesh, dim=1 if record_history else 0)

    def _sample_shape(self, shape, is_latent_shape: bool) -> tuple:
        """The shape (no batch) that a sampler's loop runs in."""
        if is_latent_shape:
            return tuple(shape)
        return self.latent_shape((1,) + tuple(shape))[1:]

    def _sample_conditions(self, nsamples, shape, y, is_latent_shape):
        """(the loop's condition, the decoder's condition or None for the
        loop's): y, unless a latent model with ``encode_y`` encodes it
        (``sample``'s docstring)."""
        if y is None or is_latent_shape or not (
                self.latent_model and self.encode_y):
            return y, None
        x0 = torch.zeros((nsamples,) + tuple(shape), device=self.device)
        _, y_enc, _ = self.encode(x0, y)
        y_enc = dict_map(lambda v: v[0] if v.shape[0] == 1 else v, y_enc)
        return y_enc, (y if self.decode_original_y else None)

    def _sample_loop(self, x, y, y_dec, guidance, nsteps, record_history,
                     integrator, stochastic, gate, noise, decode: bool,
                     variables=None):
        """x_T -> a sample: the loop, then ``decode`` (with ``y_dec`` when
        given, else y) when asked."""
        out = self._propagate_white_noise(
            x, y, guidance, nsteps, record_history, integrator, stochastic,
            gate_scale=gate, noise_seq=noise, variables=variables)
        if not decode:
            return out
        return self.decode(out, y if y_dec is None else y_dec,
                           record_history)

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
                        stochastic: bool = False, langevin_scale=None,
                        is_latent_shape: bool = False,
                        return_in_latent_space: bool = False):
        """The CUDA graph of ``sample``'s loop for (nsamples, shape,
        guidance, nsteps, record_history, y's shapes, the integrator,
        ``stochastic``, whether ``langevin_scale`` is given,
        ``is_latent_shape``, ``return_in_latent_space``, the scheduler's
        ``graph_key()``), as the JAX package's ``_jitted_sampler`` keys
        its executables; not for ``langevin_scale``'s value, which the
        graph reads from a 0-d
        device tensor. Static inputs (``graph.inputs``): x_T, the noise of
        the noisy steps ([n, nsamples, *shape], None for a deterministic
        loop), the Langevin scale, the loop's condition and the decoder's
        (None when it is the loop's). On its first use the loop runs once
        eagerly on the capture stream (the warm-up) and is captured;
        ``SamplerService.warmup`` calls this for every bucket. A loop that
        cannot be captured raises. Returns the ``utils.graphs.Graph``;
        None on the CPU, where nothing is captured."""
        if self.device.type != "cuda":
            return None
        y_loop, y_dec = self._sample_conditions(nsamples, shape, y,
                                                is_latent_shape)
        return self._compile_loop(
            nsamples, shape, y_loop, y_dec, guidance, nsteps, record_history,
            integrator, stochastic, langevin_scale, is_latent_shape,
            return_in_latent_space)

    def _compile_loop(self, nsamples, shape, y_loop, y_dec, guidance,
                      nsteps, record_history, integrator, stochastic,
                      langevin_scale, is_latent_shape,
                      return_in_latent_space):
        """``compile_sampler`` on the loop's and the decoder's conditions
        (``_sample_conditions``)."""
        cache = self._graph_cache()
        key = (nsamples, tuple(shape), _guidance_key(guidance), nsteps,
               record_history, graphs.condition_key(y_loop), integrator,
               stochastic, langevin_scale is not None, is_latent_shape,
               return_in_latent_space, graphs.condition_key(y_dec),
               self.config.noisescheduler.graph_key())
        graph = cache.graphs.get(key)
        if graph is not None:
            return graph
        x, noise, gate = self._sampler_inputs(
            nsamples, self._sample_shape(shape, is_latent_shape), nsteps,
            integrator, stochastic, langevin_scale)
        ys = graphs.static_like(y_loop, self.device)
        yd = graphs.static_like(y_dec, self.device)
        graphs.fill(ys, y_loop)
        graphs.fill(yd, y_dec)

        def loop():
            return self._sample_loop(x, ys, yd, guidance, nsteps,
                                     record_history, integrator, stochastic,
                                     gate, noise, not return_in_latent_space)

        cache.warmup(loop)
        graph = cache.capture(key, loop)
        graph.inputs = (x, noise, gate, ys, yd)
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
        if self.latent_model:
            raise NotImplementedError(
                "sample_parallel operates in the diffusion space; "
                "latent models need sample()")
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
        y's shapes, the scheduler's ``graph_key()``). Static inputs
        (``graph.inputs``): x_T, the noise (or None), None and y's
        tensors; ``graph.picard`` is the ``PicardWindow`` whose state the
        sweep updates in place. None on the CPU."""
        if self.device.type != "cuda":
            return None
        cache = self._graph_cache()
        key = ("picard", nsamples, tuple(shape), _guidance_key(guidance),
               nsteps, window, float(tol), stochastic,
               graphs.condition_key(y),
               self.config.noisescheduler.graph_key())
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
        shape, nsteps, restarts, guidance, y's shapes, the scheduler's
        ``graph_key()``) is replayed with the draws in its static inputs;
        on the CPU the loop runs eagerly on the same draws."""
        if self.latent_model:
            raise NotImplementedError(
                "sample_restart operates in the diffusion space; latent "
                "models need sample()")
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
               _guidance_key(guidance), graphs.condition_key(y),
               sched.graph_key())
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

    def _score(self, y, guidance, x, variables=None):
        """The learned score (x, σ) -> ∇log p with y given a batch dim
        where it has none (``variables``: other weights, by name)."""
        y = dict_expand_dims(y, 0) if _needs_unsqueeze(y, x) else y

        def score_fn(xx, sigma):
            return self.get_score(xx, sigma, y, guidance, variables)

        return score_fn

    def _propagate_white_noise(self, x, y, guidance, nsteps, record_history,
                               integrator, stochastic, gate_scale=None,
                               noise_seq=None, generator=None,
                               variables=None):
        """The sampling loop from unit noise x (``propagate_toward_sample``
        without its inference mode, so that a train step can run it)."""
        x = x * self.config.noisescheduler.maximum_scale
        return self.config.noisescheduler.propagate_backward(
            x, self._score(y, guidance, x, variables), nsteps,
            record_history=record_history, stochastic=stochastic,
            integrator=integrator, noise_seq=noise_seq,
            gate_scale=gate_scale, generator=generator)

    @torch.inference_mode()
    def propagate_white_noise(self, x, y=None, guidance: float = 1.0,
                              nsteps: int = 100,
                              record_history: bool = False, integrator=None,
                              stochastic: bool = False, noise_seq=None,
                              generator=None,
                              return_in_latent_space: bool = False):
        """x is unit white noise (channels-last); scaled to the scheduler's
        maximum scale and integrated to a sample in the diffusion space.
        A pixel model's result is not decoded, as in the JAX package
        (``decode`` maps it back through the batch norm); a latent model's
        is, unless ``return_in_latent_space``. ``noise_seq``
        ([n, *x.shape], n the noisy steps): the stochastic loop's noise,
        else drawn from ``generator`` before the loop."""
        out = self._propagate_white_noise(
            x, y, guidance, nsteps, record_history, integrator, stochastic,
            noise_seq=noise_seq, generator=generator)
        if return_in_latent_space or not self.latent_model:
            return out
        return self.decode(out, y, record_history)

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
                                  autoencoder=None,
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
    and a latent model's autoencoder (``autoencoder: true``: pass the
    bound autoencoder as ``autoencoder``; its weights are not part of the
    diffusion model's state)."""
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
    if description.get("autoencoder") and autoencoder is None:
        raise ValueError(
            "checkpoint is a latent-diffusion model; pass the bound "
            "autoencoder via autoencoder= (its weights are not part of "
            "the diffusion TrainState)")
    net = net_from_description(net_desc,
                               conditional_embedding=conditional_embedding,
                               device=device)
    config = KarrasModelConfig.load_from_description_with_tag(
        description["config_description"])
    return KarrasModel(net, config,
                       conditional=description.get("conditional", False),
                       masked=description.get("masked", False),
                       encode_y=description.get("encode_y", False),
                       autoencoder=autoencoder,
                       device=device, **model_kwargs)
