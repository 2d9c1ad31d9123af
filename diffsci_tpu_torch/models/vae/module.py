"""The VAE runtime: the configuration, the autoencoder with its output
log-variance, encode and decode, the training loss (NLL with the learned
or fixed variance, KL, total variation, teacher distillation, the edge
loss preprocessor), the PatchGAN discriminator, the train step that
updates the autoencoder and the discriminator together, the KL weight's
annealing, and ``BoundAutoencoder``, the adapter a latent
``KarrasModel`` takes.

Port of ``diffsci_tpu/models/vae/module.py``. The weights live in
``VAEModel.net`` (an ``nn.Module``: ``autoencoder.*`` and, when
trainable, ``logvar``) and ``VAEModel.discriminator``, so the methods
take no ``variables``; randomness is an explicit ``torch.Generator``.
Tensors are [B, C, *spatial].

The train step (``make_vae_train_step``) takes the autoencoder's step
(loss, backward, NaN→0 on its gradients, clip, AdamW), then the
discriminator's on the same reconstruction (not NaN-guarded, as in the
JAX package), whose update is kept only where the discriminator's
accuracy is below ``discriminator_threshold`` and the step count is a
multiple of ``discriminator_frequency``: both gates are device values, so
the step reads nothing back to the host. A gated step still advances the
discriminator's Adam moments and count, and moves none of its weights,
weight decay included, as optax's update multiplied by the gate does. On
a CUDA device the step is a CUDA graph per (x's shape and dtype, y's
shapes, the optimizers, the configuration's numbers): the z-noise is
drawn into its static input before each replay, and the KL weight is a
0-d device tensor filled from ``config.kl_weight`` before each step, so
``KLAnnealing`` needs no new graph.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Literal

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.models.karras.train import (AdamWClip, _capturable,
                                                   batch_like,
                                                   check_placement,
                                                   keep_rows, synced_norm)
from diffsci_tpu_torch.models.nets.layers import init_parameters
from diffsci_tpu_torch.models.nets.vae import DiagonalGaussianDistribution
from diffsci_tpu_torch.ops.losses import huber as huber_loss
from diffsci_tpu_torch.ops.preprocessors import make_loss_preprocessor
from diffsci_tpu_torch.utils import graphs, resolve_device

_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)


class VAEModelConfig:
    """The VAE's training configuration (the JAX package's fields and
    defaults)."""

    def __init__(self,
                 kl_weight: float = 1e-3,
                 nll_weight: float = 1.0,
                 logvar_init: float = 0.0,
                 trainable_logvar: bool = False,
                 reduce_mean: bool = True,
                 teacher=None,
                 teaching_mode: str = "both",
                 distillation_alpha: float = 0.5,
                 latent_matching_type: str = "wasserstein",
                 adversarial_weight: float = 0.01,
                 reconstruction_loss: Literal["mse", "huber"] = "huber",
                 discriminator_frequency: int = 1,
                 discriminator_threshold: float = 0.85,
                 label_smoothing: float = 0.1,
                 total_variation_weight: float = 0.0,
                 kl_threshold: float | None = None,
                 loss_preprocessor="none",
                 loss_preprocessor_dim: int = 2):
        if latent_matching_type not in ("kl", "mse", "modhell",
                                        "wasserstein"):
            raise ValueError(f"latent_matching_type {latent_matching_type!r}")
        if teaching_mode not in ("both", "encoder", "decoder"):
            raise ValueError(f"teaching_mode {teaching_mode!r}")
        self.kl_weight = kl_weight
        self.nll_weight = nll_weight
        self.logvar_init = logvar_init
        self.trainable_logvar = trainable_logvar
        self.reduce_mean = reduce_mean
        self.teacher = teacher
        self.teaching_mode = teaching_mode
        self.distillation_alpha = distillation_alpha
        self.latent_matching_type = latent_matching_type
        self.adversarial_weight = adversarial_weight
        self.reconstruction_loss = reconstruction_loss
        self.discriminator_frequency = discriminator_frequency
        self.discriminator_threshold = discriminator_threshold
        self.label_smoothing = label_smoothing
        self.total_variation_weight = total_variation_weight
        self.kl_threshold = kl_threshold
        self.loss_preprocessor = loss_preprocessor
        self.loss_preprocessor_dim = loss_preprocessor_dim

    @property
    def has_distillation(self):
        return self.teacher is not None

    @property
    def distillation_training_only(self):
        return self.has_distillation and self.distillation_alpha == 1.0


def total_variation(x):
    """Anisotropic total variation per item of x [B, C, *spatial]: the sum
    of |differences| along every spatial axis, [B]."""
    tv = 0.0
    for dim in range(2, x.ndim):
        diff = (x.narrow(dim, 1, x.shape[dim] - 1)
                - x.narrow(dim, 0, x.shape[dim] - 1)).abs()
        tv = tv + diff.sum(dim=tuple(range(1, diff.ndim)))
    return tv


def _recon_fn(kind: str):
    if kind == "mse":
        return lambda a, b: (a - b) ** 2
    if kind == "huber":
        return huber_loss
    raise ValueError(f"Reconstruction loss {kind} not supported")


def _same_pad(x, k: int, stride: int):
    """x padded with zeros as flax's SAME pads a k-wide, ``stride``-strided
    convolution: out = ceil(n / stride) per axis, total − total//2 of the
    padding after."""
    pads = []
    for n in reversed(x.shape[2:]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class NLayerDiscriminator(nn.Module):
    """The PatchGAN discriminator of VAE training, for 1D, 2D or 3D
    [B, C, *spatial]: a 4^d conv of stride 2 to ``ndf`` and a leaky ReLU
    (0.2), ``n_layers − 1`` more of stride 2 (no bias, GroupNorm with
    min(32, width) groups and eps 1e-6) doubling the width up to 8·ndf,
    one of stride 1 likewise, then a 4^d conv of stride 1 to one logit a
    patch; every convolution SAME-padded as flax pads it. ``in_channels``
    counts the data's channels and, for a conditional model, those of the
    condition y [B, Cy], which is broadcast over the positions and
    concatenated."""

    def __init__(self, ndf: int = 64, n_layers: int = 3,
                 in_channels: int = 1, dimension: int = 2,
                 device: torch.device | str | None = None):
        super().__init__()
        self.ndf, self.n_layers = ndf, n_layers
        conv = _CONVS[dimension - 1]
        widths = [in_channels, ndf] + [ndf * min(2 ** n, 8)
                                       for n in range(1, n_layers + 1)]
        self.strides = [2] * n_layers + [1, 1]
        widths.append(1)
        self.convs = nn.ModuleList(
            conv(widths[i], widths[i + 1], 4, stride=stride,
                 bias=i in (0, n_layers + 1))
            for i, stride in enumerate(self.strides))
        self.norms = nn.ModuleList(
            nn.GroupNorm(min(32, w), w, eps=1e-6) for w in widths[2:-1])
        self.to(resolve_device(device))

    def forward(self, x, y=None):
        if y is not None:
            yc = y["y"] if isinstance(y, dict) else y
            yc = yc.reshape(yc.shape[:2] + (1,) * (x.ndim - 2))
            x = torch.cat([x, yc.expand(-1, -1, *x.shape[2:])], dim=1)
        h = x
        for i, conv in enumerate(self.convs):
            h = conv(_same_pad(h, 4, self.strides[i]))
            if i == len(self.convs) - 1:
                return h
            if i > 0:
                h = self.norms[i - 1](h)
            h = F.leaky_relu(h, 0.2)


class _VAENetWithLogvar(nn.Module):
    """The autoencoder (``autoencoder.*``) and the output log-variance
    (the parameter ``logvar`` [1] when trainable, else the constant
    ``logvar_init``)."""

    def __init__(self, autoencoder: nn.Module, logvar_init: float = 0.0,
                 trainable_logvar: bool = False):
        super().__init__()
        self.autoencoder = autoencoder
        self.logvar_init = logvar_init
        if trainable_logvar:
            self.logvar = nn.Parameter(torch.full((1,), float(logvar_init)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if isinstance(getattr(self, "logvar", None), nn.Parameter):
            with torch.no_grad():
                self.logvar.fill_(self.logvar_init)

    def get_logvar(self, device=None):
        """The log-variance [1] (the constant on ``device``)."""
        if isinstance(getattr(self, "logvar", None), nn.Parameter):
            return self.logvar
        return torch.full((1,), float(self.logvar_init), device=device)

    def encode_moments(self, x):
        if hasattr(self.autoencoder, "encode_moments"):
            return self.autoencoder.encode_moments(x)
        return self.autoencoder.quant_conv(self.autoencoder.encoder(x))

    def decode(self, z):
        return self.autoencoder.decode(z)

    def forward(self, x, generator=None, eps=None):
        post = DiagonalGaussianDistribution(self.encode_moments(x))
        z = post.sample(generator, eps) \
            if generator is not None or eps is not None else post.mode()
        return self.decode(z), post


class VAEModel:
    """A KL-VAE around an ``AutoencoderKL``- or ``VAENet``-like network
    (and, for adversarial training, a discriminator such as
    ``NLayerDiscriminator``), on ``device`` (default: the CUDA card)."""

    def __init__(self, autoencoder: nn.Module, config: VAEModelConfig,
                 conditional: bool = False,
                 discriminator: nn.Module | None = None,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.config = config
        self.conditional = conditional
        self.discriminator = None if discriminator is None else \
            discriminator.to(self.device)
        self.is_adversarial = config.adversarial_weight > 0.0 and \
            discriminator is not None
        self.net = _VAENetWithLogvar(
            autoencoder, config.logvar_init,
            config.trainable_logvar).to(self.device).eval()
        self._recon = _recon_fn(config.reconstruction_loss)
        self._pre = make_loss_preprocessor(config.loss_preprocessor,
                                           config.loss_preprocessor_dim)
        self._latent_shapes: dict = {}

    def init(self, seed: int = 0) -> dict:
        """Draw every weight from ``seed`` (device-independent); returns
        the state dict."""
        init_parameters(self.net, seed)
        return self.net.state_dict()

    def init_discriminator(self, seed: int = 1) -> dict:
        """Draw the discriminator's weights from ``seed``; returns its
        state dict."""
        init_parameters(self.discriminator, seed)
        return self.discriminator.state_dict()

    def latent_shape(self, x_shape) -> tuple:
        """The shape [B, c, *latent] of the posterior's mean for data of
        ``x_shape`` (found once per shape by encoding zeros of one
        item)."""
        x_shape = tuple(x_shape)
        probe = self._latent_shapes.get(x_shape[1:])
        if probe is None:
            with torch.no_grad():
                m = self.net.encode_moments(torch.zeros(
                    (1,) + x_shape[1:], device=self.device))
            probe = (m.shape[1] // 2,) + tuple(m.shape[2:])
            self._latent_shapes[x_shape[1:]] = probe
        return x_shape[:1] + probe

    def encode(self, x, generator=None, eps=None, train: bool = False):
        """{"zdistrib": the posterior, "zsample": a draw from it (from
        ``generator``, or ``eps`` replayed) or, with neither, its mode}."""
        self.net.train(train)
        post = DiagonalGaussianDistribution(self.net.encode_moments(x))
        if generator is not None or eps is not None:
            z = post.sample(generator, eps)
        else:
            z = post.mode()
        return {"zdistrib": post, "zsample": z}

    def decode(self, z, train: bool = False):
        self.net.train(train)
        return self.net.decode(z)

    # ------------------------------------------------------------------
    def loss_fn(self, x, y=None, train: bool = True, eps=None,
                generator=None, kl_weight=None):
        """The VAE loss of x: nll_weight·NLL (the reconstruction metric of
        the preprocessed x and reconstruction, over exp(logvar), plus
        logvar; a mean, or a sum over the batch size without
        ``reduce_mean``) + kl_weight·KL (per item, thresholded per latent
        channel with ``kl_threshold``) + total_variation_weight·TV, then
        mixed with the teacher's distillation loss by
        ``distillation_alpha`` (the distillation loss alone at 1). The
        posterior sample's unit noise is ``eps`` (the latent's shape), or
        one draw from ``generator`` that every sample of this loss shares,
        the teacher's too, as the JAX package's one key does.
        ``kl_weight`` (a float or a 0-d tensor) stands in for the
        configuration's. Returns (loss, logs); logs hold ``x_recon``
        except in distillation-only training."""
        cfg = self.config
        drawn = []

        def unit_noise(mean):
            if eps is not None:
                return eps
            if not drawn:
                drawn.append(torch.randn(mean.shape, generator=generator,
                                         dtype=mean.dtype,
                                         device=mean.device))
            return drawn[0]

        if cfg.distillation_training_only:
            return self._distillation_loss(x, None, None, train, unit_noise)
        self.net.train(train)
        zdistrib = DiagonalGaussianDistribution(self.net.encode_moments(x))
        x_recon = self.net.decode(zdistrib.sample(
            eps=unit_noise(zdistrib.mean)))
        logvar = self.net.get_logvar(x.device)
        rec = self._recon(self._pre(x), self._pre(x_recon))
        nll = rec / torch.exp(logvar) + logvar
        nsamples = x.shape[0]
        if cfg.reduce_mean:
            nll_loss = nll.mean()
            kl = zdistrib.kl(reduce_mean=True)
        else:
            nll_loss = nll.sum() / nsamples
            kl = zdistrib.kl(reduce_mean=False)
        if cfg.kl_threshold is not None:
            kl = zdistrib.kl_thresholded(threshold=cfg.kl_threshold)
        kl_loss = kl.sum() / nsamples
        kl_w = cfg.kl_weight if kl_weight is None else kl_weight
        main = cfg.nll_weight * nll_loss + kl_w * kl_loss
        loss = main
        logs = {"nll_loss": nll_loss, "kl_loss": kl_loss, "main_loss": main,
                "logvar": logvar[0]}
        if cfg.total_variation_weight > 0.0:
            tv_loss = self._recon(total_variation(x_recon),
                                  total_variation(x)).mean()
            loss = loss + cfg.total_variation_weight * tv_loss
            logs["tv_loss"] = tv_loss
        if cfg.has_distillation:
            dloss, dlogs = self._distillation_loss(x, zdistrib, x_recon,
                                                   train, unit_noise)
            loss = ((1 - cfg.distillation_alpha) * loss
                    + cfg.distillation_alpha * dloss)
            logs.update(dlogs)
        return loss, {**logs, "x_recon": x_recon}

    def _latent_matching(self, zdistrib, teacher_z):
        cfg = self.config
        if cfg.latent_matching_type == "kl":
            val = zdistrib.kl(teacher_z, reduce_mean=cfg.reduce_mean)
        elif cfg.latent_matching_type == "modhell":
            val = zdistrib.modified_hellinger(teacher_z,
                                              reduce_mean=cfg.reduce_mean)
        else:  # mse / wasserstein
            val = zdistrib.wasserstein(teacher_z,
                                       reduce_mean=cfg.reduce_mean)
        return val.mean()

    def _distillation_loss(self, x, zdistrib, x_recon, train, unit_noise):
        """The teacher's terms: ``config.teacher`` has ``encode_moments(x)``
        and ``decode(z)`` over frozen weights ([B, C, *spatial]), run
        without gradients. "decoder": the student decodes the teacher's
        latent mode against the teacher's decode of it; "encoder": the
        posteriors matched (``latent_matching_type``); "both": both, the
        teacher's latent sampled with the student's unit noise."""
        cfg = self.config
        teacher = cfg.teacher
        zero = torch.zeros((), device=x.device)
        latent_loss = output_loss = zero
        nsamples = x.shape[0]

        def reduce(r):
            return r.mean() if cfg.reduce_mean else r.sum() / nsamples

        with torch.no_grad():
            tz = DiagonalGaussianDistribution(teacher.encode_moments(x))
        if cfg.teaching_mode == "decoder":
            z = tz.mode()
            student = self.decode(z, train=train)
            with torch.no_grad():
                teacher_rec = teacher.decode(z)
            output_loss = reduce(self._recon(self._pre(student),
                                             self._pre(teacher_rec)))
        elif cfg.teaching_mode == "encoder":
            if zdistrib is None:
                zdistrib = self.encode(x, train=train)["zdistrib"]
            latent_loss = self._latent_matching(zdistrib, tz)
        else:  # both
            if zdistrib is None:
                self.net.train(train)
                zdistrib = DiagonalGaussianDistribution(
                    self.net.encode_moments(x))
                x_recon = self.net.decode(zdistrib.sample(
                    eps=unit_noise(zdistrib.mean)))
            with torch.no_grad():
                teacher_rec = teacher.decode(tz.sample(
                    eps=unit_noise(tz.mean)))
            latent_loss = self._latent_matching(zdistrib, tz)
            output_loss = reduce(self._recon(self._pre(x_recon),
                                             self._pre(teacher_rec)))
        return latent_loss + output_loss, {
            "latent_space_matching_loss": latent_loss,
            "output_matching_loss": output_loss}


@dataclasses.dataclass
class VAETrainState:
    """The autoencoder's parameters (``VAEModel.net``'s, by name) and
    optimizer, the discriminator's (or None), the steps taken (on the
    host, and as ``counter``, a 0-d device tensor the frequency gate
    reads), the network's buffers by name, and on a CUDA device the step's
    CUDA graphs (a ``utils.graphs.GraphCache``), the autoencoder's network
    the parameters belong to (``module``), and its layout over a mesh
    (``placement``, set by ``parallel.replicate`` or
    ``parallel.shard_state_tensor_parallel``; None on one process)."""
    params: dict
    optimizer: torch.optim.Optimizer
    disc_params: dict | None
    disc_optimizer: torch.optim.Optimizer | None
    counter: torch.Tensor
    step: int = 0
    buffers: dict = dataclasses.field(default_factory=dict)
    graphs: graphs.GraphCache | None = dataclasses.field(
        default=None, repr=False, compare=False)
    module: nn.Module | None = dataclasses.field(default=None, repr=False,
                                                 compare=False)
    placement: object = dataclasses.field(default=None, repr=False,
                                          compare=False)
    # read as a Karras TrainState's by the placement and checkpoint code
    ema = None
    accum = None


# what AdamWClip.update reads of a state
_Update = collections.namedtuple("_Update", "optimizer accum")


def generator_adversarial_loss(disc: nn.Module, x_recon, y=None):
    """The autoencoder's adversarial term: the mean BCE of the
    discriminator's logits of the reconstruction against "real" (1),
    through frozen discriminator weights (gradients reach x_recon only)."""
    frozen = {k: v.detach() for k, v in disc.named_parameters()}
    frozen.update(disc.named_buffers())
    fake = torch.func.functional_call(disc, frozen, (x_recon, y))
    return F.binary_cross_entropy_with_logits(fake, torch.ones_like(fake))


def discriminator_loss(disc: nn.Module, x, x_fake, y=None,
                       label_smoothing: float = 0.1):
    """(the discriminator's loss, its accuracy): the mean of the
    label-smoothed BCE of its logits of the data against 1 − s and of the
    reconstruction against s, and the mean of its right calls (real
    logits > 0, fake < 0)."""
    real, fake = disc(x, y), disc(x_fake, y)
    real_l = F.binary_cross_entropy_with_logits(
        real, torch.full_like(real, 1 - label_smoothing))
    fake_l = F.binary_cross_entropy_with_logits(
        fake, torch.full_like(fake, label_smoothing))
    acc = 0.5 * ((real > 0).float().mean() + (fake < 0).float().mean())
    return 0.5 * (real_l + fake_l), acc


def default_vae_optimizer(learning_rate: float = 1e-4,
                          grad_clip: float = 1.0) -> AdamWClip:
    """AdamW (optax's defaults: weight decay 1e-4, betas (0.9, 0.999), eps
    1e-8) after clipping by global norm 1.0: the VAE + GAN path is spiky,
    and without the clip the autoencoder diverges within a few steps."""
    return AdamWClip(learning_rate, 1e-4, 0.9, 0.999, grad_clip)


def create_vae_train_state(model: VAEModel, x_shape=None,
                           seed: int | None = 0,
                           optimizer: AdamWClip | None = None,
                           disc_optimizer: AdamWClip | None = None):
    """Initialise the autoencoder's weights from ``seed`` and the
    discriminator's from ``seed + 1`` (None keeps the current weights),
    and both optimizers (``default_vae_optimizer()`` by default).
    ``x_shape`` ([B, C, *spatial]), when given, is checked against the
    network's input channels. Returns (state, tx, dtx); dtx is None
    without adversarial training."""
    ae = model.net.autoencoder
    cfg = getattr(ae, "config", None)
    in_ch = getattr(cfg, "in_channels", None)
    if x_shape is not None and in_ch is not None and x_shape[1] != in_ch:
        raise ValueError(f"x_shape {tuple(x_shape)} is not [B, {in_ch}, "
                         "*spatial]")
    tx = optimizer if optimizer is not None else default_vae_optimizer()
    if tx.every != 1 or tx.schedule_free:
        raise ValueError("the VAE step takes plain AdamW, one update a step")
    if seed is not None:
        model.init(seed)
    params = dict(model.net.named_parameters())
    disc_params = disc_opt = dtx = None
    if model.is_adversarial:
        dtx = disc_optimizer if disc_optimizer is not None \
            else default_vae_optimizer()
        if seed is not None:
            model.init_discriminator(seed + 1)
        disc_params = dict(model.discriminator.named_parameters())
        disc_opt = dtx.init(disc_params)
    state = VAETrainState(
        params=params, optimizer=tx.init(params), disc_params=disc_params,
        disc_optimizer=disc_opt,
        counter=torch.zeros((), dtype=torch.int64, device=model.device),
        buffers=dict(model.net.named_buffers()), module=model.net)
    return state, tx, dtx


def _config_key(cfg: VAEModelConfig) -> tuple:
    """The configuration's numbers a captured step bakes in: all but the
    KL weight, which the step reads from a device tensor."""
    return tuple((k, v) for k, v in sorted(vars(cfg).items())
                 if k != "kl_weight" and (v is None or isinstance(
                     v, (bool, int, float, str)))) + (id(cfg.teacher),)


def make_vae_train_step(model: VAEModel, tx: AdamWClip,
                        dtx: AdamWClip | None = None, _raw: bool = False):
    """The train step ``step(state, x, y=None, generator=None, eps=None)
    -> (state, metrics)`` (module docstring): the z-noise ε (the latent's
    shape) drawn from ``generator`` unless replayed by ``eps``; the
    autoencoder's loss plus adversarial_weight times the generator's BCE
    against "real" on the discriminator's logits of the reconstruction;
    backward, NaN/±inf → 0, clip, AdamW; then the discriminator's
    label-smoothed BCE on the data and the detached reconstruction,
    backward, clip, AdamW, kept where the gates pass. ``metrics``:
    ``train_loss`` and the loss's logs (``nll_loss``, ``kl_loss``,
    ``main_loss``, ``logvar``, ...), and with a discriminator
    ``gen_adversarial_loss``, ``discriminator_loss``, ``d_accuracy`` and
    ``disc_updated`` (the gate, 0 or 1), all device tensors. ``state`` is
    updated in place and returned. ``_raw=True`` returns the eager
    step.

    Over a mesh (a state ``parallel.replicate`` placed) x is this rank's
    rows, ε is the global batch's of which it keeps its rows, both
    networks' gradients are the global batch's mean before the guard and
    clip, the discriminator's gate reads the global accuracy, and the
    metrics are the mean over the ranks. A spatially sharded state
    raises. The step is a CUDA graph on the card, eager over gloo."""
    cfg = model.config
    adversarial = model.is_adversarial
    if adversarial and dtx is None:
        raise ValueError("adversarial training needs the discriminator's "
                         "optimizer (dtx)")
    disc = model.discriminator

    def update(state: VAETrainState, x, y, eps, kl_weight):
        """Both updates from fixed draws: device work only, which the
        graphed step captures. Returns the metrics."""
        for p in state.params.values():
            p.grad = None
        loss, logs = model.loss_fn(x, y, train=True, eps=eps,
                                   kl_weight=kl_weight)
        x_recon = logs.pop("x_recon", None)
        y_disc = y if model.conditional else None
        if adversarial:
            if x_recon is None:
                raise ValueError("adversarial training needs the "
                                 "reconstruction (distillation_alpha < 1)")
            g_adv = generator_adversarial_loss(disc, x_recon, y_disc)
            loss = loss + cfg.adversarial_weight * g_adv
            logs["gen_adversarial_loss"] = g_adv
        loss.backward()
        placed = state.placement
        tx.update(_Update(state.optimizer, None),
                  synced_norm(placed, state.params))

        def logged(v):
            v = v.detach()
            return v if placed is None or v.numel() != 1 else \
                placed.mean_over_ranks(v)
        if adversarial:
            for p in state.disc_params.values():
                p.grad = None
            d_loss, d_acc = discriminator_loss(disc, x, x_recon.detach(),
                                               y_disc, cfg.label_smoothing)
            d_loss.backward()
            # the gate reads the global batch's accuracy
            d_acc = logged(d_acc)
            gate = ((d_acc < cfg.discriminator_threshold)
                    & (state.counter % cfg.discriminator_frequency == 0))
            dparams = list(state.disc_params.values())
            with torch.no_grad():
                before = [p.detach().clone() for p in dparams]
                dtx.update(_Update(state.disc_optimizer, None),
                           synced_norm(placed, state.disc_params,
                                       nan_guard=False))
                for p, old in zip(dparams, before):
                    p.copy_(torch.where(gate, p, old))
            logs.update({"discriminator_loss": d_loss.detach(),
                         "d_accuracy": d_acc, "disc_updated": gate.float()})
        with torch.no_grad():
            state.counter.add_(1)
        return {"train_loss": logged(loss),
                **{k: logged(v) for k, v in logs.items()}}

    def begin(state: VAETrainState) -> None:
        tx.set_learning_rate(state.optimizer, state.step)
        if adversarial:
            dtx.set_learning_rate(state.disc_optimizer, state.step)

    def draw(state, x, generator, eps, out):
        """The z-noise into ``out`` (the global batch's over a mesh, of
        which ``out`` takes this rank's rows), drawn or replayed."""
        n, i = (1, 0) if state.placement is None else \
            state.placement.batch_shards()
        whole = out if n == 1 else torch.empty(
            model.latent_shape(batch_like(x, n).shape), dtype=out.dtype,
            device=out.device)
        if eps is None:
            torch.randn(whole.shape, generator=generator, out=whole)
        else:
            whole.copy_(eps)
        return out if n == 1 else keep_rows(out, whole, i)

    def raw_step(state: VAETrainState, x, y=None, generator=None, eps=None):
        check_placement(state, "make_vae_train_step")
        eps = draw(state, x, generator, eps, torch.empty(
            model.latent_shape(x.shape), dtype=x.dtype, device=x.device))
        begin(state)
        metrics = update(state, x, y, eps, None)
        state.step += 1
        return state, metrics

    if _raw:
        return raw_step

    def train_step(state: VAETrainState, x, y=None, generator=None,
                   eps=None):
        if x.device.type != "cuda" or not _capturable(state):
            return raw_step(state, x, y, generator, eps)
        check_placement(state, "make_vae_train_step")
        if state.graphs is None:
            state.graphs = graphs.GraphCache(x.device)
        cache = state.graphs
        begin(state)
        key = ("vae", tuple(x.shape), x.dtype, graphs.condition_key(y),
               state.optimizer, state.disc_optimizer, tx, dtx,
               _config_key(cfg), state.placement)
        graph = cache.graphs.get(key)
        if graph is None:
            inputs = (torch.empty_like(x), graphs.static_like(y, x.device),
                      torch.empty(model.latent_shape(x.shape),
                                  dtype=x.dtype, device=x.device),
                      torch.empty((), device=x.device))
        else:
            inputs = graph.inputs
        xs, ys, epss, kl_w = inputs
        xs.copy_(x)
        graphs.fill(ys, y)
        draw(state, x, generator, eps, epss)
        kl_w.fill_(float(cfg.kl_weight))
        if graph is None:
            def body():
                return update(state, *inputs)

            metrics = cache.warmup(body)
            cache.capture(key, body).inputs = inputs
        else:
            graph.replay()
            metrics = {k: v.clone() for k, v in graph.outputs.items()}
        state.step += 1
        return state, metrics

    return train_step


class KLAnnealing:
    """The KL weight's linear warm-up from ``start`` to ``end`` over
    ``num_epochs``: ``on_epoch(epoch)`` sets ``config.kl_weight`` and
    returns it. The train step reads the new weight at its next call,
    graphed or not."""

    def __init__(self, config: VAEModelConfig, start: float, end: float,
                 num_epochs: int):
        self.config = config
        self.start = start
        self.end = end
        self.num_epochs = num_epochs

    def on_epoch(self, epoch: int):
        t = min(epoch / max(self.num_epochs, 1), 1.0)
        self.config.kl_weight = self.start + t * (self.end - self.start)
        return self.config.kl_weight


class BoundAutoencoder:
    """A trained VAE as the autoencoder a latent ``KarrasModel`` takes:
    ``encode(x, y=None, eps=None)`` → z·``scale_factor`` and
    ``decode(z, y=None)`` → the decoder of z/``scale_factor``, on
    [B, C, *spatial] tensors. With ``sample_posterior`` and a unit draw
    ``eps`` of the latent's shape z is a posterior sample, else the
    posterior's mode; a ``KarrasModel`` draws ``eps`` itself, before any
    graph it captures. ``variables``: a state dict loaded into the VAE's
    network first. Binding puts the network in eval mode and freezes its
    parameters (``requires_grad`` False): they are constants of the
    diffusion model, as in the JAX package; gradients still flow through
    ``decode`` to its input."""

    def __init__(self, model: VAEModel, variables: dict | None = None,
                 scale_factor: float = 1.0, sample_posterior: bool = True):
        self.model = model
        if variables is not None:
            model.net.load_state_dict(variables, strict=True)
        model.net.eval().requires_grad_(False)
        self.scale_factor = scale_factor
        self.sample_posterior = sample_posterior

    def encode(self, x, y=None, eps=None, generator=None):
        with torch.no_grad():
            post = DiagonalGaussianDistribution(
                self.model.net.encode_moments(x))
            if self.sample_posterior and (eps is not None
                                          or generator is not None):
                z = post.sample(generator, eps)
            else:
                z = post.mode()
        return z * self.scale_factor

    def decode(self, z, y=None):
        return self.model.net.decode(z / self.scale_factor)
