"""The VAE runtime, the half that latent diffusion needs: the
configuration, the autoencoder with its output log-variance, encode and
decode, and ``BoundAutoencoder``, the adapter a latent ``KarrasModel``
takes.

Port of ``diffsci_tpu/models/vae/module.py:28-79, 135-219, 469-487``. The
weights live in ``VAEModel.net`` (an ``nn.Module``: ``autoencoder.*`` and,
when trainable, ``logvar``), so the methods take no ``variables``.
Tensors are [B, C, *spatial]. Training a VAE is not ported yet:
``VAEModel.loss_fn``, ``NLayerDiscriminator``,
``create_vae_train_state``, ``make_vae_train_step``, ``KLAnnealing`` and
``loss_preprocessor='edges'`` raise NotImplementedError.
"""

from __future__ import annotations

from typing import Literal

import torch
import torch.nn as nn

from diffsci_tpu_torch.models.nets.layers import init_parameters
from diffsci_tpu_torch.models.nets.vae import DiagonalGaussianDistribution
from diffsci_tpu_torch.utils import resolve_device

_NOT_PORTED = "VAE training is not ported yet"


class VAEModelConfig:
    """The VAE's training configuration (the JAX package's fields; only
    ``logvar_init``, ``trainable_logvar`` and ``loss_preprocessor`` act on
    the ported half)."""

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

    def get_logvar(self):
        if isinstance(getattr(self, "logvar", None), nn.Parameter):
            return self.logvar
        return torch.full((1,), float(self.logvar_init))

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
    """A KL-VAE around an ``AutoencoderKL``-like network, on ``device``
    (default: the CUDA card). ``discriminator`` and ``conditional`` are
    kept for the training half, which is not ported."""

    def __init__(self, autoencoder: nn.Module, config: VAEModelConfig,
                 conditional: bool = False,
                 discriminator: nn.Module | None = None,
                 device: torch.device | str | None = None):
        if config.loss_preprocessor not in ("none", None):
            raise NotImplementedError(
                f"loss_preprocessor={config.loss_preprocessor!r} is not "
                "ported yet")
        self.device = resolve_device(device)
        self.config = config
        self.conditional = conditional
        self.discriminator = discriminator
        self.is_adversarial = config.adversarial_weight > 0.0 and \
            discriminator is not None
        self.net = _VAENetWithLogvar(
            autoencoder, config.logvar_init,
            config.trainable_logvar).to(self.device).eval()

    def init(self, seed: int = 0) -> dict:
        """Draw every weight from ``seed`` (device-independent); returns
        the state dict."""
        init_parameters(self.net, seed)
        return self.net.state_dict()

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

    def loss_fn(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)

    def init_discriminator(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)


class NLayerDiscriminator:
    """The PatchGAN discriminator of VAE training (not ported yet)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)


class KLAnnealing:
    """The KL weight's schedule of VAE training (not ported yet)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)


def create_vae_train_state(*args, **kwargs):
    raise NotImplementedError(_NOT_PORTED)


def make_vae_train_step(*args, **kwargs):
    raise NotImplementedError(_NOT_PORTED)


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
