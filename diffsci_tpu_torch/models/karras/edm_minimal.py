"""The minimal EDM model: the lighter twin of ``KarrasModel`` with the EDM
coefficients inline (kept for API parity; ``KarrasModel`` with
``KarrasModelConfig.from_edm()`` is the full runtime).

Port of ``diffsci_tpu/models/karras/edm_minimal.py``: ``EDMModelConfig``
(the EDM closed forms and the σ grid of the torch reference's
``EDMModule``, ``create_sigma_steps``) and ``EDMModel``: ``init``,
``evaluate_denoiser``, ``loss_fn`` (with an ``eps`` replay hook),
``integrate_probability_flow`` (Heun over the grid, Euler into σ = 0)
and ``sample``. Samples are channels-last; the network (``net``, whose
state dict is the JAX package's variables') runs on [B, C, *spatial].
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from diffsci_tpu_torch.models.nets.layers import init_parameters
from diffsci_tpu_torch.ops.batchnorm import (ConstantBatchNorm,
                                             IdentityBatchNorm)
from diffsci_tpu_torch.ops.losses import huber as huber_loss
from diffsci_tpu_torch.utils import bcast_right, resolve_device


class EDMModelConfig:
    """The EDM preconditioning (σ_data), the log-normal training σ, the
    ρ-grid and the loss metric ("mse" or "huber"); ``initial_norm``: a
    number divides the data by it, False leaves them."""

    def __init__(self,
                 initial_norm: bool | float = False,
                 loss_metric: Literal["mse", "huber"] = "huber",
                 sigma_data: float = 0.5,
                 prior_mean: float = -1.2,
                 prior_std: float = 1.2,
                 sigma_min: float = 0.002,
                 sigma_max: float = 80.0,
                 exponent_steps: float = 7.0):
        self.initial_norm = initial_norm
        self.loss_metric = loss_metric
        self.sigma_data = sigma_data
        self.prior_mean = prior_mean
        self.prior_std = prior_std
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max
        self.exponent_steps = exponent_steps

    def loss_weighting(self, sigma):
        return (sigma ** 2 + self.sigma_data ** 2) / (
            (sigma * self.sigma_data) ** 2)

    def noise_conditioner(self, sigma):
        return 0.5 * torch.log(sigma)

    def input_scaling(self, sigma):
        return 1.0 / torch.sqrt(sigma ** 2 + self.sigma_data ** 2)

    def output_scaling(self, sigma):
        return sigma * self.sigma_data / torch.sqrt(sigma ** 2
                                                    + self.sigma_data ** 2)

    def skip_scaling(self, sigma):
        return self.sigma_data ** 2 / (sigma ** 2 + self.sigma_data ** 2)

    def sample_sigma(self, shape, generator=None, device=None):
        """exp of a normal(prior_mean, prior_std) draw."""
        logsigma = torch.randn(shape, generator=generator, device=device) \
            * self.prior_std + self.prior_mean
        return torch.exp(logsigma)

    def create_sigma_steps(self, n: int) -> np.ndarray:
        """n points of the ρ-grid from σ_max toward σ_min (the last one
        short of it, as the reference's), + 1e-6, in float64."""
        rho = self.exponent_steps
        s = np.arange(n, dtype=np.float64) / n
        start = self.sigma_max ** (1 / rho)
        end = self.sigma_min ** (1 / rho)
        return (start + s * (end - start)) ** rho + 1e-6


class EDMModel:
    """A network ``model(x, t, y=None)`` on [B, C, *spatial] under the EDM
    preconditioning, on ``device`` (default: the CUDA card)."""

    def __init__(self, model: torch.nn.Module, config: EDMModelConfig,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.config = config
        self.net = model.to(self.device).eval()
        if isinstance(config.initial_norm, (int, float)) \
                and not isinstance(config.initial_norm, bool):
            self.initial_norm = ConstantBatchNorm(float(config.initial_norm))
        else:
            self.initial_norm = IdentityBatchNorm()
        self._loss = ((lambda a, b: (a - b) ** 2)
                      if config.loss_metric == "mse" else huber_loss)

    def init(self, seed: int = 0) -> dict:
        """Draw every weight from ``seed``; returns the state dict."""
        init_parameters(self.net, seed)
        return self.net.state_dict()

    def evaluate_denoiser(self, x, sigma, y=None, train: bool = False):
        """D(x; σ) = c_out·F(c_in·x, c_noise, y) + c_skip·x, x channels-last,
        σ [B]."""
        cfg = self.config
        c_in = bcast_right(cfg.input_scaling(sigma), x)
        c_out = bcast_right(cfg.output_scaling(sigma), x)
        c_skip = bcast_right(cfg.skip_scaling(sigma), x)
        self.net.train(train)
        f = self.net((c_in * x).movedim(-1, 1), cfg.noise_conditioner(sigma),
                     y).movedim(1, -1)
        return c_out * f + c_skip * x

    def loss_fn(self, x, sigma, y=None, mask=None, train: bool = True,
                eps=None, generator=None):
        """The mean over elements of metric(D(x + σ·ε; σ), x) on the
        normalised data, masked elements (mask == 1) weighted 0; ε is
        ``eps`` or a draw from ``generator``."""
        x = self.initial_norm.normalize(x)
        if eps is None:
            eps = torch.randn(x.shape, generator=generator, device=x.device,
                              dtype=x.dtype)
        denoised = self.evaluate_denoiser(x + bcast_right(sigma, x) * eps,
                                          sigma, y, train)
        loss = self._loss(denoised, x)
        if mask is not None:
            loss = loss * (1 - mask.expand_as(loss))
        return loss.mean()

    def integrate_probability_flow(self, x, y=None, nsteps: int = 100,
                                   record_history: bool = False):
        """Heun over the σ grid of ``create_sigma_steps(nsteps)`` and 0 (σ
        and dσ in float32, as the JAX package's scan reads them), the
        last step to 0 by Euler. Returns x, or the history [nsteps, ...]
        with ``record_history``."""
        sig = np.concatenate([self.config.create_sigma_steps(nsteps), [0.0]])
        dsig = np.diff(sig)
        ts = sig[:-2].astype(np.float32)
        dts = dsig[:-1].astype(np.float32)

        def rhs(xx, s: float):
            sb = torch.full((xx.shape[0],), s, device=xx.device)
            d = self.evaluate_denoiser(xx, sb, y)
            return -s * ((d - xx) / s ** 2)

        history = []
        with torch.no_grad():
            for t, dt in zip(ts, dts):
                r1 = rhs(x, float(t))
                xe = x + float(dt) * r1
                r2 = rhs(xe, float(t + dt))
                x = x + 0.5 * (r1 + r2) * float(dt)
                if record_history:
                    history.append(x)
            x = x + float(dsig[-1]) * rhs(x, float(np.float32(sig[-2])))
        if record_history:
            return torch.stack(history + [x])
        return x

    def sample(self, nsamples: int, shape, generator=None, y=None,
               nsteps: int = 100):
        """σ_max·ε (ε from ``generator``, channels-last ``shape``)
        integrated to a sample, then un-normalised."""
        x = torch.randn((nsamples,) + tuple(shape), generator=generator,
                        device=self.device) * self.config.sigma_max
        x = self.integrate_probability_flow(x, y, nsteps)
        return self.initial_norm.unnormalize(x)
