"""ForecastModel: the deterministic (non-diffusion) forecasting baseline:
encode, predict with the network directly, decode.

Port of ``diffsci_tpu/models/regression.py``: ``ForecastModelConfig``
(``from_simple``, ``from_advanced``, the description) and
``ForecastModel``: ``encode``/``decode`` with ``norm`` through the
autoencoder protocol of ``KarrasModel``, ``loss_fn`` (the metric of
``make_loss_metric``; a mask means 1 = include, the opposite of the
Karras stack's convention, and the mean runs over all elements; the
``spatial_weight_map`` [*spatial] multiplies as [1, *spatial, 1]),
``predict``, ``sample`` (chunked by ``maximum_batch_size``) and
``select_batch``.

The network is called as ``net(y_cond, y)``: the conditioning window
``y["y"]`` (or y itself) and the whole condition. Targets, the window and
the prediction are channels-last, as in the JAX package; ``RuntimeNet``
moves the channel axis of the window and of the prediction at the
network boundary. The train step: ``make_train_step(model, tx,
loss_fn=lambda x, sigma, y, mask, eps: model.loss_fn(x, y, mask,
z_eps=eps))``: the σ slot holds zeros (``config.noisesampler``) and the
ε slot, of the latent's shape, the posterior's draw.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn

from diffsci_tpu_torch.models.runtime import (NoNoiseLevel, RuntimeMixin,
                                              RuntimeNet)
from diffsci_tpu_torch.ops import losses
from diffsci_tpu_torch.utils import (dict_map, get_minibatch_sizes,
                                     resolve_device)


class ForecastModelConfig:
    """The loss metric (a name or a one-key dict, as ``make_loss_metric``
    takes), whether the autoencoder is frozen, the latent ``norm``, the
    Gaussian window's ``spatial_shape``/``focus_radius`` and the per-pixel
    ``spatial_weight_map``."""

    noisesampler = NoNoiseLevel()

    def __init__(self,
                 loss_metric: str | dict = "huber",
                 freeze_autoencoder: bool = True,
                 norm: float = 1.0,
                 spatial_shape=None,
                 focus_radius=None,
                 spatial_weight_map=None):
        self.loss_metric = loss_metric
        self.freeze_autoencoder = freeze_autoencoder
        self.norm = norm
        self.spatial_shape = spatial_shape
        self.focus_radius = focus_radius
        self.spatial_weight_map = spatial_weight_map

    @classmethod
    def from_simple(cls, loss_metric: str = "huber", **kwargs):
        return cls(loss_metric=loss_metric, **kwargs)

    @classmethod
    def from_advanced(cls, loss_metric: dict, **kwargs):
        return cls(loss_metric=loss_metric, **kwargs)

    def export_description(self) -> dict[str, Any]:
        return dict(loss_metric=self.loss_metric,
                    freeze_autoencoder=self.freeze_autoencoder,
                    norm=self.norm)

    @classmethod
    def from_description(cls, description):
        return cls(**description)


class ForecastModel(RuntimeMixin):
    """The deterministic forecaster around ``net(y_cond, y)`` on
    [B, C, *spatial] (state-dict names ``model.*``); batches are (target,
    y[, mask])."""

    def __init__(self, model: nn.Module, config: ForecastModelConfig,
                 conditional: bool = True, masked: bool = False,
                 autoencoder=None, autoencoder_conditional: bool = False,
                 encode_y: bool = False,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.config = config
        self.conditional = conditional
        self.masked = masked
        self.autoencoder = autoencoder
        self.autoencoder_conditional = autoencoder_conditional
        self.encode_y = encode_y
        self.norm = config.norm
        self.compute_dtype = None
        self._loss_metric = losses.make_loss_metric(
            config.loss_metric, config.spatial_shape, config.focus_radius)
        self.net = RuntimeNet(model).to(self.device).eval()
        self._reset_runtime()

    def encode(self, x, y=None, z_eps=None):
        """Targets -> the prediction's space: the autoencoder's encode
        (``z_eps``: its posterior draw), then / norm. Returns (x, y)."""
        if self.latent_model:
            x, y_enc = self._ae_encode(x, y, z_eps,
                                       self.autoencoder_conditional)
            if self.autoencoder_conditional and self.encode_y:
                y = y_enc
        return x / self.norm, y

    def decode(self, x, y=None):
        x = x * self.norm
        if self.latent_model:
            return self._ae_decode(x, y, self.autoencoder_conditional)
        return x

    def forward(self, y, train: bool = False, variables=None):
        """The prediction from the condition."""
        yc = y["y"] if isinstance(y, dict) else y
        return self._network(train, variables)(yc, y)

    def loss_fn(self, x, y=None, mask=None, train: bool = True,
                variables=None, z_eps=None, generator=None):
        """The metric between the prediction and the encoded target: a
        metric that reduces itself takes the mask; otherwise the
        elementwise loss times the mask (1 = include) and the spatial
        weight map, averaged over all elements. ``z_eps``: the posterior's
        unit draw (the latent's shape) when the autoencoder samples its
        posterior, else drawn from ``generator``."""
        if z_eps is None:
            z_eps = self._draw_posterior(x, generator)
        x_latent, y = self.encode(x, y, z_eps)
        pred = self.forward(y, train, variables)
        metric = self._loss_metric
        if metric.reduces_internally:
            return metric(pred, x_latent, mask)
        raw = metric(pred, x_latent, mask)
        if mask is not None:
            raw = raw * mask.expand_as(raw)
        wmap = self.config.spatial_weight_map
        if wmap is not None:
            w = torch.as_tensor(wmap, dtype=raw.dtype, device=raw.device)
            raw = raw * w[None, ..., None]
        return raw.mean()

    @torch.inference_mode()
    def predict(self, y, return_latent: bool = False):
        pred = self.forward(y)
        return pred if return_latent else self.decode(pred, y)

    @torch.inference_mode()
    def sample(self, y, generator=None, return_latent: bool = False,
               maximum_batch_size: int | None = None):
        """The prediction (deterministic; ``generator`` is taken as
        ``KarrasModel.sample`` takes one), in chunks of at most
        ``maximum_batch_size`` rows."""
        yc = y["y"] if isinstance(y, dict) else y
        n = yc.shape[0]
        if maximum_batch_size is None or n <= maximum_batch_size:
            return self.predict(y, return_latent)
        outs, start = [], 0
        for bs in get_minibatch_sizes(n, maximum_batch_size):
            ysub = dict_map(lambda v, a=start, b=bs: v[a:a + b], y)
            outs.append(self.predict(ysub, return_latent))
            start += bs
        return torch.cat(outs, dim=0)

    def select_batch(self, batch):
        if self.conditional and self.masked:
            x, y, mask = batch
        elif self.conditional:
            (x, y), mask = batch, None
        elif self.masked:
            (x, mask), y = batch, None
        else:
            x, y, mask = batch, None, None
        return x, y, mask

    def export_description(self) -> dict[str, Any]:
        return dict(config_description=self.config.export_description(),
                    conditional=self.conditional, masked=self.masked,
                    autoencoder=self.autoencoder is not None,
                    autoencoder_conditional=self.autoencoder_conditional,
                    encode_y=self.encode_y)
