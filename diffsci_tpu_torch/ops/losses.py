"""Training losses: elementwise metrics, Gaussian-weighted MSE, the
smooth threshold-indicator loss, the ensemble CRPS and the multi-space
loss.

Port of ``diffsci_tpu/ops/losses.py``: ``mse``, ``huber`` (torch
``HuberLoss(reduction='none')`` semantics), ``masked_mean``,
``gaussian_window``, ``GaussianWeightedMSELoss``,
``MultiThresholdSmoothIndicatorLoss``, ``crps_ensemble``, the
ensemble-aware scalar wrapper ``elementwise_to_scalar``,
``make_loss_metric`` and ``MultiSpaceLoss``. Channels-last, as in the JAX
package; an ensemble prediction carries its members on axis 1,
[B, E, *spatial, C]. The mask convention is the reference's: mask == 1
marks excluded elements.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch


def mse(pred, target):
    return (pred - target) ** 2


def huber(pred, target, delta: float = 1.0):
    """torch.nn.HuberLoss(reduction='none') semantics."""
    d = pred - target
    abs_d = d.abs()
    return torch.where(abs_d <= delta, 0.5 * d ** 2,
                       delta * (abs_d - 0.5 * delta))


def masked_mean(loss, mask=None):
    """Mean over elements not excluded by the mask (mask == 1 excludes)."""
    if mask is None:
        return loss.mean()
    keep = (1.0 - mask).expand_as(loss)
    return (loss * keep).sum() / keep.sum().clamp_min(1.0)


def gaussian_window(shape: Sequence[int], focus_radius: float,
                    device=None) -> torch.Tensor:
    """N-dim Gaussian weight over [-1, 1]^N coordinates, shaped
    [1, *shape, 1] for channels-last broadcasting."""
    sigma = focus_radius + 1e-8
    coords = [torch.linspace(-1.0, 1.0, s, device=device) for s in shape]
    grids = torch.meshgrid(*coords, indexing="ij")
    dist2 = sum(g ** 2 for g in grids)
    w = torch.exp(-dist2 / (2 * sigma ** 2))
    return w.reshape((1,) + tuple(shape) + (1,))


@dataclasses.dataclass(frozen=True)
class GaussianWeightedMSELoss:
    """Centre-focused squared error, elementwise (no reduction)."""
    shape: tuple
    focus_radius: float
    reduces_internally = False

    def __call__(self, pred, target, mask=None):
        w = gaussian_window(self.shape, self.focus_radius, pred.device)
        if pred.ndim == len(self.shape) + 3:  # ensemble [B, E, *sp, C]
            w = w[:, None]
        return (pred - target) ** 2 * w


@dataclasses.dataclass(frozen=True)
class MultiThresholdSmoothIndicatorLoss:
    """Smooth exceedance loss over several thresholds: BCE of smooth
    indicators, a false-positive penalty and an intensity-weighted squared
    error. Applies the mask itself and returns a scalar."""
    thresholds: tuple = (0.5,)
    temperature: float = 10.0
    loss_type: str = "sigmoid"
    focus_weights: tuple | float | None = None
    background_weights: tuple | float | None = None
    fp_penalty: float = 1.0
    se_weight: float = 0.1
    aggregation: str = "mean"
    reduces_internally = True

    def __post_init__(self):
        t = self.thresholds
        object.__setattr__(self, "thresholds",
                           (float(t),) if isinstance(t, (int, float))
                           else tuple(t))

    def _weights(self, w, default):
        n = len(self.thresholds)
        if w is None:
            return (default,) * n
        if isinstance(w, (int, float)):
            return (float(w),) * n
        if len(w) != n:
            raise ValueError(f"{len(w)} weights for {n} thresholds")
        return tuple(w)

    def smooth_indicator(self, x, threshold):
        z = self.temperature * (x - threshold)
        if self.loss_type == "sigmoid":
            return torch.sigmoid(z)
        if self.loss_type == "tanh":
            return 0.5 * (1.0 + torch.tanh(z))
        if self.loss_type == "gumbel":
            return torch.softmax(torch.stack([torch.zeros_like(z), z], -1),
                                 dim=-1)[..., 1]
        raise ValueError(f"Unknown loss_type: {self.loss_type}")

    def _threshold_loss(self, pred, target, threshold, fw, bw, mask):
        eps = 1e-8
        ti = self.smooth_indicator(target, threshold)
        pi = self.smooth_indicator(pred, threshold)
        bce = -(ti * torch.log(pi + eps) + (1 - ti) * torch.log(1 - pi + eps))
        ind = bce + (1 - ti) * pi * (self.fp_penalty - 1.0)
        wind = fw * ind * ti + bw * ind * (1 - ti)
        wse = (pred - target) ** 2 * (1.0 + ti)
        return masked_mean(wind, mask) + self.se_weight * masked_mean(wse,
                                                                      mask)

    def __call__(self, pred, target, mask=None):
        if pred.ndim == target.ndim + 1:  # ensemble: mean over members
            target = target[:, None]
            if mask is not None and mask.ndim == target.ndim - 1:
                mask = mask[:, None]
        fws = self._weights(self.focus_weights, 2.0)
        bws = self._weights(self.background_weights, 0.1)
        stack = torch.stack([
            self._threshold_loss(pred, target, th, fw, bw, mask)
            for th, fw, bw in zip(self.thresholds, fws, bws)])
        if self.aggregation == "mean":
            return stack.mean()
        if self.aggregation == "sum":
            return stack.sum()
        if self.aggregation == "max":
            return stack.max()
        raise ValueError(f"Unknown aggregation: {self.aggregation}")


def crps_ensemble(pred, target, mask=None):
    """CRPS = mean|pred - target| - 0.5·mean_{i<j}|pred_i - pred_j|, per
    item, averaged over the batch. pred [B, E, *spatial, C] (or without
    E, one member), target [B, *spatial, C]. The pairwise term is one
    broadcast [B, E, E, F] difference. With a mask each item's CRPS is
    scaled by its fraction of kept elements. Returns a scalar."""
    if pred.ndim == target.ndim:
        pred = pred[:, None]
    B, E = pred.shape[:2]
    mae = (pred - target[:, None]).abs().mean(
        dim=tuple(range(2, pred.ndim))).mean(dim=1)            # [B]
    if E == 1:
        pairwise = torch.zeros(B, dtype=pred.dtype, device=pred.device)
    else:
        flat = pred.reshape(B, E, -1)
        pmean = (flat[:, :, None] - flat[:, None, :]).abs().mean(dim=3)
        i, j = torch.triu_indices(E, E, offset=1, device=pred.device)
        pairwise = pmean[:, i, j].sum(dim=1) / max(E * (E - 1) / 2, 1)
    crps = mae - 0.5 * pairwise
    if mask is not None:
        numel = math.prod(target.shape[1:])
        keep = (1.0 - mask).expand_as(target)
        valid = keep.sum(dim=tuple(range(1, target.ndim))).clamp_min(1.0)
        crps = crps * (valid / numel)
    return crps.mean()


crps_ensemble.reduces_internally = True


def elementwise_to_scalar(fn: Callable):
    """An elementwise loss as a mask-aware scalar: ``masked_mean`` of
    fn(pred, target), where an ensemble prediction [B, E, ...] meets its
    target [B, ...] (and a batched mask) through a new axis 1."""
    def wrapped(pred, target, mask=None):
        if pred.ndim == target.ndim + 1:
            target = target[:, None]
            if mask is not None and mask.ndim >= 1 \
                    and mask.shape[0] == pred.shape[0]:
                mask = mask[:, None]
        return masked_mean(fn(pred, target), mask)
    wrapped.reduces_internally = True
    return wrapped


def _elementwise(fn):
    def metric(pred, target, mask=None):
        return fn(pred, target)
    metric.reduces_internally = False
    return metric


def _parse(loss_config):
    if isinstance(loss_config, dict) and "losses" not in loss_config:
        name = next(iter(loss_config))
        return name, loss_config[name] or {}
    if isinstance(loss_config, str):
        return loss_config, {}
    raise ValueError(f"unsupported loss config: {loss_config!r}")


def make_loss_metric(loss_config: str | dict[str, Any],
                     spatial_shape=None, focus_radius=None):
    """The loss ``fn(pred, target, mask=None)`` of a config: "mse",
    "huber", "weighted_gaussian" (needs ``spatial_shape`` and
    ``focus_radius``), "smoothed_indicator", "crps" (ensembles, see
    ``crps_ensemble``), or a one-key dict such as
    ``{"huber": {"delta": 0.5}}``. ``fn.reduces_internally`` is the JAX
    package's second return value: True when fn applies the mask itself
    and returns a scalar, False when it returns the elementwise loss. A
    multi-space config (``{"losses": [...]}``) is ``MultiSpaceLoss``'s and
    raises here."""
    name, params = _parse(loss_config)
    if name == "mse":
        return _elementwise(mse)
    if name == "huber":
        delta = params.get("delta", 1.0)
        return _elementwise(lambda p, t: huber(p, t, delta))
    if name == "weighted_gaussian":
        if spatial_shape is None or focus_radius is None:
            raise AttributeError(
                "config must have spatial_shape and focus_radius")
        return GaussianWeightedMSELoss(tuple(spatial_shape), focus_radius)
    if name == "smoothed_indicator":
        return MultiThresholdSmoothIndicatorLoss(**params)
    if name == "crps":
        return crps_ensemble
    raise ValueError(f"loss_type {name} not recognized")


class MultiSpaceLoss:
    """A weighted sum of losses in the latent and/or the pixel space.
    ``loss_config["losses"]``: a list of {"name", "type", "params",
    "space" ("latent" or "pixel"), "weight" (1), "use_mask" (True)};
    ``decode_fn`` maps a latent (channels-last) to pixels (channels-last),
    needed by pixel-space terms."""

    def __init__(self, loss_config: dict[str, Any],
                 decode_fn: Callable | None = None):
        self.decode_fn = decode_fn
        self.losses = []
        for spec in loss_config["losses"]:
            fn = make_loss_metric({spec["type"]: spec.get("params", {})})
            self.losses.append(dict(
                name=spec["name"], fn=fn, space=spec["space"],
                weight=spec.get("weight", 1.0),
                use_mask=spec.get("use_mask", True)))

    def compute_loss(self, denoiser_latent, target_latent,
                     target_pixel=None, mask_latent=None, mask_pixel=None):
        """Every term's value by name and their weighted ``total``."""
        denoiser_pixel = None
        if any(s["space"] == "pixel" for s in self.losses):
            if self.decode_fn is None:
                raise ValueError("decode_fn required for pixel space losses")
            denoiser_pixel = self.decode_fn(denoiser_latent)
            if target_pixel is None:
                target_pixel = self.decode_fn(target_latent)
        values = {}
        total = 0.0
        for spec in self.losses:
            if spec["space"] == "latent":
                pred, target, mask = denoiser_latent, target_latent, \
                    mask_latent
            elif spec["space"] == "pixel":
                pred, target, mask = denoiser_pixel, target_pixel, mask_pixel
            else:
                raise ValueError(f"Unknown space: {spec['space']}")
            mask = mask if spec["use_mask"] else None
            val = spec["fn"](pred, target, mask)
            if not spec["fn"].reduces_internally:
                val = masked_mean(val, mask)
            values[spec["name"]] = val
            total = total + spec["weight"] * val
        values["total"] = total
        return values
