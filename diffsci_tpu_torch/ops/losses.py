"""Elementwise training losses.

Port of ``diffsci_tpu/ops/losses.py:29-47, 207-232``: ``mse``, ``huber``
(torch ``HuberLoss(reduction='none')`` semantics), ``masked_mean`` and
``make_loss_metric`` for "mse", "huber" and ``{"huber": {"delta": ...}}``.
Channels-last, as in the JAX package. The mask convention is the
reference's: mask == 1 marks excluded elements.
"""

from __future__ import annotations

from typing import Any

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


def make_loss_metric(loss_config: str | dict[str, Any]):
    """The elementwise loss ``fn(pred, target)`` of a config: "mse",
    "huber" or a one-key dict such as ``{"huber": {"delta": 0.5}}``. The
    JAX package's other metrics (some of which reduce internally, hence
    its extra return flag) raise NotImplementedError."""
    if isinstance(loss_config, dict) and "losses" not in loss_config:
        name = next(iter(loss_config))
        params = loss_config[name] or {}
    elif isinstance(loss_config, str):
        name, params = loss_config, {}
    else:
        raise ValueError(f"unsupported loss config: {loss_config!r}")
    if name == "mse":
        return mse
    if name == "huber":
        delta = params.get("delta", 1.0)
        return lambda p, t: huber(p, t, delta)
    raise NotImplementedError(f"loss metric {name!r} is not ported yet")
