"""DiffusionPeriodizer: make any network's outputs periodic by
expand-crop-cosine-blend.

Port of ``diffsci_tpu/extra/periodizer.py`` (the reference's
``diffsci/extra/periodizer.py:23-356``). Channels-last, as the JAX
package and the port's ``SIModel``: spatial axes are 1..ndim-2. The
wrapper takes any callable ``net_fn(x, *args, **kwargs) -> y`` (a bound
flow field, a denoiser) and runs on the device of its input.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import torch


def _normalize(v, dimension):
    if isinstance(v, int):
        return (v,) * dimension
    assert len(v) == dimension
    return tuple(v)


class DiffusionPeriodizer:
    """(periodizer.py:23-257)"""

    def __init__(self, net_fn: Callable, pad: Union[int, Sequence[int]],
                 blend_width: Union[int, Sequence[int]] = 8,
                 dimension: int = 3):
        self.net_fn = net_fn
        self.dimension = dimension
        self.pad = _normalize(pad, dimension)
        self.blend_width = _normalize(blend_width, dimension)

    def expand_periodic(self, x):
        """Tile pad pixels from the opposite side onto each boundary
        (periodizer.py:76-101)."""
        spatial = x.shape[1:-1]
        assert len(spatial) == self.dimension
        for dim_idx, (size, p) in enumerate(zip(spatial, self.pad)):
            idx = torch.arange(-p, size + p, device=x.device) % size
            x = x.index_select(dim_idx + 1, idx)
        return x

    def crop_center(self, x, original_spatial):
        """(periodizer.py:103-124)"""
        slices = [slice(None)]
        for p, size in zip(self.pad, original_spatial):
            slices.append(slice(p, p + size))
        slices.append(slice(None))
        return x[tuple(slices)]

    def cosine_blend_boundaries(self, x):
        """Blend each start strip with the flipped end strip using cosine
        weights so opposite boundaries agree (periodizer.py:126-199).
        Returns a new tensor."""
        x = x.clone()
        for dim_idx, bw in enumerate(self.blend_width):
            if bw <= 0:
                continue
            axis = dim_idx + 1
            size = x.shape[axis]
            if bw * 2 >= size:
                continue
            pos = torch.arange(bw, dtype=x.dtype, device=x.device)
            w = 0.5 * (1 - torch.cos(math.pi * (pos + 0.5) / bw))
            wshape = [1] * x.ndim
            wshape[axis] = bw
            w = w.reshape(wshape)

            start = x.narrow(axis, 0, bw)
            end = x.narrow(axis, size - bw, bw)
            end_f = end.flip(axis)
            start_f = start.flip(axis)
            new_start = w * start + (1 - w) * end_f
            w_f = w.flip(axis)
            new_end = w_f * end + (1 - w_f) * start_f
            start.copy_(new_start)
            end.copy_(new_end)
        return x

    def __call__(self, x, *args, **kwargs):
        """expand -> net -> crop -> blend (periodizer.py:201-236)."""
        spatial = x.shape[1:-1]
        y = self.net_fn(self.expand_periodic(x), *args, **kwargs)
        y = self.crop_center(y, spatial)
        return self.cosine_blend_boundaries(y)

    def forward_no_blend(self, x, *args, **kwargs):
        spatial = x.shape[1:-1]
        y = self.net_fn(self.expand_periodic(x), *args, **kwargs)
        return self.crop_center(y, spatial)

    def forward_expand_only(self, x, *args, **kwargs):
        return self.net_fn(self.expand_periodic(x), *args, **kwargs)


class PeriodicSamplerWrapper:
    """Apply the periodizer every N sampling steps
    (periodizer.py:259-310)."""

    def __init__(self, step_fn: Callable, periodizer: DiffusionPeriodizer,
                 apply_every_n_steps: int = 1):
        self.step_fn = step_fn
        self.periodizer = periodizer
        self.apply_every_n_steps = apply_every_n_steps
        self._step_count = 0

    def step(self, x, t, **kwargs):
        self._step_count += 1
        if self._step_count % self.apply_every_n_steps == 0:
            return self.periodizer(x, t, **kwargs)
        return self.step_fn(x, t, **kwargs)

    def reset(self):
        self._step_count = 0


def measure_periodicity_error(x, dimension: int = 3) -> dict:
    """MSE / max-diff between opposite boundaries per spatial dim
    (periodizer.py:313-356). Channels-last."""
    errors = {}
    mse_per_dim, max_per_dim = [], []
    names = ["H", "W", "D"][:dimension]
    for dim_idx in range(dimension):
        axis = dim_idx + 1
        diff = x.select(axis, 0) - x.select(axis, x.shape[axis] - 1)
        mse = float((diff ** 2).mean())
        mx = float(diff.abs().max())
        mse_per_dim.append(mse)
        max_per_dim.append(mx)
        errors[f"mse_{names[dim_idx]}"] = mse
        errors[f"max_diff_{names[dim_idx]}"] = mx
    errors["total_mse"] = sum(mse_per_dim)
    errors["mse_per_dim"] = mse_per_dim
    errors["max_diff_per_dim"] = max_per_dim
    return errors


__all__ = ["DiffusionPeriodizer", "PeriodicSamplerWrapper",
           "measure_periodicity_error"]
