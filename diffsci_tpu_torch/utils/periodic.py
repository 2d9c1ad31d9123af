"""Periodic (wrap-around) slicing utilities.

Port of ``diffsci_tpu/utils/periodic.py`` (the reference's periodic
indexing helpers, ``diffsci/torchutils.py:107-308``). Semantics:

- ``periodic_getitem``: slices wrap once around the dimension
  (``slice(7, 2)`` on a size-10 axis returns indices ``7,8,9,0,1``).
- ``periodic_getitem_extended``: slices may span multiple periods
  (``slice(-2, 7)`` on a size-3 axis returns 9 tiled elements).
- ``periodic_setitem``: functional write-back (returns a new tensor, as
  the JAX package does), wrapping once at most.

Slice bounds are Python ints; each helper indexes the leading dims of a
tensor on any device.
"""

from __future__ import annotations

import numpy as np
import torch


def _normalize(idx: slice, size: int, *, allow_multi_period: bool):
    start = idx.start if idx.start is not None else 0
    stop = idx.stop if idx.stop is not None else size
    step = idx.step if idx.step is not None else 1
    if step != 1:
        raise NotImplementedError("only step=1 is supported")
    if not allow_multi_period and abs(start - stop) > size:
        raise ValueError(f"slice {idx} too large for axis of size {size}")
    return start, stop


def _wrap_once(idx: slice, size: int) -> np.ndarray:
    """The indices of a slice that wraps at most once (stop < start
    wraps)."""
    start, stop = _normalize(idx, size, allow_multi_period=False)
    start %= size
    stop = stop % size if (stop < 0 or stop > size) else stop
    if stop < start:
        return np.concatenate([np.arange(start, size), np.arange(0, stop)])
    return np.arange(start, stop)


def _take(x: torch.Tensor, ids: np.ndarray, dim: int) -> torch.Tensor:
    return x.index_select(dim, torch.as_tensor(ids, dtype=torch.long,
                                               device=x.device))


def periodic_getitem(x: torch.Tensor, *indices) -> torch.Tensor:
    """Extract a once-wrapping periodic slice, dimension by dimension."""
    result = x
    for dim, idx in enumerate(indices):
        if idx == slice(None):
            continue
        if not isinstance(idx, slice):
            raise TypeError(f"unsupported index type: {type(idx)}")
        result = _take(result, _wrap_once(idx, result.shape[dim]), dim)
    return result


def periodic_getitem_extended(x: torch.Tensor, *indices) -> torch.Tensor:
    """Periodic slice allowing requests larger than the axis (tiles)."""
    result = x
    for dim, idx in enumerate(indices):
        if idx == slice(None):
            continue
        if not isinstance(idx, slice):
            raise TypeError(f"unsupported index type: {type(idx)}")
        size = result.shape[dim]
        start, stop = _normalize(idx, size, allow_multi_period=True)
        ids = np.arange(start, stop) % size if stop > start else \
            np.arange(0)
        result = _take(result, ids, dim)
    return result


def periodic_setitem(x: torch.Tensor, value, *indices) -> torch.Tensor:
    """Functional periodic assignment; returns the updated tensor.

    ``indices`` are slices over the leading dims of ``x``; each may wrap
    once."""
    if len(indices) == 1 and isinstance(indices[0], tuple):
        indices = indices[0]
    gathers = []
    for dim, idx in enumerate(indices):
        if not isinstance(idx, slice):
            raise TypeError("only slice indexing is supported")
        gathers.append(torch.as_tensor(_wrap_once(idx, x.shape[dim]),
                                       dtype=torch.long, device=x.device))
    out = x.clone()
    # an open mesh of destination indices over the sliced dims
    mesh = torch.meshgrid(*gathers, indexing="ij") if gathers else ()
    out[tuple(mesh)] = torch.as_tensor(value, dtype=x.dtype,
                                       device=x.device)
    return out


__all__ = ["periodic_getitem", "periodic_getitem_extended",
           "periodic_setitem"]
