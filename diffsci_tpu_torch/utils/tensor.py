"""Broadcasting and condition helpers.

The port's own copy of ``diffsci_tpu/utils/tensor.py``'s ``bcast_right``,
``dict_map``, ``dict_expand_dims`` and ``get_minibatch_sizes``, on torch
tensors.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def bcast_right(a: torch.Tensor, target: torch.Tensor | int) -> torch.Tensor:
    """Append trailing singleton axes to ``a`` so it broadcasts against
    ``target`` "from below" (leading axes aligned): ``[B]`` becomes
    ``[B, 1, ..., 1]`` with ``target``'s number of dims."""
    ndim = target if isinstance(target, int) else target.ndim
    if a.ndim > ndim:
        raise ValueError(f"cannot right-broadcast ndim {a.ndim} -> {ndim}")
    return a.reshape(tuple(a.shape) + (1,) * (ndim - a.ndim))


def dict_map(fn: Callable[[Any], Any], d: Any) -> Any:
    """Apply ``fn`` to a condition: ``None``, one tensor, or a flat dict of
    tensors."""
    if d is None:
        return None
    if isinstance(d, dict):
        return {k: fn(v) for k, v in d.items()}
    return fn(d)


def dict_expand_dims(d: Any, axis: int = 0) -> Any:
    return dict_map(lambda v: v.unsqueeze(axis), d)


def get_minibatch_sizes(nsamples: int, maximum_batch_size: int) -> list[int]:
    """Split ``nsamples`` into chunks of at most ``maximum_batch_size``."""
    nbatches, remainder = divmod(nsamples, maximum_batch_size)
    sizes = [maximum_batch_size] * nbatches
    if remainder:
        sizes.append(remainder)
    return sizes
