"""Broadcasting and condition helpers.

The port's own copy of ``diffsci_tpu/utils/tensor.py``'s ``bcast_right``,
``dict_map``, ``dict_expand_dims``, ``linear_interpolation``,
``get_minibatch_sizes``, ``space_to_depth`` and ``depth_to_space``, on
torch tensors, and of its host-side ``inverse_cdf_histogram`` (numpy and
scipy).
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


def unset(*shape: int) -> torch.Tensor:
    """A parameter's or buffer's storage before ``init``: NaN, so that a
    module used without ``init`` (``init_parameters``,
    ``KarrasModel.init``) or a loaded state dict gives NaN on every run,
    not whatever memory ``torch.empty`` held."""
    return torch.full(shape, float("nan"))


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


def linear_interpolation(x1: torch.Tensor, x2: torch.Tensor,
                         ninterp: int) -> torch.Tensor:
    """The straight path from ``x1`` to ``x2`` at ``ninterp + 2`` evenly
    spaced points, both ends included: [ninterp + 2, *x1.shape]."""
    alphas = torch.linspace(0.0, 1.0, ninterp + 2, dtype=x1.dtype,
                            device=x1.device)
    alphas = alphas.reshape((-1,) + (1,) * x1.ndim)
    return (1.0 - alphas) * x1[None] + alphas * x2[None]


def get_minibatch_sizes(nsamples: int, maximum_batch_size: int) -> list[int]:
    """Split ``nsamples`` into chunks of at most ``maximum_batch_size``."""
    nbatches, remainder = divmod(nsamples, maximum_batch_size)
    sizes = [maximum_batch_size] * nbatches
    if remainder:
        sizes.append(remainder)
    return sizes


def inverse_cdf_histogram(z):
    """Empirical inverse CDF of a sample through a density histogram
    (``bins="auto"``): a callable ``ppf(q)``. Host-side numpy and scipy,
    for histogram-matched noise shaping in analysis scripts; ``z`` may be
    a tensor or an array."""
    import numpy as np
    import scipy.stats

    if isinstance(z, torch.Tensor):
        z = z.detach().cpu().numpy()
    histogram, bin_edges = np.histogram(np.asarray(z), bins="auto",
                                        density=True)
    return scipy.stats.rv_histogram((histogram, bin_edges)).ppf


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """Fold ``block``-sized spatial tiles into channels on the NC* layout:
    [B, C, *S] -> [B, C·block^d, *S/block]. The folded channel index is
    the JAX package's (``diffsci_tpu/utils/tensor.py:100-126``, channels
    last): the tile offsets, first spatial axis slowest, then the channel
    fastest, so weights carry across unchanged."""
    if block == 1:
        return x
    B, C = x.shape[:2]
    spatial = tuple(x.shape[2:])
    d = len(spatial)
    shape = [B, C]
    for s in spatial:
        if s % block != 0:
            raise ValueError(f"spatial dim {s} not divisible by {block}")
        shape += [s // block, block]
    x = x.reshape(shape)
    # [B, C, s1, b1, s2, b2, ...] -> [B, b1, b2, ..., C, s1, s2, ...]
    perm = ([0] + [3 + 2 * i for i in range(d)] + [1]
            + [2 + 2 * i for i in range(d)])
    return x.permute(perm).reshape(
        (B, C * block ** d) + tuple(s // block for s in spatial))


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    if block == 1:
        return x
    B, C = x.shape[:2]
    spatial = tuple(x.shape[2:])
    d = len(spatial)
    c_out = C // block ** d
    if c_out * block ** d != C:
        raise ValueError(f"channels {C} not divisible by {block}^{d}")
    x = x.reshape((B,) + (block,) * d + (c_out,) + spatial)
    # [B, b1, ..., bd, C, s1, ..., sd] -> [B, C, s1, b1, s2, b2, ...]
    perm = [0, 1 + d]
    for i in range(d):
        perm += [2 + d + i, 1 + i]
    return x.permute(perm).reshape(
        (B, c_out) + tuple(s * block for s in spatial))
