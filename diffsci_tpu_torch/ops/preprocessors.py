"""Differentiable loss preprocessors: edge features for VAE training.

Port of ``diffsci_tpu/ops/preprocessors.py``. ``VAEModel``'s
``loss_preprocessor='edges'`` maps both the data and the reconstruction to
a stack of edge features (the input itself, the Sobel magnitude, the
Laplacian, the gradient magnitude and the morphological gradient, each
weighted so that the weights sum to 1) before the reconstruction loss, in
1D, 2D or 3D.

Tensors are [B, C, *spatial]; every stencil is applied depthwise (one
filter per channel), as a cross-correlation with zero padding that keeps
the size (``lax.conv_general_dilated`` SAME: no flip); the dilation and
erosion are max pools padded with −inf. The stencils and the border
window are made on the host once per (shape, device, dtype) and kept, so
a CUDA graph that captures the loss reads tensors made before its
capture.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

VALID_PROCESSORS = ("original", "sobel", "laplacian", "gradient", "morph")

_CONV = (F.conv1d, F.conv2d, F.conv3d)
_MAX_POOL = (F.max_pool1d, F.max_pool2d, F.max_pool3d)


def smoothstep_window(length: int, border: int) -> np.ndarray:
    """1D window: 1 inside, the cubic smoothstep 3x² − 2x³ down to 0 over
    ``border`` samples at each end."""
    if border <= 0:
        return np.ones(length, np.float32)
    idx = np.arange(length, dtype=np.float32)
    win = np.ones(length, np.float32)
    left = idx < border
    xl = idx[left] / border
    win[left] = 3 * xl**2 - 2 * xl**3
    right = idx >= (length - border)
    xr = (length - idx[right] - 1) / border
    win[right] = 3 * xr**2 - 2 * xr**3
    return win


def _outer(profiles) -> np.ndarray:
    k = profiles[0]
    for p in profiles[1:]:
        k = np.multiply.outer(k, p)
    return k.astype(np.float32)


def _sobel_kernels(dim: int) -> list[np.ndarray]:
    """Per axis, the derivative [-1, 0, 1] along it times the smoothing
    [1, 2, 1] along the others."""
    smooth = np.array([1.0, 2.0, 1.0], np.float32)
    deriv = np.array([-1.0, 0.0, 1.0], np.float32)
    return [_outer([deriv if ax == axis else smooth for ax in range(dim)])
            for axis in range(dim)]


def _laplacian_kernel(dim: int) -> np.ndarray:
    """The discrete Laplacian: −2·dim at the centre, 1 at each face
    neighbour."""
    k = np.zeros((3,) * dim, np.float32)
    center = (1,) * dim
    k[center] = -2.0 * dim
    for axis in range(dim):
        for off in (0, 2):
            idx = list(center)
            idx[axis] = off
            k[tuple(idx)] = 1.0
    return k


def _grad_kernels(dim: int) -> list[np.ndarray]:
    """Per axis, the central difference [-1, 0, 1] along it alone."""
    deriv = np.array([-1.0, 0.0, 1.0], np.float32)
    ones = np.array([1.0], np.float32)
    return [_outer([deriv if ax == axis else ones for ax in range(dim)])
            for axis in range(dim)]


class EdgeDetectionPreprocessor:
    """x [B, C, *spatial] -> its edge features, concatenated on the channel
    axis in the order of ``processors`` ("all", one name or a list of
    ``VALID_PROCESSORS``). ``feature_weights`` (by name, default 1) are
    normalised to sum 1 over the chosen processors. Every feature but
    "original" is taken of x times the smoothstep border window
    (``border_width`` samples a side); ``morph_kernel_size`` is the max
    pool's width."""

    def __init__(self, dim: int = 2,
                 processors: str | Sequence[str] = "all",
                 feature_weights: Dict[str, float] | None = None,
                 border_width: int = 8,
                 morph_kernel_size: int = 3):
        self.dim = dim
        if processors == "all":
            procs = list(VALID_PROCESSORS)
        elif isinstance(processors, str):
            procs = [processors]
        else:
            procs = list(processors)
        for p in procs:
            if p not in VALID_PROCESSORS:
                raise ValueError(f"Unknown processor: {p}")
        self.processors = procs
        self.border_width = border_width
        self.morph_kernel_size = morph_kernel_size
        if feature_weights is None:
            feature_weights = {p: 1.0 for p in VALID_PROCESSORS}
        sel = [float(feature_weights.get(p, 1.0)) for p in procs]
        total = sum(sel)
        self.weights = {p: (w / total if total else 0.0)
                        for p, w in zip(procs, sel)}
        self._stencils = {"sobel": _sobel_kernels(dim),
                          "laplacian": [_laplacian_kernel(dim)],
                          "gradient": _grad_kernels(dim)}
        self._cache: dict = {}

    def _tensor(self, key, make, like) -> torch.Tensor:
        """A constant made by ``make()`` (numpy) as a tensor on x's device
        and dtype, kept per key."""
        key = key + (like.device, like.dtype)
        t = self._cache.get(key)
        if t is None:
            t = torch.as_tensor(make()).to(like.device, like.dtype)
            self._cache[key] = t
        return t

    # -- primitives -----------------------------------------------------
    def _depthwise(self, x, name: str, i: int):
        """The i-th stencil of ``name`` over every channel, size kept."""
        c = x.shape[1]
        k = self._stencils[name][i]
        w = self._tensor(("stencil", name, i, c),
                         lambda: np.broadcast_to(k, (c, 1) + k.shape).copy(),
                         x)
        return _CONV[self.dim - 1](x, w, padding="same", groups=c)

    def _magnitude(self, x, name: str):
        grads = [self._depthwise(x, name, i)
                 for i in range(len(self._stencils[name]))]
        return torch.sqrt(sum(g * g for g in grads) + 1e-8)

    def sobel_edges(self, x):
        return self._magnitude(x, "sobel")

    def laplacian_edges(self, x):
        return self._depthwise(x, "laplacian", 0)

    def gradient_magnitude(self, x):
        return self._magnitude(x, "gradient")

    def _max_pool(self, x):
        """Max over a k^dim window, stride 1, padded with −inf as SAME
        pads: (k − 1)//2 before, the rest after."""
        k = self.morph_kernel_size
        pad = ((k - 1) // 2, k - 1 - (k - 1) // 2) * self.dim
        xp = F.pad(x, pad, value=float("-inf"))
        return _MAX_POOL[self.dim - 1](xp, k, stride=1)

    def morphological_gradient(self, x):
        """Dilation minus erosion."""
        return self._max_pool(x) + self._max_pool(-x)

    def _border_window(self, x):
        if self.border_width is None or self.border_width <= 0:
            return x
        spatial = tuple(x.shape[2:])

        def make():
            return _outer([smoothstep_window(n, self.border_width)
                           for n in spatial])

        return x * self._tensor(("window", spatial), make, x)

    # -- forward ---------------------------------------------------------
    def __call__(self, x):
        xw = self._border_window(x)
        feats = []
        for p in self.processors:
            w = self.weights[p]
            if p == "original":
                feats.append(x * w)
            elif p == "sobel":
                feats.append(self.sobel_edges(xw) * w)
            elif p == "laplacian":
                feats.append(self.laplacian_edges(xw) * w)
            elif p == "gradient":
                feats.append(self.gradient_magnitude(xw) * w)
            elif p == "morph":
                feats.append(self.morphological_gradient(xw) * w)
        return torch.cat(feats, dim=1)


def make_loss_preprocessor(spec, dim: int = 2) -> Callable:
    """The VAE configuration's ``loss_preprocessor``: 'none' (or None) ->
    the identity, 'edges' -> ``EdgeDetectionPreprocessor(dim)``, a
    callable -> itself."""
    if callable(spec):
        return spec
    if spec == "edges":
        return EdgeDetectionPreprocessor(dim=dim)
    if spec == "none" or spec is None:
        return lambda x: x
    raise ValueError(f"Loss preprocessor {spec!r} not supported")
