"""Matern-field porosity sampling and condition mapping for conditioned
microstructure generation.

Port of ``diffsci_tpu/extra/porosity_map.py`` (the reference's
``diffsci/extra/porosity_map.py:9-177``). The sampling and interpolation
are host numpy/scipy code (conditioning data, not a compute path), as in
the JAX package; the condition dicts hold float32 tensors on the
requested device (default: the CUDA card).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.interpolate import UnivariateSpline, interp1d
from scipy.spatial.distance import cdist
from scipy.special import gamma, kv

from diffsci_tpu_torch.utils import resolve_device


class MaternFieldSampler:
    """Gaussian process with a Matern kernel over fixed spatial points
    (porosity_map.py:9-88)."""

    def __init__(self, X, mean_val, params, jitter: float = 1e-6,
                 seed: int | None = None):
        self.X = np.atleast_2d(X)
        self.mean_val = mean_val
        self.n_points = self.X.shape[0]
        if isinstance(params, dict):
            self.sigma_sq = params["sigma_sq"]
            self.nu = params["nu"]
            self.length_scale = params["length_scale"]
        else:
            self.sigma_sq, self.nu, self.length_scale = params
        self._rng = np.random.default_rng(seed)
        K = self._build_covariance_matrix()
        self.L = np.linalg.cholesky(K + np.eye(self.n_points) * jitter)

    def _matern_kernel(self, r):
        result = np.zeros_like(r, dtype=np.float64)
        mask = r > 1e-10
        if np.any(mask):
            rv = r[mask]
            scaled = (np.sqrt(2 * self.nu) * rv) / self.length_scale
            factor = 2 ** (1.0 - self.nu) / gamma(self.nu)
            result[mask] = (self.sigma_sq * factor * scaled ** self.nu
                            * kv(self.nu, scaled))
        result[~mask] = self.sigma_sq
        return result

    def _build_covariance_matrix(self):
        return self._matern_kernel(cdist(self.X, self.X))

    def sample(self, n_samples: int = 1):
        z = self._rng.normal(size=(self.n_points, n_samples))
        return (self.mean_val + self.L @ z).T


def interpolate_array(arr, method: str = "linear"):
    """Upsample [p0, p2, ...] (even grid) to all integers
    (porosity_map.py:91-133)."""
    arr = np.asarray(arr)
    n = len(arr)
    x_orig = np.arange(0, n * 2, 2)
    x_target = np.arange(0, (n - 1) * 2 + 1)
    if method == "linear":
        f = interp1d(x_orig, arr, kind="linear", bounds_error=False,
                     fill_value="extrapolate")
        return f(x_target)
    if method == "spline":
        spline = UnivariateSpline(x_orig, arr, s=0, k=min(3, n - 1))
        return spline(x_target)
    raise ValueError(f"Unknown method: {method}")


def array_map(f, x):
    shape = x.shape
    return np.array([f(xx) for xx in x.reshape(-1)]).reshape(shape)


def map_porosity_to_condition(porosity, device=None):
    """{"porosity": [p]} as a float32 tensor on ``device``
    (porosity_map.py:142-143)."""
    return {"porosity": torch.tensor([float(porosity)], dtype=torch.float32,
                                     device=resolve_device(device))}


def _conditions(grid, device):
    device = resolve_device(device)
    return array_map(lambda p: map_porosity_to_condition(p, device), grid)


def make_vertical_porosity_map(input_array, grid_size=(2, 2),
                               method: str = "linear",
                               as_condition: bool = True, device=None):
    """(porosity_map.py:146-158)"""
    interp = interpolate_array(input_array, method=method)
    grid = np.ones(grid_size)[..., None] * interp[None, None, :]
    if as_condition:
        return _conditions(grid, device)
    return grid.astype(np.float32)


def get_grid_center(sizes, grid):
    """(porosity_map.py:161-167)"""
    xs = []
    for size, g in zip(sizes, grid):
        x = np.linspace(0, size, g + 1)
        xs.append((x[:-1] + x[1:]) / 2)
    return np.meshgrid(*xs)


def matern_grid_sample(sizes, grid, mean_val, params, nsamples: int = 1,
                       as_condition: bool = False, seed: int | None = None,
                       device=None):
    """Sample logistic-squashed Matern porosity fields on a grid
    (porosity_map.py:170-177): [nsamples, *grid], or an object array of
    condition dicts of that shape when ``as_condition``."""
    centers = get_grid_center(sizes, grid)
    centers = np.array(centers).T.reshape(-1, len(sizes))
    gp = MaternFieldSampler(centers, mean_val, params, seed=seed)
    samples = gp.sample(nsamples)
    samples = np.exp(samples) / (1 + np.exp(samples))
    samples = samples.reshape(nsamples, *grid)
    if as_condition:
        return _conditions(samples, device)
    return samples


__all__ = ["MaternFieldSampler", "array_map", "get_grid_center",
           "interpolate_array", "make_vertical_porosity_map",
           "map_porosity_to_condition", "matern_grid_sample"]
