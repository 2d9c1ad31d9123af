"""Analytic toy distributions with closed-form scores and optimal
denoisers: the score oracles that hold the diffusion math with no network.

The port's own copy of ``diffsci_tpu/data/toy_datasets.py``, on torch
tensors. Each dataset knows the Gaussian-smoothed density
p(x; σ) = ∫ N(x; x0, σ²) p(x0) dx0 in closed form:

- ``sample(generator)``       -> [num_samples, *shape]
- ``logprob(x, sigma)``       -> [B]
- ``gradlogprob(x, sigma)``   -> [B, *shape] (the score)
- ``denoiser(x, sigma)``      -> x + σ² · score (the optimal denoiser)
- ``optimal_denoiser_predictor(x, sigma)`` -> E[x0 | x]

A dataset's tensors live on the CPU; ``x`` and ``sigma`` may be on any
device, and the dataset's constants follow them there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from diffsci_tpu_torch.utils import bcast_right

_STABILIZER = 1e-40


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def _like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t.to(device=x.device, dtype=x.dtype)


def _sum_spatial(a):
    return a.sum(dim=tuple(range(1, a.ndim)))


def _norm_cdf(z):
    return 0.5 * torch.special.erfc(-z / math.sqrt(2.0))


def _norm_pdf(z):
    return torch.exp(-0.5 * z ** 2) / math.sqrt(2.0 * math.pi)


class AnalyticalDataset:
    """Base class: subclasses define shape, sampling and the smoothed
    score."""

    def __init__(self, num_samples: int, shape):
        self.num_samples = num_samples
        self.shape = tuple(shape)

    @property
    def ndim_data(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    def sample(self, generator=None) -> torch.Tensor:
        raise NotImplementedError

    def logprob(self, x, sigma):
        raise NotImplementedError

    def gradlogprob(self, x, sigma):
        raise NotImplementedError

    def denoiser(self, x, sigma):
        """Optimal denoiser D(x; σ) = x + σ² · score."""
        return x + bcast_right(sigma, x) ** 2 * self.gradlogprob(x, sigma)

    def optimal_denoiser_predictor(self, x, sigma, scale=None):
        raise NotImplementedError

    def optimal_noise_predictor(self, x, sigma, scale=None):
        """ε-prediction from the posterior mean."""
        x0 = self.optimal_denoiser_predictor(x, sigma, scale=scale)
        if scale is not None:
            x0 = x0 * bcast_right(scale, x0)
        return (x - x0) / bcast_right(sigma, x0)

    def __len__(self):
        return self.num_samples


class SinglePointDataset(AnalyticalDataset):
    """Dirac delta at x0."""

    def __init__(self, num_samples: int, x0):
        x0 = _f32(x0)
        super().__init__(num_samples, x0.shape)
        self.x0 = x0

    def sample(self, generator=None):
        return self.x0.expand((self.num_samples,) + self.shape).clone()

    def logprob(self, x, sigma):
        sqnorm = _sum_spatial((x - _like(self.x0, x)) ** 2)
        sigma_flat = sigma.reshape(sigma.shape[0])
        return (-0.5 * sqnorm / sigma_flat ** 2
                - self.ndim_data / 2 * torch.log(2 * math.pi
                                                 * sigma_flat ** 2))

    def gradlogprob(self, x, sigma):
        return -(x - _like(self.x0, x)) / bcast_right(sigma, x) ** 2

    def optimal_denoiser_predictor(self, x, sigma, scale=None):
        return _like(self.x0, x).expand(x.shape)


class ZeroDataset(SinglePointDataset):
    """Point mass at the origin."""

    def __init__(self, num_samples: int, shape):
        super().__init__(num_samples, np.zeros(shape))


class SingleGaussianDataset(AnalyticalDataset):
    """Isotropic Gaussian at x0 with std ``scale``."""

    def __init__(self, num_samples: int, x0, scale: float = 1.0):
        x0 = _f32(x0)
        super().__init__(num_samples, x0.shape)
        self.x0 = x0
        self.scale = scale

    def sample(self, generator=None):
        shape = (self.num_samples,) + self.shape
        return self.x0 + self.scale * torch.randn(shape, generator=generator)

    def logprob(self, x, sigma):
        var = sigma ** 2 + self.scale ** 2
        sqnorm = _sum_spatial((x - _like(self.x0, x)) ** 2)
        return (-0.5 * sqnorm / var
                - self.ndim_data / 2 * torch.log(2 * math.pi * var))

    def gradlogprob(self, x, sigma):
        var = bcast_right(sigma, x) ** 2 + self.scale ** 2
        return -(x - _like(self.x0, x)) / var

    def optimal_denoiser_predictor(self, x, sigma, scale=None):
        var = bcast_right(sigma, x) ** 2
        w = self.scale ** 2 / (self.scale ** 2 + var)
        x0 = _like(self.x0, x)
        return x0 + w * (x - x0)


class ZeroMeanGaussianDataset(SingleGaussianDataset):
    def __init__(self, num_samples: int, shape, scale: float = 1.0):
        super().__init__(num_samples, np.zeros(shape), scale=scale)


class MixtureOfPointsDataset(AnalyticalDataset):
    """Discrete distribution over ``points`` with ``weights``."""

    def __init__(self, num_samples: int, points, weights):
        points, weights = _f32(points), _f32(weights)
        super().__init__(num_samples, points.shape[1:])
        self.points = points
        self.weights = weights / weights.sum()

    def sample(self, generator=None):
        idx = torch.multinomial(self.weights, self.num_samples,
                                replacement=True, generator=generator)
        return self.points[idx]

    def _log_responsibilities(self, x, sigma):
        diff = x[:, None] - _like(self.points, x)[None]  # [b, n, *shape]
        norm2 = diff.pow(2).sum(dim=tuple(range(2, diff.ndim)))  # [b, n]
        logr = (-0.5 * norm2 / sigma[:, None] ** 2
                + torch.log(_like(self.weights, x)))
        return logr, diff

    def logprob(self, x, sigma):
        logr, _ = self._log_responsibilities(x, sigma)
        return (torch.logsumexp(logr, dim=1)
                - self.ndim_data / 2 * torch.log(2 * math.pi * sigma ** 2))

    def gradlogprob(self, x, sigma):
        logr, diff = self._log_responsibilities(x, sigma)
        r = torch.softmax(logr, dim=1)
        terms = -diff / bcast_right(sigma, diff) ** 2
        return (bcast_right(r, terms) * terms).sum(dim=1)

    def optimal_denoiser_predictor(self, x, sigma, scale=None):
        p = _like(self.points, x)[None]
        if scale is not None:
            p = p * bcast_right(scale, p)
        diff = x[:, None] - p
        norm2 = diff.pow(2).sum(dim=tuple(range(2, diff.ndim)))
        logr = (-0.5 * norm2 / bcast_right(sigma, norm2) ** 2
                + torch.log(_like(self.weights, x)))
        r = torch.softmax(logr, dim=1)
        return (bcast_right(r, p) * p).sum(dim=1)


class MixtureOfGaussiansDataset(AnalyticalDataset):
    """Mixture of isotropic Gaussians with a shared or per-component
    scale."""

    def __init__(self, num_samples: int, means, weights, scale=1.0):
        means, weights = _f32(means), _f32(weights)
        super().__init__(num_samples, means.shape[1:])
        self.means = means
        self.weights = weights / weights.sum()
        self.scale = _f32(scale).expand(means.shape[0]).clone()

    def sample(self, generator=None):
        idx = torch.multinomial(self.weights, self.num_samples,
                                replacement=True, generator=generator)
        mean = self.means[idx]
        scale = bcast_right(self.scale[idx], mean)
        return mean + scale * torch.randn(mean.shape, generator=generator)

    def _component_stats(self, x, sigma):
        means, scale = _like(self.means, x), _like(self.scale, x)
        diff = x[:, None] - means[None]  # [b, n, *shape]
        norm2 = diff.pow(2).sum(dim=tuple(range(2, diff.ndim)))  # [b, n]
        var = sigma[:, None] ** 2 + scale[None] ** 2  # [b, n]
        loglik = (-0.5 * norm2 / var
                  - self.ndim_data / 2 * torch.log(2 * math.pi * var))
        return diff, var, loglik + torch.log(_like(self.weights, x))

    def logprob(self, x, sigma):
        _, _, logjoint = self._component_stats(x, sigma)
        return torch.logsumexp(logjoint, dim=1)

    def gradlogprob(self, x, sigma):
        diff, var, logjoint = self._component_stats(x, sigma)
        r = torch.softmax(logjoint, dim=1)
        terms = -diff / bcast_right(var, diff)
        return (bcast_right(r, terms) * terms).sum(dim=1)

    def optimal_denoiser_predictor(self, x, sigma, scale=None):
        means = _like(self.means, x)[None]
        if scale is not None:
            means = means * bcast_right(scale, means)
        diff, var, logjoint = self._component_stats(x, sigma)
        r = torch.softmax(logjoint, dim=1)  # [b, n]
        sig2 = bcast_right(sigma, diff) ** 2
        s2 = bcast_right(_like(self.scale, x)[None] ** 2, diff)
        comp_mean = means + s2 / (s2 + sig2) * diff
        return (bcast_right(r, comp_mean) * comp_mean).sum(dim=1)


class DiagonalGaussianDataset(AnalyticalDataset):
    """Single Gaussian with diagonal covariance diag(stds²)."""

    def __init__(self, num_samples: int, mean, stds):
        mean, stds = _f32(mean), _f32(stds)
        super().__init__(num_samples, mean.shape)
        self.mean = mean
        self.stds = stds

    def sample(self, generator=None):
        shape = (self.num_samples,) + self.shape
        return self.mean + self.stds * torch.randn(shape, generator=generator)

    def logprob(self, x, sigma):
        stds, mean = _like(self.stds, x), _like(self.mean, x)
        var = bcast_right(sigma, x) ** 2 + stds ** 2
        sq = (x - mean) ** 2 / var
        return -0.5 * _sum_spatial(sq + torch.log(2 * math.pi * var))

    def gradlogprob(self, x, sigma):
        stds, mean = _like(self.stds, x), _like(self.mean, x)
        var = bcast_right(sigma, x) ** 2 + stds ** 2
        return -(x - mean) / var

    def optimal_denoiser_predictor(self, x, sigma, scale=None):
        stds, mean = _like(self.stds, x), _like(self.mean, x)
        var = bcast_right(sigma, x) ** 2
        w = stds ** 2 / (stds ** 2 + var)
        return mean + w * (x - mean)


class Single1DUniformDataset(AnalyticalDataset):
    """Uniform on [a, b] in 1D:
    p(x; σ) = (Φ((x-a)/σ) - Φ((x-b)/σ)) / (b - a)."""

    def __init__(self, num_samples: int, a: float = 0.0, b: float = 1.0):
        super().__init__(num_samples, (1,))
        self.a = a
        self.b = b

    def sample(self, generator=None):
        u = torch.rand((self.num_samples,) + self.shape, generator=generator)
        return self.a + (self.b - self.a) * u

    def _cdf_terms(self, x, sigma):
        sigma = bcast_right(sigma, x)
        return (x - self.a) / sigma, (x - self.b) / sigma, sigma

    def logprob(self, x, sigma):
        za, zb, _ = self._cdf_terms(x, sigma)
        p = (_norm_cdf(za) - _norm_cdf(zb)) / (self.b - self.a)
        return torch.log(p + _STABILIZER).reshape(x.shape[0])

    def gradlogprob(self, x, sigma):
        za, zb, sigma_ = self._cdf_terms(x, sigma)
        num = _norm_pdf(za) - _norm_pdf(zb)
        den = _norm_cdf(za) - _norm_cdf(zb)
        return num / (sigma_ * (den + _STABILIZER))

    def optimal_denoiser_predictor(self, x, sigma, scale=None):
        return self.denoiser(x, sigma)


class MixtureOf1DUniformsDataset(AnalyticalDataset):
    """Weighted mixture of 1D uniforms over ``intervals`` [n, 2]."""

    def __init__(self, num_samples: int, intervals, weights):
        super().__init__(num_samples, (1,))
        self.intervals = _f32(intervals)
        weights = _f32(weights)
        self.weights = weights / weights.sum()

    def sample(self, generator=None):
        idx = torch.multinomial(self.weights, self.num_samples,
                                replacement=True, generator=generator)
        a = self.intervals[idx, 0:1]
        b = self.intervals[idx, 1:2]
        u = torch.rand((self.num_samples, 1), generator=generator)
        return a + (b - a) * u

    def _component_probs(self, x, sigma):
        sigma = sigma.reshape(-1, 1)
        intervals = _like(self.intervals, x)
        a = intervals[None, :, 0]  # [1, n]
        b = intervals[None, :, 1]
        za = (x - a) / sigma
        zb = (x - b) / sigma
        p = (_norm_cdf(za) - _norm_cdf(zb)) / (b - a)
        dp = (_norm_pdf(za) - _norm_pdf(zb)) / (sigma * (b - a))
        return p, dp

    def logprob(self, x, sigma):
        p, _ = self._component_probs(x, sigma)
        mix = (_like(self.weights, x) * p).sum(dim=1)
        return torch.log(mix + _STABILIZER)

    def gradlogprob(self, x, sigma):
        p, dp = self._component_probs(x, sigma)
        w = _like(self.weights, x)
        mix = (w * p).sum(dim=1, keepdim=True)
        dmix = (w * dp).sum(dim=1, keepdim=True)
        return dmix / (mix + _STABILIZER)

    def optimal_denoiser_predictor(self, x, sigma, scale=None):
        return self.denoiser(x, sigma)


class ShapesDataset:
    """Synthetic geometric-shapes images for diffusion smoke training and
    morphing studies: host-side numpy generation, channels-last
    [N, size, size, 1], values in {-1, +1}.

    mode='paper_replica': three column slots, each independently populated
    (p = 0.5) with a triangle / square / disk at a jittered row position.
    mode='geometry_test': one centred square or disk (p = 0.5 each).
    """

    def __init__(self, num_samples: int, size: int = 64,
                 mode: str = "paper_replica", polygon_size: int = 8,
                 seed: int = 0):
        if mode not in ("paper_replica", "geometry_test"):
            raise ValueError(f"unknown mode: {mode!r}")
        self.num_samples = num_samples
        self.size = size
        self.mode = mode
        self.polygon_size = polygon_size
        self.seed = seed
        self.shape = (size, size, 1)

    def _disk(self, img, cy, cx, r):
        yy, xx = np.mgrid[0:self.size, 0:self.size]
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1.0

    def _square(self, img, cy, cx, r):
        img[max(0, cy - r):cy + r, max(0, cx - r):cx + r] = 1.0

    def _triangle(self, img, cy, cx, r):
        yy, xx = np.mgrid[0:self.size, 0:self.size]
        h = yy - (cy - r)
        img[(h >= 0) & (h <= 2 * r) & (np.abs(xx - cx) <= h / 2)] = 1.0

    def generate(self) -> np.ndarray:
        return self.generate_labeled()[0]

    def generate_labeled(self) -> tuple[np.ndarray, np.ndarray]:
        """(images, labels): paper_replica labels are the [N, 3] slot
        occupancy (triangle, square, disk), geometry_test labels [N]
        0 = square, 1 = disk."""
        rng = np.random.default_rng(self.seed)
        s, r = self.size, self.polygon_size
        out = np.zeros((self.num_samples, s, s, 1), np.float32)
        labels = np.zeros(
            (self.num_samples, 3) if self.mode == "paper_replica"
            else (self.num_samples,), np.float32)
        for i in range(self.num_samples):
            img = out[i, :, :, 0]
            if self.mode == "paper_replica":
                cols = [s // 4, s // 2, 3 * s // 4]
                draw = [self._triangle, self._square, self._disk]
                for slot in range(3):
                    if rng.random() > 0.5:
                        cy = int(rng.integers(r + 1, s - r - 1))
                        draw[slot](img, cy, cols[slot], r)
                        labels[i, slot] = 1.0
            else:
                c, rad = s // 2, s // 4
                if rng.random() > 0.5:
                    self._square(img, c, c, rad)
                else:
                    self._disk(img, c, c, rad)
                    labels[i] = 1.0
        return out * 2.0 - 1.0, labels

    def sample(self, generator=None) -> torch.Tensor:
        """The images as a tensor; the dataset's own ``seed`` sets them."""
        return torch.from_numpy(self.generate())
