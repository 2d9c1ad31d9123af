"""Generative-model evaluation metrics: FID, KID, FLD and basic sample
statistics.

Port of ``diffsci_tpu/metrics.py``. The reference keeps metrics out of the
library (its ``diffsci/metrics/__init__.py`` is an empty placeholder; FID
comes from torchmetrics inside eval scripts). This module provides the
metric math with a pluggable feature extractor: any ``features_fn(x) ->
[N, D]`` (the pytorch-fid InceptionV3 of ``metrics_inception``, a trained
``MinimalResNet``'s pooled trunk through ``classifier_features_fn``, or
identity features for toy data). Frechet and kernel distances follow the
standard definitions (Heusel et al. 2017; Binkowski et al. 2018).

The Frechet and kernel distances are host math in float64 numpy/scipy, as
in the JAX package. FLD's distances and its mixture fit run on the device
in float32 (the card unless ``device="cpu"``); its squared distances come
from a float64 product rounded to f32, whatever the global TF32 setting
says, since TF32's 10-bit products would swamp the distances of
standardized 2048-d features.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import scipy.linalg
import torch

from diffsci_tpu_torch.utils import resolve_device


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def feature_statistics(features) -> tuple[np.ndarray, np.ndarray]:
    """Mean and covariance of a feature matrix [N, D]."""
    f = _numpy(features).astype(np.float64)
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID core: ||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)). A non-finite
    square root is retried with ``eps`` added to both diagonals; the
    imaginary part of the root is dropped."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def fid(real_features, fake_features) -> float:
    """Frechet distance between two feature sets [N, D]."""
    mu1, s1 = feature_statistics(real_features)
    mu2, s2 = feature_statistics(fake_features)
    return frechet_distance(mu1, s1, mu2, s2)


def kid(real_features, fake_features, degree: int = 3,
        gamma: Optional[float] = None, coef: float = 1.0) -> float:
    """Kernel Inception Distance: unbiased MMD^2 with a polynomial kernel
    k(x, y) = (gamma x.y + coef)^degree, gamma = 1/D by default."""
    x = _numpy(real_features).astype(np.float64)
    y = _numpy(fake_features).astype(np.float64)
    d = x.shape[1]
    g = gamma if gamma is not None else 1.0 / d

    def k(a, b):
        return (g * (a @ b.T) + coef) ** degree

    m, n = x.shape[0], y.shape[0]
    kxx = k(x, x)
    kyy = k(y, y)
    kxy = k(x, y)
    sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    sum_xy = kxy.mean()
    return float(sum_xx + sum_yy - 2 * sum_xy)


def fid_from_samples(real, fake, features_fn: Callable,
                     batch_size: int = 256) -> float:
    """FID over raw samples with a batched feature extractor."""
    def extract(x):
        out = []
        for i in range(0, x.shape[0], batch_size):
            out.append(_numpy(features_fn(x[i:i + batch_size])))
        return np.concatenate(out, axis=0)

    return fid(extract(real), extract(fake))


def classifier_features_fn(classifier) -> Callable:
    """Penultimate-layer feature extractor from a trained ``MinimalResNet``
    (``models/nets/classifiers.py``): its ``features``, the global-pooled
    trunk activations before the linear head. The returned function takes
    channels-last samples [N, *spatial, C] (numpy or a tensor, as the
    samplers return them) and gives [N, D] on the classifier's device."""
    device = next(classifier.parameters()).device

    @torch.no_grad()
    def features(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        return classifier.features(x.movedim(-1, 1))
    return features


# ---------------------------------------------------------------------------
# FLD (Feature Likelihood Divergence)
# ---------------------------------------------------------------------------
def _pairwise_sq_dists(a, b, chunk: int = 2048):
    """||a_i - b_j||^2 as [M, N] f32 on a's device, chunked over rows to
    bound memory. The norms and the product are taken in float64 and
    rounded to f32 after: no global TF32 setting reaches a double product
    (toggling one here would mix torch's two precision APIs for the
    caller), and its rounding is below f32's."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device).double()
    b_sq = (b * b).sum(1)
    out = []
    for i in range(0, a.shape[0], chunk):
        ai = a[i:i + chunk].double()
        d2 = (ai * ai).sum(1)[:, None] + b_sq[None, :] - 2.0 * (ai @ b.T)
        out.append(d2.clamp_min(0.0).float())
    return torch.cat(out, 0)


def _mog_log_likelihood(dist2, log_sigma2, d):
    """log p(x_i) under (1/N) sum_j Normal(g_j, sigma_j^2 I_d), given the
    precomputed squared distances dist2 [M, N]."""
    inv = torch.exp(-log_sigma2)
    ll = (-0.5 * d * (math.log(2.0 * math.pi) + log_sigma2)[None, :]
          - 0.5 * dist2 * inv[None, :])
    return torch.logsumexp(ll, 1) - math.log(dist2.shape[1])


def fit_mog_bandwidths(centers, fit_features, n_iters: int = 200,
                       lr: float = 0.1, device=None):
    """Per-center isotropic log-variances of a Gaussian mixture centered at
    ``centers``, fit by maximizing the mean log-likelihood of
    ``fit_features`` (Adam on log sigma^2, ``n_iters`` steps with no host
    sync between them). Returns (log_sigma2 [N], mean_fit_nll), both
    tensors on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    centers = torch.as_tensor(centers, dtype=torch.float32, device=device)
    fit = torch.as_tensor(fit_features, dtype=torch.float32, device=device)
    d = centers.shape[1]
    with torch.no_grad():
        dist2 = _pairwise_sq_dists(fit, centers)
        # init: per-center mean squared distance to the fit set, per dim
        ls = torch.log(dist2.mean(0) / d + 1e-6)
    ls.requires_grad_(True)
    opt = torch.optim.Adam([ls], lr=lr)

    def loss():
        return -_mog_log_likelihood(dist2, ls, d).mean()

    with torch.enable_grad():
        for _ in range(n_iters):
            opt.zero_grad(set_to_none=False)
            loss().backward()
            opt.step()
    ls = ls.detach()
    with torch.no_grad():
        return ls, -_mog_log_likelihood(dist2, ls, d).mean()


def _standardized(train, *others):
    """The sets in float32, standardized by the train set's statistics
    (host numpy, as the JAX package does)."""
    train = _numpy(train).astype(np.float32)
    others = [_numpy(o).astype(np.float32) for o in others]
    mu, std = train.mean(0), train.std(0) + 1e-8
    return [(x - mu) / std for x in (train, *others)]


def _nll(points, centers, log_sigma2, d) -> float:
    d2 = _pairwise_sq_dists(points, centers)
    return -float(_mog_log_likelihood(d2, log_sigma2, d).mean())


@torch.no_grad()
def fld(train_features, test_features, gen_features,
        n_iters: int = 200, lr: float = 0.1,
        max_fit_points: int = 10000, seed: int = 0, device=None) -> float:
    """Feature Likelihood Divergence (Jiralerspong et al., NeurIPS 2023).

    A Gaussian mixture centered at the generated features with per-sample
    isotropic bandwidths is fit to maximize the likelihood of the TRAIN
    features, then scored by its negative log-likelihood on the held-out
    TEST features. Copying training points collapses those bandwidths
    during the train fit and is then punished by the test NLL:

        FLD = 100/d * (NLL_test[MoG(gen)] - NLL_test[MoG(train subset)])

    where the baseline mixture is centered on a disjoint train subset and
    fit and scored identically, so a perfect model scores ~0 and higher
    is worse. Features are standardized by train statistics first; the
    subsets come from ``np.random.RandomState(seed)``, as in the JAX
    package. The fits run on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    train, test, gen = _standardized(train_features, test_features,
                                     gen_features)
    d = train.shape[1]

    perm = rng.permutation(train.shape[0])
    n_base = min(gen.shape[0], train.shape[0] // 2)
    base_centers = train[perm[:n_base]]
    fit_idx = perm[n_base:][:max_fit_points]
    fit_set = torch.as_tensor(train[fit_idx], device=device)
    test = torch.as_tensor(test, device=device)

    def test_nll(centers):
        centers = torch.as_tensor(centers, device=device)
        ls, _ = fit_mog_bandwidths(centers, fit_set, n_iters, lr, device)
        return _nll(test, centers, ls, d)

    return 100.0 / d * (test_nll(gen) - test_nll(base_centers))


@torch.no_grad()
def fld_generalization_gap(train_features, gen_features,
                           n_iters: int = 200, lr: float = 0.1,
                           max_fit_points: int = 10000,
                           seed: int = 0, device=None) -> float:
    """Per-dim NLL gap (held-out train half minus fit half) of the
    generated-feature mixture, the paper's memorization diagnostic: a
    model that copies its training data fits that half far better than
    the disjoint half, driving the gap up."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    train, gen = _standardized(train_features, gen_features)
    d = train.shape[1]

    perm = rng.permutation(train.shape[0])
    half = train.shape[0] // 2
    fit_set = train[perm[:half]][:max_fit_points]
    held = torch.as_tensor(train[perm[half:]][:max_fit_points],
                           device=device)
    gen = torch.as_tensor(gen, device=device)

    ls, fit_nll = fit_mog_bandwidths(gen, fit_set, n_iters, lr, device)
    return 100.0 / d * (_nll(held, gen, ls, d) - float(fit_nll))


def sample_statistics(samples) -> dict[str, float]:
    """Cheap distributional statistics for parity checks."""
    s = _numpy(samples).astype(np.float64)
    return {
        "mean": float(s.mean()),
        "std": float(s.std()),
        "min": float(s.min()),
        "max": float(s.max()),
        "skew": float(((s - s.mean()) ** 3).mean() / (s.std() ** 3 + 1e-12)),
        "kurtosis": float(((s - s.mean()) ** 4).mean()
                          / (s.std() ** 4 + 1e-12) - 3.0),
    }


__all__ = ["classifier_features_fn", "feature_statistics", "fid",
           "fid_from_samples", "fit_mog_bandwidths", "fld",
           "fld_generalization_gap", "frechet_distance", "kid",
           "sample_statistics"]
