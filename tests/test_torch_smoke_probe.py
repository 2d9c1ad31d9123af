"""``chip_smoke.py``'s training probe on a model with the EDM batch norm.

``chip_smoke.train`` holds a training run to a fixed-draw loss that must
fall. A probe outside training normalises x by the EDM batch norm's
running statistics, which training moves from their initial 0 and 1
toward the batch's own, so the probes before and after training scored
the denoiser against two different targets (configuration D's {0, 1}
volumes, then their standardised values) and the gate passed or failed
with the rounding of a run. ``batch_statistics_of`` normalises both probes
by the batch's own statistics, as the train step does.
"""

import numpy as np
import torch

import chip_smoke
from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                               PUNetGConfig)
from tests import _torch_warmup  # noqa: F401  (MKL's first exp, CPU threads)


def _model_and_batch():
    model = KarrasModel(
        PUNetG(PUNetGConfig(dimension=2, model_channels=8,
                            channel_expansion=[2]), device="cpu"),
        KarrasModelConfig.from_edm(has_edm_batch_norm=True), device="cpu")
    model.init(0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.random((4, 16, 16, 1)) < 0.3)
                         .astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    sigma = model.config.noisesampler.sample((4,), gen)
    eps = torch.randn(x.shape, generator=gen)
    return model, x, sigma, eps


def _probe(model, x, sigma, eps):
    with torch.no_grad(), chip_smoke.batch_statistics_of(model, x):
        return float(model.loss_fn(x, sigma, eps=eps, train=False))


def test_probe_does_not_follow_the_running_statistics():
    """The same weights give the same probe whatever the running
    statistics hold, where a probe by the running statistics moves by
    more than a tenth between the initial ones and nine tenths of the
    batch's; it equals the train step's normalisation, and the running
    statistics come back unchanged."""
    model, x, sigma, eps = _model_and_batch()
    bnorm = model.net.bnorm
    start = _probe(model, x, sigma, eps)
    with torch.no_grad():
        raw = float(model.loss_fn(x, sigma, eps=eps, train=False))
        trained = float(model.loss_fn(x, sigma, eps=eps, train=True))
        mean, var = bnorm.batch_statistics(x)
        bnorm.mean.copy_(0.9 * mean)
        bnorm.var.copy_(0.1 + 0.9 * var)
        moved = float(model.loss_fn(x, sigma, eps=eps, train=False))
    assert abs(moved - raw) > 0.1 * raw
    assert _probe(model, x, sigma, eps) == start == trained
    assert torch.equal(bnorm.mean, 0.9 * mean)
    assert torch.equal(bnorm.var, 0.1 + 0.9 * var)


def test_probe_of_a_model_without_batch_norm_is_unchanged():
    """Without the batch norm the helper does nothing."""
    model = KarrasModel(
        PUNetG(PUNetGConfig(dimension=2, model_channels=8,
                            channel_expansion=[2]), device="cpu"),
        KarrasModelConfig.from_edm(), device="cpu")
    model.init(0)
    _, x, sigma, eps = _model_and_batch()
    with torch.no_grad():
        raw = float(model.loss_fn(x, sigma, eps=eps, train=False))
    assert _probe(model, x, sigma, eps) == raw
