"""No parameter or buffer of the port holds uninitialized memory.

The constructors that cannot draw their weights without a generator fill
them with NaN (``diffsci_tpu_torch.utils.unset``) until ``init``
(``init_parameters``, ``KarrasModel.init``) or a loaded state dict
overwrites them, so a forgotten ``init`` gives NaN on every run rather
than whatever ``torch.empty`` held (which once passed and once failed one
test under ``-n 6``). Each case constructs one such module at a small
width, checks that the tensors its constructor leaves to ``init`` are NaN,
then that ``init`` leaves no NaN anywhere in it.
"""

import pytest
import torch

from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

from diffsci_tpu_torch.models.karras.module import (DynamicLossWeight,
                                                    KarrasModel,
                                                    KarrasModelConfig)
from diffsci_tpu_torch.models.nets import attention, convit, dasc, layers
from diffsci_tpu_torch.models.nets import moe, normed
from diffsci_tpu_torch.models.nets.mlp import MLPUncond

# (module factory, names of the tensors its constructor leaves to init)
MODULES = {
    "MultiHeadAttention": (lambda: attention.MultiHeadAttention(8, 2),
                           ["in_proj_weight"]),
    "EinsumMultiHeadAttention": (
        lambda: attention.EinsumMultiHeadAttention(8, 2),
        [f"{n}_proj_matrix" for n in "qkvo"]),
    "CircularConv": (lambda: layers.CircularConv(2, 3, 4, 3), ["weight"]),
    "GaussianFourierProjection": (
        lambda: layers.GaussianFourierProjection(8), ["W"]),
    "GaussianFourierProjectionVector": (
        lambda: layers.GaussianFourierProjectionVector(3, 8), ["W"]),
    "ConvolutionalFourierProjection": (
        lambda: layers.ConvolutionalFourierProjection(3, 8), ["W", "bias"]),
    "ConditionDrop": (lambda: layers.ConditionDrop(0.1, 8),
                      ["null_embedding"]),
    "MagnitudePreservingDense": (
        lambda: normed.MagnitudePreservingDense(4, 6), ["weight"]),
    "MagnitudePreservingConv": (
        lambda: normed.MagnitudePreservingConv(2, 3, 4, 3), ["weight"]),
    "MoEFeedForward": (lambda: moe.MoEFeedForward(8, 4),
                       ["router", "experts_w1", "experts_w2"]),
    "LearnedRoPE": (lambda: convit.LearnedRoPE(8), ["angles"]),
    "ConVitAttention": (
        lambda: convit.ConVitAttention(8, 2),
        [f"{n}_proj_tensor" for n in ("q", "k", "v", "out")]),
    "VideoModelingModule": (
        lambda: dasc.VideoModelingModule(dasc.DASCConfig(latent_dim=8)),
        ["query"]),
    "DynamicLossWeight": (lambda: DynamicLossWeight(8),
                          ["fourier_weights", "fourier_bias"]),
}


def _tensors(module):
    return dict(module.named_parameters()) | dict(module.named_buffers())


@pytest.mark.parametrize("name", sorted(MODULES))
def test_init_leaves_no_nan(name):
    """The constructor's own tensors are NaN until init; init_parameters
    leaves no NaN in any parameter or buffer."""
    factory, unset = MODULES[name]
    module = factory()
    tensors = _tensors(module)
    for key in unset:
        assert bool(tensors[key].isnan().all()), key
    layers.init_parameters(module, 0)
    for key, t in _tensors(module).items():
        if t.is_floating_point():
            assert not bool(t.isnan().any()), key


def test_karras_model_init_leaves_no_nan():
    """KarrasModel.init draws the network and the dynamic loss weight's
    Fourier buffers, which are NaN before it."""
    model = KarrasModel(MLPUncond(2, (8,), device="cpu"),
                        KarrasModelConfig.from_edm(dynamic_loss_weight=8),
                        device="cpu")
    assert bool(model.net.dlw.fourier_weights.isnan().all())
    model.init(0)
    for key, t in _tensors(model.net).items():
        if t.is_floating_point():
            assert not bool(t.isnan().any()), key
