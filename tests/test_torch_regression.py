"""The port's deterministic forecaster (``diffsci_tpu_torch/models/
regression.py``) against the reference fixture ``forecast_loss.npz``
(five losses: masks 1 = include, the spatial weight map, the mean over
all elements; ``tests/test_reference_parity4.py``'s bounds) and against
the JAX package: a two-convolution head's loss, ``predict`` and chunked
``sample``, and two ``make_train_step`` steps against the JAX package's;
and, port-only, a latent forecaster through an autoencoder.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn as nn

import flax.linen as fnn
import jax
import jax.numpy as jnp

from diffsci_tpu.models.karras import train as jtrain
from diffsci_tpu.models.regression import ForecastModel as JForecastModel
from diffsci_tpu.models.regression import \
    ForecastModelConfig as JForecastModelConfig

from diffsci_tpu_torch import (ForecastModel, ForecastModelConfig,
                               create_train_state, make_train_step)
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


class ConstModel(nn.Module):
    """A fixed prediction [B, C, H, W] (the network's layout), so the loss
    math is pinned without a shared network."""

    def __init__(self, pred):
        super().__init__()
        self.register_buffer("pred", _t(pred))
        self.d = nn.Parameter(torch.zeros(()))

    def forward(self, yc, y=None):
        return self.pred + 0.0 * self.d


CASES = {"mse": ("mse", False, False), "huber": ("huber", False, False),
         "mse_masked": ("mse", True, False),
         "mse_weighted": ("mse", False, True),
         "mse_masked_weighted": ("mse", True, True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forecast_loss_fixture(case):
    """ForecastModel.loss_fn: channels-last targets and mask (the
    fixture's NCHW arrays moved), the weight map [H, W]; rtol 5e-4, atol
    1e-7."""
    d = np.load(os.path.join(FIXDIR, "forecast_loss.npz"))
    metric, masked, weighted = CASES[case]
    cfg = ForecastModelConfig(loss_metric=metric,
                              spatial_weight_map=d["wmap"] if weighted
                              else None)
    model = ForecastModel(ConstModel(d["pred"]), cfg, conditional=True,
                          masked=masked, device="cpu")
    target = _t(d["target"].transpose(0, 2, 3, 1))
    mask = _t(d["mask"].transpose(0, 2, 3, 1)) if masked else None
    loss = model.loss_fn(target, torch.zeros(3, 1), mask, train=False)
    np.testing.assert_allclose(float(loss.detach()),
                               float(d[f"loss_{case}"]), rtol=5e-4, atol=1e-7)


class JHead(fnn.Module):
    @fnn.compact
    def __call__(self, x, y=None, train=False):
        h = fnn.Conv(8, (3, 3), padding="SAME")(x)
        return fnn.Conv(1, (3, 3), padding="SAME")(fnn.silu(h))


class Head(nn.Module):
    """``JHead`` on [B, C, H, W]."""

    def __init__(self, cin=2, width=8, cout=1):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, width, 3, padding=1)
        self.conv1 = nn.Conv2d(width, cout, 3, padding=1)

    def forward(self, yc, y=None):
        return self.conv1(nn.functional.silu(self.conv0(yc)))


def _head_state(params) -> dict:
    out = {}
    for i in range(2):
        p = params[f"Conv_{i}"]
        out[f"conv{i}.weight"] = _t(np.asarray(p["kernel"]).transpose(
            3, 2, 0, 1))
        out[f"conv{i}.bias"] = _t(p["bias"])
    return out


def _pair(cfg_kw):
    jmodel = JForecastModel(JHead(), JForecastModelConfig(**cfg_kw),
                            conditional=True)
    rng = np.random.default_rng(2)
    yc = rng.standard_normal((4, 8, 8, 2)).astype(np.float32)
    x = rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), {"y": jnp.asarray(yc)})
    model = ForecastModel(Head(), ForecastModelConfig(**cfg_kw),
                          conditional=True, device="cpu")
    model.net.model.load_state_dict(_head_state(variables["params"]))
    return jmodel, variables, model, yc, x


@pytest.mark.parametrize("metric", ["mse", "huber"])
def test_forecast_head_matches_jax(metric):
    """A two-convolution head: the loss with a mask and a weight map
    (rtol 1e-5), ``predict`` and ``sample(maximum_batch_size=3)`` (rtol
    1e-5, atol 1e-6; chunked equals whole)."""
    wmap = np.random.default_rng(3).uniform(size=(8, 8)).astype(np.float32)
    jmodel, variables, model, yc, x = _pair(
        dict(loss_metric=metric, spatial_weight_map=wmap))
    mask = (np.random.default_rng(4).uniform(size=x.shape) > 0.3).astype(
        np.float32)
    ref = jmodel.loss_fn(variables, jax.random.PRNGKey(1), jnp.asarray(x),
                         {"y": jnp.asarray(yc)}, jnp.asarray(mask),
                         train=False)
    ours = model.loss_fn(_t(x), {"y": _t(yc)}, _t(mask), train=False)
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-5)
    jpred = jmodel.predict(variables, {"y": jnp.asarray(yc)})
    pred = model.predict({"y": _t(yc)})
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5,
                               atol=1e-6)
    chunked = model.sample({"y": _t(yc)}, maximum_batch_size=3)
    np.testing.assert_allclose(chunked.numpy(), pred.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_forecast_train_steps_match_jax():
    """Two ``make_train_step`` steps of a ``ForecastModel`` (the default
    AdamW with clip 0.5; the σ slot holds zeros) against the JAX package's
    ``make_train_step`` over its forecast loss: losses within 1e-5,
    parameters within PR 17's 2e-3 relative bound."""
    jmodel, variables, model, yc, x = _pair(dict(loss_metric="huber"))
    params, consts = jtrain.split_variables(variables)
    jtx = jtrain.default_optimizer()
    jstate = jtrain.TrainState(params=params, consts=consts,
                               opt_state=jtx.init(params), ema=None,
                               step=jnp.zeros((), jnp.int32))

    def jloss(v, key, xx, y, mask, train=True):
        return jmodel.loss_fn(v, key, xx, y, mask, train), {}

    jstep = jax.jit(jtrain.make_train_step(jmodel, jtx, loss_fn=jloss,
                                           _raw=True))
    state, tx = create_train_state(model, x.shape, seed=None)
    step = make_train_step(model, tx, loss_fn=lambda xx, s, y, mask, eps:
                           model.loss_fn(xx, y, mask))
    for k in range(2):
        jstate, jmet = jstep(jstate, jax.random.PRNGKey(k), jnp.asarray(x),
                             {"y": jnp.asarray(yc)})
        _, met = step(state, _t(x), {"y": _t(yc)},
                      generator=torch.Generator().manual_seed(k))
        np.testing.assert_allclose(float(met["train_loss"]),
                                   float(jmet["train_loss"]), rtol=1e-5)
    ref = _head_state(jstate.params)
    for k, v in model.net.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=2e-3,
                                   atol=2e-3 * float(ref[k].abs().max()),
                                   err_msg=k)


class PoolAutoencoder:
    """A fixed autoencoder on [B, C, H, W]: 2×2 mean pooling and its
    nearest-neighbour inverse, times 4 channels."""
    sample_posterior = False

    def encode(self, x, y=None, eps=None):
        return nn.functional.avg_pool2d(x, 2).repeat(1, 4, 1, 1)

    def decode(self, z, y=None):
        return nn.functional.interpolate(z[:, :1], scale_factor=2)


def test_latent_forecaster_encodes_and_decodes():
    """A latent forecaster: the loss compares the prediction with the
    encoded target / norm (channels-last), ``latent_shape`` is the
    encoder's, and ``predict`` decodes the prediction · norm."""
    head = Head(cin=4, cout=4)
    model = ForecastModel(head, ForecastModelConfig(loss_metric="mse",
                                                    norm=2.0),
                          autoencoder=PoolAutoencoder(), device="cpu")
    model.init(0)
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((2, 8, 8, 1)))
    yc = _t(rng.standard_normal((2, 4, 4, 4)))
    assert model.latent_shape(x.shape) == (2, 4, 4, 4)
    with torch.no_grad():
        pred = head(yc.movedim(-1, 1)).movedim(1, -1)
        z = PoolAutoencoder().encode(x.movedim(-1, 1)).movedim(1, -1) / 2.0
        torch.testing.assert_close(model.loss_fn(x, {"y": yc}, train=False),
                                   ((pred - z) ** 2).mean())
        out = model.predict({"y": yc})
    ref = PoolAutoencoder().decode((pred * 2.0).movedim(-1, 1)).movedim(1,
                                                                        -1)
    torch.testing.assert_close(out, ref)
    torch.testing.assert_close(model.predict({"y": yc}, return_latent=True),
                               pred)
