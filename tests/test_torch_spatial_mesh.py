"""The dp × spatial step of configurations D, E and PUNetGCond's networks
(gloo ranks on the CPU, world 2 on a (1, 2) and world 4 on a (2, 2) data ×
spatial mesh) against the JAX package's single-device ``make_train_step``
on the conftest's virtual devices.

The contract is GSPMD's: the JAX package takes these networks on a
``P("data", "spatial")`` batch and gives the single-device step
(``tests/test_parallel.py:163-188``). Each pin is a small width of its
configuration, on the same weights with σ and ε replayed, at the bounds of
``tests/test_torch_parallel.py::test_spatial_step_matches_jax`` (loss rtol
1e-5, parameters rtol 1e-4 atol 1e-6; AdamW at eps 1e-4 in both packages,
``tests/_torch_steps.py``):
- D: a 3D PUNetG with circular convolutions, ``PorosityEmbedder(8)`` and
  the EDM batch norm, bottleneck attention, at batch 2 on 8³; its running
  ``mean``/``var`` after the step too (the statistics of every rank's rows
  and slabs);
- E: a 2D PUNetG with magnitude-preserving convolutions, cosine
  attention and the dynamic loss weight, at batch 4 on 16², the step with
  the mp re-projection;
- PUNetGCond with one channel condition of a single broadcast row
  ([1, 2, 16, 16], cut along its first spatial dim, its row kept on every
  data rank), at batch 4 on 16².
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import create_train_state as jcreate_train_state
from diffsci_tpu.models import make_train_step as jmake_train_step
from diffsci_tpu.models.nets import embedders as jemb
from diffsci_tpu.models.nets import punetg as jpunetg

from diffsci_tpu_torch import PUNetGConfig
from diffsci_tpu_torch.convert import from_jax_variables
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)
from tests import _torch_steps as steps
from tests._torch_ranks import result, run_ranks
from tests._torch_spatial_mesh_cases import KINDS

_BASE = dict(model_channels=8, channel_expansion=(2,),
             number_resnet_downward_block=1, number_resnet_upward_block=1,
             number_resnet_attn_block=2, number_resnet_before_attn_block=1,
             number_resnet_after_attn_block=1)
# name -> (PUNetG fields, x's shape, the condition's shape or None)
PINS = {
    "d": (dict(_BASE, dimension=3, convolution_type="circular",
               num_heads=2, attn_backend="flash"), (2, 8, 8, 8, 1), (2,)),
    "e": (dict(_BASE, convolution_type="mp", attn_type="cosine"),
          (4, 16, 16, 1), None),
    "cond": (dict(_BASE, input_channels=3), (4, 16, 16, 1), (1, 16, 16, 2)),
}


def _jax_model(name, cfg):
    config, conditional, _ = KINDS[name]
    jcfg = jpunetg.PUNetGConfig(**dict(cfg, channel_expansion=list(
        cfg["channel_expansion"])))
    if name == "d":
        net = jpunetg.PUNetG(jcfg,
                             conditional_embedding=jemb.PorosityEmbedder(8))
    elif name == "cond":
        net = jpunetg.PUNetGCond(jcfg, channel_conditional_items=["c"])
    else:
        net = jpunetg.PUNetG(jcfg)
    return JKarrasModel(net, JKarrasModelConfig.from_edm(**config),
                        conditional=conditional)


def _pin(name, rng):
    """One JAX single-device step of pin ``name``: the payload (weights,
    batch, condition, draws) and the reference (loss, norm, variables)."""
    cfg, shape, yshape = PINS[name]
    x = rng.standard_normal(shape).astype(np.float32)
    sigma = np.exp(rng.standard_normal(shape[0]) - 1.0).astype(np.float32)
    eps = rng.standard_normal(shape).astype(np.float32)
    y = None if yshape is None else (
        rng.uniform(0.2, 0.5, yshape) if name == "d"
        else rng.standard_normal(yshape)).astype(np.float32)
    jy = None if y is None else {"porosity" if name == "d" else "c":
                                 jnp.asarray(y)}
    jmodel = _jax_model(name, cfg)
    opt = optax.chain(optax.clip_by_global_norm(0.5),
                      optax.adamw(1e-3, b1=0.9, b2=0.999,
                                  eps=steps.PIN_ADAM_EPS, weight_decay=1e-4))
    jstate, jtx = jcreate_train_state(jmodel, jax.random.PRNGKey(0), shape,
                                      y=jy, optimizer=opt)
    pcfg = PUNetGConfig(**cfg)

    def sd(variables):
        return {k: v.numpy() for k, v in from_jax_variables(
            jax.tree.map(np.asarray, variables), pcfg).items()}

    def jloss(variables, key, xx, yy, replay, train=True):
        return jmodel.loss_fn(variables, key, xx, replay["sigma"], y=jy,
                              train=train, eps=replay["eps"])

    payload = dict(cfg=cfg, sd=sd(jstate.variables()), x=x, sigma=sigma,
                   eps=eps,
                   y=None if y is None else (
                       y if name == "d" else np.moveaxis(y, -1, 1).copy()))
    step = jmake_train_step(jmodel, jtx, has_mp_weights=KINDS[name][2],
                            loss_fn=jloss)
    jstate, met = step(jstate, jax.random.PRNGKey(2), jnp.asarray(x), None,
                       {"sigma": jnp.asarray(sigma), "eps": jnp.asarray(eps)})
    return payload, (float(met["train_loss"]), float(met["grad_norm"]),
                     sd(jstate.variables()))


@pytest.fixture(scope="module")
def jax_side():
    rng = np.random.default_rng(0)
    payload, ref = {}, {}
    for name in PINS:
        payload[name], ref[name] = _pin(name, rng)
    return payload, ref


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, jax_side):
    payload, ref = jax_side
    return request.param, run_ranks("tests._torch_spatial_mesh_cases",
                                    request.param, payload), payload, ref


@pytest.mark.parametrize("name", list(PINS))
def test_spatial_step_matches_jax(ranks, name):
    """Every rank's step (its slab of the batch and condition) against
    JAX's single-device step: loss, gradient norm, parameters, and D's
    batch-norm statistics."""
    world, res, payload, ref = ranks
    loss, norm, params = ref[name]
    for rank in range(world):
        out = result(res, name, rank)
        assert out["slab"][1] == payload[name]["x"].shape[1] // 2
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(out["norm"], norm, rtol=1e-4)
        assert set(out["params"]) == set(params) - set(out["buffers"])
        for k, v in out["params"].items():
            np.testing.assert_allclose(v, params[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        for k, v in out["buffers"].items():
            np.testing.assert_allclose(v, params[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        if name == "d":
            assert {"bnorm.mean", "bnorm.var"} <= set(out["buffers"])


def test_shard_batch_cuts_channels_first_conditions(ranks):
    world, res, _, _ = ranks
    for rank in range(world):
        assert result(res, "channels_first", rank) is True
