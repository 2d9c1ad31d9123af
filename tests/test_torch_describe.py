"""Descriptions: the port's net registry (``models/nets/describe.py``),
``KarrasModel.export_description`` and ``karras_model_from_description``
against the JAX package's, both ways.

A JAX ``KarrasModel.export_description()`` passed through JSON rebuilds
in the port, and the port's rebuilds in the JAX package; the rebuilt
model and the original give the same denoiser output on the same
(converted) weights, x and σ, at the bound the port's PUNetG tests use
against the JAX package (rtol 5e-4, atol 5e-5, f32 sums in another
order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import nets as jnets
from diffsci_tpu.models.karras.module import \
    karras_model_from_description as jkarras_model_from_description
from diffsci_tpu.models.nets.describe import \
    net_from_description as jnet_from_description

from diffsci_tpu_torch import config as tconfig
from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.models.karras import karras_model_from_description
from diffsci_tpu_torch.models.nets import (HFNet, MLPUncond, PUNetG,
                                           PUNetGConfig)
from diffsci_tpu_torch.models.nets.describe import net_from_description
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

_SMALL = dict(model_channels=8, channel_expansion=[2], num_groups=4,
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1, num_heads=2)
# kind -> (JAX net, channels-last x shape, the condition y (JAX layout))
_KINDS = {
    "punetg": (lambda: jnets.PUNetG(jnets.PUNetGConfig(**_SMALL)),
               (2, 16, 16, 1), None),
    "punetg_cond": (lambda: jnets.PUNetGCond(
        jnets.PUNetGConfig(**_SMALL, input_channels=2),
        channel_conditional_items=("obs",)), (2, 16, 16, 1), "obs"),
    "hfnet": (lambda: jnets.HFNet(block_channels=(8, 16), channels=1,
                                  norm_num_groups=4, attn_up_and_down=True),
              (2, 8, 8, 1), None),
    "mlp": (lambda: jnets.MLPUncond(dim=3, hidden_dims=(8, 8)), (2, 3),
            None),
}


def _json(d):
    return json.loads(json.dumps(d))


def _inputs(x_shape, cond):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(x_shape).astype(np.float32)
    sigma = np.array([0.3, 2.0], np.float32)
    y = None if cond is None else {
        cond: rng.standard_normal(x_shape).astype(np.float32)}
    return x, sigma, y


def _port_y(y):
    """The port's networks take spatial conditions channels-first."""
    return None if y is None else {
        k: torch.from_numpy(np.moveaxis(v, -1, 1)) for k, v in y.items()}


def _variables(jmodel, x_shape, y, seed):
    """Weights for both packages: the JAX model's variable shapes
    (traced, not compiled), filled with N(0, 0.2²) numbers from ``seed``."""
    shapes = jax.eval_shape(lambda k: jmodel.init(k, x_shape, y),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.2)
                        .astype(s.dtype), shapes)


def _denoisers(jmodel, variables, model, x, sigma, y):
    ref = jax.jit(lambda v, xx, ss, yy: jmodel.get_denoiser(
        v, xx, ss, yy)[0])(variables, jnp.asarray(x), jnp.asarray(sigma), y)
    with torch.no_grad():
        out, _ = model.get_denoiser(torch.from_numpy(x),
                                    torch.from_numpy(sigma), _port_y(y))
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_jax_description_rebuilds_in_port(kind):
    """JAX export -> JSON -> the port's model, on the same weights: the
    same description back, the same denoiser output."""
    make_net, x_shape, cond = _KINDS[kind]
    jmodel = JKarrasModel(make_net(), JKarrasModelConfig.from_edm(),
                          conditional=cond is not None)
    x, sigma, y = _inputs(x_shape, cond)
    variables = _variables(jmodel, x_shape, y, 0)
    desc = _json(jmodel.export_description())
    assert desc["net"]["kind"] == kind
    model = karras_model_from_description(desc, device="cpu")
    assert _json(model.export_description()) == desc
    model.net.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables)), strict=True)
    out, ref = _denoisers(jmodel, variables, model, x, sigma, y)
    np.testing.assert_allclose(out, ref, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_port_description_rebuilds_in_jax(kind):
    """The port's export -> JSON -> the JAX package's model, on the same
    weights (converted into the port's model): the same denoiser
    output."""
    make_net, x_shape, cond = _KINDS[kind]
    source = karras_model_from_description(_json(JKarrasModel(
        make_net(), JKarrasModelConfig.from_edm(),
        conditional=cond is not None).export_description()), device="cpu")
    desc = _json(source.export_description())
    jmodel = jkarras_model_from_description(desc)
    assert _json(jmodel.export_description()) == desc
    x, sigma, y = _inputs(x_shape, cond)
    variables = _variables(jmodel, x_shape, y, 1)
    source.net.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables)), strict=True)
    out, ref = _denoisers(jmodel, variables, source, x, sigma, y)
    np.testing.assert_allclose(out, ref, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("net", [
    lambda d: HFNet(block_channels=(8, 16), channels=2, cond_channels=1,
                    norm_num_groups=4, device=d),
    lambda d: MLPUncond(dim=3, hidden_dims=(8,), dropout=0.1, device=d),
    lambda d: PUNetG(PUNetGConfig(**_SMALL), device=d)],
    ids=["hfnet", "mlp", "punetg"])
def test_net_descriptions_equal_jax(net):
    """A port net's description is the JAX net's, key for key, and
    rebuilds the same configuration in the port."""
    ours = _json(net("cpu").export_description())
    assert _json(jnet_from_description(ours).export_description()) == ours
    assert _json(net_from_description(
        ours, device="cpu").export_description()) == ours


def test_unet2d_description_equals_jax():
    """UNet2D's fields; ``dimension`` is written only when it is not 2
    (the JAX module infers it from its input)."""
    from diffsci_tpu_torch.models.nets import UNet2D

    kw = dict(block_out_channels=(8, 16), in_channels=2, out_channels=2,
              attn_down=(False, True), attn_up=(True, False),
              norm_num_groups=4)
    ours = _json(UNet2D(**kw, device="cpu").export_description())
    assert ours == _json(jnets.UNet2D(**kw).export_description())
    assert _json(net_from_description(ours, device="cpu")
                 .export_description()) == ours
    three = UNet2D(**kw, dimension=3, device="cpu").export_description()
    assert three["config"]["dimension"] == 3


def test_legacy_punetg_descriptions_rebuild():
    """Descriptions written before ``kind`` existed (after
    tests/test_describe.py:59-72): the PUNetG export without the kind
    key, and the bare config-kwargs dict."""
    cfg = PUNetGConfig(model_channels=8, channel_expansion=[2], num_groups=4)
    legacy = dict(config=cfg.export_description(),
                  conditional_embedding_args=None,
                  has_conditional_embedding=False)
    for desc in (legacy, cfg.export_description()):
        net = net_from_description(_json(desc), device="cpu")
        assert type(net) is PUNetG and net.config == cfg
    jcfg = jnets.PUNetGConfig(model_channels=8, channel_expansion=[2],
                              num_groups=4)
    assert _json(jcfg.export_description()) == _json(
        cfg.export_description())


def test_kinds_not_ported_and_unknown_raise():
    """No kind of the JAX package is left unported: the four that raised
    "not ported yet" before (dit, moe_dit, convit, adm) rebuild now; an
    unknown kind and a model description the port cannot rebuild
    raise."""
    for kind, config, cls in (
            ("dit", dict(nembed=16, nheads=2, nblocks=1),
             "DiffusionTransformer"),
            ("moe_dit", dict(nembed=16, nheads=2, nblocks=2, n_experts=2),
             "MoEDiffusionTransformer"),
            ("convit", dict(embed_dim=8, num_layers=1, num_heads=2),
             "ConVit"),
            ("adm", dict(model_channels=8, channel_expansion=[2]), "ADM")):
        net = net_from_description({"kind": kind, "config": config},
                                   device="cpu")
        assert type(net).__name__ == cls
        assert _json(net.export_description())["kind"] == kind
    with pytest.raises(ValueError, match="unknown net kind"):
        net_from_description({"kind": "nope", "config": {}})
    desc = JKarrasModel(jnets.MLPUncond(dim=2), JKarrasModelConfig.from_edm()
                        ).export_description()
    with pytest.raises(ValueError, match="latent"):
        karras_model_from_description(dict(desc, autoencoder=True),
                                      device="cpu")
    with pytest.raises(ValueError, match="no net config"):
        karras_model_from_description(dict(desc, net=None), device="cpu")


def test_config_registry_round_trip(tmp_path):
    """``config.register`` / ``build`` and the JSON description files."""

    @tconfig.register("test_point")
    class Point:
        def __init__(self, a, b=2):
            self.a, self.b = a, b

        @classmethod
        def twice(cls, a):
            return cls(2 * a, 2 * a)

    desc = {"tag": "test_point", "extra_args": {"a": 1}}
    tconfig.save_description(desc, tmp_path / "d.json")
    p = tconfig.build(tconfig.load_description(tmp_path / "d.json"))
    assert (p.a, p.b, Point.tag) == (1, 2, "test_point")
    q = tconfig.build(dict(desc, factory="twice"))
    assert (q.a, q.b) == (2, 2)
    with pytest.raises(ValueError, match="unknown config tag"):
        tconfig.build({"tag": "nope"})
