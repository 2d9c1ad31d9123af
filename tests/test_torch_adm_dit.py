"""The port's ADM, DiT and MoE-DiT against the reference fixtures and the
JAX package, and the descriptions of the new net kinds.

- ADM: the torch reference's state dicts (``adm_forward.npz``,
  ``adm_forward_dec2.npz``, ``admmp_forward.npz``) load into the port's
  ``ADM`` with ``load_state_dict(strict=True)`` and give the fixture's
  output at the JAX package's bound (rtol 5e-4, atol 5e-5,
  ``tests/test_reference_parity.py``); the JAX package's weights for them
  (``import_reference_adm``) convert to the same state dict. Live against
  the JAX package on the same weights (``from_jax_variables``): 3D, mp
  convolutions, a conditional embedding, ``space_to_depth``, decoder type
  2 with additive skips, and flash attention (two heads) through the
  kernels' plain versions, at ``tests/test_adm_dit.py``'s bound (rtol
  2e-4, atol 2e-5).
- DiT: ``patchify``/``unpatchify`` and the positions against the JAX
  functions, and the
  network live against the JAX package ('xla' and 'flash' attention,
  one and three channels) at rtol 2e-4, atol 2e-5.
- MoE: ``MoEFeedForward`` against the JAX module with ample capacity,
  with a dropping capacity and with a zero router (every token to expert
  0), the aux loss and the dropped fraction included, at
  ``tests/test_moe.py``'s bound (rtol 2e-5, atol 1e-6); MoE-DiT live at
  rtol 2e-4, atol 2e-5, with ``moe_aux_loss``.
- Descriptions: a JAX ``KarrasModel`` of each new kind (adm, convit, dit,
  moe_dit) exports, rebuilds in the port and back, with the same denoiser
  output on the same weights (rtol 5e-4, atol 5e-5, as
  ``tests/test_torch_describe.py``).

Inputs are made with numpy; the port's tensors are [B, C, *spatial], the
JAX package's channels last.
"""

import json
import os

import numpy as np
import pytest
import torch

import _torch_warmup  # noqa: F401

import flax.linen as jnn
import jax
import jax.numpy as jnp

from diffsci_tpu.extra import converters
from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models.karras.module import \
    karras_model_from_description as jkarras_model_from_description
from diffsci_tpu.models.nets import adm as jadm
from diffsci_tpu.models.nets import convit as jconvit
from diffsci_tpu.models.nets import dit as jdit
from diffsci_tpu.models.nets import moe as jmoe

from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.kernels import flash_attention as fa
from diffsci_tpu_torch.models.karras import karras_model_from_description
from diffsci_tpu_torch.models.nets import adm, dit, moe

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")


def _check(ours, ref, rtol, atol, label=""):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    np.testing.assert_allclose(np.asarray(ours, np.float64),
                               np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol, err_msg=label)


def _nc(a):
    """channels-last -> [B, C, *spatial] tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a), -1, 1)))


def _cl(a):
    return np.moveaxis(a.detach().numpy(), 1, -1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _noisy(variables, seed, scale=0.2):
    """The variables with every leaf redrawn from N(0, scale²): untrained
    nets' zero-initialized biases and FiLM layers would hide mapping
    errors."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(np.shape(a))
                                   * scale).astype(np.float32), variables)


# ---------------------------------------------------------------------------
# ADM
# ---------------------------------------------------------------------------
def _fixture_config(cls, **overrides):
    base = dict(model_channels=8, time_embed_dim=8, output_embed_dim=16,
                channel_expansion=[2], number_resnet_downward_block=1,
                number_resnet_upward_block=1, number_resnet_attn_block=2,
                number_resnet_before_attn_block=1,
                number_resnet_after_attn_block=1, num_groups=1)
    base.update(overrides)
    return cls(**base)


@pytest.mark.parametrize("fixture,overrides", [
    ("adm_forward.npz", {}),
    ("adm_forward_dec2.npz", {"decoder_type": 2,
                              "skip_integration_type": "add"}),
    ("admmp_forward.npz", {}),
])
def test_adm_reference_state_dict(fixture, overrides):
    d = np.load(os.path.join(FIXDIR, fixture))
    sd = {k[4:]: d[k] for k in d.files if k.startswith("sd__")}
    net = adm.ADM(_fixture_config(adm.ADMConfig, **overrides), device="cpu")
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                        strict=True)
    with torch.no_grad():
        y = net(torch.from_numpy(d["x"]), torch.from_numpy(d["t"]))
    _check(y, d["y"], rtol=5e-4, atol=5e-5, label=fixture)

    # the JAX package's variables of the same weights convert to them
    jnet = jadm.ADM(_fixture_config(jadm.ADMConfig, **overrides))
    x = jnp.asarray(d["x"]).transpose(0, 2, 3, 1)
    template = jnet.init(jax.random.PRNGKey(0), x, jnp.asarray(d["t"]))
    variables = converters.import_reference_adm(sd, template)
    ours = from_jax_variables(_np_tree(variables), net.config)
    assert sorted(ours) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_allclose(ours[k].numpy(), v, rtol=0, atol=1e-7,
                                   err_msg=k)


def _small_adm(cls, **kw):
    base = dict(model_channels=8, time_embed_dim=8, output_embed_dim=16,
                channel_expansion=[2], number_resnet_downward_block=1,
                number_resnet_upward_block=1, number_resnet_attn_block=2,
                number_resnet_before_attn_block=1,
                number_resnet_after_attn_block=1)
    base.update(kw)
    return cls(**base)


ADM_CASES = {
    "3d": (dict(dimension=3), (2, 8, 8, 8, 1), False),
    "mp": (dict(convolution_type="mp"), (2, 16, 16, 1), False),
    "conditional": (dict(cond_dropout=0.1), (2, 16, 16, 1), True),
    "space_to_depth": (dict(space_to_depth=2), (2, 16, 16, 1), False),
    "decoder2_add": (dict(decoder_type=2, skip_integration_type="add",
                          number_resnet_upward_block=2),
                     (2, 16, 16, 1), False),
    "flash_2heads": (dict(attn_heads=2, attn_backend="flash"),
                     (2, 16, 16, 1), False),
}


@pytest.mark.parametrize("case", sorted(ADM_CASES))
def test_adm_live_against_jax(case, monkeypatch):
    kw, shape, cond = ADM_CASES[case]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    t = np.array([0.3, -1.2], np.float32)
    y = rng.standard_normal((2, 3)).astype(np.float32) if cond else None
    jnet = jadm.ADM(_small_adm(jadm.ADMConfig, **{
        **kw, "attn_backend": "xla"}),
        conditional_embedding=jnn.Dense(16) if cond else None)
    variables = _noisy(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 jnp.asarray(t), y), 1)
    ref = jnet.apply(variables, jnp.asarray(x), jnp.asarray(t), y)
    net = adm.ADM(_small_adm(adm.ADMConfig, **kw),
                  conditional_embedding=(torch.nn.Linear(3, 16)
                                         if cond else None), device="cpu")
    net.load_state_dict(from_jax_variables(_np_tree(variables), net.config),
                        strict=True)
    net.eval()
    # the flash case engages the kernels' path (their plain versions on
    # the CPU) at this size
    monkeypatch.setattr(fa, "MIN_TOKENS", 1)
    with torch.no_grad():
        out = net(_nc(x), torch.from_numpy(t),
                  None if y is None else torch.from_numpy(y))
    _check(_cl(out), ref, rtol=2e-4, atol=2e-5, label=case)


def test_adm_config_properties_and_description():
    kw = dict(number_resnet_before_attn_block=2, number_resnet_attn_block=3,
              number_resnet_after_attn_block=1)
    cfg = adm.ADMConfig(**kw)
    assert cfg.middle_block_attn_config == [False, False, True, True, False,
                                            False]
    assert cfg.num_blocks_middle_block == 6
    assert cfg.middle_channel == 256
    assert cfg.extended_channel_expansion == [1, 2, 4]
    desc = json.loads(json.dumps(cfg.export_description()))
    assert adm.ADMConfig.from_description(desc) == cfg
    assert desc == json.loads(json.dumps(
        jadm.ADMConfig(**kw).export_description()))


# ---------------------------------------------------------------------------
# DiT and MoE-DiT
# ---------------------------------------------------------------------------
def test_patchify_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 16, 12, 3)).astype(
        np.float32)
    tokens = dit.patchify(_nc(x), 4)
    _check(tokens, jdit.patchify(jnp.asarray(x), 4), rtol=0, atol=0)
    back = dit.unpatchify(tokens, 4, 16, 12, 3)
    _check(_cl(back), x, rtol=0, atol=0)
    _check(dit.positional_encoding_2d(4, 6, 32),
           jdit.positional_encoding_2d(4, 6, 32), rtol=0, atol=1e-12)


DIT_CASES = {
    "xla": dict(nchannels=1, patch_size=4, attn_backend="xla"),
    "flash": dict(nchannels=1, patch_size=4, attn_backend="flash"),
    "rgb_patch2": dict(nchannels=3, patch_size=2, attn_backend="xla"),
}


def _dit_inputs(nchannels):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, nchannels)).astype(np.float32)
    return x, np.array([0.7, -0.4], np.float32)


@pytest.mark.parametrize("case", sorted(DIT_CASES))
def test_dit_live_against_jax(case, monkeypatch):
    kw = DIT_CASES[case]
    x, t = _dit_inputs(kw["nchannels"])
    jkw = dict(kw, attn_backend="xla")
    jnet = jdit.DiffusionTransformer(nembed=32, nheads=2, nblocks=2, **jkw)
    variables = _noisy(jnet.init(jax.random.PRNGKey(2), jnp.asarray(x),
                                 jnp.asarray(t)), 4)
    ref = jnet.apply(variables, jnp.asarray(x), jnp.asarray(t))
    net = dit.DiffusionTransformer(nembed=32, nheads=2, nblocks=2, **kw,
                                   device="cpu")
    net.load_state_dict(from_jax_variables(_np_tree(variables)),
                        strict=True)
    monkeypatch.setattr(fa, "MIN_TOKENS", 1)
    with torch.no_grad():
        out = net(_nc(x), torch.from_numpy(t))
    _check(_cl(out), ref, rtol=2e-4, atol=2e-5, label=case)


def _jax_moe(ffn, variables, x):
    y, inter = ffn.apply(variables, x, mutable=["intermediates"])
    flat = {getattr(path[-2], "key", None): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(inter)[0]}
    return (np.asarray(y), float(flat["moe_aux_loss"]),
            float(flat["moe_dropped_fraction"]))


@pytest.mark.parametrize("case", ["ample", "dropping", "zero_router"])
def test_moe_ffn_matches_jax(case):
    B, T, d, E = 2, 16, 8, 4
    cf = {"ample": float(E), "dropping": 0.5, "zero_router": 1.0}[case]
    x = np.random.default_rng(7).standard_normal((B, T, d)).astype(
        np.float32)
    jffn = jmoe.MoEFeedForward(nembed=d, n_experts=E, mlp_factor=2,
                               capacity_factor=cf)
    variables = _noisy(jffn.init(jax.random.PRNGKey(1), jnp.asarray(x)), 8,
                       scale=0.5)
    if case == "zero_router":
        variables = {"params": dict(variables["params"],
                                    router=np.zeros((d, E), np.float32))}
    ref, aux, dropped = _jax_moe(jffn, variables, jnp.asarray(x))
    ffn = moe.MoEFeedForward(d, E, mlp_factor=2, capacity_factor=cf)
    ffn.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                         variables["params"].items()}, strict=True)
    with torch.no_grad():
        out = ffn(torch.from_numpy(x))
    _check(out, ref, rtol=2e-5, atol=1e-6, label=case)
    _check(ffn.aux_loss, aux, rtol=2e-5, atol=1e-6)
    _check(ffn.dropped_fraction, dropped, rtol=0, atol=1e-7)
    if case == "ample":
        assert dropped == 0.0
    else:
        assert dropped > 0.0
        # dropped tokens leave the FFN exactly 0
        S = B * T
        assert int((out.reshape(S, d).abs().sum(-1) == 0).sum()) == \
            round(dropped * S)


def test_moe_dit_live_against_jax():
    kw = dict(nembed=16, nheads=2, nblocks=2, patch_size=4, nchannels=1,
              n_experts=4, moe_every=1, capacity_factor=0.5)
    x, t = _dit_inputs(1)
    jnet = jmoe.MoEDiffusionTransformer(**kw)
    variables = _noisy(jnet.init(jax.random.PRNGKey(3), jnp.asarray(x),
                                 jnp.asarray(t)), 9)
    ref, inter = jnet.apply(variables, jnp.asarray(x), jnp.asarray(t),
                            mutable=["intermediates"])
    net = moe.MoEDiffusionTransformer(**kw, device="cpu")
    assert [type(b).__name__ for b in net.blocks] == ["MoEDiTBlock"] * 2
    net.load_state_dict(from_jax_variables(_np_tree(variables)),
                        strict=True)
    with torch.no_grad():
        out = net(_nc(x), torch.from_numpy(t))
    _check(_cl(out), ref, rtol=2e-4, atol=2e-5)
    _check(moe.moe_aux_loss(net, weight=1.0),
           jmoe.moe_aux_loss(inter, weight=1.0), rtol=2e-5, atol=1e-6)
    dropped = [float(m.dropped_fraction) for m in net.modules()
               if isinstance(m, moe.MoEFeedForward)]
    assert all(f > 0.0 for f in dropped)
    assert float(moe.moe_aux_loss(dit.DiffusionTransformer(
        nembed=16, nheads=2, nblocks=1, device="cpu"))) == 0.0


# ---------------------------------------------------------------------------
# descriptions of the new kinds
# ---------------------------------------------------------------------------
_KINDS = {
    "adm": (lambda: jadm.ADM(_small_adm(jadm.ADMConfig)), (2, 16, 16, 1)),
    "convit": (lambda: jconvit.ConVit(jconvit.ConVitConfig(
        embed_dim=8, num_layers=1, num_heads=2, has_time_embedding=True,
        condition_dropout=0.0)), (2, 16, 16, 1)),
    "dit": (lambda: jdit.DiffusionTransformer(nembed=16, nheads=2,
                                              nblocks=1), (2, 16, 16, 1)),
    "moe_dit": (lambda: jmoe.MoEDiffusionTransformer(
        nembed=16, nheads=2, nblocks=2, n_experts=2), (2, 16, 16, 1)),
}


def _json(d):
    return json.loads(json.dumps(d))


def _denoisers(jmodel, variables, model, x, sigma):
    ref = jax.jit(lambda v, xx, ss: jmodel.get_denoiser(v, xx, ss)[0])(
        variables, jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():
        out, _ = model.get_denoiser(torch.from_numpy(x),
                                    torch.from_numpy(sigma))
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_new_kind_descriptions_round_trip(kind, direction):
    make_net, x_shape = _KINDS[kind]
    desc = _json(JKarrasModel(make_net(), JKarrasModelConfig.from_edm())
                 .export_description())
    assert desc["net"]["kind"] == kind
    model = karras_model_from_description(desc, device="cpu")
    assert _json(model.export_description()) == desc
    jmodel = (JKarrasModel(make_net(), JKarrasModelConfig.from_edm())
              if direction == "jax_to_port"
              else jkarras_model_from_description(desc))
    rng = np.random.default_rng(0)
    x = rng.standard_normal(x_shape).astype(np.float32)
    sigma = np.array([0.3, 2.0], np.float32)
    variables = _noisy(jmodel.init(jax.random.PRNGKey(0), x_shape), 1)
    model.net.load_state_dict(from_jax_variables(_np_tree(variables)),
                              strict=True)
    out, ref = _denoisers(jmodel, variables, model, x, sigma)
    np.testing.assert_allclose(out, ref, rtol=5e-4, atol=5e-5)


# ---------------------------------------------------------------------------
# train states
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["adm", "moe_dit"])
def test_jax_train_state_carries_over(kind):
    """A JAX ``KarrasModel`` state of an ADM or a MoE-DiT after one AdamW
    step with a power EMA becomes the port's (``from_jax_train_state``):
    parameters, AdamW's first and second moments and the EMA shadows are
    JAX's leaves through ``from_jax_variables``, the counts JAX's."""
    from diffsci_tpu.models import EMATracker as JEMATracker
    from diffsci_tpu.models import create_train_state as jcreate_train_state
    from diffsci_tpu.models import make_train_step as jmake_train_step

    from diffsci_tpu_torch import (EMATracker, KarrasModel,
                                   KarrasModelConfig, default_optimizer)
    from diffsci_tpu_torch.convert import from_jax_train_state

    x_shape = (2, 16, 16, 1)
    jmodel = JKarrasModel(_KINDS[kind][0](), JKarrasModelConfig.from_edm())
    jtracker = JEMATracker(ema_type="power", power_function_stds=[0.05])
    jstate, jtx = jcreate_train_state(jmodel, jax.random.PRNGKey(0), x_shape,
                                      ema=jtracker)
    rng = np.random.default_rng(2)
    replay = {"sigma": np.array([0.4, 2.0], np.float32),
              "eps": rng.standard_normal(x_shape).astype(np.float32)}

    def jloss(variables, key, x, y, replay, train=True):
        return jmodel.loss_fn(variables, key, x, replay["sigma"],
                              train=train, eps=replay["eps"])

    jstep = jmake_train_step(jmodel, jtx, ema=jtracker, loss_fn=jloss)
    x = rng.standard_normal(x_shape).astype(np.float32)
    jstate, _ = jstep(jstate, jax.random.PRNGKey(1), jnp.asarray(x), None,
                      replay)
    state_np = jax.tree.map(np.asarray, jstate)

    model = karras_model_from_description(
        _json(jmodel.export_description()), device="cpu")
    assert isinstance(model, KarrasModel)
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05])
    state = from_jax_train_state(state_np, model, default_optimizer(), tracker)
    assert (state.step, state.ema.num_updates) == (1, 1)
    params = from_jax_variables({"params": state_np.params})
    adam = next(s for s in jax.tree_util.tree_leaves(
        state_np.opt_state, is_leaf=lambda n: hasattr(n, "mu"))
        if hasattr(s, "mu"))
    mu = from_jax_variables({"params": adam.mu})
    nu = from_jax_variables({"params": adam.nu})
    shadow = from_jax_variables({"params": state_np.ema.profiles[0]})
    for name, p in state.params.items():
        slot = state.optimizer.state[p]
        assert torch.equal(p.detach(), params[name]), name
        assert torch.equal(slot["exp_avg"], mu[name]), name
        assert torch.equal(slot["exp_avg_sq"], nu[name]), name
        assert torch.equal(state.ema.profiles[0][name], shadow[name]), name
    assert float(mu["model.input_layer.weight" if kind == "adm" else
                    "model.blocks.1.moe.experts_w1"].abs().max()) > 0
