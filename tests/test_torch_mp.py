"""The port's magnitude-preserving stack against the JAX package and the
reference fixtures: mp dense/conv layers (eval forward, the re-projection,
one SGD step), cosine and mp attention, the mp PUNetG with cosine
attention, ``renormalize_mp_weights``, the dynamic loss weight in
``loss_fn``, a 5-step ``make_train_step(has_mp_weights=True)`` trajectory,
and the sampler's hoisted weights.

Inputs are made with numpy; JAX weights reach the port through
``from_jax_variables``, the reference's state dicts load directly (the
port keeps its names). Each pin uses the tolerance of the JAX package's
test on the same fixture (``tests/test_reference_parity12.py``).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu.models import EMATracker as JEMATracker
from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import PUNetG as JPUNetG
from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig
from diffsci_tpu.models import create_train_state as jcreate_train_state
from diffsci_tpu.models import make_train_step as jmake_train_step
from diffsci_tpu.models.karras.train import (
    renormalize_mp_weights as jrenormalize)

from diffsci_tpu_torch import (EMATracker, KarrasModel, KarrasModelConfig,
                               PUNetG, PUNetGConfig, create_train_state,
                               default_optimizer, make_train_step,
                               renormalize_mp_weights)
from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.models.nets import attention, normed
from tests import _torch_warmup  # noqa: F401  (MKL's first exp, CPU threads)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")
_SMALL = dict(model_channels=8, channel_expansion=(2,),
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=2, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1, convolution_type="mp",
              attn_type="cosine")


def _check(ours, ref, rtol=5e-5, atol=5e-6, label=""):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref),
                               rtol=rtol, atol=atol, err_msg=label)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# mp layers (normedlayers_golden.npz)
# ---------------------------------------------------------------------------
def _mp_layer(d, name):
    w0, b0 = d[f"{name}_w0"], d[f"{name}_b0"]
    if name == "linear":
        layer = normed.MagnitudePreservingDense(w0.shape[1], w0.shape[0])
    else:
        layer = normed.MagnitudePreservingConv(w0.ndim - 2, w0.shape[1],
                                               w0.shape[0], w0.shape[-1])
    layer.load_state_dict({"weight": _t(w0), "bias": _t(b0)})
    return layer


@pytest.mark.parametrize("name", ["linear", "conv2d", "conv3d"])
def test_mp_layers_match_reference(name):
    """Eval forward; the re-projected weight; the train-mode forward of
    the re-projected layer and one SGD(lr=0.1) step on sum(y²)."""
    d = np.load(os.path.join(FIXDIR, "normedlayers_golden.npz"))
    layer = _mp_layer(d, name)
    x = _t(d[f"{name}_x"])
    _check(layer(x), d[f"{name}_y_eval"], label=f"{name} eval")
    renormalize_mp_weights(layer)
    _check(layer.weight, d[f"{name}_w_renormed"], label=f"{name} renormed")
    y = layer(x)
    loss = (y ** 2).sum()
    loss.backward()
    _check(y, d[f"{name}_y_train"], label=f"{name} train")
    _check(loss, d[f"{name}_loss"], rtol=1e-4, label=f"{name} loss")
    with torch.no_grad():
        for p in layer.parameters():
            p -= 0.1 * p.grad
    _check(layer.weight, d[f"{name}_w_after_step"], rtol=1e-4, atol=1e-5)
    _check(layer.bias, d[f"{name}_b_after_step"], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# cosine / mp attention (cosine_attention.npz)
# ---------------------------------------------------------------------------
def test_attention_functions_match_reference():
    d = np.load(os.path.join(FIXDIR, "cosine_attention.npz"))
    q, k, v = (_t(d[n]) for n in "qkv")
    _check(attention.cosine_attention(q, k, v), d["fn_cosine_out"])
    _check(attention.dot_product_attention(q, k, v), d["fn_dot_out"])


def _einsum_mha(d, tag, mp):
    mha = attention.EinsumMultiHeadAttention(
        16, 2, attn_type="cosine", magnitude_preserving=mp,
        fan_in_scaled=True)
    mha.load_state_dict({f"{n}_proj_matrix": _t(d[f"mha_{tag}_w{n}"])
                         for n in "qkvo"})
    return mha


def test_cosine_mha_plain_matches_reference():
    """attn_type='cosine' without mp: the projections still divide by
    sqrt(fan_in) (the reference's in-house module)."""
    d = np.load(os.path.join(FIXDIR, "cosine_attention.npz"))
    _check(_einsum_mha(d, "plain", False)(_t(d["mha_plain_x"])),
           d["mha_plain_out"])


def test_cosine_mha_mp_eval_renorm_and_step_match_reference():
    d = np.load(os.path.join(FIXDIR, "cosine_attention.npz"))
    mha = _einsum_mha(d, "mp", True)
    x = _t(d["mha_mp_x"])
    _check(mha(x), d["mha_mp_out"], label="mp eval")
    renormalize_mp_weights(mha)
    _check(mha.q_proj_matrix, d["mha_mp_wq_renormed"], label="wq renormed")
    _check(mha.o_proj_matrix, d["mha_mp_wo_renormed"], label="wo renormed")
    out = mha(x)
    loss = (out ** 2).sum()
    loss.backward()
    _check(out, d["mha_mp_out_train"], label="mp train")
    _check(loss, d["mha_mp_loss"], rtol=1e-4)
    with torch.no_grad():
        wq = mha.q_proj_matrix - 0.1 * mha.q_proj_matrix.grad
    _check(wq, d["mha_mp_wq_after_step"], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# PUNetG convolution_type='mp', attn_type='cosine' (punetg_mp.npz)
# ---------------------------------------------------------------------------
def test_punetg_mp_matches_reference_f64():
    """The reference's state dict loads strictly; the f32 forward is held
    to the reference run in float64 at the JAX test's bound (rtol 5e-4,
    atol 5e-5) and to the reference's own f32 run within that test's
    envelope (rtol 5e-2, atol 2e-3: torch's f32 GroupNorm on the
    reference's side)."""
    d = np.load(os.path.join(FIXDIR, "punetg_mp.npz"))
    sd = {k[4:]: _t(d[k]) for k in d.files if k.startswith("sd__")}
    net = PUNetG(PUNetGConfig(**_SMALL, num_groups=1), device="cpu")
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        y = net(_t(d["x"]), _t(d["t"]))
    _check(y, d["y_f64"], rtol=5e-4, atol=5e-5, label="mp PUNetG (f64)")
    _check(y, d["y"], rtol=5e-2, atol=2e-3, label="mp PUNetG (f32)")


# ---------------------------------------------------------------------------
# live against the JAX package
# ---------------------------------------------------------------------------
def _jax_and_port(x_shape, dlw=None):
    kw = {} if dlw is None else dict(dynamic_loss_weight=dlw)
    jmodel = JKarrasModel(JPUNetG(JPUNetGConfig(**_SMALL)),
                          JKarrasModelConfig.from_edm(**kw))
    variables = jmodel.init(jax.random.PRNGKey(0), x_shape)
    model = KarrasModel(PUNetG(PUNetGConfig(**_SMALL), device="cpu"),
                        KarrasModelConfig.from_edm(**kw), device="cpu")
    model.net.load_state_dict(_sd(variables), strict=True)
    return jmodel, variables, model


def _sd(variables):
    return from_jax_variables(jax.tree.map(np.asarray, variables))


def _draws(x_shape, seed):
    rng = np.random.default_rng(seed)
    sigma = np.exp(rng.standard_normal(x_shape[0]) * 1.2 - 1.2).astype(
        np.float32)
    return sigma, rng.standard_normal(x_shape).astype(np.float32)


def test_renormalize_mp_weights_matches_jax():
    """The same raw weights (off the sphere) re-projected by both
    packages: conv, time-MLP and attention projections alike."""
    _, variables, model = _jax_and_port((2, 16, 16, 1))
    renorm = jrenormalize(variables["params"])
    renormalize_mp_weights(model.net)
    ref = _sd({**variables, "params": renorm})
    for name, w in model.net.state_dict().items():
        _check(w, ref[name].numpy(), rtol=1e-5, atol=1e-7, label=name)


@pytest.mark.parametrize("dlw", [None, 16])
def test_loss_fn_with_dynamic_loss_weight_matches_jax(dlw):
    """λ(σ)/e^u · Huber + u with the dynamic loss weight's u(c_noise),
    from replayed ε, and its gradient norm."""
    x_shape = (3, 16, 16, 1)
    jmodel, variables, model = _jax_and_port(x_shape, dlw=dlw)
    x = np.random.default_rng(3).standard_normal(x_shape).astype(np.float32)
    sigma, eps = _draws(x_shape, 4)

    def jloss(params):
        return jmodel.loss_fn({**variables, "params": params},
                              jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(sigma), eps=jnp.asarray(eps))[0]

    jl, jg = jax.value_and_grad(jloss)(variables["params"])
    loss = model.loss_fn(_t(x), _t(sigma), eps=_t(eps))
    loss.backward()
    gnorm = torch.sqrt(sum((p.grad ** 2).sum()
                           for p in model.net.parameters()))
    jgnorm = np.sqrt(sum(float(jnp.sum(g ** 2))
                         for g in jax.tree.leaves(jg)))
    _check(loss, float(jl), rtol=1e-5, atol=1e-7, label="loss")
    _check(gnorm, jgnorm, rtol=1e-4, label="grad norm")
    if dlw is not None:
        assert {"dlw.fourier_weights", "dlw.fourier_bias",
                "dlw.linear.weight"} <= set(model.net.state_dict())


def test_mp_train_step_trajectory_matches_jax():
    """5 f32 steps of make_train_step(has_mp_weights=True) with the
    dynamic loss weight, σ and ε replayed: loss, grad norm, parameters
    (re-projected after every AdamW step) and EMA shadows, at the
    tolerances of ``test_torch_training.py``'s trajectory; every mp
    weight per output unit at the re-projection's norm after the steps:
    w / (ε + ‖w‖) has norm ‖w‖ / (ε + ‖w‖), 1/(1 + ε) for ‖w‖ ≈ 1
    (ε = 1e-4), within 1e-5."""
    x_shape, lr = (4, 16, 16, 1), 1e-3
    jmodel, _, _ = _jax_and_port(x_shape, dlw=16)
    jtracker = JEMATracker(ema_type="power", power_function_stds=[0.05])
    jstate, jtx = jcreate_train_state(jmodel, jax.random.PRNGKey(0), x_shape,
                                      ema=jtracker)

    def jloss(variables, key, x, y, replay, train=True):
        return jmodel.loss_fn(variables, key, x, replay["sigma"], train=train,
                              eps=replay["eps"])

    jstep = jmake_train_step(jmodel, jtx, ema=jtracker, has_mp_weights=True,
                             loss_fn=jloss)
    model = KarrasModel(PUNetG(PUNetGConfig(**_SMALL), device="cpu"),
                        KarrasModelConfig.from_edm(dynamic_loss_weight=16),
                        device="cpu")
    model.net.load_state_dict(_sd(jstate.variables()), strict=True)
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05])
    state, tx = create_train_state(model, x_shape, seed=None,
                                   optimizer=default_optimizer(lr),
                                   ema=tracker)
    step = make_train_step(model, tx, ema=tracker, has_mp_weights=True)
    x = np.random.default_rng(0).standard_normal(x_shape).astype(np.float32)
    for k in range(1, 6):
        sigma, eps = _draws(x_shape, 10 + k)
        jstate, jmet = jstep(jstate, jax.random.PRNGKey(k), jnp.asarray(x),
                             None, {"sigma": jnp.asarray(sigma),
                                    "eps": jnp.asarray(eps)})
        state, met = step(state, _t(x), sigma=_t(sigma), eps=_t(eps))
        _check(met["train_loss"], float(jmet["train_loss"]), rtol=1e-5,
               atol=0)
        _check(met["grad_norm"], float(jmet["grad_norm"]), rtol=1e-4,
               atol=0)
        for ours, theirs in (
                (state.params, _sd(jstate.variables())),
                (state.ema.profiles[0], _sd(
                    {**jstate.variables(),
                     "params": jstate.ema.profiles[0]}))):
            diff = np.concatenate([(ours[n].detach() - theirs[n]).abs()
                                   .flatten().numpy() for n in ours])
            assert np.quantile(diff, 0.999) <= 0.01 * lr, k
            assert diff.max() <= 2 * k * lr, k
    for m in model.net.modules():
        if isinstance(m, normed._MagnitudePreserving):
            w = m.weight.detach()
            n = w.flatten(1).norm(dim=1) * np.sqrt(w.shape[0] / w.numel())
            _check(n, np.full(w.shape[0], 1 / (1 + 1e-4)), rtol=0,
                   atol=1e-5)


def test_hoisted_sampler_weights_match_the_forward():
    """A model's cast copy (here in float32, so that only the hoisting
    differs) holds each mp layer's and mp attention's normalized, scaled
    weights, taken once from the masters, and gives what the per-call
    normalization of the masters gives (``variables=`` runs the masters
    through ``functional_call``); a change of the masters reaches it."""
    x_shape = (2, 16, 16, 1)
    _, variables, _ = _jax_and_port(x_shape)
    model = KarrasModel(PUNetG(PUNetGConfig(**_SMALL), device="cpu"),
                        KarrasModelConfig.from_edm(),
                        compute_dtype=torch.float32, device="cpu")
    model.net.load_state_dict(_sd(variables), strict=True)
    x = torch.randn(x_shape, generator=torch.Generator().manual_seed(0))
    sigma = torch.tensor([0.3, 2.0])
    with torch.no_grad():
        for flip in (False, True):
            if flip:
                for m in model.net.modules():
                    if isinstance(m, normed._MagnitudePreserving):
                        m.weight.mul_(-1.0)
            hoisted = model.get_denoiser(x, sigma)[0]
            assert all(m.hoisted for m in model._cast_net.modules()
                       if hasattr(m, "hoist_from"))
            ref = model.get_denoiser(x, sigma, variables={})[0]
            _check(hoisted, ref.numpy(), rtol=1e-5, atol=1e-6,
                   label=f"flipped {flip}")
