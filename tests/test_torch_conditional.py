"""The port's conditional PUNetG path against the JAX package and the
reference fixtures: PUNetG with each option (space_to_depth, the Fourier
stem, bias-free convolutions, circular convolutions, GroupPix and identity
norms, spatially-varying conditions), PUNetGCond, the embedders, the
custom losses, classifier-free guidance (a float and an
``IntervalGuidance``), ``ConditionDrop``, the EDM batch norm in
``loss_fn``, the train step and ``encode``/``decode``, and the routing of
norms into kernel K2.

Inputs are made with numpy; JAX weights reach the port through
``from_jax_variables``, the reference's state dicts load directly. On the
CPU the port runs its kernels' plain versions and the JAX package its XLA
paths (its flash kernel's plain reference). Spatial conditions are
channels-last for the JAX package and [B, C, *spatial] for the port's
network. Each fixture pin uses the tolerance of the JAX package's test on
the same fixture (``tests/test_reference_parity5.py``, ``..._parity2.py``).
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as jnn

from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import create_train_state as jcreate_train_state
from diffsci_tpu.models import make_train_step as jmake_train_step
from diffsci_tpu.models.karras.module import (
    IntervalGuidance as JIntervalGuidance)
from diffsci_tpu.models.nets import embedders as jemb
from diffsci_tpu.models.nets import layers as jlayers
from diffsci_tpu.models.nets import punetg as jpunetg

from diffsci_tpu_torch import (IntervalGuidance, KarrasModel,
                               KarrasModelConfig, PUNetG, PUNetGCond,
                               PUNetGConfig, create_train_state,
                               default_optimizer, make_train_step)
from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.kernels import fused_norm
from diffsci_tpu_torch.models.nets import (MLPCond, calculate_receptive_field,
                                           embedders, layers)
from diffsci_tpu_torch.ops import losses
from tests import _torch_warmup  # noqa: F401  (MKL's first exp, CPU threads)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")
_SMALL = dict(model_channels=8, channel_expansion=(2,),
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1)


def _check(ours, ref, rtol, atol, label=""):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref),
                               rtol=rtol, atol=atol, err_msg=label)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nc(a):
    """channels-last -> [B, C, *spatial]."""
    return _t(np.moveaxis(np.asarray(a), -1, 1))


def _sd(variables, config=None):
    return from_jax_variables(jax.tree.map(np.asarray, variables), config)


def _porosity(n, seed):
    return np.random.default_rng(seed).uniform(0.1, 0.5, (n, 1)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------
def test_punetg_cond_matches_reference():
    """PUNetGCond: y['pmap'] joins x as an input channel; the reference's
    state dict loads under ``unet.``."""
    d = np.load(os.path.join(FIXDIR, "punetg_cond.npz"))
    sd = {"unet." + k[4:]: _t(d[k]) for k in d.files if k.startswith("sd__")}
    net = PUNetGCond(PUNetGConfig(**_SMALL, input_channels=2),
                     channel_conditional_items=["pmap"], device="cpu")
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        y = net(_t(d["x"]), _t(d["t"]), {"pmap": _t(d["pmap"])})
    _check(y, d["y"], rtol=5e-4, atol=1e-5)


def _emb_data(d):
    return {k[3:]: _t(d[k]) for k in d.files if k.startswith("in_")}


def _emb_sd(d, prefix):
    """The reference's state dict without its positional div_term buffer,
    which the port recomputes (checked against it)."""
    sd = {k[len(prefix) + 4:]: _t(d[k]) for k in d.files
          if k.startswith(prefix + "sd__")}
    for k in [k for k in sd if k.endswith("div_term")]:
        div = sd.pop(k)
        dembed = 2 * div.numel()
        ref = 10000.0 ** (np.arange(0, dembed, 2) / dembed)
        np.testing.assert_allclose(div.numpy(), ref, rtol=1e-5)
    return sd


@pytest.mark.parametrize("case", ["posenc", "tpc", "tpcm", "psd", "poro",
                                  "comp", "tpct"])
def test_embedders_match_reference(case):
    d = np.load(os.path.join(FIXDIR, "embedders.npz"))
    data = _emb_data(d)
    tol = dict(rtol=1e-5, atol=1e-6)
    if case == "posenc":
        _check(embedders.PositionalEncoding1d(8)(data["tpc_dist"]),
               d["posenc"], **tol)
        return
    if case in ("tpc", "tpcm", "psd"):
        net = {"tpc": embedders.TwoPointCorrelationEmbedder(8),
               "tpcm": embedders.TwoPointCorrelationEmbedder(
                   8, reduction="mean"),
               "psd": embedders.PoreSizeDistEmbedder(
                   8, reduction="mean")}[case]
        sd, out = _emb_sd(d, case), {"tpc": "tpc_out", "tpcm":
                                     "tpc_mean_out", "psd": "psd_out"}[case]
        # sin/cos of |2πWx| ~ 1e3 rad amplify argument ULPs
        tol = dict(rtol=1e-4, atol=2e-5)
    elif case == "poro":
        net, sd, out = embedders.PorosityEmbedder(8), _emb_sd(d, "poro"), \
            "poro_out"
    elif case == "comp":
        net = embedders.CompositeEmbedder([
            embedders.PorosityEmbedder(8),
            embedders.PoreSizeDistEmbedder(8, reduction="mean")])
        sd = {f"embedders.0.{k}": v for k, v in _emb_sd(d, "poro").items()}
        sd.update({f"embedders.1.{k}": v
                   for k, v in _emb_sd(d, "psd").items()})
        out = "comp_out"
    else:
        net = embedders.TwoPointCorrelationTransformer(8, nhead=2,
                                                       num_layers=2)
        sd, out = _emb_sd(d, "tpct"), "tpct_out"
        tol = dict(rtol=5e-5, atol=1e-5)
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        _check(net(data), d[out], **tol, label=case)


@pytest.mark.parametrize("case", ["2", "3"])
def test_gaussian_weighted_mse_matches_reference(case):
    d = np.load(os.path.join(FIXDIR, "custom_losses.npz"))
    pred, target = (_t(np.moveaxis(d[f"gw_{k}{case}"], 1, -1))
                    for k in "pt")
    fn = losses.make_loss_metric("weighted_gaussian",
                                 spatial_shape=pred.shape[1:-1],
                                 focus_radius=0.5 if case == "2" else 1.2)
    assert not fn.reduces_internally
    _check(fn(pred, target), np.moveaxis(d[f"gw_out{case}"], 1, -1),
           rtol=1e-5, atol=1e-7)


_MT = {"sigmoid_default": dict(thresholds=0.5),
       "tanh_multi": dict(thresholds=(0.3, 0.7), loss_type="tanh",
                          temperature=2.0, focus_weights=1.5,
                          background_weights=0.2, fp_penalty=2.0,
                          se_weight=0.25, aggregation="sum"),
       "gumbel_max": dict(thresholds=(0.2, 0.5), loss_type="gumbel",
                          temperature=5.0, aggregation="max"),
       "sigmoid_masked": dict(thresholds=(0.0, 0.5),
                              focus_weights=(2.0, 3.0),
                              background_weights=(0.1, 0.2))}


@pytest.mark.parametrize("case", sorted(_MT))
def test_multithreshold_loss_matches_reference(case):
    d = np.load(os.path.join(FIXDIR, "custom_losses.npz"))
    pred, target, mask = (_t(np.moveaxis(d[f"mt_{k}"], 1, -1))
                          for k in ("pred", "target", "mask"))
    fn = losses.make_loss_metric({"smoothed_indicator": _MT[case]})
    assert fn.reduces_internally
    rtol = 5e-3 if case == "tanh_multi" else 1e-5
    _check(fn(pred, target, mask if case.endswith("masked") else None),
           d[f"mt_{case}"], rtol=rtol, atol=1e-7)


def _guided_model():
    d = np.load(os.path.join(FIXDIR, "guided_karras.npz"))
    model = KarrasModel(MLPCond(3, 2, hidden_dims=(16, 16), device="cpu"),
                        KarrasModelConfig.from_edm(), conditional=True,
                        device="cpu")
    model.net.load_state_dict({"model." + k[5:]: _t(d[k]) for k in d.files
                               if k.startswith("csd__")}, strict=True)
    return d, model


@pytest.mark.parametrize("g", [0.0, 1.0, 2.5])
def test_cfg_denoiser_matches_reference(g):
    d, model = _guided_model()
    with torch.no_grad():
        den, _ = model.get_denoiser(_t(d["x"]), _t(d["sigma"]),
                                    y=_t(d["y"]), guidance=g)
    _check(den, d[f"denoiser_g{g}"], rtol=5e-4, atol=1e-6)


def test_cfg_guided_trajectory_matches_reference():
    d, model = _guided_model()
    hist = model.propagate_toward_sample(_t(d["xb"]), y=_t(d["y"]),
                                         guidance=2.0, nsteps=8,
                                         record_history=True)
    _check(hist, d["guided_traj"], rtol=5e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# PUNetG options, live against the JAX package
# ---------------------------------------------------------------------------
_OPTIONS = {
    "space_to_depth": (dict(space_to_depth=2), (2, 28, 28, 1)),
    "in_embedding": (dict(in_embedding=True), (2, 16, 16, 1)),
    "no_bias": (dict(bias=False), (2, 16, 16, 1)),
    "circular": (dict(convolution_type="circular"), (2, 16, 16, 1)),
    "group_pix": (dict(first_resblock_norm="GroupPix",
                       second_resblock_norm="GroupLN"), (2, 16, 16, 1)),
    "identity_norm": (dict(first_resblock_norm="GroupRMS",
                           second_resblock_norm="Identity"), (2, 16, 16, 1)),
    "no_affine": (dict(affine_norm=False), (2, 16, 16, 1)),
    "spatial_condition": (dict(cond_drop=0.1, channel_expansion=(2, 2),
                               number_resnet_attn_block=2, num_heads=2),
                          (2, 12, 12, 1)),
}


def _jax_punetg(fields, x, t, y=None, embed=None, seed=0):
    jcfg = jpunetg.PUNetGConfig(**fields)
    jnet = jpunetg.PUNetG(jcfg, conditional_embedding=embed)
    variables = jnet.init(jax.random.PRNGKey(seed), x, t, y)
    return variables, np.asarray(jnet.apply(variables, x, t, y))


@pytest.mark.parametrize("option", sorted(_OPTIONS))
def test_punetg_option_matches_jax(option):
    """The same weights and inputs through both packages' PUNetG with one
    option: space_to_depth=2 on 28² (14 -> 7: the odd-size pad and crop),
    the Fourier stem, the ones channel of bias=False, circular
    convolutions, GroupPix then GroupLN, GroupRMS then the identity norm,
    affine_norm=False, and a spatially-varying condition (a 1x1 conv
    embedding at full resolution, corner-pooled down and upsampled back
    through two levels, with cond_drop, inactive in eval)."""
    fields, x_shape = _OPTIONS[option]
    fields = {**_SMALL, **fields}
    # GroupPix with one channel per group is x / sqrt(x² + ε), whose slope
    # near 0 (1/√ε ≈ 316) amplifies float32 rounding: both packages run it
    # in float64
    f64 = option == "group_pix"
    dtype = np.float64 if f64 else np.float32
    rng = np.random.default_rng(1)
    x = rng.standard_normal(x_shape).astype(dtype)
    t = np.array([0.5, -1.2], dtype)
    y = embed = port_embed = None
    if option == "spatial_condition":
        y = rng.standard_normal(x_shape[:-1] + (3,)).astype(dtype)
        embed = jnn.Conv(8, (1, 1))
        port_embed = torch.nn.Conv2d(3, 8, 1)
    with jax.enable_x64(True) if f64 else contextlib.nullcontext():
        variables, ref = _jax_punetg(fields, jnp.asarray(x), jnp.asarray(t),
                                     None if y is None else jnp.asarray(y),
                                     embed)
    cfg = PUNetGConfig(**fields)
    net = PUNetG(cfg, conditional_embedding=port_embed, device="cpu").eval()
    net.load_state_dict(_sd(variables, cfg), strict=True)
    with torch.no_grad():
        out = net.to(torch.float64 if f64 else torch.float32)(
            _nc(x), _t(t), None if y is None else _nc(y))
    _check(np.moveaxis(out.numpy(), 1, -1), ref, rtol=5e-4, atol=5e-5,
           label=option)


def test_punetg_3d_flash_circular_matches_jax():
    """3D 32³ with circular convolutions and a 4096-token flash attention
    bottleneck, in both packages."""
    fields = dict(_SMALL, model_channels=4, dimension=3,
                  number_resnet_attn_block=2, num_heads=2,
                  attn_backend="flash", convolution_type="circular")
    x = np.random.default_rng(2).standard_normal(
        (1, 32, 32, 32, 1)).astype(np.float32)
    t = np.array([0.3], np.float32)
    variables, ref = _jax_punetg(fields, jnp.asarray(x), jnp.asarray(t))
    net = PUNetG(PUNetGConfig(**fields), device="cpu")
    net.load_state_dict(_sd(variables), strict=True)
    with torch.no_grad():
        out = net(_nc(x), _t(t))
    _check(np.moveaxis(out.numpy(), 1, -1), ref, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("dims,shape", [(None, (2, 7, 9, 3)),
                                        ((0,), (2, 7, 9, 3)),
                                        ((1,), (2, 7, 9, 3)),
                                        ((0, 2), (1, 5, 6, 7, 2))])
def test_circular_conv_matches_jax(dims, shape):
    """CircularConv with every spatial dim periodic and with a subset
    (zeros on the others), 2D and 3D."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jconv = jlayers.CircularConv(4, 3, circular_dims=dims)
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    conv = layers.CircularConv(len(shape) - 2, shape[-1], 4, 3,
                               circular_dims=dims)
    k = np.asarray(variables["params"]["Conv_0"]["kernel"])
    nd = k.ndim - 2
    conv.load_state_dict({"weight": _t(np.transpose(
        k, (nd + 1, nd) + tuple(range(nd)))),
        "bias": _t(np.asarray(variables["params"]["Conv_0"]["bias"]))})
    with torch.no_grad():
        out = conv(_nc(x))
    _check(np.moveaxis(out.numpy(), 1, -1), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rate,train", [(0.0, True), (1.0, True),
                                        (1.0, False), (0.5, False)])
def test_condition_drop_matches_jax(rate, train):
    """Rates 0 and 1 are deterministic in both packages; eval mode is the
    identity whatever the rate. The embedding is [B, C] and, spatially
    varying, [B, C, H, W]."""
    rng = np.random.default_rng(4)
    jdrop = jlayers.ConditionDrop(rate, 6)
    for shape in ((3, 6), (3, 5, 4, 6)):
        x = rng.standard_normal(shape).astype(np.float32)
        variables = jdrop.init(jax.random.PRNGKey(0), jnp.asarray(x))
        ref = np.asarray(jdrop.apply(variables, jnp.asarray(x), train=train,
                                     rngs={"dropout": jax.random.PRNGKey(1)}))
        drop = layers.ConditionDrop(rate, 6).train(train)
        drop.load_state_dict({"null_embedding": _t(np.asarray(
            variables["params"]["null_embedding"]))})
        with torch.no_grad():
            out = drop(_nc(x) if x.ndim > 2 else _t(x))
        out = np.moveaxis(out.numpy(), 1, -1) if x.ndim > 2 else out
        _check(out, ref, rtol=0, atol=0, label=str(shape))


def test_punetg_cond_with_embedder_matches_jax():
    """PUNetGCond (scope ``unet``) with a composite embedding of the rest
    of the condition: a porosity embedder and a two-point-correlation
    transformer (flax attention -> torch's packed projections)."""
    fields = dict(_SMALL, input_channels=2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    pmap = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    t = np.array([0.5, -1.2], np.float32)
    cond = {"porosity": _porosity(2, 6),
            "tpc_dist": np.tile(np.arange(5, dtype=np.float32), (2, 1)),
            "tpc_prob": rng.uniform(0.1, 0.9, (2, 5)).astype(np.float32)}
    jnet = jpunetg.PUNetGCond(
        jpunetg.PUNetGConfig(**fields),
        conditional_embedding=jemb.CompositeEmbedder([
            jemb.PorosityEmbedder(8),
            jemb.TwoPointCorrelationTransformer(8, nhead=2, num_layers=1)]),
        channel_conditional_items=("pmap",))
    jy = {"pmap": jnp.asarray(pmap),
          **{k: jnp.asarray(v) for k, v in cond.items()}}
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(t), jy)
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x), jnp.asarray(t),
                                jy))
    net = PUNetGCond(
        PUNetGConfig(**fields),
        conditional_embedding=embedders.CompositeEmbedder([
            embedders.PorosityEmbedder(8),
            embedders.TwoPointCorrelationTransformer(8, nhead=2,
                                                     num_layers=1)]),
        channel_conditional_items=("pmap",), device="cpu")
    net.load_state_dict(_sd(variables), strict=True)
    with torch.no_grad():
        out = net(_nc(x), _t(t), {"pmap": _nc(pmap),
                                  **{k: _t(v) for k, v in cond.items()}})
    _check(np.moveaxis(out.numpy(), 1, -1), ref, rtol=5e-4, atol=5e-5)
    assert net.export_description() == jnet.export_description()


@pytest.mark.parametrize("fields", [
    dict(_SMALL), dict(_SMALL, number_resnet_attn_block=2),
    dict(_SMALL, space_to_depth=2, in_embedding=True,
         channel_expansion=(2, 4))])
def test_receptive_field_and_description_match_jax(fields):
    assert calculate_receptive_field(PUNetGConfig(**fields)) == \
        jpunetg.calculate_receptive_field(jpunetg.PUNetGConfig(**fields))
    assert PUNetG(PUNetGConfig(**fields), device="cpu").export_description() \
        == jpunetg.PUNetG(jpunetg.PUNetGConfig(**fields)).export_description()


def test_norm_routing_to_k2():
    """Only spatial, affine, per-channel norms with SiLU take K2 (and K3
    in the backward): GroupPix (per pixel), affine_norm=False and the
    identity norm never call the kernel's wrapper."""
    calls = []
    real = fused_norm.norm_silu

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    x = torch.randn(2, 1, 8, 8)
    t = torch.zeros(2)
    cases = {"default": (dict(), 2 * 5),
             "group_pix": (dict(first_resblock_norm="GroupPix",
                                second_resblock_norm="GroupPix"), 0),
             "no_affine": (dict(affine_norm=False), 0),
             "identity": (dict(first_resblock_norm="Identity",
                               second_resblock_norm="GroupPix"), 0)}
    fused_norm.norm_silu = counting
    try:
        for name, (fields, expected) in cases.items():
            calls.clear()
            net = PUNetG(PUNetGConfig(**_SMALL, **fields), device="cpu")
            net(x, t).sum().backward()
            assert len(calls) == expected, name
            fused = [m.fused for m in net.modules()
                     if isinstance(m, layers._GroupNormBase)]
            assert all(fused) if expected else not any(fused), name
    finally:
        fused_norm.norm_silu = real


# ---------------------------------------------------------------------------
# KarrasModel: guidance, batch norm, condition drop, training, sampling
# ---------------------------------------------------------------------------
def _cond_models(fields=None, bnorm=False, x_shape=(3, 16, 16, 1)):
    """JAX and port KarrasModels around a porosity-conditioned PUNetG with
    one set of weights."""
    fields = dict(_SMALL, **(fields or {}))
    kw = dict(has_edm_batch_norm=True) if bnorm else {}
    jmodel = JKarrasModel(
        jpunetg.PUNetG(jpunetg.PUNetGConfig(**fields),
                       conditional_embedding=jemb.PorosityEmbedder(8)),
        JKarrasModelConfig.from_edm(**kw), conditional=True)
    y = {"porosity": jnp.asarray(_porosity(x_shape[0], 0))}
    variables = jmodel.init(jax.random.PRNGKey(0), x_shape, y)
    cfg = PUNetGConfig(**fields)
    model = KarrasModel(
        PUNetG(cfg, conditional_embedding=embedders.PorosityEmbedder(8),
               device="cpu"),
        KarrasModelConfig.from_edm(**kw), conditional=True, device="cpu")
    model.net.load_state_dict(_sd(variables, cfg), strict=True)
    return jmodel, variables, model


def test_interval_guidance_denoiser_matches_jax():
    """σ inside and outside the band (0.3, 5) in one batch: guided rows
    blend (1 - g)·uncond + g·cond, the others are the conditional
    denoiser; the combine is one call on the guided base."""
    jmodel, variables, model = _cond_models()
    x = np.random.default_rng(7).standard_normal((3, 16, 16, 1)).astype(
        np.float32) * 2
    sigma = np.array([0.1, 1.0, 10.0], np.float32)
    por = _porosity(3, 8)
    for guidance in (2.5, (2.5, 0.3, 5.0)):
        jg = JIntervalGuidance(*guidance) if isinstance(guidance, tuple) \
            else guidance
        g = IntervalGuidance(*guidance) if isinstance(guidance, tuple) \
            else guidance
        ref, _ = jmodel.get_denoiser(variables, jnp.asarray(x),
                                     jnp.asarray(sigma),
                                     y={"porosity": jnp.asarray(por)},
                                     guidance=jg)
        with torch.no_grad():
            den, _ = model.get_denoiser(_t(x), _t(sigma),
                                        y={"porosity": _t(por)}, guidance=g)
        _check(den, np.asarray(ref), rtol=5e-4, atol=5e-5, label=str(g))
    cond, _ = jmodel.get_denoiser(variables, jnp.asarray(x),
                                  jnp.asarray(sigma),
                                  y={"porosity": jnp.asarray(por)})
    # rows outside the band are the plain conditional denoiser
    _check(den[0], np.asarray(cond)[0], rtol=5e-4, atol=5e-5)
    _check(den[2], np.asarray(cond)[2], rtol=5e-4, atol=5e-5)
    assert not np.allclose(den[1].numpy(), np.asarray(cond)[1], atol=1e-3)


def test_guided_heun_sample_matches_jax():
    """18 guided Heun steps (IntervalGuidance(2, 0.3, 5): 70 network
    calls) from one x0, one porosity for the whole batch."""
    jmodel, variables, model = _cond_models(x_shape=(2, 16, 16, 1))
    x0 = np.random.default_rng(9).standard_normal((2, 16, 16, 1)).astype(
        np.float32)
    por = np.array([0.3], np.float32)
    ref = np.asarray(jmodel.propagate_white_noise(
        variables, jax.random.PRNGKey(0), jnp.asarray(x0),
        y={"porosity": jnp.asarray(por)},
        guidance=JIntervalGuidance(2.0, 0.3, 5.0), nsteps=18,
        record_history=True))
    hist = model.propagate_white_noise(
        _t(x0), y={"porosity": _t(por)},
        guidance=IntervalGuidance(2.0, 0.3, 5.0), nsteps=18,
        record_history=True)
    assert hist.shape == ref.shape == (19, 2, 16, 16, 1)
    _check(hist[-1], ref[-1], rtol=1e-3, atol=1e-4)
    _check(hist, ref, rtol=1e-3, atol=5e-4)


def test_batch_norm_loss_and_updates_match_jax():
    """loss_fn in training: x whitened by the batch's statistics (the
    population variance), the running statistics' momentum update equal
    to JAX's ``batch_stats`` update, ε replayed; in eval the running
    statistics."""
    x_shape = (3, 16, 16, 1)
    jmodel, variables, model = _cond_models(bnorm=True)
    rng = np.random.default_rng(10)
    x = (rng.standard_normal(x_shape) * 0.7 + 0.4).astype(np.float32)
    sigma = np.array([0.2, 1.0, 3.0], np.float32)
    eps = rng.standard_normal(x_shape).astype(np.float32)
    por = {"porosity": _porosity(3, 11)}
    for train in (True, False):
        jl, upd = jmodel.loss_fn(variables, jax.random.PRNGKey(0),
                                 jnp.asarray(x), jnp.asarray(sigma),
                                 y={k: jnp.asarray(v) for k, v in
                                    por.items()},
                                 train=train, eps=jnp.asarray(eps))
        loss, updates = model.loss_fn(
            _t(x), _t(sigma), y={k: _t(v) for k, v in por.items()},
            train=train, eps=_t(eps), return_updates=True)
        _check(loss, float(jl), rtol=1e-5, atol=1e-7, label=str(train))
        if train:
            for k in ("mean", "var"):
                _check(updates[f"bnorm.{k}"],
                       np.asarray(upd["batch_stats"]["bnorm"][k]),
                       rtol=1e-6, atol=1e-7, label=k)
        else:
            assert updates == {}


def test_encode_decode_round_trip_matches_jax():
    """encode (running statistics, / norm) and decode (· norm, inverse
    batch norm) against the JAX package's, and decode(encode(x)) = x."""
    jmodel, variables, model = _cond_models(bnorm=True)
    stats = {"mean": np.array([0.3], np.float32),
             "var": np.array([2.5], np.float32)}
    variables = {**variables, "batch_stats": {"bnorm": {
        k: jnp.asarray(v) for k, v in stats.items()}}}
    for k, v in stats.items():
        getattr(model.net.bnorm, k).copy_(_t(v))
    jmodel.norm = model.norm = 2.0
    x = np.random.default_rng(12).standard_normal((2, 8, 8, 1)).astype(
        np.float32)
    jenc = np.asarray(jmodel.encode(variables, jnp.asarray(x))[0])
    with torch.no_grad():
        enc = model.encode(_t(x))[0]
        dec = model.decode(enc)
    _check(enc, jenc, rtol=1e-6, atol=1e-7)
    _check(dec, np.asarray(jmodel.decode(variables, jnp.asarray(jenc))),
           rtol=1e-6, atol=1e-6)
    _check(dec, x, rtol=1e-5, atol=1e-6)


def test_cond_drop_in_loss_and_keep_replay():
    """Training with cond_drop: the keep mask is drawn from the step's
    generator after σ and ε (``keep=`` replays it); a mask of all False
    equals JAX's rate-1 loss (every row takes the null embedding), all
    True the rate-0-like loss with the condition."""
    x_shape = (3, 16, 16, 1)
    rng = np.random.default_rng(13)
    x = rng.standard_normal(x_shape).astype(np.float32)
    sigma = np.array([0.2, 1.0, 3.0], np.float32)
    eps = rng.standard_normal(x_shape).astype(np.float32)
    por = _porosity(3, 14)
    for rate, keep in ((1.0, False), (1e-9, True)):
        jmodel, variables, model = _cond_models(dict(cond_drop=rate))
        jl, _ = jmodel.loss_fn(variables, jax.random.PRNGKey(0),
                               jnp.asarray(x), jnp.asarray(sigma),
                               y={"porosity": jnp.asarray(por)},
                               eps=jnp.asarray(eps))
        loss = model.loss_fn(_t(x), _t(sigma), y={"porosity": _t(por)},
                             eps=_t(eps),
                             cond_keep=torch.full((3,), keep))
        _check(loss, float(jl), rtol=1e-5, atol=1e-7, label=str(rate))
    # the draw: σ, ε, then keep from one generator
    model.cond_drop_rate = 0.5
    g = torch.Generator().manual_seed(3)
    keep = model.draw_cond_keep(3, g)
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(keep, torch.rand(3, generator=g2) < 0.5)


def test_batch_norm_train_trajectory_matches_jax():
    """5 f32 steps of make_train_step with the EDM batch norm and a
    conditioned net, σ and ε replayed: loss, grad norm and parameters at
    ``test_torch_training.py``'s tolerances, and the running statistics
    carried from step to step equal to JAX's."""
    x_shape, lr = (4, 16, 16, 1), 1e-3
    jmodel, _, _ = _cond_models(bnorm=True, x_shape=x_shape)
    y = {"porosity": _porosity(4, 15)}
    jstate, jtx = jcreate_train_state(
        jmodel, jax.random.PRNGKey(0), x_shape,
        y={k: jnp.asarray(v) for k, v in y.items()})

    def jloss(variables, key, x, yy, replay, train=True):
        return jmodel.loss_fn(variables, key, x, replay["sigma"],
                              y={k: jnp.asarray(v) for k, v in y.items()},
                              train=train, eps=replay["eps"])

    jstep = jmake_train_step(jmodel, jtx, loss_fn=jloss)
    _, _, model = _cond_models(bnorm=True, x_shape=x_shape)
    model.net.load_state_dict(_sd(jstate.variables()), strict=True)
    state, tx = create_train_state(model, x_shape, seed=None,
                                   optimizer=default_optimizer(lr))
    step = make_train_step(model, tx)
    rng = np.random.default_rng(16)
    x = (rng.standard_normal(x_shape) * 0.5 + 0.2).astype(np.float32)
    for k in range(1, 6):
        sigma = np.exp(rng.standard_normal(4) * 1.2 - 1.2).astype(np.float32)
        eps = rng.standard_normal(x_shape).astype(np.float32)
        jstate, jmet = jstep(jstate, jax.random.PRNGKey(k), jnp.asarray(x),
                             None, {"sigma": jnp.asarray(sigma),
                                    "eps": jnp.asarray(eps)})
        state, met = step(state, _t(x), y={kk: _t(v) for kk, v in y.items()},
                          sigma=_t(sigma), eps=_t(eps))
        _check(met["train_loss"], float(jmet["train_loss"]), rtol=1e-5,
               atol=0)
        _check(met["grad_norm"], float(jmet["grad_norm"]), rtol=1e-4,
               atol=0)
        theirs = _sd(jstate.variables())
        for name in ("bnorm.mean", "bnorm.var"):
            _check(model.net.state_dict()[name], theirs[name].numpy(),
                   rtol=1e-6, atol=1e-7, label=f"{name} step {k}")
        diff = np.concatenate([(state.params[n].detach() - theirs[n]).abs()
                               .flatten().numpy() for n in state.params])
        assert np.quantile(diff, 0.999) <= 0.01 * lr, k
        assert diff.max() <= 2 * k * lr, k


def test_config_fields_and_description():
    cfg = KarrasModelConfig.from_edm(has_edm_batch_norm=True,
                                     dynamic_loss_weight=8,
                                     loss_metric="mse")
    jcfg = JKarrasModelConfig.from_edm(has_edm_batch_norm=True,
                                       dynamic_loss_weight=8,
                                       loss_metric="mse")
    assert cfg.export_description() == jcfg.export_description()
    assert cfg.has_dynamic_loss_weight and cfg.has_edm_batch_norm
    cfg.update_loss_metric("huber")
    assert cfg.loss_metric == cfg.extra_args["loss_metric"] == "huber"
    assert hash(IntervalGuidance(2.0, 0.3, 5.0)) == hash(
        IntervalGuidance(2.0, 0.3, 5.0))
    assert dataclasses.astuple(IntervalGuidance(2.0, 0.3, 5.0)) == \
        dataclasses.astuple(JIntervalGuidance(2.0, 0.3, 5.0))
