"""The rest of the port's score-network zoo against the reference fixtures
and the JAX package: ConVit, the PUNetG variants (deterministic,
encoder/decoder, PUNetV), MinimalResNet and DASC.

Each reference state dict loads into the port's module with
``load_state_dict(strict=True)`` and gives the fixture's output at the
bound of the JAX package's test on the same fixture: ConVit
(``convit_forward.npz``, rtol 5e-4, atol 5e-5,
``tests/test_reference_parity6.py``), the PUNetG variants
(``punetg_deterministic.npz``, ``punetg_encdec.npz``,
``punetv_forward.npz``, rtol 5e-4, atol 5e-5,
``tests/test_reference_parity3.py``), MinimalResNet 2D and 3D
(``classifier_forward.npz``, rtol 1e-4, atol 1e-5,
``tests/test_reference_parity5.py``) and DASC with ``dasc_loss``
(``dasc_forward.npz``, ``tests/test_reference_parity9.py``'s bounds).
The JAX package's weights reach the port through ``from_jax_variables``:
each module is also held live against the JAX package on the same
(randomly drawn) weights, at rtol 2e-4, atol 2e-5.

The deterministic reference has no time path, while the JAX package's
``PUNetGDeterministic`` (and the port's) runs PUNetG's time MLPs on a
zero embedding, which give exactly 0 when their biases are 0 (flax's
initialization): the fixture test loads the reference's keys and sets
those biases to 0, as the JAX test's template has them.
"""

import os

import numpy as np
import pytest
import torch

import _torch_warmup  # noqa: F401

import flax.linen as jnn
import jax
import jax.numpy as jnp

from diffsci_tpu.models.nets import classifiers as jclassifiers
from diffsci_tpu.models.nets import convit as jconvit
from diffsci_tpu.models.nets import dasc as jdasc
from diffsci_tpu.models.nets import punetg_variants as jvariants
from diffsci_tpu.models.nets.punetg import PUNetGConfig as JPUNetGConfig

from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.models.nets import (classifiers, convit, dasc, layers,
                                           punetg_variants as variants)
from diffsci_tpu_torch.models.nets.punetg import PUNetGConfig

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")


def _check(ours, ref, rtol, atol, label=""):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    np.testing.assert_allclose(np.asarray(ours, np.float64),
                               np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol, err_msg=label)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nc(a):
    """channels-last -> [B, C, *spatial] tensor."""
    return _t(np.moveaxis(np.asarray(a), -1, 1))


def _cl(a):
    return np.moveaxis(a.detach().numpy(), 1, -1)


def _sd(d, prefix):
    return {k[len(prefix):]: _t(d[k]) for k in d.files
            if k.startswith(prefix)}


def _noisy(variables, seed, scale=0.2):
    """Every leaf redrawn from N(0, scale²) (zero-initialized biases and
    gates would hide mapping errors)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(np.shape(a))
                                   * scale).astype(np.float32), variables)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# ConVit
# ---------------------------------------------------------------------------
CONVIT_CASES = {
    "softmax": dict(),
    "linear": dict(linear_attention=True),
    "convsample": dict(with_conv_on_upsample=True,
                       with_conv_on_downsample=True),
    "cond": dict(has_conditional_embedding=True, relative_positioning=True),
}


def _convit_config(cls, **extra):
    return cls(in_channels=1, embed_dim=8, num_pos_dims=2, num_layers=2,
               num_heads=2, ffn_expansion_factor=2, attn_compression_factor=2,
               kernel_size_in_out=3, kernel_size_conv=1,
               kernel_size_depthwise=3, has_time_embedding=True,
               condition_dropout=0.0, **extra)


@pytest.mark.parametrize("case", sorted(CONVIT_CASES))
def test_convit_reference_state_dict(case):
    d = np.load(os.path.join(FIXDIR, "convit_forward.npz"))
    cond = case == "cond"
    net = convit.ConVit(_convit_config(convit.ConVitConfig,
                                       **CONVIT_CASES[case]),
                        conditional_embedding=(torch.nn.Linear(3, 8)
                                               if cond else None),
                        device="cpu")
    net.load_state_dict(_sd(d, case + "sd__"), strict=True)
    with torch.no_grad():
        out = net(_t(d["x"]), _t(d["t"]), _t(d["ycond"]) if cond else None)
    _check(out, d[f"{case}_out"], rtol=5e-4, atol=5e-5, label=case)


@pytest.mark.parametrize("case", ["softmax_1d", "linear_cond",
                                  "convsample_3d"])
def test_convit_live_against_jax(case):
    kw = {"softmax_1d": dict(num_pos_dims=1),
          "linear_cond": dict(linear_attention=True,
                              has_conditional_embedding=True),
          "convsample_3d": dict(num_pos_dims=3, with_conv_on_upsample=True,
                                with_conv_on_downsample=True)}[case]
    nd = kw.get("num_pos_dims", 2)
    base = dict(in_channels=1, embed_dim=8, num_layers=2, num_heads=2,
                ffn_expansion_factor=2, kernel_size_in_out=3,
                has_time_embedding=True, condition_dropout=0.0,
                num_pos_dims=nd)
    base.update(kw)
    cond = base.get("has_conditional_embedding", False)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2,) + (8,) * nd + (1,)).astype(np.float32)
    t = np.array([0.2, -0.9], np.float32)
    y = rng.standard_normal((2, 3)).astype(np.float32) if cond else None
    jnet = jconvit.ConVit(jconvit.ConVitConfig(**base),
                          conditional_embedding=jnn.Dense(8) if cond
                          else None)
    variables = _noisy(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 jnp.asarray(t), y), 2, scale=0.3)
    ref = jnet.apply(variables, jnp.asarray(x), jnp.asarray(t), y)
    net = convit.ConVit(convit.ConVitConfig(**base),
                        conditional_embedding=(torch.nn.Linear(3, 8)
                                               if cond else None),
                        device="cpu")
    net.load_state_dict(from_jax_variables(_np(variables)), strict=True)
    with torch.no_grad():
        out = net(_nc(x), _t(t), None if y is None else _t(y))
    _check(_cl(out), ref, rtol=2e-4, atol=2e-5, label=case)


# ---------------------------------------------------------------------------
# PUNetG variants
# ---------------------------------------------------------------------------
_SMALL = dict(model_channels=8, channel_expansion=[2],
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1)


def test_punetg_deterministic_reference_state_dict():
    d = np.load(os.path.join(FIXDIR, "punetg_deterministic.npz"))
    net = variants.PUNetGDeterministic(PUNetGConfig(**_SMALL), device="cpu")
    sd = {f"unet.{k}": v for k, v in _sd(d, "sd__").items()}
    missing, unexpected = net.load_state_dict(sd, strict=False)
    assert not unexpected
    assert missing and all(".timeblock." in k for k in missing)
    with torch.no_grad():
        for k in missing:
            if k.endswith(".bias"):
                net.get_parameter(k).zero_()
        y = net(_t(d["x"]), torch.tensor([5.0, -3.0]))   # t is not read
    _check(y, d["y"], rtol=5e-4, atol=5e-5)


def test_punetg_encoder_decoder_reference_state_dicts():
    d = np.load(os.path.join(FIXDIR, "punetg_encdec.npz"))
    cfg = PUNetGConfig(**_SMALL)
    enc = variants.PUNetGEncoder(cfg, use_time_embedding=True, device="cpu")
    enc.load_state_dict(_sd(d, "esd__"), strict=True)
    dec = variants.PUNetGDecoder(cfg, use_time_embedding=True, device="cpu")
    dec.load_state_dict(_sd(d, "dsd__"), strict=True)
    with torch.no_grad():
        z = enc(_t(d["x"]), _t(d["t"]))
        xr = dec(_t(d["z"]), _t(d["t"]))
    _check(z, d["z"], rtol=5e-4, atol=5e-5, label="encoder latent")
    _check(xr, d["xr"], rtol=5e-4, atol=5e-5, label="decoder")


def test_punetv_reference_state_dict():
    d = np.load(os.path.join(FIXDIR, "punetv_forward.npz"))
    net = variants.PUNetV(variants.PUNetVConfig(**_SMALL), device="cpu")
    net.load_state_dict(_sd(d, "sd__"), strict=True)
    with torch.no_grad():
        y = net(_t(d["x"]), _t(d["t"]))
    _check(y, d["y"], rtol=5e-4, atol=5e-5)
    desc = net.export_description()
    assert desc == jvariants.PUNetV(jvariants.PUNetVConfig(
        **_SMALL)).export_description()


_LIVE = dict(_SMALL, number_resnet_attn_block=2, num_heads=2)


def _live(jnet, net, args_jax, args_port, seed, convert_config=None):
    variables = _noisy(jnet.init(jax.random.PRNGKey(0), *args_jax), seed)
    ref = jnet.apply(variables, *args_jax)
    net.load_state_dict(from_jax_variables(_np(variables), convert_config),
                        strict=True)
    with torch.no_grad():
        out = net(*args_port)
    return out, ref


def test_punetg_variants_live_against_jax():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    t = np.array([0.4, -0.8], np.float32)
    jcfg, cfg = JPUNetGConfig(**_LIVE), PUNetGConfig(**_LIVE)

    out, ref = _live(jvariants.PUNetGDeterministic(jcfg),
                     variants.PUNetGDeterministic(cfg, device="cpu"),
                     (jnp.asarray(x),), (_nc(x),), 1)
    _check(_cl(out), ref, rtol=2e-4, atol=2e-5, label="deterministic")
    desc = variants.PUNetGDeterministic(cfg, device="cpu")
    assert desc.export_description() == \
        jvariants.PUNetGDeterministic(jcfg).export_description()

    out, ref = _live(
        jvariants.PUNetGEncoder(jcfg, use_time_embedding=True,
                                output_channels=6),
        variants.PUNetGEncoder(cfg, use_time_embedding=True,
                               output_channels=6, device="cpu"),
        (jnp.asarray(x), jnp.asarray(t)), (_nc(x), _t(t)), 2)
    _check(out, ref, rtol=2e-4, atol=2e-5, label="encoder projection")

    z = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    skip = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    out, ref = _live(
        jvariants.PUNetGDecoder(jcfg),
        variants.PUNetGDecoder(cfg, device="cpu"),
        (jnp.asarray(z), None, [jnp.asarray(skip)]),
        (_nc(z), None, [_nc(skip)]), 3)
    _check(_cl(out), ref, rtol=2e-4, atol=2e-5, label="decoder skips")


def test_punetv_slices_live_against_jax():
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    t = np.array([0.4, -0.8], np.float32)
    yb = rng.standard_normal((2, 3, 16, 16, 4)).astype(np.float32)
    mask = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    kw = dict(_SMALL, slice_embed_channels=4)
    jnet = jvariants.PUNetV(jvariants.PUNetVConfig(**kw))
    net = variants.PUNetV(variants.PUNetVConfig(**kw), device="cpu")
    out, ref = _live(
        jnet, net,
        (jnp.asarray(x), jnp.asarray(t),
         {"yb": jnp.asarray(yb), "temporal_mask": jnp.asarray(mask)}),
        (_nc(x), _t(t), {"yb": _t(np.moveaxis(yb, -1, 2)),
                         "temporal_mask": _t(mask)}), 4,
        variants.PUNetVConfig(**kw))
    _check(_cl(out), ref, rtol=2e-4, atol=2e-5, label="punetv slices")


@pytest.mark.parametrize("size", [(8, 8), (6, 10), (32, 20)])
def test_linear_resize_matches_jax(size):
    x = np.random.default_rng(1).standard_normal((2, 16, 12, 3)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2,) + size + (3,), "linear")
    _check(_cl(layers.linear_resize(_nc(x), size)), ref, rtol=1e-5,
           atol=1e-6)


# ---------------------------------------------------------------------------
# MinimalResNet and DASC
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dim", [2, 3])
def test_classifier_reference_state_dict(dim):
    d = np.load(os.path.join(FIXDIR, "classifier_forward.npz"))
    kw = dict(in_channels=1, out_classes=3, model_channels=8, n_layers=2,
              dimension=dim, num_groups=4)
    net = classifiers.MinimalResNet(**kw, device="cpu")
    net.load_state_dict(_sd(d, f"c{dim}sd__"), strict=True)
    with torch.no_grad():
        logits = net(_t(d[f"c{dim}_x"]))
    _check(logits, d[f"c{dim}_logits"], rtol=1e-4, atol=1e-5)
    x = np.moveaxis(d[f"c{dim}_x"], 1, -1)
    out, ref = _live(jclassifiers.MinimalResNet(**kw),
                     classifiers.MinimalResNet(**kw, device="cpu"),
                     (jnp.asarray(x),), (_t(d[f"c{dim}_x"]),), 5)
    _check(out, ref, rtol=2e-4, atol=2e-5, label="live")


_DASC = dict(in_channels=1, frame_height=16, frame_width=16,
             frames_per_video=3, latent_dim=16, num_videos=4,
             encoder_channels=(8, 16), vmm_num_layers=2,
             use_skip_connections=True)


def test_dasc_reference_state_dict_and_loss():
    d = np.load(os.path.join(FIXDIR, "dasc_forward.npz"))
    cfg = dasc.DASCConfig(**_DASC)
    net = dasc.DASC(cfg, device="cpu")
    net.load_state_dict(_sd(d, "sd__"), strict=True)
    x = _t(d["x"])
    with torch.no_grad():
        out = net(x, all_videos_mode=True)
        batch = net(x)
    for key, ref, rtol, atol in (
            ("frame_features", "all_frame_features", 5e-4, 1e-5),
            ("video_features", "all_video_features", 5e-4, 1e-5),
            ("attention_weights", "all_attention", 5e-4, 1e-5),
            ("coefficient_matrix", "all_coeff", 1e-5, 1e-7),
            ("self_represented_features", "all_self_repr", 5e-4, 1e-5),
            ("reconstructed", "all_reconstructed", 5e-4, 1e-5)):
        _check(out[key], d[ref], rtol=rtol, atol=atol, label=key)
    _check(batch["reconstructed"], d["batch_reconstructed"], rtol=5e-4,
           atol=1e-5)
    total, losses = dasc.dasc_loss(cfg, out, x, stage="second")
    _check(total, d["loss_total"], rtol=5e-4, atol=1e-6)
    for key in ("mse", "self_repr", "sparsity"):
        _check(losses[key], d[f"loss_{key}"], rtol=5e-4, atol=1e-7,
               label=key)
    first, _ = dasc.dasc_loss(cfg, out, x, stage="first")
    _check(first, losses["mse"], rtol=0, atol=0)


@pytest.mark.parametrize("skips", [True, False])
def test_dasc_live_against_jax(skips):
    kw = dict(_DASC, use_skip_connections=skips)
    x = np.random.default_rng(19).standard_normal((4, 3, 16, 16, 1)).astype(
        np.float32)
    jnet = jdasc.DASC(jdasc.DASCConfig(**kw))
    variables = _noisy(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 all_videos_mode=True), 6)
    ref = jnet.apply(variables, jnp.asarray(x), all_videos_mode=True)
    net = dasc.DASC(dasc.DASCConfig(**kw), device="cpu")
    net.load_state_dict(from_jax_variables(_np(variables)), strict=True)
    with torch.no_grad():
        out = net(_t(np.moveaxis(x, -1, 2)), all_videos_mode=True)
    _check(np.moveaxis(out["reconstructed"].numpy(), 2, -1),
           ref["reconstructed"], rtol=2e-4, atol=2e-5)
    _check(out["self_represented_features"],
           ref["self_represented_features"], rtol=2e-4, atol=2e-5)
