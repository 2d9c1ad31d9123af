"""The port's latent diffusion against the JAX package: a ``KarrasModel``
over a ``BoundAutoencoder`` (its loss with a replayed posterior draw,
plain and ``MultiSpaceLoss``; its samples, decoded or in the latent
space), ``autoregressive_sample`` (the JAX model's ``sample`` patched to
start from the port's x_T), ``KarrasEncoderModel`` against
``karras_encoder_loss.npz``, and descriptions with ``autoencoder=``.

Inputs are made with numpy; JAX weights reach the port through
``from_jax_variables``. Data and latents are channels-last in both
packages; the autoencoder's own tensors and the condition window are
[B, C, *spatial] in the port. Losses are held at the JAX tests' rtol
5e-4; sampled trajectories at rtol 1e-3 (the port's other Heun
trajectories against the JAX package's, tests/test_torch_sampling.py)
with an atol of 1e-4 of the trajectory's largest entry: an untrained
net drives a 3-step sample from σ = 80 to entries of ~20, where float32
sums in another order move an entry near zero by ~1e-4 of that scale.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn as nn

import _torch_warmup  # noqa: F401

import jax
import jax.numpy as jnp
import flax.linen as jnn

from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import vae as jvae_module
from diffsci_tpu.models.karras import autoregressive as jar
from diffsci_tpu.models.karras import ensemble as jens
from diffsci_tpu.models.karras.encoder import \
    KarrasEncoderModel as JKarrasEncoderModel
from diffsci_tpu.models.karras.module import \
    karras_model_from_description as jfrom_description
from diffsci_tpu.models.nets import vae as jvae
from diffsci_tpu.models.nets.mlp import MLPCond as JMLPCond
from diffsci_tpu.models.nets.punetg import PUNetG as JPUNetG
from diffsci_tpu.models.nets.punetg import PUNetGCond as JPUNetGCond
from diffsci_tpu.models.nets.punetg import PUNetGConfig as JPUNetGConfig

from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                               PUNetGCond, PUNetGConfig,
                               karras_model_from_description)
from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.models.karras import autoregressive as ar
from diffsci_tpu_torch.models.karras import ensemble as ens
from diffsci_tpu_torch.models.karras.encoder import KarrasEncoderModel
from diffsci_tpu_torch.models.nets import MLPCond, vae
from diffsci_tpu_torch.models import vae as vae_module

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")
_SMALL = dict(model_channels=8, channel_expansion=(2,),
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1)
PIX, LAT, LC = 16, 8, 2          # pixel side, latent side, latent channels


def _check(ours, ref, rtol, atol, label=""):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    np.testing.assert_allclose(np.asarray(ours, np.float64),
                               np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol, err_msg=label)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check_sample(ours, ref, label=""):
    _check(ours, ref, rtol=1e-3, atol=1e-4 * float(np.abs(ref).max()),
           label=label)


class _EpsBound(jvae_module.BoundAutoencoder):
    """The JAX package's binding with its posterior draw replayed (its
    ``encode`` takes a key only)."""
    eps = None

    def encode(self, x, key=None, y=None):
        enc = self.model.encode(self.variables, x, eps=self.eps)
        return enc["zsample"] * self.scale_factor


def _autoencoders(scale=0.7):
    """A JAX-bound VAE and the port's over the same weights."""
    kw = dict(double_z=True, z_channels=LC, resolution=PIX, in_channels=1,
              out_ch=1, ch=8, ch_mult=(1, 2), num_res_blocks=1)
    jmodel = jvae_module.VAEModel(
        jvae.AutoencoderKL(jvae.DDConfig(**kw), embed_dim=LC),
        jvae_module.VAEModelConfig())
    variables = jmodel.init(jax.random.PRNGKey(3), (1, PIX, PIX, 1))
    tmodel = vae_module.VAEModel(
        vae.AutoencoderKL(vae.DDConfig(**kw), LC, device="cpu"),
        vae_module.VAEModelConfig(), device="cpu")
    tmodel.net.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables)), strict=True)
    return (_EpsBound(jmodel, variables, scale),
            vae_module.BoundAutoencoder(tmodel, scale_factor=scale))


def _latent_pair(loss_metric="huber", sample_posterior=True):
    jbound, bound = _autoencoders()
    bound.sample_posterior = sample_posterior
    fields = dict(_SMALL, input_channels=LC, output_channels=LC)
    jmodel = JKarrasModel(JPUNetG(JPUNetGConfig(**fields)),
                          JKarrasModelConfig.from_edm(loss_metric=loss_metric),
                          autoencoder=jbound)
    variables = jmodel.init(jax.random.PRNGKey(0), (2, LAT, LAT, LC))
    model = KarrasModel(PUNetG(PUNetGConfig(**fields), device="cpu"),
                        KarrasModelConfig.from_edm(loss_metric=loss_metric),
                        autoencoder=bound, device="cpu")
    model.net.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables)), strict=True)
    return jmodel, variables, model, jbound


MULTI = {"losses": [
    {"name": "lat", "type": "huber", "space": "latent", "weight": 0.5},
    {"name": "pix", "type": "mse", "space": "pixel", "weight": 2.0}]}


@pytest.mark.parametrize("metric", ["huber", "multi"])
def test_latent_loss_matches_jax(metric):
    """The loss of a latent model: x encoded with a replayed posterior
    draw, the denoiser in the latent space, the metric there (or the
    multi-space loss: a latent Huber term and a pixel MSE term through the
    decoder) at rtol 5e-4, atol 1e-6."""
    jmodel, variables, model, jbound = _latent_pair(
        MULTI if metric == "multi" else metric)
    assert model.latent_model and model.draws_posterior()
    assert model.latent_shape((2, PIX, PIX, 1)) == (2, LAT, LAT, LC)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, PIX, PIX, 1)).astype(np.float32)
    sigma = np.array([0.4, 3.0], np.float32)
    eps = rng.normal(size=(2, LAT, LAT, LC)).astype(np.float32)
    z_eps = rng.normal(size=(2, LAT, LAT, LC)).astype(np.float32)
    jbound.eps = jnp.asarray(z_eps)
    ref, _ = jmodel.loss_fn(variables, jax.random.PRNGKey(1),
                            jnp.asarray(x), jnp.asarray(sigma), train=False,
                            eps=jnp.asarray(eps))
    loss = model.loss_fn(_t(x), _t(sigma), train=False, eps=_t(eps),
                         z_eps=_t(z_eps))
    _check(loss, ref, rtol=5e-4, atol=1e-6)
    # gradients reach the diffusion network, not the frozen autoencoder
    loss.backward()
    assert all(p.grad is not None for p in model.net.parameters())
    assert all(p.grad is None for p in
               model.autoencoder.model.net.parameters())
    # the posterior draw is taken from the generator before ε
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    with torch.no_grad():
        drawn = model.loss_fn(_t(x), _t(sigma), train=False, generator=g1)
        z = torch.randn((2, LAT, LAT, LC), generator=g2)
        e = torch.randn((2, LAT, LAT, LC), generator=g2)
        replay = model.loss_fn(_t(x), _t(sigma), train=False, eps=e, z_eps=z)
    torch.testing.assert_close(drawn, replay)


def test_latent_sample_matches_jax():
    """``sample`` draws x_T in the latent shape and decodes the loop's
    result through the autoencoder; against the JAX package's
    ``propagate_white_noise`` from the same x_T (decoded, and in the
    latent space), 3 Heun steps."""
    jmodel, variables, model, _ = _latent_pair(sample_posterior=False)
    g = torch.Generator().manual_seed(9)
    x_T = torch.randn((2, LAT, LAT, LC), generator=g)
    for latent_out in (False, True):
        ref = jmodel.propagate_white_noise(
            variables, jax.random.PRNGKey(0), jnp.asarray(x_T.numpy()),
            nsteps=3, return_in_latent_space=latent_out)
        out = model.sample(2, (PIX, PIX, 1),
                           torch.Generator().manual_seed(9), nsteps=3,
                           return_in_latent_space=latent_out)
        assert out.shape == ((2, LAT, LAT, LC) if latent_out
                             else (2, PIX, PIX, 1))
        _check_sample(out, ref, label=f"latent {latent_out}")
        same = model.sample(2, (LAT, LAT, LC),
                            torch.Generator().manual_seed(9), nsteps=3,
                            is_latent_shape=True,
                            return_in_latent_space=latent_out)
        torch.testing.assert_close(same, out, rtol=0, atol=0)
        with torch.no_grad():
            prop = model.propagate_white_noise(
                x_T, nsteps=3, return_in_latent_space=latent_out)
        torch.testing.assert_close(prop, out, rtol=0, atol=0)
    hist = model.sample(2, (PIX, PIX, 1), torch.Generator().manual_seed(9),
                        nsteps=3, record_history=True)
    assert hist.shape == (4, 2, PIX, PIX, 1)
    _check(hist[-1], out_decoded := model.sample(
        2, (PIX, PIX, 1), torch.Generator().manual_seed(9), nsteps=3),
        rtol=1e-5, atol=1e-6)
    assert out_decoded.shape == (2, PIX, PIX, 1)
    for fn in (model.sample_restart, model.sample_parallel):
        with pytest.raises(NotImplementedError, match="latent"):
            fn(2, (PIX, PIX, 1))


def _ar_pair(cond_time=2):
    jbound, bound = _autoencoders()
    bound.sample_posterior = False
    fields = dict(_SMALL, input_channels=LC * (1 + cond_time),
                  output_channels=LC)
    jcfg = jens.EnsembleKarrasModelConfig.from_karras_config(
        JKarrasModelConfig.from_edm())
    jmodel = jens.EnsembleKarrasModel(
        JPUNetGCond(JPUNetGConfig(**fields), channel_conditional_items=["y"]),
        jcfg, conditional=True, autoencoder=jbound)
    variables = jmodel.init(
        jax.random.PRNGKey(0), (2, LAT, LAT, LC),
        {"y": jnp.zeros((2, LAT, LAT, LC * cond_time))})
    cfg = ens.EnsembleKarrasModelConfig.from_karras_config(
        KarrasModelConfig.from_edm())
    model = ens.EnsembleKarrasModel(
        PUNetGCond(PUNetGConfig(**fields), channel_conditional_items=["y"],
                   device="cpu"), cfg, conditional=True, autoencoder=bound,
        device="cpu")
    model.net.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables)), strict=True)
    return jmodel, variables, model


def test_autoregressive_sample_matches_jax(monkeypatch):
    """Three forecast steps of two samples from a window encoded once
    (``y_already_encoded``), the window sliding over sample 0's
    prediction, all forecasts decoded at the end: against the JAX
    package's ``autoregressive_sample`` whose model starts each step from
    the x_T the port draws."""
    jmodel, variables, model = _ar_pair()
    F, n = 3, 2
    rng = np.random.default_rng(1)
    window = rng.normal(size=(2 * LC, LAT, LAT)).astype(np.float32)
    g = torch.Generator().manual_seed(4)
    x_Ts = [torch.randn((n, LAT, LAT, LC), generator=g).numpy()
            for _ in range(F)]
    calls = []

    def replayed_sample(variables, key, nsamples, shape, y=None,
                        guidance=1.0, nsteps=100, is_latent_shape=False,
                        return_in_latent_space=False, **kw):
        x_T = jnp.asarray(x_Ts[len(calls)])
        calls.append(shape)
        return jmodel.propagate_white_noise(
            variables, key, x_T, y, guidance, nsteps,
            return_in_latent_space=True)

    monkeypatch.setattr(jmodel, "sample", replayed_sample)
    ref = jar.autoregressive_sample(
        jmodel, variables, jax.random.PRNGKey(0), n, (LAT, LAT, LC), F, 2,
        nsteps_diffusion=3, y={"y": jnp.asarray(np.moveaxis(window, 0, -1))},
        y_already_encoded=True, return_intermediate=True)
    out = ar.autoregressive_sample(
        model, n, (LAT, LAT, LC), F, 2, nsteps_diffusion=3,
        y={"y": _t(window)}, y_already_encoded=True,
        return_intermediate=True, generator=torch.Generator().manual_seed(4))
    assert len(calls) == F
    assert out["forecasts"].shape == (F, n, PIX, PIX, 1)
    _check_sample(out["intermediate_latent"], ref["intermediate_latent"],
                  label="latents")
    _check_sample(out["forecasts"], ref["forecasts"], label="decoded")
    _check(out["final_forecast"], out["forecasts"][-1], rtol=0, atol=0)
    latent = ar.autoregressive_sample(
        model, n, (LAT, LAT, LC), F, 2, nsteps_diffusion=3,
        y={"y": _t(window)}, y_already_encoded=True, return_in_latent=True,
        generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(latent["forecasts"],
                               out["intermediate_latent"])
    chunked = ar.autoregressive_sample(
        model, 3, (LAT, LAT, LC), 2, 2, nsteps_diffusion=2,
        y={"y": _t(window)}, y_already_encoded=True, maximum_batch_size=2,
        generator=torch.Generator().manual_seed(4))
    assert chunked["forecasts"].shape == (2, 3, PIX, PIX, 1)
    assert chunked["final_forecast"].shape == (3, PIX, PIX, 1)
    with pytest.raises(ValueError, match="y\\['y'\\]"):
        ar.autoregressive_sample(model, n, (LAT, LAT, LC), 1, 2)


def test_window_frames_round_trip_and_encoded_window():
    """Frames and window are one reshape apart, in the JAX package's
    channel order; a window in pixel space goes through an autoencoder
    whose ``encode`` returns (x, y) once, before the rollout."""
    frames = torch.randn(3, 2, 4, 4)
    window = ar.frames_to_window(frames)
    assert window.shape == (6, 4, 4)
    torch.testing.assert_close(ar.window_to_frames(window, 3), frames)
    jwin = jar.frames_to_window(jnp.asarray(frames.numpy().transpose(
        0, 2, 3, 1)))
    _check(window.numpy().transpose(1, 2, 0), jwin, rtol=0, atol=0)

    class HalvingAE:
        sample_posterior = False
        calls = 0

        def encode(self, x, y=None, eps=None):
            HalvingAE.calls += 1
            return x[:, :, ::2, ::2], {"y": y["y"][..., ::2, ::2]}

        def decode(self, z, y=None):
            return z.repeat_interleave(2, 2).repeat_interleave(2, 3)

    net = PUNetGCond(PUNetGConfig(**_SMALL, input_channels=3,
                                  output_channels=1),
                     channel_conditional_items=["y"], device="cpu")
    model = ens.EnsembleKarrasModel(
        net, ens.EnsembleKarrasModelConfig.from_edm(), conditional=True,
        autoencoder=HalvingAE(), autoencoder_conditional=True,
        encode_y=True, device="cpu")
    model.init(0)
    out = ar.autoregressive_sample(
        model, 2, (4, 4, 1), 2, 2, nsteps_diffusion=2,
        y={"y": torch.randn(2, 8, 8)},
        generator=torch.Generator().manual_seed(0))
    assert out["forecasts"].shape == (2, 2, 8, 8, 1)
    assert torch.isfinite(out["forecasts"]).all()


class _LinearEncoder(jnn.Module):
    ydim: int

    @jnn.compact
    def __call__(self, x, train: bool = False):
        return jnn.Dense(self.ydim)(x)


class _TorchLinearEncoder(nn.Module):
    def __init__(self, dim, ydim):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, ydim))

    def forward(self, x):
        return self.net(x)


@pytest.mark.parametrize("masked", [False, True])
def test_karras_encoder_loss_matches_reference(masked):
    """The condition from the trainable encoder, then the EDM loss with
    replayed noise: the reference's state dicts, rtol 5e-4, atol 1e-7
    (tests/test_reference_parity4.py)."""
    d = np.load(os.path.join(FIXDIR, "karras_encoder_loss.npz"))
    model = KarrasEncoderModel(MLPCond(3, 2, hidden_dims=(16, 16),
                                       device="cpu"),
                               _TorchLinearEncoder(3, 2),
                               KarrasModelConfig.from_edm(), masked=masked,
                               device="cpu")
    sd = {"model." + k[5:]: _t(d[k]) for k in d.files
          if k.startswith("csd__")}
    sd.update({"encoder_model.net.0." + k[9:]: _t(d[k]) for k in d.files
               if k.startswith("esd__")})
    model.net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        loss = model.loss_fn(_t(d["x"]), _t(d["sigma"]),
                             mask=_t(d["mask"]) if masked else None,
                             train=False, eps=_t(d["eps"]))
    _check(loss, d["loss_masked" if masked else "loss_plain"], rtol=5e-4,
           atol=1e-7)
    assert model.select_batch(_t(d["x"]) if not masked else
                              (_t(d["x"]), _t(d["mask"])))[1] is None


def test_karras_encoder_matches_jax_and_describes():
    """JAX weights through ``from_jax_variables`` (``encoder_model``
    beside ``model``): the same loss; the description nests the base
    one, key for key the JAX package's."""
    jmodel = JKarrasEncoderModel(JMLPCond(3, 2, hidden_dims=(16,)),
                                 _LinearEncoder(2),
                                 JKarrasModelConfig.from_edm())
    variables = jmodel.init(jax.random.PRNGKey(0), (4, 3))
    model = KarrasEncoderModel(MLPCond(3, 2, hidden_dims=(16,),
                                       device="cpu"),
                               _TorchLinearEncoder(3, 2),
                               KarrasModelConfig.from_edm(), device="cpu")
    model.net.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables)), strict=True)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 3)).astype(np.float32)
    sigma = np.array([0.2, 1.0, 3.0, 9.0], np.float32)
    eps = rng.normal(size=(4, 3)).astype(np.float32)
    ref, _ = jmodel.loss_fn(variables, jax.random.PRNGKey(1), jnp.asarray(x),
                            jnp.asarray(sigma), train=False,
                            eps=jnp.asarray(eps))
    with torch.no_grad():
        loss = model.loss_fn(_t(x), _t(sigma), train=False, eps=_t(eps))
    _check(loss, ref, rtol=5e-4, atol=1e-7)
    desc, jdesc = model.export_description(), jmodel.export_description()
    assert set(desc) == set(jdesc) == {"base_description",
                                       "encoder_description"}
    assert desc["base_description"] == jdesc["base_description"]


def test_latent_description_round_trip():
    """A latent model's description (``autoencoder: true``, key for key
    the JAX package's) rebuilds with the bound autoencoder passed in, in
    both packages; without it both refuse."""
    jmodel, variables, model, jbound = _latent_pair()
    desc, jdesc = model.export_description(), jmodel.export_description()
    assert desc == jdesc and desc["autoencoder"] is True
    rebuilt = karras_model_from_description(desc,
                                            autoencoder=model.autoencoder,
                                            device="cpu")
    jrebuilt = jfrom_description(jdesc, autoencoder=jbound)
    assert rebuilt.latent_model and jrebuilt.latent_model
    assert rebuilt.encode_y == jrebuilt.encode_y
    assert rebuilt.export_description() == jrebuilt.export_description()
    with pytest.raises(ValueError, match="latent"):
        karras_model_from_description(desc, device="cpu")
    with pytest.raises(ValueError, match="latent"):
        jfrom_description(jdesc)
