"""The port's KL autoencoder against the reference fixtures and the JAX
package: ``AutoencoderKL`` 2D and 3D (the reference's state dicts load
directly; JAX weights reach the port through ``from_jax_variables``),
every ``DiagonalGaussianDistribution`` method, ``VAEModel``'s encode and
decode, ``BoundAutoencoder``, ``ChannelAdapterWrapper`` and
``load_autoencoder``.

Inputs are made with numpy. The port's tensors are [B, C, *spatial], the
JAX package's channels-last. Each fixture pin uses the tolerance of the
JAX package's test on the same fixture (``tests/test_reference_parity.py``,
``..._parity7.py``, ``..._parity8.py``).
"""

import os

import numpy as np
import pytest
import torch

import _torch_warmup  # noqa: F401

import jax
import jax.numpy as jnp

from diffsci_tpu.models.nets import autoencoders as jautoencoders
from diffsci_tpu.models.nets import vae as jvae
from diffsci_tpu.models import vae as jvae_module

from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.models.nets import autoencoders, vae
from diffsci_tpu_torch.models import vae as vae_module

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")


def _check(ours, ref, rtol, atol, label=""):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    np.testing.assert_allclose(np.asarray(ours, np.float64),
                               np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol, err_msg=label)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nc(a):
    """channels-last -> [B, C, *spatial]."""
    return _t(np.moveaxis(np.asarray(a), -1, 1))


def _cl(a):
    """[B, C, *spatial] -> channels-last numpy."""
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    return np.moveaxis(a, 1, -1)


REF_CASES = {
    "2d": (dict(double_z=True, z_channels=3, resolution=32, in_channels=1,
                out_ch=1, ch=32, ch_mult=[1, 2], num_res_blocks=1,
                attn_resolutions=[], dropout=0.0, has_mid_attn=True), 3),
    "3d": (dict(double_z=True, z_channels=2, resolution=16, in_channels=1,
                out_ch=1, ch=32, ch_mult=[1, 2], num_res_blocks=1,
                attn_resolutions=[], dropout=0.0, has_mid_attn=True,
                dimension=3), 2),
}


@pytest.mark.parametrize("tag", sorted(REF_CASES))
def test_autoencoderkl_matches_reference(tag):
    """The reference's AutoencoderKL state dict loads as it is; moments,
    mode and decode within rtol 5e-4, atol 5e-5."""
    d = np.load(os.path.join(FIXDIR, f"autoencoderkl{tag}.npz"))
    kw, embed = REF_CASES[tag]
    ae = vae.AutoencoderKL(vae.DDConfig(**kw), embed, device="cpu")
    ae.load_state_dict({k[4:]: _t(d[k]) for k in d.files
                        if k.startswith("sd__")}, strict=True)
    with torch.no_grad():
        post = ae.encode(_t(d["x"]))
        dec = ae.decode(post.mode())
    tol = dict(rtol=5e-4, atol=5e-5)
    _check(post.parameters, d["moments"], **tol, label="moments")
    _check(post.mode(), d["z_mode"], **tol, label="mode")
    _check(dec, d["decoded"], **tol, label="decode")


LIVE_CASES = {
    "2d": dict(dimension=2),
    "2d_attn_res": dict(dimension=2, attn_resolutions=(8,)),
    "2d_linear_attn": dict(dimension=2, attn_resolutions=(16,),
                           attn_type="linear"),
    "2d_three_levels_no_mid_attn": dict(dimension=2, has_mid_attn=False,
                                  ch_mult=(1, 2, 2)),
    "3d": dict(dimension=3),
}


def _small_dd(mod, **kw):
    base = dict(double_z=True, z_channels=2, resolution=16, in_channels=1,
                out_ch=1, ch=8, ch_mult=(1, 2), num_res_blocks=1)
    base.update(kw)
    return mod.DDConfig(**base)


def _jax_ae(case, x_cl, in_channels=1, embed=2):
    kw = dict(LIVE_CASES[case], in_channels=in_channels,
              out_ch=in_channels)
    jcfg, tcfg = _small_dd(jvae, **kw), _small_dd(vae, **kw)
    jae = jvae.AutoencoderKL(jcfg, embed_dim=embed)
    variables = jae.init(jax.random.PRNGKey(0), jnp.asarray(x_cl),
                         key=jax.random.PRNGKey(1))
    tae = vae.AutoencoderKL(tcfg, embed, device="cpu")
    tae.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables), tcfg), strict=True)
    return jae, variables, tae


@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_autoencoderkl_matches_jax(case):
    """Same JAX-initialised weights: moments, a replayed posterior sample
    and the decode agree with the JAX package's AutoencoderKL (the
    fixture's bounds)."""
    dim = LIVE_CASES[case]["dimension"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2,) + (16,) * dim + (1,)).astype(np.float32)
    jae, variables, tae = _jax_ae(case, x)
    post = jae.apply(variables, jnp.asarray(x),
                     method=jvae.AutoencoderKL.encode)
    eps = rng.normal(size=np.asarray(post.mean).shape).astype(np.float32)
    z = post.sample(None, eps=jnp.asarray(eps))
    dec = jae.apply(variables, z, method=jvae.AutoencoderKL.decode)
    with torch.no_grad():
        tpost = tae.encode(_nc(x))
        tz = tpost.sample(eps=_nc(eps))
        tdec = tae.decode(tz)
    tol = dict(rtol=5e-4, atol=5e-5)
    _check(_cl(tpost.parameters), post.parameters, **tol, label="moments")
    _check(_cl(tz), z, **tol, label="posterior sample")
    _check(_cl(tdec), dec, **tol, label="decode")
    # the forward: decode of a sample, or of the mode
    with torch.no_grad():
        recon, _ = tae(_nc(x), eps=_nc(eps))
        recon_mode, _ = tae(_nc(x), sample_posterior=False)
    _check(recon, tdec, rtol=0, atol=0)
    _check(_cl(recon_mode), jae.apply(variables, post.mode(),
                                      method=jvae.AutoencoderKL.decode),
           **tol, label="forward, mode")


def test_distribution_methods_match_reference():
    """Every method against ``vae_distrib.npz`` (rtol 1e-5, atol 1e-6, as
    tests/test_reference_parity7.py)."""
    d = np.load(os.path.join(FIXDIR, "vae_distrib.npz"))
    d1 = vae.DiagonalGaussianDistribution(_t(d["m1"]))
    d2 = vae.DiagonalGaussianDistribution(_t(d["m2"]))
    tol = dict(rtol=1e-5, atol=1e-6)
    for rm, tag in [(False, "sum"), (True, "mean")]:
        _check(d1.kl(reduce_mean=rm), d[f"kl_prior_{tag}"], **tol,
               label=f"kl prior {tag}")
        _check(d1.kl(d2, reduce_mean=rm), d[f"kl_other_{tag}"], **tol,
               label=f"kl other {tag}")
        _check(d1.modified_hellinger(d2, reduce_mean=rm), d[f"hell_{tag}"],
               **tol, label=f"hellinger {tag}")
        _check(d1.wasserstein(d2, reduce_mean=rm), d[f"wass_{tag}"], **tol,
               label=f"wasserstein {tag}")
    _check(d1.nll(_t(d["samp"])), d["nll"], **tol, label="nll")
    _check(d1.kl_thresholded(threshold=0.5), d["klthr_prior"], **tol,
           label="kl thresholded prior")
    _check(d1.kl_thresholded(d2, threshold=0.8), d["klthr_other"], **tol,
           label="kl thresholded other")


def test_distribution_matches_jax():
    """The prior-relative methods, the deterministic posterior, the mode
    and a replayed sample against the JAX package's class on the same
    moments."""
    rng = np.random.default_rng(5)
    m = rng.normal(size=(2, 6, 4, 4)).astype(np.float32)
    eps = rng.normal(size=(2, 3, 4, 4)).astype(np.float32)
    t = vae.DiagonalGaussianDistribution(_t(m))
    j = jvae.DiagonalGaussianDistribution(jnp.asarray(_cl(m)))
    tol = dict(rtol=1e-5, atol=1e-6)
    for rm in (False, True):
        _check(t.modified_hellinger(reduce_mean=rm),
               j.modified_hellinger(reduce_mean=rm), **tol)
        _check(t.wasserstein(reduce_mean=rm), j.wasserstein(reduce_mean=rm),
               **tol)
    _check(_cl(t.mode()), j.mode(), rtol=0, atol=0)
    _check(_cl(t.sample(eps=_t(eps))), j.sample(None, jnp.asarray(_cl(eps))),
           **tol)
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    torch.testing.assert_close(
        t.sample(g1), t.mean + t.std * torch.randn(t.mean.shape,
                                                   generator=g2))
    det = vae.DiagonalGaussianDistribution(_t(m), deterministic=True)
    assert float(det.kl().abs().sum()) == 0.0
    assert float(det.nll(_t(m[:, :3])).abs().sum()) == 0.0
    _check(det.sample(eps=_t(eps)), det.mean, rtol=0, atol=0)


def _vae_pair(x_cl, scale=0.5, trainable_logvar=True, in_channels=1):
    """A JAX VAEModel and the port's over the same weights."""
    kw = dict(dimension=2, in_channels=in_channels, out_ch=in_channels)
    jcfg_ae = _small_dd(jvae, **kw)
    jmodel = jvae_module.VAEModel(
        jvae.AutoencoderKL(jcfg_ae, embed_dim=2),
        jvae_module.VAEModelConfig(trainable_logvar=trainable_logvar,
                                   logvar_init=0.25))
    variables = jmodel.init(jax.random.PRNGKey(2), x_cl.shape)
    tcfg_ae = _small_dd(vae, **kw)
    tmodel = vae_module.VAEModel(
        vae.AutoencoderKL(tcfg_ae, 2, device="cpu"),
        vae_module.VAEModelConfig(trainable_logvar=trainable_logvar,
                                  logvar_init=0.25), device="cpu")
    tmodel.net.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables), tcfg_ae), strict=True)
    return jmodel, variables, tmodel


def test_vae_model_and_bound_autoencoder_match_jax():
    """``VAEModel.encode`` (mode and a replayed sample) and ``decode``,
    the trainable log-variance, and ``BoundAutoencoder``'s scale factor,
    mode and decode against the JAX package."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    jmodel, variables, tmodel = _vae_pair(x)
    assert "logvar" in dict(tmodel.net.named_parameters())
    _check(tmodel.net.get_logvar(), [0.25], rtol=0, atol=0)
    enc = jmodel.encode(variables, jnp.asarray(x))
    eps = rng.normal(size=np.asarray(enc["zsample"]).shape).astype(
        np.float32)
    enc_s = jmodel.encode(variables, jnp.asarray(x), eps=jnp.asarray(eps))
    tol = dict(rtol=5e-4, atol=5e-5)
    with torch.no_grad():
        tenc = tmodel.encode(_nc(x))
        tenc_s = tmodel.encode(_nc(x), eps=_nc(eps))
        tdec = tmodel.decode(tenc["zsample"])
    _check(_cl(tenc["zsample"]), enc["zsample"], **tol, label="mode")
    _check(_cl(tenc_s["zsample"]), enc_s["zsample"], **tol, label="sample")
    _check(_cl(tdec), jmodel.decode(variables, enc["zsample"]), **tol,
           label="decode")

    jbound = jvae_module.BoundAutoencoder(jmodel, variables, 0.5)
    tbound = vae_module.BoundAutoencoder(tmodel, scale_factor=0.5)
    assert tbound.sample_posterior
    assert not any(p.requires_grad for p in tmodel.net.parameters())
    with torch.no_grad():
        tz = tbound.encode(_nc(x))
        tz_s = tbound.encode(_nc(x), eps=_nc(eps))
        tx = tbound.decode(tz)
    _check(_cl(tz), jbound.encode(jnp.asarray(x)), **tol, label="bound z")
    _check(tz_s, 0.5 * tenc_s["zsample"], rtol=1e-6, atol=1e-7)
    _check(_cl(tx), jbound.decode(jbound.encode(jnp.asarray(x))), **tol,
           label="bound decode")
    # the mode when the binding does not sample its posterior
    mode_only = vae_module.BoundAutoencoder(tmodel, scale_factor=0.5,
                                            sample_posterior=False)
    with torch.no_grad():
        _check(mode_only.encode(_nc(x), eps=_nc(eps)), tz, rtol=0, atol=0)


@pytest.mark.parametrize("channels,independent",
                         [(1, False), (2, False), (3, False), (1, True)])
def test_channel_adapter_matches_jax(channels, independent):
    """The channel adapter around a bound 3-channel VAE, against the JAX
    package's (channel axis 1 here, -1 there)."""
    rng = np.random.default_rng(11)
    data_channels = 2 if independent else channels
    x = rng.normal(size=(2, 16, 16, data_channels)).astype(np.float32)
    jmodel, variables, tmodel = _vae_pair(
        np.zeros((2, 16, 16, 3), np.float32), in_channels=3)
    jwrap = jautoencoders.ChannelAdapterWrapper(
        jvae_module.BoundAutoencoder(jmodel, variables), channels,
        independent, data_channels=data_channels, latent_channels=2)
    twrap = autoencoders.ChannelAdapterWrapper(
        vae_module.BoundAutoencoder(tmodel), channels, independent,
        data_channels=data_channels, latent_channels=2)
    assert twrap.sample_posterior
    z = jwrap.encode(jnp.asarray(x))
    tol = dict(rtol=5e-4, atol=5e-5)
    with torch.no_grad():
        tz = twrap.encode(_nc(x))
        tdec = twrap.decode(tz)
    _check(_cl(tz), z, **tol, label="encode")
    _check(_cl(tdec), jwrap.decode(z), **tol, label="decode")
    if not independent:
        with torch.no_grad():
            _check(twrap(_nc(x)), tdec, rtol=0, atol=0)


def test_load_autoencoder_and_training_refusals():
    ae = autoencoders.load_autoencoder(
        "our_kl", ddconfig=dict(ch=8, ch_mult=(1, 2), resolution=16),
        embed_dim=3, device="cpu")
    assert isinstance(ae, vae.AutoencoderKL) and ae.embed_dim == 3
    assert ae.export_description()["config"]["ch_mult"] == [1, 2]
    assert vae.DDConfig.from_description(
        ae.config.export_description()) == ae.config
    for name in ("kl1", "tiny1"):
        with pytest.raises(NotImplementedError, match="diffusers"):
            autoencoders.load_autoencoder(name)
    with pytest.raises(ValueError, match="Unknown autoencoder"):
        autoencoders.load_autoencoder("nope")
    model = vae_module.VAEModel(ae, vae_module.VAEModelConfig(),
                                device="cpu")
    # the training half is ported (tests/test_torch_vae_training.py): the
    # loss runs, and the refusals left are the configuration's own
    loss, logs = model.loss_fn(torch.zeros(1, 1, 16, 16),
                               generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and logs["x_recon"].shape == (1, 1, 16, 16)
    with pytest.raises(ValueError, match="not supported"):
        vae_module.VAEModel(ae, vae_module.VAEModelConfig(
            loss_preprocessor="blur"), device="cpu")
    with pytest.raises(ValueError, match="teaching_mode"):
        vae_module.VAEModelConfig(teaching_mode="nope")
    edges = vae_module.VAEModel(ae, vae_module.VAEModelConfig(
        loss_preprocessor="edges"), device="cpu")
    assert torch.isfinite(edges.loss_fn(
        torch.zeros(1, 1, 16, 16), eps=torch.zeros(1, 3, 8, 8))[0])
    # init draws every weight from the seed, the same on every call
    a = {k: v.clone() for k, v in model.init(4).items()}
    b = model.init(4)
    assert all(torch.equal(a[k], b[k]) for k in a)
