"""The port's VAE training against the reference fixtures and the JAX
package: ``total_variation``, ``VAENet`` (the reference's state dict
loaded strictly, and JAX weights through ``from_jax_variables`` in 1D,
2D and 3D, minimal-RF and time-conditioned), ``patched_conv``, every
``VAEModel`` loss case of ``vae_module_losses.npz`` and its adversarial
losses, the edge loss preprocessor, ``make_vae_train_step`` step for step
(a step whose discriminator gate is 0 included), a JAX train state
resumed in the port, the PatchGAN discriminator's SAME padding and
``KLAnnealing``.

Inputs are made with numpy. The port's tensors are [B, C, *spatial], the
JAX package's channels-last. Each fixture pin uses the tolerance of the
JAX package's test on the same fixture (``tests/test_reference_parity.py``,
``..._parity7.py``); live comparisons state theirs.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu.models.nets import vaenet as jvaenet
from diffsci_tpu.models.vae import module as jmodule
from diffsci_tpu.ops import preprocessors as jpre

from diffsci_tpu_torch.convert import from_jax_train_state, from_jax_variables
from diffsci_tpu_torch.models.nets import vaenet
from diffsci_tpu_torch.models.vae import module
from diffsci_tpu_torch.ops import losses, preprocessors
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")
# the fixtures' VAENet (tests/test_reference_parity.py, ..._parity7.py)
_FIX_CFG = dict(dimension=2, in_channels=1, out_channels=1, z_channels=3,
                z_dim=3, ch=8, ch_mult=[1, 2], num_res_blocks=1,
                attn_resolutions=[], resolution=16, has_mid_attn=True,
                num_groups=1)


def _check(ours, ref, rtol, atol, label=""):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    np.testing.assert_allclose(np.asarray(ours, np.float64),
                               np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol, err_msg=label)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cl(a):
    """[B, C, *spatial] -> channels-last."""
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    return np.moveaxis(a, 1, -1)


def _nc(a):
    """channels-last -> [B, C, *spatial] tensor."""
    return _t(np.moveaxis(np.asarray(a), -1, 1))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fixture_sd(d, prefix):
    return {k[len(prefix):]: _t(d[k]) for k in d.files
            if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# total variation, VAENet, patched_conv
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tag", ["2d", "3d"])
@pytest.mark.parametrize("metric", ["mse", "huber"])
def test_total_variation_matches_fixture(tag, metric):
    d = np.load(os.path.join(FIXDIR, "vae_tv_loss.npz"))
    tv_r = module.total_variation(_t(d[f"x_{tag}"]))
    tv_f = module.total_variation(_t(d[f"xrec_{tag}"]))
    raw = losses.huber(tv_f, tv_r) if metric == "huber" \
        else (tv_f - tv_r) ** 2
    _check(0.7 * raw.mean(), d[f"tv_{tag}_{metric}"], rtol=1e-5, atol=1e-6,
           label=f"tv {tag} {metric}")


def test_vaenet_loads_reference_state_dict():
    """The reference's state dict loads strictly (the port keeps its
    names) and the moments and decode agree (rtol 5e-4, atol 5e-5)."""
    d = np.load(os.path.join(FIXDIR, "vaenet_forward.npz"))
    cfg = vaenet.VAENetConfig(**_FIX_CFG)
    net = vaenet.VAENet(cfg, device="cpu")
    net.load_state_dict(_fixture_sd(d, "sd__"), strict=True)
    with torch.no_grad():
        moments = net.encode(_t(d["x"]))
        dec = net.decode(moments[:, :cfg.z_dim])
    _check(moments, d["moments"], rtol=5e-4, atol=5e-5, label="moments")
    _check(dec, d["decoded"], rtol=5e-4, atol=5e-5, label="decode")
    assert vaenet.VAENetConfig.from_description(
        cfg.export_description()) == cfg
    assert net.export_description() == {"config": cfg.export_description()}


VAENET_CASES = {
    "1d_no_conv_resample": dict(dimension=1, resamp_with_conv=False,
                                input_bias=False, output_bias=False,
                                has_mid_attn=False),
    "2d_minimal_linear_time": dict(dimension=2, minimal_rf_mode=True,
                                   attn_resolutions=(8,), attn_type="linear",
                                   with_time_emb=True),
    "3d_attn_time": dict(dimension=3, attn_resolutions=(8,),
                         with_time_emb=True, tanh_out=True),
}


@pytest.mark.parametrize("case", sorted(VAENET_CASES))
def test_vaenet_matches_jax(case):
    """JAX weights through ``from_jax_variables`` (strict): moments and
    decode agree with the JAX package's VAENet (rtol 5e-4, atol 5e-5, the
    fixture's bounds), and the receptive radius is the JAX package's."""
    fields = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, resolution=16,
                  num_groups=4, **VAENET_CASES[case])
    dim = fields["dimension"]
    jnet = jvaenet.VAENet(jvaenet.VAENetConfig(**fields))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2,) + (16,) * dim + (1,)).astype(np.float32)
    t = np.array([0.3, 0.7], np.float32)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(t))
    cfg = vaenet.VAENetConfig(**fields)
    net = vaenet.VAENet(cfg, device="cpu")
    net.load_state_dict(from_jax_variables(_np(variables), cfg), strict=True)
    jm, jd = jnet.apply(variables, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        m, dec = net(_nc(x), _t(t))
    _check(_cl(m), jm, rtol=5e-4, atol=5e-5, label="moments")
    _check(_cl(dec), jd, rtol=5e-4, atol=5e-5, label="decode")
    assert net.receptive_radius() == jnet.receptive_radius()


def test_patched_conv_matches_direct():
    """A convolution taken window by window equals the direct one (the JAX
    package's bounds: rtol 1e-4, atol 1e-5)."""
    assert vaenet.divide_dims(10, 4) == [(0, 4), (4, 8), (8, 10)]
    assert vaenet.divide_dims(10, 4, lb=2) == [(2, 6), (6, 10)]
    g = torch.Generator().manual_seed(0)
    for dim, shape in ((2, (1, 2, 16, 16)), (3, (1, 2, 9, 7, 11))):
        conv = (torch.nn.Conv2d, torch.nn.Conv3d)[dim - 2](2, 3, 3)
        x = torch.randn(shape, generator=g)
        with torch.no_grad():
            direct = torch.nn.functional.conv2d(x, conv.weight, conv.bias,
                                                padding=1) if dim == 2 else \
                torch.nn.functional.conv3d(x, conv.weight, conv.bias,
                                           padding=1)
            patched = vaenet.patched_conv(x, conv, patch_size=5, padding=1)
        _check(patched, direct.numpy(), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the losses of the reference fixture
# ---------------------------------------------------------------------------
VAE_CASES = {
    "plain": dict(reduce_mean=True, kl_weight=1e-3,
                  reconstruction_loss="mse"),
    "sum_huber": dict(reduce_mean=False, kl_weight=0.5,
                      reconstruction_loss="huber"),
    "tv": dict(reduce_mean=True, reconstruction_loss="mse",
               total_variation_weight=1.0),
    "distill_enc_kl": dict(reduce_mean=True, reconstruction_loss="mse",
                           teaching_mode="encoder",
                           latent_matching_type="kl",
                           distillation_alpha=0.4),
    "distill_dec": dict(reduce_mean=True, reconstruction_loss="mse",
                        teaching_mode="decoder", distillation_alpha=0.4),
    "distill_both_wass": dict(reduce_mean=False,
                              reconstruction_loss="huber",
                              teaching_mode="both",
                              latent_matching_type="wasserstein",
                              distillation_alpha=0.4),
    "distill_only": dict(reduce_mean=True, reconstruction_loss="mse",
                         teaching_mode="both",
                         latent_matching_type="modhell",
                         distillation_alpha=1.0),
}


@pytest.fixture(scope="module")
def vae_fixture():
    d = np.load(os.path.join(FIXDIR, "vae_module_losses.npz"))
    cfg = vaenet.VAENetConfig(**_FIX_CFG)
    teacher = vaenet.VAENet(cfg, device="cpu")
    teacher.load_state_dict(_fixture_sd(d, "tsd__"), strict=True)
    teacher.eval().requires_grad_(False)
    return d, cfg, teacher


def _fixture_model(d, cfg, **kw):
    model = module.VAEModel(vaenet.VAENet(cfg, device="cpu"),
                            module.VAEModelConfig(**kw), device="cpu")
    model.net.autoencoder.load_state_dict(_fixture_sd(d, "ssd__"),
                                          strict=True)
    return model


@pytest.mark.parametrize("case", sorted(VAE_CASES))
def test_vae_loss_matches_fixture(vae_fixture, case):
    """Every loss case of the reference's VAELoss with its weights and the
    replayed z-noise (rtol 5e-4, atol 1e-5)."""
    d, cfg, teacher = vae_fixture
    kw = dict(VAE_CASES[case])
    if case.startswith("distill"):
        kw["teacher"] = teacher
    model = _fixture_model(d, cfg, **kw)
    with torch.no_grad():
        loss, logs = model.loss_fn(_t(d["x"]), train=False,
                                   eps=_t(d["eps_z"]))
    _check(loss, d[f"loss_{case}"], rtol=5e-4, atol=1e-5,
           label=f"vae loss {case}")
    assert ("x_recon" in logs) == (case != "distill_only")


def test_vae_adversarial_losses_match_fixture(vae_fixture):
    """The generator's adversarial term and total, and the label-smoothed
    discriminator loss and accuracy, through the functions the train step
    calls, against the reference's (a 3×3 conv as the discriminator)."""
    d, cfg, _ = vae_fixture
    disc = torch.nn.Conv2d(1, 1, 3, padding=1)
    disc.load_state_dict({"weight": _t(d["dsd__weight"]),
                          "bias": _t(d["dsd__bias"])})

    class Disc(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = disc

        def forward(self, x, y=None):
            return self.conv(x)

    model = _fixture_model(d, cfg, reduce_mean=True,
                           reconstruction_loss="mse",
                           adversarial_weight=0.05, label_smoothing=0.1)
    x = _t(d["x"])
    with torch.no_grad():
        vae_loss, logs = model.loss_fn(x, train=False, eps=_t(d["eps_z"]))
        gen_adv = module.generator_adversarial_loss(Disc(), logs["x_recon"])
        d_loss, d_acc = module.discriminator_loss(Disc(), x, logs["x_recon"],
                                                  label_smoothing=0.1)
    _check(gen_adv, d["gen_adv"], rtol=5e-4, atol=1e-6, label="gen adv")
    _check(vae_loss + 0.05 * gen_adv, d["gen_loss"], rtol=5e-4, atol=1e-5,
           label="gen total")
    _check(d_loss, d["disc_loss"], rtol=5e-4, atol=1e-6, label="disc loss")
    _check(d_acc, d["d_accuracy"], rtol=1e-5, atol=1e-6,
           label="disc accuracy")


# ---------------------------------------------------------------------------
# the edge loss preprocessor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("processors", ["all", "original", "sobel",
                                        "laplacian", "gradient", "morph"])
def test_edge_preprocessor_matches_jax(dim, processors):
    """Each processor and all of them, with a border window, against the
    JAX package's (rtol 1e-5, atol 1e-5) on a 2-channel input of odd and
    even sizes; even morphological windows pad as SAME does."""
    rng = np.random.default_rng(dim)
    size = {1: (33,), 2: (20, 17), 3: (12, 9, 10)}[dim]
    x = rng.standard_normal((2,) + size + (2,)).astype(np.float32)
    for kw in (dict(border_width=4), dict(border_width=0,
                                          morph_kernel_size=2,
                                          feature_weights={"sobel": 3.0})):
        ours = preprocessors.EdgeDetectionPreprocessor(dim, processors, **kw)
        theirs = jpre.EdgeDetectionPreprocessor(dim, processors, **kw)
        out = ours(_nc(x))
        ref = theirs(jnp.asarray(x))
        _check(_cl(out), ref, rtol=1e-5, atol=1e-5,
               label=f"{dim}D {processors} {kw}")
    with pytest.raises(ValueError, match="Unknown processor"):
        preprocessors.EdgeDetectionPreprocessor(dim, ["nope"])
    np.testing.assert_array_equal(preprocessors.smoothstep_window(12, 3),
                                  jpre.smoothstep_window(12, 3))


def test_loss_preprocessor_resolution_and_edges_loss_matches_jax():
    """``make_loss_preprocessor`` ('none', 'edges', a callable), and a 3D
    VAENet's loss under ``loss_preprocessor='edges'`` with total variation
    against the JAX package's on the same weights and z-noise (rtol 5e-4,
    atol 1e-5)."""
    ident = preprocessors.make_loss_preprocessor("none")
    x = torch.ones(2, 1, 4)
    assert ident(x) is x
    assert isinstance(preprocessors.make_loss_preprocessor("edges", 3),
                      preprocessors.EdgeDetectionPreprocessor)
    fn = preprocessors.make_loss_preprocessor(torch.tanh)
    assert fn is torch.tanh
    with pytest.raises(ValueError, match="not supported"):
        preprocessors.make_loss_preprocessor("blur")

    fields = dict(dimension=3, ch=8, ch_mult=(1, 2), num_res_blocks=1,
                  resolution=16, num_groups=4)
    kw = dict(loss_preprocessor="edges", loss_preprocessor_dim=3,
              total_variation_weight=0.1)
    jmodel = jmodule.VAEModel(jvaenet.VAENet(jvaenet.VAENetConfig(**fields)),
                              jmodule.VAEModelConfig(**kw))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), x.shape)
    eps = rng.standard_normal((2, 8, 8, 8, 4)).astype(np.float32)
    ref, _ = jmodel.loss_fn(variables, jax.random.PRNGKey(1),
                            jnp.asarray(x), train=False,
                            eps=jnp.asarray(eps))
    cfg = vaenet.VAENetConfig(**fields)
    model = module.VAEModel(vaenet.VAENet(cfg, device="cpu"),
                            module.VAEModelConfig(**kw), device="cpu")
    model.net.load_state_dict(from_jax_variables(_np(variables), cfg),
                              strict=True)
    with torch.no_grad():
        loss, logs = model.loss_fn(_nc(x), train=False, eps=_nc(eps))
    _check(loss, ref, rtol=5e-4, atol=1e-5, label="edges loss")
    assert "tv_loss" in logs


# ---------------------------------------------------------------------------
# the discriminator and the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dim,size", [(2, (15, 13)), (1, (17,)),
                                      (3, (8, 9, 7))])
def test_discriminator_matches_jax(dim, size):
    """flax's SAME padding of the 4-wide kernels (stride 2, then 1) on odd
    and even sizes, the GroupNorm eps and the condition's broadcast: the
    logits agree with the JAX package's NLayerDiscriminator (rtol 1e-4,
    atol 1e-5)."""
    jdisc = jmodule.NLayerDiscriminator(ndf=8, n_layers=2)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2,) + size + (1,)).astype(np.float32)
    y = rng.standard_normal((2, 3)).astype(np.float32)
    yb = y.reshape((2,) + (1,) * dim + (3,))
    variables = jdisc.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.asarray(yb))
    ref = jdisc.apply(variables, jnp.asarray(x), jnp.asarray(yb))
    disc = module.NLayerDiscriminator(ndf=8, n_layers=2, in_channels=4,
                                      dimension=dim, device="cpu")
    disc.load_state_dict(from_jax_variables(_np(variables)), strict=True)
    with torch.no_grad():
        out = disc(_nc(x), _t(y))
    assert out.shape[2:] == tuple(-(-n // 4) for n in size)
    _check(_cl(out), ref, rtol=1e-4, atol=1e-5)


def _jax_and_port_vae(**cfg_kw):
    """A JAX VAEModel (VAENet and NLayerDiscriminator) with its train state,
    and the port's over the same weights."""
    fields = dict(dimension=2, ch=8, ch_mult=(1, 2), num_res_blocks=1,
                  resolution=16, num_groups=4)
    kw = dict(adversarial_weight=0.05, discriminator_frequency=2,
              **cfg_kw)
    jmodel = jmodule.VAEModel(jvaenet.VAENet(jvaenet.VAENetConfig(**fields)),
                              jmodule.VAEModelConfig(**kw),
                              discriminator=jmodule.NLayerDiscriminator(
                                  ndf=8, n_layers=2))
    x_shape = (2, 16, 16, 1)
    jstate, jtx, jdtx = jmodule.create_vae_train_state(
        jmodel, jax.random.PRNGKey(0), x_shape)
    cfg = vaenet.VAENetConfig(**fields)
    model = module.VAEModel(
        vaenet.VAENet(cfg, device="cpu"), module.VAEModelConfig(**kw),
        discriminator=module.NLayerDiscriminator(ndf=8, n_layers=2,
                                                 device="cpu"),
        device="cpu")
    return jmodel, jstate, jmodule.make_vae_train_step(jmodel, jtx, jdtx), \
        model, cfg


def _jax_eps(key, shape):
    """The z-noise the JAX step draws from ``key``."""
    kg, _ = jax.random.split(key)
    ksamp, _ = jax.random.split(kg)
    return np.asarray(jax.random.normal(ksamp, shape, jnp.float32))


def _within_adamw(ours: dict, theirs: dict, lr: float, k: int, label):
    """The train step's bounds on parameters after k AdamW steps: 99.9 %
    of entries within 0.01·lr, every entry within 2·k·lr."""
    diff = np.concatenate([(ours[n].detach() - theirs[n]).abs().flatten()
                           .numpy() for n in ours])
    assert np.quantile(diff, 0.999) <= 0.01 * lr, label
    assert diff.max() <= 2 * k * lr, label


def _moments(opt, params: dict) -> dict:
    return {key: {n: opt.state[p][key] for n, p in params.items()}
            for key in ("exp_avg", "exp_avg_sq")}


def _jax_moments(opt_state, convert) -> dict:
    adam = next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(s, "mu"))
    return {"exp_avg": convert(adam.mu), "exp_avg_sq": convert(adam.nu),
            "count": int(adam.count)}


def test_vae_train_step_matches_jax():
    """Three steps of ``make_vae_train_step`` against the JAX package's,
    the z-noise replayed, ``discriminator_frequency=2`` (the second step's
    gate is 0): the loss and every log within rtol 1e-4, the accuracy and
    the gate equal; the autoencoder's and the discriminator's parameters
    within the train step's bounds (lr 1e-4) and their Adam moments within
    1e-4 (first) and 2e-4 (second) of their largest entry. On the gated
    step the discriminator's weights stay bit for bit while its moments
    and count advance, in both packages."""
    jmodel, jstate, jstep, model, cfg = _jax_and_port_vae()
    model.net.load_state_dict(from_jax_variables(
        _np({"params": jstate.params, **jstate.consts}), cfg), strict=True)
    model.discriminator.load_state_dict(from_jax_variables(
        _np({"params": jstate.disc_params})), strict=True)
    state, tx, dtx = module.create_vae_train_state(model, (2, 1, 16, 16),
                                                   seed=None)
    step = module.make_vae_train_step(model, tx, dtx)
    x = np.random.default_rng(1).standard_normal((2, 16, 16, 1)).astype(
        np.float32)
    lr = 1e-4

    def disc_sd():
        return {k: v.clone() for k, v in
                model.discriminator.state_dict().items()}

    for k in range(3):
        key = jax.random.PRNGKey(10 + k)
        eps = _jax_eps(key, (2, 8, 8, 4))
        jdisc_before = _np(jstate.disc_params)
        before = disc_sd()
        jstate, jmet = jstep(jstate, key, jnp.asarray(x))
        state, met = step(state, _nc(x), eps=_nc(eps))
        assert state.step == k + 1 and int(state.counter) == k + 1
        for name, v in jmet.items():
            if name in ("d_accuracy", "disc_updated"):
                assert float(met[name]) == float(v), name
            else:
                _check(met[name], v, rtol=1e-4, atol=1e-7, label=name)
        _within_adamw(state.params, from_jax_variables(_np(
            {"params": jstate.params, **jstate.consts}), cfg), lr, k + 1,
            f"params {k}")
        _within_adamw(state.disc_params, from_jax_variables(_np(
            {"params": jstate.disc_params})), lr, k + 1, f"disc {k}")
        for opt, params, jopt, conv in (
                (state.optimizer, state.params, jstate.opt_state,
                 lambda t: from_jax_variables({"params": _np(t)}, cfg)),
                (state.disc_optimizer, state.disc_params,
                 jstate.disc_opt_state,
                 lambda t: from_jax_variables({"params": _np(t)}))):
            ours, theirs = _moments(opt, params), _jax_moments(jopt, conv)
            assert theirs["count"] == k + 1
            for key_m, bound in (("exp_avg", 1e-4), ("exp_avg_sq", 2e-4)):
                scale = max(float(v.abs().max())
                            for v in theirs[key_m].values())
                for n, v in ours[key_m].items():
                    _check(v, theirs[key_m][n], rtol=0, atol=bound * scale,
                           label=f"{key_m} {n} step {k}")
            assert all(float(opt.state[p]["step"]) == k + 1
                       for p in params.values())
        if k == 1:
            assert float(met["disc_updated"]) == 0.0
            after = disc_sd()
            for n in after:
                torch.testing.assert_close(after[n], before[n], rtol=0,
                                           atol=0)
            for a, b in zip(jax.tree.leaves(jdisc_before),
                            jax.tree.leaves(_np(jstate.disc_params))):
                np.testing.assert_array_equal(a, b)
    assert float(met["disc_updated"]) == 1.0


def test_jax_vae_state_resumes_in_port():
    """A JAX ``VAETrainState`` after one step, carried over by
    ``from_jax_train_state`` (both optimizers and the step), takes the
    same next step in the port as in the JAX package: the gated second
    step, then the third (bounds as above)."""
    jmodel, jstate, jstep, model, cfg = _jax_and_port_vae()
    x = np.random.default_rng(2).standard_normal((2, 16, 16, 1)).astype(
        np.float32)
    jstate, _ = jstep(jstate, jax.random.PRNGKey(1), jnp.asarray(x))
    tx, dtx = module.default_vae_optimizer(), module.default_vae_optimizer()
    state = from_jax_train_state(_np(jstate), model, tx, dtx=dtx)
    assert state.step == 1 and int(state.counter) == 1
    step = module.make_vae_train_step(model, tx, dtx)
    for k in (2, 3):
        key = jax.random.PRNGKey(k)
        jstate, jmet = jstep(jstate, key, jnp.asarray(x))
        state, met = step(state, _nc(x), eps=_nc(_jax_eps(key,
                                                          (2, 8, 8, 4))))
        _check(met["train_loss"], jmet["train_loss"], rtol=1e-4, atol=1e-7)
        assert float(met["disc_updated"]) == float(jmet["disc_updated"])
        _within_adamw(state.params, from_jax_variables(_np(
            {"params": jstate.params, **jstate.consts}), cfg), 1e-4, k,
            f"params {k}")
        _within_adamw(state.disc_params, from_jax_variables(_np(
            {"params": jstate.disc_params})), 1e-4, k, f"disc {k}")


def test_train_step_draws_and_kl_annealing():
    """Without ``eps`` the step draws the z-noise from its generator (one
    seed, one step); ``KLAnnealing`` sets the weight linearly and the next
    step's loss follows it: the main loss moves by Δkl_weight·kl_loss."""
    cfg = vaenet.VAENetConfig(dimension=2, ch=8, ch_mult=(1, 2),
                              num_res_blocks=1, resolution=16, num_groups=4)
    conf = module.VAEModelConfig(adversarial_weight=0.0)
    ann = module.KLAnnealing(conf, start=0.0, end=1.0, num_epochs=4)
    assert [ann.on_epoch(e) for e in (0, 2, 4, 9)] == [0.0, 0.5, 1.0, 1.0]
    model = module.VAEModel(vaenet.VAENet(cfg, device="cpu"), conf,
                            device="cpu")
    assert not model.is_adversarial
    x = torch.randn(2, 1, 16, 16, generator=torch.Generator().manual_seed(0))
    results = []
    for weight in (0.0, 0.5, 0.5):
        conf.kl_weight = weight
        state, tx, dtx = module.create_vae_train_state(model, seed=3)
        assert dtx is None and state.disc_params is None
        step = module.make_vae_train_step(model, tx)
        _, met = step(state, x, generator=torch.Generator().manual_seed(5))
        results.append(met)
    torch.testing.assert_close(results[1]["train_loss"],
                               results[2]["train_loss"], rtol=0, atol=0)
    torch.testing.assert_close(
        results[1]["train_loss"] - results[0]["train_loss"],
        0.5 * results[0]["kl_loss"], rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="x_shape"):
        module.create_vae_train_state(model, (2, 3, 16, 16))
