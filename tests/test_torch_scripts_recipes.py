"""Recipe parity of the port's scripts (``diffsci_tpu_torch/scripts/``)
with the JAX package's (``scripts/``): the model, EMA and optimizer a
port script builds (its ``build(args, device)``), carried the JAX model's
weights by ``convert.from_jax_variables``, take three train steps on one
batch with σ and ε (and the condition-drop mask, the ensemble's draws,
the VAE's z-noise) replayed, against JAX's step built from the JAX
script's own constants: loss rtol 1e-5 and grad_norm rtol 1e-4
(``tests/test_torch_training.py::test_train_step_trajectory_matches_jax``;
JAX's ensemble and VAE steps report no grad_norm), the parameters within
its AdamW bounds. Covered: mnist (EDM), cifar10
(VP), conditional (CFG drop), ensemble_forecast (CRPS) and train_vae.

The recipes run at cut sizes (8 channels, 16² fields, batch 2 or 4) with
the scripts' depths, constants and options. Under VP the JAX network's
Fourier time embedding is drawn at scale 0.03 in place of 30, which the
port then loads (``tests/test_torch_stochastic_model.py``'s VP pins give
the reason: a one-ulp change of VP's c_noise turns the phases at scale 30
by ~1e-2 rad).
"""

import contextlib

import numpy as np
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu_torch.convert import from_jax_variables
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)
from tests._torch_scripts_util import jax_script, parser_of, port


# ---------------------------------------------------------------------------
# three train steps of each recipe against JAX's
# ---------------------------------------------------------------------------
def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nc(a):
    return _t(np.moveaxis(a, -1, 1))


@contextlib.contextmanager
def _quick_init():
    """XLA's optimisations off while JAX draws a recipe's initial state:
    flax's eager init compiles each of its hundreds of operations alone,
    which takes ~2.5× less so (27 s → 10 s for mnist's on the CPU). The
    port loads whatever JAX draws, and the steps compile as always."""
    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", old)


def _args(name, flags_):
    return parser_of(port(name)).parse_args(
        [str(f) for f in flags_] + ["--device", "cpu"])


def _within_adamw(ours: dict, theirs: dict, lr: float, k: int, label):
    """99.9 % of entries within 0.01·lr, every entry within 2·k·lr after
    k AdamW steps (``tests/test_torch_training.py``'s bounds)."""
    diff = np.concatenate([(ours[n].detach() - theirs[n]).abs().flatten()
                           .numpy() for n in ours])
    assert np.quantile(diff, 0.999) <= 0.01 * lr, label
    assert diff.max() <= 2 * k * lr, label


def _karras_recipe(name, flags_, jnet, jconfig, jema, jtx, x_shape, lr,
                   y=None, jy=None, keep=False, conditional=False):
    """Three replayed steps of a KarrasModel recipe in both packages."""
    from diffsci_tpu.models import KarrasModel as JKarrasModel
    from diffsci_tpu.models import create_train_state as jcreate
    from diffsci_tpu.models import make_train_step as jmake
    from diffsci_tpu_torch.models import create_train_state, make_train_step
    import diffsci_tpu.models.nets.layers as jlayers

    jmodel = JKarrasModel(jnet, jconfig, conditional=conditional)
    with _quick_init():
        jstate, _ = jcreate(jmodel, jax.random.PRNGKey(0), x_shape, y=jy,
                            ema=jema, optimizer=jtx)
    replay_keep = {}

    def bernoulli(key, p, shape):
        # JAX's ConditionDrop draws its keep mask here: the replayed one
        return replay_keep["keep"].reshape(shape)

    def jloss(variables, key, x, yy, replay, train=True):
        if "keep" in replay:
            replay_keep["keep"] = replay["keep"]
        return jmodel.loss_fn(variables, key, x, replay["sigma"], y=jy,
                              train=train, eps=replay["eps"])

    jstep = jmake(jmodel, jtx, ema=jema, loss_fn=jloss)
    model, ema, tx = port(name).build(_args(name, flags_), "cpu")
    model.net.load_state_dict(from_jax_variables(_np(jstate.variables())),
                              strict=True)
    state, tx = create_train_state(model, x_shape, seed=None, optimizer=tx,
                                   ema=ema)
    step = make_train_step(model, tx, ema=ema)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(x_shape).astype(np.float32)
    real_bernoulli = jlayers.jax.random.bernoulli
    try:
        jlayers.jax.random.bernoulli = bernoulli
        for k in range(1, 4):
            sigma = np.exp(rng.standard_normal(x_shape[0]) * 1.2
                           - 1.2).astype(np.float32)
            eps = rng.standard_normal(x_shape).astype(np.float32)
            replay = {"sigma": jnp.asarray(sigma), "eps": jnp.asarray(eps)}
            kw = {}
            if keep:
                mask = np.arange(x_shape[0]) % 3 != k % 3
                replay["keep"] = jnp.asarray(mask)
                kw["keep"] = _t(mask)
            jstate, jmet = jstep(jstate, jax.random.PRNGKey(k),
                                 jnp.asarray(x), jy, replay)
            state, met = step(state, _t(x), y, sigma=_t(sigma), eps=_t(eps),
                              **kw)
            np.testing.assert_allclose(float(met["train_loss"]),
                                       float(jmet["train_loss"]), rtol=1e-5)
            np.testing.assert_allclose(float(met["grad_norm"]),
                                       float(jmet["grad_norm"]), rtol=1e-4)
            _within_adamw(state.params,
                          from_jax_variables(_np(jstate.variables())), lr, k,
                          f"{name} step {k}")
    finally:
        jlayers.jax.random.bernoulli = real_bernoulli


def _jax_optimizer(jmod):
    from diffsci_tpu.models import default_optimizer as jdefault
    return jdefault(jmod.LEARNING_RATE, jmod.WEIGHT_DECAY,
                    grad_clip=jmod.GRAD_CLIP)


def _jax_power_ema(stds, every=1):
    from diffsci_tpu.models import EMATracker as JEMATracker
    return JEMATracker(ema_type="power", power_function_stds=stds,
                       update_every=every)


def test_recipe_mnist_edm_matches_jax():
    from diffsci_tpu.models import KarrasModelConfig as JConfig
    from diffsci_tpu.models import PUNetG as JPUNetG
    from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig
    jmod = jax_script("train_diffusion_mnist")
    jnet = JPUNetG(JPUNetGConfig(model_channels=8,
                                 channel_expansion=jmod.CHANNEL_EXPANSION))
    _karras_recipe("train_diffusion_mnist", ["--channels", 8], jnet,
                   JConfig.from_edm(), _jax_power_ema(jmod.EMA_STDS, 4),
                   _jax_optimizer(jmod), (4, 16, 16, 1), jmod.LEARNING_RATE)


def test_recipe_cifar10_vp_matches_jax():
    from diffsci_tpu.models import KarrasModelConfig as JConfig
    from diffsci_tpu.models import PUNetG as JPUNetG
    from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig
    jmod = jax_script("train_diffusion_cifar10")
    jnet = JPUNetG(JPUNetGConfig(model_channels=8, channel_expansion=[2, 4],
                                 input_channels=3, output_channels=3,
                                 space_to_depth=1,
                                 time_projection_scale=0.03))
    _karras_recipe("train_diffusion_cifar10", ["--channels", 8], jnet,
                   JConfig.from_vp(), _jax_power_ema(jmod.EMA_STDS, 4),
                   _jax_optimizer(jmod), (4, 16, 16, 3), jmod.LEARNING_RATE)


def test_recipe_conditional_cfg_drop_matches_jax():
    """The condition-drop mask replayed into both: JAX's ConditionDrop
    draws it with ``jax.random.bernoulli``, which the test replaces by
    the replayed mask; the port's step takes it as ``keep=``."""
    import flax.linen as fnn
    from diffsci_tpu.models import KarrasModelConfig as JConfig
    from diffsci_tpu.models import PUNetG as JPUNetG
    from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig
    args = _args("train_diffusion_conditional", ["--channels", 8])
    jnet = JPUNetG(JPUNetGConfig(model_channels=8, channel_expansion=[2, 4],
                                 cond_drop=args.cond_drop),
                   conditional_embedding=fnn.Embed(4, 8))
    labels = np.array([0, 3, 1, 2], np.int32)
    _karras_recipe("train_diffusion_conditional", ["--channels", 8], jnet,
                   JConfig.from_edm(), _jax_power_ema([0.05]),
                   _default_jax_optimizer(), (4, 16, 16, 1), 1e-3,
                   y=_t(labels.astype(np.int64)), jy=jnp.asarray(labels),
                   keep=True, conditional=True)


def _default_jax_optimizer():
    from diffsci_tpu.models import default_optimizer as jdefault
    return jdefault()


def test_recipe_ensemble_forecast_crps_matches_jax():
    """CRPS over the recipe's E = 4 members, σ and the members' ε
    replayed into both (JAX's through its ``training_loss``)."""
    from diffsci_tpu.models import KarrasModelConfig as JConfig
    from diffsci_tpu.models import PUNetGCond as JPUNetGCond
    from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig
    from diffsci_tpu.models import create_train_state as jcreate
    from diffsci_tpu.models.karras import ensemble as jens
    from diffsci_tpu_torch.models import (create_train_state,
                                          make_ensemble_train_step)
    name = "train_ensemble_forecast"
    args = _args(name, ["--channels", 8])
    jmod = jax_script(name)
    B, S, E = 4, args.size, args.ensemble
    jnet = JPUNetGCond(JPUNetGConfig(
        model_channels=8, channel_expansion=[2], input_channels=2,
        output_channels=1, number_resnet_downward_block=1,
        number_resnet_upward_block=1, number_resnet_attn_block=1,
        number_resnet_before_attn_block=1, number_resnet_after_attn_block=1),
        channel_conditional_items=("state",))
    jmodel = jens.EnsembleKarrasModel(
        jnet, jens.EnsembleKarrasModelConfig.from_karras_config(
            JConfig.from_edm(loss_metric="crps"), ensemble_size_train=E),
        conditional=True)
    jema = _jax_power_ema([0.05])
    x_t, x_tp1 = jmod.make_advection_pairs(B, size=S)
    jy = {"state": jnp.asarray(x_t)}
    with _quick_init():
        jstate, jtx = jcreate(jmodel, jax.random.PRNGKey(0), (B, S, S, 1),
                              y=jy, ema=jema)
    rng = np.random.default_rng(5)
    sig = np.exp(rng.normal(size=(3, B)) * 1.2 - 1.2).astype(np.float32)
    eps = rng.normal(size=(3, B, E, S, S, 1)).astype(np.float32)

    def replayed(variables, key, batch, n_ensemble=1, train=True):
        i = key[1]
        bx, by = batch
        loss, upd = jmodel.loss_fn(variables, key, bx, jnp.asarray(sig)[i],
                                   by, None, train=train,
                                   n_ensemble=n_ensemble,
                                   eps=jnp.asarray(eps)[i])
        return loss, upd, {}

    jmodel.training_loss = replayed
    jstep = jens.make_ensemble_train_step(jmodel, jtx, ema=jema)
    model, ema, _ = port(name).build(args, "cpu")
    model.net.load_state_dict(from_jax_variables(_np(jstate.variables())),
                              strict=True)
    state, tx = create_train_state(model, (B, S, S, 1), seed=None, ema=ema)
    step = make_ensemble_train_step(model, tx, ema=ema)
    y = {"state": _nc(x_t)}
    for k in range(3):
        draws = model.draw_tensors(_t(x_tp1), E)
        draws["sigma"].copy_(_t(sig[k])[None])
        draws["eps"].copy_(_t(eps[k])[None])
        jstate, jmet = jstep(jstate, jax.random.PRNGKey(k),
                             (jnp.asarray(x_tp1), jy))
        state, met = step(state, _t(x_tp1), y, draws=draws)
        np.testing.assert_allclose(float(met["train_loss"]),
                                   float(jmet["train_loss"]), rtol=1e-5)
        # the JAX ensemble step reports no grad_norm
        assert "grad_norm" not in jmet
        _within_adamw(state.params,
                      from_jax_variables(_np(jstate.variables())), 1e-3,
                      k + 1, f"step {k}")


def test_recipe_train_vae_matches_jax():
    """The recipe's AutoencoderKL (32 channels, ch_mult [1, 2, 4], MSE,
    KL 1e-4, no discriminator) at 16², the z-noise JAX draws from the
    step's key replayed into the port."""
    from diffsci_tpu.models.nets import AutoencoderKL as JAutoencoderKL
    from diffsci_tpu.models.nets import DDConfig as JDDConfig
    from diffsci_tpu.models.vae import module as jvae
    from diffsci_tpu_torch.models.vae import (create_vae_train_state,
                                              make_vae_train_step)
    name = "train_vae"
    args = _args(name, ["--resolution", 16, "--batch", 2])
    dd = JDDConfig(z_channels=4, resolution=args.resolution, ch=32,
                   ch_mult=[1, 2, 4], num_res_blocks=2, has_mid_attn=False)
    jmodel = jvae.VAEModel(JAutoencoderKL(dd, embed_dim=4),
                           jvae.VAEModelConfig(kl_weight=args.kl_weight,
                                               reconstruction_loss="mse",
                                               adversarial_weight=0.0))
    x_shape = (args.batch, args.resolution, args.resolution, 1)
    with _quick_init():
        jstate, jtx, jdtx = jvae.create_vae_train_state(
            jmodel, jax.random.PRNGKey(0), x_shape)
    jstep = jvae.make_vae_train_step(jmodel, jtx, jdtx)
    _, model = port(name).build(args, "cpu")
    assert model.net.autoencoder.config.export_description() == \
        dd.export_description()
    model.net.load_state_dict(from_jax_variables(
        _np({"params": jstate.params, **jstate.consts})), strict=True)
    state, tx, dtx = create_vae_train_state(
        model, (args.batch, 1, args.resolution, args.resolution), seed=None)
    step = make_vae_train_step(model, tx, dtx)
    x = np.random.default_rng(1).standard_normal(x_shape).astype(np.float32)
    latent = (args.batch, args.resolution // 4, args.resolution // 4, 4)
    for k in range(3):
        key = jax.random.PRNGKey(10 + k)
        kg, _ = jax.random.split(key)
        ksamp, _ = jax.random.split(kg)
        eps = np.asarray(jax.random.normal(ksamp, latent, jnp.float32))
        jstate, jmet = jstep(jstate, key, jnp.asarray(x))
        state, met = step(state, _nc(x), eps=_nc(eps))
        np.testing.assert_allclose(float(met["train_loss"]),
                                   float(jmet["train_loss"]), rtol=1e-5)
        # the JAX VAE step reports no grad_norm
        assert "grad_norm" not in jmet
        _within_adamw(state.params, from_jax_variables(_np(
            {"params": jstate.params, **jstate.consts})), 1e-4, k + 1,
            f"step {k}")
