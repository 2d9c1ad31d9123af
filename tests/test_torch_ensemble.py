"""The port's ensemble runtime against the reference fixtures and the JAX
package: the CRPS ensemble loss and the ensemble Huber reduction
(``ensemble_loss.npz``), the autoregressive loss with a stub sampler
(``autoregressive_loss.npz``), the window slide, split and weights, the
replay schedule and L2-SP, the in-step sampler against the JAX package's
``propagate_white_noise`` on one x_T, and three
``make_ensemble_train_step`` steps against the JAX package's on replayed
draws.

Inputs are made with numpy; the reference's state dicts load directly,
JAX weights reach the port through ``from_jax_variables``. x, its targets
and masks are channels-last in both packages; the condition window y['y']
is [B, C, *spatial] for the port's network, channels-last for the JAX
package's. Each fixture pin uses the JAX package's test's tolerance
(``tests/test_reference_parity3.py``, ``..._parity8.py``).
"""

import os

import numpy as np
import pytest
import torch

import _torch_warmup  # noqa: F401

import jax
import jax.numpy as jnp

from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import create_train_state as jcreate_train_state
from diffsci_tpu.models.karras import ensemble as jens
from diffsci_tpu.models.nets.punetg import PUNetGCond as JPUNetGCond
from diffsci_tpu.models.nets.punetg import PUNetGConfig as JPUNetGConfig

from diffsci_tpu_torch import (KarrasModelConfig, PUNetG, PUNetGCond,
                               PUNetGConfig, create_train_state,
                               default_optimizer)
from diffsci_tpu_torch.convert import (from_jax_train_state,
                                       from_jax_variables)
from diffsci_tpu_torch.models.karras import ensemble as ens
from diffsci_tpu_torch.models.nets import MLPUncond
from diffsci_tpu_torch.ops import losses

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")
_SMALL = dict(model_channels=8, channel_expansion=(2,),
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1)


def _check(ours, ref, rtol, atol, label=""):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    np.testing.assert_allclose(np.asarray(ours, np.float64),
                               np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol, err_msg=label)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cl(a):
    """[B, C, *spatial] -> channels-last."""
    return np.moveaxis(np.asarray(a), 1, -1)


# ---------------------------------------------------------------------------
# the reference fixtures
# ---------------------------------------------------------------------------
ENSEMBLE_CASES = {
    "crps_e3": ("crps", 3, False),
    "crps_e3_masked": ("crps", 3, True),
    "huber_e3": ("huber", 3, False),
    "huber_e1": ("huber", 1, False),
}


@pytest.mark.parametrize("case", sorted(ENSEMBLE_CASES))
def test_ensemble_loss_matches_reference(case):
    """``EnsembleKarrasModel.loss_fn`` with the reference's PUNetG weights,
    batch, σ and replayed ensemble noise (rtol 5e-4, atol 1e-6)."""
    d = np.load(os.path.join(FIXDIR, "ensemble_loss.npz"))
    metric, ne, masked = ENSEMBLE_CASES[case]
    eps = np.moveaxis(d["eps_ens"], 2, -1)      # [B, E, H, W, C]
    model = ens.EnsembleKarrasModel(
        PUNetG(PUNetGConfig(**_SMALL), device="cpu"),
        KarrasModelConfig.from_edm(loss_metric=metric), masked=masked,
        device="cpu")
    model.net.load_state_dict({"model." + k[4:]: _t(d[k]) for k in d.files
                               if k.startswith("sd__")}, strict=True)
    with torch.no_grad():
        loss = model.loss_fn(_t(_cl(d["x"])), _t(d["sigma"]),
                             mask=_t(_cl(d["mask"])) if masked else None,
                             train=False, n_ensemble=ne,
                             eps=_t(eps if ne > 1 else eps[:, 0]))
    _check(loss, d[f"loss_{case}"], rtol=5e-4, atol=1e-6, label=case)


def _ar_net(device="cpu"):
    return PUNetGCond(PUNetGConfig(**_SMALL, input_channels=3,
                                   output_channels=1),
                      channel_conditional_items=["y"], device=device)


def test_autoregressive_loss_matches_reference():
    """Three horizons, weights (0.5, 0.3, 0.2), masks split per horizon,
    replayed σ and ε, the in-step sampler stubbed with the fixture's
    deterministic function (rtol 5e-4, atol 1e-5)."""
    d = np.load(os.path.join(FIXDIR, "autoregressive_loss.npz"))
    cfg = ens.EnsembleKarrasModelConfig.from_edm()
    cfg.autoregressive_loss_steps = 3
    cfg.autoregressive_loss_weights = [0.5, 0.3, 0.2]
    model = ens.EnsembleKarrasModel(_ar_net(), cfg, conditional=True,
                                    masked=True, device="cpu")
    model.net.load_state_dict({"model.unet." + k[4:]: _t(d[k])
                               for k in d.files if k.startswith("sd__")},
                              strict=True)

    def sampler_fn(target, y):
        return (torch.tanh(y["y"].mean(dim=1, keepdim=True)) + 0.1
                ).movedim(1, -1)

    with torch.no_grad():
        total, _, step_losses = model.autoregressive_loss_fn(
            _t(_cl(d["x"])), y={"y": _t(d["ywin"])},
            mask=_t(_cl(d["mask"])), train=False,
            sigma_seq=_t(d["sigma_seq"]),
            eps_seq=[_t(_cl(e)) for e in d["eps_seq"]],
            sampler_fn=sampler_fn)
    _check(torch.stack(step_losses), d["step_losses"], rtol=5e-4,
           atol=1e-5, label="step losses")
    _check(total, d["total"], rtol=5e-4, atol=1e-5, label="total")


# ---------------------------------------------------------------------------
# window slide, split, weights, the non-AR path (tests/test_ensemble.py)
# ---------------------------------------------------------------------------
def _cond_model(steps, **kw):
    cfg = ens.EnsembleKarrasModelConfig.from_karras_config(
        KarrasModelConfig.from_edm(loss_metric="mse"),
        autoregressive_loss_steps=steps, **kw)
    net = PUNetGCond(PUNetGConfig(**_SMALL, input_channels=3,
                                  output_channels=1),
                     channel_conditional_items=["y"], device="cpu")
    model = ens.EnsembleKarrasModel(net, cfg, conditional=True, device="cpu")
    # drawn weights: the attention projection and the Fourier buffer are
    # uninitialized memory until init, which could hold NaN
    model.init(seed=0)
    return model


def test_window_slides_split_and_weights(monkeypatch):
    """Each prediction slides into the last channel of y['y'] (the caller's
    y untouched), the in-step sampler runs before every horizon but the
    last, both target layouts split, the weights normalise."""
    model = _cond_model(3)
    record = []

    def fake(target, y, x_T, noise=None, variables=None):
        record.append(y["y"].clone())
        return torch.full(target.shape, 99.0)

    monkeypatch.setattr(model, "_sample_next_autoregressive_condition",
                        fake)
    x = torch.zeros((2, 8, 8, 3))
    y = {"y": torch.zeros((2, 2, 8, 8))}
    total, _, step_losses = model.autoregressive_loss_fn(
        x, y, train=False, generator=torch.Generator().manual_seed(0))
    assert len(step_losses) == 3 and len(record) == 2
    assert float(record[0].abs().max()) == 0.0
    assert float(record[1][:, :1].abs().max()) == 0.0
    assert float((record[1][:, 1:] - 99.0).abs().max()) == 0.0
    assert float(y["y"].abs().max()) == 0.0
    torch.testing.assert_close(total, sum(step_losses) / 3)

    # unbatched windows take a prediction of one item
    slid = model._append_autoregressive_prediction(
        {"y": torch.zeros((2, 8, 8))}, torch.ones((1, 8, 8, 1)))
    assert slid["y"].shape == (2, 8, 8) and float(slid["y"][1].min()) == 1
    with pytest.raises(ValueError, match="unbatched"):
        model._append_autoregressive_prediction(
            {"y": torch.zeros((2, 8, 8))}, torch.ones((2, 8, 8, 1)))
    with pytest.raises(ValueError, match="key 'y'"):
        model._append_autoregressive_prediction(torch.zeros(2), x)
    with pytest.raises(ValueError, match="conditional"):
        model.autoregressive_loss_fn(x, None)

    m = ens.EnsembleKarrasModel
    t = m._split_autoregressive_targets(torch.zeros((2, 3, 8, 8, 1)), 3)
    assert len(t) == 3 and t[0].shape == (2, 8, 8, 1)
    t = m._split_autoregressive_targets(torch.zeros((2, 8, 8, 6)), 3)
    assert len(t) == 3 and t[0].shape == (2, 8, 8, 2)
    with pytest.raises(ValueError):
        m._split_autoregressive_targets(torch.zeros((2, 8, 8, 5)), 3)
    masks = m._split_autoregressive_masks(torch.ones((2, 8, 8, 6)), 3, t)
    assert len(masks) == 3 and masks[0].shape == (2, 8, 8, 2)
    assert m._split_autoregressive_masks(torch.ones((2, 8, 8, 1)), 3,
                                         t)[2].shape == (2, 8, 8, 1)

    model.config.autoregressive_loss_weights = [1.0, 2.0, 3.0]
    np.testing.assert_allclose(model._autoregressive_step_weights(3),
                               [1 / 6, 2 / 6, 3 / 6], rtol=1e-6)
    jm = jens.EnsembleKarrasModel(None, jens.EnsembleKarrasModelConfig(
        None, None, None, autoregressive_loss_weights=[1.0, 2.0, 3.0]))
    np.testing.assert_array_equal(model._autoregressive_step_weights(3),
                                  jm._autoregressive_step_weights(3))
    with pytest.raises(ValueError):
        model.config.autoregressive_loss_weights = [1.0]
        model._autoregressive_step_weights(3)


def test_non_ar_path_and_config():
    """One horizon never calls the AR loss; ``from_karras_config`` keeps the
    base's fields and takes the ensemble knobs; the presets record the
    autoregressive fields in ``extra_args`` as the JAX package's do."""
    base = KarrasModelConfig.from_edm(loss_metric="crps",
                                      autoregressive_loss_steps=2,
                                      autoregressive_loss_diffusion_steps=7)
    jbase = JKarrasModelConfig.from_edm(loss_metric="crps",
                                        autoregressive_loss_steps=2,
                                        autoregressive_loss_diffusion_steps=7)
    assert base.extra_args == jbase.extra_args
    assert base.autoregressive_loss_diffusion_steps == 7
    cfg = ens.EnsembleKarrasModelConfig.from_karras_config(
        base, ensemble_size_train=4, replay_enabled=True)
    jcfg = jens.EnsembleKarrasModelConfig.from_karras_config(
        jbase, ensemble_size_train=4, replay_enabled=True)
    for name in ("ensemble_size_train", "ensemble_size_val",
                 "replay_enabled", "replay_loss_weight", "tag",
                 "loss_metric", "freeze_layer_patterns") + ens._AR_FIELDS:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    model = ens.EnsembleKarrasModel(MLPUncond(2, (8,), device="cpu"),
                                    ens.EnsembleKarrasModelConfig.from_edm(
                                        loss_metric="mse"), device="cpu")
    assert not model.has_autoregressive_loss()
    model.autoregressive_loss_fn = None      # would fail if called
    g = torch.Generator().manual_seed(0)
    loss, _, aux = model.training_loss(torch.zeros((4, 2)), generator=g)
    assert aux == {} and torch.isfinite(loss)
    # one member: the base loss on the same draws
    x, sigma = torch.randn(4, 2), torch.ones(4)
    eps = torch.randn(4, 2)
    torch.testing.assert_close(
        model.loss_fn(x, sigma, n_ensemble=1, eps=eps),
        super(ens.EnsembleKarrasModel, model).loss_fn(x, sigma, eps=eps))


def test_crps_and_multispace_match_jax():
    """``crps_ensemble`` (E = 1 and 4, masked or not), the ensemble-aware
    scalar wrapper and ``MultiSpaceLoss`` against the JAX package's."""
    from diffsci_tpu.ops import losses as jlosses
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(3, 4, 6, 6, 2)).astype(np.float32)
    target = rng.normal(size=(3, 6, 6, 2)).astype(np.float32)
    mask = (rng.uniform(size=(3, 6, 6, 2)) < 0.3).astype(np.float32)
    for p in (pred, pred[:, 0]):
        for m in (None, mask):
            _check(losses.crps_ensemble(_t(p), _t(target),
                                        None if m is None else _t(m)),
                   jlosses.crps_ensemble(jnp.asarray(p), jnp.asarray(target),
                                         m), rtol=1e-5, atol=1e-7)
    wrapped = losses.elementwise_to_scalar(losses.mse)
    jwrapped = jlosses._elementwise_to_scalar(jlosses.mse)
    _check(wrapped(_t(pred), _t(target), _t(mask)),
           jwrapped(jnp.asarray(pred), jnp.asarray(target),
                    jnp.asarray(mask)), rtol=1e-5, atol=1e-7)
    cfg = {"losses": [
        {"name": "lat", "type": "huber", "space": "latent", "weight": 0.5},
        {"name": "pix", "type": "crps", "space": "pixel", "weight": 2.0},
        {"name": "nomask", "type": "mse", "space": "latent",
         "use_mask": False}]}
    ms = losses.MultiSpaceLoss(cfg, decode_fn=lambda z: 2.0 * z)
    jms = jlosses.MultiSpaceLoss(cfg, decode_fn=lambda z: 2.0 * z)
    ours = ms.compute_loss(_t(target + 0.1), _t(target),
                           mask_latent=_t(mask), mask_pixel=_t(mask))
    ref = jms.compute_loss(jnp.asarray(target + 0.1), jnp.asarray(target),
                           mask_latent=jnp.asarray(mask),
                           mask_pixel=jnp.asarray(mask))
    assert set(ours) == set(ref)
    for k in ref:
        _check(ours[k], ref[k], rtol=1e-5, atol=1e-7, label=k)
    with pytest.raises(ValueError, match="decode_fn"):
        losses.MultiSpaceLoss(cfg).compute_loss(_t(target), _t(target))


# ---------------------------------------------------------------------------
# replay schedule, L2-SP
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["constant", "linear", "cosine", "off"])
def test_replay_schedule_matches_jax(kind):
    schedule = {} if kind == "off" else dict(
        enabled=True, type=kind, start_weight=1.0, end_weight=0.2,
        num_steps=10)
    for pos in (0, 3, 7, 10, 25):
        ours = ens.scheduled_replay_weight(schedule, 0.7, pos)
        ref = float(jens.scheduled_replay_weight(schedule, 0.7, pos))
        assert ours == ref, (kind, pos, ours, ref)
    with pytest.raises(ValueError):
        ens.scheduled_replay_weight(dict(enabled=True, type="nope"), 1, 0)


def test_l2_sp_matches_jax():
    rng = np.random.default_rng(1)
    params = {"model.a.weight": rng.normal(size=(3, 2)).astype(np.float32),
              "model.a.bias": rng.normal(size=(3,)).astype(np.float32),
              "model.b.weight": rng.normal(size=(4,)).astype(np.float32)}
    ref = ens.select_regularization_reference(
        {k: _t(v) for k, v in params.items()}, ["model.a.*"],
        ["*.bias"])
    assert set(ref) == {"model.a.weight"}
    moved = {k: _t(v + 0.5) for k, v in params.items()}
    jparams = {"a": {"w": jnp.asarray(params["model.a.weight"] + 0.5)}}
    jref = {"a": {"w": jnp.asarray(params["model.a.weight"])}}
    for normalize in (True, False):
        _check(ens.l2_sp_regularization(moved, ref, 0.3, normalize),
               jens.l2_sp_regularization(jparams, jref, 0.3, normalize),
               rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="did not match"):
        ens.select_regularization_reference(moved, ["nothing.*"])


# ---------------------------------------------------------------------------
# the in-step sampler and the train step against the JAX package
# ---------------------------------------------------------------------------
H = 8


def _jax_and_port_ar(steps=2, diffusion_steps=2, loss_metric="crps",
                     ensemble=2):
    kw = dict(autoregressive_loss_steps=steps,
              autoregressive_loss_diffusion_steps=diffusion_steps)
    jcfg = jens.EnsembleKarrasModelConfig.from_karras_config(
        JKarrasModelConfig.from_edm(loss_metric=loss_metric, **kw),
        ensemble_size_train=ensemble)
    jnet = JPUNetGCond(JPUNetGConfig(**_SMALL, input_channels=3,
                                     output_channels=1),
                       channel_conditional_items=["y"])
    jmodel = jens.EnsembleKarrasModel(jnet, jcfg, conditional=True)
    cfg = ens.EnsembleKarrasModelConfig.from_karras_config(
        KarrasModelConfig.from_edm(loss_metric=loss_metric, **kw),
        ensemble_size_train=ensemble)
    model = ens.EnsembleKarrasModel(_ar_net(), cfg, conditional=True,
                                    device="cpu")
    return jmodel, model


def test_in_step_sampler_matches_jax_propagate_white_noise():
    """The in-step sampler from one x_T (3 Heun steps) against the JAX
    package's ``propagate_white_noise`` on the same x_T and window, at
    the bound of the port's other Heun trajectories against the JAX
    package's (tests/test_torch_sampling.py: rtol 1e-3, atol 1e-4)."""
    jmodel, model = _jax_and_port_ar(diffusion_steps=3)
    rng = np.random.default_rng(2)
    ywin = rng.normal(size=(2, H, H, 2)).astype(np.float32)
    x_T = rng.normal(size=(2, H, H, 1)).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), (2, H, H, 1),
                            {"y": jnp.asarray(ywin)})
    model.net.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables)), strict=True)
    ref = jmodel.propagate_white_noise(variables, jax.random.PRNGKey(1),
                                       jnp.asarray(x_T),
                                       {"y": jnp.asarray(ywin)}, nsteps=3)
    pred = model._sample_next_autoregressive_condition(
        torch.zeros((2, H, H, 1)), {"y": _t(np.moveaxis(ywin, -1, 1))},
        _t(x_T))
    _check(pred, ref, rtol=1e-3, atol=1e-4)


def test_ensemble_train_step_matches_jax():
    """Three f32 steps of ``make_ensemble_train_step`` (CRPS over E = 2,
    two horizons, a 2-step in-step sampler, clip, AdamW) from one JAX
    init on one batch, every draw replayed into both (the JAX step's
    through a training loss that indexes them by the step's key): the
    loss and the per-horizon losses at rtol 5e-4, the parameters as
    tests/test_torch_training.py holds them (99.9 % of entries within
    0.01·lr, every entry within 2·k·lr after k steps)."""
    jmodel, model = _jax_and_port_ar()
    B, S, E, lr = 2, 2, 2, 1e-3
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, H, H, S)).astype(np.float32)
    ywin = rng.normal(size=(B, H, H, 2)).astype(np.float32)
    steps = 3
    sig = np.exp(rng.normal(size=(steps, S, B)) * 1.2 - 1.2).astype(
        np.float32)
    eps = rng.normal(size=(steps, S, B, E, H, H, 1)).astype(np.float32)
    x_T = rng.normal(size=(steps, S - 1, B, H, H, 1)).astype(np.float32)

    jstate, jtx = jcreate_train_state(jmodel, jax.random.PRNGKey(0),
                                      (B, H, H, 1),
                                      y={"y": jnp.asarray(ywin)})
    orig = jmodel.autoregressive_loss_fn

    def replayed(variables, key, batch, n_ensemble=1, train=True):
        i = key[1]
        bx, by = batch
        calls = []

        def sampler_fn(target, y):
            s = len(calls)
            calls.append(s)
            return jax.lax.stop_gradient(jmodel.propagate_white_noise(
                variables, key, jnp.asarray(x_T)[i, s], y, nsteps=2))

        loss, upd, step_losses = orig(
            variables, key, bx, by, None, train=train,
            n_ensemble=n_ensemble, sigma_seq=jnp.asarray(sig)[i],
            eps_seq=[jnp.asarray(eps)[i, s] for s in range(S)],
            sampler_fn=sampler_fn)
        return loss, upd, {f"ar_loss_horizon_{k + 1}": v
                           for k, v in enumerate(step_losses)}

    jmodel.training_loss = replayed
    jstep = jens.make_ensemble_train_step(jmodel, jtx)

    model.net.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, jstate.variables())), strict=True)
    state, tx = create_train_state(model, (B, H, H, 3), seed=None,
                                   optimizer=default_optimizer(lr))
    step = ens.make_ensemble_train_step(model, tx)
    y = {"y": _t(np.moveaxis(ywin, -1, 1))}
    for k in range(steps):
        draws = model.draw_tensors(_t(x), E)
        draws["sigma"].copy_(_t(sig[k]))
        draws["eps"].copy_(_t(eps[k]))
        draws["x_T"].copy_(_t(x_T[k]))
        jstate, jmet = jstep(jstate, jax.random.PRNGKey(k),
                             (jnp.asarray(x), {"y": jnp.asarray(ywin)}))
        state, met = step(state, _t(x), y, draws=draws)
        assert state.step == k + 1
        for name in ("train_loss", "ar_loss_horizon_1", "ar_loss_horizon_2"):
            _check(met[name], jmet[name], rtol=5e-4, atol=1e-6,
                   label=f"{name} step {k}")
        theirs = from_jax_variables(jax.tree.map(np.asarray,
                                                 jstate.variables()))
        diff = np.concatenate([(state.params[n].detach() - theirs[n]).abs()
                               .flatten().numpy() for n in state.params])
        assert np.quantile(diff, 0.999) <= 0.01 * lr, k
        assert diff.max() <= 2 * (k + 1) * lr, k

    # the JAX run carried over, with an L2-SP reference of its weights
    # (biases left out): the same parameters, step and reference term
    jref = jens.select_regularization_reference(
        jstate.params, ["model/*"], ["*/bias", "*/bias_*"])
    state_np = jax.tree.map(np.asarray, jstate)
    carried, ref = from_jax_train_state(
        state_np, model, default_optimizer(lr),
        reg_reference=jax.tree.map(np.asarray, jref))
    assert carried.step == steps
    theirs = from_jax_variables(jax.tree.map(np.asarray,
                                             jstate.variables()))
    for name, p in carried.params.items():
        torch.testing.assert_close(p.detach(), theirs[name], rtol=0, atol=0)
    assert ref and not any(k.endswith("bias") for k in ref)
    moved = {k: v.detach() + 0.01 for k, v in carried.params.items()}
    jmoved = jax.tree.map(lambda a: a + 0.01, jstate.params)
    _check(ens.l2_sp_regularization(moved, ref, 2.0),
           jens.l2_sp_regularization(jmoved, jref, 2.0), rtol=1e-5, atol=0)


def test_replay_and_l2_sp_train_steps(monkeypatch):
    """The replay step adds the scheduled weight times the replay batch's
    loss (tests/test_ensemble.py's fake per-batch losses); the L2-SP term
    is 0 on the reference's own weights and positive once they moved."""
    cfg = ens.EnsembleKarrasModelConfig.from_karras_config(
        KarrasModelConfig.from_edm(loss_metric="mse"), replay_enabled=True,
        replay_loss_weight=0.5)
    model = ens.EnsembleKarrasModel(MLPUncond(2, (8,), device="cpu"), cfg,
                                    device="cpu")
    state, tx = create_train_state(model, (4, 2), seed=0)

    def fake(x, y, mask, n_ensemble=1, train=True, generator=None,
             draws=None, variables=None):
        leaf = next(iter(model.net.parameters()))
        return x[0, 0] + 0.0 * leaf.sum(), {}, {}

    monkeypatch.setattr(model, "_training_loss", fake)
    step = ens.make_ensemble_train_step(model, tx)
    _, met = step(state, torch.full((1, 2), 2.0),
                  replay=torch.full((1, 2), 4.0))
    assert float(met["train_loss"]) == 2.0 + 0.5 * 4.0
    assert float(met["train_loss_finetune"]) == 2.0
    assert float(met["train_loss_replay"]) == 4.0
    assert float(met["train_replay_loss_weight"]) == 0.5
    with pytest.raises(ValueError, match="replay batch"):
        step(state, torch.full((1, 2), 2.0))
    monkeypatch.undo()

    cfg = ens.EnsembleKarrasModelConfig.from_karras_config(
        KarrasModelConfig.from_edm(loss_metric="mse"),
        pretrained_weight_regularization={"enabled": True, "weight": 10.0})
    model = ens.EnsembleKarrasModel(MLPUncond(2, (8,), device="cpu"), cfg,
                                    device="cpu")
    state, tx = create_train_state(model, (4, 2), seed=0)
    ref = ens.select_regularization_reference(state.params)
    step = ens.make_ensemble_train_step(model, tx, reg_reference=ref)
    g = torch.Generator().manual_seed(0)
    _, met = step(state, torch.zeros((8, 2)), generator=g)
    assert float(met["l2_sp"]) == 0.0
    _, met = step(state, torch.zeros((8, 2)), generator=g)
    assert float(met["l2_sp"]) > 0.0 and state.step == 2
