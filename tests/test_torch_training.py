"""The port's training slice against the JAX package: the σ draw, the
losses, ``KarrasModel.loss_fn``, the EMA tracker and ``make_train_step``
step for step, plus the faults the slice repairs (gradients reach the f32
masters under a bf16 ``compute_dtype``, ``train=True`` means training
mode, and the kernel wrappers stay in the autograd graph).

Weights come from a JAX init converted by ``from_jax_variables`` and
inputs, σ and ε are made with numpy, so both packages see the same
numbers. On the CPU the port's kernels run their plain versions inside the
same ``torch.autograd.Function``s that launch the kernels on the card; the
JAX package's flash kernel runs in interpret mode where a test says so.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu.kernels import flash_attention as jfa
from diffsci_tpu.models import EMATracker as JEMATracker
from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import PUNetG as JPUNetG
from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig
from diffsci_tpu.models import create_train_state as jcreate_train_state
from diffsci_tpu.models import make_train_step as jmake_train_step
from diffsci_tpu.models.karras import ema as jema
from diffsci_tpu.ops import losses as jlosses

from diffsci_tpu_torch import (EMATracker, KarrasModel, KarrasModelConfig,
                               PUNetG, PUNetGConfig, create_train_state,
                               default_optimizer, make_eval_step,
                               make_train_step)
from diffsci_tpu_torch import ops
from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.models.karras import ema
from diffsci_tpu_torch.ops import losses
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

_SMALL = dict(model_channels=8, channel_expansion=(2,),
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1, num_heads=2)
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")
# 3D 32³ input, one downsampling: 16³ = 4096 bottleneck tokens, head dim 8
_SMALL_3D = dict(_SMALL, dimension=3, attn_backend="flash")


def _jax_and_port(fields, x_shape, compute_dtype=None, loss_metric="huber"):
    """A JAX KarrasModel with its init, and the port's with the same
    weights."""
    jmodel = JKarrasModel(JPUNetG(JPUNetGConfig(**fields)),
                          JKarrasModelConfig.from_edm(loss_metric=loss_metric),
                          compute_dtype=compute_dtype and jnp.bfloat16)
    variables = jmodel.init(jax.random.PRNGKey(0), x_shape)
    model = KarrasModel(PUNetG(PUNetGConfig(**fields), device="cpu"),
                        KarrasModelConfig.from_edm(loss_metric=loss_metric),
                        compute_dtype=compute_dtype, device="cpu")
    model.net.load_state_dict(
        from_jax_variables(jax.tree.map(np.asarray, variables)), strict=True)
    return jmodel, variables, model


def _state_dict_of(variables):
    return from_jax_variables(jax.tree.map(np.asarray, variables))


def _batch(x_shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    sigma = np.exp(rng.standard_normal(x_shape[0]) * 1.2 - 1.2).astype(
        np.float32)
    eps = rng.standard_normal(x_shape).astype(np.float32)
    return x, sigma, eps


# ---------------------------------------------------------------------------
# σ draw and losses
# ---------------------------------------------------------------------------
def test_edm_noise_sampler_moments():
    """log σ ~ N(prior_mean, prior_std²), from an explicit generator: the
    moments of 200000 draws within 5 standard errors, one seed gives one
    draw."""
    sampler = ops.EDMNoiseSampler(prior_mean=-1.2, prior_std=1.2)
    n = 200_000
    s = sampler.sample((n,), torch.Generator().manual_seed(0))
    assert s.shape == (n,) and s.dtype == torch.float32 and (s > 0).all()
    logs = s.log().double()
    assert abs(float(logs.mean()) + 1.2) < 5 * 1.2 / n ** 0.5
    assert abs(float(logs.std()) - 1.2) < 5 * 1.2 / (2 * n) ** 0.5
    again = sampler.sample((n,), torch.Generator().manual_seed(0))
    torch.testing.assert_close(s, again, rtol=0, atol=0)
    assert sampler.sample((3, 2)).shape == (3, 2)


@pytest.mark.parametrize("delta", [1.0, 0.3])
def test_elementwise_losses_match_jax(delta):
    rng = np.random.default_rng(0)
    p, t = (rng.standard_normal((3, 8, 8, 1)).astype(np.float32) * 2
            for _ in range(2))
    mask = (rng.random((3, 8, 8, 1)) < 0.3).astype(np.float32)
    tp, tt = torch.from_numpy(p), torch.from_numpy(t)
    np.testing.assert_allclose(losses.huber(tp, tt, delta).numpy(),
                               np.asarray(jlosses.huber(p, t, delta)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        losses.huber(tp, tt, delta).numpy(),
        torch.nn.HuberLoss(reduction="none", delta=delta)(tp, tt).numpy(),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(losses.mse(tp, tt).numpy(),
                               np.asarray(jlosses.mse(p, t)), rtol=1e-6)
    for m in (None, mask):
        np.testing.assert_allclose(
            float(losses.masked_mean(losses.mse(tp, tt),
                                     None if m is None else
                                     torch.from_numpy(m))),
            float(jlosses.masked_mean(jlosses.mse(p, t), m)), rtol=1e-6)


def test_make_loss_metric_configs():
    p, t = torch.tensor([0.0, 3.0]), torch.tensor([0.5, 0.0])
    torch.testing.assert_close(losses.make_loss_metric("mse")(p, t),
                               torch.tensor([0.25, 9.0]))
    torch.testing.assert_close(losses.make_loss_metric("huber")(p, t),
                               torch.tensor([0.125, 2.5]))
    torch.testing.assert_close(
        losses.make_loss_metric({"huber": {"delta": 2.0}})(p, t),
        torch.tensor([0.125, 4.0]))
    crps = losses.make_loss_metric("crps")
    assert crps is losses.crps_ensemble and crps.reduces_internally
    with pytest.raises(ValueError, match="not recognized"):
        losses.make_loss_metric("nope")
    with pytest.raises(ValueError):
        losses.make_loss_metric({"losses": []})


# ---------------------------------------------------------------------------
# KarrasModel.loss_fn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["huber", "mse"])
def test_loss_fn_matches_jax_2d(metric, masked):
    """Same weights, x, σ and replayed ε: the loss agrees within rtol 1e-5
    (f32, sums in another order)."""
    x_shape = (3, 16, 16, 1)
    jmodel, variables, model = _jax_and_port(_SMALL, x_shape,
                                             loss_metric=metric)
    x, sigma, eps = _batch(x_shape, 1)
    mask = ((np.random.default_rng(2).random(x_shape) < 0.4)
            .astype(np.float32) if masked else None)
    ref, _ = jmodel.loss_fn(variables, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(sigma), mask=mask,
                            eps=jnp.asarray(eps))
    loss = model.loss_fn(torch.from_numpy(x), torch.from_numpy(sigma),
                         mask=None if mask is None else torch.from_numpy(mask),
                         eps=torch.from_numpy(eps))
    assert loss.ndim == 0 and loss.requires_grad
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)


class _MLP(torch.nn.Module):
    """The reference's toy MLP score network: concat(x, t[, y]) -> 16 ->
    16 -> dim with ReLU (state-dict names net.0, net.2, net.4)."""

    def __init__(self, in_dim):
        super().__init__()
        self.net = torch.nn.Sequential(
            torch.nn.Linear(in_dim, 16), torch.nn.ReLU(),
            torch.nn.Linear(16, 16), torch.nn.ReLU(), torch.nn.Linear(16, 3))

    def forward(self, x, t, y=None):
        parts = [x, t[:, None]] + ([] if y is None else [y])
        return self.net(torch.cat(parts, dim=-1))


@pytest.mark.parametrize("case", ["edm_mse", "edm_huber", "edm_mse_masked",
                                  "edm_mse_cond"])
def test_loss_fn_matches_reference_fixture(case):
    """The reference's KarrasModule.loss_fn on its own weights, batch, σ
    and noise (fixture karras_loss.npz), at the bound of the JAX
    package's test of the same fixture (rtol 5e-4)."""
    d = np.load(os.path.join(FIXDIR, "karras_loss.npz"))
    cond, masked = case.endswith("_cond"), case.endswith("_masked")
    prefix = "csd__" if cond else "sd__"
    net = _MLP(6 if cond else 4)
    net.load_state_dict({k[len(prefix):]: torch.from_numpy(d[k])
                         for k in d.files if k.startswith(prefix)},
                        strict=True)
    model = KarrasModel(net, KarrasModelConfig.from_edm(
        loss_metric=case.split("_")[1]), conditional=cond, device="cpu")
    with torch.no_grad():
        loss = model.loss_fn(
            torch.from_numpy(d["x"]), torch.from_numpy(d["sigma"]),
            y=torch.from_numpy(d["y"]) if cond else None,
            mask=torch.from_numpy(d["mask"]) if masked else None,
            train=False, eps=torch.from_numpy(d["eps"]))
    np.testing.assert_allclose(float(loss), float(d[f"loss_{case}"]),
                               rtol=5e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_fn_and_grads_match_jax_3d_flash(masked, monkeypatch):
    """A 3D PUNetG whose bottleneck attention takes the flash path over
    4096 tokens: on the port's side FlashAttention (K4 forward, K5/K6
    backward; their plain versions here) and NormSiLU (K2/K3), on the JAX
    side its Pallas kernels in interpret mode. Loss within rtol 1e-5;
    every parameter's gradient within 1e-4 of the largest gradient
    entry."""
    monkeypatch.setattr(jfa, "INTERPRET", True)
    x_shape = (2, 32, 32, 32, 1)
    jmodel, variables, model = _jax_and_port(_SMALL_3D, x_shape)
    x, sigma, eps = _batch(x_shape, 3)
    mask = ((np.random.default_rng(4).random(x_shape) < 0.4)
            .astype(np.float32) if masked else None)

    def jloss(params):
        return jmodel.loss_fn({**variables, "params": params},
                              jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(sigma), mask=mask,
                              eps=jnp.asarray(eps))[0]

    ref, jgrads = jax.value_and_grad(jloss)(variables["params"])
    loss = model.loss_fn(torch.from_numpy(x), torch.from_numpy(sigma),
                         mask=None if mask is None else torch.from_numpy(mask),
                         eps=torch.from_numpy(eps))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    ref_grads = _state_dict_of({**variables, "params": jgrads})
    scale = max(float(g.abs().max()) for g in ref_grads.values())
    for name, p in model.net.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)


# ---------------------------------------------------------------------------
# EMA
# ---------------------------------------------------------------------------
def _params(val):
    return {"w": np.full((3,), val, np.float32),
            "b": np.full((2,), 2 * val, np.float32)}


@pytest.mark.parametrize("update_every", [1, 4])
@pytest.mark.parametrize("tracker_kw", [
    dict(ema_type="traditional", decay=0.9),
    dict(ema_type="traditional", decay=0.999, halflife_steps=10.0,
         rampup_ratio=0.5),
    dict(ema_type="power", power_function_stds=[0.05, 0.3])])
def test_ema_tracker_matches_jax(tracker_kw, update_every):
    """12 updates with moving parameters: every profile's shadows within
    rtol 1e-6 of the JAX tracker's, and the same update count."""
    jt = JEMATracker(update_every=update_every, **tracker_kw)
    t = EMATracker(update_every=update_every, **tracker_kw)
    jstate = jt.init({k: jnp.asarray(v) for k, v in _params(0.0).items()})
    state = t.init({k: torch.from_numpy(v) for k, v in _params(0.0).items()})
    for i in range(1, 13):
        p = _params(float(i) ** 1.5)
        jstate = jt.update(jstate, {k: jnp.asarray(v) for k, v in p.items()})
        state = t.update(state, {k: torch.from_numpy(v) for k, v in p.items()})
        for idx in range(t.num_profiles):
            for k in p:
                np.testing.assert_allclose(
                    t.get_params(state, idx)[k].numpy(),
                    np.asarray(jt.get_params(jstate, idx)[k]), rtol=1e-6,
                    err_msg=f"update {i} profile {idx} {k}")
    assert state.num_updates == int(jstate.num_updates) == 12


def test_ema_math_matches_jax():
    for std in (0.05, 0.1, 0.2):
        assert ema.power_function_exp_from_std(std) == pytest.approx(
            jema.power_function_exp_from_std(std), rel=1e-12)
        for t in (1, 2, 7, 100):
            assert ema.power_function_beta(std, t) == pytest.approx(
                float(jema.power_function_beta(std, t)), rel=1e-6)
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05, 0.1])
    state = tracker.init({"w": torch.zeros(3)})
    tracker.update(state, {"w": torch.full((3,), 3.0)})  # beta 0: a copy
    for idx in range(2):
        torch.testing.assert_close(tracker.get_params(state, idx)["w"],
                                   torch.full((3,), 3.0))
    with pytest.raises(ValueError):
        EMATracker(ema_type="other")
    with pytest.raises(ValueError):
        EMATracker(update_every=0)


# ---------------------------------------------------------------------------
# the train step, step for step against JAX
# ---------------------------------------------------------------------------
def test_train_step_trajectory_matches_jax():
    """5 f32 steps of make_train_step (Huber loss, backward, NaN guard,
    clip 0.5, AdamW lr 1e-3, power EMA) from one JAX init, on one batch,
    with σ and ε replayed per step.

    Tolerances: loss rtol 1e-5 and grad_norm rtol 1e-4 (f32 sums in
    another order, compounding over the steps). Parameters and EMA
    shadows: AdamW moves each entry by lr·m/(√v + eps), which is ±lr
    wherever the gradient is well above its rounding noise, so a relative
    gradient difference δ shifts an entry by ~lr·δ. Where a gradient entry
    is near zero, rounding alone can flip m/√v, up to 2·lr per step. Hence
    99.9% of entries within 0.01·lr and every entry within 2·k·lr after k
    steps."""
    x_shape = (4, 16, 16, 1)
    lr = 1e-3
    jmodel, _, _ = _jax_and_port(_SMALL, x_shape)
    jtracker = JEMATracker(ema_type="power", power_function_stds=[0.05])
    jstate, jtx = jcreate_train_state(jmodel, jax.random.PRNGKey(0), x_shape,
                                      ema=jtracker)

    def jloss(variables, key, x, y, replay, train=True):
        return jmodel.loss_fn(variables, key, x, replay["sigma"], train=train,
                              eps=replay["eps"])

    jstep = jmake_train_step(jmodel, jtx, ema=jtracker, loss_fn=jloss)

    model = KarrasModel(PUNetG(PUNetGConfig(**_SMALL), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.net.load_state_dict(_state_dict_of(jstate.variables()), strict=True)
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05])
    state, tx = create_train_state(model, x_shape, seed=None,
                                   optimizer=default_optimizer(lr),
                                   ema=tracker)
    step = make_train_step(model, tx, ema=tracker)

    x = np.random.default_rng(0).standard_normal(x_shape).astype(np.float32)
    for k in range(1, 6):
        _, sigma, eps = _batch(x_shape, 10 + k)
        jstate, jmet = jstep(jstate, jax.random.PRNGKey(k), jnp.asarray(x),
                             None, {"sigma": jnp.asarray(sigma),
                                    "eps": jnp.asarray(eps)})
        state, met = step(state, torch.from_numpy(x),
                          sigma=torch.from_numpy(sigma),
                          eps=torch.from_numpy(eps))
        assert state.step == k
        np.testing.assert_allclose(float(met["train_loss"]),
                                   float(jmet["train_loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        for ours, theirs in (
                (state.params, _state_dict_of(jstate.variables())),
                (state.ema.profiles[0], _state_dict_of(
                    {**jstate.variables(),
                     "params": jstate.ema.profiles[0]}))):
            diff = np.concatenate([(ours[n].detach() - theirs[n]).abs()
                                   .flatten().numpy() for n in ours])
            assert np.quantile(diff, 0.999) <= 0.01 * lr, k
            assert diff.max() <= 2 * k * lr, k
    assert state.ema.num_updates == 5


def test_train_step_draws_sigma_and_eval_step():
    """Without replayed draws the step takes σ and ε from the generator:
    one seed, one step. The eval step runs without gradients, with the EMA
    shadows when asked, and changes nothing."""
    x_shape = (2, 8, 8, 1)
    fields = dict(_SMALL, model_channels=4)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(x_shape)
                         .astype(np.float32))
    out = []
    for _ in range(2):
        model = KarrasModel(PUNetG(PUNetGConfig(**fields), device="cpu"),
                            KarrasModelConfig.from_edm(), device="cpu")
        tracker = EMATracker(ema_type="power", update_every=4)
        state, tx = create_train_state(model, x_shape, seed=3, ema=tracker)
        step = make_train_step(model, tx, ema=tracker)
        gen = torch.Generator().manual_seed(5)
        for _ in range(3):
            state, met = step(state, x, generator=gen)
        out.append((float(met["train_loss"]), float(met["grad_norm"])))
    assert out[0] == out[1] and np.isfinite(out[0]).all()
    assert state.ema.num_updates == 3
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    eval_step = make_eval_step(model, tracker, use_ema=True)
    sigma, eps = torch.full((2,), 0.7), torch.zeros(x_shape)
    val = eval_step(state, x, sigma=sigma, eps=eps)["valid_loss"]
    assert not val.requires_grad and np.isfinite(float(val))
    # before the 4th update the shadows are still the initial weights
    with torch.no_grad():
        init = model.loss_fn(x, sigma, eps=eps, train=False,
                             variables=state.ema_variables(tracker))
    assert float(val) == float(init)
    for k, v in model.net.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="x_shape"):
        create_train_state(model, (2, 8, 8), seed=None)


# ---------------------------------------------------------------------------
# the repaired faults
# ---------------------------------------------------------------------------
def test_bf16_train_step_reaches_every_f32_master():
    """compute_dtype=bfloat16: the parameters are cast inside the graph,
    so one step leaves a non-zero f32 gradient on every master and moves
    every master."""
    x_shape = (2, 16, 16, 1)
    model = KarrasModel(PUNetG(PUNetGConfig(**_SMALL), device="cpu"),
                        KarrasModelConfig.from_edm(),
                        compute_dtype=torch.bfloat16, device="cpu")
    state, tx = create_train_state(model, x_shape, seed=0)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    x, sigma, eps = _batch(x_shape, 6)
    state, met = make_train_step(model, tx)(
        state, torch.from_numpy(x), sigma=torch.from_numpy(sigma),
        eps=torch.from_numpy(eps))
    assert np.isfinite(float(met["train_loss"]))
    for name, p in state.params.items():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert float(p.grad.abs().max()) > 0, name
        assert not torch.equal(p.detach(), before[name]), name


def test_bf16_gradient_error_matches_jax():
    """bf16 rounds at other places in the two packages (the JAX norms take
    their statistics in bf16, the port's K2/K3 in f32), so the pin is on
    the error: the port's bf16 loss and gradients stay as close to the
    port's f32 ones as the JAX package's bf16 ones to its f32 ones (within
    1.25x: loss, max and mean gradient error). The f32 gradients agree
    within 1e-5 of the largest entry."""
    x_shape = (2, 16, 16, 1)
    x, _, eps = _batch(x_shape, 7)
    sigma = np.array([0.05, 5.0], np.float32)
    out = {}
    for name, cd in (("f32", None), ("bf16", torch.bfloat16)):
        jmodel, variables, model = _jax_and_port(_SMALL, x_shape, cd)

        def jloss(params):
            return jmodel.loss_fn({**variables, "params": params},
                                  jax.random.PRNGKey(0), jnp.asarray(x),
                                  jnp.asarray(sigma), eps=jnp.asarray(eps))[0]

        jl, jg = jax.value_and_grad(jloss)(variables["params"])
        jg = _state_dict_of({**variables, "params": jg})
        loss = model.loss_fn(torch.from_numpy(x), torch.from_numpy(sigma),
                             eps=torch.from_numpy(eps))
        loss.backward()
        names = [n for n, _ in model.net.named_parameters()]
        out["jax", name] = (float(jl), np.concatenate(
            [jg[n].numpy().ravel() for n in names]))
        out["port", name] = (float(loss.detach()), np.concatenate(
            [p.grad.numpy().ravel() for _, p in model.net.named_parameters()]))
    ref = out["jax", "f32"][1]
    np.testing.assert_allclose(out["port", "f32"][1], ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    err = {who: (abs(out[who, "bf16"][0] - out[who, "f32"][0]),
                 np.abs(out[who, "bf16"][1] - out[who, "f32"][1]))
           for who in ("jax", "port")}
    assert err["port"][0] <= 1.25 * err["jax"][0]
    assert err["port"][1].max() <= 1.25 * err["jax"][1].max()
    assert err["port"][1].mean() <= 1.25 * err["jax"][1].mean()


def test_train_flag_sets_training_mode():
    """train=True runs the network in training mode (dropout on); sampling
    and train=False run it in eval mode, with or without a compute
    dtype."""
    for cd in (None, torch.bfloat16):
        model = KarrasModel(PUNetG(PUNetGConfig(**dict(_SMALL,
                                                       model_channels=4)),
                                   device="cpu"),
                            KarrasModelConfig.from_edm(), compute_dtype=cd,
                            device="cpu")
        model.init(seed=0)
        seen = []
        hook = torch.nn.modules.module.register_module_forward_hook(
            lambda mod, args, out: seen.append(mod.training)
            if isinstance(mod, torch.nn.Dropout) else None)
        try:
            x = torch.zeros(2, 8, 8, 1)
            model.loss_fn(x, torch.ones(2), train=True)
            assert seen and all(seen), cd
            seen.clear()
            model.loss_fn(x, torch.ones(2), train=False)
            assert seen and not any(seen), cd
            seen.clear()
            model.sample(2, (8, 8, 1), torch.Generator().manual_seed(0),
                         nsteps=2)
            assert seen and not any(seen), cd
        finally:
            hook.remove()


def test_sampling_after_training_sees_new_weights():
    """Under a compute dtype, sampling uses a cast copy of the network,
    one module for the model's life; a train step leaves it as it was,
    and the next call without gradients refreshes its tensors in place
    from the new masters (the tensors a captured sampler reads)."""
    x_shape = (2, 8, 8, 1)
    model = KarrasModel(PUNetG(PUNetGConfig(**dict(_SMALL, model_channels=4)),
                               device="cpu"),
                        KarrasModelConfig.from_edm(),
                        compute_dtype=torch.bfloat16, device="cpu")
    state, tx = create_train_state(model, x_shape, seed=0)
    x = torch.randn(x_shape, generator=torch.Generator().manual_seed(0))
    sigma = torch.tensor([0.5, 2.0])
    with torch.no_grad():
        d0, _ = model.get_denoiser(x, sigma)
    copy0 = model._cast_net
    tensors0 = {n: p.clone() for n, p in copy0.named_parameters()}
    step = make_train_step(model, tx)
    state, _ = step(state, x, generator=torch.Generator().manual_seed(1))
    for name, p in copy0.named_parameters():    # training left the copy
        assert torch.equal(p, tensors0[name])
    with torch.no_grad():
        d1, _ = model.get_denoiser(x, sigma)
    assert model._cast_net is copy0
    assert not torch.equal(d0, d1)
    assert any(not torch.equal(p, tensors0[n])
               for n, p in copy0.named_parameters())
    for name, p in model._cast_net.named_parameters():
        torch.testing.assert_close(
            p, dict(model.net.named_parameters())[name].detach().bfloat16(),
            rtol=0, atol=0)
