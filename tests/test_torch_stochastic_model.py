"""The port's stochastic samplers, VP/VE/SR3 configurations, inpainting,
stochastic serving and toy oracles, on the CPU, against the JAX package.

Weights come from a JAX init converted by ``from_jax_variables``; inputs
and every draw are made with numpy or replayed from the port's generator
into the JAX package's replay hooks (``noise_seq``, ``renoise_noises``,
``sigma``/``eps``), so both packages see the same numbers. The JAX flash
kernel runs in interpret mode. Tolerances: sampling trajectories rtol
1e-3 + atol 5e-4, as the port's Heun sampling test
(``tests/test_torch_sampling.py``), plus 1e-5 of the step's largest
entry: an untrained network drives the VP and VE trajectories to ~1e8,
where float32 sums in another order differ by a few units in the last
place of that scale; losses rtol 1e-5 and gradients 1e-4 of the largest
entry, as its training tests (``tests/test_torch_training.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu import data as jdata
from diffsci_tpu import ops as jops
from diffsci_tpu.kernels import flash_attention as jfa
from diffsci_tpu.models import EMATracker as JEMATracker
from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import PUNetG as JPUNetG
from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig
from diffsci_tpu.models import create_train_state as jcreate_train_state
from diffsci_tpu.models import make_train_step as jmake_train_step

from diffsci_tpu_torch import (EMATracker, KarrasModel, KarrasModelConfig,
                               PUNetG, PUNetGConfig, SamplerService,
                               create_train_state, default_optimizer,
                               make_eval_step, make_train_step)
from diffsci_tpu_torch import data, ops
from diffsci_tpu_torch.convert import from_jax_variables
from tests import _torch_warmup  # noqa: F401  (MKL's first exp, CPU threads)

_SMALL = dict(model_channels=8, channel_expansion=(2,),
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1, num_heads=2)
# 3D 32³ input, one downsampling: 16³ = 4096 bottleneck tokens (flash)
_SMALL_3D = dict(_SMALL, dimension=3, attn_backend="flash")


def _assert_trajectory_close(ours, ref, history=False, scale_tol=1e-5):
    """Every step t of a history (else the one state) within
    1e-3·|ref| + 5e-4 + scale_tol·max|ref_t|."""
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    for a, b in (zip(ours, ref) if history else [(ours, ref)]):
        np.testing.assert_allclose(
            a, b, rtol=1e-3, atol=5e-4 + scale_tol * float(np.abs(b).max()))


def _config(name, port: bool):
    cls = KarrasModelConfig if port else JKarrasModelConfig
    return {"edm": cls.from_edm, "vp": cls.from_vp, "ve": cls.from_ve,
            "sr3": cls.conditional_sr3}[name]()


def _pair(fields, x_shape, config="edm"):
    """A JAX KarrasModel with its init, and the port's with the same
    weights, under one configuration. Under VP the network's Fourier time
    embedding takes scale 0.03 in place of 30: VP's c_noise = 999·t spans
    [0, 999] where EDM's log(σ)/4 spans ~[-1.6, 1.1], and at scale 30 a
    one-ulp change of c_noise (the JAX package's fused float32 log gives
    998.99994 where an unfused one gives 999.0) turns the phases 2π·999·W
    by ~1e-2 rad and moves an untrained network's output by ~0.5 %."""
    if config == "vp":
        fields = dict(fields, time_projection_scale=0.03)
    jmodel = JKarrasModel(JPUNetG(JPUNetGConfig(**fields)),
                          _config(config, port=False))
    variables = jmodel.init(jax.random.PRNGKey(0), x_shape)
    model = KarrasModel(PUNetG(PUNetGConfig(**fields), device="cpu"),
                        _config(config, port=True), device="cpu")
    model.net.load_state_dict(_state_dict_of(variables), strict=True)
    return jmodel, variables, model


def _state_dict_of(variables):
    return from_jax_variables(jax.tree.map(np.asarray, variables))


def _rng(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["edm", "vp", "ve", "sr3"])
def test_config_presets_match_jax(name):
    """Each preset's description, grid, maximum scale and coefficients,
    and a round trip through ``load_from_description_with_tag``."""
    cfg, jcfg = _config(name, True), _config(name, False)
    assert cfg.export_description() == jcfg.export_description()
    again = KarrasModelConfig.load_from_description_with_tag(
        cfg.export_description())
    assert again.export_description() == cfg.export_description()
    np.testing.assert_allclose(cfg.noisescheduler.create_steps(19),
                               jcfg.noisescheduler.create_steps(19),
                               rtol=1e-12)
    assert cfg.noisescheduler.maximum_scale == pytest.approx(
        jcfg.noisescheduler.maximum_scale, rel=1e-12)
    sigma = np.geomspace(0.01, 80.0, 13).astype(np.float32)
    for ours, ref in zip(cfg.preconditioner.coefficients(
            torch.from_numpy(sigma)), jcfg.preconditioner.coefficients(
            jnp.asarray(sigma))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        cfg.noisesampler.loss_weighting(torch.from_numpy(sigma)).numpy(),
        np.asarray(jcfg.noisesampler.loss_weighting(jnp.asarray(sigma))),
        rtol=1e-6)
    with pytest.raises(ValueError):
        KarrasModelConfig.load_from_description_with_tag(
            {"tag": "custom", "extra_args": {}})


# ---------------------------------------------------------------------------
# stochastic and multistep sampling through the model
# ---------------------------------------------------------------------------
def _sample_case(fields, x_shape, config, integrator, stochastic, nsteps):
    jmodel, variables, model = _pair(fields, x_shape, config)
    x0 = _rng(1, x_shape)
    n = model.config.noisescheduler.noise_steps(nsteps, stochastic,
                                                integrator)
    noise = _rng(2, (n,) + x_shape) if n else None
    ref = np.asarray(jmodel.propagate_white_noise(
        variables, jax.random.PRNGKey(0), jnp.asarray(x0), nsteps=nsteps,
        record_history=True, integrator=integrator, stochastic=stochastic,
        noise_seq=None if noise is None else jnp.asarray(noise)))
    hist = model.propagate_white_noise(
        torch.from_numpy(x0), nsteps=nsteps, record_history=True,
        integrator=integrator, stochastic=stochastic,
        noise_seq=None if noise is None else torch.from_numpy(noise))
    assert tuple(hist.shape) == ref.shape == (nsteps + 1,) + x_shape
    # VP's churn evaluates t_noise = σ⁻¹(σ(1 + γ)) and s(t_noise) in float32
    # on both sides, fused by XLA and not by the port: the churned states
    # differ by ~1e-5 of their scale from the first step on, not growing
    scale_tol = 5e-5 if (config, integrator) == ("vp", "karras") else 1e-5
    _assert_trajectory_close(hist, ref, history=True, scale_tol=scale_tol)


@pytest.mark.parametrize("config", ["edm", "vp", "ve"])
@pytest.mark.parametrize("integrator,stochastic", [
    ("karras", False), ("dpmpp2m", False), (None, True)])
def test_stochastic_sampling_matches_jax_2d(config, integrator, stochastic):
    """6 steps of churn, DPM++2M and Euler–Maruyama (``stochastic=True``)
    through ``propagate_white_noise`` with the noise replayed."""
    _sample_case(_SMALL, (2, 16, 16, 1), config, integrator, stochastic, 6)


@pytest.mark.parametrize("config,integrator,stochastic", [
    ("edm", "karras", False), ("ve", None, True), ("vp", "dpmpp2m", False)])
def test_stochastic_sampling_matches_jax_3d_flash(monkeypatch, config,
                                                  integrator, stochastic):
    """A 3D PUNetG whose bottleneck runs flash attention (the port's
    FlashAttention with its plain version here; the JAX package's Pallas
    kernel in interpret mode), 3 steps."""
    monkeypatch.setattr(jfa, "INTERPRET", True)
    _sample_case(_SMALL_3D, (1, 32, 32, 32, 1), config, integrator,
                 stochastic, 3)


def test_sample_draws_x_then_noise_and_langevin_scale():
    """``sample`` draws x_T, then the loop's [n, B, ...] noise, from its
    generator: the same as propagate_white_noise on those draws. A
    langevin_scale γ equals langevin_const = γ."""
    _, _, model = _pair(_SMALL, (2, 16, 16, 1))
    shape = (16, 16, 1)
    out = model.sample(2, shape, torch.Generator().manual_seed(3), nsteps=4,
                       stochastic=True, langevin_scale=0.5)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2,) + shape, generator=gen)
    noise = torch.randn((4, 2) + shape, generator=gen)
    model.config.noisescheduler.langevin_const = 0.5
    try:
        ref = model.propagate_white_noise(x, nsteps=4, stochastic=True,
                                          noise_seq=noise)
    finally:
        model.config.noisescheduler.langevin_const = 1.0
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    # a deterministic integrator draws x_T only
    out = model.sample(2, shape, torch.Generator().manual_seed(3), nsteps=4,
                       integrator="dpmpp2m")
    ref = model.propagate_white_noise(
        torch.randn((2,) + shape, generator=torch.Generator().manual_seed(3)),
        nsteps=4, integrator="dpmpp2m")
    assert torch.equal(out, ref)
    # chunks draw in turn from one generator
    out = model.sample(3, shape, torch.Generator().manual_seed(3), nsteps=4,
                       integrator="karras", maximum_batch_size=2)
    gen = torch.Generator().manual_seed(3)
    ref = torch.cat([model.sample(n, shape, gen, nsteps=4,
                                  integrator="karras") for n in (2, 1)])
    assert torch.equal(out, ref)


def test_sample_restart_matches_jax(monkeypatch):
    """Restart sampling through the model: x_T, then the jumps' draws,
    replayed into the JAX package's ``jax.random.normal``."""
    jmodel, variables, model = _pair(_SMALL, (2, 16, 16, 1))
    shape, restarts = (16, 16, 1), ((0.05, 2.0, 2),)
    out = model.sample_restart(2, shape, torch.Generator().manual_seed(4),
                               nsteps=8, restarts=restarts)
    gen = torch.Generator().manual_seed(4)
    rows = iter([torch.randn((2,) + shape, generator=gen).numpy()]
                + list(torch.randn((2, 2) + shape, generator=gen).numpy()))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(next(rows), dtype))
    ref = jmodel.sample_restart(variables, jax.random.PRNGKey(0), 2, shape,
                                nsteps=8, restarts=restarts)
    assert next(rows, None) is None
    _assert_trajectory_close(out, ref)


def test_partial_propagation_and_toward_noise_match_jax():
    """propagate_partial_toward_sample with an analytic score blended in,
    and the stochastic forward pass propagate_toward_noise (its draws
    replayed into the JAX scheduler's noise_seq hook)."""
    jmodel, variables, model = _pair(_SMALL, (2, 16, 16, 1))
    x = _rng(5, (2, 16, 16, 1)) * 5.0

    def interp(sigma):
        return 1.0 / (1.0 + sigma)

    def analytic(z, sigma):
        return -z / (1.0 + sigma.reshape(-1, 1, 1, 1) ** 2)

    ours = model.propagate_partial_toward_sample(
        torch.from_numpy(x), 3, 7, nsteps=10, record_history=True,
        analytical_score=analytic, interp_fn=interp)
    ref = jmodel.propagate_partial_toward_sample(
        variables, jax.random.PRNGKey(0), jnp.asarray(x), 3, 7, nsteps=10,
        record_history=True, analytical_score=analytic, interp_fn=interp)
    _assert_trajectory_close(ours, ref, history=True)

    x = _rng(6, (2, 16, 16, 1))
    ours = model.propagate_toward_noise(
        torch.from_numpy(x), nsteps=8, record_history=True,
        stochastic_integration=True,
        generator=torch.Generator().manual_seed(6))
    noise = torch.randn((7, 2, 16, 16, 1),
                        generator=torch.Generator().manual_seed(6))

    def jscore(xx, sigma):
        return jmodel.get_score(variables, xx, sigma)

    ref = jmodel.config.noisescheduler.propagate_forward(
        jax.random.PRNGKey(0), jnp.asarray(x), jscore, nsteps=8,
        record_history=True, stochastic=True,
        noise_seq=jnp.asarray(noise.numpy()))
    _assert_trajectory_close(ours, ref, history=True)


@pytest.mark.parametrize("mode", ["inpaint", "repaint"])
def test_inpaint_and_repaint_match_jax(mode):
    """The model's inpaint/repaint against the JAX package's scheduler
    loops on the same draws (x_T, then the forward pass's 7 noisy steps
    followed by RePaint's re-noise jumps, replayed into ``noise_seq`` and
    ``renoise_noises``), with the JAX model's score. The known region of
    the last state is the clean original."""
    jmodel, variables, model = _pair(_SMALL, (2, 16, 16, 1))
    x_orig = _rng(7, (2, 16, 16, 1))
    mask = (np.random.default_rng(8).random((16, 16, 1)) < 0.5).astype(
        np.float32)
    nsteps, rsteps, nresamples = 8, 4, 2
    ours = model.inpaint(torch.from_numpy(x_orig), torch.from_numpy(mask),
                         nsteps=nsteps, mode=mode, rsteps=rsteps,
                         nresamples=nresamples,
                         generator=torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    x_t = torch.randn(x_orig.shape, generator=gen).numpy()
    n_ren = nresamples * (nsteps // rsteps - 1) if mode == "repaint" else 0
    draws = torch.randn((nsteps - 1 + n_ren,) + x_orig.shape,
                        generator=gen).numpy()
    sched = jmodel.config.noisescheduler

    def jscore(xx, sigma):
        return jmodel.get_score(variables, xx, sigma)

    key = jax.random.PRNGKey(0)
    y_noised = sched.propagate_forward(
        key, jnp.asarray(x_orig), jscore, nsteps, record_history=True,
        stochastic=True, noise_seq=jnp.asarray(draws[:nsteps - 1]))[::-1]
    noise = jnp.asarray(x_t) * sched.maximum_scale
    if mode == "inpaint":
        ref = sched.inpaint(key, noise, y_noised, jnp.asarray(mask), jscore,
                            nsteps)
    else:
        ref = sched.repaint(key, noise, y_noised, jnp.asarray(mask), jscore,
                            nsteps, rsteps, nresamples,
                            renoise_noises=jnp.asarray(draws[nsteps - 1:]))
    _assert_trajectory_close(ours, ref)
    if mode == "inpaint":   # the last splice puts the clean original back
        known = np.broadcast_to(mask.astype(bool), ours.shape)
        np.testing.assert_array_equal(ours.numpy()[known], x_orig[known])
    # chunks: each chunk of maximum_batch_size runs on its own draws
    chunked = model.inpaint(torch.from_numpy(x_orig), torch.from_numpy(mask),
                            nsteps=nsteps, mode=mode, rsteps=rsteps,
                            nresamples=nresamples, maximum_batch_size=1,
                            generator=torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    parts = [model.inpaint(torch.from_numpy(x_orig[i:i + 1]),
                           torch.from_numpy(mask), nsteps=nsteps, mode=mode,
                           rsteps=rsteps, nresamples=nresamples,
                           generator=gen) for i in range(2)]
    assert torch.equal(chunked, torch.cat(parts))


# ---------------------------------------------------------------------------
# training under VP and VE
# ---------------------------------------------------------------------------
def _vp_sigma(seed, n):
    """σ of the VP noise sampler from numpy uniforms."""
    u = np.random.default_rng(seed).random(n).astype(np.float32)
    t = u * (1.0 - 1e-5) + 1e-5
    return np.asarray(jops.VPSchedulingFunctions().noise(jnp.asarray(t)))


@pytest.mark.parametrize("config", ["vp", "ve", "sr3"])
def test_loss_fn_and_grads_match_jax(config):
    """loss_fn with replayed σ and ε: the configuration's preconditioner
    (VP's c_noise = 999·σ⁻¹(σ)) and λ(σ) reach the loss; loss within rtol
    1e-5, every gradient within 1e-4 of the largest entry."""
    x_shape = (3, 16, 16, 1)
    jmodel, variables, model = _pair(_SMALL, x_shape, config)
    x, eps = _rng(10, x_shape), _rng(11, x_shape)
    sigma = _vp_sigma(12, 3) if config == "vp" else np.asarray(
        [0.03, 1.5, 40.0], np.float32)

    def jloss(params):
        return jmodel.loss_fn({**variables, "params": params},
                              jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(sigma), eps=jnp.asarray(eps))[0]

    ref, jgrads = jax.value_and_grad(jloss)(variables["params"])
    loss = model.loss_fn(torch.from_numpy(x), torch.from_numpy(sigma),
                         eps=torch.from_numpy(eps))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    ref_grads = _state_dict_of({**variables, "params": jgrads})
    scale = max(float(g.abs().max()) for g in ref_grads.values())
    for name, p in model.net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)


def test_vp_train_step_trajectory_matches_jax():
    """5 f32 steps of make_train_step under from_vp from one JAX init, σ
    (the VP sampler's) and ε replayed per step: the tolerances of the EDM
    trajectory test (loss rtol 1e-5, grad_norm 1e-4; parameters and EMA
    99.9 % within 0.01·lr, every entry within 2·k·lr after k steps)."""
    x_shape = (4, 16, 16, 1)
    lr = 1e-3
    jmodel, _, _ = _pair(_SMALL, x_shape, "vp")
    jtracker = JEMATracker(ema_type="power", power_function_stds=[0.05])
    jstate, jtx = jcreate_train_state(jmodel, jax.random.PRNGKey(0), x_shape,
                                      ema=jtracker)

    def jloss(variables, key, x, y, replay, train=True):
        return jmodel.loss_fn(variables, key, x, replay["sigma"], train=train,
                              eps=replay["eps"])

    jstep = jmake_train_step(jmodel, jtx, ema=jtracker, loss_fn=jloss)
    model = KarrasModel(PUNetG(PUNetGConfig(
        **_SMALL, time_projection_scale=0.03), device="cpu"),
        KarrasModelConfig.from_vp(), device="cpu")
    model.net.load_state_dict(_state_dict_of(jstate.variables()), strict=True)
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05])
    state, tx = create_train_state(model, x_shape, seed=None,
                                   optimizer=default_optimizer(lr),
                                   ema=tracker)
    step = make_train_step(model, tx, ema=tracker)
    x = _rng(0, x_shape)
    for k in range(1, 6):
        sigma, eps = _vp_sigma(20 + k, 4), _rng(30 + k, x_shape)
        jstate, jmet = jstep(jstate, jax.random.PRNGKey(k), jnp.asarray(x),
                             None, {"sigma": jnp.asarray(sigma),
                                    "eps": jnp.asarray(eps)})
        state, met = step(state, torch.from_numpy(x),
                          sigma=torch.from_numpy(sigma),
                          eps=torch.from_numpy(eps))
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


@pytest.mark.parametrize("config", ["vp", "ve"])
def test_train_and_eval_steps_draw_their_sigma(config):
    """Without replayed draws the train step draws σ with the
    configuration's sampler (the VP sampler's σ(t) of a uniform t, VE's
    log-uniform σ) from the generator, then ε: the same as replaying those
    draws. The eval step takes the same σ."""
    x_shape = (2, 16, 16, 1)
    x = torch.from_numpy(_rng(13, x_shape))
    runs = []
    for replay in (False, True):
        model = KarrasModel(PUNetG(PUNetGConfig(**_SMALL), device="cpu"),
                            _config(config, True), device="cpu")
        state, tx = create_train_state(model, x_shape, seed=1)
        step = make_train_step(model, tx)
        gen = torch.Generator().manual_seed(14)
        kw = {}
        if replay:
            kw = dict(sigma=model.config.noisesampler.sample((2,), gen),
                      eps=torch.randn(x_shape, generator=gen))
        _, met = step(state, x, generator=gen, **kw)
        runs.append(float(met["train_loss"]))
    assert np.isfinite(runs).all() and runs[0] == runs[1]
    ev = make_eval_step(model)(state, x, sigma=torch.tensor([0.5, 2.0]),
                               eps=torch.zeros(x_shape))
    assert np.isfinite(float(ev["valid_loss"]))


# ---------------------------------------------------------------------------
# stochastic serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs", [{"integrator": "karras"},
                                    {"stochastic": True},
                                    {"stochastic": True,
                                     "langevin_scale": 0.3}])
def test_service_sample_kwargs_same_seed_same_samples(kwargs):
    """SamplerService(sample_kwargs=...) serves model.sample with those
    kwargs: a request within a bucket is the bucket's sample from the
    request's seed (padding rows dropped), a request of 6 is two bucket-4
    chunks drawn in turn, and one seed gives the same samples twice."""
    model = KarrasModel(PUNetG(PUNetGConfig(**dict(_SMALL, model_channels=4)),
                               device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.init(seed=3)
    svc = SamplerService(model, (8, 8, 1), batch_buckets=(1, 4), nsteps=3,
                         sample_kwargs=kwargs, device="cpu")
    svc.warmup()
    out = svc.sample(3, generator=5)
    ref = model.sample(4, (8, 8, 1), torch.Generator().manual_seed(5),
                       nsteps=3, **kwargs)
    np.testing.assert_array_equal(out, ref[:3].numpy())
    chunked = svc.sample(6, generator=6)
    gen = torch.Generator().manual_seed(6)
    ref = torch.cat([model.sample(4, (8, 8, 1), gen, nsteps=3, **kwargs)
                     for _ in range(2)])[:6]
    np.testing.assert_array_equal(chunked, ref.numpy())
    np.testing.assert_array_equal(chunked, svc.sample(6, generator=6))
    assert not np.array_equal(chunked, svc.sample(6, generator=7))
    assert np.isfinite(chunked).all()


# ---------------------------------------------------------------------------
# toy oracles
# ---------------------------------------------------------------------------
def _datasets(lib):
    return {
        "point": lib.SinglePointDataset(8, [1.0, -2.0]),
        "zero": lib.ZeroDataset(8, (3,)),
        "gaussian": lib.SingleGaussianDataset(8, [0.5, 1.0], scale=0.7),
        "zero_gaussian": lib.ZeroMeanGaussianDataset(8, (2,), scale=2.0),
        "points": lib.MixtureOfPointsDataset(
            8, [[0.0, 1.0], [2.0, -1.0], [-3.0, 0.5]], [1.0, 2.0, 1.0]),
        "mog": lib.MixtureOfGaussiansDataset(
            8, [[-2.0, 0.0], [2.0, 1.0]], [0.3, 0.7], scale=[0.5, 0.8]),
        "diag": lib.DiagonalGaussianDataset(8, [0.0, 1.0], [0.5, 2.0]),
        "uniform": lib.Single1DUniformDataset(8, -1.0, 2.0),
        "uniforms": lib.MixtureOf1DUniformsDataset(
            8, [[-3.0, -1.0], [0.0, 0.5]], [1.0, 3.0]),
    }


@pytest.mark.parametrize("name", ["point", "zero", "gaussian",
                                  "zero_gaussian", "points", "mog", "diag",
                                  "uniform", "uniforms"])
def test_toy_oracles_match_jax(name):
    ds, jds = _datasets(data)[name], _datasets(jdata)[name]
    x = _rng(15, (6,) + ds.shape) * 2.0
    sigma = np.asarray([0.05, 0.2, 0.5, 1.0, 3.0, 10.0], np.float32)
    xt, st = torch.from_numpy(x), torch.from_numpy(sigma)
    for fn in ("logprob", "gradlogprob", "denoiser",
               "optimal_denoiser_predictor", "optimal_noise_predictor"):
        ours = getattr(ds, fn)(xt, st).numpy()
        ref = np.asarray(getattr(jds, fn)(jnp.asarray(x), jnp.asarray(sigma)))
        assert ours.shape == ref.shape, fn
        # where the density underflows the stabiliser 1e-40, a float32
        # subnormal, is flushed to zero by XLA (log -inf, score 0/0 NaN)
        # and kept by torch (log(1e-40) = -92.1, score 0)
        flushed = ~np.isfinite(ref)
        assert np.isfinite(ours).all(), fn
        if fn == "logprob":
            np.testing.assert_allclose(ours[flushed],
                                       np.log(np.float32(1e-40)), rtol=1e-6)
        np.testing.assert_allclose(ours[~flushed], ref[~flushed], rtol=1e-4,
                                   atol=1e-5, err_msg=f"{name} {fn}")
    drawn = ds.sample(torch.Generator().manual_seed(0))
    assert tuple(drawn.shape) == (8,) + ds.shape
    assert bool(torch.isfinite(drawn).all())


@pytest.mark.parametrize("mode", ["paper_replica", "geometry_test"])
def test_shapes_dataset_matches_jax(mode):
    ours = data.ShapesDataset(5, size=32, mode=mode, seed=3)
    ref = jdata.ShapesDataset(5, size=32, mode=mode, seed=3)
    for a, b in zip(ours.generate_labeled(), ref.generate_labeled()):
        np.testing.assert_array_equal(a, b)
    assert tuple(ours.sample().shape) == (5, 32, 32, 1)


@pytest.mark.parametrize("arm", ["churn18", "em200"])
def test_mixture_of_gaussians_statistics(arm):
    """The verify recipe's analytic check: 18-step churn and 200-step EM
    with MixtureOfGaussiansDataset's exact score sample 4000 points from
    two modes at (∓2, ∓2), std 0.4, weights 0.3/0.7. Bounds: mode shares
    within 0.03 (~4σ of the sampling error at 4000 points); EM-200 mode
    means within 0.06 and in-mode std within 10 %; churn at 18 steps
    carries its own discretisation bias, which the JAX package's churn
    shows too (mode means 2.03-2.10 from the origin and std 0.44-0.45 over
    three seeds), so its means are held within 0.12 and its std within
    20 %."""
    means = np.asarray([[-2.0, -2.0], [2.0, 2.0]], np.float32)
    ds = data.MixtureOfGaussiansDataset(4000, means, [0.3, 0.7], scale=0.4)
    sched = ops.EDMScheduler()
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((4000, 2), generator=gen) * sched.maximum_scale
    if arm == "churn18":
        out = sched.propagate_backward(x, ds.gradlogprob, nsteps=18,
                                       integrator="karras", generator=gen)
        mean_tol, std_tol = 0.12, 0.20
    else:
        out = sched.propagate_backward(x, ds.gradlogprob, nsteps=200,
                                       stochastic=True, generator=gen)
        mean_tol, std_tol = 0.06, 0.10
    assert bool(torch.isfinite(out).all())
    mode = (out.sum(dim=1) > 0).long()
    share = float(mode.float().mean())
    assert abs(share - 0.7) <= 0.03, share
    for k in (0, 1):
        pts = out[mode == k]
        np.testing.assert_allclose(pts.mean(dim=0).numpy(), means[k],
                                   atol=mean_tol)
        std = pts.std(dim=0).numpy()
        assert np.all(np.abs(std / 0.4 - 1.0) <= std_tol), std
