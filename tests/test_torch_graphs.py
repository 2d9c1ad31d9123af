"""The JAX package's compiled execution as the port runs it, on the CPU:
``make_train_scan``, ``make_train_step(remat=True)``, the two learning-rate
schedules and the EMA cadence through them, held against the JAX package;
the draws a graphed step makes before its replay; and the launch
accounting of a capture.

On the CPU the entry points run their eager bodies, which the card's CUDA
graphs capture (``tests/test_torch_card.py`` holds graph against eager
there). Weights come from a JAX init through ``from_jax_variables``;
inputs, σ and ε are numpy arrays from a seed, replayed into both
packages. The tolerances are those of the 5-step trajectory test of
``tests/test_torch_training.py`` (stated where used).
"""

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
from diffsci_tpu.models import cosine_restarts_schedule as jcosine_restarts
from diffsci_tpu.models import create_train_state as jcreate_train_state
from diffsci_tpu.models import default_optimizer as jdefault_optimizer
from diffsci_tpu.models import make_train_scan as jmake_train_scan
from diffsci_tpu.models import make_train_step as jmake_train_step
from diffsci_tpu.models import warmup_cosine_schedule as jwarmup_cosine

from diffsci_tpu_torch import (EMATracker, KarrasModel, KarrasModelConfig,
                               PUNetG, PUNetGConfig, SamplerService,
                               cosine_restarts_schedule, create_train_state,
                               default_optimizer, kernels, make_train_scan,
                               make_train_step, warmup_cosine_schedule)
from diffsci_tpu_torch.convert import from_jax_variables
from tests import _torch_warmup  # noqa: F401  (MKL's first exp, CPU threads)

_SMALL = dict(model_channels=8, channel_expansion=(2,),
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1, num_heads=2)
_X_SHAPE = (4, 16, 16, 1)
_EMAS = {"power": dict(ema_type="power", power_function_stds=[0.05]),
         "traditional": dict(ema_type="traditional", decay=0.999,
                             halflife_steps=10.0, rampup_ratio=0.5)}


def _draws(k, seed=0):
    """x, and k replayed σ [k, B] and ε [k, *x] (the trajectory test's
    distributions)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(_X_SHAPE).astype(np.float32)
    sigmas = np.exp(rng.standard_normal((k, _X_SHAPE[0])) * 1.2 - 1.2) \
        .astype(np.float32)
    epss = rng.standard_normal((k,) + _X_SHAPE).astype(np.float32)
    return x, sigmas, epss


def _jloss(jmodel):
    """The JAX step's loss with σ and ε replayed through the slot of y
    (make_train_scan passes ys there) or of mask (make_train_step)."""
    def loss(variables, key, x, y, mask, train=True):
        replay = y if y is not None else mask
        return jmodel.loss_fn(variables, key, x, replay["sigma"],
                              train=train, eps=replay["eps"])
    return loss


def _pair(lr=1e-3, ema="power", update_every=1):
    """A JAX train state and the port's, on the same weights: (jmodel,
    jstate, jtx, jtracker), (model, state, tx, tracker)."""
    jmodel = JKarrasModel(JPUNetG(JPUNetGConfig(**_SMALL)),
                          JKarrasModelConfig.from_edm())
    jtracker = JEMATracker(update_every=update_every, **_EMAS[ema])
    jstate, jtx = jcreate_train_state(
        jmodel, jax.random.PRNGKey(0), _X_SHAPE, ema=jtracker,
        optimizer=jdefault_optimizer(lr[1] if isinstance(lr, tuple) else lr))
    model = KarrasModel(PUNetG(PUNetGConfig(**_SMALL), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.net.load_state_dict(
        from_jax_variables(jax.tree.map(np.asarray, jstate.variables())),
        strict=True)
    tracker = EMATracker(update_every=update_every, **_EMAS[ema])
    state, tx = create_train_state(
        model, _X_SHAPE, seed=None, ema=tracker,
        optimizer=default_optimizer(lr[0] if isinstance(lr, tuple) else lr))
    return (jmodel, jstate, jtx, jtracker), (model, state, tx, tracker)


def _assert_state_close(state, jstate, k, lr):
    """The trajectory test's bound on parameters and EMA shadows after k
    steps: AdamW moves an entry by ~±lr, so 99.9% of entries within
    0.01·lr and every entry within 2·k·lr."""
    jparams = from_jax_variables(jax.tree.map(np.asarray,
                                              jstate.variables()))
    for idx in range(len(state.ema.profiles)):
        jshadow = from_jax_variables(jax.tree.map(np.asarray, {
            **jstate.variables(), "params": jstate.ema.profiles[idx]}))
        for ours, theirs in ((state.params, jparams),
                             (state.ema.profiles[idx], jshadow)):
            diff = np.concatenate([(ours[n].detach() - theirs[n]).abs()
                                   .flatten().numpy() for n in ours])
            assert np.quantile(diff, 0.999) <= 0.01 * lr, k
            assert diff.max() <= 2 * k * lr, k
    assert state.ema.num_updates == int(jstate.ema.num_updates) == k


def _assert_metrics_close(met, jmet):
    """Loss rtol 1e-5 and grad_norm rtol 1e-4: f32 sums in another order,
    compounding over the steps."""
    np.testing.assert_allclose(np.asarray(met["train_loss"]),
                               np.asarray(jmet["train_loss"]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(met["grad_norm"]),
                               np.asarray(jmet["grad_norm"]), rtol=1e-4)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------
def test_remat_step_matches_jax():
    """3 f32 steps of make_train_step(remat=True) against the JAX
    package's (jax.checkpoint around the loss), power EMA, σ and ε
    replayed: loss, grad_norm, parameters and EMA at the trajectory
    test's tolerances."""
    (jmodel, jstate, jtx, jtracker), (model, state, tx, tracker) = _pair()
    jstep = jmake_train_step(jmodel, jtx, ema=jtracker,
                             loss_fn=_jloss(jmodel), remat=True)
    step = make_train_step(model, tx, ema=tracker, remat=True)
    x, sigmas, epss = _draws(3)
    for k in range(3):
        jstate, jmet = jstep(jstate, jax.random.PRNGKey(k), jnp.asarray(x),
                             None, {"sigma": jnp.asarray(sigmas[k]),
                                    "eps": jnp.asarray(epss[k])})
        state, met = step(state, torch.from_numpy(x),
                          sigma=torch.from_numpy(sigmas[k]),
                          eps=torch.from_numpy(epss[k]))
        _assert_metrics_close(met, jmet)
        _assert_state_close(state, jstate, k + 1, 1e-3)


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_remat_gives_the_same_gradients(compute_dtype):
    """remat runs the same forward again in the backward pass, so one
    step's loss, gradients and updated weights equal the plain step's bit
    for bit (f32 and bf16 compute)."""
    x, sigmas, epss = _draws(1, seed=3)
    out = {}
    for remat in (False, True):
        model = KarrasModel(PUNetG(PUNetGConfig(**_SMALL), device="cpu"),
                            KarrasModelConfig.from_edm(),
                            compute_dtype=compute_dtype, device="cpu")
        state, tx = create_train_state(model, _X_SHAPE, seed=5)
        state, met = make_train_step(model, tx, remat=remat)(
            state, torch.from_numpy(x), sigma=torch.from_numpy(sigmas[0]),
            eps=torch.from_numpy(epss[0]))
        out[remat] = (met, {n: (p.grad.clone(), p.detach().clone())
                            for n, p in state.params.items()})
    assert float(out[True][0]["train_loss"]) == \
        float(out[False][0]["train_loss"])
    assert float(out[True][0]["grad_norm"]) == \
        float(out[False][0]["grad_norm"])
    for name, (grad, weight) in out[False][1].items():
        assert torch.equal(out[True][1][name][0], grad), name
        assert torch.equal(out[True][1][name][1], weight), name


# ---------------------------------------------------------------------------
# make_train_scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("draws", ["replayed", "generator"])
def test_train_scan_equals_steps(draws):
    """make_train_scan at K = 3 is exactly 3 of make_train_step's steps:
    metrics, parameters, EMA shadows (power, every 2 steps) and counters
    bit for bit, with σ and ε replayed and with a generator (which pins
    the order of the draws: σ, then ε, step by step)."""
    x, sigmas, epss = _draws(3, seed=1)
    xs = torch.from_numpy(np.stack([x, 2 * x, -x]))
    runs = []
    for scan in (False, True):
        model = KarrasModel(PUNetG(PUNetGConfig(**_SMALL), device="cpu"),
                            KarrasModelConfig.from_edm(), device="cpu")
        tracker = EMATracker(update_every=2, **_EMAS["power"])
        state, tx = create_train_state(model, _X_SHAPE, seed=2, ema=tracker)
        gen = torch.Generator().manual_seed(11)
        replay = dict(sigmas=torch.from_numpy(sigmas),
                      epss=torch.from_numpy(epss)) \
            if draws == "replayed" else {}
        if scan:
            state, met = make_train_scan(model, tx, ema=tracker)(
                state, xs, generator=gen, **replay)
        else:
            step = make_train_step(model, tx, ema=tracker)
            mets = [step(state, xs[k], generator=gen,
                         sigma=replay.get("sigmas", [None] * 3)[k],
                         eps=replay.get("epss", [None] * 3)[k])[1]
                    for k in range(3)]
            met = {name: torch.stack([m[name] for m in mets])
                   for name in mets[0]}
        runs.append((met, state))
    (met0, s0), (met1, s1) = runs
    assert met1["train_loss"].shape == (3,)
    for name in met0:
        assert torch.equal(met0[name], met1[name]), name
    for name in s0.params:
        assert torch.equal(s0.params[name], s1.params[name]), name
        assert torch.equal(s0.ema.profiles[0][name],
                           s1.ema.profiles[0][name]), name
    assert s0.step == s1.step == 3
    assert s0.ema.num_updates == s1.ema.num_updates == 3


@pytest.mark.parametrize("ema", ["power", "traditional"])
def test_train_scan_matches_jax(ema):
    """make_train_scan at K = 3 against the JAX package's (one lax.scan),
    EMA every 2 steps (the power profile's telescoped decay, the
    traditional profile's product of per-step decays), σ and ε replayed
    (through ys on the JAX side): the stacked metrics, parameters and
    shadows at the trajectory test's tolerances."""
    (jmodel, jstate, jtx, jtracker), (model, state, tx, tracker) = \
        _pair(ema=ema, update_every=2)
    x, sigmas, epss = _draws(3, seed=4)
    xs = np.stack([x, 0.5 * x, x[::-1].copy()])
    jstate, jmet = jmake_train_scan(jmodel, jtx, ema=jtracker,
                                    loss_fn=_jloss(jmodel))(
        jstate, jax.random.split(jax.random.PRNGKey(0), 3), jnp.asarray(xs),
        {"sigma": jnp.asarray(sigmas), "eps": jnp.asarray(epss)})
    state, met = make_train_scan(model, tx, ema=tracker)(
        state, torch.from_numpy(xs), sigmas=torch.from_numpy(sigmas),
        epss=torch.from_numpy(epss))
    _assert_metrics_close(met, jmet)
    _assert_state_close(state, jstate, 3, 1e-3)
    assert state.step == int(jstate.step) == 3


# ---------------------------------------------------------------------------
# learning-rate schedules
# ---------------------------------------------------------------------------
_SCHEDULES = {
    "warmup_cosine": ((1e-3, 10, 100), {}),
    "warmup_cosine_end": ((2e-4, 25, 200), dict(end_factor=0.1)),
    "cosine_no_warmup": ((0.5, 0, 50), dict(end_factor=0.05)),
    "restarts": ((1e-3, 40), dict(n_restarts=3)),
    "restarts_end": ((0.5, 17), dict(n_restarts=10, end_factor=0.2)),
}


@pytest.mark.parametrize("case", list(_SCHEDULES))
def test_schedules_match_optax(case):
    """warmup_cosine_schedule and cosine_restarts_schedule against the JAX
    package's (optax's warmup_cosine_decay_schedule, sgdr_schedule) over
    the counts 0..299: rtol 1e-6 (optax computes in float32, the port in
    float64) plus 1e-7 of the peak where the rate crosses 0."""
    args, kw = _SCHEDULES[case]
    ours, theirs = ((warmup_cosine_schedule, jwarmup_cosine)
                    if case.startswith(("warmup", "cosine")) else
                    (cosine_restarts_schedule, jcosine_restarts))
    fn, jfn = ours(*args, **kw), theirs(*args, **kw)
    counts = np.arange(300)
    got = np.array([fn(int(c)) for c in counts])
    ref = np.array([float(jfn(jnp.asarray(c))) for c in counts])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7 * args[0])


def test_scheduled_trajectory_matches_jax():
    """5 f32 steps with default_optimizer(learning_rate=
    warmup_cosine_schedule(1e-3, 2, 10)) against the JAX package's: the
    rate reaches each update at optax's count (0 on the first: the
    weights do not move), power EMA; the trajectory test's tolerances
    with lr its peak."""
    sched = (warmup_cosine_schedule(1e-3, 2, 10), jwarmup_cosine(1e-3, 2, 10))
    (jmodel, jstate, jtx, jtracker), (model, state, tx, tracker) = \
        _pair(lr=sched)
    jstep = jmake_train_step(jmodel, jtx, ema=jtracker,
                             loss_fn=_jloss(jmodel))
    step = make_train_step(model, tx, ema=tracker)
    x, sigmas, epss = _draws(5, seed=6)
    start = {n: p.detach().clone() for n, p in state.params.items()}
    for k in range(5):
        jstate, jmet = jstep(jstate, jax.random.PRNGKey(k), jnp.asarray(x),
                             None, {"sigma": jnp.asarray(sigmas[k]),
                                    "eps": jnp.asarray(epss[k])})
        state, met = step(state, torch.from_numpy(x),
                          sigma=torch.from_numpy(sigmas[k]),
                          eps=torch.from_numpy(epss[k]))
        if k == 0:   # lr 0: only the weight decay's factor 1 - 0·wd
            for n, p in state.params.items():
                assert torch.equal(p.detach(), start[n]), n
        assert state.optimizer.param_groups[0]["lr"] == \
            pytest.approx(sched[0](k), rel=1e-12)
        _assert_metrics_close(met, jmet)
        _assert_state_close(state, jstate, k + 1, 1e-3)


# ---------------------------------------------------------------------------
# what a graphed step does around its replay, on the CPU
# ---------------------------------------------------------------------------
def test_draws_into_static_inputs_equal_fresh_draws():
    """A graphed step draws σ (the log-normal sampler, ``out=``) and then
    ε into its static inputs: the same numbers, in the same order, as
    fresh draws from the same generator."""
    sampler = KarrasModelConfig.from_edm().noisesampler
    gen = torch.Generator().manual_seed(8)
    sigma = sampler.sample((5,), gen)
    eps = torch.randn((5, 4, 4, 1), generator=gen)
    out = (torch.full((5,), float("nan")), torch.full((5, 4, 4, 1), 7.0))
    gen.manual_seed(8)
    got = sampler.sample((5,), gen, out=out[0])
    torch.randn((5, 4, 4, 1), generator=gen, out=out[1])
    assert got is out[0]
    assert torch.equal(out[0], sigma) and torch.equal(out[1], eps)
    gen.manual_seed(8)
    ref = torch.exp(torch.randn(5, generator=gen) * 1.2 - 1.2)
    assert torch.equal(sigma, ref)


def test_capture_counts_are_taken_back_and_replays_add_them():
    """A capture runs no kernel: counting_capture records the launches the
    body's wrappers counted and restores LAUNCHES; add_launches adds the
    record once per replay."""
    kernels.reset_launches()
    kernels.LAUNCHES["norm_silu"] = 3
    with kernels.counting_capture() as recorded:
        kernels.LAUNCHES["norm_silu"] += 20
        kernels.LAUNCHES["fused_axby"] += 1
    assert recorded == {"norm_silu": 20, "fused_axby": 1}
    assert kernels.LAUNCHES["norm_silu"] == 3
    assert kernels.LAUNCHES["fused_axby"] == 0
    for _ in range(2):
        kernels.add_launches(recorded)
    assert kernels.LAUNCHES["norm_silu"] == 43
    assert kernels.LAUNCHES["fused_axby"] == 2
    with pytest.raises(ValueError):
        with kernels.counting_capture():
            kernels.LAUNCHES["fused_axby"] += 5
            raise ValueError("a failed capture")
    assert kernels.LAUNCHES["fused_axby"] == 2
    kernels.reset_launches()


def test_cpu_entry_points_capture_nothing():
    """On the CPU nothing is captured: compile_sampler returns None, the
    service's warm-up draws no noise (its generator is untouched), and a
    train step keeps no graph."""
    model = KarrasModel(PUNetG(PUNetGConfig(**dict(_SMALL,
                                                   model_channels=4)),
                               device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.init(seed=0)
    assert model.compile_sampler(2, (8, 8, 1), nsteps=2) is None
    svc = SamplerService(model, (8, 8, 1), batch_buckets=(1, 2), nsteps=2,
                         seed=4, device="cpu")
    before = svc._generator.get_state()
    assert set(svc.warmup()) == {1, 2}
    assert torch.equal(svc._generator.get_state(), before)
    state, tx = create_train_state(model, (2, 8, 8, 1), seed=0)
    step = make_train_step(model, tx)
    step(state, torch.zeros(2, 8, 8, 1), generator=torch.Generator())
    assert state.graphs is None and state.step == 1


def test_cast_copy_follows_masters_changed():
    """The masters updated where their version counters do not move (what
    a replayed train-step graph does, here through ``.data``): the cast
    copy keeps its values until ``_masters_changed``, then its next use
    refreshes the same tensors in place, bit for bit the masters in bf16."""
    model = KarrasModel(PUNetG(PUNetGConfig(**dict(_SMALL,
                                                   model_channels=4)),
                               device="cpu"),
                        KarrasModelConfig.from_edm(),
                        compute_dtype=torch.bfloat16, device="cpu")
    model.init(seed=0)
    cast = model._inference_net()
    before = [p.clone() for p in cast.parameters()]
    with torch.no_grad():
        for p in model.net.parameters():
            p.data.add_(0.25)
    assert model._inference_net() is cast
    assert all(torch.equal(a, b) for a, b in zip(cast.parameters(), before))
    model._masters_changed()
    assert model._inference_net() is cast
    for c, m in zip(cast.parameters(), model.net.parameters()):
        assert torch.equal(c, m.detach().bfloat16())


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_sampler_graph_cache_follows_weight_tensors(compute_dtype):
    """The sampler's graph cache is kept while the tensors its graphs read
    stay (a load_state_dict, a refresh in place) and dropped, graphs and
    pool, when they are replaced, since a graph reads the tensors of its
    capture. A load_state_dict with ``assign=True`` replaces the masters:
    in f32 the graphs read those, in bf16 the cast copy, which keeps its
    tensors and takes the new values."""
    model = KarrasModel(PUNetG(PUNetGConfig(**dict(_SMALL,
                                                   model_channels=4)),
                               device="cpu"),
                        KarrasModelConfig.from_edm(),
                        compute_dtype=compute_dtype, device="cpu")
    model.init(seed=0)
    cache = model._graph_cache()
    sd = {k: v.clone() + 1 for k, v in model.net.state_dict().items()}
    model.net.load_state_dict(sd)
    model._masters_changed()
    assert model._graph_cache() is cache
    model.net.load_state_dict({k: v + 1 for k, v in sd.items()},
                              assign=True)
    if compute_dtype is None:
        assert model._graph_cache() is not cache
    else:
        assert model._graph_cache() is cache
        for c, m in zip(model._cast_net.parameters(),
                        model.net.parameters()):
            assert torch.equal(c, m.detach().bfloat16())
