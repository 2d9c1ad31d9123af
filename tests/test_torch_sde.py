"""The port's SDE stack (``diffsci_tpu_torch/models/sde.py``) against the
reference fixtures and the JAX package.

- ``sde_tables.npz``: mean, std², drift and diffusion of VP constant,
  VP linear and VE-sqrt; ``sde_pf.npz``: the Euler and Heun
  probability-flow samplers from a shared start; ``sde_loss.npz``: four
  losses with the reference's MLP state dicts loaded by name; all at
  ``tests/test_reference_parity4.py``'s bounds;
- live against JAX: every scheduler's functions (subVP, VE and the custom
  VP too), the probability-flow sampler around an MLP, and one
  ``make_train_step`` step of an ``SDEModel`` against the JAX package's
  step with the SDE loss;
- port-only (the JAX sampler has no replay hook): the Euler–Maruyama
  ``sde_sampler`` against a float64 numpy loop over the same draws, and
  ``SDEModel.sample`` against ``sde_sampler`` on the same draws.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu.models import MLPUncond as JMLPUncond
from diffsci_tpu.models import sde as jsde
from diffsci_tpu.models.karras import train as jtrain

from diffsci_tpu_torch import SDEModel, create_train_state, make_train_step
from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.models import sde
from diffsci_tpu_torch.models.nets import MLPCond, MLPUncond
from diffsci_tpu_torch.utils import bcast_right
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _schedulers(module):
    return {"vp_const": module.VPSchedulerConstant(coef=4.0),
            "vp_linear": module.VPSchedulerLinear(coef=16.0),
            "ve_sqrt": module.VESchedulerSqrt()}


@pytest.mark.parametrize("name", ["vp_const", "vp_linear", "ve_sqrt"])
def test_scheduler_tables_fixture(name):
    """mean, std², drift and diffusion over the fixture's t grid (rtol
    1e-5, atol 1e-7)."""
    d = np.load(os.path.join(FIXDIR, "sde_tables.npz"))
    sched = _schedulers(sde)[name]
    t, x = _t(d["t"]), _t(d["x"])
    for fn, args in (("mean", (t, x)), ("std2_", (t,)),
                     ("drift_term", (t, x)), ("diffusion_term", (t,))):
        key = {"std2_": "std2", "drift_term": "drift",
               "diffusion_term": "diffusion"}.get(fn, fn)
        np.testing.assert_allclose(getattr(sched, fn)(*args).numpy(),
                                   d[f"{name}_{key}"], rtol=1e-5, atol=1e-7,
                                   err_msg=fn)


_ALL = {"vp_const": lambda m: m.VPSchedulerConstant(coef=3.0),
        "vp_linear": lambda m: m.VPSchedulerLinear(coef=19.9),
        "vp_custom": lambda m: m.VPSchedulerCustom(
            beta=lambda t: 0.1 + 9.9 * t ** 2,
            betaint=lambda t: 0.1 * t + 3.3 * t ** 3),
        "subvp": lambda m: m.SubVPScheduler(coef=19.9),
        "ve": lambda m: m.VEScheduler(sigma_min=0.01, sigma_max=50.0),
        "ve_sqrt": lambda m: m.VESchedulerSqrt()}


@pytest.mark.parametrize("name", sorted(_ALL))
def test_scheduler_functions_match_jax(name):
    """Every scheduler's mean, std, drift and diffusion against the JAX
    package's on t ∈ [1e-5, 1] (rtol 1e-5, atol 1e-7), and the training
    time draw within [Tmin, T)."""
    ours, ref = _ALL[name](sde), _ALL[name](jsde)
    t = np.linspace(1e-5, 1.0, 33).astype(np.float32)
    x = np.random.default_rng(0).standard_normal((33, 4)).astype(np.float32)
    for fn, args in (("mean", (t, x)), ("std", (t,)),
                     ("drift_term", (t, x)), ("diffusion_term", (t,))):
        np.testing.assert_allclose(
            getattr(ours, fn)(*map(_t, args)).numpy(),
            np.asarray(getattr(ref, fn)(*map(jnp.asarray, args))),
            rtol=1e-5, atol=1e-7, err_msg=fn)
    draw = ours.sample((4096,), torch.Generator().manual_seed(0))
    assert ours.Tmin <= float(draw.min()) and float(draw.max()) < ours.T


def _analytic(sched):
    """The fixture generator's analytic score in the noise-prediction
    convention: ε̂ = −score·std."""
    def predictor(x, t, y=None, train=False):
        score = -x / (1.0 + bcast_right(t, x)) + 0.3 * torch.tanh(x)
        return -score * bcast_right(sched.std(t), x)
    return predictor


@pytest.mark.parametrize("method", ["euler", "heun"])
def test_pf_sampler_fixture(method):
    """The probability-flow sampler from the fixture's start (rtol 5e-4,
    atol 1e-5)."""
    d = np.load(os.path.join(FIXDIR, "sde_pf.npz"))
    sched = sde.VPSchedulerLinear(coef=16.0)
    out = sde.pf_sampler(sched, _analytic(sched), 4, (3,),
                         nsteps=int(d["nsteps"]), method=method,
                         x0=_t(d["x0"]))
    np.testing.assert_allclose(out.numpy(), d[f"pf_{method}_final"],
                               rtol=5e-4, atol=1e-5)


LOSS_CASES = {"vp_mse": ("vp_linear", "mse", 1.0, False),
              "ve_mse": ("ve_sqrt", "mse", 1.0, False),
              "vp_huber": ("vp_linear", "huber", 1.0, False),
              "vp_mse_scaled_cond": ("vp_linear", "mse", 2.5, True)}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_sde_loss_fixture(case):
    """sde_loss_fn with the reference's score MLP (ε̂ = −std·score), batch,
    t and replayed noise (rtol 5e-4, atol 1e-7)."""
    d = np.load(os.path.join(FIXDIR, "sde_loss.npz"))
    sched_name, metric, scale, conditional = LOSS_CASES[case]
    sched = _schedulers(sde)[sched_name]
    prefix = "csd__" if conditional else "usd__"
    net = (MLPCond(3, 2, hidden_dims=(16, 16), device="cpu") if conditional
           else MLPUncond(3, hidden_dims=(16, 16), device="cpu"))
    net.load_state_dict({k[5:]: torch.from_numpy(d[k]) for k in d.files
                         if k.startswith(prefix)}, strict=True)

    def predictor(x, t, y=None, train=False):
        score = net(x, t, y) if conditional else net(x, t)
        return -score * bcast_right(sched.std(t), x)

    with torch.no_grad():
        loss = sde.sde_loss_fn(sched, predictor, _t(d["x"]),
                               _t(d["y"]) if conditional else None,
                               train=False, loss_metric=metric,
                               loss_scale_factor=scale, t=_t(d["t"]),
                               eps=_t(d["eps"]))
    np.testing.assert_allclose(float(loss), float(d[f"loss_{case}"]),
                               rtol=5e-4, atol=1e-7)


def _mlp_pair(sched_fn, dim=3):
    jnet = JMLPUncond(dim=dim, hidden_dims=(16, 16))
    variables = jnet.init(jax.random.PRNGKey(0), jnp.zeros((2, dim)),
                          jnp.ones((2,)))
    jmodel = jsde.SDEModel(jnet, sched_fn(jsde))
    model = SDEModel(MLPUncond(dim, (16, 16), device="cpu"), sched_fn(sde),
                     device="cpu")
    model.net.model.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables)), strict=True)
    return jmodel, variables, model


def test_pf_sampler_mlp_matches_jax():
    """``SDEModel.sample(probability_flow=True)``'s loop (Heun, 20 steps)
    around an MLP from a given start against the JAX package's
    ``pf_sampler`` (rtol 1e-4, atol 1e-5)."""
    jmodel, variables, model = _mlp_pair(_ALL["vp_linear"])
    x0 = np.random.default_rng(2).standard_normal((4, 3)).astype(np.float32)
    ref = jsde.pf_sampler(jmodel.scheduler, jmodel.noise_predictor,
                          variables, jax.random.PRNGKey(0), 4, (3,),
                          nsteps=20, x0=jnp.asarray(x0))
    with torch.no_grad():
        ours = sde.pf_sampler(model.scheduler, model.noise_predictor, 4,
                              (3,), nsteps=20, x0=_t(x0))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_em_sampler_equals_float64_loop():
    """``sde_sampler`` with replayed draws against the same Euler–Maruyama
    recursion in float64 numpy (VP linear, the analytic score, 50 steps):
    within 1e-4 of the state's scale."""
    sched = sde.VPSchedulerLinear(coef=16.0)
    rng = np.random.default_rng(5)
    x_T = rng.standard_normal((4, 3))
    noise = rng.standard_normal((50, 4, 3))
    out = sde.sde_sampler(sched, _analytic(sched), 4, (3,), nsteps=50,
                          noise_seq=_t(noise), x_T=_t(x_T))
    ts = np.linspace(sched.T, sched.Tmin, 51)
    x = x_T.copy()
    for i, (t, dt) in enumerate(zip(ts[:-1], np.diff(ts))):
        beta, betaint = 16.0 * t, 8.0 * t ** 2
        std = np.sqrt(-np.expm1(-betaint) + 1e-8)
        score = -x / (1.0 + t) + 0.3 * np.tanh(x)
        drift = -0.5 * beta * x - beta * score
        x = x + drift * dt + np.sqrt(beta) * noise[i] * np.sqrt(-dt)
        assert np.isfinite(std)
    np.testing.assert_allclose(out.numpy(), x, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(x).max()))


@pytest.mark.parametrize("probability_flow", [False, True])
def test_sde_model_sample_is_the_sampler(probability_flow):
    """``SDEModel.sample`` draws x_T = std(T)·N(0, 1) and then the steps'
    noise from one generator, and runs the sampler's loop: bit for bit
    ``sde_sampler``/``pf_sampler`` on those draws."""
    _, _, model = _mlp_pair(_ALL["vp_linear"])
    out = model.sample(4, (3,), torch.Generator().manual_seed(1), nsteps=10,
                       probability_flow=probability_flow)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, 3), generator=g)
    x = model.scheduler.prior_scale(x) * x
    with torch.no_grad():
        if probability_flow:
            ref = sde.pf_sampler(model.scheduler, model.noise_predictor, 4,
                                 (3,), nsteps=10, x0=x)
        else:
            ref = sde.sde_sampler(model.scheduler, model.noise_predictor, 4,
                                  (3,), nsteps=10, generator=g, x_T=x)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_sde_train_step_matches_jax():
    """Two ``make_train_step`` steps of an ``SDEModel`` (the default AdamW
    with clip 0.5; the SDE loss with t in σ's slot and ε replayed) against
    the JAX package's ``make_train_step`` over ``SDEModel.loss_fn`` with
    the same t and ε: losses within 1e-5, parameters within PR 17's 2e-3
    relative bound."""
    jmodel, _, model = _mlp_pair(_ALL["vp_linear"])
    rng = np.random.default_rng(6)
    x = rng.standard_normal((16, 3)).astype(np.float32)
    ts = rng.uniform(1e-3, 1.0, (2, 16)).astype(np.float32)
    epss = rng.standard_normal((2, 16, 3)).astype(np.float32)
    jstate, jtx = jtrain.create_train_state(jmodel, jax.random.PRNGKey(0),
                                            (16, 3))
    model.net.model.load_state_dict(from_jax_variables(jax.tree.map(
        np.asarray, {"params": jstate.params})), strict=True)
    state, tx = create_train_state(model, (16, 3), seed=None)
    step = make_train_step(model, tx, loss_fn=lambda xx, t, y, mask, eps:
                           model.loss_fn(xx, y, t=t, eps=eps))
    @jax.jit
    def jstep(state, key, xx, t, eps):
        def loss_fn(v, k, xb, y, mask, train=True):
            return jmodel.loss_fn(v, k, xb, y, train, t=t, eps=eps), {}
        return jtrain.make_train_step(jmodel, jtx, loss_fn=loss_fn,
                                      _raw=True)(state, key, xx)

    for k in range(2):
        jstate, jmet = jstep(jstate, jax.random.PRNGKey(k), jnp.asarray(x),
                             ts[k], epss[k])
        _, met = step(state, _t(x), sigma=_t(ts[k]), eps=_t(epss[k]))
        np.testing.assert_allclose(float(met["train_loss"]),
                                   float(jmet["train_loss"]), rtol=1e-5)
    ref = from_jax_variables(jax.tree.map(np.asarray,
                                          {"params": jstate.params}))
    for k, v in model.net.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=2e-3,
                                   atol=2e-3 * float(ref[k].abs().max()),
                                   err_msg=k)
    draw = model.config.noisesampler.sample((8,),
                                            torch.Generator().manual_seed(0))
    assert 0.0 < float(draw.min()) and float(draw.max()) < 1.0
