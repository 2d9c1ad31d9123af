"""The port's diffusion math (``diffsci_tpu_torch/ops``) against the
reference fixtures and the JAX package.

Golden fixtures (``tests/fixtures/reference/math_golden.npz``,
``math_golden_scalars.json``, ``stochastic_golden.npz``) are held at the
JAX package's own tolerances, those of ``tests/test_reference_parity.py``:
math 2e-4 relative / 1e-6 absolute, with its per-quantity exceptions;
stochastic trajectories 2e-4 / 1e-5, the VP (scaled) branch 5e-4 / 1e-4,
RePaint 5e-4 / 1e-5. The live comparisons with the JAX package feed the
same float32 inputs (and the same replayed draws) to both and allow
rtol 1e-5 / atol 1e-5: both evaluate every per-step scalar in float32, so
they differ only by the order of float32 operations over 10-20 steps.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu import ops as jops

from diffsci_tpu_torch import ops
from diffsci_tpu_torch.ops import schedulers as schedulers_mod
from tests import _torch_warmup  # noqa: F401  (MKL's first exp, CPU threads)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")
LIVE = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def gold():
    return np.load(os.path.join(FIXDIR, "math_golden.npz"))


@pytest.fixture(scope="module")
def gold_scalars():
    with open(os.path.join(FIXDIR, "math_golden_scalars.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def stoch_gold():
    return np.load(os.path.join(FIXDIR, "stochastic_golden.npz"))


def _check(ours, ref, rtol=2e-4, atol=1e-6, label=""):
    if torch.is_tensor(ours):
        ours = ours.detach().numpy()
    np.testing.assert_allclose(np.asarray(ours, np.float64),
                               np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol, err_msg=label)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _unit_gaussian_score(z, sigma):
    return -z / (1.0 + sigma.reshape((-1,) + (1,) * (z.ndim - 1)) ** 2)


def _schedulers():
    return {"edm": ops.EDMScheduler(), "vp": ops.VPScheduler(),
            "ve": ops.VEScheduler()}


def _jschedulers():
    return {"edm": jops.EDMScheduler(), "vp": jops.VPScheduler(),
            "ve": jops.VEScheduler()}


# ---------------------------------------------------------------------------
# preconditioners, scheduling functions, grids, Langevin, loss weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["edm", "vp", "ve", "sr3", "null"])
def test_preconditioner_tables(gold, name):
    sigma = _t(gold["sigma_grid"])
    p = {"edm": ops.EDMPreconditioner(),
         "vp": ops.VPPreconditioner(scheduling=ops.VPSchedulingFunctions()),
         "ve": ops.VEPreconditioner(), "sr3": ops.SR3Preconditioner(),
         "null": ops.NullPreconditioner()}[name]
    c_skip, c_out, c_in, c_noise = p.coefficients(sigma)
    _check(c_skip, gold[f"prec_{name}_c_skip"], label=f"{name} c_skip")
    _check(c_out, gold[f"prec_{name}_c_out"], label=f"{name} c_out")
    _check(c_in, gold[f"prec_{name}_c_in"], label=f"{name} c_in")
    _check(c_noise, gold[f"prec_{name}_c_noise"], rtol=5e-4, atol=5e-5,
           label=f"{name} c_noise")


@pytest.mark.parametrize("name", ["edm", "vp", "ve"])
def test_scheduling_functions(gold, name):
    t = _t(gold["t_grid"])
    f = ops.name_to_scheduling_functions(name.upper())
    _check(f.scale(t), gold[f"sched_{name}_scale"], label="scale")
    _check(f.scale_deriv(t), gold[f"sched_{name}_scale_deriv"], atol=1e-5,
           label="scale_deriv")
    _check(f.noise(t), gold[f"sched_{name}_noise"], label="noise")
    _check(f.noise_deriv(t), gold[f"sched_{name}_noise_deriv"], rtol=5e-4,
           label="noise_deriv")
    _check(f.inverse_noise(f.noise(t)), gold[f"sched_{name}_inverse_noise"],
           rtol=5e-4, atol=1e-5, label="inverse_noise")
    if f"sched_{name}_pf_score_mult" in gold.files:
        _check(f.pf_score_multiplier(t), gold[f"sched_{name}_pf_score_mult"],
               label="pf_score_mult")
    if name == "vp":
        _check(f.pf_scale_multiplier(t), gold["sched_vp_pf_scale_mult"],
               label="pf_scale_mult")
    # the flags and descriptions are the JAX package's
    jf = jops.name_to_scheduling_functions(name.upper())
    assert (f.constant_scaling, f.identity_noise, f.has_pf_score_multiplier,
            f.has_pf_scale_multiplier) == (
        jf.constant_scaling, jf.identity_noise, jf.has_pf_score_multiplier,
        jf.has_pf_scale_multiplier)
    assert f.export_description() == jf.export_description()


@pytest.mark.parametrize("name", ["edm", "vp", "ve"])
@pytest.mark.parametrize("n", [6, 19, 51])
def test_scheduler_grids(gold, gold_scalars, name, n):
    s = _schedulers()[name]
    _check(s.create_steps(n), gold[f"grid_{name}_{n}"], rtol=5e-4, atol=1e-7,
           label=f"{name} grid n={n}")
    _check([s.maximum_scale], [gold_scalars[f"{name}_maximum_scale"]],
           rtol=1e-5, label=f"{name} maximum_scale")


def test_edm_step_from_time(gold):
    s = ops.EDMScheduler()
    grid = _t(s.create_steps(19)[:-1])
    np.testing.assert_array_equal(s.step_from_time(grid, 19).numpy(),
                                  gold["edm_step_from_time_19"])


@pytest.mark.parametrize("name", ["edm", "vp", "ve"])
def test_step_from_time_matches_jax(name):
    """The grid's own times, and times between grid points, to the nearest
    step (the JAX package's float32 evaluation and round-half-even)."""
    s, js = _schedulers()[name], _jschedulers()[name]
    n = 19
    grid = s.create_steps(n)
    grid = grid[grid > 0]
    mids = grid[:-1] ** 0.7 * grid[1:] ** 0.3     # no ties at half steps
    t = np.concatenate([grid, mids]).astype(np.float32)
    ours = s.step_from_time(torch.from_numpy(t), n)
    ref = np.asarray(js.step_from_time(jnp.asarray(t), n))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(s.step_from_time(t, n), ref)


@pytest.mark.parametrize("gamma", [0.01, 1.0, 3.0])
def test_langevin_edm(gold, gamma):
    t = _t(gold["t_grid"])
    s = ops.EDMScheduler(langevin_const=gamma)
    key = str(gamma).replace(".", "p")
    _check(s.langevin_factor(t), gold[f"langevin_edm_{key}"],
           label="langevin_factor")
    _check(s.noise_injection(t), gold[f"noiseinj_edm_{key}"],
           label="noise_injection")


def test_langevin_vp(gold):
    t = _t(gold["t_grid"])
    s = ops.VPScheduler()
    s.langevin_const = 2.0
    _check(s.langevin_factor(t), gold["langevin_vp_2p0"], rtol=5e-4,
           label="vp langevin_factor")


@pytest.mark.parametrize("name", ["edm", "vp", "ve", "uniform"])
def test_loss_weighting(gold, name):
    sigma = _t(gold["sigma_grid"])
    sampler = {"edm": ops.EDMNoiseSampler(),
               "vp": ops.VPNoiseSampler(
                   scheduling=ops.VPSchedulingFunctions()),
               "ve": ops.VENoiseSampler(),
               "uniform": ops.UniformNoiseSampler()}[name]
    _check(sampler.loss_weighting(sigma), gold[f"lw_{name}"],
           label=f"{name} lambda")


@pytest.mark.parametrize("name", ["vp", "ve", "uniform"])
def test_noise_sampler_draws(name):
    """One uniform draw of the generator, mapped as the JAX package maps its
    uniform draw (float32), both into a new tensor and into ``out``; every
    sigma inside the sampler's range."""
    vp_fns = ops.VPSchedulingFunctions()
    sampler = {"vp": ops.VPNoiseSampler(scheduling=vp_fns),
               "ve": ops.VENoiseSampler(),
               "uniform": ops.UniformNoiseSampler(t=0.1, T=3.0)}[name]
    jsampler = {"vp": jops.VPNoiseSampler(
        scheduling=jops.VPSchedulingFunctions()),
        "ve": jops.VENoiseSampler(),
        "uniform": jops.UniformNoiseSampler(t=0.1, T=3.0)}[name]
    sigma = sampler.sample((4096,), torch.Generator().manual_seed(0))
    u = torch.rand((4096,), generator=torch.Generator().manual_seed(0))
    out = torch.empty(4096)
    assert sampler.sample((4096,), torch.Generator().manual_seed(0),
                          out=out) is out
    assert torch.equal(out, sigma)
    # the JAX package's map from its uniform draw, on the same uniforms
    jax_map = {"vp": lambda v: jsampler.scheduling.noise(
        v * (1.0 - jsampler.epsilon) + jsampler.epsilon),
        "ve": lambda v: jnp.exp(jnp.log(jsampler.sigma_min) + v * (
            jnp.log(jsampler.sigma_max) - jnp.log(jsampler.sigma_min))),
        "uniform": lambda v: jsampler.t + v * (jsampler.T - jsampler.t)}
    # rtol 1e-5: VP's sqrt(exp(e) - 1) cancels near t = epsilon (e ~ 1e-4),
    # where one float32 step of exp moves sigma by ~1e-6 relative
    _check(sigma, np.asarray(jax_map[name](jnp.asarray(u.numpy()))),
           rtol=1e-5, atol=1e-7, label=f"{name} draw")
    lo, hi = {"vp": (float(vp_fns.noise(1e-3)), float(vp_fns.noise(1.0))),
              "ve": (0.02, 100.0), "uniform": (0.1, 3.0)}[name]
    assert lo * (1 - 1e-5) <= float(sigma.min()) <= float(sigma.max()) <= \
        hi * (1 + 1e-5)
    assert sampler.export_description() == jsampler.export_description()


# ---------------------------------------------------------------------------
# deterministic trajectories against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["edm", "vp", "ve"])
@pytest.mark.parametrize("integ", ["heun", "euler"])
def test_backward_trajectories(gold, name, integ):
    s = _schedulers()[name]
    x0 = _t(gold["traj_x0"]) * s.maximum_scale
    hist = s.propagate_backward(x0, _unit_gaussian_score, nsteps=18,
                                record_history=True,
                                integrator=None if integ == "heun" else integ)
    ref = gold[f"traj_{name}_{integ}_bwd"]
    assert tuple(hist.shape) == ref.shape
    _check(hist, ref, rtol=5e-4, atol=2e-5,
           label=f"{name} {integ} backward trajectory")


@pytest.mark.parametrize("name", ["edm", "vp", "ve"])
def test_forward_trajectories(gold, name):
    """Forward history row 0 is the clean state (the reference leaves a
    zeros row there), so rows 1: are compared."""
    s = _schedulers()[name]
    hist = s.propagate_forward(_t(gold["traj_x0"]), _unit_gaussian_score,
                               nsteps=18, record_history=True)
    _check(hist[1:], gold[f"traj_{name}_heun_fwd"], rtol=5e-4, atol=2e-5,
           label=f"{name} forward trajectory")


# ---------------------------------------------------------------------------
# stochastic loops with a replayed noise sequence, against the reference
# ---------------------------------------------------------------------------
def test_euler_maruyama_edm_backward(stoch_gold):
    sched = ops.EDMScheduler()
    x = _t(stoch_gold["x0"]) * sched.maximum_scale
    hist = sched.propagate_backward(x, _unit_gaussian_score, nsteps=18,
                                    stochastic=True, record_history=True,
                                    noise_seq=stoch_gold["noise_seq"])
    _check(hist, stoch_gold["em_edm_bwd"], rtol=2e-4, atol=1e-5,
           label="EM EDM backward")


def test_euler_maruyama_vp_backward(stoch_gold):
    """The scaled (non-constant scaling) branch of make_rhs."""
    sched = ops.VPScheduler()
    x = _t(stoch_gold["x0"]) * sched.maximum_scale
    hist = sched.propagate_backward(x, _unit_gaussian_score, nsteps=18,
                                    stochastic=True, record_history=True,
                                    noise_seq=stoch_gold["noise_seq"])
    _check(hist, stoch_gold["em_vp_bwd"], rtol=5e-4, atol=1e-4,
           label="EM VP backward")


def test_euler_maruyama_edm_forward(stoch_gold):
    """The sign-flipped Langevin drift of forward propagation; 17 noise
    rows for 18 steps (the first grid step is skipped)."""
    sched = ops.EDMScheduler()
    hist = sched.propagate_forward(_t(stoch_gold["x0"]), _unit_gaussian_score,
                                   nsteps=18, stochastic=True,
                                   record_history=True,
                                   noise_seq=stoch_gold["noise_seq"][:17])
    _check(hist[1:], stoch_gold["em_edm_fwd"][1:], rtol=2e-4, atol=1e-5,
           label="EM EDM forward")


def test_euler_maruyama_langevin_interval_gated(stoch_gold):
    sched = ops.EDMScheduler(langevin_const=3.0,
                             langevin_interval=(0.1, 10.0))
    x = _t(stoch_gold["x0"]) * sched.maximum_scale
    hist = sched.propagate_backward(x, _unit_gaussian_score, nsteps=18,
                                    stochastic=True, record_history=True,
                                    noise_seq=stoch_gold["noise_seq"])
    _check(hist, stoch_gold["em_edm_bwd_gated"], rtol=2e-4, atol=1e-5,
           label="EM gated")


def test_karras_churn_backward(stoch_gold):
    """Churn with the S_tmin/S_tmax window and the endpoint Euler step,
    which still takes its noise row (18 rows for 18 steps)."""
    sched = ops.EDMScheduler()
    integ = ops.KarrasIntegrator(scheduling=sched.scheduling)
    x = _t(stoch_gold["x0"]) * sched.maximum_scale
    hist = sched.propagate_backward(x, _unit_gaussian_score, nsteps=18,
                                    record_history=True, integrator=integ,
                                    noise_seq=stoch_gold["noise_seq"])
    _check(hist, stoch_gold["karras_churn_bwd"], rtol=2e-4, atol=1e-5,
           label="Karras churn")


def test_inpaint_trajectory(stoch_gold):
    """y_noised indexed by backward grid time; the reference's history row
    0 is the pre-splice state, so rows 1: are compared."""
    sched = ops.EDMScheduler()
    x = _t(stoch_gold["x0"]) * sched.maximum_scale
    hist = sched.inpaint(x, _t(stoch_gold["inpaint_y_ours"]),
                         _t(stoch_gold["inpaint_mask"]),
                         _unit_gaussian_score, nsteps=18,
                         record_history=True)
    _check(hist[1:], stoch_gold["inpaint_edm"][1:], rtol=2e-4, atol=1e-5,
           label="inpaint")


def test_repaint_final_state(stoch_gold):
    sched = ops.EDMScheduler()
    x = _t(stoch_gold["x0"]) * sched.maximum_scale
    out = sched.repaint(x, _t(stoch_gold["repaint_y_ours"]),
                        _t(stoch_gold["inpaint_mask"]), _unit_gaussian_score,
                        nsteps=12, rsteps=4, nresamples=2,
                        renoise_noises=_t(stoch_gold["repaint_renoise_seq"]))
    _check(out, stoch_gold["repaint_edm"], rtol=5e-4, atol=1e-5,
           label="repaint")


def test_stochastic_path_draws_before_its_loop():
    """Without noise_seq, propagate draws one [nsteps, *x.shape] tensor
    from the generator (after whatever the caller drew) and replays it:
    the same as passing that draw as noise_seq."""
    sched = ops.EDMScheduler()
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(1)) * 80.0
    out = sched.propagate_backward(x, _unit_gaussian_score, nsteps=6,
                                   stochastic=True,
                                   generator=torch.Generator().manual_seed(2))
    noise = torch.randn((6, 3, 5), generator=torch.Generator().manual_seed(2))
    ref = sched.propagate_backward(x, _unit_gaussian_score, nsteps=6,
                                   stochastic=True, noise_seq=noise)
    assert torch.equal(out, ref)
    assert sched.noise_steps(6, stochastic=True) == 6
    assert sched.noise_steps(6, stochastic=True, backward=False) == 5
    assert sched.noise_steps(6, integrator="karras") == 6
    assert sched.noise_steps(6, integrator="dpmpp2m") == 0
    assert sched.noise_steps(6) == 0


# ---------------------------------------------------------------------------
# live against the JAX package
# ---------------------------------------------------------------------------
def _x0(shape=(3, 4), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jscore(z, sigma):
    return -z / (1.0 + sigma.reshape((-1,) + (1,) * (z.ndim - 1)) ** 2)


@pytest.mark.parametrize("name", ["edm", "ve"])
def test_dpmpp2m_matches_jax(name):
    """DPM-Solver++(2M) on the EDM ρ-grid and the VE grid: its carry, the
    first-order first step and (EDM) the first-order step to σ = 0."""
    s, js = _schedulers()[name], _jschedulers()[name]
    x0 = _x0() * s.maximum_scale
    hist = s.propagate_backward(torch.from_numpy(x0), _unit_gaussian_score,
                                nsteps=12, record_history=True,
                                integrator="dpmpp2m")
    ref = js.propagate_backward(jax.random.PRNGKey(0), jnp.asarray(x0),
                                _jscore, nsteps=12, record_history=True,
                                integrator="dpmpp2m")
    _check(hist, np.asarray(ref), **LIVE, label=f"{name} dpmpp2m")


@pytest.mark.parametrize("name", ["edm", "vp", "ve"])
@pytest.mark.parametrize("integrator", ["heun", "euler-maruyama", "karras"])
def test_propagate_partial_matches_jax(name, integrator):
    """Steps 5 to 10 of a 16-step grid, where every churn step has γ > 0:
    at γ = 0 above S_tmax the JAX package's XLA fuses σ_noise² − σ² into
    an FMA and injects noise of std ~sqrt(ulp(σ²)) (~3e-3 at VE's
    t = 141), where the port, like a float64 evaluation, injects none."""
    s, js = _schedulers()[name], _jschedulers()[name]
    x0 = _x0() * 3.0
    noise = _x0((6, 3, 4), seed=1)
    hist = s.propagate_partial(torch.from_numpy(x0), _unit_gaussian_score,
                               nsteps=16, initial_step=5, final_step=11,
                               record_history=True, integrator=integrator,
                               noise_seq=noise)
    ref = js.propagate_partial(jax.random.PRNGKey(0), jnp.asarray(x0),
                               _jscore, nsteps=16, initial_step=5,
                               final_step=11, record_history=True,
                               integrator=integrator,
                               noise_seq=jnp.asarray(noise))
    assert tuple(hist.shape) == (7, 3, 4)
    _check(hist, np.asarray(ref), rtol=1e-5, atol=2e-5,
           label=f"{name} {integrator} partial")


@pytest.mark.parametrize("name", ["edm", "vp", "ve"])
def test_renoise_and_apply_noise_match_jax(name):
    s, js = _schedulers()[name], _jschedulers()[name]
    x, eps = _x0(), _x0(seed=2)
    t = s.create_steps(11)
    ours = s.renoise(torch.from_numpy(x), float(t[7]), float(t[3]),
                     noise=torch.from_numpy(eps))
    ref = js.renoise(jax.random.PRNGKey(0), jnp.asarray(x), float(t[7]),
                     float(t[3]), noise=jnp.asarray(eps))
    _check(ours, np.asarray(ref), **LIVE, label=f"{name} renoise")
    for step in (0, 4, 10):
        ours = s.apply_noise(torch.from_numpy(x), nsteps=10, step=step,
                             eps=eps)
        ref = js.apply_noise(jax.random.PRNGKey(0), jnp.asarray(x),
                             nsteps=10, step=step, eps=eps)
        _check(ours, np.asarray(ref), **LIVE,
               label=f"{name} apply_noise step {step}")
    with pytest.raises(ValueError):
        s.apply_noise(torch.from_numpy(x), nsteps=10, step=11, eps=eps)


@pytest.mark.parametrize("name,restarts", [
    ("edm", ((0.05, 2.0, 2),)),
    ("edm", ((0.3, 1.0, 1), (2.0, 10.0, 2))),
    ("vp", ((0.05, 0.5, 2),)),
    ("ve", ((0.5, 5.0, 2),)),
])
def test_restart_matches_jax(monkeypatch, name, restarts):
    """Restart sampling with its re-noise draws replayed on both sides: the
    port's draw helper and the JAX package's ``jax.random.normal`` both
    return the same rows, in jump order."""
    s, js = _schedulers()[name], _jschedulers()[name]
    x0 = _x0() * s.maximum_scale
    n_jumps = s.restart_jumps(restarts)
    jumps = _x0((n_jumps, 3, 4), seed=3)
    calls = []

    def port_draw(generator, n, like):
        calls.append(n)
        return torch.from_numpy(jumps).to(like.dtype)

    monkeypatch.setattr(schedulers_mod, "draw_noise", port_draw)
    ours = s.restart_propagate_backward(torch.from_numpy(x0),
                                        _unit_gaussian_score, nsteps=18,
                                        restarts=restarts)
    assert calls == [n_jumps]
    rows = iter(jumps)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(next(rows), dtype))
    ref = js.restart_propagate_backward(jax.random.PRNGKey(0),
                                        jnp.asarray(x0), _jscore, nsteps=18,
                                        restarts=restarts)
    assert next(rows, None) is None
    _check(ours, np.asarray(ref), rtol=1e-5, atol=2e-5,
           label=f"{name} restart {restarts}")


def test_restart_rejects_what_jax_rejects():
    s = ops.EDMScheduler()
    x = torch.zeros(1, 2)
    for restarts in (((2.0, 1.0, 1),), ((1.0, 1.01, 1),),
                     ((0.1, 5.0, 1), (1.0, 10.0, 1))):
        with pytest.raises(ValueError):
            s.restart_propagate_backward(x, _unit_gaussian_score, 18,
                                         restarts=restarts,
                                         generator=torch.Generator())


@pytest.mark.parametrize("name", ["edm", "vp", "ve"])
def test_langevin_scale_equals_langevin_const(name):
    """gate_scale = γ (a 0-d tensor, the graphed samplers' runtime knob)
    with langevin_const 1 gives langevin_const = γ, as in the JAX package,
    and matches the JAX package's gate_scale."""
    s, js = _schedulers()[name], _jschedulers()[name]
    x0 = _x0() * s.maximum_scale
    noise = _x0((10, 3, 4), seed=4)
    ours = s.propagate_backward(torch.from_numpy(x0), _unit_gaussian_score,
                                nsteps=10, stochastic=True, noise_seq=noise,
                                gate_scale=torch.tensor(0.7))
    ref = js.propagate_backward(jax.random.PRNGKey(0), jnp.asarray(x0),
                                _jscore, nsteps=10, stochastic=True,
                                noise_seq=jnp.asarray(noise),
                                gate_scale=jnp.float32(0.7))
    _check(ours, np.asarray(ref), rtol=1e-5, atol=2e-5,
           label=f"{name} gate_scale")
    s2 = _schedulers()[name]
    s2.langevin_const = 0.7
    const = s2.propagate_backward(torch.from_numpy(x0), _unit_gaussian_score,
                                  nsteps=10, stochastic=True,
                                  noise_seq=noise)
    _check(ours, const.numpy(), rtol=1e-5, atol=1e-5,
           label=f"{name} gate_scale against langevin_const")


def test_name_to_integrator_and_flags():
    sf = ops.EDMSchedulingFunctions()
    for name in ("euler", "heun", "euler-maruyama", "karras", "dpmpp2m"):
        ours = ops.name_to_integrator(name, scheduling=sf)
        ref = jops.name_to_integrator(name,
                                      scheduling=jops.EDMSchedulingFunctions())
        assert ours.tag == ref.tag
        assert (ours.stochastic, ours.evaluates_endpoint, ours.has_carry) == (
            ref.stochastic, ref.evaluates_endpoint, ref.has_carry)
    with pytest.raises(ValueError):
        ops.name_to_integrator("rk4")
    with pytest.raises(ValueError):
        ops.EDMScheduler(stochastic_integrator=ops.HeunIntegrator())
