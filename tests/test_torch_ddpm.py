"""The port's DDPM/DDIM runtime (``diffsci_tpu_torch/models/ddpm.py``)
against the JAX package and the reference fixtures: the ᾱ schedulers, the
fused steps (K7, K1) against their unfused formulas, the full T = 1000
loops of ``ddpm_sampling.npz``, the losses of ``ddpm_loss.npz``, and
``DDPMModel`` around a small HFNet step for step against JAX's, with its
loss gradients, its bf16 noise predictor and ``SamplerService``.

Weights come from a JAX init converted by ``from_jax_variables``; inputs,
t and the per-step noise are numpy arrays fed to both packages (the
``noise_seq`` and ``eps`` replay hooks). On the CPU the port's K7 and K1
run their plain versions.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu.models import ddpm as jdd
from diffsci_tpu.models.nets import hfnet as jhf

from diffsci_tpu_torch import (DDPMModel, DDPMModelConfig, HFNetCond,
                               HFNetUncond, SamplerService)
from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.models import ddpm as dd
from diffsci_tpu_torch.models.nets import MLPCond, MLPUncond
from tests import _torch_warmup  # noqa: F401  (MKL's first exp, CPU threads)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")
_HF = dict(block_channels=(8, 16), channels=3, norm_num_groups=4,
           attn_up_and_down=True)


# ---------------------------------------------------------------------------
# schedulers and steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["classical", "exp", "cosine"])
@pytest.mark.parametrize("T", [1000, 25])
def test_scheduler_tables_match_jax(name, T):
    """ᾱ at t ∈ {0, 1, T/2, T}, α and β at t ∈ {1, T/2, T}; the classical
    table (host float64 cumulative product cast to float32, rounded and
    clipped index) bit for bit, the closed forms within rtol 1e-6."""
    js, s = jdd._name_to_scheduler(name), dd._name_to_scheduler(name)
    t = np.array([0.0, 1.0, T // 2, T], np.float32)
    tol = dict(rtol=0, atol=0) if name == "classical" else \
        dict(rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(s.calpha(torch.from_numpy(t), T).numpy(),
                               np.asarray(js.calpha(jnp.asarray(t), T)),
                               **tol)
    for fn in ("alpha", "beta"):
        np.testing.assert_allclose(
            getattr(s, fn)(torch.from_numpy(t[1:]), T).numpy(),
            np.asarray(getattr(js, fn)(jnp.asarray(t[1:]), T)),
            rtol=1e-6, atol=1e-7, err_msg=fn)


def _integrators(module, sched):
    return {"classical_type1": module.ClassicalDDPMIntegratorType1(sched),
            "classical_type2": module.ClassicalDDPMIntegratorType2(sched),
            "ddpm": module.DDPMIntegrator(sched),
            "ddim": module.DDIMIntegrator(sched)}


@pytest.mark.parametrize("case", ["classical_type1", "classical_type2",
                                  "ddpm", "ddim"])
def test_ddpm_step_matches_unfused_formula(case):
    """The fused updates (K7 backward, K1 forward) equal the papers'
    formulas written with broadcast elementwise ops, at the bound of the
    JAX package's test (rtol 2e-5, atol 1e-5)."""
    rng = np.random.default_rng(3)
    x, noise = (torch.from_numpy(rng.standard_normal((4, 8, 8, 1))
                                 .astype(np.float32)) for _ in range(2))
    integ = _integrators(dd, dd.ClassicalDDPMScheduler())[case]
    t = torch.tensor(500.0)

    def fake_eps(xx, tt):
        return torch.tanh(xx) * 0.5

    out = integ.step_backward(x, t, fake_eps, 1000, noise=noise)
    t_ = torch.full((4, 1, 1, 1), 500.0)
    sig = integ.noise_injector(t.expand(4), 1000).reshape(4, 1, 1, 1)
    ca = integ.scheduler.calpha(t_, 1000)
    eps = fake_eps(x, t)
    if case.startswith("classical"):
        al = integ.scheduler.alpha(t_, 1000)
        ref = ((x - (1 - al) / torch.sqrt(1 - ca) * eps) / torch.sqrt(al)
               + sig * noise)
        fwd = (torch.sqrt(1 - integ.scheduler.beta(t_, 1000)) * x
               + torch.sqrt(integ.scheduler.beta(t_, 1000)) * noise)
    else:
        cap = integ.scheduler.calpha(t_ - 1, 1000)
        x0 = (x - eps * torch.sqrt(1 - ca)) / torch.sqrt(ca)
        ref = (torch.sqrt(cap) * x0
               + torch.sqrt(torch.relu(1 - cap - sig ** 2)) * eps
               + sig * noise)
        fwd = torch.sqrt(ca / cap) * x + (1 - ca / cap) * noise
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=1e-5)
    torch.testing.assert_close(integ.step_forward(x, t, 1000, noise=noise),
                               fwd, rtol=2e-5, atol=1e-5)


def test_classical_short_grid_is_non_finite_as_in_jax():
    """β at step T of the classical schedule rebuilt for T = nsteps is
    20/T: at nsteps = 20 it is 1, α = 0 and the first step divides by 0
    in both packages (inherited; the port mirrors it, as it must); at 25
    both are finite."""
    x = np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32)
    for nsteps, finite in ((20, False), (25, True)):
        ref = jdd.DDPMIntegrator(jdd.ClassicalDDPMScheduler()
                                 ).propagate_backward(
            jax.random.PRNGKey(0), jnp.asarray(x), lambda xx, tt: xx * 0.5,
            nsteps=nsteps)
        out = dd.DDPMIntegrator(dd.ClassicalDDPMScheduler()
                                ).propagate_backward(
            torch.from_numpy(x), lambda xx, tt: xx * 0.5, nsteps=nsteps,
            generator=torch.Generator().manual_seed(0))
        assert bool(np.isfinite(np.asarray(ref)).all()) is finite
        assert bool(torch.isfinite(out).all()) is finite


# ---------------------------------------------------------------------------
# reference fixtures
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ddpm_gold():
    return np.load(os.path.join(FIXDIR, "ddpm_sampling.npz"))


def _fixture_integrators():
    out = _integrators(dd, dd.ClassicalDDPMScheduler())
    out["ddpm_cosine"] = dd.DDPMIntegrator(dd.CosineDDPMScheduler())
    return out


def _fixture_predictor(T):
    def predictor(x, t):
        return (0.9 * x + 0.2 * torch.tanh(x)) * (
            0.9 + 0.1 * torch.cos(t / T))[:, None]
    return predictor


@pytest.mark.parametrize("case", ["classical_type1", "classical_type2",
                                  "ddpm", "ddim", "ddpm_cosine"])
def test_ddpm_backward_fixture(ddpm_gold, case):
    """The full T = 1000 reverse loop with the fixture's replayed noise, at
    the JAX package's bound (tests/test_reference_parity2.py: rtol 2e-3,
    atol 1e-4)."""
    d = ddpm_gold
    T = int(d["T"])
    hist = _fixture_integrators()[case].propagate_backward(
        torch.from_numpy(d["x0"]), _fixture_predictor(T), nsteps=T,
        record_history=True, noise_seq=d["noise_seq"])
    assert hist.shape == (T + 1,) + d["x0"].shape
    np.testing.assert_allclose(hist.numpy()[d["keep"]], d[f"bwd_{case}"],
                               rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("case", ["classical_type1", "ddpm"])
def test_ddpm_forward_fixture(ddpm_gold, case):
    """The forward (noising) loop through K1, rtol 2e-3, atol 2e-5."""
    d = ddpm_gold
    T = int(d["T"])
    hist = _fixture_integrators()[case].propagate_forward(
        torch.from_numpy(d["x0"]), nsteps=T, record_history=True,
        noise_seq=d["noise_seq"])
    np.testing.assert_allclose(hist.numpy()[d["keep"]], d[f"fwd_{case}"],
                               rtol=2e-3, atol=2e-5)


_LOSS_CASES = {
    "classical_huber": ("classical", "huber", False),
    "classical_mse": ("classical", "mse", False),
    "cosine_huber": ("cosine", "huber", False),
    "classical_huber_cond": ("classical", "huber", True),
}


@pytest.mark.parametrize("case", sorted(_LOSS_CASES))
def test_ddpm_loss_fixture(case):
    """DDPMModel.loss_fn with the reference's MLP state dicts loaded
    directly, replayed ε and fixed t, at the JAX package's bound
    (tests/test_reference_parity4.py: rtol 5e-4, atol 1e-7)."""
    d = np.load(os.path.join(FIXDIR, "ddpm_loss.npz"))
    sched, metric, conditional = _LOSS_CASES[case]
    config = DDPMModelConfig.from_classical_ddpm(scheduler=sched)
    config.loss_metric = metric
    prefix = "csd__" if conditional else "usd__"
    net = (MLPCond(3, 2, hidden_dims=(16, 16), device="cpu") if conditional
           else MLPUncond(3, hidden_dims=(16, 16), device="cpu"))
    net.load_state_dict({k[5:]: torch.from_numpy(d[k]) for k in d.files
                         if k.startswith(prefix)}, strict=True)
    model = DDPMModel(net, config, conditional=conditional, device="cpu")
    loss = model.loss_fn(torch.from_numpy(d["x"]), torch.from_numpy(d["t"]),
                         y=torch.from_numpy(d["y"]) if conditional else None,
                         train=False, eps=torch.from_numpy(d["eps"]))
    np.testing.assert_allclose(float(loss.detach()), float(d[f"loss_{case}"]),
                               rtol=5e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# DDPMModel around a small HFNet, against the JAX package
# ---------------------------------------------------------------------------
def _configs(config, loss_metric):
    """The JAX and the port's DDPMModelConfig (``from_ddpm``, ...)."""
    out = []
    for module in (jdd, dd):
        cfg = getattr(module.DDPMModelConfig, config)()
        cfg.loss_metric = loss_metric
        out.append(cfg)
    return out


def _jax_and_port(config, x_shape, compute_dtype=None, cond=None,
                  loss_metric="huber"):
    kw = dict(_HF, cond_channels=cond) if cond else _HF
    jnet = jhf.HFNetCond(**kw) if cond else jhf.HFNetUncond(**_HF)
    jcfg, cfg = _configs(config, loss_metric)
    jmodel = jdd.DDPMModel(jnet, jcfg,
                           compute_dtype=compute_dtype and jnp.bfloat16)
    y = (jnp.zeros(x_shape[:-1] + (cond,)) if cond else None)
    variables = jmodel.init(jax.random.PRNGKey(0), x_shape, y=y)
    net = (HFNetCond(**kw, device="cpu") if cond
           else HFNetUncond(**_HF, device="cpu"))
    model = DDPMModel(net, cfg, compute_dtype=compute_dtype, device="cpu")
    model.net.load_state_dict(
        from_jax_variables(jax.tree.map(np.asarray, variables)), strict=True)
    return jmodel, variables, model


@pytest.mark.parametrize("config", ["from_ddpm", "from_ddim"])
def test_ddpm_model_25_steps_match_jax(config):
    """The slice as a whole: 25 backward steps (classical schedule rebuilt
    for T = 25) of DDPMModel's noise predictor through a small HFNet with
    attention, with the same weights, x and replayed noise; the JAX
    package's DDPM-loop bound (rtol 2e-3, atol 1e-4), its atol taken
    relative to the step's largest |x| where that exceeds 1: the untrained
    network's ε̂ does not match x, so both loops amplify x to ~1e4 and
    differ there by f32 rounding (≤ 5e-7 of the step's scale, measured),
    which a fixed atol would compare at the near-zero entries. Then 25
    forward (noising) steps through K1."""
    x_shape, nsteps = (2, 16, 16, 3), 25
    jmodel, variables, model = _jax_and_port(config, x_shape)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(x_shape).astype(np.float32)
    noise_seq = rng.standard_normal((nsteps,) + x_shape).astype(np.float32)
    ref = np.asarray(jmodel.config.integrator.propagate_backward(
        jax.random.PRNGKey(0), jnp.asarray(x),
        lambda xx, tt: jmodel.noise_predictor(variables, xx, tt),
        nsteps=nsteps, record_history=True, noise_seq=noise_seq))
    with torch.inference_mode():
        hist = model.config.integrator.propagate_backward(
            torch.from_numpy(x), model.noise_predictor, nsteps=nsteps,
            record_history=True, noise_seq=noise_seq)
    assert hist.shape == ref.shape == (nsteps + 1,) + x_shape
    assert np.isfinite(ref).all()
    for step, (ours, theirs) in enumerate(zip(hist.numpy(), ref)):
        np.testing.assert_allclose(
            ours, theirs, rtol=2e-3,
            atol=1e-4 * max(1.0, float(np.abs(theirs).max())),
            err_msg=f"step {step}")
    ref = np.asarray(jmodel.config.integrator.propagate_forward(
        jax.random.PRNGKey(0), jnp.asarray(x), nsteps=nsteps,
        noise_seq=noise_seq))
    out = model.config.integrator.propagate_forward(
        torch.from_numpy(x), nsteps=nsteps, noise_seq=noise_seq)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("metric", ["huber", "mse"])
def test_ddpm_loss_and_grads_match_jax(metric):
    """loss_fn with replayed ε and fixed t through the small HFNet: the
    loss within rtol 1e-5, every parameter's gradient within 1e-4 of the
    largest gradient entry of jax.grad (f32 sums in another order)."""
    x_shape = (3, 16, 16, 3)
    jmodel, variables, model = _jax_and_port("from_ddpm", x_shape,
                                             loss_metric=metric)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(x_shape).astype(np.float32)
    eps = rng.standard_normal(x_shape).astype(np.float32)
    t = np.array([1.0, 400.0, 1000.0], np.float32)

    def jloss(params):
        return jmodel.loss_fn({**variables, "params": params},
                              jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(t), train=False,
                              eps=jnp.asarray(eps))

    ref, jgrads = jax.value_and_grad(jloss)(variables["params"])
    loss = model.loss_fn(torch.from_numpy(x), torch.from_numpy(t),
                         train=False, eps=torch.from_numpy(eps))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    ref_grads = from_jax_variables(jax.tree.map(
        np.asarray, {**variables, "params": jgrads}))
    scale = max(float(g.abs().max()) for g in ref_grads.values())
    for name, p in model.net.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)


def test_bf16_loss_reaches_every_f32_master():
    """Under compute_dtype=bf16 the cast is inside the graph: the loss is
    f32 and every f32 master gets a gradient, near its f32 gradient
    (within 5e-2 of the largest entry: bf16 activations)."""
    x_shape = (2, 8, 8, 3)
    rng = np.random.default_rng(8)
    x, eps = (torch.from_numpy(rng.standard_normal(x_shape)
                               .astype(np.float32)) for _ in range(2))
    t = torch.tensor([3.0, 800.0])
    grads = {}
    for cd in (None, torch.bfloat16):
        model = DDPMModel(HFNetUncond(**_HF, device="cpu"),
                          DDPMModelConfig.from_ddpm(), compute_dtype=cd,
                          device="cpu")
        model.init(seed=2)
        loss = model.loss_fn(x, t, train=False, eps=eps)
        assert loss.dtype == torch.float32
        loss.backward()
        grads[cd] = {n: p.grad for n, p in model.net.named_parameters()}
        assert all(p.dtype == torch.float32 and p.grad is not None
                   for p in model.net.parameters())
    scale = max(float(g.abs().max()) for g in grads[None].values())
    for name, g in grads[torch.bfloat16].items():
        np.testing.assert_allclose(g.numpy(), grads[None][name].numpy(),
                                   rtol=0, atol=5e-2 * scale, err_msg=name)


def test_bf16_noise_predictor_matches_jax():
    """compute_dtype=bf16 casts x, t and y to bf16, as the JAX package
    does, so t = 999 and 501 are 1000 and 500 after the cast (the port
    gives the same output for both). At t whose values bf16 holds exactly,
    the port's bf16 predictor stays as close to its f32 one as JAX's bf16
    predictor does to its own: max |Δ| within 1.5x. The port's network
    runs wholly in bf16 (diffusers' cast of the time embedding), JAX's in
    f32 after the first time-bias add (its type promotion), so the port's
    mean |Δ| is larger (1.46-1.54x measured at these inputs) and is held
    within 1.75x."""
    x_shape = (2, 16, 16, 3)
    x = np.random.default_rng(6).standard_normal(x_shape).astype(np.float32)
    out = {}
    for name, cd in (("f32", None), ("bf16", torch.bfloat16)):
        jmodel, variables, model = _jax_and_port("from_ddpm", x_shape, cd)
        for t in ([1000.0, 500.0], [10.0, 100.0], [999.0, 501.0]):
            tt = np.array(t, np.float32)
            out["jax", name, t[0]] = np.asarray(jmodel.noise_predictor(
                variables, jnp.asarray(x), jnp.asarray(tt)))
            with torch.no_grad():
                eps = model.noise_predictor(torch.from_numpy(x),
                                            torch.from_numpy(tt))
            assert eps.dtype == torch.float32 and eps.is_contiguous()
            out["port", name, t[0]] = eps.numpy()
    for t in (1000.0, 10.0):
        ref = out["jax", "f32", t]
        np.testing.assert_allclose(out["port", "f32", t], ref, rtol=2e-4,
                                   atol=2e-5)
        gap_jax = np.abs(out["jax", "bf16", t] - ref)
        gap_port = np.abs(out["port", "bf16", t] - out["port", "f32", t])
        assert gap_port.max() <= 1.5 * gap_jax.max(), (t, gap_port.max(),
                                                       gap_jax.max())
        assert gap_port.mean() <= 1.75 * gap_jax.mean()
    np.testing.assert_array_equal(out["port", "bf16", 999.0],
                                  out["port", "bf16", 1000.0])


def test_spatial_condition_matches_jax():
    """HFNetCond inside DDPMModel: a channels-last spatial y is moved to the
    network's layout with x, and the loss agrees with JAX's (rtol 1e-5)."""
    x_shape = (2, 16, 16, 3)
    jmodel, variables, model = _jax_and_port("from_ddim", x_shape, cond=2)
    rng = np.random.default_rng(7)
    x, eps = (rng.standard_normal(x_shape).astype(np.float32)
              for _ in range(2))
    y = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    t = np.array([30.0, 700.0], np.float32)
    ref = jmodel.loss_fn(variables, jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(t), y=jnp.asarray(y), train=False,
                         eps=jnp.asarray(eps))
    with torch.no_grad():
        loss = model.loss_fn(torch.from_numpy(x), torch.from_numpy(t),
                             y=torch.from_numpy(y), train=False,
                             eps=torch.from_numpy(eps))
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)


class _NCHWNet(torch.nn.Module):
    """Returns its [B, C, H, W] input in the NCHW layout, whatever the
    layout it came in."""

    def forward(self, x, t, y=None):
        return x.contiguous() * 0.5


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_noise_predictor_gives_contiguous_f32(compute_dtype):
    """K7 takes contiguous tensors: ε comes back channels-last, float32 and
    contiguous whatever layout the network's output has (a same-dtype
    ``.to(memory_format=...)`` would alias the strided view)."""
    model = DDPMModel(_NCHWNet(), DDPMModelConfig.from_ddim(),
                      compute_dtype=compute_dtype, device="cpu")
    x = torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    eps = model.noise_predictor(x, torch.tensor([5.0, 6.0]))
    assert eps.dtype == torch.float32 and eps.is_contiguous()
    torch.testing.assert_close(eps, (x.to(compute_dtype or torch.float32)
                                     * 0.5).float(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# sampling and serving
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def service():
    model = DDPMModel(HFNetUncond(**_HF, device="cpu"),
                      DDPMModelConfig.from_ddpm(), device="cpu")
    model.init(seed=3)
    return SamplerService(model, (8, 8, 3), batch_buckets=(2, 4), nsteps=25,
                          device="cpu")


def test_service_seed_gives_one_set_of_samples(service):
    """Ancestral DDPM (noise drawn at every step) through SamplerService:
    finite samples of the right shape; one seed gives the same samples
    whatever the chunking (6 = 4 + 2, or 3 padded to 4)."""
    six = service.sample(6, generator=5)
    assert six.shape == (6, 8, 8, 3) and np.isfinite(six).all()
    np.testing.assert_array_equal(six[:4], service.sample(4, generator=5))
    np.testing.assert_array_equal(service.sample(3, generator=9),
                                  service.sample(4, generator=9)[:3])
    assert not np.array_equal(six[:4], service.sample(4, generator=6))


def test_sample_history_and_timestep_draw():
    model = DDPMModel(HFNetUncond(**_HF, device="cpu"),
                      DDPMModelConfig.from_ddim("cosine"), device="cpu")
    model.init(seed=1)
    gen = torch.Generator().manual_seed(0)
    hist = model.sample(2, (8, 8, 3), generator=gen, nsteps=5,
                        record_history=True)
    assert hist.shape == (6, 2, 8, 8, 3) and torch.isfinite(hist).all()
    t = model.sample_timestep(1000, generator=gen)
    assert t.dtype == torch.float32
    assert float(t.min()) >= 1 and float(t.max()) <= 1000
    assert torch.equal(t, t.round())
    with pytest.raises(ValueError, match="not recognized"):
        cfg = DDPMModelConfig.from_ddpm()
        cfg.loss_metric = "l1"
        DDPMModel(model.net, cfg, device="cpu")
