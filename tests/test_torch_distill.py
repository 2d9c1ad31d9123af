"""The port's progressive distillation and minimal EDM model against the
JAX package: the halving schedule and the interval grid (exactly), the
teacher's sub-steps (Heun and Euler, and against the port's own
``propagate_partial``), the targets and their exact inversion, one
``make_distill_step`` (loss, grad norm and parameters after AdamW) for
an MLP under Heun and Euler sub-steps, a guided conditional MLP and a
small PUNetG whose attention takes the flash path (the plain K4–K6
here), the oracle chain's statistics, and ``EDMModel``.

Both packages get the same weights (a JAX init through
``from_jax_variables``) and the same draws: the JAX step's interval index
and ε are made from its key the way it makes them and replayed into the
port's step (``idx=``, ``eps=``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import MLPCond as JMLPCond
from diffsci_tpu.models import MLPUncond as JMLPUncond
from diffsci_tpu.models import PUNetG as JPUNetG
from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig
from diffsci_tpu.models.karras import EDMModel as JEDMModel
from diffsci_tpu.models.karras import EDMModelConfig as JEDMModelConfig
from diffsci_tpu.models.karras import TrainState as JTrainState
from diffsci_tpu.models.karras import default_optimizer as jdefault_optimizer
from diffsci_tpu.models.karras import distill as jdistill
from diffsci_tpu.models.karras import split_variables as jsplit_variables

from diffsci_tpu_torch import data, ops
from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.kernels import flash_attention as fa
from diffsci_tpu_torch.models import (KarrasModel, KarrasModelConfig,
                                      MLPCond, MLPUncond, PUNetG,
                                      PUNetGConfig)
from diffsci_tpu_torch.models.karras import (EDMModel, EDMModelConfig,
                                             default_optimizer, distill)
from diffsci_tpu_torch.models.karras.train import _new_train_state
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

KEY = jax.random.PRNGKey(0)
_FLASH = dict(model_channels=8, channel_expansion=(2,),
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1, num_heads=2,
              attn_backend="flash")


def _configs(sigma_max=10.0):
    """The JAX and port EDM configurations with σ_max = ``sigma_max``."""
    out = []
    for cls in (JKarrasModelConfig, KarrasModelConfig):
        config = cls.from_edm()
        config.noisescheduler.sigma_max = sigma_max
        config.noisescheduler.maximum_scale = sigma_max
        out.append(config)
    return out


def _pair(kind, x_shape, y=None):
    """A JAX model with its init and the port's with the same weights."""
    jconfig, config = _configs()
    if kind == "mlp":
        jnet, net = (JMLPUncond(dim=x_shape[-1], hidden_dims=(32, 32)),
                     MLPUncond(x_shape[-1], (32, 32), device="cpu"))
    elif kind == "mlp_cond":
        jnet, net = (JMLPCond(dim=x_shape[-1], ydim=y.shape[-1],
                              hidden_dims=(16,)),
                     MLPCond(x_shape[-1], y.shape[-1], (16,), device="cpu"))
    else:
        jnet, net = (JPUNetG(JPUNetGConfig(**_FLASH)),
                     PUNetG(PUNetGConfig(**_FLASH), device="cpu"))
    cond = kind == "mlp_cond"
    jmodel = JKarrasModel(jnet, jconfig, conditional=cond)
    variables = jmodel.init(KEY, x_shape, None if y is None
                            else jnp.asarray(y))
    model = KarrasModel(net, config, conditional=cond, device="cpu")
    sd = from_jax_variables(jax.tree.map(np.asarray, variables))
    model.net.load_state_dict(sd, strict=True)
    return jmodel, variables, model, sd


def _teacher(model, sd):
    teacher = distill._teacher_like(model)
    teacher.net.load_state_dict(sd, strict=True)
    return teacher


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# the grid and the schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sigma_max", [10.0, 80.0])
def test_halving_schedule_and_interval_grid_equal_jax(sigma_max):
    """The schedule and every (a, m, b) triple equal the JAX package's bit
    for bit, the student's grid is every second teacher point, and the
    last interval's midpoint is 0."""
    for args in ((17, 2), (17, 1), (5, 3), (2, 2), (1, 1), (9, 1)):
        assert distill.halving_schedule(*args) == \
            jdistill.halving_schedule(*args)
    with pytest.raises(ValueError):
        distill.halving_schedule(8, 0)
    jconfig, config = _configs(sigma_max)
    jmodel = JKarrasModel(JMLPUncond(dim=2), jconfig)
    model = KarrasModel(MLPUncond(2, device="cpu"), config, device="cpu")
    sched = model.config.noisescheduler
    for n in (1, 2, 3, 5, 9, 17):
        ours = distill.distill_interval_grid(model, n)
        theirs = jdistill.distill_interval_grid(jmodel, n)
        for o, t in zip(ours, theirs):
            assert o.dtype == np.float32
            np.testing.assert_array_equal(o, np.asarray(t))
        if n > 1:
            S = sched.create_steps(n + 1)
            np.testing.assert_array_equal(ours[0], S[:-1].astype(np.float32))
            np.testing.assert_array_equal(ours[2], S[1:].astype(np.float32))
            assert ours[1][-1] == 0.0 and np.all(ours[1][:-1] >=
                                                 sched.sigma_min)


# ---------------------------------------------------------------------------
# the teacher's sub-steps and the targets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("heun", [True, False])
def test_denoiser_step_matches_jax(heun):
    """Heun (endpoint rule per row) and Euler sub-steps with σ vectors that
    hold zeros (the identity sub-step) agree with the JAX package's within
    rtol 1e-5, and rows with σ_from = σ_to pass unchanged."""
    jmodel, variables, model, _ = _pair("mlp", (6, 2))
    x = np.random.default_rng(1).standard_normal((6, 2)).astype(np.float32)
    s_from = np.array([10.0, 2.0, 0.5, 0.002, 0.0, 1.0], np.float32)
    s_to = np.array([2.0, 0.5, 0.002, 0.0, 0.0, 1.0], np.float32)

    def jden(xx, sig):
        return jmodel.get_denoiser(variables, xx, sig, None)[0]

    def den(xx, sig):
        return model.get_denoiser(xx, sig)[0]

    ref = jdistill._denoiser_step(jden, jnp.asarray(x), jnp.asarray(s_from),
                                  jnp.asarray(s_to), heun=heun)
    with torch.no_grad():
        out = distill._denoiser_step(den, _t(x), _t(s_from), _t(s_to),
                                     heun=heun)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(out[4:].numpy(), x[4:])


def test_teacher_substeps_match_propagate_partial():
    """Two teacher sub-steps over each student interval equal the port's
    own Heun sampler over the same teacher grid points (the JAX package's
    bounds: rtol 2e-5, atol 1e-6)."""
    _, _, model, _ = _pair("mlp", (3, 2))
    n = 4
    sched = model.config.noisescheduler
    a, m, b = distill.distill_interval_grid(model, n)
    x = _t(np.random.default_rng(3).standard_normal((3, 2)).astype(
        np.float32) * 2.0)

    def den(xx, sig):
        return model.get_denoiser(xx, sig)[0]

    def score_fn(xx, sig):
        return (den(xx, sig) - xx) / sig[:, None] ** 2

    with torch.no_grad():
        for j in range(n):
            full = [torch.full((3,), float(v)) for v in (a[j], m[j], b[j])]
            x_mid = distill._denoiser_step(den, x, full[0], full[1])
            x_two = distill._denoiser_step(den, x_mid, full[1], full[2])
            final = 2 * j + 2 if j < n - 1 else 2 * n - 1
            ref = sched.propagate_partial(x, score_fn, nsteps=2 * n - 1,
                                          initial_step=2 * j,
                                          final_step=final)
            np.testing.assert_allclose(x_two.numpy(), ref.numpy(),
                                       rtol=2e-5, atol=1e-6,
                                       err_msg=f"interval {j}")


@pytest.mark.parametrize("kind", ["mlp", "mlp_cond"])
def test_distill_targets_match_jax_and_invert_exactly(kind):
    """The targets agree with the JAX package's (guided at 2 for the
    conditional MLP), and one student Euler step from D_tgt reproduces the
    teacher's X (the JAX package's bounds: rtol 1e-5, atol 1e-6), the last
    interval's target being X itself."""
    n, B = 4, 6
    y = np.random.default_rng(5).standard_normal((B, 3)).astype(np.float32) \
        if kind == "mlp_cond" else None
    jmodel, variables, model, sd = _pair(kind, (B, 2), y)
    teacher = _teacher(model, sd)
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((B, 2)).astype(np.float32)
    eps = rng.standard_normal((B, 2)).astype(np.float32)
    idx = np.array([0, 1, 2, 3, 0, 3], np.int64)
    guidance = 2.0 if kind == "mlp_cond" else 1.0
    ref = jdistill.distill_targets(
        jmodel, variables, jnp.asarray(x0), jnp.asarray(eps),
        jnp.asarray(idx), n, y=None if y is None else jnp.asarray(y),
        teacher_guidance=guidance)
    out = distill.distill_targets(teacher, _t(x0), _t(eps), _t(idx), n,
                                  y=None if y is None else _t(y),
                                  teacher_guidance=guidance)
    for o, r, name in zip(out, ref, ("x_t", "sigma", "D_tgt", "X")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    x_t, sigma, D_tgt, X = out
    _, _, b = distill.distill_interval_grid(model, n)
    sig = sigma[:, None]
    x_b = x_t + (_t(b)[_t(idx)][:, None] - sig) * (x_t - D_tgt) / sig
    np.testing.assert_allclose(x_b.numpy(), X.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.isfinite(D_tgt).all()
    last = idx == n - 1
    np.testing.assert_allclose(D_tgt[last].numpy(), X[last].numpy(),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the distill step
# ---------------------------------------------------------------------------
STEP_CASES = {
    "mlp_heun": dict(kind="mlp", shape=(8, 2), heun=True, guidance=1.0),
    "mlp_euler": dict(kind="mlp", shape=(8, 2), heun=False, guidance=1.0),
    "mlp_cond_guided": dict(kind="mlp_cond", shape=(6, 2), heun=True,
                            guidance=2.0),
    "punetg_flash": dict(kind="punetg", shape=(2, 16, 16, 1), heun=True,
                         guidance=1.0),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_distill_step_matches_jax(case, monkeypatch):
    """One distill step (n = 3 student steps) from the same weights and
    draws: loss within rtol 1e-5, grad norm within rtol 1e-4, and the
    parameters after clip and AdamW (lr 1e-3) within the train step's
    bounds (99.9 % of entries within 0.01·lr, every entry within 2·lr).
    The PUNetG case sends its 64-token attention through the flash path
    (FlashAttention's plain K4–K6 here; XLA attention in the JAX
    package)."""
    monkeypatch.setattr(fa, "MIN_TOKENS", 1)
    c = STEP_CASES[case]
    n, lr = 3, 1e-3
    y = np.random.default_rng(5).standard_normal(
        (c["shape"][0], 3)).astype(np.float32) \
        if c["kind"] == "mlp_cond" else None
    jmodel, variables, model, sd = _pair(c["kind"], c["shape"], y)
    teacher = _teacher(model, sd)
    x = np.random.default_rng(2).standard_normal(c["shape"]).astype(
        np.float32)

    jtx = jdefault_optimizer(learning_rate=lr)
    params, consts = jsplit_variables(variables)
    jstate = JTrainState(params=params, consts=consts,
                         opt_state=jtx.init(params), ema=None,
                         step=jnp.zeros((), jnp.int32))
    jstep = jdistill.make_distill_step(jmodel, jtx, n,
                                       teacher_guidance=c["guidance"],
                                       teacher_heun=c["heun"])
    key = jax.random.PRNGKey(7)
    jy = None if y is None else jnp.asarray(y)
    jstate, jmet = jstep(jstate, variables, key, jnp.asarray(x), jy)
    kidx, keps, _ = jax.random.split(key, 3)
    idx = np.asarray(jax.random.randint(kidx, (x.shape[0],), 0, n))
    eps = np.asarray(jax.random.normal(keps, x.shape, jnp.float32))

    tx = default_optimizer(lr)
    state = _new_train_state(model, tx)
    step = distill.make_distill_step(model, tx, n,
                                     teacher_guidance=c["guidance"],
                                     teacher_heun=c["heun"])
    state, met = step(state, teacher, _t(x), None if y is None else _t(y),
                      idx=_t(idx.astype(np.int64)), eps=_t(eps))
    assert state.step == 1
    np.testing.assert_allclose(float(met["distill_loss"]),
                               float(jmet["distill_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    theirs = from_jax_variables(jax.tree.map(
        np.asarray, {**consts, "params": jstate.params}))
    diff = np.concatenate([(state.params[k].detach() - theirs[k]).abs()
                           .flatten().numpy() for k in state.params])
    assert np.quantile(diff, 0.999) <= 0.01 * lr
    assert diff.max() <= 2 * lr
    # the teacher did not move, and the student shares no storage with it
    for k, v in teacher.net.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
        assert v.data_ptr() != model.net.state_dict()[k].data_ptr()


def test_distill_step_draws_from_its_generator():
    """Without replays the step draws the interval index, then ε, from its
    generator: one seed gives one step, and the teacher must be another
    model than the student."""
    _, _, model, sd = _pair("mlp", (8, 2))
    teacher = _teacher(model, sd)
    x = torch.randn(8, 2, generator=torch.Generator().manual_seed(0))
    losses = []
    for _ in range(2):
        model.net.load_state_dict(sd)
        tx = default_optimizer(1e-3)
        state = _new_train_state(model, tx)
        step = distill.make_distill_step(model, tx, 3)
        _, met = step(state, teacher, x,
                      generator=torch.Generator().manual_seed(11))
        losses.append(float(met["distill_loss"]))
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    g = torch.Generator().manual_seed(11)
    idx = torch.randint(0, 3, (8,), generator=g)
    eps = torch.randn(8, 2, generator=g)
    model.net.load_state_dict(sd)
    tx = default_optimizer(1e-3)
    state = _new_train_state(model, tx)
    _, met = distill.make_distill_step(model, tx, 3)(state, teacher, x,
                                                    idx=idx, eps=eps)
    assert float(met["distill_loss"]) == losses[0]
    with pytest.raises(ValueError, match="another KarrasModel"):
        distill.make_distill_step(model, tx, 3)(state, model, x)


def test_distill_progressive_statistics():
    """The halving chain 5 → 3 → 2 → 1 from an analytic teacher (the exact
    Gaussian denoiser under the identity preconditioning), distilled
    across architectures into an MLP, as the JAX package's test: finite
    losses, the 1-NFE student's std within 15 % of the data's and at most
    half the error of the teacher's own 2-step Euler sample."""
    dim, std = 2, 1.0
    dataset = data.ZeroMeanGaussianDataset(num_samples=4096, shape=[dim],
                                           scale=std)

    class OracleNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dummy = torch.nn.Parameter(torch.ones(()))

        def forward(self, x, t=None, y=None):
            return dataset.denoiser(x, t) + 0.0 * self.dummy * x

        def reset_parameters(self, generator):
            with torch.no_grad():
                self.dummy.fill_(1.0)

    _, config = _configs()
    config.preconditioner = ops.NullPreconditioner()
    teacher = KarrasModel(OracleNet(), config, device="cpu")
    _, config_s = _configs()
    student = KarrasModel(MLPUncond(dim, (64, 64), device="cpu"), config_s,
                          device="cpu")
    student_vars = {k: v.clone() for k, v in student.init(0).items()}
    gen = torch.Generator().manual_seed(13)

    def batches():
        while True:
            yield dataset.sample(gen)[:128]

    variables, history = distill.distill_progressive(
        student, None, batches(), torch.Generator().manual_seed(17),
        start_nsteps=5, final_nsteps=1, steps_per_phase=600,
        learning_rate=1e-3, teacher_model=teacher,
        initial_variables=student_vars)
    assert [h["nsteps"] for h in history] == [5, 3, 2, 1]
    for h in history:
        assert len(h["losses"]) == 600 and np.all(np.isfinite(h["losses"]))
    for k, v in student.net.state_dict().items():
        torch.testing.assert_close(v, variables[k], rtol=0, atol=0)
    samples = distill.sample_onestep(student, 4096, (dim,),
                                     torch.Generator().manual_seed(19))
    err = abs(float(samples.std()) - std) / std
    assert err < 0.15, float(samples.std())
    naive = teacher.sample(4096, (dim,), torch.Generator().manual_seed(19),
                           nsteps=2, integrator="euler")
    naive_err = abs(float(naive.std()) - std) / std
    assert err < 0.5 * max(naive_err, 0.2), (err, naive_err)


# ---------------------------------------------------------------------------
# EDMModel
# ---------------------------------------------------------------------------
def test_edm_minimal_model_matches_jax():
    """``EDMModel``: the JAX package's test (a zero network: finite loss,
    samples of the right shape pulled toward 0), the loss against the
    JAX package's under the same σ and ε (the JAX loss draws ε from its
    key's first half, replayed here) within rtol 1e-5, for both metrics
    and an initial norm, and the probability-flow integration against
    the JAX package's within rtol 1e-5."""
    class Zero(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.d = torch.nn.Parameter(torch.ones(()))

        def forward(self, x, t=None, y=None):
            return x * 0.0 + 0.0 * self.d

        def reset_parameters(self, generator):
            with torch.no_grad():
                self.d.fill_(1.0)

    config = EDMModelConfig(loss_metric="mse")
    model = EDMModel(Zero(), config, device="cpu")
    model.init(0)
    g = torch.Generator().manual_seed(0)
    sigma = config.sample_sigma((8,), g)
    loss = model.loss_fn(torch.zeros(8, 2), sigma, generator=g)
    assert torch.isfinite(loss)
    x_T = torch.randn(8, 2, generator=torch.Generator().manual_seed(1))
    out = model.sample(8, (2,), torch.Generator().manual_seed(1), nsteps=20)
    # F = 0: D = c_skip·x, whose flow maps σ_max·ε to σ_d·ε·σ_max/
    # sqrt(σ_max² + σ_d²) ≈ 0.5·ε; 20 Heun steps land within 5 % of it
    ratio = out / x_T
    assert out.shape == (8, 2)
    assert float(ratio.max() - ratio.min()) < 1e-5
    assert abs(float(ratio.mean()) - 0.5) < 0.025

    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 2)).astype(np.float32)
    sigma = np.exp(rng.standard_normal(6) * 1.2 - 1.2).astype(np.float32)
    for kw in (dict(loss_metric="mse"), dict(loss_metric="huber"),
               dict(loss_metric="huber", initial_norm=2.0)):
        jmodel = JEDMModel(JMLPUncond(dim=2, hidden_dims=(16,)),
                           JEDMModelConfig(**kw))
        variables = jmodel.init(KEY, (6, 2))
        port = EDMModel(MLPUncond(2, (16,), device="cpu"),
                        EDMModelConfig(**kw), device="cpu")
        port.net.load_state_dict(from_jax_variables(
            jax.tree.map(np.asarray, variables)), strict=True)
        key = jax.random.PRNGKey(3)
        ref = jmodel.loss_fn(variables, key, jnp.asarray(x),
                             jnp.asarray(sigma), train=False)
        knoise, _ = jax.random.split(key)
        eps = np.asarray(jax.random.normal(knoise, x.shape, jnp.float32))
        ours = port.loss_fn(_t(x), _t(sigma), train=False, eps=_t(eps))
        np.testing.assert_allclose(float(ours.detach()), float(ref),
                                   rtol=1e-5)
    x_T = rng.standard_normal((4, 2)).astype(np.float32) * 80.0
    ref = jmodel.integrate_probability_flow(variables, KEY, jnp.asarray(x_T),
                                            nsteps=12, record_history=True)
    ours = port.integrate_probability_flow(_t(x_T), nsteps=12,
                                           record_history=True)
    assert ours.shape == (12, 4, 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
