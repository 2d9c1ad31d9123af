"""The port's stochastic interpolants (``diffsci_tpu_torch/models/si.py``)
against the reference fixtures and the JAX package.

- ``si_module.npz``: the six losses and the five trajectories (Heun with
  the final Euler step, guided, EDM-preconditioned, Euler–Maruyama on the
  linear and the cosine path with replayed noise), with the reference's
  MLP state dicts loaded into the port's ``MLPUncond``/``MLPCond`` by
  name, at ``tests/test_reference_parity2.py``'s bounds;
- live against JAX, through ``convert.from_jax_variables``: an ``SIModel``
  around a small 3D PUNetG (8 channels, 8³; its attention in both
  packages' plain form) for the loss with replayed t and ε, a Heun
  sample, an Euler–Maruyama loop with ``noise_seq``, "edm"
  preconditioning, bf16 compute and the running initial norm's updated
  statistics; ``create_soft_mask`` in 2D and 3D; one ``make_train_step``
  step of an ``SIModel`` with the running norm against the JAX package's
  step, and the JAX state carried over by ``from_jax_train_state``;
- port-only (the JAX functions have no replay hook there): ``inpaint``'s
  known region, the train step's t draw, and ``SamplerService`` serving
  an ``SIModel`` row by row through its dispatcher.

The JAX side's network is initialised and its loops are compiled once per
module (module-scoped fixtures).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu.models import MLPUncond as JMLPUncond
from diffsci_tpu.models import PUNetG as JPUNetG
from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig
from diffsci_tpu.models.karras import train as jtrain
from diffsci_tpu.models.si import SIModel as JSIModel
from diffsci_tpu.models.si import SIModelConfig as JSIModelConfig

from diffsci_tpu_torch import (PUNetG, PUNetGConfig, SamplerService,
                               SIModel, SIModelConfig, create_train_state,
                               default_optimizer, make_train_step)
from diffsci_tpu_torch.convert import from_jax_train_state, from_jax_variables
from diffsci_tpu_torch.models.nets import MLPCond, MLPUncond
from diffsci_tpu_torch.serving import row_seeds
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")
_PUNET = dict(dimension=3, model_channels=8, channel_expansion=(2,),
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1, num_heads=2)
_SHAPE = (2, 8, 8, 8, 1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


# ---------------------------------------------------------------------------
# the reference fixtures
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gold():
    return np.load(os.path.join(FIXDIR, "si_module.npz"))


def _fixture_net(gold, conditional):
    prefix = "csd__" if conditional else "usd__"
    net = (MLPCond(3, 2, hidden_dims=(16, 16), device="cpu") if conditional
           else MLPUncond(3, hidden_dims=(16, 16), device="cpu"))
    net.load_state_dict({k[5:]: torch.from_numpy(gold[k]) for k in gold.files
                         if k.startswith(prefix)}, strict=True)
    return net


LOSS_CASES = {
    "linear_mse": (dict(scheduler="linear", loss_metric="mse"), False,
                   False),
    "linear_huber": (dict(scheduler="linear", loss_metric="huber"), False,
                     False),
    "cosine_mse": (dict(scheduler="cosine", loss_metric="mse"), False,
                   False),
    "linear_mse_masked": (dict(scheduler="linear", loss_metric="mse"), True,
                          False),
    "linear_mse_cond": (dict(scheduler="linear", loss_metric="mse"), False,
                        True),
    "edm_precond_mse": (dict(scheduler="edm", precondition_fn="edm",
                             loss_metric="mse"), False, False),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_si_loss_fixture(gold, case):
    """SIModel.loss_fn with the reference's weights, batch, t and replayed
    ε, at the JAX package's bound (rtol 5e-4, atol 1e-7)."""
    cfg, masked, conditional = LOSS_CASES[case]
    model = SIModel(_fixture_net(gold, conditional), SIModelConfig(**cfg),
                    device="cpu")
    with torch.no_grad():
        loss = model.loss_fn(_t(gold["x"]), _t(gold["t"]),
                             y=_t(gold["y"]) if conditional else None,
                             mask=_t(gold["mask"]) if masked else None,
                             train=False, eps=_t(gold["eps"]))
    np.testing.assert_allclose(float(loss), float(gold[f"loss_{case}"]),
                               rtol=5e-4, atol=1e-7)


TRAJECTORIES = {
    "traj_linear_heun": (dict(scheduler="linear"), False, {}),
    "traj_linear_guided": (dict(scheduler="linear"), True,
                           dict(guidance=2.5)),
    "traj_edm_precond": (dict(scheduler="edm", precondition_fn="edm"),
                         False, {}),
    "traj_linear_em": (dict(scheduler="linear"), False,
                       dict(noise_injection=True)),
    "traj_cosine_em": (dict(scheduler="cosine"), False,
                       dict(noise_injection=True)),
}


@pytest.mark.parametrize("case", sorted(TRAJECTORIES))
def test_si_trajectory_fixture(gold, case):
    """integrate_flow_field's history from the fixture's start (Heun with
    the final Euler step, guidance 2.5 with y, EDM preconditioning,
    Euler–Maruyama with the replayed ``si_noise_seq``), at the JAX
    package's bound (rtol 5e-4, atol 1e-6)."""
    cfg, conditional, kw = TRAJECTORIES[case]
    model = SIModel(_fixture_net(gold, conditional), SIModelConfig(**cfg),
                    device="cpu")
    if conditional:
        kw = dict(kw, y=_t(gold["y"][:4]))
    if kw.get("noise_injection"):
        kw = dict(kw, noise_seq=_t(gold["si_noise_seq"]))
    with torch.no_grad():
        hist = model.integrate_flow_field(_t(gold["xstart"]),
                                          int(gold["nsteps"]),
                                          return_history=True, **kw)
    np.testing.assert_allclose(hist.numpy(), gold[case], rtol=5e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# live against the JAX package: a small 3D PUNetG
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def punet():
    """The JAX PUNetG's variables (one jitted init) and the port's PUNetG
    with the same weights, and the inputs."""
    jnet = JPUNetG(JPUNetGConfig(**_PUNET))
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k: jnet.init(
        {"params": k, "dropout": k}, jnp.zeros(_SHAPE),
        jnp.ones(_SHAPE[:1]), None))(key)
    variables = jax.tree.map(np.asarray, variables)
    net = PUNetG(PUNetGConfig(**_PUNET), device="cpu")
    net.load_state_dict(from_jax_variables(variables), strict=True)
    rng = np.random.default_rng(0)
    data = {name: rng.standard_normal(_SHAPE).astype(np.float32)
            for name in ("x", "eps", "x_T")}
    data["t"] = rng.uniform(0.05, 0.95, _SHAPE[0]).astype(np.float32)
    data["noise_seq"] = rng.standard_normal((3,) + _SHAPE).astype(
        np.float32)
    return jnet, variables, net, data


def _pair(punet, compute_dtype=None, **cfg):
    jnet, variables, net, _ = punet
    jmodel = JSIModel(jnet, JSIModelConfig(**cfg),
                      compute_dtype=compute_dtype and jnp.bfloat16)
    model = SIModel(net, SIModelConfig(**cfg), compute_dtype=compute_dtype,
                    device="cpu")
    return jmodel, variables, model


def _close(ours, ref, rtol, atol_scale):
    """rtol against each entry, atol relative to the reference's scale."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_allclose(
        ours, ref, rtol=rtol,
        atol=atol_scale * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("case", ["huber", "edm_precond", "bf16"])
def test_si_loss_punetg_matches_jax(punet, case):
    """The loss with replayed t and ε: f32 within rtol 2e-5 (the Huber
    path, and the EDM preconditioner on the edm path with its
    log σ(t) noise input), and bf16 compute in both packages within 2e-2
    (their bf16 convolutions round differently)."""
    cfg = dict(scheduler="linear", loss_metric="huber")
    if case == "edm_precond":
        cfg = dict(scheduler="edm", precondition_fn="edm", loss_metric="mse")
    jmodel, variables, model = _pair(
        punet, torch.bfloat16 if case == "bf16" else None, **cfg)
    d = punet[3]
    ref, _ = jax.jit(lambda v: jmodel.loss_fn(
        v, jax.random.PRNGKey(1), jnp.asarray(d["x"]), jnp.asarray(d["t"]),
        eps=d["eps"], train=False))(variables)
    with torch.no_grad():
        ours = model.loss_fn(_t(d["x"]), _t(d["t"]), eps=_t(d["eps"]),
                             train=False)
    tol = 2e-2 if case == "bf16" else 2e-5
    np.testing.assert_allclose(float(ours), float(ref), rtol=tol, atol=0)


@pytest.mark.parametrize("case", ["heun", "edm_heun", "euler_maruyama"])
def test_si_sampling_punetg_matches_jax(punet, case):
    """Four steps: ``sample`` from a given x_T (Heun twice, then Euler:
    five network calls) on the linear path and on the EDM path with its
    preconditioner (x_T scaled by σ(1) = 80), and the Euler–Maruyama loop
    with replayed noise; within rtol 1e-4 and 1e-4 of the result's
    scale."""
    cfg = dict(scheduler="edm", precondition_fn="edm") \
        if case == "edm_heun" else dict(scheduler="linear")
    jmodel, variables, model = _pair(punet, **cfg)
    d = punet[3]
    x_T = jnp.asarray(d["x_T"])
    if case == "euler_maruyama":
        ref = jax.jit(lambda v: jmodel.integrate_flow_field(
            jax.random.PRNGKey(0), v, x_T, 4, noise_injection=True,
            noise_seq=d["noise_seq"]))(variables)
        with torch.no_grad():
            ours = model.integrate_flow_field(
                _t(d["x_T"]), 4, noise_injection=True,
                noise_seq=_t(d["noise_seq"]))
    else:
        ref = jax.jit(lambda v: jmodel.sample(
            v, jax.random.PRNGKey(0), _SHAPE[0], _SHAPE[1:], nsteps=4,
            orig_noise=x_T))(variables)
        ours = model.sample(_SHAPE[0], _SHAPE[1:], nsteps=4,
                            orig_noise=_t(d["x_T"]))
    _close(ours, ref, 1e-4, 1e-4)


def test_si_running_norm_matches_jax(punet):
    """initial_norm=True: the training loss (the batch's own statistics)
    and the running statistics after it equal the JAX package's (rtol
    2e-5); ``from_jax_variables`` maps ``batch_stats/initial_norm`` to
    the ``initial_norm`` buffers beside the network, and an eval loss by
    the stored statistics agrees too."""
    cfg = dict(scheduler="linear", loss_metric="mse", initial_norm=True,
               sigma_data=0.5)
    jmodel, variables, model = _pair(punet, **cfg)
    d = punet[3]
    x = d["x"] * 3.0 + 1.5
    jvars = dict(variables, batch_stats=jax.tree.map(
        np.asarray, {"initial_norm": jmodel._bnorm.init(
            jax.random.PRNGKey(0), jnp.asarray(x))["batch_stats"]}))
    sd = from_jax_variables(jvars)
    assert {"initial_norm.mean", "initial_norm.var"} <= set(sd)
    model.net.load_state_dict(sd, strict=True)

    def train_then_eval(v):
        """The training loss and its updates, then the eval loss by the
        updated statistics (one compile)."""
        args = (jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(d["t"]))
        loss, upd = jmodel.loss_fn(v, *args, eps=d["eps"], train=True)
        v2 = dict(v, batch_stats=upd["batch_stats"])
        return loss, upd, jmodel.loss_fn(v2, *args, eps=d["eps"],
                                         train=False)[0]

    ref, upd, ref2 = jax.jit(train_then_eval)(jvars)
    with torch.no_grad():
        ours, updates = model.loss_fn(_t(x), _t(d["t"]), eps=_t(d["eps"]),
                                      train=True, return_updates=True)
    np.testing.assert_allclose(float(ours), float(ref), rtol=2e-5)
    stats = upd["batch_stats"]["initial_norm"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(updates[f"initial_norm.{k}"].numpy(),
                                   np.asarray(stats[k]), rtol=2e-5)
    jvars2 = dict(jvars, batch_stats=jax.tree.map(np.asarray,
                                                  upd["batch_stats"]))
    model.net.load_state_dict(from_jax_variables(jvars2), strict=True)
    with torch.no_grad():
        ours2 = model.loss_fn(_t(x), _t(d["t"]), eps=_t(d["eps"]),
                              train=False)
    np.testing.assert_allclose(float(ours2), float(ref2), rtol=2e-5)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("falloff", [0, 2])
def test_create_soft_mask_matches_jax(ndim, falloff):
    """The cosine-smoothed mask of a box (1 = known) equals flax's
    ``avg_pool(padding="SAME")`` form (padding counted) within 1e-6."""
    shape = (12,) * ndim + (1,)
    mask = np.zeros(shape, np.float32)
    mask[(slice(3, 9),) * ndim] = 1.0
    jmodel = JSIModel(JMLPUncond(dim=2), JSIModelConfig())
    model = SIModel(MLPUncond(2, device="cpu"), SIModelConfig(),
                    device="cpu")
    ref = jmodel.create_soft_mask(jnp.asarray(mask), falloff)
    ours = model.create_soft_mask(_t(mask), falloff)
    assert ours.shape == mask.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_si_train_step_matches_jax_and_carries_over():
    """One ``make_train_step`` step of an ``SIModel`` (an MLP, running
    initial norm, the default AdamW with clip 0.5; t and ε replayed into
    σ's and ε's slots) against the JAX package's ``make_train_step`` with
    the SI loss: loss, parameters (PR 17's 2e-3 relative bound after one
    step) and the running statistics the step writes. Then the JAX state
    loads through ``from_jax_train_state`` and the port's next step from
    it equals the JAX package's next step."""
    cfg = dict(scheduler="linear", loss_metric="mse", initial_norm=True)
    jmodel = JSIModel(JMLPUncond(dim=3, hidden_dims=(16,)),
                      JSIModelConfig(**cfg))
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((16, 3)) * 2.0 + 1.0).astype(np.float32)
    ts = rng.uniform(size=(2, 16)).astype(np.float32)
    epss = rng.standard_normal((2, 16, 3)).astype(np.float32)
    jstate, jtx = jtrain.create_train_state(jmodel, jax.random.PRNGKey(0),
                                            (16, 3))

    @jax.jit
    def jstep(state, key, xx, t, eps):
        def loss_fn(variables, k, xb, y, mask, train=True):
            return jmodel.loss_fn(variables, k, xb, t, eps=eps, train=train)
        return jtrain.make_train_step(jmodel, jtx, loss_fn=loss_fn,
                                      _raw=True)(state, key, xx)

    model = SIModel(MLPUncond(3, hidden_dims=(16,), device="cpu"),
                    SIModelConfig(**cfg), device="cpu")
    state, tx = create_train_state(model, (16, 3), seed=None)
    model.net.load_state_dict(from_jax_variables(jax.tree.map(
        np.asarray, {"params": jstate.params, **jstate.consts})))
    step = make_train_step(model, tx)
    jstate1, jmet = jstep(jstate, jax.random.PRNGKey(1), jnp.asarray(x),
                          ts[0], epss[0])
    _, met = step(state, _t(x), sigma=_t(ts[0]), eps=_t(epss[0]))
    np.testing.assert_allclose(float(met["train_loss"]),
                               float(jmet["train_loss"]), rtol=1e-5)
    ref = from_jax_variables(jax.tree.map(
        np.asarray, {"params": jstate1.params, **jstate1.consts}))
    for k, v in model.net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=2e-3,
                                   atol=2e-3 * float(ref[k].abs().max()),
                                   err_msg=k)
    assert not np.allclose(ref["initial_norm.mean"].numpy(), 0.0)

    fresh = SIModel(MLPUncond(3, hidden_dims=(16,), device="cpu"),
                    SIModelConfig(**cfg), device="cpu")
    carried = from_jax_train_state(jax.tree.map(np.asarray, jstate1), fresh,
                                   default_optimizer())
    assert carried.step == 1
    jstate2, jmet2 = jstep(jstate1, jax.random.PRNGKey(2), jnp.asarray(x),
                           ts[1], epss[1])
    _, met2 = make_train_step(fresh, default_optimizer())(
        carried, _t(x), sigma=_t(ts[1]), eps=_t(epss[1]))
    np.testing.assert_allclose(float(met2["train_loss"]),
                               float(jmet2["train_loss"]), rtol=1e-5)
    ref2 = from_jax_variables(jax.tree.map(
        np.asarray, {"params": jstate2.params, **jstate2.consts}))
    for k, v in fresh.net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref2[k].numpy(), rtol=2e-3,
                                   atol=2e-3 * float(ref2[k].abs().max()),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the port's own properties
# ---------------------------------------------------------------------------
def test_inpaint_known_region_is_exact(punet):
    """After the last step (t = 0: α = 1, σ = 0) the known region, where
    the soft mask is 1, is ``x_orig`` itself; elsewhere the sample is
    finite. Euler–Maruyama steps with a resampling round, falloff 2."""
    _, _, model = _pair(punet, scheduler="linear")
    rng = np.random.default_rng(1)
    x_orig = _t(rng.standard_normal(_SHAPE[1:]))
    mask = torch.zeros(_SHAPE[1:])
    mask[:, :4] = 1.0
    out = model.inpaint(x_orig, mask, nsamples=2, nsteps=4,
                        generator=torch.Generator().manual_seed(0),
                        mask_falloff=2, resample_steps=1)
    soft = model.create_soft_mask(mask, 2)
    known = (soft == 1.0).expand_as(out)
    assert out.shape == (2,) + _SHAPE[1:] and bool(torch.isfinite(out).all())
    assert int(known.sum()) > 0
    torch.testing.assert_close(out[known],
                               x_orig.expand_as(out)[known], rtol=0, atol=0)


@pytest.mark.parametrize("weighting", ["uniform", "edm"])
def test_train_step_draws_t_by_sample_timestep(weighting):
    """The train step's σ slot holds ``sample_timestep``'s t: the same
    generator state gives the same draw, uniform on [0, 1) or
    σ⁻¹(exp(1.2·N − 1.2)) on the EDM path."""
    cfg = SIModelConfig(scheduler="edm" if weighting == "edm" else "linear",
                        loss_weighting=weighting)
    model = SIModel(MLPUncond(2, device="cpu"), cfg, device="cpu")
    t = model.sample_timestep(4096, torch.Generator().manual_seed(3))
    out = torch.empty(4096)
    cfg.noisesampler.sample((4096,), torch.Generator().manual_seed(3),
                            out=out)
    torch.testing.assert_close(out, t, rtol=0, atol=0)
    if weighting == "uniform":
        assert 0.0 <= float(t.min()) and float(t.max()) < 1.0
    else:
        n = torch.randn(4096, generator=torch.Generator().manual_seed(3))
        ref = cfg.scheduler.sigma_fn_inv(torch.exp(1.2 * n - 1.2))
        torch.testing.assert_close(t, ref, rtol=1e-6, atol=1e-6)


def test_service_serves_si_model_row_by_row():
    """``SamplerService`` serves an ``SIModel`` unchanged: a plain request
    equals ``sample`` of its bucket from the same generator, and through the
    dispatcher each row equals ``sample`` of its own row generator alone
    (Euler–Maruyama, so the loop's draws are per row too)."""
    model = SIModel(MLPUncond(3, hidden_dims=(16,), device="cpu"),
                    SIModelConfig(), device="cpu")
    model.init(0)
    kw = {"noise_injection": True}
    plain = SamplerService(model, (3,), batch_buckets=(1, 4), nsteps=5,
                           sample_kwargs=kw, device="cpu")
    # a request of 3 runs the bucket of 4 and drops the padding row
    ref = model.sample(4, (3,), torch.Generator().manual_seed(7), nsteps=5,
                       **kw)
    np.testing.assert_array_equal(plain.sample(3, 7), ref[:3].numpy())
    svc = SamplerService(model, (3,), batch_buckets=(1, 4), nsteps=5,
                         sample_kwargs=kw, batch_window_ms=5.0,
                         device="cpu")
    try:
        out = svc.sample(3, 11)
    finally:
        svc.close()
    for i, s in enumerate(row_seeds(11, 3)):
        alone = model.sample(1, (3,), [torch.Generator().manual_seed(s)],
                             nsteps=5, **kw)
        np.testing.assert_allclose(out[i:i + 1], alone.numpy(), rtol=1e-6,
                                   atol=1e-6)


class _DataLine:
    """A stand-in for a ``DeviceMesh`` with a ``data`` axis of 2 ranks
    (the divisibility check runs before any collective)."""
    mesh_dim_names = ("data",)

    def size(self, dim):
        return 2

    def get_local_rank(self, axis):
        return 0


def test_mesh_is_not_ported():
    """``sample(mesh=...)`` is ported (``tests/test_torch_parallel.py``
    holds it against the JAX package in gloo ranks); here its contract
    that the batch divides the mesh's ``data`` axis, checked before any
    collective."""
    model = SIModel(MLPUncond(2, device="cpu"), SIModelConfig(),
                    device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        model.sample(3, (2,), mesh=_DataLine())
