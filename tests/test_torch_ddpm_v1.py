"""The port's DDPM v1 (``diffsci_tpu_torch/models/ddpm_v1.py``) against
the reference fixture ``ddpm_v1_golden.npz`` (the ᾱ tables at T 1000 and
50, the eight losses, ``apply_noise`` and the five 50-step ``backward``
arms with the fixture's replayed noise, at ``tests/test_ddpm_v1.py``'s
bounds) and against the JAX package: two ``make_train_step`` steps under
``default_v1_optimizer`` against the JAX package's steps, and a step's
graph body (``step``) against the JAX package's scan on a small HFNet.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from diffsci_tpu.models import MLPUncond as JMLPUncond
from diffsci_tpu.models import ddpm_v1 as jv1
from diffsci_tpu.models.karras import train as jtrain

from diffsci_tpu_torch import (DDPMModuleV1, DDPMSchedulerV1,
                               create_train_state, default_v1_optimizer,
                               make_train_step)
from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.models.nets import MLPUncond
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "reference",
                   "ddpm_v1_golden.npz")


@pytest.fixture(scope="module")
def fx():
    return np.load(FIX)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


class AnalyticNet(nn.Module):
    """The fixture generator's stand-in: tanh(x)·(0.9 + 0.1·cos(t/T))
    (+ 0.05·mean(y) when conditional)."""

    def __init__(self, T, conditional=False):
        super().__init__()
        self.T, self.conditional = T, conditional

    def forward(self, x, t, y=None):
        tt = t.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
        out = torch.tanh(x) * (0.9 + 0.1 * torch.cos(tt / self.T))
        if self.conditional and y is not None:
            out = out + 0.05 * y.mean(dim=-1, keepdim=True)
        return out


@pytest.mark.parametrize("T", [1000, 50])
def test_v1_scheduler_tables_fixture(fx, T):
    """β, α and σ within rtol 1e-6, ᾱ (the host float64 table) within
    2e-5; ``schedule`` honours ``reverse``."""
    sched, tag = DDPMSchedulerV1(T=T), f"T{T}"
    t = _t(fx[f"sched_{tag}_t"])
    for fn in ("beta", "alpha", "sigma"):
        np.testing.assert_allclose(getattr(sched, fn)(t).numpy(),
                                   fx[f"sched_{tag}_{fn}"], rtol=1e-6,
                                   err_msg=fn)
    np.testing.assert_allclose(sched.calpha(t).numpy(),
                               fx[f"sched_{tag}_calpha"], rtol=2e-5)
    assert list(sched.schedule(reverse=True)) == list(range(T, 0, -1))
    assert list(sched.schedule()) == list(range(1, T + 1))


@pytest.mark.parametrize("cond", [False, True])
@pytest.mark.parametrize("loss_type", ["mse", "huber"])
@pytest.mark.parametrize("scaling", ["constant", "default"])
def test_v1_loss_fixture(fx, cond, loss_type, scaling):
    """The loss with replayed t and noise, λ "default" or constant, mse or
    Huber (δ 1), within rtol 2e-5."""
    mod = DDPMModuleV1(AnalyticNet(1000, cond), DDPMSchedulerV1(T=1000),
                       conditional=cond, loss_type=loss_type,
                       loss_scaling=scaling, device="cpu")
    loss = mod.loss_fn(_t(fx["loss_x"]), _t(fx["loss_t"]),
                       _t(fx["loss_y"]) if cond else None,
                       noise=_t(fx["loss_eps"]))
    ref = fx[f"loss_{'cond' if cond else 'uncond'}_{loss_type}_{scaling}"]
    np.testing.assert_allclose(float(loss), float(ref), rtol=2e-5)


def test_v1_apply_noise_fixture(fx):
    mod = DDPMModuleV1(AnalyticNet(50), DDPMSchedulerV1(T=50), device="cpu")
    out = mod.apply_noise(_t(fx["apply_noise_x"]), _t(fx["apply_noise_t"]),
                          noise=_t(fx["apply_noise_eps"]))
    np.testing.assert_allclose(out.numpy(), fx["apply_noise_out"],
                               rtol=1e-5)


@pytest.mark.parametrize("sampler,nt,name", [
    ("ddpm", 1, "ddpm_backward_nt1"),
    ("ddpm", 2, "ddpm_backward_nt2"),
    ("ddim", 0, "ddim_backward_nt0"),
    ("ddim", 2, "ddim_backward_nt2"),
    ("ddpm", 1, "ddpm_backward_cond"),
])
def test_v1_backward_fixture(fx, sampler, nt, name):
    """The 50-step reverse process with ``samp_noise_seq`` (t = 50 first;
    the t = 1 step adds no noise; DDIM's predicted term over sqrt(α_t)),
    within rtol 2e-4, atol 2e-5; the conditional arm with its single y
    row."""
    cond = name.endswith("cond")
    mod = DDPMModuleV1(AnalyticNet(50, cond), DDPMSchedulerV1(T=50),
                       conditional=cond, device="cpu")
    out = mod.backward(_t(fx["samp_x0"]),
                       y=_t(fx["samp_y0"]) if cond else None,
                       sampler=sampler, noise_type=nt,
                       noise_seq=_t(fx["samp_noise_seq"]))
    np.testing.assert_allclose(out.numpy(), fx[name], rtol=2e-4, atol=2e-5)


def test_v1_train_steps_match_jax():
    """Two ``make_train_step`` steps of a ``DDPMModuleV1`` around an MLP
    under ``default_v1_optimizer(1e-2, restart_period=20)`` (AdamW over
    the cosine restarts, no clip), t in σ's slot and the noise replayed,
    against the JAX package's ``make_train_step`` over its v1 loss with
    the same t and noise: losses within 1e-5, parameters within PR 17's
    2e-3 relative bound; then ``sample`` gives finite draws."""
    jmod = jv1.DDPMModuleV1(JMLPUncond(dim=2, hidden_dims=(16,)),
                            jv1.DDPMSchedulerV1(T=50))
    jtx = jv1.default_v1_optimizer(1e-2, restart_period=20)
    variables = jmod.init(jax.random.PRNGKey(0), (8, 2))
    params, consts = jtrain.split_variables(variables)
    jstate = jtrain.TrainState(params=params, consts=consts,
                               opt_state=jtx.init(params), ema=None,
                               step=jnp.zeros((), jnp.int32))
    mod = DDPMModuleV1(MLPUncond(2, (16,), device="cpu"),
                       DDPMSchedulerV1(T=50), device="cpu")
    state, tx = create_train_state(mod, (8, 2), seed=None,
                                   optimizer=default_v1_optimizer(
                                       1e-2, restart_period=20))
    mod.net.model.load_state_dict(from_jax_variables(jax.tree.map(
        np.asarray, variables)), strict=True)
    step = make_train_step(mod, tx, loss_fn=lambda x, t, y, mask, eps:
                           mod.loss_fn(x, t, y, noise=eps))

    @jax.jit
    def jstep(state, key, xx, t, eps):
        def loss_fn(v, k, xb, y, mask, train=True):
            return jmod.loss_fn(v, k, xb, t, noise=eps), {}
        return jtrain.make_train_step(jmod, jtx, loss_fn=loss_fn,
                                      _raw=True)(state, key, xx)

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((8, 2)) * 0.1 + 1.0).astype(np.float32)
    for k in range(2):
        t = rng.integers(1, 51, 8).astype(np.float32)
        eps = rng.standard_normal((8, 2)).astype(np.float32)
        jstate, jmet = jstep(jstate, jax.random.PRNGKey(k), jnp.asarray(x),
                             t, eps)
        _, met = step(state, _t(x), sigma=_t(t), eps=_t(eps))
        np.testing.assert_allclose(float(met["train_loss"]),
                                   float(jmet["train_loss"]), rtol=1e-5)
    ref = from_jax_variables(jax.tree.map(np.asarray,
                                          {"params": jstate.params}))
    for k, v in mod.net.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=2e-3,
                                   atol=2e-3 * float(ref[k].abs().max()),
                                   err_msg=k)
    t = mod.config.noisesampler.sample((4096,),
                                       torch.Generator().manual_seed(0))
    assert float(t.min()) == 1.0 and float(t.max()) == 50.0
    assert bool((t == t.round()).all())
    out = mod.sample(4, (2,), torch.Generator().manual_seed(1))
    assert out.shape == (4, 2) and bool(torch.isfinite(out).all())


def test_v1_step_matches_jax_hfnet():
    """The reverse step (the body the card's graph replays per t) around a
    small HFNet with attention, DDIM with noise type 2, 6 steps of T 50
    from a given start with replayed noise, against the JAX package's
    ``backward`` scan cut to those steps: within rtol 1e-4 and 1e-4 of
    the state's scale."""
    from diffsci_tpu.models.nets import hfnet as jhf
    from diffsci_tpu_torch import HFNetUncond

    hf = dict(block_channels=(8, 16), channels=3, norm_num_groups=4,
              attn_up_and_down=True)
    jnet = jhf.HFNetUncond(**hf)
    jmod = jv1.DDPMModuleV1(jnet, jv1.DDPMSchedulerV1(T=6))
    variables = jax.jit(lambda k: jmod.init(k, (2, 8, 8, 3)))(
        jax.random.PRNGKey(0))
    mod = DDPMModuleV1(HFNetUncond(**hf, device="cpu"), DDPMSchedulerV1(T=6),
                       device="cpu")
    mod.net.model.load_state_dict(from_jax_variables(jax.tree.map(
        np.asarray, variables)), strict=True)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    seq = rng.standard_normal((6, 2, 8, 8, 3)).astype(np.float32)
    ref = jmod.backward(variables, jax.random.PRNGKey(0), jnp.asarray(x),
                        sampler="ddim", noise_type=2, noise_seq=seq)
    out = mod.backward(_t(x), sampler="ddim", noise_type=2,
                       noise_seq=_t(seq))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))
