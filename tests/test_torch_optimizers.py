"""The port's two optimizers written for it against optax through the JAX
package: ``schedule_free_optimizer`` (``optax.contrib.schedule_free_adamw``
after the clip) with ``schedule_free_eval_params``, and
``default_optimizer(mu_dtype=torch.bfloat16)`` (``optax.adamw(mu_dtype=
jnp.bfloat16)``), step for step on a small MLP with σ and ε replayed;
both through ``freeze_optimizer`` and ``accumulate_gradients``, saved and
restored, and a JAX schedule-free state carried over.

Tolerances are ``tests/test_torch_training.py``'s training bound: the loss
rtol 1e-5; parameters, z and the eval parameters with 99.9% of entries
within 0.01·lr and every entry within 2·k·lr after k steps (an Adam-type
step moves an entry by ±lr where its gradient is clear of rounding noise).
The bf16 first moment equals optax's to one bf16 ulp (2⁻⁷ relative), the
second moment to rtol 1e-4; a restore is bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import MLPUncond as JMLPUncond
from diffsci_tpu.models import create_train_state as jcreate_train_state
from diffsci_tpu.models import make_train_step as jmake_train_step
from diffsci_tpu.models.karras import train as jtrain

from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig,
                               accumulate_gradients, create_train_state,
                               default_optimizer, freeze_optimizer,
                               make_train_step, restore_checkpoint,
                               save_checkpoint, schedule_free_eval_params,
                               schedule_free_optimizer)
from diffsci_tpu_torch.convert import from_jax_train_state, from_jax_variables
from diffsci_tpu_torch.models.nets import MLPUncond
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

LR = 1e-3
X_SHAPE = (8, 3)


def _optimizers(kind, clip=0.5):
    if kind == "schedule_free":
        return (jtrain.schedule_free_optimizer(LR, grad_clip=clip),
                schedule_free_optimizer(LR, grad_clip=clip))
    return (jtrain.default_optimizer(LR, grad_clip=clip,
                                     mu_dtype=jnp.bfloat16),
            default_optimizer(LR, grad_clip=clip, mu_dtype=torch.bfloat16))


def _models(jtx, tx):
    jmodel = JKarrasModel(JMLPUncond(dim=3, hidden_dims=(16,)),
                          JKarrasModelConfig.from_edm())
    jstate, _ = jcreate_train_state(jmodel, jax.random.PRNGKey(0), X_SHAPE,
                                    optimizer=jtx)

    def jloss(variables, key, x, y, replay, train=True):
        return jmodel.loss_fn(variables, key, x, replay["sigma"], train=train,
                              eps=replay["eps"])

    jstep = jmake_train_step(jmodel, jtx, loss_fn=jloss)
    model = KarrasModel(MLPUncond(3, (16,), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.net.load_state_dict(_port(jstate.variables()), strict=True)
    state, _ = create_train_state(model, X_SHAPE, seed=None, optimizer=tx)
    return jstate, jstep, model, state, make_train_step(model, tx)


def _port(variables):
    return from_jax_variables(jax.tree.map(np.asarray, variables))


def _draws(k):
    rng = np.random.default_rng(100 + k)
    sigma = np.exp(rng.standard_normal(X_SHAPE[0]) * 1.2 - 1.2).astype(
        np.float32)
    return sigma, rng.standard_normal(X_SHAPE).astype(np.float32)


def _x():
    return np.random.default_rng(0).standard_normal(X_SHAPE).astype(
        np.float32)


def _both_steps(jstate, jstep, state, step, k):
    sigma, eps = _draws(k)
    x = _x()
    jstate, jmet = jstep(jstate, jax.random.PRNGKey(k), jnp.asarray(x), None,
                         {"sigma": jnp.asarray(sigma),
                          "eps": jnp.asarray(eps)})
    state, met = step(state, torch.from_numpy(x),
                      sigma=torch.from_numpy(sigma),
                      eps=torch.from_numpy(eps))
    np.testing.assert_allclose(float(met["train_loss"]),
                               float(jmet["train_loss"]), rtol=1e-5)
    return jstate, state


def _within_bound(ours: dict, theirs: dict, k: int, names=None):
    names = names or list(ours)
    diff = np.concatenate([(ours[n].detach().float() - theirs[n]).abs()
                           .flatten().numpy() for n in names])
    assert np.quantile(diff, 0.999) <= 0.01 * LR, (k, diff.max())
    assert diff.max() <= 2 * k * LR, (k, diff.max())


def _slots(state, key) -> dict:
    return {name: state.optimizer.state[p][key]
            for name, p in state.params.items() if p in state.optimizer.state}


@pytest.mark.parametrize("clip", [0.5, None])
def test_schedule_free_matches_optax(clip):
    """10 steps under schedule-free AdamW, with and without the clip: the
    loss, the parameters y, the iterate z and the eval parameters x
    against optax's, and the weight sum and max_lr exactly (the first
    step divides by a sum that starts at 0)."""
    jtx, tx = _optimizers("schedule_free", clip)
    jstate, jstep, _, state, step = _models(jtx, tx)
    import optax.contrib as oc
    for k in range(1, 11):
        jstate, state = _both_steps(jstate, jstep, state, step, k)
        jsf = [s for s in jax.tree.leaves(
            jstate.opt_state,
            is_leaf=lambda s: isinstance(s, oc.ScheduleFreeState))
            if isinstance(s, oc.ScheduleFreeState)][0]
        _within_bound(state.params, _port(jstate.variables()), k)
        _within_bound(_slots(state, "z"), _port({"params": jsf.z}), k)
        _within_bound(schedule_free_eval_params(state),
                      _port({"params": jtrain.schedule_free_eval_params(
                          jstate)}), k)
        first = next(iter(state.optimizer.state.values()))
        assert float(first["weight_sum"]) == pytest.approx(
            float(jsf.weight_sum), rel=1e-6)
        assert float(first["max_lr"]) == float(jsf.max_lr)
        assert all(torch.isfinite(p).all() for p in state.params.values())


def test_bf16_first_moment_matches_optax():
    """10 steps of AdamW with a bfloat16 first moment: the loss and the
    parameters, the stored bf16 moment (one bf16 ulp) and the f32 second
    moment (rtol 1e-4) against optax's."""
    jtx, tx = _optimizers("bf16")
    jstate, jstep, _, state, step = _models(jtx, tx)
    for k in range(1, 11):
        jstate, state = _both_steps(jstate, jstep, state, step, k)
        _within_bound(state.params, _port(jstate.variables()), k)
        adam = jstate.opt_state[1][0]
        mu = _port({"params": jax.tree.map(
            lambda a: np.asarray(a, np.float32), adam.mu)})
        nu = _port({"params": adam.nu})
        for name, m in _slots(state, "exp_avg").items():
            assert m.dtype == torch.bfloat16
            np.testing.assert_allclose(m.float().numpy(), mu[name].numpy(),
                                       rtol=2 ** -7, atol=1e-30)
        for name, v in _slots(state, "exp_avg_sq").items():
            np.testing.assert_allclose(v.numpy(), nu[name].numpy(),
                                       rtol=1e-4, atol=1e-12)
        assert float(next(iter(state.optimizer.state.values()))["step"]) == k


@pytest.mark.parametrize("kind", ["schedule_free", "bf16"])
def test_freeze_and_accumulate(kind):
    """Through ``freeze_optimizer`` (the first layer frozen: it keeps its
    weights exactly) and ``accumulate_gradients(every=2)``, 6 micro-steps
    (3 updates) against the JAX package's wrappers."""
    jtx, tx = _optimizers(kind)
    jmodel = JKarrasModel(JMLPUncond(dim=3, hidden_dims=(16,)),
                          JKarrasModelConfig.from_edm())
    params = jmodel.init(jax.random.PRNGKey(0), X_SHAPE)["params"]
    jtx = jtrain.accumulate_gradients(
        jtrain.freeze_optimizer(jtx, params, ["model/Dense_0/*"]), 2)
    jstate, _, model, _, _ = _models(jtx, tx)
    tx = accumulate_gradients(freeze_optimizer(
        tx, dict(model.net.named_parameters()), ["model.net.0.*"]), 2)
    state, _ = create_train_state(model, X_SHAPE, seed=None, optimizer=tx)
    frozen = {n: p.detach().clone() for n, p in state.params.items()
              if n.startswith("model.net.0.")}

    def jloss(variables, key, x, y, replay, train=True):
        return jmodel.loss_fn(variables, key, x, replay["sigma"], train=train,
                              eps=replay["eps"])

    jstep = jmake_train_step(jmodel, jtx, loss_fn=jloss)
    step = make_train_step(model, tx)
    for k in range(1, 7):
        jstate, state = _both_steps(jstate, jstep, state, step, k)
        _within_bound(state.params, _port(jstate.variables()), (k + 1) // 2)
    for n, p in frozen.items():
        torch.testing.assert_close(state.params[n].detach(), p, rtol=0,
                                   atol=0)
    assert state.accum.gradient_step == 3


@pytest.mark.parametrize("kind", ["schedule_free", "bf16"])
def test_state_save_restore(kind, tmp_path):
    """A checkpoint of each state comes back bit for bit into a fresh
    template (the moments in their dtypes, the shared scalars), and the
    next step from the restored state equals the next step from the saved
    one."""
    _, tx = _optimizers(kind)
    _, _, model, state, step = _models(*_optimizers(kind))
    for k in range(1, 4):
        sigma, eps = _draws(k)
        step(state, torch.from_numpy(_x()), sigma=torch.from_numpy(sigma),
             eps=torch.from_numpy(eps))
    save_checkpoint(tmp_path / "ck", state)
    from diffsci_tpu_torch.checkpoint import state_tensors
    saved = {k: v.clone() for k, v in state_tensors(state).items()}
    template, _ = create_train_state(model, X_SHAPE, seed=None, optimizer=tx)
    restore_checkpoint(tmp_path / "ck", template, model)
    for k, v in state_tensors(template).items():
        assert v.dtype == saved[k].dtype, k
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
    assert template.step == 3
    sigma, eps = _draws(4)
    step2 = make_train_step(model, tx)
    step2(template, torch.from_numpy(_x()), sigma=torch.from_numpy(sigma),
          eps=torch.from_numpy(eps))
    after = {k: v.detach().clone() for k, v in template.params.items()}
    restore_checkpoint(tmp_path / "ck", template, model)
    step2(template, torch.from_numpy(_x()), sigma=torch.from_numpy(sigma),
          eps=torch.from_numpy(eps))
    for k, v in template.params.items():
        torch.testing.assert_close(v.detach(), after[k], rtol=0, atol=0)


def test_from_jax_schedule_free_state():
    """A JAX schedule-free state after 3 steps, carried over by
    ``from_jax_train_state``: its z, second moment, counts and sums land
    in the port's state, and the next 2 steps stay within the training
    bound of the JAX run's; without a schedule-free state,
    ``schedule_free_eval_params`` raises."""
    jtx, tx = _optimizers("schedule_free")
    jstate, jstep, model, _, _ = _models(jtx, tx)
    for k in range(1, 4):
        sigma, eps = _draws(k)
        jstate, _ = jstep(jstate, jax.random.PRNGKey(k), jnp.asarray(_x()),
                          None, {"sigma": jnp.asarray(sigma),
                                 "eps": jnp.asarray(eps)})
    state = from_jax_train_state(jax.tree.map(np.asarray, jstate), model, tx)
    assert state.step == 3
    first = next(iter(state.optimizer.state.values()))
    assert float(first["step"]) == 3
    step = make_train_step(model, tx)
    for k in range(4, 6):
        jstate, state = _both_steps(jstate, jstep, state, step, k)
        _within_bound(state.params, _port(jstate.variables()), k - 3)
    plain, _ = create_train_state(model, X_SHAPE, seed=None,
                                  optimizer=default_optimizer(LR))
    with pytest.raises(ValueError, match="ScheduleFreeState"):
        schedule_free_eval_params(plain)
    with pytest.raises(ValueError):
        schedule_free_optimizer(lambda count: LR)
