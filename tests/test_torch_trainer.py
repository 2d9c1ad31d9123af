"""The port's host loop against the JAX package: data loading
(``ArrayDataLoader``, ``train_val_split``), ``freeze_optimizer``,
``accumulate_gradients``, the eval step's draws, and ``Trainer`` /
``fit_karras`` (after ``tests/test_trainer.py``).

The optimizer pins take K steps in both packages from the same weights
(a JAX init converted by ``from_jax_variables``) with σ and ε replayed per
step, as ``tests/test_torch_training.py`` does, and hold the parameters to
that file's bound: AdamW moves an entry by about ±lr a step, so 99.9% of
entries within 0.01·lr and every entry within 2·k·lr after k updates.
Adam's first moments, which carry the clipped gradients, agree within
1e-4 of their largest entry (the gradients' bound there).
"""

import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffsci_tpu.data import loading as jloading
from diffsci_tpu.models import EMATracker as JEMATracker
from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import create_train_state as jcreate_train_state
from diffsci_tpu.models import make_train_step as jmake_train_step
from diffsci_tpu.models.karras import train as jtrain
from diffsci_tpu.models.nets import MLPUncond as JMLPUncond

from diffsci_tpu_torch import (CheckpointManager, EMATracker, KarrasModel,
                               KarrasModelConfig, Trainer,
                               accumulate_gradients, create_train_state,
                               default_optimizer, fit_karras,
                               freeze_optimizer, make_eval_step,
                               make_train_step)
from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.data import (ArrayDataLoader, TorchLoaderAdapter,
                                    prefetch_to_device, split_indices,
                                    train_val_split)
from diffsci_tpu_torch.models.nets import MLPUncond
from diffsci_tpu_torch.trainer import HyperparameterManager
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

LR = 1e-3


# ---------------------------------------------------------------------------
# data loading
# ---------------------------------------------------------------------------
def _epochs(loader, n=2):
    return [[np.asarray(b["x"]) if isinstance(b, dict) else np.asarray(b)
             for b in loader] for _ in range(n)]


@pytest.mark.parametrize("leaf", ["array", "memmap", "tensor"])
@pytest.mark.parametrize("procs", [(1, 0), (2, 0), (2, 1)])
def test_array_dataloader_matches_jax(leaf, procs, tmp_path):
    """Two epochs of batches (rows that name their index) equal the JAX
    package's loader's for the same seed, per process of 1 or 2; memmap
    leaves read only the batch, tensor leaves give the same rows."""
    data = np.arange(50 * 2, dtype=np.float32).reshape(50, 2)
    np.save(tmp_path / "d.npy", data)
    mm = np.load(tmp_path / "d.npy", mmap_mode="r")
    ours_leaf = {"array": data, "memmap": mm,
                 "tensor": torch.from_numpy(data)}[leaf]
    count, index = procs
    ours = ArrayDataLoader({"x": ours_leaf}, batch_size=8, seed=3,
                           process_count=count, process_index=index)
    theirs = jloading.ArrayDataLoader({"x": data}, batch_size=8, seed=3,
                                      process_count=count,
                                      process_index=index)
    assert len(ours) == len(theirs) == 6
    a, b = _epochs(ours), _epochs(theirs)
    assert not np.array_equal(a[0][0], a[1][0])     # reshuffled
    for ea, eb in zip(a, b):
        assert len(ea) == 6
        for x, y in zip(ea, eb):
            assert x.shape == (8 // count, 2)
            np.testing.assert_array_equal(x, y)


def test_train_val_split_and_adapter_match_jax():
    ds = (np.arange(100).reshape(50, 2), np.arange(50))
    for ours, theirs in zip(train_val_split(ds, 0.2, seed=4),
                            jloading.train_val_split(ds, 0.2, seed=4)):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    assert train_val_split(ds, 0.2)[0][0].shape == (40, 2)
    loader = torch.utils.data.DataLoader(
        torch.utils.data.TensorDataset(torch.arange(24.).reshape(12, 2)),
        batch_size=4)
    adapted = TorchLoaderAdapter(loader)
    assert len(adapted) == 3
    for _ in range(2):
        (xb,), *_ = list(adapted)
        assert torch.equal(xb, torch.arange(8.).reshape(4, 2))
    xs = np.arange(40, dtype=np.float32).reshape(10, 4)
    batches = list(prefetch_to_device(
        iter(ArrayDataLoader(xs, batch_size=2, shuffle=False)), size=2,
        device="cpu"))
    assert len(batches) == 5 and isinstance(batches[0], torch.Tensor)
    np.testing.assert_array_equal(torch.cat(batches).numpy(), xs)


@pytest.mark.parametrize("procs", [(1, 0), (2, 1)])
def test_indexed_loader_matches_jax_over_the_split(procs, tmp_path):
    """Loaders over a memmap restricted to split_indices' rows (what
    fit_karras loads, reading only each batch's rows) yield, for two
    epochs, the JAX package's loaders over its gathered split."""
    data = np.arange(60 * 2, dtype=np.float32).reshape(60, 2)
    np.save(tmp_path / "d.npy", data)
    mm = np.load(tmp_path / "d.npy", mmap_mode="r")
    count, index = procs
    sides = zip(split_indices(60, 0.2, seed=4),
                jloading.train_val_split(data, 0.2, seed=4), (True, False))
    for idx, gathered, shuffle in sides:
        kw = dict(batch_size=4, shuffle=shuffle, seed=3,
                  process_count=count, process_index=index)
        ours = ArrayDataLoader(mm, indices=idx, **kw)
        theirs = jloading.ArrayDataLoader(gathered, **kw)
        assert len(ours) == len(theirs) == len(idx) // 4
        for ea, eb in zip(_epochs(ours), _epochs(theirs)):
            assert len(ea) == len(eb)
            for x, y in zip(ea, eb):
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# freeze and accumulation against optax
# ---------------------------------------------------------------------------
def _mlp_pair(jtx, tx, x_shape=(4, 8), ema=None):
    """A JAX MLP KarrasModel with its state and replaying step, and the
    port's with the same weights and replaying step."""
    jmodel = JKarrasModel(JMLPUncond(dim=x_shape[1], hidden_dims=(16, 16)),
                          JKarrasModelConfig.from_edm())
    jstate, jtx = jcreate_train_state(
        jmodel, jax.random.PRNGKey(0), x_shape, optimizer=jtx,
        ema=ema and JEMATracker(**ema))

    def jloss(variables, key, x, y, replay, train=True):
        return jmodel.loss_fn(variables, key, x, replay["sigma"],
                              train=train, eps=replay["eps"])

    jstep = jmake_train_step(jmodel, jtx, ema=ema and JEMATracker(**ema),
                             loss_fn=jloss)
    model = KarrasModel(MLPUncond(x_shape[1], (16, 16), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.net.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, jstate.variables())), strict=True)
    tracker = ema and EMATracker(**ema)
    state, tx = create_train_state(model, x_shape, seed=None, optimizer=tx,
                                   ema=tracker)
    step = make_train_step(model, tx, ema=tracker)
    return jstep, jstate, step, state


def _draws(x_shape, k):
    rng = np.random.default_rng(100 + k)
    sigma = np.exp(rng.standard_normal(x_shape[0]) * 1.2 - 1.2)
    return sigma.astype(np.float32), \
        rng.standard_normal(x_shape).astype(np.float32)


def _both_step(jstep, jstate, step, state, x, k):
    sigma, eps = _draws(x.shape, k)
    jstate, jmet = jstep(jstate, jax.random.PRNGKey(k), jnp.asarray(x), None,
                         {"sigma": jnp.asarray(sigma),
                          "eps": jnp.asarray(eps)})
    state, met = step(state, torch.from_numpy(x),
                      sigma=torch.from_numpy(sigma),
                      eps=torch.from_numpy(eps))
    return jstate, jmet, state, met


def _port_names(tree):
    return from_jax_variables(jax.tree.map(np.asarray, {"params": tree}))


def _assert_params_close(params, jparams, updates):
    theirs = _port_names(jparams)
    diff = np.concatenate([(params[n].detach() - theirs[n]).abs().flatten()
                           .numpy() for n in params])
    assert np.quantile(diff, 0.999) <= 0.01 * LR
    assert diff.max() <= 2 * max(updates, 1) * LR


def test_freeze_optimizer_matches_optax():
    """Three steps with Dense_0 frozen (optax.multi_transform with
    set_to_zero around chain(clip, adamw)): the frozen parameters stay bit
    for bit, the trainable ones move as JAX's, and Adam's first moments
    agree, which they do only if the clip's norm (active here) covers the
    trainable gradients alone."""
    x_shape = (4, 8)
    jmodel = JKarrasModel(JMLPUncond(dim=8, hidden_dims=(16, 16)),
                          JKarrasModelConfig.from_edm())
    params0 = jmodel.init(jax.random.PRNGKey(0), x_shape)["params"]
    jtx = jtrain.freeze_optimizer(jtrain.default_optimizer(LR), params0,
                                  ["model/Dense_0/*"])
    # the frozen set in the port's names, through convert's name map
    frozen = {n for n, v in _port_names(jax.tree.map(
        lambda m, p: np.full(p.shape, 0.0 if m else 1.0),
        jtrain.freeze_mask(params0, ["model/Dense_0/*"]), params0)).items()
        if float(v.min()) > 0}
    assert frozen == {"model.net.0.weight", "model.net.0.bias"}
    tx = freeze_optimizer(default_optimizer(LR),
                          dict.fromkeys(["model.net.0.weight",
                                         "model.net.0.bias",
                                         "model.net.2.weight"]),
                          ["model.net.0.*"])
    assert tx.frozen == frozen
    jstep, jstate, step, state = _mlp_pair(jtx, tx, x_shape)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    x = np.random.default_rng(0).standard_normal(x_shape).astype(np.float32)
    for k in range(1, 4):
        jstate, jmet, state, met = _both_step(jstep, jstate, step, state, x,
                                              k)
        assert float(met["grad_norm"]) > 0.5     # the clip is active
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    for n in frozen:
        assert torch.equal(state.params[n].detach(), before[n])
        assert float(state.params[n].grad.abs().max()) > 0
        assert state.params[n] not in state.optimizer.state
    _assert_params_close(state.params, jstate.params, 3)
    adam = [s for s in jax.tree.leaves(
        jstate.opt_state, is_leaf=lambda s: isinstance(
            s, optax.ScaleByAdamState)) if isinstance(
                s, optax.ScaleByAdamState)][0]
    zeros = jax.tree.map(np.zeros_like, jstate.params)
    mu = _port_names(jax.tree.map(
        lambda m, z: z if isinstance(m, optax.MaskedNode) else m,
        adam.mu, zeros, is_leaf=lambda m: isinstance(m, optax.MaskedNode)))
    scale = max(float(v.abs().max()) for v in mu.values())
    for n, p in state.params.items():
        if n not in frozen:
            np.testing.assert_allclose(
                state.optimizer.state[p]["exp_avg"].numpy(), mu[n].numpy(),
                rtol=0, atol=1e-4 * scale, err_msg=n)


def test_accumulate_gradients_matches_multisteps():
    """accumulate_gradients(tx, 2) against optax.MultiSteps over four
    micro-batches with their own draws: the parameters hold on the first
    micro-step of each pair (bit for bit) and move as JAX's on the second;
    the step count and the EMA advance on every micro-step; the counters
    follow MultiSteps'."""
    x_shape = (4, 8)
    ema = dict(ema_type="power", power_function_stds=[0.05])
    jstep, jstate, step, state = _mlp_pair(
        jtrain.accumulate_gradients(jtrain.default_optimizer(LR), 2),
        accumulate_gradients(default_optimizer(LR), 2), x_shape, ema)
    rng = np.random.default_rng(1)
    for k in range(1, 5):
        x = rng.standard_normal(x_shape).astype(np.float32)
        before = {n: p.detach().clone() for n, p in state.params.items()}
        jstate, jmet, state, met = _both_step(jstep, jstate, step, state, x,
                                              k)
        np.testing.assert_allclose(float(met["train_loss"]),
                                   float(jmet["train_loss"]), rtol=1e-5)
        if k % 2:
            for n, p in state.params.items():
                assert torch.equal(p.detach(), before[n]), (k, n)
        _assert_params_close(state.params, jstate.params, k // 2)
        _assert_params_close(state.ema.profiles[0], jstate.ema.profiles[0],
                             k // 2)
        assert state.step == int(jstate.step) == k
        assert state.ema.num_updates == int(jstate.ema.num_updates) == k
        assert (state.accum.mini_step, state.accum.gradient_step) == (
            int(jstate.opt_state.mini_step),
            int(jstate.opt_state.gradient_step))
    with pytest.raises(ValueError):
        accumulate_gradients(default_optimizer(), 0)


def test_gradient_accumulation_of_identical_batches_is_one_step():
    """k identical micro-batches (the same x, σ and ε) make exactly the
    update of one plain step, and the parameters hold until then (after
    tests/test_trainer.py:485-516, its bound)."""
    x_shape = (4, 8)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(x_shape)
                         .astype(np.float32))
    sigma, eps = (torch.from_numpy(a) for a in _draws(x_shape, 7))
    out = {}
    for every in (1, 3):
        model = KarrasModel(MLPUncond(8, (16, 16), device="cpu"),
                            KarrasModelConfig.from_edm(), device="cpu")
        tx = default_optimizer(grad_clip=None)
        if every > 1:
            tx = accumulate_gradients(tx, every)
        state, tx = create_train_state(model, x_shape, seed=0, optimizer=tx)
        step = make_train_step(model, tx)
        p0 = [p.detach().clone() for p in state.params.values()]
        for k in range(every):
            step(state, x, sigma=sigma, eps=eps)
            if k < every - 1:
                assert all(torch.equal(a, p.detach()) for a, p in
                           zip(p0, state.params.values()))
        out[every] = [p.detach() for p in state.params.values()]
    for a, b in zip(out[3], out[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_eval_step_draws_sigma_then_eps():
    """The eval step draws σ, then ε, from its generator (the order its
    graph's static inputs are filled in on the card): one seed gives the
    loss of those draws replayed."""
    x_shape = (3, 8)
    model = KarrasModel(MLPUncond(8, (16,), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    state, _ = create_train_state(model, x_shape, seed=0)
    x = torch.randn(x_shape, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(5)
    sigma = model.config.noisesampler.sample((3,), g)
    eps = torch.randn(x_shape, generator=g)
    for eval_step in (make_eval_step(model), make_eval_step(model,
                                                            _raw=True)):
        drawn = eval_step(state, x, generator=torch.Generator()
                          .manual_seed(5))["valid_loss"]
        replayed = eval_step(state, x, sigma=sigma, eps=eps)["valid_loss"]
        assert float(drawn) == float(replayed)


# ---------------------------------------------------------------------------
# Trainer and fit_karras (after tests/test_trainer.py)
# ---------------------------------------------------------------------------
def _mlp_model(dim=2, hidden=(16,)):
    return KarrasModel(MLPUncond(dim, hidden, device="cpu"),
                       KarrasModelConfig.from_edm(loss_metric="mse"),
                       device="cpu")


def test_fit_karras_end_to_end(tmp_path):
    xs = np.zeros((256, 2), np.float32)
    state, trainer = fit_karras(
        _mlp_model(), xs, batch_size=32, max_epochs=2, val_fraction=0.25,
        ema=EMATracker(ema_type="traditional", decay=0.9), log_dir=tmp_path,
        seed=0, device="cpu", profile_dir=tmp_path / "prof",
        profile_steps=(2, 4))
    assert state.step == 2 * 6      # 192 train rows / 32
    assert trainer.logger.last("train_loss") is not None
    assert trainer.logger.last("valid_loss") is not None
    assert trainer.logger.last("imgs_per_sec") > 0
    assert (tmp_path / "metrics.jsonl").exists()
    assert state.ema.num_updates == state.step
    assert (tmp_path / "prof" / "trace.json").exists()
    assert trainer.profile_seconds > 0


def test_fit_karras_resume(tmp_path):
    from diffsci_tpu_torch.checkpoint import save_checkpoint

    xs = np.zeros((64, 2), np.float32)
    model = _mlp_model(hidden=(8,))
    state1, _ = fit_karras(model, xs, batch_size=32, seed=0, device="cpu")
    assert state1.step == 2
    save_checkpoint(tmp_path / "ckpt", state1)
    state2, _ = fit_karras(model, xs, batch_size=32, seed=0, device="cpu",
                           resume_from=tmp_path / "ckpt")
    assert state2.step == 4      # continued from step 2


def test_no_validation_fit_checkpoints(tmp_path):
    """Without validation a fit still leaves a restorable checkpoint:
    cadence saves plus a save-last on exit."""
    xs = np.zeros((96, 2), np.float32)
    model = _mlp_model(hidden=(8,))
    mgr = CheckpointManager(tmp_path / "ckpts", max_to_keep=3)
    fit_karras(model, xs, batch_size=32, seed=0, checkpoint_manager=mgr,
               save_every_steps=2, device="cpu")
    template, _ = create_train_state(model, (32, 2), seed=None)
    restored, step = mgr.restore_latest(template)
    assert step == 3 and restored.step == 3
    assert mgr.all_steps() == [2, 3]
    mgr.close()


def test_save_last_not_duplicated(tmp_path):
    """When the last step has a cadence save, save-last adds none."""
    xs = np.zeros((64, 2), np.float32)
    mgr = CheckpointManager(tmp_path / "ckpts", max_to_keep=3)
    trainer_saves = []
    save = mgr.save
    mgr.save = lambda step, *a, **k: (trainer_saves.append(step),
                                      save(step, *a, **k))
    fit_karras(_mlp_model(hidden=(8,)), xs, batch_size=32, seed=0,
               checkpoint_manager=mgr, save_every_steps=1, device="cpu")
    assert trainer_saves == [1, 2] and mgr.latest_step() == 2
    mgr.close()


def test_multi_loader_validation(tmp_path):
    """Two named validation loaders log 'valid_loss/<name>'; the
    manager can monitor either key; a list is named by index."""
    model = _mlp_model()
    state, tx = create_train_state(model, (8, 2), seed=0)
    xs = np.zeros((64, 2), np.float32)
    val_loaders = {"zero": ArrayDataLoader(xs[32:48], 8, shuffle=False),
                   "shifted": ArrayDataLoader(xs[48:] + 3.0, 8,
                                              shuffle=False)}
    ckpt = CheckpointManager(tmp_path / "ck", max_to_keep=2,
                             monitor="valid_loss/shifted")
    trainer = Trainer(max_epochs=2, log_dir=tmp_path, val_loaders=val_loaders,
                      checkpoint_manager=ckpt, device="cpu")
    state = trainer.fit(state, make_train_step(model, tx),
                        ArrayDataLoader(xs[:32], 8, seed=0),
                        make_eval_step(model))
    vz = trainer.logger.last("valid_loss/zero")
    vs = trainer.logger.last("valid_loss/shifted")
    assert vz is not None and vs is not None and vs > vz
    rows = [r for r in trainer.logger.history if "valid_loss/shifted" in r]
    assert ckpt.best_step() == min(
        rows, key=lambda r: r["valid_loss/shifted"])["step"]
    out = trainer.validate_multi(state, make_eval_step(model),
                                 list(val_loaders.values()),
                                 torch.Generator().manual_seed(1))
    assert set(out) == {"valid_loss/0", "valid_loss/1"}
    ckpt.close()


def test_preemption_sigterm_saves_checkpoint(tmp_path):
    """SIGTERM mid-fit stops the loop at the next step boundary, the last
    step is saved, fit returns, the handler is restored and the run
    resumes from the saved step."""
    model = _mlp_model(hidden=(8,))
    state, tx = create_train_state(model, (4, 2), seed=0)
    data = np.random.default_rng(0).standard_normal((64, 2)) \
        .astype(np.float32)
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=3)
    trainer = Trainer(max_epochs=10_000, checkpoint_manager=mgr,
                      select_batch=model.select_batch, device="cpu")
    previous = signal.getsignal(signal.SIGTERM)
    timer = threading.Timer(0.5, lambda: os.kill(os.getpid(),
                                                 signal.SIGTERM))
    timer.start()
    try:
        out = trainer.fit(state, make_train_step(model, tx),
                          ArrayDataLoader(data, batch_size=4))
    finally:
        timer.cancel()
    final = out.step
    assert 0 < final < 10_000 * 16          # interrupted
    assert final in mgr.all_steps()
    assert trainer.logger.last("preempted_by_signal") == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) == previous
    template, _ = create_train_state(model, (4, 2), seed=1)
    restored, step = mgr.restore_latest(template)
    assert step == final and restored.step == final
    mgr.close()


def test_hyperparameter_manager(tmp_path):
    import json

    hp = HyperparameterManager()
    hp.add_model_config(_mlp_model(hidden=(8,)))
    hp.add_optimizer_config(learning_rate=1e-3, weight_decay=1e-4)
    hp.add_training_config(batch_size=256, max_epochs=10, stds=(0.05, 0.1))
    d = hp.export_dict()
    assert d["optimizer/learning_rate"] == 1e-3
    assert d["training/batch_size"] == 256
    assert d["model/tag"] == "edm"
    assert json.loads(hp.save(tmp_path / "hp.json").read_text()) == d


def test_entry_points_need_a_card_unless_cpu(monkeypatch, tmp_path):
    """With CUDA hidden, the entry points raise unless device="cpu"."""
    from diffsci_tpu_torch import SamplerService
    from diffsci_tpu_torch.models.karras import karras_model_from_description

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _mlp_model(hidden=(8,))
    desc = model.export_description()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_karras(model, np.zeros((8, 2), np.float32), batch_size=4)
    state, tx = create_train_state(model, (4, 2), seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer().fit(state, make_train_step(model, tx),
                      ArrayDataLoader(np.zeros((8, 2), np.float32), 4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        karras_model_from_description(desc)
    from diffsci_tpu_torch.checkpoint import save_checkpoint
    save_checkpoint(tmp_path / "c", state, description=desc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SamplerService.from_checkpoint(tmp_path / "c", (2,), ema_stds=())
    assert karras_model_from_description(desc, device="cpu").device.type \
        == "cpu"
