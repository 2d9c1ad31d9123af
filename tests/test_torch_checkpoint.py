"""The port's persistence against the JAX package and itself:
``save_checkpoint`` / ``restore_checkpoint`` (in place), the
``CheckpointManager``'s top-k, cadence and post-hoc EMA, the
``ModelRegistry``'s JSON, ``extract_submodule``,
``SamplerService.from_checkpoint`` and ``convert.from_jax_train_state``
(after ``tests/test_trainer.py`` and ``tests/test_ema.py``).

Tolerances: a restore is bit for bit; post-hoc weights equal the JAX
package's to 1e-12 relative (the same float64 solve) and the synthesized
shadows to rtol 1e-6 (f32 sums); a state carried over from JAX takes its
next step within ``tests/test_torch_training.py``'s training bound (99.9%
of entries within 0.01·lr, every entry within 2·lr after one step).
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsci_tpu import checkpoint as jcheckpoint
from diffsci_tpu.models import EMATracker as JEMATracker
from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import PUNetG as JPUNetG
from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig
from diffsci_tpu.models import create_train_state as jcreate_train_state
from diffsci_tpu.models import make_train_step as jmake_train_step
from diffsci_tpu.models.karras import ema as jema

from diffsci_tpu_torch import (CheckpointManager, EMATracker, KarrasModel,
                               KarrasModelConfig, ModelRegistry, PUNetG,
                               PUNetGCond, PUNetGConfig, SamplerService,
                               accumulate_gradients, create_train_state,
                               default_optimizer, make_train_step,
                               restore_checkpoint, save_checkpoint)
from diffsci_tpu_torch.checkpoint import (extract_submodule,
                                          load_description, load_state)
from diffsci_tpu_torch.convert import (from_jax_train_state,
                                       from_jax_variables)
from diffsci_tpu_torch.models.karras import (karras_model_from_description,
                                             solve_posthoc_weights,
                                             synthesize_posthoc_ema)
from diffsci_tpu_torch.models.nets import MLPUncond
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

LR = 1e-3
_STDS = [0.05, 0.1]


def _mlp_model(hidden=(8,)):
    return KarrasModel(MLPUncond(2, hidden, device="cpu"),
                       KarrasModelConfig.from_edm(), device="cpu")


def _steps(model, state, tx, tracker, n, seed=0):
    step = make_train_step(model, tx, ema=tracker)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((4, 2), generator=torch.Generator().manual_seed(9))
    for _ in range(n):
        step(state, x, generator=g)
    return state


def _tensors(state):
    from diffsci_tpu_torch.checkpoint import state_tensors
    return state_tensors(state)


def test_checkpoint_roundtrip_in_place(tmp_path):
    """Params, AdamW's moments and step, the accumulation's running mean
    and counters, both EMA profiles and the step come back bit for bit,
    into the template's own tensors; the next step from the restored state
    equals the next step from the saved one."""
    model = _mlp_model()
    tracker = EMATracker(ema_type="power", power_function_stds=_STDS)
    tx = accumulate_gradients(default_optimizer(LR), 2)
    state, tx = create_train_state(model, (4, 2), seed=0, optimizer=tx,
                                   ema=tracker)
    _steps(model, state, tx, tracker, 3)       # mid-cycle: a mean is held
    info = save_checkpoint(tmp_path / "ckpt", state,
                           description=model.export_description())
    assert info["bytes"] > 0 and info["write_seconds"] >= 0
    assert load_description(tmp_path / "ckpt") == \
        json.loads(json.dumps(model.export_description()))

    other = _mlp_model()
    template, _ = create_train_state(other, (4, 2), seed=1, optimizer=tx,
                                     ema=tracker)
    ptrs = {k: t.data_ptr() for k, t in _tensors(template).items()}
    restored = restore_checkpoint(tmp_path / "ckpt", template, other)
    assert restored is template
    assert (template.step, template.ema.num_updates) == (3, 3)
    assert (template.accum.mini_step, template.accum.gradient_step) == (1, 1)
    ours, theirs = _tensors(state), _tensors(template)
    assert set(ours) == set(theirs)
    assert any(k.startswith("accum/") for k in ours)
    assert any(k.startswith("optimizer/") for k in ours)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
        assert theirs[k].data_ptr() == ptrs[k], k
    _steps(model, state, tx, tracker, 1, seed=5)
    _steps(other, template, tx, tracker, 1, seed=5)
    for k, t in _tensors(state).items():
        assert torch.equal(t, _tensors(template)[k]), k


def test_restore_refuses_a_mismatched_template(tmp_path):
    model = _mlp_model()
    tracker = EMATracker(ema_type="power", power_function_stds=_STDS)
    state, _ = create_train_state(model, (4, 2), seed=0, ema=tracker)
    save_checkpoint(tmp_path / "c", state)
    wider, _ = create_train_state(_mlp_model((16,)), (4, 2), ema=tracker)
    with pytest.raises(ValueError, match="template"):
        restore_checkpoint(tmp_path / "c", wider)
    no_ema, _ = create_train_state(_mlp_model(), (4, 2))
    with pytest.raises(KeyError, match="unexpected"):
        restore_checkpoint(tmp_path / "c", no_ema)
    with pytest.raises(FileExistsError):
        save_checkpoint(tmp_path / "c", state, overwrite=False)


def test_model_registry_reads_across_packages(tmp_path):
    """models.json is plain JSON: the port reads the JAX package's entries
    and the JAX package reads the port's."""
    path = tmp_path / "models.json"
    reg = ModelRegistry(path)
    assert reg.list_models() == []
    reg.register("mnist-edm", "/ckpts/mnist", {"tag": "edm"})
    jreg = jcheckpoint.ModelRegistry(path)
    assert jreg.entry("mnist-edm")["description"]["tag"] == "edm"
    jreg.register("vol-edm", "/ckpts/vol", {"tag": "vp"})
    assert reg.list_models() == ["mnist-edm", "vol-edm"]
    assert reg.entry("vol-edm")["checkpoint"] == "/ckpts/vol"
    with pytest.raises(KeyError):
        reg.entry("nope")


def test_extract_submodule():
    """The inner PUNetG of a PUNetGCond, by its dotted prefix, loads into
    a bare PUNetG (input channels counting the concatenated condition)."""
    cfg = PUNetGConfig(model_channels=8, channel_expansion=[2],
                       input_channels=2, number_resnet_downward_block=1,
                       number_resnet_upward_block=1,
                       number_resnet_attn_block=1,
                       number_resnet_before_attn_block=1,
                       number_resnet_after_attn_block=1)
    wrapper = PUNetGCond(cfg, channel_conditional_items=("img",),
                         device="cpu")
    sub = extract_submodule(wrapper.state_dict(), "unet")
    bare = PUNetG(cfg, device="cpu")
    bare.load_state_dict(sub, strict=True)
    out = bare(torch.zeros((1, 2, 16, 16)), torch.ones(1))
    assert out.shape == (1, 1, 16, 16)
    with pytest.raises(KeyError, match="not found"):
        extract_submodule(wrapper.state_dict(), "nope")


def test_metric_save_replaces_cadence_save_same_step(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpts", max_to_keep=3)
    state = {"w": torch.ones(4)}
    mgr.save(2, state)                       # cadence save, no metrics
    mgr.save(2, state, {"valid_loss": 0.5})  # validation save, same step
    assert mgr.best_step() == 2
    mgr.save(4, state)
    mgr.save(4, state, {"valid_loss": 0.25})
    assert mgr.best_step() == 4 and mgr.all_steps() == [2, 4]
    mgr.close()


def test_cadence_saves_are_bounded_and_index_reopens(tmp_path):
    """Metricless saves are bounded by keep_cadence; metric saves keep the
    top max_to_keep; a new manager on the directory finds both."""
    mgr = CheckpointManager(tmp_path / "ckpts", max_to_keep=2,
                            keep_cadence=2)
    for step in range(1, 7):
        mgr.save(step, {"w": torch.full((4,), float(step))})
    assert mgr.all_steps() == [5, 6]
    for step, loss in ((7, 0.3), (8, 0.1), (9, 0.2)):
        mgr.save(step, {"w": torch.full((4,), float(step))},
                 {"valid_loss": loss})
    mgr.close()
    assert sorted(p.name for p in (tmp_path / "ckpts").iterdir()
                  if p.is_dir()) == ["5", "6", "8", "9"]
    again = CheckpointManager(tmp_path / "ckpts", max_to_keep=2)
    assert (again.all_steps(), again.best_step()) == ([5, 6, 8, 9], 8)
    template = {"w": torch.zeros(4)}
    _, step = again.restore_best(template)
    assert step == 8 and torch.equal(template["w"], torch.full((4,), 8.0))
    _, step = again.restore_latest(template)
    assert step == 9 and float(template["w"][0]) == 9.0
    again.close()


def test_old_saves_stay_until_the_new_one_is_written(tmp_path):
    """While the writer is busy, the saves that a new one makes surplus
    stay on disk and the index lists only finished saves, so a new process
    restores the last finished one; once the writes are done the surplus
    saves are gone."""
    root = tmp_path / "ckpts"
    mgr = CheckpointManager(root, max_to_keep=1, keep_cadence=1)
    mgr.save(1, {"w": torch.full((4,), 1.0)})
    mgr.save(2, {"w": torch.full((4,), 2.0)}, {"valid_loss": 0.5})
    mgr.wait_until_finished()
    gate = threading.Event()
    mgr._writer.submit(gate.wait)                    # the writer is busy
    mgr.save(3, {"w": torch.full((4,), 3.0)})        # drops cadence 1
    mgr.save(4, {"w": torch.full((4,), 4.0)}, {"valid_loss": 0.25})
    assert mgr.all_steps() == [3, 4]

    def on_disk():
        index = json.loads((root / "checkpoints.json").read_text())
        return ([e["step"] for e in index["checkpoints"]],
                sorted(int(p.name) for p in root.iterdir() if p.is_dir()))

    try:
        assert on_disk() == ([1, 2], [1, 2])
        again = CheckpointManager(root)
        template = {"w": torch.zeros(4)}
        assert again.restore_latest(template)[1] == 2
        assert torch.equal(template["w"], torch.full((4,), 2.0))
        again.close()
    finally:
        gate.set()
    mgr.close()
    assert on_disk() == ([3, 4], [3, 4])


def test_posthoc_ema_matches_jax():
    """The setup of tests/test_ema.py:173-219 (two tracked power profiles,
    snapshots every 50 of 1000 steps of a random walk): the weights equal
    the JAX package's solve, the synthesis its weighted sum, and the
    synthesized profile tracks a third profile tracked directly."""
    stds, target_std = (0.02, 0.12), 0.05
    tracked = EMATracker(ema_type="power", power_function_stds=stds)
    direct = EMATracker(ema_type="power", power_function_stds=(target_std,))
    params = {"w": torch.zeros(4)}
    st, sd = tracked.init(params), direct.init(params)
    walk = np.cumsum(np.random.default_rng(0).standard_normal((1000, 4))
                     .astype(np.float32) * 0.05, axis=0)
    snapshots, snap_ts, snap_stds = [], [], []
    for t in range(1, 1001):
        params = {"w": torch.from_numpy(walk[t - 1])}
        tracked.update(st, params)
        direct.update(sd, params)
        if t % 50 == 0:
            for i, s in enumerate(stds):
                snapshots.append({"w": st.profiles[i]["w"].clone()})
                snap_ts.append(t)
                snap_stds.append(s)
    np.testing.assert_allclose(
        solve_posthoc_weights(snap_ts, snap_stds, 1000, target_std),
        jema.solve_posthoc_weights(snap_ts, snap_stds, 1000, target_std),
        rtol=1e-12)
    synth = synthesize_posthoc_ema(snapshots, snap_ts, snap_stds, target_std)
    ref = jema.synthesize_posthoc_ema(
        [{"w": s["w"].numpy()} for s in snapshots], snap_ts, snap_stds,
        target_std)
    np.testing.assert_allclose(synth["w"].numpy(), np.asarray(ref["w"]),
                               rtol=1e-6)
    want = sd.profiles[0]["w"].numpy()
    err = np.abs(synth["w"].numpy() - want).max() / np.abs(want).mean()
    assert err < 2e-2, err


def test_manager_posthoc_ema_matches_float64(tmp_path):
    """CheckpointManager.synthesize_posthoc_ema over a run with EMA every
    4 steps: each checkpoint dated by its update boundary, the ones that
    share a boundary (the same shadows) counted once, and the result equal
    to the solved weights applied in float64 to the saved shadows (rtol
    1e-6 of the largest entry)."""
    model = _mlp_model((16,))
    tracker = EMATracker(ema_type="power", power_function_stds=_STDS,
                         update_every=4)
    state, tx = create_train_state(model, (4, 2), seed=0, ema=tracker)
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=None,
                            keep_cadence=10)
    for step in (3, 10, 11, 20, 22):
        _steps(model, state, tx, tracker, step - state.step)
        mgr.save(step, state)
    synth = mgr.synthesize_posthoc_ema(state, tracker, target_std=0.075)
    # boundaries 8 (10), 20 (20, 22: one stands for both); 3 is before 4
    used = {8: 11, 20: 22}
    w = solve_posthoc_weights([t for t in used for _ in _STDS],
                              _STDS * len(used), 20, 0.075)
    saved = {t: load_state(mgr.step_dir(s)) for t, s in used.items()}
    assert torch.equal(load_state(mgr.step_dir(20))["ema/0/model.net.0.bias"],
                       saved[20]["ema/0/model.net.0.bias"])
    for name, got in synth.items():
        ref = sum(wi * saved[t][f"ema/{i}/{name}"].double().numpy()
                  for wi, (t, i) in zip(w, [(t, i) for t in used
                                            for i in range(len(_STDS))]))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
    with pytest.raises(ValueError, match="power"):
        mgr.synthesize_posthoc_ema(state, EMATracker(), 0.075)
    mgr.close()


def test_from_checkpoint_serves_the_ema_profile(tmp_path):
    """SamplerService.from_checkpoint (CPU) serves EMA profile 0's weights:
    the same samples as a service over a model rebuilt from the
    description with those weights loaded, for one seed; raw weights with
    ema_profile=None."""
    model = _mlp_model((16,))
    tracker = EMATracker(ema_type="power", power_function_stds=_STDS)
    state, tx = create_train_state(model, (4, 2), seed=0, ema=tracker)
    _steps(model, state, tx, tracker, 3)
    save_checkpoint(tmp_path / "c", state,
                    description=model.export_description())
    kw = dict(batch_buckets=(1, 4), nsteps=4, device="cpu")
    served = {}
    for profile in (0, None):
        svc = SamplerService.from_checkpoint(tmp_path / "c", (2,),
                                             ema_profile=profile, **kw)
        served[profile] = svc.sample(3, generator=7)
        ref = karras_model_from_description(model.export_description(),
                                            device="cpu")
        weights = dict(state.params if profile is None else
                       tracker.get_params(state.ema, profile))
        ref.net.load_state_dict(weights, strict=True)
        np.testing.assert_array_equal(
            served[profile], SamplerService(ref, (2,), **kw).sample(
                3, generator=7))
    assert not np.array_equal(served[0], served[None])


def test_from_checkpoint_reads_any_run(tmp_path):
    """from_checkpoint reads the weights from the checkpoint alone: a run
    with gradient accumulation and one EMA profile serves with the default
    ema_stds; an EMA profile the run did not keep raises."""
    model = _mlp_model((16,))
    tracker = EMATracker(ema_type="power", power_function_stds=[0.1])
    tx = accumulate_gradients(default_optimizer(LR), 2)
    state, tx = create_train_state(model, (4, 2), seed=0, optimizer=tx,
                                   ema=tracker)
    _steps(model, state, tx, tracker, 3)
    save_checkpoint(tmp_path / "c", state,
                    description=model.export_description())
    kw = dict(batch_buckets=(4,), nsteps=4, device="cpu")
    served = SamplerService.from_checkpoint(tmp_path / "c", (2,), **kw)
    ref = karras_model_from_description(model.export_description(),
                                        device="cpu")
    ref.net.load_state_dict(tracker.get_params(state.ema, 0), strict=True)
    np.testing.assert_array_equal(
        served.sample(3, generator=7),
        SamplerService(ref, (2,), **kw).sample(3, generator=7))
    with pytest.raises(KeyError, match="EMA profiles: \\['0'\\]"):
        SamplerService.from_checkpoint(tmp_path / "c", (2,), ema_profile=1,
                                       **kw)


_SMALL = dict(model_channels=8, channel_expansion=(2,),
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1, num_heads=2)


def test_from_jax_train_state_continues_the_run(tmp_path):
    """A JAX PUNetG state after 3 steps (AdamW, power EMA of two
    profiles), saved with the JAX package's save_checkpoint and read back
    as numpy, becomes the port's state: its AdamW moments, EMA and counts
    are JAX's, and one more step in each package with the same draws
    agrees within the training bound, parameters and EMA alike."""
    x_shape = (2, 16, 16, 1)
    jmodel = JKarrasModel(JPUNetG(JPUNetGConfig(**_SMALL)),
                          JKarrasModelConfig.from_edm())
    jtracker = JEMATracker(ema_type="power", power_function_stds=_STDS)
    jstate, jtx = jcreate_train_state(jmodel, jax.random.PRNGKey(0), x_shape,
                                      ema=jtracker)

    def jloss(variables, key, x, y, replay, train=True):
        return jmodel.loss_fn(variables, key, x, replay["sigma"],
                              train=train, eps=replay["eps"])

    jstep = jmake_train_step(jmodel, jtx, ema=jtracker, loss_fn=jloss)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(x_shape).astype(np.float32)

    def draws():
        return (np.exp(rng.standard_normal(2) * 1.2 - 1.2).astype(np.float32),
                rng.standard_normal(x_shape).astype(np.float32))

    for k in range(3):
        sigma, eps = draws()
        jstate, _ = jstep(jstate, jax.random.PRNGKey(k), jnp.asarray(x),
                          None, {"sigma": sigma, "eps": eps})
    jcheckpoint.save_checkpoint(tmp_path / "jax", jstate)
    template, _ = jcreate_train_state(jmodel, jax.random.PRNGKey(1), x_shape,
                                      ema=jtracker)
    state_np = jax.tree.map(np.asarray, jcheckpoint.restore_checkpoint(
        tmp_path / "jax", template))

    model = KarrasModel(PUNetG(PUNetGConfig(**_SMALL), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    tracker = EMATracker(ema_type="power", power_function_stds=_STDS)
    tx = default_optimizer(LR)
    state = from_jax_train_state(state_np, model, tx, tracker)
    assert (state.step, state.ema.num_updates) == (3, 3)
    adam = state_np.opt_state[1][0]
    mu = from_jax_variables({"params": adam.mu})
    for name, p in state.params.items():
        slot = state.optimizer.state[p]
        assert float(slot["step"]) == float(adam.count) == 3
        assert torch.equal(slot["exp_avg"], mu[name]), name

    sigma, eps = draws()
    jstate, _ = jstep(jstate, jax.random.PRNGKey(3), jnp.asarray(x), None,
                      {"sigma": sigma, "eps": eps})
    make_train_step(model, tx, ema=tracker)(
        state, torch.from_numpy(x), sigma=torch.from_numpy(sigma),
        eps=torch.from_numpy(eps))
    for ours, theirs in [(state.params, jstate.params)] + [
            (state.ema.profiles[i], jstate.ema.profiles[i])
            for i in range(2)]:
        ref = from_jax_variables(jax.tree.map(np.asarray,
                                              {"params": theirs}))
        diff = np.concatenate([(ours[n].detach() - ref[n]).abs().flatten()
                               .numpy() for n in ours])
        assert np.quantile(diff, 0.999) <= 0.01 * LR
        assert diff.max() <= 2 * LR
    assert state.step == int(jstate.step) == 4
