"""The host-side training loop: epochs, metric logging, checkpoints,
validation, preemption safety and profiling.

Port of ``diffsci_tpu/trainer.py``. The compute lives in the train and
eval steps (``models/karras/train.py``), which on the card replay CUDA
graphs; this loop shuffles data, moves batches to the device ahead of the
step that uses them (``data.loading.prefetch_to_device``) and keeps the
books. It does not wait for the card: a step's metrics stay device
tensors, and only the logging steps (``log_every``), a validation's end
and a checkpoint's copy read from the device.
"""

from __future__ import annotations

import json
import pathlib
import signal
import threading
import time
from typing import Any, Callable, Iterable, Optional

import torch

from diffsci_tpu_torch.checkpoint import gather_state
from diffsci_tpu_torch.data.loading import (ArrayDataLoader,
                                            prefetch_to_device,
                                            split_indices, tree_leaves)
from diffsci_tpu_torch.utils import resolve_device


class MetricLogger:
    """JSONL metric log (``metrics.jsonl`` in ``log_dir``) and its rows in
    memory."""

    def __init__(self, log_dir: str | pathlib.Path | None = None):
        self.history: list[dict] = []
        self.log_path = None
        if log_dir is not None:
            p = pathlib.Path(log_dir)
            p.mkdir(parents=True, exist_ok=True)
            self.log_path = p / "metrics.jsonl"

    def log(self, step: int, metrics: dict[str, Any]):
        row = {"step": int(step)}
        row.update({k: float(v) for k, v in metrics.items()})
        self.history.append(row)
        if self.log_path is not None:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(row) + "\n")

    def last(self, key: str, default=None):
        for row in reversed(self.history):
            if key in row:
                return row[key]
        return default


class Trainer:
    """Epoch loop over train and eval steps.

    ``fit(state, step_fn, train_loader, eval_fn=None, val_loader=None)``
    with ``step_fn(state, x, y, mask, generator=...) -> (state, metrics)``
    and ``eval_fn(state, x, y, mask, generator=...) -> metrics``, as
    ``make_train_step`` and ``make_eval_step`` build them. The loaders
    yield arrays (x) or tuples that ``select_batch`` splits (the model's
    ``select_batch``). The random draws of the steps come from one
    ``torch.Generator`` on ``device``, seeded by ``seed`` when ``fit``
    starts (a resumed fit starts it from ``seed`` again, as the JAX
    package restarts its key).

    ``device``: where the batches go, the CUDA card unless ``"cpu"`` is
    given.

    ``mesh`` (a ``DeviceMesh`` with a ``data`` axis; every rank runs the
    same ``fit``): data parallelism over a state that
    ``parallel.replicate`` (or a ``shard_state_*``) placed. A loader that
    yields whole batches (``process_count`` 1) has each batch cut to this
    rank's rows (``shard_batch``); one that yields this rank's rows
    already (``ArrayDataLoader`` under a process group) is taken as it
    is. Rank 0 alone writes the metric log and the checkpoints, which
    hold whole tensors: every rank gathers the shards of an FSDP, tensor-
    or expert-parallel state before rank 0 saves, so a checkpoint
    restores at any world size."""

    def __init__(self,
                 max_epochs: int = 1,
                 max_steps: int | None = None,
                 mesh=None,
                 seed: int = 0,
                 log_every: int = 50,
                 val_every_epochs: int = 1,
                 checkpoint_manager=None,
                 save_every_steps: int | None = None,
                 save_last: bool = True,
                 log_dir: str | pathlib.Path | None = None,
                 select_batch: Callable | None = None,
                 profile_dir: str | pathlib.Path | None = None,
                 profile_steps: tuple[int, int] | None = None,
                 prefetch: int = 2,
                 val_loaders: "dict[str, Iterable] | list | None" = None,
                 device: torch.device | str | None = None):
        self.mesh = mesh
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.seed = seed
        self.log_every = log_every
        self.val_every_epochs = val_every_epochs
        self.checkpoint_manager = checkpoint_manager
        # step-cadence and save-on-exit checkpoints, with or without
        # validation
        self.save_every_steps = save_every_steps
        self.save_last = save_last
        self._last_saved_step = -1
        self.logger = MetricLogger(log_dir if self._writes else None)
        self.select_batch = select_batch or (lambda b: (b, None, None))
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        # the finished torch.profiler run of profile_steps, and its host
        # seconds (start to stop, ended by a synchronize)
        self.profiler = None
        self.profile_seconds = None
        self.prefetch = prefetch
        # validation over several loaders: metrics suffixed '/<name>'
        if isinstance(val_loaders, (list, tuple)):
            val_loaders = {str(i): ld for i, ld in enumerate(val_loaders)}
        self.val_loaders = val_loaders
        self.device = device

    @property
    def _writes(self) -> bool:
        """Whether this process writes logs and checkpoints (rank 0 of a
        mesh, or no mesh)."""
        return self.mesh is None or torch.distributed.get_rank() == 0

    def _batches(self, loader, device):
        """(x, y, mask) tuples of tensors on ``device``, ``prefetch`` of
        them copied ahead; over a mesh, this rank's rows."""
        batches = (self.select_batch(b) for b in loader)
        if self.mesh is not None and getattr(loader, "process_count",
                                             1) == 1:
            from diffsci_tpu_torch.parallel.mesh import shard_batch
            batches = (shard_batch(b, self.mesh) for b in batches)
        return prefetch_to_device(batches, self.prefetch, device)

    def fit(self, state, step_fn, train_loader: Iterable,
            eval_fn: Optional[Callable] = None,
            val_loader: Optional[Iterable] = None):
        device = resolve_device(self.device)
        generator = torch.Generator(device).manual_seed(self.seed)
        step = state.step
        # Preemption safety: the first SIGTERM or SIGINT sets a flag, the
        # loop stops at the next step boundary and the save-last below
        # writes the final checkpoint, so a resume starts where the signal
        # came; a second signal takes the default action (a wedged save
        # must not block the kill). Only the main thread installs
        # handlers.
        preempted: list[int] = []
        installed = {}
        if self.checkpoint_manager is not None and \
                threading.current_thread() is threading.main_thread():
            def on_signal(signum, frame):
                preempted.append(signum)
                signal.signal(signum, installed[signum])

            for sig in (signal.SIGTERM, signal.SIGINT):
                # a handler installed outside Python reads as None
                installed[sig] = signal.signal(sig, on_signal) or \
                    signal.SIG_DFL
        try:
            state, step = self._fit_loop(state, step_fn, train_loader,
                                         eval_fn, val_loader, generator,
                                         step, device, preempted)
        finally:
            for sig, prev in installed.items():
                signal.signal(sig, prev)
        if preempted:
            self.logger.log(step, {"preempted_by_signal": preempted[0]})
        if (self.checkpoint_manager is not None and self.save_last
                and step > 0 and step != self._last_saved_step):
            self._save(step, state)
        if self.checkpoint_manager is not None:
            # the writes finish before fit returns, on every rank
            if self._writes:
                self.checkpoint_manager.wait_until_finished()
            if self.mesh is not None:
                torch.distributed.barrier()
        return state

    def _save(self, step, state, metrics=None) -> None:
        if self.checkpoint_manager is None:
            return
        if self.mesh is not None:
            # every rank: the tensors the mesh shards gathered whole
            state = gather_state(state)
        if self._writes:
            self.checkpoint_manager.save(step, state, metrics)
        self._last_saved_step = step

    def _fit_loop(self, state, step_fn, train_loader, eval_fn, val_loader,
                  generator, step, device, preempted):
        t_start = time.perf_counter()
        images_seen = 0
        profile = bool(self.profile_dir and self.profile_steps)
        for epoch in range(self.max_epochs):
            if preempted:
                break
            for x, y, mask in self._batches(train_loader, device):
                if profile and step == self.profile_steps[0]:
                    self._start_profile(device)
                state, metrics = step_fn(state, x, y, mask,
                                         generator=generator)
                if profile and step == self.profile_steps[1]:
                    self._stop_profile(device)
                step += 1
                images_seen += x.shape[0]
                if step % self.log_every == 0 or step == 1:
                    row = {k: float(v) for k, v in metrics.items()}
                    elapsed = time.perf_counter() - t_start
                    row["imgs_per_sec"] = images_seen / max(elapsed, 1e-9)
                    self.logger.log(step, row)
                if self.save_every_steps and \
                        step % self.save_every_steps == 0:
                    self._save(step, state)
                if self.max_steps is not None and step >= self.max_steps:
                    break
                if preempted:
                    break
            if preempted:
                break
            if (epoch + 1) % self.val_every_epochs == 0 and \
                    eval_fn is not None:
                if val_loader is not None:
                    val = self.validate(state, eval_fn, val_loader,
                                        generator, device)
                    self.logger.log(step, val)
                    self._save(step, state, val)
                if self.val_loaders is not None:
                    val = self.validate_multi(state, eval_fn,
                                              self.val_loaders, generator,
                                              device)
                    self.logger.log(step, val)
                    self._save(step, state, val)
            if self.max_steps is not None and step >= self.max_steps:
                break
        return state, step

    def _start_profile(self, device) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            activities.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=activities)
        self.profiler.start()
        self._profile_t0 = time.perf_counter()

    def _stop_profile(self, device) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.profile_seconds = time.perf_counter() - self._profile_t0
        self.profiler.stop()
        out = pathlib.Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        self.profiler.export_chrome_trace(str(out / "trace.json"))

    def validate(self, state, eval_fn, val_loader, generator=None,
                 device=None) -> dict[str, float]:
        """The mean of each eval metric over ``val_loader``'s batches
        (summed on the device, read once at the end)."""
        device = resolve_device(self.device if device is None else device)
        sums: dict = {}
        count = 0
        for x, y, mask in self._batches(val_loader, device):
            metrics = eval_fn(state, x, y, mask, generator=generator)
            for k, v in metrics.items():
                sums[k] = v + sums[k] if k in sums else v
            count += 1
        return {k: float(v) / max(count, 1) for k, v in sums.items()}

    def validate_multi(self, state, eval_fn, val_loaders, generator=None,
                       device=None) -> dict[str, float]:
        """Per-loader validation metrics, each key suffixed '/<name>' (a
        list is named by index); a ``CheckpointManager`` can monitor e.g.
        'valid_loss/ocean'."""
        if isinstance(val_loaders, (list, tuple)):
            val_loaders = {str(i): ld for i, ld in enumerate(val_loaders)}
        out: dict[str, float] = {}
        for name, loader in val_loaders.items():
            metrics = self.validate(state, eval_fn, loader, generator,
                                    device)
            out.update({f"{k}/{name}": v for k, v in metrics.items()})
        return out


def fit_karras(model, dataset, *, batch_size=32, max_epochs=1,
               max_steps=None, mesh=None, ema=None, optimizer=None,
               seed=0, val_fraction=0.0, log_dir=None,
               checkpoint_manager=None, save_every_steps=None, log_every=50,
               x_shape=None, resume_from=None, profile_dir=None,
               profile_steps=None, device=None):
    """Train a ``KarrasModel`` in one call: the train state (weights from
    ``seed``), the graphed train step, the eval step when
    ``val_fraction`` > 0 (``train_val_split``'s rows by ``seed``), the
    loaders and a ``Trainer``. ``dataset``: channels-last arrays, memmaps
    or CPU tensors (or a tuple for ``model.select_batch``); the split is
    by row indices, so each batch reads only its rows of a memmap, with
    or without validation. Runs on the CUDA
    card unless ``device="cpu"`` is given; the model is moved there.

    ``resume_from``: a checkpoint directory (``save_checkpoint``'s, or a
    ``CheckpointManager`` step directory); the fresh state is the restore
    template, so the optimizer and EMA must match the saved run's.
    ``mesh`` (a ``DeviceMesh`` with a ``data`` axis; every rank calls):
    data parallelism, as the JAX package's: the state is replicated from
    rank 0 (``parallel.replicate``), each rank loads its rows of every
    global batch of ``batch_size`` (the loaders' per-process shards), and
    the step averages the gradients over the ranks.
    Returns (state, trainer)."""
    from diffsci_tpu_torch.checkpoint import restore_checkpoint
    from diffsci_tpu_torch.models.karras.train import (create_train_state,
                                                       make_eval_step,
                                                       make_train_step)

    device = resolve_device(device)
    model.to(device)
    if x_shape is None:
        probe = dataset if not isinstance(dataset, tuple) else dataset[0]
        x_shape = (batch_size,) + tuple(probe.shape[1:])
    state, tx = create_train_state(model, x_shape, seed=seed,
                                   optimizer=optimizer, ema=ema)
    if resume_from is not None:
        restore_checkpoint(resume_from, state, model)
    if mesh is not None:
        from diffsci_tpu_torch.parallel.mesh import replicate
        replicate(state, mesh)
    step_fn = make_train_step(model, tx, ema=ema)
    eval_fn = val_loader = train_idx = None
    if val_fraction > 0:
        train_idx, val_idx = split_indices(tree_leaves(dataset)[0].shape[0],
                                           val_fraction, seed)
        val_loader = ArrayDataLoader(dataset, batch_size, shuffle=False,
                                     indices=val_idx)
        eval_fn = make_eval_step(model, ema=ema)
    train_loader = ArrayDataLoader(dataset, batch_size, seed=seed,
                                   indices=train_idx)
    trainer = Trainer(max_epochs=max_epochs, max_steps=max_steps, mesh=mesh,
                      seed=seed,
                      log_every=log_every, log_dir=log_dir,
                      checkpoint_manager=checkpoint_manager,
                      save_every_steps=save_every_steps,
                      select_batch=model.select_batch,
                      profile_dir=profile_dir, profile_steps=profile_steps,
                      device=device)
    state = trainer.fit(state, step_fn, train_loader, eval_fn, val_loader)
    return state, trainer


class HyperparameterManager:
    """Flattened hyperparameters of the model, optimizer and training
    configs for experiment tracking, saved as JSON next to the metrics
    log; pass ``export_dict()`` to any tracker."""

    def __init__(self):
        self.hparams: dict = {}

    def add_model_config(self, model):
        config = getattr(model, "config", None)
        export = getattr(config, "export_description", None)
        if export is not None:
            self._flatten("model", export())

    def add_optimizer_config(self, **kwargs):
        self._flatten("optimizer", kwargs)

    def add_training_config(self, **kwargs):
        self._flatten("training", kwargs)

    def _flatten(self, prefix, d):
        for k, v in d.items():
            key = f"{prefix}/{k}"
            if isinstance(v, dict):
                self._flatten(key, v)
            elif isinstance(v, (int, float, str, bool)) or v is None:
                self.hparams[key] = v
            elif isinstance(v, (list, tuple)):
                self.hparams[key] = list(v)
            else:
                self.hparams[key] = repr(v)

    def export_dict(self) -> dict:
        return dict(self.hparams)

    def save(self, path):
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.hparams, indent=2, sort_keys=True))
        return p
