"""Checkpoints: a train state saved with ``torch.save`` beside its JSON
description, top-k management over a run's directory, post-hoc EMA from
the retained checkpoints, and the ``models.json`` registry.

Port of ``diffsci_tpu/checkpoint.py``. A checkpoint is a directory with
``state.pt``, one flat dict of tensors by name, and ``description.json``
(the model's ``export_description``, as the JAX package writes it):

- ``params/<name>`` and ``buffers/<name>``: the network's tensors by the
  port's dotted names (the batch norm's running statistics are buffers);
- ``optimizer/<name>/{step,exp_avg,exp_avg_sq}``: AdamW's state of each
  trained parameter;
- ``accum/<name>``, ``accum/mini_step``, ``accum/gradient_step``: the
  gradient accumulation's running mean and counters, where there is one;
- ``ema/<profile>/<name>`` and ``ema/num_updates``: the EMA shadows;
- ``step``.

A state that a mesh shards (``parallel``: FSDP, tensor or expert
parallelism) is saved whole: every rank calls, the shards are
all-gathered (``gather_state``) and rank 0 writes; restoring it into a
placed template keeps each rank's block of every saved tensor. So a
checkpoint reads back at any world size, one process included.

Saving copies the state to pinned host memory on the caller's stream and
waits for that copy, so the graphs that update the state in place can go
on; only the write to disk may run on a background thread (the
manager's). Files are written under a temporary name, then renamed.
Restoring copies into the template's own tensors in place, since the
captured CUDA graphs of the train and eval steps read those tensors: a
mismatched name or shape raises.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import pathlib
import shutil
import time
from typing import Any

import torch

from diffsci_tpu_torch.models.karras.ema import (accumulate_weighted,
                                                 solve_posthoc_weights)
from diffsci_tpu_torch.parallel.placement import block

STATE_FILE = "state.pt"
DESCRIPTION_FILE = "description.json"
INDEX_FILE = "checkpoints.json"


def _optimizer_tensors(prefix: str, optimizer, params: dict) -> dict:
    names = {id(p): k for k, p in params.items()}
    return {f"{prefix}/{names[id(p)]}/{key}": t
            for group in optimizer.param_groups for p in group["params"]
            for key, t in optimizer.state[p].items()}


def state_tensors(state) -> dict[str, torch.Tensor]:
    """The tensors of a train state by checkpoint name (the live tensors,
    not copies: over a mesh, this rank's shards); a dict of tensors is
    taken as it is. A ``VAETrainState`` adds its discriminator's
    parameters and optimizer (``disc_params/``, ``disc_optimizer/``) and
    its step counter."""
    if isinstance(state, dict):
        return dict(state)
    out = {f"params/{k}": p.detach() for k, p in state.params.items()}
    out.update({f"buffers/{k}": b for k, b in state.buffers.items()})
    out.update(_optimizer_tensors("optimizer", state.optimizer,
                                  state.params))
    if getattr(state, "disc_params", None) is not None:
        out.update({f"disc_params/{k}": p.detach()
                    for k, p in state.disc_params.items()})
        out.update(_optimizer_tensors("disc_optimizer", state.disc_optimizer,
                                      state.disc_params))
    if hasattr(state, "counter"):
        out["counter"] = state.counter
    if state.accum is not None:
        out.update({f"accum/{k}": g for k, g in state.accum.grads.items()})
    if state.ema is not None:
        for i, profile in enumerate(state.ema.profiles):
            out.update({f"ema/{i}/{k}": v for k, v in profile.items()})
    return out


def _param_name(name: str) -> str | None:
    """The parameter a checkpoint name belongs to, or None (a buffer)."""
    parts = name.split("/")
    if parts[0] in ("params", "optimizer", "accum"):
        return parts[1]
    if parts[0] == "ema":
        return parts[2]
    return None


def _shards(state, tensors: dict) -> dict:
    """Checkpoint name -> spec of each of ``tensors`` (``state``'s) that
    is this rank's block of a whole tensor: under FSDP, TP and EP the
    sharded parameters, their moments and shadows; {} for a state that no
    mesh shards."""
    placement = getattr(state, "placement", None)
    if placement is None:
        return {}
    specs, local = placement.specs, state.params
    out = {}
    for name, t in tensors.items():
        key = _param_name(name)
        spec = specs.get(key, ()) if key is not None else ()
        if spec and t.ndim and t.shape == local[key].shape:
            out[name] = spec
    return out


def gather_state(state) -> dict[str, torch.Tensor]:
    """A train state's checkpoint as one dict: its tensors by checkpoint
    name, each that a mesh shards made whole (all-gathered: every rank of
    the mesh calls), and its counters as int64 tensors. A dict of tensors
    is taken as it is. Saving the dict writes what saving the state
    writes."""
    tensors = state_tensors(state)
    for name, spec in _shards(state, tensors).items():
        tensors[name] = state.placement.whole(tensors[name], spec)
    for name, value in _counters(state).items():
        tensors[name] = torch.tensor(value, dtype=torch.int64)
    return tensors


def _counters(state) -> dict[str, int]:
    """The host integers of a train state by checkpoint name."""
    if isinstance(state, dict):
        return {}
    out = {"step": state.step}
    if state.ema is not None:
        out["ema/num_updates"] = state.ema.num_updates
    if state.accum is not None:
        out["accum/mini_step"] = state.accum.mini_step
        out["accum/gradient_step"] = state.accum.gradient_step
    return out


def _set_counters(state, saved: dict) -> None:
    if isinstance(state, dict):
        return
    state.step = int(saved["step"])
    if state.ema is not None:
        state.ema.num_updates = int(saved["ema/num_updates"])
    if state.accum is not None:
        state.accum.mini_step = int(saved["accum/mini_step"])
        state.accum.gradient_step = int(saved["accum/gradient_step"])


def snapshot(state) -> tuple[dict[str, torch.Tensor], float]:
    """Host copies of ``gather_state(state)``: device tensors into pinned
    buffers on the caller's stream, then one wait for those copies.
    Returns (the dict to save, the seconds of the copy)."""
    t0 = time.perf_counter()
    out, streams = {}, set()
    for name, t in gather_state(state).items():
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            streams.add(torch.cuda.current_stream(t.device))
        else:
            buf = t.detach().clone()
        out[name] = buf
    for stream in streams:
        stream.synchronize()
    return out, time.perf_counter() - t0


def _replace_write(path: pathlib.Path, write) -> None:
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    os.replace(tmp, path)


def write_snapshot(path: str | pathlib.Path, snap: dict,
                   description: dict[str, Any] | None = None) -> float:
    """Write ``snapshot``'s dict (and the description) into the directory
    ``path``. Returns the seconds it took."""
    t0 = time.perf_counter()
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    _replace_write(path / STATE_FILE, lambda p: torch.save(snap, p))
    if description is not None:
        _replace_write(path / DESCRIPTION_FILE, lambda p: p.write_text(
            json.dumps(description, indent=2)))
    return time.perf_counter() - t0


def _nbytes(snap: dict) -> int:
    return sum(t.numel() * t.element_size() for t in snap.values())


def save_checkpoint(path: str | pathlib.Path, state,
                    description: dict[str, Any] | None = None,
                    overwrite: bool = True) -> dict[str, float]:
    """Save a train state (or a dict of tensors) into the directory
    ``path``, with the description (``model.export_description()``)
    beside it. ``overwrite=True`` replaces a checkpoint at the same path.
    Returns the saved bytes and the seconds of the device-to-host copy
    and of the disk write. A state over a mesh: every rank calls, and
    rank 0 writes."""
    path = pathlib.Path(path).absolute()
    if not overwrite and (path / STATE_FILE).exists():
        raise FileExistsError(f"a checkpoint exists at {path}")
    snap, copy_seconds = snapshot(state)
    write_seconds = 0.0
    if getattr(state, "placement", None) is None or \
            torch.distributed.get_rank() == 0:
        write_seconds = write_snapshot(path, snap, description)
    return {"bytes": _nbytes(snap), "copy_seconds": copy_seconds,
            "write_seconds": write_seconds}


def load_state(path: str | pathlib.Path) -> dict[str, torch.Tensor]:
    """A checkpoint's dict of tensors, on the CPU."""
    return torch.load(pathlib.Path(path) / STATE_FILE, map_location="cpu",
                      weights_only=True)


def _copy_into(tensors: dict[str, torch.Tensor], saved: dict,
               path) -> None:
    """Copy ``saved[name]`` into each ``tensors[name]`` in place, grouped
    by device; a name the checkpoint lacks, or a shape or dtype that
    differs, raises before anything is copied."""
    missing = sorted(set(tensors) - set(saved))
    if missing:
        raise KeyError(f"checkpoint {path} lacks {missing[:5]}")
    for name, t in tensors.items():
        if saved[name].shape != t.shape or saved[name].dtype != t.dtype:
            raise ValueError(
                f"checkpoint {path}: {name} is {tuple(saved[name].shape)} "
                f"{saved[name].dtype}, the template's "
                f"{tuple(t.shape)} {t.dtype}")
    by_device: dict = {}
    for name, t in tensors.items():
        by_device.setdefault(t.device, []).append((t, saved[name]))
    with torch.no_grad():
        for device, pairs in by_device.items():
            torch._foreach_copy_([dst for dst, _ in pairs],
                                 [src.to(device) for _, src in pairs])


def restore_checkpoint(path: str | pathlib.Path, state_template,
                       model=None):
    """Restore the checkpoint at ``path`` into ``state_template`` (a
    train state made like the saved one, e.g. a fresh
    ``create_train_state``, or the live state itself) in place: every
    tensor is copied into the template's own (``torch._foreach_copy_``),
    so CUDA graphs captured over the template go on reading the restored
    values, and the counters are set. The names and shapes must match
    the saved ones exactly. A template over a mesh takes its block of
    each tensor that the mesh shards (every rank reads the file).
    ``model``: the ``KarrasModel`` whose weights these are, whose cast
    copy is then refreshed. Returns the template."""
    saved = load_state(path)
    tensors, counters = state_tensors(state_template), \
        _counters(state_template)
    missing = sorted((set(tensors) | set(counters)) - set(saved))
    extra = sorted(set(saved) - set(tensors) - set(counters))
    if missing or extra:
        raise KeyError(f"checkpoint {path} does not match the template: "
                       f"missing {missing[:5]}, unexpected {extra[:5]}")
    placement = getattr(state_template, "placement", None)
    for name, spec in _shards(state_template, tensors).items():
        saved[name] = block(saved[name], spec, placement.mesh)
    _copy_into(tensors, saved, path)
    _set_counters(state_template, saved)
    if model is not None:
        model._masters_changed()
    return state_template


def restore_weights(path: str | pathlib.Path, model,
                    ema_profile: int | None = None):
    """Copy a checkpoint's network weights into ``model.net`` in place:
    the shadows of EMA profile ``ema_profile``, or the raw parameters when
    it is None, and the buffers; then refresh the model's cast copy. It
    needs no train state, so it reads the checkpoint of any run, whatever
    its optimizer, freezing, accumulation or EMA. Every parameter and
    buffer of the network must be in the checkpoint with its shape.
    Returns the model."""
    saved = load_state(path)
    source = "params" if ema_profile is None else f"ema/{ema_profile}"
    if not any(k.startswith(source + "/") for k in saved):
        profiles = sorted({k.split("/")[1] for k in saved
                           if k.startswith("ema/") and k != "ema/num_updates"})
        raise KeyError(f"checkpoint {path} holds no {source!r}; its EMA "
                       f"profiles: {profiles}")
    tensors = {f"{source}/{k}": p.detach()
               for k, p in model.net.named_parameters()}
    tensors.update({f"buffers/{k}": b for k, b in model.net.named_buffers()})
    _copy_into(tensors, saved, path)
    model._masters_changed()
    return model


def load_description(path: str | pathlib.Path) -> dict[str, Any] | None:
    p = pathlib.Path(path) / DESCRIPTION_FILE
    return json.loads(p.read_text()) if p.exists() else None


def extract_submodule(state_dict: dict, prefix: str) -> dict:
    """The entries of a state dict under the module ``prefix`` (the port's
    dotted names, e.g. ``"unet"`` or ``"model.unet"``), without the
    prefix: the weights a bare ``PUNetG`` loads after training a
    ``PUNetGCond`` around it."""
    head = prefix.rstrip(".") + "."
    out = {k[len(head):]: v for k, v in state_dict.items()
           if k.startswith(head)}
    if not out:
        scopes = sorted({k.split(".")[0] for k in state_dict})
        raise KeyError(f"submodule {prefix!r} not found; available "
                       f"scopes: {scopes}")
    return out


class CheckpointManager:
    """Top-k and save-last management of a run's checkpoints, one
    directory per step under ``directory`` (the JAX package's orbax
    manager: ``checkpoint.py:100-175``).

    Saves with metrics compete for the ``max_to_keep`` best by
    ``metrics[monitor]`` (``mode`` "min" or "max"); saves without
    metrics stay out of that competition, and the newest ``keep_cadence``
    of them are kept. The steps and their metrics are kept in a small JSON
    index in the directory, so a new process finds the best step. The
    disk writes, and after each the index and the deletions it calls for,
    run in order on one background thread; ``wait_until_finished`` joins
    them, and anything that reads a checkpoint waits for the writes
    first."""

    def __init__(self, directory: str | pathlib.Path, max_to_keep: int = 3,
                 monitor: str = "valid_loss", mode: str = "min",
                 keep_cadence: int = 2):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode
        self.keep_cadence = keep_cadence
        self._writer = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: list[concurrent.futures.Future] = []
        index = self.directory / INDEX_FILE
        saved = json.loads(index.read_text()) if index.exists() else {}
        # [{"step", "metrics" (None for a cadence save)}], by step
        self._entries: list[dict] = saved.get("checkpoints", [])
        self._cadence_steps: list[int] = saved.get("cadence", [])
        self.last_save: dict[str, float] | None = None

    def step_dir(self, step: int) -> pathlib.Path:
        return self.directory / str(step)

    def all_steps(self) -> list[int]:
        return sorted(e["step"] for e in self._entries)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _ranked(self) -> list[dict]:
        """The metric saves from worst to best (orbax's order)."""
        return sorted((e for e in self._entries if e["metrics"] is not None),
                      key=lambda e: e["metrics"].get(self.monitor,
                                                     float("inf")),
                      reverse=self.mode == "min")

    def best_step(self) -> int | None:
        ranked = self._ranked()
        return ranked[-1]["step"] if ranked else None

    def save(self, step: int, state,
             metrics: dict[str, float] | None = None) -> None:
        """Save ``state`` (a train state or a dict of tensors) at ``step``.
        ``metrics=None`` marks a cadence (crash-safety) save, which a
        second save at the same step does not replace; a metric save at a
        step that already has a save replaces it, so the metric is
        recorded. ``last_save`` holds the bytes and the seconds of the
        device-to-host copy (the write's seconds once it is done).

        The saves that this one makes surplus are deleted, and the index
        rewritten, on the writer thread once the new save is on disk: a
        kill at any moment leaves the newest finished save in place, and
        the index on disk lists only finished saves."""
        if metrics is None and step in self.all_steps():
            return
        if metrics is not None:
            metrics = {k: float(v) for k, v in metrics.items()}
            if step in self._cadence_steps:
                self._cadence_steps.remove(step)
        snap, copy_seconds = snapshot(state)
        self.last_save = {"bytes": _nbytes(snap),
                          "copy_seconds": copy_seconds}
        record = self.last_save
        # a save at the same step is overwritten file by file (renames)
        self._entries = sorted(
            [e for e in self._entries if e["step"] != step]
            + [{"step": step, "metrics": metrics}], key=lambda e: e["step"])
        dropped = []
        if self.max_to_keep is not None and \
                len(self._entries) > self.max_to_keep:
            best = {e["step"] for e in self._ranked()[-self.max_to_keep:]}
            dropped += [e["step"] for e in self._entries
                        if e["metrics"] is not None and e["step"] not in best]
        if metrics is None:
            self._cadence_steps.append(step)
            while len(self._cadence_steps) > self.keep_cadence:
                dropped.append(self._cadence_steps.pop(0))
        self._entries = [e for e in self._entries if e["step"] not in dropped]
        index = json.dumps({"checkpoints": self._entries,
                            "cadence": self._cadence_steps}, indent=1)

        def write():
            record["write_seconds"] = write_snapshot(self.step_dir(step),
                                                     snap)
            _replace_write(self.directory / INDEX_FILE,
                           lambda p: p.write_text(index))
            for old in dropped:
                shutil.rmtree(self.step_dir(old), ignore_errors=True)

        self._pending.append(self._writer.submit(write))

    def wait_until_finished(self) -> None:
        """Join the background writes (safe to call any time); a write's
        error is raised here."""
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    def _restore(self, step, state_template, model):
        if step is None:
            return None, None
        self.wait_until_finished()
        return restore_checkpoint(self.step_dir(step), state_template,
                                  model), step

    def restore_latest(self, state_template, model=None):
        """(the template restored in place from the latest step, step), or
        (None, None) when nothing is saved."""
        return self._restore(self.latest_step(), state_template, model)

    def restore_best(self, state_template, model=None):
        """As ``restore_latest``, from the best metric save."""
        return self._restore(self.best_step(), state_template, model)

    def synthesize_posthoc_ema(self, state_template, tracker,
                               target_std: float, target_t=None) -> dict:
        """Post-hoc EMA (arXiv:2312.02696 §3.3) from this directory's
        checkpoints: the power-EMA shadows of every retained checkpoint,
        least-squares combined into the ``target_std`` profile at
        ``target_t`` (default: the latest snapshot's step). ``tracker`` is
        the run's ``EMATracker``. Each shadow is dated by the last
        ``update_every`` boundary before its step, when it was last
        written; shadows still at their initial copy are skipped, and of
        checkpoints that share a boundary (so hold the same shadows, which
        would make the solve singular) the latest stands for all. The
        weights are solved first and the checkpoints added one at a time
        (one ``torch._foreach_add_`` chain per shadow, on the template's
        device). Returns the f32 parameters by name."""
        if tracker.ema_type != "power":
            raise ValueError("post-hoc synthesis needs power-profile EMA")
        self.wait_until_finished()
        steps = self.all_steps()
        if not steps:
            raise ValueError("no checkpoints saved")
        every = max(int(tracker.update_every), 1)
        by_boundary = {(s // every) * every: s for s in steps
                       if (s // every) * every > 0}
        if not by_boundary:
            raise ValueError("no checkpoint is past the first EMA update "
                             f"boundary (update_every={every})")
        stds = list(tracker.power_function_stds)
        ts = [t for t in sorted(by_boundary) for _ in stds]
        if target_t is None:
            target_t = max(ts)
        w = solve_posthoc_weights(ts, stds * len(by_boundary), target_t,
                                  target_std)
        params = state_template.params
        acc, idx = None, 0
        with torch.no_grad():
            for t in sorted(by_boundary):
                saved = load_state(self.step_dir(by_boundary[t]))
                for i in range(len(stds)):
                    names = [f"ema/{i}/{k}" for k in params]
                    if any(n not in saved for n in names):
                        raise ValueError(
                            f"checkpoint at step {by_boundary[t]} carries "
                            f"no EMA profile {i}")
                    shadows = {k: saved[n].to(p.device)
                               for (k, p), n in zip(params.items(), names)}
                    acc = accumulate_weighted(acc, w[idx], shadows)
                    idx += 1
                del saved   # only the running f32 sum stays resident
        return acc

    def close(self) -> None:
        self.wait_until_finished()
        self._writer.shutdown()


class ModelRegistry:
    """``models.json`` registry: identifier -> {checkpoint, description},
    plain JSON that either package reads."""

    def __init__(self, registry_path: str | pathlib.Path):
        self.registry_path = pathlib.Path(registry_path)

    def _read(self) -> dict:
        if self.registry_path.exists():
            return json.loads(self.registry_path.read_text())
        return {}

    def list_models(self) -> list[str]:
        return sorted(self._read().keys())

    def register(self, name: str, checkpoint_path: str,
                 description: dict[str, Any]) -> None:
        entries = self._read()
        entries[name] = {"checkpoint": str(checkpoint_path),
                         "description": description}
        self.registry_path.write_text(json.dumps(entries, indent=2))

    def entry(self, name: str) -> dict[str, Any]:
        entries = self._read()
        if name not in entries:
            raise KeyError(f"unknown model: {name!r}; "
                           f"known: {sorted(entries)}")
        return entries[name]
