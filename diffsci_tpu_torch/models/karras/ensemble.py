"""EnsembleKarrasModel: ensemble (CRPS) losses, the autoregressive
forecasting loss, replay fine-tuning and L2-SP regularisation, with their
train step.

Port of ``diffsci_tpu/models/karras/ensemble.py``:

- the ensemble loss draws E noises per item at once and makes one
  denoiser call over the flattened [B·E] batch; the metric sees the whole
  ensemble [B, E, *spatial, C] (CRPS), an elementwise metric is reduced
  to a scalar before the weighting;
- the autoregressive loss takes per-horizon losses on split targets and
  makes each next condition by sampling the model inside the step
  (detached) and sliding the prediction into y['y']'s channel window;
- replay fine-tuning adds a scheduled weight times the loss of a replay
  batch; L2-SP adds the squared distance to frozen reference weights.

Layouts: x, its targets and masks are channels-last (the port's
``KarrasModel``); conditions are in the network's layout, so y['y'] is
[B, T·C, *spatial] and its window slides on axis 1.

Draws: every draw of a step is made before its work runs, from the
caller's generator, in one order (``draw_autoregressive``): per horizon
σ [B], the posterior's ε (latent models), the ensemble's ε [B, E, ...],
the condition-drop mask [B·E] (when the network drops conditions), then,
before every horizon but the last, the in-step sampler's x_T and its
loop noise (stochastic integrators). ``sigma_seq``, ``eps_seq`` and
``draws=`` replay them.

On a CUDA device ``make_ensemble_train_step`` is a CUDA graph per key, as
``make_train_step`` is: the draws go into static inputs, and the in-step
sampler's network calls (35 for 18 Heun steps) are part of the captured
step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import math

import numpy as np
import torch

from diffsci_tpu_torch.models.karras.module import (KarrasModel,
                                                    KarrasModelConfig)
from diffsci_tpu_torch.models.karras.train import (
    AdamWClip, TrainState, _begin_update, _capturable, _ema_graph_update,
    _end_update, _rows, batch_like, check_placement, keep_rows,
    renormalize_mp_weights, synced_norm)
from diffsci_tpu_torch.models.karras.ema import EMATracker
from diffsci_tpu_torch.utils import bcast_right, dict_map, graphs

_AR_FIELDS = ("autoregressive_loss_steps",
              "autoregressive_loss_diffusion_steps",
              "autoregressive_loss_guidance", "autoregressive_loss_weights",
              "autoregressive_loss_maximum_batch_size",
              "autoregressive_loss_integrator")


class EnsembleKarrasModelConfig(KarrasModelConfig):
    """``KarrasModelConfig`` with the ensemble sizes, replay fine-tuning
    (``replay_enabled``, ``replay_loss_weight``,
    ``replay_loss_weight_schedule``), L2-SP
    (``pretrained_weight_regularization``: True or {"enabled", "weight",
    "normalize", ...}) and ``freeze_layer_patterns``."""

    def __init__(self, *args,
                 ensemble_size_train: int = 1,
                 ensemble_size_val: int = 1,
                 replay_enabled: bool = False,
                 replay_loss_weight: float = 1.0,
                 replay_loss_weight_schedule: dict | None = None,
                 pretrained_weight_regularization: dict | bool | None = None,
                 freeze_layer_patterns: list[str] | None = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.ensemble_size_train = ensemble_size_train
        self.ensemble_size_val = ensemble_size_val
        self.replay_enabled = replay_enabled
        self.replay_loss_weight = replay_loss_weight
        self.replay_loss_weight_schedule = replay_loss_weight_schedule or {}
        self.pretrained_weight_regularization = \
            pretrained_weight_regularization
        self.freeze_layer_patterns = freeze_layer_patterns or []

    @classmethod
    def from_karras_config(cls, base: KarrasModelConfig, **kwargs):
        """``base``'s math and autoregressive fields with the ensemble
        knobs of ``kwargs`` (which win over ``base``)."""
        inherited = dict(
            preconditioner=base.preconditioner,
            noisesampler=base.noisesampler,
            noisescheduler=base.noisescheduler,
            loss_metric=base.loss_metric, tag=base.tag,
            has_edm_batch_norm=base.has_edm_batch_norm,
            dynamic_loss_weight=base.dynamic_loss_weight,
            extra_args=base.extra_args, spatial_shape=base.spatial_shape,
            focus_radius=base.focus_radius,
            **{k: getattr(base, k) for k in _AR_FIELDS})
        inherited.update(kwargs)
        return cls(**inherited)


def scheduled_replay_weight(schedule: dict, default_weight: float,
                            position) -> float:
    """The replay loss's weight at ``position`` (a step or epoch count):
    constant, linear or cosine from ``start_weight`` to ``end_weight``
    over ``num_steps`` (or ``num_epochs``) when the schedule is
    ``enabled``, else ``default_weight``. A float32 value, as the JAX
    package computes it."""
    f32 = np.float32
    if not schedule.get("enabled", False):
        return float(f32(default_weight))
    start = float(schedule.get("start_weight", default_weight))
    end = float(schedule.get("end_weight", default_weight))
    duration = float(schedule.get("num_steps",
                                  schedule.get("num_epochs", 1)))
    progress = f32(min(max(f32(position) / f32(duration), 0.0), 1.0)) \
        if duration > 0 else f32(1.0)
    kind = str(schedule.get("type", "linear")).lower()
    if kind == "constant":
        return float(f32(start))
    if kind == "linear":
        return float(f32(start) + progress * f32(end - start))
    if kind == "cosine":
        return float(f32(end) + f32(0.5 * (start - end))
                     * (f32(1) + np.cos(f32(math.pi) * progress)))
    raise ValueError(f"unknown replay schedule type: {kind}")


def l2_sp_regularization(params: dict, reference: dict, weight: float,
                         normalize: bool = True):
    """L2-SP: weight · Σ (p − p_ref)² over the parameters of
    ``reference`` (name -> frozen tensor), divided by their number of
    entries when ``normalize``."""
    terms = [torch.sum((params[name] - ref) ** 2)
             for name, ref in reference.items()]
    count = sum(ref.numel() for ref in reference.values())
    if count == 0:
        return torch.zeros(())
    total = torch.stack(terms).sum()
    if normalize:
        total = total / count
    return weight * total


def select_regularization_reference(params: dict, include_patterns=("*",),
                                    exclude_patterns=()) -> dict:
    """A frozen copy (name -> tensor) of the parameters whose dotted names
    match a glob of ``include_patterns`` and none of
    ``exclude_patterns`` (e.g. ``"model.unet.downward_blocks.*"``).
    Raises when nothing matches."""
    out = {}
    for name, p in params.items():
        inc = any(fnmatch.fnmatch(name, pat) for pat in include_patterns)
        exc = any(fnmatch.fnmatch(name, pat) for pat in exclude_patterns)
        if inc and not exc:
            out[name] = p.detach().clone()
    if not out:
        raise ValueError(
            "pretrained_weight_regularization did not match any parameters")
    return out


class EnsembleKarrasModel(KarrasModel):
    """``KarrasModel`` with the ensemble and autoregressive losses."""
    # the placement whose global batch the loss's batch means take (set by
    # the ensemble step over a mesh), or None
    _placement = None

    @contextlib.contextmanager
    def over_ranks(self, placement):
        """Within: the ensemble loss's batch mean of the loss weight is the
        global batch's (``placement``: a state's placement, or None). The
        loss is mean(λ)·metric, a product of batch means, so each rank's
        own mean would not give the global batch's gradient."""
        old, self._placement = self._placement, placement
        try:
            yield
        finally:
            self._placement = old

    def _batch_mean(self, t):
        m = t.mean()
        placed = self._placement
        return m if placed is None else placed.batch_mean(m)

    # ------------------------------------------------------------------
    def loss_fn(self, x, sigma, y=None, mask=None, train: bool = True,
                n_ensemble: int = 1, eps=None, generator=None,
                variables=None, cond_keep=None,
                return_updates: bool = False, z_eps=None):
        """The ensemble loss: ``KarrasModel.loss_fn`` when n_ensemble is
        1; else E = n_ensemble noises ε [B, E, *latent] (replayed by
        ``eps``), one denoiser call over the [B·E] batch (conditions
        repeated per member, ``cond_keep`` [B·E]), the metric of the whole
        ensemble against x (a reducing metric such as CRPS as it is; an
        elementwise one reduced to its mean, or masked to the mean over
        items of their kept sums over their kept counts), then
        mean(λ/e^u)·metric + mean(u)."""
        if n_ensemble <= 1:
            return super().loss_fn(x, sigma, y, mask, train, eps=eps,
                                   generator=generator, variables=variables,
                                   cond_keep=cond_keep,
                                   return_updates=return_updates,
                                   z_eps=z_eps)
        if self._multi_space is not None:
            raise NotImplementedError(
                "multi-space loss is not implemented for ensembles")
        if z_eps is None:
            z_eps = self._draw_posterior(x, generator)
        x, y, updates = self.encode(x, y, train=train, z_eps=z_eps)
        B, E = x.shape[0], n_ensemble
        feat = tuple(x.shape[1:])
        sigma_b = bcast_right(sigma, x)
        if eps is None:
            eps = torch.randn((B, E) + feat, generator=generator,
                              device=x.device, dtype=x.dtype)
        x_noised = x[:, None] + sigma_b[:, None] * eps.to(x.dtype)
        y_flat = dict_map(lambda v: v.repeat_interleave(E, dim=0)
                          if v.shape[0] == B else v, y)
        if cond_keep is None and train and self.conditional \
                and y is not None:
            cond_keep = self.draw_cond_keep(B * E, generator)
        denoiser, cnoise = self.get_denoiser(
            x_noised.reshape((B * E,) + feat), sigma.repeat_interleave(E),
            y_flat, train=train, variables=variables, cond_keep=cond_keep)
        denoiser = denoiser.reshape((B, E) + feat)
        weight = self.config.noisesampler.loss_weighting(sigma_b)
        bias = torch.zeros_like(weight)
        if self.config.has_dynamic_loss_weight:
            modifier = bcast_right(self._loss_weight_modifier(
                cnoise.reshape(B, E).mean(dim=1), variables), x)
            weight = weight / torch.exp(modifier)
            bias = bias + modifier
        if self._loss_metric.reduces_internally:
            raw = self._loss_metric(denoiser, x, mask)
        else:
            raw = self._loss_metric(denoiser, x[:, None], mask)
            if mask is not None:
                keep = 1.0 - mask.expand_as(x)
                per_b = (raw * keep[:, None]).sum(
                    dim=tuple(range(1, raw.ndim)))
                count = keep.sum(dim=tuple(range(1, keep.ndim))).clamp_min(
                    1.0)
                raw = (per_b / count).mean()
            else:
                raw = raw.mean()
        loss = self._batch_mean(weight) * raw + bias.mean()
        return (loss, updates) if return_updates else loss

    # ------------------------------------------------------------------
    def has_autoregressive_loss(self) -> bool:
        return getattr(self.config, "autoregressive_loss_steps", 1) > 1

    def _ar_steps(self, nsteps=None) -> int:
        steps = int(self.config.autoregressive_loss_steps
                    if nsteps is None else nsteps)
        if steps < 1:
            raise ValueError("autoregressive_loss_steps must be >= 1")
        return steps

    def draw_tensors(self, x, n_ensemble: int = 1, nsteps=None,
                     sampler: bool = True) -> dict:
        """Empty tensors for every draw of a training loss over the batch
        x (channels-last; ``nsteps`` horizons, default the configuration's):
        "sigma" [S, B], "z_eps" [S, *latent] or None, "eps" [S, B, E,
        *latent] ([S, *latent] for E = 1), "keep" [S, B·E] bool or None,
        and, with ``sampler``, the in-step sampler's "x_T" [S−1, B,
        *latent] and "noise" [S−1, n, B, *latent] (None for a
        deterministic integrator)."""
        S = self._ar_steps(nsteps)
        target = self._split_autoregressive_targets(
            torch.empty(x.shape, device="meta"), S)[0].shape
        lat = self.latent_shape(target)
        B, dev = lat[0], x.device
        E = max(int(n_ensemble), 1)
        eps_shape = (S,) + ((B, E) + lat[1:] if E > 1 else lat)
        keep = self.cond_drop_rate is not None and self.conditional
        d = dict(sigma=torch.empty((S, B), device=dev),
                 z_eps=torch.empty((S,) + lat, device=dev)
                 if self.draws_posterior() else None,
                 eps=torch.empty(eps_shape, device=dev),
                 keep=torch.empty((S, B * E), dtype=torch.bool, device=dev)
                 if keep else None, x_T=None, noise=None)
        if sampler and S > 1:
            cfg = self.config
            shape = (B,) + self._sample_shape(target[1:], False)
            d["x_T"] = torch.empty((S - 1,) + shape, device=dev)
            n = cfg.noisescheduler.noise_steps(
                cfg.autoregressive_loss_diffusion_steps, False,
                cfg.autoregressive_loss_integrator)
            if n:
                d["noise"] = torch.empty((S - 1, n) + shape, device=dev)
        return d

    def draw_autoregressive(self, draws: dict, generator=None,
                            sigma_seq=None, eps_seq=None) -> dict:
        """Fill ``draws`` (``draw_tensors``) from ``generator`` in the
        order of the module docstring; ``sigma_seq`` [S, B] and
        ``eps_seq`` replay σ and ε. Returns ``draws``."""
        S, B = draws["sigma"].shape
        E = draws["keep"].shape[1] // B if draws["keep"] is not None \
            else None
        for s in range(S):
            if sigma_seq is None:
                self.config.noisesampler.sample((B,), generator,
                                                out=draws["sigma"][s])
            else:
                draws["sigma"][s].copy_(sigma_seq[s])
            for name in ("z_eps", "eps"):
                t = draws[name]
                if t is None:
                    continue
                if name == "eps" and eps_seq is not None:
                    t[s].copy_(eps_seq[s])
                else:
                    torch.randn(t[s].shape, generator=generator, out=t[s])
            if E is not None:
                self.draw_cond_keep(B * E, generator, out=draws["keep"][s])
            if s < S - 1:
                for name in ("x_T", "noise"):
                    t = draws[name]
                    if t is not None:
                        torch.randn(t[s].shape, generator=generator,
                                    out=t[s])
        return draws

    def autoregressive_loss_fn(self, x, y=None, mask=None,
                               train: bool = True, n_ensemble: int = 1,
                               nsteps: int | None = None, sigma_seq=None,
                               eps_seq=None, sampler_fn=None,
                               generator=None, variables=None, draws=None):
        """The autoregressive loss over ``nsteps`` horizons (default the
        configuration's): x's targets split per horizon
        ([B, S, *spatial, C] or [B, *spatial, S·C]), masks likewise, the
        per-horizon losses (``loss_fn``) weighted by the normalised
        ``autoregressive_loss_weights``, each next condition the model's
        sample at the horizon's target shape (``_sample_next_...``, or
        ``sampler_fn(target, y)``) slid into y['y']. ``draws``
        (``draw_tensors``, filled) replays every draw; else they are drawn
        from ``generator`` first, ``sigma_seq`` and ``eps_seq`` replayed.
        Returns (total, updates, per-horizon losses)."""
        steps = self._ar_steps(nsteps)
        if steps > 1 and y is None:
            raise ValueError(
                "Autoregressive loss requires conditional data so generated "
                "predictions can be fed back into y['y'].")
        if draws is None:
            draws = self.draw_autoregressive(
                self.draw_tensors(x, n_ensemble, steps,
                                  sampler=sampler_fn is None),
                generator, sigma_seq, eps_seq)
        targets = self._split_autoregressive_targets(x, steps)
        masks = self._split_autoregressive_masks(mask, steps, targets)
        weights = self._autoregressive_step_weights(steps)
        current_y, total, step_losses, updates = y, 0.0, [], {}
        for s, target in enumerate(targets):
            keep = None if draws["keep"] is None else draws["keep"][s]
            z = None if draws["z_eps"] is None else draws["z_eps"][s]
            loss, upd = self.loss_fn(
                target, draws["sigma"][s], current_y, masks[s], train,
                n_ensemble, eps=draws["eps"][s], variables=variables,
                cond_keep=keep, return_updates=True, z_eps=z)
            updates = upd or updates
            step_losses.append(loss)
            total = total + float(weights[s]) * loss
            if s < steps - 1:
                if sampler_fn is not None:
                    pred = sampler_fn(target, current_y)
                else:
                    noise = None if draws["noise"] is None \
                        else draws["noise"][s]
                    pred = self._sample_next_autoregressive_condition(
                        target, current_y, draws["x_T"][s], noise,
                        variables)
                current_y = self._append_autoregressive_prediction(
                    current_y, pred)
        return total, updates, step_losses

    @staticmethod
    def _split_autoregressive_targets(x, steps: int):
        """[B, steps, *spatial, C] or channel-flattened
        [B, *spatial, steps·C] -> a list of ``steps`` targets."""
        if steps == 1:
            return [x]
        if x.ndim >= 5 and x.shape[1] == steps:
            return [x[:, s].contiguous() for s in range(steps)]
        if x.ndim >= 4 and x.shape[-1] % steps == 0:
            return [t.contiguous() for t in torch.chunk(x, steps, dim=-1)]
        raise ValueError(
            "Could not split x into autoregressive targets: expected "
            "[B, steps, *spatial, C] or [B, *spatial, steps*C].")

    @staticmethod
    def _split_autoregressive_masks(mask, steps: int, targets):
        if mask is None or steps == 1:
            return [mask] * steps
        if mask.ndim >= 5 and mask.shape[1] == steps:
            return [mask[:, s] for s in range(steps)]
        target_channels = targets[0].shape[-1]
        if mask.ndim >= 4 and mask.shape[-1] == steps * target_channels:
            return list(torch.chunk(mask, steps, dim=-1))
        return [mask] * steps

    def _autoregressive_step_weights(self, steps: int) -> torch.Tensor:
        """The horizons' weights normalised to sum 1 (float32)."""
        weights = getattr(self.config, "autoregressive_loss_weights", None)
        if weights is None:
            w = np.ones((steps,), np.float32)
        else:
            w = np.asarray(weights, np.float32)
            if w.size != steps:
                raise ValueError(
                    "autoregressive_loss_weights must have one value per "
                    "autoregressive loss step")
        return torch.from_numpy(
            w / max(w.sum(), np.finfo(np.float32).eps))

    def _inference_variables(self, variables=None):
        """The weights the in-step sampler reads, cast once to the compute
        dtype (in the step, so a captured graph casts the current
        masters), or None for the network's own f32 tensors."""
        if self.compute_dtype is None and variables is None:
            return None
        tensors = dict(self.net.named_parameters())
        tensors.update(self.net.named_buffers())
        tensors.update(variables or {})
        cd = self.compute_dtype
        return {k: v.detach().to(cd) if cd is not None
                and v.is_floating_point() else v.detach()
                for k, v in tensors.items()}

    def _sample_next_autoregressive_condition(self, target, y, x_T,
                                              noise=None, variables=None):
        """The model's sample at the target's shape, conditioned on y,
        from the drawn x_T (and loop noise), detached: the configuration's
        ``autoregressive_loss_*`` steps, guidance, integrator and maximum
        batch, decoded as ``sample`` decodes."""
        if y is None:
            raise ValueError(
                "Autoregressive loss requires conditional data so generated "
                "predictions can be fed back into y['y'].")
        cfg = self.config
        B = target.shape[0]
        with torch.no_grad():
            tensors = self._inference_variables(variables)
            y_loop, y_dec = self._sample_conditions(B, target.shape[1:], y,
                                                    False)
            chunk = cfg.autoregressive_loss_maximum_batch_size or B
            outs = []
            for lo in range(0, B, chunk):
                rows = slice(lo, min(lo + chunk, B))

                def part(c):
                    return dict_map(lambda v: v[rows] if v.shape[0] == B
                                    else v, c)

                outs.append(self._sample_loop(
                    x_T[rows], part(y_loop), part(y_dec),
                    cfg.autoregressive_loss_guidance,
                    cfg.autoregressive_loss_diffusion_steps, False,
                    cfg.autoregressive_loss_integrator, False, None,
                    None if noise is None else noise[:, rows], True,
                    variables=tensors))
            pred = outs[0] if len(outs) == 1 else torch.cat(outs, 0)
        return pred.to(target.dtype)

    @staticmethod
    def _append_autoregressive_prediction(y, prediction):
        """Slide y['y']'s channel window ([B, T·C, *spatial], or unbatched
        [T·C, *spatial]): drop its first C channels and append the
        channels-last prediction [B, *spatial, C]."""
        if not isinstance(y, dict) or "y" not in y:
            raise ValueError(
                "Autoregressive loss expects y to be a dict containing "
                "key 'y'.")
        y_tensor = y["y"]
        prediction = prediction.detach().to(y_tensor.dtype)
        if y_tensor.ndim == prediction.ndim - 1:
            if prediction.shape[0] != 1:
                raise ValueError(
                    "Cannot append batched predictions to unbatched y['y'].")
            prediction = prediction[0].movedim(-1, 0)
            axis = 0
        elif y_tensor.ndim == prediction.ndim:
            prediction = prediction.movedim(-1, 1)
            axis = 1
        else:
            raise ValueError(
                f"Prediction rank {prediction.ndim} is incompatible with "
                f"y['y'] rank {y_tensor.ndim}.")
        cps = prediction.shape[axis]
        if y_tensor.shape[axis] < cps:
            raise ValueError(
                "y['y'] has fewer channels than the generated prediction.")
        updated = dict(y)
        updated["y"] = torch.cat(
            [y_tensor.narrow(axis, cps, y_tensor.shape[axis] - cps),
             prediction], dim=axis)
        return updated

    # ------------------------------------------------------------------
    def training_loss(self, batch, n_ensemble: int = 1, train: bool = True,
                      generator=None, draws=None, variables=None):
        """The loss of one (sub-)batch (``select_batch``'s layout),
        autoregressive when configured. Returns (loss, updates, aux): aux
        holds ``ar_loss_horizon_{i}`` for the autoregressive loss."""
        x, y, mask = self.select_batch(batch)
        return self._training_loss(x, y, mask, n_ensemble, train, generator,
                                   draws, variables)

    def _training_loss(self, x, y, mask, n_ensemble=1, train=True,
                       generator=None, draws=None, variables=None):
        ar = self.has_autoregressive_loss()
        if draws is None:
            draws = self.draw_autoregressive(
                self.draw_tensors(x, n_ensemble, None if ar else 1),
                generator)
        if ar:
            loss, updates, step_losses = self.autoregressive_loss_fn(
                x, y, mask, train=train, n_ensemble=n_ensemble,
                variables=variables, draws=draws)
            return loss, updates, {f"ar_loss_horizon_{i + 1}": sl
                                   for i, sl in enumerate(step_losses)}
        keep = None if draws["keep"] is None else draws["keep"][0]
        z = None if draws["z_eps"] is None else draws["z_eps"][0]
        loss, updates = self.loss_fn(
            x, draws["sigma"][0], y, mask, train, n_ensemble,
            eps=draws["eps"][0], variables=variables, cond_keep=keep,
            return_updates=True, z_eps=z)
        return loss, updates, {}


@dataclasses.dataclass
class _Batch:
    """A step's static inputs for one (sub-)batch: x, y, mask and its
    draws."""
    x: torch.Tensor
    y: object
    mask: object
    draws: dict
    n_ensemble: int = 1

    @classmethod
    def like(cls, model, x, y, mask, n_ensemble):
        return cls(torch.empty_like(x), graphs.static_like(y, x.device),
                   graphs.static_like(mask, x.device),
                   model.draw_tensors(x, n_ensemble, cls._steps(model)),
                   n_ensemble)

    @staticmethod
    def _steps(model):
        return None if model.has_autoregressive_loss() else 1

    def fill(self, model, x, y, mask, generator, draws=None,
             rows: tuple = (1, 0)) -> None:
        """Copy the batch in and make its draws (``draws``: filled
        ``draw_tensors`` replayed instead). ``rows`` = (n, i): x is block
        i of n of a global batch's rows; the draws (and the replayed ones)
        are the global batch's, of which this batch keeps block i."""
        self.x.copy_(x)
        graphs.fill(self.y, y)
        graphs.fill(self.mask, mask)
        n, i = rows
        if n > 1:
            whole = draws
            if whole is None:
                whole = model.draw_autoregressive(model.draw_tensors(
                    batch_like(x, n), self.n_ensemble, self._steps(model)),
                    generator)
            for k, v in self.draws.items():
                if v is not None:
                    # the batch dim: 1 ([S, B, ...]); the loop noise's 2
                    keep_rows(v, whole[k], i, 2 if k == "noise" else 1)
        elif draws is None:
            model.draw_autoregressive(self.draws, generator)
        else:
            for k, v in self.draws.items():
                if v is not None:
                    v.copy_(draws[k])


def _split_batch(batch):
    """(x, y, mask) of a replay batch given as x or a tuple."""
    if isinstance(batch, (tuple, list)):
        return tuple(batch) + (None,) * (3 - len(batch))
    return batch, None, None


def make_ensemble_train_step(model: EnsembleKarrasModel, tx: AdamWClip,
                             ema: EMATracker | None = None,
                             reg_reference: dict | None = None,
                             has_mp_weights: bool = False,
                             nan_guard: bool = True, _raw: bool = False):
    """The train step of the ensemble runtime, ``step(state, x, y=None,
    mask=None, generator=None, replay=None, draws=None,
    replay_draws=None) -> (state, metrics)``: the configuration's
    training loss (``ensemble_size_train`` members, autoregressive when
    configured) on (x, y, mask); with ``replay_enabled`` plus the
    scheduled weight (``scheduled_replay_weight`` at the state's step)
    times the loss of ``replay`` ((x, y, mask) or x); with L2-SP enabled
    (``pretrained_weight_regularization`` and ``reg_reference``, e.g.
    ``select_regularization_reference``) plus its term; then backward, the
    NaN→0 guard, the clip and the optimizer (as ``make_train_step``), the
    mp re-projection (``has_mp_weights``), the batch norm's statistics and
    the EMA. The draws are made from ``generator`` before the work, the
    batch's then the replay batch's (``draws=`` / ``replay_draws=``:
    filled ``draw_tensors`` replayed instead). ``metrics``: train_loss,
    grad_norm and the loss's aux (per-horizon losses; the fine-tune and
    replay losses and the weight; l2_sp) as device tensors. Plugs into
    ``Trainer.fit`` as ``step_fn``.

    Over a mesh (a state placed by ``parallel.replicate`` and the
    others) x is this rank's rows; every draw is the global batch's, of
    which the step keeps its rows, and the gradients are the global
    batch's mean before the guard and clip, as ``make_train_step``'s
    (the logged losses are the mean over the ranks). A spatially sharded
    state raises.

    On a CUDA device the step is a CUDA graph per (the batches' shapes,
    optimizer, accumulation phase, placement) held by the state, the
    in-step sampler inside it (eager over gloo); ``_raw=True`` returns
    the eager step."""
    cfg = model.config
    reg_cfg = getattr(cfg, "pretrained_weight_regularization", None)
    if reg_cfg is True:
        reg_cfg = {"enabled": True}
    reg_on = (isinstance(reg_cfg, dict) and reg_cfg.get("enabled", False)
              and float(reg_cfg.get("weight", 0.0)) > 0.0
              and reg_reference is not None)
    E = cfg.ensemble_size_train
    buffers = dict(model.net.named_buffers())

    def replay_weight(state, device):
        return torch.tensor(scheduled_replay_weight(
            cfg.replay_loss_weight_schedule, cfg.replay_loss_weight,
            state.step), device=device)

    def update(state, main: _Batch, rep: _Batch | None, w, emit=True):
        """Loss, backward, guard, clip, optimizer, re-projection and the
        batch norm's statistics from static draws: device work only."""
        for p in state.params.values():
            p.grad = None
        with model.over_ranks(state.placement):
            loss, upd, aux = model._training_loss(
                main.x, main.y, main.mask, E, True, draws=main.draws)
            if rep is not None:
                loss_r, upd_r, _ = model._training_loss(
                    rep.x, rep.y, rep.mask, E, True, draws=rep.draws)
        if rep is not None:
            aux = {"train_loss_finetune": loss, "train_loss_replay": loss_r,
                   "train_replay_loss_weight": w}
            loss = loss + w * loss_r
            upd = upd or upd_r
        if reg_on:
            reg = l2_sp_regularization(
                state.params, reg_reference,
                float(reg_cfg.get("weight", 0.0)),
                bool(reg_cfg.get("normalize", True)))
            loss = loss + reg
            aux["l2_sp"] = reg
        loss.backward()
        placed = state.placement
        norm = synced_norm(placed, state.params, nan_guard)
        tx.update(state, norm, emit)
        if has_mp_weights:
            renormalize_mp_weights(model.net)
        with torch.no_grad():
            for name, value in (upd or {}).items():
                buffers[name].copy_(value)

        def logged(v):
            v = v.detach()
            return v if placed is None else placed.mean_over_ranks(v)
        return logged(loss), norm, {k: logged(v) if torch.is_tensor(v)
                                    else v for k, v in aux.items()}

    def batches(x, y, mask, replay):
        main = _Batch.like(model, x, y, mask, E)
        rep = None
        if cfg.replay_enabled:
            if replay is None:
                raise ValueError("replay_enabled needs a replay batch")
            xr, yr, mr = _split_batch(replay)
            rep = _Batch.like(model, xr, yr, mr, E)
        return main, rep

    def fill(state, main, rep, x, y, mask, replay, generator, draws,
             replay_draws):
        rows = _rows(state)
        main.fill(model, x, y, mask, generator, draws, rows)
        if rep is not None:
            rep.fill(model, *_split_batch(replay), generator, replay_draws,
                     rows)

    def metrics(loss, norm, aux):
        return {"train_loss": loss, "grad_norm": norm, **aux}

    def raw_step(state: TrainState, x, y=None, mask=None, generator=None,
                 replay=None, draws=None, replay_draws=None):
        check_placement(state, "make_ensemble_train_step")
        main, rep = batches(x, y, mask, replay)
        fill(state, main, rep, x, y, mask, replay, generator, draws,
             replay_draws)
        w = replay_weight(state, x.device) if rep is not None else None
        emit = _begin_update(state, tx)
        out = update(state, main, rep, w, emit)
        if ema is not None and state.ema is not None:
            ema.update(state.ema, state.params)
        _end_update(state, tx, emit)
        return state, metrics(*out)

    if _raw:
        return raw_step

    def train_step(state: TrainState, x, y=None, mask=None, generator=None,
                   replay=None, draws=None, replay_draws=None):
        if x.device.type != "cuda" or not _capturable(state):
            return raw_step(state, x, y, mask, generator, replay, draws,
                            replay_draws)
        check_placement(state, "make_ensemble_train_step")
        if state.graphs is None:
            state.graphs = graphs.GraphCache(x.device)
        cache = state.graphs
        emit = _begin_update(state, tx)
        rkey = None if replay is None else tuple(
            None if t is None else graphs.condition_key(t)
            for t in _split_batch(replay))
        key = ("ensemble", tuple(x.shape), x.dtype, graphs.condition_key(y),
               graphs.condition_key(mask), rkey, state.optimizer, tx, emit,
               state.placement)
        graph = cache.graphs.get(key)
        if graph is None:
            main, rep = batches(x, y, mask, replay)
            w = torch.zeros((), device=x.device) if rep is not None else None
        else:
            main, rep, w = graph.inputs
        fill(state, main, rep, x, y, mask, replay, generator, draws,
             replay_draws)
        if w is not None:
            w.copy_(replay_weight(state, x.device))
        if graph is None:
            def body():
                return update(state, main, rep, w, emit)

            out = cache.warmup(body)
            cache.capture(key, body).inputs = (main, rep, w)
        else:
            graph.replay()
            loss, norm, aux = graph.outputs
            out = (loss.clone(), norm.clone(),
                   {k: v.clone() for k, v in aux.items()})
        model._masters_changed()
        if ema is not None and state.ema is not None:
            _ema_graph_update(ema, cache, state.ema, state.params)
        _end_update(state, tx, emit)
        return state, metrics(*out)

    return train_step
