"""Training: train state, AdamW with global-norm clipping, the train step
(σ draw, EDM loss, backward, NaN guard, clip, AdamW, EMA) and the eval
step.

Port of ``diffsci_tpu/models/karras/train.py:35-258``. The JAX package
builds pure jitted functions over an immutable ``TrainState``; here the
parameters are the network's own tensors, updated in place by
``torch.optim.AdamW``, and ``TrainState`` holds them with the optimizer,
the EMA state and the step count. The step launches its work on the
device and returns its metrics as device tensors: nothing in it waits
for the device.

Not ported yet: ``remat``, ``make_train_scan``, ``freeze_*``,
``renormalize_mp_weights`` (no magnitude-preserving weights in the ported
networks), the learning-rate schedules, the schedule-free optimizer and
``accumulate_gradients``.
"""

from __future__ import annotations

import dataclasses

import torch

from diffsci_tpu_torch.models.karras.ema import EMAState, EMATracker


@dataclasses.dataclass
class TrainState:
    """The trained parameters (the network's own tensors, by name), their
    optimizer, the EMA state (or None) and the number of steps taken."""
    params: dict
    optimizer: torch.optim.Optimizer
    ema: EMAState | None
    step: int = 0

    def ema_variables(self, tracker: EMATracker | None) -> dict:
        """The parameters with the EMA shadows of the tracker's profile
        swapped in, by name: pass as ``variables=`` to
        ``KarrasModel.loss_fn`` or ``get_denoiser``, or load into a network
        with ``load_state_dict(..., strict=False)``."""
        if self.ema is None or tracker is None:
            return dict(self.params)
        return dict(tracker.get_params(self.ema))


@dataclasses.dataclass(frozen=True)
class AdamWClip:
    """AdamW after clipping the gradients by their global norm, as
    ``optax.chain(clip_by_global_norm(c), adamw(...))``. torch's AdamW
    update equals optax's (decoupled decay p·(1 - lr·wd), eps outside the
    square root); the clip is optax's g·c/max(‖g‖, c), not
    ``torch.nn.utils.clip_grad_norm_``, whose +1e-6 changes the numbers."""
    learning_rate: float
    weight_decay: float
    b1: float
    b2: float
    grad_clip: float | None
    eps: float = 1e-8

    def init(self, params) -> torch.optim.AdamW:
        return torch.optim.AdamW(list(params), lr=self.learning_rate,
                                 betas=(self.b1, self.b2), eps=self.eps,
                                 weight_decay=self.weight_decay)

    def step(self, optimizer: torch.optim.Optimizer, grads: list,
             norm: torch.Tensor) -> None:
        """Clip ``grads`` (the optimizer's ``.grad`` tensors, global norm
        ``norm``) in place, then take the AdamW step."""
        if self.grad_clip is not None:
            c = self.grad_clip
            torch._foreach_mul_(grads, c / torch.clamp(norm, min=c))
        optimizer.step()


def default_optimizer(learning_rate: float = 1e-3, weight_decay: float = 1e-4,
                      b1: float = 0.9, b2: float = 0.999,
                      grad_clip: float | None = 0.5) -> AdamWClip:
    """The JAX package's default: AdamW (lr 1e-3, wd 1e-4, betas (0.9,
    0.999)) after clipping by global norm 0.5."""
    return AdamWClip(learning_rate, weight_decay, b1, b2, grad_clip)


def nan_to_zero_grads(grads: list) -> None:
    """NaN and ±inf gradient entries become 0, in place."""
    for g in grads:
        torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)


def global_norm(tensors: list) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def create_train_state(model, x_shape, seed: int | None = 0,
                       optimizer: AdamWClip | None = None,
                       ema: EMATracker | None = None):
    """Initialise the weights from ``seed`` (None keeps the network's
    current weights, e.g. a loaded state dict), the optimizer and the EMA.
    ``x_shape`` is the channels-last batch shape the state will train on;
    it is checked against the network. Returns (state, tx)."""
    net_cfg = model.net.model.config
    if len(x_shape) != net_cfg.dimension + 2 or \
            x_shape[-1] != net_cfg.input_channels:
        raise ValueError(f"x_shape {tuple(x_shape)} is not [B, *"
                         f"{net_cfg.dimension}D spatial, "
                         f"{net_cfg.input_channels}]")
    if seed is not None:
        model.init(seed)
    tx = optimizer if optimizer is not None else default_optimizer()
    params = dict(model.net.named_parameters())
    state = TrainState(params=params, optimizer=tx.init(params.values()),
                       ema=ema.init(params) if ema is not None else None)
    return state, tx


def make_train_step(model, tx: AdamWClip, ema: EMATracker | None = None):
    """The train step ``step(state, x, y=None, mask=None, generator=None,
    sigma=None, eps=None) -> (state, metrics)``: draw σ (log-normal, from
    ``generator``), EDM loss, backward through the network, NaN→0 guard,
    global-norm clip, AdamW, EMA. ``sigma`` and ``eps`` replay fixed draws
    (the cross-framework tests use them). ``metrics`` holds
    ``train_loss`` and ``grad_norm`` (after the guard, before the clip) as
    device tensors. ``state`` is updated in place and returned."""

    def train_step(state: TrainState, x, y=None, mask=None, generator=None,
                   sigma=None, eps=None):
        if sigma is None:
            sigma = model.config.noisesampler.sample(
                (x.shape[0],), generator, x.device)
        state.optimizer.zero_grad(set_to_none=True)
        loss = model.loss_fn(x, sigma, y, mask, train=True, eps=eps,
                             generator=generator)
        loss.backward()
        grads = []
        for p in state.params.values():
            if p.grad is None:          # unused by this loss: a zero grad
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        nan_to_zero_grads(grads)
        norm = global_norm(grads)
        tx.step(state.optimizer, grads, norm)
        if ema is not None and state.ema is not None:
            ema.update(state.ema, state.params)
        state.step += 1
        return state, {"train_loss": loss.detach(), "grad_norm": norm}

    return train_step


def make_eval_step(model, ema: EMATracker | None = None,
                   use_ema: bool = False):
    """The validation step ``step(state, x, y=None, mask=None,
    generator=None, sigma=None, eps=None) -> {"valid_loss"}``: the EDM
    loss without gradients, in eval mode, with the EMA shadows swapped in
    when ``use_ema``."""

    def eval_step(state: TrainState, x, y=None, mask=None, generator=None,
                  sigma=None, eps=None):
        variables = state.ema_variables(ema) if use_ema else None
        if sigma is None:
            sigma = model.config.noisesampler.sample(
                (x.shape[0],), generator, x.device)
        with torch.no_grad():
            loss = model.loss_fn(x, sigma, y, mask, train=False, eps=eps,
                                 generator=generator, variables=variables)
        return {"valid_loss": loss}

    return eval_step
