"""Training: train state, AdamW with global-norm clipping and its
learning-rate schedules, the train step (σ, ε and condition-drop draws,
loss, backward, NaN guard, clip, AdamW, the magnitude-preserving
re-projection, the batch norm's running statistics, EMA), K steps a call
(``make_train_scan``) and the eval step.

Port of ``diffsci_tpu/models/karras/train.py:35-283``. The JAX package
builds pure jitted functions over an immutable ``TrainState``; here the
parameters are the network's own tensors, updated in place by
``torch.optim.AdamW``, and ``TrainState`` holds them with the optimizer,
the EMA state and the step count. The step launches its work on the
device and returns its metrics as device tensors: nothing in it waits
for the device.

On a CUDA device the step is a CUDA graph per (x's shape and dtype, y's
and mask's shapes, optimizer, loss), the counterpart of the JAX package's
one jitted step: the first call of a key takes the step eagerly on the
capture stream (the warm-up, which also makes AdamW's state) and
captures it; later calls draw σ, ε and the condition-drop mask into the
graph's static inputs in the eager order, copy the batch in, fill the
learning rate and replay. The magnitude-preserving re-projection and the
batch norm's buffer writes are part of the captured step.
Under gradient accumulation a key has two graphs, "accumulate" and
"accumulate, then step", which the host picks by its micro-step counter;
both read the running mean of the gradients in one device buffer of the
state. The EMA update is a graph of its own, replayed on the steps where
the shadows move. The eval step is a graph per key as well, which reads
the parameters (or the EMA shadows) in place. The graphs belong to the
train state (``state.graphs``), whose tensors they update, so every step
function over one state, the
one ``make_train_scan`` builds included, shares them and their memory
pool, and they go with the state. ``make_train_step(..., _raw=True)``
returns the eager step, as in the JAX package.

The optimizers: torch's AdamW (``default_optimizer()``), and two written
for the port with ``torch._foreach_*`` and capturable like torch's (step
counts and sums in 0-d device tensors, no host read):
``default_optimizer(mu_dtype=torch.bfloat16)`` (``AdamWMu``: the first
moment stored in ``mu_dtype``, optax's ``adamw(mu_dtype=)``) and
``schedule_free_optimizer()`` (``ScheduleFreeAdamW``:
``optax.contrib.schedule_free_adamw``), with
``schedule_free_eval_params``.

Over a mesh (a state that ``parallel.replicate``, ``shard_state_fsdp``,
``shard_state_tensor_parallel`` or ``shard_state_expert_parallel`` placed:
``state.placement``) the same step is the parallel step, one process a
rank: x is this rank's rows, the draws are the global batch's of which
it keeps its rows, the EDM batch norm's statistics are the global
batch's, and the gradients are averaged over the ranks before the NaN
guard, the clip and AdamW (``parallel/placement.py``; FSDP's blocks by
the backward's reduce-scatters, ``parallel/fsdp.py``); on the card the
NCCL collectives are captured in the step's graph (over gloo, which
carries CUDA tensors too, the step runs eagerly). Over a data × spatial
mesh (``parallel.spatial.shard_state_spatial``) x is also a slab of its
first spatial axis, and ε is drawn a row at a time, each rank keeping its
slab (``_draw_slab``). Progressive
distillation's step is ``models/karras/distill.py:make_distill_step``.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from diffsci_tpu_torch.models.karras.ema import EMAState, EMATracker
from diffsci_tpu_torch.utils import graphs


@dataclasses.dataclass
class GradAccumulation:
    """The state of ``accumulate_gradients`` (optax.MultiSteps): the
    running mean of this cycle's micro-batch gradients by parameter name
    (f32 tensors on the parameters' device, updated in place), the
    micro-batches it holds (``mini_step``), the optimizer updates taken
    (``gradient_step``), and the divisor of the next micro-batch's term
    (mini_step + 1) as a 0-d device tensor that the graphs read."""
    grads: dict
    count: torch.Tensor
    mini_step: int = 0
    gradient_step: int = 0


@dataclasses.dataclass
class TrainState:
    """The trained parameters (the network's own tensors, by name), their
    optimizer, the EMA state (or None), the number of steps taken, the
    network's buffers by name (the JAX package's ``consts``), the
    gradient accumulation's state (or None), on a CUDA device the
    CUDA graphs of the steps taken on it (a ``utils.graphs.GraphCache``;
    capture times, launches), the network the parameters belong to
    (``module``), and its layout over a mesh (``placement``: a
    ``parallel.placement.Placement``, or None on one process)."""
    params: dict
    optimizer: torch.optim.Optimizer
    ema: EMAState | None
    step: int = 0
    buffers: dict = dataclasses.field(default_factory=dict)
    accum: GradAccumulation | None = None
    graphs: graphs.GraphCache | None = dataclasses.field(
        default=None, repr=False, compare=False)
    module: torch.nn.Module | None = dataclasses.field(
        default=None, repr=False, compare=False)
    placement: object = dataclasses.field(default=None, repr=False,
                                          compare=False)

    def ema_variables(self, tracker: EMATracker | None) -> dict:
        """The parameters with the EMA shadows of the tracker's profile
        swapped in, by name: pass as ``variables=`` to
        ``KarrasModel.loss_fn`` or ``get_denoiser``, or load into a network
        with ``load_state_dict(..., strict=False)``. Under FSDP the
        shadows are blocks, as the parameters are (``variables=`` of the
        placed network takes them; ``checkpoint.gather_state`` makes them
        whole)."""
        if self.ema is None or tracker is None:
            return dict(self.params)
        return dict(tracker.get_params(self.ema))


def _shared_scalar(value: float, device) -> torch.Tensor:
    return torch.full((), float(value), dtype=torch.float32, device=device)


class AdamWMu(torch.optim.Optimizer):
    """AdamW with its first moment stored in ``mu_dtype`` and its second
    in float32, step for step ``optax.adamw(mu_dtype=...)`` under jit: the
    new first moment (1 − b1)·g + b1·m is computed in float32, with b1
    rounded to ``mu_dtype`` (JAX makes a Python float a bfloat16 constant
    against a bfloat16 array, and XLA evaluates the product in float32),
    the update reads it in float32, and it is rounded to ``mu_dtype`` once
    when stored. Per parameter, ``state[p]`` holds
    ``step`` (one 0-d float32 tensor shared by all), ``exp_avg`` and
    ``exp_avg_sq``. ``lr``: a float or a 0-d device tensor that the caller
    fills (a schedule). Capturable: the step makes no host read."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-4, mu_dtype=torch.bfloat16):
        super().__init__(list(params), dict(lr=lr, betas=betas, eps=eps,
                                            weight_decay=weight_decay))
        self.mu_dtype = mu_dtype
        self._b1_mu = float(torch.tensor(betas[0], dtype=mu_dtype))
        params = self.param_groups[0]["params"]
        step = _shared_scalar(0.0, params[0].device)
        for p in params:
            self.state[p] = {"step": step,
                             "exp_avg": torch.zeros_like(p, dtype=mu_dtype),
                             "exp_avg_sq": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = group["params"]
            grads = [p.grad for p in params]
            mus = [self.state[p]["exp_avg"] for p in params]
            nus = [self.state[p]["exp_avg_sq"] for p in params]
            step = self.state[params[0]]["step"]
            b1, b2 = group["betas"]
            step.add_(1.0)
            mu = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(mu, [m.float() for m in mus],
                                alpha=self._b1_mu)
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, sq)
            den = torch._foreach_div(nus, 1.0 - torch.pow(b2, step))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(mu, 1.0 - torch.pow(b1, step))
            torch._foreach_div_(upd, den)
            torch._foreach_add_(upd, params, alpha=group["weight_decay"])
            lr = group["lr"]
            torch._foreach_mul_(upd, -lr if not torch.is_tensor(lr)
                                else torch.neg(lr))
            torch._foreach_add_(params, upd)
            torch._foreach_copy_(mus, mu)


class ScheduleFreeAdamW(torch.optim.Optimizer):
    """Schedule-free AdamW, step for step
    ``optax.contrib.schedule_free_adamw`` at its defaults (no warm-up,
    ``weight_lr_power`` 2): the parameters are the interpolation
    y = b1·x + (1 − b1)·z; z takes the AdamW step without momentum (RMS
    scaling with bias correction, decoupled decay on y, −lr); x is the
    running average of z with weight c = max_lr²/Σ max_lr² (0 where that
    sum is 0, as optax's ``nan_to_num``). Per parameter, ``state[p]``
    holds ``z`` and ``exp_avg_sq``, and the 0-d float32 tensors ``step``
    (the RMS count), ``weight_sum`` and ``max_lr``, shared by all.
    ``lr`` is a float. Capturable: the step makes no host read."""

    def __init__(self, params, lr: float, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=1e-4):
        super().__init__(list(params), dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                            weight_decay=weight_decay))
        params = self.param_groups[0]["params"]
        device = params[0].device
        shared = {k: _shared_scalar(0.0, device)
                  for k in ("step", "weight_sum", "max_lr")}
        for p in params:
            self.state[p] = dict(shared, z=p.detach().clone(),
                                 exp_avg_sq=torch.zeros_like(p))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = group["params"]
            grads = [p.grad for p in params]
            first = self.state[params[0]]
            zs = [self.state[p]["z"] for p in params]
            nus = [self.state[p]["exp_avg_sq"] for p in params]
            b1, b2, lr = group["b1"], group["b2"], group["lr"]
            max_lr = first["max_lr"]
            max_lr.clamp_(min=lr)
            weight = max_lr * max_lr
            total = first["weight_sum"] + weight
            ck = torch.where(weight.isnan() | total.isnan(),
                             torch.full_like(weight, float("nan")),
                             torch.nan_to_num(weight / total, nan=0.0,
                                              posinf=float("inf")))
            first["weight_sum"].copy_(total)
            step = first["step"]
            step.add_(1.0)
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, sq)
            den = torch._foreach_div(nus, 1.0 - torch.pow(b2, step))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(grads, den)
            torch._foreach_add_(upd, params, alpha=group["weight_decay"])
            torch._foreach_mul_(upd, -lr)
            z_new = torch._foreach_add(zs, upd)
            # x recovered from y and the old z, then averaged toward z
            x = torch._foreach_mul(zs, -(1.0 - b1))
            torch._foreach_add_(x, params)
            torch._foreach_div_(x, b1)
            torch._foreach_mul_(x, 1.0 - ck)
            torch._foreach_add_(x, torch._foreach_mul(z_new, ck))
            y = torch._foreach_mul(x, b1)
            torch._foreach_add_(y, torch._foreach_mul(z_new, 1.0 - b1))
            torch._foreach_sub_(y, params)
            torch._foreach_add_(params, y)
            torch._foreach_copy_(zs, z_new)


@dataclasses.dataclass(frozen=True)
class AdamWClip:
    """AdamW after clipping the gradients by their global norm, as
    ``optax.chain(clip_by_global_norm(c), adamw(...))``. torch's AdamW
    update equals optax's (decoupled decay p·(1 - lr·wd), eps outside the
    square root); the clip is optax's g·c/max(‖g‖, c), not
    ``torch.nn.utils.clip_grad_norm_``, whose +1e-6 changes the numbers.
    ``learning_rate``: a float, or a schedule ``count -> lr`` (e.g.
    ``warmup_cosine_schedule``) read at the number of updates before each
    one, as optax counts.

    ``frozen`` (``freeze_optimizer``): names of parameters that get no
    update at all, no AdamW step and no weight decay, and whose gradients
    the clip's norm leaves out. ``every`` (``accumulate_gradients``): the
    number of micro-batches whose mean gradient makes one update.

    ``mu_dtype`` (e.g. ``torch.bfloat16``): AdamW's first moment in that
    dtype (``AdamWMu``). ``schedule_free``: schedule-free AdamW in place of
    AdamW (``ScheduleFreeAdamW``; b1 is its interpolation weight, and the
    learning rate a float)."""
    learning_rate: float | Callable[[int], float]
    weight_decay: float
    b1: float
    b2: float
    grad_clip: float | None
    eps: float = 1e-8
    frozen: frozenset = frozenset()
    every: int = 1
    mu_dtype: torch.dtype | None = None
    schedule_free: bool = False

    def trainable(self, params: dict) -> dict:
        """The parameters (by name) that the optimizer updates."""
        return {k: p for k, p in params.items() if k not in self.frozen}

    def init(self, params: dict) -> torch.optim.AdamW:
        """torch's AdamW over the trainable ``params`` (name -> tensor),
        its moments made now (zeros, as its first step would make them),
        so that a checkpoint of a fresh state holds them too. On CUDA
        parameters it is capturable (step count and bias corrections on
        the device, so a graph can replay its step), and under a schedule
        its learning rate is a 0-d device tensor that
        ``set_learning_rate`` fills before each step. ``capturable`` is
        for CUDA parameters only."""
        params = list(self.trainable(params).values())
        if self.schedule_free:
            return ScheduleFreeAdamW(params, self.learning_rate, self.b1,
                                     self.b2, self.eps, self.weight_decay)
        cuda = any(p.is_cuda for p in params)
        lr = self.learning_rate
        if callable(lr):
            lr = float(lr(0))
            if cuda:
                lr = torch.tensor(lr, device=params[0].device)
        if self.mu_dtype is not None:
            return AdamWMu(params, lr, (self.b1, self.b2), self.eps,
                           self.weight_decay, self.mu_dtype)
        optimizer = torch.optim.AdamW(params, lr=lr, betas=(self.b1, self.b2),
                                      eps=self.eps,
                                      weight_decay=self.weight_decay,
                                      capturable=cuda)
        # the first step of each graph runs uncaptured, as its warm-up
        optimizer._warned_capturable_if_run_uncaptured = True
        for p in params:
            optimizer.state[p] = {
                "step": torch.zeros((), device=p.device) if cuda
                else torch.tensor(0.0),
                "exp_avg": torch.zeros_like(
                    p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(
                    p, memory_format=torch.preserve_format)}
        return optimizer

    def init_accumulation(self, params: dict) -> GradAccumulation | None:
        """The accumulation's state over the trainable ``params`` (None
        when ``every`` is 1)."""
        if self.every == 1:
            return None
        trainable = self.trainable(params)
        device = next(iter(trainable.values())).device
        return GradAccumulation(
            grads={k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in trainable.items()},
            count=torch.ones((), device=device))

    def set_learning_rate(self, optimizer: torch.optim.Optimizer,
                          count: int) -> None:
        """Under a schedule, its rate for the update that follows ``count``
        updates, into every param group: a host float, or a fill of the
        device tensor that a replayed graph reads."""
        if not callable(self.learning_rate):
            return
        lr = float(self.learning_rate(count))
        for group in optimizer.param_groups:
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr

    def update(self, state: "TrainState", norm: torch.Tensor,
               emit: bool = True) -> None:
        """From the ``.grad`` of every trainable parameter (``norm``: the
        global norm of every parameter's gradient): under accumulation,
        fold them into the running mean (acc + (g − acc)/count, optax's
        Welford form), and unless ``emit`` stop there; clip by the global
        norm of what the optimizer steps on (optax's g·c/max(‖g‖, c), the
        trainable gradients or their mean), take the AdamW step, and under
        accumulation zero the mean. Device work only."""
        params = [p for group in state.optimizer.param_groups
                  for p in group["params"]]
        grads = [p.grad for p in params]
        acc = state.accum
        if acc is not None:
            mean = list(acc.grads.values())
            torch._foreach_add_(mean, torch._foreach_div(
                torch._foreach_sub(grads, mean), acc.count))
            if not emit:
                return
            torch._foreach_copy_(grads, mean)
        if self.grad_clip is not None:
            if acc is not None or self.frozen:
                norm = _norm(state, params)
            c = self.grad_clip
            torch._foreach_mul_(grads, c / torch.clamp(norm, min=c))
        state.optimizer.step()
        if acc is not None:
            torch._foreach_zero_(mean)


def default_optimizer(learning_rate: float | Callable[[int], float] = 1e-3,
                      weight_decay: float = 1e-4, b1: float = 0.9,
                      b2: float = 0.999,
                      grad_clip: float | None = 0.5,
                      mu_dtype: torch.dtype | None = None) -> AdamWClip:
    """The JAX package's default: AdamW (lr 1e-3, wd 1e-4, betas (0.9,
    0.999)) after clipping by global norm 0.5. ``learning_rate``: a float
    or a schedule (``warmup_cosine_schedule``,
    ``cosine_restarts_schedule``). ``mu_dtype`` (e.g. ``torch.bfloat16``):
    the dtype of AdamW's first moment, which halves its bytes; the second
    moment stays float32."""
    return AdamWClip(learning_rate, weight_decay, b1, b2, grad_clip,
                     mu_dtype=mu_dtype)


def schedule_free_optimizer(learning_rate: float = 1e-3, b1: float = 0.9,
                            weight_decay: float = 1e-4,
                            grad_clip: float | None = 0.5) -> AdamWClip:
    """Schedule-free AdamW (``optax.contrib.schedule_free_adamw``: b2
    0.999, eps 1e-8, ``weight_lr_power`` 2, no warm-up) after clipping by
    global norm, as the JAX package's ``schedule_free_optimizer``. Train
    with it; evaluate and serve with ``schedule_free_eval_params``."""
    if callable(learning_rate):
        raise ValueError("schedule_free_optimizer takes a constant "
                         "learning rate")
    return AdamWClip(learning_rate, weight_decay, b1, 0.999, grad_clip,
                     schedule_free=True)


def schedule_free_eval_params(state: "TrainState") -> dict:
    """The evaluation-mode parameters of a state trained with
    ``schedule_free_optimizer``, by name: x = (y − (1 − b1)·z)/b1 for the
    trained ones (b1 as float32, as optax reads it from its state), the
    others as they are. Load them with ``load_state_dict(...,
    strict=False)`` or pass them as ``variables=``."""
    opt = state.optimizer
    if not isinstance(opt, ScheduleFreeAdamW):
        raise ValueError("optimizer state contains no ScheduleFreeState; "
                         "train with schedule_free_optimizer()")
    b1 = torch.tensor(opt.param_groups[0]["b1"], dtype=torch.float32)
    out = {}
    with torch.no_grad():
        for name, p in state.params.items():
            slot = opt.state.get(p)
            out[name] = p.detach().clone() if slot is None else \
                (p - (1.0 - b1).to(p.device) * slot["z"]) / b1.to(p.device)
    return out


def split_variables(net: torch.nn.Module) -> tuple[dict, dict]:
    """A network's tensors as (parameters by name, buffers by name): the
    JAX package's (params, consts)."""
    return dict(net.named_parameters()), dict(net.named_buffers())


def freeze_mask(params: dict, patterns) -> dict:
    """name -> True (trainable) or False (frozen): frozen where a glob of
    ``patterns`` matches the parameter's dotted name (e.g.
    ``"model.downward_blocks.*"``)."""
    return {name: not any(fnmatch.fnmatch(name, pat) for pat in patterns)
            for name in params}


def freeze_optimizer(tx: AdamWClip, params: dict, patterns) -> AdamWClip:
    """``tx`` with the parameters that ``patterns`` match frozen: they get
    no update, no weight decay, and the clip's norm leaves their gradients
    out, as ``optax.multi_transform`` with ``set_to_zero`` around
    ``chain(clip, adamw)`` does."""
    mask = freeze_mask(params, patterns)
    return dataclasses.replace(tx, frozen=tx.frozen | frozenset(
        name for name, trainable in mask.items() if not trainable))


def accumulate_gradients(tx: AdamWClip, every: int) -> AdamWClip:
    """``tx`` taking one update per ``every`` micro-batches, on their mean
    gradient (optax ``MultiSteps``): the parameters do not move in between,
    while the state's step count and the EMA advance on every micro-step,
    as in the JAX package."""
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    return dataclasses.replace(tx, every=every)


def _cosine_decay(init_value: float, decay_steps: int, alpha: float):
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count):
        count = min(count, decay_steps)
        decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * decay + alpha)

    return schedule


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           decay_steps: int, end_factor: float = 0.0):
    """Linear warmup from 0 to ``peak_lr`` over ``warmup_steps``, then
    cosine decay to ``end_factor·peak_lr`` at ``decay_steps`` (warmup
    included): optax's ``warmup_cosine_decay_schedule`` as the JAX
    package builds it (``diffsci_tpu/models/karras/train.py:261-270``).
    Pass the result as ``default_optimizer(learning_rate=...)``."""
    end = end_factor * peak_lr
    alpha = 0.0 if peak_lr == 0.0 else end / peak_lr
    decay = _cosine_decay(peak_lr, decay_steps - warmup_steps, alpha)

    def schedule(count: int) -> float:
        if count < warmup_steps:   # optax.linear_schedule(0, peak, warmup)
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (0.0 - peak_lr) * frac + peak_lr
        return decay(count - warmup_steps)

    return schedule


def cosine_restarts_schedule(peak_lr: float, period: int,
                             n_restarts: int = 10, end_factor: float = 0.0):
    """Cosine annealing with warm restarts (SGDR): ``n_restarts`` equal
    cycles of ``period`` steps from ``peak_lr`` down to
    ``end_factor·peak_lr``, holding the end value after the last: optax's
    ``sgdr_schedule`` as the JAX package builds it
    (``diffsci_tpu/models/karras/train.py:273-283``)."""
    cycle = warmup_cosine_schedule(peak_lr, 0, period, end_factor)

    def schedule(count: int) -> float:
        restart = min(max(count, 0) // period, n_restarts - 1)
        return cycle(count - restart * period)

    return schedule


def nan_to_zero_grads(grads: list) -> None:
    """NaN and ±inf gradient entries become 0, in place."""
    for g in grads:
        torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)


@torch.no_grad()
def renormalize_mp_weights(module: torch.nn.Module, eps: float = 1e-4) -> None:
    """Re-project every magnitude-preserving weight of ``module`` onto the
    unit sphere, in place (``diffsci_tpu/models/karras/train.py:86-110``):
    dense and conv weights per output unit, attention projections
    [H, C, dh] over the model axis (q, k, v) or over (heads, dhead) (o)."""
    for m in module.modules():
        if hasattr(m, "renormalize_"):
            m.renormalize_(eps)


def global_norm(tensors: list) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm) of
    local tensors; a state over a mesh takes its norm from its placement,
    which sums a sharded gradient's squares over its shards."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def _norm(state: TrainState, params: list) -> torch.Tensor:
    """The global norm of the gradients of ``params`` (tensors that the
    optimizer steps) of ``state``."""
    grads = [p.grad for p in params]
    if state.placement is None:
        return global_norm(grads)
    names = {id(p): k for k, p in state.params.items()}
    return state.placement.global_norm(
        {names[id(p)]: p.grad for p in params})


def create_train_state(model, x_shape, seed: int | None = 0,
                       optimizer: AdamWClip | None = None,
                       ema: EMATracker | None = None):
    """Initialise the weights from ``seed`` (None keeps the network's
    current weights, e.g. a loaded state dict), the optimizer and the EMA.
    ``x_shape`` is the channels-last batch shape the state will train on;
    it is checked against a PUNetG's config (a latent model's latent
    shape). Returns (state, tx)."""
    net = model.net.model
    net_cfg = getattr(net, "config", None)
    # a latent model's network sees the autoencoder's latents
    shape = model.latent_shape(x_shape) if getattr(
        model, "latent_model", False) else tuple(x_shape)
    # PUNetGCond's input_channels count its concatenated conditions too;
    # configs without these fields (ConVit's) are not checked
    if hasattr(net_cfg, "dimension") and hasattr(
            net_cfg, "input_channels") and (
            len(shape) != net_cfg.dimension + 2 or not (
                getattr(net, "channel_conditional_items", ())
                or shape[-1] == net_cfg.input_channels)):
        raise ValueError(f"x_shape {tuple(shape)} is not [B, *"
                         f"{net_cfg.dimension}D spatial, "
                         f"{net_cfg.input_channels}]")
    if seed is not None:
        model.init(seed)
    tx = optimizer if optimizer is not None else default_optimizer()
    return _new_train_state(model, tx, ema), tx


def _new_train_state(model, tx: AdamWClip,
                     ema: EMATracker | None = None) -> TrainState:
    """A train state over the model's current weights."""
    params, buffers = split_variables(model.net)
    return TrainState(params=params, optimizer=tx.init(params),
                      ema=ema.init(params) if ema is not None else None,
                      buffers=buffers, accum=tx.init_accumulation(params),
                      module=model.net)


def _begin_update(state: TrainState, tx: AdamWClip) -> bool:
    """Before a step: the schedule's learning rate for the updates taken
    so far and, under accumulation, the divisor of this micro-batch.
    Returns whether this step takes the optimizer step."""
    acc = state.accum
    tx.set_learning_rate(state.optimizer,
                         state.step if acc is None else acc.gradient_step)
    if acc is None:
        return True
    acc.count.fill_(acc.mini_step + 1)
    return acc.mini_step == tx.every - 1


def _end_update(state: TrainState, tx: AdamWClip, emit: bool) -> None:
    acc = state.accum
    if acc is not None:
        acc.mini_step = (acc.mini_step + 1) % tx.every
        acc.gradient_step += emit
    state.step += 1


def _draw(model, x, generator, sigma, eps, keep, out, z_eps=None,
          rows: tuple = (1, 0), slab=None):
    """σ, then a latent model's posterior draw (when its autoencoder
    samples one), then ε, then the condition-drop mask (when the network
    drops conditions), in the eager step's order, each drawn from
    ``generator`` unless replayed (``sigma=``, ``z_eps=``, ``eps=``,
    ``keep=``), into the tensors ``out`` (σ [B], ε of the diffusion
    space's shape, the mask [B] bool or None, the posterior draw of that
    shape or None). ``rows`` = (n, i): x is the i-th of n equal blocks of
    rows of a global batch; the draws (and the replayed ones) are the
    global batch's, and ``out`` takes block i. ``slab`` (a spatial
    placement's ``SpatialLayout``, or None): x is also one of its slabs
    along dim 1 (``_draw_slab``). Returns ``out``."""
    n, i = rows
    if slab is not None and slab.n > 1:
        return _draw_slab(model, x, generator, sigma, eps, keep, out, z_eps,
                          rows, slab)
    if n > 1:
        every = tuple(None if t is None else t.new_empty(
            (t.shape[0] * n,) + tuple(t.shape[1:])) for t in out)
        _draw(model, every[0], generator, sigma, eps, keep, every, z_eps)
        for t, g in zip(out, every):
            if t is not None:
                t.copy_(g[i * t.shape[0]:(i + 1) * t.shape[0]])
        return out
    sigma_out, eps_out, keep_out = out[:3]
    z_out = out[3] if len(out) > 3 else None
    if sigma is None:
        model.config.noisesampler.sample((x.shape[0],), generator,
                                         out=sigma_out)
    else:
        sigma_out.copy_(sigma)
    if z_out is not None:
        if z_eps is None:
            torch.randn(z_out.shape, generator=generator, out=z_out)
        else:
            z_out.copy_(z_eps)
    if eps is None:
        torch.randn(eps_out.shape, generator=generator, out=eps_out)
    else:
        eps_out.copy_(eps)
    if keep_out is not None:
        if keep is None:
            model.draw_cond_keep(x.shape[0], generator, out=keep_out)
        else:
            keep_out.copy_(keep)
    return out


def _draw_slab(model, x, generator, sigma, eps, keep, out, z_eps, rows,
               slab):
    """``_draw`` for a slab of a dp × spatial mesh: σ and the keep mask of
    the global batch, of which ``out`` takes its rows; ε in the global
    order, one row [1, *spatial, C] a draw, of which this rank keeps the
    slab of its rows (no rank holds the whole global ε; on the CPU, whose
    generator fills a tensor in blocks of 16 values, the rows give the
    single draw's values when a row's size divides by 16). A replayed ε is
    the global batch's. A latent model's posterior draw raises."""
    sigma_out, eps_out, keep_out = out[:3]
    if len(out) > 3 and out[3] is not None:
        raise NotImplementedError("a latent model is not ported to a "
                                  "spatial mesh")
    n, i = rows
    B, L, j = x.shape[0], eps_out.shape[slab.dim], slab.index
    whole = torch.empty(B * n, device=sigma_out.device)
    if sigma is None:
        model.config.noisesampler.sample((B * n,), generator, out=whole)
    else:
        whole.copy_(sigma)
    keep_rows(sigma_out, whole, i)
    if eps is None:
        row = eps_out.new_empty((1,) + tuple(eps_out.shape[1:slab.dim])
                                + (L * slab.n,)
                                + tuple(eps_out.shape[slab.dim + 1:]))
        for r in range(B * n):
            torch.randn(row.shape, generator=generator, out=row)
            if i * B <= r < (i + 1) * B:
                keep_rows(eps_out[r - i * B:r - i * B + 1], row, j,
                          slab.dim)
    else:
        keep_rows(eps_out, eps[i * B:(i + 1) * B], j, slab.dim)
    if keep_out is not None:
        mask = torch.empty(B * n, dtype=torch.bool, device=keep_out.device)
        if keep is None:
            model.draw_cond_keep(B * n, generator, out=mask)
        else:
            mask.copy_(keep)
        keep_rows(keep_out, mask, i)
    return out


def _keep_like(model, x):
    """The condition-drop mask's tensor for a batch like x, or None."""
    if getattr(model, "cond_drop_rate", None) is None:
        return None
    return torch.empty(x.shape[0], dtype=torch.bool, device=x.device)


def _draw_tensors(model, x, posterior: bool = True) -> tuple:
    """Empty tensors for a step's draws over the batch x: σ [B], ε of
    the diffusion space's shape (a latent model's latent shape), the
    condition-drop mask (or None) and the posterior draw (or None)."""
    shape = model.latent_shape(x.shape)
    z = torch.empty(shape, dtype=x.dtype, device=x.device) \
        if posterior and model.draws_posterior() else None
    return (torch.empty(x.shape[0], device=x.device),
            torch.empty(shape, dtype=x.dtype, device=x.device),
            _keep_like(model, x), z)


def _step_loss(model, loss_fn, remat: bool):
    """The step's loss ``(x, sigma, y, mask, eps, keep) -> (scalar, the
    batch norm's updated statistics by buffer name)``: ``loss_fn`` (no
    updates) or the model's loss in training mode; with ``remat``, under
    ``torch.utils.checkpoint``, which stores only its inputs and runs the
    forward again in the backward pass (the kernels' autograd Functions
    included), as ``jax.checkpoint`` rematerialises. It saves and
    restores the RNG state, so that dropout draws the same masks again;
    torch 2.11 captures that into a CUDA graph."""
    def loss(x, sigma, y, mask, eps, keep, z_eps=None):
        if loss_fn is not None:
            return loss_fn(x, sigma, y, mask, eps), {}
        return model.loss_fn(x, sigma, y, mask, train=True, eps=eps,
                             cond_keep=keep, return_updates=True,
                             z_eps=z_eps)

    if not remat:
        return loss

    def remat_loss(x, sigma, y, mask, eps, keep, z_eps=None):
        return checkpoint(loss, x, sigma, y, mask, eps, keep, z_eps,
                          use_reentrant=False)

    return remat_loss


def synced_norm(placed, params: dict, nan_guard: bool = True
                ) -> torch.Tensor:
    """After the backward: a zero ``.grad`` for every parameter of
    ``params`` the loss left without one; under a placement (``placed``,
    or None) the gradients made the global batch's mean
    (``Placement.sync_grads``) before the NaN→0 guard (``nan_guard``).
    Returns the global norm of the gradients."""
    grads = []
    for p in params.values():
        if p.grad is None:          # unused by this loss: a zero grad
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    if placed is None:
        if nan_guard:
            nan_to_zero_grads(grads)
        return global_norm(grads)
    # the global batch's mean gradient before the guard and clip
    placed.sync_grads(params)
    if nan_guard:
        nan_to_zero_grads(grads)
    return placed.global_norm({k: p.grad for k, p in params.items()})


def check_placement(state, what: str) -> None:
    """Raise when ``state``'s placement is one the step ``what`` cannot
    honour: a spatial mesh (its draws and layers are the Karras train
    step's only)."""
    placed = getattr(state, "placement", None)
    if placed is not None and placed.spatial is not None:
        raise NotImplementedError(
            f"{what} does not take a spatially sharded state (only "
            "make_train_step does)")


def batch_like(x: torch.Tensor, n: int) -> torch.Tensor:
    """A stand-in for the global batch of ``n`` blocks of x's rows: its
    shape and device, one stored element (the draws' allocations read no
    more of a batch)."""
    return torch.empty((), dtype=x.dtype, device=x.device).expand(
        (x.shape[0] * n,) + tuple(x.shape[1:]))


def keep_rows(local: torch.Tensor, whole: torch.Tensor, i: int,
              dim: int = 0) -> torch.Tensor:
    """``local`` filled with block i of ``whole`` along ``dim`` (blocks of
    ``local``'s size): a rank's part of a global batch's draw."""
    k = local.shape[dim]
    return local.copy_(whole.narrow(dim, i * k, k))


def _capturable(state: TrainState) -> bool:
    """Whether a CUDA graph can capture the state's step: no placement, or
    one over NCCL (a step over gloo runs eagerly)."""
    return state.placement is None or state.placement.capturable


def _rows(state: TrainState) -> tuple:
    """(the distinct batch shards, this rank's) of a state's step."""
    if state.placement is None:
        return (1, 0)
    return state.placement.batch_shards()


def _slab(state: TrainState):
    """A spatially sharded state's ``SpatialLayout``, or None."""
    return getattr(state.placement, "spatial", None)


def make_train_step(model, tx: AdamWClip, ema: EMATracker | None = None,
                    loss_fn: Callable | None = None, remat: bool = False,
                    has_mp_weights: bool = False, _raw: bool = False):
    """The train step ``step(state, x, y=None, mask=None, generator=None,
    sigma=None, eps=None, keep=None) -> (state, metrics)``: draw σ (from
    ``generator``, by the configuration's noise sampler: log-normal for
    EDM, σ(t) of a uniform t for VP, log-uniform for VE), ε and, when the
    network drops conditions, the keep mask [B]; the configuration's loss,
    backward through the network, NaN→0 guard, global-norm clip, AdamW at
    the schedule's rate (under ``accumulate_gradients``, on every
    ``every``-th micro-step, on the mean gradient; frozen parameters get
    no update), the magnitude-preserving re-projection
    (``has_mp_weights``), the batch norm's running statistics, EMA.
    ``sigma``, ``eps`` and ``keep`` replay fixed draws (the
    cross-framework tests use them).
    ``metrics`` holds ``train_loss`` and ``grad_norm`` (after the guard,
    before the clip) as device tensors. ``state`` is updated in place and
    returned.

    ``loss_fn(x, sigma, y, mask, eps) -> loss`` replaces the model's
    loss; ``remat=True`` recomputes the loss's forward in the backward
    pass instead of storing its activations. On a CUDA device the step is
    captured and replayed as a CUDA graph held by the state (module
    docstring); ``_raw=True`` returns the eager step."""
    loss_of = _step_loss(model, loss_fn, remat)

    buffers = dict(model.net.named_buffers())

    def update(state, x, y, mask, sigma, eps, keep, z_eps=None, emit=True):
        """Loss, backward, NaN guard, clip, AdamW (under accumulation: the
        running mean, and the step when ``emit``), the mp re-projection
        and the batch norm's statistics from fixed draws: device work
        only, which the graphed step captures. Returns the loss and the
        gradients' global norm."""
        placed = state.placement
        for p in state.params.values():
            p.grad = None
        loss, updates = loss_of(x, sigma, y, mask, eps, keep, z_eps)
        loss.backward()
        norm = synced_norm(placed, state.params)
        if placed is not None:
            loss = placed.mean_over_ranks(loss.detach())
        tx.update(state, norm, emit)
        if has_mp_weights:
            renormalize_mp_weights(model.net)
        with torch.no_grad():
            for name, value in updates.items():
                buffers[name].copy_(value)
        return loss.detach(), norm

    posterior = loss_fn is None

    def raw_step(state: TrainState, x, y=None, mask=None, generator=None,
                 sigma=None, eps=None, keep=None, z_eps=None):
        sigma, eps, keep, z_eps = _draw(
            model, x, generator, sigma, eps, keep,
            _draw_tensors(model, x, posterior), z_eps, _rows(state),
            _slab(state))
        emit = _begin_update(state, tx)
        loss, norm = update(state, x, y, mask, sigma, eps, keep, z_eps,
                            emit)
        if ema is not None and state.ema is not None:
            ema.update(state.ema, state.params)
        _end_update(state, tx, emit)
        return state, {"train_loss": loss, "grad_norm": norm}

    if _raw:
        return raw_step

    def train_step(state: TrainState, x, y=None, mask=None, generator=None,
                   sigma=None, eps=None, keep=None, z_eps=None):
        if x.device.type != "cuda" or not _capturable(state):
            return raw_step(state, x, y, mask, generator, sigma, eps, keep,
                            z_eps)
        if state.graphs is None:
            state.graphs = graphs.GraphCache(x.device)
        cache = state.graphs
        emit = _begin_update(state, tx)
        key = (tuple(x.shape), x.dtype, graphs.condition_key(y),
               graphs.condition_key(mask), state.optimizer, tx, loss_fn,
               remat, has_mp_weights, emit, state.placement)
        graph = cache.graphs.get(key)
        if graph is None:
            inputs = (torch.empty_like(x), graphs.static_like(y, x.device),
                      graphs.static_like(mask, x.device)) \
                + _draw_tensors(model, x, posterior)
        else:
            inputs = graph.inputs
        xs, ys, masks = inputs[:3]
        xs.copy_(x)
        graphs.fill(ys, y)
        graphs.fill(masks, mask)
        _draw(model, x, generator, sigma, eps, keep, inputs[3:], z_eps,
              _rows(state), _slab(state))
        if graph is None:
            def body():
                return update(state, *inputs, emit=emit)

            loss, norm = cache.warmup(body)
            cache.capture(key, body).inputs = inputs
        else:
            graph.replay()
            loss, norm = (t.clone() for t in graph.outputs)
        # a replay moves no version counter: the sampler's cast copy of
        # the weights is refreshed at its next use
        model._masters_changed()
        if ema is not None and state.ema is not None:
            _ema_graph_update(ema, cache, state.ema, state.params)
        _end_update(state, tx, emit)
        return state, {"train_loss": loss, "grad_norm": norm}

    return train_step


def _ema_graph_update(ema: EMATracker, cache, ema_state: EMAState,
                      params: dict) -> None:
    """Advance the EMA and, on the steps where the shadows move, replay
    the cache's EMA graph (captured at its first use) with the new
    decays."""
    betas = ema.advance(ema_state)
    if betas is None:
        return
    ema.set_decays(ema_state, betas)
    graph = cache.graphs.get("ema")
    if graph is not None and graph.inputs is ema_state:
        graph.replay()
        return

    def apply():
        ema.apply(ema_state, params)

    cache.warmup(apply)
    cache.capture("ema", apply).inputs = ema_state


def make_train_scan(model, tx: AdamWClip, ema: EMATracker | None = None,
                    loss_fn: Callable | None = None, remat: bool = False,
                    has_mp_weights: bool = False):
    """K train steps a call: ``scan_steps(state, xs, ys=None,
    generator=None, sigmas=None, epss=None) -> (state, metrics)`` with xs
    [K, B, ...] (K batches), ys [K, ...], replayed draws sigmas [K, B] and
    epss [K, B, ...], and metrics stacked [K]. Exactly K applications of
    ``make_train_step``'s step (same body, same draws in the same order,
    the same EMA cadence and learning-rate count), as the JAX package's
    scan (``diffsci_tpu/models/karras/train.py:209-241``). On a CUDA
    device each step replays the step's graph, the one any step over the
    same state and loss replays (``state.graphs``), and nothing waits for
    the device between the steps."""
    step = make_train_step(model, tx, ema=ema, loss_fn=loss_fn, remat=remat,
                           has_mp_weights=has_mp_weights)

    def scan_steps(state: TrainState, xs, ys=None, generator=None,
                   sigmas=None, epss=None):
        metrics = {"train_loss": [], "grad_norm": []}
        for k in range(xs.shape[0]):
            state, met = step(state, xs[k], None if ys is None else ys[k],
                              generator=generator,
                              sigma=None if sigmas is None else sigmas[k],
                              eps=None if epss is None else epss[k])
            for name, value in met.items():
                metrics[name].append(value)
        return state, {name: torch.stack(values) if values else
                       torch.empty(0, device=xs.device)
                       for name, values in metrics.items()}

    return scan_steps


def make_eval_step(model, ema: EMATracker | None = None,
                   use_ema: bool = False, _raw: bool = False):
    """The validation step ``step(state, x, y=None, mask=None,
    generator=None, sigma=None, eps=None) -> {"valid_loss"}``: σ, then ε
    drawn from ``generator`` (unless replayed), and the loss without
    gradients, in eval mode, on the state's parameters or, when
    ``use_ema``, the EMA shadows of the tracker's profile. ``valid_loss``
    is a device tensor.

    On a CUDA device the step is a CUDA graph per (x's shape and dtype, the
    condition's and mask's shapes, the EMA profile read) held by the
    state, as the train step is: σ and ε are drawn into its static inputs
    before each replay, and it reads the parameters, the shadows and the
    batch norm's buffers in place, so it sees every update.
    ``_raw=True`` returns the eager step."""

    def loss(state, x, y, mask, sigma, eps, z_eps=None):
        variables = state.ema_variables(ema) if use_ema else \
            dict(state.params)
        with torch.no_grad():
            out = model.loss_fn(x, sigma, y, mask, train=False, eps=eps,
                                variables=variables, z_eps=z_eps)
        if state.placement is not None:
            out = state.placement.mean_over_ranks(out)
        return out

    def draw_tensors(x):
        sigma, eps, _, z = _draw_tensors(model, x)
        return sigma, eps, None, z

    def raw_step(state: TrainState, x, y=None, mask=None, generator=None,
                 sigma=None, eps=None):
        sigma, eps, _, z_eps = _draw(model, x, generator, sigma, eps, None,
                                     draw_tensors(x), rows=_rows(state),
                                     slab=_slab(state))
        return {"valid_loss": loss(state, x, y, mask, sigma, eps, z_eps)}

    if _raw:
        return raw_step

    def eval_step(state: TrainState, x, y=None, mask=None, generator=None,
                  sigma=None, eps=None):
        if x.device.type != "cuda" or not _capturable(state):
            return raw_step(state, x, y, mask, generator, sigma, eps)
        if state.graphs is None:
            state.graphs = graphs.GraphCache(x.device)
        cache = state.graphs
        # the graph reads the tensors of one EMA profile, or the params
        profile = ema.profile_index if use_ema and ema is not None else None
        key = ("eval", tuple(x.shape), x.dtype, graphs.condition_key(y),
               graphs.condition_key(mask), profile, state.placement)
        graph = cache.graphs.get(key)
        if graph is None:
            inputs = (torch.empty_like(x), graphs.static_like(y, x.device),
                      graphs.static_like(mask, x.device)) + draw_tensors(x)
        else:
            inputs = graph.inputs
        xs, ys, masks, sigmas, epss, _, zs = inputs
        xs.copy_(x)
        graphs.fill(ys, y)
        graphs.fill(masks, mask)
        _draw(model, x, generator, sigma, eps, None, inputs[3:],
              rows=_rows(state), slab=_slab(state))
        if graph is None:
            def body():
                return loss(state, xs, ys, masks, sigmas, epss, zs)

            out = cache.warmup(body)
            cache.capture(key, body).inputs = inputs
        else:
            graph.replay()
            out = graph.outputs.clone()
        return {"valid_loss": out}

    return eval_step
