"""Progressive distillation (Salimans & Ho, arXiv:2202.00512) for the EDM
denoiser runtime: a student learns to take in one Euler step what its
teacher takes in two, and the halving repeats down to one or two steps;
and 1-NFE sampling with the student of the last halving.

Port of ``diffsci_tpu/models/karras/distill.py``: ``distill_interval_grid``,
``_denoiser_step``, ``distill_targets``, ``make_distill_step``,
``halving_schedule``, ``sample_onestep`` (with ``compile_onestep``, its
graph) and ``distill_progressive``. The JAX package's module docstring
derives the method; in short:

- The EDM ρ-grid nests: the grid of 2N − 1 steps holds the N-step grid as
  every second point (the same IEEE quotients), both ending with the
  σ_min → 0 interval, so a student samples through the ordinary
  ``KarrasModel.sample(nsteps=N, integrator="euler")``.
- For a student interval [a, b] the teacher steps a → m → b (the last
  interval, σ_min → 0, is one teacher step: m = b = 0), and the target of
  the student's denoiser is the exact inverse of its Euler step,
  D_tgt = x + (X − x)·a/(a − b), weighted by ((a − b)/a)², so that the
  loss is the induced next-state error ‖x_b(D_s) − X‖².
- The teacher's sub-steps are Heun with the EDM endpoint rule (the
  sampler's own), or Euler when the teacher is itself a distilled student
  (Heun double-corrects a distilled D).

Here the teacher is a ``KarrasModel`` whose network holds the teacher's
weights (the JAX package passes them as variables). On a CUDA device the
distill step is a CUDA graph per (x's shape and dtype, y's shapes,
student steps, Heun or Euler, the guidance, the teacher, the optimizer),
the counterpart of the JAX package's one executable per (batch shape,
nsteps): the teacher's denoiser calls run inside it, reading the
teacher's tensors in place (cast to the compute dtype in the graph, so a
teacher reloaded in place with ``load_state_dict`` is seen by the next
replay); the interval index, ε and the condition drop are drawn into its
static inputs before each replay. Minimum student steps: 1 (the terminal
σ_max → 0 interval samples through ``sample_onestep``).
"""

from __future__ import annotations

import copy
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from diffsci_tpu_torch.models.karras.ema import EMATracker
from diffsci_tpu_torch.models.karras.train import (
    AdamWClip, TrainState, _capturable, _ema_graph_update, _new_train_state,
    _rows, batch_like, check_placement, default_optimizer, keep_rows,
    renormalize_mp_weights, synced_norm)
from diffsci_tpu_torch.utils import bcast_right, graphs


def _check_distillable(model, student_nsteps: int) -> None:
    """Distillation needs EDM scheduling (sampler time = σ, constant
    scaling) in the diffusion space, and at least one student step."""
    sf = model.config.noisescheduler.scheduling
    if not (getattr(sf, "constant_scaling", False)
            and getattr(sf, "identity_noise", False)):
        raise NotImplementedError(
            "progressive distillation needs EDM scheduling (sampler time "
            "== sigma, constant scaling); got a scheduler whose time "
            "variable is not sigma")
    if getattr(model, "latent_model", False):
        raise NotImplementedError(
            "distill the latent-space KarrasModel directly (distillation "
            "operates in the diffusion space)")
    if student_nsteps < 1:
        raise ValueError("student_nsteps must be >= 1")


def distill_interval_grid(model, student_nsteps: int):
    """The σ triples (a, m, b) of the student's intervals: the student
    steps a → b, the teacher a → m → b on its own grid of
    2·student_nsteps − 1 steps; the last interval (σ_min → 0) is one
    teacher step, m = b = 0. For one student step the single interval is
    σ_max → 0 with the 2-step student's grid as the teacher's
    (σ_max → σ_min → 0). Computed on the host in float64 from the
    scheduler's grid and cast once: float32 numpy arrays [student_nsteps].
    """
    sched = model.config.noisescheduler
    if student_nsteps == 1:
        T2 = np.asarray(sched.create_steps(3), np.float64)
        return (np.array([T2[0]], np.float32), np.array([T2[1]], np.float32),
                np.array([0.0], np.float32))
    T = np.asarray(sched.create_steps(2 * student_nsteps), np.float64)
    S = np.asarray(sched.create_steps(student_nsteps + 1), np.float64)
    if not (T[-1] == 0.0 and np.all(np.diff(T) < 0)):
        raise NotImplementedError(
            "scheduler grid must be strictly decreasing and end at 0")
    # nesting: the student's ρ points are every second teacher point
    assert np.array_equal(T[:-1:2], S[:-1]), "grid family does not nest"
    n = student_nsteps
    a = np.concatenate([T[0:2 * n - 2:2], [T[2 * n - 2]]])
    m = np.concatenate([T[1:2 * n - 2:2], [0.0]])
    b = np.concatenate([T[2:2 * n - 1:2], [0.0]])
    return a.astype(np.float32), m.astype(np.float32), b.astype(np.float32)


def _denoiser_step(denoise_fn, x, s_from, s_to, heun: bool = True):
    """One deterministic pf-ODE step with per-row σ vectors [B]: Heun with
    the EDM endpoint rule applied per row (the sampler's HeunIntegrator
    and its endpoint split), or Euler. Rows with s_from = s_to pass
    unchanged (dt = 0). A σ = 0 row still goes through the denoiser, at
    σ = 1, so that c_noise = log σ stays finite (0·NaN would poison the
    row)."""
    safe_from = torch.where(s_from > 0, s_from, 1.0)
    d1 = (x - denoise_fn(x, safe_from)) / bcast_right(safe_from, x)
    dt = bcast_right(s_to - s_from, x)
    x_euler = x + dt * d1
    if not heun:
        return x_euler
    safe_to = torch.where(s_to > 0, s_to, 1.0)
    d2 = (x_euler - denoise_fn(x_euler, safe_to)) / bcast_right(safe_to, x)
    slope = torch.where(bcast_right(s_to, x) > 0, 0.5 * (d1 + d2), d1)
    return x + dt * slope


def _grid_tensors(model, student_nsteps: int, device) -> tuple:
    """(a, m, b, the loss weights ((a − b)/a)²) as float32 tensors on
    ``device``."""
    a, m, b = distill_interval_grid(model, student_nsteps)
    w = ((a - b) / a) ** 2
    return tuple(torch.as_tensor(v, device=device) for v in (a, m, b, w))


def _teacher_variables(teacher):
    """The teacher's tensors cast once to its compute dtype (in the step,
    so a captured graph casts the current weights), or None to run its
    network's own float32 tensors."""
    cd = teacher.compute_dtype
    if cd is None:
        return None
    tensors = dict(teacher.net.named_parameters())
    tensors.update(teacher.net.named_buffers())
    return {k: v.detach().to(cd) if v.is_floating_point() else v.detach()
            for k, v in tensors.items()}


def _targets(teacher, grid, x0, eps, interval_idx, y, guidance, heun):
    """``distill_targets`` on grid tensors made before (a capture makes no
    host-to-device copy)."""
    a, m, b = (g[interval_idx] for g in grid[:3])
    x_t = x0 + bcast_right(a, x0) * eps
    with torch.no_grad():
        variables = _teacher_variables(teacher)

        def teacher_denoise(xx, sig):
            return teacher.get_denoiser(xx, sig, y, guidance=guidance,
                                        train=False, variables=variables)[0]

        x_mid = _denoiser_step(teacher_denoise, x_t, a, m, heun=heun)
        X = _denoiser_step(teacher_denoise, x_mid, m, b, heun=heun)
    # exact inversion of the student's one-step Euler map a -> b
    D_tgt = x_t + (X - x_t) * bcast_right(a / (a - b), x_t)
    return x_t, a, D_tgt, X


def distill_targets(teacher, x0, eps, interval_idx, student_nsteps: int,
                    y=None, teacher_guidance: float = 1.0,
                    teacher_heun: bool = True):
    """The targets of a distill step, from the ``teacher`` (a
    ``KarrasModel`` holding the teacher's weights): x0 channels-last, ε of
    its shape, ``interval_idx`` [B] the student interval of each row.
    Returns ``(x_t, sigma, D_tgt, X)``: x0 noised at the interval's start
    σ = a, that σ [B], the exact-inversion target of the student's
    denoiser and the teacher's two-step result, without gradients.
    ``teacher_heun`` must be False when the teacher is itself a distilled
    student (module docstring)."""
    grid = _grid_tensors(teacher, student_nsteps, x0.device)
    return _targets(teacher, grid, x0, eps, interval_idx, y,
                    teacher_guidance, teacher_heun)


def _draw(model, x, generator, student_nsteps, idx, eps, out,
          rows: tuple = (1, 0)):
    """The interval index [B], then ε, each from ``generator`` unless
    replayed, then (when the network drops conditions and y is given) the
    keep mask [B] from ``generator``, into ``out``. ``rows`` = (n, i): x
    is block i of n of a global batch's rows; the draws (and the replayed
    ones) are the global batch's, and ``out`` takes block i. Returns
    ``out``."""
    n, i = rows
    if n > 1:
        whole = batch_like(x, n)
        every = tuple(None if t is None else t.new_empty(
            (t.shape[0] * n,) + tuple(t.shape[1:])) for t in out)
        _draw(model, whole, generator, student_nsteps, idx, eps, every)
        for t, g in zip(out, every):
            if t is not None:
                keep_rows(t, g, i)
        return out
    idx_out, eps_out, keep_out = out
    if idx is None:
        torch.randint(0, student_nsteps, idx_out.shape, generator=generator,
                      device=idx_out.device, out=idx_out)
    else:
        idx_out.copy_(idx)
    if eps is None:
        torch.randn(eps_out.shape, generator=generator, out=eps_out)
    else:
        eps_out.copy_(eps)
    if keep_out is not None:
        model.draw_cond_keep(x.shape[0], generator, out=keep_out)
    return out


def _draw_tensors(model, x, y) -> tuple:
    """Empty tensors for a distill step's draws over the batch x."""
    drops = model.conditional and y is not None \
        and model.cond_drop_rate is not None
    return (torch.empty(x.shape[0], dtype=torch.int64, device=x.device),
            torch.empty_like(x),
            torch.empty(x.shape[0], dtype=torch.bool, device=x.device)
            if drops else None)


def make_distill_step(model, tx: AdamWClip, student_nsteps: int, *,
                      teacher_model=None, ema: EMATracker | None = None,
                      teacher_guidance: float = 1.0,
                      teacher_heun: bool = True, nan_guard: bool = True,
                      has_mp_weights: bool = False, _raw: bool = False):
    """The progressive-distillation step ``step(state, teacher, x, y=None,
    generator=None, idx=None, eps=None) -> (state, metrics)``:
    per row, draw a student interval (``idx``) and ε, let ``teacher`` (a
    ``KarrasModel`` with the teacher's weights; None: ``teacher_model``)
    take its two sub-steps without gradients, and regress the student's
    denoiser (``model``, in training mode) onto the exact-inversion target
    under the trajectory-space weight; backward, the NaN → 0 guard
    (``nan_guard``), clip, AdamW, the mp re-projection
    (``has_mp_weights``), EMA. ``idx`` and ``eps`` replay the interval
    and noise draws (the cross-framework tests use them). ``metrics``:
    ``distill_loss`` and ``grad_norm`` (after the guard, before the clip),
    device tensors. ``state`` (a ``TrainState`` over ``model``) is updated
    in place and returned.

    ``teacher_guidance`` ≠ 1 distills classifier-free guidance into the
    student, which then samples with guidance 1 (Meng et al.,
    arXiv:2210.03142). ``teacher_model``: a model of another architecture
    or preconditioner to distill from; it must share the student's noise
    grid. ``teacher_heun``: False when the teacher is a distilled student.
    Over a mesh (a state placed by ``parallel.replicate`` and the others)
    x is this rank's rows, the draws are the global batch's of which it
    keeps its rows, and the gradients are the global batch's mean before
    the guard and clip, as ``make_train_step``'s; ``distill_loss`` is the
    mean over the ranks. A spatially sharded state raises.
    On a CUDA device the step is captured and replayed as a CUDA graph
    held by the state (module docstring; eager over gloo); ``_raw=True``
    returns the eager step."""
    _check_distillable(model, student_nsteps)
    if tx.every != 1:
        raise ValueError("the distill step takes one update a step")
    checked = set()

    def teacher_of(teacher):
        teacher = teacher if teacher is not None else teacher_model
        if teacher is None:
            raise ValueError("the distill step needs a teacher model")
        if teacher is model:
            raise ValueError("the teacher must be another KarrasModel than "
                             "the student (its weights are the teacher's)")
        if id(teacher) not in checked:
            k = max(2 * student_nsteps, 3)
            if not np.array_equal(
                    teacher.config.noisescheduler.create_steps(k),
                    model.config.noisescheduler.create_steps(k)):
                raise ValueError("teacher_model must share the student's "
                                 "noise scheduler grid")
            checked.add(id(teacher))
        return teacher

    grids: dict = {}

    def grid_on(device):
        if device not in grids:
            grids[device] = _grid_tensors(model, student_nsteps, device)
        return grids[device]

    def update(state: TrainState, teacher, x, y, idx, eps, keep):
        """Targets, loss, backward, guard, clip, AdamW and the mp
        re-projection from fixed draws: device work only, which the
        graphed step captures. Returns the loss and the gradients' global
        norm."""
        grid = grid_on(x.device)
        x_t, sigma, D_tgt, _ = _targets(teacher, grid, x, eps, idx, y,
                                        teacher_guidance, teacher_heun)
        for p in state.params.values():
            p.grad = None
        D_s, _ = model.get_denoiser(x_t, sigma, y, guidance=1.0, train=True,
                                    cond_keep=keep)
        w = bcast_right(grid[3][idx], x_t)
        loss = torch.mean(w * (D_s - D_tgt) ** 2)
        loss.backward()
        placed = state.placement
        norm = synced_norm(placed, state.params, nan_guard)
        tx.update(state, norm)
        if has_mp_weights:
            renormalize_mp_weights(model.net)
        loss = loss.detach()
        return (loss if placed is None else placed.mean_over_ranks(loss),
                norm)

    def raw_step(state: TrainState, teacher, x, y=None, generator=None,
                 idx=None, eps=None):
        teacher = teacher_of(teacher)
        check_placement(state, "make_distill_step")
        idx, eps, keep = _draw(model, x, generator, student_nsteps, idx,
                               eps, _draw_tensors(model, x, y), _rows(state))
        tx.set_learning_rate(state.optimizer, state.step)
        loss, norm = update(state, teacher, x, y, idx, eps, keep)
        if ema is not None and state.ema is not None:
            ema.update(state.ema, state.params)
        state.step += 1
        return state, {"distill_loss": loss, "grad_norm": norm}

    if _raw:
        return raw_step

    def step(state: TrainState, teacher, x, y=None, generator=None,
             idx=None, eps=None):
        if x.device.type != "cuda" or not _capturable(state):
            return raw_step(state, teacher, x, y, generator, idx, eps)
        teacher = teacher_of(teacher)
        check_placement(state, "make_distill_step")
        if state.graphs is None:
            state.graphs = graphs.GraphCache(x.device)
        cache = state.graphs
        tx.set_learning_rate(state.optimizer, state.step)
        key = ("distill", tuple(x.shape), x.dtype, graphs.condition_key(y),
               student_nsteps, teacher_heun, teacher_guidance, id(teacher),
               teacher.compute_dtype, state.optimizer, tx, nan_guard,
               has_mp_weights, state.placement)
        graph = cache.graphs.get(key)
        if graph is None:
            inputs = (torch.empty_like(x), graphs.static_like(y, x.device)) \
                + _draw_tensors(model, x, y)
        else:
            inputs = graph.inputs
        xs, ys = inputs[:2]
        xs.copy_(x)
        graphs.fill(ys, y)
        _draw(model, x, generator, student_nsteps, idx, eps, inputs[2:],
              _rows(state))
        if graph is None:
            def body():
                return update(state, teacher, *inputs)

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
        state.step += 1
        return state, {"distill_loss": loss, "grad_norm": norm}

    return step


def halving_schedule(start_nsteps: int, final_nsteps: int = 2):
    """Student steps per phase: N → (N + 1)//2 → ... down to
    ``final_nsteps`` (2 → 1 at the end). Each phase's teacher grid
    (2N − 1 steps) is the previous student's grid."""
    if final_nsteps < 1:
        raise ValueError("final_nsteps must be >= 1")
    out, n = [], start_nsteps
    while n >= final_nsteps:
        out.append(n)
        if n == final_nsteps:
            break
        n = max((n + 1) // 2 if n > 2 else 1, final_nsteps)
    return out


def _teacher_like(model):
    """A ``KarrasModel`` like ``model`` with its own copy of the network
    (the weights of a student-to-student phase's teacher)."""
    teacher = copy.copy(model)
    teacher.net = copy.deepcopy(model.net)
    teacher._reset_cast()
    teacher._latent_shapes = {}
    return teacher


def _load(model, variables) -> None:
    """Copy ``variables`` (a state dict, or parameters by name) into the
    model's own tensors."""
    with torch.no_grad():
        unexpected = model.net.load_state_dict(variables,
                                               strict=False).unexpected_keys
    if unexpected:
        raise KeyError(f"not tensors of the model: {unexpected}")
    model._masters_changed()


def distill_progressive(model, teacher_variables, data_iter: Iterable,
                        generator=None, *,
                        start_nsteps: int = 17,
                        final_nsteps: int = 2,
                        steps_per_phase: int = 500,
                        optimizer: AdamWClip | None = None,
                        learning_rate: float = 1e-4,
                        ema: EMATracker | None = None,
                        teacher_guidance: float = 1.0,
                        teacher_model=None,
                        initial_variables=None,
                        callback: Optional[Callable] = None):
    """The whole halving chain: the first student learns
    ``start_nsteps``-step sampling from the teacher's
    2·start_nsteps − 1-step trajectories, then becomes the teacher of the
    next halving, down to ``final_nsteps``. ``teacher_variables``: the
    trained model's state dict (EMA weights are best; None: ``model``'s
    current weights). Phase 0's teacher takes Heun sub-steps and
    ``teacher_guidance``; every later one is a distilled student and takes
    Euler sub-steps without guidance. Each phase starts a fresh optimizer
    (``optimizer``, else ``default_optimizer(learning_rate)``) and EMA,
    with the student's weights set to its teacher's; the next teacher is
    the phase's EMA weights (``ema``) or its parameters, copied in place
    into one teacher model, so the step's graph reads them.

    ``teacher_model``: a ``KarrasModel`` of another architecture to
    distill from in phase 0 only; then ``teacher_variables`` are its
    weights (None: its current ones) and the first student starts from
    ``initial_variables``.

    ``data_iter`` yields clean batches x or (x, y), channels-last on the
    model's device; draws come from ``generator``. Returns
    ``(variables, history)``: the last phase's state dict (also loaded
    into ``model.net``, so ``model.sample(nsteps=N,
    integrator="euler")``, or ``sample_onestep`` for N = 1, samples it)
    and per phase {"nsteps", "losses" (floats, read once a phase),
    "graphs" and "capture_seconds" (the step's CUDA graphs, 0 on the
    CPU)}. ``callback(nsteps, variables, losses)`` follows each phase."""
    schedule = halving_schedule(start_nsteps, final_nsteps)
    data_iter = iter(data_iter)
    history = []
    teacher = None
    for phase_i, nsteps in enumerate(schedule):
        cross = teacher_model is not None and phase_i == 0
        if cross:
            if initial_variables is None:
                raise ValueError(
                    "teacher_model (cross-architecture first phase) "
                    "needs initial_variables for the student")
            if teacher_variables is not None:
                _load(teacher_model, teacher_variables)
            phase_teacher = teacher_model
            _load(model, initial_variables)
        else:
            if teacher is None:
                teacher = _teacher_like(model)
            if teacher_variables is not None:
                _load(teacher, teacher_variables)
                _load(model, teacher_variables)
            phase_teacher = teacher
        tx = optimizer if optimizer is not None else default_optimizer(
            learning_rate=learning_rate)
        state = _new_train_state(model, tx, ema)
        step = make_distill_step(
            model, tx, nsteps, ema=ema,
            teacher_model=teacher_model if cross else None,
            teacher_guidance=teacher_guidance if phase_i == 0 else 1.0,
            teacher_heun=(phase_i == 0))
        losses = []
        for _ in range(steps_per_phase):
            batch = next(data_iter)
            x, y = batch if isinstance(batch, tuple) else (batch, None)
            state, metrics = step(state, phase_teacher, x, y, generator)
            losses.append(metrics["distill_loss"])
        variables = model.net.state_dict()
        if ema is not None:
            variables.update(state.ema_variables(ema))
        teacher_variables = {k: v.detach().clone()
                             for k, v in variables.items()}
        losses = torch.stack(losses).tolist() if losses else []
        cache = state.graphs
        history.append({
            "nsteps": nsteps, "losses": losses,
            "graphs": len(cache.graphs) if cache is not None else 0,
            "capture_seconds": sum(g.capture_seconds for g in
                                   cache.graphs.values())
            if cache is not None else 0.0})
        if callback is not None:
            callback(nsteps, teacher_variables, losses)
    _load(model, teacher_variables)
    return teacher_variables, history


def _onestep_body(model, nsamples: int):
    """D(σ_max·ε, σ_max) of ε ([nsamples, *shape]) and y."""
    smax = float(model.config.noisescheduler.maximum_scale)

    def body(eps, y):
        sigma = torch.full((nsamples,), smax, device=eps.device)
        return model.get_denoiser(smax * eps, sigma, y)[0]
    return body


@torch.inference_mode()
def compile_onestep(model, nsamples: int, shape, y=None):
    """The CUDA graph of ``sample_onestep`` for (nsamples, shape, y's
    shapes) in the model's graph cache: on its first use the call runs
    once eagerly on the capture stream (the warm-up) and is captured; it
    is never replayed here, so a service may capture while another
    thread replays its other graphs. Static inputs (``graph.inputs``): ε,
    None, None and y's tensors. None on the CPU, where nothing is
    captured."""
    _check_distillable(model, 1)
    if model.device.type != "cuda":
        return None
    cache = model._graph_cache()
    key = ("onestep", nsamples, tuple(shape), graphs.condition_key(y))
    graph = cache.graphs.get(key)
    if graph is not None:
        return graph
    body = _onestep_body(model, nsamples)
    eps = torch.zeros((nsamples,) + tuple(shape), device=model.device)
    ys = graphs.static_like(y, model.device)
    graphs.fill(ys, y)
    cache.warmup(lambda: body(eps, ys))
    graph = cache.capture(key, lambda: body(eps, ys))
    graph.inputs = (eps, None, None, ys)
    return graph


@torch.inference_mode()
def sample_onestep(model, nsamples: int, shape, generator=None, y=None,
                   mesh=None):
    """1-NFE generation: ε drawn from ``generator`` (or one generator a
    row, as the service's dispatcher passes them), then
    D(σ_max·ε, σ_max): one network call and one combine (K1). On a CUDA
    device the call replays ``compile_onestep``'s graph, ε its static
    input; on the CPU it runs eagerly. Returns the samples,
    channels-last, not decoded (as the JAX package). ``mesh``:
    data-parallel, as ``KarrasModel.sample(mesh=...)``: the whole
    batch's ε drawn on every rank, its rows denoised, the rows
    all-gathered in rank order."""
    if mesh is not None:
        from diffsci_tpu_torch.parallel.mesh import (data_rows, gather_batch,
                                                     rows_of)
        rows = data_rows(mesh, nsamples)
        eps = torch.zeros((nsamples,) + tuple(shape), device=model.device)
        model._draw_inputs((eps, None, None), generator, None)
        eps, y = eps[rows], rows_of(y, rows, nsamples)
        graph = compile_onestep(model, eps.shape[0], shape, y)
        if graph is None:
            out = _onestep_body(model, eps.shape[0])(eps, y)
        else:
            graph.inputs[0].copy_(eps)
            graphs.fill(graph.inputs[3], y)
            graph.replay()
            out = graph.outputs.clone()
        return gather_batch(out, mesh)
    graph = compile_onestep(model, nsamples, shape, y)
    if graph is None:
        eps = torch.zeros((nsamples,) + tuple(shape), device=model.device)
        model._draw_inputs((eps, None, None), generator, None)
        return _onestep_body(model, nsamples)(eps, y)
    model._draw_inputs(graph.inputs[:3], generator, None)
    graphs.fill(graph.inputs[3], y)
    graph.replay()
    return graph.outputs.clone()
