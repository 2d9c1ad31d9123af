"""Schedulers: time grids and forward/backward ODE-SDE propagation.

Port of ``diffsci_tpu/ops/schedulers.py``: the Langevin knobs,
``make_rhs`` (probability flow and SDE, constant and scaled schedules),
the step engine ``_run_steps``, ``propagate`` backward, forward and
partial, restart sampling, inpaint and RePaint, ``renoise``,
``apply_noise``, the parallel-in-time (Picard) sampler
(``propagate_backward_parallel``, over ``ops/parallel_sampling.py``) and
the EDM, VP and VE schedulers. Grids are built on the host in numpy (float64); each step's
t, dt, Langevin gate and integrator extras are cast to float32 as the JAX
package's ``pack()`` does. The scan becomes a Python loop over the grid;
the Heun endpoint step (the grid landing exactly on t = 0) is split off
statically, as in the JAX package.

Randomness is drawn before a loop runs, with ``draw_noise``: one
``[n, *x.shape]`` tensor for the n steps that inject noise (or the n
re-noise jumps of restart and RePaint), from the caller's
``torch.Generator``; step i reads row i. ``noise_seq=`` (and
``renoise_noises=``, ``eps=``, ``noise=``) replace the draw with given
numbers. A draw inside a CUDA graph's capture raises: a graphed caller
draws into the graph's static inputs before each replay.

Conventions, as the JAX package's (deliberate deviations from the torch
reference): forward history row 0 is the clean state; ``y_noised[k]`` of
``inpaint``/``repaint`` is the known image at backward grid time ``t[k]``
(k = 0 the noisiest, k = nsteps the clean original), so the last splice
uses the clean original.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from diffsci_tpu_torch.ops import integrators as integrators_lib
from diffsci_tpu_torch.ops import scheduling as scheduling_lib
from diffsci_tpu_torch.ops.integrators import f32, host

ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x, sigma[B])


def draw_noise(generator, n: int, like: torch.Tensor) -> torch.Tensor:
    """``n`` unit normal draws of ``like``'s shape, dtype and device,
    [n, *like.shape], from ``generator``. Raises inside a CUDA graph's
    capture, which must not draw."""
    if like.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a stochastic loop cannot draw its noise inside a CUDA graph "
            "capture: draw it before the capture and pass it in "
            "(noise_seq)")
    return torch.randn((n,) + tuple(like.shape), generator=generator,
                       dtype=like.dtype, device=like.device)


def draw_rows(generators, x: torch.Tensor,
              noise: torch.Tensor | None = None) -> None:
    """Fill a sampler's draws row by row: row i of x ([B, *shape]) and of
    the loop's noise ([n, B, *shape], or None) come from
    ``generators[i]`` alone, in one call of [1 + n, *shape] (x_T first,
    then the loop's n rows), so that a row depends on its own generator
    only, whatever it is batched with. Rows past the generators are
    zero."""
    n = 0 if noise is None else noise.shape[0]
    rows = torch.zeros((x.shape[0], 1 + n) + tuple(x.shape[1:]),
                       dtype=x.dtype, device=x.device)
    for i, generator in enumerate(generators):
        torch.randn(rows.shape[1:], generator=generator, out=rows[i])
    x.copy_(rows[:, 0])
    if noise is not None:
        noise.copy_(rows[:, 1:].transpose(0, 1))


def _round_to_step(step):
    if torch.is_tensor(step):
        return torch.round(step).to(torch.int32)
    return np.round(step).astype(np.int32)


class Scheduler:
    """Owns the scheduling functions, the integrators, the initial noise
    scale and the Langevin knobs."""

    def __init__(self, scheduling: scheduling_lib.SchedulingFunctions,
                 integrator: integrators_lib.Integrator,
                 maximum_scale: float,
                 stochastic_integrator: integrators_lib.Integrator
                 | None = None,
                 langevin_const: float = 1.0,
                 langevin_interval: tuple[float, float] | None = None):
        self.scheduling = scheduling
        self.integrator = integrator
        self.maximum_scale = float(maximum_scale)
        if stochastic_integrator is None:
            stochastic_integrator = integrators_lib.EulerMaruyamaIntegrator()
        elif not stochastic_integrator.stochastic:
            raise ValueError("stochastic_integrator must be stochastic")
        self.stochastic_integrator = stochastic_integrator
        self.langevin_const = langevin_const
        self.langevin_interval = langevin_interval

    def graph_key(self) -> tuple:
        """What a sampler's CUDA graph bakes in of this scheduler: its type
        and every field (the scheduling functions, the integrators, the
        maximum scale, the Langevin constant and interval, the grid's
        parameters). Equal schedulers give equal keys, so a new object
        equal to the old one reuses a graph, and one with another
        ``langevin_const`` does not."""
        return (type(self),) + tuple(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in sorted(vars(self).items()))

    # -- grids (host-side, static) --------------------------------------
    def create_steps(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def _langevin_gate(self, t: np.ndarray) -> np.ndarray:
        """The per-step Langevin on/off gate."""
        if self.langevin_interval is None:
            return np.ones_like(t)
        lo, hi = self.langevin_interval
        return ((t > lo) & (t < hi)).astype(t.dtype)

    # -- per-step math --------------------------------------------------
    def langevin_factor(self, t, gate=1.0):
        """γ(t): a multiple of Song's Langevin factor s² σ' σ. ``gate`` is
        a number or, under ``langevin_scale``, a 0-d device tensor, which
        stays one (a graph reads its value at each replay)."""
        sf = self.scheduling
        standard = sf.scale(t) ** 2 * sf.noise_deriv(t) * sf.noise(t)
        if torch.is_tensor(gate) and torch.is_tensor(standard) and \
                gate.device != standard.device:
            standard = float(standard)
        return gate * self.langevin_const * standard

    def noise_injection(self, t, gate=1.0):
        """g(t) = sqrt(2 γ(t))."""
        return scheduling_lib._sqrt(2.0 * self.langevin_factor(t, gate))

    def make_rhs(self, score_fn: ScoreFn, backward: bool = True,
                 stochastic: bool = False):
        """Probability-flow / SDE right-hand side ``rhs(x, t, gate=1.0)``;
        t is a 0-d float32 CPU tensor, ``score_fn`` receives σ broadcast to
        the batch."""
        sf = self.scheduling

        def rhs(x, t, gate=1.0):
            sigma = sf.noise(t)
            sigma_b = torch.full((x.shape[0],), float(sigma), dtype=x.dtype,
                                 device=x.device)
            if sf.constant_scaling:
                if sf.has_pf_score_multiplier:
                    mult = sf.pf_score_multiplier(t)
                else:
                    mult = sigma * sf.noise_deriv(t)
                score = score_fn(x, sigma_b)
                res = -host(mult) * score
                if stochastic:
                    sfac = -host(self.langevin_factor(t, gate)) * score
                    res = res + (sfac if backward else -sfac)
            else:
                s = sf.scale(t)
                if sf.has_pf_scale_multiplier:
                    scale_mult = sf.pf_scale_multiplier(t)
                else:
                    scale_mult = sf.scale_deriv(t) / s
                if sf.has_pf_score_multiplier:
                    mult = sf.pf_score_multiplier(t)
                else:
                    mult = s * sf.noise_deriv(t) * sf.noise(t)
                score = score_fn(x / host(s), sigma_b)
                res = host(scale_mult) * x - host(mult) * score
                if stochastic:
                    sfac = -host(self.langevin_factor(t, gate) / host(s)) \
                        * score
                    res = res + (sfac if backward else -sfac)
            return res

        return rhs

    # -- the step engine -------------------------------------------------
    def _run_steps(self, x, integrator, rhs, t_steps: np.ndarray,
                   dt_steps: np.ndarray, nsteps_total: int,
                   record_history: bool, splice=None, noise_seq=None,
                   gate_scale=None):
        """Run len(dt_steps) integrator steps, splitting off a final
        endpoint step when the integrator evaluates rhs at t + dt and the
        grid lands exactly on zero.

        ``splice(x, i)`` post-processes the state after step i (inpaint).
        ``noise_seq`` ([len(dt_steps), *x.shape]): the noise a stochastic
        integrator reads, row i at step i. ``gate_scale``: a 0-d tensor
        multiplied into the per-step Langevin gate, read at run time, so a
        γ sweep replays one graph (``langevin_const=1`` and
        ``gate_scale=γ`` equal ``langevin_const=γ``)."""
        nsteps = len(dt_steps)
        if nsteps == 0:
            return x[None] if record_history else x
        if integrator.draws_noise and noise_seq is None:
            raise ValueError(f"{type(integrator).__name__} needs its noise "
                             "(noise_seq)")
        t_end = float(t_steps[-1] + dt_steps[-1])
        split_endpoint = integrator.evaluates_endpoint and t_end == 0.0
        extras_np = integrator.scan_extras(t_steps, dt_steps, nsteps_total)
        gate_np = self._langevin_gate(t_steps).astype(np.float32)
        t32 = torch.from_numpy(t_steps.astype(np.float32))
        dt32 = torch.from_numpy(dt_steps.astype(np.float32))
        history = [x] if record_history else None
        carry = integrator.init_carry(x) if integrator.has_carry else None
        for i in range(nsteps):
            gate = f32(gate_np[i])
            if gate_scale is not None:
                gate = gate_scale * float(gate)
            extras = {"gate": gate}
            for name, values in extras_np.items():
                extras[name] = f32(values[i])
            if noise_seq is not None:
                extras["noise"] = noise_seq[i]
            endpoint = split_endpoint and i == nsteps - 1
            if carry is None:
                x = integrator.step(x, t32[i], dt32[i], rhs,
                                    self.noise_injection, extras,
                                    endpoint=endpoint)
            else:
                x, carry = integrator.step_carry(
                    x, carry, t32[i], dt32[i], rhs, self.noise_injection,
                    extras, endpoint=endpoint)
            if splice is not None:
                x = splice(x, i)
            if record_history:
                history.append(x)
        if record_history:
            return torch.stack(history, dim=0)
        return x

    def _noise_for(self, integrator, n: int, x, noise_seq, generator):
        """The noise of an ``n``-step run: None for an integrator that
        injects none, else ``noise_seq`` as x's dtype and device, or a new
        draw."""
        if not integrator.draws_noise:
            return None
        if noise_seq is None:
            return draw_noise(generator, n, x)
        return torch.as_tensor(noise_seq, dtype=x.dtype, device=x.device)

    def noise_steps(self, nsteps: int, stochastic: bool = False,
                    integrator=None, backward: bool = True) -> int:
        """The number of noise rows ``propagate`` draws for these
        arguments (0 for a deterministic integrator)."""
        integrator = self._resolve_integrator(integrator, stochastic)
        if not integrator.draws_noise:
            return 0
        return nsteps if backward else nsteps - 1

    # -- propagation ----------------------------------------------------
    def propagate(self, x, score_fn: ScoreFn, nsteps: int = 100,
                  record_history: bool = False, backward: bool = True,
                  stochastic: bool = False,
                  integrator: integrators_lib.Integrator | str | None = None,
                  noise_seq=None, gate_scale=None, generator=None):
        integrator = self._resolve_integrator(integrator, stochastic)
        t = self.create_steps(nsteps + 1)
        skip = 0
        if not backward:
            t = t[::-1]
            skip = 1
        dt = np.diff(t)
        rhs = self.make_rhs(score_fn, backward=backward,
                            stochastic=integrator.stochastic)
        noise_seq = self._noise_for(integrator, nsteps - skip, x, noise_seq,
                                    generator)
        out = self._run_steps(x, integrator, rhs, t[skip:nsteps],
                              dt[skip:nsteps], nsteps, record_history,
                              noise_seq=noise_seq, gate_scale=gate_scale)
        if record_history and not backward:
            # forward history: index 0 is the clean original
            out = torch.cat([x[None], out], dim=0)
        return out

    def propagate_backward(self, x, score_fn: ScoreFn, nsteps: int = 100,
                           record_history: bool = False,
                           stochastic: bool = False, integrator=None,
                           noise_seq=None, gate_scale=None, generator=None):
        return self.propagate(x, score_fn, nsteps, record_history,
                              backward=True, stochastic=stochastic,
                              integrator=integrator, noise_seq=noise_seq,
                              gate_scale=gate_scale, generator=generator)

    def propagate_backward_parallel(self, x, score_fn: ScoreFn,
                                    nsteps: int = 18,
                                    iters: int | None = None,
                                    tol: float | None = None):
        """Parallel-in-time (Picard) deterministic sampling over the whole
        trajectory: one network call of batch nsteps·B a sweep;
        ``iters`` = nsteps reproduces sequential Euler
        (``ops/parallel_sampling.py``)."""
        from diffsci_tpu_torch.ops.parallel_sampling import \
            picard_propagate_backward
        return picard_propagate_backward(self, x, score_fn, nsteps,
                                         iters=iters, tol=tol)

    def propagate_forward(self, x, score_fn: ScoreFn, nsteps: int = 100,
                          record_history: bool = False,
                          stochastic: bool = False, integrator=None,
                          noise_seq=None, generator=None):
        return self.propagate(x, score_fn, nsteps, record_history,
                              backward=False, stochastic=stochastic,
                              integrator=integrator, noise_seq=noise_seq,
                              generator=generator)

    def propagate_partial(self, x, score_fn: ScoreFn, nsteps: int = 100,
                          initial_step: int = 0, final_step: int = 100,
                          record_history: bool = False,
                          stochastic: bool = False, integrator=None,
                          noise_seq=None, generator=None):
        """Backward propagation over grid steps [initial_step,
        final_step)."""
        integrator = self._resolve_integrator(integrator, stochastic)
        t = self.create_steps(nsteps + 1)
        dt = np.diff(t)
        rhs = self.make_rhs(score_fn, backward=True,
                            stochastic=integrator.stochastic)
        t_run = t[initial_step:final_step]
        noise_seq = self._noise_for(integrator, len(t_run), x, noise_seq,
                                    generator)
        return self._run_steps(x, integrator, rhs, t_run,
                               dt[initial_step:final_step], nsteps,
                               record_history, noise_seq=noise_seq)

    # -- restart sampling -------------------------------------------------
    @staticmethod
    def restart_jumps(restarts) -> int:
        """The number of re-noise jumps (and draws) of ``restarts``."""
        return sum(int(k) for _, _, k in restarts)

    def restart_propagate_backward(self, x, score_fn: ScoreFn,
                                   nsteps: int = 18,
                                   restarts=((0.05, 2.0, 2),),
                                   integrator=None, generator=None):
        """Restart sampling (Xu et al., NeurIPS 2023, arXiv:2306.14878):
        deterministic ODE segments separated by forward-noise jumps. Each
        interval ``(sigma_lo, sigma_hi, K)`` is snapped to the σ grid; on
        reaching sigma_lo the state is re-noised up to sigma_hi through
        x_hi = (s_hi/s_lo) x_lo + s_hi sqrt(σ_hi² - σ_lo²) n and integrated
        down again, K times. Network calls: nsteps' plus K times each
        interval's width. The jumps' noise is drawn before the first
        segment, one row a jump."""
        noises = draw_noise(generator, self.restart_jumps(restarts), x)
        return self._restart(x, score_fn, nsteps, restarts, integrator,
                             noises)

    def _restart(self, x, score_fn, nsteps, restarts, integrator, noises):
        """``restart_propagate_backward`` with its jumps' noise given
        ([sum K, *x.shape]): the body a CUDA graph captures."""
        integrator = self._resolve_integrator(integrator, stochastic=False)
        t = self.create_steps(nsteps + 1)
        sf = self.scheduling
        sigma = np.asarray(sf.noise(t[:-1]), np.float64)
        s_all = (np.ones_like(sigma) if sf.constant_scaling
                 else np.asarray(sf.scale(t[:-1]), np.float64))

        def snap(sig):
            return int(np.argmin(np.abs(sigma - sig)))

        ivals = []
        for lo, hi, k in restarts:
            if hi <= lo:
                raise ValueError("restart interval needs sigma_hi > "
                                 "sigma_lo")
            i_hi, i_lo = snap(hi), snap(lo)
            if not i_hi < i_lo:
                raise ValueError(
                    f"restart interval ({lo}, {hi}) collapses on the "
                    f"{nsteps}-step grid; widen it or raise nsteps")
            ivals.append((i_hi, i_lo, int(k)))
        ivals.sort(key=lambda iv: iv[0])
        for (_, b, _), (a2, _, _) in zip(ivals, ivals[1:]):
            if a2 < b:
                raise ValueError("restart intervals must not overlap")

        def segment(x, i0, i1):
            if i1 <= i0:
                return x
            return self.propagate_partial(x, score_fn, nsteps,
                                          initial_step=i0, final_step=i1,
                                          integrator=integrator)

        pos, jump = 0, 0
        for i_hi, i_lo, k in ivals:
            x = segment(x, pos, i_lo)
            ratio = float(s_all[i_hi] / s_all[i_lo])
            amp = float(s_all[i_hi]
                        * np.sqrt(sigma[i_hi] ** 2 - sigma[i_lo] ** 2))
            for _ in range(k):
                x = ratio * x + amp * noises[jump]
                jump += 1
                x = segment(x, i_hi, i_lo)
            pos = i_lo
        return segment(x, pos, nsteps)

    # -- inpainting -------------------------------------------------------
    def inpaint(self, x, y_noised, mask, score_fn: ScoreFn,
                nsteps: int = 100, record_history: bool = False,
                integrator=None, generator=None):
        """Backward propagation splicing the known region (mask == 1) after
        every step; ``y_noised[k]`` is the known image at grid time t[k]."""
        integrator = self._resolve_integrator(integrator, stochastic=False)
        t = self.create_steps(nsteps + 1)
        dt = np.diff(t)
        rhs = self.make_rhs(score_fn, backward=True, stochastic=False)
        x = x * (1 - mask) + y_noised[0] * mask
        y_targets = y_noised[1:]  # after step i we are at t[i + 1]

        def splice(xn, i):
            return xn * (1 - mask) + y_targets[i] * mask

        noise_seq = self._noise_for(integrator, nsteps, x, None, generator)
        return self._run_steps(x, integrator, rhs, t[:nsteps], dt[:nsteps],
                               nsteps, record_history, splice=splice,
                               noise_seq=noise_seq)

    def repaint(self, x, y_noised, mask, score_fn: ScoreFn,
                nsteps: int = 100, rsteps: int = 10, nresamples: int = 10,
                record_history: bool = False, integrator=None,
                renoise_noises=None, generator=None):
        """RePaint resampling: propagate in chunks of ``rsteps``; at each
        chunk boundary, ``nresamples`` times splice the known region,
        re-noise back to the chunk start and propagate again.
        ``renoise_noises`` ([nresamples·(nsteps/rsteps - 1), *x.shape]):
        the re-noise draws in call order, else drawn before the loop."""
        if nsteps % rsteps != 0:
            raise ValueError("rsteps should divide nsteps")
        t = self.create_steps(nsteps + 1)
        if renoise_noises is None:
            renoise_noises = draw_noise(
                generator, nresamples * (nsteps // rsteps - 1), x)
        history = []

        x = x * (1 - mask) + y_noised[0] * mask
        if record_history:
            history.append(x)

        x = self.propagate_partial(x, score_fn, nsteps, 0, rsteps,
                                   integrator=integrator, generator=generator)
        step, fstep = rsteps, 2 * rsteps
        n_renoise = 0
        while fstep <= nsteps:
            x = self.propagate_partial(x, score_fn, nsteps, step, fstep,
                                       integrator=integrator,
                                       generator=generator)
            for _ in range(nresamples):
                x = x * (1 - mask) + y_noised[fstep] * mask
                if record_history:
                    history.append(x)
                x = self.renoise(x, float(t[fstep]), float(t[step]),
                                 noise=renoise_noises[n_renoise])
                n_renoise += 1
                x = self.propagate_partial(x, score_fn, nsteps, step, fstep,
                                           integrator=integrator,
                                           generator=generator)
            step, fstep = fstep, fstep + rsteps
        if step != nsteps:
            raise ValueError("wrong counting")
        if record_history:
            history.append(x)
            return torch.stack(history, dim=0)
        return x

    def renoise(self, x, t: float, t_noise: float, noise=None,
                generator=None):
        """Noise a state at time t back up to time t_noise. ``noise``
        replays a fixed draw."""
        sf = self.scheduling
        sigma = sf.noise(f32(t))
        sigma_noise = sf.noise(f32(t_noise))
        scale = sf.scale(f32(t))
        scale_noise = sf.scale(f32(t_noise))
        std = scale_noise * torch.sqrt(
            torch.clamp(sigma_noise ** 2 - sigma ** 2, min=0.0))
        if noise is None:
            noise = draw_noise(generator, 1, x)[0]
        return host(scale_noise / scale) * x + host(std) * noise

    def apply_noise(self, x, nsteps: int = 100, step: int = 0, eps=None,
                    generator=None):
        """Noise clean data to grid time t[step]. ``eps`` replays a fixed
        draw."""
        if step > nsteps:
            raise ValueError(f"step larger than num of steps: {step}>{nsteps}")
        t_step = f32(float(self.create_steps(nsteps + 1)[step]))
        sf = self.scheduling
        sigma = sf.noise(t_step)
        scale = sf.scale(t_step)
        if eps is None:
            noise = draw_noise(generator, 1, x)[0]
        else:
            noise = torch.as_tensor(eps, dtype=x.dtype, device=x.device)
        return host(scale) * x + host(scale * sigma) * noise

    def _resolve_integrator(self, integrator, stochastic: bool):
        if integrator is None:
            return self.stochastic_integrator if stochastic else \
                self.integrator
        if isinstance(integrator, str):
            return integrators_lib.name_to_integrator(
                integrator, scheduling=self.scheduling)
        return integrator


class EDMScheduler(Scheduler):
    """Karras ρ-grid scheduler with the Heun integrator; ``kwargs`` go to
    ``Scheduler`` (``langevin_const``, ``langevin_interval``,
    ``stochastic_integrator``)."""

    def __init__(self, sigma_min: float = 0.002, sigma_max: float = 80.0,
                 exponent_steps: float = 7.0,
                 scheduling: str | scheduling_lib.SchedulingFunctions = "EDM",
                 **kwargs):
        if isinstance(scheduling, str):
            scheduling = scheduling_lib.name_to_scheduling_functions(
                scheduling)
        super().__init__(scheduling, integrators_lib.HeunIntegrator(),
                         maximum_scale=sigma_max, **kwargs)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.exponent_steps = float(exponent_steps)

    def create_steps(self, n: int) -> np.ndarray:
        if n < 3:
            raise ValueError(
                f"EDM sigma grid needs at least 2 sampling steps (got "
                f"n={n} grid points); the Karras rho-spacing formula "
                f"divides by n-2")
        rho = self.exponent_steps
        s = np.arange(n - 1, dtype=np.float64) / (n - 2)
        start = self.sigma_max ** (1 / rho)
        end = self.sigma_min ** (1 / rho)
        steps = (start + s * (end - start)) ** rho
        if not self.scheduling.identity_noise:
            steps = np.asarray(self.scheduling.inverse_noise(steps))
        return np.concatenate([steps, np.zeros(1)])

    def step_from_time(self, t, n: int):
        exp = 1.0 / self.exponent_steps
        step = (n - 1) * (t ** exp - self.sigma_max ** exp) / (
            self.sigma_min ** exp - self.sigma_max ** exp)
        return _round_to_step(step)


class VPScheduler(Scheduler):
    """Uniform grid in t from 1 down to ``epsilon_min``; ``sched_kwargs``
    go to the scheduling functions (``beta_data``, ``beta_min``)."""

    def __init__(self, epsilon_min: float = 0.001,
                 scheduling: str | scheduling_lib.SchedulingFunctions = "VP",
                 **sched_kwargs):
        if isinstance(scheduling, str):
            scheduling = scheduling_lib.name_to_scheduling_functions(
                scheduling, **sched_kwargs)
        # float32, as the JAX package (and the reference) evaluate it
        one = torch.ones(1)
        sigma_max = float(scheduling.noise(one) * scheduling.scale(one))
        super().__init__(scheduling, integrators_lib.HeunIntegrator(),
                         maximum_scale=sigma_max)
        self.epsilon_min = float(epsilon_min)

    def create_steps(self, n: int) -> np.ndarray:
        s = np.arange(n, dtype=np.float64) / (n - 1)
        return 1.0 + s * (self.epsilon_min - 1.0)

    def step_from_time(self, t, n: int):
        step = (n - 1) * (t - 1.0) / (self.epsilon_min - 1.0)
        return _round_to_step(step)


class VEScheduler(Scheduler):
    """Geometric grid in t = σ² from σ_max² down to σ_min²."""

    def __init__(self, sigma_min: float = 0.02, sigma_max: float = 100.0,
                 scheduling: str | scheduling_lib.SchedulingFunctions = "VE",
                 **sched_kwargs):
        if isinstance(scheduling, str):
            scheduling = scheduling_lib.name_to_scheduling_functions(
                scheduling, **sched_kwargs)
        super().__init__(scheduling, integrators_lib.HeunIntegrator(),
                         maximum_scale=sigma_max)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)

    def create_steps(self, n: int) -> np.ndarray:
        s = np.arange(n, dtype=np.float64) / (n - 1)
        return self.sigma_max ** 2 * (self.sigma_min ** 2 /
                                      self.sigma_max ** 2) ** s

    def step_from_time(self, t, n: int):
        log = torch.log if torch.is_tensor(t) else np.log
        step = (n - 1) * (log(t) - np.log(self.sigma_max ** 2)) / (
            np.log(self.sigma_min ** 2) - np.log(self.sigma_max ** 2))
        return _round_to_step(step)
