"""Parallel-in-time sampling: Picard iteration over the probability-flow
trajectory (ParaDiGMS, Shih et al., arXiv:2305.16317).

Port of ``diffsci_tpu/ops/parallel_sampling.py``: ``_per_step_coefficients``,
``picard_propagate_backward`` (the whole trajectory a sweep) and
``picard_window_sample`` (a window of W steps ahead of the converged
frontier a sweep, one network call of batch W·B). The per-step
coefficients are computed on the host in numpy float32, as the JAX
package computes them at trace time.

The JAX window loop is a ``lax.while_loop`` whose frontier ``p`` is data.
Here its state lives in device tensors (``PicardWindow``): the trajectory
X[0..S] plus W scratch rows, the frontier ``p`` and the sweep count. One
sweep (``PicardWindow.sweep``) is device work only: it gathers the window
by index tensors built from the device ``p``, calls the network once,
takes the cumulative sum, the error and the advance, and moves ``p``, so
a CUDA graph can capture it (``KarrasModel.sample_parallel``). The host
repeats sweeps and reads ``p`` after each (4 bytes). A sweep is a
no-op once ``p`` reached S or the sweep count reached the JAX loop's
safety cap 4·S, so a sweep past the end changes nothing.

The coefficients are padded by W past the end, as in the JAX package:
dt = 0 freezes the points past the end and σ repeats its last value, so
the network never sees σ = 0 and the window never reads out of bounds.
"""

from __future__ import annotations

import numpy as np
import torch

from diffsci_tpu_torch.ops.schedulers import draw_noise


def _per_step_coefficients(scheduler, t_steps: np.ndarray):
    """Host-side per-step scalars of the pf-ODE drift
    f(x, t) = scale_mult(t)·x − mult(t)·score(x / s(t), σ(t)) (the
    deterministic arm of ``Scheduler.make_rhs``), float32 arrays."""
    sf = scheduler.scheduling
    sigma = np.asarray(sf.noise(t_steps), np.float32)
    if sf.constant_scaling:
        s = np.ones_like(sigma)
        scale_mult = np.zeros_like(sigma)
        if sf.has_pf_score_multiplier:
            mult = np.asarray(sf.pf_score_multiplier(t_steps), np.float32)
        else:
            mult = np.asarray(sigma * sf.noise_deriv(t_steps), np.float32)
    else:
        s = np.asarray(sf.scale(t_steps), np.float32)
        if sf.has_pf_scale_multiplier:
            scale_mult = np.asarray(sf.pf_scale_multiplier(t_steps),
                                    np.float32)
        else:
            scale_mult = np.asarray(sf.scale_deriv(t_steps) / s, np.float32)
        if sf.has_pf_score_multiplier:
            mult = np.asarray(sf.pf_score_multiplier(t_steps), np.float32)
        else:
            mult = np.asarray(s * sf.noise_deriv(t_steps) * sigma,
                              np.float32)
    return sigma, s, scale_mult, mult


def _grid(scheduler, nsteps: int):
    t_grid = np.asarray(scheduler.create_steps(nsteps + 1), np.float32)
    return t_grid[:nsteps], np.diff(t_grid)[:nsteps]


def picard_propagate_backward(scheduler, x, score_fn, nsteps: int = 18,
                              iters: int | None = None,
                              tol: float | None = None):
    """Backward pf-ODE propagation by Picard iteration over the whole
    trajectory: each sweep evaluates the drift at all ``nsteps`` points in
    one network call of batch nsteps·B; ``iters`` = nsteps sweeps (the
    default) reproduce sequential Euler. ``tol``: stop early once the
    largest update of a sweep is at most ``tol`` (read on the host after
    each sweep). Returns the final state."""
    iters = int(min(nsteps if iters is None else iters, nsteps))
    tt, dt = _grid(scheduler, nsteps)
    sigma, s, scale_mult, mult = _per_step_coefficients(scheduler, tt)
    B, S = x.shape[0], nsteps
    lead = (S, 1) + (1,) * (x.ndim - 1)

    def coef(a):
        return torch.as_tensor(a, dtype=x.dtype, device=x.device).reshape(
            lead)

    sig_flat = torch.as_tensor(sigma, dtype=x.dtype, device=x.device
                               ).repeat_interleave(B)
    s_b, scale_b, mult_b, dt_b = map(coef, (s, scale_mult, mult, dt))

    def sweep(X):
        flat = (X / s_b).reshape((S * B,) + tuple(x.shape[1:]))
        F = scale_b * X - mult_b * score_fn(flat, sig_flat).reshape(X.shape)
        prefix = torch.cumsum(dt_b * F, dim=0)
        return (torch.cat([X[:1], x[None] + prefix[:-1]], dim=0),
                x + prefix[-1])

    X = x[None].expand((S,) + tuple(x.shape)).clone()
    out = x
    for _ in range(iters):
        X_new, out = sweep(X)
        if tol is not None and float((X_new - X).abs().max()) <= tol:
            break
        X = X_new
    return out


class PicardWindow:
    """The device state and the sweep of sliding-window Picard sampling for
    a batch of shape ``x_shape``: the trajectory ``X`` [S + 1 + W, B, ...]
    (S points after x_T, then W scratch rows that a window overhanging the
    end writes), the frontier ``p`` and ``sweeps`` (0-d int64), and the
    padded per-step coefficients; with ``stochastic``, the injected noise
    g(t_i)·ε_i·sqrt|dt_i| of each step, which ``reset`` fills."""

    def __init__(self, scheduler, x_shape, nsteps: int = 18,
                 window: int = 8, tol: float = 1e-3,
                 stochastic: bool = False, gate: float = 1.0,
                 device=None, dtype=torch.float32):
        S = self.nsteps = int(nsteps)
        W = self.window = int(min(window, S))
        self.tol = float(tol)
        self.stochastic = stochastic
        tt, dt = _grid(scheduler, S)
        sigma, s, scale_mult, mult = _per_step_coefficients(scheduler, tt)
        if stochastic:
            lf = np.asarray(scheduler.langevin_factor(tt, gate), np.float32)
            # the backward SDE's drift: −(mult + lf/s)·score
            mult = mult + lf / s
            self._g = torch.as_tensor(np.sqrt(2.0 * lf) * np.sqrt(np.abs(dt)),
                                      dtype=dtype, device=device)
        pad = np.zeros(W, np.float32)

        def padded(a, fill=None):
            tail = pad if fill is None else np.full(W, fill, np.float32)
            return torch.as_tensor(np.concatenate([a, tail]), dtype=dtype,
                                   device=device)

        self.sigma = padded(sigma, sigma[-1])
        self.s = padded(s, s[-1])
        self.scale_mult = padded(scale_mult)
        self.mult = padded(mult)
        self.dt = padded(dt)
        self.X = torch.zeros((S + 1 + W,) + tuple(x_shape), dtype=dtype,
                             device=device)
        self.noise = torch.zeros((S + W,) + tuple(x_shape), dtype=dtype,
                                 device=device) if stochastic else None
        self.p = torch.zeros((), dtype=torch.int64, device=device)
        self.sweeps = torch.zeros((), dtype=torch.int64, device=device)
        self._offsets = torch.arange(W, device=device)
        self._first = torch.ones(1, dtype=torch.bool, device=device)

    def reset(self, x, noise_seq=None) -> None:
        """Start from x (at σ_max, already scaled): every trajectory point
        set to x, p and the sweep count to 0, and under ``stochastic`` the
        steps' injected noise from ``noise_seq`` ([S, *x.shape])."""
        self.X.copy_(x[None].expand_as(self.X))
        self.p.zero_()
        self.sweeps.zero_()
        if self.stochastic:
            S = self.nsteps
            lead = (S,) + (1,) * x.ndim
            self.noise[:S].copy_(noise_seq * self._g.reshape(lead))

    def sweep(self, score_fn) -> None:
        """One Picard sweep over the window [p, p + W): device work only,
        no host read, capturable. A no-op once p = S or the sweep count
        reached 4·S."""
        S, W, X = self.nsteps, self.window, self.X
        idx = self.p + self._offsets
        lead = (W,) + (1,) * (X.ndim - 1)
        xs_w = X.index_select(0, idx)
        B = xs_w.shape[1]

        def coef(a):
            return a.index_select(0, idx).reshape(lead)

        flat = (xs_w / coef(self.s)).reshape((W * B,) + tuple(X.shape[2:]))
        sig_flat = self.sigma.index_select(0, idx)[:, None].expand(
            W, B).reshape(-1)
        score = score_fn(flat, sig_flat).reshape(xs_w.shape)
        F = coef(self.scale_mult) * xs_w - coef(self.mult) * score
        incr = coef(self.dt) * F
        if self.stochastic:
            incr = incr + self.noise.index_select(0, idx)
        Y = X.index_select(0, self.p.reshape(1)) + torch.cumsum(incr, dim=0)
        old = X.index_select(0, idx + 1)
        err = (Y - old).abs().reshape(W, -1).amax(dim=1)
        # the first point is exact (Euler from an exact anchor); later ones
        # are accepted while their update stays within tol
        ok = torch.cat([self._first, err[1:] <= self.tol]) & (idx + 1 <= S)
        active = (self.p < S) & (self.sweeps < 4 * S)
        advance = torch.cumprod(ok.to(torch.int64), dim=0).sum() * active
        X.index_copy_(0, idx + 1, torch.where(active, Y, old))
        self.sweeps.add_(active.to(torch.int64))
        self.p.copy_(torch.clamp(self.p + advance, max=S))

    def run(self, sweep) -> int:
        """Call ``sweep()`` (the eager sweep, or a graph's replay) until the
        frontier reaches S or the cap of 4·S sweeps, reading p after every
        call. Returns the sweep count. Raises if the state stops moving (a
        sweep that was not this state's)."""
        S, calls = self.nsteps, 0
        while True:
            sweep()
            calls += 1
            p, sweeps = torch.stack((self.p, self.sweeps)).tolist()
            if p >= S or sweeps >= 4 * S:
                return sweeps
            if calls > 4 * S:
                raise RuntimeError(f"Picard sweeps stopped at p={p} after "
                                   f"{calls} calls")

    @property
    def result(self) -> torch.Tensor:
        """X[S], the sample."""
        return self.X[self.nsteps]


def picard_window_sample(scheduler, x, score_fn, nsteps: int = 18,
                         window: int = 8, tol: float = 1e-3,
                         return_sweeps: bool = False,
                         stochastic: bool = False, generator=None,
                         noise_seq=None, gate: float = 1.0):
    """Sliding-window Picard sampling (ParaDiGMS §3.2): each sweep is one
    network call of batch window·B over the W steps after the converged
    frontier; the first point of the window is exact, and every further
    point whose update changed by at most ``tol`` (absolute, largest over
    the point) is accepted too. ``tol=0`` is sequential Euler in nsteps
    sweeps. ``stochastic=True`` parallelises Euler–Maruyama: its noise is
    independent of the state, so it is drawn before the loop (from
    ``generator``, [nsteps, *x.shape], or replayed from ``noise_seq``)
    and enters the Picard sum as a constant. Runs eagerly; returns the
    sample (and the sweep count if ``return_sweeps``)."""
    pw = PicardWindow(scheduler, x.shape, nsteps, window, tol, stochastic,
                      gate, device=x.device, dtype=x.dtype)
    if stochastic:
        noise_seq = draw_noise(generator, pw.nsteps, x) if noise_seq is None \
            else torch.as_tensor(noise_seq, dtype=x.dtype, device=x.device)
    pw.reset(x, noise_seq)
    sweeps = pw.run(lambda: pw.sweep(score_fn))
    out = pw.result.clone()
    return (out, sweeps) if return_sweeps else out
