"""K2·S and K3·S, the norm + SiLU split around an all-reduce for rows that
lie across the ranks of a spatial mesh (``kernels/fused_norm.py:
NormSiLUSplit``), on the CPU (their plain versions), against the JAX
package's ``norm_silu`` on the whole tensor, run as the JAX package's
tests run it (its Pallas kernels in interpret mode).

Each slab of the first spatial axis is a rank: threads stand in for the
ranks, and their ``reduce`` sums a [B, C] tensor over them in rank order
behind a barrier, as an all-reduce does. Over 2 and 4 slabs:
- the forward within ``tests/test_kernels.py:175``'s bound (rtol 2e-5,
  atol 2e-6);
- the backward of sum(y·cos y) within ``tests/test_kernels.py:199``'s
  (rtol 5e-5, atol 5e-6): dx, and dw and db summed over the ranks from
  each rank's local partials (the train step's gradient sum), so a rank
  that took the all-reduced sums for dw and db would count them S times.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu.kernels import fused_norm as jfn

from diffsci_tpu_torch import kernels
from diffsci_tpu_torch.kernels import fused_norm as fn
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)


class _Ranks:
    """``n`` threads as the ranks of one group: ``reduce(rank)`` is that
    rank's in-place sum over the group (every rank's tensor, in rank
    order, behind a barrier)."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=60)
        self.slots = [None] * n

    def reduce(self, rank: int):
        def fn(t):
            self.slots[rank] = t.clone()
            self.barrier.wait()
            total = self.slots[0].clone()
            for other in self.slots[1:]:
                total += other
            self.barrier.wait()
            t.copy_(total)
        return fn

    def run(self, body) -> list:
        out, errors = [None] * self.n, []

        def target(rank):
            try:
                out[rank] = body(rank)
            except BaseException as e:      # re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=target, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


def _inputs(shape, seed):
    """x (×2 + 0.3), w (×0.2 + 1), b (×0.1) in the port's [B, C, *spatial]
    layout, numpy."""
    rng = np.random.default_rng(seed)
    C = shape[1]
    return ((rng.standard_normal(shape) * 2.0 + 0.3).astype(np.float32),
            (rng.standard_normal(C) * 0.2 + 1.0).astype(np.float32),
            (rng.standard_normal(C) * 0.1).astype(np.float32))


def _last(a):
    """[B, C, *spatial] -> channels-last (the JAX kernel's layout)."""
    return np.moveaxis(a, 1, -1)


def _jax(x, w, b, kind):
    def loss(x, w, b):
        y = jfn.norm_silu(x, w, b, kind, interpret=True)
        return jnp.sum(y * jnp.cos(y)), y

    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(_last(x)), jnp.asarray(w), jnp.asarray(b))
    return (np.moveaxis(np.asarray(y), -1, 1),
            np.moveaxis(np.asarray(grads[0]), -1, 1),
            np.asarray(grads[1]), np.asarray(grads[2]))


def _split(x, w, b, kind, n):
    """The split norm on n slabs of dim 2, one thread a rank: (y, dx, dw,
    db) of sum(y·cos y), dw and db summed over the ranks."""
    ranks = _Ranks(n)
    slabs = np.split(x, n, axis=2)
    count = x[0, 0].size

    def body(rank):
        xs = torch.from_numpy(slabs[rank].copy()).requires_grad_()
        ws = torch.from_numpy(w.copy()).requires_grad_()
        bs = torch.from_numpy(b.copy()).requires_grad_()
        y = fn.norm_silu_split(xs, ws, bs, kind, 1e-5, ranks.reduce(rank),
                               count)
        (y * torch.cos(y)).sum().backward()
        return y.detach(), xs.grad, ws.grad, bs.grad

    outs = ranks.run(body)
    return (torch.cat([o[0] for o in outs], 2).numpy(),
            torch.cat([o[1] for o in outs], 2).numpy(),
            sum(o[2] for o in outs).numpy(), sum(o[3] for o in outs).numpy())


SHAPES = [(2, 64, 8, 8), (2, 32, 4, 4, 4), (3, 160, 12)]


@pytest.mark.parametrize("slabs", [2, 4])
@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "3d", "1d"])
def test_split_norm_matches_jax_on_the_whole_tensor(shape, kind, slabs):
    x, w, b = _inputs(shape, seed=len(shape) + slabs)
    y_ref, dx_ref, dw_ref, db_ref = _jax(x, w, b, kind)
    y, dx, dw, db = _split(x, w, b, kind, slabs)
    np.testing.assert_allclose(y, y_ref, rtol=2e-5, atol=2e-6)
    for got, ref, name in ((dx, dx_ref, "dx"), (dw, dw_ref, "dw"),
                           (db, db_ref, "db")):
        np.testing.assert_allclose(got, ref, rtol=5e-5, atol=5e-6,
                                   err_msg=f"{kind} {name}")


def test_split_norm_halves_against_the_unsplit_plain_versions():
    """One slab (S = 1): K2·S's and K3·S's halves give the unsplit plain
    versions' y, statistics, dx, dw and db; the wrappers count no launch
    on CPU tensors (they take the plain versions)."""
    x, w, b = (torch.from_numpy(a) for a in _inputs((2, 8, 6, 5), 3))
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    before = dict(kernels.LAUNCHES)
    for kind in ("ln", "rms"):
        y, mean, rstd = fn.norm_silu_split_fwd(x, w, b, kind, 1e-5,
                                               lambda t: None, 30)
        ry, rmean, rrstd = fn.norm_silu_plain(x, w, b, kind)
        torch.testing.assert_close(y, ry, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(mean, rmean, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(rstd, rrstd, rtol=1e-6, atol=1e-6)
        got = fn.norm_silu_split_bwd(g, x, mean, rstd, w, b, kind,
                                     lambda t: None, 30)
        for a, r in zip(got, fn.norm_silu_bwd_plain(g, x, rmean, rrstd, w,
                                                    b, kind)):
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)
    assert kernels.LAUNCHES == before
