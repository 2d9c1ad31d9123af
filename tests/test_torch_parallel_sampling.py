"""The port's parallel-in-time (Picard) sampling against the JAX package's
``ops/parallel_sampling.py``, on the same x and the mixture-of-Gaussians
oracle (``gradlogprob`` of both packages' ``MixtureOfGaussiansDataset``),
and ``KarrasModel.sample_parallel`` against the port's sequential Euler
sampler and the JAX package's Picard sampler on converted weights.

Tolerances are ``tests/test_parallel_sampling.py``'s: rtol/atol 1e-4 at
tol 0 (sequential Euler, up to f32 sums in another order) and 1e-3 at
tol 1e-3; ``sample_parallel`` rtol 1e-3, atol 1e-4 (through a net). Sweep
counts are equal at tol 0. At tol 1e-3 a point is accepted when its
update is at most 1e-3, a decision that f32 rounding can flip for a point
within an ulp of the threshold, so the counts may differ by one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsci_tpu import data as jdata
from diffsci_tpu import ops as jops
from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import MLPUncond as JMLPUncond
from diffsci_tpu.ops import parallel_sampling as jps

from diffsci_tpu_torch import KarrasModel, KarrasModelConfig, data, ops
from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.models.nets import MLPUncond
from diffsci_tpu_torch.ops import parallel_sampling as ps
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

_MOG = dict(num_samples=8, means=[[-1.5, 0.0], [1.5, 0.0]],
            weights=[1.0, 1.0], scale=0.3)


def _setup(nsamples=16, langevin_const=None):
    kw = {} if langevin_const is None else {"langevin_const": langevin_const}
    x0 = np.random.default_rng(0).standard_normal((nsamples, 2)).astype(
        np.float32) * 80.0
    return (jdata.MixtureOfGaussiansDataset(**_MOG),
            data.MixtureOfGaussiansDataset(**_MOG),
            jops.EDMScheduler(**kw), ops.EDMScheduler(**kw), x0)


def test_coefficients_match_jax():
    """The per-step drift coefficients (σ, s, scale and score multipliers)
    of the EDM grid exactly, and of the VP grid within rtol 1e-6."""
    _, _, jsched, sched, _ = _setup()
    tt = np.asarray(jsched.create_steps(17), np.float32)[:16]
    for a, b in zip(jps._per_step_coefficients(jsched, tt),
                    ps._per_step_coefficients(sched, tt)):
        np.testing.assert_array_equal(np.asarray(a), b)
    vp_j, vp = jops.VPScheduler(), ops.VPScheduler()
    tt = np.asarray(vp_j.create_steps(9), np.float32)[:8]
    for a, b in zip(jps._per_step_coefficients(vp_j, tt),
                    ps._per_step_coefficients(vp, tt)):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6)


def test_full_picard_matches_jax():
    """``picard_propagate_backward`` at iters = nsteps (sequential Euler)
    and in tol mode, and ``Scheduler.propagate_backward_parallel``."""
    jds, ds, jsched, sched, x0 = _setup()
    ref = jps.picard_propagate_backward(jsched, jnp.asarray(x0),
                                        jds.gradlogprob, nsteps=16)
    out = ps.picard_propagate_backward(sched, torch.from_numpy(x0),
                                       ds.gradlogprob, nsteps=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    seq = sched.propagate_backward(torch.from_numpy(x0), ds.gradlogprob,
                                   nsteps=16, integrator="euler")
    np.testing.assert_allclose(out.numpy(), seq.numpy(), rtol=1e-4,
                               atol=1e-4)
    ref_tol = jps.picard_propagate_backward(jsched, jnp.asarray(x0),
                                            jds.gradlogprob, nsteps=16,
                                            tol=1e-5)
    out_tol = sched.propagate_backward_parallel(
        torch.from_numpy(x0), ds.gradlogprob, nsteps=16, tol=1e-5)
    np.testing.assert_allclose(out_tol.numpy(), np.asarray(ref_tol),
                               rtol=1e-4, atol=1e-4)
    few = ps.picard_propagate_backward(sched, torch.from_numpy(x0),
                                       ds.gradlogprob, nsteps=16, iters=4)
    ref_few = jps.picard_propagate_backward(jsched, jnp.asarray(x0),
                                            jds.gradlogprob, nsteps=16,
                                            iters=4)
    np.testing.assert_allclose(few.numpy(), np.asarray(ref_few), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("S,W", [(16, 8), (64, 16)])
@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_window_picard_matches_jax(S, W, tol):
    """The windowed sampler's result and sweep count against the JAX
    package's on the same x; at tol 0, sequential Euler in S sweeps."""
    jds, ds, jsched, sched, x0 = _setup()
    ref, jsweeps = jps.picard_window_sample(
        jsched, jnp.asarray(x0), jds.gradlogprob, nsteps=S, window=W,
        tol=tol, return_sweeps=True)
    out, sweeps = ps.picard_window_sample(
        sched, torch.from_numpy(x0), ds.gradlogprob, nsteps=S, window=W,
        tol=tol, return_sweeps=True)
    lim = 1e-4 if tol == 0 else 1e-3
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=lim,
                               atol=lim)
    if tol == 0:
        assert sweeps == int(jsweeps) == S
        seq = sched.propagate_backward(torch.from_numpy(x0), ds.gradlogprob,
                                       nsteps=S, integrator="euler")
        np.testing.assert_allclose(out.numpy(), seq.numpy(), rtol=1e-4,
                                   atol=1e-4)
    else:
        assert abs(sweeps - int(jsweeps)) <= 1, (sweeps, int(jsweeps))
        assert sweeps < S


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_window_picard_stochastic_matches_jax(tol):
    """Euler–Maruyama with one replayed ``noise_seq``: the JAX package's
    result and sweeps; at tol 0, the port's sequential Euler–Maruyama on
    the same noise."""
    S = 32
    jds, ds, jsched, sched, x0 = _setup(langevin_const=1.0)
    eps = np.random.default_rng(9).standard_normal((S, 16, 2)).astype(
        np.float32)
    ref, jsweeps = jps.picard_window_sample(
        jsched, jnp.asarray(x0), jds.gradlogprob, nsteps=S, window=8,
        tol=tol, stochastic=True, noise_seq=jnp.asarray(eps),
        return_sweeps=True)
    out, sweeps = ps.picard_window_sample(
        sched, torch.from_numpy(x0), ds.gradlogprob, nsteps=S, window=8,
        tol=tol, stochastic=True, noise_seq=torch.from_numpy(eps),
        return_sweeps=True)
    lim = 1e-4 if tol == 0 else 1e-3
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=lim,
                               atol=lim)
    if tol == 0:
        assert sweeps == int(jsweeps) == S
        seq = sched.propagate_backward(
            torch.from_numpy(x0), ds.gradlogprob, nsteps=S, stochastic=True,
            integrator="euler-maruyama", noise_seq=torch.from_numpy(eps))
        np.testing.assert_allclose(out.numpy(), seq.numpy(), rtol=1e-4,
                                   atol=1e-4)
    else:
        assert abs(sweeps - int(jsweeps)) <= 1, (sweeps, int(jsweeps))


def test_sweep_state_is_inert_after_the_end():
    """Sweeps after the frontier reached S change neither X[S] nor the
    sweep count; the window that overhangs the end reads padded rows; a
    reset state runs to the same bits."""
    _, ds, _, sched, x0 = _setup()
    pw = ps.PicardWindow(sched, x0.shape, nsteps=16, window=8, tol=1e-3)
    pw.reset(torch.from_numpy(x0))
    sweeps = pw.run(lambda: pw.sweep(ds.gradlogprob))
    result, count = pw.result.clone(), int(pw.sweeps)
    assert count == sweeps and int(pw.p) == 16
    for _ in range(3):
        pw.sweep(ds.gradlogprob)
    torch.testing.assert_close(pw.result, result, rtol=0, atol=0)
    assert int(pw.sweeps) == count
    pw.reset(torch.from_numpy(x0))
    assert pw.run(lambda: pw.sweep(ds.gradlogprob)) == sweeps
    torch.testing.assert_close(pw.result, result, rtol=0, atol=0)


def test_sample_parallel_matches_euler_and_jax():
    """``sample_parallel(tol=0)`` equals the port's ``sample(integrator=
    "euler")`` from one seed (x_T drawn in the same order) in nsteps
    sweeps, and the JAX package's ``picard_window_sample`` through the
    converted net on the same x_T."""
    jmodel = JKarrasModel(JMLPUncond(dim=3, hidden_dims=(16,)),
                          JKarrasModelConfig.from_edm())
    variables = jmodel.init(jax.random.PRNGKey(0), (4, 3))
    model = KarrasModel(MLPUncond(3, (16,), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.net.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables)), strict=True)
    seq = model.sample(8, (3,), torch.Generator().manual_seed(5), nsteps=4,
                       integrator="euler")
    par, sweeps = model.sample_parallel(8, (3,),
                                        torch.Generator().manual_seed(5),
                                        nsteps=4, window=4, tol=0.0,
                                        return_sweeps=True)
    assert sweeps == 4
    np.testing.assert_allclose(par.numpy(), seq.numpy(), rtol=1e-3,
                               atol=1e-4)
    x_t = torch.randn((8, 3), generator=torch.Generator().manual_seed(5))
    sched = jmodel.config.noisescheduler

    def jscore(xt, sigma):
        return jmodel.get_score(variables, xt, sigma)

    ref = jps.picard_window_sample(
        sched, jnp.asarray(x_t.numpy()) * sched.maximum_scale, jscore,
        nsteps=4, window=4, tol=0.0)
    np.testing.assert_allclose(par.numpy(), np.asarray(ref), rtol=1e-3,
                               atol=1e-4)
    sto, sto_sweeps = model.sample_parallel(
        8, (3,), torch.Generator().manual_seed(5), nsteps=4, window=2,
        tol=0.0, stochastic=True, return_sweeps=True)
    seq_sto = model.sample(8, (3,), torch.Generator().manual_seed(5),
                           nsteps=4, stochastic=True,
                           integrator="euler-maruyama")
    assert sto_sweeps == 4
    np.testing.assert_allclose(sto.numpy(), seq_sto.numpy(), rtol=1e-3,
                               atol=1e-4)
