"""The port's inference features against the JAX package: AnoDDPM and
DDAD (``features/anomaly.py``), RePaint (``features/inpainting.py``),
``KarrasModel.interpolate_images`` and ``sample_and_filter``, and
``sample_onestep`` (``models/karras/distill.py``).

The anomaly detectors and RePaint run on the mixture-of-Gaussians oracle
(``gradlogprob`` of both packages' datasets) with the JAX run's draws
replayed into the port (``apply_eps=``, ``noise_seq=``, ``eps=``,
``noise=``, ``renoise_noises=``; where the JAX function has no hook, the
test derives its draws from the key as the JAX code splits it). The
model features run an MLP on weights converted from a JAX init
(``from_jax_variables``). Tolerance: rtol/atol 1e-4, the JAX package's
sequential-sampler bound (``tests/test_parallel_sampling.py``), over f32
sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsci_tpu import data as jdata
from diffsci_tpu import ops as jops
from diffsci_tpu.features import DDAD as JDDAD
from diffsci_tpu.features import AnoDDPM as JAnoDDPM
from diffsci_tpu.features import RePaint as JRePaint
from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import MLPUncond as JMLPUncond
from diffsci_tpu.models.karras.distill import \
    sample_onestep as jsample_onestep

from diffsci_tpu_torch import KarrasModel, KarrasModelConfig, data, ops
from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.features import DDAD, AnoDDPM, RePaint
from diffsci_tpu_torch.models.karras.distill import sample_onestep
from diffsci_tpu_torch.models.nets import MLPUncond
from diffsci_tpu_torch.utils import linear_interpolation
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

TOL = dict(rtol=1e-4, atol=1e-4)
_MOG = dict(num_samples=8, means=[[-1.5, 0.0], [1.5, 0.0]],
            weights=[1.0, 1.0], scale=0.3)


def _oracles():
    return (jdata.MixtureOfGaussiansDataset(**_MOG).gradlogprob,
            data.MixtureOfGaussiansDataset(**_MOG).gradlogprob)


def _x(shape=(6, 2), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_anoddpm_matches_jax():
    """AnoDDPM (Euler–Maruyama, the default) from step 10 of 20 with the
    noising ε and the per-step noise replayed: the history and the
    reconstruction error; a clean input reconstructs closer than a
    corrupted one."""
    jscore, score = _oracles()
    x = _x()
    rng = np.random.default_rng(1)
    eps = rng.standard_normal(x.shape).astype(np.float32)
    seq = rng.standard_normal((10,) + x.shape).astype(np.float32)
    jdet, det = JAnoDDPM(jops.EDMScheduler()), AnoDDPM(ops.EDMScheduler())
    ref = jdet.reconstruct(jax.random.PRNGKey(0), jnp.asarray(x), jscore,
                           step=10, nsteps=20, record_history=True,
                           apply_eps=jnp.asarray(eps),
                           noise_seq=jnp.asarray(seq))
    out = det.reconstruct(_t(x), score, step=10, nsteps=20,
                          record_history=True, apply_eps=_t(eps),
                          noise_seq=_t(seq))
    assert out.shape == (11,) + x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    err = det.reconstruction_error(_t(x), score, 10, 20, apply_eps=_t(eps),
                                   noise_seq=_t(seq))
    np.testing.assert_allclose(
        err.numpy(), ((x - np.asarray(ref[-1])) ** 2).sum(-1), **TOL)
    g = torch.Generator().manual_seed(0)
    clean = det.reconstruction_error(torch.full((64, 2), 1.5), score, 10,
                                     20, generator=g)
    bad = det.reconstruction_error(torch.full((64, 2), 4.0), score, 10, 20,
                                   generator=g)
    assert float(bad.mean()) > float(clean.mean())


@pytest.mark.parametrize("integrator", [None, "euler"])
def test_ddad_matches_jax(integrator):
    """DDAD (Heun, and Euler) from step 8 of 16, w = 3, on the JAX run's
    draws: the noising ε from k1 and the stochastic forward pass's per-step
    noise from k2, split as the JAX scan splits them."""
    jscore, score = _oracles()
    x = _x()
    key = jax.random.PRNGKey(3)
    k1, k2, _ = jax.random.split(key, 3)
    eps = np.asarray(jax.random.normal(k1, x.shape, jnp.float32))
    rows, kc = [], k2
    for _ in range(15):
        kc, sub = jax.random.split(kc)
        rows.append(np.asarray(jax.random.normal(sub, x.shape, jnp.float32)))
    jint = None if integrator is None else jops.EulerIntegrator()
    pint = None if integrator is None else ops.EulerIntegrator()
    ref = JDDAD(jops.EDMScheduler()).reconstruct(
        key, jnp.asarray(x), jscore, nsteps=16, initial_step=8, w=3.0,
        integrator=jint, record_history=True)
    det = DDAD(ops.EDMScheduler())
    out = det.reconstruct(_t(x), score, nsteps=16, initial_step=8, w=3.0,
                          integrator=pint, record_history=True,
                          apply_eps=_t(eps), noise_seq=_t(np.stack(rows)))
    assert out.shape == (9,) + x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    err = det.reconstruction_error(_t(x), score, 8, 16, integrator=pint,
                                   apply_eps=_t(eps),
                                   noise_seq=_t(np.stack(rows)))
    jerr = JDDAD(jops.EDMScheduler()).reconstruction_error(
        key, jnp.asarray(x), jscore, 8, 16, integrator=jint)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), **TOL)


def test_repaint_matches_jax():
    """RePaint over the oracle (20 steps, resample every 5 steps twice)
    with the noised history's ε, x_T and the re-noise draws replayed, and
    its noised history itself."""
    jscore, score = _oracles()
    x = _x((4, 2))
    mask = np.array([1.0, 0.0], np.float32)
    nsteps, rsteps, nres = 20, 5, 2
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(4), 3)
    hist_keys = jax.random.split(k1, nsteps + 1)
    eps = np.stack([np.asarray(jax.random.normal(k, x.shape, jnp.float32))
                    for k in hist_keys])
    x_t = np.asarray(jax.random.normal(k2, x.shape, jnp.float32))
    renoise = np.random.default_rng(2).standard_normal(
        (nres * (nsteps // rsteps - 1),) + x.shape).astype(np.float32)
    jrp, rp = JRePaint(jops.EDMScheduler()), RePaint(ops.EDMScheduler())
    jhist = jrp.gaussian_noised_history(k1, jnp.asarray(x), nsteps)
    hist = rp.gaussian_noised_history(_t(x), nsteps, eps=_t(eps))
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=1e-6,
                               atol=1e-5)
    ref = jrp.scheduler.repaint(
        jax.random.PRNGKey(9), jnp.asarray(x_t) * 80.0, jhist,
        jnp.asarray(mask), jscore, nsteps=nsteps, rsteps=rsteps,
        nresamples=nres, renoise_noises=jnp.asarray(renoise))
    out = rp.reconstruct(_t(x), score, _t(mask), n_resamples=nres,
                         resample_steps=rsteps, nsteps=nsteps, eps=_t(eps),
                         noise=_t(x_t), renoise_noises=_t(renoise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    drawn = rp.reconstruct(_t(x), score, _t(mask), nsteps=nsteps,
                           resample_steps=rsteps,
                           generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn).all()


def _mlp_pair():
    jmodel = JKarrasModel(JMLPUncond(dim=3, hidden_dims=(16,)),
                          JKarrasModelConfig.from_edm())
    variables = jmodel.init(jax.random.PRNGKey(0), (4, 3))
    model = KarrasModel(MLPUncond(3, (16,), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.net.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables)), strict=True)
    return jmodel, variables, model


def test_interpolate_images_matches_jax():
    """``interpolate_images(jitter=None)``: both images to noise by the
    learned pf-ODE, 4 inner points on the straight line, and back; and
    ``linear_interpolation`` itself."""
    jmodel, variables, model = _mlp_pair()
    x1, x2 = _x((3,), 1), _x((3,), 2)
    ref = jmodel.interpolate_images(variables, jax.random.PRNGKey(0),
                                    jnp.asarray(x1), jnp.asarray(x2), 4,
                                    jitter=None, nsteps=6)
    out = model.interpolate_images(_t(x1), _t(x2), 4, jitter=None, nsteps=6)
    assert out.shape == (6, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    from diffsci_tpu.utils import linear_interpolation as jlinear
    np.testing.assert_allclose(
        linear_interpolation(_t(x1), _t(x2), 3).numpy(),
        np.asarray(jlinear(jnp.asarray(x1), jnp.asarray(x2), 3)),
        rtol=1e-6, atol=1e-7)
    jittered = model.interpolate_images(
        _t(x1), _t(x2), 2, nsteps=6, generator=torch.Generator())
    assert jittered.shape == (4, 3) and torch.isfinite(jittered).all()


def test_sample_and_filter_matches_jax(monkeypatch):
    """``sample_and_filter`` over 10 samples in chunks of 4 (4, 4, 2) with
    the JAX run's x_T replayed chunk by chunk (its keys split as the JAX
    method splits them): the samples, the filter and the hit rate; with
    ``return_only_positives`` only the positives remain."""
    jmodel, variables, model = _mlp_pair()

    def positive(enc):
        return enc[:, 0] > 0

    key = jax.random.PRNGKey(7)
    ref = jmodel.sample_and_filter(variables, key, 10, (3,), positive,
                                   nsteps=5, maximum_batch_size=4)
    draws, k = [], key
    for bs in (4, 4, 2):
        k, sub = jax.random.split(k)
        _, sub2, _ = jax.random.split(sub, 3)
        knoise, _, _ = jax.random.split(sub2, 3)
        draws.append(np.asarray(jax.random.normal(knoise, (bs, 3))))
    replay = iter(draws)

    def replayed(inputs, generator, langevin_scale):
        inputs[0].copy_(_t(next(replay)))
        return inputs

    monkeypatch.setattr(model, "_draw_inputs", replayed)
    out = model.sample_and_filter(10, (3,), positive, nsteps=5,
                                  maximum_batch_size=4)
    np.testing.assert_allclose(out["samples"].numpy(),
                               np.asarray(ref["samples"]), **TOL)
    np.testing.assert_array_equal(out["filter"].numpy(),
                                  np.asarray(ref["filter"]))
    assert out["hit_rate"] == pytest.approx(float(ref["hit_rate"]))
    monkeypatch.undo()
    pos = model.sample_and_filter(10, (3,), positive, torch.Generator(),
                                  nsteps=5, maximum_batch_size=4,
                                  return_only_positives=True)
    assert bool(pos["filter"].all())
    assert pos["samples"].shape[0] == round(pos["hit_rate"] * 10)


def test_sample_onestep_matches_jax():
    """``sample_onestep``: one denoiser call D(σ_max·ε, σ_max) on the ε the
    port draws, against the JAX package's denoiser on that ε (and JAX's
    ``sample_onestep`` is that call on its key's ε); a VP model raises."""
    jmodel, variables, model = _mlp_pair()
    out = sample_onestep(model, 5, (3,), torch.Generator().manual_seed(3))
    eps = torch.randn((5, 3), generator=torch.Generator().manual_seed(3))
    den, _ = jmodel.get_denoiser(variables, jnp.asarray(eps.numpy()) * 80.0,
                                 jnp.full((5,), 80.0))
    np.testing.assert_allclose(out.numpy(), np.asarray(den), **TOL)
    key = jax.random.PRNGKey(1)
    jout = jsample_onestep(jmodel, variables, key, 5, (3,))
    jden, _ = jmodel.get_denoiser(
        variables, 80.0 * jax.random.normal(key, (5, 3)),
        jnp.full((5,), 80.0))
    np.testing.assert_allclose(np.asarray(jout), np.asarray(jden), rtol=1e-6)
    vp = KarrasModel(MLPUncond(3, (16,), device="cpu"),
                     KarrasModelConfig.from_vp(), device="cpu")
    with pytest.raises(NotImplementedError):
        sample_onestep(vp, 2, (3,))


def test_anoddpm_matches_reference_fixture():
    """AnoDDPM against the reference's own output
    (``tests/fixtures/reference/anoddpm.npz``, from step 90 of 100 with its
    initial draw replayed), with the deterministic Heun the reference
    always used (``tests/test_reference_parity8.py``'s pin and bound:
    rtol 5e-4, atol 1e-5)."""
    import os

    d = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                             "reference", "anoddpm.npz"))

    def score(xx, sigma):
        s = sigma.reshape((-1,) + (1,) * (xx.ndim - 1))
        return -xx / (1.0 + s ** 2)

    det = AnoDDPM(ops.EDMScheduler(), ops.HeunIntegrator())
    rec = det.reconstruct(_t(d["x"]), score, step=90, nsteps=100,
                          apply_eps=_t(d["eps0"]))
    np.testing.assert_allclose(rec.numpy(), d["rec"], rtol=5e-4, atol=1e-5)
