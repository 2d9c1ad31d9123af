"""The port's metrics (``diffsci_tpu_torch/metrics.py``) against the JAX
package's ``diffsci_tpu/metrics.py`` on the same numpy inputs.

- the host math (float64 numpy/scipy in both): ``fid``,
  ``frechet_distance`` (rank-deficient and NaN covariances), ``kid``,
  ``sample_statistics``, ``fid_from_samples``;
- FLD on the CPU in float32 against the JAX package's f32 (optax's Adam
  and torch's share the update m̂/(√v̂ + ε)): ``fit_mog_bandwidths``,
  ``fld`` and ``fld_generalization_gap`` at d 6 and a few hundred points,
  ``n_iters`` ≤ 50;
- ``classifier_features_fn`` of a ``MinimalResNet`` carried over by
  ``from_jax_variables``;
- the FID and FLD orderings the JAX package's
  ``tests/test_remaining_components.py`` asserts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu import metrics as jmetrics

from diffsci_tpu_torch import metrics
from diffsci_tpu_torch.convert import from_jax_variables
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This module's work is thousands of small torch operations (FLD's Adam steps);
    beside pytest-xdist's other workers their intra-op threads contend (a
    test of 0.3 s alone took 80 s), so the module runs on one thread,
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sets():
    rng = np.random.default_rng(0)
    d = 6
    return {"train": rng.standard_normal((400, d)),
            "test": rng.standard_normal((200, d)),
            "fresh": rng.standard_normal((150, d)),
            "shifted": rng.standard_normal((150, d)) + 2.5}


def test_fid_kid_statistics_match_jax():
    """FID, KID (default and explicit kernels) and the sample statistics
    equal the JAX package's to 1e-10 relative (both float64 on the host),
    on numpy and on tensor inputs; FID of a set with itself ~0."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((300, 8))
    b = rng.standard_normal((250, 8)) * 1.3 + 0.4
    for ours, ref in (
            (metrics.fid(a, b), jmetrics.fid(a, b)),
            (metrics.fid(torch.from_numpy(a), b), jmetrics.fid(a, b)),
            (metrics.kid(a, b), jmetrics.kid(a, b)),
            (metrics.kid(a, b, degree=2, gamma=0.5, coef=0.3),
             jmetrics.kid(a, b, degree=2, gamma=0.5, coef=0.3))):
        np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-12)
    assert metrics.fid(a, a) == pytest.approx(0.0, abs=1e-6)
    s, js = metrics.sample_statistics(b), jmetrics.sample_statistics(b)
    assert set(s) == set(js)
    for k in s:
        np.testing.assert_allclose(s[k], js[k], rtol=1e-12, atol=1e-12)
    mu, sig = metrics.feature_statistics(a)
    jmu, jsig = jmetrics.feature_statistics(a)
    np.testing.assert_allclose(mu, jmu, rtol=1e-12)
    np.testing.assert_allclose(sig, jsig, rtol=1e-12)


def test_frechet_distance_singular_retry_matches_jax():
    """Rank-deficient covariances (more dims than samples): both packages
    take the same path through ``sqrtm`` and drop the imaginary part
    alike; a NaN covariance ends alike (scipy's error, or NaN after the
    ``eps`` retry)."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((5, 12))
    b = rng.standard_normal((6, 12))
    mu1, s1 = metrics.feature_statistics(a)
    mu2, s2 = metrics.feature_statistics(b)
    np.testing.assert_allclose(metrics.frechet_distance(mu1, s1, mu2, s2),
                               jmetrics.frechet_distance(mu1, s1, mu2, s2),
                               rtol=1e-8)
    nan = np.full_like(s1, np.nan)

    def outcome(fn):
        try:
            with np.errstate(invalid="ignore"):
                return fn(mu1, nan, mu2, s2)
        except Exception as e:      # noqa: BLE001  (compared below)
            return type(e)

    ours, ref = outcome(metrics.frechet_distance), outcome(
        jmetrics.frechet_distance)
    assert ours is ref or (np.isnan(ours) and np.isnan(ref))


def test_fid_orders_sets():
    """FID ~0 for a set with itself, smaller for a fresh draw than for a
    shifted one (≈ ||2||² per dim), and KID the same order, as the JAX
    package's test holds it."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((500, 8))
    b = rng.standard_normal((500, 8))
    shifted = a + 2.0
    assert metrics.fid(a, b) < metrics.fid(a, shifted)
    assert abs(metrics.fid(a, shifted) - 4 * 8) < 2.0
    assert metrics.kid(a, b) < metrics.kid(a, shifted)


def test_fid_from_samples_matches_jax():
    """Batched extraction (a batch that does not divide N) through a
    features function returning tensors."""
    rng = np.random.default_rng(3)
    real = rng.uniform(size=(70, 4, 4, 1)).astype(np.float32)
    fake = (real[:60] * 0.8 + 0.1).astype(np.float32)
    w = rng.standard_normal((16, 5)).astype(np.float32)

    def fn(x):
        return torch.as_tensor(x).reshape(len(x), -1) @ torch.from_numpy(w)

    def jfn(x):
        return jnp.asarray(x).reshape(len(x), -1) @ w

    np.testing.assert_allclose(
        metrics.fid_from_samples(real, fake, fn, batch_size=32),
        jmetrics.fid_from_samples(real, fake, jfn, batch_size=32),
        rtol=1e-5)


def test_pairwise_sq_dists_matches_jax():
    """Chunked over rows (chunk 64 of 150): the JAX package's f32
    distances within 1e-5 of their scale (the port's product is float64,
    rounded to f32), never negative."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((150, 6)).astype(np.float32)
    b = rng.standard_normal((90, 6)).astype(np.float32)
    ours = metrics._pairwise_sq_dists(torch.from_numpy(a), b, chunk=64)
    ref = np.asarray(jmetrics._pairwise_sq_dists(a, b, chunk=64))
    assert ours.shape == (150, 90) and float(ours.min()) >= 0.0
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * float(ref.max()))
    ll = metrics._mog_log_likelihood(ours, torch.zeros(90) - 0.5, 6)
    jll = jmetrics._mog_log_likelihood(jnp.asarray(ref),
                                       jnp.zeros(90) - 0.5, 6)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=1e-5)


def test_fit_mog_bandwidths_matches_jax(sets):
    """40 Adam steps (lr 0.1) on the same centres and fit set: the fitted
    log σ² within 1e-4 and the mean fit NLL within 1e-5 relative of the
    JAX package's (float32 each, the same update rule)."""
    centers = sets["fresh"].astype(np.float32)
    fit = sets["train"][:300].astype(np.float32)
    ls, nll = metrics.fit_mog_bandwidths(centers, fit, n_iters=40, lr=0.1,
                                         device="cpu")
    jls, jnll = jmetrics.fit_mog_bandwidths(jnp.asarray(centers),
                                            jnp.asarray(fit), 40, 0.1)
    assert ls.shape == (150,) and not ls.requires_grad
    np.testing.assert_allclose(ls.numpy(), np.asarray(jls), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(nll), float(jnll), rtol=1e-5)


@pytest.mark.parametrize("gen", ["fresh", "shifted"])
def test_fld_matches_jax(sets, gen):
    """``fld`` (train 400, test 200, gen 150, 30 steps, seed 1) and
    ``fld_generalization_gap``: the same permutation, standardization and
    subsets, and the JAX package's value within 1e-4 of max(1, |FLD|)."""
    kw = dict(n_iters=30, lr=0.1, seed=1)
    ours = metrics.fld(sets["train"], sets["test"], sets[gen], device="cpu",
                       **kw)
    ref = jmetrics.fld(sets["train"], sets["test"], sets[gen], **kw)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-4 * max(1.0, abs(ref)))
    gap = metrics.fld_generalization_gap(sets["train"], sets[gen],
                                         device="cpu", **kw)
    jgap = jmetrics.fld_generalization_gap(sets["train"], sets[gen], **kw)
    np.testing.assert_allclose(gap, jgap, rtol=0,
                               atol=1e-4 * max(1.0, abs(jgap)))


def test_fld_orders_models_and_detects_memorization():
    """The JAX package's FLD properties (its test at 3000 points and 150
    steps, cut to 1200 and 30 here): fresh samples score near the baseline,
    shifted far above, verbatim train copies above fresh, and the
    generalization gap separates copies from fresh samples."""
    rng = np.random.default_rng(0)
    d = 6
    train = rng.standard_normal((1200, d))
    test = rng.standard_normal((600, d))
    fresh = rng.standard_normal((300, d))
    shifted = rng.standard_normal((300, d)) + 2.5
    memorized = train[:300]
    kw = dict(n_iters=30, lr=0.1, seed=1, device="cpu")
    f_fresh = metrics.fld(train, test, fresh, **kw)
    assert abs(f_fresh) < 25.0
    assert metrics.fld(train, test, shifted, **kw) > f_fresh + 50.0
    assert metrics.fld(train, test, memorized, **kw) > f_fresh + 3.0
    assert metrics.fld_generalization_gap(train, memorized, **kw) > \
        metrics.fld_generalization_gap(train, fresh, **kw) + 5.0


def test_fld_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x = np.zeros((8, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.fld(x, x, x, n_iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.fit_mog_bandwidths(x, x, n_iters=1)


def test_classifier_features_fn_matches_jax():
    """A MinimalResNet's pooled trunk through ``from_jax_variables``:
    ``classifier_features_fn`` takes channels-last samples, as the JAX
    function does, and gives its features within 1e-5; FID over them
    agrees to 1e-4."""
    from diffsci_tpu.models.nets.classifiers import MinimalResNet as JResNet
    from diffsci_tpu_torch.models.nets import MinimalResNet

    rng = np.random.default_rng(5)
    x = rng.uniform(size=(24, 12, 12, 1)).astype(np.float32)
    jnet = JResNet(model_channels=8, n_layers=2)
    variables = jax.tree.map(np.asarray, jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(x[:1])))
    ref_fn = jax.jit(jmetrics.classifier_features_fn(jnet, variables))
    net = MinimalResNet(model_channels=8, n_layers=2, device="cpu")
    net.load_state_dict(from_jax_variables(variables), strict=True)
    fn = metrics.classifier_features_fn(net)
    ours, ref = fn(x), np.asarray(ref_fn(jnp.asarray(x)))
    assert ours.shape == (24, 8)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    y = np.clip(x + 0.2 * rng.standard_normal(x.shape), 0, 1).astype(
        np.float32)
    np.testing.assert_allclose(
        metrics.fid_from_samples(x, y, fn, batch_size=10),
        jmetrics.fid_from_samples(x, y, lambda b: ref_fn(jnp.asarray(b)),
                                  batch_size=10), rtol=1e-4)


@pytest.mark.parametrize("setting", ["legacy_tf32", "generic_medium"])
def test_pairwise_sq_dists_leaves_precision_settings(setting):
    """FLD's distances leave the caller's matmul settings as they were:
    after them the caller sets its flag again in the API it uses and the
    generic precision still reads back (toggling the generic setting
    inside made torch refuse to read it once a later phase of
    ``chip_smoke.py`` set the legacy flag)."""
    mm = torch.backends.cuda.matmul
    flags = (mm.allow_tf32, torch.get_float32_matmul_precision())
    try:
        if setting == "legacy_tf32":
            mm.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("medium")
        before = (mm.allow_tf32, torch.get_float32_matmul_precision(),
                  mm.fp32_precision)
        metrics._pairwise_sq_dists(torch.randn(4, 3), torch.randn(5, 3))
        assert (mm.allow_tf32, torch.get_float32_matmul_precision(),
                mm.fp32_precision) == before
        # the caller's next setting, in its own API, still reads back
        if setting == "legacy_tf32":
            mm.allow_tf32 = False
        else:
            torch.set_float32_matmul_precision("high")
        torch.get_float32_matmul_precision()
    finally:
        mm.allow_tf32 = flags[0]
        torch.set_float32_matmul_precision(flags[1])
