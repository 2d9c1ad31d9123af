"""The port's ``utils.inverse_cdf_histogram`` and ``models.nets.vae.swish``
against the JAX package's, on one numpy sample each: the inverse CDF bit
for bit (both are numpy and scipy on the host), swish within 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

from diffsci_tpu.models.nets import vae as jvae
from diffsci_tpu.utils import inverse_cdf_histogram as jinverse_cdf
from diffsci_tpu_torch.models.nets import vae
from diffsci_tpu_torch.utils import inverse_cdf_histogram


@pytest.mark.parametrize("as_tensor", [False, True])
def test_inverse_cdf_histogram_matches_jax(as_tensor):
    rng = np.random.default_rng(3)
    z = np.concatenate([rng.standard_normal(3000),
                        rng.gamma(2.0, 1.5, 1000)]).astype(np.float32)
    q = np.linspace(0.0, 1.0, 257)
    ours = inverse_cdf_histogram(torch.from_numpy(z) if as_tensor else z)
    np.testing.assert_array_equal(ours(q), jinverse_cdf(z)(q))


def test_swish_matches_jax():
    x = np.random.default_rng(4).standard_normal((4, 8, 8, 3)) \
        .astype(np.float32) * 4
    ours = vae.swish(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jvae.swish(jnp.asarray(x)))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
