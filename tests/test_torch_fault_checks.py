"""Configuration D's recipe through both packages at a cut width
(``tests/_torch_fault_checks.py d``: PUNetG 3D with circular
convolutions, ``cond_drop`` 0.1, ``PorosityEmbedder``, the EDM batch norm,
AdamW at its defaults, power EMA every 4 steps): from the port's
``init(0)`` carried into the JAX variables, on ``chip_smoke``'s numpy
volumes with σ, ε and the condition-keep masks replayed, three steps
agree (loss rtol 1e-5, grad norm rtol 1e-4, parameters within AdamW's
bounds, the running statistics within 1e-5) and so does the fixed-draw
probe before training."""

import numpy as np

from tests import _torch_warmup  # noqa: F401  (MKL's first exp)
from tests._torch_fault_checks import d_check


def test_d_recipe_steps_match_jax_at_cut_width():
    rows, before, _ = d_check(batch_seed=0, steps=3, channels=4, size=16)
    np.testing.assert_allclose(before[0], before[1], rtol=1e-5)
    for k, loss, jloss, norm, jnorm, dparams, dstats, _ in rows:
        np.testing.assert_allclose(loss, jloss, rtol=1e-5, err_msg=str(k))
        np.testing.assert_allclose(norm, jnorm, rtol=1e-4, err_msg=str(k))
        assert dparams <= 2 * k * 1e-3, k
        assert dstats <= 1e-5, k
