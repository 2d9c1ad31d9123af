"""Tensor parallelism through modules that read a layer's weight instead
of calling the layer: the attention blocks of the autoencoders (LDM's
single-head and linear attention apply their 1×1 convolutions to tokens,
VAENet's through its ``_Conv`` wrappers) and DASC's self-representation
(the whole coefficient matrix). Gloo ranks on the CPU at world 2 and 4
(``tests/_torch_tp_readers_cases.py``) against the single-process step.

The contract is GSPMD's, which the JAX package's tensor parallelism gets:
a placed step gives the single-device result, at ``tests/test_torch_fsdp.py``'s
bounds (loss rtol 1e-5, grad_norm rtol 1e-4, parameters rtol 1e-4 atol
1e-6):
- an autoencoder's VAE step (``shard_state_tensor_parallel`` of its
  ``VAETrainState`` on a (world / 2, 2) data × tensor mesh, at a
  ``min_size`` the attention's width reaches, so q, k, v and proj_out, or
  to_qkv and to_out, are column-parallel);
- DASC's loss and gradients over its videos with ``self_repr`` and the
  rest column-parallel over every rank (``min_size`` ≤ ``num_videos``).
"""

import numpy as np
import pytest

from tests import _torch_warmup  # noqa: F401  (MKL's first exp)
from tests import _torch_tp_readers_cases as tc
from tests._torch_ranks import result, run_ranks


@pytest.fixture(scope="module")
def payload():
    return tc.payload()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, payload):
    return request.param, run_ranks("tests._torch_tp_readers_cases",
                                    request.param, payload)


READERS = {"vanilla": ("q", "k", "v", "proj_out"),
           "linear": ("to_qkv", "to_out"),
           "vaenet": ("q.conv", "k.conv", "v.conv", "proj_out.conv")}


@pytest.mark.parametrize("name", sorted(READERS))
def test_autoencoder_attention_dp_tp_step_matches_one_process(
        ranks, payload, name):
    world, res = ranks
    single = tc.vae_step(payload, name)
    for rank in range(world):
        out = result(res, f"vae_{name}", rank)
        for layer in READERS[name]:
            assert any(".attn" in k and k.endswith(f".{layer}.weight")
                       for k in out["tp"]), (layer, out["tp"])
        np.testing.assert_allclose(out["loss"], single["loss"], rtol=1e-5)
        if single["norm"] is not None:
            np.testing.assert_allclose(out["norm"], single["norm"],
                                       rtol=1e-4)
        assert set(out["params"]) == set(single["params"])
        for k, v in out["params"].items():
            np.testing.assert_allclose(v, single["params"][k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_dasc_self_representation_tp_matches_one_process(ranks, payload):
    world, res = ranks
    single = tc.dasc_step(payload)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in single["grads"].values()))
    for rank in range(world):
        out = result(res, "dasc", rank)
        assert "srm.self_repr.weight" in out["tp"]
        np.testing.assert_allclose(out["loss"], single["loss"], rtol=1e-5)
        got = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                          for g in out["grads"].values()))
        np.testing.assert_allclose(got, norm, rtol=1e-4)
        for k, g in out["grads"].items():
            np.testing.assert_allclose(g, single["grads"][k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
