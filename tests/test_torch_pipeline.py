"""The port's pipeline parallelism (``parallel/pipeline.py``) at world
size 2 and 4 (gloo ranks on the CPU) against the JAX package's DiT on
the same weights, at the JAX tests' bounds (``tests/test_pipeline.py``):
the forward 2e-5 / 2e-6 (pure pipeline, dp × pp, one microbatch),
the gradients of the stage chunks, of a whole stack and of the
embedding and head 1e-4 / 1e-6, training steps that lower the loss,
the indivisible block and batch counts, EDM sampling with the denoiser
on the pipeline 2e-3 / 2e-4, and a plain residual block stack 1e-5 /
1e-6. One spawn per world size runs every case
(``tests/_torch_pipeline_cases.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu.models.nets import DiffusionTransformer as JDiT
from diffsci_tpu.ops.schedulers import EDMScheduler as JEDMScheduler

from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.parallel import stack_block_params
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)
from tests._torch_ranks import result, run_ranks

NBLOCKS = 4


def _sd(variables):
    return {k: v.numpy() for k, v in from_jax_variables(
        jax.tree.map(np.asarray, variables)).items()}


def _random_variables(module, seed, *args):
    """A flax module's variables drawn with numpy (N(0, 1/fan_in) for
    kernels, N(0, 0.1²) around 0 or 1 for the rest) in the shapes its
    ``init`` gives, found by ``jax.eval_shape``: flax's own init runs op by
    op on the CPU and takes seconds."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", ""))
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(s.dtype)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(s.dtype)

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2).copy()


@pytest.fixture(scope="module")
def jax_side():
    model = JDiT(nembed=32, nheads=2, nblocks=NBLOCKS, patch_size=4,
                 nchannels=1)
    x = jax.random.normal(jax.random.PRNGKey(0), (8, 16, 16, 1))
    t = jnp.linspace(0.1, 1.0, 8)
    variables = _random_variables(model, 1, x, t)
    ref = {"forward": _nchw(jax.jit(model.apply)(variables, x, t))}

    def loss(params):
        out = model.apply({**variables, "params": params}, x[:4], t[:4])
        return jnp.mean(out ** 2)

    grads = jax.jit(jax.grad(loss))(variables["params"])
    ref["grads"] = _sd({**variables, "params": grads})

    sched = JEDMScheduler()
    x0 = jax.random.normal(jax.random.PRNGKey(8), (8, 16, 16, 1)) \
        * sched.maximum_scale

    def score(xt, sigma):
        sig = jnp.asarray(sigma) * jnp.ones((xt.shape[0],))
        d = model.apply(variables, xt, sig)
        return (d - xt) / sig.reshape(-1, 1, 1, 1) ** 2

    ref["sampling"] = _nchw(sched.propagate_backward(
        jax.random.PRNGKey(7), x0, score, nsteps=4))

    rng = np.random.default_rng(0)
    gw = (rng.standard_normal((NBLOCKS, 16, 16)) * 0.1).astype(np.float32)
    gb = (rng.standard_normal((NBLOCKS, 16)) * 0.1).astype(np.float32)
    gx = rng.standard_normal((12, 5, 16)).astype(np.float32)
    gte = rng.standard_normal((12, 16)).astype(np.float32)
    h = jnp.asarray(gx)
    for i in range(NBLOCKS):
        h = h + jnp.tanh(h @ gw[i] + gb[i] + gte[:, None])
    ref["generic"] = np.asarray(h)

    payload = dict(dit=_sd(variables), x=_nchw(x), t=np.asarray(t),
                   x0=_nchw(x0), gw=gw, gb=gb, gx=gx, gte=gte)
    return payload, ref


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, jax_side):
    payload, ref = jax_side
    return request.param, run_ranks("tests._torch_pipeline_cases",
                                    request.param, payload), ref


def test_pipeline_forward_matches_jax(ranks):
    world, res, ref = ranks
    for rank in range(world):
        out = result(res, "forward", rank)
        for name in ("pp", "dp_pp", "one_micro"):
            np.testing.assert_allclose(out[name], ref["forward"], rtol=2e-5,
                                       atol=2e-6, err_msg=name)


def test_pipeline_backward_matches_jax(ranks):
    world, res, ref = ranks
    names = [f"blocks.{i}" for i in range(NBLOCKS)]
    g_stacked, g_rest = stack_block_params(
        {k: torch.from_numpy(v) for k, v in ref["grads"].items()}, names)
    k = NBLOCKS // world
    for rank in range(world):
        out = result(res, "backward", rank)
        assert out["roundtrip"]
        for whole in (False, True):
            rest, stacked = out[whole]
            assert set(rest) == {n for n in g_rest if n != "time_proj.W"}
            for name, g in rest.items():
                np.testing.assert_allclose(g, g_rest[name].numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=name)
            for name, g in stacked.items():
                want = g_stacked[name].numpy()
                if not whole:
                    want = want[rank * k:(rank + 1) * k]
                np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-6,
                                           err_msg=name)


def test_pipeline_train_steps_lower_the_loss(ranks):
    world, res, _ = ranks
    losses = [result(res, "train_steps", rank) for rank in range(world)]
    assert all(lo == losses[0] for lo in losses)
    assert losses[0][1] < losses[0][0]


def test_pipeline_rejects_indivisible_counts(ranks):
    world, res, _ = ranks
    for rank in range(world):
        assert result(res, "errors", rank) == {"blocks": True,
                                               "batch": True}


def test_pipeline_parallel_sampling_matches_jax(ranks):
    _, res, ref = ranks
    np.testing.assert_allclose(result(res, "sampling"), ref["sampling"],
                               rtol=2e-3, atol=2e-4)


def test_pipeline_apply_generic_blocks(ranks):
    world, res, ref = ranks
    for rank in range(world):
        np.testing.assert_allclose(result(res, "generic", rank),
                                   ref["generic"], rtol=1e-5, atol=1e-6)
