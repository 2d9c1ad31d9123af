"""The port's sampling path against the JAX package and the reference
fixtures: the EDM math, 18-step Heun sampling through KarrasModel, and
SamplerService's bucket / pad / chunk behaviour on the CPU.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu import ops as jops
from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import PUNetG as JPUNetG
from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig

from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                               PUNetGConfig, SamplerService)
from diffsci_tpu_torch import ops
from diffsci_tpu_torch.convert import from_jax_variables
from tests import _torch_warmup  # noqa: F401  (MKL's first exp, CPU threads)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")

_SMALL = dict(model_channels=8, channel_expansion=(2,),
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1)


# ---------------------------------------------------------------------------
# EDM math without a network
# ---------------------------------------------------------------------------
def test_edm_grid_and_preconditioner_match_jax():
    for n in (6, 19, 51):
        np.testing.assert_allclose(ops.EDMScheduler().create_steps(n),
                                   jops.EDMScheduler().create_steps(n),
                                   rtol=1e-12)
    sigma = np.geomspace(0.002, 80.0, 17).astype(np.float32)
    jp, p = jops.EDMPreconditioner(), ops.EDMPreconditioner()
    for fn in ("skip_scaling", "output_scaling", "input_scaling",
               "noise_conditioner"):
        np.testing.assert_allclose(
            getattr(p, fn)(torch.from_numpy(sigma)).numpy(),
            np.asarray(getattr(jp, fn)(jnp.asarray(sigma))),
            rtol=1e-6, atol=1e-7, err_msg=fn)
    np.testing.assert_allclose(
        ops.EDMNoiseSampler().loss_weighting(torch.from_numpy(sigma)).numpy(),
        np.asarray(jops.EDMNoiseSampler().loss_weighting(jnp.asarray(sigma))),
        rtol=1e-6)


@pytest.mark.parametrize("integrator", [None, "euler"])
def test_analytic_trajectory_matches_jax(integrator):
    """18-step propagate_backward with the N(0, I) data score: the step
    engine, the Heun endpoint rule and record_history; and the forward
    (noising) direction of propagate."""
    x0 = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)

    def jscore(z, sigma):
        return -z / (1.0 + sigma[:, None] ** 2)

    def score(z, sigma):
        return -z / (1.0 + sigma[:, None] ** 2)

    js, s = jops.EDMScheduler(), ops.EDMScheduler()
    ref = np.asarray(js.propagate_backward(
        jax.random.PRNGKey(0), jnp.asarray(x0) * js.maximum_scale, jscore,
        nsteps=18, record_history=True, integrator=integrator))
    hist = s.propagate_backward(torch.from_numpy(x0) * s.maximum_scale,
                                score, nsteps=18, record_history=True,
                                integrator=integrator)
    assert hist.shape == ref.shape == (19, 3, 5)
    np.testing.assert_allclose(hist.numpy(), ref, rtol=1e-5, atol=1e-5)
    ref = np.asarray(js.propagate(
        jax.random.PRNGKey(0), jnp.asarray(x0), jscore, nsteps=18,
        record_history=True, backward=False, integrator=integrator))
    hist = s.propagate(torch.from_numpy(x0), score, nsteps=18,
                       record_history=True, backward=False,
                       integrator=integrator)
    assert hist.shape == ref.shape == (19, 3, 5)
    np.testing.assert_allclose(hist.numpy(), ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# KarrasModel sampling
# ---------------------------------------------------------------------------
def test_heun_18_steps_match_jax():
    """propagate_white_noise, 18 Heun steps (35 network calls), from one
    set of weights and one x0, with a two-head bottleneck attention."""
    fields = dict(_SMALL, number_resnet_attn_block=2, num_heads=2)
    jmodel = JKarrasModel(JPUNetG(JPUNetGConfig(**fields)),
                          JKarrasModelConfig.from_edm())
    variables = jmodel.init(jax.random.PRNGKey(0), (2, 16, 16, 1))
    model = KarrasModel(PUNetG(PUNetGConfig(**fields), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.net.load_state_dict(
        from_jax_variables(jax.tree.map(np.asarray, variables)), strict=True)
    x0 = np.random.default_rng(1).standard_normal((2, 16, 16, 1)).astype(
        np.float32)
    ref = np.asarray(jmodel.propagate_white_noise(
        variables, jax.random.PRNGKey(0), jnp.asarray(x0), nsteps=18,
        record_history=True))
    hist = model.propagate_white_noise(torch.from_numpy(x0), nsteps=18,
                                       record_history=True)
    assert hist.shape == ref.shape == (19, 2, 16, 16, 1)
    np.testing.assert_allclose(hist[-1].numpy(), ref[-1], rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(hist.numpy(), ref, rtol=1e-3, atol=5e-4)


def test_bf16_denoiser_error_matches_jax():
    """compute_dtype=bfloat16: parameters and network input in bf16, the
    preconditioning and the combine in f32. bf16 rounds at other places in
    the two packages (the JAX norms take their statistics in bf16, the
    port's in f32), so the pin is on the error: the port's bf16 denoiser
    stays as close to the f32 denoiser as the JAX package's bf16 one
    (within 1.25x, max and mean)."""
    fields = dict(_SMALL, number_resnet_attn_block=2, num_heads=2)
    x_shape = (2, 16, 16, 1)
    jnet = JPUNetG(JPUNetGConfig(**fields))
    variables = JKarrasModel(jnet, JKarrasModelConfig.from_edm()).init(
        jax.random.PRNGKey(0), x_shape)
    state = from_jax_variables(jax.tree.map(np.asarray, variables))
    x = np.random.default_rng(2).standard_normal(x_shape).astype(
        np.float32) * 3
    sigma = np.array([0.3, 5.0], np.float32)
    out = {}
    for name, jcd, cd in (("f32", None, None),
                          ("bf16", jnp.bfloat16, torch.bfloat16)):
        jmodel = JKarrasModel(jnet, JKarrasModelConfig.from_edm(),
                              compute_dtype=jcd)
        out["jax", name] = np.asarray(jmodel.get_denoiser(
            variables, jnp.asarray(x), jnp.asarray(sigma))[0])
        model = KarrasModel(PUNetG(PUNetGConfig(**fields), device="cpu"),
                            KarrasModelConfig.from_edm(), compute_dtype=cd,
                            device="cpu")
        model.net.load_state_dict(state, strict=True)
        with torch.no_grad():
            d, _ = model.get_denoiser(torch.from_numpy(x),
                                      torch.from_numpy(sigma))
        assert d.dtype == torch.float32
        out["port", name] = d.numpy()
    ref = out["jax", "f32"]
    np.testing.assert_allclose(out["port", "f32"], ref, rtol=5e-4, atol=5e-5)
    err_jax = np.abs(out["jax", "bf16"] - ref)
    err_port = np.abs(out["port", "bf16"] - ref)
    assert err_port.max() <= 1.25 * err_jax.max()
    assert err_port.mean() <= 1.25 * err_jax.mean()


def _fixture_model(gold, prefix, conditional):
    sd = {k[5:]: torch.from_numpy(gold[k]) for k in gold.files
          if k.startswith(prefix)}
    net = PUNetG(PUNetGConfig(**_SMALL),
                 conditional_embedding=torch.nn.Linear(3, 8) if conditional
                 else None, device="cpu")
    net.load_state_dict(sd, strict=True)
    return KarrasModel(net, KarrasModelConfig.from_edm(),
                       conditional=conditional, device="cpu")


@pytest.mark.parametrize("case", ["uncond", "cfg"])
def test_full_pipeline_sample_fixture(case):
    """The reference's whole 18-NFE sample (bounds of
    tests/test_reference_parity11.py), unconditional and with CFG 2.5."""
    gold = np.load(os.path.join(FIXDIR, "full_pipeline_sample.npz"))
    cfg = case == "cfg"
    model = _fixture_model(gold, "csd__" if cfg else "usd__", cfg)
    x0 = torch.from_numpy(gold["x0"]).permute(0, 2, 3, 1).contiguous()
    hist = model.propagate_white_noise(
        x0, y=torch.from_numpy(gold["y"]) if cfg else None,
        guidance=2.5 if cfg else 1.0, nsteps=18, record_history=True)
    assert hist.shape[0] == 19
    ours = hist.numpy()[gold["keep"]]
    ref = gold["cfg_traj" if cfg else "uncond_traj"].transpose(0, 1, 3, 4, 2)
    np.testing.assert_allclose(ours[-1], ref[-1], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=5e-4)


# ---------------------------------------------------------------------------
# SamplerService
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def service():
    fields = dict(_SMALL, model_channels=4)
    model = KarrasModel(PUNetG(PUNetGConfig(**fields), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.init(seed=3)
    return SamplerService(model, (8, 8, 1), batch_buckets=(4, 1), nsteps=2,
                          device="cpu")


def test_service_buckets_pad_and_chunk(service):
    assert service.batch_buckets == (1, 4)
    times = service.warmup()
    assert set(times) == {1, 4}
    before = dict(service.stats)
    out = service.sample(3)
    assert out.shape == (3, 8, 8, 1) and out.dtype == np.float32
    assert np.isfinite(out).all()
    assert service.stats["padded"] - before["padded"] == 1
    assert service.stats["chunks"] - before["chunks"] == 1
    out = service.sample(6)                   # chunked: 4 + 2 (padded to 4)
    assert out.shape == (6, 8, 8, 1)
    assert service.stats["chunks"] - before["chunks"] == 3
    assert service.stats["padded"] - before["padded"] == 3
    assert service.sample(0).shape == (0, 8, 8, 1)
    assert service.stats["requests"] - before["requests"] == 2  # 0 skips
    assert service.stats["samples"] - before["samples"] == 9
    assert service.throughput() > 0


def test_service_seed_determinism(service):
    a = service.sample(6, generator=7)
    b = service.sample(6, generator=7)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, service.sample(6, generator=8))
    # padding rows are dropped, not mixed in: a request of 3 is the first
    # three rows of a request of 4 from the same seed (both bucket 4)
    np.testing.assert_array_equal(service.sample(3, generator=9),
                                  service.sample(4, generator=9)[:3])
    # without a seed, the service's own generator advances
    assert not np.array_equal(service.sample(2), service.sample(2))


def test_combine_policy_and_minibatches(service):
    """fused_precondition=False (broadcast combine) equals the default
    K1 path; sample(maximum_batch_size=...) concatenates its chunks."""
    model = service.model
    x = torch.randn(3, 8, 8, 1, generator=torch.Generator().manual_seed(0))
    sigma = torch.tensor([0.1, 1.0, 40.0])
    with torch.no_grad():
        fused, _ = model.get_denoiser(x, sigma)
        model.fused_precondition = False
        try:
            plain, _ = model.get_denoiser(x, sigma)
        finally:
            model.fused_precondition = "sample"
    torch.testing.assert_close(fused, plain, rtol=1e-6, atol=1e-6)
    out = model.sample(5, (8, 8, 1), torch.Generator().manual_seed(1),
                       nsteps=2, maximum_batch_size=2)
    assert out.shape == (5, 8, 8, 1)
    hist = model.sample(3, (8, 8, 1), torch.Generator().manual_seed(1),
                        nsteps=2, record_history=True, maximum_batch_size=2)
    assert hist.shape == (3, 3, 8, 8, 1)


def test_entry_points_need_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PUNetGConfig(**_SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        PUNetG(cfg)
    net = PUNetG(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        KarrasModel(net, KarrasModelConfig.from_edm())
    model = KarrasModel(net, KarrasModelConfig.from_edm(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SamplerService(model, (8, 8, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        KarrasModel(net, KarrasModelConfig.from_edm(), device="cuda")


# ---------------------------------------------------------------------------
# the sampler graphs' key follows the scheduler
# ---------------------------------------------------------------------------
class _KeyRecorder:
    """A stand-in for a model's ``GraphCache``: it records the keys of the
    graphs it is asked to capture and runs nothing."""

    def __init__(self):
        self.graphs = {}

    def warmup(self, fn):
        pass

    def capture(self, key, fn):
        self.graphs[key] = types.SimpleNamespace()
        return self.graphs[key]


def _small_b(sched):
    model = KarrasModel(PUNetG(PUNetGConfig(**_SMALL), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.init(0)
    model.config.noisescheduler = sched
    return model


def test_swapped_scheduler_samples_as_a_fresh_model():
    """After ``config.noisescheduler`` is swapped for one with another
    ``langevin_const``, ``sample`` gives (bit for bit) the sample of a
    fresh model built at the new scheduler, not the old one's; and the
    key of ``sample``'s graph (``compile_sampler``, taken here with a
    recording cache on the CPU) changes with ``langevin_const``, while a
    new scheduler equal to the old one keeps it. The card's replay of
    all three graphed samplers: ``tests/test_torch_card.py::
    test_sampler_graphs_follow_a_swapped_scheduler_on_card``."""
    def draw(m):
        return m.sample(2, (16, 16, 1), torch.Generator().manual_seed(3),
                        nsteps=5, stochastic=True)

    model = _small_b(ops.EDMScheduler(langevin_const=0.5))
    first = draw(model)
    model.config.noisescheduler = ops.EDMScheduler(langevin_const=3.0)
    swapped = draw(model)
    fresh = draw(_small_b(ops.EDMScheduler(langevin_const=3.0)))
    assert torch.equal(swapped, fresh)
    assert not torch.equal(swapped, first)

    cache = _KeyRecorder()
    model._graph_cache = lambda: cache
    for const in (0.5, 3.0, 3.0, 0.5):
        model.config.noisescheduler = ops.EDMScheduler(langevin_const=const)
        model._compile_loop(2, (16, 16, 1), None, None, 1.0, 5, False, None,
                            True, None, False, False)
    assert len(cache.graphs) == 2
    keys = [ops.EDMScheduler(**kw).graph_key() for kw in (
        {}, {"langevin_const": 2.0}, {"langevin_interval": (0.1, 1.0)},
        {"sigma_max": 40.0}, {"scheduling": "VE"})]
    assert len(set(keys)) == len(keys)
    assert ops.EDMScheduler().graph_key() == ops.EDMScheduler().graph_key()
