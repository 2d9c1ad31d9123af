"""The port's parallel modes at world size 2 and 4 (gloo ranks on the CPU)
against the JAX package on the conftest's 8 virtual devices.

One spawn per world size runs every case (``tests/_torch_parallel_cases
.py``) in each rank; the JAX side runs here. The contract is GSPMD's: a
mode gives the single-device result, within the JAX test's own bound:
- the data-parallel, data × tensor and FSDP train steps: loss rtol 1e-5,
  parameters rtol 1e-4 atol 1e-6 (``tests/test_parallel.py:52-57``), on
  weights from a JAX init and with σ and ε replayed; data × tensor on an
  MLP and on a ConVit whose strided and transposed convolutions shard
  their output features;
- the EDM batch norm under DP, on rows whose per-rank statistics differ
  from the global ones (a per-rank statistic fails it);
- the dp × ep MoE forward: rtol 2e-5 atol 1e-5 (``tests/test_moe.py:131
  -132``), at a capacity factor that drops tokens, where a per-rank
  capacity or per-rank slots would drop others;
- data-parallel sampling (Karras, DDPM, SI, a latent model, 1-NFE):
  1e-5 / 1e-6 against the JAX package's ``sample(mesh=...)`` on its x_T,
  replayed in the port (the two packages' random streams differ), and
  against the port's single-process samples from the same seed, a
  stochastic sampler's too;
- ``halo_shard_decode`` against the JAX package's and against the
  periodic decode (1e-4 / 1e-5, ``tests/test_extra.py:123``);
- ``Trainer(mesh=...)`` over an FSDP and a TP state: its losses, the
  EMA's validation loss, and checkpoints of whole tensors restored at
  world size N and 1, against one process at the DP bounds;
- ``fit_karras(mesh=...)`` against the single-process loop;
- the ensemble/AR (F's: CRPS over E, horizon 2, the in-step sampler),
  distill and VAE (discriminator on) steps on a replicated state, against
  the single-process step on the whole batch with the same replayed draws
  at the DP bounds; the ensemble step also against the JAX package's
  single-device ``make_ensemble_train_step``;
- ``SamplerService(mesh=...)`` (rank 0 serves, the others follow), plain,
  through the dispatcher, 1-NFE, DDIM and over HTTP, against the
  single-process service at the same seeds (1e-5 / 1e-6), and the JAX
  ``SamplerService(mesh=make_mesh())`` on its x_T replayed (at the
  port's Heun-against-JAX bound, rtol 1e-3 atol 1e-4); its bad buckets
  and ``picard=`` raise, as the JAX service's;
- the dp × spatial step (``shard_state_spatial``) against the JAX
  package's single-device ``make_train_step`` on the same weights with σ
  and ε replayed (loss rtol 1e-5, parameters rtol 1e-4 atol 1e-6): the JAX
  test's 2D net (``test_parallel.py:170-180``) on a (world / 2, 2) mesh, a
  3D PUNetG with bottleneck attention and the same net with circular
  convolutions on a spatial mesh of every rank; a second step from a
  generator against the single-process port's. The steps of these pins
  take AdamW with eps 1e-4 in both packages (``tests/_torch_steps.py``:
  at eps 1e-8 Adam's first step turns a rounding-level gradient into
  ±lr).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from diffsci_tpu.extra.chunk_decode import halo_shard_decode as jhalo
from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import MLPUncond as JMLPUncond
from diffsci_tpu.models import create_train_state as jcreate_train_state
from diffsci_tpu.models import make_train_step as jmake_train_step
from diffsci_tpu.models.ddpm import \
    ClassicalDDPMScheduler as JClassicalDDPMScheduler
from diffsci_tpu.models.ddpm import DDIMIntegrator as JDDIMIntegrator
from diffsci_tpu.models.ddpm import DDPMModel as JDDPMModel
from diffsci_tpu.models.ddpm import DDPMModelConfig as JDDPMModelConfig
from diffsci_tpu.models.nets.convit import ConVit as JConVit
from diffsci_tpu.models.nets.convit import ConVitConfig as JConVitConfig
from diffsci_tpu.models.nets.moe import \
    MoEDiffusionTransformer as JMoEDiffusionTransformer
from diffsci_tpu.models.si import SIModel as JSIModel
from diffsci_tpu.models.si import SIModelConfig as JSIModelConfig
from diffsci_tpu.parallel import fsdp_specs as jfsdp_specs
from diffsci_tpu.parallel import make_mesh as jmake_mesh
from diffsci_tpu.parallel import replicate as jreplicate
from diffsci_tpu.parallel import shard_batch as jshard_batch
from diffsci_tpu.models.karras import ensemble as jens
from diffsci_tpu.models.nets.punetg import PUNetG as JPUNetG
from diffsci_tpu.models.nets.punetg import PUNetGCond as JPUNetGCond
from diffsci_tpu.models.nets.punetg import PUNetGConfig as JPUNetGConfig
from diffsci_tpu.serving import SamplerService as JSamplerService
import optax

from diffsci_tpu_torch.convert import from_jax_variables
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)
from tests import _torch_steps as steps
from tests._torch_ranks import result, run_ranks

B = 32


def _sd(variables):
    return {k: v.numpy() for k, v in from_jax_variables(
        jax.tree.map(np.asarray, variables)).items()}


class _JitInit:
    """A JAX model whose ``init`` runs jitted (flax's init runs op by op
    and takes seconds on the CPU)."""

    def __init__(self, model):
        self.model = model

    def init(self, key, x_shape, y=None):
        return jax.jit(self.model.init, static_argnums=1)(key, x_shape)


def _pin_optimizer():
    """``tests/_torch_steps.py:pin_optimizer`` in optax: the default clip
    and AdamW with eps 1e-4."""
    return optax.chain(optax.clip_by_global_norm(0.5),
                       optax.adamw(1e-3, b1=0.9, b2=0.999,
                                   eps=steps.PIN_ADAM_EPS, weight_decay=1e-4))


def _jax_step(hidden, x, sigma, eps, bnorm=False, mesh=None, net=None,
              optimizer=None):
    """One JAX train step (default AdamW + clip, or ``optimizer``) of an
    MLP of ``hidden`` widths (or of ``net``) from the init of key 0, with σ
    and ε replayed; returns (the init's state dict, loss, norm, the
    stepped state dict)."""
    jmodel = JKarrasModel(net or JMLPUncond(dim=2, hidden_dims=hidden),
                          JKarrasModelConfig.from_edm(
                              loss_metric="mse", has_edm_batch_norm=bnorm))
    jstate, jtx = jcreate_train_state(_JitInit(jmodel), jax.random.PRNGKey(0),
                                      (8,) + x.shape[1:],
                                      optimizer=optimizer)
    init = _sd(jstate.variables())

    def jloss(variables, key, xx, y, replay, train=True):
        return jmodel.loss_fn(variables, key, xx, replay["sigma"],
                              train=train, eps=replay["eps"])

    step = jmake_train_step(jmodel, jtx, loss_fn=jloss)
    xs, replay = jnp.asarray(x), {"sigma": jnp.asarray(sigma),
                                  "eps": jnp.asarray(eps)}
    if mesh is not None:
        jstate = jreplicate(jstate, mesh)
        xs, replay = jshard_batch(xs, mesh), jshard_batch(replay, mesh)
    jstate, met = step(jstate, jax.random.PRNGKey(2), xs, None, replay)
    return (init, float(met["train_loss"]), float(met["grad_norm"]),
            _sd(jstate.variables()))


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


class _StubAE:
    """The JAX test's autoencoder of [B, 3] data
    (``test_parallel.py:367-371``)."""

    def encode(self, x, key=None):
        return x[:, :2]

    def decode(self, z):
        return jnp.concatenate([z, z[:, :1]], axis=1)


def _decoder(rng):
    w1 = (rng.standard_normal((8, 2, 3, 3)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal(8) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((1, 8, 3, 3)) * 0.3).astype(np.float32)
    b2 = (rng.standard_normal(1) * 0.1).astype(np.float32)
    return w1, b1, w2, b2


def _jax_decode(w1, b1, w2, b2):
    def conv(x, w, b):
        return lax.conv_general_dilated(
            x, jnp.asarray(w.transpose(2, 3, 1, 0)), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + b

    def decode(z):
        h = jax.nn.silu(conv(z, w1, b1))
        h = jnp.repeat(jnp.repeat(h, 2, axis=1), 2, axis=2)
        return conv(h, w2, b2)
    return decode


@pytest.fixture(scope="module")
def jax_side():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 2)).astype(np.float32)
    sigma = np.exp(rng.standard_normal(B) * 1.2 - 1.2).astype(np.float32)
    eps = rng.standard_normal((B, 2)).astype(np.float32)
    # rows whose blocks have their own means: per-rank batch statistics
    # differ from the global ones
    x_shifted = x + np.repeat(np.arange(8.0, dtype=np.float32), B // 8)[
        :, None]
    payload = dict(x=x, sigma=sigma, eps=eps, x_shifted=x_shifted)
    ref = {}
    mesh = jmake_mesh()
    payload["mlp16"], *ref["dp"] = _jax_step([16], x, sigma, eps,
                                             mesh=mesh)
    payload["bnorm"], *ref["bnorm"] = _jax_step([16], x_shifted, sigma, eps,
                                                bnorm=True)
    payload["mlp64x2"], *ref["tp"] = _jax_step([64, 64], x, sigma, eps)
    payload["mlp64"], *ref["fsdp"] = _jax_step([64], x, sigma, eps)
    jmodel = JKarrasModel(JMLPUncond(dim=2, hidden_dims=[64]),
                          JKarrasModelConfig.from_edm(loss_metric="mse"))
    ref["fsdp_specs"] = jfsdp_specs(
        _JitInit(jmodel).init(jax.random.PRNGKey(0), (8, 2))["params"], mesh,
        min_elements=64)

    # MoE-DiT (test_moe.py:107-132), at two capacity factors
    mx = jax.random.normal(jax.random.PRNGKey(0), (8, 8, 8, 1))
    mt = jnp.linspace(0.1, 1.0, 8)
    ref["moe"] = {}
    for cf in (2.0, 0.5):
        net = JMoEDiffusionTransformer(nembed=16, nheads=2, nblocks=2,
                                       patch_size=2, nchannels=1,
                                       n_experts=4, moe_every=2,
                                       capacity_factor=cf)
        if cf == 2.0:
            mvars = _random_variables(net, 1, mx, mt)
            payload["moe"] = _sd(mvars)
        ref["moe"][cf] = np.asarray(jax.jit(net.apply)(mvars, mx, mt)
                                    ).transpose(0, 3, 1, 2)
    payload["moe_x"] = np.asarray(mx).transpose(0, 3, 1, 2).copy()
    payload["moe_t"] = np.asarray(mt)

    # SI, deterministic, on a replayed x_T (test_parallel.py:325-342)
    si = JSIModel(JMLPUncond(3, hidden_dims=(16,)),
                  JSIModelConfig(scheduler="linear", loss_metric="mse"))
    vs = si.init(jax.random.PRNGKey(0), (8, 3))
    payload["si"] = _sd(vs)
    payload["si_x0"] = rng.standard_normal((16, 3)).astype(np.float32)
    ref["si"] = np.asarray(si.sample(
        vs, jax.random.PRNGKey(3), 16, (3,), nsteps=6, mesh=mesh,
        orig_noise=jnp.asarray(payload["si_x0"])))

    # Karras, DDPM and a latent model sampled on the mesh
    # (test_parallel.py:296-385); the port replays their x_T
    key = jax.random.PRNGKey(5)
    km = JKarrasModel(JMLPUncond(3, hidden_dims=(16,)),
                      JKarrasModelConfig.from_edm())
    kv = _JitInit(km).init(jax.random.PRNGKey(0), (8, 3))
    payload["karras"] = _sd(kv)
    payload["karras_xT"] = np.asarray(jax.random.normal(
        jax.random.split(key, 3)[0], (16, 3)))
    ref["karras"] = np.asarray(km.sample(kv, key, 16, (3,), nsteps=8,
                                         mesh=mesh))
    sch = JClassicalDDPMScheduler(T=50)
    dd = JDDPMModel(JMLPUncond(3, hidden_dims=(16,)),
                    JDDPMModelConfig(sch, JDDIMIntegrator(sch)))
    dv = _JitInit(dd).init(jax.random.PRNGKey(1), (8, 3))
    key = jax.random.PRNGKey(3)
    payload["ddpm"] = _sd(dv)
    payload["ddpm_xT"] = np.asarray(jax.random.normal(
        jax.random.split(key)[0], (16, 3)))
    ref["ddpm"] = np.asarray(dd.sample(dv, key, 16, (3,), mesh=mesh))
    lm = JKarrasModel(JMLPUncond(2, hidden_dims=(8,)),
                      JKarrasModelConfig.from_edm(), autoencoder=_StubAE())
    lv = _JitInit(lm).init(jax.random.PRNGKey(0), (8, 2))
    key = jax.random.PRNGKey(1)
    payload["latent"] = _sd(lv)
    payload["latent_xT"] = np.asarray(jax.random.normal(
        jax.random.split(key, 3)[1], (16, 2)))
    ref["latent"] = np.asarray(lm.sample(lv, key, 16, (3,), nsteps=4,
                                         mesh=mesh))

    # dp × tp on a ConVit with a strided and a transposed convolution
    payload["convit_cfg"] = dict(
        in_channels=1, embed_dim=8, num_layers=1, num_heads=2,
        ffn_expansion_factor=2, kernel_size_in_out=3,
        has_time_embedding=True, condition_dropout=0.0,
        with_conv_on_upsample=True, with_conv_on_downsample=True)
    payload["conv_x"] = rng.standard_normal((8, 8, 8, 1)).astype(
        np.float32)
    payload["conv_sigma"] = np.exp(rng.standard_normal(8) - 1.0).astype(
        np.float32)
    payload["conv_eps"] = rng.standard_normal((8, 8, 8, 1)).astype(
        np.float32)
    payload["convit"], *ref["tp_conv"] = _jax_step(
        None, payload["conv_x"], payload["conv_sigma"], payload["conv_eps"],
        net=JConVit(JConVitConfig(**payload["convit_cfg"])))

    # the halo-sharded decode on 4 virtual devices
    payload["decoder"] = _decoder(rng)
    z = rng.standard_normal((1, 32, 16, 2)).astype(np.float32)
    payload["z"] = z.transpose(0, 3, 1, 2).copy()
    ref["halo"] = np.asarray(jhalo(
        _jax_decode(*payload["decoder"]), jnp.asarray(z),
        jmake_mesh(4, axes=("spatial",)), axis_name="spatial", halo=2,
        upscale=2)).transpose(0, 3, 1, 2)

    payload["fit_data"] = rng.standard_normal((64, 2)).astype(np.float32)
    _spatial_pins(rng, payload, ref)
    _ensemble_pin(rng, payload, ref)
    _service_pin(payload, ref)
    payload.update(_port_step_payloads(rng))
    return payload, ref


SP_2D = dict(model_channels=8, channel_expansion=(2,),
             number_resnet_downward_block=1, number_resnet_upward_block=1,
             number_resnet_attn_block=1, number_resnet_before_attn_block=1,
             number_resnet_after_attn_block=1)
SP_3D = dict(SP_2D, dimension=3, number_resnet_attn_block=2, num_heads=2,
             attn_backend="flash")


def _spatial_pins(rng, payload, ref):
    """The JAX single-device step of each spatial pin's net: the JAX
    test's 2D PUNetG at batch 8 on 16² (test_parallel.py:170-180), a 3D
    one with bottleneck attention at batch 2 on 8³, and that net with
    circular convolutions."""
    for name, cfg, shape in (
            ("sp2d", SP_2D, (8, 16, 16, 1)), ("sp3d", SP_3D, (2, 8, 8, 8, 1)),
            ("sp3dc", dict(SP_3D, convolution_type="circular"),
             (2, 8, 8, 8, 1))):
        x = rng.standard_normal(shape).astype(np.float32)
        sigma = np.exp(rng.standard_normal(shape[0]) - 1.0).astype(
            np.float32)
        eps = rng.standard_normal(shape).astype(np.float32)
        jcfg = JPUNetGConfig(**dict(cfg, channel_expansion=list(
            cfg["channel_expansion"])))
        sd, *ref[name] = _jax_step(None, x, sigma, eps, net=JPUNetG(jcfg),
                                   optimizer=_pin_optimizer())
        payload[name] = dict(cfg=cfg, sd=sd, x=x, sigma=sigma, eps=eps)


def _ensemble_pin(rng, payload, ref):
    """One JAX ``make_ensemble_train_step`` (F's small configuration in
    ``tests/_torch_steps.py``) on replayed σ, ε and in-step x_T, as
    tests/test_torch_ensemble.py replays them."""
    B, H, S, E = 4, 8, 2, 2
    jcfg = jens.EnsembleKarrasModelConfig.from_karras_config(
        JKarrasModelConfig.from_edm(loss_metric="crps",
                                    autoregressive_loss_steps=S,
                                    autoregressive_loss_diffusion_steps=2),
        ensemble_size_train=E)
    jnet = JPUNetGCond(JPUNetGConfig(**dict(
        steps.ENS_CFG, channel_expansion=[2])),
        channel_conditional_items=["y"])
    jmodel = jens.EnsembleKarrasModel(jnet, jcfg, conditional=True)
    x = rng.normal(size=(B, H, H, S)).astype(np.float32)
    ywin = rng.normal(size=(B, H, H, 2)).astype(np.float32)
    sig = np.exp(rng.normal(size=(S, B)) * 1.2 - 1.2).astype(np.float32)
    eps = rng.normal(size=(S, B, E, H, H, 1)).astype(np.float32)
    x_T = rng.normal(size=(S - 1, B, H, H, 1)).astype(np.float32)
    jstate, jtx = jcreate_train_state(jmodel, jax.random.PRNGKey(0),
                                      (B, H, H, 1),
                                      y={"y": jnp.asarray(ywin)},
                                      optimizer=_pin_optimizer())
    orig = jmodel.autoregressive_loss_fn

    def replayed(variables, key, batch, n_ensemble=1, train=True):
        bx, by = batch
        calls = []

        def sampler_fn(target, y):
            s = len(calls)
            calls.append(s)
            return jax.lax.stop_gradient(jmodel.propagate_white_noise(
                variables, key, jnp.asarray(x_T)[s], y, nsteps=2))

        loss, upd, step_losses = orig(
            variables, key, bx, by, None, train=train,
            n_ensemble=n_ensemble, sigma_seq=jnp.asarray(sig),
            eps_seq=[jnp.asarray(eps)[s] for s in range(S)],
            sampler_fn=sampler_fn)
        return loss, upd, {f"ar_loss_horizon_{k + 1}": v
                           for k, v in enumerate(step_losses)}

    jmodel.training_loss = replayed
    payload["ens"] = dict(sd=_sd(jstate.variables()), x=x,
                          ywin=np.moveaxis(ywin, -1, 1).copy(), sigma=sig,
                          eps=eps, x_T=x_T)
    jstate, met = jens.make_ensemble_train_step(jmodel, jtx)(
        jstate, jax.random.PRNGKey(0),
        (jnp.asarray(x), {"y": jnp.asarray(ywin)}))
    ref["ens"] = (float(met["train_loss"]), None, _sd(jstate.variables()))


def _service_pin(payload, ref):
    """The JAX ``SamplerService(mesh=make_mesh())`` of its own test
    (tests/test_serving.py:243-259) at key 11, and the x_T its bucket run
    draws (the chunk's key, then the sampler's first split)."""
    jmodel = JKarrasModel(JMLPUncond(dim=2, hidden_dims=(8,)),
                          JKarrasModelConfig.from_edm())
    vs = _JitInit(jmodel).init(jax.random.PRNGKey(0), (4, 2))
    svc = JSamplerService(jmodel, vs, shape=(2,), batch_buckets=(8,),
                          nsteps=3, mesh=jmake_mesh())
    key = jax.random.PRNGKey(11)
    ref["svc"] = np.asarray(svc.sample(8, key=key))
    chunk = jax.random.split(key, 1)[0]
    payload["svc"] = dict(jax=_sd(vs), jax_xT=np.asarray(jax.random.normal(
        jax.random.split(chunk, 3)[0], (8, 2))))


def _port_step_payloads(rng) -> dict:
    """The distill and VAE cases' weights and draws (the port's own init:
    these pins are the single-process port step)."""
    from diffsci_tpu_torch import KarrasModel, KarrasModelConfig
    from diffsci_tpu_torch.models.nets.mlp import MLPUncond
    model = KarrasModel(MLPUncond(2, (16,), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")

    def weights(seed):
        model.init(seed)
        return {k: v.numpy().copy() for k, v in
                model.net.state_dict().items()}
    vae = steps.vae_model()
    x_vae = rng.standard_normal((4, 1, 16, 16)).astype(np.float32)
    return {
        "distill": dict(sd=weights(1), teacher=weights(2),
                        x=rng.standard_normal((8, 2)).astype(np.float32),
                        idx=rng.integers(0, 3, 8),
                        eps=rng.standard_normal((8, 2)).astype(np.float32)),
        "vae": dict(x=x_vae, eps=rng.standard_normal(tuple(
            vae.latent_shape(x_vae.shape))).astype(np.float32))}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, jax_side, tmp_path_factory):
    payload, ref = jax_side
    payload = dict(payload, ckpt_dir=str(tmp_path_factory.mktemp("ckpt")))
    return request.param, run_ranks("tests._torch_parallel_cases",
                                    request.param, payload), payload, ref


def _close_step(out, ref):
    loss, norm, params = ref
    np.testing.assert_allclose(out["loss"], loss, rtol=1e-5)
    if norm is not None:      # the JAX ensemble step logs no norm
        np.testing.assert_allclose(out["norm"], norm, rtol=1e-4)
    assert set(out["params"]) <= set(params)
    for name, value in out["params"].items():
        np.testing.assert_allclose(value, params[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_mesh_helpers_in_ranks(ranks):
    _, res, _, _ = ranks
    for rank in range(len(res)):
        assert result(res, "mesh", rank) is True


def test_data_parallel_train_step_matches_jax(ranks):
    world, res, _, ref = ranks
    for rank in range(world):
        _close_step(result(res, "dp_step", rank), ref["dp"])


def test_edm_batch_norm_takes_global_statistics(ranks):
    world, res, _, ref = ranks
    out = result(res, "bnorm_step")
    _close_step(out, ref["bnorm"])
    for name in ("bnorm.mean", "bnorm.var"):
        np.testing.assert_allclose(out["buffers"][name],
                                   ref["bnorm"][2][name], rtol=1e-5,
                                   atol=1e-6)


def test_tensor_parallel_train_step_matches_jax(ranks):
    world, res, _, ref = ranks
    for rank in range(world):
        out = result(res, "tp_step", rank)
        assert out["specs"]["model.net.2.weight"] == ("tensor", None)
        assert "model.net.4.weight" not in out["specs"]   # 2 features
        _close_step(out, ref["tp"])


def test_fsdp_train_step_matches_jax(ranks):
    world, res, _, ref = ranks
    jspecs = ref["fsdp_specs"]["model"]
    for rank in range(world):
        out = result(res, "fsdp_step", rank)
        specs = out["specs"]
        # JAX kernels are [in, out], torch weights [out, in]
        for i in (0, 2):
            jk = tuple(jspecs[f"Dense_{i // 2}"]["kernel"])
            jk += (None,) * (2 - len(jk))
            assert specs[f"model.net.{i}.weight"] == jk[::-1]
        assert out["block_shapes"]["model.net.0.weight"] == (64 // world, 3)
        _close_step(out, ref["fsdp"])


def test_tensor_parallel_conv_step_matches_jax(ranks):
    """The convolutions' output features: dim 0 of a ``Conv2d``'s weight,
    dim 1 of a ``ConvTranspose2d``'s."""
    world, res, _, ref = ranks
    for rank in range(world):
        out = result(res, "tp_conv_step", rank)
        specs = out["specs"]
        down, = [k for k in specs if k.endswith("downsample.conv.weight")]
        up, = [k for k in specs if k.endswith("upsample.conv.weight")
               and k != down]
        assert specs[down] == ("tensor", None, None, None)
        assert specs[up] == (None, "tensor", None, None)
        _close_step(out, ref["tp_conv"])


def test_trainer_checkpoints_sharded_states_whole(ranks, tmp_path):
    """``Trainer(mesh=...)`` over an FSDP and a TP state: the losses and
    the EMA's validation loss of one process, and a checkpoint of whole
    tensors that restores at world size N (bit for bit the state saved)
    and at world size 1 (the one-process state)."""
    from diffsci_tpu_torch.checkpoint import restore_checkpoint
    from tests._torch_parallel_cases import (placed_state, trained,
                                             whole_state)
    world, res, payload, _ = ranks
    state, log = trained(payload, None, 1, str(tmp_path / "single"))
    single = whole_state(state)
    assert any("valid_loss" in row for row in log)
    for mode, out in result(res, "checkpoint").items():
        assert len(out["log"]) == len(log)
        for row, ref_row in zip(out["log"], log):
            for key in ("train_loss", "grad_norm", "valid_loss"):
                if key in ref_row:
                    np.testing.assert_allclose(row[key], ref_row[key],
                                               rtol=1e-5, err_msg=key)
        assert set(out["again"]) == set(out["live"]) == set(single)
        for name, value in out["live"].items():
            np.testing.assert_array_equal(out["again"][name], value,
                                          err_msg=f"{mode} {name}")
        fresh = placed_state(payload, None, 1)[0]
        restore_checkpoint(out["directory"], fresh)
        for name, value in whole_state(fresh).items():
            np.testing.assert_allclose(value, single[name], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{mode} {name}")


def test_expert_parallel_forward_matches_jax(ranks):
    world, res, _, ref = ranks
    out = result(res, "ep_forward")
    for cf, y_ref in ref["moe"].items():
        np.testing.assert_allclose(out[cf]["y"], y_ref, rtol=2e-5,
                                   atol=1e-5)
    assert out[0.5]["dropped"] > 0.1     # this case drops tokens


def test_karras_sampling_on_a_mesh(ranks):
    world, res, _, ref = ranks
    for rank in range(world):
        out = result(res, "karras_sampling", rank)
        for key in (False, True, "history"):
            single, sharded = out[key]
            assert sharded.shape == single.shape
            np.testing.assert_allclose(sharded, single, rtol=1e-5,
                                       atol=1e-6)
        assert out["raises"]
        np.testing.assert_allclose(out["jax"], ref["karras"], rtol=1e-5,
                                   atol=1e-6)


def test_ddpm_sampling_on_a_mesh(ranks):
    _, res, _, ref = ranks
    out = result(res, "ddpm_sampling")
    np.testing.assert_allclose(out["pair"][1], out["pair"][0], rtol=1e-5,
                               atol=1e-6)
    assert out["raises"]
    np.testing.assert_allclose(out["jax"], ref["ddpm"], rtol=1e-5,
                               atol=1e-6)


def test_latent_sampling_on_a_mesh_matches_jax(ranks):
    world, res, _, ref = ranks
    for rank in range(world):
        single, sharded = result(res, "latent_sampling", rank)
        assert sharded.shape == (16, 3)
        np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sharded, ref["latent"], rtol=1e-5,
                                   atol=1e-6)


def test_si_sampling_on_a_mesh_matches_jax(ranks):
    _, res, _, ref = ranks
    out = result(res, "si_sampling")
    np.testing.assert_allclose(out["jax_pair"], ref["si"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out["pair"][1], out["pair"][0], rtol=1e-5,
                               atol=1e-6)
    assert out["raises"]


def test_onestep_sampling_on_a_mesh(ranks):
    _, res, _, _ = ranks
    single, sharded = result(res, "onestep")
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)


def test_halo_shard_decode_matches_jax_and_periodic_decode(ranks):
    world, res, _, ref = ranks
    for rank in range(world):
        out, full = result(res, "halo", rank)
        assert out.shape == (1, 1, 64, 32)
        np.testing.assert_allclose(out, full, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out, ref["halo"], rtol=1e-4, atol=1e-5)


def test_fit_karras_on_a_mesh_matches_one_process(ranks):
    from diffsci_tpu_torch import KarrasModel, KarrasModelConfig, fit_karras
    from diffsci_tpu_torch.models.nets.mlp import MLPUncond
    world, res, payload, _ = ranks
    model = KarrasModel(MLPUncond(2, [16], device="cpu"),
                        KarrasModelConfig.from_edm(loss_metric="mse"),
                        device="cpu")
    _, trainer = fit_karras(model, payload["fit_data"], batch_size=16,
                            max_steps=3, seed=3, log_every=1, device="cpu")
    single = [row["train_loss"] for row in trainer.logger.history]
    for rank in range(world):
        np.testing.assert_allclose(result(res, "fit", rank), single,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# every train step synced through its state's placement
# ---------------------------------------------------------------------------
def _single(fn, q):
    return fn(q, lambda state: state, lambda a: a)


@pytest.mark.parametrize("name", ["ensemble_step", "distill_step",
                                  "vae_step"])
def test_placed_steps_match_the_single_process_step(ranks, name):
    """A replicated state stepped on each rank's rows: the single-process
    step on the whole batch, at the DP bounds, on every rank (their
    replicas no longer drift apart)."""
    world, res, payload, _ = ranks
    key = {"ensemble_step": "ens", "distill_step": "distill",
           "vae_step": "vae"}[name]
    ref = _single(getattr(steps, name), payload[key])
    for rank in range(world):
        out = result(res, name, rank)
        np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5)
        groups = ("params", "disc_params") if name == "vae_step" else \
            ("params",)
        for group in groups:
            assert set(out[group]) == set(ref[group])
            for k, v in out[group].items():
                np.testing.assert_allclose(v, ref[group][k], rtol=1e-4,
                                           atol=1e-6, err_msg=k)
        if name == "vae_step":
            assert out["gate"] == ref["gate"] == 1.0
            np.testing.assert_allclose(out["disc_loss"], ref["disc_loss"],
                                       rtol=1e-5)
        else:
            np.testing.assert_allclose(out["norm"], ref["norm"], rtol=1e-4)


def test_placed_ensemble_step_matches_jax(ranks):
    world, res, _, ref = ranks
    for rank in range(world):
        _close_step(result(res, "ensemble_step", rank), ref["ens"])


# ---------------------------------------------------------------------------
# SamplerService(mesh=...)
# ---------------------------------------------------------------------------
def test_mesh_service_matches_the_single_process_service(ranks):
    """Rank 0's samples through the plain service (a request of two
    chunks too), the dispatcher, 1-NFE, DDIM and HTTP are the
    single-process service's at the same seeds, and its stats count once;
    the followers refuse ``sample()``."""
    from diffsci_tpu_torch.serving import SamplerService
    world, res, payload, _ = ranks
    out = result(res, "mesh_service")
    for label, (model, kw, requests) in steps.service_models(
            payload["svc"]).items():
        svc = SamplerService(model, kw.pop("shape"), device="cpu", **kw)
        single = [svc.sample(n, seed) for n, seed in requests]
        for got, want in zip(out[label], single, strict=True):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=label)
        for k in ("requests", "samples", "padded", "chunks",
                  "batched_requests", "batched_dispatches"):
            assert out[label + "_stats"][k] == svc.stats[k], (label, k)
        if label == "plain":
            np.testing.assert_allclose(out["http"], svc.sample(3, 5),
                                       rtol=1e-5, atol=1e-6)
        svc.close()
    for rank in range(1, world):
        assert result(res, "mesh_service", rank)["follower_raises"]


def test_mesh_service_matches_jax_and_raises_as_jax(ranks):
    """The JAX ``SamplerService(mesh=make_mesh())`` on its x_T, at the
    bound of the port's Heun trajectories against the JAX package's
    (tests/test_torch_sampling.py: rtol 1e-3, atol 1e-4; its 3 steps from
    σ 80 leave the two packages' float32 ~3e-5 apart); a bucket that the
    data axis does not divide and ``picard=`` raise."""
    world, res, _, ref = ranks
    out = result(res, "mesh_service")
    np.testing.assert_allclose(out["jax"], ref["svc"], rtol=1e-3, atol=1e-4)
    assert out["raises batch_buckets"] and out["raises picard"]


# ---------------------------------------------------------------------------
# the dp × spatial step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case,name", [("spatial_2d", "sp2d"),
                                       ("spatial_attention", "sp3d"),
                                       ("spatial_circular", "sp3dc")])
def test_spatial_step_matches_jax(ranks, case, name):
    """The dp × spatial step against the JAX package's single-device step
    on the same weights and replayed draws; its second step, from a
    generator (σ and the rows of ε drawn in the global order), against
    the single-process port's."""
    world, res, payload, ref = ranks
    single = steps.spatial_step(payload[name])
    for rank in range(world):
        out = result(res, case, rank)
        _close_step(out, ref[name])
        _close_step({"loss": out["gen_loss"], "norm": 0.0,
                     "params": out["gen_params"]},
                    (single["gen_loss"], 0.0, single["gen_params"]))


def test_spatial_mesh_raises_for_what_it_cannot_take(ranks):
    """A network other than PUNetG and PUNetGCond (a DiT), an extra
    residual module, a slab the levels do not pool whole and the distill
    step on a spatial state raise; nothing trains per slab in their
    place."""
    world, res, _, _ = ranks
    for rank in range(world):
        assert result(res, "spatial_raises", rank) == dict.fromkeys(
            ("dit", "residual", "slab", "distill"), True)


def test_spatial_layers_match_the_whole_tensor(ranks):
    """The gathered attention on the flash kernels' path (K4, K5/K6's
    plain versions) and the plain group norms on slabs: their outputs and
    gradients against the whole tensor's, within 1e-5 of the scale."""
    world, res, _, _ = ranks
    for rank in range(world):
        assert result(res, "spatial_attention", rank)["flash_path"] <= 1e-5
        errs = result(res, "spatial_plain_norms", rank)
        assert set(errs) == {"ln", "rms", "ln_plain", "pix"}
        assert max(errs.values()) <= 1e-5, errs
