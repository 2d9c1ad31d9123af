"""FSDP as the JAX package shards it (weights gathered layer by layer,
gradients reduce-scattered into the blocks; ``parallel/fsdp.py``),
alone and composed with tensor parallelism: gloo ranks on the CPU at
world 2 and 4 (``tests/_torch_fsdp_cases.py``) against the JAX package's
single-device step and against the port's single-process step.

The contract is GSPMD's: a placed step gives the single-device result, at
``tests/test_parallel.py``'s bounds (loss rtol 1e-5, parameters rtol 1e-4
atol 1e-6):
- FSDP∘TP (``shard_state_fsdp(..., tensor_axis="tensor")``) on a (world /
  2, 2) data × tensor mesh against JAX's single-device step of an MLP
  [128, 128] (``test_parallel.py:259-290``'s sizes), with the spec check
  that no axis is reused and that a tensor takes both;
- a small PUNetG (convolutions, bottleneck attention) over two steps:
  between steps its network's parameters hold exactly the blocks and the
  unsharded tensors, AdamW's moments their blocks, and the backward
  gathers the weights again (autograd saved the blocks); the same net
  under FSDP∘TP with its convolutions and the attention's ``out_proj``
  column-parallel;
- the collective order: a sharded layer that the loss never reaches,
  ``remat`` (whose recomputation keeps no gathered weight: the backward
  gathers again), and two micro-steps under ``accumulate_gradients``;
- a sharded parameter read or written through its module attribute
  outside the network's forward raises;
- samples (f32, and the bf16 cast copy of the blocks; ``sample`` on
  every rank, ``sample(mesh=)`` and ``SamplerService(mesh=)`` with rank 0
  serving) and the eval loss from an FSDP-placed model against the
  single-process model's (1e-5 / 1e-6);
- the magnitude-preserving re-projection on blocks against the whole
  tensors' (rtol 1e-5, atol 1e-7: ``tests/test_torch_mp.py``'s), and E's
  options stepped under FSDP;
- ``Trainer(mesh=)`` over FSDP∘TP: its log, and checkpoints of whole
  tensors restored at world N (bit for bit) and at world 1;
- the ensemble and distill steps on an FSDP state; the VAE state refuses
  FSDP;
- FSDP over an expert-parallel state (``shard_state_expert_parallel``
  then ``shard_state_fsdp(..., existing_specs=state.placement.specs)``)
  on a (world / 2, 2) data × expert mesh of a small MoE-DiT (4 experts):
  its specs those of JAX's ``fsdp_specs(existing_specs=
  expert_parallel_specs(...))`` under the converter's names, one step
  against the single-process step and JAX's single-device step, dp × ep
  and ep alone beside it, a checkpoint of whole tensors, and FSDP over
  an axis it does not compose with raising.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from diffsci_tpu.models import KarrasModel as JKarrasModel
from diffsci_tpu.models import KarrasModelConfig as JKarrasModelConfig
from diffsci_tpu.models import MLPUncond as JMLPUncond
from diffsci_tpu.models import create_train_state as jcreate_train_state
from diffsci_tpu.models import make_train_step as jmake_train_step
from diffsci_tpu.models.nets.moe import \
    MoEDiffusionTransformer as JMoEDiffusionTransformer
from diffsci_tpu.parallel import expert_parallel_specs as jep_specs
from diffsci_tpu.parallel import fsdp_specs as jfsdp_specs
from diffsci_tpu.parallel import make_mesh as jmake_mesh

from diffsci_tpu_torch.convert import from_jax_variables
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)
from tests import _torch_fsdp_cases as fc
from tests import _torch_steps as steps
from tests._torch_ranks import result, run_ranks

B = 32


def _sd(variables):
    return {k: v.numpy() for k, v in from_jax_variables(
        jax.tree.map(np.asarray, variables)).items()}


class _JitInit:
    """A JAX model whose ``init`` runs jitted (flax's runs op by op)."""

    def __init__(self, model):
        self.model = model

    def init(self, key, x_shape, y=None):
        return jax.jit(self.model.init, static_argnums=1)(key, x_shape)


def _jax_mlp_step(hidden, x, sigma, eps):
    """One JAX train step (default AdamW + clip) of an MLP from the init
    of key 0, σ and ε replayed: (the init's state dict, (loss, norm, the
    stepped state dict))."""
    jmodel = JKarrasModel(JMLPUncond(dim=2, hidden_dims=hidden),
                          JKarrasModelConfig.from_edm(loss_metric="mse"))
    jstate, jtx = jcreate_train_state(_JitInit(jmodel),
                                      jax.random.PRNGKey(0), (8, 2))

    def jloss(variables, key, xx, y, replay, train=True):
        return jmodel.loss_fn(variables, key, xx, replay["sigma"],
                              train=train, eps=replay["eps"])

    weights = _sd(jstate.variables())
    jstate, met = jmake_train_step(jmodel, jtx, loss_fn=jloss)(
        jstate, jax.random.PRNGKey(2), jnp.asarray(x), None,
        {"sigma": jnp.asarray(sigma), "eps": jnp.asarray(eps)})
    return weights, (float(met["train_loss"]), float(met["grad_norm"]),
                     _sd(jstate.variables()))


def _jax_moe(x, sigma, eps):
    """JAX's side of the FSDP∘EP cases: the small MoE-DiT's init (key 0),
    one single-device step of it (the pins' AdamW in optax, σ and ε
    replayed) and, for each world size, the specs of
    ``fsdp_specs(existing_specs=expert_parallel_specs(...))`` on a
    (world / 2, 2) data × expert mesh, by the port's names of the leaves
    the converter maps one to one (the attention's packed projections
    have no JAX leaf of their own). Returns (the init's state dict, the
    reference step, world -> name -> (spec, JAX shape))."""
    jmodel = JKarrasModel(JMoEDiffusionTransformer(**fc.MOE),
                          JKarrasModelConfig.from_edm(loss_metric="mse"))
    opt = optax.chain(optax.clip_by_global_norm(0.5),
                      optax.adamw(1e-3, b1=0.9, b2=0.999,
                                  eps=steps.PIN_ADAM_EPS, weight_decay=1e-4))
    jstate, jtx = jcreate_train_state(_JitInit(jmodel), jax.random.PRNGKey(0),
                                      x.shape, optimizer=opt)
    variables = jax.tree.map(np.asarray, jstate.variables())
    weights = _sd(variables)

    def jloss(v, key, xx, y, replay, train=True):
        return jmodel.loss_fn(v, key, xx, replay["sigma"], train=train,
                              eps=replay["eps"])

    stepped, met = jmake_train_step(jmodel, jtx, loss_fn=jloss)(
        jstate, jax.random.PRNGKey(2), jnp.asarray(x), None,
        {"sigma": jnp.asarray(sigma), "eps": jnp.asarray(eps)})
    ref = (float(met["train_loss"]), float(met["grad_norm"]),
           _sd(stepped.variables()))
    # which JAX leaf each port tensor is: every leaf filled with its index
    params = variables["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    marked = jax.tree_util.tree_unflatten(
        tree, [np.full(a.shape, i, np.float32) for i, a in enumerate(leaves)])
    owner = {}
    for name, t in from_jax_variables({**variables,
                                       "params": marked}).items():
        ids = np.unique(t.numpy())
        if len(ids) == 1 and sorted(t.shape) == sorted(
                leaves[int(ids[0])].shape):
            owner[name] = int(ids[0])
    specs = {}
    for world in (2, 4):
        mesh = jmake_mesh(world, axes=fc.TOKENS, shape=(world // 2, 2))
        flat = jax.tree_util.tree_leaves(
            jfsdp_specs(params, mesh, min_elements=fc.MIN,
                        existing_specs=jep_specs(params, mesh)),
            is_leaf=lambda a: isinstance(a, jax.sharding.PartitionSpec))
        specs[world] = {name: (tuple(flat[i]), leaves[i].shape)
                        for name, i in owner.items()}
    return weights, ref, specs


def _port_weights(make, seed):
    model = make()
    model.init(seed)
    return {k: v.numpy().copy() for k, v in model.net.state_dict().items()}


@pytest.fixture(scope="module")
def payloads():
    rng = np.random.default_rng(0)
    p = dict(
        x=rng.standard_normal((B, 2)).astype(np.float32),
        sigma=np.exp(rng.standard_normal((2, B)) * 1.2 - 1.2).astype(
            np.float32),
        eps=rng.standard_normal((2, B, 2)).astype(np.float32),
        px=rng.standard_normal((4, 16, 16, 1)).astype(np.float32),
        psigma=np.exp(rng.standard_normal((2, 4)) - 1.0).astype(np.float32),
        peps=rng.standard_normal((2, 4, 16, 16, 1)).astype(np.float32))
    ref = {}
    p["mlp128"], ref["fsdp_tp"] = _jax_mlp_step([128, 128], p["x"],
                                                p["sigma"][0], p["eps"][0])
    p["mlp"] = _port_weights(lambda: _bare_mlp([64, 64]), 1)
    ens = steps.ensemble_model()
    ens.init(0)
    H, S, E = 8, 2, 2
    p["ens"] = dict(
        sd={k: v.numpy().copy() for k, v in ens.net.state_dict().items()},
        x=rng.normal(size=(4, H, H, S)).astype(np.float32),
        ywin=rng.normal(size=(4, 2, H, H)).astype(np.float32),
        sigma=np.exp(rng.normal(size=(S, 4)) * 1.2 - 1.2).astype(
            np.float32),
        eps=rng.normal(size=(S, 4, E, H, H, 1)).astype(np.float32),
        x_T=rng.normal(size=(S - 1, 4, H, H, 1)).astype(np.float32))
    p["mx"] = rng.standard_normal((8, 8, 8, 1)).astype(np.float32)
    p["msigma"] = np.exp(rng.standard_normal(8) * 1.2 - 1.2).astype(
        np.float32)
    p["meps"] = rng.standard_normal((8, 8, 8, 1)).astype(np.float32)
    p["moe"], ref["moe"], ref["moe_specs"] = _jax_moe(p["mx"], p["msigma"],
                                                      p["meps"])
    distill = lambda: _bare_mlp([16])  # noqa: E731
    p["distill"] = dict(sd=_port_weights(distill, 1),
                        teacher=_port_weights(distill, 2),
                        x=rng.standard_normal((8, 2)).astype(np.float32),
                        idx=rng.integers(0, 3, 8),
                        eps=rng.standard_normal((8, 2)).astype(np.float32))
    return p, ref


def _bare_mlp(hidden):
    from diffsci_tpu_torch import KarrasModel, KarrasModelConfig
    from diffsci_tpu_torch.models.nets.mlp import MLPUncond
    return KarrasModel(MLPUncond(2, hidden, device="cpu"),
                       KarrasModelConfig.from_edm(loss_metric="mse"),
                       device="cpu")


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, payloads, tmp_path_factory):
    p, ref = payloads
    p = dict(p, ckpt_dir=str(tmp_path_factory.mktemp("ckpt")))
    return request.param, run_ranks("tests._torch_fsdp_cases",
                                    request.param, p), p, ref


def _close(out, ref, label=""):
    loss, norm, params = ref
    np.testing.assert_allclose(out["loss"], loss, rtol=1e-5, err_msg=label)
    if norm is not None:
        np.testing.assert_allclose(out["norm"], norm, rtol=1e-4,
                                   err_msg=label)
    assert set(out["params"]) <= set(params)
    for name, value in out["params"].items():
        np.testing.assert_allclose(value, params[name], rtol=1e-4,
                                   atol=1e-6, err_msg=f"{label} {name}")


def _identity(state):
    return state


def _same(a):
    return a


def test_fsdp_composed_with_tensor_parallelism_matches_jax(ranks):
    world, res, _, ref = ranks
    for rank in range(world):
        out = result(res, "fsdp_tp", rank)
        both = 0
        for name, spec in out["specs"].items():
            axes = [a for a in spec if a is not None]
            assert len(axes) == len(set(axes)), (name, spec)
            both += set(axes) == {"data", "tensor"}
        assert both >= 1
        # [128, 128]: rows over tensor, columns over data
        assert out["specs"]["model.net.2.weight"] == ("tensor", "data")
        assert out["local"]["model.net.2.weight"] == (64, 128 // (world // 2))
        _close(out, ref["fsdp_tp"])


def test_fsdp_holds_blocks_and_gathers_layer_by_layer(ranks):
    """Two PUNetG steps against the single-process steps; between steps
    the network's parameters hold the blocks and the unsharded tensors
    (a count of bytes), and the backward gathers again."""
    world, res, p, _ = ranks
    single = fc.punet_steps(p, _identity, _same)
    for rank in range(world):
        out = result(res, "punet", rank)
        _close(out, (single["loss"], single["norm"], single["params"]))
        sharded = set(out["sharded"])
        assert len(sharded) >= 10
        want = sum(b // world if k in sharded else b
                   for k, b in out["whole"].items())
        assert out["held"] == want < sum(out["whole"].values())
        assert out["moments"] == 2 * want
        # the forward gathers each sharded weight once a step, the
        # backward again each that autograd saved
        forward = out["gathers"] - out["regathers"]
        assert forward >= 2 * len(sharded)
        assert out["regathers"] >= forward // 2


def test_fsdp_tp_punetg_with_column_parallel_attention(ranks):
    """FSDP∘TP of the small PUNetG with its convolutions and the
    attention's out_proj column-parallel (the attention calls out_proj as
    a module, so its column-parallel forward runs): the single-process
    steps."""
    world, res, p, _ = ranks
    single = fc.punet_steps(p, _identity, _same)
    for rank in range(world):
        out = result(res, "punet_tp", rank)
        assert "model.attn_block.0.mhattn.out_proj.weight" in out["tp"]
        assert len(out["tp"]) >= 10
        _close(out, (single["loss"], single["norm"], single["params"]))


def test_fsdp_collective_order_unused_layer_remat_accumulation(ranks):
    world, res, p, _ = ranks
    single = fc.order_steps(p, _identity, _same)
    for rank in range(world):
        out = result(res, "order", rank)
        for label, ref in single.items():
            np.testing.assert_allclose(out[label]["losses"], ref["losses"],
                                       rtol=1e-5, err_msg=label)
            _close(dict(out[label], loss=out[label]["losses"][-1]),
                   (ref["losses"][-1], ref["norm"], ref["params"]), label)


def test_fsdp_remat_recomputation_keeps_blocks(ranks):
    """Under ``remat`` the checkpoint's recomputation hands the gathered
    weights to FSDP's hooks, which keep their blocks: the backward gathers
    each saved weight again, where the recomputation would otherwise hold
    every gathered weight at once."""
    world, res, _, _ = ranks
    for rank in range(world):
        out = result(res, "order", rank)["remat"]
        # the MLP's three sharded weights gathered in the forward and in
        # the recomputation; the two that autograd saves (the first
        # layer's input needs no gradient) again in the backward
        assert out["regathers"] >= 2
        assert out["gathers"] >= 2 * 3 + out["regathers"]


def test_fsdp_parameter_reads_outside_the_forward_raise(ranks):
    world, res, _, _ = ranks
    for rank in range(world):
        out = result(res, "reads", rank)
        for label in ("read", "init", "model_init"):
            assert "held as FSDP blocks" in out[label], (label, out[label])


def test_sample_and_eval_from_an_fsdp_placed_model(ranks):
    world, res, p, _ = ranks
    single = fc.sample_and_eval(p)
    for rank in range(world):
        out = result(res, "sample", rank)
        for key, value in single.items():
            if out[key] is None:       # a follower of the mesh service
                assert rank and key.endswith("service")
                continue
            for got in (out[key], out.get(key + " mesh", out[key])):
                np.testing.assert_allclose(got, value, rtol=1e-5, atol=1e-6,
                                           err_msg=key)


def test_mp_renormalization_on_blocks(ranks):
    world, res, p, _ = ranks
    for rank in range(world):
        out = result(res, "mp_renorm", rank)
        assert set(out[True]) == set(out[False])
        for name, value in out[True].items():
            np.testing.assert_allclose(value, out[False][name], rtol=1e-5,
                                       atol=1e-7, err_msg=name)
    single = fc.mp_steps(p, _identity, _same)
    for rank in range(world):
        out = result(res, "mp", rank)
        assert 0 in out["dims"] and len(out["dims"]) >= 2
        _close(out, (single["loss"], single["norm"], single["params"]))


def test_fsdp_tp_checkpoints_restore_at_world_n_and_1(ranks, tmp_path):
    from diffsci_tpu_torch.checkpoint import gather_state, restore_checkpoint
    world, res, p, _ = ranks
    state, log, fresh = fc.checkpoint_run(p, None, str(tmp_path / "single"))
    single = {k: v.numpy() for k, v in gather_state(state).items()}
    out = result(res, "checkpoint")
    assert any("valid_loss" in row for row in log)
    assert len(out["log"]) == len(log)
    for row, ref_row in zip(out["log"], log):
        for key in ("train_loss", "grad_norm", "valid_loss"):
            if key in ref_row:
                np.testing.assert_allclose(row[key], ref_row[key],
                                           rtol=1e-5, err_msg=key)
    assert set(out["again"]) == set(out["live"]) == set(single)
    for name, value in out["live"].items():
        np.testing.assert_array_equal(out["again"][name], value,
                                      err_msg=name)
    restore_checkpoint(out["directory"], fresh)
    for name, value in gather_state(fresh).items():
        np.testing.assert_allclose(value.numpy(), single[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", ["ensemble_step", "distill_step"])
def test_placed_steps_take_an_fsdp_state(ranks, name):
    world, res, p, _ = ranks
    key = {"ensemble_step": "ens", "distill_step": "distill"}[name]
    ref = getattr(steps, name)(p[key], _identity, _same)
    for rank in range(world):
        out = result(res, "placed_steps", rank)
        assert out["vae_raises"]
        _close(out[name], (ref["loss"], ref["norm"], ref["params"]), name)


def _axis_sizes(spec, shape) -> dict:
    """axis -> the whole size of the dim a spec shards over it."""
    return {a: shape[d] for d, a in enumerate(spec) if a is not None}


def test_fsdp_over_expert_parallelism_matches_jax(ranks):
    """FSDP∘EP on a (world / 2, 2) data × expert mesh. Specs: for every
    tensor that the converter maps from one JAX leaf, each axis shards a
    dim of the same size as in JAX's specs (the layouts differ, and on
    ties the packages may take either of two equal dims: ``fsdp.py``'s
    docstring); every expert tensor over both axes. Steps (bounds of
    ``test_fsdp_train_step_matches_jax``: loss rtol 1e-5, norm rtol
    1e-4, parameters rtol 1e-4 atol 1e-6): FSDP∘EP, dp × ep and ep on a
    1D expert mesh against the single-process port step and JAX's
    single-device step. An FSDP∘EP rank holds its blocks of the
    parameters and moments (at world 4 fewer bytes than dp × ep); its
    checkpoint holds whole tensors."""
    world, res, p, ref = ranks
    single = fc.moe_step(p, _identity, _same)
    jspecs = ref["moe_specs"][world]
    assert len(jspecs) >= 10
    for rank in range(world):
        out = result(res, "fsdp_ep", rank)
        specs = out["fsdp_ep"]["specs"]
        experts = [k for k in specs if ".experts_" in k]
        assert len(experts) == 4
        for name in experts:
            assert set(specs[name]) - {None} == {"data", "expert"}, name
        for name, (jspec, jshape) in jspecs.items():
            shape = single["params"][name].shape
            assert _axis_sizes(specs.get(name, ()), shape) == \
                _axis_sizes(jspec, jshape), (name, specs.get(name), jspec)
        for label in ("fsdp_ep", "ep", "ep_1d"):
            _close(out[label], (single["loss"], single["norm"],
                                single["params"]), label)
            _close(out[label], ref["moe"], label + " jax")
        # a rank holds each tensor's block: its whole bytes over the
        # ranks of the axes its spec takes
        sizes = {"data": world // 2, "expert": 2}
        want = sum(v.nbytes // int(np.prod(
            [sizes[a] for a in specs.get(k, ()) if a]))
            for k, v in single["params"].items())
        assert out["fsdp_ep"]["held"] == want
        assert out["fsdp_ep"]["moments"] == 2 * want
        if world == 4:
            assert want < out["ep"]["held"]
        name = experts[0]
        assert out["fsdp_ep"]["local"][name][0] == 2
        saved = out["fsdp_ep"]["saved"]
        assert set(saved) == set(single["params"])
        for k, v in saved.items():
            np.testing.assert_array_equal(v, out["fsdp_ep"]["params"][k],
                                          err_msg=k)
        assert "compose" in out["raises"]
