"""Two training faults seen on the card, replayed on the CPU through both
packages from one initial state with the same draws, step by step.

    python -m tests._torch_fault_checks repro [--channels 128] [--batch 8]
        [--steps 30] [--nfe 18] [--samples 4]
    python -m tests._torch_fault_checks d --batch-seed S [--steps 23]
        [--channels 32] [--size 32]

``repro``: ``repro_reference_fid``'s training recipe (PUNetG at
``--channels`` with expansion [2, 4] on 28² images, EDM, AdamW lr 1e-3,
weight decay 1e-4, clip 0.5, power EMA [0.05, 0.1]) on the script's own
synthetic data, the JAX network's initial weights loaded into the port
(``convert.from_jax_variables``), σ and ε drawn with numpy and replayed
into both train steps; then ``--samples`` shared white noises through
both EMA networks' Heun ODE at ``--nfe`` steps
(``propagate_white_noise``). ``d``: configuration D's network (A's widths
at ``--channels``: PUNetG 3D, circular convolutions, ``cond_drop`` 0.1,
``PorosityEmbedder(32)``, the EDM batch norm) on one batch of
``chip_smoke.porous_volumes(--batch-seed)``, AdamW at its defaults, with
σ, ε and the condition-drop mask replayed.

Each step prints both losses and grad norms, max|Δ| of the parameters and
of the EMA shadows (or of the batch norm's running statistics) between
the packages, and the largest parameter; the sample printout gives each
package's max|x| and their max|Δ|. Imports the JAX package: test tooling,
not part of the port.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from diffsci_tpu_torch.convert import from_jax_variables  # noqa: E402
from tests._torch_scripts_util import port  # noqa: E402
from tests.test_torch_scripts_recipes import (  # noqa: E402
    _args, _jax_power_ema, _np, _quick_init, _t)


def _max_delta(ours: dict, theirs: dict) -> float:
    return max(float((ours[n].detach() - theirs[n]).abs().max())
               for n in ours)


def _largest(tensors: dict) -> float:
    return max(float(t.detach().abs().max()) for t in tensors.values())


def _edm_sigma(rng, n):
    # EDM's training σ: log σ ~ N(-1.2, 1.2²)
    return np.exp(rng.standard_normal(n) * 1.2 - 1.2).astype(np.float32)


def repro(channels=128, batch=8, steps=30, nfe=18, samples=4, seed=0):
    """Returns the rows (step, port loss, JAX loss, port grad norm, JAX
    grad norm, params max|Δ|, EMA max|Δ|, largest |param|) and the
    samples' (port max|x|, JAX max|x|, max|Δ|)."""
    from diffsci_tpu.models import KarrasModel as JKarrasModel
    from diffsci_tpu.models import KarrasModelConfig as JConfig
    from diffsci_tpu.models import PUNetG as JPUNetG
    from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig
    from diffsci_tpu.models import create_train_state as jcreate
    from diffsci_tpu.models import default_optimizer as jdefault
    from diffsci_tpu.models import make_train_step as jmake
    from diffsci_tpu_torch.models import create_train_state, make_train_step
    from diffsci_tpu_torch.scripts._common import use_weights

    script = port("repro_reference_fid")
    jmodel = JKarrasModel(JPUNetG(JPUNetGConfig(
        model_channels=channels, channel_expansion=[2, 4])),
        JConfig.from_edm())
    jema = _jax_power_ema([0.05, 0.1])
    jtx = jdefault(1e-3, 1e-4, grad_clip=0.5)
    x_shape = (batch, 28, 28, 1)
    with _quick_init():
        jstate, _ = jcreate(jmodel, jax.random.PRNGKey(0), x_shape,
                            ema=jema, optimizer=jtx)

    def jloss(variables, key, x, y, replay, train=True):
        return jmodel.loss_fn(variables, key, x, replay["sigma"], y=y,
                              train=train, eps=replay["eps"])

    jstep = jmake(jmodel, jtx, ema=jema, loss_fn=jloss)
    model, ema, tx = script.build(
        _args("repro_reference_fid", ["--channels", channels]), "cpu")
    model.net.load_state_dict(from_jax_variables(_np(jstate.variables())),
                              strict=True)
    state, tx = create_train_state(model, x_shape, seed=None, optimizer=tx,
                                   ema=ema)
    step = make_train_step(model, tx, ema=ema)
    data = script.load_mnist(None)
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(1, steps + 1):
        x = data[rng.choice(len(data), batch, replace=False)]
        sigma = _edm_sigma(rng, batch)
        eps = rng.standard_normal(x_shape).astype(np.float32)
        jstate, jmet = jstep(jstate, jax.random.PRNGKey(k), jnp.asarray(x),
                             None, {"sigma": jnp.asarray(sigma),
                                    "eps": jnp.asarray(eps)})
        state, met = step(state, _t(x), None, sigma=_t(sigma), eps=_t(eps))
        theirs = from_jax_variables(_np(jstate.variables()))
        their_ema = from_jax_variables(
            _np(jstate.ema_variables(jema, profile_index=0)))
        row = (k, float(met["train_loss"]), float(jmet["train_loss"]),
               float(met["grad_norm"]), float(jmet["grad_norm"]),
               _max_delta(state.params, theirs),
               _max_delta(state.ema_variables(ema, profile_index=0),
                          their_ema),
               _largest(state.params))
        rows.append(row)
        print("step %d: loss %.6g (JAX %.6g), grad norm %.6g (JAX %.6g), "
              "params max|Δ| %.3e, EMA max|Δ| %.3e, max|param| %.4g" % row,
              flush=True)

    noise = rng.standard_normal((samples, 28, 28, 1)).astype(np.float32)
    jx = np.asarray(jmodel.propagate_white_noise(
        jstate.ema_variables(jema, profile_index=0), jax.random.PRNGKey(0),
        jnp.asarray(noise), nsteps=nfe))
    use_weights(model, state.ema_variables(ema, profile_index=0))
    with torch.no_grad():
        x = model.propagate_white_noise(_t(noise), nsteps=nfe).numpy()
    out = (float(np.abs(x).max()), float(np.abs(jx).max()),
           float(np.abs(x - jx).max()))
    print("samples (%d at %d NFE, Heun): port max|x| %.6g, JAX max|x| "
          "%.6g, max|Δ| %.3e" % ((samples, nfe) + out), flush=True)
    return rows, out


def jax_variables_of(state_dict: dict, template, config=None):
    """The JAX variables (the tree of ``template``) whose
    ``from_jax_variables`` is ``state_dict``: every leaf filled once with
    its leaf number and once with its element numbers (exact in float32),
    converted, tells which JAX element each port element came from."""
    leaves, treedef = jax.tree.flatten(template)

    def convert(fill):
        return from_jax_variables(jax.tree.unflatten(treedef, [
            fill(i, np.asarray(leaf)) for i, leaf in enumerate(leaves)]),
            config)

    which = convert(lambda i, leaf: np.full(leaf.shape, i, np.float32))
    where = convert(lambda i, leaf: np.arange(
        leaf.size, dtype=np.float32).reshape(leaf.shape))
    out = [np.full(np.shape(leaf), np.nan, np.float32) for leaf in leaves]
    for name, ids in which.items():
        ids = ids.numpy().ravel().astype(np.int64)
        pos = where[name].numpy().ravel().astype(np.int64)
        vals = state_dict[name].detach().float().cpu().numpy().ravel()
        for i in np.unique(ids):
            sel = ids == i
            out[i].reshape(-1)[pos[sel]] = vals[sel]
    if any(np.isnan(o).any() for o in out):
        raise ValueError("a JAX leaf the port's state does not cover")
    return jax.tree.unflatten(treedef, [jnp.asarray(o) for o in out])


def d_check(batch_seed=0, steps=23, channels=32, size=32):
    """Configuration D's first ``steps`` steps on the batch of
    ``batch_seed`` through both packages in float32, from the port's
    ``init(0)`` (the card's initial state) with ``chip_smoke.d_draws``
    replayed. Returns the rows (step, port loss, JAX loss, port grad
    norm, JAX grad norm, params max|Δ|, running statistics max|Δ|,
    largest |param|) and both probes (before, after) of each package."""
    import chip_smoke
    import diffsci_tpu.models.nets.layers as jlayers
    from diffsci_tpu.models import KarrasModel as JKarrasModel
    from diffsci_tpu.models import KarrasModelConfig as JConfig
    from diffsci_tpu.models import create_train_state as jcreate
    from diffsci_tpu.models import default_optimizer as jdefault
    from diffsci_tpu.models import make_train_step as jmake
    from diffsci_tpu.models.nets import embedders as jemb
    from diffsci_tpu.models.nets import punetg as jpunetg
    from diffsci_tpu_torch import PUNetGConfig
    from diffsci_tpu_torch.models import (EMATracker, create_train_state,
                                          make_train_step)

    fields = dict(dimension=3, model_channels=channels,
                  channel_expansion=[2], num_heads=2, attn_backend="flash",
                  convolution_type="circular", cond_drop=0.1)
    n = 4
    x_shape = (n, size, size, size, 1)
    x, phi = chip_smoke.porous_volumes(n, size, batch_seed)
    (psig, peps), draws = chip_smoke.d_draws(batch_seed, steps, n, size)
    cfg = PUNetGConfig(**fields)
    model = chip_smoke.model_d(cfg, device="cpu", dtype=None)
    model.init(0)
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05],
                         update_every=4)
    state, tx = create_train_state(model, x_shape, seed=None, ema=tracker)
    step = make_train_step(model, tx, ema=tracker)

    jmodel = JKarrasModel(
        jpunetg.PUNetG(jpunetg.PUNetGConfig(**fields),
                       conditional_embedding=jemb.PorosityEmbedder(channels)),
        JConfig.from_edm(has_edm_batch_norm=True), conditional=True)
    jy = {"porosity": jnp.asarray(phi)}
    jema = _jax_power_ema([0.05], every=4)
    jtx = jdefault()
    with _quick_init():
        jstate, _ = jcreate(jmodel, jax.random.PRNGKey(0), x_shape, y=jy,
                            ema=jema, optimizer=jtx)
    jvars = jax_variables_of(model.net.state_dict(), jstate.variables(), cfg)
    params = jvars["params"]
    jstate = jstate.replace(
        params=params, consts={k: v for k, v in jvars.items()
                               if k != "params"},
        opt_state=jtx.init(params), ema=jema.init(params))
    replay_keep = {}

    def bernoulli(key, p, shape):
        # JAX's ConditionDrop draws its keep mask here: the replayed one
        return replay_keep["keep"].reshape(shape)

    def jloss(variables, key, xx, yy, replay, train=True):
        replay_keep["keep"] = replay["keep"]
        return jmodel.loss_fn(variables, key, xx, replay["sigma"], y=jy,
                              train=train, eps=replay["eps"])

    jstep = jmake(jmodel, jtx, ema=jema, loss_fn=jloss)
    y = {"porosity": _t(phi)}
    mean, var = (np.asarray(v.detach()) for v in
                 model.net.bnorm.batch_statistics(_t(x)))

    def probes():
        # the fixed draw, each batch norm on the batch's own statistics
        with torch.no_grad(), chip_smoke.batch_statistics_of(model, _t(x)):
            ours = float(model.loss_fn(_t(x), _t(psig), y, eps=_t(peps),
                                       train=False))
        jv = dict(jstate.variables())
        jv["batch_stats"] = {"bnorm": {"mean": jnp.asarray(mean),
                                       "var": jnp.asarray(var)}}
        theirs = float(jmodel.loss_fn(jv, jax.random.PRNGKey(0),
                                      jnp.asarray(x), jnp.asarray(psig),
                                      y=jy, train=False,
                                      eps=jnp.asarray(peps))[0])
        return ours, theirs

    before = probes()
    rows = []
    real = jlayers.jax.random.bernoulli
    try:
        jlayers.jax.random.bernoulli = bernoulli
        for k, (sig, eps, keep) in enumerate(draws, 1):
            jstate, jmet = jstep(jstate, jax.random.PRNGKey(k),
                                 jnp.asarray(x), jy,
                                 {"sigma": jnp.asarray(sig),
                                  "eps": jnp.asarray(eps),
                                  "keep": jnp.asarray(keep)})
            state, met = step(state, _t(x), y, sigma=_t(sig), eps=_t(eps),
                              keep=_t(keep))
            theirs = from_jax_variables(_np(jstate.variables()), cfg)
            sd = model.net.state_dict()
            row = (k, float(met["train_loss"]), float(jmet["train_loss"]),
                   float(met["grad_norm"]), float(jmet["grad_norm"]),
                   _max_delta(state.params, theirs),
                   max(float((sd[b] - theirs[b]).abs().max())
                       for b in ("bnorm.mean", "bnorm.var")),
                   _largest(state.params))
            rows.append(row)
            print("step %d: loss %.6g (JAX %.6g), grad norm %.6g (JAX "
                  "%.6g), params max|Δ| %.3e, batch norm max|Δ| %.3e, "
                  "max|param| %.4g" % row, flush=True)
    finally:
        jlayers.jax.random.bernoulli = real
    after = probes()
    print("probe (fixed draw, the batch's own statistics): port %.6g -> "
          "%.6g, JAX %.6g -> %.6g" % (before[0], after[0], before[1],
                                       after[1]), flush=True)
    return rows, before, after


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("which", choices=("repro", "d"))
    ap.add_argument("--channels", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--nfe", type=int, default=18)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--batch-seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=32)
    args = ap.parse_args(argv)
    if args.which == "repro":
        repro(args.channels or 128, args.batch, args.steps or 30, args.nfe,
              args.samples)
    else:
        d_check(args.batch_seed, args.steps or 23, args.channels or 32,
                args.size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
