"""The cases of ``tests/test_torch_pipeline.py`` that run in each gloo rank
(``tests/_torch_ranks.py``; torch only, no JAX)."""

from __future__ import annotations

import numpy as np
import torch

from diffsci_tpu_torch.models.nets.dit import DiffusionTransformer
from diffsci_tpu_torch.parallel import make_mesh, pipeline_apply
from diffsci_tpu_torch.parallel.pipeline import (make_dit_pipeline,
                                                 merge_dit_variables,
                                                 shard_stacked_params,
                                                 split_dit_variables)
from tests._torch_ranks import cases

NBLOCKS = 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _dit(p):
    net = DiffusionTransformer(nembed=32, nheads=2, nblocks=NBLOCKS,
                               patch_size=4, nchannels=1, device="cpu")
    net.load_state_dict({k: _t(v) for k, v in p["dit"].items()})
    return net


def _variables(net, grad=False):
    tensors = dict(net.named_parameters())
    names = set(tensors)
    tensors.update(net.named_buffers())
    return {k: v.detach().clone().requires_grad_(grad and k in names)
            for k, v in tensors.items()}


def _mesh(world, dp):
    if dp:
        return make_mesh(axes=("data", "stage"), shape=(world // 2, 2),
                         device_type="cpu")
    return make_mesh(axes=("stage",), device_type="cpu")


def case_forward(rank, world, p):
    net = _dit(p)
    x, t = _t(p["x"]), _t(p["t"])
    out = {}
    for name, dp, n_micro in (("pp", False, 4), ("dp_pp", True, 2),
                              ("one_micro", False, 1)):
        mesh = _mesh(world, dp)
        forward, _ = make_dit_pipeline(net, mesh, n_micro=n_micro,
                                       data_axis="data" if dp else None)
        rest, stacked, _ = split_dit_variables(_variables(net), NBLOCKS)
        stacked = shard_stacked_params(stacked, mesh)
        with torch.no_grad():
            out[name] = forward(rest, stacked, x, t).numpy()
    return out


def case_backward(rank, world, p):
    """Gradients through the schedule: of a stage's chunk, of a whole
    stack, and of the embedding and head."""
    net = _dit(p)
    mesh = _mesh(world, False)
    x, t = _t(p["x"])[:4], _t(p["t"])[:4]
    forward, names = make_dit_pipeline(net, mesh, n_micro=2)
    out = {}
    for whole in (False, True):
        rest, stacked, _ = split_dit_variables(_variables(net, True),
                                               NBLOCKS)
        stacked = {k: v.detach().requires_grad_() for k, v in
                   stacked.items()}
        if not whole:
            stacked = shard_stacked_params(stacked, mesh)
        loss = (forward(rest, stacked, x, t) ** 2).mean()
        loss.backward()
        out[whole] = ({k: v.grad.numpy() for k, v in rest.items()
                       if v.grad is not None},
                      {k: v.grad.numpy() for k, v in stacked.items()})
    rest, stacked, _ = split_dit_variables(_variables(net), NBLOCKS)
    merged = merge_dit_variables(rest, stacked, names)
    out["roundtrip"] = all(torch.equal(merged[k], v)
                           for k, v in _variables(net).items())
    return out


def case_train_steps(rank, world, p):
    """Two SGD steps on the dp × pp pipeline: the loss goes down."""
    net = _dit(p)
    mesh = _mesh(world, True)
    x, t = _t(p["x"]), _t(p["t"])
    forward, _ = make_dit_pipeline(net, mesh, n_micro=2, data_axis="data")
    rest, stacked, _ = split_dit_variables(_variables(net, True), NBLOCKS)
    stacked = shard_stacked_params(stacked, mesh)
    losses = []
    for _ in range(2):
        loss = (forward(rest, stacked, x, t) ** 2).mean()
        loss.backward()
        losses.append(float(loss))
        with torch.no_grad():
            for v in list(rest.values()) + list(stacked.values()):
                if v.grad is not None:
                    v -= 0.1 * v.grad
                    v.grad = None
    return losses


def case_errors(rank, world, p):
    mesh = _mesh(world, False)
    out = {}
    five = {"w": torch.zeros(5, 3, 3)}
    try:
        pipeline_apply(lambda q, a, c: a, five, torch.zeros(8, 2, 3),
                       torch.zeros(8, 3), mesh, n_micro=2)
    except ValueError as e:
        out["blocks"] = "not divisible" in str(e)
    four = {"w": torch.zeros(4, 3, 3)}
    try:
        pipeline_apply(lambda q, a, c: a, four, torch.zeros(8, 2, 3),
                       torch.zeros(8, 3), mesh, n_micro=3)
    except ValueError as e:
        out["batch"] = "not divisible" in str(e)
    return out


def case_sampling(rank, world, p):
    """EDM Heun sampling with the denoiser on the dp × pp pipeline."""
    from diffsci_tpu_torch.ops.schedulers import EDMScheduler
    net = _dit(p)
    mesh = _mesh(world, True)
    forward, _ = make_dit_pipeline(net, mesh, n_micro=2, data_axis="data")
    rest, stacked, _ = split_dit_variables(_variables(net), NBLOCKS)
    stacked = shard_stacked_params(stacked, mesh)

    def score(xt, sigma):
        d = forward(rest, stacked, xt, sigma)
        return (d - xt) / sigma.reshape(-1, 1, 1, 1) ** 2

    with torch.no_grad():
        return EDMScheduler().propagate_backward(_t(p["x0"]), score,
                                                 nsteps=4).numpy()


def case_generic(rank, world, p):
    mesh = _mesh(world, False)
    stacked = {"w": _t(p["gw"]), "b": _t(p["gb"])}

    def block_apply(q, tok, emb):
        return tok + torch.tanh(tok @ q["w"] + q["b"] + emb[:, None])

    with torch.no_grad():
        return pipeline_apply(block_apply, stacked, _t(p["gx"]),
                              _t(p["gte"]), mesh, n_micro=4).numpy()


CASES = {"forward": case_forward, "backward": case_backward,
         "train_steps": case_train_steps, "errors": case_errors,
         "sampling": case_sampling, "generic": case_generic}


def run(rank, world, payload):
    return cases(CASES, rank, world, payload)
