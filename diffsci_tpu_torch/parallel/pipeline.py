"""Pipeline parallelism (GPipe) over a ``stage`` axis.

Port of ``diffsci_tpu/parallel/pipeline.py``. The per-block parameters
of a uniform block stack are stacked on a leading [nblocks] dim, each
rank of a ``stage`` line keeps its contiguous chunk of blocks, and the
batch goes through in ``n_micro`` microbatches on the GPipe schedule:
- tick t: stage 0 takes microbatch t (while t < n_micro), every stage
  whose microbatch t − s exists applies its blocks to the activation it
  holds (an idle stage passes it on unchanged: a multi-controller
  pipeline need not compute the bubble that SPMD masks), and the
  activations move one stage on around the ring (``batch_isend_irecv``
  over the line);
- the last stage keeps microbatch t − (n_stages − 1) on the ticks it
  emits one; n_micro + n_stages − 1 ticks in all;
- the last stage's outputs are broadcast over the line, so every rank
  returns the whole result.
Backward flows through the same schedule: each tick's exchange is an
autograd function whose backward sends the gradients the other way round
the ring, so ``loss.backward()`` on every rank of the line (the same
loss) gives each stage its blocks' gradients and every rank the
embedding's and head's. The conditioning rides along whole; its
gradient, a sum over the stages, is summed over the line.

With ``data_axis`` the microbatches' rows are split over that axis as
well (dp × pp): the output is gathered over it, and every parameter's
gradient is summed over it.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from diffsci_tpu_torch.parallel.mesh import axis_size, constrain_batch

STAGE_AXIS = "stage"


def stack_block_params(params: dict, block_names: Sequence[str]):
    """Split a model's tensors by name into (stacked_blocks, rest):
    ``stacked_blocks`` maps each name within a block to the blocks'
    tensors stacked on a new leading [nblocks] dim; ``rest`` is every
    other tensor (the embedding and the head), which stays whole."""
    first = block_names[0] + "."
    inner = [k[len(first):] for k in params if k.startswith(first)]
    stacked = {k: torch.stack([params[f"{b}.{k}"] for b in block_names])
               for k in inner}
    prefixes = tuple(b + "." for b in block_names)
    rest = {k: v for k, v in params.items() if not k.startswith(prefixes)}
    return stacked, rest


def unstack_block_params(stacked: dict, rest: dict,
                         block_names: Sequence[str]) -> dict:
    """The inverse of ``stack_block_params``: the flat dict by name
    (e.g. to load a pipeline-trained model's state dict)."""
    params = dict(rest)
    for i, b in enumerate(block_names):
        for k, v in stacked.items():
            params[f"{b}.{k}"] = v[i]
    return params


class StageBlocks(dict):
    """One stage's chunk of a stacked block dict (``shard_stacked_params``):
    ``nblocks`` is the whole stack's count."""
    nblocks: int = 0


def shard_stacked_params(stacked: dict, mesh,
                         stage_axis: str = STAGE_AXIS) -> StageBlocks:
    """This rank's contiguous chunk of the stacked blocks (leaf tensors
    of their own, so they take gradients); ``pipeline_apply`` takes the
    chunk or the whole stack."""
    n = axis_size(mesh, stage_axis)
    nblocks = next(iter(stacked.values())).shape[0]
    _check_blocks(nblocks, n)
    k, s = nblocks // n, mesh.get_local_rank(stage_axis)
    out = StageBlocks({name: v[s * k:(s + 1) * k].detach().clone()
                       .requires_grad_(v.requires_grad)
                       for name, v in stacked.items()})
    out.nblocks = nblocks
    return out


def _check_blocks(nblocks: int, n_stages: int) -> None:
    if nblocks % n_stages:
        raise ValueError(f"{nblocks} blocks not divisible by {n_stages} "
                         f"stages")


class _SumGrad(torch.autograd.Function):
    """Identity on the inputs; each gradient summed over ``group``."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = []
        for g in gs:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None,) + tuple(out)


def sum_grads(group, *xs):
    """``xs`` unchanged, with their gradients summed over ``group``."""
    return _SumGrad.apply(group, *xs)


class _Ring(torch.autograd.Function):
    """Send x to the next stage and take the previous one's; backward
    sends the gradient back and takes the next one's."""

    @staticmethod
    def forward(ctx, x, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _exchange(x.contiguous(), group, nxt, prv)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.group, ctx.prv, ctx.nxt), \
            None, None, None


def _exchange(x, group, to: int, frm: int):
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, to, group),
           dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Tie(torch.autograd.Function):
    """``a`` unchanged, with ``b`` tied to it: backward gives ``b`` a
    zero gradient, so that the ring that made ``b`` runs its backward
    exchanges on every rank, in the order of the ticks."""

    @staticmethod
    def forward(ctx, a, b):
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(g)


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every rank of the line (a broadcast);
    backward gives the last stage the gradient of the one loss that every
    rank computes, and the others none; ``buf`` (the ring's end) is tied
    in as ``_Tie`` ties it."""

    @staticmethod
    def forward(ctx, outs, buf, group, src: int, last: bool):
        ctx.last = last
        outs = outs.contiguous().clone()
        dist.broadcast(outs, src=src, group=group)
        return outs

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), \
            torch.zeros_like(g[0]), None, None, None


def _gather_rows(x, group, n: int, rank: int):
    from diffsci_tpu_torch.parallel.tensor_parallel import _GatherLine
    return _GatherLine.apply(x, 0, group, n, rank)


def pipeline_apply(block_apply: Callable, stacked: dict, tokens, te, mesh,
                   *, n_micro: int, stage_axis: str = STAGE_AXIS,
                   data_axis: str | None = None):
    """Apply a stack of uniform blocks to ``tokens`` on the GPipe schedule
    over ``stage_axis`` (module docstring).

    ``block_apply(block_params, tokens, te) -> tokens`` applies one block
    (``block_params``: name -> one block's tensor). ``stacked``: the
    whole stack ([nblocks, ...], n_stages must divide nblocks) or this
    stage's chunk (``shard_stacked_params``). ``tokens`` / ``te``: the
    whole batch on every rank, split into ``n_micro`` equal microbatches;
    with ``data_axis``, each rank's rows over that axis first. Returns
    the whole result on every rank."""
    group = mesh.get_group(stage_axis)
    n, s = axis_size(mesh, stage_axis), mesh.get_local_rank(stage_axis)
    nblocks = stacked.nblocks if isinstance(stacked, StageBlocks) \
        else next(iter(stacked.values())).shape[0]
    _check_blocks(nblocks, n)
    whole = not isinstance(stacked, StageBlocks)
    if data_axis is not None:
        dgroup = mesh.get_group(data_axis)
        stacked = dict(zip(list(stacked),
                           sum_grads(dgroup, *stacked.values())))
        tokens = constrain_batch(tokens, mesh, data_axis)
        te = constrain_batch(te, mesh, data_axis)
    B = tokens.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    mb = B // n_micro
    # the conditioning's gradient is summed over the stages, the tokens'
    # taken from stage 0; the ring starts from buf, whose gradient is
    # ready last, so each rank sums after its ring's backward
    buf = torch.zeros((mb,) + tuple(tokens.shape[1:]), dtype=tokens.dtype,
                      device=tokens.device,
                      requires_grad=torch.is_grad_enabled())
    names = list(stacked)
    if n > 1:
        # a whole stack's gradient is its chunks' (each on its stage)
        tokens, te, buf, *values = sum_grads(
            group, tokens, te, buf, *(stacked.values() if whole else ()))
        if whole:
            stacked = dict(zip(names, values))
    if whole:
        k = nblocks // n
        stacked = {name: v[s * k:(s + 1) * k] for name, v in
                   stacked.items()}
    tok_mb = tokens.reshape(n_micro, mb, *tokens.shape[1:])
    te_mb = te.reshape(n_micro, mb, *te.shape[1:])
    local = next(iter(stacked.values())).shape[0]

    def apply_stage(x, c):
        for i in range(local):
            x = block_apply({name: v[i] for name, v in stacked.items()}, x, c)
        return x

    nxt = dist.get_global_rank(group, (s + 1) % n)
    prv = dist.get_global_rank(group, (s - 1) % n)
    outs = [None] * n_micro
    for t in range(n_micro + n - 1):
        m = t - s
        x_in = _Tie.apply(tok_mb[t], buf) if s == 0 and t < n_micro \
            else buf
        y = apply_stage(x_in, te_mb[m]) if 0 <= m < n_micro else x_in
        if s == n - 1 and 0 <= m < n_micro:
            outs[m] = y
        buf = _Ring.apply(y, group, nxt, prv) if n > 1 else y
    outs = torch.stack([o if o is not None else torch.zeros_like(buf)
                        for o in outs])
    out = _FromLast.apply(outs, buf, group,
                          dist.get_global_rank(group, n - 1), s == n - 1) \
        if n > 1 else outs
    out = out.reshape(B, *out.shape[2:])
    if data_axis is not None:
        out = _gather_rows(out, mesh.get_group(data_axis),
                           axis_size(mesh, data_axis),
                           mesh.get_local_rank(data_axis))
    return out


def split_dit_variables(variables: dict, nblocks: int):
    """Split a ``DiffusionTransformer``'s tensors by name (parameters and
    buffers) into ``(rest, stacked_blocks, block_names)``: the stacked
    ``blocks.{i}`` tensors (trained on the pipeline, sharded over the
    stages) and everything else (the embedding, the head and the Fourier
    buffer, whole on every rank)."""
    block_names = [f"blocks.{i}" for i in range(nblocks)]
    stacked, rest = stack_block_params(variables, block_names)
    return rest, stacked, block_names


def merge_dit_variables(rest: dict, stacked: dict,
                        block_names: Sequence[str]) -> dict:
    """The inverse of ``split_dit_variables``: the tensors by name, to
    load with ``load_state_dict``."""
    return unstack_block_params(stacked, rest, block_names)


class _Method(nn.Module):
    """``net``'s method ``name`` as a module's forward (so that
    ``functional_call`` can run it over given tensors)."""

    def __init__(self, net: nn.Module, name: str):
        super().__init__()
        self.net = net
        self.name = name

    def forward(self, *args):
        return getattr(self.net, self.name)(*args)


def make_dit_pipeline(model, mesh, *, n_micro: int,
                      stage_axis: str = STAGE_AXIS,
                      data_axis: str | None = None):
    """Pipeline-parallel forward of a ``DiffusionTransformer``: returns
    ``(forward, block_names)`` with ``forward(rest, stacked, x, t=None,
    y=None)`` giving ``model(x, t, y)`` (x [B, C, H, W]), the blocks run
    by ``pipeline_apply`` over ``stage_axis``, ``model.embed`` and
    ``model.head`` on every rank over the tensors of ``rest``. Split and
    merge the tensors with ``split_dit_variables`` /
    ``merge_dit_variables``."""
    from torch.func import functional_call

    block_names = [f"blocks.{i}" for i in range(model.nblocks)]
    template = model.blocks[0]
    embed, head = _Method(model, "embed"), _Method(model, "head")

    def block_apply(p, tok, te):
        return functional_call(template, p, (tok, te))

    def forward(rest, stacked, x, t=None, y=None):
        H, W = x.shape[2], x.shape[3]
        if data_axis is not None:
            names = list(rest)
            rest = dict(zip(names, sum_grads(mesh.get_group(data_axis),
                                             *rest.values())))
        named = {f"net.{k}": v for k, v in rest.items()}
        tokens, te = functional_call(embed, named, (x, t, y),
                                     strict=False)
        tokens = pipeline_apply(block_apply, stacked, tokens, te, mesh,
                                n_micro=n_micro, stage_axis=stage_axis,
                                data_axis=data_axis)
        return functional_call(head, named, (tokens, H, W), strict=False)

    return forward, block_names


__all__ = ["STAGE_AXIS", "StageBlocks", "make_dit_pipeline",
           "merge_dit_variables", "pipeline_apply", "shard_stacked_params",
           "split_dit_variables", "stack_block_params", "sum_grads",
           "unstack_block_params"]
