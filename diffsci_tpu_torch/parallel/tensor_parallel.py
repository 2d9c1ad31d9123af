"""Tensor parallelism: wide layers' output features sharded over a
``tensor`` axis.

Port of ``diffsci_tpu/parallel/tensor_parallel.py``. The JAX package
shards each wide parameter's output-feature axis and lets GSPMD partition
the matmuls and convolutions. Here the same layers become column-parallel
layers, as Megatron writes them: each rank of a ``tensor`` line holds the
rows of the weight for its block of output features and computes that
block; the blocks are all-gathered into the whole activation, which every
rank of the line then holds (so the rest of the network runs as it is).
Backward: the activation's gradient is the same on every rank of the line
and each keeps its block's part; the input's gradient, a partial sum over
the output features, is summed over the line.

The spec rule follows the JAX package's (the output-feature axis, when it
has ``min_size`` or more features and the axis divides it), read in
torch's layouts: dim 0 of a ``Linear``'s and a ``Conv*d``'s weight, dim 1
of a ``ConvTranspose*d``'s. Biases and every other tensor stay
replicated, as 1-d tensors do in the JAX package; so do grouped
convolutions, and weights that other modules hold (the JAX package's
rule shards any ≥2-d leaf by its last axis: placement, not numbers).

A module that reads a layer's weight instead of calling the layer goes
through ``as_linear`` (a ``Linear`` or 1×1 convolution applied to tokens:
this rank's features, gathered whole) or ``whole_weight`` (the weight
all-gathered with autograd), so it sees the whole product under tensor
parallelism as GSPMD gives it in the JAX package.
"""

from __future__ import annotations

import types

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.parallel.mesh import (DATA_AXIS, TENSOR_AXIS,
                                             axis_size)

_CONV = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
_CONV_T = (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)


def _feature_dim(module: nn.Module):
    """The output-feature dim of a module's ``weight`` that tensor
    parallelism may shard, or None."""
    if type(module) is nn.Linear:
        return 0
    if isinstance(module, _CONV) and module.groups == 1:
        return 0
    if isinstance(module, _CONV_T) and module.groups == 1:
        return 1
    return None


def tensor_parallel_specs(net: nn.Module, mesh, axis: str = TENSOR_AXIS,
                          min_size: int = 128) -> dict:
    """name -> spec for every parameter of ``net``: a ``Linear``'s,
    ``Conv*d``'s or ``ConvTranspose*d``'s weight sharded on its
    output-feature dim over ``axis`` when that dim is ≥ ``min_size`` and
    divisible; () for the rest."""
    n = axis_size(mesh, axis)
    specs = {name: () for name, _ in net.named_parameters()}
    for mname, module in net.named_modules():
        d = _feature_dim(module)
        w = getattr(module, "weight", None)
        if d is None or w is None or getattr(module, "_tp", None):
            continue
        if w.shape[d] >= min_size and w.shape[d] % n == 0:
            spec = [None] * w.ndim
            spec[d] = axis
            specs[f"{mname}.weight" if mname else "weight"] = tuple(spec)
    return specs


class _ToLine(torch.autograd.Function):
    """Identity forward; the gradient summed over the line (each rank's
    is a partial sum over its output features)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherLine(torch.autograd.Function):
    """Every rank's block of features along ``dim``, whole; backward
    keeps this rank's block of the (line-wide equal) gradient."""

    @staticmethod
    def forward(ctx, y, dim, group, n, rank):
        ctx.dim, ctx.rank, ctx.k = dim, rank, y.shape[dim]
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.k, ctx.k).contiguous(),
                None, None, None, None)


class Line:
    """A rank's line of a mesh axis: its group, size and index. A copy
    of the module that holds it (the cast copy under a compute dtype)
    shares it."""

    def __init__(self, mesh, axis: str):
        self.group = mesh.get_group(axis)
        self.n = axis_size(mesh, axis)
        self.rank = mesh.get_local_rank(axis)

    def __deepcopy__(self, memo):
        return self


def _tp_forward(module, x):
    """A column-parallel layer's forward: this rank's output features,
    gathered whole, then the (whole, replicated) bias."""
    if isinstance(module, nn.Linear):
        return as_linear(module, x)
    line = module._tp
    x = _ToLine.apply(x, line.group)
    if isinstance(module, _CONV):
        y = module._conv_forward(x, module.weight, None)
    else:
        y = _conv_t(module, x)
    y = _GatherLine.apply(y, 1, line.group, line.n, line.rank)
    if module.bias is not None:
        y = y + module.bias.view([1, -1] + [1] * (y.ndim - 2))
    return y


def as_linear(layer: nn.Module, h, bias: bool = True):
    """``layer`` (a ``Linear`` or a 1×1 ``Conv*d``) as a matrix product
    over the last dim of ``h`` ([..., in] -> [..., out]), with its bias
    unless ``bias`` is False. A column-parallel layer computes this
    rank's output features and gathers them whole, as its own forward
    does."""
    w = layer.weight.flatten(1)
    b = layer.bias if bias else None
    line = getattr(layer, "_tp", None)
    if line is None:
        return F.linear(h, w, b)
    y = F.linear(_ToLine.apply(h, line.group), w)
    y = _GatherLine.apply(y, y.ndim - 1, line.group, line.n, line.rank)
    return y if b is None else y + b


def whole_weight(layer: nn.Module) -> torch.Tensor:
    """``layer``'s whole weight: a column-parallel layer's rows
    all-gathered over its line, differentiably (every rank of the line
    computes the same gradient of the whole, and keeps its rows'); a
    plain layer's own."""
    line = getattr(layer, "_tp", None)
    if line is None:
        return layer.weight
    return _GatherLine.apply(layer.weight, _feature_dim(layer), line.group,
                             line.n, line.rank)


def _conv_t(module, x):
    fn = (F.conv_transpose1d, F.conv_transpose2d,
          F.conv_transpose3d)[_CONV_T.index(type(module))]
    return fn(x, module.weight, None, module.stride, module.padding,
              module.output_padding, module.groups, module.dilation)


@torch.no_grad()
def shard_params_tensor_parallel(net: nn.Module, mesh,
                                 axis: str = TENSOR_AXIS,
                                 min_size: int = 128) -> dict:
    """Make the layers that ``tensor_parallel_specs`` shards
    column-parallel over ``axis``, in place: each keeps its rows of the
    weight (a new parameter under the same name) and gathers its output.
    At one rank along ``axis`` the layers stay as they are. Returns the
    specs."""
    specs = tensor_parallel_specs(net, mesh, axis, min_size)
    line = Line(mesh, axis)
    n, rank = line.n, line.rank
    if n == 1:
        return specs
    for mname, module in net.named_modules():
        name = f"{mname}.weight" if mname else "weight"
        if not specs.get(name):
            continue
        d = _feature_dim(module)
        w = module.weight
        k = w.shape[d] // n
        module.weight = nn.Parameter(w.narrow(d, rank * k, k).clone(),
                                     requires_grad=w.requires_grad)
        module._tp = line
        module.forward = types.MethodType(_tp_forward, module)
    return specs


@torch.no_grad()
def shard_state_tensor_parallel(state, mesh, axis: str = TENSOR_AXIS,
                                data_axis: str | None = DATA_AXIS,
                                min_size: int = 128):
    """Shard a train state for data × tensor parallelism, in place: the
    wide layers of its network (``state.module``) column-parallel over
    ``axis``, their AdamW moments and EMA
    shadows cut to the same rows (by name, where the JAX package matches
    them by shape); everything else replicated (made rank 0's). The
    batch is each rank's rows over ``data_axis``. Its
    ``state.placement.specs`` are what ``fsdp_specs(...,
    existing_specs=)`` composes with (``shard_state_fsdp(...,
    tensor_axis=)`` places both). Returns the state."""
    from diffsci_tpu_torch.models.karras.train import split_variables
    from diffsci_tpu_torch.parallel.fsdp import reshard_state
    from diffsci_tpu_torch.parallel.mesh import replicate
    from diffsci_tpu_torch.parallel.placement import Placement
    net = state.module
    replicate(state, mesh)
    old = dict(state.params)
    prefix = _prefix(net, old)
    specs = shard_params_tensor_parallel(net, mesh, axis, min_size)
    specs = {prefix + k: s for k, s in specs.items() if s}
    params, _ = split_variables(net)
    new = {k: params[k[len(prefix):]] for k in old}
    reshard_state(state, old, new, specs, mesh)
    state.params = new
    state.placement = Placement(mesh, batch_axes=(data_axis,)
                                if data_axis else (), specs=specs)
    return state


def _prefix(net: nn.Module, params: dict) -> str:
    """The prefix of ``params``' names for ``net``'s parameters (the
    state's names are the KarrasNet's, e.g. 'model.')."""
    first_name, first = next(iter(net.named_parameters()))
    for k, v in params.items():
        if v is first:
            return k[:len(k) - len(first_name)]
    raise ValueError("the state's parameters are not the network's")


__all__ = ["as_linear", "shard_params_tensor_parallel",
           "shard_state_tensor_parallel", "tensor_parallel_specs",
           "whole_weight"]
