"""FSDP: a train state's parameters, their AdamW moments and EMA shadows
sharded over the data axis, each layer's weights gathered as it runs
(ZeRO stage 3), composable with tensor and expert parallelism.

Port of ``diffsci_tpu/parallel/fsdp.py``. The JAX package puts
NamedShardings on the state and GSPMD gathers a layer's weights as the
layer runs. Here ``shard_state_fsdp`` does the same by hand, in place:
- each parameter that the spec rule shards is replaced in its module by
  this rank's block (a new parameter under the same name): the f32
  master that AdamW steps, whose moments and EMA shadows are blocks too,
  and which the checkpoints read and restore. Between steps a rank holds
  the blocks and the unsharded tensors, nothing whole;
- inside the network's forward, reading such a parameter as a module
  attribute (``module.weight``, in the module's forward or its parent's)
  all-gathers the blocks over the data axis (``_Gather``): under a
  compute dtype the block's cast, so the gather moves half the bytes. Its
  backward reduce-scatters the gradient, in float32, into the block's
  ``.grad`` (the sum over the ranks over their number: the global
  batch's mean), as that layer's backward ends. Outside the forward the
  read raises: a write through it would land on a gathered copy, and a
  read on one rank alone would leave the others' collective waiting.
  The block is ``module._parameters[name]``, the whole tensor
  ``checkpoint.gather_state``'s;
- autograd saves the block, not the gathered weight: the network's
  forward runs under saved-tensor hooks that keep a reference to the
  block and gather it again when the backward needs it. Under ``remat``
  they sit inside the checkpoint's hooks and hand it every other tensor,
  so its recomputation holds no gathered weight either;
- a layer that the loss does not reach gathers nothing and gets the zero
  gradient the step gives every unused parameter; every rank runs the
  same layers, so the collectives come in the same order on each.
The step is ``make_train_step``'s, over NCCL one CUDA graph with the
collectives in it. The magnitude-preserving re-projection runs on the
blocks: a module's ``unit_dims()`` name the dims a unit's norm sums over,
and where a block splits them placement registers the all-reduce of the
sums in its ``unit_sums`` (``models/nets/normed.py``).

Departures from the JAX package: the sampler's cast copy of an FSDP
network (``models/compute.py``) holds the blocks in the compute dtype and
gathers each layer as the masters do; the spec rule reads torch's layouts
(a convolution's weight is [out, in, *k] where JAX's is [*k, in, out], so
on ties the two packages may pick different dims: placement, not
numbers); the VAE step does not take an FSDP state, and FSDP does not
compose with the spatial mesh (both raise).

Over an expert-parallel state (``shard_state_expert_parallel`` on a
data × expert mesh, then ``shard_state_fsdp``): each ``experts_*``
tensor keeps its leading dim over the expert axis and is blocked over
the data axis along another dim, the dense remainder over the data axis
alone. A layer gathers its blocks over the data axis only (this rank's
experts, whole), ``Routing`` moves the tokens over the expert axis as
before, and after the backward's reduce-scatter over the data axis a
dense block's gradient is all-reduced over the expert axis, whose ranks
hold other rows (``Placement._fsdp_rule``).
"""

from __future__ import annotations

import contextvars
import math
import types
from typing import Any

import torch
import torch.distributed as dist
import torch.nn as nn

from diffsci_tpu_torch.models.compute import READ_DTYPE
from diffsci_tpu_torch.parallel.mesh import DATA_AXIS, axis_size, replicate
from diffsci_tpu_torch.parallel.placement import Placement, block


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def fsdp_specs(params: Any, mesh, axis: str = DATA_AXIS,
               min_elements: int = 4096, existing_specs: dict | None = None
               ) -> dict:
    """name -> spec: each parameter's largest ``axis``-divisible
    dimension, for tensors of ``min_elements`` or more; () (replicated)
    otherwise. ``params``: a module or a dict of tensors.

    ``existing_specs`` (name -> spec, e.g. ``tensor_parallel_specs``'s, or
    a tensor-parallel state's ``placement.specs``): the dims those specs
    shard keep their axis and FSDP picks another, so no dim is sharded
    over two axes. A tensor they shard counts by its whole size: its
    dims read as this rank's shard times the axis."""
    n = axis_size(mesh, axis)
    existing = existing_specs or {}
    out = {}
    for name, leaf in _named(params).items():
        prior = tuple(existing.get(name, ()))
        prior += (None,) * (leaf.ndim - len(prior))
        shape = [s * (axis_size(mesh, a) if a is not None else 1)
                 for s, a in zip(leaf.shape, prior)]
        out[name] = prior if any(a is not None for a in prior) else ()
        if math.prod(shape) < min_elements:
            continue
        for d in sorted(range(leaf.ndim), key=lambda d: -shape[d]):
            if prior[d] is None and shape[d] % n == 0 and shape[d] >= n:
                out[name] = tuple(axis if i == d else prior[i]
                                  for i in range(leaf.ndim))
                break
    return out


# ---------------------------------------------------------------------------
# the per-layer gather and reduce-scatter
# ---------------------------------------------------------------------------
# whether the running code is a placed network's forward, where a
# sharded parameter's read gathers it
_IN_FORWARD: contextvars.ContextVar = contextvars.ContextVar(
    "fsdp_in_forward", default=False)


def _all_gather(part: torch.Tensor, dim: int, line) -> torch.Tensor:
    """Every rank's ``part`` of ``line`` joined along ``dim``
    (contiguous)."""
    part = part.movedim(dim, 0).contiguous()
    out = part.new_empty((line.n * part.shape[0],) + tuple(part.shape[1:]))
    dist.all_gather_into_tensor(out, part, group=line.group)
    return out.movedim(0, dim).contiguous() if dim else out


def _reduce_scatter(whole: torch.Tensor, dim: int, line,
                    dtype: torch.dtype) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's
    ``whole`` over their number, in ``dtype``."""
    whole = whole.to(dtype).movedim(dim, 0).contiguous()
    out = whole.new_empty((whole.shape[0] // line.n,)
                          + tuple(whole.shape[1:]))
    dist.reduce_scatter_tensor(out, whole, group=line.group)
    out.div_(line.n)
    return out.movedim(0, dim).contiguous() if dim else out


class _Gather(torch.autograd.Function):
    """The whole parameter from every rank's block (cast to ``dtype``);
    backward: the gradient's block of the mean over the ranks."""

    @staticmethod
    def forward(ctx, blk, dim, line, dtype):
        ctx.dim, ctx.line, ctx.dtype = dim, line, blk.dtype
        return _all_gather(blk.to(dtype), dim, line)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.line, ctx.dtype), None, \
            None, None


class Shard:
    """A parameter's FSDP layout: the dim its blocks split, and the line
    of the data axis that holds them."""

    def __init__(self, dim: int, line):
        self.dim, self.line = dim, line

    def gather(self, blk: torch.Tensor) -> torch.Tensor:
        """The whole parameter, in the compute dtype that
        ``models/compute.py`` reads it in (``READ_DTYPE``)."""
        dtype = READ_DTYPE.get() or blk.dtype
        if not (torch.is_grad_enabled() and blk.requires_grad):
            with torch.no_grad():
                return _all_gather(blk.to(dtype), self.dim, self.line)
        whole = _Gather.apply(blk, self.dim, self.line, dtype)
        # what ``_pack`` keeps in its place
        whole._fsdp_source = (blk, self, dtype)
        return whole

    def reduce(self, partial: torch.Tensor) -> tuple:
        """(``partial`` summed over the line, the line's size): the
        per-unit sums of squares of a block split across its units
        (``unit_sums``, ``models/nets/normed.py``)."""
        partial = partial.clone()
        dist.all_reduce(partial, group=self.line.group)
        return partial, self.line.n


class _Saved:
    """What autograd keeps of a gathered weight (or a view of it): its
    block and layout, and the view's geometry."""

    def __init__(self, source, t: torch.Tensor):
        self.source = source
        self.view = (tuple(t.shape), t.stride(), t.storage_offset())


def _pack(t: torch.Tensor, outer):
    base = t if t._base is None else t._base
    source = getattr(base, "_fsdp_source", None)
    if source is not None:
        return _Saved(source, t)
    return t if outer is None else outer[0](t)


def _unpack(packed, outer):
    if isinstance(packed, _Saved):
        blk, shard, dtype = packed.source
        with torch.no_grad():
            whole = _all_gather(blk.to(dtype), shard.dim, shard.line)
        return whole.as_strided(*packed.view)
    return packed if outer is None else outer[1](packed)


def _hooked_forward(module, *args, **kwargs):
    """The network's forward, inside which a sharded parameter's read
    gathers it; when it records a graph, under saved-tensor hooks that
    keep a gathered weight's block (``_pack``/``_unpack``) and pass every
    other tensor to the hooks already set (a remat checkpoint's), so that
    neither the forward nor the checkpoint's recomputation holds a
    gathered weight."""
    token = _IN_FORWARD.set(True)
    try:
        if not torch.is_grad_enabled():
            return module._fsdp_forward(*args, **kwargs)
        outer = torch._C._autograd._top_saved_tensors_default_hooks(False)
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: _pack(t, outer), lambda p: _unpack(p, outer)):
            return module._fsdp_forward(*args, **kwargs)
    finally:
        _IN_FORWARD.reset(token)


def _fsdp_getattr(self, name):
    shards = self.__dict__.get("_fsdp")
    if shards is not None and name in shards:
        if not _IN_FORWARD.get():
            raise RuntimeError(
                f"{type(self).__name__}.{name} is held as FSDP blocks "
                "(parallel/fsdp.py) and gathered only inside the network's "
                f"forward: this rank's block is ._parameters[{name!r}], the "
                "whole tensor checkpoint.gather_state(state)'s")
        return shards[name].gather(self._parameters[name])
    return super(type(self), self).__getattr__(name)


_CLASSES: dict = {}


def _fsdp_class(cls: type) -> type:
    """``cls`` whose sharded parameters read as their gathered whole."""
    if cls.__dict__.get("_fsdp_class"):
        return cls
    if cls not in _CLASSES:
        _CLASSES[cls] = type(cls.__name__, (cls,), {
            "__getattr__": _fsdp_getattr, "_fsdp_class": True,
            "__module__": cls.__module__, "__qualname__": cls.__qualname__})
    return _CLASSES[cls]


# ---------------------------------------------------------------------------
# placing a state
# ---------------------------------------------------------------------------
@torch.no_grad()
def reshard_state(state, old: dict, new: dict, specs: dict, mesh) -> None:
    """Swap the tensors ``old`` (name -> tensor) that the optimizer and
    the EMA move for ``new``, in place: each AdamW moment and each EMA
    shadow (and accumulated gradient) of a swapped tensor becomes its
    block under ``specs``; slots of another shape, such as a shared step
    count, stay."""
    swapped = {k for k in new if new[k] is not old[k]}
    by_id = {id(old[k]): k for k in swapped}
    opt = state.optimizer
    for group in opt.param_groups:
        for i, p in enumerate(group["params"]):
            name = by_id.get(id(p))
            if name is None:
                continue
            group["params"][i] = new[name]
            slot = opt.state.pop(p, None)
            if slot is not None:
                opt.state[new[name]] = {
                    k: (block(v, specs[name], mesh).clone()
                        if torch.is_tensor(v) and v.ndim > 0
                        and v.shape == p.shape else v)
                    for k, v in slot.items()}
    trees = list(state.ema.profiles) if state.ema is not None else []
    if state.accum is not None:
        trees.append(state.accum.grads)
    for tree in trees:
        for name in swapped:
            if name in tree:
                tree[name] = block(tree[name], specs[name], mesh).clone()


def _existing(state, existing_specs) -> dict:
    """The specs of the tensors the state already holds sharded: its
    placement's, which ``existing_specs``, when given, must equal."""
    placed = state.placement.specs if state.placement is not None else {}
    if existing_specs is not None:
        given = {k: tuple(s) for k, s in existing_specs.items()
                 if any(a is not None for a in s)}
        if given != {k: tuple(s) for k, s in placed.items()}:
            raise ValueError(
                "existing_specs must be the specs the state is placed by "
                "(shard_state_tensor_parallel's or "
                "shard_state_expert_parallel's state.placement.specs); "
                "pass tensor_axis= to place the tensor-parallel layers "
                "first")
    return dict(placed)


@torch.no_grad()
def shard_state_fsdp(state, mesh, axis: str = DATA_AXIS,
                     min_elements: int = 4096, tensor_axis: str | None = None,
                     tensor_min_size: int = 128,
                     existing_specs: dict | None = None):
    """Shard a train state FSDP-style over ``axis``, in place: every
    parameter that ``fsdp_specs`` shards becomes this rank's block in its
    module, its AdamW moments and EMA shadows (and accumulated gradient)
    too; the network's buffers, the rest of its parameters and the step
    count stay replicated (made rank 0's). Train it with
    ``make_train_step``'s step on each rank's rows of the batch
    (``shard_batch``); sample and evaluate it on every rank.

    ``tensor_axis``: data × tensor parallelism on a 2D mesh: the wide
    layers first made column-parallel over it
    (``shard_state_tensor_parallel`` at ``tensor_min_size``), then each
    tensor blocked along a dim that tensor parallelism did not take. A
    state that ``shard_state_expert_parallel`` placed keeps its experts
    over the expert axis and its batch over data × expert, and FSDP
    blocks every tensor over ``axis`` along another dim (module
    docstring). ``existing_specs``: kept for the JAX signature, and only
    checked: the specs always come from the state's placement (a state
    that ``shard_state_tensor_parallel`` or ``shard_state_expert_parallel``
    placed), and a value other than its ``placement.specs`` raises.
    Returns the state."""
    from diffsci_tpu_torch.models.vae.module import VAETrainState
    from diffsci_tpu_torch.parallel.tensor_parallel import (
        Line, _prefix, shard_state_tensor_parallel)
    if isinstance(state, VAETrainState):
        raise NotImplementedError("the VAE step does not take an FSDP "
                                  "state (data parallelism: replicate)")
    placed = state.placement
    if placed is not None and (placed.spatial is not None
                               or placed.fsdp_axis is not None):
        raise NotImplementedError("FSDP does not compose with a spatial "
                                  "mesh, nor shard a state twice")
    if tensor_axis is not None:
        shard_state_tensor_parallel(state, mesh, tensor_axis,
                                    data_axis=axis,
                                    min_size=tensor_min_size)
    elif placed is None:
        replicate(state, mesh)
    prior = _existing(state, existing_specs)
    expert_axis = state.placement.expert_axis
    if any(a not in (axis, tensor_axis, expert_axis)
           for s in prior.values() for a in s if a is not None):
        raise NotImplementedError("FSDP composes with tensor and expert "
                                  "parallelism only")
    batch_axes = state.placement.batch_axes if expert_axis else (axis,)
    specs = {k: s for k, s in fsdp_specs(state.params, mesh, axis,
                                         min_elements, prior).items() if s}
    net = state.module
    prefix = _prefix(net, state.params)
    line = Line(mesh, axis)
    owners = {prefix + (f"{m}.{p}" if m else p): (mod, p)
              for m, mod in net.named_modules()
              for p in mod._parameters}
    new, own = dict(state.params), {}
    for name, spec in specs.items():
        if axis not in spec:
            continue
        d = spec.index(axis)
        module, pname = owners[name]
        p = module._parameters[pname]
        k = p.shape[d] // line.n
        new[name] = nn.Parameter(p.narrow(d, line.rank * k, k).clone(),
                                 requires_grad=p.requires_grad)
        module._parameters[pname] = new[name]
        shard = module.__dict__.setdefault("_fsdp", {})[pname] = \
            Shard(d, line)
        units = module.unit_dims().get(pname, ()) \
            if hasattr(module, "unit_dims") else ()
        if d in tuple(u % p.ndim for u in units):
            module.__dict__.setdefault("unit_sums", {})[pname] = shard.reduce
        module.__class__ = _fsdp_class(type(module))
        own[name] = tuple(axis if i == d else None for i in range(p.ndim))
    reshard_state(state, state.params, new, own, mesh)
    state.params = new
    state.placement = Placement(mesh, batch_axes=batch_axes, specs=specs,
                                fsdp_axis=axis, expert_axis=expert_axis)
    if "_fsdp_forward" not in net.__dict__:
        net._fsdp_forward = net.forward
        net.forward = types.MethodType(_hooked_forward, net)
    # the blocks, which the compute dtype's cast leaves to the gathers
    # (``models/compute.py``)
    net.read_cast = frozenset(
        f"{m}.{p}" if m else p for m, mod in net.named_modules()
        for p in mod.__dict__.get("_fsdp", {}))
    return state


__all__ = ["fsdp_specs", "shard_state_fsdp"]
