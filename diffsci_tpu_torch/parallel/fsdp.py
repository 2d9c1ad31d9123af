"""FSDP: a train state's optimizer state, gradients and master weights
sharded over the data axis, with whole working copies (ZeRO stage 2).

Port of ``diffsci_tpu/parallel/fsdp.py``, with one departure. The JAX
package puts NamedShardings on the parameters too, and GSPMD gathers a
layer's weights as the layer runs, so between steps a device holds 1/N of
every sharded parameter. Here each rank keeps, for every parameter that
the spec rule shards, its block of the parameter (the f32 master that
the optimizer steps), of AdamW's moments and of the EMA shadows
(``FSDPShards``); the network's own parameters are whole working copies
that the forward and backward read. The step (``make_train_step`` over a
state that ``shard_state_fsdp`` placed):
- the backward's gradients of the sharded parameters are
  reduce-scattered into their blocks (one flat reduce-scatter), the rest
  all-reduced, all divided by the number of ranks;
- the NaN guard, the clip by the global norm (the squares of the blocks
  summed over the ranks) and AdamW run on the blocks, and the EMA moves
  the blocks' shadows;
- the updated blocks are all-gathered into the working copies.
Memory a rank, for P bytes of f32 sharded parameters over N ranks and k
EMA profiles: P of working copies and P of gradients while the backward
runs, then P/N of blocks, 2P/N of moments and kP/N of shadows, where the
data-parallel step holds P + P + 2P + kP. Sharding the working copies
too (a gather before each layer) is not ported.

The spec rule is a pure function of a tensor's shape: the largest
dimension that the axis divides, when the tensor has ``min_elements`` or
more. torch lays a convolution's weight out [out, in, *k] where JAX's is
[*k, in, out], so on ties the two packages may pick different axes: that
moves placement, not numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from diffsci_tpu_torch.parallel.mesh import DATA_AXIS, axis_size, replicate
from diffsci_tpu_torch.parallel.placement import Placement, block


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def fsdp_specs(params: Any, mesh, axis: str = DATA_AXIS,
               min_elements: int = 4096) -> dict:
    """name -> spec: each parameter's largest ``axis``-divisible
    dimension, for tensors of ``min_elements`` or more; () (replicated)
    otherwise. ``params``: a module or a dict of tensors."""
    n = axis_size(mesh, axis)
    out = {}
    for name, leaf in _named(params).items():
        out[name] = ()
        if leaf.numel() < min_elements:
            continue
        for d in sorted(range(leaf.ndim), key=lambda d: -leaf.shape[d]):
            if leaf.shape[d] % n == 0 and leaf.shape[d] >= n:
                out[name] = tuple(axis if i == d else None
                                  for i in range(leaf.ndim))
                break
    return out


@dataclasses.dataclass
class FSDPShards:
    """The sharded parameters' blocks by name (leaf tensors that the
    optimizer steps), their specs, and the axis."""
    blocks: dict
    specs: dict
    axis: str

    def step_params(self, params: dict) -> dict:
        """name -> the tensor the optimizer and the EMA move: the block
        of a sharded parameter, the parameter itself otherwise."""
        return {k: self.blocks.get(k, p) for k, p in params.items()}

    def _dim(self, name: str) -> int:
        return next(i for i, a in enumerate(self.specs[name])
                    if a is not None)

    def reduce_scatter(self, params: dict, mesh, divisor: float) -> None:
        """Each block's gradient: the sum over the ranks of its part of
        its parameter's gradient, over ``divisor`` (one flat
        reduce-scatter over the axis); the parameters' own gradients are
        then dropped."""
        n = axis_size(mesh, self.axis)
        rows = [params[name].grad.movedim(self._dim(name), 0).reshape(n, -1)
                for name in self.blocks]
        flat = torch.cat(rows, dim=1)
        mine = flat.new_empty(flat.shape[1])
        dist.reduce_scatter_tensor(mine, flat.reshape(-1),
                                   group=mesh.get_group(self.axis))
        mine.div_(divisor)
        for (name, b), part in zip(self.blocks.items(), mine.split(
                [b.numel() for b in self.blocks.values()])):
            d = self._dim(name)
            b.grad = part.view(b.movedim(d, 0).shape).movedim(0, d) \
                .contiguous()
            params[name].grad = None

    @torch.no_grad()
    def gather(self, params: dict, mesh) -> None:
        """The working copies made whole again from every rank's blocks."""
        for name, b in self.blocks.items():
            d = self._dim(name)
            group = mesh.get_group(self.axis)
            parts = [torch.empty_like(b) for _ in range(
                axis_size(mesh, self.axis))]
            dist.all_gather(parts, b, group=group)
            params[name].copy_(torch.cat(parts, dim=d))

    @torch.no_grad()
    def scatter(self, params: dict, mesh) -> None:
        """The blocks made their part of the working copies (after an
        in-place change of the copies, e.g. the mp re-projection)."""
        for name, b in self.blocks.items():
            b.copy_(block(params[name], self.specs[name], mesh))


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


@torch.no_grad()
def shard_state_fsdp(state, mesh, axis: str = DATA_AXIS,
                     min_elements: int = 4096):
    """Shard a train state FSDP-style over ``axis``: the blocks of the
    parameters, AdamW's moments and the EMA shadows; the network's
    buffers and the step count stay replicated (made rank 0's). Train it
    with ``make_train_step``'s step on each rank's rows of the batch.
    (Composing it with tensor parallelism, the JAX package's
    ``tensor_axis``, is not ported.)"""
    replicate(state, mesh)
    specs = {k: s for k, s in fsdp_specs(state.params, mesh, axis,
                                         min_elements).items() if s}
    blocks = {k: block(state.params[k], s, mesh).clone()
              for k, s in specs.items()}
    reshard_state(state, state.params, {k: blocks.get(k, p) for k, p in
                                        state.params.items()}, specs, mesh)
    state.placement = Placement(mesh, batch_axes=(axis,),
                                fsdp=FSDPShards(blocks, specs, axis))
    return state


__all__ = ["FSDPShards", "fsdp_specs", "shard_state_fsdp"]
