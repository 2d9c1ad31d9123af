"""How a train state lies over a mesh, and the collectives its step
takes: the port's counterpart of the shardings a JAX ``TrainState``'s
arrays carry.

``replicate``, ``shard_state_fsdp``, ``shard_state_tensor_parallel`` and
``shard_state_expert_parallel`` give a state a ``Placement``; the train
step reads it:
- the batch is this rank's rows over ``batch_axes``, and every random
  draw is the global batch's, of which the step keeps its rows, so a
  step at world size N draws what the single-process step draws;
- the gradients are summed over the ranks that hold the same tensor (one
  flat all-reduce a group of such ranks; FSDP's blocks are
  reduce-scattered by the backward itself) and divided by the number of
  distinct batch shards they cover, so they are the global batch's mean
  gradient before the NaN guard, the clip and AdamW, as JAX's are;
- the global norm sums the squares of a sharded tensor over its shards;
- the loss is the mean over the ranks.

A spec is the JAX package's ``PartitionSpec`` as a tuple: one mesh axis
name (or None) a dimension, () for a replicated tensor.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from diffsci_tpu_torch.parallel.mesh import (axis_index, axis_size,
                                             gather_batch)


def spec_axes(spec: Sequence) -> tuple:
    return tuple(a for a in spec if a is not None)


def block(tensor: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of a whole ``tensor`` under ``spec``."""
    for d, a in enumerate(spec):
        if a is not None:
            n = axis_size(mesh, a)
            k = tensor.shape[d] // n
            tensor = tensor.narrow(d, axis_index(mesh, a) * k, k)
    return tensor


class Placement:
    """A train state's layout over ``mesh``: the axes its batch rows are
    split over, and one spec for every sharded parameter by name (the
    rest are replicated): the network's own tensors, which under TP, EP
    and FSDP are this rank's shards, and under FSDP composed with TP may
    be sharded over both axes. ``fsdp_axis``: the axis whose blocks FSDP
    gathers layer by layer (``parallel/fsdp.py``), or None."""

    def __init__(self, mesh, batch_axes: Sequence[str], specs: dict | None =
                 None, fsdp_axis: str | None = None):
        self.mesh = mesh
        names = mesh.mesh_dim_names
        self.batch_axes = tuple(a for a in batch_axes if a in names)
        self.specs = dict(specs or {})
        self.fsdp_axis = fsdp_axis
        # the dp × spatial step's layout (``parallel/spatial.py``), or None
        self.spatial = None
        self.world = dist.get_world_size()
        # a CUDA graph captures NCCL's collectives; gloo's (which also
        # carry CUDA tensors) synchronise with the host, so a step over
        # them runs eagerly
        self.capturable = dist.get_backend() == "nccl"

    # -- the batch ---------------------------------------------------------
    def batch_shards(self) -> tuple[int, int]:
        """(the number of distinct batch shards, this rank's index)."""
        return (axis_size(self.mesh, self.batch_axes),
                axis_index(self.mesh, self.batch_axes))

    def whole(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's block under
        ``spec`` (all-gathered along each sharded dim; every rank
        calls)."""
        for d, a in enumerate(spec):
            if a is not None:
                t = gather_batch(t, self.mesh, a, dim=d)
        return t

    # -- groups ------------------------------------------------------------
    def _group(self, axes: Sequence[str]):
        """The process group of this rank's ranks along ``axes``; None for
        the world; "none" for no axis."""
        names = self.mesh.mesh_dim_names
        axes = [a for a in names if a in axes]
        if not axes:
            return "none"
        if len(axes) == len(names):
            return None
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        raise NotImplementedError(f"a group over axes {axes} of a mesh "
                                  f"over {names}")

    def _grad_rule(self, name: str):
        """(the group to sum a gradient over, the divisor): the ranks that
        hold the same tensor, and the distinct batch shards they cover
        times the copies of each."""
        sharded = set(spec_axes(self.specs.get(name, ())))
        rest = [a for a in self.mesh.mesh_dim_names if a not in sharded]
        copies = int(np.prod([axis_size(self.mesh, a) for a in rest
                              if a not in self.batch_axes]))
        return self._group(rest), float(self.batch_shards()[0] * copies)

    # -- the step's collectives -------------------------------------------
    def sync_grads(self, params: dict) -> None:
        """The gradient of each parameter made the global batch's mean:
        every one all-reduced in place (one flat all-reduce a (group,
        divisor)), but for FSDP's blocks, whose gradients the backward
        already reduce-scattered. ``params``: the state's parameters by
        name."""
        buckets: dict = {}
        for name, p in params.items():
            if self.fsdp_axis is not None and \
                    self.fsdp_axis in self.specs.get(name, ()):
                continue
            group, divisor = self._grad_rule(name)
            if group == "none":
                continue
            buckets.setdefault((id(group), divisor), (group, divisor, []))[
                2].append(p.grad)
        for group, divisor, grads in buckets.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            flat.div_(divisor)
            torch._foreach_copy_(grads, [
                part.view_as(g) for part, g in zip(
                    flat.split([g.numel() for g in grads]), grads)])

    def global_norm(self, named: dict) -> torch.Tensor:
        """sqrt of the sum of squares of the full tensors whose local
        parts are ``named``: a sharded tensor's squares summed over its
        shards (over the world for one sharded over two axes), a
        replicated one's counted once. At world size 1, the
        single-process norm."""
        from diffsci_tpu_torch.models.karras.train import global_norm
        if self.world == 1:
            return global_norm(list(named.values()))
        by_group: dict = {}
        whole = []
        for name, t in named.items():
            axes = spec_axes(self.specs.get(name, ()))
            if axes:
                group = self._group(axes)
                by_group.setdefault(id(group), (group, []))[1].append(t)
            else:
                whole.append(t)
        if not by_group:
            return global_norm(whole)
        sq = torch.zeros((), dtype=torch.float32, device=next(
            iter(named.values())).device)
        if whole:
            sq = sq + global_norm(whole).float() ** 2
        for group, tensors in by_group.values():
            part = global_norm(tensors).float().reshape(1) ** 2
            dist.all_reduce(part, group=group)
            sq = sq + part[0]
        return torch.sqrt(sq)

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """A scalar's mean over the batch shards (the ranks along
        ``batch_axes``), differentiable: each rank's gradient is the mean
        of theirs."""
        from torch.distributed.nn.functional import all_reduce
        group = self._group(self.batch_axes)
        if group == "none":
            return x
        return all_reduce(x, group=group) / self.batch_shards()[0]

    def mean_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """A scalar's mean over the world (a rank that repeats another's
        rows repeats its value)."""
        if self.world == 1:
            return x
        x = x.detach().reshape(1).clone()
        dist.all_reduce(x)
        return (x / self.world)[0]


__all__ = ["Placement", "block", "spec_axes"]
