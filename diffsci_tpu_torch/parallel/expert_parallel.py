"""Expert parallelism: the stacked MoE experts sharded over an
``expert`` axis, tokens moved to their expert's rank and back with
all-to-alls.

Port of ``diffsci_tpu/parallel/expert_parallel.py``. The JAX package
shards every ``experts_*`` parameter's leading (expert) axis and lets
GSPMD move the tokens. Here each rank of an ``expert`` line keeps its
E/n experts (``experts_w1`` [E/n, d, f], ...), and every
``MoEFeedForward`` of the network routes over the line through its
``routing`` (a ``Routing``, which ``shard_params_expert_parallel`` sets;
the routing arithmetic is the module's own ``route``):
- the batch is split over the token axes (``data`` × ``expert``: every
  rank its own rows), and the router runs on each rank's tokens;
- each expert's capacity and each token's slot are the single-device
  forward's: the capacity from the global token count, the slot from a
  cumulative count over the global tokens in rank order (the counts of
  the ranks before this one, by an all-gather, plus this rank's own);
- the kept tokens go to the rank that holds their expert
  (``all_to_all_single``), which runs its experts on an [E/n, C, d]
  buffer as the single-device forward runs all E, and the outputs come
  back the same way.
The all-to-alls carry autograd (``torch.distributed.nn``). The dispatch's
sizes are read on the host, so the routed forward runs eagerly (no CUDA
graph).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn

from diffsci_tpu_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS,
                                             axis_index, axis_size)

_PREFIX = "experts_"


def _named(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def expert_parallel_specs(params, mesh, axis: str = EXPERT_AXIS) -> dict:
    """name -> spec: a tensor whose name has a component starting with
    ``experts_`` gets its leading (expert) dim over ``axis`` when the
    axis divides it; () for the rest. ``params``: a module or a dict of
    tensors."""
    n = axis_size(mesh, axis)
    out = {}
    for name, leaf in _named(params).items():
        expert = any(part.startswith(_PREFIX) for part in name.split("."))
        out[name] = (axis,) + (None,) * (leaf.ndim - 1) if expert \
            and leaf.ndim >= 1 and leaf.shape[0] % n == 0 else ()
    return out


class Routing:
    """An MoE layer's routing over a mesh: the token group (the ranks
    whose rows make the global batch, in rank order) and the expert
    line. ``MoEFeedForward.route`` takes its counts and sums from it, and
    ``forward`` its exchange (``dispatch``). Copies of the module share
    it."""

    def __init__(self, mesh, axis: str, token_axes):
        names = mesh.mesh_dim_names
        token_axes = tuple(a for a in token_axes if a in names)
        self.n_tok = axis_size(mesh, token_axes)
        self.tok_rank = axis_index(mesh, token_axes)
        if len(token_axes) == len(names):
            self.tok_group = None
        elif len(token_axes) == 1:
            self.tok_group = mesh.get_group(token_axes[0])
        else:
            raise NotImplementedError(f"token axes {token_axes}")
        self.group = mesh.get_group(axis)
        self.n = axis_size(mesh, axis)
        self.rank = mesh.get_local_rank(axis)

    def __deepcopy__(self, memo):
        return self

    def counts(self, counts: torch.Tensor):
        """(the tokens the ranks before this one gave each expert, the
        tokens every rank gave each), from this rank's ``counts`` [E]."""
        every = [torch.empty_like(counts) for _ in range(self.n_tok)]
        dist.all_gather(every, counts, group=self.tok_group)
        every = torch.stack(every)
        return every[:self.tok_rank].sum(0), every.sum(0)

    def token_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the token group (differentiable)."""
        from torch.distributed.nn.functional import all_reduce
        return all_reduce(t, group=self.tok_group)

    def dispatch(self, m, tokens, expert, slot, keep, C):
        """The experts' outputs [S, d] for this rank's tokens (0 for a
        dropped one): the kept tokens go to the rank that holds their
        expert, which runs its E/n experts on an [E/n, C, d] buffer as the
        single-device forward runs all E, and come back."""
        S, d = tokens.shape
        El = m.n_experts // self.n
        # the kept tokens, grouped by the rank that holds their expert
        idx = torch.nonzero(keep).squeeze(1)
        idx = idx[torch.argsort(expert[idx] // El, stable=True)]
        owner = expert[idx] // El
        send = torch.bincount(owner, minlength=self.n)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        send, recv = send.tolist(), recv.tolist()
        meta = torch.stack([expert[idx] - owner * El, slot[idx]], dim=1)
        meta_in = meta.new_empty((sum(recv), 2))
        dist.all_to_all_single(meta_in, meta.contiguous(), recv, send,
                               group=self.group)
        tok_in = _all_to_all(tokens[idx], send, recv, self.group)
        dest = meta_in[:, 0] * C + meta_in[:, 1]
        buf = tokens.new_zeros((El * C, d)).index_copy(0, dest, tok_in)
        out = m.experts(buf.view(El, C, d))
        back = _all_to_all(out.index_select(0, dest), recv, send, self.group)
        return tokens.new_zeros((S, d)).index_copy(0, idx, back)


def _all_to_all(x: torch.Tensor, send: list, recv: list, group):
    from torch.distributed.nn.functional import all_to_all_single
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    return all_to_all_single(out, x.contiguous(), recv, send, group=group)


@torch.no_grad()
def shard_params_expert_parallel(net: nn.Module, mesh,
                                 axis: str = EXPERT_AXIS,
                                 token_axes=(DATA_AXIS, EXPERT_AXIS)
                                 ) -> dict:
    """Shard every ``MoEFeedForward`` of ``net`` over ``axis``, in place:
    each keeps its rank's experts (new parameters under the same names)
    and routes its tokens over the line; the batch is each rank's rows
    over ``token_axes``. Returns the specs."""
    from diffsci_tpu_torch.models.nets.moe import MoEFeedForward
    specs = expert_parallel_specs(net, mesh, axis)
    routing = Routing(mesh, axis, token_axes)
    for mname, module in net.named_modules():
        if not isinstance(module, MoEFeedForward):
            continue
        if module.n_experts % routing.n:
            raise ValueError(f"{module.n_experts} experts not divisible by "
                             f"the '{axis}' axis size {routing.n}")
        k = module.n_experts // routing.n
        for pname, p in list(module.named_parameters(recurse=False)):
            if specs.get(f"{mname}.{pname}" if mname else pname):
                setattr(module, pname, nn.Parameter(
                    p.narrow(0, routing.rank * k, k).clone(),
                    requires_grad=p.requires_grad))
        module.routing = routing
    return specs


@torch.no_grad()
def shard_state_expert_parallel(state, mesh, axis: str = EXPERT_AXIS,
                                data_axis: str | None = DATA_AXIS):
    """Shard a train state for data × expert parallelism, in place: the
    experts of its network (``state.module``) over ``axis``, with their
    AdamW moments and EMA shadows (matched by name, as the JAX package
    matches them); everything else replicated (made rank 0's). The batch is each rank's rows over (``data_axis``,
    ``axis``). Returns the state."""
    from diffsci_tpu_torch.models.karras.train import split_variables
    from diffsci_tpu_torch.parallel.fsdp import reshard_state
    from diffsci_tpu_torch.parallel.mesh import replicate
    from diffsci_tpu_torch.parallel.placement import Placement
    from diffsci_tpu_torch.parallel.tensor_parallel import _prefix
    net = state.module
    replicate(state, mesh)
    old = dict(state.params)
    prefix = _prefix(net, old)
    token_axes = (data_axis, axis) if data_axis else (axis,)
    specs = shard_params_expert_parallel(net, mesh, axis, token_axes)
    specs = {prefix + k: s for k, s in specs.items() if s}
    params, _ = split_variables(net)
    new = {k: params[k[len(prefix):]] for k in old}
    reshard_state(state, old, new, specs, mesh)
    state.params = new
    state.placement = Placement(mesh, batch_axes=token_axes, specs=specs,
                                expert_axis=axis)
    return state


__all__ = ["EXPERT_AXIS", "expert_parallel_specs",
           "shard_params_expert_parallel", "shard_state_expert_parallel"]
