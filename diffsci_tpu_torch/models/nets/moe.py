"""Mixture-of-Experts FFN and MoE-DiT on [B, C, H, W].

Port of ``diffsci_tpu/models/nets/moe.py``: ``MoEFeedForward`` (top-1
routing with a fixed per-expert capacity), ``MoEDiTBlock``,
``MoEDiffusionTransformer`` and ``moe_aux_loss``. The result is the JAX
package's: the router in f32, top-1 by argmax (first of equal gates),
capacity ``round_up(max(int(cf·S/E), 1), 8)`` slots an expert, slots
given in the flattened (b, t) order by a cumulative sum, and tokens past
capacity dropped (their FFN output is 0, so the block's residual carries
them unchanged).

The JAX package dispatches with a dense one-hot [S, E, C] tensor and
einsums, which at DiT-B widths (S = 32768, E = 4, C = 16384) would hold
2·10⁹ elements. Here each kept token is copied into its slot of an
[E·C, d] buffer (``index_copy``; a dropped token goes to one spare row
that is never read) and each token reads its expert's output row back
(``index_select``): the same sums, since a slot holds one token. The
experts' FFNs run on the whole [E, C, d] buffer as two batched matrix
products, as the JAX einsums do.

Where JAX sows ``moe_aux_loss`` and ``moe_dropped_fraction``, each
``MoEFeedForward`` keeps them as the attributes ``aux_loss`` and
``dropped_fraction`` (0-d f32 tensors of its last call, on its device);
``moe_aux_loss(net)`` reads them.

Under expert parallelism a module's ``routing`` (set by
``parallel.expert_parallel.shard_params_expert_parallel``) takes the
routing's counts over the global batch and moves the kept tokens to the
rank of their expert and back (``Routing.dispatch``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.models.nets.dit import DiffusionTransformer, DiTBlock
from diffsci_tpu_torch.utils import unset


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class MoEFeedForward(nn.Module):
    """Top-1-routed expert FFN over tokens [B, T, d] -> [B, T, d]:
    ``router`` [d, E], ``experts_w1`` [E, d, f], ``experts_b1`` [E, f],
    ``experts_w2`` [E, f, d], ``experts_b2`` [E, d] with f =
    mlp_factor·d (the JAX package's names and layouts)."""

    def __init__(self, nembed: int, n_experts: int, mlp_factor: int = 4,
                 capacity_factor: float = 2.0):
        super().__init__()
        d, E, f = nembed, n_experts, mlp_factor * nembed
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.router = nn.Parameter(unset(d, E))
        self.experts_w1 = nn.Parameter(unset(E, d, f))
        self.experts_b1 = nn.Parameter(torch.zeros(E, f))
        self.experts_w2 = nn.Parameter(unset(E, f, d))
        self.experts_b2 = nn.Parameter(torch.zeros(E, d))
        self.aux_loss = None
        self.dropped_fraction = None
        # expert parallelism's routing over a mesh
        # (``parallel.expert_parallel``), or None
        self.routing = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Weights from normal(0, 1/fan_in) over their input axis, biases
        0."""
        for w in (self.router, self.experts_w1, self.experts_w2):
            w.copy_(torch.randn(w.shape, generator=generator)
                    / math.sqrt(w.shape[-2]))
        nn.init.zeros_(self.experts_b1)
        nn.init.zeros_(self.experts_b2)

    def capacity(self, tokens: int) -> int:
        """Slots an expert for ``tokens`` (= B·T) tokens."""
        return _round_up(max(int(self.capacity_factor * tokens
                                 / self.n_experts), 1), 8)

    def route(self, tokens):
        """Top-1 routing of tokens [S, d]: (each token's expert, its gate,
        its slot in its expert's queue, whether it is kept, the capacity
        C); sets ``aux_loss`` and ``dropped_fraction``. Under expert
        parallelism (``routing``) the tokens are this rank's of a global
        batch: C comes from the global token count, the slots from a
        cumulative count over the global tokens in rank order, and the
        two statistics are the global batch's."""
        r = self.routing or _ONE_RANK
        E, S = self.n_experts, tokens.shape[0]
        S_all = S * r.n_tok
        C = self.capacity(S_all)
        gates = torch.softmax(tokens.float() @ self.router.float(), dim=-1)
        expert = torch.argmax(gates, dim=-1)                       # [S]
        gate = gates.gather(1, expert[:, None])[:, 0]
        sel = (expert[:, None] == torch.arange(E, device=tokens.device)
               ).long()
        before, total = r.counts(sel.sum(0))
        # each token's place in its expert's queue, in (b, t) order
        slot = (torch.cumsum(sel, dim=0) + before).gather(
            1, expert[:, None])[:, 0] - 1
        keep = slot < C
        self.aux_loss = E * torch.sum(total.float() / S_all
                                      * r.token_sum(gates.sum(0)) / S_all)
        self.dropped_fraction = 1.0 - r.token_sum(keep.float().sum()) / S_all
        return expert, gate, slot, keep, C

    def experts(self, buf):
        """Every expert's FFN on its slots: buf [E', C, d] (E' of this
        module's experts) -> [E'·C, d]."""
        h = F.silu(torch.baddbmm(self.experts_b1[:, None].to(buf.dtype), buf,
                                 self.experts_w1.to(buf.dtype)))
        return torch.baddbmm(self.experts_b2[:, None].to(buf.dtype), h,
                             self.experts_w2.to(buf.dtype)).flatten(0, 1)

    def forward(self, x):
        B, T, d = x.shape
        E = self.n_experts
        tokens = x.reshape(B * T, d)
        expert, gate, slot, keep, C = self.route(tokens)
        if self.routing is None:
            dest = torch.where(keep, expert * C + slot, E * C)
            expert_in = x.new_zeros((E * C + 1, d)).index_copy(0, dest,
                                                               tokens)
            out = self.experts(expert_in[:E * C].view(E, C, d))
            y = out.index_select(0, torch.where(keep, dest, 0))
        else:
            y = self.routing.dispatch(self, tokens, expert, slot, keep, C)
        y = torch.where(keep[:, None], y * gate.to(x.dtype)[:, None],
                        torch.zeros((), dtype=x.dtype, device=x.device))
        return y.reshape(B, T, d)


class _OneRank:
    """The routing of a module that holds all its experts and all the
    tokens: no exchange."""
    n_tok = 1

    @staticmethod
    def counts(counts):
        """(the tokens a rank before this one gave each expert, the
        tokens every rank gave each)."""
        return 0, counts

    @staticmethod
    def token_sum(t):
        return t


_ONE_RANK = _OneRank()


class MoEDiTBlock(DiTBlock):
    """``DiTBlock`` with its MLP replaced by a top-1 ``MoEFeedForward``
    (``moe``)."""

    def __init__(self, nembed: int, nheads: int, mlp_factor: int = 4,
                 attn_backend: str = "xla", n_experts: int = 4,
                 capacity_factor: float = 2.0):
        self._moe_args = (n_experts, capacity_factor)
        super().__init__(nembed, nheads, mlp_factor, attn_backend)

    def _build_mlp(self, nembed: int, mlp_factor: int) -> None:
        n_experts, capacity_factor = self._moe_args
        self.moe = MoEFeedForward(nembed, n_experts, mlp_factor,
                                  capacity_factor)

    def mlp(self, h):
        return self.moe(h)


class MoEDiffusionTransformer(DiffusionTransformer):
    """DiT with every ``moe_every``-th block (blocks moe_every - 1,
    2·moe_every - 1, ...) a ``MoEDiTBlock``; the rest are ``DiTBlock``s.
    Same call as ``DiffusionTransformer``."""

    def __init__(self, *, n_experts: int = 4, capacity_factor: float = 2.0,
                 moe_every: int = 2, **kwargs):
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.moe_every = moe_every
        super().__init__(**kwargs)

    def _blocks(self) -> list:
        return [MoEDiTBlock(self.nembed, self.nheads, self.mlp_factor,
                            self.attn_backend, self.n_experts,
                            self.capacity_factor)
                if i % self.moe_every == self.moe_every - 1 else
                DiTBlock(self.nembed, self.nheads, self.mlp_factor,
                         self.attn_backend)
                for i in range(self.nblocks)]

    def export_description(self) -> dict[str, Any]:
        desc = super().export_description()
        desc["kind"] = "moe_dit"
        desc["config"].update(n_experts=self.n_experts,
                              capacity_factor=self.capacity_factor,
                              moe_every=self.moe_every)
        return desc


def moe_aux_loss(net: nn.Module, weight: float = 1e-2):
    """weight·(mean over MoE blocks of their last call's ``aux_loss`` − 1):
    0 at perfectly balanced routing (the JAX package's ``moe_aux_loss``
    over the sown values). 0 when ``net`` has no MoE block, or none has
    run."""
    values = [m.aux_loss for m in net.modules()
              if isinstance(m, MoEFeedForward) and m.aux_loss is not None]
    if not values:
        return torch.zeros(())
    return weight * (torch.stack(values).mean() - 1.0)


__all__ = ["MoEDiTBlock", "MoEDiffusionTransformer", "MoEFeedForward",
           "moe_aux_loss"]
