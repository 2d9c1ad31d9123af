"""The dp × spatial train step: a batch split on its rows over ``data``
and on its first spatial axis over ``spatial``.

The JAX package feeds ``P("data", "spatial")`` batches to its ordinary
train step and lets GSPMD add the convolutions' halos and the sharded
reductions (``tests/test_parallel.py:163-188``). Here, one process a card,
``shard_state_spatial`` swaps the spatial modules of a PUNetG or
PUNetGCond for slab ones in place (the way ``tensor_parallel.py`` swaps
its layers; parameters and names stay), and ``make_train_step`` is used
unchanged from the caller's side on ``shard_batch``'s slabs
(channels-last [B, *spatial, C]: the rows of this rank's ``data`` index,
the slab of its ``spatial`` index along the first spatial axis, H in 2D
and D in 3D; dim 2 of the network's [B, C, *spatial]; PUNetGCond's
channels-first conditions [B or 1, c, *spatial] through
``shard_batch(..., channels_first=True)``, cut along dim 2, a broadcast
row kept). It exists for 3D porous volumes (configurations A and D),
whose activations outgrow one card before the weights do.

What each layer does on a slab of S ranks:
- **Convolutions** (``conv_layer``'s zero-padded ones, ``CircularConv``
  and ``MagnitudePreservingConv``, by its normalized weight; inside
  ``ResnetBlockC``, ``DownSampler``, ``UpSampler``, ``convin``,
  ``convout``): a k×k convolution pads its slab with k//2 planes of each
  neighbour (``_Halo``): every rank all-gathers the boundary planes of
  every rank over the ``spatial`` group, not send/recv (gloo on CUDA
  tensors carries all-gather and aborts on ``batch_isend_irecv``), and
  keeps its neighbours'; the two ends take zeros, or the ring's wrap on a
  circular axis. The backward all-gathers every rank's halo gradients and
  adds the two meant for this rank into its boundary planes. The other
  spatial axes pad as the layer does.
- **Max-pool and nearest upsampling** are local: every level's slab must
  divide by the pool (checked at placement and at each pool).
- **Norms**: the fused G == C norm + SiLU is K2·S forward and K3·S
  backward (``kernels/fused_norm.py:NormSiLUSplit``: the statistics of the
  whole row from all-reduced [B, C] partials); the plain group-norm path
  all-reduces its local partial sums (mean, then the centred squares);
  GroupPix is per pixel and stays local.
- **The EDM batch norm** of the data takes its statistics over every
  rank's rows and slabs: ``replicate`` sets its ``batch_ranks`` to the
  world, and its sums over the ranks count each element once.
- **Bottleneck attention** (``MultiHeadAttention`` and
  ``EinsumMultiHeadAttention``: dot or cosine, magnitude-preserving or
  not, its projections as the module makes them): q, k and v
  all-gathered over ``spatial`` (this rank's tokens are one contiguous
  block of the flattened volume), attention on the whole token set (dot:
  K4 past the same 2048-token gate as the unsharded net, plain below it;
  cosine: plain, as in both packages), this rank's rows of O kept; the
  backward all-gathers dO, runs K5/K6 (or the plain backward) on the
  whole and keeps this rank's slab of dq, dk and dv, the same full
  gradient on every rank, so nothing is reduced. The attention's work is
  repeated on each spatial rank.
- Everything per row (the time and porosity embeddings, the dynamic loss
  weight, the condition drop) or per element is local.

The loss is each rank's mean over its rows and slab; the gradients are
summed over every rank and divided by their number (``Placement``: the
spatial ranks count as copies of the data shard), which gives the global
batch's mean gradient, since each rank's backward already routes the
other ranks' terms through the halos, the statistics and the attention.
σ and the condition-drop mask are the global batch's per row; ε is drawn
one row at a time and each rank keeps its slab of its rows, so no rank
holds the whole global ε (``models/karras/train.py:_draw``).

What still raises under a spatial mesh: an extra residual module, a
network other than PUNetG and PUNetGCond, a latent model, the ensemble,
distill and VAE steps, and an FSDP state. Attention over local queries
only and a spatial sampler are not ported. At one spatial rank the
layers stay as they are (the unsplit K2/K3, no exchange).
"""

from __future__ import annotations

import types

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from diffsci_tpu_torch.kernels import flash_attention, fused_norm
from diffsci_tpu_torch.parallel.mesh import (DATA_AXIS, SPATIAL_AXIS,
                                             axis_index, axis_size)
from diffsci_tpu_torch.parallel.tensor_parallel import Line

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_FN = {2: F.conv2d, 3: F.conv3d}


def _gather(x: torch.Tensor, line: Line) -> list:
    """Every rank's ``x`` of ``line``, in rank order."""
    parts = [torch.empty_like(x) for _ in range(line.n)]
    dist.all_gather(parts, x.contiguous(), group=line.group)
    return parts


class _Halo(torch.autograd.Function):
    """x [B, C, L, ...] (a slab along dim 2) -> [B, C, p + L + p, ...]:
    the last p planes of the previous rank above, the first p planes of
    the next one below; zeros at the two ends, or the ring's wrap when
    ``circular``. Backward: the halos' gradients added into their owners'
    boundary planes."""

    @staticmethod
    def forward(ctx, x, p, line, circular):
        ctx.p, ctx.line, ctx.circular = p, line, circular
        L = x.shape[2]
        ends = _gather(torch.cat([x.narrow(2, 0, p), x.narrow(2, L - p, p)],
                                 dim=2), line)
        prev, nxt = _neighbours(line, circular)
        zeros = x.new_zeros(x.shape[:2] + (p,) + x.shape[3:])
        top = zeros if prev is None else ends[prev].narrow(2, p, p)
        bottom = zeros if nxt is None else ends[nxt].narrow(2, 0, p)
        return torch.cat([top, x, bottom], dim=2)

    @staticmethod
    def backward(ctx, g):
        p, line = ctx.p, ctx.line
        L = g.shape[2] - 2 * p
        halos = _gather(torch.cat([g.narrow(2, 0, p), g.narrow(2, L + p, p)],
                                  dim=2), line)
        prev, nxt = _neighbours(line, ctx.circular)
        dx = g.narrow(2, p, L).clone()
        # my first planes are the previous rank's bottom halo, my last the
        # next rank's top halo
        if prev is not None:
            dx.narrow(2, 0, p).add_(halos[prev].narrow(2, p, p))
        if nxt is not None:
            dx.narrow(2, L - p, p).add_(halos[nxt].narrow(2, 0, p))
        return dx, None, None, None


def _neighbours(line: Line, circular: bool) -> tuple:
    """(the previous rank, the next) of ``line``; None past an end."""
    r, n = line.rank, line.n
    if circular:
        return (r - 1) % n, (r + 1) % n
    return (r - 1 if r > 0 else None), (r + 1 if r < n - 1 else None)


def _halo(x, p, line, circular):
    if x.shape[2] < p:
        raise ValueError(f"a slab of {x.shape[2]} planes is thinner than "
                         f"its convolution's halo of {p}")
    return _Halo.apply(x, p, line, circular)


def _conv_forward(module, x):
    """A zero-padded convolution ('SAME', stride 1) on a slab: the halo
    along dim 2, zeros along the others."""
    p = module.padding[0]
    x = _halo(x, p, module._spatial, False) if p else x
    return _CONV_FN[x.ndim - 2](x, module.weight, module.bias,
                                padding=(0,) + tuple(module.padding[1:]))


def _mp_conv_forward(module, x):
    """``MagnitudePreservingConv`` on a slab: the halo along dim 2, zeros
    along the others, by its effective (normalized) weight."""
    p = module.padding
    x = _halo(x, p, module._spatial, False) if p else x
    return _CONV_FN[x.ndim - 2](x, module.effective_weight(), module.bias,
                                padding=(0,) + (p,) * (x.ndim - 3))


def _circular_forward(module, x):
    """``CircularConv`` on a slab: the halo along dim 2 (the ring's wrap
    when that axis is circular), then the layer's own padding of the
    others."""
    p, nd = module.pad, module.dimension
    if p:
        x = _halo(x, p, module._spatial, 0 in module.circular)
        for d in range(1, nd):
            axis = 2 + d
            if d in module.circular:
                x = torch.cat([x.narrow(axis, x.shape[axis] - p, p), x,
                               x.narrow(axis, 0, p)], dim=axis)
            else:
                pads = [0] * (2 * nd)
                k = 2 * (nd - 1 - d)
                pads[k:k + 2] = [p, p]
                x = F.pad(x, pads)
    return _CONV_FN[nd](x, module.weight, module.bias)


def _down_forward(module, x):
    """``DownSampler``: the pool is local when the slab divides by it."""
    s = module.scale_factor
    if x.shape[2] % s:
        raise ValueError(f"a slab of {x.shape[2]} planes does not divide "
                         f"by the pool {s}")
    from diffsci_tpu_torch.models.nets.layers import _MAX_POOL
    return module.conv(_MAX_POOL[module.dimension](x, s, s))


def _norm_forward(module, x):
    """``_GroupNormBase`` on a slab: the fused G == C norm by K2·S/K3·S,
    the plain path from all-reduced partial sums (two passes: the mean,
    then the centred squares); a per-pixel norm as it is."""
    from torch.distributed.nn.functional import all_reduce
    line = module._spatial
    if not module.spatial:
        return type(module).forward(module, x)
    count = (x.numel() // (x.shape[0] * module.num_groups)) * line.n
    if module.fused:
        kind = "ln" if module.subtract_mean else "rms"

        def reduce(t):
            dist.all_reduce(t, group=line.group)
        return fused_norm.norm_silu_split(
            x.contiguous(), module.weight, module.bias, kind, module.eps,
            reduce, count)
    B, C = x.shape[:2]
    sp = tuple(x.shape[2:])
    G = module.num_groups
    xg = x.reshape((B, G, C // G) + sp)
    dims = tuple(range(2, xg.ndim))
    if module.subtract_mean:
        mean = all_reduce(xg.sum(dim=dims, keepdim=True),
                          group=line.group) / count
        xc = xg - mean
        var = all_reduce((xc * xc).sum(dim=dims, keepdim=True),
                         group=line.group) / count
        xg = xc / torch.sqrt(var + module.eps)
    else:
        ms = all_reduce((xg * xg).sum(dim=dims, keepdim=True),
                        group=line.group) / count
        xg = xg / torch.sqrt(ms + module.eps)
    x = xg.reshape((B, C) + sp)
    if module.affine:
        shape = (1, C) + (1,) * len(sp)
        x = x * module.weight.view(shape) + module.bias.view(shape)
    if module.fuse_silu:
        x = F.silu(x)
    return x


class _GatheredAttention(torch.autograd.Function):
    """Attention for this rank's block of the tokens: q, k and v
    [B, H, T, d] all-gathered over the line (one call), attention over the
    whole token set, this rank's rows of O kept. The core: softmax(q kᵀ/√d)
    v (K4 when ``flash`` and the whole set passes the kernel's gate, else
    the plain attention), or cosine attention (``cosine``; plain, as in
    both packages). Backward: dO all-gathered, K5/K6 (or the plain
    backward) on the whole, this rank's rows of dq, dk and dv kept (every
    rank holds the same full gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, line, flash, cosine=False):
        from diffsci_tpu_torch.models.nets.attention import cosine_attention
        T = q.shape[2]
        qkv = torch.cat(_gather(torch.stack([q, k, v]), line), dim=3)
        qf, kf, vf = (t.contiguous() for t in qkv.unbind(0))
        ctx.line, ctx.T = line, T
        ctx.flash = flash and not cosine and \
            qf.shape[2] >= flash_attention.MIN_TOKENS
        ctx.core = cosine_attention if cosine else \
            flash_attention.dot_product_attention
        if ctx.flash:
            o, lse = flash_attention.flash_attention_fwd(qf, kf, vf)
            ctx.save_for_backward(qf, kf, vf, o, lse)
        else:
            o = ctx.core(qf, kf, vf)
            ctx.save_for_backward(qf, kf, vf)
        return o.narrow(2, line.rank * T, T).contiguous()

    @staticmethod
    def backward(ctx, do):
        line, T = ctx.line, ctx.T
        dof = torch.cat(_gather(do, line), dim=2)
        if ctx.flash:
            grads = flash_attention.flash_attention_bwd(*ctx.saved_tensors,
                                                        dof)
        else:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in
                          ctx.saved_tensors]
                o = ctx.core(*leaves)
                grads = torch.autograd.grad(o, leaves, dof)
        return tuple(g.narrow(2, line.rank * T, T).contiguous()
                     for g in grads) + (None, None, None)


def _attention(module, q, k, v):
    return _GatheredAttention.apply(
        q, k, v, module._spatial, module.backend == "flash",
        getattr(module, "attn_type", "dot") == "cosine")


def _mha_forward(module, x):
    """``MultiHeadAttention`` on this rank's tokens [B, T, C]."""
    B, T, C = x.shape
    H = module.num_heads
    qkv = F.linear(x, module.in_proj_weight, module.in_proj_bias)
    qkv = qkv.view(B, T, 3, H, C // H).permute(2, 0, 3, 1, 4)
    o = _attention(module, qkv[0], qkv[1], qkv[2])
    o = o.transpose(1, 2).reshape(B, T, C)
    return module.out_proj(o)


def _einsum_forward(module, x):
    """``EinsumMultiHeadAttention`` (dot or cosine, magnitude-preserving
    or not: its projections as the module makes them) on this rank's
    tokens."""
    wq, wk, wv, wo = module.projections()
    q, k, v = (torch.einsum("btc,hcd->bhtd", x, w) for w in (wq, wk, wv))
    return torch.einsum("bhtd,hcd->btc", _attention(module, q, k, v), wo)


def _levels(net) -> int:
    """The factor every slab is divided by on the way down: the pools'
    scale to the number of levels, times space_to_depth."""
    cfg = net.config
    return (cfg.transition_scale_factor ** len(cfg.channel_expansion)
            * cfg.space_to_depth)


def _check_net(net: nn.Module) -> nn.Module:
    """The PUNetG or PUNetGCond of a ``KarrasNet`` (or the network
    itself), or raise for what a spatial mesh cannot take."""
    from diffsci_tpu_torch.models.nets.punetg import PUNetG, PUNetGCond
    inner = getattr(net, "model", net)
    if type(inner) not in (PUNetG, PUNetGCond):
        raise NotImplementedError(
            f"a spatial mesh takes PUNetG and PUNetGCond, not "
            f"{type(inner).__name__}")
    if inner.config.dimension not in _CONV:
        raise NotImplementedError("a spatial mesh takes 2D and 3D PUNetG")
    for m in net.modules():
        if getattr(m, "extra_residual", None) is not None:
            raise NotImplementedError("an extra residual module is not "
                                      "ported to a spatial mesh")
    return inner


def _spatial_parallel(net: nn.Module, mesh) -> None:
    """Swap the spatial layers of a PUNetG (``net``: its ``KarrasNet``, or
    the network) for their slab forms over the ``spatial`` axis, in place
    (module docstring); a no-op at one spatial rank."""
    from diffsci_tpu_torch.models.nets.attention import (
        EinsumMultiHeadAttention, MultiHeadAttention)
    from diffsci_tpu_torch.models.nets.layers import (CircularConv,
                                                      DownSampler,
                                                      _GroupNormBase)
    from diffsci_tpu_torch.models.nets.normed import MagnitudePreservingConv
    if axis_size(mesh, SPATIAL_AXIS) == 1:
        return
    line = Line(mesh, SPATIAL_AXIS)
    swaps = ((CircularConv, _circular_forward), (_GroupNormBase,
                                                 _norm_forward),
             (DownSampler, _down_forward), (MultiHeadAttention,
                                            _mha_forward),
             (EinsumMultiHeadAttention, _einsum_forward),
             (MagnitudePreservingConv, _mp_conv_forward))
    for m in net.modules():
        forward = None
        if type(m) in (nn.Conv2d, nn.Conv3d):
            if m.stride != (1,) * len(m.stride) or any(
                    2 * p + 1 != k for p, k in zip(m.padding,
                                                   m.kernel_size)):
                raise NotImplementedError(
                    "a spatial mesh takes stride-1 'SAME' convolutions")
            forward = _conv_forward
        for kind, fn in swaps:
            if isinstance(m, kind):
                forward = fn
        if forward is not None:
            m._spatial = line
            m.forward = types.MethodType(forward, m)


class SpatialLayout:
    """A spatially sharded state's batch layout: S ranks along the
    ``spatial`` axis, this rank's index, and the dim of a channels-last
    batch they split (the first spatial axis)."""
    dim = 1

    def __init__(self, mesh):
        self.n = axis_size(mesh, SPATIAL_AXIS)
        self.index = axis_index(mesh, SPATIAL_AXIS)


@torch.no_grad()
def shard_state_spatial(state, mesh, x_shape):
    """Place a train state over a data × spatial mesh, in place: every
    rank's copy made rank 0's (``replicate``, which also gives the EDM
    batch norm the world's statistics), the network's layers swapped for
    their slab forms, and its step's batch the rows of this rank's
    ``data`` index and the slab of its ``spatial`` index
    (``shard_batch``; PUNetGCond's channel conditions with
    ``channels_first=True``). ``x_shape``: the global batch's
    channels-last shape, whose first spatial axis must divide into slabs
    that every level of the network pools whole. Returns the state."""
    from diffsci_tpu_torch.parallel.mesh import replicate
    if getattr(state.placement, "fsdp_axis", None) is not None:
        raise NotImplementedError("a spatial mesh does not take an FSDP "
                                  "state")
    net = state.module
    inner = _check_net(net)
    n = axis_size(mesh, SPATIAL_AXIS)
    side = int(x_shape[1])
    if side % (n * _levels(inner)):
        raise ValueError(
            f"the first spatial axis ({side}) does not divide into {n} "
            f"slabs that each of the network's levels pools whole (a slab "
            f"must divide by {_levels(inner)})")
    if int(x_shape[0]) % axis_size(mesh, DATA_AXIS):
        raise ValueError(f"batch {x_shape[0]} not divisible by mesh "
                         f"'{DATA_AXIS}' axis size "
                         f"{axis_size(mesh, DATA_AXIS)}")
    replicate(state, mesh)
    state.placement.batch_axes = tuple(
        a for a in (DATA_AXIS,) if a in mesh.mesh_dim_names)
    state.placement.spatial = SpatialLayout(mesh)
    _spatial_parallel(net, mesh)
    return state


__all__ = ["SpatialLayout", "shard_state_spatial"]
