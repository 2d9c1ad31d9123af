"""K2 and K3: fused per-channel norm + SiLU, y = SiLU(norm(x)·w + b),
forward (K2) and backward (K3), joined by ``NormSiLU``.

Kernel note. K2 replaces ``diffsci_tpu/kernels/fused_norm.py:_fwd_kernel``
and K3 ``_bwd_kernel`` (through ``norm_silu``, a custom VJP there), the
two norm+SiLU pairs of every ResnetBlockC.
Source: ``csrc/fused_norm.cu`` (CUDA C++; Triton would do for a row
reduction plus an elementwise pass, but one build route serves all the
port's kernels). The JAX package keeps its kernel opt-in because Pallas
operands clash with XLA's TPU convolution layouts; nothing of that holds
here, so in the port this kernel is the norm on the card.

- What bounds it on the H100: bytes. Per element it needs one read of x
  and one write of y and does ~10 flops; the statistics are [B, C].
- What the design does about it: on the port's NC* layout each (b, c) is
  one contiguous row of length S = prod(spatial). K2 reads each element
  of x from device memory once: a block copies its segment of x into
  shared memory (16-byte ``cp.async`` copies, element copies at unaligned
  ends) and takes the two-pass statistics of the TPU kernel over it (the
  mean, then the centred sum of squares, which avoids the cancellation of
  E[x²] - μ² when |μ| ≫ σ), and computes y from there into 16-byte
  stores. The launch picks the shape from S and the row count: rows of
  up to 1024 elements (configuration B's 784, 196, 49) take a group of
  lanes of one warp each (a 16-byte word a lane up to 16 lanes, two
  words a lane beyond: 32 lanes at 784, 16 at 196, 8 at 49), several
  rows a block, with warp-shuffle sums only; rows of up to 4096 (A's
  16³) take one CTA each; longer rows (A's 32³) are split over a
  thread-block cluster of up to 8 CTAs, enough for two waves of the SMs
  (32 rows of 32768 at A's bucket 1 become 256 CTAs), which add their
  partial sums through distributed shared memory in one fixed order.
  Rows beyond a cluster's 1 MB of shared memory (none on the main paths)
  are streamed by one block each, the re-reads served by L2. Sums run in
  a fixed order, so one input gives one result. Mean and rstd are written
  as [B, C] f32 for K3.
- K3 is bound by bytes too: it reads g and x and writes dx (~25 flops
  and 4 SFU operations per element), and reuses the forward's [B, C]
  statistics. It takes K2's launch shapes by the same rule, counting the
  bytes of both arrays (a cluster CTA holds at most 64 KB of each), and
  holds the block's segments of g and x in shared memory at x's
  misalignment, so each element of g and x is read from device memory
  once. Since w is one value per row, mean(dn) = w·Σgu/S and
  mean(dn·n) = w·Σgu·n/S: pass 1 takes the two sums Σgu and Σgu·n (lane
  group, block and cluster sums in a fixed order) over the held values,
  pass 2 writes dx from them in 16-byte stores (the rows kernel keeps
  pass 1's gu as f32 in shared memory; a cluster CTA recomputes it).
  The two sums are also the row's partials of db and dw, written to
  [B, C] f32; their sum over the batch is a plain ``.sum(0)`` outside the
  kernel, as the JAX package sums its kernel's partials outside it. One
  writer per output and no atomics, so one input gives one result. Rows
  beyond a cluster stream g and x twice through L2, as K2's do.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from diffsci_tpu_torch import kernels
from diffsci_tpu_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "norm_silu_fwd_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]),
    "norm_silu_bwd_launch": (ctypes.c_int, [ctypes.c_void_p] * 9 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    # K2·S and K3·S
    "norm_silu_stats_launch": (ctypes.c_int, [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]),
    "norm_silu_apply_launch": (ctypes.c_int, [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]),
    "norm_silu_bwd_partials_launch": (ctypes.c_int, [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]),
    "norm_silu_bwd_dx_launch": (ctypes.c_int, [ctypes.c_void_p] * 9 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])}
_KINDS = ("ln", "rms")


def _threads(row_len: int) -> int:
    threads = 32
    while threads < 1024 and threads * 4 < row_len:
        threads *= 2
    return threads


def norm_silu_plain(x, w, b, kind: str = "ln", eps: float = 1e-5):
    """The plain PyTorch version. Returns (y, mean, rstd), the stats [B, C]
    f32; y in x.dtype."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    B, C = x.shape[:2]
    dims = tuple(range(2, x.ndim))
    xf = x.float()
    if kind == "ln":
        mean = xf.mean(dim=dims, keepdim=True)
        xc = xf - mean
    else:
        mean = torch.zeros((B, C) + (1,) * len(dims), device=x.device)
        xc = xf
    rstd = torch.rsqrt((xc * xc).mean(dim=dims, keepdim=True) + eps)
    shape = (1, C) + (1,) * len(dims)
    u = xc * rstd * w.float().view(shape) + b.float().view(shape)
    return F.silu(u).to(x.dtype), mean.view(B, C), rstd.view(B, C)


def norm_silu_fwd(x, w, b, kind: str = "ln", eps: float = 1e-5):
    """Fused SiLU(norm(x)·w + b) over x [B, C, *spatial], normalising each
    (batch, channel) over the spatial extent. 'ln' subtracts the mean
    (torch GroupNorm with G == C); 'rms' does not. Returns (y, mean, rstd).

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel."""
    if x.device.type == "cpu":
        return norm_silu_plain(x, w, b, kind, eps)
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    if x.device.type != "cuda" or w.device != x.device or \
            b.device != x.device:
        raise ValueError("norm_silu: x, w and b must be on one CUDA device")
    if x.ndim < 3:
        raise ValueError(f"norm_silu: x must be [B, C, *spatial], got "
                         f"{tuple(x.shape)}")
    B, C = x.shape[:2]
    if w.shape != (C,) or b.shape != (C,):
        raise ValueError(f"norm_silu: w, b must be [{C}]")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"norm_silu: x, w, b dtypes {x.dtype}, {w.dtype}, "
                        f"{b.dtype}; one of float32 or bfloat16")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("norm_silu: x, w and b must be contiguous")
    row_len = x.numel() // max(B * C, 1)
    y = torch.empty_like(x)
    mean = torch.empty((B, C), dtype=torch.float32, device=x.device)
    rstd = torch.empty((B, C), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, mean, rstd
    lib = _build.load("fused_norm", _SIGNATURES)
    err = lib.norm_silu_fwd_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), B * C, C, row_len,
        int(kind == "ln"), float(eps), _DTYPES[x.dtype], _threads(row_len),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.LAUNCHES["norm_silu"] += 1
    _build.check(lib, err, "norm_silu")
    return y, mean, rstd


def norm_silu_bwd_plain(g, x, mean, rstd, w, b, kind: str = "ln"):
    """The plain PyTorch version of K3: (dx in x.dtype, dw and db in
    w.dtype) from the cotangent g and the forward's saved tensors."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    B, C = x.shape[:2]
    dims = tuple(range(2, x.ndim))
    stat = (B, C) + (1,) * len(dims)
    shape = (1, C) + (1,) * len(dims)
    wf = w.float().view(shape)
    n = (x.float() - mean.view(stat)) * rstd.view(stat)
    u = n * wf + b.float().view(shape)
    s = torch.sigmoid(u)
    gu = g.float() * (s * (1.0 + u * (1.0 - s)))
    dn = gu * wf
    dx = dn - n * (dn * n).mean(dim=dims, keepdim=True)
    if kind == "ln":
        dx = dx - dn.mean(dim=dims, keepdim=True)
    dx = rstd.view(stat) * dx
    red = (0,) + dims
    return (dx.to(x.dtype), (gu * n).sum(dim=red).to(w.dtype),
            gu.sum(dim=red).to(b.dtype))


def norm_silu_bwd(g, x, mean, rstd, w, b, kind: str = "ln"):
    """K3: the backward of ``norm_silu_fwd``; returns (dx, dw, db). On CPU
    tensors this is the plain version; on CUDA tensors it launches the
    kernel (per-(b, c) partials of dw and db, summed over the batch
    here)."""
    if x.device.type == "cpu":
        return norm_silu_bwd_plain(g, x, mean, rstd, w, b, kind)
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    B, C = x.shape[:2]
    tensors = (g, x, mean, rstd, w, b)
    if any(t.device != x.device for t in tensors) or \
            x.device.type != "cuda":
        raise ValueError("norm_silu_bwd: all tensors must be on one CUDA "
                         "device")
    if g.shape != x.shape or mean.shape != (B, C) or \
            rstd.shape != (B, C) or w.shape != (C,) or b.shape != (C,):
        raise ValueError(f"norm_silu_bwd: shapes g {tuple(g.shape)}, x "
                         f"{tuple(x.shape)}, mean/rstd [{B}, {C}], w/b "
                         f"[{C}] expected")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in
                                     (g, w, b)) or \
            mean.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise TypeError("norm_silu_bwd: g, x, w, b share float32 or "
                        "bfloat16; mean and rstd are float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("norm_silu_bwd: inputs must be contiguous")
    if x.numel() == 0:
        return torch.zeros_like(x), torch.zeros_like(w), torch.zeros_like(b)
    row_len = x.numel() // (B * C)
    dx = torch.empty_like(x)
    dw_part = torch.empty((B, C), dtype=torch.float32, device=x.device)
    db_part = torch.empty((B, C), dtype=torch.float32, device=x.device)
    lib = _build.load("fused_norm", _SIGNATURES)
    err = lib.norm_silu_bwd_launch(
        g.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        w.data_ptr(), b.data_ptr(), dx.data_ptr(), dw_part.data_ptr(),
        db_part.data_ptr(), B * C, C, row_len, int(kind == "ln"),
        _DTYPES[x.dtype], _threads(row_len),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.LAUNCHES["norm_silu_bwd"] += 1
    _build.check(lib, err, "norm_silu_bwd")
    return dx, dw_part.sum(0).to(w.dtype), db_part.sum(0).to(b.dtype)


class NormSiLU(torch.autograd.Function):
    """SiLU(norm(x)·w + b) with K2 as its forward and K3 as its backward
    (their plain versions on CPU tensors). Saves x, w, b and the [B, C]
    f32 statistics."""

    @staticmethod
    def forward(ctx, x, w, b, kind, eps):
        y, mean, rstd = norm_silu_fwd(x, w, b, kind, eps)
        ctx.save_for_backward(x, mean, rstd, w, b)
        ctx.kind = kind
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, w, b = ctx.saved_tensors
        dx, dw, db = norm_silu_bwd(g.contiguous(), x, mean, rstd, w, b,
                                   ctx.kind)
        return dx, dw, db, None, None


def norm_silu(x, w, b, kind: str = "ln", eps: float = 1e-5):
    """SiLU(norm(x)·w + b), differentiable in x, w and b (``NormSiLU``).
    Where autograd records nothing (sampling runs under
    ``torch.inference_mode``) it calls the forward directly and spares
    every call the Function's host time."""
    if not torch.is_grad_enabled():
        return norm_silu_fwd(x, w, b, kind, eps)[0]
    return NormSiLU.apply(x, w, b, kind, eps)


# ---------------------------------------------------------------------------
# K2·S and K3·S: K2 and K3 split around an all-reduce (the spatial mesh)
# ---------------------------------------------------------------------------
# Under a spatial mesh (``parallel/spatial.py``) each (b, c) row lies
# across the ranks of the spatial group, a slab on each, and its statistics
# are the whole row's. K2 and K3 each become two launches with an
# all-reduce of [B, C] f32 partials between them (``NormSiLUSplit``):
# - K2·S: (a) ``norm_silu_stats``: the slab's Σx, all-reduced to the mean,
#   then the slab's Σ(x − mean)², all-reduced to rstd ('ln': two passes,
#   so every rank centres on the same mean and the statistics do not
#   depend on the split beyond rounding; 'rms': Σx² once); (b)
#   ``norm_silu_apply``: y = SiLU((x − mean)·rstd·w + b).
# - K3·S: (a) ``norm_silu_bwd_partials``: the slab's Σgu and Σgu·n, the
#   local partials of db and dw; (b) ``norm_silu_bwd_dx``: dx from their
#   sums over the ranks, dx = rstd·(gu·w − w·Σgu/N − n·w·Σgu·n/N) ('rms'
#   drops the Σgu term), N the whole row's length. dw and db come from the
#   local partials: the train step sums every gradient over the ranks
#   afterwards, so the all-reduced sums would count each S times.
# Source: ``csrc/fused_norm.cu`` beside K2 and K3, whose launch rule and
# 16-byte word paths they take; each row is read once a launch, straight
# from device memory. Bound by bytes: (a) reads x (g and x), (b) reads x
# (g and x) and writes y (dx). On CPU tensors each wrapper is its plain
# version.


def _row_len(x) -> int:
    return x.numel() // max(x.shape[0] * x.shape[1], 1)


def _stats_shape(x) -> tuple:
    return tuple(x.shape[:2]) + (1,) * (x.ndim - 2)


def norm_silu_stats_plain(x, center=None, square: bool = False):
    """K2·S (a)'s plain version: per (b, c), f32 [B, C], Σx over the slab
    (``square`` False), or Σ(x − center)² (``center`` [B, C] f32, or 0
    when None)."""
    dims = tuple(range(2, x.ndim))
    xf = x.float()
    if not square:
        return xf.sum(dim=dims)
    if center is not None:
        xf = xf - center.view(_stats_shape(x))
    return (xf * xf).sum(dim=dims)


def _check_split(what, x, *stats, g=None):
    if x.device.type != "cuda" or x.ndim < 3:
        raise ValueError(f"{what}: x must be a CUDA [B, C, *spatial] tensor")
    if x.dtype not in _DTYPES or (g is not None and (
            g.dtype != x.dtype or g.shape != x.shape)):
        raise TypeError(f"{what}: x (and g) float32 or bfloat16, one shape")
    rows = x.shape[0] * x.shape[1]
    if any(t is not None and (t.dtype != torch.float32 or t.numel() != rows
                              or not t.is_contiguous()
                              or t.device != x.device) for t in stats):
        raise ValueError(f"{what}: statistics must be contiguous float32 "
                         f"[{x.shape[0]}, {x.shape[1]}] on {x.device}")
    if not x.is_contiguous() or (g is not None and not g.is_contiguous()):
        raise ValueError(f"{what}: x (and g) must be contiguous")


def _like_x(g, x):
    """g, or a copy of it at x's offset within a 16-byte word (the split
    K3's word paths read g's words beside x's)."""
    size = x.element_size()
    mis = x.data_ptr() % 16 // size
    if g.data_ptr() % 16 // size == mis:
        return g
    buf = torch.empty(g.numel() + 16 // size, dtype=g.dtype, device=g.device)
    k = (mis - buf.data_ptr() % 16 // size) % (16 // size)
    return buf[k:k + g.numel()].view_as(g).copy_(g)


def norm_silu_stats(x, center=None, square: bool = False):
    """K2·S (a): ``norm_silu_stats_plain`` on CPU tensors; on CUDA tensors
    one launch of the kernel."""
    if x.device.type == "cpu":
        return norm_silu_stats_plain(x, center, square)
    _check_split("norm_silu_stats", x, center)
    out = torch.empty(x.shape[:2], dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out.zero_()
    row_len = _row_len(x)
    lib = _build.load("fused_norm", _SIGNATURES)
    err = lib.norm_silu_stats_launch(
        x.data_ptr(), None if center is None else center.data_ptr(),
        out.data_ptr(), out.numel(), row_len, int(square), _DTYPES[x.dtype],
        _threads(row_len), torch.cuda.current_stream(x.device).cuda_stream)
    kernels.LAUNCHES["norm_silu_stats"] += 1
    _build.check(lib, err, "norm_silu_stats")
    return out


def norm_silu_apply_plain(x, mean, rstd, w, b):
    """K2·S (b)'s plain version: SiLU((x − mean)·rstd·w + b) from the
    [B, C] f32 statistics, in x.dtype (``norm_silu_plain``'s
    arithmetic)."""
    stat = _stats_shape(x)
    shape = (1, x.shape[1]) + (1,) * (x.ndim - 2)
    xc = x.float() - mean.view(stat)
    u = xc * rstd.view(stat) * w.float().view(shape) + b.float().view(shape)
    return F.silu(u).to(x.dtype)


def norm_silu_apply(x, mean, rstd, w, b):
    """K2·S (b): ``norm_silu_apply_plain`` on CPU tensors; on CUDA tensors
    one launch of the kernel."""
    if x.device.type == "cpu":
        return norm_silu_apply_plain(x, mean, rstd, w, b)
    _check_split("norm_silu_apply", x, mean, rstd)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    row_len = _row_len(x)
    lib = _build.load("fused_norm", _SIGNATURES)
    err = lib.norm_silu_apply_launch(
        x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), w.data_ptr(),
        b.data_ptr(), y.data_ptr(), mean.numel(), x.shape[1], row_len,
        _DTYPES[x.dtype], _threads(row_len),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.LAUNCHES["norm_silu_apply"] += 1
    _build.check(lib, err, "norm_silu_apply")
    return y


def _grad_terms(g, x, mean, rstd, w, b):
    """n, gu = g·SiLU'(n·w + b), f32, as ``norm_silu_bwd_plain``."""
    stat = _stats_shape(x)
    shape = (1, x.shape[1]) + (1,) * (x.ndim - 2)
    n = (x.float() - mean.view(stat)) * rstd.view(stat)
    u = n * w.float().view(shape) + b.float().view(shape)
    s = torch.sigmoid(u)
    return n, g.float() * (s * (1.0 + u * (1.0 - s)))


def norm_silu_bwd_partials_plain(g, x, mean, rstd, w, b):
    """K3·S (a)'s plain version: per (b, c), f32 [B, C], (Σgu, Σgu·n) over
    the slab."""
    n, gu = _grad_terms(g, x, mean, rstd, w, b)
    dims = tuple(range(2, x.ndim))
    return gu.sum(dim=dims), (gu * n).sum(dim=dims)


def norm_silu_bwd_partials(g, x, mean, rstd, w, b):
    """K3·S (a): ``norm_silu_bwd_partials_plain`` on CPU tensors; on CUDA
    tensors one launch of the kernel."""
    if x.device.type == "cpu":
        return norm_silu_bwd_partials_plain(g, x, mean, rstd, w, b)
    _check_split("norm_silu_bwd_partials", x, mean, rstd, g=g)
    s_gu, s_gun = (torch.empty(x.shape[:2], dtype=torch.float32,
                               device=x.device) for _ in range(2))
    if x.numel() == 0:
        return s_gu.zero_(), s_gun.zero_()
    g = _like_x(g, x)
    row_len = _row_len(x)
    lib = _build.load("fused_norm", _SIGNATURES)
    err = lib.norm_silu_bwd_partials_launch(
        g.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        w.data_ptr(), b.data_ptr(), s_gu.data_ptr(), s_gun.data_ptr(),
        s_gu.numel(), x.shape[1], row_len, _DTYPES[x.dtype],
        _threads(row_len), torch.cuda.current_stream(x.device).cuda_stream)
    kernels.LAUNCHES["norm_silu_bwd_partials"] += 1
    _build.check(lib, err, "norm_silu_bwd_partials")
    return s_gu, s_gun


def norm_silu_bwd_dx_plain(g, x, mean, rstd, w, b, s_gu, s_gun, count: int,
                           kind: str = "ln"):
    """K3·S (b)'s plain version: dx in x.dtype from the whole row's sums
    ``s_gu`` and ``s_gun`` ([B, C] f32) over ``count`` elements."""
    stat = _stats_shape(x)
    wf = w.float().view((1, x.shape[1]) + (1,) * (x.ndim - 2))
    n, gu = _grad_terms(g, x, mean, rstd, w, b)
    dx = gu * wf - n * (wf * s_gun.view(stat) / count)
    if kind == "ln":
        dx = dx - wf * s_gu.view(stat) / count
    return (rstd.view(stat) * dx).to(x.dtype)


def norm_silu_bwd_dx(g, x, mean, rstd, w, b, s_gu, s_gun, count: int,
                     kind: str = "ln"):
    """K3·S (b): ``norm_silu_bwd_dx_plain`` on CPU tensors; on CUDA
    tensors one launch of the kernel."""
    if x.device.type == "cpu":
        return norm_silu_bwd_dx_plain(g, x, mean, rstd, w, b, s_gu, s_gun,
                                      count, kind)
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    _check_split("norm_silu_bwd_dx", x, mean, rstd, s_gu, s_gun, g=g)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    g = _like_x(g, x)
    row_len = _row_len(x)
    lib = _build.load("fused_norm", _SIGNATURES)
    err = lib.norm_silu_bwd_dx_launch(
        g.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        w.data_ptr(), b.data_ptr(), s_gu.data_ptr(), s_gun.data_ptr(),
        dx.data_ptr(), mean.numel(), x.shape[1], row_len, 1.0 / count,
        int(kind == "ln"), _DTYPES[x.dtype], _threads(row_len),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.LAUNCHES["norm_silu_bwd_dx"] += 1
    _build.check(lib, err, "norm_silu_bwd_dx")
    return dx


def norm_silu_split_fwd(x, w, b, kind, eps, reduce, count: int):
    """K2·S: (y, mean, rstd) of a slab x whose rows continue on other ranks;
    ``reduce(t)`` sums a [B, C] f32 tensor over them in place, ``count``
    is the whole row's length."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    if kind == "ln":
        total = norm_silu_stats(x)
        reduce(total)
        mean = total / count
    else:
        mean = torch.zeros(x.shape[:2], dtype=torch.float32,
                           device=x.device)
    squares = norm_silu_stats(x, mean if kind == "ln" else None, True)
    reduce(squares)
    rstd = torch.rsqrt(squares / count + eps)
    return norm_silu_apply(x, mean, rstd, w, b), mean, rstd


def norm_silu_split_bwd(g, x, mean, rstd, w, b, kind, reduce, count: int):
    """K3·S: (dx, dw, db) of ``norm_silu_split_fwd``; dw and db are this
    slab's partials (the train step sums gradients over the ranks)."""
    s_gu, s_gun = norm_silu_bwd_partials(g, x, mean, rstd, w, b)
    sums = torch.stack([s_gu, s_gun])
    dw, db = s_gun.sum(0).to(w.dtype), s_gu.sum(0).to(b.dtype)
    reduce(sums)
    dx = norm_silu_bwd_dx(g, x, mean, rstd, w, b, sums[0], sums[1], count,
                          kind)
    return dx, dw, db


class NormSiLUSplit(torch.autograd.Function):
    """SiLU(norm(x)·w + b) over rows split across ranks: K2·S forward,
    K3·S backward (their plain versions on CPU tensors), an all-reduce
    (``reduce``) between each pair of halves, in one order on every
    rank."""

    @staticmethod
    def forward(ctx, x, w, b, kind, eps, reduce, count):
        y, mean, rstd = norm_silu_split_fwd(x, w, b, kind, eps, reduce,
                                            count)
        ctx.save_for_backward(x, mean, rstd, w, b)
        ctx.kind, ctx.reduce, ctx.count = kind, reduce, count
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, w, b = ctx.saved_tensors
        dx, dw, db = norm_silu_split_bwd(g.contiguous(), x, mean, rstd, w, b,
                                         ctx.kind, ctx.reduce, ctx.count)
        return dx, dw, db, None, None, None, None


def norm_silu_split(x, w, b, kind: str, eps: float, reduce, count: int):
    """``norm_silu`` of a slab whose rows continue on other ranks
    (``NormSiLUSplit``); the forward alone where autograd records
    nothing."""
    if not torch.is_grad_enabled():
        return norm_silu_split_fwd(x, w, b, kind, eps, reduce, count)[0]
    return NormSiLUSplit.apply(x, w, b, kind, eps, reduce, count)
