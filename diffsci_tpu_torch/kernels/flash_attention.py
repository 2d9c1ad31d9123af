"""K4, K5 and K6: flash attention (online softmax), forward and backward,
joined by ``FlashAttention``.

Kernel note. K4 replaces ``diffsci_tpu/kernels/flash_attention.py:
_fwd_kernel``, K5 ``_dq_kernel`` and K6 ``_dkv_kernel`` (through
``flash_attention``, a custom VJP there): the PUNetG bottleneck attention
with ``attn_backend='flash'`` at T ≥ 2048 tokens (config A: 16³ = 4096
tokens, head dim 32; DiT-B's 12 heads of 64, configuration H). Sources:
``csrc/flash_attention.cu`` (K4) and ``csrc/flash_attention_bwd.cu`` (K5,
K6), CUDA C++; the ``mma.sync`` pieces in ``csrc/flash_mma.cuh``, the
``wgmma``/TMA pieces of the narrow and wide routes in
``csrc/flash_wgmma.cuh``, the f32 tile layout and dispatch in
``csrc/flash_common.cuh``.

- What bounds them on the H100: operations. K4 does 4·T²·d flops, K5
  6·T²·d and K6 8·T²·d per head against (4·T·d + T) elements moved: at
  T = 4096, d = 32 that is ~1000 flops per byte, above the card's ridge.
  Each also takes T² exponentials on the special-function unit, 16 per
  clock per SM: at d = 32 that floor (~0.032 ms at config A's shape) lies
  above the tensor cores' (0.017 ms for K4), at d = 64 the two are about
  equal (0.193 against 0.209 ms at H's). The [T, T] score matrix never
  touches device memory.
- Routes, by a shape rule in the launchers (a call is one launch either
  way): bf16 K4 at d 32, 64 and 128 and bf16 K5 and K6 at d 32 and 64, on
  rows that TMA can read (d % 8 = 0, 16-byte aligned bases), take the
  narrow ``wgmma`` kernels; bf16 K4, K5 and K6 at the other d ≤ 128 (K5
  and K6 at d 128 among them) or on unaligned bases take the
  ``mma.sync`` kernels; f32 the FP32 pipes; d above 128 the wide
  kernels. A build with
  ``-DFLASH_WGMMA_MIN_DIM=129`` sends every d ≤ 128 to ``mma.sync``
  (``scripts/torch_flash_variants.py --set narrow`` times the two routes
  side by side).
- bfloat16, the narrow route: warp-specialised, as the wide route below.
  K4 (``flash_fwd_narrow_kernel``): a producer warp issues TMA copies of
  128-key K and V tiles (one box a tile: 64-column rows with the 128-byte
  swizzle, 32-column rows with the 64-byte swizzle at d 32) into a ring
  of three stages with full and empty mbarriers; each consumer warpgroup
  owns 64 query rows for the whole loop (three warpgroups a block at d
  64, one at d 32, where two blocks share an SM; two at d 128), with Q
  staged once and ``setmaxnreg`` giving it the producer's registers. It
  issues S_j = Q K_jᵀ (``wgmma`` m64n128k16) and O += P_{j−1} V_{j−1}
  (P from registers, V transposed by the descriptor) together and runs
  the online softmax of S_j while P_{j−1} V_{j−1} is in flight, so its
  exponentials overlap the tensor cores. K5 (``flash_dq_narrow_kernel``):
  the same producer and ring for K and V; each consumer warpgroup owns 64
  query rows end to end (one a block at d 32, two blocks an SM; two at d
  64), Q and dO staged once and its rows' lse·log2 e and delta in
  registers. It issues S_j = Q K_jᵀ and dP_j = dO V_jᵀ (``wgmma``
  m64n128k16, both from shared memory) together with dQ +=
  bf16(dS_{j−1}) K_{j−1} (dS from registers, K transposed by the
  descriptor) and forms P_j and dS_j = P_j∘(dP_j − delta) in f32 while
  that product is in flight. K6 (``flash_dkv_narrow_kernel``):
  one block of 128 keys, K and V staged once, Q and dO streamed in
  64-query tiles with their lse and delta; each of two consumer
  warpgroups owns 64 keys end to end (Sᵀ, dPᵀ, dK and dV all fit its
  registers), so nothing passes between them.
- bfloat16, K4, K5 and K6 on ``mma.sync`` (m16n8k16, f32
  accumulators). A block of 4 warps owns 64 rows of its own side (K4 and
  K5: queries, K6: keys), 16 per warp, and loops over tiles of the other
  side that stream through a double-buffered ``cp.async`` ring in bf16
  shared memory, so the next tile loads while this one computes. K4 keeps
  its Q fragments in registers, takes S = Q Kᵀ, runs the online softmax
  (running max and sum in f32, row reductions by quad shuffles) on the C
  fragments and feeds P, rounded to bf16 in registers, as the A operand
  of P V: the FlashAttention-2 repacking, nothing goes through shared
  memory. K5 keeps its Q and dO fragments in registers and takes
  S = Q Kᵀ, dP = dO Vᵀ, P = exp2(S·scale·log2 e − lse·log2 e),
  dS = P∘(dP − delta) and dQ += dS K with K through ``ldmatrix.trans``;
  its key tile shrinks at d = 128 to keep S, dP and dQ in registers. K6
  takes Sᵀ = K Qᵀ, Pᵀ = exp2(Sᵀ·scale·log2 e − lse·log2 e), dV += Pᵀ dO,
  dPᵀ = V dOᵀ, dSᵀ = Pᵀ∘(dPᵀ − delta) and dK += dSᵀ Q, reading Q and dO
  plainly and transposed (``ldmatrix.trans``) from one shared tile. dQ,
  dK and dV stay in f32 registers and are written once. bf16 rounding
  happens where the Pallas kernels cast before the MXU (P before P·V,
  ``flash_attention.py:106``; dS before dS·K, ``:179``; P and dS before
  dV and dK, ``:209, 211``), so the port rounds as the JAX reference
  does. Rows that are not 16-byte aligned (d % 8 ≠ 0) are staged by
  element loads in the same kernels. The narrow route rounds at the same
  points.
- float32: the FP32 pipes. One block per (batch·head, 64 rows) loops over
  64-row tiles of the other side staged in shared memory; four threads
  share a row, each scoring a quarter of the other tile and owning a
  quarter of the output columns. f32 stays there so that the f32 path
  keeps full f32 products: TF32 or bf16 tensor cores would not hold the
  1e-4 checks against the plain versions.
- Backward: the forward saves O and the natural-log lse; delta =
  rowsum(dO∘O) is one plain f32 reduction outside the kernels, as in the
  JAX package. P is recomputed tile by tile from lse, so no [T, T] matrix
  is stored. The TPU kernels carry their sums across a sequential grid
  axis; here that axis is a loop inside the block (K5's block owns query
  rows, K6's key rows). Each output tile has one writer and no atomics,
  so one input gives one result, bit for bit.
- All of them mask ragged T inside the kernel (rows past T load as zeros
  and are never stored; K4's keys past T score −inf) with no padding
  copies, and take head dims up to 128 by zero-padding in shared memory to
  the next of 16, 32, 64, 128. Each wrapper call is one kernel launch.
- Head dims above 128 (ADM's single 256-channel head, any d the JAX
  kernel takes), the wide kernels, in the same sources; the launcher
  picks one by a shape rule, and a call is one launch either way:
  - bf16 K4, K5 and K6 on rows that TMA can read (d % 8 = 0, 16-byte
    aligned bases) up to d 512: warp-specialised ``wgmma`` kernels, as
    the TPU kernel takes the full head dim per block. One producer
    warpgroup issues TMA copies of 64 × 64 slices (128-byte swizzle; rows
    past T and columns past d read as zeros) into rings of shared-memory
    stages with full/empty mbarriers; two consumer warpgroups compute the
    scores once per tile over all of d on ``wgmma`` m64n64k16 and keep
    the output in f32 registers (``setmaxnreg`` 240). Above d 256 the
    output is split into 192- or 256-column chunks (grid z), so the
    score work is at most twice the minimum at d 512. K4: 128 query rows
    a block, 64 a warpgroup, Q staged once; its online softmax is the
    ``mma.sync`` kernel's, on the ``wgmma`` accumulator (the same row
    layout), with P rounded to bf16 in registers as the A operand of
    P·V. K5 up to d 256 (``flash_dq_wgmma_kernel``): K4's layout,
    Q and dO staged once, K and V slices streamed; each warpgroup takes
    S = Q Kᵀ and dP = dO Vᵀ, P, dS = P∘(dP − delta) in f32 and
    dQ += bf16(dS) K (K transposed by the descriptor) for its own 64
    rows with no handoff, so one warpgroup's exponentials overlap the
    other's products. K5 above d 256 (``flash_dq_wgmma_pair_kernel``: Q
    and dO of 128 rows would not fit): 64 query rows a block, one warpgroup
    takes S and P, the other dP and dS with the f32 P handed over
    through shared memory, bf16(dS) goes back the same way, and each
    takes half of the chunk's dQ columns. K6: one 64-key block, K and V
    staged once; one warpgroup takes Sᵀ = K Qᵀ, Pᵀ and
    dV += bf16(Pᵀ) dO, the other dPᵀ = V dOᵀ, dSᵀ = Pᵀ∘(dPᵀ − delta)
    with the f32 Pᵀ handed over through shared memory, and
    dK += bf16(dSᵀ) Q.
  - Everything else above 128 (f32, unaligned bf16 rows such as d 260,
    d > 512): one kernel per K4, K5, K6 and dtype. A
    block owns one 128-column chunk of the output (grid z) and sums
    S = Q Kᵀ (and dP = dO Vᵀ) over 128-column chunks of d staged one at a
    time in shared memory, so neither shared memory nor registers grow
    with d; bf16 on ``mma.sync`` with 32-row tiles of the other side, f32
    on the FP32 pipes in the layout above. Each chunk's block recomputes
    its rows' scores: ⌈d/128⌉ times the minimum score work.
  The bf16 roundings are the same on both routes (P before P·V and dV,
  dS before dQ and dK).
"""

from __future__ import annotations

import ctypes
import math

import torch

from diffsci_tpu_torch import kernels
from diffsci_tpu_torch.kernels import _build

# The JAX package's shape gate (measured on its TPU); kept so both packages
# take the same path for the same shapes. Below it, attention is the plain
# PyTorch ``dot_product_attention``.
MIN_TOKENS = 2048

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SIGNATURES = {"flash_fwd_launch": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p])}
_BWD_TAIL = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_void_p]
BWD_SIGNATURES = {
    "flash_dq_launch": (ctypes.c_int, [ctypes.c_void_p] * 7 + _BWD_TAIL),
    "flash_dkv_launch": (ctypes.c_int, [ctypes.c_void_p] * 8 + _BWD_TAIL)}


def dot_product_attention(q, k, v):
    """softmax(q kᵀ / √d) v in the input dtype; q, k, v: [..., T, d]."""
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(logits, dim=-1), v)


def flash_attention_plain(q, k, v):
    """The plain PyTorch version of the kernel: f32 math, O in q.dtype and
    lse [B, H, T] f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(
        q.shape[-1])
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype), lse


def _check(what, q, *others):
    """The kernels' contract: one CUDA device, one [B, H, T, d] shape with
    B·H ≤ 65535 (any d), float32 or bfloat16, contiguous."""
    tensors = (q,) + others
    if q.device.type != "cuda" or any(t.device != q.device
                                       for t in others):
        raise ValueError(f"{what}: inputs must be on one CUDA device")
    if q.ndim != 4 or any(t.shape != q.shape for t in others):
        raise ValueError(f"{what}: inputs must share one [B, H, T, d] "
                         f"shape, got {[tuple(t.shape) for t in tensors]}")
    B, H, T, d = q.shape
    if B * H > 65535:
        raise ValueError(f"{what}: B*H {B * H} exceeds the kernels' grid "
                         "limit of 65535")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in others):
        raise TypeError(f"{what}: dtypes {[t.dtype for t in tensors]}; one "
                        "of float32 or bfloat16")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")


def _check_rows(what, q, *rows):
    """lse / delta: f32 [B, H, T] on q's device, contiguous."""
    if any(r.shape != q.shape[:3] or r.dtype != torch.float32
           or r.device != q.device or not r.is_contiguous() for r in rows):
        raise ValueError(f"{what}: lse and delta must be contiguous float32 "
                         f"{tuple(q.shape[:3])} on {q.device}")


def flash_attention_fwd(q, k, v):
    """Self-attention forward on q, k, v [B, H, T, d] -> (O [B, H, T, d],
    lse [B, H, T] f32). On CPU tensors this is the plain version; on CUDA
    tensors it launches the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    _check("flash_attention", q, k, v)
    B, H, T, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    lib = _build.load("flash_attention", SIGNATURES)
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B * H, T, d, math.log2(math.e) / math.sqrt(d),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    kernels.LAUNCHES["flash_attention"] += 1
    _build.check(lib, err, "flash_attention")
    return o, lse


def _probs_and_ds(q, k, v, do, lse, delta):
    """f32 P = exp(q kᵀ/√d − lse) and dS = P∘(dO vᵀ − delta), recomputed
    from the forward's lse as the kernels do."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2))
                  * scale - lse.unsqueeze(-1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta.unsqueeze(-1)), scale


def flash_attention_dq_plain(q, k, v, do, lse, delta):
    """The plain PyTorch version of K5: dQ = dS K/√d, f32 math, in
    q.dtype."""
    _, ds, scale = _probs_and_ds(q, k, v, do, lse, delta)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta):
    """The plain PyTorch version of K6: (dK = dSᵀ Q/√d, dV = Pᵀ dO), f32
    math, in q.dtype."""
    p, ds, scale = _probs_and_ds(q, k, v, do, lse, delta)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """The plain PyTorch version of the backward, from the forward's saved
    O and lse: delta = rowsum(dO∘O) in f32, then K5's and K6's plain
    versions -> (dQ, dK, dV) in q.dtype."""
    delta = (do.float() * o.float()).sum(-1)
    return (flash_attention_dq_plain(q, k, v, do, lse, delta),
            *flash_attention_dkv_plain(q, k, v, do, lse, delta))


def _launch_bwd(fn, name, q, k, v, do, lse, delta, outs):
    B, H, T, d = q.shape
    lib = _build.load("flash_attention_bwd", BWD_SIGNATURES)
    err = getattr(lib, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
        B * H, T, d, 1.0 / math.sqrt(d), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.LAUNCHES[name] += 1
    _build.check(lib, err, name)


def flash_attention_dq(q, k, v, do, lse, delta):
    """K5: dQ [B, H, T, d] from q, k, v, dO and the f32 [B, H, T] lse and
    delta = rowsum(dO∘O). CUDA tensors only."""
    _check("flash_attention_dq", q, k, v, do)
    _check_rows("flash_attention_dq", q, lse, delta)
    dq = torch.empty_like(q)
    if q.numel():
        _launch_bwd("flash_dq_launch", "flash_attention_dq", q, k, v, do,
                    lse, delta, (dq,))
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta):
    """K6: (dK, dV) [B, H, T, d] from the same inputs as K5. CUDA tensors
    only."""
    _check("flash_attention_dkv", q, k, v, do)
    _check_rows("flash_attention_dkv", q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        _launch_bwd("flash_dkv_launch", "flash_attention_dkv", q, k, v, do,
                    lse, delta, (dk, dv))
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do):
    """Backward of ``flash_attention_fwd`` -> (dQ, dK, dV). On CPU tensors
    this is the plain version; on CUDA tensors delta = rowsum(dO∘O) is one
    f32 reduction and K5 and K6 are launched."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    do = do.to(q.dtype).contiguous()
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_attention_dq(q, k, v, do, lse, delta)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """softmax(q kᵀ/√d) v with K4 as its forward and K5/K6 as its backward
    (their plain versions on CPU tensors). Saves q, k, v, O and lse."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return flash_attention_bwd(*ctx.saved_tensors, do)


def flash_attention(q, k, v):
    """Self-attention [B, H, T, d] -> [B, H, T, d], differentiable: the
    flash kernels (``FlashAttention``) for T ≥ ``MIN_TOKENS`` (2048),
    ``dot_product_attention`` below it. The gate depends on the shape
    only. Where autograd records nothing (sampling) the forward is called
    directly, without the Function's host time."""
    if q.shape[-2] < MIN_TOKENS:
        return dot_product_attention(q, k, v)
    if not torch.is_grad_enabled():
        return flash_attention_fwd(q, k, v)[0]
    return FlashAttention.apply(q, k, v)
