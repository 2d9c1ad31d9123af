"""K4: flash-attention forward (online softmax), O and the row logsumexp.

Kernel note. Replaces ``diffsci_tpu/kernels/flash_attention.py:
_fwd_kernel`` (through ``flash_attention``), the PUNetG bottleneck
attention with ``attn_backend='flash'`` at T ≥ 2048 tokens (config A: 16³ =
4096 tokens, head dim 32). Source: ``csrc/flash_attention.cu`` (CUDA C++).

- What bounds it on the H100: operations. 4·T²·d flops against
  (4·T·d + T) elements moved: at T = 4096, d = 32 that is ~1000 flops per
  byte, above the card's ridge, and it grows with T. The [T, T] score
  matrix (64 MB per head in f32) never touches device memory.
- What the design does about it: one block per (batch·head, 64 query rows)
  loops over 64-key tiles of K and V staged in shared memory (converted to
  f32), keeps the running max, running sum and output accumulator in f32
  registers, and writes O and lse once. Scores are taken in the log2
  domain (Q pre-scaled by log2(e)/√d) so each probability is one exp2.
  Four threads share a query row; shared-memory rows are padded so their
  float4 reads are conflict-free. The products run on the FP32 FMA pipes,
  not on the tensor cores: ``wgmma``/``mma.sync`` tiles, TMA loads and
  tuning are later work. Ragged T is masked inside the kernel on query
  rows and keys, with no padding copies; head dims up to 128 are taken by
  zero-padding in shared memory to the next of 16, 32, 64, 128.
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
MAX_HEAD_DIM = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"flash_fwd_launch": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p])}


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


def flash_attention_fwd(q, k, v):
    """Self-attention forward on q, k, v [B, H, T, d] -> (O [B, H, T, d],
    lse [B, H, T] f32). On CPU tensors this is the plain version; on CUDA
    tensors it launches the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one CUDA "
                         "device")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must share one "
                         f"[B, H, T, d] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, T, d = q.shape
    if d > MAX_HEAD_DIM or B * H > 65535:
        raise ValueError(f"flash_attention: head dim {d} (max "
                         f"{MAX_HEAD_DIM}) or B*H {B * H} (max 65535) out "
                         "of range")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; one of float32 or bfloat16")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B * H, T, d, math.log2(math.e) / math.sqrt(d),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    kernels.LAUNCHES["flash_attention"] += 1
    _build.check(lib, err, "flash_attention")
    return o, lse


def flash_attention(q, k, v):
    """Self-attention [B, H, T, d] -> [B, H, T, d]: the flash kernel path
    for T ≥ ``MIN_TOKENS`` (2048), ``dot_product_attention`` below it. The
    gate depends on the shape only."""
    if q.shape[-2] < MIN_TOKENS:
        return dot_product_attention(q, k, v)
    return flash_attention_fwd(q, k, v)[0]
