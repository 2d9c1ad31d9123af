"""K2: fused per-channel norm + SiLU forward, y = SiLU(norm(x)·w + b).

Kernel note. Replaces ``diffsci_tpu/kernels/fused_norm.py:_fwd_kernel``
(through ``norm_silu``), the two norm+SiLU pairs of every ResnetBlockC.
Source: ``csrc/fused_norm.cu`` (CUDA C++; Triton would do for a row
reduction plus an elementwise pass, but one build route serves all the
port's kernels). The JAX package keeps its kernel opt-in because Pallas
operands clash with XLA's TPU convolution layouts; nothing of that holds
here, so in the port this kernel is the norm on the card.

- What bounds it on the H100: bytes. Per element it needs one read of x
  and one write of y and does ~10 flops; the statistics are [B, C].
- What the design does about it: on the port's NC* layout each (b, c) is
  one contiguous row of length S = prod(spatial), so one block per row
  streams it with coalesced loads. Pass 1 sums (the mean, 'ln' only),
  pass 2 sums the centred squares (the two-pass variance of the TPU
  kernel, which avoids the cancellation of E[x²] - μ²), pass 3 writes y.
  Passes 2 and 3 re-read a row that the block has just read, which L2
  (50 MB) serves, so device memory sees about one read and one write.
  Rows of any length are streamed, so the TPU's 1 MB slab cap has no
  counterpart (config A's 32³ rows are 32768 long). The block size grows
  with S, from 32 threads (S = 49) to 1024 (S ≥ 4096). Mean and rstd are
  written as [B, C] f32 for the backward of the training slice.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from diffsci_tpu_torch import kernels
from diffsci_tpu_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"norm_silu_fwd_launch": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p])}
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


def norm_silu(x, w, b, kind: str = "ln", eps: float = 1e-5):
    """``norm_silu_fwd`` without the statistics."""
    return norm_silu_fwd(x, w, b, kind, eps)[0]
