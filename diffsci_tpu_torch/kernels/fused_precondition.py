"""K1: fused per-batch linear combination, out = a[b]·x + b[b]·f.

Kernel note. Replaces ``diffsci_tpu/kernels/fused_precondition.py:
_axby_kernel`` (through ``fused_axby``/``denoise_combine``), the Karras
denoiser epilogue D = c_skip·x + c_out·F that every sampling step runs.
Source: ``csrc/fused_precondition.cu`` (CUDA C++; Triton would do for a
single elementwise pass, but one build route serves all the port's
kernels).

- What bounds it on the H100: bytes. It reads x and f and writes out once
  (12 bytes per element in f32) and does 3 flops per element, far below
  the card's ~295 flops/byte ridge. At the path's sizes (64·784 or
  4·32768 elements, well under 1 MB) one launch is a few microseconds of
  latency against a sub-microsecond byte bound.
- What the design does about it: one flat grid-stride pass over [B, N]
  with the per-batch coefficients read from [B] f32 device arrays, so
  x and f are each read once. The TPU kernel's N % 128 tiling gate and its
  XLA fallback have no counterpart: the pass takes any N. Products and the
  sum are rounded separately (no FMA), so on f32 inputs the kernel equals
  the plain version bit for bit.
- Gradient: ``FusedAxby``, whose forward is the kernel and whose
  backward is the plain expression of the JAX package's custom VJP
  (``fused_precondition.py:159-168``): dx = a·g, df = b·g, and each
  coefficient's gradient summed against x and f. The JAX package leaves
  that backward to XLA, so here it is plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from diffsci_tpu_torch import kernels
from diffsci_tpu_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"axby_launch": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p])}


def _coeff(c, batch: int, device) -> torch.Tensor:
    """Scalar / [1] / [B] / [B, 1, ...] coefficient -> contiguous [B] f32."""
    c = torch.as_tensor(c, dtype=torch.float32, device=device).reshape(-1)
    return c.expand(batch).contiguous()


def fused_axby_plain(x, f, a, b):
    """The plain PyTorch version: f32 math, output in x.dtype."""
    B = x.shape[0]
    shape = (B,) + (1,) * (x.ndim - 1)
    a = _coeff(a, B, x.device).view(shape)
    b = _coeff(b, B, x.device).view(shape)
    return (a * x.float() + b * f.float()).to(x.dtype)


def fused_axby_fwd(x, f, a, b):
    """out = a[batch]·x + b[batch]·f, f32 math, output in x.dtype.

    x, f: [B, ...] float32 or bfloat16 of one shape; a, b: scalar, [1] or
    [B]. On CPU tensors this is the plain version; on CUDA tensors it
    launches the kernel."""
    if x.device.type == "cpu":
        return fused_axby_plain(x, f, a, b)
    if x.device.type != "cuda" or f.device != x.device:
        raise ValueError(f"fused_axby: x on {x.device}, f on {f.device}; "
                         "both must be on one CUDA device")
    if x.shape != f.shape:
        raise ValueError(f"fused_axby: shapes {tuple(x.shape)} and "
                         f"{tuple(f.shape)} differ")
    if x.dtype not in _DTYPES or f.dtype not in _DTYPES:
        raise TypeError(f"fused_axby: dtypes {x.dtype}, {f.dtype}; "
                        "float32 or bfloat16 only")
    if not (x.is_contiguous() and f.is_contiguous()):
        raise ValueError("fused_axby: x and f must be contiguous")
    B = x.shape[0]
    a32 = _coeff(a, B, x.device)
    b32 = _coeff(b, B, x.device)
    out = torch.empty_like(x)
    total = x.numel()
    if total == 0:
        return out
    lib = _build.load("fused_precondition", _SIGNATURES)
    err = lib.axby_launch(
        x.data_ptr(), f.data_ptr(), a32.data_ptr(), b32.data_ptr(),
        out.data_ptr(), total // B, total, _DTYPES[x.dtype],
        _DTYPES[f.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    kernels.LAUNCHES["fused_axby"] += 1
    _build.check(lib, err, "fused_axby")
    return out


def _coeff_grad(g32, val, coeff, batch: int):
    """Gradient of a per-batch coefficient: the cotangent summed against
    the tensor, folded back to the coefficient's own shape (a scalar or
    [1] coefficient was broadcast over the batch)."""
    d = (g32 * val.float()).reshape(batch, -1).sum(1)
    if coeff.numel() != batch:
        d = d.sum()
    return d.reshape(coeff.shape).to(coeff.dtype)


class FusedAxby(torch.autograd.Function):
    """out = a·x + b·f with K1 as its forward (its plain version on CPU
    tensors) and the plain backward of the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, x, f, a, b):
        ctx.save_for_backward(x, f, a, b)
        return fused_axby_fwd(x, f, a, b)

    @staticmethod
    def backward(ctx, g):
        x, f, a, b = ctx.saved_tensors
        B = x.shape[0]
        shape = (B,) + (1,) * (x.ndim - 1)
        g32 = g.float()
        need = ctx.needs_input_grad
        dx = (_coeff(a, B, x.device).view(shape) * g32).to(x.dtype) \
            if need[0] else None
        df = (_coeff(b, B, x.device).view(shape) * g32).to(f.dtype) \
            if need[1] else None
        da = _coeff_grad(g32, x, a, B) if need[2] else None
        db = _coeff_grad(g32, f, b, B) if need[3] else None
        return dx, df, da, db


def fused_axby(x, f, a, b):
    """``fused_axby_fwd``, differentiable in all four arguments
    (``FusedAxby``). a, b: scalars or tensors (scalar, [1] or [B]). Where
    autograd records nothing (sampling) the forward is called directly,
    without the Function's host time."""
    if not torch.is_grad_enabled():
        return fused_axby_fwd(x, f, a, b)
    device = x.device
    a = a if torch.is_tensor(a) else torch.tensor(float(a), device=device)
    b = b if torch.is_tensor(b) else torch.tensor(float(b), device=device)
    return FusedAxby.apply(x, f, a, b)


def denoise_combine(x, f, c_skip, c_out):
    """D = c_skip·x + c_out·f (the Karras denoiser epilogue)."""
    return fused_axby(x, f, c_skip, c_out)
