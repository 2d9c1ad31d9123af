"""K1 and K7: fused per-batch linear combinations,
out = a[b]·x + b[b]·f (K1) and out = a[b]·x + b[b]·f + c[b]·g (K7).

Kernel note. K1 replaces ``diffsci_tpu/kernels/fused_precondition.py:
_axby_kernel`` (through ``fused_axby``/``denoise_combine``), the Karras
denoiser epilogue D = c_skip·x + c_out·F that every EDM sampling step runs.
K7 replaces ``_lincomb3_kernel`` (through ``fused_lincomb3``), the update
that every DDPM/DDIM step runs (``models/ddpm.py``): a·x + b·ε + c·noise
with the step's coefficients folded to [B]. Source:
``csrc/fused_precondition.cu`` (CUDA C++; Triton would do for a single
elementwise pass, but one build route serves all the port's kernels).

- What bounds them on the H100: at the main paths' sizes, the latency of
  one launch and the host's cost of issuing it. K1 reads x and f and
  writes out once (12 bytes an element in f32) for 3 flops, K7 reads
  three tensors (16 bytes) for 5: far below the card's ~295 flops/byte
  ridge, so bytes bound them in principle. But the paths' launches are
  small (K1 at 1–64 rows of 784 or 1–4 rows of 32768 elements, K7 at
  1–16 rows of 3072), with byte bounds of 0.003–0.47 µs against a
  measured 1.25–1.40 µs a launch, within 0.17 µs of one PyTorch
  elementwise launch over the same bytes (PERF.md §6); the host
  spends 0.015–0.026 ms issuing each one.
- What the design does about it, on the device: the batch row is the
  grid's y index and a chunk of the row its x index, so no element's
  index is divided by N and a thread loads its row's coefficients once,
  beside its first data loads. A thread combines the elements of one
  16-byte word of x and out (``PRECOND_X_BYTES``: 4 in f32, 8 in bf16),
  with word loads and stores of each operand whose row starts on a word
  boundary (16 bytes; 8 for a bf16 operand beside f32 x), and element by
  element elsewhere (unaligned views, rows whose bytes are not a
  multiple of a word, the end of a row). The launch aims at
  ``PRECOND_CTAS`` (64) CTAs of 64 to ``PRECOND_THREADS`` (512) threads,
  a row's threads split evenly over its CTAs: at the paths' sizes one
  wave of 4–64 CTAs in which each thread makes one round of loads
  (1.6–26 % below the grid-stride pass it replaced), and at large sizes
  90 % of the byte bound (66.8 µs against 60.1 at [8, 1, 128³] f32). K7
  is K1's pass with a third term. Each of x, f and g may be f32 or bf16
  on its own, as the JAX kernels cast each one; the TPU kernels'
  N % 128 tiling gate and their XLA fallback have no counterpart.
  Products and sums are rounded separately (no FMA), in the plain
  version's order, so where x is f32 each kernel equals its plain
  version bit for bit.
- On the host (``_launch``): one pass checks device, shape, dtype and
  contiguity; a coefficient that is already a contiguous [B] f32 tensor
  on x's device (every call site's) is passed as it is; the current
  stream is PyTorch's raw handle; the library's ``argtypes`` are set
  once, at load. Sampling calls ``fused_axby_fwd`` or
  ``fused_lincomb3_fwd`` directly (no autograd Function); a call costs
  the host 0.31–0.65× of the plain version's.
- Gradient: ``FusedAxby`` and ``FusedLincomb3``, whose forward is the
  kernel and whose backward is the plain expression of the JAX package's
  custom VJP (``fused_precondition.py:159-168, 237-249``): each tensor's
  gradient is its coefficient times the cotangent, and each coefficient's
  gradient is the cotangent summed against its tensor. The JAX package
  leaves that backward to XLA, so here it is plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from diffsci_tpu_torch import kernels
from diffsci_tpu_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "axby_launch": (ctypes.c_int, [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
    "lincomb3_launch": (ctypes.c_int, [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])}


def _coeff(c, batch: int, device) -> torch.Tensor:
    """Scalar / [1] / [B] / [B, 1, ...] coefficient -> contiguous [B] f32.
    A coefficient that is one already (every call site of the sampling
    loops passes one) is returned as it is, with no tensor operation."""
    if (type(c) is torch.Tensor and c.dtype == torch.float32
            and c.shape == (batch,) and c.device == device
            and c.is_contiguous()):
        return c
    if isinstance(c, (int, float)):
        # a fill on the device, not a copy from the host: a CUDA graph's
        # capture may reach it
        return torch.full((batch,), float(c), dtype=torch.float32,
                          device=device)
    c = torch.as_tensor(c, dtype=torch.float32, device=device).reshape(-1)
    return c.expand(batch).contiguous()


def _combine_plain(tensors, coeffs):
    """sum_i coeffs[i][batch]·tensors[i], f32 math, summed left to right,
    output in the first tensor's dtype."""
    x = tensors[0]
    B = x.shape[0]
    shape = (B,) + (1,) * (x.ndim - 1)
    out = None
    for t, c in zip(tensors, coeffs):
        term = _coeff(c, B, x.device).view(shape) * t.float()
        out = term if out is None else out + term
    return out.to(x.dtype)


def _check(what, tensors):
    """The kernels' contract: one CUDA device, one shape, float32 or
    bfloat16 each, contiguous. One pass over the tensors; the message
    says which part of the contract a call broke."""
    x = tensors[0]
    device, shape = x.device, x.shape
    for t in tensors:
        if (t.device != device or t.shape != shape or t.dtype not in _DTYPES
                or not t.is_contiguous()):
            break
    else:
        if device.type == "cuda":
            return
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: inputs on {[str(t.device) for t in tensors]}"
                         "; all must be on one CUDA device")
    if any(t.shape != x.shape for t in tensors):
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in tensors]}"
                         " differ")
    if any(t.dtype not in _DTYPES for t in tensors):
        raise TypeError(f"{what}: dtypes {[t.dtype for t in tensors]}; "
                        "float32 or bfloat16 only")
    raise ValueError(f"{what}: inputs must be contiguous")


def _launch(what, fn, tensors, coeffs):
    """Check the inputs, fold the coefficients to [B] f32 and launch
    ``fn`` of the library on the current stream, counting the launch
    under ``what``. The stream is PyTorch's raw handle of the device's
    current stream, which builds no ``torch.cuda.Stream`` object."""
    _check(what, tensors)
    x = tensors[0]
    device = x.device
    B = x.shape[0]
    folded = [_coeff(c, B, device) for c in coeffs]
    out = torch.empty_like(x)
    total = x.numel()
    if total == 0:
        return out
    lib = _build.load("fused_precondition", _SIGNATURES)
    err = getattr(lib, fn)(
        *(t.data_ptr() for t in tensors), *(c.data_ptr() for c in folded),
        out.data_ptr(), total // B, total,
        *(_DTYPES[t.dtype] for t in tensors),
        torch._C._cuda_getCurrentRawStream(device.index))
    kernels.LAUNCHES[what] += 1
    _build.check(lib, err, what)
    return out


def _coeff_grad(g32, val, coeff, batch: int):
    """Gradient of a per-batch coefficient: the cotangent summed against
    the tensor, folded back to the coefficient's own shape (a scalar or
    [1] coefficient was broadcast over the batch)."""
    d = (g32 * val.float()).reshape(batch, -1).sum(1)
    if coeff.numel() != batch:
        d = d.sum()
    return d.reshape(coeff.shape).to(coeff.dtype)


def _combine_backward(ctx, g):
    """The JAX package's custom VJP of a per-batch combination, for the
    tensors and coefficients saved as (t_1, ..., t_n, c_1, ..., c_n)."""
    saved = ctx.saved_tensors
    n = len(saved) // 2
    tensors, coeffs = saved[:n], saved[n:]
    x = tensors[0]
    B = x.shape[0]
    shape = (B,) + (1,) * (x.ndim - 1)
    g32 = g.float()
    need = ctx.needs_input_grad
    dts = [(_coeff(c, B, x.device).view(shape) * g32).to(t.dtype)
           if need[i] else None for i, (t, c) in enumerate(zip(tensors,
                                                                coeffs))]
    dcs = [_coeff_grad(g32, t, c, B) if need[n + i] else None
           for i, (t, c) in enumerate(zip(tensors, coeffs))]
    return (*dts, *dcs)


def _as_tensor(c, device):
    """A 0-d f32 tensor for a number, by a fill on the device (safe inside
    a capture); tensors as they are."""
    return c if torch.is_tensor(c) else torch.full((), float(c),
                                                   device=device)


# ---------------------------------------------------------------------------
# K1: a·x + b·f
# ---------------------------------------------------------------------------
def fused_axby_plain(x, f, a, b):
    """The plain PyTorch version: f32 math, output in x.dtype."""
    return _combine_plain((x, f), (a, b))


def fused_axby_fwd(x, f, a, b):
    """out = a[batch]·x + b[batch]·f, f32 math, output in x.dtype.

    x, f: [B, ...] float32 or bfloat16 of one shape; a, b: scalar, [1] or
    [B]. On CPU tensors this is the plain version; on CUDA tensors it
    launches the kernel."""
    if x.device.type == "cpu":
        return fused_axby_plain(x, f, a, b)
    return _launch("fused_axby", "axby_launch", (x, f), (a, b))


class FusedAxby(torch.autograd.Function):
    """out = a·x + b·f with K1 as its forward (its plain version on CPU
    tensors) and the plain backward of the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, x, f, a, b):
        ctx.save_for_backward(x, f, a, b)
        return fused_axby_fwd(x, f, a, b)

    backward = staticmethod(_combine_backward)


def fused_axby(x, f, a, b):
    """``fused_axby_fwd``, differentiable in all four arguments
    (``FusedAxby``). a, b: scalars or tensors (scalar, [1] or [B]). Where
    autograd records nothing (sampling) the forward is called directly,
    without the Function's host time."""
    if not torch.is_grad_enabled():
        return fused_axby_fwd(x, f, a, b)
    return FusedAxby.apply(x, f, _as_tensor(a, x.device),
                           _as_tensor(b, x.device))


def denoise_combine(x, f, c_skip, c_out):
    """D = c_skip·x + c_out·f (the Karras denoiser epilogue)."""
    return fused_axby(x, f, c_skip, c_out)


def euler_update(x, f, c_skip, c_out, t, t_next):
    """Fused denoise + Euler ODE step, one K1 launch:
    x' = x + (t_next − t)/t · (x − D),  D = c_skip·x + c_out·f,
    folded to a·x + b·f with r = (t_next − t)/t, a = 1 + r(1 − c_skip)
    and b = −r·c_out. c_skip, c_out, t and t_next: scalars or [B].

    For custom sampling loops that call the raw network and want the
    whole Karras-ODE Euler step in one pass; the stock integrators
    (``ops/integrators.py``) are generic over an rhs closure and do not
    call it, as in the JAX package."""
    r = (t_next - t) / t
    return fused_axby(x, f, 1.0 + r * (1.0 - c_skip), -r * c_out)


# ---------------------------------------------------------------------------
# K7: a·x + b·f + c·g
# ---------------------------------------------------------------------------
def fused_lincomb3_plain(x, f, g, a, b, c):
    """The plain PyTorch version: (a·x + b·f) + c·g in f32, output in
    x.dtype."""
    return _combine_plain((x, f, g), (a, b, c))


def fused_lincomb3_fwd(x, f, g, a, b, c):
    """out = a[batch]·x + b[batch]·f + c[batch]·g, f32 math, output in
    x.dtype: the DDPM/DDIM update a·x + b·ε + c·noise.

    x, f, g: [B, ...] of one shape, each float32 or bfloat16; a, b, c:
    scalar, [1] or [B]. On CPU tensors this is the plain version; on CUDA
    tensors it launches the kernel."""
    if x.device.type == "cpu":
        return fused_lincomb3_plain(x, f, g, a, b, c)
    return _launch("fused_lincomb3", "lincomb3_launch", (x, f, g), (a, b, c))


class FusedLincomb3(torch.autograd.Function):
    """out = a·x + b·f + c·g with K7 as its forward (its plain version on
    CPU tensors) and the plain backward of the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, x, f, g, a, b, c):
        ctx.save_for_backward(x, f, g, a, b, c)
        return fused_lincomb3_fwd(x, f, g, a, b, c)

    backward = staticmethod(_combine_backward)


def fused_lincomb3(x, f, g, a, b, c):
    """``fused_lincomb3_fwd``, differentiable in all six arguments
    (``FusedLincomb3``). Where autograd records nothing (sampling) the
    forward is called directly, without the Function's host time."""
    if not torch.is_grad_enabled():
        return fused_lincomb3_fwd(x, f, g, a, b, c)
    return FusedLincomb3.apply(x, f, g, *(_as_tensor(v, x.device)
                                          for v in (a, b, c)))
