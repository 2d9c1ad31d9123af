"""K2's split reduction, rehearsed on the CPU.

The CUDA K2 (``diffsci_tpu_torch/csrc/fused_norm.cu``) holds each row of x
in shared memory and takes the two-pass statistics of the TPU kernel over
it, in pieces: rows of up to 1024 elements are summed by a group of
lanes of one warp (about one 16-byte word a lane); longer rows are split into the slices of a thread-block
cluster, each slice summed by its CTA's threads, and the slices' partial
sums are combined in one fixed order (a warp's shuffle tree over the
ranks), first for the mean and then for the centred sum of squares.
``_emulate_k2`` repeats that split in PyTorch (f32 sums per thread, per
slice, then the tree) with the launch's own choice of slices. It is held against the JAX package's Pallas kernel in
interpret mode (``diffsci_tpu.kernels.fused_norm.norm_silu``, whose two-pass
form the port keeps) and against the port's plain version, at
configuration A's and B's row lengths, ragged rows and an off-centre input.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffsci_tpu.kernels import fused_norm as jfn

from diffsci_tpu_torch.kernels import fused_norm as fn

# fused_norm.cu's launch constants
SMS = 132               # the H100's SMs
WARP_ROW_MAX = 1024     # kWarpRowMax
FILL_WAVES = 2          # kFillWaves
SLICE_BYTES = 128 * 1024
MAX_CLUSTER = 8
SLICE_THREADS = 256


def _slices(rows, row_len, itemsize):
    """(CTAs per row, slice length, threads per CTA) as the launch picks
    them; for the rows kernel one slice (the row, padded to whole 16-byte
    words) and its group of lanes."""
    vec = 16 // itemsize
    if row_len <= WARP_ROW_MAX:
        lanes = 1
        while lanes < 32 and lanes * vec < row_len:
            lanes *= 2
        return 1, -(-row_len // vec) * vec, lanes
    need = -(-row_len * itemsize // SLICE_BYTES)
    assert need <= MAX_CLUSTER, "the stream kernel's rows are not emulated"
    fill = -(-FILL_WAVES * SMS // rows)
    cs = 1
    while cs < MAX_CLUSTER and (cs < need or cs < fill):
        cs *= 2
    sl = -(-(-(-row_len // cs)) // vec) * vec
    return cs, sl, min(SLICE_THREADS, -(-(sl // vec + 1) // 32) * 32)


def _xor_tree(v):
    """The sum a warp's xor-shuffle tree gives over v [..., n ≤ 32] held by
    lanes 0..n-1 (the other lanes hold 0): the lane-0 result of adding
    lane i ^ o for o = 16, 8, 4, 2, 1."""
    lanes = torch.nn.functional.pad(v, (0, 32 - v.shape[-1]))
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32) ^ o]
    return lanes[..., 0]


def _split_sum(v, cs, sl, threads, vec):
    """Row sums of v [R, S] in K2's order: each thread (or lane of a row's
    group) sums its 16-byte words (words t, t + threads, ... of its slice)
    in order; a row's group adds its lanes by a shuffle tree, a CTA its
    threads, and the slices' partials, one per lane, go through a warp's
    shuffle tree."""
    R, S = v.shape
    padded = torch.zeros(R, cs * sl)
    padded[:, :S] = v
    words = padded.view(R, cs, -1, vec).sum(-1)         # [R, cs, words]
    nw = words.shape[-1]
    per = -(-nw // threads)
    words = torch.nn.functional.pad(words, (0, per * threads - nw))
    part = torch.zeros(R, cs, threads)
    for i in range(per):                                # in order
        part = part + words[..., i * threads:(i + 1) * threads]
    if cs == 1 and threads <= 32:
        return _xor_tree(part[:, 0])
    return _xor_tree(part.sum(-1))


def _emulate_k2(x, w, b, kind, eps=1e-5):
    """K2 in float32 on the split above: (y, mean, rstd)."""
    B, C = x.shape[:2]
    xf = x.float().reshape(B * C, -1)
    S = xf.shape[1]
    itemsize = x.element_size()
    cs, sl, threads = _slices(B * C, S, itemsize)
    vec = 16 // itemsize
    if kind == "ln":
        mean = _split_sum(xf, cs, sl, threads, vec) / S
    else:
        mean = torch.zeros(B * C)
    d = xf - mean[:, None]
    rstd = torch.rsqrt(_split_sum(d * d, cs, sl, threads, vec) / S + eps)
    c = torch.arange(B * C) % C
    scale = rstd * w.float()[c]
    u = d * scale[:, None] + b.float()[c][:, None]
    y = u / (1 + torch.exp(-u))
    return (y.to(x.dtype).view(x.shape), mean.view(B, C), rstd.view(B, C))


# configuration A's 32³ rows at serving bucket 1 (a cluster of 8) and its
# 16³ rows at batch 4 (a cluster of 4), B's rows of 784, 196 and 49 (a
# warp each), and ragged rows (1001 for a warp; 5001 for a cluster whose
# last slice is short)
_SHAPES = [(1, 32, 32, 32, 32), (4, 64, 16, 16, 16), (2, 64, 28, 28),
           (2, 128, 14, 14), (2, 256, 7, 7), (2, 3, 1001), (3, 5, 5001)]
# off-centre inputs, |μ| = 100σ: a cluster's row and a warp's
_OFF_CENTRE = [(1, 8, 32, 32, 32), (4, 16, 7, 7)]
_TOL = dict(rtol=2e-5, atol=2e-6)   # tests/test_torch_kernels.py's bound


def _inputs(shape, shift=0.3, scale=2.0):
    """x [B, C, *spatial], w, b [C] in float32."""
    rng = np.random.default_rng(sum(shape))
    C = shape[1]
    x = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    w = (rng.standard_normal(C) * 0.2 + 1).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return x, w, b


def _jax(x, w, b, kind):
    """The JAX Pallas kernel in interpret mode, channels-last at its
    boundary; y back in NC*."""
    y = jfn.norm_silu(jnp.asarray(np.moveaxis(x, 1, -1)), jnp.asarray(w),
                      jnp.asarray(b), kind, interpret=True)
    return np.moveaxis(np.asarray(y), -1, 1)


def _float64(x, w, b, kind, eps=1e-5):
    """y in float64, the two-pass form."""
    B, C = x.shape[:2]
    xr = x.astype(np.float64).reshape(B * C, -1)
    mu = xr.mean(1, keepdims=True) if kind == "ln" else 0.0
    rstd = 1 / np.sqrt(((xr - mu) ** 2).mean(1, keepdims=True) + eps)
    c = np.arange(B * C) % C
    u = (xr - mu) * rstd * w[c][:, None] + b[c][:, None]
    return (u / (1 + np.exp(-u))).reshape(x.shape)


def _check_stats(mean, rstd, rmean, rrstd):
    """chip_smoke.py's gate on K2's statistics: mean within 1e-4 of
    max(1, |mean|), rstd within 1e-4 relative."""
    assert float(((mean - rmean).abs() / rmean.abs().clamp(min=1)).max()) \
        <= 1e-4
    assert float(((rstd - rrstd).abs() / rrstd).max()) <= 1e-4


@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("shape", _SHAPES)
def test_split_reduction_matches_jax_kernel(shape, kind):
    """The emulated K2 against the JAX Pallas kernel: y within rtol 2e-5,
    atol 2e-6."""
    x, w, b = _inputs(shape)
    y, _, _ = _emulate_k2(*(torch.from_numpy(a) for a in (x, w, b)), kind)
    np.testing.assert_allclose(y.numpy(), _jax(x, w, b, kind), **_TOL)


@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("shape", _SHAPES)
def test_split_reduction_matches_plain(shape, kind):
    """The emulated K2 against ``norm_silu_plain`` (whole-row f32 sums): y
    within the same bound, and the statistics within chip_smoke.py's
    gate."""
    xt, wt, bt = (torch.from_numpy(a) for a in _inputs(shape))
    y, mean, rstd = _emulate_k2(xt, wt, bt, kind)
    ry, rmean, rrstd = fn.norm_silu_plain(xt, wt, bt, kind)
    torch.testing.assert_close(y, ry, **_TOL)
    _check_stats(mean, rstd, rmean, rrstd)


@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("shape", _OFF_CENTRE)
def test_split_reduction_off_centre(shape, kind):
    """|μ| = 100σ. Off centre x - μ keeps fewer bits of x: one f32 step of
    |μ| (2^-23·100 = 1.2e-5) times rstd joins the atol, for any f32
    summation order. The emulated K2 and the plain version are held to
    that bound against float64 and against each other; the JAX kernel
    (interpret mode) is itself up to ~4e-4 from float64 at 32³ rows, so
    the emulation is held to lie no farther from it than that error plus
    the bound, and no farther from float64 than it."""
    x, w, b = _inputs(shape, shift=100.0, scale=1.0)
    tol = dict(rtol=2e-5, atol=2e-6 + 2.0 ** -23 * 100.0)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    y, mean, rstd = _emulate_k2(xt, wt, bt, kind)
    ry, rmean, rrstd = fn.norm_silu_plain(xt, wt, bt, kind)
    exact = _float64(x, w, b, kind)
    np.testing.assert_allclose(y.numpy(), exact, **tol)
    np.testing.assert_allclose(ry.numpy(), exact, **tol)
    torch.testing.assert_close(y, ry, **tol)
    _check_stats(mean, rstd, rmean, rrstd)
    jy = _jax(x, w, b, kind)
    jerr = float(np.abs(jy - exact).max())
    assert float(np.abs(y.numpy() - exact).max()) <= jerr + tol["atol"]
    np.testing.assert_allclose(y.numpy(), jy, rtol=tol["rtol"],
                               atol=tol["atol"] + jerr)


def test_launch_shapes():
    """The slices the launch picks at the main paths' shapes: A's 32³ rows
    split over clusters of 8 at serving bucket 1 and of 4 at batch 4, A's
    16³ rows over 8 (bucket 1) or 2 (batch 4); B's rows of 784 and 196
    take a warp each, of 49 a group of 8 lanes; a 1 MB f32 row is the
    longest a cluster holds."""
    assert _slices(32, 32 ** 3, 2) == (8, 4096, 256)
    assert _slices(128, 32 ** 3, 2) == (4, 8192, 256)
    assert _slices(64, 16 ** 3, 2) == (8, 512, 96)
    assert _slices(256, 16 ** 3, 2) == (2, 2048, 256)
    assert _slices(4096, 784, 2) == (1, 784, 32)
    assert _slices(8192, 196, 2) == (1, 200, 32)
    assert _slices(16384, 49, 2) == (1, 56, 8)
    assert _slices(1, 2 ** 18, 4)[0] == MAX_CLUSTER
    with pytest.raises(AssertionError):
        _slices(1, 2 ** 18 + 1, 4)
    assert math.isclose(SLICE_BYTES * MAX_CLUSTER, 2 ** 20)
