"""K2's and K3's split reductions, rehearsed on the CPU.

The CUDA K2 (``diffsci_tpu_torch/csrc/fused_norm.cu``) holds each row of x
in shared memory and takes the two-pass statistics of the TPU kernel over
it, in pieces: rows of up to 1024 elements are summed by a group of
lanes of one warp (a 16-byte word or two a lane); rows of up to 4096 by
one CTA; longer rows are split into the slices of a thread-block
cluster, each slice summed by its CTA's threads, and the slices' partial
sums are combined in one fixed order (a warp's shuffle tree over the
ranks), first for the mean and then for the centred sum of squares.
``_emulate_k2`` repeats that split in PyTorch (f32 sums per thread, per
slice, then the tree) with the launch's own choice of slices. It is held against the JAX package's Pallas kernel in
interpret mode (``diffsci_tpu.kernels.fused_norm.norm_silu``, whose two-pass
form the port keeps) and against the port's plain version, at
configuration A's and B's row lengths, ragged rows and an off-centre input.

K3 takes the same launch shapes, counting both of its arrays (g and x),
and sums gu and gu·n over the held values. ``_emulate_k3`` repeats its
order exactly: each lane's or thread's f32 sums over its 16-byte words
element by element, at the row's own offset within its first word, then
the lane group's shuffle tree, or the warps', the block's and the
cluster ranks' trees. It is held against ``jax.grad`` through the JAX
kernel's custom VJP (its Pallas kernels in interpret mode) and against
``norm_silu_bwd_plain``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu.kernels import fused_norm as jfn

from diffsci_tpu_torch.kernels import fused_norm as fn
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

# fused_norm.cu's launch constants
SMS = 132               # the H100's SMs
WARP_ROW_MAX = 1024     # kWarpRowMax
WORDS_PER_LANE = 2      # kWordsPerLane, beyond 16 lanes a row
BLOCK_ROW_MAX = 4096    # kBlockRowMax
FILL_WAVES = 1          # kFillWaves
SLICE_BYTES = 128 * 1024
MAX_CLUSTER = 8
SLICE_THREADS = 256


def _slices(rows, row_len, itemsize, arrays=1):
    """(CTAs per row, slice length, threads per CTA) as the launch picks
    them for K2 (arrays = 1: x) or K3 (arrays = 2: g and x); for the rows
    kernels one slice (the row, padded to whole 16-byte words) and its
    group of lanes."""
    vec = 16 // itemsize
    if row_len <= WARP_ROW_MAX:
        lanes = 1
        while lanes < 16 and lanes * vec < row_len:
            lanes *= 2
        while lanes < 32 and lanes * WORDS_PER_LANE * vec < row_len:
            lanes *= 2
        return 1, -(-row_len // vec) * vec, lanes
    need = -(-arrays * row_len * itemsize // SLICE_BYTES)
    assert need <= MAX_CLUSTER, "the stream kernel's rows are not emulated"
    fill = 1 if row_len <= BLOCK_ROW_MAX else -(-FILL_WAVES * SMS // rows)
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


def _unit_sums(v, off, units, vec):
    """Each unit's (lane's or thread's) f32 sum over v [R, n], element by
    element in K3's order: element j of a row lies at offset off + j of
    the 16-byte words from the row's first one (off [R], the row's
    misalignment), and unit u takes words u, u + units, ... Zeros fill
    the gaps, which leaves every f32 sum as it is."""
    R, n = v.shape
    pos = off[:, None] + torch.arange(n)
    word = pos // vec
    unit = word % units
    seq = word // units * vec + pos % vec
    held = torch.zeros(R, units, int(seq.max()) + 1)
    held[torch.arange(R)[:, None], unit, seq] = v
    s = torch.zeros(R, units)
    for k in range(held.shape[-1]):                     # in order
        s = s + held[..., k]
    return s


def _k3_sum(v, off, cs, sl, units, vec):
    """Row sums of v [R, S] in K3's order: a rows kernel's group of lanes
    adds its lanes by a shuffle tree; a cluster CTA adds its threads by
    each warp's tree, then the warps' tree, and the ranks' partials go
    through a warp's tree."""
    R, S = v.shape
    if S <= WARP_ROW_MAX:
        return _xor_tree(_unit_sums(v, off, units, vec))
    padded = torch.zeros(R, cs * sl)
    padded[:, :S] = v
    part = _unit_sums(padded.view(R * cs, sl), off.repeat_interleave(cs),
                      units, vec)
    block = _xor_tree(_xor_tree(part.view(R * cs, -1, 32)))
    return _xor_tree(block.view(R, cs))


def _emulate_k3(g, x, mean, rstd, w, b, kind):
    """K3 in float32 on its launch's split, from the forward's statistics
    mean, rstd [B, C]: (dx, dw, db). Since w is one value per row,
    mean(dn) = w·Σgu/S and mean(dn·n) = w·Σgu·n/S, as the kernel takes
    them; dw and db sum the rows' partials over the batch."""
    B, C = x.shape[:2]
    R = B * C
    xf, gf = x.float().reshape(R, -1), g.float().reshape(R, -1)
    S = xf.shape[1]
    vec = 16 // x.element_size()
    cs, sl, units = _slices(R, S, x.element_size(), arrays=2)
    c = torch.arange(R) % C
    wc, bc, r = w.float()[c], b.float()[c], rstd.reshape(R)
    n = (xf - mean.reshape(R, 1)) * r[:, None]
    u = n * wc[:, None] + bc[:, None]
    sg = 1 / (1 + torch.exp(-u))
    gu = gf * (sg * (u * (1 - sg) + 1))
    off = torch.arange(R) * S % vec        # the rows' misalignment
    s_gu = _k3_sum(gu, off, cs, sl, units, vec)
    s_gun = _k3_sum(gu * n, off, cs, sl, units, vec)
    inv_n = torch.tensor(1.0 / S, dtype=torch.float32)
    m_dn = wc * s_gu * inv_n if kind == "ln" else torch.zeros(R)
    m_dnn = wc * s_gun * inv_n
    dx = gu * (r * wc)[:, None] + (n * (-r * m_dnn)[:, None]
                                   + (-r * m_dn)[:, None])
    return (dx.to(x.dtype).view(x.shape), s_gun.view(B, C).sum(0).to(w.dtype),
            s_gu.view(B, C).sum(0).to(b.dtype))


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


def _k3(g, x, w, b, kind):
    """The emulated K3 on the emulated K2's statistics, and the plain
    version on the same statistics."""
    gt, xt, wt, bt = (torch.from_numpy(a) for a in (g, x, w, b))
    _, mean, rstd = _emulate_k2(xt, wt, bt, kind)
    return (_emulate_k3(gt, xt, mean, rstd, wt, bt, kind),
            fn.norm_silu_bwd_plain(gt, xt, mean, rstd, wt, bt, kind))


def _jax_k3(g, x, w, b, kind):
    """jax.grad of sum(norm_silu(x, w, b)·g) through the JAX kernel's
    custom VJP, its Pallas kernels in interpret mode, channels-last at its
    boundary; dx back in NC*."""
    gl = jnp.asarray(np.moveaxis(g, 1, -1))

    def loss(x, w, b):
        return jnp.sum(jfn.norm_silu(x, w, b, kind, interpret=True) * gl)

    dx, dw, db = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(np.moveaxis(x, 1, -1)), jnp.asarray(w), jnp.asarray(b))
    return np.moveaxis(np.asarray(dx), -1, 1), np.asarray(dw), np.asarray(db)


def _assert_grads_close(got, ref, atol=1e-5):
    """dx, dw and db within rtol 1e-5 and ``atol`` of each one's largest
    entry (tests/test_torch_kernels.py's K3 bound)."""
    for o, r, name in zip(got, ref, ("dx", "dw", "db")):
        r = np.asarray(r)
        np.testing.assert_allclose(np.asarray(o), r, rtol=1e-5,
                                   atol=atol * np.abs(r).max(), err_msg=name)


def _k3_inputs(shape, **kw):
    g = np.random.default_rng(sum(shape) + 1).standard_normal(shape)
    return (g.astype(np.float32),) + _inputs(shape, **kw)


@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("shape", _SHAPES)
def test_k3_split_reduction_matches_jax_kernel(shape, kind):
    """The emulated K3, on the emulated K2's statistics, against jax.grad
    through the JAX Pallas kernels in interpret mode."""
    g, x, w, b = _k3_inputs(shape)
    (got, _) = _k3(g, x, w, b, kind)
    _assert_grads_close(got, _jax_k3(g, x, w, b, kind))


@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("shape", _SHAPES)
def test_k3_split_reduction_matches_plain(shape, kind):
    """The emulated K3 against ``norm_silu_bwd_plain`` (whole-row f32
    sums) on the same statistics."""
    got, ref = _k3(*_k3_inputs(shape), kind)
    _assert_grads_close(got, ref)


def _float64_k3(g, x, w, b, kind, eps=1e-5):
    """(dx, dw, db) in float64, statistics included."""
    B, C = x.shape[:2]
    xr, gr = (a.astype(np.float64).reshape(B * C, -1) for a in (x, g))
    mu = xr.mean(1, keepdims=True) if kind == "ln" else 0.0
    rstd = 1 / np.sqrt(((xr - mu) ** 2).mean(1, keepdims=True) + eps)
    c = np.arange(B * C) % C
    n = (xr - mu) * rstd
    u = n * w[c][:, None] + b[c][:, None]
    sg = 1 / (1 + np.exp(-u))
    gu = gr * sg * (1 + u * (1 - sg))
    dn = gu * w[c][:, None]
    dx = dn - n * (dn * n).mean(1, keepdims=True)
    if kind == "ln":
        dx = dx - dn.mean(1, keepdims=True)
    return ((rstd * dx).reshape(x.shape),
            (gu * n).sum(1).reshape(B, C).sum(0), gu.sum(1).reshape(B, C).sum(0))


@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("shape", _OFF_CENTRE)
def test_k3_split_reduction_off_centre(shape, kind):
    """|μ| = 100σ. The emulated K3 and the plain version, on the emulated
    K2's statistics, are held to the bound against each other and against
    float64. The JAX Pallas backward takes its own statistics, up to
    ~2e-4 of the largest entry from float64 at 32³ rows: the emulation is
    held to lie no farther from float64 than it, and within its error
    plus the bound of it."""
    g, x, w, b = _k3_inputs(shape, shift=100.0, scale=1.0)
    got, ref = _k3(g, x, w, b, kind)
    exact = _float64_k3(g, x, w, b, kind)
    _assert_grads_close(got, ref)
    _assert_grads_close(got, exact)
    _assert_grads_close(ref, exact)
    for o, j, e in zip(got, _jax_k3(g, x, w, b, kind), exact):
        o, top = o.numpy(), np.abs(e).max()
        jerr = float(np.abs(j - e).max())
        assert float(np.abs(o - e).max()) <= jerr + 1e-5 * top
        np.testing.assert_allclose(o, j, rtol=1e-5, atol=1e-5 * top + jerr)


def test_launch_shapes():
    """The slices the launch picks at the main paths' shapes. K2: A's 32³
    rows split over clusters of 8 at serving bucket 1 and of 2 at batch 4,
    A's 16³ rows take one CTA each; B's rows of 784 take a warp each, of
    196 a group of 16 lanes (two words a lane), of 49 a group of 8; a 1 MB
    f32 row is the longest a cluster holds. K3 (g and x held): the same
    shapes at A's and B's train batches; a 512 KB f32 row is the longest
    a cluster holds."""
    assert _slices(32, 32 ** 3, 2) == (8, 4096, 256)
    assert _slices(128, 32 ** 3, 2) == (2, 16384, 256)
    assert _slices(64, 16 ** 3, 2) == (1, 4096, 256)
    assert _slices(256, 16 ** 3, 2) == (1, 4096, 256)
    assert _slices(4096, 784, 2) == (1, 784, 32)
    assert _slices(8192, 196, 2) == (1, 200, 16)
    assert _slices(16384, 49, 2) == (1, 56, 8)
    assert _slices(1, 2 ** 18, 4)[0] == MAX_CLUSTER
    with pytest.raises(AssertionError):
        _slices(1, 2 ** 18 + 1, 4)
    assert math.isclose(SLICE_BYTES * MAX_CLUSTER, 2 ** 20)
    # K3 at A's batch 4 and B's batch 256
    assert _slices(128, 32 ** 3, 2, arrays=2) == (2, 16384, 256)
    assert _slices(256, 16 ** 3, 2, arrays=2) == (1, 4096, 256)
    assert _slices(16384, 784, 2, arrays=2) == (1, 784, 32)
    assert _slices(32768, 196, 2, arrays=2) == (1, 200, 16)
    assert _slices(65536, 49, 2, arrays=2) == (1, 56, 8)
    assert _slices(1, 2 ** 17, 4, arrays=2)[0] == MAX_CLUSTER
    with pytest.raises(AssertionError):
        _slices(1, 2 ** 17 + 1, 4, arrays=2)
