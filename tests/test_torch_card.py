"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card. The
module imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

(``--noconftest`` leaves out ``tests/conftest.py``, which configures JAX.)
The kernels' tolerances are ``chip_smoke.py`` phase 1's; the CUDA
graphs' (graphed entry points against their eager bodies) phases 2 to 4's.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from diffsci_tpu_torch import (DDPMModel, DDPMModelConfig, EMATracker,
                               HFNetUncond, KarrasModel, KarrasModelConfig,
                               PUNetG, PUNetGConfig, create_train_state,
                               default_optimizer, kernels, make_train_scan,
                               make_train_step, warmup_cosine_schedule)
from diffsci_tpu_torch.kernels import flash_attention as fa
from diffsci_tpu_torch.kernels import fused_norm as fn
from diffsci_tpu_torch.kernels import fused_precondition as fp
import _torch_warmup  # noqa: F401  (CPU threads; tests/ is on the path)

pytestmark = pytest.mark.cuda

# chip_smoke.py phase 1's flash shapes: config A, the phase-2/3 net's head
# dim 8, ragged T, every head-dim template, head dims that are not a
# template's (20: rows not 16-byte aligned)
_FLASH_SWEEP = ((4, 2, 4096, 32), (1, 2, 4096, 8), (2, 4, 4096, 16),
                (1, 2, 4097, 32), (1, 1, 2049, 64), (1, 1, 2111, 128),
                (2, 1, 2048, 40), (1, 2, 2048, 20))


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA only")


def _assert_attention_close(out, ref):
    """K4's O: within 1e-4 in f32; in bf16 within one bf16 step of each
    entry (2^-7·|ref|) plus 2e-3 of the largest entry (a typical |O| is a
    few 1e-2, so an absolute bound would pass wrong outputs)."""
    diff = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        limit = 1e-4
    else:
        r = ref.float().abs()
        limit = 2 ** -7 * r + 2e-3 * r.max()
    assert bool((diff <= limit).all()), float(diff.max())


def _assert_grad_close(out, ref):
    """The backward kernels' bound: max|Δ| within 1e-4 (f32) or 1e-2 (bf16)
    of max|ref|."""
    tol = 1e-4 if out.dtype == torch.float32 else 1e-2
    err = float((out.float() - ref.float()).abs().max())
    assert err <= tol * float(ref.float().abs().max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    dt = getattr(torch, dtype)
    tol = dict(rtol=0, atol=1e-4) if dt == torch.float32 else \
        dict(rtol=2e-2, atol=2e-2)
    gen = torch.Generator("cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    kernels.reset_launches()
    x, f = randn(5, 28, 28, 1), randn(5, 28, 28, 1)
    a = torch.rand(5, generator=gen, device="cuda")
    torch.testing.assert_close(fp.fused_axby(x, f, a, 2.0),
                               fp.fused_axby_plain(x, f, a, 2.0), **tol)
    g = randn(5, 28, 28, 1)
    torch.testing.assert_close(fp.fused_lincomb3(x, f, g, a, 2.0, -a),
                               fp.fused_lincomb3_plain(x, f, g, a, 2.0, -a),
                               **tol)
    x = randn(2, 8, 9, 10, 11)
    w, b = randn(8), randn(8)
    for kind in ("ln", "rms"):
        for got, ref in zip(fn.norm_silu_fwd(x, w, b, kind),
                            fn.norm_silu_plain(x, w, b, kind)):
            torch.testing.assert_close(got.float(), ref.float(), **tol)
    q, k, v = randn(1, 2, 333, 40), randn(1, 2, 333, 40), randn(1, 2, 333, 40)
    o, lse = fa.flash_attention_fwd(q, k, v)
    ro, rlse = fa.flash_attention_plain(q, k, v)
    _assert_attention_close(o, ro)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-3)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"fused_axby": 1, "norm_silu": 2,
                                "norm_silu_bwd": 0, "flash_attention": 1,
                                "flash_attention_dq": 0,
                                "flash_attention_dkv": 0,
                                "fused_lincomb3": 1, "norm_silu_stats": 0,
                                "norm_silu_apply": 0,
                                "norm_silu_bwd_partials": 0,
                                "norm_silu_bwd_dx": 0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_match_plain_on_card(dtype):
    """K3, K5 and K6 against their plain versions on the same saved
    tensors, with ragged T and head dims that are not a template's."""
    dt = getattr(torch, dtype)
    tol = dict(rtol=0, atol=1e-4) if dt == torch.float32 else \
        dict(rtol=2e-2, atol=2e-2)
    gen = torch.Generator("cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    x, g = randn(2, 8, 9, 10, 11), randn(2, 8, 9, 10, 11)
    w, b = randn(8), randn(8)
    for kind in ("ln", "rms"):
        _, mean, rstd = fn.norm_silu_fwd(x, w, b, kind)
        kernels.reset_launches()
        got = fn.norm_silu_bwd(g, x, mean, rstd, w, b, kind)
        assert kernels.LAUNCHES["norm_silu_bwd"] == 1
        for o, r in zip(got, fn.norm_silu_bwd_plain(g, x, mean, rstd, w, b,
                                                    kind)):
            torch.testing.assert_close(o.float(), r.float(), **tol)
    for shape in ((1, 2, 333, 40), (2, 1, 4097, 16)) + _FLASH_SWEEP:
        q, k, v, do = (randn(*shape) * 0.5 for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        kernels.reset_launches()
        got = fa.flash_attention_bwd(q, k, v, o, lse, do)
        assert kernels.LAUNCHES["flash_attention_dq"] == 1
        assert kernels.LAUNCHES["flash_attention_dkv"] == 1
        for o_, r in zip(got, fa.flash_attention_bwd_plain(q, k, v, o, lse,
                                                           do)):
            _assert_grad_close(o_, r)
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", _FLASH_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_matches_plain_on_card(dtype, shape):
    """K4 (the tensor-core kernel in bf16, the FP32 one in f32) against its
    plain version over phase 1's sweep: O within 1e-4 (f32) or
    2^-7·|ref| + 2e-3·max|ref| (bf16), lse within 1e-3."""
    dt = getattr(torch, dtype)
    gen = torch.Generator("cuda").manual_seed(3)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
               for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v)
    ro, rlse = fa.flash_attention_plain(q, k, v)
    _assert_attention_close(o, ro)
    assert float((lse - rlse).abs().max()) <= 1e-3


# head dims above 128 at ragged T: in bf16, 136, 192 and 256 take one pass
# of the wgmma K4, K5 and K6, 320 and 512 their 192- and 256-column chunks,
# 200 zero-padded columns of aligned rows; 260 (520-byte rows, which TMA
# cannot read) the mma.sync wide kernels, as f32 does at every one
_WIDE = ((1, 1, 2048, 256), (1, 2, 2049, 512), (2, 1, 2048, 200),
         (1, 1, 2049, 136), (1, 1, 2111, 192), (2, 1, 2111, 256),
         (1, 2, 2049, 320), (1, 1, 2111, 512), (1, 1, 2049, 260))


@pytest.mark.parametrize("shape", _WIDE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_take_wide_head_dims_on_card(dtype, shape):
    """Head dims above 128 (ADM's one 256-channel head; head dims that are
    no multiple of 128, on both wide routes): K4, K5 and K6 launch once
    each through their wide kernels and hold their plain versions'
    bounds, the fixed fault that raised there while the JAX package took
    them."""
    dt = getattr(torch, dtype)
    gen = torch.Generator("cuda").manual_seed(4)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for _ in range(4))
    kernels.reset_launches()
    o, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert kernels.LAUNCHES["flash_attention"] == 1
    assert kernels.LAUNCHES["flash_attention_dq"] == 1
    assert kernels.LAUNCHES["flash_attention_dkv"] == 1
    ro, rlse = fa.flash_attention_plain(q, k, v)
    _assert_attention_close(o, ro)
    assert float((lse - rlse).abs().max()) <= 1e-3
    for o_, r in zip(got, fa.flash_attention_bwd_plain(q, k, v, o, lse, do)):
        _assert_grad_close(o_, r)
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(2, 1, 2049, 256), (1, 2, 2111, 512),
                                   (1, 1, 2049, 260)])
def test_flash_wide_kernels_are_deterministic_on_card(shape):
    """The wide bf16 K4, K5 and K6 (wgmma at d 256 and 512, mma.sync at
    260) have one writer per output element and no atomics: the same
    inputs give bit-identical O, lse, dQ, dK and dV."""
    gen = torch.Generator("cuda").manual_seed(6)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    o2, lse2 = fa.flash_attention_fwd(q, k, v)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    delta = (do.float() * o.float()).sum(-1)
    assert torch.equal(fa.flash_attention_dq(q, k, v, do, lse, delta),
                       fa.flash_attention_dq(q, k, v, do, lse, delta))
    first = fa.flash_attention_dkv(q, k, v, do, lse, delta)
    second = fa.flash_attention_dkv(q, k, v, do, lse, delta)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("shape", [(4, 2, 4096, 32), (4, 12, 4096, 64)])
def test_flash_dkv_is_deterministic_on_card(shape):
    """K6 in bf16 has one writer per output tile and no atomics: the same
    inputs give bit-identical dK and dV (A's head dim 32 and H's 64, both
    on the narrow wgmma route)."""
    gen = torch.Generator("cuda").manual_seed(4)
    q, k, v, do = (torch.randn(shape, generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    first = fa.flash_attention_dkv(q, k, v, do, lse, delta)
    second = fa.flash_attention_dkv(q, k, v, do, lse, delta)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# the narrow wgmma route (bf16 K4 at d 32, 64 and 128, K6 at d 32 and 64,
# rows that TMA can read): A's buckets 4 and 1 and its Picard sweep's
# batch 8, H's bucket 4, FLASH_SWEEP's (1, 1, 2049, 64), ragged T at 2049
# and 4097, and d 128 (K4 only)
_NARROW = ((4, 2, 4096, 32), (1, 2, 4096, 32), (8, 2, 4096, 32),
           (4, 12, 4096, 64), (1, 1, 2049, 64), (2, 1, 2049, 32),
           (1, 2, 4097, 32), (1, 1, 4097, 64), (1, 1, 2049, 128))


def _kernel_names(fn, reps=3):
    """Names of the CUDA kernels that ``fn`` launches, from torch.profiler
    over ``reps`` calls (a trace may drop a device record)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


def _flash_route_case(shape, offset, seed):
    """bf16 K4, K5 and K6 at ``shape`` on inputs whose base is ``offset``
    elements into their storage, against their plain versions (each
    launched once, each repeat bit-identical); returns the kernels that
    K4, K5 and K6 launched."""
    gen = torch.Generator("cuda").manual_seed(seed)
    q, k, v, do = (_offset_randn(shape, torch.bfloat16, offset, gen)
                   for _ in range(4))
    kernels.reset_launches()
    o, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert kernels.LAUNCHES["flash_attention"] == 1
    assert kernels.LAUNCHES["flash_attention_dq"] == 1
    assert kernels.LAUNCHES["flash_attention_dkv"] == 1
    ro, rlse = fa.flash_attention_plain(q, k, v)
    _assert_attention_close(o, ro)
    assert float((lse - rlse).abs().max()) <= 1e-3
    for o_, r in zip(got, fa.flash_attention_bwd_plain(q, k, v, o, lse, do)):
        _assert_grad_close(o_, r)
    assert torch.equal(o, fa.flash_attention_fwd(q, k, v)[0])
    assert all(torch.equal(a, b) for a, b in zip(
        got, fa.flash_attention_bwd(q, k, v, o, lse, do)))
    delta = (do.float() * o.float()).sum(-1)
    fwd = _kernel_names(lambda: fa.flash_attention_fwd(q, k, v))
    dq = _kernel_names(lambda: fa.flash_attention_dq(q, k, v, do, lse,
                                                     delta))
    dkv = _kernel_names(lambda: fa.flash_attention_dkv(q, k, v, do, lse,
                                                       delta))
    return fwd, dq, dkv


@pytest.mark.parametrize("shape", _NARROW)
def test_flash_narrow_route_matches_plain_on_card(shape):
    """The narrow wgmma K4 (d 32, 64, 128), K5 and K6 (d 32, 64) at the
    main paths' shapes and ragged T: within phase 1's bounds of the plain
    versions (O 2^-7·|ref| + 2e-3·max|ref|, lse 1e-3, dQ, dK, dV 1e-2 of
    max|ref|), bit-identical on a repeat, and launched by the shape
    rule."""
    fwd, dq, dkv = _flash_route_case(shape, 0, 7)
    assert any("flash_fwd_narrow_kernel" in n for n in fwd), fwd
    narrow_dq = any("flash_dq_narrow_kernel" in n for n in dq)
    assert narrow_dq == (shape[-1] <= 64), dq
    narrow_dkv = any("flash_dkv_narrow_kernel" in n for n in dkv)
    assert narrow_dkv == (shape[-1] <= 64), dkv


@pytest.mark.parametrize("shape", [(4, 2, 4096, 32), (4, 12, 4096, 64)])
def test_flash_narrow_dq_is_deterministic_on_card(shape):
    """The narrow K5 at A's d 32 and H's d 64 (train batch 4 and bucket
    4): one writer per dQ element and no atomics, so three calls give the
    same bits."""
    gen = torch.Generator("cuda").manual_seed(11)
    q, k, v, do = (torch.randn(shape, generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    first = fa.flash_attention_dq(q, k, v, do, lse, delta)
    assert any("flash_dq_narrow_kernel" in n for n in _kernel_names(
        lambda: fa.flash_attention_dq(q, k, v, do, lse, delta), 1))
    for _ in range(2):
        assert torch.equal(first, fa.flash_attention_dq(q, k, v, do, lse,
                                                        delta))


@pytest.mark.parametrize("shape", [(1, 1, 2049, 64), (4, 12, 4096, 64),
                                   (1, 2, 4096, 32)])
def test_flash_unaligned_base_takes_mma_sync_on_card(shape):
    """Inputs whose base is one element off 16 bytes (TMA cannot read
    them): the shape rule sends K4, K5 and K6 to the mma.sync kernels,
    which hold the same bounds."""
    fwd, dq, dkv = _flash_route_case(shape, 1, 8)
    assert any("flash_fwd_mma_kernel" in n for n in fwd), fwd
    assert any("flash_dq_mma_kernel" in n for n in dq), dq
    assert any("flash_dkv_mma_kernel" in n for n in dkv), dkv
    assert not any("narrow" in n for n in fwd | dq | dkv)


@pytest.mark.parametrize("shape", _FLASH_SWEEP)
def test_flash_dq_tensor_cores_match_plain_on_card(shape):
    """K5 in bf16 (the tensor-core kernel, dS rounded to bf16 before dS·K)
    against its plain version over phase 1's sweep, within 1e-2 of
    max|ref|, and bit-identical when run again (one writer per dQ tile,
    no atomics)."""
    gen = torch.Generator("cuda").manual_seed(5)
    q, k, v, do = (torch.randn(shape, generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    kernels.reset_launches()
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta)
    assert kernels.LAUNCHES["flash_attention_dq"] == 1
    _assert_grad_close(dq, fa.flash_attention_dq_plain(q, k, v, do, lse,
                                                        delta))
    assert torch.equal(dq, fa.flash_attention_dq(q, k, v, do, lse, delta))


# K2's launch shapes: configuration A's 32³ rows at serving bucket 1 (a
# cluster of 8 CTAs per row), rows that are not 16-byte aligned (S = 49,
# 1001), an x whose base is not (element offset 1), off-centre inputs
# (|μ| = 100σ) and rows beyond a cluster's shared memory (f32, 1.2 MB: the
# stream kernel). (shape, scale, shift, offset)
_NORM_CASES = [((1, 32, 32, 32, 32), 2.0, 0.3, 0), ((3, 5, 7, 7), 2.0, 0.3, 0),
               ((2, 3, 1001), 2.0, 0.3, 1), ((1, 32, 32, 32, 32), 2.0, 0.3, 1),
               ((1, 32, 32, 32, 32), 1.0, 100.0, 0),
               ((64, 256, 7, 7), 1.0, 100.0, 0), ((1, 2, 300000), 2.0, 0.3, 0)]


@pytest.mark.parametrize("case", _NORM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_silu_split_rows_match_plain_on_card(dtype, case):
    """K2 against its plain version on each of its launch shapes: y within
    1e-4 (f32) or 2e-2 + 2e-2·|ref| (bf16), the mean within 1e-4 of
    max(1, |mean|) and rstd within 1e-4 relative; the same input gives the
    same bits again; K3 on its statistics within the backward bound."""
    dt = getattr(torch, dtype)
    shape, scale, shift, offset = case
    gen = torch.Generator("cuda").manual_seed(6)
    C, n = shape[1], 1
    for s in shape:
        n *= s
    x = (torch.randn(n + offset, generator=gen, device="cuda") * scale
         + shift).to(dt)[offset:].view(shape)
    w = (torch.randn(C, generator=gen, device="cuda") * 0.2 + 1).to(dt)
    b = (torch.randn(C, generator=gen, device="cuda") * 0.1).to(dt)
    g = torch.randn(shape, generator=gen, device="cuda").to(dt)
    for kind in ("ln", "rms"):
        y, mean, rstd = fn.norm_silu_fwd(x, w, b, kind)
        ry, rmean, rrstd = fn.norm_silu_plain(x, w, b, kind)
        tol = dict(rtol=0, atol=1e-4) if dt == torch.float32 else \
            dict(rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(y.float(), ry.float(), **tol)
        assert float(((mean - rmean).abs() / rmean.abs().clamp(min=1))
                     .max()) <= 1e-4
        assert float(((rstd - rrstd).abs() / rrstd).max()) <= 1e-4
        assert torch.equal(y, fn.norm_silu_fwd(x, w, b, kind)[0])
        for o, r in zip(fn.norm_silu_bwd(g, x, mean, rstd, w, b, kind),
                        fn.norm_silu_bwd_plain(g, x, mean, rstd, w, b,
                                               kind)):
            _assert_grad_close(o, r)
    torch.cuda.synchronize()


# K3's launch shapes at configurations A's and B's train-step norms: A's
# 32³ rows (a cluster of 2 CTAs per row) and 16³ rows (one CTA per row), B's
# rows of 784 (a warp each), 196 (16 lanes) and 49 (8 lanes, rows that
# share 16-byte words)
_K3_SHAPES = [(4, 32, 32, 32, 32), (4, 64, 16, 16, 16), (256, 64, 28, 28),
              (256, 128, 14, 14), (256, 256, 7, 7)]


@pytest.mark.parametrize("shape", _K3_SHAPES)
def test_norm_silu_bwd_launch_shapes_on_card(shape):
    """K3 in bf16 at each of the train steps' launch shapes, on K2's
    statistics: dx, dw and db within 1e-2 of max|ref| of the plain
    version, one launch each, and bit-identical when run again (one writer
    per output, sums in a fixed order)."""
    gen = torch.Generator("cuda").manual_seed(7)
    C = shape[1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.3).bfloat16()
    g = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(C, generator=gen, device="cuda") * 0.2 + 1).bfloat16()
    b = (torch.randn(C, generator=gen, device="cuda") * 0.1).bfloat16()
    for kind in ("ln", "rms"):
        _, mean, rstd = fn.norm_silu_fwd(x, w, b, kind)
        kernels.reset_launches()
        got = fn.norm_silu_bwd(g, x, mean, rstd, w, b, kind)
        assert kernels.LAUNCHES["norm_silu_bwd"] == 1
        for o, r in zip(got, fn.norm_silu_bwd_plain(g, x, mean, rstd, w, b,
                                                    kind)):
            _assert_grad_close(o, r)
        again = fn.norm_silu_bwd(g, x, mean, rstd, w, b, kind)
        assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(64, 32, 32, 3), (3, 1001)])
def test_fused_lincomb3_matches_plain_on_card(shape):
    """K7 in every dtype combination of x, f and g, at configuration C's
    sampler shape and a ragged one: bit for bit in f32 (both round
    (a·x + b·f) + c·g term by term), |Δ| <= 2e-2 + 2e-2·|ref| with bf16."""
    gen = torch.Generator("cuda").manual_seed(2)
    dts = (torch.float32, torch.bfloat16)
    a, b, c = (torch.randn(shape[0], generator=gen, device="cuda")
               for _ in range(3))
    kernels.reset_launches()
    for dx in dts:
        for df in dts:
            for dg in dts:
                x, f, g = (torch.randn(shape, generator=gen,
                                       device="cuda").to(dt)
                           for dt in (dx, df, dg))
                out = fp.fused_lincomb3(x, f, g, a, b, c)
                ref = fp.fused_lincomb3_plain(x, f, g, a, b, c)
                assert out.dtype == dx
                if dx == df == dg == torch.float32:
                    assert torch.equal(out, ref)
                else:
                    torch.testing.assert_close(out.float(), ref.float(),
                                               rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_lincomb3"] == 8


# K1's and K7's cases: the main paths' shapes (B's and A's samplers, C's),
# ragged rows, many short rows, one long row, and operands whose base is
# not 16-byte aligned (contiguous views at a storage offset of 1 element:
# x alone, f alone, f and x, and for K7 g alone and all three). (shape,
# names of the offset operands)
_COMBINE_CASES = [((64, 28, 28, 1), ""), ((4, 1, 32, 32, 32), ""),
                  ((16, 32, 32, 3), ""), ((3, 1001), ""), ((5, 7), ""),
                  ((4096, 3), ""), ((1, 2 ** 20 + 3), ""),
                  ((64, 28, 28, 1), "x"), ((64, 28, 28, 1), "f"),
                  ((64, 28, 28, 1), "xf"), ((4, 1, 32, 32, 32), "xf"),
                  ((16, 32, 32, 3), "g"), ((16, 32, 32, 3), "xfg"),
                  ((3, 1001), "xfg")]


def _offset_randn(shape, dtype, offset, gen, scale=1.0):
    n = 1
    for s in shape:
        n *= s
    return (torch.randn(n + offset, generator=gen, device="cuda")
            * scale).to(dtype)[offset:].view(shape)


_OPERANDS = {"fused_axby": "xf", "fused_lincomb3": "xfg"}


@pytest.mark.parametrize("kernel,case", [
    (kernel, case) for kernel, names in _OPERANDS.items()
    for case in _COMBINE_CASES if set(case[1]) <= set(names)])
def test_fused_combine_cases_on_card(kernel, case):
    """K1 in its 4 dtype combinations of x and f, K7 in its 8 of x, f
    and g: bit for bit against the plain version when x is f32 (the
    kernels round a·x + b·f (+ c·g) term by term, as it does), within
    2e-2 + 2e-2·|ref| when it is bf16; the same inputs give the same bits
    again; one launch a call."""
    shape, offsets = case
    names = _OPERANDS[kernel]
    gen = torch.Generator("cuda").manual_seed(8)
    coeffs = [torch.randn(shape[0], generator=gen, device="cuda")
              for _ in names]
    dts = (torch.float32, torch.bfloat16)
    combos = [(dx, df) for dx in dts for df in dts] if len(names) == 2 else \
        [(dx, df, dg) for dx in dts for df in dts for dg in dts]
    wrapper, plain = getattr(fp, kernel), getattr(fp, kernel + "_plain")
    kernels.reset_launches()
    for dtypes in combos:
        tensors = [_offset_randn(shape, dt, int(nm in offsets), gen,
                                 40.0 if nm == "x" else 1.0)
                   for nm, dt in zip(names, dtypes)]
        assert all(t.is_contiguous() for t in tensors)
        out = wrapper(*tensors, *coeffs)
        ref = plain(*tensors, *coeffs)
        assert out.dtype == dtypes[0]
        if dtypes[0] == torch.float32:
            assert torch.equal(out, ref), dtypes
        else:
            torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                       atol=2e-2)
        assert torch.equal(out, wrapper(*tensors, *coeffs))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kernel] == 2 * len(combos)
    assert sum(kernels.LAUNCHES.values()) == 2 * len(combos)


def test_euler_update_matches_plain_on_card():
    """euler_update (one K1 launch) against x + (t_next − t)/t·(x − D),
    D = c_skip·x + c_out·f, at configuration B's sampler state in f32:
    within 1e-5."""
    gen = torch.Generator("cuda").manual_seed(9)
    x, f = (torch.randn((64, 28, 28, 1), generator=gen, device="cuda")
            for _ in range(2))
    c_skip = torch.rand(64, generator=gen, device="cuda")
    c_out = torch.randn(64, generator=gen, device="cuda")
    t = torch.rand(64, generator=gen, device="cuda") * 9 + 1
    t_next = t * (0.5 + 0.4 * torch.rand(64, generator=gen, device="cuda"))
    kernels.reset_launches()
    out = fp.euler_update(x, f, c_skip, c_out, t, t_next)
    assert kernels.LAUNCHES["fused_axby"] == 1

    def br(v):
        return v.view(64, 1, 1, 1)
    D = br(c_skip) * x + br(c_out) * f
    ref = x + br((t_next - t) / t) * (x - D)
    assert float((out - ref).abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# CUDA graphs: the graphed entry points against their eager bodies
# ---------------------------------------------------------------------------
@pytest.fixture
def _no_tf32():
    """Full f32 convolutions and products, so that graph and eager differ
    only by the order of f32 sums (cuDNN may pick other algorithms for a
    capture)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _small_3d():
    """chip_smoke.py phases 2 and 3's net: configuration A's shape at a cut
    width (3D 32³, flash attention over 4096 tokens, head dim 8)."""
    return PUNetGConfig(dimension=3, model_channels=8, channel_expansion=[2],
                        number_resnet_downward_block=1,
                        number_resnet_upward_block=1,
                        number_resnet_attn_block=2,
                        number_resnet_before_attn_block=1,
                        number_resnet_after_attn_block=1, num_heads=2,
                        attn_backend="flash")


def _counts():
    return {k: v for k, v in kernels.LAUNCHES.items() if v}


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_graphed_sample_matches_eager_on_card(_no_tf32, compute_dtype):
    """KarrasModel.sample replays one graph of the whole Heun loop per
    bucket (1 and 3): within rtol 1e-3 + atol 1e-3 of the eager loop on
    the same noise (phase 2's; graph and eager run the same kernels, in
    another order of f32 sums only where cuDNN captures another
    algorithm); a replay launches exactly what the eager loop launches;
    one seed gives the same bits twice; and a returned sample is a copy
    (a later call leaves it as it was)."""
    model = KarrasModel(PUNetG(_small_3d()), KarrasModelConfig.from_edm(),
                        compute_dtype=compute_dtype)
    model.init(seed=1)
    for bucket in (1, 3):
        shape = (32, 32, 32, 1)
        first = model.sample(bucket, shape, torch.Generator("cuda")
                             .manual_seed(7), nsteps=3)
        kept = first.clone()
        x = torch.randn((bucket,) + shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(7))
        kernels.reset_launches()
        ref = model.propagate_white_noise(x, nsteps=3)
        eager = _counts()
        kernels.reset_launches()
        again = model.sample(bucket, shape, torch.Generator("cuda")
                             .manual_seed(7), nsteps=3)
        assert _counts() == eager
        assert eager["fused_axby"] == eager["flash_attention"] == 5
        assert torch.equal(first, again)
        model.sample(bucket, shape, torch.Generator("cuda").manual_seed(8),
                     nsteps=3)
        assert torch.equal(first, kept)
        assert bool(torch.isfinite(first).all())
        torch.testing.assert_close(first, ref, rtol=1e-3, atol=1e-3)


def test_sampler_graph_follows_trained_weights_on_card():
    """Under a bf16 compute dtype the sampler's graph reads the model's cast
    copy, which graphed train steps update through ``_masters_changed``
    (a replay moves no version counter). Sample; train (the warm-up, then
    a replay); sample; replay one more step; sample again: each sample
    from one seed differs from the one before, and the last two agree with
    the eager loop run from a cast copy built anew from the current
    masters (phase 2's rtol 1e-3 + atol 1e-3)."""
    model = KarrasModel(PUNetG(_small_3d()), KarrasModelConfig.from_edm(),
                        compute_dtype=torch.bfloat16)
    state, tx = create_train_state(model, (2, 32, 32, 32, 1), seed=1)
    gen = torch.Generator("cuda").manual_seed(3)
    shape = (32, 32, 32, 1)

    def sample():
        return model.sample(2, shape, gen.manual_seed(3), nsteps=2)

    def eager_from_fresh_copy():
        noise = torch.randn((2,) + shape, device="cuda",
                            generator=gen.manual_seed(3))
        fresh = KarrasModel(PUNetG(_small_3d()), KarrasModelConfig.from_edm(),
                            compute_dtype=torch.bfloat16)
        fresh.net.load_state_dict(model.net.state_dict())
        return fresh.propagate_white_noise(noise, nsteps=2)

    before = sample()
    step = make_train_step(model, tx)
    x = torch.randn((2,) + shape, device="cuda", generator=gen)
    for _ in range(2):
        step(state, x, generator=gen)
    after = sample()
    assert not torch.equal(before, after)
    torch.testing.assert_close(after, eager_from_fresh_copy(), rtol=1e-3,
                               atol=1e-3)
    step(state, x, generator=gen)             # a replay between two samples
    later = sample()
    assert not torch.equal(after, later)
    torch.testing.assert_close(later, eager_from_fresh_copy(), rtol=1e-3,
                               atol=1e-3)


def test_train_state_holds_its_graphs_on_card():
    """The graphs of a train step belong to its state: make_train_scan over
    a state that make_train_step has trained replays the step's graph (no
    second capture, no second warm-up update), a remat step over the same
    state captures a graph of its own, and the graphs go with the state."""
    model = KarrasModel(PUNetG(_small_3d()), KarrasModelConfig.from_edm())
    state, tx = create_train_state(model, (2, 32, 32, 32, 1), seed=2)
    gen = torch.Generator("cuda").manual_seed(4)
    xs = torch.randn((3, 2, 32, 32, 32, 1), device="cuda", generator=gen)
    make_train_step(model, tx)(state, xs[0], generator=gen)
    (graph,) = state.graphs.graphs.values()
    kernels.reset_launches()
    state, met = make_train_scan(model, tx)(state, xs, generator=gen)
    assert list(state.graphs.graphs.values()) == [graph]
    assert _counts() == {k: 3 * n for k, n in graph.launches.items()}
    assert state.step == 4 and met["train_loss"].shape == (3,)
    make_train_step(model, tx, remat=True)(state, xs[0], generator=gen)
    assert len(state.graphs.graphs) == 2
    held = weakref.ref(state.graphs)
    del state, graph
    gc.collect()
    assert held() is None


def _train(graphed, remat, schedule, steps=3, tx=None):
    """``steps`` f32 train steps of the small 3D flash net from seed 2,
    σ and ε replayed, power EMA every 2 steps, under AdamW (or ``tx``):
    (metrics, state, launches of each step)."""
    model = KarrasModel(PUNetG(_small_3d()), KarrasModelConfig.from_edm())
    lr = warmup_cosine_schedule(1e-3, 2, 10) if schedule else 1e-3
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05],
                         update_every=2)
    state, tx = create_train_state(model, (2, 32, 32, 32, 1), seed=2,
                                   optimizer=tx or default_optimizer(lr),
                                   ema=tracker)
    step = make_train_step(model, tx, ema=tracker, remat=remat,
                           _raw=not graphed)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 32, 1))
                         .astype(np.float32)).cuda()
    metrics, counts = [], []
    for _ in range(steps):
        sigma = np.exp(rng.standard_normal(2) * 1.2 - 1.2).astype(np.float32)
        eps = rng.standard_normal(x.shape).astype(np.float32)
        kernels.reset_launches()
        state, met = step(state, x, sigma=torch.from_numpy(sigma).cuda(),
                          eps=torch.from_numpy(eps).cuda())
        counts.append(_counts())
        metrics.append((float(met["train_loss"]), float(met["grad_norm"])))
    return metrics, state, counts


@pytest.mark.parametrize("remat,schedule", [(False, False), (True, True)])
def test_graphed_train_steps_match_eager_on_card(_no_tf32, remat, schedule):
    """make_train_step replays one graph per step after its first (eager,
    the warm-up): 3 f32 steps against the eager step from the same
    weights and draws, loss and grad_norm within rtol 1e-3 (phase 3's),
    parameters and EMA shadows with 99.9% of entries within 0.05·lr and
    every entry within 2·k·lr; each step launches what an eager step
    launches (with remat K2 and K4 twice: the forward runs again in the
    backward pass); a learning-rate schedule and the EMA cadence reach
    the replays."""
    m_raw, s_raw, c_raw = _train(False, remat, schedule)
    m_graph, s_graph, c_graph = _train(True, remat, schedule)
    assert c_graph == c_raw
    per_step = c_raw[0]
    assert per_step["norm_silu"] == per_step["norm_silu_bwd"] * \
        (2 if remat else 1)
    assert per_step["flash_attention"] == (2 if remat else 1)
    np.testing.assert_allclose(m_graph, m_raw, rtol=1e-3)
    assert s_graph.step == s_raw.step == 3
    assert s_graph.ema.num_updates == 3
    for ours, ref in ((s_graph.params, s_raw.params),
                      (s_graph.ema.profiles[0], s_raw.ema.profiles[0])):
        diff = torch.cat([(ours[n].detach() - ref[n].detach()).abs()
                          .flatten() for n in ref]).cpu().numpy()
        assert np.quantile(diff, 0.999) <= 0.05 * 1e-3
        assert diff.max() <= 2 * 3 * 1e-3


def test_train_scan_matches_steps_on_card(_no_tf32):
    """make_train_scan at K = 3 against 3 graphed steps from the same
    weights and generator: the same metrics within rtol 1e-3 (each path
    captures its own graph), and K2 launched 20 times a step."""
    out = []
    for scan in (False, True):
        model = KarrasModel(PUNetG(_small_3d()), KarrasModelConfig.from_edm())
        state, tx = create_train_state(model, (2, 32, 32, 32, 1), seed=2)
        gen = torch.Generator("cuda").manual_seed(4)
        xs = torch.randn((3, 2, 32, 32, 32, 1), device="cuda", generator=gen)
        kernels.reset_launches()
        if scan:
            state, met = make_train_scan(model, tx)(state, xs, generator=gen)
            got = torch.stack([met["train_loss"], met["grad_norm"]], 1)
        else:
            step = make_train_step(model, tx)
            got = torch.stack([torch.stack(
                [m["train_loss"], m["grad_norm"]]) for m in
                (step(state, x, generator=gen)[1] for x in xs)])
        out.append((got.cpu().numpy(), _counts()))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-3)
    assert out[1][1] == out[0][1]


@pytest.mark.parametrize("arm", ["from_ddim", "from_ddpm"])
def test_graphed_ddpm_matches_eager_on_card(_no_tf32, arm):
    """DDPMModel.sample replays one graph of a step per t (5 steps, the
    cosine schedule): each step within |Δ| <= 1e-3·|ref| + 1e-3·max|ref_t|
    of the eager loop with the same generator (phase 4's), one K7 launch a
    step and nothing else, one seed the same bits twice."""
    model = DDPMModel(HFNetUncond(block_channels=(32, 64), channels=3,
                                  norm_num_groups=8, attn_up_and_down=True),
                      getattr(DDPMModelConfig, arm)("cosine"))
    model.init(seed=4)

    def graphed(seed):
        return model.sample(2, (16, 16, 3), torch.Generator("cuda")
                            .manual_seed(seed), nsteps=5, record_history=True)

    first = graphed(5)
    kernels.reset_launches()
    again = graphed(5)
    assert _counts() == {"fused_lincomb3": 5}
    assert torch.equal(first, again)
    gen = torch.Generator("cuda").manual_seed(5)
    x = torch.randn((2, 16, 16, 3), device="cuda", generator=gen)
    with torch.inference_mode():
        ref = model.config.integrator.propagate_backward(
            x, model.noise_predictor, 5, record_history=True, generator=gen)
    assert first.shape == ref.shape == (6, 2, 16, 16, 3)
    assert bool(torch.isfinite(first).all())
    for ours, theirs in zip(first, ref):
        assert bool(((ours - theirs).abs() <= 1e-3 * theirs.abs() + 1e-3
                     * max(1.0, float(theirs.abs().max()))).all())


class _HostSync(torch.nn.Module):
    """A score network that reads a value back to the host: legal eagerly,
    refused inside a capture."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(()))

    def forward(self, x, t, y=None):
        return x * self.scale * float(t.mean())


def test_failed_capture_raises_on_card():
    """A body that synchronises cannot be captured: sample raises instead
    of running the eager loop, and the card stays usable."""
    model = KarrasModel(_HostSync(), KarrasModelConfig.from_edm())
    with pytest.raises(RuntimeError):
        model.sample(2, (8, 8, 1), torch.Generator("cuda").manual_seed(0),
                     nsteps=2)
    torch.cuda.synchronize()
    out = model.propagate_white_noise(torch.zeros(2, 8, 8, 1,
                                                  device="cuda"), nsteps=2)
    assert bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# stochastic samplers as CUDA graphs
# ---------------------------------------------------------------------------
def _eager_stochastic(model, bucket, shape, seed, nsteps, integrator=None,
                      stochastic=False, langevin_scale=None):
    """The eager loop on sample()'s draws (x_T, then the [n, B, ...] noise
    of the noisy steps) from ``seed``."""
    gen = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn((bucket,) + shape, device="cuda", generator=gen)
    n = model.config.noisescheduler.noise_steps(nsteps, stochastic,
                                                integrator)
    noise = torch.randn((n, bucket) + shape, device="cuda",
                        generator=gen) if n else None
    gate = None if langevin_scale is None else torch.tensor(
        float(langevin_scale), device="cuda")
    with torch.inference_mode():
        return model._propagate_white_noise(
            x, None, 1.0, nsteps, False, integrator, stochastic,
            gate_scale=gate, noise_seq=noise)


@pytest.mark.parametrize("kwargs", [{"integrator": "karras"},
                                    {"stochastic": True},
                                    {"integrator": "dpmpp2m"}])
def test_graphed_stochastic_sample_matches_eager_on_card(_no_tf32, kwargs):
    """Churn, Euler–Maruyama and DPM++2M: the graphed sample within phase
    2's rtol 1e-3 + atol 1e-3 of the eager loop on the same draws, with
    the eager loop's launches; one seed gives the same bits twice (the
    DPM++2M carry lives in the graph, not across replays); and a first
    result stays as it was after a call from another seed (no aliasing of
    the static output or the noise buffer)."""
    model = KarrasModel(PUNetG(_small_3d()), KarrasModelConfig.from_edm())
    model.init(seed=1)
    shape, nsteps = (32, 32, 32, 1), 4
    first = model.sample(2, shape, torch.Generator("cuda").manual_seed(7),
                         nsteps=nsteps, **kwargs)
    kept = first.clone()
    kernels.reset_launches()
    ref = _eager_stochastic(model, 2, shape, 7, nsteps, **kwargs)
    eager = _counts()
    kernels.reset_launches()
    again = model.sample(2, shape, torch.Generator("cuda").manual_seed(7),
                         nsteps=nsteps, **kwargs)
    assert _counts() == eager
    nfe = 2 * nsteps - 1 if kwargs.get("integrator") == "karras" else nsteps
    assert eager["fused_axby"] == eager["flash_attention"] == nfe
    assert torch.equal(first, again)
    other = model.sample(2, shape, torch.Generator("cuda").manual_seed(8),
                         nsteps=nsteps, **kwargs)
    assert torch.equal(first, kept) and not torch.equal(first, other)
    assert bool(torch.isfinite(first).all())
    torch.testing.assert_close(first, ref, rtol=1e-3, atol=1e-3)


def test_langevin_scale_sweep_replays_one_graph_on_card(_no_tf32):
    """A γ sweep of langevin_scale replays the one graph captured at the
    first γ (the cache holds one graph throughout) and matches the eager
    loop at each γ; the γs give different samples."""
    model = KarrasModel(PUNetG(_small_3d()), KarrasModelConfig.from_edm())
    model.init(seed=1)
    shape, outs = (32, 32, 32, 1), []
    for gamma in (0.25, 1.0, 2.0):
        out = model.sample(2, shape, torch.Generator("cuda").manual_seed(3),
                           nsteps=4, stochastic=True, langevin_scale=gamma)
        assert len(model._graphs.graphs) == 1
        ref = _eager_stochastic(model, 2, shape, 3, 4, stochastic=True,
                                langevin_scale=gamma)
        torch.testing.assert_close(out, ref, rtol=1e-3, atol=1e-3)
        outs.append(out)
    assert not torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[1], outs[2])


def test_sampler_graphs_follow_a_swapped_scheduler_on_card(_no_tf32):
    """``sample`` (Euler–Maruyama), ``sample_parallel`` (stochastic Picard)
    and ``sample_restart`` keep their graphs keyed on the scheduler
    (``Scheduler.graph_key``): after ``config.noisescheduler`` is swapped
    for one with another ``langevin_const`` and σ_max, each replays a
    graph of the new scheduler, bit for bit a fresh model's at it, and
    differs from its sample at the old one; an equal new scheduler
    object captures nothing."""
    from diffsci_tpu_torch.ops import EDMScheduler

    def model_at(sched):
        m = KarrasModel(PUNetG(_small_3d()), KarrasModelConfig.from_edm())
        m.init(seed=1)
        m.config.noisescheduler = sched
        return m

    shape = (32, 32, 32, 1)

    def gen():
        return torch.Generator("cuda").manual_seed(7)

    calls = {
        "sample": lambda m: m.sample(2, shape, gen(), nsteps=6,
                                     stochastic=True),
        "picard": lambda m: m.sample_parallel(2, shape, gen(), nsteps=6,
                                              window=4, tol=0.0,
                                              stochastic=True),
        "restart": lambda m: m.sample_restart(2, shape, gen(), nsteps=6)}
    old = EDMScheduler(langevin_const=0.5)
    model = model_at(old)
    before = {k: fn(model) for k, fn in calls.items()}
    model.config.noisescheduler = EDMScheduler(langevin_const=3.0,
                                               sigma_max=40.0)
    after = {k: fn(model) for k, fn in calls.items()}
    fresh = model_at(EDMScheduler(langevin_const=3.0, sigma_max=40.0))
    for name, fn in calls.items():
        assert torch.equal(after[name], fn(fresh)), name
        assert not torch.equal(after[name], before[name]), name
    held = len(model._graphs.graphs)
    model.config.noisescheduler = EDMScheduler(langevin_const=3.0,
                                               sigma_max=40.0)
    for fn in calls.values():
        fn(model)
    assert len(model._graphs.graphs) == held == 6


def test_graphed_sample_restart_matches_eager_on_card(_no_tf32):
    """sample_restart replays one graph per key: within phase 2's tolerance
    of the eager restart loop on the same draws (x_T, then the jumps'),
    the same bits twice, and nsteps + K·width network calls."""
    model = KarrasModel(PUNetG(_small_3d()), KarrasModelConfig.from_edm())
    model.init(seed=1)
    shape, nsteps, restarts = (32, 32, 32, 1), 6, ((0.3, 2.0, 1),)
    first = model.sample_restart(2, shape,
                                 torch.Generator("cuda").manual_seed(5),
                                 nsteps=nsteps, restarts=restarts)
    sched = model.config.noisescheduler
    gen = torch.Generator("cuda").manual_seed(5)
    x = torch.randn((2,) + shape, device="cuda", generator=gen)
    noises = torch.randn((1, 2) + shape, device="cuda", generator=gen)
    kernels.reset_launches()
    with torch.inference_mode():
        ref = sched._restart(x * sched.maximum_scale,
                             model._score(None, 1.0, x), nsteps, restarts,
                             None, noises)
    eager = _counts()
    kernels.reset_launches()
    again = model.sample_restart(2, shape,
                                 torch.Generator("cuda").manual_seed(5),
                                 nsteps=nsteps, restarts=restarts)
    assert _counts() == eager
    sigma = sched.create_steps(nsteps + 1)[:-1]
    i_hi = int(np.argmin(np.abs(sigma - 2.0)))
    i_lo = int(np.argmin(np.abs(sigma - 0.3)))
    width = i_lo - i_hi
    assert eager["fused_axby"] == 2 * nsteps - 1 + 2 * width
    assert torch.equal(first, again)
    torch.testing.assert_close(first, ref, rtol=1e-3, atol=1e-3)


def test_stochastic_capture_that_draws_raises_on_card():
    """A stochastic loop without its noise would draw inside the capture:
    the draw raises instead of capturing a generator, and the card stays
    usable."""
    model = KarrasModel(PUNetG(_small_3d()), KarrasModelConfig.from_edm())
    model.init(seed=1)
    cache = model._graph_cache()
    x = torch.zeros((1, 32, 32, 32, 1), device="cuda")

    def loop():
        return model.propagate_white_noise(
            x, nsteps=2, stochastic=True,
            generator=torch.Generator("cuda").manual_seed(0))

    cache.warmup(loop)
    with pytest.raises(RuntimeError, match="capture"):
        cache.capture("draws", loop)
    torch.cuda.synchronize()
    assert "draws" not in cache.graphs
    out = model.sample(1, (32, 32, 32, 1),
                       torch.Generator("cuda").manual_seed(0), nsteps=2,
                       stochastic=True)
    assert bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# the conditional and magnitude-preserving paths (chip_smoke.py phases
# 14 to 16)
# ---------------------------------------------------------------------------
def _small_d(dtype=None):
    """Configuration D's options at phase 2's cut: circular convolutions,
    a porosity embedding with cond_drop, the EDM batch norm."""
    import dataclasses

    from diffsci_tpu_torch.models.nets import PorosityEmbedder

    cfg = dataclasses.replace(_small_3d(), convolution_type="circular",
                              cond_drop=0.1)
    return KarrasModel(PUNetG(cfg, conditional_embedding=PorosityEmbedder(8)),
                       KarrasModelConfig.from_edm(has_edm_batch_norm=True),
                       conditional=True, compute_dtype=dtype)


def _small_e(dtype=None):
    """Configuration E's options at a cut: 2D, mp convolutions, cosine
    attention, the dynamic loss weight."""
    cfg = PUNetGConfig(model_channels=16, channel_expansion=[2],
                       number_resnet_downward_block=1,
                       number_resnet_upward_block=1,
                       number_resnet_before_attn_block=1,
                       number_resnet_after_attn_block=1,
                       convolution_type="mp", attn_type="cosine")
    return KarrasModel(PUNetG(cfg),
                       KarrasModelConfig.from_edm(dynamic_loss_weight=16),
                       compute_dtype=dtype)


def test_guided_sample_graph_matches_eager_on_card(_no_tf32):
    """The graph of a guided loop (IntervalGuidance, one porosity, the
    batch norm decoded): within phase 2's tolerance of the eager body;
    CFG's 2·(2n - 1) network calls and 2n - 1 combines; the porosity is a
    static input (another value, another sample, no new graph)."""
    from diffsci_tpu_torch import IntervalGuidance

    model = _small_d()
    state = model.init(seed=1)
    state["bnorm.mean"].fill_(0.1)
    state["bnorm.var"].fill_(2.0)
    shape = (32, 32, 32, 1)
    kw = dict(guidance=IntervalGuidance(2.0, 0.3, 5.0), nsteps=3)

    def graphed(p):
        return model.sample(2, shape, torch.Generator("cuda").manual_seed(7),
                            y={"porosity": torch.tensor([p])}, **kw)

    first = graphed(0.3)
    kernels.reset_launches()
    again = graphed(0.3)
    assert _counts() == {"fused_axby": 5, "norm_silu": 2 * 5 * 12,
                         "flash_attention": 10}
    noise = torch.randn((2,) + shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(7))
    ref = model.decode(model.propagate_white_noise(
        noise, y={"porosity": torch.tensor([0.3], device="cuda")}, **kw))
    assert torch.equal(first, again)
    torch.testing.assert_close(first, ref, rtol=1e-3, atol=1e-3)
    ngraphs = len(model._graphs.graphs)
    assert not torch.equal(graphed(0.45), first)
    assert len(model._graphs.graphs) == ngraphs


def test_batch_norm_and_mp_graphed_steps_match_eager_on_card(_no_tf32):
    """Graphed train steps against eager ones from the same weights and
    draws: D's (keep mask replayed) leave the same running statistics
    after every step; E's (has_mp_weights) the same loss within rtol 1e-3
    and the mp weights re-projected (phase 3's bounds on the
    parameters)."""
    gen = torch.Generator("cuda").manual_seed(5)
    for make, x_shape, kw in ((_small_d, (2, 32, 32, 32, 1),
                               dict(y={"porosity": torch.tensor(
                                   [[0.2], [0.4]], device="cuda")})),
                              (_small_e, (2, 16, 16, 1), {})):
        x = torch.randn(x_shape, device="cuda", generator=gen) * 0.5 + 0.3
        draws = [(torch.exp(torch.randn(2, device="cuda", generator=gen)),
                  torch.randn(x_shape, device="cuda", generator=gen))
                 for _ in range(3)]
        runs = []
        for raw in (True, False):
            model = make()
            state, tx = create_train_state(model, x_shape, seed=3)
            step = make_train_step(model, tx, has_mp_weights=True, _raw=raw)
            out = []
            for sigma, eps in draws:
                met = step(state, x, sigma=sigma, eps=eps,
                           keep=torch.tensor([True, False], device="cuda"),
                           **kw)[1]
                out.append((float(met["train_loss"]), [
                    b.clone() for b in model.net.buffers()]))
            runs.append((out, {k: v.detach().clone()
                               for k, v in state.params.items()}))
        (eager, p_eager), (graph, p_graph) = runs
        np.testing.assert_allclose([o[0] for o in graph],
                                   [o[0] for o in eager], rtol=1e-3)
        for (_, b_graph), (_, b_eager) in zip(graph, eager):
            assert all(torch.equal(a, b) for a, b in zip(b_graph, b_eager))
        diff = torch.cat([(p_graph[n] - p_eager[n]).abs().flatten()
                          for n in p_eager]).cpu().numpy()
        assert np.quantile(diff, 0.999) <= 0.05 * 1e-3
        assert diff.max() <= 2 * 3 * 1e-3


def _small_2d():
    return PUNetGConfig(model_channels=8, channel_expansion=[2],
                        number_resnet_downward_block=1,
                        number_resnet_upward_block=1,
                        number_resnet_attn_block=1,
                        number_resnet_before_attn_block=1,
                        number_resnet_after_attn_block=1, num_heads=2)


def test_restore_in_place_under_captured_graphs_on_card(tmp_path):
    """A checkpoint restored into the live state, under its captured graphs
    (the two of gradient accumulation and the EMA update's): the same
    steps from the same generator give the same parameters, AdamW moments,
    accumulated gradients and EMA shadows bit for bit, and no graph is
    captured again."""
    from diffsci_tpu_torch import (accumulate_gradients, restore_checkpoint,
                                   save_checkpoint)
    from diffsci_tpu_torch.checkpoint import state_tensors

    model = KarrasModel(PUNetG(_small_2d()), KarrasModelConfig.from_edm(),
                        compute_dtype=torch.bfloat16)
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05, 0.1],
                         update_every=2)
    state, tx = create_train_state(
        model, (4, 16, 16, 1), seed=0, ema=tracker,
        optimizer=accumulate_gradients(default_optimizer(), 2))
    step = make_train_step(model, tx, ema=tracker)
    x = torch.randn((4, 16, 16, 1), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))

    def run(seed, n=3):
        gen = torch.Generator("cuda").manual_seed(seed)
        for _ in range(n):
            step(state, x, generator=gen)
        return {k: t.clone() for k, t in state_tensors(state).items()}

    run(0, 4)                       # captures both step graphs and the EMA's
    save_checkpoint(tmp_path / "c", state, model.export_description())
    keys = set(state.graphs.graphs)
    first = run(11)
    restore_checkpoint(tmp_path / "c", state, model)
    assert state.step == 4
    again = run(11)
    assert set(state.graphs.graphs) == keys and len(keys) == 3
    for k in first:
        assert torch.equal(first[k], again[k]), k


def test_graphed_eval_step_matches_eager_on_card(_no_tf32):
    """make_eval_step's graph (σ and ε drawn into its static inputs)
    against the eager step from the same generator, on the parameters and
    on the EMA shadows, before and after more training (the graph reads
    both in place): within rtol 1e-5."""
    from diffsci_tpu_torch import make_eval_step

    model = KarrasModel(PUNetG(_small_2d()), KarrasModelConfig.from_edm())
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05])
    state, tx = create_train_state(model, (4, 16, 16, 1), seed=0,
                                   ema=tracker)
    step = make_train_step(model, tx, ema=tracker)
    gen = torch.Generator("cuda").manual_seed(2)
    x = torch.randn((4, 16, 16, 1), device="cuda", generator=gen)
    for use_ema in (False, True):
        graphed = make_eval_step(model, tracker, use_ema=use_ema)
        eager = make_eval_step(model, tracker, use_ema=use_ema, _raw=True)
        seen = []
        for _ in range(3):
            for _ in range(2):
                step(state, x, generator=gen)
            got = graphed(state, x, generator=torch.Generator(
                "cuda").manual_seed(7))["valid_loss"]
            ref = eager(state, x, generator=torch.Generator(
                "cuda").manual_seed(7))["valid_loss"]
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)
            seen.append(float(got))
        assert len(set(seen)) == 3      # each replay saw the new weights
    assert sum(k[0] == "eval" for k in state.graphs.graphs
               if isinstance(k, tuple)) == 2


def test_from_checkpoint_serves_like_the_in_memory_model_on_card(tmp_path):
    """SamplerService.from_checkpoint on the card gives, for one seed, the
    bits of a service over the in-memory state's EMA profile 0."""
    from diffsci_tpu_torch import SamplerService, save_checkpoint
    from diffsci_tpu_torch.models.karras import karras_model_from_description

    model = KarrasModel(PUNetG(_small_2d()), KarrasModelConfig.from_edm(),
                        compute_dtype=torch.bfloat16)
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05, 0.1])
    state, tx = create_train_state(model, (4, 16, 16, 1), seed=0,
                                   ema=tracker)
    step = make_train_step(model, tx, ema=tracker)
    gen = torch.Generator("cuda").manual_seed(3)
    x = torch.randn((4, 16, 16, 1), device="cuda", generator=gen)
    for _ in range(3):
        step(state, x, generator=gen)
    save_checkpoint(tmp_path / "c", state, model.export_description())
    kw = dict(batch_buckets=(1, 4), nsteps=3)
    served = SamplerService.from_checkpoint(tmp_path / "c", (16, 16, 1), **kw)
    ref = karras_model_from_description(model.export_description())
    ref.net.load_state_dict({**dict(model.net.named_buffers()),
                             **tracker.get_params(state.ema, 0)})
    mine = SamplerService(ref, (16, 16, 1), **kw)
    assert np.array_equal(served.sample(4, generator=5),
                          mine.sample(4, generator=5))


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_picard_sweep_graph_matches_eager_on_card(_no_tf32, tol):
    """``sample_parallel`` replays one graph of a Picard sweep: the same
    sweeps as the eager sweep on the same x_T, the result within phase 2's
    rtol 1e-3 + atol 1e-3, one K1 and one network call's K2 a sweep; at
    tol 0 the sequential Euler sample in nsteps sweeps; a second request
    of the same seed gives the same bits."""
    from diffsci_tpu_torch.ops import parallel_sampling as ps

    model = KarrasModel(PUNetG(_small_2d()), KarrasModelConfig.from_edm())
    model.init(seed=1)
    shape, nsteps = (16, 16, 1), 6
    kw = dict(nsteps=nsteps, window=4, tol=tol, return_sweeps=True)
    model.compile_parallel(2, shape, nsteps=nsteps, window=4, tol=tol)
    kernels.reset_launches()
    out, sweeps = model.sample_parallel(
        2, shape, torch.Generator("cuda").manual_seed(3), **kw)
    counts = _counts()
    x = torch.randn((2,) + shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    kernels.reset_launches()
    ref, ref_sweeps = ps.picard_window_sample(
        model.config.noisescheduler, x * 80.0, model._score(None, 1.0, x),
        nsteps=nsteps, window=4, tol=tol, return_sweeps=True)
    assert _counts() == counts and sweeps == ref_sweeps
    kernels.reset_launches()
    with torch.inference_mode():
        model.get_denoiser(x, torch.full((2,), 80.0, device="cuda"))
    assert counts == {k: n * sweeps for k, n in _counts().items()}
    assert counts["fused_axby"] == sweeps
    torch.testing.assert_close(out, ref, rtol=1e-3, atol=1e-3)
    again, _ = model.sample_parallel(
        2, shape, torch.Generator("cuda").manual_seed(3), **kw)
    assert torch.equal(out, again)
    if tol == 0.0:
        assert sweeps == nsteps
        seq = model.sample(2, shape, torch.Generator("cuda").manual_seed(3),
                           nsteps=nsteps, integrator="euler")
        torch.testing.assert_close(out, seq, rtol=1e-3, atol=1e-3)


def test_dispatcher_isolation_on_card():
    """The dispatcher thread replays the bucket graph that the warm-up
    captured on the caller's thread: a seeded request gives the same bits
    alone and crowded in one bucket, and its rows equal a plain request
    of the rows' generators."""
    import threading

    from diffsci_tpu_torch import SamplerService

    model = KarrasModel(PUNetG(_small_2d()), KarrasModelConfig.from_edm(),
                        compute_dtype=torch.bfloat16)
    model.init(seed=0)
    svc = SamplerService(model, (16, 16, 1), batch_buckets=(8,), nsteps=3,
                         batch_window_ms=20.0)
    svc.warmup()
    alone = svc.sample(3, 7)
    threads = [threading.Thread(target=svc.sample, args=(2, 100 + i))
               for i in range(2)]
    for t in threads:
        t.start()
    crowded = svc.sample(3, 7)
    for t in threads:
        t.join(60.0)
        assert not t.is_alive()
    svc.close()
    assert svc.stats["batched_dispatches"] >= 2
    assert np.array_equal(alone, crowded) and np.isfinite(alone).all()


def _crowd_first_rows(svc, seeds):
    """One one-row request a seed from its own thread, all at once; the
    results by seed."""
    import threading

    results = {}

    def client(seed):
        results[seed] = svc.sample(1, seed)

    threads = [threading.Thread(target=client, args=(s,)) for s in seeds]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
        assert not t.is_alive()
    svc.close()
    return results


def test_cold_onestep_dispatcher_on_card():
    """A 1-NFE dispatcher service that was never warmed by hand: 8
    concurrent first requests capture each bucket once (callers arriving
    during the warm-up wait, and the warm-up replays nothing), and each
    gets its row of ``sample_onestep`` with its row generator, bit for
    bit."""
    from diffsci_tpu_torch import SamplerService
    from diffsci_tpu_torch.models.karras.distill import sample_onestep
    from diffsci_tpu_torch.serving import row_seeds

    model = KarrasModel(PUNetG(_small_2d()), KarrasModelConfig.from_edm())
    model.init(seed=0)
    svc = SamplerService(model, (16, 16, 1), batch_buckets=(8,), nsteps=1,
                         batch_window_ms=20.0)
    compiles, compile_bucket = [], svc._compile

    def counted(b):
        compiles.append(b)
        compile_bucket(b)

    svc._compile = counted
    results = _crowd_first_rows(svc, range(200, 208))
    assert compiles == [8]
    for seed, got in results.items():
        gen = torch.Generator("cuda").manual_seed(row_seeds(seed, 1)[0])
        ref = sample_onestep(model, 8, (16, 16, 1), [gen])[:1]
        assert np.array_equal(got, ref.cpu().numpy())


def test_ddpm_dispatcher_on_card():
    """A DDPMModel service through the dispatcher (ancestral DDPM, 5
    steps, graphed): each concurrent request is bit for bit its row of
    ``DDPMModel.sample`` with its row generator, which draws the row's x_T
    and each step's noise."""
    from diffsci_tpu_torch import SamplerService
    from diffsci_tpu_torch.serving import row_seeds

    model = DDPMModel(HFNetUncond(block_channels=(32, 64), channels=3,
                                  norm_num_groups=8, attn_up_and_down=True),
                      DDPMModelConfig.from_ddpm("cosine"))
    model.init(seed=4)
    svc = SamplerService(model, (16, 16, 3), batch_buckets=(4,), nsteps=5,
                         batch_window_ms=20.0)
    svc.warmup()
    results = _crowd_first_rows(svc, range(300, 306))
    assert svc.stats["batched_dispatches"] >= 2
    for seed, got in results.items():
        gen = torch.Generator("cuda").manual_seed(row_seeds(seed, 1)[0])
        ref = model.sample(4, (16, 16, 3), generator=[gen], nsteps=5)[:1]
        assert np.isfinite(got).all()
        assert np.array_equal(got, ref.cpu().numpy())


@pytest.mark.parametrize("kind", ["schedule_free", "bf16"])
def test_graphed_optimizer_steps_match_eager_on_card(_no_tf32, kind):
    """The two optimizers written for the port under the graphed step: 3
    f32 steps against the eager step from the same weights and draws
    (phase 3's bounds), the same launches a step."""
    from diffsci_tpu_torch import schedule_free_optimizer

    tx = (schedule_free_optimizer(1e-3) if kind == "schedule_free"
          else default_optimizer(1e-3, mu_dtype=torch.bfloat16))
    m_raw, s_raw, c_raw = _train(False, False, False, tx=tx)
    m_graph, s_graph, c_graph = _train(True, False, False, tx=tx)
    assert c_graph == c_raw
    np.testing.assert_allclose(m_graph, m_raw, rtol=1e-3)
    diff = torch.cat([(s_graph.params[n].detach() - p.detach()).abs()
                      .flatten() for n, p in s_raw.params.items()])
    assert np.quantile(diff.cpu().numpy(), 0.999) <= 0.05 * 1e-3
    assert float(diff.max()) <= 2 * 3 * 1e-3
    if kind == "bf16":
        assert all(s["exp_avg"].dtype == torch.bfloat16
                   for s in s_graph.optimizer.state.values())


def _distill_pair(dtype):
    """A small student and a teacher of other weights (seeds 0 and 1)."""
    from diffsci_tpu_torch.models.karras import distill

    model = KarrasModel(PUNetG(_small_2d()), KarrasModelConfig.from_edm(),
                        compute_dtype=dtype)
    model.init(seed=0)
    teacher = distill._teacher_like(model)
    teacher.init(seed=1)
    return model, teacher


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_graphed_distill_step_matches_eager_on_card(_no_tf32, dtype):
    """``make_distill_step``'s graph against its eager body from the same
    weights and replayed draws (f32, and bf16 over f32 masters, where the
    teacher's cast copy is made in the graph): three steps bit for bit
    (losses, grad norms, parameters), then the teacher reloaded in place
    with other weights, and two more steps of the same graph against the
    eager step with the new teacher, bit for bit; one graph in all, with
    the teacher's and the student's launches in it."""
    from diffsci_tpu_torch.models.karras import distill
    from diffsci_tpu_torch.models.karras.train import _new_train_state

    arms = {}
    for graphed in (False, True):
        model, teacher = _distill_pair(dtype)
        tx = default_optimizer(1e-3)
        state = _new_train_state(model, tx)
        step = distill.make_distill_step(model, tx, 3, _raw=not graphed)
        arms[graphed] = (model, teacher, state, step)
    gen = torch.Generator("cuda").manual_seed(3)
    x = torch.randn(4, 16, 16, 1, generator=gen, device="cuda")
    new_teacher = None
    for k in range(5):
        if k == 3:
            new_teacher = {n: v.clone() for n, v in
                           _distill_pair(dtype)[0].init(seed=7).items()}
            for model, teacher, _, _ in arms.values():
                teacher.net.load_state_dict(new_teacher)
        idx = torch.randint(0, 3, (4,), generator=gen, device="cuda")
        eps = torch.randn(x.shape, generator=gen, device="cuda")
        mets = {}
        for graphed, (model, teacher, state, step) in arms.items():
            _, mets[graphed] = step(state, teacher, x, idx=idx, eps=eps)
        for name in ("distill_loss", "grad_norm"):
            assert torch.equal(mets[True][name], mets[False][name]), (k, name)
        for n, p in arms[False][2].params.items():
            assert torch.equal(arms[True][2].params[n], p), (k, n)
    graphs = arms[True][2].graphs.graphs
    assert len(graphs) == 1
    launches = next(iter(graphs.values())).launches
    # four teacher denoiser calls (Heun) a step, each one K1
    assert launches["fused_axby"] == 4, launches


def _vae_models(seed=0):
    from diffsci_tpu_torch import (NLayerDiscriminator, VAEModel,
                                   VAEModelConfig, VAENet, VAENetConfig)

    cfg = VAENetConfig(dimension=2, ch=8, ch_mult=(1, 2), num_res_blocks=1,
                       resolution=16, num_groups=4)
    model = VAEModel(VAENet(cfg), VAEModelConfig(
        adversarial_weight=0.05, discriminator_frequency=2,
        loss_preprocessor="edges", total_variation_weight=0.1),
        discriminator=NLayerDiscriminator(ndf=8, n_layers=2))
    return model


@pytest.fixture
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms: some of its backward algorithms
    for f32 convolutions accumulate with atomics, so two eager steps
    differ in their last bits without it."""
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = flag


def test_graphed_vae_step_matches_eager_on_card(_no_tf32,
                                                _deterministic_cudnn):
    """``make_vae_train_step``'s graph against its eager body from the same
    weights and z-noise: four steps bit for bit (every metric, both
    networks' parameters and Adam moments), the second with the
    frequency gate at 0 (the discriminator's weights stay, its moments
    move); a KL weight set between steps reaches the graph (one graph in
    all)."""
    from diffsci_tpu_torch import (KLAnnealing, create_vae_train_state,
                                   make_vae_train_step)

    arms = {}
    for graphed in (False, True):
        model = _vae_models()
        state, tx, dtx = create_vae_train_state(model, (2, 1, 16, 16),
                                                seed=0)
        arms[graphed] = (model, state,
                         make_vae_train_step(model, tx, dtx,
                                             _raw=not graphed))
    gen = torch.Generator("cuda").manual_seed(2)
    x = torch.randn(2, 1, 16, 16, generator=gen, device="cuda")
    for k in range(4):
        if k == 3:
            for model, _, _ in arms.values():
                KLAnnealing(model.config, 1e-3, 0.5, 2).on_epoch(2)
        eps = torch.randn(2, 4, 8, 8, generator=gen, device="cuda")
        before = {n: p.detach().clone()
                  for n, p in arms[True][1].disc_params.items()}
        mets = {}
        for graphed, (model, state, step) in arms.items():
            _, mets[graphed] = step(state, x, eps=eps)
        assert mets[True].keys() == mets[False].keys()
        for name, v in mets[False].items():
            assert torch.equal(mets[True][name], v), (k, name)
        for attr in ("params", "disc_params"):
            for n, p in getattr(arms[False][1], attr).items():
                assert torch.equal(getattr(arms[True][1], attr)[n], p), \
                    (k, n)
        for opt in ("optimizer", "disc_optimizer"):
            eager = getattr(arms[False][1], opt)
            graph = getattr(arms[True][1], opt)
            for pe, pg in zip(eager.param_groups[0]["params"],
                              graph.param_groups[0]["params"]):
                for key in ("exp_avg", "exp_avg_sq", "step"):
                    assert torch.equal(graph.state[pg][key],
                                       eager.state[pe][key]), (k, key)
        if k == 1:
            assert float(mets[True]["disc_updated"]) == 0.0
            for n, p in arms[True][1].disc_params.items():
                assert torch.equal(p, before[n]), n
    assert float(mets[True]["kl_loss"]) > 0
    assert len(arms[True][1].graphs.graphs) == 1


def test_graphed_si_sample_matches_eager_on_card(_no_tf32):
    """``SIModel.sample`` replays one graph of the whole loop per key:
    Heun (6 steps: 9 network calls) and Euler–Maruyama (5 calls, the
    loop's noise a static input) bit for bit the eager
    ``integrate_flow_field`` on the same draws, launches included; one
    seed gives the same bits twice; the running norm's statistics are
    read in place (a change reaches the next replay)."""
    from diffsci_tpu_torch import SIModel, SIModelConfig

    model = SIModel(PUNetG(_small_3d()), SIModelConfig(initial_norm=True))
    model.init(seed=1)
    shape = (32, 32, 32, 1)
    for kw in ({}, {"noise_injection": True}):
        n_noise = 5 if kw else 0
        out = model.sample(2, shape, torch.Generator("cuda").manual_seed(7),
                           nsteps=6, **kw)
        g = torch.Generator("cuda").manual_seed(7)
        x = torch.randn((2,) + shape, generator=g, device="cuda")
        seq = torch.randn((n_noise, 2) + shape, generator=g, device="cuda") \
            if kw else None
        kernels.reset_launches()
        with torch.no_grad():
            ref = model.integrate_flow_field(x * model._sigma_init(), 6,
                                             noise_seq=seq, **kw)
        eager = _counts()
        kernels.reset_launches()
        again = model.sample(2, shape, torch.Generator("cuda").manual_seed(7),
                             nsteps=6, **kw)
        assert _counts() == eager
        assert eager["flash_attention"] == (5 if kw else 9)
        assert torch.equal(out, again) and torch.equal(out, ref)
    with torch.no_grad():
        model.net.initial_norm.mean.fill_(0.5)
    moved = model.sample(2, shape, torch.Generator("cuda").manual_seed(7),
                         nsteps=6, noise_injection=True)
    assert torch.equal(moved, out + 0.5)


def test_si_dispatcher_on_card():
    """``SamplerService`` serves an ``SIModel`` (bf16, Euler–Maruyama)
    through its dispatcher: each concurrent request is bit for bit its row
    of ``SIModel.sample`` with its row generator, which draws the row's
    x_T and loop noise."""
    from diffsci_tpu_torch import SamplerService, SIModel, SIModelConfig
    from diffsci_tpu_torch.serving import row_seeds

    model = SIModel(PUNetG(_small_2d()), SIModelConfig(),
                    compute_dtype=torch.bfloat16)
    model.init(seed=4)
    kw = {"noise_injection": True}
    svc = SamplerService(model, (16, 16, 1), batch_buckets=(4,), nsteps=5,
                         sample_kwargs=kw, batch_window_ms=20.0)
    svc.warmup()
    results = _crowd_first_rows(svc, range(400, 406))
    assert svc.stats["batched_dispatches"] >= 2
    for seed, got in results.items():
        gen = torch.Generator("cuda").manual_seed(row_seeds(seed, 1)[0])
        ref = model.sample(4, (16, 16, 1), [gen], nsteps=5, **kw)[:1]
        assert np.isfinite(got).all()
        assert np.array_equal(got, ref.cpu().numpy())


@pytest.mark.parametrize("probability_flow", [False, True])
def test_graphed_sde_and_v1_steps_match_eager_on_card(_no_tf32,
                                                      probability_flow):
    """``SDEModel.sample`` (one graph of a step, replayed per step) bit for
    bit the eager ``sde_sampler``/``pf_sampler`` on the same draws, 8
    steps; and ``DDPMModuleV1.sample`` (DDIM, noise type 2, T 8) bit for
    bit its eager ``step`` loop on the same draws."""
    from diffsci_tpu_torch import DDPMModuleV1, DDPMSchedulerV1, SDEModel
    from diffsci_tpu_torch.models import sde

    model = SDEModel(PUNetG(_small_2d()), sde.VPSchedulerLinear(coef=19.9))
    model.init(seed=2)
    shape = (16, 16, 1)
    out = model.sample(3, shape, torch.Generator("cuda").manual_seed(5),
                       nsteps=8, probability_flow=probability_flow)
    g = torch.Generator("cuda").manual_seed(5)
    x = torch.randn((3,) + shape, generator=g, device="cuda")
    x = model.scheduler.prior_scale(x) * x
    with torch.no_grad():
        if probability_flow:
            ref = sde.pf_sampler(model.scheduler, model.noise_predictor, 3,
                                 shape, nsteps=8, x0=x)
        else:
            ref = sde.sde_sampler(model.scheduler, model.noise_predictor, 3,
                                  shape, nsteps=8, generator=g, x_T=x)
    assert torch.equal(out, ref)
    v1 = DDPMModuleV1(PUNetG(_small_2d()), DDPMSchedulerV1(T=8))
    v1.init(seed=3)
    out = v1.sample(3, shape, torch.Generator("cuda").manual_seed(6),
                    sampler="ddim", noise_type=2)
    g = torch.Generator("cuda").manual_seed(6)
    x = torch.randn((3,) + shape, generator=g, device="cuda")
    with torch.no_grad():
        for t in range(8, 0, -1):
            noise = torch.randn(x.shape, generator=g, device="cuda")
            x = v1.step(x, torch.tensor(float(t), device="cuda"), noise,
                        sampler="ddim", noise_type=2)
    assert torch.equal(out, x) and bool(torch.isfinite(out).all())


def test_inception_features_card_against_cpu(_no_tf32):
    """The pytorch-fid InceptionV3 (synthetic weights, seed 0) on the card
    against the CPU, f32 with TF32 off: ``inception_fid_features`` of 5
    grayscale 28² images at batch 2 (the resize, the RGB repeat and the
    net) within 1e-4 of the features' scale, shape [5, 2048]."""
    from diffsci_tpu_torch import metrics_inception as mi

    x = np.random.default_rng(0).uniform(size=(5, 28, 28, 1)).astype(
        np.float32)
    card = mi.inception_fid_features(mi.InceptionV3FID().init(0), x,
                                     batch_size=2)
    cpu = mi.inception_fid_features(mi.InceptionV3FID(device="cpu").init(0),
                                    x, batch_size=2)
    assert card.shape == cpu.shape == (5, 2048)
    np.testing.assert_allclose(card, cpu, rtol=0,
                               atol=1e-4 * float(np.abs(cpu).max()))


def test_fld_distances_in_full_f32_with_tf32_on():
    """With the global TF32 flag on, FLD's squared distances of
    standardized 2048-d features (norms ~2048) stay full-precision
    products (float64, rounded to f32): within 1e-6 relative of float64
    at their ~4096 scale, where TF32 would be off by ~1; ``fld`` on the
    card equals the CPU's within 1e-3 of
    max(1, |FLD|); the flag is as it was after."""
    from diffsci_tpu_torch import metrics

    rng = np.random.default_rng(1)
    a = rng.standard_normal((300, 2048)).astype(np.float32)
    b = rng.standard_normal((200, 2048)).astype(np.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        d2 = metrics._pairwise_sq_dists(torch.from_numpy(a).cuda(), b)
        assert torch.backends.cuda.matmul.allow_tf32
        ref = ((a[:, None, :].astype(np.float64) - b[None]) ** 2).sum(-1)
        err = float(np.abs(d2.cpu().numpy() - ref).max())
        assert err < 1e-6 * float(ref.max()), err
        kw = dict(n_iters=50, lr=0.1, seed=0)
        card = metrics.fld(a, a[:100] + 0.1, b, **kw)
        cpu = metrics.fld(a, a[:100] + 0.1, b, device="cpu", **kw)
        assert abs(card - cpu) <= 1e-3 * max(1.0, abs(cpu)), (card, cpu)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_grid_volume_card_against_cpu(_no_tf32):
    """``sample_grid_volume`` with a small SIModel (a 3D PUNetG of 8
    channels) at grid (2, 2, 2), 8³ cubes, overlap 4, on the card and the
    CPU from one replayed noise cube: the corner cube (deterministic Heun,
    the card's graphed sampler) agrees within 1e-3 of its scale, and every
    inpainted cube keeps its known region exactly on the card."""
    from diffsci_tpu_torch import SIModel, SIModelConfig, extra

    cfg = dataclasses.replace(_small_3d(), attn_backend="xla")
    noise = torch.randn((1, 16, 16, 16, 1),
                        generator=torch.Generator().manual_seed(0))
    vols, corners = {}, {}
    for dev in ("cuda", "cpu"):
        model = SIModel(PUNetG(cfg, device=dev), SIModelConfig(),
                        device=dev)
        model.init(seed=1)
        inner = model.inpaint
        known = []

        def inpaint(x_orig, mask, _inner=inner, _known=known, **kw):
            out = _inner(x_orig, mask, **kw)
            k = mask == 1.0
            _known.append(bool(torch.equal(out[0][k], x_orig[k])))
            return out

        model.inpaint = inpaint
        vols[dev] = extra.sample_grid_volume(
            model, torch.Generator(dev).manual_seed(2), [2, 2, 2],
            (8, 8, 8, 1), 4, nsteps=4, noise_cube=noise).cpu()
        assert known == [True] * 7, known
        corners[dev] = vols[dev][0, :10, :10, :10]
    scale = max(1.0, float(corners["cpu"].abs().max()))
    err = float((corners["cuda"] - corners["cpu"]).abs().max())
    assert err <= 1e-3 * scale, err
    assert bool(torch.isfinite(vols["cuda"]).all())


@pytest.fixture
def _nccl_mesh():
    """A one-rank NCCL process group (a free localhost port) and its
    ``data`` mesh; the group is left as the test found it."""
    import torch.distributed as dist

    from diffsci_tpu_torch.parallel import initialize_distributed, make_mesh
    fresh = not dist.is_initialized()
    initialize_distributed(device_type="cuda")
    assert dist.get_backend() == "nccl"
    yield make_mesh(device_type="cuda")
    if fresh:
        dist.destroy_process_group()


@pytest.fixture
def _deterministic():
    """cuDNN's deterministic algorithms, so that two captures of one step
    pick the same ones."""
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = flag


def test_world1_nccl_dp_step_is_the_plain_step_on_card(_no_tf32,
                                                       _deterministic,
                                                       _nccl_mesh):
    """The data-parallel train step over one NCCL rank (the gradient
    all-reduce captured in the step's graph) gives the plain graphed
    step's numbers bit for bit, over 3 steps from copies of one state
    and one set of draws (chip_smoke.py phase 37 (a) at a cut width; the
    plain attention, whose backward has no split sums)."""
    from diffsci_tpu_torch.parallel import replicate, shard_batch

    cfg = dataclasses.replace(_small_3d(), attn_backend="xla")
    x = torch.randn((4, 32, 32, 32, 1), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    runs = []
    for placed in (False, True):
        model = KarrasModel(PUNetG(cfg), KarrasModelConfig.from_edm())
        tracker = EMATracker(ema_type="power", power_function_stds=[0.05])
        state, tx = create_train_state(model, x.shape, seed=0, ema=tracker)
        xb = x
        if placed:
            replicate(state, _nccl_mesh)
            xb = shard_batch(x, _nccl_mesh)
        step = make_train_step(model, tx, ema=tracker)
        gen = torch.Generator("cuda").manual_seed(1)
        metrics = [step(state, xb, generator=gen)[1] for _ in range(3)]
        runs.append(([(float(m["train_loss"]), float(m["grad_norm"]))
                      for m in metrics],
                     {k: v.detach().clone() for k, v in state.params.items()},
                     state))
    (m0, p0, _), (m1, p1, s1) = runs
    assert s1.graphs is not None and s1.graphs.graphs
    assert m0 == m1
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name


def test_sample_on_a_one_rank_mesh_is_the_plain_sample_on_card(_nccl_mesh):
    """``KarrasModel.sample(mesh=...)``, ``DDPMModel.sample(mesh=...)`` and
    ``sample_onestep(mesh=...)`` over one NCCL rank: the requests without
    a mesh, bit for bit; an indivisible batch raises on a larger mesh's
    contract (``data_rows``)."""
    from diffsci_tpu_torch.models.karras.distill import sample_onestep
    from diffsci_tpu_torch.parallel.mesh import data_rows

    model = KarrasModel(PUNetG(_small_3d()), KarrasModelConfig.from_edm())
    model.init(seed=0)
    for fn in (lambda **kw: model.sample(4, (32, 32, 32, 1),
                                         torch.Generator("cuda")
                                         .manual_seed(7), nsteps=4, **kw),
               lambda **kw: sample_onestep(model, 4, (32, 32, 32, 1),
                                           torch.Generator("cuda")
                                           .manual_seed(7), **kw)):
        assert torch.equal(fn(), fn(mesh=_nccl_mesh))
    ddpm = DDPMModel(HFNetUncond(block_channels=(32, 64), channels=3,
                                 norm_num_groups=8, attn_up_and_down=True),
                     DDPMModelConfig.from_ddim("cosine"))
    ddpm.init(seed=4)
    a = ddpm.sample(2, (16, 16, 3), torch.Generator("cuda").manual_seed(3),
                    nsteps=5)
    b = ddpm.sample(2, (16, 16, 3), torch.Generator("cuda").manual_seed(3),
                    nsteps=5, mesh=_nccl_mesh)
    assert torch.equal(a, b)
    assert data_rows(_nccl_mesh, 3) == slice(0, 3)
