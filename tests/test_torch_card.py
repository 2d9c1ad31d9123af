"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card. The
module imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

(``--noconftest`` leaves out ``tests/conftest.py``, which configures JAX.)
The tolerances are ``chip_smoke.py`` phase 1's.
"""

import pytest
import torch

from diffsci_tpu_torch import kernels
from diffsci_tpu_torch.kernels import flash_attention as fa
from diffsci_tpu_torch.kernels import fused_norm as fn
from diffsci_tpu_torch.kernels import fused_precondition as fp

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
                                "fused_lincomb3": 1}


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


def test_flash_dkv_is_deterministic_on_card():
    """K6 in bf16 has one writer per output tile and no atomics: the same
    inputs give bit-identical dK and dV."""
    gen = torch.Generator("cuda").manual_seed(4)
    q, k, v, do = (torch.randn((4, 2, 4096, 32), generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    first = fa.flash_attention_dkv(q, k, v, do, lse, delta)
    second = fa.flash_attention_dkv(q, k, v, do, lse, delta)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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
