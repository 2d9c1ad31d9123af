"""The port's kernels (``diffsci_tpu_torch/kernels``) against the JAX
package.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold the plain versions against the JAX functions on the same numpy inputs,
with the Pallas kernels in interpret mode as ``tests/test_kernels.py`` runs
them. ``tests/test_torch_card.py`` holds each CUDA kernel against its
plain version on an NVIDIA card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu.kernels import flash_attention as jfa
from diffsci_tpu.kernels import fused_norm as jfn
from diffsci_tpu.kernels import fused_precondition as jfp
from diffsci_tpu.models.nets import layers as jlayers

from diffsci_tpu_torch.kernels import flash_attention as fa
from diffsci_tpu_torch.kernels import fused_norm as fn
from diffsci_tpu_torch.kernels import fused_precondition as fp
from diffsci_tpu_torch.models.nets import layers
from tests import _torch_warmup  # noqa: F401  (MKL's first exp, CPU threads)


def _nc(a):
    """channels-last numpy -> NC* torch"""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _cl(t):
    """NC* torch -> channels-last numpy"""
    return np.moveaxis(t.float().numpy(), 1, -1)


# ---------------------------------------------------------------------------
# K1: fused_axby
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hw", [28, 32])            # N = 784 and 1024
@pytest.mark.parametrize("coeff", ["scalar", "one", "batch"])
def test_fused_axby_plain_matches_jax(hw, coeff):
    rng = np.random.default_rng(hw)
    B = 3
    x = rng.standard_normal((B, hw, hw, 1)).astype(np.float32) * 40
    f = rng.standard_normal((B, hw, hw, 1)).astype(np.float32)
    a, b = {"scalar": (np.float32(0.7), np.float32(-1.3)),
            "one": (np.array([0.7], np.float32),
                    np.array([-1.3], np.float32)),
            "batch": (rng.random(B).astype(np.float32),
                      rng.standard_normal(B).astype(np.float32))}[coeff]
    ref = np.asarray(jfp.fused_axby(jnp.asarray(x), jnp.asarray(f),
                                    jnp.asarray(a), jnp.asarray(b), True))
    out = fp.fused_axby(torch.from_numpy(x), torch.from_numpy(f),
                        torch.as_tensor(a), torch.as_tensor(b))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("times", ["batch", "scalar"])
def test_euler_update_matches_jax(times):
    """euler_update (one K1 launch with a = 1 + r(1 − c_skip),
    b = −r·c_out) against the JAX function in interpret mode and against
    the unfused x + (t_next − t)/t·(x − D), D = c_skip·x + c_out·f, on
    tests/test_kernels.py's shapes and bound (rtol 1e-5, atol 1e-6), with
    t and t_next per batch row or one scalar."""
    rng = np.random.default_rng(6)
    x, f = (rng.standard_normal((3, 8, 8, 2)).astype(np.float32)
            for _ in range(2))
    c_skip = np.array([0.3, 0.5, 0.9], np.float32)
    c_out = np.array([1.2, 0.4, -0.6], np.float32)
    t, t_next = ((np.array([10.0, 5.0, 1.0], np.float32),
                  np.array([7.0, 3.0, 0.5], np.float32)) if times == "batch"
                 else (np.float32(10.0), np.float32(7.0)))
    ref = np.asarray(jfp.euler_update(*(jnp.asarray(v) for v in
                                        (x, f, c_skip, c_out, t, t_next)),
                                      True))
    out = fp.euler_update(*(torch.as_tensor(v) for v in
                            (x, f, c_skip, c_out, t, t_next)))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)

    def br(v):
        return np.reshape(v, np.shape(v) + (1,) * (x.ndim - np.ndim(v)))
    D = br(c_skip) * x + br(c_out) * f
    unfused = x + br((t_next - t) / t) * (x - D)
    np.testing.assert_allclose(out.numpy(), unfused, rtol=1e-5, atol=1e-6)


_COEFFS = {
    "float": lambda B: 0.7,
    "0-d": lambda B: torch.tensor(-1.3),
    "[1]": lambda B: torch.tensor([0.25]),
    "[B]": lambda B: torch.arange(B, dtype=torch.float32) - 1.5,
    "[B,1,1,1]": lambda B: torch.linspace(-2, 2, B).view(B, 1, 1, 1),
    "float64": lambda B: torch.linspace(-2, 2, B, dtype=torch.float64),
    "strided [B]": lambda B: torch.arange(2 * B, dtype=torch.float32)[::2],
}


@pytest.mark.parametrize("kind", list(_COEFFS))
def test_coefficient_fold(kind):
    """The launch path's fold of a coefficient gives the [B] f32 values
    of as_tensor → reshape(-1) → expand(B) → contiguous for every form a
    caller may pass, and a contiguous [B] f32 tensor on x's device (what
    every call site passes) is the very same object, with no copy."""
    B = 4
    c = _COEFFS[kind](B)
    got = fp._coeff(c, B, torch.device("cpu"))
    ref = torch.as_tensor(c, dtype=torch.float32).reshape(-1).expand(B) \
        .contiguous()
    assert got.dtype == torch.float32 and got.shape == (B,)
    assert got.is_contiguous()
    assert torch.equal(got, ref)
    assert (got is c) == (kind == "[B]")


# ---------------------------------------------------------------------------
# K7: fused_lincomb3
# ---------------------------------------------------------------------------
def _lincomb3_coeffs(coeff, B, rng):
    return {"scalar": (np.float32(0.7), np.float32(-1.3), np.float32(0.2)),
            "one": tuple(np.array([v], np.float32) for v in (0.7, -1.3, 0.2)),
            "batch": tuple(rng.standard_normal(B).astype(np.float32)
                           for _ in range(3))}[coeff]


@pytest.mark.parametrize("shape", [(3, 8, 16), (4, 3), (2, 16, 16, 3)])
@pytest.mark.parametrize("coeff", ["scalar", "one", "batch"])
def test_fused_lincomb3_plain_matches_jax(shape, coeff):
    """K7's plain version against the JAX function, its Pallas kernel in
    interpret mode where N tiles by 128 ((3, 8, 16)) and its XLA arm
    elsewhere; rtol 1e-6, atol 1e-6 (tests/test_kernels.py's bound)."""
    rng = np.random.default_rng(len(shape))
    x, f, g = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    a, b, c = _lincomb3_coeffs(coeff, shape[0], rng)
    ref = np.asarray(jfp.fused_lincomb3(*(jnp.asarray(v) for v in
                                          (x, f, g, a, b, c)), True))
    out = fp.fused_lincomb3(*(torch.as_tensor(v) for v in (x, f, g, a, b, c)))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("coeff", ["scalar", "one", "batch"])
def test_fused_lincomb3_grads_match_jax(coeff):
    """FusedLincomb3's backward (the plain expression of the JAX package's
    custom VJP) in all six arguments, through tanh as the JAX package's
    test takes it, f32: rtol 1e-5, atol 1e-6 (tests/test_kernels.py)."""
    rng = np.random.default_rng(6)
    shape = (3, 8, 16)
    x, f, g = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    args = (x, f, g) + _lincomb3_coeffs(coeff, 3, rng)

    def jloss(*a):
        return jnp.sum(jnp.tanh(jfp.fused_lincomb3(*a, True)))
    ref = [np.asarray(r) for r in jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in args))]
    leaves = [torch.from_numpy(np.asarray(a)).requires_grad_() for a in args]
    torch.tanh(fp.fused_lincomb3(*leaves)).sum().backward()
    for r, t, name in zip(ref, leaves, "xfgabc"):
        assert t.grad.shape == r.shape, name
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-5, atol=1e-6,
                                   err_msg=f"d{name}")


def test_fused_lincomb3_wrapper_graph_and_mixed_dtypes():
    """In the graph it is FusedLincomb3; where autograd records nothing the
    forward's own output, bit for bit. Each of x, f and g may be bf16 on
    its own; the output takes x's dtype, the math stays f32."""
    gen = torch.Generator().manual_seed(0)
    x, f, g = (torch.randn(2, 5, 3, generator=gen) for _ in range(3))
    c = torch.tensor([0.5, 2.0], requires_grad=True)
    z = fp.fused_lincomb3(x, f, g, c, -1.0, 0.25)
    assert type(z.grad_fn).__name__ == "FusedLincomb3Backward"
    z.sum().backward()
    torch.testing.assert_close(c.grad, x.sum((1, 2)), rtol=1e-6, atol=1e-6)
    with torch.inference_mode():
        z = fp.fused_lincomb3(x, f, g, c, -1.0, 0.25)
        assert z.grad_fn is None
        torch.testing.assert_close(
            z, fp.fused_lincomb3_fwd(x, f, g, c, -1.0, 0.25), rtol=0, atol=0)
        for dx, df, dg in ((torch.float32, torch.bfloat16, torch.float32),
                           (torch.bfloat16, torch.float32, torch.bfloat16)):
            xs, fs, gs = x.to(dx), f.to(df), g.to(dg)
            out = fp.fused_lincomb3(xs, fs, gs, c, -1.0, 0.25)
            ref = (c.view(2, 1, 1) * xs.float() - fs.float()
                   + 0.25 * gs.float()).to(dx)
            assert out.dtype == dx
            torch.testing.assert_close(out, ref, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K2: norm_silu
# ---------------------------------------------------------------------------
_NORM_SHAPES = [(2, 7, 7, 16), (2, 4, 4, 4, 8), (3, 13, 8)]


@pytest.mark.parametrize("shape", _NORM_SHAPES)
@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_norm_silu_plain_matches_jax_kernel(shape, kind):
    rng = np.random.default_rng(len(shape))
    C = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.3).astype(np.float32)
    w = (rng.standard_normal(C) * 0.2 + 1).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    ref = np.asarray(jfn.norm_silu(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), kind, interpret=True))
    y, mean, rstd = fn.norm_silu_fwd(_nc(x), torch.from_numpy(w),
                                     torch.from_numpy(b), kind)
    np.testing.assert_allclose(_cl(y), ref, rtol=2e-5, atol=2e-6)
    assert mean.shape == rstd.shape == (shape[0], C)


def test_norm_silu_plain_bf16_matches_jax_kernel():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    w = np.ones(16, np.float32)
    b = np.zeros(16, np.float32)
    ref = np.asarray(jfn.norm_silu(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b, jnp.bfloat16), "rms", interpret=True)
        .astype(jnp.float32))
    y = fn.norm_silu(_nc(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                     torch.from_numpy(b).bfloat16(), "rms")
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_cl(y), ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("groups,fuse_silu,affine", [
    (16, True, True),            # G == C, fused SiLU, affine: K2
    (4, True, True),             # G < C: the general path
    (16, False, True),           # no SiLU: the general path
    (16, True, False)])          # no affine: the general path
@pytest.mark.parametrize("cls", ["GroupLNorm", "GroupRMSNorm"])
def test_group_norm_modules_match_jax_plain_path(cls, groups, fuse_silu,
                                                 affine):
    """The port's norm modules (K2's plain version for G == C with SiLU
    and affine, the general path otherwise) against the JAX modules'
    plain path, which uses the shifted one-pass variance (inputs and
    bounds of tests/test_kernels.py's fused-vs-plain module test)."""
    rng = np.random.default_rng(groups)
    C = 16
    x = rng.standard_normal((2, 5, 6, C)).astype(np.float32)
    w = (rng.standard_normal(C) * 0.2 + 1).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    jmod = getattr(jlayers, cls)(groups, C, affine=affine,
                                 fuse_silu=fuse_silu)
    jvars = {"params": {"scale": w, "bias": b}} if affine else {}
    ref = np.asarray(jmod.apply(jvars, jnp.asarray(x)))
    mod = getattr(layers, cls)(groups, C, affine=affine, fuse_silu=fuse_silu)
    if affine:
        mod.load_state_dict({"weight": torch.from_numpy(w),
                             "bias": torch.from_numpy(b)})
    with torch.no_grad():
        y = mod(_nc(x))
    np.testing.assert_allclose(_cl(y), ref, rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# K4: flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,d", [(200, 16), (300, 32), (256, 32)])
def test_flash_attention_plain_matches_jax_kernel(T, d):
    rng = np.random.default_rng(T + d)
    q, k, v = (rng.standard_normal((1, 2, T, d)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), min_tokens=0,
        interpret=True))
    o, lse = fa.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(o.numpy(), ref, rtol=2e-4, atol=2e-5)
    s = np.einsum("bhid,bhjd->bhij", q, k) / np.sqrt(d)
    lse_ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=1e-5, atol=1e-5)


def test_flash_attention_shape_gate():
    """Below min_tokens the port takes plain attention, as the JAX package
    takes XLA there; both agree with the JAX function."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 2, 49, 32)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(out.numpy(),
                                  fa.dot_product_attention(tq, tk, tv).numpy())


# ---------------------------------------------------------------------------
# backward: K1's plain VJP, K3, K5/K6
# ---------------------------------------------------------------------------
def _jax_grads(fn, args, g):
    """jax.grad of sum(fn(*args) * g) in every argument."""
    def loss(*a):
        return jnp.sum(fn(*a) * g)
    return [np.asarray(r) for r in jax.grad(loss, argnums=tuple(
        range(len(args))))(*(jnp.asarray(a) for a in args))]


def _torch_grads(fn, args, g):
    leaves = [torch.from_numpy(np.asarray(a)).requires_grad_() for a in args]
    fn(*leaves).backward(g)
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("coeff", ["scalar", "one", "batch"])
def test_fused_axby_grads_match_jax(coeff):
    """FusedAxby's backward (the plain expression of the JAX package's
    custom VJP) in all four arguments, f32, rtol 1e-5."""
    rng = np.random.default_rng(5)
    B = 3
    x = rng.standard_normal((B, 6, 7, 1)).astype(np.float32) * 40
    f, g = (rng.standard_normal((B, 6, 7, 1)).astype(np.float32)
            for _ in range(2))
    a, b = {"scalar": (np.float32(0.7), np.float32(-1.3)),
            "one": (np.array([0.7], np.float32),
                    np.array([-1.3], np.float32)),
            "batch": (rng.random(B).astype(np.float32),
                      rng.standard_normal(B).astype(np.float32))}[coeff]
    ref = _jax_grads(lambda *t: jfp.fused_axby(*t, True), (x, f, a, b), g)
    got = _torch_grads(fp.fused_axby, (x, f, a, b), torch.from_numpy(g))
    for r, o, name in zip(ref, got, ("x", "f", "a", "b")):
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 7, 7, 16), (2, 4, 5, 4, 8)])
@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_norm_silu_backward_matches_jax_kernel(shape, kind):
    """NormSiLU's backward (K3's plain version here) against jax.grad
    through the JAX kernel's custom VJP, its Pallas kernels in interpret
    mode; channels-last at the JAX boundary. f32: dx, dw and db within
    1e-5 of their largest entry."""
    rng = np.random.default_rng(len(shape) + len(kind))
    C = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.3).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(C) * 0.2 + 1).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    ref = _jax_grads(lambda x, w, b: jfn.norm_silu(x, w, b, kind,
                                                   interpret=True),
                     (x, w, b), g)
    got = _torch_grads(lambda x, w, b: fn.norm_silu(x, w, b, kind),
                       (np.moveaxis(x, -1, 1).copy(), w, b), _nc(g))
    got[0] = np.moveaxis(got[0], 1, -1)
    for r, o, name in zip(ref, got, ("dx", "dw", "db")):
        np.testing.assert_allclose(o, r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("T", [2048, 2111])          # 2111: ragged
@pytest.mark.parametrize("d", [8, 16])
def test_flash_attention_backward_matches_jax_kernel(T, d):
    """FlashAttention's backward (the plain version of K5/K6 and delta
    here) against jax.grad through the JAX flash kernel's custom VJP in
    interpret mode. f32: dQ, dK, dV within 1e-5 of their largest entry."""
    rng = np.random.default_rng(T + d)
    q, k, v, g = (rng.standard_normal((1, 2, T, d)).astype(np.float32)
                  for _ in range(4))
    ref = _jax_grads(lambda q, k, v: jfa.flash_attention(q, k, v,
                                                         interpret=True),
                     (q, k, v), g)
    got = _torch_grads(fa.flash_attention, (q, k, v), torch.from_numpy(g))
    for r, o, name in zip(ref, got, ("dq", "dk", "dv")):
        np.testing.assert_allclose(o, r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_backward_plain_versions_match_autograd():
    """The plain backward functions, called on the forward's saved tensors,
    equal autograd through the plain forwards (f32, 1e-5), in f32 and with
    bf16 inputs (2e-2)."""
    gen = torch.Generator().manual_seed(0)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        x = (torch.randn(2, 4, 9, 10, generator=gen) * 2).to(dt)
        w = (torch.randn(4, generator=gen) * 0.2 + 1).to(dt)
        b = (torch.randn(4, generator=gen) * 0.1).to(dt)
        g = torch.randn(x.shape, generator=gen).to(dt)
        for kind in ("ln", "rms"):
            leaves = [t.detach().float().requires_grad_() for t in (x, w, b)]
            fn.norm_silu_plain(*leaves, kind)[0].backward(g.float())
            _, mean, rstd = fn.norm_silu_fwd(x, w, b, kind)
            got = fn.norm_silu_bwd_plain(g, x, mean, rstd, w, b, kind)
            for o, t in zip(got, leaves):
                assert o.dtype == dt
                torch.testing.assert_close(o.float(), t.grad, rtol=tol,
                                           atol=tol)
        q, k, v, do = (torch.randn(1, 2, 77, 16, generator=gen).to(dt)
                       for _ in range(4))
        leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
        fa.dot_product_attention(*leaves).backward(do.float())
        o, lse = fa.flash_attention_fwd(q, k, v)
        for got, t in zip(fa.flash_attention_bwd_plain(q, k, v, o, lse, do),
                          leaves):
            assert got.dtype == dt
            torch.testing.assert_close(got.float(), t.grad, rtol=tol,
                                       atol=tol)


def test_kernel_wrappers_stay_in_the_graph():
    """The wrappers go through their autograd.Functions (the forward
    kernel joined to its backward), so their outputs carry a grad_fn and
    gradients reach what lies upstream of them; on the card the same
    Functions launch the kernels."""
    x = torch.randn(2, 4, 6, 6, requires_grad=True)
    w = torch.ones(4, requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    y = fn.norm_silu(x * 2, w, b)
    assert type(y.grad_fn).__name__ == "NormSiLUBackward"
    q = torch.randn(1, 1, 2048, 8, requires_grad=True)
    o = fa.flash_attention(q * 1.0, q * 0.5, q * 2.0)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    c = torch.tensor([0.5, 2.0], requires_grad=True)
    z = fp.fused_axby(x, y, c, 3.0)
    assert type(z.grad_fn).__name__ == "FusedAxbyBackward"
    (z.sum() + o.sum()).backward()
    for t in (x, w, b, q, c):
        assert t.grad is not None and float(t.grad.abs().max()) > 0


def test_library_name_covers_the_shared_headers(tmp_path, monkeypatch):
    """A library is rebuilt when its source or a shared header of csrc/
    (``flash_common.cuh``) changes: both enter the hash in its name."""
    from diffsci_tpu_torch.kernels import _build
    assert (_build.CSRC_DIR / "flash_common.cuh").exists()
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// 1\n")
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (tmp_path / "h.cuh").write_text("// 2\n")
    second = _build.library_path("k")
    (tmp_path / "k.cu").write_text('#include "h.cuh"  \n')
    assert len({first, second, _build.library_path("k")}) == 3


@pytest.mark.parametrize("context", ["inference_mode", "no_grad"])
def test_kernel_wrappers_call_the_forward_without_autograd(context):
    """Where autograd records nothing (sampling) the wrappers give the
    forward's own output, bit for bit, with no grad_fn."""
    ctx = getattr(torch, context)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 6, 6, generator=gen)
    w, b = torch.rand(4, generator=gen) + 0.5, torch.randn(4, generator=gen)
    q, k, v = (torch.randn(1, 2, 2048, 8, generator=gen) for _ in range(3))
    c = torch.tensor([0.5, 2.0])
    with ctx():
        y = fn.norm_silu(x, w, b, "rms")
        o = fa.flash_attention(q, k, v)
        z = fp.fused_axby(x, y, c, 3.0)
    assert y.grad_fn is None and o.grad_fn is None and z.grad_fn is None
    torch.testing.assert_close(y, fn.norm_silu_fwd(x, w, b, "rms")[0],
                               rtol=0, atol=0)
    torch.testing.assert_close(o, fa.flash_attention_fwd(q, k, v)[0],
                               rtol=0, atol=0)
    torch.testing.assert_close(z, fp.fused_axby_fwd(x, y, c, 3.0), rtol=0,
                               atol=0)
