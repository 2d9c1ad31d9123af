"""The port's kernels (``diffsci_tpu_torch/kernels``) against the JAX
package.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold the plain versions against the JAX functions on the same numpy inputs,
with the Pallas kernels in interpret mode as ``tests/test_kernels.py`` runs
them. ``test_kernel_matches_plain_on_card`` holds each CUDA kernel against
its plain version and needs an NVIDIA card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffsci_tpu.kernels import flash_attention as jfa
from diffsci_tpu.kernels import fused_norm as jfn
from diffsci_tpu.kernels import fused_precondition as jfp
from diffsci_tpu.models.nets import layers as jlayers

from diffsci_tpu_torch.kernels import flash_attention as fa
from diffsci_tpu_torch.kernels import fused_norm as fn
from diffsci_tpu_torch.kernels import fused_precondition as fp
from diffsci_tpu_torch.models.nets import layers


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
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA only")
    from diffsci_tpu_torch import kernels
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
    x = randn(2, 8, 9, 10, 11)
    w, b = randn(8), randn(8)
    for kind in ("ln", "rms"):
        for got, ref in zip(fn.norm_silu_fwd(x, w, b, kind),
                            fn.norm_silu_plain(x, w, b, kind)):
            torch.testing.assert_close(got.float(), ref.float(), **tol)
    q, k, v = randn(1, 2, 333, 40), randn(1, 2, 333, 40), randn(1, 2, 333, 40)
    for got, ref in zip(fa.flash_attention_fwd(q, k, v),
                        fa.flash_attention_plain(q, k, v)):
        torch.testing.assert_close(got.float(), ref.float(), **tol)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"fused_axby": 1, "norm_silu": 2,
                                "flash_attention": 1}
