"""Where the bf16 tensor-core flash kernels round, rehearsed on the CPU.

The bf16 K4, K5 and K6 (``diffsci_tpu_torch/csrc/flash_attention.cu``,
``flash_attention_bwd.cu``) round the probabilities P (K4, K6) and dS (K5,
K6) to bf16 in registers before the tensor-core products, with f32
accumulation; K4 does so tile by tile against the running max of its
online softmax, with the key tile of the route that the launcher's shape
rule picks (``_key_tile``: 128 keys on the narrow ``wgmma`` route at head
dims 32, 64 and 128, 64 in the ``mma.sync`` kernel and on the wide
``wgmma`` route, 32 in the ``mma.sync`` wide kernel). ``_emulate_fwd`` and
``_emulate_bwd`` repeat that arithmetic in PyTorch. They are held against
the JAX package's flash attention (Pallas in interpret mode, and
``jax.grad`` through its custom VJP), which casts p and ds to the input
dtype at the same points (``diffsci_tpu/kernels/flash_attention.py:106,
179, 209, 211``), and against the port's plain versions within the bf16
tolerances that ``chip_smoke.py`` applies to the kernels on the card.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu.kernels import flash_attention as jfa

from diffsci_tpu_torch.kernels import flash_attention as fa
from tests import _torch_warmup  # noqa: F401  (MKL's first exp, CPU threads)

KEY_TILE = 64           # K4's key tile (kMmaKeys; the wide wgmma kernel's too)
NARROW_KEY_TILE = 128   # the narrow wgmma K4's (kNarrowKeys)
LOG2E = math.log2(math.e)


def _key_tile(d):
    """K4's key tile at head dim d in bf16 on 16-byte aligned bases, by
    the launcher's shape rule (``flash_fwd_launch`` in
    ``csrc/flash_attention.cu``; ``narrow_route`` and ``wgmma_route`` in
    ``csrc/flash_wgmma.cuh``): 128 on the narrow wgmma route (d 32, 64 and
    128), 64 in the mma.sync kernel (the other d ≤ 128) and in the wide
    wgmma kernel (d ≤ 512 with d % 8 == 0), 32 in the mma.sync wide
    kernel (``kWideKeys``) otherwise."""
    if d in (32, 64, 128):
        return NARROW_KEY_TILE
    if d <= 128:
        return KEY_TILE
    return KEY_TILE if d <= 512 and d % 8 == 0 else 32


def _emulate_fwd(q, k, v, key_tile=KEY_TILE):
    """K4 in bf16: online softmax over ``key_tile``-key tiles (by the
    route, ``_key_tile``) in the log2 domain, P rounded to bf16 before
    P·V, l summed over the f32 P; O in bf16 and the natural-log lse in
    f32."""
    T, d = q.shape[-2:]
    sl2 = LOG2E / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for k0 in range(0, T, key_tile):
        s = qf @ kf[..., k0:k0 + key_tile, :].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * sl2)
        p = torch.exp2(s * sl2 - (m_new * sl2)[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + (
            p.bfloat16().float() @ vf[..., k0:k0 + key_tile, :])
        m = m_new
    lse = (m * sl2 + torch.log2(l)) * math.log(2.0)
    return (acc / l[..., None]).bfloat16(), lse


def _emulate_bwd(q, k, v, o, lse, do):
    """delta = rowsum(dO∘O) in f32; K5: dQ = bf16(dS) K/√d; K6:
    dV = bf16(Pᵀ) dO and dK = bf16(dSᵀ) Q/√d, f32 sums; all in bf16."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1)
    p = torch.exp2((qf @ kf.transpose(-1, -2)) * scale * LOG2E
                   - (lse * LOG2E)[..., None])
    ds = (p * (dof @ vf.transpose(-1, -2) - delta[..., None])).bfloat16()
    dq = ds.float() @ kf * scale
    dk = ds.float().transpose(-1, -2) @ qf * scale
    dv = p.bfloat16().float().transpose(-1, -2) @ dof
    return tuple(t.bfloat16() for t in (dq, dk, dv))


def _dq_key_tile(d):
    """K5's key tile on a ``wgmma`` route at head dim d (bf16, 16-byte
    aligned bases): 128 on the narrow route (d 32 and 64,
    ``flash_dq_narrow_kernel``, ``kDqNarrowKeys``), 64 on the wide one
    (d above 128, ``flash_dq_wgmma_kernel`` and
    ``flash_dq_wgmma_pair_kernel``)."""
    return NARROW_KEY_TILE if d in (32, 64) else KEY_TILE


def _emulate_dq_tiles(q, k, v, lse, delta, do, key_tile=KEY_TILE):
    """K5 on a ``wgmma`` route, its key tile by ``_dq_key_tile``: 128 keys
    for the narrow ``flash_dq_narrow_kernel`` (d 32 and 64), 64 for the
    wide ``flash_dq_wgmma_kernel`` and ``flash_dq_wgmma_pair_kernel`` (d
    above 128). dQ summed in f32 over ``key_tile``-key tiles in key order,
    P = exp2(S·scale·log2 e − lse·log2 e) and dS = P∘(dP − delta) in f32
    per tile, dS rounded to bf16 before dS·K, the scale applied once at
    the end; dQ in bf16."""
    T, d = q.shape[-2:]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    l2 = (lse * LOG2E)[..., None]
    acc = torch.zeros(q.shape)
    for k0 in range(0, T, key_tile):
        kt, vt = kf[..., k0:k0 + key_tile, :], vf[..., k0:k0 + key_tile, :]
        p = torch.exp2((qf @ kt.transpose(-1, -2)) * (scale * LOG2E) - l2)
        ds = p * (dof @ vt.transpose(-1, -2) - delta[..., None])
        acc = acc + ds.bfloat16().float() @ kt
    return (acc * scale).bfloat16()


def _inputs(T, d):
    rng = np.random.default_rng(T * 100 + d)
    return [torch.from_numpy(rng.standard_normal((1, 2, T, d))
                             .astype(np.float32)).bfloat16()
            for _ in range(4)]


def _jax(q, k, v, do):
    """The JAX package's bf16 flash attention in interpret mode: O and the
    gradients of sum(O·dO) in q, k and v (its custom VJP)."""
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                       for t in (q, k, v, do))

    def fwd(q, k, v):
        return jfa.flash_attention(q, k, v, interpret=True)

    def loss(q, k, v):
        return jnp.sum(fwd(q, k, v).astype(jnp.float32)
                       * jdo.astype(jnp.float32))
    o = fwd(jq, jk, jv)
    grads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    return [torch.from_numpy(np.array(t.astype(jnp.float32)))
            for t in (o, *grads)]


def _rel(out, ref):
    """max |out - ref| / max |ref|."""
    return float((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


@pytest.mark.parametrize("T", [2048, 2049])
@pytest.mark.parametrize("d", [8, 32, 40])
def test_emulated_rounding_matches_jax_flash(T, d):
    """The emulation, with K4's key tile by the route (``_key_tile``: 128
    keys at d 32, the narrow wgmma route), against the JAX package's bf16
    flash kernels. Both round P and dS to bf16 before the products, but
    against other running maxima (the JAX kernel's key blocks are 1024 or
    128 keys, not 64 or 128) and
    from their own O and lse: O within 1 bf16 step (2^-8 of |O|) plus 2e-3
    of max|O|, lse within 1e-5; dQ, dK, dV within 1e-2 of their largest
    entry, the bound chip_smoke.py holds the bf16 backward kernels to.
    With dS rounded where the JAX dQ rounds it, the largest dQ gap over
    these cases is 3.6e-3 of max|dQ| (5.3e-3 with dS kept in f32), about
    one bf16 step of the largest entry."""
    q, k, v, do = _inputs(T, d)
    o, lse = _emulate_fwd(q, k, v, key_tile=_key_tile(d))
    grads = _emulate_bwd(q, k, v, o, lse, do)
    jo, *jgrads = _jax(q, k, v, do)
    diff = (o.float() - jo).abs()
    assert bool((diff <= 2 ** -8 * jo.abs() + 2e-3 * jo.abs().max()).all()), \
        float(diff.max())
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=0, atol=1e-5)
    for got, ref, name in zip(grads, jgrads, ("dq", "dk", "dv")):
        assert got.dtype == torch.bfloat16
        assert _rel(got, ref) <= 1e-2, (name, _rel(got, ref))


@pytest.mark.parametrize("T", [2048, 2049])
@pytest.mark.parametrize("d", [8, 32, 40, 64, 128])
def test_emulated_rounding_within_chip_tolerance_of_plain(T, d):
    """The emulation against the port's plain versions (f32 math, no bf16
    rounding inside) within chip_smoke.py's bf16 tolerances: O within
    2^-7·|ref| + 2e-3·max|ref|, lse within 1e-3; dQ, dK, dV within 1e-2 of
    their largest entry. This is what phase 1 asks of the kernels on the
    card."""
    q, k, v, do = _inputs(T, d)
    o, lse = _emulate_fwd(q, k, v, key_tile=_key_tile(d))
    ro, rlse = fa.flash_attention_plain(q, k, v)
    r = ro.float().abs()
    diff = (o.float() - ro.float()).abs()
    assert bool((diff <= 2 ** -7 * r + 2e-3 * r.max()).all()), \
        float(diff.max() / r.max())
    assert float((lse - rlse).abs().max()) <= 1e-3
    grads = _emulate_bwd(q, k, v, o, lse, do)
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for got, ref, name in zip(grads, refs, ("dq", "dk", "dv")):
        assert _rel(got, ref) <= 1e-2, (name, _rel(got, ref))



def _against_jax(T, d):
    """The emulation of K4 (its key tile by the route, ``_key_tile``) and
    of K5/K6 and the port's plain versions at (T, d) against the JAX
    package's bf16 flash kernels in interpret mode, for the head dims whose
    outputs put one-bf16-step differences just above a power of two: the
    emulation at ``test_emulated_rounding_matches_jax_flash``'s bounds,
    where an entry of O past 2^-8·|ref| + 2e-3·max|ref| must differ by no
    more than one bf16 step at its magnitude (2^-7 of the power of two
    below it, which 2^-8·|ref| undercounts) and lie in the lower half of
    its binade, where the two differ most; the plain versions, which the kernels are
    held to on the card, at ``test_emulated_rounding_within_chip_tolerance_
    of_plain``'s bounds (O within 2^-7·|ref| + 2e-3·max|ref|, lse within
    1e-3, dQ, dK, dV within 1e-2 of their largest entry)."""
    q, k, v, do = _inputs(T, d)
    jo, *jgrads = _jax(q, k, v, do)
    r = jo.abs()
    o, lse = _emulate_fwd(q, k, v, key_tile=_key_tile(d))
    diff = (o.float() - jo).abs()
    step = torch.exp2(torch.floor(torch.log2(r.clamp_min(1e-30))) - 7)
    past = diff > 2 ** -8 * r + 2e-3 * r.max()
    assert bool((diff[past] <= step[past]).all()), float(diff.max())
    assert bool((r[past] < 1.5 * 2 ** 7 * step[past]).all()), \
        r[past].tolist()
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=0, atol=1e-5)
    for got, ref, name in zip(_emulate_bwd(q, k, v, o, lse, do), jgrads,
                              ("dq", "dk", "dv")):
        assert _rel(got, ref) <= 1e-2, (name, _rel(got, ref))

    po, plse = fa.flash_attention_plain(q, k, v)
    diff = (po.float() - jo).abs()
    assert bool((diff <= 2 ** -7 * r + 2e-3 * r.max()).all()), \
        float(diff.max())
    assert float((plse - lse).abs().max()) <= 1e-3
    for got, ref, name in zip(fa.flash_attention_bwd_plain(
            q, k, v, po, plse, do), jgrads, ("dq", "dk", "dv")):
        assert got.dtype == torch.bfloat16
        assert _rel(got, ref) <= 1e-2, (name, _rel(got, ref))


@pytest.mark.parametrize("T", [2048, 2049])
@pytest.mark.parametrize("d", [64, 128])
def test_narrow_head_dims_against_jax_flash(T, d):
    """Head dims 64 (DiT-B's, configuration H) and 128 on the narrow wgmma
    K4 (128-key tiles; K6 at d 64 as well, whose roundings ``_emulate_bwd``
    repeats) against the JAX package's bf16 flash kernels, and the
    backward against ``jax.grad``, by ``_against_jax``. At d 64 and T 2048
    four of the 262,144 outputs lie just above 0.125 (at most 1.09 times
    it), where the two roundings differ by one step (2^-10) and
    2^-8·|O| + 2e-3·max|O| is 9.1e-4; every other entry keeps that
    bound."""
    _against_jax(T, d)


@pytest.mark.parametrize("d", [136, 256, 260, 320, 512])
def test_wide_head_dims_against_jax_flash(d):
    """Head dims above 128 (ADM's one 256-channel head; 512 at
    model_channels=128; 136 and 320, one pass and two chunks of the wgmma
    kernels; 260, rows that only the mma.sync wide kernels read), which
    K4-K6 take through their wide kernels (K4's key tile by the route,
    ``_key_tile``), by ``_against_jax`` at T 2048: these cases' million
    outputs (16 times d = 40's) put a few one-step differences of opposite
    roundings in the lower half of a binade."""
    _against_jax(2048, d)


@pytest.mark.parametrize("d", [32, 64, 256, 512])
def test_wgmma_dq_tiles_against_jax_flash(d):
    """The ``wgmma`` K5's dQ (key tiles in key order by the route,
    ``_dq_key_tile``: 128 keys at d 32 and 64, 64 above 128; dS rounded
    to bf16 a tile, f32 sums; ``_emulate_dq_tiles``) on the emulated
    forward's O and lse, against the JAX package's bf16 flash dQ in
    interpret mode within ``test_emulated_rounding_matches_jax_flash``'s
    bound: 1e-2 of the largest entry. At ragged T: the last tile holds
    one key."""
    q, k, v, do = _inputs(2049, d)
    jdq = _jax(q, k, v, do)[1]
    o, lse = _emulate_fwd(q, k, v, key_tile=_key_tile(d))
    delta = (do.float() * o.float()).sum(-1)
    dq = _emulate_dq_tiles(q, k, v, lse, delta, do, _dq_key_tile(d))
    assert dq.dtype == torch.bfloat16
    assert _rel(dq, jdq) <= 1e-2, _rel(dq, jdq)
