"""The port's HFNet family (``UNet2D``, ``HFNetUncond``, ``HFNetCond``, the
MLPs) against the JAX package on the same weights.

JAX variables are carried across by ``diffsci_tpu_torch.convert`` and
inputs are made with numpy, so both packages see the same numbers. The
diffusers state-dict names are pinned by loading the state dict of
``tests/_torch_unet2d.TorchUNet2D`` (a rendering of the published
``UNet2DModel`` with diffusers' names) into the port's UNet2D. Forward
tolerance: the JAX package's own (``tests/test_ddpm_unet.py``, rtol 2e-4,
atol 2e-5).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu.kernels import flash_attention as jfa
from diffsci_tpu.models.nets import ddpm_unet as jdu
from diffsci_tpu.models.nets import hfnet as jhf
from diffsci_tpu.models.nets import mlp as jmlp

from diffsci_tpu_torch import HFNetCond, HFNetUncond, UNet2D
from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.kernels import flash_attention as fa
from diffsci_tpu_torch.models.nets import MLPCond, MLPUncond, ddpm_unet
from diffsci_tpu_torch.models.nets.layers import init_parameters
from tests import _torch_warmup  # noqa: F401  (MKL's first exp, CPU threads)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")
TOL = dict(rtol=2e-4, atol=2e-5)


def _nc(a):
    """channels-last numpy -> NC* torch"""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _port_weights(jnet, *args):
    variables = jnet.init(jax.random.PRNGKey(0), *(jnp.asarray(a)
                                                     for a in args))
    return variables, from_jax_variables(jax.tree.map(np.asarray, variables))


@pytest.mark.parametrize("dim,flip,shift", [(16, True, 0.0), (16, False, 1.0),
                                            (17, True, 0.0), (9, False, 0.0)])
def test_timestep_embedding_matches_jax(dim, flip, shift):
    t = np.array([0.0, 1.0, 3.0, 250.0, 999.0, 1000.0], np.float32)
    ref = np.asarray(jdu.timestep_embedding(jnp.asarray(t), dim, flip, shift))
    out = ddpm_unet.timestep_embedding(torch.from_numpy(t), dim, flip, shift)
    assert out.shape == ref.shape == (6, dim)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


_UNET = dict(block_out_channels=(8, 16), in_channels=3, out_channels=2,
             norm_num_groups=4)


@pytest.mark.parametrize("case", ["2d", "2d_attn", "3d_attn"])
def test_unet2d_matches_jax(case):
    attn = case != "2d"
    flags = dict(attn_down=(False, attn), attn_up=(attn, False))
    shape = (2, 8, 8, 8, 3) if case == "3d_attn" else (2, 16, 16, 3)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    t = np.array([3.0, 250.0], np.float32)
    jnet = jdu.UNet2D(**_UNET, **flags)
    variables, state = _port_weights(jnet, x, t)
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x), jnp.asarray(t)))
    net = UNet2D(**_UNET, **flags, dimension=len(shape) - 2, device="cpu")
    # the converted names cover the port's tree exactly
    assert sorted(state) == sorted(net.state_dict())
    net.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = net(_nc(x), torch.from_numpy(t))
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1), ref, **TOL)


def test_unet2d_loads_a_diffusers_state_dict():
    """diffusers' UNet2DModel names (the rendering in tests/_torch_unet2d)
    load strictly, and the two networks agree on the same input."""
    from tests._torch_unet2d import TorchUNet2D

    torch.manual_seed(0)
    flags = dict(attn_down=(False, True), attn_up=(True, False))
    ref_net = TorchUNet2D(**_UNET, **flags).eval()
    net = UNet2D(**_UNET, **flags, device="cpu").eval()
    net.load_state_dict(ref_net.state_dict(), strict=True)
    x = torch.randn(2, 3, 16, 16)
    t = torch.tensor([3.0, 250.0])
    with torch.no_grad():
        torch.testing.assert_close(net(x, t), ref_net(x, t), rtol=1e-5,
                                   atol=1e-6)


def test_unet2d_flash_backend_matches_xla(monkeypatch):
    """'flash' goes through K4's wrapper (FlashAttention, its plain version
    here) once the gate is lowered, and agrees with 'xla' on one set of
    weights, as the JAX package's test of its two backends."""
    monkeypatch.setattr(fa, "MIN_TOKENS", 1)
    flags = dict(attn_down=(False, True), attn_up=(True, False))
    nets = {b: UNet2D(**_UNET, **flags, backend=b, device="cpu")
            for b in ("xla", "flash")}
    nets["flash"].load_state_dict(nets["xla"].state_dict())
    x = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([1.0, 7.0])
    outs = {b: net(x, t) for b, net in nets.items()}
    assert outs["flash"].grad_fn is not None
    torch.testing.assert_close(outs["flash"], outs["xla"], **TOL)


@pytest.mark.parametrize("cond", [False, True])
def test_hfnet_matches_jax(cond):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    y = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    t = np.array([10.0, 900.0], np.float32)
    kw = dict(block_channels=(8, 16, 16), channels=3, norm_num_groups=4,
              attn_up_and_down=True)
    if cond:
        jnet, net = (jhf.HFNetCond(cond_channels=2, **kw),
                     HFNetCond(cond_channels=2, **kw, device="cpu"))
    else:
        jnet, net = jhf.HFNetUncond(**kw), HFNetUncond(**kw, device="cpu")
    args = (x, t, y) if cond else (x, t)
    variables, state = _port_weights(jnet, *args)
    assert all(k.startswith("unet.") for k in state)
    net.load_state_dict(state, strict=True)
    ref = np.asarray(jnet.apply(variables, *(jnp.asarray(a) for a in args)))
    with torch.no_grad():
        out = net(_nc(x), torch.from_numpy(t), _nc(y) if cond else None)
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1), ref, **TOL)
    if cond:
        with pytest.raises(ValueError, match="requires"):
            net(_nc(x), torch.from_numpy(t))


def test_mlps_match_jax_and_reference_fixture():
    """MLPUncond / MLPCond: the reference's ``net.{i}`` state dicts load
    directly and give the fixture's outputs (rtol 2e-4, atol 1e-6, the
    JAX package's bound); JAX variables convert to the same names."""
    d = np.load(os.path.join(FIXDIR, "mlp_forward.npz"))
    x, t, y = (torch.from_numpy(d[k]) for k in ("x", "t", "ycond"))
    for prefix, net, args, key in (
            ("usd__", MLPUncond(3, hidden_dims=(8, 8), device="cpu"),
             (x, t), "out_uncond"),
            ("csd__", MLPCond(3, 2, hidden_dims=(8, 8), device="cpu"),
             (x, t, y), "out_cond")):
        net.load_state_dict({k[5:]: torch.from_numpy(d[k]) for k in d.files
                             if k.startswith(prefix)}, strict=True)
        with torch.no_grad():
            np.testing.assert_allclose(net(*args).numpy(), d[key], rtol=2e-4,
                                       atol=1e-6)
    jnet = jmlp.MLPCond(3, 2, hidden_dims=(8, 8))
    variables, state = _port_weights(jnet, d["x"], d["t"], d["ycond"])
    net = MLPCond(3, 2, hidden_dims=(8, 8), device="cpu")
    net.load_state_dict(state, strict=True)
    ref = jnet.apply(variables, *(jnp.asarray(d[k])
                                  for k in ("x", "t", "ycond")))
    with torch.no_grad():
        np.testing.assert_allclose(net(x, t, y).numpy(), np.asarray(ref),
                                   **TOL)


def test_init_parameters_handles_torch_norms():
    """init_parameters gives torch's GroupNorm and LayerNorm ones and zeros
    (their reset_parameters() takes no generator, which raised before),
    and one seed gives one set of weights."""
    net = torch.nn.Sequential(torch.nn.GroupNorm(2, 4),
                              torch.nn.LayerNorm(4), torch.nn.Linear(4, 4),
                              torch.nn.GroupNorm(1, 4, affine=False))
    for p in net.parameters():
        torch.nn.init.normal_(p)
    init_parameters(net, seed=0)
    for i in (0, 1):
        assert torch.equal(net[i].weight, torch.ones(4))
        assert torch.equal(net[i].bias, torch.zeros(4))
    unet = UNet2D(**_UNET, device="cpu")
    init_parameters(unet, seed=3)
    again = UNet2D(**_UNET, device="cpu")
    init_parameters(again, seed=3)
    for (name, a), b in zip(unet.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(unet.conv_norm_out.weight, torch.ones(8))


def test_config_c_size_and_entry_points_need_cuda(monkeypatch):
    """Configuration C (the DDPM CIFAR-10 widths in HFNet's attention
    pattern) has the JAX model's 38,383,107 parameters; without a device
    the networks ask for CUDA."""
    net = HFNetUncond((128, 256, 256, 256), channels=3, attn_up_and_down=True,
                      device="meta")
    assert sum(p.numel() for p in net.parameters()) == 38_383_107
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: UNet2D(**_UNET), lambda: HFNetUncond((8, 16)),
                  lambda: MLPUncond(3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_jax_flash_backend_unchanged_by_port():
    """The JAX package's flash gate (2048 tokens) is the port's."""
    assert fa.MIN_TOKENS == jfa.DEFAULT_MIN_TOKENS
