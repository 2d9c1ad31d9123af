"""The port's pytorch-fid InceptionV3 (``diffsci_tpu_torch/
metrics_inception.py``) against the JAX package's
``diffsci_tpu/metrics_inception.py``.

The real ``pt_inception-2015-12-05`` weights are not in the repository,
so both nets carry synthetic weights: the port's ``init(0)`` with every
BatchNorm's scale, bias and running statistics randomized (so that the
BN mapping is exercised), carried to JAX by the JAX package's own
``convert_torch_inception_state`` and back by ``from_jax_variables``.
The JAX net is built once (a module-scoped fixture, no flax ``init``) and
run only at 75 x 75, its smallest input: each block's output is read from
one jitted forward (``capture_intermediates``) and held against the
port's block on the JAX block's input, at the blocks' real channel
widths; InceptionE's two pools also at 5 x 5. The resize is held against
``jax.image.resize(antialias=False)`` in both directions (28 -> 299 and
512 -> 299); ``inception_fid_features`` against that resize and the
port's net.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsci_tpu import metrics_inception as jmi

from diffsci_tpu_torch import metrics_inception as mi
from diffsci_tpu_torch.convert import from_jax_variables
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

BLOCKS = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
          "Conv2d_3b_1x1", "Conv2d_4a_3x3", "Mixed_5b", "Mixed_5c",
          "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
          "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c")


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _close(ours, ref, rtol=1e-4, atol_scale=1e-5, label=""):
    """rtol 1e-4 against each entry, atol 1e-5 of the reference's scale
    (f32 convolutions summed in another order)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol_scale * max(
        1e-30, float(np.abs(ref).max())), err_msg=label)


@pytest.fixture(scope="module")
def nets():
    """The port's net with synthetic weights, its state dict as numpy, the
    JAX variables converted from it, and one jitted JAX forward at 75 x 75
    (batch 2) with every block's output captured."""
    net = mi.InceptionV3FID(device="cpu").init(0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1 + 0.2 * torch.randn(n, generator=g))
                m.bias.copy_(0.2 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.2 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
    sd = {k: v.numpy() for k, v in net.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    variables = jmi.convert_torch_inception_state(sd)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 75, 75, 3)).astype(
        np.float32)
    out, state = jax.jit(lambda v, xx: jmi.InceptionV3FID().apply(
        v, xx, capture_intermediates=True))(variables, jnp.asarray(x))
    inter = {k: np.asarray(v["__call__"][0])
             for k, v in state["intermediates"].items() if k in BLOCKS}
    return net, sd, variables, x, np.asarray(out), inter


def test_architecture_names_and_size(nets):
    """pytorch-fid's module names (the JAX converter reads them) and its
    feature extractor's size: ~21.8M parameters (the JAX package's test
    bound), 2048 features."""
    net = nets[0]
    n = sum(p.numel() for p in net.parameters())
    assert 21_000_000 < n < 22_500_000, n
    names = {k.split(".")[0] for k in net.state_dict()}
    assert names == set(BLOCKS)
    assert net.Mixed_7c.branch_pool.conv.weight.shape == (192, 2048, 1, 1)


def test_whole_net_matches_jax_both_ways(nets):
    """The whole net at 75 x 75, batch 2: the port's output equals the JAX
    net's on the converted weights; the JAX variables carried back by
    ``from_jax_variables`` are the port's state dict exactly, and a fresh
    port net loaded from them gives the same output."""
    net, sd, variables, x, ref, _ = nets
    with torch.no_grad():
        ours = net(_nchw(x)).numpy()
    assert ours.shape == (2, 2048)
    _close(ours, ref, label="InceptionV3FID 75x75")
    back = from_jax_variables(jax.tree.map(np.asarray, variables))
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    fresh = mi.InceptionV3FID(device="cpu")
    fresh.load_state_dict(back, strict=True)    # without num_batches_tracked
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(_nchw(x)).numpy(), ours)


@pytest.mark.parametrize("i", range(1, len(BLOCKS)))
def test_block_matches_jax(nets, i):
    """Each stage after the first (BasicConv2d stems; InceptionA at 7 x 7;
    B 7 -> 3; C at 3 x 3; D 3 -> 1; E at 1 x 1), run on the JAX stage's
    own input, at its real channel widths: the JAX stage's output. The
    stem max pools sit between Conv2d_2b and Conv2d_3b and between
    Conv2d_4a and Mixed_5b."""
    net, _, _, _, _, inter = nets
    prev = inter[BLOCKS[i - 1]]
    x = _nchw(prev)
    if BLOCKS[i] in ("Conv2d_3b_1x1", "Mixed_5b"):
        x = mi._max_pool(x)
    with torch.no_grad():
        ours = _nhwc(getattr(net, BLOCKS[i])(x))
    _close(ours, inter[BLOCKS[i]], label=BLOCKS[i])


def test_first_block_and_basic_conv_match_jax(nets):
    """Conv2d_1a_3x3 on the input; and a lone BasicConv2d (1 x 7, stride
    (2, 1), padding (0, 3)) carried by the JAX converter."""
    net, _, variables, x, _, inter = nets
    with torch.no_grad():
        ours = _nhwc(net.Conv2d_1a_3x3(_nchw(x)))
    _close(ours, inter["Conv2d_1a_3x3"], label="Conv2d_1a_3x3")

    conv = mi.BasicConv2d(5, 7, (1, 7), stride=(2, 1), padding=(0, 3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        conv.bn.running_mean.copy_(torch.randn(7, generator=g) * 0.2)
        conv.bn.running_var.copy_(torch.rand(7, generator=g) + 0.5)
    conv.eval()
    sd = {f"blk.{k}": v.numpy() for k, v in conv.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    jv = jmi.convert_torch_inception_state(sd)
    xb = np.random.default_rng(5).standard_normal((2, 9, 11, 5)).astype(
        np.float32)

    class Wrap(jmi.nn.Module):
        @jmi.nn.compact
        def __call__(self, xx):
            return jmi.BasicConv2d(7, (1, 7), strides=(2, 1),
                                   padding=(0, 3), name="blk")(xx)

    ref = Wrap().apply(jv, jnp.asarray(xb))
    with torch.no_grad():
        ours = _nhwc(conv(_nchw(xb)))
    _close(ours, ref, label="BasicConv2d")


@pytest.mark.parametrize("name,pool,cin", [("Mixed_7b", "avg", 1280),
                                           ("Mixed_7c", "max", 2048)])
def test_inception_e_pools_match_jax(nets, name, pool, cin):
    """InceptionE's average pool (padding not counted) and max pool (over
    -inf padding) at 5 x 5, where the borders matter, with the whole
    net's weights of that block."""
    net, _, variables, _, _, _ = nets
    sub = {"params": variables["params"][name],
           "batch_stats": variables["batch_stats"][name]}
    x = np.random.default_rng(6).standard_normal((2, 5, 5, cin)).astype(
        np.float32) - 0.5
    ref = jax.jit(jmi.InceptionE(pool=pool).apply)(sub, jnp.asarray(x))
    block = getattr(net, name)
    assert block.pool == pool
    with torch.no_grad():
        ours = _nhwc(block(_nchw(x)))
    _close(ours, ref, label=name)


def test_avg_pool_does_not_count_padding():
    x = torch.ones(1, 1, 3, 3)
    torch.testing.assert_close(mi._avg_pool_nip(x), x)
    ref = jmi._avg_pool_nip(jnp.arange(25.0).reshape(1, 5, 5, 1), (3, 3),
                            (1, 1), (1, 1))
    ours = mi._avg_pool_nip(torch.arange(25.0).reshape(1, 1, 5, 5))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("size", [28, 75, 512])
def test_resize_matches_jax(size):
    """The 299 x 299 bilinear resize without antialiasing, up (28, 75) and
    down (512): ``F.interpolate(align_corners=False, antialias=False)``
    equals ``jax.image.resize(..., antialias=False)`` within 1e-5."""
    x = np.random.default_rng(size).uniform(size=(1, size, size, 3)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1, 299, 299, 3), "bilinear",
                           antialias=False)
    ours = torch.nn.functional.interpolate(
        _nchw(x), size=(299, 299), mode="bilinear", align_corners=False,
        antialias=False)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_inception_fid_features_pipeline(nets):
    """``inception_fid_features`` on 3 grayscale 28 x 28 images at batch
    2: the channel repeated to RGB, the JAX package's resize, x·2 - 1 and
    the port's net, as float32 numpy [3, 2048]."""
    net = nets[0]
    x = np.random.default_rng(7).uniform(size=(3, 28, 28, 1)).astype(
        np.float32)
    feats = mi.inception_fid_features(net, x, batch_size=2)
    assert feats.shape == (3, 2048) and feats.dtype == np.float32
    assert np.isfinite(feats).all()
    rgb = np.repeat(x, 3, axis=-1)
    big = np.asarray(jax.image.resize(jnp.asarray(rgb), (3, 299, 299, 3),
                                      "bilinear", antialias=False))
    with torch.no_grad():
        ref = net(_nchw(big) * 2.0 - 1.0).numpy()
    _close(feats, ref, label="features")


def test_init_and_load_weights(nets, tmp_path):
    """``init(seed)``: the same seed gives the same weights (a copy of the
    module's net, made by ``init(0)``, drawn again from seed 0); kernels
    are lecun-normal (std √(1/fan_in) within 5 %, none beyond two of the
    untruncated normal's), BatchNorm 1/0/0/1. ``load_weights`` reads a
    pytorch-fid-style file with its ``fc`` head and loads the rest
    strictly."""
    net = nets[0]
    a = copy.deepcopy(net).init(0)
    for (k, v), ref in zip(a.named_parameters(), net.parameters()):
        if k.endswith("conv.weight"):
            assert torch.equal(v, ref), k
    w = a.Mixed_6b.branch7x7_2.conv.weight.detach()
    fan_in = w[0].numel()
    std = w.std().item() * fan_in ** 0.5
    assert abs(std - 1.0) < 0.05, std
    assert float(w.abs().max()) * fan_in ** 0.5 <= 2.0 / .8796 + 1e-4
    bn = a.Mixed_6b.branch7x7_2.bn
    assert bool((bn.weight == 1).all() and (bn.bias == 0).all())
    assert bool((bn.running_mean == 0).all() and (bn.running_var == 1).all())

    sd = dict(net.state_dict(), **{"fc.weight": torch.zeros(1008, 2048),
                                   "fc.bias": torch.zeros(1008)})
    path = tmp_path / "pt_inception.pth"
    torch.save(sd, path)
    loaded = mi.load_weights(str(path), device="cpu")
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert not loaded.training
