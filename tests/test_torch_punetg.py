"""The port's PUNetG against the JAX package's and the reference fixtures.

Weights come from a JAX init converted by ``diffsci_tpu_torch.convert.
from_jax_variables`` (or from the torch reference's state dicts in
``tests/fixtures/reference``), and inputs are made with numpy, so both
packages see the same numbers. On the CPU the port runs its kernels'
plain versions; the JAX package takes its XLA paths (its plain reference
for the flash kernel).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as jnn

from diffsci_tpu.models import PUNetG as JPUNetG
from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig

from diffsci_tpu_torch import PUNetG, PUNetGConfig
from diffsci_tpu_torch.convert import from_jax_variables
from tests import _torch_warmup  # noqa: F401  (MKL's first exp, CPU threads)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")

_SMALL = dict(model_channels=8, number_resnet_downward_block=1,
              number_resnet_upward_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1)


def _both(**fields):
    return JPUNetGConfig(**fields), PUNetGConfig(**fields)


def _check_against_jax(fields, x_shape, seed, conditional=False):
    jcfg, cfg = _both(**fields)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)   # channels-last
    t = np.array([0.5, -1.2][:x_shape[0]], np.float32)
    cond = (rng.standard_normal((x_shape[0], 3)).astype(np.float32)
            if conditional else None)
    mc = fields["model_channels"]
    jnet = JPUNetG(jcfg, conditional_embedding=jnn.Dense(mc)
                   if conditional else None)
    jcond = None if cond is None else jnp.asarray(cond)
    variables = jnet.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                          jnp.asarray(t), jcond)
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x), jnp.asarray(t),
                                jcond))
    net = PUNetG(cfg, conditional_embedding=torch.nn.Linear(3, mc)
                 if conditional else None, device="cpu")
    net.load_state_dict(from_jax_variables(jax.tree.map(np.asarray,
                                                        variables)),
                        strict=True)
    with torch.no_grad():
        y = net(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))),
                torch.from_numpy(t),
                None if cond is None else torch.from_numpy(cond))
    np.testing.assert_allclose(np.moveaxis(y.numpy(), 1, -1), ref,
                               rtol=5e-4, atol=5e-5)


def test_punetg_2d_matches_jax():
    """Two levels on 12x12 (6 -> 3: the odd-size pad/crop), a two-head
    bottleneck attention below the flash gate, and a Dense condition
    embedding."""
    _check_against_jax(dict(_SMALL, channel_expansion=(2, 2),
                            number_resnet_attn_block=2, num_heads=2),
                       (2, 12, 12, 1), seed=0, conditional=True)


def test_punetg_3d_flash_matches_jax():
    """3D, attn_backend='flash', 16^3 = 4096 bottleneck tokens: the flash
    path in both packages."""
    _check_against_jax(dict(_SMALL, model_channels=4, dimension=3,
                            channel_expansion=(2,),
                            number_resnet_attn_block=2, num_heads=2,
                            attn_backend="flash"),
                       (1, 32, 32, 32, 1), seed=1)


@pytest.mark.parametrize("name,attn_blocks", [("punetg_forward", 1),
                                              ("punetg_attn_forward", 2)])
def test_punetg_reference_fixture(name, attn_blocks):
    """The torch reference's state dict loads strictly and reproduces its
    output (bounds of tests/test_reference_parity.py)."""
    d = np.load(os.path.join(FIXDIR, f"{name}.npz"))
    sd = {k[4:]: torch.from_numpy(d[k]) for k in d.files
          if k.startswith("sd__")}
    net = PUNetG(PUNetGConfig(**_SMALL, channel_expansion=(2,),
                              number_resnet_attn_block=attn_blocks),
                 device="cpu")
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        y = net(torch.from_numpy(d["x"]), torch.from_numpy(d["t"]))
    np.testing.assert_allclose(y.numpy(), d["y"], rtol=5e-4, atol=5e-5)


def test_unported_options_raise():
    """Every option of the JAX package's PUNetG is ported
    (``tests/test_torch_conditional.py`` and ``tests/test_torch_mp.py``
    hold them against it); what neither package accepts raises: an
    unknown convolution type, a spatial size that space_to_depth cannot
    fold, and a spatially-varying condition at another resolution than
    the folded x."""
    with pytest.raises(ValueError):
        PUNetG(PUNetGConfig(**_SMALL, convolution_type="bogus"),
               device="cpu")
    net = PUNetG(PUNetGConfig(**_SMALL, channel_expansion=(2,),
                              space_to_depth=2), device="cpu")
    with pytest.raises(ValueError):
        net(torch.zeros(1, 1, 15, 16), torch.zeros(1))
    with pytest.raises(ValueError):
        net(torch.zeros(1, 1, 16, 16), torch.zeros(1),
            torch.zeros(1, 8, 16, 16))
