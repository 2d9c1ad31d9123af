"""The port's extras (``diffsci_tpu_torch/extra/``, ``utils/periodic.py``)
against the reference fixtures and the JAX package.

- the fixtures, at the JAX tests' bounds for the same files:
  ``periodic_golden.npz`` (exact, ``tests/test_reference_parity12.py``),
  ``periodizer.npz`` (rtol 1e-5 / atol 1e-6, ``test_reference_parity8.py``),
  ``porosity_map.npz`` and ``grid_volume.npz`` / ``sequential_volume.npz``
  through port copies of the fixture's stubs (``test_reference_parity10.py``);
- live against JAX on the same numpy inputs: the grid order and masks,
  the porosity conditions, ``decoder_halo_radius`` / ``upscale_factor``,
  ``tiled_decode`` on a small local decoder, ``convert_conv_params_to_
  circular`` on a small PUNetG (the circular models' outputs), and a tiny
  real ``SIModel`` (a 3D PUNetG of 8 channels) through
  ``sample_grid_volume``: the corner cube (deterministic Heun) against the
  JAX model's sample of the same slice of the same noise cube;
- port-only: every inpainted cube's and block's known region is exact,
  and every validation error.

The JAX side's networks are initialised once per module.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from diffsci_tpu import extra as jextra
from diffsci_tpu.extra import converters as jconverters
from diffsci_tpu.extra import fillinginpainting as jfill
from diffsci_tpu.models import PUNetG as JPUNetG
from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig
from diffsci_tpu.models.nets.vae import DDConfig as JDDConfig
from diffsci_tpu.models.si import SIModel as JSIModel
from diffsci_tpu.models.si import SIModelConfig as JSIModelConfig
from diffsci_tpu.utils import periodic as jperiodic

from diffsci_tpu_torch import (DDConfig, PUNetG, PUNetGConfig, SIModel,
                               SIModelConfig, extra)
from diffsci_tpu_torch.convert import from_jax_variables
from diffsci_tpu_torch.extra import converters, fillinginpainting, porosity_map
from diffsci_tpu_torch.extra import sequentialinpainting
from diffsci_tpu_torch.utils import periodic
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "reference")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This module's work is thousands of small torch operations (tiny networks' calls);
    beside pytest-xdist's other workers their intra-op threads contend (a
    test of 0.3 s alone took 80 s), so the module runs on one thread,
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _check(ours, ref, rtol, atol, label=""):
    np.testing.assert_allclose(np.asarray(ours, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol, err_msg=label)


def _vol_nchw(a):
    """torch [1, C, X, Y, Z] -> channels-last [1, X, Y, Z, C]."""
    return np.asarray(a).transpose(0, 2, 3, 4, 1)


# ---------------------------------------------------------------------------
# periodic slicing (periodic_golden.npz, exact)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def per_gold():
    return np.load(os.path.join(FIXDIR, "periodic_golden.npz"))


EXTENDED = {
    "ext_1d_a": ("a1", (slice(-2, 7),)),
    "ext_1d_b": ("a1", (slice(0, 10),)),
    "ext_1d_c": ("a1", (slice(4, 6),)),
    "ext_2d_a": ("a2", (slice(-3, 9), slice(None))),
    "ext_2d_b": ("a2", (slice(1, 9), slice(-2, 12))),
    "ext_3d_a": ("a3", (slice(None), slice(-4, 9), slice(2, 11))),
}
WRAPPED = {
    "get_1d_wrap": (slice(4, 2),),
    "get_2d_wrap": (slice(3, 1), slice(5, 2)),
    "get_2d_neg": (slice(-2, 1), slice(None)),
}


@pytest.mark.parametrize("name", sorted(EXTENDED))
def test_periodic_getitem_extended_fixture(per_gold, name):
    src, idx = EXTENDED[name]
    out = periodic.periodic_getitem_extended(_t(per_gold[src]), *idx)
    _check(out, per_gold[name], 0, 0, name)


@pytest.mark.parametrize("name", sorted(WRAPPED))
def test_periodic_getitem_wrap_fixture(per_gold, name):
    out = periodic.periodic_getitem(_t(per_gold["a2"]), *WRAPPED[name])
    _check(out, per_gold[name], 0, 0, name)


def test_periodic_setitem_fixture(per_gold):
    a2 = _t(per_gold["a2"])
    out = periodic.periodic_setitem(a2, _t(per_gold["set_2d_value"]),
                                    slice(4, 2), slice(5, 2))
    _check(out, per_gold["set_2d_out"], 0, 0, "periodic_setitem wrap")
    assert not torch.equal(out, a2)     # functional: the input is unchanged
    _check(a2, per_gold["a2"], 0, 0)


def test_periodic_errors_match_jax():
    """A step and a slice longer than the axis raise as in the JAX
    package; a wrapped window written back reads back the same."""
    x = torch.arange(10.0)
    for fn, jfn in ((periodic.periodic_getitem, jperiodic.periodic_getitem),
                    (periodic.periodic_getitem_extended,
                     jperiodic.periodic_getitem_extended)):
        with pytest.raises(NotImplementedError):
            fn(x, slice(0, 4, 2))
        with pytest.raises(NotImplementedError):
            jfn(jnp.arange(10.0), slice(0, 4, 2))
        with pytest.raises(TypeError):
            fn(x, 3)
    with pytest.raises(ValueError):
        periodic.periodic_getitem(x, slice(-2, 11))
    with pytest.raises(ValueError):
        jperiodic.periodic_getitem(jnp.arange(10.0), slice(-2, 11))
    with pytest.raises(TypeError):
        periodic.periodic_setitem(x, 0.0, 3)
    y = periodic.periodic_setitem(x, torch.full((4,), -1.0), slice(8, 2))
    ref = jperiodic.periodic_setitem(jnp.arange(10.0), jnp.full((4,), -1.0),
                                     slice(8, 2))
    _check(y, ref, 0, 0)
    _check(periodic.periodic_getitem(y, slice(8, 2)), -np.ones(4), 0, 0)


# ---------------------------------------------------------------------------
# the periodizer (periodizer.npz)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dim,tag", [(2, "p2"), (3, "p3")])
def test_periodizer_fixture(dim, tag):
    """Expand-crop-blend around the fixture's conv net in all three forward
    variants (rtol 1e-5, atol 1e-6) and the blended output's periodicity
    error (rtol 1e-4), as ``test_reference_parity8.py`` holds the JAX
    package."""
    d = np.load(os.path.join(FIXDIR, "periodizer.npz"))
    x = _t(d[f"{tag}_x"]).movedim(1, -1)
    w, b = _t(d[f"{tag}_conv_w"]), _t(d[f"{tag}_conv_b"])
    conv = (F.conv2d, F.conv3d)[dim - 2]

    def net_fn(xx, t=None):
        y = conv(xx.movedim(-1, 1), w, b, padding=1).movedim(1, -1)
        return y + 0.1 * torch.tanh(xx)

    per = extra.DiffusionPeriodizer(net_fn, pad=4 if dim == 2 else 2,
                                    blend_width=3, dimension=dim)
    for out, key in ((per(x), "blend"), (per.forward_no_blend(x), "noblend"),
                     (per.forward_expand_only(x), "expand")):
        _check(out, _t(d[f"{tag}_{key}"]).movedim(1, -1), 1e-5, 1e-6,
               f"periodizer {key} {dim}D")
    err = extra.measure_periodicity_error(per(x), dimension=dim)
    np.testing.assert_allclose(err["total_mse"], d[f"{tag}_err_max"],
                               rtol=1e-4, atol=1e-9)


def test_periodizer_matches_jax_and_wrapper_cadence():
    """The three variants and the periodicity error against the JAX
    periodizer around the same function (rtol 1e-6), and
    ``PeriodicSamplerWrapper`` applying it every second step."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 10, 2)).astype(np.float32)

    def jfn(xx, t=None):
        return jnp.tanh(xx) * 2.0 + jnp.roll(xx, 1, axis=1)

    def fn(xx, t=None):
        return torch.tanh(xx) * 2.0 + torch.roll(xx, 1, dims=1)

    kw = dict(pad=(3, 2), blend_width=(4, 2), dimension=2)
    jper = jextra.DiffusionPeriodizer(jfn, **kw)
    per = extra.DiffusionPeriodizer(fn, **kw)
    for m in ("__call__", "forward_no_blend", "forward_expand_only"):
        _check(getattr(per, m)(_t(x)), getattr(jper, m)(jnp.asarray(x)),
               1e-6, 1e-6, m)
    e = extra.measure_periodicity_error(per(_t(x)), dimension=2)
    je = jextra.measure_periodicity_error(jper(jnp.asarray(x)), dimension=2)
    assert set(e) == set(je)
    for k in ("mse_H", "mse_W", "max_diff_H", "max_diff_W", "total_mse"):
        np.testing.assert_allclose(e[k], je[k], rtol=1e-6, atol=1e-9)

    wrapper = extra.PeriodicSamplerWrapper(lambda xx, t: xx, per, 2)
    xt = _t(x)
    assert torch.equal(wrapper.step(xt, 0.5), xt)
    assert torch.equal(wrapper.step(xt, 0.5), per(xt, 0.5))
    wrapper.reset()
    assert torch.equal(wrapper.step(xt, 0.5), xt)


# ---------------------------------------------------------------------------
# porosity maps (porosity_map.npz)
# ---------------------------------------------------------------------------
def test_porosity_map_fixture():
    """The Matern covariance, its Cholesky factor, a sample with replayed
    z, both interpolations, the vertical map and the grid centres at
    ``test_reference_parity10.py``'s bounds."""
    d = np.load(os.path.join(FIXDIR, "porosity_map.npz"))
    gp = porosity_map.MaternFieldSampler(d["X"], mean_val=0.4, params={
        "sigma_sq": 1.3, "nu": 1.5, "length_scale": 0.8})
    _check(gp._build_covariance_matrix(), d["K"], 1e-10, 1e-12, "K")
    _check(gp.L, d["L"], 1e-8, 1e-10, "L")
    _check((0.4 + gp.L @ d["z"]).T, d["samples"], 1e-8, 1e-10, "samples")
    arr = [0.1, 0.5, 0.2, 0.9]
    _check(porosity_map.interpolate_array(arr, method="linear"),
           d["interp_linear"], 1e-8, 1e-10, "linear")
    _check(porosity_map.interpolate_array(arr, method="spline"),
           d["interp_spline"], 1e-8, 1e-10, "spline")
    _check(porosity_map.make_vertical_porosity_map(
        arr, grid_size=(3, 2), method="linear", as_condition=False),
        d["vmap_grid"], 1e-6, 1e-8, "vertical map")
    for i, g in enumerate(porosity_map.get_grid_center((4.0, 6.0), (2, 3))):
        _check(g, d[f"grid_center_{i}"], 1e-10, 1e-12, f"grid center {i}")
    with pytest.raises(ValueError):
        porosity_map.interpolate_array(arr, method="cubic")


def test_porosity_conditions_match_jax():
    """``matern_grid_sample`` from one seed and the condition dicts of it
    and of ``make_vertical_porosity_map``: the JAX package's values, as
    float32 tensors of shape [1] on the requested device."""
    params = {"sigma_sq": 1.0, "nu": 1.5, "length_scale": 32.0}
    kw = dict(sizes=(64,) * 3, grid=(2, 2, 2), mean_val=0.0, params=params,
              nsamples=2, seed=5)
    ours = porosity_map.matern_grid_sample(**kw)
    ref = jextra.matern_grid_sample(**kw)
    _check(ours, ref, 0, 0)
    conds = porosity_map.matern_grid_sample(**kw, as_condition=True,
                                            device="cpu")
    jconds = jextra.matern_grid_sample(**kw, as_condition=True)
    assert conds.shape == jconds.shape == (2, 2, 2, 2)
    for pos in np.ndindex(*conds.shape):
        p = conds[pos]["porosity"]
        assert p.dtype == torch.float32 and p.shape == (1,)
        assert p.device == CPU
        _check(p, jconds[pos]["porosity"], 0, 0)
    vm = porosity_map.make_vertical_porosity_map([0.1, 0.3], device="cpu")
    jvm = jextra.make_vertical_porosity_map([0.1, 0.3])
    assert vm.shape == jvm.shape == (2, 2, 3)
    for pos in np.ndindex(*vm.shape):
        _check(vm[pos]["porosity"], jvm[pos]["porosity"], 0, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            porosity_map.map_porosity_to_condition(0.3)


# ---------------------------------------------------------------------------
# the volume orchestrators: the fixtures' stubs
# ---------------------------------------------------------------------------
class _GridStub:
    """The fixture's stub: sample -> tanh(noise slice); inpaint -> mask *
    known + (1 - mask) * tanh(noise)."""
    device = CPU

    def __init__(self):
        self.sample_calls = 0
        self.inpaint_calls = 0

    def sample(self, nsamples, shape, generator, orig_noise=None, **kw):
        self.sample_calls += 1
        return torch.tanh(orig_noise)

    def inpaint(self, x_orig, mask, orig_noise=None, **kw):
        self.inpaint_calls += 1
        return (mask * x_orig + (1 - mask) * torch.tanh(orig_noise[0]))[None]


@pytest.mark.parametrize("tag,periodic_", [
    ("plain", (False, False, False)), ("periodic", (True, True, True))])
def test_grid_volume_fixture(tag, periodic_):
    d = np.load(os.path.join(FIXDIR, "grid_volume.npz"))
    stub = _GridStub()
    vol = extra.sample_grid_volume(
        stub, None, grid_map=[2, 2, 2], base_shape=(8, 8, 8, 1),
        overlap_size=4, nsteps=3, periodicity=periodic_,
        noise_cube=_vol_nchw(d[f"{tag}_noise"]))
    _check(vol, _vol_nchw(d[f"{tag}_volume"]), 1e-5, 1e-6,
           f"grid volume {tag}")
    assert (stub.sample_calls, stub.inpaint_calls) == (1, 7)


class _SeqStub:
    """The fixture's stub: a channels-first coordinate ramp moved to
    channels-last."""
    device = CPU

    def _pattern(self, shape):
        cf = (shape[-1],) + tuple(shape[:-1])
        ramp = torch.linspace(-1.0, 1.0, int(np.prod(cf))).reshape(cf)
        return torch.sin(3.0 * ramp).movedim(0, -1)

    def sample(self, nsamples, shape, generator, **kw):
        return self._pattern(shape)[None]

    def inpaint(self, x_orig, mask, **kw):
        gen = self._pattern(x_orig.shape)
        return (mask * x_orig + (1 - mask) * gen)[None]


@pytest.mark.parametrize("blend", ["cosine", "latest"])
def test_sequential_volume_fixture(blend):
    d = np.load(os.path.join(FIXDIR, "sequential_volume.npz"))
    vol = extra.sample_sequential_z(_SeqStub(), None, num_blocks=3,
                                    base_shape=(8, 8, 8, 1), overlap_size=4,
                                    nsteps=3, blend_mode=blend)
    _check(vol, _vol_nchw(d[f"{blend}_volume"]), 1e-5, 1e-6,
           f"sequential {blend}")


@pytest.mark.parametrize("grid_map", [(2, 2, 2), (3, 2, 2), (4, 2, 3)])
@pytest.mark.parametrize("periodic_", [(False,) * 3, (True, True, False)])
def test_grid_order_bounds_masks_match_jax(grid_map, periodic_):
    """The parity order, every cube's (possibly wrapped) window and every
    inpaint mask along the order equal the JAX package's."""
    if periodic_[0] and grid_map[0] % 2:
        periodic_ = (False, True, False)
    order, corners = extra.get_grid_generation_order(grid_map)
    assert (order, corners) == jextra.get_grid_generation_order(grid_map)
    base, final = [4, 4, 4], [4 * g for g in grid_map]
    done = set()
    for pos in order:
        b = extra.get_cube_spatial_bounds(pos, base, 2, final, periodic_)
        assert b == jextra.get_cube_spatial_bounds(pos, base, 2, final,
                                                   periodic_)
        mask = extra.build_inpaint_mask(pos, done, base, 2, final, 1,
                                        periodic_, device="cpu")
        ref = jextra.build_inpaint_mask(pos, done, base, 2, final, 1,
                                        periodic_)
        _check(mask, ref, 0, 0, str(pos))
        done.add(pos)


def test_orchestrator_validation_errors():
    """The JAX package's errors: a periodic axis with an odd grid count,
    an unknown blend mode, and every check of ``sample_sequential_z``."""
    stub = _GridStub()
    with pytest.raises(ValueError, match="not even"):
        extra.sample_grid_volume(stub, None, [3, 2, 2], (4, 4, 4, 1), 2,
                                 periodicity=(True, False, False))
    with pytest.raises(ValueError, match="blend_mode"):
        extra.sample_grid_volume(stub, None, [2, 2, 2], (4, 4, 4, 1), 2,
                                 blend_mode="mean")
    seq = _SeqStub()
    for args, match in (((0, (4, 4, 8, 1), 4), "at least 1"),
                        ((2, (4, 4, 8, 1), -2), "non-negative"),
                        ((2, (4, 4, 8, 1), 3), "even"),
                        ((2, (4, 4, 8, 1), 8), "less than")):
        with pytest.raises(ValueError, match=match):
            extra.sample_sequential_z(seq, None, *args)
    with pytest.raises(ValueError, match="Expected 3 conditions"):
        extra.sample_sequential_z(seq, None, 3, (4, 4, 8, 1), 4,
                                  y=[{"p": 0.1}] * 2)
    with pytest.raises(ValueError, match="blend_mode"):
        extra.sample_sequential_z(seq, None, 2, (4, 4, 8, 1), 4,
                                  blend_mode="mean")
    w = sequentialinpainting.create_cosine_blend_weights(4, device="cpu")
    ref = jextra.create_cosine_blend_weights(4)
    _check(w, ref, 1e-6, 1e-7)


# ---------------------------------------------------------------------------
# the decoder's halo and the tiled decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(ch_mult=(1, 2), num_res_blocks=1, has_mid_attn=False),
    dict(has_mid_attn=False),
    dict(ch_mult=(1, 2, 4), num_res_blocks=3, has_mid_attn=False),
    dict(ch_mult=(1,), num_res_blocks=0, has_mid_attn=False),
])
def test_decoder_halo_radius_matches_jax(kw):
    assert extra.decoder_halo_radius(DDConfig(**kw)) == \
        jextra.decoder_halo_radius(JDDConfig(**kw))
    assert extra.upscale_factor(DDConfig(**kw)) == \
        jextra.upscale_factor(JDDConfig(**kw))


def test_decoder_halo_radius_rejects_attention():
    with pytest.raises(NotImplementedError):
        extra.decoder_halo_radius(DDConfig(has_mid_attn=True))
    with pytest.raises(NotImplementedError):
        extra.decoder_halo_radius(DDConfig(has_mid_attn=False,
                                           attn_resolutions=(32,)))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        extra.halo_shard_decode(lambda z: z, torch.zeros(1, 2, 8, 8), None)


def _local_decoder(rng):
    """The JAX test's LocalDecoder (conv 2 -> 8, SiLU, 2x nearest
    upsample, conv 8 -> 1; receptive radius 1 + 1/2 latent units, so halo
    2 is exact) in both packages with the same weights."""
    w1 = rng.standard_normal((3, 3, 2, 8)).astype(np.float32) * 0.3
    b1 = rng.standard_normal(8).astype(np.float32) * 0.1
    w2 = rng.standard_normal((3, 3, 8, 1)).astype(np.float32) * 0.3
    b2 = rng.standard_normal(1).astype(np.float32) * 0.1

    def jdecode(z):      # channels-last, SAME convolutions
        dn = ("NHWC", "HWIO", "NHWC")
        h = jax.lax.conv_general_dilated(z, w1, (1, 1), "SAME",
                                         dimension_numbers=dn) + b1
        h = jax.nn.silu(h)
        h = jnp.repeat(jnp.repeat(h, 2, axis=1), 2, axis=2)
        return jax.lax.conv_general_dilated(h, w2, (1, 1), "SAME",
                                            dimension_numbers=dn) + b2

    tw1, tw2 = (torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
                for w in (w1, w2))

    def decode(z):       # [B, C, H, W]
        h = F.silu(F.conv2d(z, tw1, torch.from_numpy(b1), padding=1))
        h = h.repeat_interleave(2, 2).repeat_interleave(2, 3)
        return F.conv2d(h, tw2, torch.from_numpy(b2), padding=1)

    return decode, jdecode


@pytest.mark.parametrize("periodic_", [True, False])
def test_tiled_decode_matches_jax(periodic_):
    """The tiled decode of a 16 x 12 latent in 8 x 5 tiles (ragged at the
    edge) with halo 2, periodic and clamped, equals the JAX package's
    tiled decode (atol 1e-5), and, periodic, the one-shot decode of the
    periodically padded latent (exact for a norm-free local decoder)."""
    rng = np.random.default_rng(0)
    decode, jdecode = _local_decoder(rng)
    z = rng.standard_normal((2, 16, 12, 2)).astype(np.float32)
    ours = extra.tiled_decode(decode, _t(z).movedim(-1, 1), chunk=(8, 5),
                              halo=2, upscale=2, periodic=periodic_)
    ref = jextra.tiled_decode(jdecode, jnp.asarray(z), chunk=(8, 5), halo=2,
                              upscale=2, periodic=periodic_)
    assert ours.shape == (2, 1, 32, 24) and ours.device == CPU
    _check(ours.movedim(1, -1), ref, 1e-5, 1e-5)
    if periodic_:
        ids0 = torch.arange(-2, 18) % 16
        ids1 = torch.arange(-2, 14) % 12
        big = _t(z).movedim(-1, 1)[:, :, ids0][:, :, :, ids1]
        full = decode(big)[:, :, 4:-4, 4:-4]
        _check(ours, full, 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# conv -> circular surgery
# ---------------------------------------------------------------------------
_SMALL = dict(model_channels=8, channel_expansion=[2],
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1)


def test_convert_conv_params_to_circular_matches_jax():
    """A default-conv PUNetG's JAX weights, carried into the circular
    variant by each package's ``convert_conv_params_to_circular``: the
    port's circular model (its state dict converted by name) gives the JAX
    circular model's output (rtol 1e-5 of the output's scale)."""
    key = jax.random.PRNGKey(0)
    x = np.random.default_rng(1).standard_normal((1, 16, 16, 1)).astype(
        np.float32)
    t = np.ones((1,), np.float32)
    jdef = JPUNetG(JPUNetGConfig(**_SMALL))
    jcirc = JPUNetG(JPUNetGConfig(**_SMALL, convolution_type="circular"))
    init = jax.jit(lambda k: (
        jdef.init({"params": k, "dropout": k}, jnp.asarray(x), t),
        jcirc.init({"params": k, "dropout": k}, jnp.asarray(x), t)))
    v_def, v_circ = jax.tree.map(np.asarray, init(key))
    converted = jconverters.convert_conv_params_to_circular(
        v_def["params"], v_circ["params"])
    ref = jax.jit(jcirc.apply)(dict(v_circ, params=converted),
                               jnp.asarray(x), t)

    plain = PUNetG(PUNetGConfig(**_SMALL), device="cpu")
    plain.load_state_dict(from_jax_variables(v_def), strict=True)
    circ = PUNetG(PUNetGConfig(**_SMALL, convolution_type="circular"),
                  device="cpu")
    sd = converters.convert_conv_params_to_circular(plain.state_dict(),
                                                    circ.state_dict())
    assert list(sd) == list(circ.state_dict())
    circ.load_state_dict(sd, strict=True)
    with torch.no_grad():
        ours = circ(_t(x).movedim(-1, 1), _t(t)).movedim(1, -1)
        wrapped = plain(_t(x).movedim(-1, 1), _t(t)).movedim(1, -1)
    scale = float(np.abs(ref).max())
    _check(ours, ref, 1e-5, 1e-5 * scale)
    assert float((wrapped - _t(np.asarray(ref))).abs().max()) > 1e-3 * scale


def test_transfer_params_strip_and_strict():
    """``transfer_params`` matches a wrapped ``conv`` scope to a plain one
    and ``CircularConv_i`` to ``Conv_i``; an unmatched name or shape
    raises when strict and keeps the template's tensor otherwise."""
    src = {"a.conv.weight": torch.ones(2, 3), "b.CircularConv_0.bias":
           torch.full((4,), 2.0), "c.weight": torch.ones(5)}
    dst = {"a.weight": torch.zeros(2, 3), "b.Conv_0.bias": torch.zeros(4),
           "c.weight": torch.zeros(6)}
    with pytest.raises(ValueError, match="c.weight"):
        converters.transfer_params(src, dst)
    out = converters.transfer_params(src, dst, strict=False)
    assert torch.equal(out["a.weight"], torch.ones(2, 3))
    assert torch.equal(out["b.Conv_0.bias"], torch.full((4,), 2.0))
    assert torch.equal(out["c.weight"], torch.zeros(6))


# ---------------------------------------------------------------------------
# a tiny real SIModel through the orchestrators
# ---------------------------------------------------------------------------
_PUNET3 = dict(dimension=3, model_channels=8, channel_expansion=(2,),
               number_resnet_downward_block=1, number_resnet_upward_block=1,
               number_resnet_attn_block=1,
               number_resnet_before_attn_block=1,
               number_resnet_after_attn_block=1, num_heads=2)
_NSTEPS = 4


@pytest.fixture(scope="module")
def tiny_si():
    """The JAX PUNetG's variables (one jitted init) and the port's SIModel
    around a PUNetG with the same weights (linear path)."""
    jnet = JPUNetG(JPUNetGConfig(**_PUNET3))
    shape = (1, 8, 8, 8, 1)
    variables = jax.jit(lambda k: jnet.init(
        {"params": k, "dropout": k}, jnp.zeros(shape), jnp.ones((1,)),
        None))(jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    model = SIModel(PUNetG(PUNetGConfig(**_PUNET3), device="cpu"),
                    SIModelConfig(scheduler="linear"), device="cpu")
    model.net.model.load_state_dict(from_jax_variables(variables),
                                    strict=True)
    jmodel = JSIModel(jnet, JSIModelConfig(scheduler="linear"))
    return jmodel, variables, model


class _Recorder:
    """The SIModel's sample and inpaint, recording what each returned."""

    def __init__(self, model):
        self.model, self.device, self.calls = model, model.device, []

    def sample(self, *args, **kw):
        out = self.model.sample(*args, **kw)
        self.calls.append(("sample", kw.get("orig_noise"), None, out))
        return out

    def inpaint(self, x_orig, mask, **kw):
        out = self.model.inpaint(x_orig, mask, **kw)
        self.calls.append(("inpaint", x_orig, mask, out))
        return out


def _known_regions_exact(calls):
    """Every inpainted cube leaves its known region (mask 1, falloff 0) as
    x_orig: at t = 0 the linear path's α is 1 and σ 0."""
    n = 0
    for kind, x_orig, mask, out in calls:
        if kind == "inpaint":
            known = mask == 1.0
            assert bool(known.any())
            assert torch.equal(out[0][known], x_orig[known])
            assert bool(torch.isfinite(out).all())
            n += 1
    return n


@pytest.mark.parametrize("periodic_", [False, True])
def test_grid_volume_tiny_si_matches_jax(tiny_si, periodic_):
    """``sample_grid_volume`` at grid (2, 2, 2), base 8³, overlap 4 (cubes
    10³ plain, 12³ periodic, the corner's window wrapped) with a replayed
    noise cube: the corner cube equals the JAX model's Heun sample of the
    same slice (rtol 1e-4, atol 1e-4 of its scale, as
    ``tests/test_torch_si.py`` holds a sample), it stays in the volume,
    and every inpainted cube's known region is exact."""
    jmodel, variables, model = tiny_si
    per = (periodic_,) * 3
    noise = np.random.default_rng(2).standard_normal(
        (1, 16, 16, 16, 1)).astype(np.float32)
    rec = _Recorder(model)
    vol = extra.sample_grid_volume(
        rec, torch.Generator().manual_seed(0), [2, 2, 2], (8, 8, 8, 1), 4,
        nsteps=_NSTEPS, periodicity=per, noise_cube=noise)
    assert vol.shape == (1, 16, 16, 16, 1)
    assert bool(torch.isfinite(vol).all())
    assert [c[0] for c in rec.calls] == ["sample"] + ["inpaint"] * 7
    assert _known_regions_exact(rec.calls) == 7

    bounds = jfill.get_cube_spatial_bounds((0, 0, 0), [8] * 3, 4, [16] * 3,
                                           per)
    jslice = jperiodic.periodic_getitem(jnp.asarray(noise[0]), *bounds)[None]
    ext = tuple(jslice.shape[1:])
    assert ext == ((12,) * 3 + (1,) if periodic_ else (10,) * 3 + (1,))
    ref = jax.jit(lambda v, o: jmodel.sample(
        v, jax.random.PRNGKey(0), 1, ext, nsteps=_NSTEPS,
        is_latent_shape=True, orig_noise=o, return_latents=True))(
            variables, jslice)
    corner = rec.calls[0][3]
    scale = max(1.0, float(np.abs(ref).max()))
    _check(corner, ref, 1e-4, 1e-4 * scale, "corner cube")
    # later cubes keep it as their known region
    assert torch.equal(periodic.periodic_getitem(vol[0], *bounds),
                       corner[0])


def test_grid_volume_draw_order(tiny_si):
    """Without ``noise_cube`` the cube is the generator's first draw, then
    the cubes' draws: the same seed gives the same volume, and so does the
    cube drawn first and replayed as ``noise_cube``."""
    _, _, model = tiny_si
    kw = dict(grid_map=[2, 1, 1], base_shape=(8, 8, 8, 1), overlap_size=4,
              nsteps=3)
    a = extra.sample_grid_volume(model, torch.Generator().manual_seed(7),
                                 **kw)
    g = torch.Generator().manual_seed(7)
    cube = torch.randn((1, 16, 8, 8, 1), generator=g)
    b = extra.sample_grid_volume(model, g, noise_cube=cube, **kw)
    assert torch.equal(a, b)


def test_grid_volume_condition_grid():
    """A porosity-conditioned SIModel (PUNetG with a ``PorosityEmbedder``,
    as configuration Q): an object array of condition dicts shaped like
    the grid gives each cube its own condition (one shared dict equals a
    grid of that dict; another porosity in the second cube changes the
    volume), numpy porosities as float32."""
    from diffsci_tpu_torch.models.nets import PorosityEmbedder

    model = SIModel(PUNetG(PUNetGConfig(**dict(_PUNET3,
                                               number_resnet_attn_block=0)),
                           conditional_embedding=PorosityEmbedder(8),
                           device="cpu"),
                    SIModelConfig(scheduler="linear"), device="cpu")
    model.init(seed=3)
    kw = dict(grid_map=[2, 1, 1], base_shape=(8, 8, 8, 1), overlap_size=4,
              nsteps=3)

    def run(y):
        return extra.sample_grid_volume(
            model, torch.Generator().manual_seed(2), y=y, **kw)

    shared = run({"porosity": np.array([0.3])})
    grid = porosity_map.make_vertical_porosity_map(
        [0.3, 0.3], grid_size=(2, 1), device="cpu")[:, :, :1]
    assert torch.equal(shared, run(grid))
    grid[1, 0, 0] = porosity_map.map_porosity_to_condition(0.6, "cpu")
    other = run(grid)
    # the corner cube's window is the same; the second cube's is not
    assert torch.equal(other[:, :6], shared[:, :6])
    assert float((other - shared).abs().max()) > 1e-4


def test_sequential_tiny_si_known_regions(tiny_si):
    """``sample_sequential_z`` with the tiny SIModel: 3 blocks of 8 x 8 x 6
    with overlap 2 (Euler–Maruyama throughout, its default), cosine and
    latest: shapes, finite values, each inpainted block's known region
    exact, and with "latest" the stack holds each block's body up to the
    next block."""
    _, _, model = tiny_si
    for blend in ("cosine", "latest"):
        rec = _Recorder(model)
        vol = extra.sample_sequential_z(
            rec, torch.Generator().manual_seed(1), 3, (8, 8, 6, 1), 2,
            nsteps=3, blend_mode=blend)
        assert vol.shape == (1, 8, 8, 18, 1)
        assert bool(torch.isfinite(vol).all())
        assert [c[0] for c in rec.calls] == ["sample", "inpaint", "inpaint"]
        assert [tuple(c[3].shape[1:]) for c in rec.calls] == [
            (8, 8, 7, 1), (8, 8, 8, 1), (8, 8, 7, 1)]
        assert _known_regions_exact(rec.calls) == 2
        if blend == "latest":
            # block i writes [6i - 1, 6i + 6); the next block from 6i + 5
            for i, (_, _, _, out) in enumerate(rec.calls[1:], 1):
                assert torch.equal(vol[0, :, :, 6 * i - 1:6 * i + 5],
                                   out[0, :, :, :6])
