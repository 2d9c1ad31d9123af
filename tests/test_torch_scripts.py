"""The port's scripts (``diffsci_tpu_torch/scripts/``) against the JAX
package's (``scripts/``):

- CLI parity: every flag of a JAX script exists in its port with the same
  option strings, default, nargs, type, choices and action; ``--device``
  (default ``cuda``) is the only extra flag;
- CONFIG parity: every upper-case constant of a JAX script is equal in
  its port;
- data parity: each synthetic fallback and numpy helper gives
  ``np.array_equal`` arrays (the JAX scripts build them with numpy
  alone);
- deterministic outputs: ``correlation_thresholds`` of both packages on
  one profile JSON gives the same CSV rows (floats within 1e-6).

The recipes' train steps against JAX's are in
``tests/test_torch_scripts_recipes.py``, the scripts' runs in
``tests/test_torch_scripts_smoke.py``, ``_studies.py`` and ``_mp.py``.
"""

import csv
import json

import numpy as np
import pytest

from tests import _torch_warmup  # noqa: F401  (MKL's first exp)
from tests._torch_scripts_util import (NAMES, flags, jax_script, parser_of,
                                       port, run_main)


# ---------------------------------------------------------------------------
# CLI, CONFIG and data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_cli_flags_match_the_jax_script(name):
    ours = flags(parser_of(port(name)))
    theirs = flags(parser_of(jax_script(name)))
    assert set(ours) - set(theirs) == {"device"}
    assert ours.pop("device")[:2] == (("--device",), "cuda")
    for dest, spec in theirs.items():
        assert ours[dest] == spec, (dest, ours[dest], spec)


@pytest.mark.parametrize("name", NAMES)
def test_config_constants_match_the_jax_script(name):
    jmod, pmod = jax_script(name), port(name)
    consts = {k: v for k, v in vars(jmod).items()
              if k.isupper() and isinstance(v, (int, float, str, list,
                                                tuple, dict))
              and k != "SCRIPTS"}
    for k, v in consts.items():
        assert getattr(pmod, k) == v, k


def _vae_fallback(jmod, pmod):
    # the JAX script builds its fields inline in main()
    theirs = np.random.default_rng(0).standard_normal(
        (2048, 16, 16, 1)).astype(np.float32)
    return pmod.load_data(None, 16), theirs


def _sr_degrade(jmod, pmod):
    xs = jmod.make_blobs(16)
    f = 4
    lo = xs.reshape(-1, 28 // f, f, 28 // f, f, 1).mean(axis=(2, 4))
    return pmod.degrade(xs, f), np.repeat(np.repeat(lo, f, axis=1), f,
                                          axis=2)


def _same(fn, *args):
    return lambda jmod, pmod: (getattr(pmod, fn)(*args),
                               getattr(jmod, fn)(*args))


DATA = {
    "mnist load_data": ("train_diffusion_mnist", _same("load_data", None)),
    "eval_fid load_real": ("eval_fid", _same("load_real", None, 64)),
    "cifar10 load_data": ("train_diffusion_cifar10",
                          _same("load_data", None, 256)),
    "conditional make_dataset": ("train_diffusion_conditional",
                                 _same("make_dataset", 256)),
    "conditional centroid": ("train_diffusion_conditional",
                             _same("centroid", np.linspace(
                                 -1, 1, 28 * 28).reshape(28, 28))),
    "sr make_blobs": ("train_super_resolution", _same("make_blobs", 256)),
    "sr degrade": ("train_super_resolution", _sr_degrade),
    "sr psnr": ("train_super_resolution", _same(
        "psnr", np.zeros((2, 4)), np.full((2, 4), 0.1))),
    "forecast pairs": ("train_ensemble_forecast",
                       _same("make_advection_pairs", 256, 16)),
    "vae fields": ("train_vae", _vae_fallback),
    "anomaly make_blobs": ("anomaly_detection", _same("make_blobs", 64)),
    "anomaly inject_square": ("anomaly_detection", _same(
        "inject_square", np.zeros((8, 28, 28, 1), np.float32))),
    "inpainting make_two_blobs": ("inpainting_demo",
                                  _same("make_two_blobs", 64)),
    "entropy custom_spacing": ("entropy_time_profile",
                               _same("custom_spacing", 1e-3, 8.0, 8)),
    "entropy approx_entropy1": ("entropy_time_profile", _same(
        "approx_entropy1", np.random.default_rng(0).normal(size=500),
        np.random.default_rng(1).normal(size=400))),
    "correlation safe_corr": ("correlation_thresholds", _same(
        "safe_corr", [1.0, 2.0, 4.0, 3.0], [0.5, 1.5, 2.0, 2.5])),
}


@pytest.mark.parametrize("case", sorted(DATA))
def test_synthetic_data_is_the_jax_scripts(case):
    name, make = DATA[case]
    ours, theirs = make(jax_script(name), port(name))
    ours = ours if isinstance(ours, tuple) else (ours,)
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=case)


def _profile_json(path, nsnap=5, nsteps=12):
    rng = np.random.default_rng(3)
    snaps = {}
    for k in range(1, nsnap + 1):
        ent = rng.uniform(0.05, 2.0, 4)
        snaps[str(20 * k)] = {
            "gamma_values": [0.001, 0.5, 2.0, 8.0],
            "sde_entropies": ent.tolist(),
            "inv_sde_entropies": rng.uniform(0.05, 2.0, 4).tolist(),
            "score_errors": rng.uniform(0.0, 3.0, nsteps).tolist(),
            "dsm_losses": rng.uniform(0.0, 3.0, nsteps).tolist(),
            "train_loss": float(rng.uniform())}
    path.write_text(json.dumps({"nsteps": nsteps, "snapshots": snaps}))


def test_correlation_thresholds_csv_matches_the_jax_script(tmp_path):
    src = tmp_path / "profile.json"
    _profile_json(src)
    args = ["--input", src, "--epoch-threshold", "0",
            "--initial-range", "0.3", "0.9", "4",
            "--final-range", "0.05", "0.4", "4",
            "--late-range", "0.01", "0.2", "5"]
    rows = {}
    for label, mod in (("jax", jax_script("correlation_thresholds")),
                       ("port", port("correlation_thresholds"))):
        out = tmp_path / f"{label}.csv"
        extra = ["--device", "cpu"] if label == "port" else []
        run_main(mod, "correlation_thresholds",
                 args + ["--out", out] + extra)
        rows[label] = list(csv.DictReader(open(out)))
    assert len(rows["port"]) == len(rows["jax"]) > 10
    for a, b in zip(rows["port"], rows["jax"]):
        assert a.keys() == b.keys()
        for k in a:
            try:
                x, y = float(a[k]), float(b[k])
            except ValueError:
                assert a[k] == b[k], k
                continue
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-12,
                                       equal_nan=True, err_msg=k)


def test_use_weights_refuses_names_the_network_lacks():
    """``_common.use_weights`` loads a state's weights into the network
    by name, and raises when a parameter is missing from them or a name
    is not the network's, rather than sampling from the weights it had."""
    import torch
    from diffsci_tpu_torch.models import (KarrasModel, KarrasModelConfig,
                                          MLPUncond)
    from diffsci_tpu_torch.scripts._common import use_weights
    model = KarrasModel(MLPUncond(2, (8,), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.init(0)
    weights = {k: torch.full_like(p, 0.5)
               for k, p in model.net.named_parameters()}
    use_weights(model, weights)
    assert all(bool((p == 0.5).all()) for p in model.net.parameters())
    first = next(iter(weights))
    with pytest.raises(KeyError, match="missing parameters"):
        use_weights(model, {k: v for k, v in weights.items()
                            if k != first})
    with pytest.raises(KeyError, match="unexpected names"):
        use_weights(model, {**weights, "net.bogus": weights[first]})
