"""Each of the port's 15 scripts (``diffsci_tpu_torch/scripts/``) runs its
``main()`` in-process on the CPU (``--device cpu``) at
``tests/test_scripts.py``'s sizes or smaller, and writes the JAX
script's file set under its output paths: the checkpoint with its
``description.json`` (equal to the JAX model's ``export_description()``),
``metrics.jsonl``, ``samples.npy`` channels-last as the JAX script saves
it, the PNGs and the JSON artifacts. The training recipes are here; the
studies are in ``tests/test_torch_scripts_studies.py``.
"""

import json

import numpy as np
import pytest

from tests import _torch_warmup  # noqa: F401  (MKL's first exp)
from tests._torch_scripts_util import port, run_main


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _run(name, args):
    return run_main(port(name), name, [str(a) for a in args]
                    + ["--device", "cpu"])


def _jax_description(name, channels):
    from diffsci_tpu.models import KarrasModel, KarrasModelConfig, PUNetG
    from diffsci_tpu.models import PUNetGConfig
    if name == "train_diffusion_mnist":
        net = PUNetG(PUNetGConfig(model_channels=channels,
                                  channel_expansion=[2, 4]))
        return KarrasModel(net, KarrasModelConfig.from_edm()) \
            .export_description()
    if name == "train_diffusion_cifar10":
        net = PUNetG(PUNetGConfig(model_channels=channels,
                                  channel_expansion=[2, 4],
                                  input_channels=3, output_channels=3))
        return KarrasModel(net, KarrasModelConfig.from_vp()) \
            .export_description()
    net = PUNetG(PUNetGConfig(model_channels=channels,
                              channel_expansion=[2, 4],
                              number_resnet_attn_block=1,
                              number_resnet_before_attn_block=2,
                              number_resnet_after_attn_block=2))
    return KarrasModel(net, KarrasModelConfig.from_edm()) \
        .export_description()


CKPT = ["ckpt/description.json", "ckpt/state.pt"]


@pytest.fixture(scope="module")
def mnist_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mnist")
    _run("train_diffusion_mnist", ["--steps", 2, "--batch", 8, "--channels",
                                   8, "--outdir", out])
    return out


def test_train_diffusion_mnist_writes_the_jax_file_set(mnist_run):
    assert _files(mnist_run) == sorted(CKPT + ["metrics.jsonl",
                                               "samples.npy",
                                               "samples.png"])
    desc = json.loads((mnist_run / "ckpt" / "description.json").read_text())
    assert desc == _jax_description("train_diffusion_mnist", 8)
    samples = np.load(mnist_run / "samples.npy")
    assert samples.shape == (16, 28, 28, 1) and samples.dtype == np.float32
    assert np.isfinite(samples).all()
    rows = [json.loads(r) for r in
            (mnist_run / "metrics.jsonl").read_text().splitlines()]
    assert rows[0]["step"] == 1 and "train_loss" in rows[0]
    assert any("valid_loss" in r for r in rows)


def test_eval_fid_scores_the_mnist_checkpoint(mnist_run, capsys):
    _run("eval_fid", ["--ckpt", mnist_run / "ckpt", "--nsamples", 8,
                      "--batch", 4, "--nfe", 3, "--fld"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(result) == {"fid", "kid", "feature_space", "nsamples", "nfe",
                           "stochastic", "gamma", "seed", "gen_mean",
                           "gen_std", "real_mean", "real_std", "fld",
                           "fld_gen_gap"}
    assert result["feature_space"] == "pixel" and result["nsamples"] == 8
    assert all(np.isfinite(result[k]) for k in ("fid", "kid", "fld"))
    _run("eval_fid", ["--ckpt", mnist_run / "ckpt", "--nsamples", 4,
                      "--batch", 4, "--nfe", 3, "--gamma", 0.5, "--no-ema"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["stochastic"] and result["gamma"] == 0.5


def test_train_diffusion_toy_samples_two_modes():
    s = _run("train_diffusion_toy", ["--steps", 2, "--batch", 16])
    assert s.shape == (4096, 2) and np.isfinite(s).all()


TRAINERS = {
    "train_diffusion_cifar10": (
        ["--steps", 2, "--batch", 8, "--channels", 8],
        CKPT + ["metrics.jsonl", "samples.npy", "samples.png"]),
    "train_diffusion_shapes": (
        ["--steps", 2, "--batch", 8, "--channels", 8, "--size", 20,
         "--num-samples", 32],
        CKPT + ["metrics.jsonl", "morph.png", "samples.png"]),
    "train_diffusion_conditional": (
        ["--steps", 2, "--batch", 8, "--channels", 8, "--nsamples", 4],
        ["conditional_samples.png", "metrics.jsonl"]),
    "train_super_resolution": (
        ["--steps", 2, "--batch", 8, "--channels", 8, "--nsamples", 4,
         "--ndraws", 2],
        ["metrics.jsonl", "sr3.png"]),
    "train_ensemble_forecast": (
        ["--steps", 2, "--batch", 8, "--channels", 8, "--ensemble", 2,
         "--eval-ensemble", 2, "--size", 16],
        ["forecast.png"]),
    "train_vae": (
        ["--steps", 2, "--batch", 4, "--resolution", 16],
        CKPT),
}


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_training_recipe_writes_the_jax_file_set(name, tmp_path):
    flags_, files = TRAINERS[name]
    _run(name, flags_ + ["--outdir", tmp_path])
    assert _files(tmp_path) == sorted(files)
    if "ckpt/description.json" not in files:
        return
    desc = json.loads((tmp_path / "ckpt" / "description.json").read_text())
    if name == "train_vae":
        from diffsci_tpu.models.nets import DDConfig
        assert desc == {"ddconfig": DDConfig(
            z_channels=4, resolution=16, ch=32, ch_mult=[1, 2, 4],
            num_res_blocks=2, has_mid_attn=False).export_description()}
        from diffsci_tpu_torch.checkpoint import load_state
        saved = load_state(tmp_path / "ckpt")
        assert int(saved["step"]) == 2 and int(saved["counter"]) == 2
    else:
        assert desc == _jax_description(name, 8)
    if name == "train_diffusion_cifar10":
        samples = np.load(tmp_path / "samples.npy")
        assert samples.shape == (16, 32, 32, 3)


def test_train_vae_adversarial_checkpoint_restores(tmp_path):
    """``train_vae --adversarial`` saves the discriminator's parameters
    and optimizer and the step counter beside the autoencoder's, and the
    checkpoint restores into a fresh ``create_vae_train_state`` template
    tensor for tensor."""
    import torch
    from diffsci_tpu_torch.checkpoint import (load_state,
                                              restore_checkpoint,
                                              state_tensors)
    from diffsci_tpu_torch.models.vae import create_vae_train_state
    from tests._torch_scripts_util import parser_of
    flags_ = ["--steps", 2, "--batch", 4, "--resolution", 16,
              "--adversarial"]
    _run("train_vae", flags_ + ["--outdir", tmp_path])
    saved = load_state(tmp_path / "ckpt")
    for group in ("params/", "optimizer/", "disc_params/",
                  "disc_optimizer/"):
        assert any(k.startswith(group) for k in saved), group
    assert int(saved["step"]) == 2 and int(saved["counter"]) == 2

    mod = port("train_vae")
    _, model = mod.build(parser_of(mod).parse_args(
        [str(f) for f in flags_] + ["--device", "cpu"]), "cpu")
    template, _, _ = create_vae_train_state(model, (4, 1, 16, 16), seed=0)
    fresh = {k: v.clone() for k, v in state_tensors(template).items()}
    assert any(not torch.equal(v, saved[k]) for k, v in fresh.items()
               if k.startswith("params/"))
    restore_checkpoint(tmp_path / "ckpt", template)
    tensors = state_tensors(template)
    assert {k for k in tensors if k.startswith("disc_")} == \
        {k for k in saved if k.startswith("disc_")}
    for k, v in tensors.items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0, msg=k)
    assert int(template.step) == 2
