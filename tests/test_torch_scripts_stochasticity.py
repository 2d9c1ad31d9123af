"""The port's last four scripts against the JAX package's:
``stochasticity_sweep``, ``stochasticity_study``,
``picard_restart_trained`` and ``repro_reference_fid``
(``diffsci_tpu_torch/scripts/``), on the CPU (``--device cpu``) at cut
sizes.

- the parsers (with the sweep's suppressed worker flags): every flag of
  the JAX script and ``--device`` (``tests/test_torch_scripts.py``
  covers them over ``NAMES``; here the help of the worker flags too);
- data: ``load_mnist(None)``, the study's ``ShapesDataset`` arrays and
  ``TARGETS`` equal to the JAX scripts' (``np.array_equal``, ``==``);
- the artifacts: the study's and ``picard_restart_trained``'s JSON keys
  those of the committed JAX artifacts (``docs/artifacts/``, only read);
- the sweep's ``--processes 2`` JSON equal bit for bit to the sequential
  run's (both through the command line, in processes of one
  environment);
- three steps of the repro's training configuration (``build``) against
  JAX's step from the JAX script's constants, σ and ε replayed (loss
  rtol 1e-5, grad_norm rtol 1e-4, parameters within AdamW's bounds:
  ``tests/test_torch_scripts_recipes.py``);
- the repro's ``--smoke`` run with a data file (a temporary
  ``mnist.npz``) and an Inception weights file (a seeded
  ``InceptionV3FID`` state dict), and its ``--ckpt`` rerun, which gives
  the same FIDs;
- each of the four raises when ``--device cuda`` (the default) finds no
  CUDA.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from tests import _torch_warmup  # noqa: F401  (MKL's first exp)
from tests._torch_scripts_util import jax_script, parser_of, port, run_main

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARTIFACTS = ROOT / "docs" / "artifacts"
FOUR = ("stochasticity_sweep", "stochasticity_study",
        "picard_restart_trained", "repro_reference_fid")
SHAPES = ["--size", 20, "--num-data", 32, "--model-channels", 8,
          "--batch-size", 8]


def _run(name, args):
    return run_main(port(name), name, [str(a) for a in args]
                    + ["--device", "cpu"])


# ---------------------------------------------------------------------------
# parsers, data, constants
# ---------------------------------------------------------------------------
def test_sweep_worker_flags_stay_hidden():
    ours = {a.dest: a.help for a in parser_of(
        port("stochasticity_sweep"))._actions}
    theirs = {a.dest: a.help for a in parser_of(
        jax_script("stochasticity_sweep"))._actions}
    for dest in ("worker", "taskfile"):
        assert ours[dest] == theirs[dest] == "==SUPPRESS=="


def test_data_and_targets_are_the_jax_scripts():
    from diffsci_tpu.data import ShapesDataset as JShapes
    from diffsci_tpu_torch.data import ShapesDataset
    jrepro, repro = jax_script("repro_reference_fid"), \
        port("repro_reference_fid")
    np.testing.assert_array_equal(repro.load_mnist(None),
                                  jrepro.load_mnist(None))
    assert repro.TARGETS == jrepro.TARGETS
    # the study's training set with its labels, and its held-out set
    for ours, theirs in (
            (ShapesDataset(64, size=32, mode="paper_replica")
             .generate_labeled(),
             JShapes(64, size=32, mode="paper_replica").generate_labeled()),
            ((ShapesDataset(16, size=32, mode="paper_replica",
                            seed=123).generate(),),
             (JShapes(16, size=32, mode="paper_replica",
                      seed=123).generate(),))):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", FOUR)
def test_scripts_raise_without_cuda(name, monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_main(port(name), name, [])
    assert not any(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# the artifacts' keys
# ---------------------------------------------------------------------------
def test_stochasticity_study_writes_the_jax_artifact(tmp_path):
    out = tmp_path / "sweep.json"
    _run("stochasticity_study", ["--steps", 2, "--nsamples", 4, "--nfe", 3,
                                 "--gammas", 0.01, 1.0] + SHAPES +
         ["--log-dir", tmp_path / "log", "--out", out])
    art = json.loads(out.read_text())
    ref = json.loads((ARTIFACTS / "stochasticity_sweep.json").read_text())
    # the committed artifact predates the two keys of the width that the
    # JAX script now writes too (scripts/stochasticity_study.py:186-187)
    assert set(art) - set(ref) == {"model_channels", "channel_expansion"}
    assert set(ref) <= set(art)
    assert [set(r) for r in art["sweep"]] == [{"gamma", "fid"}] * 2
    assert {"gamma", "fid"} <= set(ref["sweep"][0])
    assert art["train_steps"] == 2 and art["nfe"] == 3
    assert all(np.isfinite(r["fid"]) for r in art["sweep"])
    assert isinstance(art["shape_ok"], bool)


def test_picard_restart_trained_writes_the_jax_artifact(tmp_path):
    out = tmp_path / "pr.json"
    art = _run("picard_restart_trained",
               ["--train-steps", 2, "--nsamples-fid", 4,
                "--latency-batch", 2, "--expansion", 2] + SHAPES +
               ["--log-dir", tmp_path / "log", "--out", out])
    assert json.loads(out.read_text()) == art
    ref = json.loads((ARTIFACTS / "picard_restart_trained_r5.json")
                     .read_text())
    assert set(art) == set(ref)
    assert list(art["arms"]) == list(ref["arms"])
    for label, row in ref["arms"].items():
        assert set(art["arms"][label]) == set(row), label
    assert set(art["claims"]) == set(ref["claims"])
    # Picard's fixed point is sequential Euler from the same draws
    assert art["arms"]["picard@18_w8"]["max_abs_delta_vs_euler@18"] < 1e-3
    assert art["arms"]["picard@100_w16"]["sweeps"] <= 100


# ---------------------------------------------------------------------------
# the sweep: --processes 2 against the sequential run
# ---------------------------------------------------------------------------
def test_sweep_processes_match_sequential_bit_for_bit(tmp_path):
    """Both modes through the command line, in processes of one
    environment (one thread each): the parent's seeds and real features
    and its precision flags reach the workers, so each γ's FID is the
    sequential run's to the bit, in the γ grid's order."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    outs = {}
    for label, extra in (("seq", []), ("mp", ["--processes", "2"])):
        outs[label] = tmp_path / f"{label}.json"
        subprocess.run(
            [sys.executable, "-m",
             "diffsci_tpu_torch.scripts.stochasticity_sweep",
             "--gammas", "0.0", "0.5", "1.0", "--nsamples", "16",
             "--nsteps", "4", "--out", str(outs[label]), "--device", "cpu"]
            + extra, cwd=tmp_path, env=env, check=True, timeout=240)
    seq, mp = (outs[k].read_text() for k in ("seq", "mp"))
    assert seq == mp
    scores = json.loads(seq)
    assert list(scores) == ["gamma_0.0", "gamma_0.5", "gamma_1.0"]
    assert all(np.isfinite(v) for v in scores.values())
    assert len(set(scores.values())) == 3


# ---------------------------------------------------------------------------
# the repro: its training config against JAX's, its files
# ---------------------------------------------------------------------------
def test_repro_training_config_matches_jax():
    """Three steps of ``build`` (the smoke width, 8 channels) against
    JAX's step from the JAX script's config: PUNetG expansion [2, 4],
    EDM, AdamW lr 1e-3 wd 1e-4 clip 0.5, power EMA [0.05, 0.1]."""
    from diffsci_tpu.models import KarrasModelConfig as JConfig
    from diffsci_tpu.models import PUNetG as JPUNetG
    from diffsci_tpu.models import PUNetGConfig as JPUNetGConfig
    from diffsci_tpu.models import default_optimizer as jdefault
    from tests.test_torch_scripts_recipes import (_jax_power_ema,
                                                  _karras_recipe)
    jnet = JPUNetG(JPUNetGConfig(model_channels=8, channel_expansion=[2, 4]))
    _karras_recipe("repro_reference_fid", ["--channels", 8], jnet,
                   JConfig.from_edm(), _jax_power_ema([0.05, 0.1]),
                   jdefault(1e-3, 1e-4, grad_clip=0.5), (4, 16, 16, 1),
                   1e-3)


def test_repro_data_weights_and_checkpoint_branches(tmp_path, monkeypatch):
    """``--smoke`` with ``--data`` (a uint8 [N, 28, 28] ``mnist.npz``) and
    ``--inception-weights`` (a seeded ``InceptionV3FID`` state dict): the
    results name the file and the Inception space, three finite FIDs;
    then ``--ckpt`` of that run's checkpoint gives them again bit for
    bit. FID at d 2048 is a host ``sqrtm`` of ~20 s on the CPU and an
    Inception forward at 299² ~0.3 s an image on one thread, both
    covered by ``tests/test_torch_metrics.py`` and
    ``tests/test_torch_inception.py``: here FID is the squared distance
    of the features' means and the images are resized to 80² (the
    network's pools take it), so the branch's path runs in seconds."""
    import types

    import torch
    import torch.nn.functional as F
    import diffsci_tpu_torch.metrics as metrics
    import diffsci_tpu_torch.metrics_inception as mi
    from diffsci_tpu_torch.metrics_inception import InceptionV3FID

    rng = np.random.default_rng(7)
    data = tmp_path / "mnist.npz"
    np.savez(data, x=(rng.random((48, 28, 28)) * 255).astype(np.uint8))
    net = InceptionV3FID(device="cpu")
    net.init(0)
    weights = tmp_path / "pt_inception.pth"
    torch.save(net.state_dict(), weights)
    monkeypatch.setattr(metrics, "fid", lambda a, b: float(
        np.sum((np.mean(a, 0) - np.mean(b, 0)) ** 2)))
    small = dict(vars(F), interpolate=lambda x, size, **kw: F.interpolate(
        x, size=(80, 80), **kw))
    monkeypatch.setattr(mi, "F", types.SimpleNamespace(**small))
    flags_ = ["--smoke", "--data", data, "--inception-weights", weights]
    first = _run("repro_reference_fid", flags_ + ["--outdir", tmp_path / "a"])
    saved = json.loads((tmp_path / "a" / "fid_results.json").read_text())
    assert saved["data"] == str(data)
    assert saved["feature_space"] == "inception (reference-comparable)"
    assert set(first) == {"ode_heun", "sde_gamma1.0", "sde_gamma3.0"}
    assert all(np.isfinite(v) for v in first.values())
    assert saved["targets"] == {n: t for n, _, t, _ in
                                port("repro_reference_fid").TARGETS}
    again = _run("repro_reference_fid", flags_ + [
        "--ckpt", tmp_path / "a" / "ckpt", "--outdir", tmp_path / "b"])
    assert again == first
