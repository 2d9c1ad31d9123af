"""The port's study scripts (``diffsci_tpu_torch/scripts/``) run their
``main()`` in-process on the CPU (``--device cpu``) at cut sizes and
write the JAX scripts' outputs: the JSON artifacts with the JAX scripts'
keys, the training logs and PNGs; the entropy-profile pair repeats
``tests/test_scripts.py::test_entropy_time_profile_and_correlations``'s
assertions on the port.
"""

import csv
import json

import numpy as np
import pytest

from tests import _torch_warmup  # noqa: F401  (MKL's first exp)
from tests._torch_scripts_util import port, run_main


def _run(name, args):
    return run_main(port(name), name, [str(a) for a in args]
                    + ["--device", "cpu"])


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


SHAPES = ["--size", 20, "--num-data", 32, "--nsamples", 4,
          "--model-channels", 8, "--batch-size", 8]


def test_sampler_comparison_writes_its_artifact(tmp_path):
    _run("sampler_comparison", ["--steps", 2] + SHAPES +
         ["--log-dir", tmp_path / "log", "--out", tmp_path / "out.json"])
    art = json.loads((tmp_path / "out.json").read_text())
    assert set(art) == {"dataset", "train_steps", "nsamples",
                        "model_channels", "feature_space", "results",
                        "claims"}
    assert list(art["results"]) == [g[0] for g in
                                    port("sampler_comparison").GRID]
    assert all(np.isfinite(r["fid"]) for r in art["results"].values())
    assert set(art["claims"]) == {"dpm_beats_euler_at_10_nfe",
                                  "dpm_beats_euler_at_20_nfe",
                                  "dpm20_within_10pct_of_heun19"}
    assert _files(tmp_path) == ["log/metrics.jsonl", "out.json"]


def test_sampler_comparison_classifier_features():
    """``--classifier-fid``'s feature space: a MinimalResNet trained on
    the shapes' slot labels, its pooled features (32 wide, float64)."""
    from diffsci_tpu_torch.data import ShapesDataset
    xs, labels = ShapesDataset(16, size=20).generate_labeled()
    feats = port("sampler_comparison").train_classifier_features(
        xs, labels, "cpu", steps=2)
    f = feats(xs[:5])
    assert f.shape == (5, 32) and f.dtype == np.float64
    assert np.isfinite(f).all()


def test_distill_study_writes_its_artifact(tmp_path):
    _run("distill_study", ["--steps", 2, "--phase-steps", 2,
                           "--start-nsteps", 3] + SHAPES +
         ["--log-dir", tmp_path / "log", "--out", tmp_path / "out.json"])
    art = json.loads((tmp_path / "out.json").read_text())
    assert art["chain"] == [3, 2, 1]
    assert set(art["results"]) == {
        "teacher_heun@18", "teacher_euler@3", "teacher_euler@5",
        "teacher_euler@2", "student_euler@3", "student_euler@2",
        "student_onestep@1"}
    assert set(art["claims"]) == {"student2_beats_naive2",
                                  "student2_within_2x_of_full_budget",
                                  "student_chain_monotone_vs_naive",
                                  "onestep_within_2x_of_full_budget"}


@pytest.mark.parametrize("mode,nsteps", [("inpaint", 6), ("repaint", 10)])
def test_inpainting_demo(mode, nsteps, tmp_path, capsys):
    _run("inpainting_demo", ["--steps", 2, "--batch", 8, "--channels", 8,
                             "--nsteps", nsteps, "--neval", 4, "--mode",
                             mode, "--outdir", tmp_path])
    assert _files(tmp_path) == sorted(["metrics.jsonl", f"{mode}.png"])
    if mode == "inpaint":
        assert "known-region max |err| = 0.00e+00" in capsys.readouterr().out


def test_anomaly_detection(tmp_path):
    _run("anomaly_detection", ["--steps", 2, "--batch", 8, "--channels", 8,
                               "--nsteps", 6, "--noise-step", 3, "--neval",
                               4, "--outdir", tmp_path])
    assert _files(tmp_path) == ["anomaly.png", "metrics.jsonl"]


def test_entropy_time_profile_and_correlations(tmp_path):
    out = tmp_path / "etp.json"
    _run("entropy_time_profile",
         ["--train-steps", "60", "--snapshot-every", "20",
          "--nsamples", "400", "--nsteps", "12", "--ngamma", "3",
          "--datasize", "200", "--batch", "64", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert set(saved) == {"dataset", "nsteps", "sigma_grid", "snapshots",
                          "note"}
    snaps = saved["snapshots"]
    assert len(snaps) == 3
    for snap in snaps.values():
        assert len(snap["gamma_values"]) == 3
        assert len(snap["sde_entropies"]) == 3
        assert len(snap["score_errors"]) == 12
        assert all(v >= 0 for v in snap["score_errors"])

    _run("correlation_thresholds",
         ["--input", str(out), "--epoch-threshold", "0",
          "--nsteps", "12", "--initial-range", "0.3", "0.9", "3",
          "--final-range", "0.05", "0.4", "3",
          "--late-range", "0.01", "0.2", "3"])
    csv_path = tmp_path / "etp.json.correlations.csv"
    rows = list(csv.DictReader(open(csv_path)))
    assert rows
    types = {r["type"] for r in rows}
    assert types == {"early_mid_vs_improvement", "late_vs_deterioration"}
    # triangular grid: every early row satisfies initial > final
    for r in rows:
        if r["type"] == "early_mid_vs_improvement":
            assert float(r["initial_threshold"]) > float(
                r["final_threshold"])
            assert int(r["step_initial"]) < int(r["step_final"])


def test_scripts_raise_without_cuda_when_cuda_is_asked(monkeypatch):
    """``--device cuda`` (the default) raises on a machine without CUDA:
    no silent CPU fallback."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_main(port("correlation_thresholds"), "correlation_thresholds",
                 ["--input", "unused.json"])


def test_eval_fid_classifier_and_inception_features(tmp_path, capsys,
                                                    monkeypatch):
    """``eval_fid``'s feature spaces other than pixels, on a checkpoint of
    a 2-step run: ``--classifier`` (a MinimalResNet directory as
    ``save_checkpoint`` writes a dict of tensors, its kwargs as the
    description) and ``--inception-weights`` (a state-dict file, here
    the synthetic weights of ``InceptionV3FID.init``). FID at d 2048 is a
    host ``sqrtm`` of ~20 s on the CPU, which ``tests/test_torch_metrics.py``
    covers: here it reads the features' 2048 columns and returns the
    squared distance of their means."""
    import diffsci_tpu_torch.metrics as metrics
    import torch
    from diffsci_tpu_torch.checkpoint import save_checkpoint
    from diffsci_tpu_torch.metrics_inception import InceptionV3FID
    from diffsci_tpu_torch.models.nets.classifiers import MinimalResNet
    from diffsci_tpu_torch.models.nets.layers import init_parameters

    _run("train_diffusion_mnist", ["--steps", 2, "--batch", 8,
                                   "--channels", 8, "--outdir",
                                   tmp_path / "run"])
    kwargs = {"out_classes": 3, "model_channels": 8, "n_layers": 2}
    clf = MinimalResNet(**kwargs, device="cpu")
    init_parameters(clf, 0)
    save_checkpoint(tmp_path / "clf", dict(clf.state_dict()),
                    description=kwargs)
    torch.save(InceptionV3FID(device="cpu").init(0).state_dict(),
               tmp_path / "inception.pt")
    common = ["--ckpt", tmp_path / "run" / "ckpt", "--nsamples", 2,
              "--batch", 2, "--nfe", 2]
    for extra, space in (
            (["--classifier", tmp_path / "clf"], "classifier"),
            (["--inception-weights", tmp_path / "inception.pt"],
             "inception_pool3")):
        capsys.readouterr()
        if space == "inception_pool3":
            monkeypatch.setattr(metrics, "fid", lambda a, b: float(
                ((a.mean(0) - b.mean(0)) ** 2).sum()) if a.shape[1] == 2048
                else np.nan)
        _run("eval_fid", common + extra)
        result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert result["feature_space"] == space
        assert np.isfinite(result["fid"]) and np.isfinite(result["kid"])


def test_entropy_time_profile_builds_its_model_on_device(tmp_path,
                                                         monkeypatch):
    """``--platform`` (the JAX script's flag, default cpu) is accepted and
    moves nothing: an invocation without it builds the study's model on
    the device ``--device`` names, here ``cpu:0``, which the CPU itself
    (``torch.device("cpu")``) does not equal."""
    import torch
    import diffsci_tpu_torch.models as models
    real, seen = models.KarrasModel, []

    def recording(*a, device=None, **kw):
        seen.append(device)
        return real(*a, device=device, **kw)

    monkeypatch.setattr(models, "KarrasModel", recording)
    run_main(port("entropy_time_profile"), "entropy_time_profile",
             ["--train-steps", "2", "--snapshot-every", "2", "--nsamples",
              "64", "--nsteps", "3", "--ngamma", "2", "--datasize", "16",
              "--batch", "8", "--out", str(tmp_path / "etp.json"),
              "--device", "cpu:0"])
    assert seen == [torch.device("cpu", 0)]
    assert len(json.loads((tmp_path / "etp.json").read_text())
               ["snapshots"]) == 1
