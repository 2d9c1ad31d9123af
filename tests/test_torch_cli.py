"""``python -m diffsci_tpu_torch``: ``info``, ``sample`` (``--out``,
``--grid``, ``--seed``), the ``serve`` flow over ``build_server`` and
``profile`` on a torch.profiler trace, with ``--device cpu`` (after
``tests/test_cli.py``, ``tests/test_serve_http.py`` and
``tests/test_profiling.py``). The checkpoint is a small PUNetG after one
train step, saved with ``save_checkpoint``."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from diffsci_tpu_torch import (EMATracker, KarrasModel, KarrasModelConfig,
                               PUNetG, PUNetGConfig, SamplerService,
                               create_train_state, make_train_step,
                               profiling, save_checkpoint)
from diffsci_tpu_torch.cli import main
from diffsci_tpu_torch.serving import build_server
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)

_SMALL = dict(model_channels=8, channel_expansion=(2,),
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=1, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1, num_heads=2)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "ckpt"
    model = KarrasModel(PUNetG(PUNetGConfig(**_SMALL), device="cpu"),
                        KarrasModelConfig.from_edm(loss_metric="mse"),
                        device="cpu")
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05])
    state, tx = create_train_state(model, (4, 8, 8, 1), seed=0, ema=tracker)
    step = make_train_step(model, tx, ema=tracker)
    g = torch.Generator().manual_seed(1)
    step(state, torch.randn((4, 8, 8, 1), generator=g), generator=g)
    save_checkpoint(path, state, description=model.export_description())
    return str(path)


def test_cli_info(ckpt, tmp_path, capsys):
    assert main(["info", "--ckpt", ckpt]) == 0
    desc = json.loads(capsys.readouterr().out)
    assert desc["config_description"]["tag"] == "edm"
    assert main(["info", "--ckpt", str(tmp_path)]) == 1


def test_cli_sample(ckpt, tmp_path, capsys):
    """``sample --seed`` writes what the in-process service gives for that
    seed, bit for bit, and a PNG grid (no matplotlib); without
    ``--device`` on a machine with no card it raises, falling back to
    nothing."""
    out, grid = tmp_path / "s.npy", tmp_path / "grid.png"
    rc = main(["sample", "--ckpt", ckpt, "--shape", "8", "8", "1",
               "--nsamples", "5", "--seed", "3", "--nsteps", "4",
               "--out", str(out), "--grid", str(grid), "--device", "cpu"])
    assert rc == 0
    arr = np.load(out)
    assert arr.shape == (5, 8, 8, 1) and np.isfinite(arr).all()
    svc = SamplerService.from_checkpoint(ckpt, (8, 8, 1), ema_stds=[0.05],
                                         batch_buckets=(5,), nsteps=4,
                                         device="cpu")
    np.testing.assert_array_equal(arr, svc.sample(5, 3))
    assert grid.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "wrote" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["sample", "--ckpt", ckpt, "--shape", "8", "8", "1",
                  "--nsamples", "1", "--out", str(out)])


def _request(url, obj=None):
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("window_ms", [0.0, 5.0])
def test_serve_flow(ckpt, window_ms):
    """``serve``'s wiring in-process: ``from_checkpoint``, warm-up,
    ``build_server`` on port 0: ``/healthz``, a seeded ``/sample`` equal
    to the service's request of that seed, a 400 for ``nsamples`` out of
    range (and still serving), ``/stats``."""
    svc = SamplerService.from_checkpoint(ckpt, (8, 8, 1), ema_stds=[0.05],
                                         batch_buckets=(4,), nsteps=4,
                                         batch_window_ms=window_ms,
                                         device="cpu")
    svc.warmup()
    server = build_server(svc, port=0, max_nsamples=8)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        code, health = _request(base + "/healthz")
        assert code == 200 and health["ok"]
        code, out = _request(base + "/sample", {"nsamples": 3, "seed": 1})
        assert code == 200 and out["shape"] == [3, 8, 8, 1]
        np.testing.assert_array_equal(np.asarray(out["samples"], np.float32),
                                      svc.sample(3, 1))
        for bad in ({"nsamples": 9}, {"nsamples": -1}, {"seed": "x"}):
            code, err = _request(base + "/sample", bad)
            assert code == 400 and "error" in err
        assert _request(base + "/healthz")[0] == 200
        code, stats = _request(base + "/stats")
        assert code == 200 and stats["requests"] >= 2
        assert _request(base + "/nothing")[0] == 404
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_cli_profile(tmp_path, capsys):
    """``profile`` on a CPU torch.profiler Chrome trace: the host plane
    holds ``aten::mm`` with its call count; the busy fraction is a
    fraction; a trace without kernels has a device busy fraction of 0."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones((128, 128))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            torch.mm(x, x)
    path = tmp_path / "run" / "trace.pt.trace.json"
    path.parent.mkdir()
    prof.export_chrome_trace(str(path))
    assert profiling.find_trace(str(tmp_path)) == str(path)
    trace = profiling.parse_trace(str(path))
    rows = profiling.op_summary(trace, plane="cpu")
    mm = [r for r in rows if r["name"] == "aten::mm"]
    assert mm and mm[0]["count"] == 3 and mm[0]["total_us"] > 0
    assert abs(sum(r["pct"] for r in rows) - 100.0) < 1e-6
    assert 0.0 < profiling.device_busy_fraction(trace, plane="cpu") <= 1.0
    assert profiling.device_busy_fraction(trace) == 0.0
    assert profiling.plane_overview(trace)[0]["busy_ms"] > 0
    assert main(["profile", str(tmp_path), "--plane", "cpu",
                 "--overview"]) == 0
    printed = capsys.readouterr().out
    assert "aten::mm" in printed and "busy fraction (cpu)" in printed
    with pytest.raises(ValueError):
        profiling.op_summary(trace, plane="tpu")
