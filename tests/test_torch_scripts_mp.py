"""``train_diffusion_mnist --n-devices 2`` (data parallelism over two gloo
ranks on the CPU, ``tests/_torch_ranks.py``, as ``torchrun
--nproc-per-node 2`` runs the script) writes one checkpoint, which holds
the single-process run of the same global batch within
``tests/test_torch_parallel.py``'s bounds (parameters and EMA shadows
rtol 1e-4 atol 1e-6; the logged losses rtol 1e-5) and restores into a
world-1 state. Both runs take the recipe's AdamW at the pins' eps
(``tests/_torch_scripts_cases.pin_default_optimizer``)."""

import json

import numpy as np
import torch

from tests import _torch_warmup  # noqa: F401  (MKL's first exp)
from tests._torch_ranks import result, run_ranks
from tests._torch_scripts_util import parser_of, port, run_main

ARGS = ["--steps", "3", "--batch", "8", "--channels", "8"]


def test_mnist_two_ranks_match_one_process(tmp_path, monkeypatch):
    import diffsci_tpu_torch.models as models
    from tests._torch_scripts_cases import pin_default_optimizer
    monkeypatch.setattr(models, "default_optimizer", pin_default_optimizer)
    from diffsci_tpu_torch.checkpoint import load_state, restore_checkpoint
    from diffsci_tpu_torch.models import create_train_state
    two, one = tmp_path / "two", tmp_path / "one"
    res = run_ranks("tests._torch_scripts_cases", 2,
                    {"args": ARGS, "outdir": str(two)})
    for rank in range(2):
        result(res, "mnist", rank)
    mod = port("train_diffusion_mnist")
    run_main(mod, "train_diffusion_mnist",
             ARGS + ["--outdir", str(one), "--device", "cpu"])

    a, b = load_state(two / "ckpt"), load_state(one / "ckpt")
    assert set(a) == set(b) and int(a["step"]) == int(b["step"]) == 3
    for k, v in b.items():
        if k.startswith(("params/", "ema/")) and v.is_floating_point():
            np.testing.assert_allclose(a[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    logs = [[json.loads(r) for r in (d / "metrics.jsonl").read_text()
             .splitlines()] for d in (two, one)]
    assert len(logs[0]) == len(logs[1])
    for ra, rb in zip(*logs):
        for key in ("train_loss", "grad_norm", "valid_loss"):
            if key in rb:
                np.testing.assert_allclose(ra[key], rb[key], rtol=1e-5,
                                           err_msg=key)
    assert (two / "samples.npy").exists()
    assert json.loads((two / "ckpt" / "description.json").read_text()) == \
        json.loads((one / "ckpt" / "description.json").read_text())

    # the two-rank checkpoint restores into a world-1 state
    model, ema, tx = mod.build(parser_of(mod).parse_args(
        ARGS + ["--device", "cpu"]), "cpu")
    template, _ = create_train_state(model, (8, 28, 28, 1), seed=None,
                                     optimizer=tx, ema=ema)
    restore_checkpoint(two / "ckpt", template, model)
    assert template.step == 3
    for k, p in template.params.items():
        torch.testing.assert_close(p.detach(), a[f"params/{k}"], rtol=0,
                                   atol=0)
