"""The case of ``tests/test_torch_scripts_mp.py`` that runs in each gloo
rank (``tests/_torch_ranks.py``; torch only, no JAX):
``train_diffusion_mnist --n-devices 2`` in-process, as ``torchrun`` runs
it, every rank writing into the same output directory (rank 0 writes)."""

from __future__ import annotations

import diffsci_tpu_torch.models as models
from tests._torch_ranks import cases
from tests._torch_scripts_util import port, run_main
from tests._torch_steps import PIN_ADAM_EPS


def pin_default_optimizer(learning_rate=1e-3, weight_decay=1e-4,
                          grad_clip=0.5):
    """The recipe's AdamW at the pins' eps (``tests/_torch_steps.py``:
    at eps 1e-8 a rounding-level gradient, such as the key projection's
    bias under the softmax, moves its parameter by up to ±lr in any
    other summation order)."""
    from diffsci_tpu_torch.models.karras.train import AdamWClip
    return AdamWClip(learning_rate, weight_decay, 0.9, 0.999, grad_clip,
                     eps=PIN_ADAM_EPS)


def case_mnist(rank, world, p):
    models.default_optimizer = pin_default_optimizer
    run_main(port("train_diffusion_mnist"), "train_diffusion_mnist",
             p["args"] + ["--n-devices", str(world), "--outdir", p["outdir"],
                          "--device", "cpu"])
    return {"rank": rank}


def run(rank, world, payload):
    return cases({"mnist": case_mnist}, rank, world, payload)
