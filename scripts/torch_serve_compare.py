#!/usr/bin/env python3
"""Serving request times of the PyTorch port on one GPU, for comparing two
trees of it.

    python3 scripts/torch_serve_compare.py [--root DIR] [--repeats N]

Imports ``diffsci_tpu_torch`` from ``DIR`` (default: this repository),
builds its kernels and times requests through ``SamplerService`` for the
two configurations that ``chip_smoke.py`` serves, bf16, 18-step Heun,
random weights from seed 0:

- A, 3D 32³ volumes with flash attention: buckets (1, 4), requests 1, 3, 6;
- B, MNIST 28x28: buckets (1, 8, 64), requests 1, 64, 70.

After the service's warm-up each round asks every request size once, for
``--repeats`` rounds; a request's time is the host clock around
``SamplerService.sample``, which ends in a synchronize and a copy to the
host; beside it stands the process's CPU time over the same request
(``time.process_time``), which tells host work from waiting. Prints every
time, the card's name and power limit, and last one JSON line with the
median wall and CPU seconds per request size.

To compare a commit with its parent, unpack the parent's
``diffsci_tpu_torch`` into a git-ignored directory and run parent, change,
change, parent in one call on one card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
NSTEPS = 18


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=pathlib.Path, default=REPO,
                        help="directory holding the diffsci_tpu_torch to "
                             "time")
    parser.add_argument("--repeats", type=int, default=7)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_compare: CUDA is not available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import diffsci_tpu_torch
    from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                                   PUNetGConfig, SamplerService)
    from diffsci_tpu_torch import kernels

    pkg = pathlib.Path(diffsci_tpu_torch.__file__).resolve().parent
    if pkg.parent != root:
        raise RuntimeError(f"imported {pkg}, not the one under {root}")
    kernels.build()
    configs = {
        "A": (PUNetGConfig(dimension=3, model_channels=32,
                           channel_expansion=[2], num_heads=2,
                           attn_backend="flash"),
              (32, 32, 32, 1), (1, 4), (1, 3, 6)),
        "B": (PUNetGConfig(model_channels=64, channel_expansion=[2, 4]),
              (28, 28, 1), (1, 8, 64), (1, 64, 70)),
    }
    medians, cpu_medians = {}, {}
    for label, (cfg, shape, buckets, sizes) in configs.items():
        model = KarrasModel(PUNetG(cfg), KarrasModelConfig.from_edm(),
                            compute_dtype=torch.bfloat16)
        model.init(seed=0)
        svc = SamplerService(model, shape, batch_buckets=buckets,
                             nsteps=NSTEPS, seed=0)
        svc.warmup()
        times = {n: [] for n in sizes}
        cpu = {n: [] for n in sizes}
        for _ in range(args.repeats):
            for n in sizes:
                t0, c0 = time.perf_counter(), time.process_time()
                out = svc.sample(n)
                times[n].append(time.perf_counter() - t0)
                cpu[n].append(time.process_time() - c0)
                if out.shape != (n,) + shape or not np.isfinite(out).all():
                    raise AssertionError(f"{label}: request of {n} gave "
                                         f"shape {out.shape} or non-finite "
                                         "values")
        for n in sizes:
            medians[f"{label}{n}"] = statistics.median(times[n])
            cpu_medians[f"{label}{n}"] = statistics.median(cpu[n])
            print(f"[{label}] request {n}: median "
                  f"{medians[f'{label}{n}']:.4f} s over {args.repeats}: "
                  f"{[round(t, 4) for t in times[n]]}; CPU median "
                  f"{cpu_medians[f'{label}{n}']:.4f} s", flush=True)
        del model, svc
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"root": str(root), "median_s": medians,
                      "cpu_median_s": cpu_medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
