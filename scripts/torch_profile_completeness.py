#!/usr/bin/env python3
"""How often a torch.profiler trace of one served request of the PyTorch
port misses device kernels, on one GPU.

    python3 scripts/torch_profile_completeness.py [--traces N]

Builds the port's kernels and serves configuration B (MNIST 28x28, the
PUNetG that ``chip_smoke.py`` serves: 64 channels, expansion [2, 4]; f32,
TF32 off, random weights from seed 0) from one CUDA graph at bucket 64,
an 18-step Heun sample of 64 images. Then it takes ``N`` traces of the
same request (seed 2), each in its own ``torch.profiler.profile`` session
with CPU and CUDA activities, exports each as a Chrome trace and reads it
back with ``diffsci_tpu_torch.profiling``. Every request replays the same
graph, so every complete trace holds the same kernels. For each trace it
prints the number of device kernels, K1's (``axby_kernel``) and K2's
(``norm_silu``) rows, and the launch counter's K1 and K2. Prints the
card's name and power limit, and last one JSON line: how many traces held
each kernel total, and how many disagreed with the launch counter.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig,  # noqa: E402
                               PUNetG, PUNetGConfig, SamplerService, kernels,
                               profiling)

K2_NAMES = ("norm_silu_rows", "norm_silu_cluster", "norm_silu")


def read(path: str) -> tuple[int, int, int]:
    """(device kernels, K1 rows, K2 rows) of a Chrome trace."""
    rows = profiling.op_summary(profiling.parse_trace(path), "cuda",
                                line=profiling.KERNEL)
    k1 = sum(r["count"] for r in rows if "axby_kernel" in r["name"])
    k2 = sum(r["count"] for r in rows
             if any(n in r["name"] for n in K2_NAMES))
    return sum(r["count"] for r in rows), k1, k2


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser()
    parser.add_argument("--traces", type=int, default=60)
    args = parser.parse_args()
    kernels.load_all()
    torch.backends.cudnn.allow_tf32 = False
    cfg = PUNetGConfig(model_channels=64, channel_expansion=[2, 4])
    model = KarrasModel(PUNetG(cfg), KarrasModelConfig.from_edm())
    model.net.load_state_dict(KarrasModel(
        PUNetG(cfg, device="cpu"), KarrasModelConfig.from_edm(),
        device="cpu").init(seed=0))
    svc = SamplerService(model, (28, 28, 1), batch_buckets=(64,))
    svc.warmup()
    svc.sample(64, 1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"torch {torch.__version__} on {card}", flush=True)
    totals = collections.Counter()
    disagree = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "request.pt.trace.json")
        for i in range(args.traces):
            kernels.reset_launches()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                svc.sample(64, 2)
                torch.cuda.synchronize()
            c = dict(kernels.LAUNCHES)
            prof.export_chrome_trace(path)
            total, k1, k2 = read(path)
            totals[total] += 1
            same = (k1, k2) == (c["fused_axby"], c["norm_silu"])
            disagree += not same
            print(f"trace {i}: {total} kernels, K1 rows {k1}, K2 rows {k2};"
                  f" launch counter {c['fused_axby']}, {c['norm_silu']}"
                  f"{'' if same else ' DIFFER'}", flush=True)
    print(card)
    print(json.dumps({"traces": args.traces,
                      "kernel_totals": {str(k): n for k, n in
                                        sorted(totals.items())},
                      "k1_k2_differ_from_counter": disagree}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
