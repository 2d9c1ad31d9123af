#!/usr/bin/env python3
"""Device times of configurations H and I of the PyTorch port on one GPU,
for comparing two trees of it.

    python3 scripts/torch_zoo_compare.py [--root DIR]

Imports ``chip_smoke`` and ``diffsci_tpu_torch`` from ``DIR`` (default:
this repository), builds its kernels and runs ``chip_smoke.full_width``
for H (DiT at DiT-B's widths, 12 heads of 64: the d ≤ 128 flash kernels)
and I (ADM's defaults, one head of 256: the wide ones) as phases 25 and
26 of ``chip_smoke.py`` do, cut to bucket 4 and 5 graphed train steps
after 2 warm-up steps: a profiled request's and step's device time and
their K4–K6 share, with the exact launch counts checked. Prints the
card's name and power limit, and last one JSON line with the device
seconds.

To compare a commit with its parent, unpack the parent's tree into a
git-ignored directory (``git archive``) and run parent, change, change,
parent in one call on one card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import re
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=pathlib.Path, default=REPO,
                        help="directory holding the chip_smoke.py and "
                             "diffsci_tpu_torch to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_zoo_compare: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    import chip_smoke
    from diffsci_tpu_torch import kernels

    kernels.load_all()
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    nb = chip_smoke.H_WIDTHS["nblocks"]
    nfe = chip_smoke.NFE
    configs = {"H": (chip_smoke.model_h,
                     dict(fused_axby=nfe, flash_attention=nb * nfe),
                     dict(flash_attention=nb, flash_attention_dq=nb,
                          flash_attention_dkv=nb)),
               "I": (chip_smoke.model_i,
                     dict(fused_axby=nfe, flash_attention=nfe),
                     dict(flash_attention=1, flash_attention_dq=1,
                          flash_attention_dkv=1))}
    result = {}
    for label, (make, per_request, per_step) in configs.items():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            chip_smoke.full_width(label, make, zero, per_request, per_step,
                                  steps=5, warmup=2, buckets=(4,),
                                  eager_check=False)
        text = out.getvalue()
        print(text, end="", flush=True)
        device = [float(x) for x in re.findall(r"device ([0-9.]+) s", text)]
        result[label] = {"request_device_s": device[0],
                         "step_device_s": device[1]}
    print(chip_smoke.smi("name,power.limit"))
    print(json.dumps({"root": str(args.root), **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
