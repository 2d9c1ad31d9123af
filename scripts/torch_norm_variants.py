#!/usr/bin/env python3
"""Time variants of K2 (norm + SiLU forward) on one GPU.

Run from the repository root, with one NVIDIA Hopper card (H100):

    python3 scripts/torch_norm_variants.py [--parent PATH/fused_norm.cu]

Each variant builds ``diffsci_tpu_torch/csrc/fused_norm.cu`` with one nvcc
-D flag over the committed defaults of its launch choices: the longest row
that a warp takes (``NORM_WARP_ROW_MAX``), the bytes of x a rows-kernel
block aims at (``NORM_ROWS_BLOCK_BYTES``), the 16-byte words of a row per
lane (``NORM_WORDS_PER_LANE``), the waves of CTAs the cluster split aims
at (``NORM_FILL_WAVES``) and the threads of a cluster CTA
(``NORM_SLICE_THREADS``); ``--parent`` adds another version of the source
(an earlier commit's, with the same C interface) as the variant "parent".
All are built at once under ``diffsci_tpu_torch/_build/variants/``,
checked against the plain version and timed in bf16 'ln' at the norms of
configurations A (32³ and 16³ rows, batches 1 and 4) and B (28², 14², 7²
rows, batches 64 and 256): the device time of one launch (torch.profiler
over 50 launches), two rounds in turn. The card's name, power limit and
maximum SM clock come first.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from diffsci_tpu_torch.kernels import _build  # noqa: E402
from diffsci_tpu_torch.kernels import fused_norm as fn  # noqa: E402

VARIANTS = {"committed": (), "fill 1 wave": ("-DNORM_FILL_WAVES=1",),
            "fill 4 waves": ("-DNORM_FILL_WAVES=4",),
            "slice 128 threads": ("-DNORM_SLICE_THREADS=128",),
            "slice 512 threads": ("-DNORM_SLICE_THREADS=512",),
            "2 words a lane": ("-DNORM_WORDS_PER_LANE=2",),
            "warp rows to 4096": ("-DNORM_WARP_ROW_MAX=4096",),
            "rows block 16 KB": ("-DNORM_ROWS_BLOCK_BYTES=16384",)}
SHAPES = ((1, 32, 32, 32, 32), (4, 32, 32, 32, 32), (1, 64, 16, 16, 16),
          (4, 64, 16, 16, 16), (64, 64, 28, 28), (64, 128, 14, 14),
          (64, 256, 7, 7), (256, 64, 28, 28), (256, 128, 14, 14),
          (256, 256, 7, 7))


def build(variants: dict) -> dict:
    """Build every variant {name: (source, defines)}: {name: library}."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, (source, defines)) in enumerate(variants.items()):
        so = out_dir / f"fused_norm-{i}.so"
        jobs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-I",
             str(_build.CSRC_DIR), "-o", str(so), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = _build.open_library(so, fn._SIGNATURES)
    return libs


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="another fused_norm.cu to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_norm_variants: needs a CUDA card", file=sys.stderr)
        return 2
    source = _build.CSRC_DIR / "fused_norm.cu"
    variants = {name: (source, d) for name, d in VARIANTS.items()}
    if args.parent:
        variants = {"parent": (pathlib.Path(args.parent), ()), **variants}
    libs = build(variants)
    print(chip_smoke.smi("name,power.limit,clocks.max.sm"), flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    inputs = []
    for shape in SHAPES:
        C = shape[1]
        x = chip_smoke.randn(shape, torch.bfloat16, gen, 2.0, 0.3)
        w = chip_smoke.randn((C,), torch.bfloat16, gen, 0.2, 1.0)
        b = chip_smoke.randn((C,), torch.bfloat16, gen, 0.1)
        inputs.append((x, w, b, fn.norm_silu_plain(x, w, b, "ln")[0]))
    print("device µs per launch, bf16 'ln'; bound (bytes): " + "  ".join(
        "{} {:.2f}".format(list(shape), 1e3 * chip_smoke.bound(
            4 * x.numel(), 0, torch.float32)[0])
        for shape, (x, *_) in zip(SHAPES, inputs)), flush=True)
    for rnd in range(2):
        for name, lib in libs.items():
            times = []
            for shape, (x, w, b, ref) in zip(SHAPES, inputs):
                B, C = shape[:2]
                S = x.numel() // (B * C)
                y = torch.empty_like(x)
                mean = torch.empty((B, C), device="cuda")
                rstd = torch.empty((B, C), device="cuda")

                def launch():
                    _build.check(lib, lib.norm_silu_fwd_launch(
                        x.data_ptr(), w.data_ptr(), b.data_ptr(),
                        y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                        B * C, C, S, 1, 1e-5, 1, fn._threads(S), stream),
                        name)

                launch()
                torch.cuda.synchronize()
                err, ok = chip_smoke.within(y, ref, torch.bfloat16, 0)
                if not ok:
                    raise AssertionError(f"{name} {shape}: max|Δ| {err}")
                times.append(chip_smoke.device_ms(launch, 50) * 1e3)
            print(f"round {rnd} {name:18s} " + "  ".join(
                f"{t:7.2f}" for t in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
