#!/usr/bin/env python3
"""Time variants of K2 (norm + SiLU forward) and K3 (its backward) on one
GPU.

Run from the repository root, with one NVIDIA Hopper card (H100):

    python3 scripts/torch_norm_variants.py [--parent PATH/fused_norm.cu ...]

Each variant builds ``diffsci_tpu_torch/csrc/fused_norm.cu`` with one nvcc
-D flag over the committed defaults of its launch choices, which K2 and K3
share: the longest row that a warp takes (``NORM_WARP_ROW_MAX``), the bytes
a rows-kernel block holds of each array (``NORM_ROWS_BLOCK_BYTES``), the 16-byte words
a lane takes beyond 16 lanes a row (``NORM_WORDS_PER_LANE``), the longest
row that one CTA takes (``NORM_BLOCK_ROW_MAX``), the waves of CTAs the
cluster split aims at beyond it (``NORM_FILL_WAVES``) and the threads of a
cluster CTA (``NORM_SLICE_THREADS``); ``--parent`` adds other versions of the
source (earlier commits', with the same C interface) as variants
"parent <file name>". All are built at once under ``diffsci_tpu_torch/_build/variants/``
(the committed one with ``-Xptxas -v``, whose register and spill counts are
printed), checked against the plain versions and timed in bf16 'ln': K2 at
the norms of configurations A (32³ and 16³ rows, batches 1 and 4) and B
(28², 14², 7² rows, batches 64 and 256); K3 at the norms of A's and B's
train steps (batches 4 and 256), with its L2 warm (the same inputs launch
after launch) and cold (a 128 MB buffer written between launches, more
than the 50 MB L2). A time is the device time of one launch
(torch.profiler over 50 launches, only the kernel's own), two rounds in
turn. The card's name, power limit and maximum SM clock come first, and
each shape's least time by its bytes.
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

VARIANTS = {"committed": (), "1 word a lane": ("-DNORM_WORDS_PER_LANE=1",),
            "clusters from 1024": ("-DNORM_BLOCK_ROW_MAX=1024",),
            "fill 2 waves": ("-DNORM_FILL_WAVES=2",),
            "slice 512 threads": ("-DNORM_SLICE_THREADS=512",),
            "rows block 16 KB": ("-DNORM_ROWS_BLOCK_BYTES=16384",)}
K2_SHAPES = ((1, 32, 32, 32, 32), (4, 32, 32, 32, 32), (1, 64, 16, 16, 16),
             (4, 64, 16, 16, 16), (64, 64, 28, 28), (64, 128, 14, 14),
             (64, 256, 7, 7), (256, 64, 28, 28), (256, 128, 14, 14),
             (256, 256, 7, 7))
K3_SHAPES = ((256, 64, 28, 28), (256, 128, 14, 14), (256, 256, 7, 7),
             (4, 32, 32, 32, 32), (4, 64, 16, 16, 16))
ITERS = 50


def build(variants: dict, stem: str, signatures: dict) -> dict:
    """Build every variant {name: (source, defines)} of the library
    ``stem``, one nvcc each, all at once, and load it with
    ``signatures``: {name: library}."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, (source, defines)) in enumerate(variants.items()):
        so = out_dir / f"{stem}-{i}.so"
        verbose = ("-Xptxas", "-v") if name == "committed" else ()
        jobs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *defines, *verbose, "-I",
             str(_build.CSRC_DIR), "-o", str(so), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name == "committed":
            print("\n".join(line for line in log.splitlines()
                            if "registers" in line or "spill" in line
                            or "Compiling entry" in line), flush=True)
        libs[name] = _build.open_library(so, signatures)
    return libs


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", nargs="+", default=[],
                        help="other versions of fused_norm.cu to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_norm_variants: needs a CUDA card", file=sys.stderr)
        return 2
    source = _build.CSRC_DIR / "fused_norm.cu"
    variants = {name: (source, d) for name, d in VARIANTS.items()}
    variants = {**{f"parent {pathlib.Path(path).name}": (pathlib.Path(path), ())
                   for path in args.parent}, **variants}
    libs = build(variants, "fused_norm", fn._SIGNATURES)
    print(chip_smoke.smi("name,power.limit,clocks.max.sm"), flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def norm_inputs(shape):
        C = shape[1]
        x = chip_smoke.randn(shape, torch.bfloat16, gen, 2.0, 0.3)
        w = chip_smoke.randn((C,), torch.bfloat16, gen, 0.2, 1.0)
        b = chip_smoke.randn((C,), torch.bfloat16, gen, 0.1)
        return x, w, b

    k2_inputs = []
    for shape in K2_SHAPES:
        x, w, b = norm_inputs(shape)
        k2_inputs.append((x, w, b, fn.norm_silu_plain(x, w, b, "ln")[0]))
    k3_inputs = []
    for shape in K3_SHAPES:
        x, w, b = norm_inputs(shape)
        g = chip_smoke.randn(shape, torch.bfloat16, gen)
        _, mean, rstd = fn.norm_silu_plain(x, w, b, "ln")
        k3_inputs.append((g, x, mean, rstd, w, b, fn.norm_silu_bwd_plain(
            g, x, mean, rstd, w, b, "ln")))

    def bound_us(nbytes):
        return 1e3 * chip_smoke.bound(nbytes, 0, torch.float32)[0]

    print("device µs per launch, bf16 'ln'. K2 bound (bytes: x, y): "
          + "  ".join("{} {:.2f}".format(list(s), bound_us(4 * i[0].numel()))
                      for s, i in zip(K2_SHAPES, k2_inputs)), flush=True)
    print("K3 bound (bytes: g, x, dx): " + "  ".join(
        "{} {:.2f}".format(list(s), bound_us(6 * i[0].numel()))
        for s, i in zip(K3_SHAPES, k3_inputs)), flush=True)

    def k2_us(name, lib):
        times = []
        for shape, (x, w, b, ref) in zip(K2_SHAPES, k2_inputs):
            B, C = shape[:2]
            S = x.numel() // (B * C)
            y = torch.empty_like(x)
            mean = torch.empty((B, C), device="cuda")
            rstd = torch.empty((B, C), device="cuda")

            def launch():
                _build.check(lib, lib.norm_silu_fwd_launch(
                    x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), B * C, C, S, 1, 1e-5, 1,
                    fn._threads(S), stream), name)

            launch()
            torch.cuda.synchronize()
            err, ok = chip_smoke.within(y, ref, torch.bfloat16, 0)
            if not ok:
                raise AssertionError(f"K2 {name} {shape}: max|Δ| {err}")
            times.append(chip_smoke.device_ms(launch, ITERS) * 1e3)
        return times

    def k3_us(name, lib):
        warm, cold = [], []
        for shape, (g, x, mean, rstd, w, b, ref) in zip(K3_SHAPES, k3_inputs):
            B, C = shape[:2]
            S = x.numel() // (B * C)
            dx = torch.empty_like(x)
            dwp = torch.empty((B, C), device="cuda")
            dbp = torch.empty((B, C), device="cuda")

            def launch():
                _build.check(lib, lib.norm_silu_bwd_launch(
                    g.data_ptr(), x.data_ptr(), mean.data_ptr(),
                    rstd.data_ptr(), w.data_ptr(), b.data_ptr(),
                    dx.data_ptr(), dwp.data_ptr(), dbp.data_ptr(), B * C, C,
                    S, 1, 1, fn._threads(S), stream), name)

            launch()
            torch.cuda.synchronize()
            err, ok, ratio = chip_smoke.within_grad(
                (dx, dwp.sum(0).bfloat16(), dbp.sum(0).bfloat16()), ref,
                torch.bfloat16)
            if not ok:
                raise AssertionError(f"K3 {name} {shape}: max|Δ|/max|ref| "
                                     f"{ratio}")
            warm.append(chip_smoke.device_ms(launch, ITERS) * 1e3)
            cold.append(chip_smoke.cold_device_ms(
                launch, ITERS, chip_smoke.NORM_KERNELS["K3"]) * 1e3)
        return warm, cold

    for rnd in range(2):
        for name, lib in libs.items():
            k2 = k2_us(name, lib)
            warm, cold = k3_us(name, lib)
            print(f"round {rnd} {name:28s} K2 " + " ".join(
                f"{t:7.2f}" for t in k2) + " | K3 warm " + " ".join(
                f"{t:7.2f}" for t in warm) + " | cold " + " ".join(
                f"{t:7.2f}" for t in cold), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
