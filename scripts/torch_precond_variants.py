#!/usr/bin/env python3
"""Time variants of K1 (``fused_axby``) and K7 (``fused_lincomb3``) on one
GPU.

Run from the repository root, with one NVIDIA Hopper card (H100):

    python3 scripts/torch_precond_variants.py [--parent PATH/fused_precondition.cu ...]

Each variant builds ``diffsci_tpu_torch/csrc/fused_precondition.cu`` with
one nvcc -D flag over the committed defaults of the launch choices that
K1 and K7 share: the bytes of x a thread combines (``PRECOND_X_BYTES``,
one 16-byte word: 4 f32 elements), the most threads of a CTA
(``PRECOND_THREADS``) and the CTAs a launch aims at (``PRECOND_CTAS``; 1
gives each row the fewest CTAs); ``--parent`` adds other
versions of the source (earlier commits', with the same C interface, e.g.
``git show <commit>:diffsci_tpu_torch/csrc/fused_precondition.cu``) as
variants "parent <file name>". All are built at once under
``diffsci_tpu_torch/_build/variants/`` (the committed one with
``-Xptxas -v``, whose register and spill counts are printed), checked bit
for bit against the plain versions, and timed in float32, the main
paths' dtype: K1 at configuration A's serving buckets 1 and 4
([1|4, 32, 32, 32, 1]) and B's 1, 8 and 64 ([1|8|64, 28, 28, 1]), K7 at
configuration C's buckets 1 and 16 ([1|16, 32, 32, 3]), and each at its
byte-bound shape (K1 [8, 1, 128, 128, 128], K7 [64, 3, 256, 256]). A time
is the device time of one launch (torch.profiler over 200 launches, 20 at
the byte-bound shapes, only the kernel's own), two rounds in turn. The
card's name, power limit and maximum SM clock come first, then each
shape's least time by its bytes.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from diffsci_tpu_torch.kernels import _build  # noqa: E402
from diffsci_tpu_torch.kernels import fused_precondition as fp  # noqa: E402
from torch_norm_variants import build  # noqa: E402

VARIANTS = {"committed": (), "32 bytes of x": ("-DPRECOND_X_BYTES=32",),
            "aim at 32 CTAs": ("-DPRECOND_CTAS=32",),
            "aim at 132 CTAs": ("-DPRECOND_CTAS=132",),
            "fewest CTAs of <= 256": ("-DPRECOND_CTAS=1",
                                      "-DPRECOND_THREADS=256"),
            "fewest CTAs of <= 128": ("-DPRECOND_CTAS=1",
                                      "-DPRECOND_THREADS=128")}
# (kernel, C entry point, kernel name in the trace, shapes)
KERNELS = (("K1", "axby_launch", "axby_kernel",
            chip_smoke.COMBINE_TIMED["fused_axby"]
            + (chip_smoke.COMBINES["fused_axby"][1],)),
           ("K7", "lincomb3_launch", "lincomb3_kernel",
            chip_smoke.COMBINE_TIMED["fused_lincomb3"]
            + (chip_smoke.COMBINES["fused_lincomb3"][1],)))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", nargs="+", default=[],
                        help="other versions of fused_precondition.cu to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_precond_variants: needs a CUDA card", file=sys.stderr)
        return 2
    source = _build.CSRC_DIR / "fused_precondition.cu"
    variants = {name: (source, d) for name, d in VARIANTS.items()}
    variants = {**{f"parent {pathlib.Path(path).name}": (pathlib.Path(path), ())
                   for path in args.parent}, **variants}
    libs = build(variants, "fused_precondition", fp._SIGNATURES)
    print(chip_smoke.smi("name,power.limit,clocks.max.sm"), flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    cases = []        # (kernel, entry, trace name, shape, tensors, coeffs,
    for kernel, entry, trace, shapes in KERNELS:        # out, reference)
        k = 2 if kernel == "K1" else 3
        plain = fp.fused_axby_plain if k == 2 else fp.fused_lincomb3_plain
        for shape in shapes:
            tensors = [chip_smoke.randn(shape, torch.float32, gen)
                       for _ in range(k)]
            coeffs = [chip_smoke.randn(shape[0], torch.float32, gen)
                      for _ in range(k)]
            cases.append((kernel, entry, trace, shape, tensors, coeffs,
                          torch.empty_like(tensors[0]),
                          plain(*tensors, *coeffs)))
    bounds = (1e3 * chip_smoke.bound(4 * (len(ts) + 1) * ts[0].numel(), 0,
                                     torch.float32)[0]
              for _, _, _, _, ts, _, _, _ in cases)
    print("device µs per launch, float32; bound (bytes: each operand read, "
          "out written): " + "  ".join(
              f"{case[0]} {list(case[3])} {us:.3f}"
              for case, us in zip(cases, bounds)), flush=True)

    def times(name, lib):
        out_us = []
        for kernel, entry, trace, shape, tensors, coeffs, out, ref in cases:
            n = tensors[0].numel()

            def launch():
                _build.check(lib, getattr(lib, entry)(
                    *(t.data_ptr() for t in tensors),
                    *(c.data_ptr() for c in coeffs), out.data_ptr(),
                    n // shape[0], n, *([0] * len(tensors)), stream), name)

            out.fill_(float("nan"))
            launch()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"{kernel} {name} {list(shape)}: "
                                     "not bit for bit the plain version")
            iters = 20 if n >= 2 ** 23 else 200
            out_us.append(chip_smoke.device_ms(launch, iters, (trace,)) * 1e3)
        return out_us

    for rnd in range(2):
        for name, lib in libs.items():
            print(f"round {rnd} {name:32s} " + " ".join(
                f"{t:8.3f}" for t in times(name, lib)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
