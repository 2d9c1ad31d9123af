#!/usr/bin/env python3
"""Check and time the flash kernels at head dims above 128 on one GPU.

Run from the repository root, with one NVIDIA Hopper card (H100):

    python3 scripts/torch_flash_wide.py

Builds the flash sources of ``diffsci_tpu_torch/csrc`` once more with
``-Xptxas -v`` under ``diffsci_tpu_torch/_build/wide/`` and prints the
registers and spills of the wide kernels (head dims above 128); holds
K4, K5 and K6 in float32 and bfloat16 against their plain versions
(``chip_smoke.py``'s tolerances) at head dims 200, 256, 260 and 512 and
at a few d ≤ 128 shapes, each bf16 result twice for the same bits; then
times K4, K5 and K6 in bf16 beside SDPA's flash backend (where it takes
the head dim) at configuration I's shapes (ADM: one head of 256, buckets
and train batch), H's (DiT-B: 12 heads of 64) and a head dim of 512. The
card's name and power limit come last. Exits 1 if a check fails.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from diffsci_tpu_torch.kernels import _build  # noqa: E402
from diffsci_tpu_torch.kernels import flash_attention as fa  # noqa: E402

CHECKED = ((1, 2, 2048, 256), (1, 2, 2048, 512), (2, 1, 2049, 200),
           (1, 1, 2111, 260), (4, 1, 4096, 256), (1, 2, 4096, 32),
           (1, 1, 2111, 128), (1, 2, 2048, 20))
TIMED = ((4, 1, 4096, 256), (4, 12, 4096, 64), (8, 1, 4096, 256),
         (1, 2, 2048, 512), (4, 2, 4096, 32))


def ptxas_report() -> None:
    out_dir = _build.BUILD_DIR / "wide"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in ("flash_attention", "flash_attention_bwd"):
        run = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out_dir / f"{name}.so"),
             str(_build.CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True)
        if run.returncode:
            print(run.stderr[-3000:])
            sys.exit(1)
        lines = run.stderr.splitlines()
        for i, line in enumerate(lines):
            if "wide" in line and "Compiling entry" in line:
                print(line.split("'")[1][-60:], "|",
                      lines[i + 2].strip(), "|", lines[i + 3].strip())


def check(gen) -> list:
    failed = []
    for shape in CHECKED:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (chip_smoke.randn(shape, dtype, gen)
                           for _ in range(4))
            o, lse = fa.flash_attention_fwd(q, k, v)
            ro, rlse = fa.flash_attention_plain(q, k, v)
            _, share, _ = chip_smoke.within_attention(o, ro, dtype)
            lerr = float((lse - rlse).abs().max())
            delta = (do.float() * o.float()).sum(-1)
            got = (fa.flash_attention_dq(q, k, v, do, lse, delta),
                   *fa.flash_attention_dkv(q, k, v, do, lse, delta))
            ref = (fa.flash_attention_dq_plain(q, k, v, do, lse, delta),
                   *fa.flash_attention_dkv_plain(q, k, v, do, lse, delta))
            _, ok, ratio = chip_smoke.within_grad(got, ref, dtype)
            same = torch.equal(o, fa.flash_attention_fwd(q, k, v)[0]) and \
                torch.equal(got[0], fa.flash_attention_dq(q, k, v, do, lse,
                                                          delta))
            ok = ok and share <= 1 and lerr <= 1e-3 and same
            print(f"{list(shape)} {str(dtype)[6:]}: O |Δ|/limit "
                  f"{share:.2f}, lse {lerr:.1e}, grads max|Δ|/max|ref| "
                  f"{ratio:.1e}, twice the same bits {same} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append((shape, dtype))
    return failed


def time_shapes(gen) -> None:
    for shape in TIMED:
        q, k, v, do = (chip_smoke.randn(shape, torch.bfloat16, gen)
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        times = [chip_smoke.cuda_ms(fn, 20) for fn in (
            lambda: fa.flash_attention_fwd(q, k, v),
            lambda: fa.flash_attention_dq(q, k, v, do, lse, delta),
            lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta))]
        sdpa = "no SDPA (head dim above 256)"
        if shape[-1] <= 256:
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                ms = chip_smoke.cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v), 20)
            sdpa = f"SDPA forward {ms:.4f} ms"
        print(f"time {list(shape)} bf16: K4 {times[0]:.4f}, K5 "
              f"{times[1]:.4f}, K6 {times[2]:.4f} ms; {sdpa}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_wide: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    ptxas_report()
    _build.build()
    gen = torch.Generator("cuda").manual_seed(0)
    failed = check(gen)
    time_shapes(gen)
    print(chip_smoke.smi("name,power.limit"))
    print("FAILED" if failed else "all ok", failed)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
