#!/usr/bin/env python3
"""Time variants of the bf16 flash kernels' tile constants on one GPU.

Run from the repository root, with one NVIDIA Hopper card (H100):

    python3 scripts/torch_flash_variants.py

Each variant builds the flash sources of ``diffsci_tpu_torch/csrc`` with
one nvcc -D flag over the committed defaults: the warps per block
(``FLASH_MMA_WARPS``, all three kernels), K4's key tile
(``FLASH_FWD_KEYS``), K5's key tile at head dims up to 64
(``FLASH_DQ_KEYS``), K6's query tile at head dim 32 (``FLASH_DKV_BQ32``)
and ``exp2f`` in place of the SFU-only ``fast_exp2``
(``FLASH_EXACT_EXP2``). All are built at once under
``diffsci_tpu_torch/_build/variants/``, checked against the plain versions
and timed at configuration A's shape (q, k, v, dO [4, 2, 4096, 32] bf16):
K4, K5 and K6, the median and range of 5 timed loops of 20 calls, two
rounds in turn. The card's name, power limit and maximum SM clock come
first; registers and spills of the head-dim-32 tensor-core kernels
(``-Xptxas -v``) last.
"""

from __future__ import annotations

import math
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from diffsci_tpu_torch.kernels import _build  # noqa: E402
from diffsci_tpu_torch.kernels import flash_attention as fa  # noqa: E402

VARIANTS = {"committed": (), "K6 query tile 64": ("-DFLASH_DKV_BQ32=64",),
            "8 warps": ("-DFLASH_MMA_WARPS=8",),
            "K4 key tile 128": ("-DFLASH_FWD_KEYS=128",),
            "K5 key tile 32": ("-DFLASH_DQ_KEYS=32",),
            "K5 key tile 128": ("-DFLASH_DQ_KEYS=128",),
            "exp2f": ("-DFLASH_EXACT_EXP2",)}
LIBS = {"flash_attention": fa.SIGNATURES,
        "flash_attention_bwd": fa.BWD_SIGNATURES}


def build() -> dict:
    """Build every variant: {(variant, lib): (path, ptxas summary of each
    of its head-dim-32 tensor-core kernels)}."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, defines) in enumerate(VARIANTS.items()):
        for lib in LIBS:
            so = out_dir / f"{lib}-{i}.so"
            jobs[(name, lib)] = (so, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-Xptxas",
                 "-v", "-o", str(so), str(_build.CSRC_DIR / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lines = log.splitlines()
        summary = []
        for i, line in enumerate(lines):
            found = re.search(r"(flash_\w+?_mma_kernel)ILi32ELb1E", line)
            if "Compiling entry" in line and found:
                summary.append(found.group(1) + ": " + " ".join(
                    x.split(":", 1)[-1].strip() for x in lines[i:i + 4]
                    if "registers" in x or "spill" in x))
        built[key] = (so, "; ".join(summary))
    return built


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_variants: needs a CUDA card", file=sys.stderr)
        return 2
    built = build()
    print(chip_smoke.smi("name,power.limit,clocks.max.sm"), flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    B, H, T, d = 4, 2, 4096, 32
    q, k, v, do = (torch.randn((B, H, T, d), generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    ro, rlse = fa.flash_attention_plain(q, k, v)
    o0, lse0 = fa.flash_attention_fwd(q, k, v)
    delta = (do.float() * o0.float()).sum(-1)
    rdq = fa.flash_attention_dq_plain(q, k, v, do, lse0, delta)
    rdk, rdv = fa.flash_attention_dkv_plain(q, k, v, do, lse0, delta)
    stream = torch.cuda.current_stream().cuda_stream
    for rnd in range(2):
        for name in VARIANTS:
            lf, lb = (_build.open_library(built[(name, lib)][0], sigs)
                      for lib, sigs in LIBS.items())
            o, lse = torch.empty_like(q), torch.empty_like(lse0)
            dq = torch.empty_like(q)
            dk, dv = torch.empty_like(k), torch.empty_like(v)

            def fwd():
                _build.check(lf, lf.flash_fwd_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), B * H, T, d,
                    math.log2(math.e) / math.sqrt(d), 1, stream), name)

            def dq_():
                _build.check(lb, lb.flash_dq_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse0.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H,
                    T, d, 1 / math.sqrt(d), 1, stream), name)

            def dkv():
                _build.check(lb, lb.flash_dkv_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse0.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), B * H, T, d, 1 / math.sqrt(d), 1,
                    stream), name)

            fwd()
            dq_()
            dkv()
            torch.cuda.synchronize()
            err_o, share, _ = chip_smoke.within_attention(o, ro,
                                                          torch.bfloat16)
            err_g, ok_g, _ = chip_smoke.within_grad(
                (dq, dk, dv), (rdq, rdk, rdv), torch.bfloat16)
            if not (share <= 1 and ok_g
                    and float((lse - rlse).abs().max()) < 1e-3):
                raise AssertionError(f"{name}: disagrees with the plain "
                                     f"versions ({err_o}, {err_g})")
            times = ", ".join(
                "{} {:.4f} ms ({:.4f}-{:.4f})".format(
                    kernel, *chip_smoke.cuda_ms_spread(fn, 20))
                for kernel, fn in (("K4", fwd), ("K5", dq_), ("K6", dkv)))
            print(f"round {rnd} {name:18s} {times}", flush=True)
    for (name, lib), (_, regs) in built.items():
        print(f"{name:18s} {lib:20s} d=32 {regs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
