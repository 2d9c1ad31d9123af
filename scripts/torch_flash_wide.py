#!/usr/bin/env python3
"""Check and time the flash kernels at head dims above 128 on one GPU.

Run from the repository root, with one NVIDIA Hopper card (H100):

    python3 scripts/torch_flash_wide.py [--quick]

Builds the flash sources of ``diffsci_tpu_torch/csrc`` three times more
with ``-Xptxas -v`` under ``diffsci_tpu_torch/_build/wide/``: as
committed; with ``-DFLASH_WGMMA_MAX_DIM=128``, which sends every head dim
above 128 to the ``mma.sync`` wide kernels (the route that unaligned rows
and float32 keep); and with ``-DFLASH_DQ_WGMMA_ROWS=64``, which gives
K5 up to d 256 the 64-row ``flash_dq_wgmma_pair_kernel`` (two warpgroups
sharing one query tile through handoffs) in place of the 128-row
``flash_dq_wgmma_kernel``. Prints the registers and spills of the
wide kernels and every line in which ptxas reports serialised ``wgmma``
or injected warpgroup arrivals; holds K4, K5 and K6 in float32 and
bfloat16 against their plain versions (``chip_smoke.py``'s tolerances)
at small shapes first, then at head dims 136, 192, 200, 256, 260, 320
and 512 with ragged T and at a few d ≤ 128 shapes, each bf16 result
twice for the same bits; then times K4, K5 and K6 in bf16 on the three
builds side by side (medians of 5 timed loops, each beside its bound)
with SDPA's flash backend where it takes the head dim (the forward
beside K4, its backward asked for dQ alone beside K5), at configuration
I's shapes (ADM: one head of 256, bucket 4 and train batch 8), a head
dim of 512, and H's and A's (d ≤ 128, unchanged). The card's name and
power limit come last. ``--quick`` stops after the small shapes. Exits 1
if a check fails.
"""

from __future__ import annotations

import math
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

SMALL = ((1, 1, 64, 256), (1, 1, 130, 256), (2, 1, 200, 136),
         (1, 2, 100, 512), (1, 1, 257, 320))
CHECKED = ((1, 2, 2048, 256), (1, 2, 2048, 512), (2, 1, 2049, 200),
           (1, 1, 2111, 260), (4, 1, 4096, 256), (1, 1, 2049, 136),
           (1, 1, 2111, 192), (1, 2, 2049, 320), (1, 1, 2111, 512),
           (1, 2, 4096, 32), (1, 1, 2111, 128), (1, 2, 2048, 20))
TIMED = ((4, 1, 4096, 256), (8, 1, 4096, 256), (1, 2, 2048, 512),
         (4, 12, 4096, 64), (4, 2, 4096, 32))
LIBS = {"flash_attention": fa.SIGNATURES,
        "flash_attention_bwd": fa.BWD_SIGNATURES}
ROUTES = {"wgmma": (), "mma.sync": ("-DFLASH_WGMMA_MAX_DIM=128",),
          "wgmma, K5 handoff": ("-DFLASH_DQ_WGMMA_ROWS=64",)}


def build_routes() -> dict:
    """Both routes' libraries, built at once: {(route, lib): path}; prints
    ptxas's registers and spills of the wide kernels and any serialised
    wgmma."""
    out_dir = _build.BUILD_DIR / "wide"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (route, defines) in enumerate(ROUTES.items()):
        for lib in LIBS:
            so = out_dir / f"{lib}-{i}.so"
            jobs[(route, lib)] = (so, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-Xptxas",
                 "-v", "-o", str(so), str(_build.CSRC_DIR / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for (route, lib), (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-6000:])
            raise RuntimeError(f"nvcc failed for {lib} ({route})")
        built[(route, lib)] = so
        if route != "wgmma":
            continue
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if ("wgmma" in line or "warpgroup" in line) and \
                    "Compiling entry" not in line:
                print("ptxas:", line.strip())
            if "Compiling entry" in line and ("wide" in line
                                              or "wgmma" in line):
                stats = [x.split(":", 1)[-1].strip() for x in lines[i:i + 4]
                         if "registers" in x or "spill" in x]
                print(line.split("'")[1][-48:], "|", " | ".join(stats))
    return built


def check(gen, shapes) -> list:
    failed = []
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (chip_smoke.randn(shape, dtype, gen)
                           for _ in range(4))
            o, lse = fa.flash_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            ro, rlse = fa.flash_attention_plain(q, k, v)
            _, share, _ = chip_smoke.within_attention(o, ro, dtype)
            lerr = float((lse - rlse).abs().max())
            delta = (do.float() * o.float()).sum(-1)
            got = (fa.flash_attention_dq(q, k, v, do, lse, delta),
                   *fa.flash_attention_dkv(q, k, v, do, lse, delta))
            torch.cuda.synchronize()
            ref = (fa.flash_attention_dq_plain(q, k, v, do, lse, delta),
                   *fa.flash_attention_dkv_plain(q, k, v, do, lse, delta))
            _, ok, ratio = chip_smoke.within_grad(got, ref, dtype)
            each = [chip_smoke.within_grad((g,), (r,), dtype)[2]
                    for g, r in zip(got, ref)]
            again = (fa.flash_attention_fwd(q, k, v)[0],
                     fa.flash_attention_dq(q, k, v, do, lse, delta),
                     *fa.flash_attention_dkv(q, k, v, do, lse, delta))
            same = all(torch.equal(a, b) for a, b in zip((o, *got), again))
            ok = ok and share <= 1 and lerr <= 1e-3 and same
            print(f"{list(shape)} {str(dtype)[6:]}: O |Δ|/limit "
                  f"{share:.2f}, lse {lerr:.1e}, dQ dK dV max|Δ|/max|ref| "
                  f"{' '.join(f'{e:.1e}' for e in each)} (limit "
                  f"{chip_smoke.GRAD_TOL[dtype]:.0e}), twice the same bits "
                  f"{same} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append((shape, dtype))
    return failed


def route_calls(lf, lb, q, k, v, do, lse, delta):
    """K4, K5 and K6 of one route's libraries, called through ctypes."""
    B, H, T, d = q.shape
    o, lse_o = torch.empty_like(q), torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    grads = ptrs + (do.data_ptr(), lse.data_ptr(), delta.data_ptr())

    def k4():
        _build.check(lf, lf.flash_fwd_launch(
            *ptrs, o.data_ptr(), lse_o.data_ptr(), B * H, T, d,
            math.log2(math.e) / math.sqrt(d), 1, stream), "K4")

    def k5():
        _build.check(lb, lb.flash_dq_launch(
            *grads, dq.data_ptr(), B * H, T, d, 1 / math.sqrt(d), 1,
            stream), "K5")

    def k6():
        _build.check(lb, lb.flash_dkv_launch(
            *grads, dk.data_ptr(), dv.data_ptr(), B * H, T, d,
            1 / math.sqrt(d), 1, stream), "K6")

    return {"K4": k4, "K5": k5, "K6": k6}, (o, dq, dk, dv)


def time_routes(gen, built) -> None:
    libs = {route: [_build.open_library(built[(route, lib)], sigs)
                    for lib, sigs in LIBS.items()] for route in ROUTES}
    for shape in TIMED:
        B, H, T, d = shape
        BH = B * H
        q, k, v, do = (chip_smoke.randn(shape, torch.bfloat16, gen)
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        reads = 4 * 2 * BH * T * d + 2 * 4 * BH * T
        work = {"K4": (4 * 2 * BH * T * d + 4 * BH * T, 4 * BH * T * T * d),
                "K5": (reads + 2 * BH * T * d, 6 * BH * T * T * d),
                "K6": (reads + 2 * 2 * BH * T * d, 8 * BH * T * T * d)}
        calls = {route: route_calls(*libs[route], q, k, v, do, lse, delta)
                 for route in ROUTES}
        for fns, _ in calls.values():  # both routes, to compare outputs
            for fn in fns.values():
                fn()
        torch.cuda.synchronize()
        outs = [out for _, out in calls.values()]
        agree = max(float((x.float() - y.float()).abs().max()
                          / y.float().abs().max())
                    for other in outs[1:] for x, y in zip(other, outs[0]))
        sdpa = {}
        if d <= 256:
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                sdpa["K4"] = chip_smoke.cuda_ms_spread(
                    lambda: F.scaled_dot_product_attention(q, k, v), 10)[0]
                leaf = q.detach().requires_grad_()
                out = F.scaled_dot_product_attention(leaf, k, v)
                sdpa["K5"] = chip_smoke.cuda_ms_spread(
                    lambda: torch.autograd.grad(out, leaf, do,
                                                retain_graph=True), 10)[0]
        for name in ("K4", "K5", "K6"):
            bms, _ = chip_smoke.bound(*work[name], torch.bfloat16)
            times = []
            for rnd in range(2):  # the routes in turn, then backwards
                order = list(ROUTES) if rnd == 0 else list(ROUTES)[::-1]
                for route in order:
                    times.append((route, chip_smoke.cuda_ms_spread(
                        calls[route][0][name], 10)[0]))
            best = {r: min(t for rr, t in times if rr == r) for r in ROUTES}
            text = ", ".join(f"{r} {t:.4f} ms ({100 * bms / t:.1f} % of "
                             f"bound)" for r, t in best.items())
            extra = f", SDPA {sdpa[name]:.4f} ms" if name in sdpa else ""
            print(f"time {name} {list(shape)} bf16: {text}{extra}; bound "
                  f"{bms:.4f} ms; routes agree to {agree:.1e} of max|out|",
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_wide: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    built = build_routes()
    _build.build()
    gen = torch.Generator("cuda").manual_seed(0)
    failed = check(gen, SMALL)
    if "--quick" not in sys.argv[1:]:
        failed += check(gen, CHECKED)
        time_routes(gen, built)
    print(chip_smoke.smi("name,power.limit"))
    print("FAILED" if failed else "all ok", failed)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
