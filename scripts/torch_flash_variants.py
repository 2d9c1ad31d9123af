#!/usr/bin/env python3
"""Build the bf16 flash kernels with nvcc -D variants and time them side by
side on one GPU.

Run from the repository root, with one NVIDIA Hopper card (H100):

    python3 scripts/torch_flash_variants.py [--set mma|narrow] [--variants]
                                            [--plain]

Every build compiles the flash sources of ``diffsci_tpu_torch/csrc`` with
``-Xptxas -v`` under ``diffsci_tpu_torch/_build/variants/``, all nvcc
processes started at once; a build that changes one library's macros
only times the set's first build's other library. Two sets:

- ``mma`` (the default): the ``mma.sync`` kernels' tile macros, each
  build with ``-DFLASH_WGMMA_MIN_DIM=129`` so that head dim 32 stays on
  those kernels: the warps per block (``FLASH_MMA_WARPS``, all three
  kernels), K4's key tile (``FLASH_FWD_KEYS``), K5's key tile at head dims
  up to 64 (``FLASH_DQ_KEYS``), K6's query tile at head dim 32
  (``FLASH_DKV_BQ32``) and ``exp2f`` in place of the SFU-only
  ``fast_exp2`` (``FLASH_EXACT_EXP2``), at configuration A's shape.
- ``narrow``: the two routes of bf16 head dims up to 128, the committed
  build (the narrow ``wgmma`` kernels) and ``-DFLASH_WGMMA_MIN_DIM=129``
  (the ``mma.sync`` kernels); with ``--variants`` also the narrow
  kernels' tile macros (two consumer warpgroups a block at d 64 and at d
  32, rings of 2 stages, and of 4 for K4 and 6 for K6), at H's shapes
  (DiT-B: bucket 4 and train batch 8), A's (PUNetG 3D: buckets 4 and 1,
  the Picard sweep's batch 8) and at head dim 128.

It prints the card's name, power limit and maximum SM clock; ptxas's
registers and spills of the set's kernels in every build, and every line
in which ptxas reports serialised ``wgmma``; then, at each shape, every
build's K4, K5 and K6 against their plain versions (``chip_smoke.py``'s
bf16 tolerances) and the three kernels timed on every build (the builds
in turn, then backwards; the lesser of the two medians of 5 timed loops of
10 calls, and the range of all ten loops), each beside its bound, the SFU
floor of its exponentials and SDPA's flash backend (the forward beside
K4, its backward asked for dQ beside K5 and for dK, dV beside K6).
``--plain`` times the plain versions of K4, K5 and K6 last, at A's, H's
and I's shapes and at head dim 512. Exits 1 if a build disagrees with
the plain versions.
"""

from __future__ import annotations

import math
import pathlib
import re
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

LIBS = {"flash_attention": fa.SIGNATURES,
        "flash_attention_bwd": fa.BWD_SIGNATURES}
MMA_ROUTE = ("-DFLASH_WGMMA_MIN_DIM=129",)
# per set: the defines of every build, its builds, its shapes and the
# kernels whose ptxas lines it prints
SETS = {
    "mma": dict(
        base=MMA_ROUTE,
        builds={"committed": (), "K6 query tile 64": ("-DFLASH_DKV_BQ32=64",),
                "8 warps": ("-DFLASH_MMA_WARPS=8",),
                "K4 key tile 128": ("-DFLASH_FWD_KEYS=128",),
                "K5 key tile 32": ("-DFLASH_DQ_KEYS=32",),
                "K5 key tile 128": ("-DFLASH_DQ_KEYS=128",),
                "exp2f": ("-DFLASH_EXACT_EXP2",)},
        variants={},
        shapes=(((4, 2, 4096, 32), "A, bucket 4 and train batch 4"),),
        kernels=r"(flash_(?:fwd|dq|dkv)_mma_kernel)ILi32ELb1E"),
    "narrow": dict(
        base=(),
        builds={"narrow": (), "mma.sync": MMA_ROUTE},
        variants={"d 64 2 WGs": ("-DFLASH_NARROW_WGS64=2",),
                  "d 32 2 WGs": ("-DFLASH_NARROW_WGS32=2",),
                  "K5 d 64 1 WG": ("-DFLASH_DQ_NARROW_WGS64=1",),
                  "K5 d 64 3 WGs": ("-DFLASH_DQ_NARROW_WGS64=3",),
                  "K5 d 32 2 WGs": ("-DFLASH_DQ_NARROW_WGS32=2",),
                  "rings of 2": ("-DFLASH_NARROW_STAGES=2",
                                 "-DFLASH_DKV_NARROW_STAGES=2",
                                 "-DFLASH_DQ_NARROW_STAGES=2"),
                  "rings of 4 and 6": ("-DFLASH_NARROW_STAGES=4",
                                       "-DFLASH_DKV_NARROW_STAGES=6",
                                       "-DFLASH_DQ_NARROW_STAGES=6")},
        shapes=(((4, 12, 4096, 64), "H, bucket 4"),
                ((8, 12, 4096, 64), "H, train batch 8"),
                ((4, 2, 4096, 32), "A, bucket 4"),
                ((1, 2, 4096, 32), "A, bucket 1"),
                ((8, 2, 4096, 32), "A, Picard sweep"),
                ((2, 4, 4096, 128), "head dim 128")),
        kernels=r"(flash_(?:fwd|dq|dkv)_narrow_kernelILi\d+E(?:Li\d+E)?)"),
}
# the macros that reach one library alone
ONE_LIB = (("flash_attention", ("-DFLASH_NARROW_", "-DFLASH_FWD_")),
           ("flash_attention_bwd", ("-DFLASH_DKV_", "-DFLASH_DQ_")))
# the plain versions timed at A's, H's and I's shapes and at head dim 512
PLAIN_TIMED = ((4, 2, 4096, 32), (4, 12, 4096, 64), (8, 12, 4096, 64),
               (4, 1, 4096, 256), (8, 1, 4096, 256), (1, 2, 2048, 512))


def libs_of(defines) -> tuple:
    """The libraries that a build's own defines change."""
    for lib, prefixes in ONE_LIB:
        if defines and all(d.startswith(prefixes) for d in defines):
            return (lib,)
    return tuple(LIBS)


def build(builds: dict, base: tuple, pattern: str) -> dict:
    """nvcc of every build's libraries, all started at once: {(build,
    lib): path}. Prints ptxas's registers and spills of each kernel that
    ``pattern`` names and every line that reports serialised wgmma."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, defines) in enumerate(builds.items()):
        for lib in libs_of(defines):
            so = out_dir / f"{lib}-{i}.so"
            jobs[(name, lib)] = (so, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, *base, *defines,
                 "-Xptxas", "-v", "-o", str(so),
                 str(_build.CSRC_DIR / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for (name, lib), (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-6000:])
            raise RuntimeError(f"nvcc failed for {lib} ({name})")
        built[(name, lib)] = so
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "serializ" in line:
                print(f"ptxas ({name}):", line.strip())
            found = re.search(pattern, line)
            if "Compiling entry" in line and found:
                stats = [x.split(":", 1)[-1].strip() for x in lines[i:i + 4]
                         if "registers" in x or "spill" in x]
                print(f"{name}: {found.group(1)} | {' | '.join(stats)}")
    return built


def build_calls(lf, lb, q, k, v, do, lse, delta):
    """K4, K5 and K6 of one build's libraries, called through ctypes, and
    their outputs (O, lse, dQ, dK, dV)."""
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

    return {"K4": k4, "K5": k5, "K6": k6}, (o, lse_o, dq, dk, dv)


def sdpa_times(q, k, v, do) -> dict:
    """SDPA's flash backend: the forward, and its backward asked for dQ
    (beside K5) and for dK, dV (beside K6)."""
    def bwd(wrt):
        leaves = [t.detach().requires_grad_(i in wrt)
                  for i, t in enumerate((q, k, v))]
        out = F.scaled_dot_product_attention(*leaves)
        inputs = [leaves[i] for i in wrt]
        return chip_smoke.cuda_ms_spread(lambda: torch.autograd.grad(
            out, inputs, do, retain_graph=True), 10)[0]

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return {"K4": chip_smoke.cuda_ms_spread(
                    lambda: F.scaled_dot_product_attention(q, k, v), 10)[0],
                "K5": bwd((0,)), "K6": bwd((1, 2))}


def agrees(name, shape, outs, refs) -> bool:
    """One build's O, lse, dQ, dK, dV against the plain versions'."""
    o, lse, *grads = outs
    ro, rlse, *rgrads = refs
    dtype = torch.bfloat16
    _, share, _ = chip_smoke.within_attention(o, ro, dtype)
    lerr = float((lse - rlse).abs().max())
    _, ok, ratio = chip_smoke.within_grad(grads, rgrads, dtype)
    ok = ok and share <= 1 and lerr <= 1e-3
    print(f"check {name} {list(shape)}: O |Δ|/limit {share:.2f}, lse "
          f"{lerr:.1e}, dQ dK dV max|Δ|/max|ref| {ratio:.1e} (limit "
          f"{chip_smoke.GRAD_TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok


def time_builds(gen, builds, built, shapes) -> list:
    """Checks and times every build at ``shapes``; returns the builds and
    shapes that disagree with the plain versions."""
    first = next(iter(builds))
    libs = {name: [_build.open_library(
        built.get((name, lib), built[(first, lib)]), sigs)
        for lib, sigs in LIBS.items()] for name in builds}
    failed = []
    for shape, label in shapes:
        B, H, T, d = shape
        BH = B * H
        q, k, v, do = (chip_smoke.randn(shape, torch.bfloat16, gen)
                       for _ in range(4))
        ro, rlse = fa.flash_attention_plain(q, k, v)
        delta = (do.float() * ro.float()).sum(-1)
        refs = (ro, rlse, fa.flash_attention_dq_plain(q, k, v, do, rlse,
                                                      delta),
                *fa.flash_attention_dkv_plain(q, k, v, do, rlse, delta))
        calls = {name: build_calls(*libs[name], q, k, v, do, rlse, delta)
                 for name in builds}
        for name, (fns, outs) in calls.items():
            for fn in fns.values():
                fn()
            torch.cuda.synchronize()
            if not agrees(name, shape, outs, refs):
                failed.append((name, shape))
        del refs
        torch.cuda.empty_cache()
        reads = 4 * 2 * BH * T * d + 2 * 4 * BH * T
        work = {"K4": (4 * 2 * BH * T * d + 4 * BH * T, 4 * BH * T * T * d),
                "K5": (reads + 2 * BH * T * d, 6 * BH * T * T * d),
                "K6": (reads + 2 * 2 * BH * T * d, 8 * BH * T * T * d)}
        sdpa = sdpa_times(q, k, v, do)
        sfu = chip_smoke.sfu_floor_ms(BH * T * T)
        for kernel in ("K4", "K5", "K6"):
            bms, _ = chip_smoke.bound(*work[kernel], torch.bfloat16)
            times = {b: [] for b in builds}
            for rnd in range(2):  # the builds in turn, then backwards
                for b in (list(builds) if rnd == 0 else list(builds)[::-1]):
                    times[b].append(chip_smoke.cuda_ms_spread(
                        calls[b][0][kernel], 10))
            text = ", ".join(
                f"{b} {min(m for m, _, _ in t):.4f} ms "
                f"({min(lo for _, lo, _ in t):.4f}-"
                f"{max(hi for _, _, hi in t):.4f}; "
                f"{100 * bms / min(m for m, _, _ in t):.1f} %)"
                for b, t in times.items())
            print(f"time {kernel} {list(shape)} bf16 ({label}): {text}; "
                  f"SDPA {sdpa[kernel]:.4f} ms; bound {bms:.4f} ms, SFU "
                  f"floor {sfu:.4f} ms", flush=True)
    return failed


def time_plain(gen) -> None:
    """The plain versions of K4, K5 and K6 in bf16 (f32 math over the
    whole [T, T] scores) at ``PLAIN_TIMED``, median of 3 loops of 3
    calls: the yardstick the kernels are checked against, not a route."""
    for shape in PLAIN_TIMED:
        q, k, v, do = (chip_smoke.randn(shape, torch.bfloat16, gen)
                       for _ in range(4))
        o, lse = fa.flash_attention_plain(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        times = [chip_smoke.cuda_ms_spread(fn, 3, 3)[0] for fn in (
            lambda: fa.flash_attention_plain(q, k, v),
            lambda: fa.flash_attention_dq_plain(q, k, v, do, lse, delta),
            lambda: fa.flash_attention_dkv_plain(q, k, v, do, lse, delta))]
        print(f"plain {list(shape)} bf16: K4 {times[0]:.4f} ms, K5 "
              f"{times[1]:.4f} ms, K6 {times[2]:.4f} ms", flush=True)
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_flash_variants: needs a CUDA card", file=sys.stderr)
        return 2
    which = argv[argv.index("--set") + 1] if "--set" in argv else "mma"
    spec = SETS[which]
    builds = dict(spec["builds"])
    if "--variants" in argv:
        builds.update(spec["variants"])
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.smi("name,power.limit,clocks.max.sm"), flush=True)
    built = build(builds, spec["base"], spec["kernels"])
    gen = torch.Generator("cuda").manual_seed(0)
    failed = time_builds(gen, builds, built, spec["shapes"])
    if "--plain" in argv:
        time_plain(gen)
    print("FAILED" if failed else "all ok", failed)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
