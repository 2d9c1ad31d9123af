"""Rehearse phases 31 to 36 of ``chip_smoke.py`` on the CPU, at cut widths,
before spending card time on them.

    python3 scripts/torch_rehearse_phases.py OUT_DIR [phase ...] [--si-steps N]

Copies ``diffsci_tpu_torch`` and ``chip_smoke.py`` into ``OUT_DIR`` (a
directory the caller owns, e.g. one ``.gitignore`` lists) and changes the
copy so that the card's paths run on the CPU:

- the graphed entry points take their graph path on the CPU (``.type !=
  "cuda"`` tests become ``!= "cpu"``); a capture runs nothing and a
  replay runs the captured body again (in the capture's inference mode),
  so a body that draws, reads a host value or keys its graph wrongly
  fails here as it would there;
- each kernel wrapper counts its plain version as a launch, so the
  phases' exact launch counts hold;
- the script's ``"cuda"`` devices become ``"cpu"``; synchronisation,
  memory statistics and the profiler are stubbed (device times read as
  half the wall);
- L runs at phase 2's cut width (12 K2 a network call), M at B's depth
  cut to 8 channels, N around phase 4's small HFNet, O over a 32² field
  (4² latents); SI's grid at ``--si-steps`` (6), M at 12 and 6 steps, the
  train batches 8 and 4;
- Q at phase 2's cut width with the flash gate lowered to one token
  (every attention counted as K4), 16³ cubes with overlap 4, a 32²
  latent through a decoder of 8 channels; P with B's depth at 8 channels
  in f32, 64 images a set and 20 FLD steps.

Then runs the named phases (default: 34 to 36) and prints each one's
seconds. The numbers mean nothing; control flow, shapes, draw
order, graph keys and launch counts do.
"""

import argparse
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ["phase_extras_card_vs_cpu", "phase_q", "phase_p"]
NO_ZERO = {"phase_runtimes_card_vs_cpu", "phase_extras_card_vs_cpu"}


def _sub(path, old, new):
    with open(path) as f:
        s = f.read()
    if old not in s:
        raise RuntimeError(f"{path}: the rehearsal's patch no longer "
                           f"applies: {old[:60]!r}")
    with open(path, "w") as f:
        f.write(s.replace(old, new))


def make_copy(out: str) -> None:
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "diffsci_tpu_torch"),
                    os.path.join(out, "diffsci_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), out)
    pkg = os.path.join(out, "diffsci_tpu_torch")
    for f in ("models/si.py", "models/sde.py", "models/ddpm_v1.py",
              "models/ddpm.py", "models/karras/module.py",
              "models/karras/train.py"):
        _sub(os.path.join(pkg, f), '.type != "cuda"', '.type != "cpu"')
    fa = os.path.join(pkg, "kernels/flash_attention.py")
    _sub(fa, '''    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)''', '''    if q.device.type == "cpu":
        kernels.LAUNCHES["flash_attention"] += 1
        return flash_attention_plain(q, k, v)''')
    _sub(fa, '''    if q.device.type == "cpu":
        return flash_attention_bwd_plain(''', '''    if q.device.type == "cpu":
        kernels.LAUNCHES["flash_attention_dq"] += 1
        kernels.LAUNCHES["flash_attention_dkv"] += 1
        return flash_attention_bwd_plain(''')
    fn = os.path.join(pkg, "kernels/fused_norm.py")
    for name, plain in (("norm_silu", "norm_silu_plain("),
                        ("norm_silu_bwd", "norm_silu_bwd_plain(")):
        _sub(fn, f'''    if x.device.type == "cpu":
        return {plain}''', f'''    if x.device.type == "cpu":
        kernels.LAUNCHES["{name}"] += 1
        return {plain}''')
    fp = os.path.join(pkg, "kernels/fused_precondition.py")
    for name, plain in (("fused_axby", "fused_axby_plain("),
                        ("fused_lincomb3", "fused_lincomb3_plain(")):
        _sub(fp, f'''    if x.device.type == "cpu":
        return {plain}''', f'''    if x.device.type == "cpu":
        kernels.LAUNCHES["{name}"] += 1
        return {plain}''')
    gr = os.path.join(pkg, "utils/graphs.py")
    _sub(gr, '''    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launches(self.launches)''', '''    def replay(self) -> None:
        with torch.inference_mode(self.inference):
            out = self.graph()
        if self.outputs is None:
            self.outputs = out
            return
        outs = self.outputs if isinstance(self.outputs, tuple) \\
            else (self.outputs,)
        for a, b in zip(outs, out if isinstance(out, tuple) else (out,)):
            if a is not None:
                a.copy_(b)''')
    _sub(gr, '''        stream = self._side_stream()
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn()
        current.wait_stream(stream)
        return out''', '''        return fn()''')
    _sub(gr, '''        stream = self._side_stream()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with kernels.counting_capture() as launches:
            with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                outputs = fn()
        self.graphs[key] = Graph(graph, outputs, launches,
                                 time.perf_counter() - t0)''', '''        self.graphs[key] = Graph(fn, None, {}, 0.0)
        self.graphs[key].inference = torch.is_inference_mode_enabled()''')
    _sub(os.path.join(pkg, "utils/device.py"), '''    if device is None:
        if not''', '''    if device is None:
        return torch.device("cpu")
        if not''')
    _sub(os.path.join(out, "chip_smoke.py"), '"cuda"', '"cpu"')


def rehearse(out: str, names, si_steps: int) -> None:
    sys.path.insert(0, out)
    import torch

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_snapshot = lambda *a, **k: []
    import chip_smoke as cs
    import diffsci_tpu_torch as d
    from diffsci_tpu_torch.models.nets.vae import AutoencoderKL, DDConfig
    from diffsci_tpu_torch.models.vae import (BoundAutoencoder, VAEModel,
                                              VAEModelConfig)

    def profiled(fn, host=True):
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
        return wall, 0.5 * wall, 0.0, ""

    def bound_g():
        vm = VAEModel(AutoencoderKL(DDConfig(resolution=32, ch=8,
                                             num_res_blocks=1),
                                    embed_dim=4, device="cpu"),
                      VAEModelConfig(), device="cpu")
        vm.init(seed=0)
        return BoundAutoencoder(vm)

    model_l, model_q = cs.model_l, cs.model_q
    cs.profiled_shares = profiled
    cs.profile_call = lambda *a, **k: None
    cs.smi = lambda query: "CPU rehearsal"
    cs.model_l = lambda dev="cpu", cfg=None, dtype=None, **si: model_l(
        dev, cfg or cs.small_3d_config(), None, **si)
    cs.model_q = lambda dev="cpu", cfg=None, dtype=None: model_q(
        dev, cfg or cs.small_3d_config(), None)
    d.kernels.flash_attention.MIN_TOKENS = 1
    cs.Q_BASE, cs.Q_OVERLAP, cs.Q_PAD = (16, 16, 16, 1), 4, 4
    cs.Q_LATENT, cs.Q_CHUNK = 32, 16
    cs.Q_DECODER = dict(has_mid_attn=False, ch=8, ch_mult=(1, 2),
                        num_res_blocks=1)
    cs.P_N, cs.P_TEST, cs.P_FLD_ITERS = 64, 64, 20
    cs.karras = lambda cfg: d.KarrasModel(
        d.PUNetG(cs.small_b_config(), device="cpu"),
        d.KarrasModelConfig.from_edm(), device="cpu")
    cs.NORMS_A = 12
    cs.SI_STEPS, cs.SI_NFE, cs.SI_EM_NFE = si_steps, 2 * si_steps - 3, \
        si_steps - 1
    cs.M_EM_STEPS, cs.M_PF_STEPS, cs.M_BATCH, cs.N_BATCH = 12, 6, 8, 4
    cs.punetg_b = lambda: d.PUNetG(cs.small_b_config(), device="cpu")
    cs.G_PIX, cs.bound_g = 32, bound_g
    hfnet = d.HFNetUncond
    d.HFNetUncond = lambda **kw: hfnet(
        block_channels=(32, 64), channels=3, norm_num_groups=8,
        attn_up_and_down=True, device="cpu")
    zero = dict.fromkeys(d.kernels.LAUNCHES, 0)
    for name in names:
        t0 = time.perf_counter()
        fn = getattr(cs, name)
        fn() if name in NO_ZERO else fn(zero)
        print(f"{name} ok {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("phases", nargs="*", default=PHASES)
    ap.add_argument("--si-steps", type=int, default=6)
    args = ap.parse_args()
    make_copy(args.out)
    rehearse(args.out, args.phases, args.si_steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
