"""Rehearse phases 31 to 41 of ``chip_smoke.py`` on the CPU, at cut widths,
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
  in f32, 64 images a set and 20 FLD steps;
- 37 (``phase_parallel``) over gloo on the CPU: part (a)'s one rank (B
  at batch 16, 2 timed steps, A at phase 2's cut width, H at 2 blocks of
  32 on 32² fields), part (b)'s two spawned ranks as they are;
- 38 (``phase_spatial``) over gloo on the CPU: part (a)'s one rank (A and
  B at phase 2's and 8 channels' widths, F at 8 channels, J at batch 16,
  K's autoencoder on 32² at 8 channels), part (b)'s two ranks at A's
  depth with 8 channels on 16³ in f32, F at 8 channels (the copy's
  source is cut, since spawned ranks import it afresh);
- 39 (``phase_fsdp_spatial``) over gloo on the CPU: part (a)'s one rank
  as 37's, its ranks' B at 8 channels and batch 16, D at A's cut on 16³
  at batch 2, E's widths at 8 channels on 16², H at 2 blocks of 32 on
  32², all in f32 (cut in the copy's source);
- 40 (``phase_scripts``): ``train_diffusion_mnist`` at 8 channels and
  batch 16 for 60 steps (12 eval batches a validation), ``eval_fid`` at
  20 samples in batches of 8, the other scripts at the phase's sizes;
- 41 (``phase_scripts_last``): the sweep at 8 samples of 4 steps (its
  workers run the copy), the study and Picard at 8 channels on 20² for 4
  steps, the repro's full run at 8 channels for 4 steps; H's MoE twin in
  the four gloo ranks at the cut H widths on 32² fields, batch 4.

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
                        ("norm_silu_bwd", "norm_silu_bwd_plain("),
                        ("norm_silu_stats", "norm_silu_stats_plain("),
                        ("norm_silu_apply", "norm_silu_apply_plain("),
                        ("norm_silu_bwd_partials",
                         "norm_silu_bwd_partials_plain("),
                        ("norm_silu_bwd_dx", "norm_silu_bwd_dx_plain(")):
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
        collecting = gc.isenabled()
        gc.disable()
        try:
            with kernels.counting_capture() as launches:
                with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                    outputs = fn()
        finally:
            if collecting:
                gc.enable()
        self.graphs[key] = Graph(graph, outputs, launches,
                                 time.perf_counter() - t0)''', '''        self.graphs[key] = Graph(fn, None, {}, 0.0)
        self.graphs[key].inference = torch.is_inference_mode_enabled()''')
    _sub(os.path.join(pkg, "utils/device.py"), '''    if device is None:
        if not''', '''    if device is None:
        return torch.device("cpu")
        if not''')
    _sub(os.path.join(out, "chip_smoke.py"), '"cuda"', '"cpu"')
    # phase 38 (b)'s spawned ranks import the copy afresh: cut them there
    # (A at 8 channels on 16³, f32; F at 8 channels; every attention
    # through the kernels' path)
    cs = os.path.join(out, "chip_smoke.py")
    _sub(cs, "A_WIDTH = 32 ", "A_WIDTH = 8 ")
    _sub(cs, "NSTEPS = 18\n", "NSTEPS = 3\n")
    _sub(cs, "SP_SHAPE = (4, 32, 32, 32, 1)", "SP_SHAPE = (2, 16, 16, 16, 1)")
    _sub(cs, """    return KarrasModel(PUNetG(cfg), KarrasModelConfig.from_edm(),
                       compute_dtype=torch.bfloat16)""",
         """    return KarrasModel(PUNetG(cfg), KarrasModelConfig.from_edm())""")
    _sub(cs, """    net = PUNetGCond(PUNetGConfig(model_channels=64,""",
         """    net = PUNetGCond(PUNetGConfig(model_channels=8,""")
    _sub(cs, """    return ens.EnsembleKarrasModel(net, cfg, conditional=True,
                                   compute_dtype=torch.bfloat16, device=dev)""",
         """    return ens.EnsembleKarrasModel(net, cfg, conditional=True,
                                   device=dev)""")
    _sub(fa, "MIN_TOKENS = 2048", "MIN_TOKENS = 1")
    # phase 39's spawned ranks: B at 8 channels and batch 16, D at A's cut
    # on 16³, E's widths cut on 16², H at 2 blocks of 32 on 32², f32
    _sub(cs, """    return PUNetGConfig(model_channels=64, channel_expansion=[2, 4])
""", """    return PUNetGConfig(model_channels=8, channel_expansion=[2, 4])
""")
    _sub(cs, "PAR_B_BATCH = 256 ", "PAR_B_BATCH = 16 ")
    _sub(cs, "FS_D_SHAPE = (4, 32, 32, 32, 1)", "FS_D_SHAPE = (2, 16, 16, 16, 1)")
    _sub(cs, "FS_E_SHAPE = (8, 32, 32, 1)", "FS_E_SHAPE = (4, 16, 16, 1)")
    _sub(cs, "FS_H_SHAPE = (8, 256, 256, 1)", "FS_H_SHAPE = (4, 32, 32, 1)")
    _sub(cs, "H_WIDTHS = dict(nembed=768, nheads=12, nblocks=12,",
         "H_WIDTHS = dict(nembed=32, nheads=2, nblocks=2,")
    # phase 40: mnist at 8 channels and batch 16 (12 eval batches), the
    # eval at 20 samples in batches of 8
    _sub(cs, 'SCRIPT_MNIST = ["--steps", "100"]',
         'SCRIPT_MNIST = ["--steps", "60", "--batch", "16", "--channels", "8"]')
    _sub(cs, 'SCRIPT_EVAL = ["--nsamples", "200", "--batch", "100", "--fld"]',
         'SCRIPT_EVAL = ["--nsamples", "20", "--batch", "8", "--fld"]')
    # phase 41: the sweep at 8 samples of 4 steps; the study, Picard and
    # the repro's full run at 8 channels, a few steps and samples
    _sub(cs, '''"--nsamples", "100", "--nsteps",
         "50"]''', '''"--nsamples", "8", "--nsteps", "4"]''')
    _sub(cs, '''STUDY = ["--steps", "50", "--nsamples", "128", "--nfe", "18",''',
         '''STUDY = ["--steps", "4", "--nsamples", "16", "--nfe", "4",
         "--model-channels", "8", "--batch-size", "16", "--num-data",
         "256", "--size", "20",''')
    _sub(cs, '''PICARD = ["--train-steps", "100", "--nsamples-fid", "64"]''',
         '''PICARD = ["--train-steps", "4", "--nsamples-fid", "4",
          "--latency-batch", "2", "--model-channels", "8", "--batch-size",
          "16", "--num-data", "256", "--size", "20"]''')
    _sub(cs, '''REPRO_FULL = ["--channels", "128", "--steps", "30",''',
         '''REPRO_FULL = ["--channels", "8", "--steps", "4",''')
    _sub(cs, '''"--nsamples", "100",
              "--nfe", "18"]''', '''"--nsamples", "8",
              "--nfe", "4"]''')
    _sub(cs, "def model_d(cfg, device=None, dtype=torch.bfloat16):",
         "def model_d(cfg, device=None, dtype=None):")
    _sub(cs, """    return KarrasModel(net, KarrasModelConfig.from_edm(),
                       compute_dtype=torch.bfloat16)


def model_h_moe_f32(""", """    return KarrasModel(net, KarrasModelConfig.from_edm())


def model_h_moe_f32(""")


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
        d.PUNetG(cs.small_3d_config() if cfg.dimension == 3
                 else cs.small_b_config(), device="cpu"),
        d.KarrasModelConfig.from_edm(), device="cpu")
    cs.PAR_BACKEND, cs.PAR_B_BATCH, cs.PAR_TIMED = "gloo", 16, 2
    cs.PAR_H_SIDE = 32
    cs.J_BATCH = 16

    def vae_k():
        return d.VAEModel(d.AutoencoderKL(
            DDConfig(resolution=32, ch=8, ch_mult=(1, 2), num_res_blocks=1),
            embed_dim=4, device="cpu"), d.VAEModelConfig(),
            discriminator=d.NLayerDiscriminator(ndf=8, n_layers=2,
                                                device="cpu"),
            device="cpu")
    cs.vae_k = vae_k
    cs.H_WIDTHS = dict(nembed=32, nheads=2, nblocks=2, mlp_factor=4,
                       patch_size=4, nchannels=1)
    cs.nccl_kernels = lambda fn: []

    def device_ms(fn, iters, names=None):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 0.5 * (time.perf_counter() - t0) / iters * 1e3

    cs.device_ms = device_ms

    def walls(fn, reps=3):
        t0 = time.perf_counter()
        fn()
        return [time.perf_counter() - t0]

    cs.walls = walls
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
