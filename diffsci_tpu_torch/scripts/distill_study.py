"""Progressive-distillation quality study: FID against NFE, teacher
against student.

Port of ``scripts/distill_study.py``: trains the bench-scale model on the
shapes dataset, distills it down the halving chain
(``models/karras/distill.py``), and scores pixel-FID at each NFE budget
for (a) the teacher sampled naively at that budget and (b) the distilled
student. The claim under test is Salimans & Ho's (arXiv:2202.00512): the
distilled student at 2-4 NFE approaches the teacher's full-budget quality
and beats the naively truncated sampler at the same NFE.

Writes the JSON artifact ``--out`` (default
docs/artifacts/distill_study.json) and the training log under
``--log-dir``.

Usage:
    python -m diffsci_tpu_torch.scripts.distill_study [--steps 4000]
        [--phase-steps 1500] [--device cuda]
"""

import argparse
import json
import pathlib

import numpy as np

from diffsci_tpu_torch.scripts._common import (add_device_flag, host,
                                               use_weights)
from diffsci_tpu_torch.utils import resolve_device


def features(x) -> np.ndarray:
    x = host(x)
    return np.asarray(x, np.float64).reshape(x.shape[0], -1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--phase-steps", type=int, default=1500)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--num-data", type=int, default=4096)
    ap.add_argument("--nsamples", type=int, default=1024)
    ap.add_argument("--model-channels", type=int, default=32)
    ap.add_argument("--expansion", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--distill-lr", type=float, default=1e-4)
    ap.add_argument("--start-nsteps", type=int, default=17)
    ap.add_argument("--log-dir", default="runs/distill_study")
    ap.add_argument("--out", default="docs/artifacts/distill_study.json")
    add_device_flag(ap)
    args = ap.parse_args()

    import torch
    from diffsci_tpu_torch.data import ShapesDataset
    from diffsci_tpu_torch.metrics import fid
    from diffsci_tpu_torch.models import (EMATracker, KarrasModel,
                                          KarrasModelConfig, PUNetG,
                                          PUNetGConfig, default_optimizer)
    from diffsci_tpu_torch.models.karras import (distill_progressive,
                                                 sample_onestep)
    from diffsci_tpu_torch.trainer import fit_karras

    device = resolve_device(args.device)
    xs = ShapesDataset(args.num_data, size=args.size,
                       mode="paper_replica").generate()
    held_out = ShapesDataset(args.nsamples, size=args.size,
                             mode="paper_replica", seed=123).generate()
    print(f"data {xs.shape}, device {device}", flush=True)

    net = PUNetG(PUNetGConfig(model_channels=args.model_channels,
                              channel_expansion=list(args.expansion)),
                 device=device)
    model = KarrasModel(net, KarrasModelConfig.from_edm(), device=device)
    ema = EMATracker(ema_type="power", power_function_stds=[0.05])
    state, _ = fit_karras(
        model, xs, batch_size=args.batch_size,
        max_epochs=args.steps, max_steps=args.steps, ema=ema,
        val_fraction=0.05, optimizer=default_optimizer(args.lr),
        log_dir=args.log_dir, device=device)
    use_weights(model, state.ema_variables(ema))
    teacher_vars = {k: v.detach().clone()
                    for k, v in model.net.state_dict().items()}

    real_f = features(held_out)
    shape = (args.size, args.size, 1)
    gen = torch.Generator(device).manual_seed(11)

    def score(variables, nsteps, integ, label, results):
        use_weights(model, variables)
        samples = model.sample(args.nsamples, shape, gen, nsteps=nsteps,
                               integrator=integ, maximum_batch_size=256)
        nfe = 2 * nsteps - 1 if integ == "heun" else nsteps
        results[label] = {"nsteps": nsteps, "integrator": integ,
                          "nfe": nfe,
                          "fid": float(fid(real_f, features(samples)))}
        print(f"{label}: NFE={nfe} fid={results[label]['fid']:.2f}",
              flush=True)

    results = {}
    # teacher baselines: full budget + naive truncation
    score(teacher_vars, 18, "heun", "teacher_heun@18", results)
    for n in dict.fromkeys((args.start_nsteps, 5, 3, 2)):
        score(teacher_vars, n, "euler", f"teacher_euler@{n}", results)

    def batches():
        g = torch.Generator().manual_seed(77)
        while True:
            idx = torch.randint(0, xs.shape[0], (args.batch_size,),
                                generator=g).numpy()
            yield torch.from_numpy(xs[idx]).to(device)

    chain_vars = {}

    def keep(nsteps, variables, losses):
        chain_vars[nsteps] = variables
        print(f"phase {nsteps}: loss {losses[0]:.4f} -> {losses[-1]:.5f}",
              flush=True)

    _, history = distill_progressive(
        model, teacher_vars, batches(),
        torch.Generator(device).manual_seed(5),
        start_nsteps=args.start_nsteps, final_nsteps=1,
        steps_per_phase=args.phase_steps,
        learning_rate=args.distill_lr, callback=keep)

    for nsteps, variables in chain_vars.items():
        if nsteps == 1:
            use_weights(model, variables)
            samples = sample_onestep(model, args.nsamples, shape,
                                     torch.Generator(device).manual_seed(21))
            results["student_onestep@1"] = {
                "nsteps": 1, "integrator": "onestep", "nfe": 1,
                "fid": float(fid(real_f, features(samples)))}
            print(f"student_onestep@1: NFE=1 "
                  f"fid={results['student_onestep@1']['fid']:.2f}",
                  flush=True)
        else:
            score(variables, nsteps, "euler", f"student_euler@{nsteps}",
                  results)

    base = results["teacher_heun@18"]["fid"]
    claims = {
        "student2_beats_naive2": results["student_euler@2"]["fid"]
        < results["teacher_euler@2"]["fid"],
        "student2_within_2x_of_full_budget":
            results["student_euler@2"]["fid"] < 2.0 * base,
        "student_chain_monotone_vs_naive": all(
            results[f"student_euler@{n}"]["fid"]
            < results[f"teacher_euler@{n}"]["fid"]
            for n in chain_vars
            if n != 1 and f"teacher_euler@{n}" in results),
        "onestep_within_2x_of_full_budget":
            results["student_onestep@1"]["fid"] < 2.0 * base,
    }
    artifact = {
        "dataset": f"shapes_paper_replica_{args.size}",
        "train_steps": int(state.step),
        "phase_steps": args.phase_steps,
        "nsamples": args.nsamples,
        "model_channels": args.model_channels,
        "feature_space": "pixel (relative comparison only)",
        "chain": [h["nsteps"] for h in history],
        "results": results,
        "claims": claims,
    }
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=2))
    print(f"wrote {out}; claims={claims}")


if __name__ == "__main__":
    main()
