"""Entropy and score-error time profiles over training, the
stochasticity paper's secondary analysis.

Port of ``scripts/entropy_time_profile.py``: trains a small 1D MLP score
model on a two-component Gaussian mixture, and for every snapshot on a
step grid computes

1. ``sde_entropies`` / ``inv_sde_entropies``: histogram KL divergences in
   both directions (H(~p||p), H(p||~p); ``approx_entropy1``'s
   bin-count-averaged estimator) between SDE-sampled points and the data,
   across a γ grid biased toward small γ (``custom_spacing``);
2. ``score_errors`` and ``dsm_losses``: along the sampler's own SDE
   trajectory at γ ≈ 1, the score's squared error against the analytic
   noised-mixture score and the σ⁻⁴-weighted denoising loss against the
   trajectory's endpoint.

Output: one JSON (default docs/artifacts/entropy_time_profile.json) that
``correlation_thresholds`` reads. The mixture's and the sampler's draws
come from torch generators, so the numbers are not the JAX script's.

Usage:
    python -m diffsci_tpu_torch.scripts.entropy_time_profile
        [--train-steps 3000] [--snapshot-every 250] [--nsteps 100]
        [--ngamma 8] [--device cuda]
"""

import argparse
import json
import pathlib

import numpy as np

from diffsci_tpu_torch.scripts._common import add_device_flag, host
from diffsci_tpu_torch.utils import resolve_device


def custom_spacing(min_val, max_val, n, alpha=0.5):
    """Non-uniform γ spacing biased toward small values."""
    lin = np.linspace(min_val ** alpha, max_val ** alpha, n)
    return lin ** (1.0 / alpha)


def approx_entropy1(samples, samples_ref, epsilon=1e-12, nbins=100):
    """KL(samples || samples_ref) from histograms, averaged over a range
    of bin counts: scipy's entropy(p, q) of density histograms, skipping
    nb % 4 == 0 as the reference does."""
    from scipy.stats import entropy
    s = np.asarray(samples, np.float64).ravel()
    r = np.asarray(samples_ref, np.float64).ravel()
    lo = float(min(s.min(), r.min()))
    hi = float(max(s.max(), r.max()))
    kls = []
    for nb in range(nbins - 20, nbins):
        if nb % 4 == 0:
            continue
        bins = np.linspace(lo, hi, nb)
        p = np.histogram(s, bins=bins, density=True)[0] + epsilon
        q = np.histogram(r, bins=bins, density=True)[0] + epsilon
        kls.append(entropy(p, q))
    return float(np.mean(kls))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-steps", type=int, default=3000)
    ap.add_argument("--snapshot-every", type=int, default=250)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--nsamples", type=int, default=4000)
    ap.add_argument("--nsteps", type=int, default=100)
    ap.add_argument("--ngamma", type=int, default=8)
    ap.add_argument("--gamma-max", type=float, default=8.0)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--datasize", type=int, default=2000,
                    help="trajectory rows used for the error profile")
    ap.add_argument("--out",
                    default="docs/artifacts/entropy_time_profile.json")
    ap.add_argument("--platform", default="cpu",
                    choices=["cpu", "default"],
                    help="accepted for the JAX script's command line and "
                         "ignored: --device alone says where the study "
                         "runs (--device cpu for the CPU)")
    add_device_flag(ap)
    args = ap.parse_args()

    import torch
    from diffsci_tpu_torch import data, ops
    from diffsci_tpu_torch.models import (KarrasModel, KarrasModelConfig,
                                          MLPUncond, create_train_state,
                                          default_optimizer, make_train_step)

    device = resolve_device(args.device)
    # the reference's mixt_gauss2 analogue: two 1D modes
    ds = data.MixtureOfGaussiansDataset(
        num_samples=args.nsamples, means=[[-2.0], [2.0]],
        weights=[1.0, 1.0], scale=0.3)
    data_samples = ds.sample(torch.Generator().manual_seed(0)).numpy()

    model = KarrasModel(MLPUncond(1, (128, 128, 128), device=device),
                        KarrasModelConfig.from_edm(), device=device)
    state, tx = create_train_state(model, (args.batch, 1), seed=0,
                                   optimizer=default_optimizer(args.lr))
    step_fn = make_train_step(model, tx)

    gammas = custom_spacing(1e-3, args.gamma_max, args.ngamma, args.alpha)
    nsteps = args.nsteps
    sched0 = ops.EDMScheduler()
    t_grid = sched0.create_steps(nsteps + 1)
    sigma_grid = np.asarray(sched0.scheduling.noise(t_grid[:nsteps]),
                            np.float64)
    g_profile = float(min(gammas, key=lambda g: abs(g - 1.0)))
    samplers = {float(g): ops.EDMScheduler(langevin_const=float(g))
                for g in gammas}
    # every step's σ for each of its datasize rows, for one batched call
    sig_rows = torch.from_numpy(np.repeat(sigma_grid, args.datasize)
                                .astype(np.float32)).to(device)

    @torch.no_grad()
    def score_fn(x, sigma):
        return model.get_score(x, sigma)

    @torch.no_grad()
    def error_profile(hist):
        """Score error against the analytic oracle and the σ⁻⁴ DSM loss at
        every trajectory step, the steps batched into one call."""
        x0 = hist[-1, :args.datasize]
        x = hist[:nsteps, :args.datasize].reshape(-1, 1)
        s_model = model.get_score(x, sig_rows)
        s_true = ds.gradlogprob(x, sig_rows)
        den, _ = model.get_denoiser(x, sig_rows)
        per = (nsteps, -1)
        se = ((s_model - s_true) ** 2).reshape(per).mean(dim=1)
        dsm = ((den.reshape(nsteps, -1, 1) - x0) ** 2).reshape(per).mean(
            dim=1) / torch.from_numpy(sigma_grid).float().to(device) ** 4
        return host(se).tolist(), host(dsm).tolist()

    def profile_snapshot(gen):
        """Entropies over the γ grid, and the error profile along the
        γ ≈ 1 SDE trajectory (the reference profiles the stochastic
        trajectory it also samples from)."""
        prior = (torch.randn((args.nsamples, 1), generator=gen,
                             device=device) * sched0.maximum_scale)
        sde_entropies, inv_sde_entropies = [], []
        history = None
        for g in gammas:
            out = samplers[float(g)].propagate_backward(
                prior, score_fn, nsteps=nsteps, stochastic=True,
                record_history=True, generator=gen)
            samp = host(out[-1])
            sde_entropies.append(approx_entropy1(samp, data_samples))
            inv_sde_entropies.append(approx_entropy1(data_samples, samp))
            if float(g) == g_profile:
                history = out
        se, dl = error_profile(history)
        return (list(map(float, gammas)), sde_entropies, inv_sde_entropies,
                [float(v) for v in se], [float(v) for v in dl])

    snapshots = {}
    xs = torch.from_numpy(data_samples).to(device)
    rng = np.random.default_rng(1)
    gen = torch.Generator(device).manual_seed(2)
    for step in range(1, args.train_steps + 1):
        idx = torch.from_numpy(rng.integers(0, args.nsamples,
                                            size=args.batch)).to(device)
        state, metrics = step_fn(state, xs[idx], generator=gen)
        if step % args.snapshot_every == 0:
            gv, ent, inv_ent, err, dsm = profile_snapshot(gen)
            snapshots[step] = {
                "gamma_values": gv, "sde_entropies": ent,
                "inv_sde_entropies": inv_ent, "score_errors": err,
                "dsm_losses": dsm,
                "train_loss": float(metrics["train_loss"]),
            }
            print(f"step {step}: loss={snapshots[step]['train_loss']:.4f} "
                  f"KL(~p|p) ode~{ent[0]:.4f} min={min(ent):.4f}",
                  flush=True)

    out = {
        "dataset": "MixtureOfGaussians 1D means=[-2,2] scale=0.3",
        "nsteps": nsteps,
        "sigma_grid": list(map(float, sigma_grid)),
        "snapshots": snapshots,
        "note": ("all_entropies/all_errors counterpart of the reference's "
                 ".pt pair; score_errors use the analytic noised-mixture "
                 "score (toy oracle) where the reference compares against "
                 "a fitted approximation"),
    }
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out))
    print(f"wrote {path} ({len(snapshots)} snapshots)")


if __name__ == "__main__":
    main()
