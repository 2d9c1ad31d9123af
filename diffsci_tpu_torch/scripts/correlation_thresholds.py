"""Correlation-threshold scan over entropy/error time profiles.

Port of ``scripts/correlation_thresholds.py``: reads
``entropy_time_profile``'s JSON and, over a triangular (initial, final)
time-threshold grid plus an independent late-threshold grid, computes
Pearson and Spearman correlations across the training snapshots between

  improvement   I = (KL(γ_min) − min KL) / min KL
                  against  E_early/mid = Σ err[:s_i] / Σ err[s_i:s_f]
  deterioration D = log((KL(γ_max) − min KL) / min KL)
                  against  E_late/tot  = Σ err[s_l:] / Σ err

for both KL directions. Thresholds are diffusion times, snapped to grid
steps by the EDM scheduler (a larger time is a smaller step index, so a
valid (initial, final) pair has initial > final). Writes a CSV beside the
input (or ``--out``), the reference's columns. The analysis is host
arithmetic; ``--device`` is checked as every script's is.

Usage:
    python -m diffsci_tpu_torch.scripts.correlation_thresholds
        [--input docs/artifacts/entropy_time_profile.json]
        [--epoch-threshold 1] [--nsteps 100]
        [--initial-range 0.3 0.9 4] [--final-range 0.05 0.4 4]
        [--late-range 0.01 0.2 5] [--device cuda]
"""

import argparse
import csv
import json
import pathlib

import numpy as np

from diffsci_tpu_torch.scripts._common import add_device_flag
from diffsci_tpu_torch.utils import resolve_device

KL_NAMES = ["H(~p|p)", "H(p|~p)"]


def safe_corr(x, y):
    """Pearson r/p and Spearman rho/p, NaNs on degenerate input."""
    from scipy.stats import pearsonr, spearmanr
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    finite = np.isfinite(x) & np.isfinite(y)
    x, y = x[finite], y[finite]
    if x.size < 2 or np.std(x) == 0 or np.std(y) == 0:
        return np.nan, np.nan, np.nan, np.nan
    pr, pp = pearsonr(x, y)
    sr, sp = spearmanr(x, y)
    return float(pr), float(pp), float(sr), float(sp)


def improvements_deteriorations(snapshots):
    """Per-snapshot scalars from the entropy curves; deteriorations
    log-transformed as in the reference."""
    imps, dets, steps = [], [], []
    for step in sorted(snapshots, key=int):
        snap = snapshots[step]
        imp_row, det_row = [], []
        for ent in (snap["sde_entropies"], snap["inv_sde_entropies"]):
            ent = [float(e) for e in ent]
            m = min(ent)
            imp_row.append((ent[0] - m) / m)
            det_row.append((ent[-1] - m) / m)
        imps.append(imp_row)
        dets.append(det_row)
        steps.append(int(step))
    return steps, np.asarray(imps, float), np.log(np.asarray(dets, float))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input",
                    default="docs/artifacts/entropy_time_profile.json")
    ap.add_argument("--out", default=None,
                    help="CSV path (default: <input>.correlations.csv)")
    ap.add_argument("--nsteps", type=int, default=None,
                    help="sampler grid size (default: from the input)")
    ap.add_argument("--epoch-threshold", type=int, default=0,
                    help="keep snapshots with index > this (cell #73)")
    ap.add_argument("--initial-range", nargs=3, type=float,
                    default=[0.3, 0.9, 4], metavar=("LO", "HI", "N"))
    ap.add_argument("--final-range", nargs=3, type=float,
                    default=[0.05, 0.4, 4], metavar=("LO", "HI", "N"))
    ap.add_argument("--late-range", nargs=3, type=float,
                    default=[0.01, 0.2, 5], metavar=("LO", "HI", "N"))
    add_device_flag(ap)
    args = ap.parse_args()

    from diffsci_tpu_torch import ops

    resolve_device(args.device)
    saved = json.loads(pathlib.Path(args.input).read_text())
    snapshots = saved["snapshots"]
    nsteps = args.nsteps or int(saved["nsteps"])
    sched = ops.EDMScheduler()

    def step_of(t):
        return int(sched.step_from_time(float(t), nsteps))

    steps, imps, dets = improvements_deteriorations(snapshots)
    errors = [np.asarray(snapshots[str(s)]["score_errors"], float)
              for s in steps]
    mask = np.arange(len(steps)) > args.epoch_threshold
    imps, dets = imps[mask], dets[mask]
    errors = [e for i, e in enumerate(errors) if mask[i]]
    n = int(mask.sum())
    print(f"{len(steps)} snapshots, {n} after epoch mask "
          f"(index > {args.epoch_threshold})")

    def grid(spec):
        lo, hi, num = spec
        return np.linspace(float(lo), float(hi), int(num))

    rows = []
    for it in grid(args.initial_range):
        for ft in grid(args.final_range):
            if not it > ft:
                continue
            s_i, s_f = step_of(it), step_of(ft)
            if s_i >= s_f:
                continue
            x = [np.sum(e[:s_i]) / np.sum(e[s_i:s_f]) for e in errors]
            for j, name in enumerate(KL_NAMES):
                pr, pp, sr, sp = safe_corr(x, imps[:, j])
                rows.append(dict(
                    type="early_mid_vs_improvement", initial_threshold=it,
                    final_threshold=ft, late_threshold="",
                    step_initial=s_i, step_final=s_f, step_late=-1,
                    kl_index=j, kl_name=name, n=n, pearson_r=pr,
                    pearson_p=pp, spearman_r=sr, spearman_p=sp))
    for lt in grid(args.late_range):
        s_l = step_of(lt)
        x = [np.sum(e[s_l:]) / np.sum(e) for e in errors]
        for j, name in enumerate(KL_NAMES):
            pr, pp, sr, sp = safe_corr(x, dets[:, j])
            rows.append(dict(
                type="late_vs_deterioration", initial_threshold="",
                final_threshold="", late_threshold=lt, step_initial=-1,
                step_final=-1, step_late=s_l, kl_index=j, kl_name=name,
                n=n, pearson_r=pr, pearson_p=pp, spearman_r=sr,
                spearman_p=sp))

    out = pathlib.Path(args.out or (str(args.input) + ".correlations.csv"))
    with open(out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    finite = [r for r in rows if np.isfinite(r["pearson_r"])]
    print(f"wrote {out}: {len(rows)} rows "
          f"({len(finite)} with finite correlations)")
    if finite:
        best = max(finite, key=lambda r: abs(r["pearson_r"]))
        print(f"strongest |pearson|: {best['type']} {best['kl_name']} "
              f"r={best['pearson_r']:.3f} (p={best['pearson_p']:.3g})")


if __name__ == "__main__":
    main()
