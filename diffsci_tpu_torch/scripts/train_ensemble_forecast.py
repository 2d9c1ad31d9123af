"""Probabilistic ensemble forecasting with CRPS training.

Port of ``scripts/train_ensemble_forecast.py``: a conditional diffusion
model learns p(next frame | current frame) on an advecting-blob toy
system, trained with the ensemble CRPS loss (E members per example in one
flattened denoiser call), then samples a forecast ensemble on held-out
states and scores CRPS against persistence and the ensemble mean's RMSE.

The condition goes to the network in its layout, [B, 1, S, S]; the
arrays of the task and the image are channels-last.

Writes ``OUTDIR/forecast.png`` (rows: state, truth, one member, ensemble
mean).

    python -m diffsci_tpu_torch.scripts.train_ensemble_forecast
        [--steps 1500] [--ensemble 4] [--device cuda]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from diffsci_tpu_torch.scripts._common import (add_device_flag, channels_first,
                                               host, use_weights)
from diffsci_tpu_torch.utils import resolve_device


def make_advection_pairs(n: int, size: int = 16, shift: int = 2,
                         noise: float = 0.05, seed: int = 0):
    """(x_t, x_{t+1}) pairs: a Gaussian blob advecting +shift pixels in x
    (periodic) with small stochastic forcing."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cx = rng.uniform(0, size, n)
    cy = rng.uniform(4, size - 4, n)
    s = rng.uniform(1.5, 2.5, n)

    def field(cx_, cy_, s_):
        dx = np.minimum(np.abs(xx - cx_[:, None, None]),
                        size - np.abs(xx - cx_[:, None, None]))
        return np.exp(-(dx ** 2 + (yy - cy_[:, None, None]) ** 2)
                      / (2 * s_[:, None, None] ** 2))

    x_t = field(cx, cy, s)
    jitter = rng.normal(0, 0.5, n)  # stochastic advection speed
    x_tp1 = field((cx + shift + jitter) % size, cy, s)
    x_tp1 += rng.normal(0, noise, x_tp1.shape)
    to = lambda a: (a[..., None] * 2.0 - 1.0).astype(np.float32)  # noqa
    return to(x_t), to(x_tp1)


def build(args, device):
    """The recipe's model, EMA tracker and optimizer (None: the
    default): (model, ema, tx)."""
    from diffsci_tpu_torch.models import (EMATracker, EnsembleKarrasModel,
                                          EnsembleKarrasModelConfig,
                                          KarrasModelConfig, PUNetGCond,
                                          PUNetGConfig)
    cfg = PUNetGConfig(model_channels=args.channels, channel_expansion=[2],
                       input_channels=2, output_channels=1,
                       number_resnet_downward_block=1,
                       number_resnet_upward_block=1,
                       number_resnet_attn_block=1,
                       number_resnet_before_attn_block=1,
                       number_resnet_after_attn_block=1)
    net = PUNetGCond(cfg, channel_conditional_items=("state",),
                     device=device)
    config = EnsembleKarrasModelConfig.from_karras_config(
        KarrasModelConfig.from_edm(loss_metric="crps"),
        ensemble_size_train=args.ensemble)
    model = EnsembleKarrasModel(net, config, conditional=True, device=device)
    ema = EMATracker(ema_type="power", power_function_stds=[0.05])
    return model, ema, None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--ensemble", type=int, default=4)
    ap.add_argument("--eval-ensemble", type=int, default=8)
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--outdir", default="runs/forecast")
    add_device_flag(ap)
    args = ap.parse_args()

    import torch
    from diffsci_tpu_torch.data.loading import ArrayDataLoader, tree_map
    from diffsci_tpu_torch.models import (create_train_state,
                                          make_ensemble_train_step)
    from diffsci_tpu_torch.ops.losses import crps_ensemble
    from diffsci_tpu_torch.utils import save_image_grid

    device = resolve_device(args.device)
    x_t, x_tp1 = make_advection_pairs(4096, size=args.size)
    print(f"pairs: {x_t.shape} -> {x_tp1.shape}, device: {device}")
    model, ema, _ = build(args, device)
    state, tx = create_train_state(
        model, (args.batch, args.size, args.size, 1), seed=0, ema=ema)
    step_fn = make_ensemble_train_step(model, tx, ema=ema)

    n_hold = 64
    loader = ArrayDataLoader(
        (x_tp1[:-n_hold], {"state": channels_first(x_t[:-n_hold])}),
        args.batch, seed=0)
    gen = torch.Generator(device).manual_seed(1)
    step = 0
    while step < args.steps:
        for batch in loader:
            x, y = tree_map(lambda a: torch.from_numpy(a).to(device), batch)
            state, metrics = step_fn(state, x, y, generator=gen)
            step += 1
            if step % 200 == 0:
                print(f"  step {step}: crps_loss="
                      f"{float(metrics['train_loss']):.4f}", flush=True)
            if step >= args.steps:
                break

    # --- probabilistic evaluation on held-out states ---
    use_weights(model, state.ema_variables(ema))
    cond = {"state": torch.from_numpy(channels_first(x_t[-n_hold:])).to(
        device)}
    target = x_tp1[-n_hold:]
    members = [host(model.sample(n_hold, (args.size, args.size, 1), gen,
                                 y=cond, nsteps=18))
               for _ in range(args.eval_ensemble)]
    ensemble = np.stack(members, axis=1)  # [B, E, H, W, 1]

    crps_model = float(crps_ensemble(torch.from_numpy(ensemble),
                                     torch.from_numpy(target)))
    crps_persist = float(crps_ensemble(torch.from_numpy(x_t[-n_hold:, None]),
                                       torch.from_numpy(target)))
    rmse_mean = float(np.sqrt(np.mean((ensemble.mean(1) - target) ** 2)))
    rmse_persist = float(np.sqrt(np.mean((x_t[-n_hold:] - target) ** 2)))
    better = crps_model < crps_persist
    print(f"CRPS: ensemble({args.eval_ensemble}) {crps_model:.4f} vs "
          f"persistence {crps_persist:.4f} "
          f"({'BETTER' if better else 'WORSE'})")
    print(f"RMSE: ensemble-mean {rmse_mean:.4f} vs persistence "
          f"{rmse_persist:.4f}")

    outdir = pathlib.Path(args.outdir)
    grid = np.concatenate([x_t[-8:], target[:8], ensemble[:8, 0],
                           ensemble[:8].mean(1)])
    save_image_grid(outdir / "forecast.png", grid, nrow=8)
    print(f"saved rows [state / truth / one member / ensemble mean] to "
          f"{outdir}/forecast.png")


if __name__ == "__main__":
    main()
