"""Autoregressive latent rollout: forecast step after step, each
conditioned on a sliding window of the frames before it.

Port of ``diffsci_tpu/models/karras/autoregressive.py``: the conditioning
window is encoded once (re-encoding a VAE sample would change it), each
forecast step is one ``sample`` in the latent space (on the card the
replay of the sampler's graph of its key), the window slides over sample
0's prediction, and every forecast is decoded in one call at the end.

Layouts: the window y['y'] is in the network's layout, unbatched,
[cond_time·C, *spatial] (frame t's channels at t·C ... t·C + C − 1); the
frame buffer is [cond_time, C, *spatial], so window and frames are one
reshape apart. Forecasts are channels-last, as every sample.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from diffsci_tpu_torch.utils import get_minibatch_sizes


def frames_to_window(frames: torch.Tensor) -> torch.Tensor:
    """[T, C, *spatial] frame buffer -> [T·C, *spatial] window."""
    return frames.reshape((-1,) + tuple(frames.shape[2:]))


def window_to_frames(window: torch.Tensor, cond_time: int) -> torch.Tensor:
    """Inverse of ``frames_to_window``."""
    return window.reshape((cond_time, -1) + tuple(window.shape[1:]))


def autoregressive_sample(model, nsamples: int, latent_shape,
                          nsteps_forecast: int, cond_time: int,
                          nsteps_diffusion: int = 50,
                          y: Optional[dict] = None,
                          y_already_encoded: bool = False,
                          guidance: float = 1.0,
                          maximum_batch_size: int | None = None,
                          return_intermediate: bool = False,
                          return_in_latent: bool = False,
                          generator=None) -> dict[str, Any]:
    """Roll ``model`` (a conditional ``KarrasModel``) out over
    ``nsteps_forecast`` steps of ``nsamples`` samples each.

    ``latent_shape``: channels-last, no batch, e.g. (H, W, C).
    ``y['y']``: the unbatched window [cond_time·C, *spatial] (pixel space
    unless ``y_already_encoded``; with ``encode_y`` the model's
    ``encode`` must then return (x, y)); every item of y is given the
    sample batch. Each step draws from ``generator`` as ``sample`` does.
    Returns {"forecasts": [F, B, *data], "final_forecast": [B, *data]},
    decoded, plus "intermediate_latent" [F, B, *latent] with
    ``return_intermediate``; with ``return_in_latent`` {"forecasts",
    "final_forecast_latent"} in the latent space."""
    if maximum_batch_size is not None:
        results = [autoregressive_sample(
            model, bs, latent_shape, nsteps_forecast, cond_time,
            nsteps_diffusion, y, y_already_encoded, guidance, None,
            return_intermediate, return_in_latent, generator)
            for bs in get_minibatch_sizes(nsamples, maximum_batch_size)]
        out = {"forecasts": torch.cat([r["forecasts"] for r in results],
                                      dim=1)}
        for k in ("final_forecast", "final_forecast_latent"):
            if k in results[0]:
                out[k] = torch.cat([r[k] for r in results], dim=0)
        if return_intermediate and "intermediate_latent" in results[0]:
            out["intermediate_latent"] = torch.cat(
                [r["intermediate_latent"] for r in results], dim=1)
        return out

    if y is None or "y" not in y:
        raise ValueError("y['y'] must be provided")
    y = dict(y)
    if not y_already_encoded and model.encode_y:
        dummy = torch.zeros((1,) + tuple(y["y"].shape[1:]) + (1,),
                            device=y["y"].device)
        with torch.no_grad():
            _, y_encoded, _ = model.encode(dummy, y)
        y.update(y_encoded if isinstance(y_encoded, dict)
                 else {"y": y_encoded})
        if y["y"].shape[0] == 1 and y["y"].ndim == len(latent_shape) + 1:
            y["y"] = y["y"][0]

    frames = window_to_frames(y["y"], cond_time)       # [T, C, *spatial]
    forecasts = []
    for step in range(nsteps_forecast):
        batched = {k: v[None].expand((nsamples,) + tuple(v.shape))
                   for k, v in y.items()}
        pred = model.sample(nsamples, tuple(latent_shape), generator,
                            y=batched, guidance=guidance,
                            nsteps=nsteps_diffusion, is_latent_shape=True,
                            return_in_latent_space=True)
        forecasts.append(pred)
        if step < nsteps_forecast - 1:
            # the window slides over sample 0's prediction, for all
            frames = torch.cat([frames[1:], pred[0].movedim(-1, 0)[None]],
                               dim=0)
            y = dict(y, y=frames_to_window(frames))

    forecasts_latent = torch.stack(forecasts, dim=0)   # [F, B, *latent]
    if return_in_latent:
        return {"forecasts": forecasts_latent,
                "final_forecast_latent": forecasts_latent[-1]}
    F, B = forecasts_latent.shape[:2]
    with torch.inference_mode():
        decoded = model.decode(
            forecasts_latent.reshape((F * B,) + tuple(latent_shape)), y)
    forecasts_pixel = decoded.reshape((F, B) + tuple(decoded.shape[1:]))
    result = {"forecasts": forecasts_pixel,
              "final_forecast": forecasts_pixel[-1]}
    if return_intermediate:
        result["intermediate_latent"] = forecasts_latent
    return result
