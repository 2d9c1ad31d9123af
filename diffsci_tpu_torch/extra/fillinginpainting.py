"""Grid-of-cubes volume synthesis by inpainting: generate large volumes by
sampling overlapping cubes in a parity-ordered grid, inpainting each new
cube against the already generated neighbours (with optional periodic
wrap).

Port of ``diffsci_tpu/extra/fillinginpainting.py`` (the reference's
``diffsci/extra/fillinginpainting.py:10-440``). Channels-last: volumes
are [1, X, Y, Z, C]; the windows are read and written with the periodic
getitem/setitem of ``utils/periodic.py``. The flow model is the port's
``SIModel`` (``sample(orig_noise=, is_latent_shape=, return_latents=)``,
``inpaint(orig_noise=)``): on the card its corner samples are its graphed
sampler and its inpaints run eagerly.
"""

from __future__ import annotations

import itertools
from typing import Literal

import numpy as np
import torch

from diffsci_tpu_torch.utils import (dict_map, periodic_getitem,
                                     periodic_setitem, resolve_device)


def get_grid_generation_order(grid_map):
    """Positions ordered by coordinate parity pattern (all-even corners
    first), lexicographic within each pattern
    (fillinginpainting.py:10-127). Returns (positions, corner_count)."""
    nx, ny, nz = grid_map
    positions = []
    corner_count = 0
    for parity in itertools.product((0, 1), repeat=3):
        pattern = sorted(
            (i, j, k)
            for i in range(parity[0], nx, 2)
            for j in range(parity[1], ny, 2)
            for k in range(parity[2], nz, 2))
        if parity == (0, 0, 0):
            corner_count = len(pattern)
        positions.extend(pattern)
    return positions, corner_count


def get_cube_spatial_bounds(grid_pos, base_spatial, overlap_size: int,
                            final_spatial, periodicity):
    """Extended (overlapping) slice bounds of the cube at grid_pos
    (fillinginpainting.py:129-187). A periodic window that wraps has
    ``stop < start``."""
    half = overlap_size // 2
    slices = []
    for pos, base, final, per in zip(grid_pos, base_spatial, final_spatial,
                                     periodicity):
        start = pos * base - half
        end = start + base + overlap_size
        if not per:
            start = max(0, start)
            end = min(final, end)
        else:
            start = start % final
            end = end % final
        slices.append(slice(start, end))
    return tuple(slices)


def _span_len(s: slice, size: int) -> int:
    start, stop = s.start, s.stop
    return (stop - start) if stop >= start else (size - start + stop)


def build_inpaint_mask(grid_pos, generated_positions, base_spatial,
                       overlap_size: int, final_spatial, channels: int,
                       periodicity, device=None):
    """Mask = 1 where previously generated cubes cover the current cube's
    extended window (fillinginpainting.py:189-245). Channels-last, on
    ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    ext = [b + overlap_size for b in base_spatial]
    temp = torch.zeros(tuple(final_spatial) + (channels,), device=device)
    ones = torch.ones(tuple(ext) + (channels,), device=device)
    for prev in generated_positions:
        pb = get_cube_spatial_bounds(prev, base_spatial, overlap_size,
                                     final_spatial, periodicity)
        # the write window may be clamped at non-periodic boundaries
        sizes = [_span_len(s, f) for s, f in zip(pb, final_spatial)]
        temp = periodic_setitem(
            temp, ones[tuple(slice(0, n) for n in sizes)], *pb)
    cur = get_cube_spatial_bounds(grid_pos, base_spatial, overlap_size,
                                  final_spatial, periodicity)
    return periodic_getitem(temp, *cur).clamp(0, 1)


def condition_to(y, device):
    """A condition (None or a flat dict) with each value on ``device``;
    arrays that are not tensors become float32, as the JAX package takes
    them."""
    def to_device(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return torch.as_tensor(np.asarray(v, np.float32), device=device)
    return dict_map(to_device, y)


def _condition_grid(y, grid_map, device):
    """One condition for every grid position, as an object array shaped
    like ``grid_map``, each moved to ``device`` once."""
    shared = isinstance(y, dict) or y is None
    grid = np.empty(tuple(grid_map) if shared else np.shape(y), dtype=object)
    if shared:
        y = condition_to(y, device)
    for pos in np.ndindex(*grid.shape):
        grid[pos] = y if shared else condition_to(y[pos], device)
    return grid


def sample_grid_volume(flow_model, generator, grid_map, base_shape,
                       overlap_size: int, y=None, guidance: float = 1.0,
                       nsteps: int = 30, integrate_on_sigma: bool = False,
                       noise_injection: bool = False,
                       blend_mode: Literal["latest"] = "latest",
                       periodicity=(False, False, False),
                       mask_falloff: int = 0, resample_steps: int = 0,
                       noise_cube=None):
    """Tile a [1, X, Y, Z, C] volume from overlapping cubes
    (fillinginpainting.py:298-440), on the flow model's device.

    flow_model: an ``SIModel``. generator: a ``torch.Generator`` on the
    model's device; the noise cube is drawn from it first, then each
    cube's sample or inpaint draws from it in generation order.
    ``noise_cube`` ([1, X, Y, Z, C]) replaces the first draw (the replay
    hook). base_shape: (dx, dy, dz, C), the channels-last cube shape. y:
    None, one condition dict (shared), or a numpy object array of
    condition dicts shaped like grid_map."""
    base_spatial = list(base_shape[:-1])
    channels = base_shape[-1]
    final_spatial = [b * g for b, g in zip(base_spatial, grid_map)]
    for d in range(3):
        if periodicity[d] and grid_map[d] % 2 != 0:
            raise ValueError(
                f"Grid map for dimension {d} is not even, but periodicity "
                "is True")
    if blend_mode != "latest":
        raise ValueError(f"Unknown blend_mode: {blend_mode}")
    device = flow_model.device
    y = _condition_grid(y, grid_map, device)

    if noise_cube is None:
        noise_cube = torch.randn((1,) + tuple(final_spatial) + (channels,),
                                 generator=generator, device=device)
    else:
        noise_cube = torch.as_tensor(noise_cube, dtype=torch.float32,
                                     device=device)
    volume = torch.zeros_like(noise_cube)

    order, corner_count = get_grid_generation_order(grid_map)
    generated: set = set()

    for grid_ind, grid_pos in enumerate(order):
        bounds = get_cube_spatial_bounds(grid_pos, base_spatial,
                                         overlap_size, final_spatial,
                                         periodicity)
        noise_slice = periodic_getitem(noise_cube[0], *bounds)[None]
        ext_shape = tuple(noise_slice.shape[1:])
        y_pos = y[grid_pos[0], grid_pos[1], grid_pos[2]]

        if grid_ind < corner_count:
            cube = flow_model.sample(
                1, ext_shape, generator, y=y_pos, guidance=guidance,
                nsteps=nsteps, is_latent_shape=True,
                integrate_on_sigma=integrate_on_sigma,
                noise_injection=noise_injection, orig_noise=noise_slice,
                return_latents=True)
        else:
            mask = build_inpaint_mask(grid_pos, generated, base_spatial,
                                      overlap_size, final_spatial,
                                      channels, periodicity, device)
            x_orig = periodic_getitem(volume[0], *bounds)
            cube = flow_model.inpaint(
                x_orig, mask, nsamples=1, generator=generator, y=y_pos,
                guidance=guidance, nsteps=nsteps,
                integrate_on_sigma=integrate_on_sigma,
                mask_falloff=mask_falloff, resample_steps=resample_steps,
                orig_noise=noise_slice)

        volume = periodic_setitem(volume[0], cube[0], *bounds)[None]
        generated.add(grid_pos)
    return volume


__all__ = ["build_inpaint_mask", "get_cube_spatial_bounds",
           "get_grid_generation_order", "sample_grid_volume"]
