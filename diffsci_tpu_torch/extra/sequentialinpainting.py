"""Sequential z-stacking volume synthesis with cosine blending.

Port of ``diffsci_tpu/extra/sequentialinpainting.py`` (the reference's
``diffsci/extra/sequentialinpainting.py:37-330``): extend a volume along
z by generating overlapping blocks; each new block is inpainted against
the previous block's overlap and stitched with cosine blending.

Channels-last: blocks are [dx, dy, dz, C]; the stacking axis is the THIRD
spatial axis (index 2), the reference's z-last spatial order. The flow
model is the port's ``SIModel``.
"""

from __future__ import annotations

import math
from typing import Literal

import torch

from diffsci_tpu_torch.extra.fillinginpainting import condition_to
from diffsci_tpu_torch.utils import resolve_device


def create_cosine_blend_weights(overlap_size: int, device=None):
    """0 -> 1 cosine ramp over the overlap (sequentialinpainting.py:37-56),
    on ``device`` (default: the CUDA card)."""
    t = torch.linspace(0.0, 1.0, overlap_size, device=resolve_device(device))
    return (1 - torch.cos(math.pi * t)) / 2


def build_inpaint_mask_sequential(block_spatial, channels: int,
                                  overlap_size: int, device=None):
    """Mask = 1 on the first overlap_size voxels along z
    (sequentialinpainting.py:58-81), on ``device`` (default: the CUDA
    card)."""
    mask = torch.zeros(tuple(block_spatial) + (channels,),
                       device=resolve_device(device))
    mask[:, :, :overlap_size] = 1.0
    return mask


def sample_sequential_z(flow_model, generator, num_blocks: int, base_shape,
                        overlap_size: int, y=None, guidance: float = 1.0,
                        nsteps: int = 30, integrate_on_sigma: bool = False,
                        noise_injection: bool = True,
                        blend_mode: Literal["cosine", "latest"] = "cosine",
                        mask_falloff: int = 0, resample_steps: int = 0):
    """Generate [1, dx, dy, num_blocks*dz, C] by sequential z inpainting
    (sequentialinpainting.py:83-330), on the flow model's device.
    base_shape = (dx, dy, dz, C); each block's sample or inpaint draws
    from ``generator`` in turn. y: None, one condition dict (shared) or
    one per block."""
    if num_blocks < 1:
        raise ValueError("num_blocks must be at least 1")
    if overlap_size < 0:
        raise ValueError("overlap_size must be non-negative")
    if overlap_size % 2 != 0:
        raise ValueError("overlap_size must be even")
    dx, dy, dz, channels = base_shape
    if overlap_size >= dz:
        raise ValueError(
            "overlap_size must be less than base block z-dimension")
    half = overlap_size // 2

    if isinstance(y, dict) or y is None:
        conditions = [y] * num_blocks
    else:
        conditions = list(y)
    if len(conditions) != num_blocks:
        raise ValueError(
            f"Expected {num_blocks} conditions, got {len(conditions)}")

    device = flow_model.device
    conditions = [condition_to(c, device) for c in conditions]
    final_dz = dz * num_blocks
    volume = torch.zeros((1, dx, dy, final_dz, channels), device=device)
    prev_block = None

    for i in range(num_blocks):
        is_first = i == 0
        is_last = i == num_blocks - 1
        if num_blocks == 1:
            ext_dz = dz
        elif is_first or is_last:
            ext_dz = dz + half
        else:
            ext_dz = dz + overlap_size
        ext_shape = (dx, dy, ext_dz, channels)
        z0 = i * dz
        z1 = z0 + dz

        if is_first:
            block = flow_model.sample(
                1, ext_shape, generator, y=conditions[i], guidance=guidance,
                nsteps=nsteps, is_latent_shape=True,
                integrate_on_sigma=integrate_on_sigma,
                noise_injection=noise_injection, return_latents=True)[0]
            volume[0, :, :, z0:z1] = block[:, :, :dz]
        else:
            x_orig = torch.zeros(ext_shape, device=device)
            x_orig[:, :, :overlap_size] = prev_block[:, :, -overlap_size:]
            mask = build_inpaint_mask_sequential((dx, dy, ext_dz), channels,
                                                 overlap_size, device)
            block = flow_model.inpaint(
                x_orig, mask, nsamples=1, generator=generator,
                y=conditions[i], guidance=guidance, nsteps=nsteps,
                integrate_on_sigma=integrate_on_sigma,
                mask_falloff=mask_falloff,
                resample_steps=resample_steps)[0]
            ov0 = z0 - half
            ov1 = z0 + half
            if blend_mode == "cosine":
                w = create_cosine_blend_weights(overlap_size, device).reshape(
                    1, 1, overlap_size, 1)
                current = volume[0, :, :, ov0:ov1]
                new = block[:, :, :overlap_size]
                volume[0, :, :, ov0:ov1] = current * (1 - w) + new * w
                volume[0, :, :, ov1:z1] = \
                    block[:, :, overlap_size:overlap_size + (z1 - ov1)]
            elif blend_mode == "latest":
                volume[0, :, :, ov0:z1] = block[:, :, :half + dz]
            else:
                raise ValueError(f"Unknown blend_mode: {blend_mode}")
        prev_block = block
    return volume


__all__ = ["build_inpaint_mask_sequential", "create_cosine_blend_weights",
           "sample_sequential_z"]
