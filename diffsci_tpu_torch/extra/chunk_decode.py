"""Exact tiled VAE decode for volumes too large to decode in one shot.

Port of ``diffsci_tpu/extra/chunk_decode.py`` (the reference's
``diffsci/extra/chunk_decode.py``, "Strategy B"). ``tiled_decode`` is the
single-device memory-bounded decode: a host loop over tiles; each tile
reads its latent window plus a full-receptive-field halo (periodic wrap or
clamped), decodes it through the whole network, and writes back only the
valid centre into a host buffer, so device memory stays bounded by one
tile. It works in the port's autoencoder layout [B, C, *spatial].

Exactness contract (as the reference's, chunk_decode.py:150-154): the
decoder must be local, with no mid attention and no attention
resolutions. A GroupNorm that reduces over the whole tile makes the result
depend on the tiling, in the reference and in the JAX package too; a
decoder without such norms tiles exactly.

``halo_shard_decode`` (the JAX package's decode sharded over a device
mesh) is not ported yet: it waits for the port's parallel modes.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Sequence

import torch


def decoder_halo_radius(config) -> int:
    """Full receptive-field radius of the LDM VAEDecoder in LATENT units
    (the analogue of the reference's cumulative radii,
    chunk_decode.py:135-177), for a ``DDConfig``.

    Each 3x3 conv adds radius 1 at its own resolution = 1/scale latent
    units; upsampling doubles the scale."""
    if config.has_mid_attn or len(config.attn_resolutions) > 0:
        raise NotImplementedError(
            "exact tiled decode requires a decoder without attention "
            "(set has_mid_attn=False, attn_resolutions=())")
    r = 0.0
    scale = 1.0
    r += 1.0                      # conv_in
    r += 2 * 2                    # mid: two resblocks, two 3x3 convs each
    n_res = len(config.ch_mult)
    for i_level in reversed(range(n_res)):
        r += 2 * (config.num_res_blocks + 1) / scale
        if i_level != 0:
            scale *= 2            # upsample
    r += 1.0 / scale              # conv_out
    return math.ceil(r)


def upscale_factor(config) -> int:
    return 2 ** (len(config.ch_mult) - 1)


@torch.no_grad()
def tiled_decode(decode_fn: Callable, z: torch.Tensor, chunk: Sequence[int],
                 halo: int, upscale: int, periodic: bool = True):
    """Decode the latent z = [B, C, *spatial] tile by tile on z's device.

    decode_fn: the full decoder, [B, C, *tile_spatial] -> [B, C_out,
    *tile_spatial*u]. ``chunk``: tile size per spatial dim (latent units).
    ``halo``: latent-unit halo radius (``decoder_halo_radius``). Each
    tile's valid centre is copied into a host buffer (pinned when z is on
    the card), which is returned: [B, C_out, *spatial*u] on the CPU."""
    spatial = tuple(z.shape[2:])
    ndim = len(spatial)
    assert len(chunk) == ndim
    pin = z.device.type == "cuda"
    out = None

    def spans(L, c):
        return [(s, min(s + c, L)) for s in range(0, L, c)]

    grids = [spans(L, c) for L, c in zip(spatial, chunk)]
    for tile in itertools.product(*grids):
        # read the window with its halo (wrapped or clamped)
        window = z
        for d, ((lo, hi), L) in enumerate(zip(tile, spatial)):
            ids = torch.arange(lo - halo, hi + halo, device=z.device)
            ids = ids % L if periodic else ids.clamp(0, L - 1)
            window = window.index_select(2 + d, ids)
        decoded = decode_fn(window)
        if out is None:
            out = torch.empty(tuple(decoded.shape[:2]) + tuple(
                upscale * L for L in spatial), dtype=decoded.dtype,
                pin_memory=pin)
        # crop the valid centre and write it back
        crop = [slice(None)] * 2
        dest = [slice(None)] * 2
        for lo, hi in tile:
            crop.append(slice(halo * upscale,
                              halo * upscale + (hi - lo) * upscale))
            dest.append(slice(lo * upscale, hi * upscale))
        out[tuple(dest)].copy_(decoded[tuple(crop)], non_blocking=pin)
    if pin:
        torch.cuda.synchronize(z.device)
    return out


def halo_shard_decode(decode_fn: Callable, z, mesh, axis_name: str = "spatial",
                      halo: int = 8, upscale: int = 4):
    """The decode sharded over a device mesh with halo exchange: not
    ported yet (it waits for the port's parallel modes)."""
    raise NotImplementedError(
        "halo_shard_decode (a device mesh) is not ported yet; use "
        "tiled_decode on one card")


__all__ = ["decoder_halo_radius", "halo_shard_decode", "tiled_decode",
           "upscale_factor"]
