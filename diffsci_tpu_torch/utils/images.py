"""Image grids of samples, and a PNG writer with no imaging library.

The port's own copy of ``diffsci_tpu/utils/images.py``:
``make_image_grid`` tiles a batch of channels-last images into one array,
the same array as the JAX package's; ``save_image_grid`` writes it as an
8-bit PNG with ``zlib`` and ``struct`` from the standard library, so
nothing needs matplotlib.
"""

from __future__ import annotations

import math
import pathlib
import struct
import zlib

import numpy as np

_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}   # gray, gray+alpha, RGB, RGBA


def make_image_grid(images, nrow: int | None = None, pad: int = 2,
                    pad_value: float = 0.0) -> np.ndarray:
    """Tile [N, H, W, C] into one [gh·(H + pad) + pad, gw·(W + pad) + pad,
    C] array, row-major, ``nrow`` images a row (default ⌈√N⌉)."""
    imgs = np.asarray(images)
    if imgs.ndim != 4:
        raise ValueError(f"expected [N, H, W, C], got shape {imgs.shape}")
    n, h, w, c = imgs.shape
    gw = nrow if nrow is not None else int(math.ceil(math.sqrt(n)))
    gh = int(math.ceil(n / gw))
    grid = np.full((gh * (h + pad) + pad, gw * (w + pad) + pad, c),
                   pad_value, dtype=imgs.dtype)
    for i in range(n):
        r, col = divmod(i, gw)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = imgs[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, pixels: np.ndarray) -> pathlib.Path:
    """Write uint8 pixels [H, W, C] (C of 1 to 4) as a PNG: 8 bits a
    channel, every row with filter 0, one zlib stream."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    h, w, c = pixels.shape
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           pixels.reshape(h, w * c)], axis=1)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                     + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                     + _chunk(b"IEND", b""))
    return path


def save_image_grid(path, images, nrow: int | None = None,
                    value_range: tuple[float, float] = (-1.0, 1.0)):
    """Write a sample batch as a PNG grid: values mapped from
    ``value_range`` to [0, 1], clipped, and rounded to 8 bits (grayscale
    for one channel). Returns the path."""
    grid = make_image_grid(np.asarray(images, np.float32), nrow=nrow,
                           pad_value=value_range[0])
    lo, hi = value_range
    grid = np.clip((grid - lo) / (hi - lo + 1e-12), 0.0, 1.0)
    return write_png(path, np.round(grid * 255.0).astype(np.uint8))
