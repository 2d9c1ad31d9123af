"""HFNet: the reference's UNet family around ``diffusers.UNet2DModel``.

Port of ``diffsci_tpu/models/nets/hfnet.py``: ``HFNet``, ``HFNetUncond``
and ``HFNetCond`` on top of the port's ``UNet2D`` (scope ``unet.``, as the
JAX package's ``import_diffusers_unet2d(scope='unet/')``). Conditioning
enters by channel concatenation; ``attn_up_and_down`` puts attention in
every resampling block but the outermost (first down, last up). On NCHW:
x [B, channels, H, W], y [B, cond_channels, H, W].
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from diffsci_tpu_torch.models.nets.ddpm_unet import UNet2D


def _attn_flags(n: int, attn_up_and_down: bool):
    if attn_up_and_down:
        return (False,) + (True,) * (n - 1), (True,) * (n - 1) + (False,)
    return (False,) * n, (False,) * n


class HFNet(nn.Module):
    """UNet2D with the HFNet constructor; a given y is channel-concatenated
    (``cond_channels`` widens the input for it)."""

    def __init__(self, block_channels: Sequence[int] = (64, 128, 256),
                 channels: int = 1, cond_channels: int = 0,
                 norm_num_groups: int = 32, dropout: float = 0.0,
                 attn_up_and_down: bool = False, attn_backend: str = "xla",
                 device: torch.device | str | None = None):
        super().__init__()
        # the constructor's arguments, for export_description
        self.block_channels = tuple(block_channels)
        self.channels, self.cond_channels = channels, cond_channels
        self.norm_num_groups, self.dropout = norm_num_groups, dropout
        self.attn_up_and_down, self.attn_backend = (attn_up_and_down,
                                                    attn_backend)
        attn_down, attn_up = _attn_flags(len(block_channels),
                                         attn_up_and_down)
        self.unet = UNet2D(
            block_out_channels=tuple(block_channels),
            in_channels=channels + cond_channels, out_channels=channels,
            attn_down=attn_down, attn_up=attn_up,
            norm_num_groups=norm_num_groups, dropout=dropout,
            backend=attn_backend, device=device)

    def forward(self, x, t, y=None):
        if y is not None:
            x = torch.cat([x, y], dim=1)
        return self.unet(x, t)

    def export_description(self) -> dict:
        """``{"kind": "hfnet", "config": ...}`` with the JAX package's
        fields (an ``HFNetUncond`` exports as an ``HFNet`` with no
        condition channels, as in the JAX package)."""
        from diffsci_tpu_torch.models.nets.describe import \
            plain_module_description
        return plain_module_description(self, "hfnet", HFNet)


class HFNetUncond(HFNet):
    """The unconditional HFNet (no condition channels)."""

    def __init__(self, block_channels: Sequence[int] = (64, 128, 256),
                 channels: int = 1, norm_num_groups: int = 32,
                 dropout: float = 0.0, attn_up_and_down: bool = False,
                 attn_backend: str = "xla",
                 device: torch.device | str | None = None):
        super().__init__(block_channels, channels, 0, norm_num_groups,
                         dropout, attn_up_and_down, attn_backend, device)


class HFNetCond(HFNet):
    """The channel-concat conditioned HFNet: y is required."""

    def __init__(self, block_channels: Sequence[int] = (64, 128, 256),
                 channels: int = 1, cond_channels: int = 1,
                 norm_num_groups: int = 32, dropout: float = 0.0,
                 attn_up_and_down: bool = False, attn_backend: str = "xla",
                 device: torch.device | str | None = None):
        super().__init__(block_channels, channels, cond_channels,
                         norm_num_groups, dropout, attn_up_and_down,
                         attn_backend, device)

    def forward(self, x, t, y=None):
        if y is None:
            raise ValueError("HFNetCond requires conditioning y")
        return super().forward(x, t, y)

    def export_description(self) -> dict:
        from diffsci_tpu_torch.models.nets.describe import \
            plain_module_description
        return plain_module_description(self, "hfnet_cond", HFNet)
