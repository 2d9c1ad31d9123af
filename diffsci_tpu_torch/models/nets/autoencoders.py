"""Autoencoder wrappers: the channel expand/squeeze adapter and the
``load_autoencoder`` factory.

Port of ``diffsci_tpu/models/nets/autoencoders.py``. ``ChannelAdapterWrapper``
presents 1-, 2- or 3-channel data to a 3-channel autoencoder (broadcast,
zero pad or pass through on encode; mean, slice or pass through on
decode), or encodes each data channel on its own and concatenates the
latents. Tensors are [B, C, *spatial]: the channel axis is 1. The wrapped
object follows the port's autoencoder protocol (``encode(x, y=None,
eps=None)``, ``decode(z, y=None)``, ``sample_posterior``; see
``models/vae/module.py:BoundAutoencoder``).
"""

from __future__ import annotations

from typing import Any

import torch

from diffsci_tpu_torch.models.nets.vae import AutoencoderKL, DDConfig


class ChannelAdapterWrapper:
    """Channel expand/squeeze around a bound 3-channel autoencoder.

    ``channels``: the data channels shown to it (1: broadcast to RGB, 2:
    zero-pad, 3: as they are). ``independent_channels``: encode each of
    ``data_channels`` on its own (its latents ``latent_channels`` wide)
    and concatenate; ``eps`` (the posterior draw) is then split the same
    way."""

    def __init__(self, autoencoder, channels: int = 1,
                 independent_channels: bool = False,
                 data_channels: int = 1, latent_channels: int = 4):
        self.autoencoder = autoencoder
        self.channels = channels
        self.independent_channels = independent_channels
        self.data_channels = data_channels
        self.latent_channels = latent_channels

    @property
    def sample_posterior(self) -> bool:
        return getattr(self.autoencoder, "sample_posterior", False)

    def expand_channels(self, x):
        if self.channels == 1:
            return x.expand((x.shape[0], 3) + tuple(x.shape[2:]))
        if self.channels == 2:
            return torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        if self.channels == 3:
            return x
        raise ValueError(f"Invalid number of channels: {self.channels}")

    def squeeze_channels(self, x):
        if self.channels == 1:
            return x.mean(dim=1, keepdim=True)
        if self.channels == 2:
            return x[:, :2]
        if self.channels == 3:
            return x
        raise ValueError(f"Invalid number of channels: {self.channels}")

    def encode(self, x, y=None, eps=None):
        if self.independent_channels:
            lc = self.latent_channels
            return torch.cat([self.autoencoder.encode(
                self.expand_channels(x[:, ch:ch + 1]),
                eps=None if eps is None else eps[:, lc * ch:lc * (ch + 1)])
                for ch in range(self.data_channels)], dim=1)
        return self.autoencoder.encode(self.expand_channels(x), eps=eps)

    def decode(self, z, y=None):
        if self.independent_channels:
            lc = self.latent_channels
            return torch.cat([self.squeeze_channels(self.autoencoder.decode(
                z[:, lc * ch:lc * (ch + 1)]))
                for ch in range(self.data_channels)], dim=1)
        return self.squeeze_channels(self.autoencoder.decode(z))

    def __call__(self, x, eps=None):
        return self.decode(self.encode(x, eps=eps))


def load_autoencoder(name: str = "our_kl", **kwargs) -> Any:
    """'our_kl': an ``AutoencoderKL`` of ``DDConfig(**ddconfig)`` with the
    other keyword arguments (``embed_dim``, ``device``); train or load its
    weights, then bind it with ``models.vae.BoundAutoencoder``. 'kl1' and
    'tiny1' (HF diffusers' SD-VAE and TAESD) raise: diffusers is not a
    dependency; load an SD-VAE state dict into ``AutoencoderKL`` (the
    reference's names) and wrap it in ``ChannelAdapterWrapper``."""
    if name == "our_kl":
        dd = DDConfig(**kwargs.pop("ddconfig", {}))
        return AutoencoderKL(dd, **kwargs)
    if name in ("kl1", "tiny1"):
        raise NotImplementedError(
            f"autoencoder '{name}' wraps an HF diffusers model, which is "
            "not a dependency. Load its torch state dict into "
            "diffsci_tpu_torch.models.nets.vae.AutoencoderKL, then wrap "
            "with ChannelAdapterWrapper.")
    raise ValueError(f"Unknown autoencoder: {name!r}")
