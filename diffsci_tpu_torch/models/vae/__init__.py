"""The VAE runtime's inference half (``models/vae/module.py``)."""

from diffsci_tpu_torch.models.vae.module import (
    BoundAutoencoder, KLAnnealing, NLayerDiscriminator, VAEModel,
    VAEModelConfig, create_vae_train_state, make_vae_train_step)

__all__ = ["BoundAutoencoder", "KLAnnealing", "NLayerDiscriminator",
           "VAEModel", "VAEModelConfig", "create_vae_train_state",
           "make_vae_train_step"]
