"""The VAE runtime (``models/vae/module.py``)."""

from diffsci_tpu_torch.models.vae.module import (
    BoundAutoencoder, KLAnnealing, NLayerDiscriminator, VAEModel,
    VAEModelConfig, VAETrainState, create_vae_train_state,
    default_vae_optimizer, make_vae_train_step, total_variation)

__all__ = ["BoundAutoencoder", "KLAnnealing", "NLayerDiscriminator",
           "VAEModel", "VAEModelConfig", "VAETrainState",
           "create_vae_train_state", "default_vae_optimizer",
           "make_vae_train_step", "total_variation"]
