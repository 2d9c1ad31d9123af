from diffsci_tpu_torch.models.ddpm import DDPMModel, DDPMModelConfig
from diffsci_tpu_torch.models.karras import (
    EMATracker, EnsembleKarrasModel, EnsembleKarrasModelConfig,
    IntervalGuidance, KarrasEncoderModel, KarrasModel, KarrasModelConfig,
    KarrasNet, autoregressive_sample, make_ensemble_train_step,
    accumulate_gradients, cosine_restarts_schedule, create_train_state,
    default_optimizer, freeze_optimizer, karras_model_from_description,
    make_eval_step, make_train_scan, make_train_step,
    renormalize_mp_weights, schedule_free_eval_params,
    schedule_free_optimizer, warmup_cosine_schedule)
from diffsci_tpu_torch.models.nets import (AutoencoderKL, DDConfig, HFNet,
                                           HFNetCond, HFNetUncond, MLPCond,
                                           MLPUncond, PUNetG, PUNetGCond,
                                           PUNetGConfig, UNet2D)
from diffsci_tpu_torch.models.vae import BoundAutoencoder, VAEModel, \
    VAEModelConfig

__all__ = ["AutoencoderKL", "BoundAutoencoder", "DDConfig", "DDPMModel",
           "DDPMModelConfig", "EMATracker", "EnsembleKarrasModel",
           "EnsembleKarrasModelConfig", "HFNet",
           "HFNetCond", "HFNetUncond", "IntervalGuidance",
           "KarrasEncoderModel", "KarrasModel",
           "KarrasModelConfig", "KarrasNet", "VAEModel", "VAEModelConfig",
           "autoregressive_sample", "make_ensemble_train_step", "MLPCond", "MLPUncond", "PUNetG",
           "PUNetGCond", "PUNetGConfig", "UNet2D", "accumulate_gradients",
           "cosine_restarts_schedule", "create_train_state",
           "default_optimizer", "freeze_optimizer",
           "karras_model_from_description", "make_eval_step",
           "make_train_scan", "make_train_step", "renormalize_mp_weights",
           "schedule_free_eval_params", "schedule_free_optimizer",
           "warmup_cosine_schedule"]
