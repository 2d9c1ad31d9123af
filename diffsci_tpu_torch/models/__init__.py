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
from diffsci_tpu_torch.models.karras import (
    EDMModel, EDMModelConfig, distill_progressive, make_distill_step)
from diffsci_tpu_torch.models.nets import VAENet, VAENetConfig
from diffsci_tpu_torch.models import ddpm_v1, regression, sde, si
from diffsci_tpu_torch.models.ddpm_v1 import (DDPMModuleV1, DDPMSchedulerV1,
                                              default_v1_optimizer)
from diffsci_tpu_torch.models.regression import (ForecastModel,
                                                 ForecastModelConfig)
from diffsci_tpu_torch.models.sde import SDEModel
from diffsci_tpu_torch.models.si import SIModel, SIModelConfig, SIScheduler
from diffsci_tpu_torch.models.vae import (
    BoundAutoencoder, KLAnnealing, NLayerDiscriminator, VAEModel,
    VAEModelConfig, VAETrainState, create_vae_train_state,
    default_vae_optimizer, make_vae_train_step)

__all__ = ["AutoencoderKL", "BoundAutoencoder", "DDConfig", "DDPMModel",
           "DDPMModelConfig", "DDPMModuleV1", "DDPMSchedulerV1",
           "ForecastModel", "ForecastModelConfig", "SDEModel", "SIModel",
           "SIModelConfig", "SIScheduler", "ddpm_v1",
           "default_v1_optimizer", "regression", "sde", "si", "EDMModel", "EDMModelConfig", "EMATracker",
           "EnsembleKarrasModel", "KLAnnealing", "NLayerDiscriminator",
           "VAENet", "VAENetConfig", "VAETrainState",
           "create_vae_train_state", "default_vae_optimizer",
           "distill_progressive", "make_distill_step",
           "make_vae_train_step",
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
