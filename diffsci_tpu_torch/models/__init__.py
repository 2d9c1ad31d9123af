from diffsci_tpu_torch.models.ddpm import DDPMModel, DDPMModelConfig
from diffsci_tpu_torch.models.karras import (
    EMATracker, IntervalGuidance, KarrasModel, KarrasModelConfig, KarrasNet,
    accumulate_gradients, cosine_restarts_schedule, create_train_state,
    default_optimizer, freeze_optimizer, karras_model_from_description,
    make_eval_step, make_train_scan, make_train_step,
    renormalize_mp_weights, schedule_free_eval_params,
    schedule_free_optimizer, warmup_cosine_schedule)
from diffsci_tpu_torch.models.nets import (HFNet, HFNetCond, HFNetUncond,
                                           MLPCond, MLPUncond, PUNetG,
                                           PUNetGCond, PUNetGConfig, UNet2D)

__all__ = ["DDPMModel", "DDPMModelConfig", "EMATracker", "HFNet",
           "HFNetCond", "HFNetUncond", "IntervalGuidance", "KarrasModel",
           "KarrasModelConfig", "KarrasNet", "MLPCond", "MLPUncond", "PUNetG",
           "PUNetGCond", "PUNetGConfig", "UNet2D", "accumulate_gradients",
           "cosine_restarts_schedule", "create_train_state",
           "default_optimizer", "freeze_optimizer",
           "karras_model_from_description", "make_eval_step",
           "make_train_scan", "make_train_step", "renormalize_mp_weights",
           "schedule_free_eval_params", "schedule_free_optimizer",
           "warmup_cosine_schedule"]
