from diffsci_tpu_torch.models.karras.ema import (EMAState, EMATracker,
                                                 power_function_beta,
                                                 power_function_exp_from_std)
from diffsci_tpu_torch.models.karras.module import (DynamicLossWeight,
                                                    IntervalGuidance,
                                                    KarrasModel,
                                                    KarrasModelConfig,
                                                    KarrasNet)
from diffsci_tpu_torch.models.karras.train import (
    AdamWClip, TrainState, cosine_restarts_schedule, create_train_state,
    default_optimizer, make_eval_step, make_train_scan, make_train_step,
    nan_to_zero_grads, renormalize_mp_weights, warmup_cosine_schedule)

__all__ = ["AdamWClip", "DynamicLossWeight", "EMAState", "EMATracker",
           "IntervalGuidance", "KarrasModel", "KarrasModelConfig",
           "KarrasNet", "TrainState", "cosine_restarts_schedule",
           "create_train_state", "default_optimizer", "make_eval_step",
           "make_train_scan", "make_train_step", "nan_to_zero_grads",
           "power_function_beta", "power_function_exp_from_std",
           "renormalize_mp_weights", "warmup_cosine_schedule"]
