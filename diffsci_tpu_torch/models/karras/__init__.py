from diffsci_tpu_torch.models.karras.ema import (
    EMAState, EMATracker, power_function_beta, power_function_exp_from_std,
    solve_posthoc_weights, synthesize_posthoc_ema)
from diffsci_tpu_torch.models.karras.module import (
    DynamicLossWeight, IntervalGuidance, KarrasModel, KarrasModelConfig,
    KarrasNet, karras_model_from_description)
from diffsci_tpu_torch.models.karras.train import (
    AdamWClip, AdamWMu, GradAccumulation, ScheduleFreeAdamW, TrainState,
    accumulate_gradients, cosine_restarts_schedule, create_train_state,
    default_optimizer,
    freeze_mask, freeze_optimizer, make_eval_step, make_train_scan,
    make_train_step, nan_to_zero_grads, renormalize_mp_weights,
    schedule_free_eval_params, schedule_free_optimizer, split_variables,
    warmup_cosine_schedule)
from diffsci_tpu_torch.models.karras.distill import (
    distill_interval_grid, distill_progressive, distill_targets,
    halving_schedule, make_distill_step, sample_onestep)
from diffsci_tpu_torch.models.karras.edm_minimal import (EDMModel,
                                                         EDMModelConfig)
from diffsci_tpu_torch.models.karras.ensemble import (
    EnsembleKarrasModel, EnsembleKarrasModelConfig, l2_sp_regularization,
    make_ensemble_train_step, scheduled_replay_weight,
    select_regularization_reference)
from diffsci_tpu_torch.models.karras.autoregressive import (
    autoregressive_sample, frames_to_window, window_to_frames)
from diffsci_tpu_torch.models.karras.encoder import KarrasEncoderModel

__all__ = ["AdamWClip", "AdamWMu", "DynamicLossWeight", "EDMModel",
           "EDMModelConfig", "EMAState",
           "EMATracker", "EnsembleKarrasModel",
           "EnsembleKarrasModelConfig", "GradAccumulation",
           "IntervalGuidance", "KarrasEncoderModel",
           "KarrasModel", "KarrasModelConfig", "KarrasNet",
           "ScheduleFreeAdamW", "TrainState",
           "accumulate_gradients", "autoregressive_sample",
           "cosine_restarts_schedule",
           "create_train_state", "default_optimizer",
           "distill_interval_grid", "distill_progressive",
           "distill_targets", "freeze_mask",
           "freeze_optimizer", "frames_to_window", "halving_schedule",
           "karras_model_from_description", "l2_sp_regularization",
           "make_distill_step", "make_ensemble_train_step",
           "make_eval_step", "make_train_scan", "make_train_step",
           "nan_to_zero_grads", "scheduled_replay_weight",
           "select_regularization_reference", "window_to_frames", "power_function_beta",
           "power_function_exp_from_std", "renormalize_mp_weights",
           "sample_onestep", "schedule_free_eval_params",
           "schedule_free_optimizer", "solve_posthoc_weights",
           "split_variables", "synthesize_posthoc_ema",
           "warmup_cosine_schedule"]
