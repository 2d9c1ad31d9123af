from diffsci_tpu_torch.models.karras import (EMATracker, KarrasModel,
                                             KarrasModelConfig, KarrasNet,
                                             create_train_state,
                                             default_optimizer,
                                             make_eval_step, make_train_step)
from diffsci_tpu_torch.models.nets import PUNetG, PUNetGConfig

__all__ = ["EMATracker", "KarrasModel", "KarrasModelConfig", "KarrasNet",
           "PUNetG", "PUNetGConfig", "create_train_state",
           "default_optimizer", "make_eval_step", "make_train_step"]
