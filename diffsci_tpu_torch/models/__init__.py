from diffsci_tpu_torch.models.ddpm import DDPMModel, DDPMModelConfig
from diffsci_tpu_torch.models.karras import (EMATracker, KarrasModel,
                                             KarrasModelConfig, KarrasNet,
                                             create_train_state,
                                             default_optimizer,
                                             make_eval_step, make_train_step)
from diffsci_tpu_torch.models.nets import (HFNet, HFNetCond, HFNetUncond,
                                           MLPCond, MLPUncond, PUNetG,
                                           PUNetGConfig, UNet2D)

__all__ = ["DDPMModel", "DDPMModelConfig", "EMATracker", "HFNet",
           "HFNetCond", "HFNetUncond", "KarrasModel", "KarrasModelConfig",
           "KarrasNet", "MLPCond", "MLPUncond", "PUNetG", "PUNetGConfig",
           "UNet2D", "create_train_state", "default_optimizer",
           "make_eval_step", "make_train_step"]
