from diffsci_tpu_torch.models.karras import (KarrasModel, KarrasModelConfig,
                                             KarrasNet)
from diffsci_tpu_torch.models.nets import PUNetG, PUNetGConfig

__all__ = ["KarrasModel", "KarrasModelConfig", "KarrasNet", "PUNetG",
           "PUNetGConfig"]
