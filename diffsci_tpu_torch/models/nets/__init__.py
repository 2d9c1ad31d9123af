from diffsci_tpu_torch.models.nets.ddpm_unet import UNet2D
from diffsci_tpu_torch.models.nets.hfnet import HFNet, HFNetCond, HFNetUncond
from diffsci_tpu_torch.models.nets.mlp import MLPCond, MLPUncond
from diffsci_tpu_torch.models.nets.punetg import PUNetG, PUNetGConfig

__all__ = ["HFNet", "HFNetCond", "HFNetUncond", "MLPCond", "MLPUncond",
           "PUNetG", "PUNetGConfig", "UNet2D"]
