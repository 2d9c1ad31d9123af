from diffsci_tpu_torch.models.nets.punetg import PUNetG, PUNetGConfig

__all__ = ["PUNetG", "PUNetGConfig"]
