from diffsci_tpu_torch.models.karras.module import (KarrasModel,
                                                    KarrasModelConfig,
                                                    KarrasNet)

__all__ = ["KarrasModel", "KarrasModelConfig", "KarrasNet"]
