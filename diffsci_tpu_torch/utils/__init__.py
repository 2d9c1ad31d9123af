from diffsci_tpu_torch.utils.device import resolve_device
from diffsci_tpu_torch.utils.tensor import (bcast_right, dict_expand_dims,
                                            dict_map, get_minibatch_sizes)

__all__ = ["bcast_right", "dict_expand_dims", "dict_map",
           "get_minibatch_sizes", "resolve_device"]
