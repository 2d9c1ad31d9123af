from diffsci_tpu_torch.utils.device import resolve_device
from diffsci_tpu_torch.utils.tensor import (bcast_right, depth_to_space,
                                            dict_expand_dims, dict_map,
                                            get_minibatch_sizes,
                                            space_to_depth)

__all__ = ["bcast_right", "depth_to_space", "dict_expand_dims", "dict_map",
           "get_minibatch_sizes", "resolve_device", "space_to_depth"]
