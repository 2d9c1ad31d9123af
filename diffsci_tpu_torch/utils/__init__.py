from diffsci_tpu_torch.utils.device import cap_cpu_threads, resolve_device
from diffsci_tpu_torch.utils.images import make_image_grid, save_image_grid
from diffsci_tpu_torch.utils.periodic import (periodic_getitem,
                                              periodic_getitem_extended,
                                              periodic_setitem)
from diffsci_tpu_torch.utils.tensor import (bcast_right, depth_to_space,
                                            dict_expand_dims, dict_map,
                                            get_minibatch_sizes,
                                            inverse_cdf_histogram,
                                            linear_interpolation,
                                            space_to_depth, unset)

__all__ = ["bcast_right", "cap_cpu_threads", "depth_to_space", "dict_expand_dims", "dict_map",
           "get_minibatch_sizes", "inverse_cdf_histogram", "linear_interpolation",
           "make_image_grid", "periodic_getitem",
           "periodic_getitem_extended", "periodic_setitem",
           "resolve_device", "save_image_grid",
           "space_to_depth", "unset"]
