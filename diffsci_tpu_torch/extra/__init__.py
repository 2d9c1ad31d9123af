"""Extras: periodizers, tiled decode, volume synthesis, conditioning maps."""

from diffsci_tpu_torch.extra.periodizer import (
    DiffusionPeriodizer,
    PeriodicSamplerWrapper,
    measure_periodicity_error,
)
from diffsci_tpu_torch.extra.chunk_decode import (
    tiled_decode,
    halo_shard_decode,
    decoder_halo_radius,
    upscale_factor,
)
from diffsci_tpu_torch.extra.fillinginpainting import (
    sample_grid_volume,
    get_grid_generation_order,
    get_cube_spatial_bounds,
    build_inpaint_mask,
)
from diffsci_tpu_torch.extra.sequentialinpainting import (
    sample_sequential_z,
    create_cosine_blend_weights,
)
from diffsci_tpu_torch.extra.porosity_map import (
    MaternFieldSampler,
    matern_grid_sample,
    make_vertical_porosity_map,
    map_porosity_to_condition,
    interpolate_array,
)

__all__ = [
    "DiffusionPeriodizer", "PeriodicSamplerWrapper",
    "measure_periodicity_error",
    "tiled_decode", "halo_shard_decode", "decoder_halo_radius",
    "upscale_factor",
    "sample_grid_volume", "get_grid_generation_order",
    "get_cube_spatial_bounds", "build_inpaint_mask",
    "sample_sequential_z", "create_cosine_blend_weights",
    "MaternFieldSampler", "matern_grid_sample",
    "make_vertical_porosity_map", "map_porosity_to_condition",
    "interpolate_array",
]
