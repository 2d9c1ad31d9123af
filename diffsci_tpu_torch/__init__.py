"""diffsci_tpu_torch: the PyTorch / CUDA port of diffsci_tpu for an NVIDIA
Hopper card (H100).

The JAX package ``diffsci_tpu`` stays the reference; this package imports
nothing of it and nothing of JAX. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``. The serving path is ported:
``SamplerService`` -> ``KarrasModel`` (EDM, 18-step Heun) -> ``PUNetG``,
with hand-written kernels for the denoiser combine, norm + SiLU and
flash-attention forward (``kernels/``, sources in ``csrc/``).
"""

from diffsci_tpu_torch.models import (KarrasModel, KarrasModelConfig,
                                      KarrasNet, PUNetG, PUNetGConfig)
from diffsci_tpu_torch.serving import SamplerService

__all__ = ["KarrasModel", "KarrasModelConfig", "KarrasNet", "PUNetG",
           "PUNetGConfig", "SamplerService"]
