"""diffsci_tpu_torch: the PyTorch / CUDA port of diffsci_tpu for an NVIDIA
Hopper card (H100).

The JAX package ``diffsci_tpu`` stays the reference; this package imports
nothing of it and nothing of JAX. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``. Ported so far, the EDM main path of
``PUNetG`` inside ``KarrasModel``: serving (``SamplerService``, 18-step
Heun) and training (``create_train_state`` / ``make_train_step``: σ draw,
Huber loss, backward, NaN guard, clip, AdamW, power EMA), with
hand-written kernels for the denoiser combine, norm + SiLU forward and
backward, and flash attention forward and backward (``kernels/``,
sources in ``csrc/``).
"""

from diffsci_tpu_torch.models import (EMATracker, KarrasModel,
                                      KarrasModelConfig, KarrasNet, PUNetG,
                                      PUNetGConfig, create_train_state,
                                      default_optimizer, make_eval_step,
                                      make_train_step)
from diffsci_tpu_torch.serving import SamplerService

__all__ = ["EMATracker", "KarrasModel", "KarrasModelConfig", "KarrasNet",
           "PUNetG", "PUNetGConfig", "SamplerService", "create_train_state",
           "default_optimizer", "make_eval_step", "make_train_step"]
