"""diffsci_tpu_torch: the PyTorch / CUDA port of diffsci_tpu for an NVIDIA
Hopper card (H100).

The JAX package ``diffsci_tpu`` stays the reference; this package imports
nothing of it and nothing of JAX. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``. Ported so far: ``PUNetG`` (every
option: circular and magnitude-preserving convolutions, cosine
attention, space_to_depth, spatial conditions, condition drop) and
``PUNetGCond`` with the conditioning embedders
(``models/nets/embedders.py``) inside ``KarrasModel`` under the EDM, VP,
VE and SR3 configurations, with classifier-free guidance (a float or an
``IntervalGuidance``), the EDM batch norm and the dynamic loss weight;
serving
(``SamplerService`` with ``sample_kwargs``; Heun, Euler, Euler–Maruyama,
Karras churn, DPM-Solver++(2M), restart, inpaint and RePaint) and
training (``create_train_state`` / ``make_train_step`` /
``make_train_scan``: σ draw, Huber loss, backward, NaN guard, clip, AdamW
with its schedules, the mp re-projection (``has_mp_weights``), the batch
norm's statistics, power EMA, ``remat``); the analytic toy datasets
(``data``); and DDPM/DDIM
serving and loss of the HFNet family (``DDPMModel`` around ``HFNetUncond``,
``HFNetCond`` or ``UNet2D``, the diffusers ``UNet2DModel``). Every TPU
kernel of the JAX package has a hand-written counterpart: the denoiser
combine and the DDPM/DDIM update, norm + SiLU forward and backward, and
flash attention forward and backward (``kernels/``, sources in ``csrc/``).
On the card the sampling loops and the train step run as CUDA graphs,
captured once per shape and replayed (``utils/graphs.py``).
"""

from diffsci_tpu_torch.models import (
    DDPMModel, DDPMModelConfig, EMATracker, HFNetCond, HFNetUncond,
    IntervalGuidance, KarrasModel, KarrasModelConfig, KarrasNet, PUNetG,
    PUNetGCond, PUNetGConfig, UNet2D, cosine_restarts_schedule,
    create_train_state, default_optimizer, make_eval_step, make_train_scan,
    make_train_step, renormalize_mp_weights, warmup_cosine_schedule)
from diffsci_tpu_torch.serving import SamplerService

__all__ = ["DDPMModel", "DDPMModelConfig", "EMATracker", "HFNetCond",
           "HFNetUncond", "IntervalGuidance", "KarrasModel",
           "KarrasModelConfig", "KarrasNet", "PUNetG", "PUNetGCond",
           "PUNetGConfig", "SamplerService", "UNet2D",
           "cosine_restarts_schedule", "create_train_state",
           "default_optimizer", "make_eval_step", "make_train_scan",
           "make_train_step", "renormalize_mp_weights",
           "warmup_cosine_schedule"]
