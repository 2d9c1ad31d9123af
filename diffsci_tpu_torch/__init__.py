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
On the card the sampling loops and the train and eval steps run as CUDA
graphs, captured once per shape and replayed (``utils/graphs.py``).

The host side of training: ``fit_karras`` and ``Trainer`` (epochs,
validation, logging, checkpoints, preemption safety, profiling) over
``ArrayDataLoader`` (arrays, memmaps or CPU tensors; batches copied to the
card ahead of their step), ``freeze_optimizer`` and
``accumulate_gradients``; persistence through ``save_checkpoint`` /
``restore_checkpoint`` (in place, under the captured graphs),
``CheckpointManager`` (top-k, post-hoc EMA) and ``ModelRegistry``; models
rebuilt from their JSON description (``karras_model_from_description``,
the JAX package's format) and served from a checkpoint
(``SamplerService.from_checkpoint``); a JAX run carried over by
``convert.from_jax_train_state``.

The serving stack: ``SamplerService``'s cross-request dispatcher
(``batch_window_ms``), Picard latency mode (``picard=``, over
``KarrasModel.sample_parallel``) and 1-NFE serving (``nsteps=1``,
``models/karras/distill.py``); ``serving.build_server`` (HTTP) and the
command line ``python -m diffsci_tpu_torch info|sample|serve|profile``
(``cli.py``; ``profiling.py`` reads torch.profiler traces); the
features AnoDDPM, DDAD and RePaint (``features/``), ``interpolate_images``
and ``sample_and_filter``; ``schedule_free_optimizer`` and
``default_optimizer(mu_dtype=)``.

Forecasting and latent diffusion: ``EnsembleKarrasModel`` (CRPS over an
ensemble in one flattened denoiser call, the autoregressive loss with its
in-step sampler, replay fine-tuning, L2-SP) and
``make_ensemble_train_step`` (one CUDA graph per key, the in-step
sampler inside it); ``autoregressive_sample`` (a latent rollout);
``KarrasEncoderModel``; the KL autoencoder (``AutoencoderKL``,
``DDConfig``), ``VAEModel``'s encode and decode and ``BoundAutoencoder``,
which a latent ``KarrasModel(autoencoder=...)`` takes.

Distillation and VAE training: progressive distillation
(``make_distill_step``, one CUDA graph per key with the teacher's calls
inside it, and ``distill_progressive``, the halving chain down to a
1-NFE student) and the minimal ``EDMModel``; VAE training
(``create_vae_train_state`` / ``make_vae_train_step``: the autoencoder's
and the PatchGAN ``NLayerDiscriminator``'s updates in one graphed step,
the discriminator's gates as device values; ``KLAnnealing``), the
porous-media ``VAENet`` (1D, 2D, 3D) and the edge loss preprocessor
(``ops.EdgeDetectionPreprocessor``).

The other runtimes: stochastic interpolants and flow matching
(``SIModel``: the paths, the flow loss, Heun and Euler–Maruyama
integration, one CUDA graph a request, so ``SamplerService`` serves it,
soft-mask inpainting; ``make_train_step`` trains it), the Song-style SDE
stack (``models.sde``: VP, subVP and VE, ``SDEModel``), DDPM v1
(``DDPMModuleV1``, ``default_v1_optimizer``) and the deterministic
forecaster (``ForecastModel``).

The metrics and the extras, submodules as in the JAX package:
``metrics`` (FID, KID and sample statistics on the host; FLD's mixture
fit on the card) and ``metrics_inception`` (the pytorch-fid InceptionV3
and its features); ``extra`` (grid and sequential volume synthesis around
an ``SIModel``, the periodizer, porosity maps, the tiled decode,
conv-to-circular surgery) and ``utils.periodic``.

The user recipes: ``diffsci_tpu_torch.scripts``, one module per script of
the JAX package (``python -m diffsci_tpu_torch.scripts.train_diffusion_mnist``,
``eval_fid``, ...), with the JAX scripts' flags and outputs and a
``--device`` flag.
"""

from diffsci_tpu_torch.checkpoint import (CheckpointManager, ModelRegistry,
                                          restore_checkpoint, save_checkpoint)
from diffsci_tpu_torch.data.loading import ArrayDataLoader
from diffsci_tpu_torch.models import (
    AutoencoderKL, BoundAutoencoder, DDConfig, DDPMModel, DDPMModelConfig,
    EMATracker, EnsembleKarrasModel, EnsembleKarrasModelConfig, HFNetCond,
    HFNetUncond, IntervalGuidance, KarrasEncoderModel, KarrasModel,
    KarrasModelConfig, KarrasNet, PUNetG, VAEModel, VAEModelConfig,
    autoregressive_sample, make_ensemble_train_step,
    PUNetGCond, PUNetGConfig, UNet2D, accumulate_gradients,
    cosine_restarts_schedule, create_train_state, default_optimizer,
    freeze_optimizer, karras_model_from_description, make_eval_step,
    make_train_scan, make_train_step, renormalize_mp_weights,
    schedule_free_eval_params, schedule_free_optimizer,
    warmup_cosine_schedule, EDMModel, EDMModelConfig, KLAnnealing,
    NLayerDiscriminator, VAENet, VAENetConfig, VAETrainState,
    create_vae_train_state, default_vae_optimizer, distill_progressive,
    make_distill_step, make_vae_train_step, DDPMModuleV1, DDPMSchedulerV1,
    ForecastModel, ForecastModelConfig, SDEModel, SIModel, SIModelConfig,
    SIScheduler, default_v1_optimizer)
from diffsci_tpu_torch.serving import SamplerService
from diffsci_tpu_torch.trainer import Trainer, fit_karras

__all__ = ["ArrayDataLoader", "AutoencoderKL", "BoundAutoencoder",
           "CheckpointManager", "DDConfig", "DDPMModel",
           "DDPMModelConfig", "DDPMModuleV1", "DDPMSchedulerV1",
           "ForecastModel", "ForecastModelConfig", "SDEModel", "SIModel",
           "SIModelConfig", "SIScheduler", "default_v1_optimizer", "EDMModel", "EDMModelConfig", "EMATracker",
           "EnsembleKarrasModel", "KLAnnealing", "NLayerDiscriminator",
           "VAENet", "VAENetConfig", "VAETrainState",
           "create_vae_train_state", "default_vae_optimizer",
           "distill_progressive", "make_distill_step",
           "make_vae_train_step",
           "EnsembleKarrasModelConfig", "HFNetCond", "HFNetUncond",
           "IntervalGuidance", "KarrasEncoderModel", "KarrasModel",
           "KarrasModelConfig", "KarrasNet", "VAEModel", "VAEModelConfig",
           "autoregressive_sample", "make_ensemble_train_step", "ModelRegistry", "PUNetG", "PUNetGCond",
           "PUNetGConfig", "SamplerService", "Trainer", "UNet2D",
           "accumulate_gradients", "cosine_restarts_schedule",
           "create_train_state", "default_optimizer", "fit_karras",
           "freeze_optimizer", "karras_model_from_description",
           "make_eval_step", "make_train_scan", "make_train_step",
           "renormalize_mp_weights", "restore_checkpoint",
           "save_checkpoint", "schedule_free_eval_params",
           "schedule_free_optimizer", "warmup_cosine_schedule"]
