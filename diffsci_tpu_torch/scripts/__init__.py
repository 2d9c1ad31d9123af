"""The user recipes on the port: one module per script of the JAX
package's ``scripts/``, under the same name, each run as

    python -m diffsci_tpu_torch.scripts.<name> [flags]

Each keeps its JAX counterpart's CONFIG constants, flags and defaults, its
synthetic-data fallback (plain numpy, the same arrays) and the files it
writes, with arrays on disk channels-last as the JAX package writes them.
Each adds one flag, ``--device`` (default ``cuda``, which raises when CUDA
is absent; ``cpu`` runs the recipe on the CPU). ``--n-devices N`` is data
parallelism over N ranks, one card each: run the script under ``torchrun
--nproc-per-node N``.

Ported: ``train_diffusion_mnist``, ``eval_fid``, ``train_diffusion_toy``,
``train_diffusion_cifar10``, ``train_diffusion_shapes``,
``train_diffusion_conditional``, ``train_super_resolution``,
``train_ensemble_forecast``, ``train_vae``, ``sampler_comparison``,
``anomaly_detection``, ``inpainting_demo``, ``distill_study``,
``entropy_time_profile``, ``correlation_thresholds``,
``stochasticity_sweep`` (``--processes N``: the γ grid over worker
processes, their output the sequential run's bit for bit),
``stochasticity_study``, ``picard_restart_trained`` and
``repro_reference_fid``: every script of the JAX package that does not
time Pallas, read XLA traces or run the original torch reference.
"""
