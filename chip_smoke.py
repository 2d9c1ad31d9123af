#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``diffsci_tpu_torch``) on one GPU.

Run from the repository root, with one NVIDIA Hopper card (H100):

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. Kernels: build every kernel from ``diffsci_tpu_torch/csrc`` (one nvcc
   per source, in parallel), check each against its plain PyTorch version
   on the card at the main paths' shapes in float32 and bfloat16 (the
   backward kernels K3, K5 and K6 on the forward kernels' own saved
   statistics; the norms also on unaligned rows, an unaligned base,
   off-centre inputs and rows beyond a cluster's shared memory; the flash
   kernels over a sweep of T and head dims; K1 and K7 in every dtype
   combination of their inputs, bit for bit where x is float32, on ragged
   rows, many short rows, one long row, operands whose base is not
   16-byte aligned and their byte-bound shapes, each twice for the same
   bits; ``euler_update`` against its plain form), check that the bf16 K4,
   K5 and K6 hold tensor-core instructions (``cuobjdump -sass``) and that
   bf16 K3 (at A's and B's largest train-step norms), K5 and K6 give one
   result twice, and time the kernel, its plain
   version, the least time the card could take (``bound_ms``) and, where
   one PyTorch call computes the same function, that call (``library_ms``;
   for K4-K6 the median of 5 timed loops, SDPA pinned to its flash
   backend, with the SFU floor of their exponentials printed beside the
   bound). K1, K2, K3 and K7 are also timed by their device time alone
   (torch.profiler), since back to back their time is the host's launch
   rate; K1 and K7 at every serving bucket of A and B (K1) and C (K7)
   and at a byte-bound shape each, beside their bound and a PyTorch
   elementwise pass over the same bytes, and by their host time a call
   under inference mode beside their plain versions, in two rounds in
   turn; K2 also at configuration A's serving bucket 1, beside
   ``F.group_norm`` + ``F.silu`` (two calls); K3 at A's and B's largest
   train-step norms, its device time with the inputs in L2 and out of it.
   K2·S and K3·S (K2 and K3 split around the spatial mesh's all-reduce:
   ``norm_silu_stats``, ``norm_silu_apply``, ``norm_silu_bwd_partials``,
   ``norm_silu_bwd_dx``) against their plain versions at A's slabs over
   2 ranks ([4, 32, 16, 32, 32], the bottleneck's [4, 64, 8, 16, 16]), a
   B-width slab ([256, 64, 14, 28]), an unaligned row and base and rows
   beyond a cluster, f32 and bf16, 'ln' and 'rms', within K2's and K3's
   bounds; each timed at A's 32³ slab (device time, byte bound; the sums
   beside ``torch.sum``).
2. Card vs CPU, sampling: a small configuration-A-shaped net (3D 32³,
   flash attention over 4096 tokens) samples a few Heun steps from the
   same weights on the CPU (plain versions, eager) and on the card
   (kernels, through the graphed ``KarrasModel.sample``), from the same
   noise, TF32 off; the results must agree.
3. Card vs CPU, training: the same net takes three f32 train steps from
   the same weights, batch and σ/ε draws on both (the card's through the
   graphed ``make_train_step``); losses, grad norms, parameters and EMA
   shadows must agree.
4. Card vs CPU, DDPM: a small HFNet (configuration C's family) runs 25
   DDPM and 25 DDIM steps (the card's through the graphed
   ``DDPMModel.sample``, the CPU replaying its noise) and 25 forward
   (noising) steps with replayed noise, and loss_fn with its gradient
   norm, on both; they must agree, with exactly 25 launches of K7 and of
   K1 per arm.
5. Serving, configuration A (3D 32³ porous-media volume, bf16, flash
   attention) through ``SamplerService``: the warm-up captures one CUDA
   graph per bucket (capture seconds and the graph pool printed), then
   the kernel launch counts are reset before the requests and read after.
6. Serving, configuration B (MNIST 28x28, bf16) likewise. The counts of
   phases 5 and 6 must be those of 18-step Heun samples.
7. Training, configuration A (batch 4 of 32³, bf16 over f32 masters,
   AdamW, power EMA every 4 steps) through ``make_train_step``: warm-up
   (the first step eager, then the capture), then timed steps (graph
   replays) with the counts reset before and read after; the counts must
   be exactly those of one forward and one backward per step, the loss
   finite and lower after training on its fixed batch.
8. Training, configuration B (batch 256 of 28x28) likewise.
9. Serving, configuration C (HFNet at the DDPM CIFAR-10 UNet's widths,
   32x32x3, bf16) through ``SamplerService``: DDIM at 100 steps (buckets
   1 and 16, with the same-seed check) and ancestral DDPM at 1000 steps
   (bucket 16, one request); K7 must be launched once per step of every
   bucket run (a replay of the step's graph), and no other kernel.
10. Eager against graphed, in one process: A's (4), B's (64) and C's
    DDIM (16) requests through the service's graphs and through the
    loops' inner methods from one seed (phases 2 and 4's tolerances, and
    the same bits twice for the graphed request), and A's and B's train
    steps eager (``_raw=True``) and graphed from one seed and one set of
    draws (phase 3's tolerances), each timed on the host clock; A's step
    graphed under ``remat`` (peak memory, graph pool, time, phase 3's
    tolerances against the graphed step); ``make_train_scan`` at K = 8
    against 8 graphed steps, replaying the graph A's state holds; A's
    graphed sampler after one more replayed train step, against the
    eager loop on a cast copy built anew (phase 2's tolerance).
11. Stochastic paths, card vs CPU: the net of phase 2 samples by EDM
    churn, Euler–Maruyama (also gated by ``langevin_interval`` with a
    ``langevin_scale``), DPM++2M and restart, VP and VE models by Heun and
    EM, all through the graphed entry points, and inpaints and RePaints
    eagerly on the card; the CPU replays the card's draws (x_T, then one
    tensor of the loop's noise), TF32 off; they must agree.
12. Stochastic serving at full width through
    ``SamplerService(sample_kwargs=...)``: B by churn, EM and DPM++2M, A by
    EM, 18 steps, with exact launch counts (churn 35 network calls a
    sample, EM and DPM++2M 18), the same seed giving the same samples and
    one profiled request per arm; a γ sweep of ``langevin_scale`` over
    three values on B's bucket 8 that replays one graph (the cache does
    not grow) and matches the eager loop at each γ; B's ``sample_restart``
    with ((0.05, 2.0, 2),), its network calls counted from the snapped
    grid.
13. Training under VP (B, batch 256) and VE (A, batch 4) through the
    graphed ``make_train_step``: exact launch counts, a finite falling
    loss, seconds per step, peak memory, one profiled step; three f32 VP
    steps of the small net, card against CPU (phase 3's tolerances).
14. Conditional and magnitude-preserving serving through
    ``SamplerService``, a graph per bucket: D (configuration A's widths
    with circular convolutions, a porosity embedding, cond_drop 0.1 and
    the EDM batch norm; buckets (1, 4), one porosity a request,
    ``IntervalGuidance(2.0, 0.3, 5.0)``) and E (configuration B's widths
    with mp convolutions, cosine attention and the dynamic loss weight;
    buckets (1, 8, 64)), 18 Heun steps: exact launch counts (D's CFG makes
    70 network calls a sample, so 70 K4 and 1400 K2, and 35 K1, one a
    denoiser evaluation; E 35 K1 and 980 K2), one seed one result, the
    graphed request against its eager body, the request's porosity
    reaching the graph, one profiled request each.
15. Training D (batch 4: the condition-drop draw, the batch norm) and E
    (batch 256, ``has_mp_weights``) through the graphed
    ``make_train_step``: exact launch counts, a finite falling loss,
    seconds per step, peak memory, one profiled step; D's running
    statistics after graphed steps equal to eager steps'; E's mp weights
    at the re-projection's norm within 1e-5 after the steps.
16. Card vs CPU, f32, TF32 off: D's options at phase 2's cut sample 3
    guided Heun steps (graphed; the batch norm decoded; phase 2's
    tolerance, 10 network calls and 5 K1), and three train steps each of
    D's (batch norm, a replayed keep mask) and E's options (2D 16², mp,
    cosine, ``has_mp_weights``, the dynamic loss weight) at phase 3's
    tolerances; a net with GroupPix norms and one with
    ``affine_norm=False`` launch no K2 or K3 in a forward and backward
    (the default norms launch one each a norm).
17. The host loop at configuration B's full width: ``fit_karras`` over a
    memmapped .npy of 6144 random images (batch 256, 2 epochs of 21
    steps, validation on 10%, power EMA (0.05, 0.1) every 4 steps, cadence
    and metric saves into a ``CheckpointManager``, steps 20-30 under
    torch.profiler): 42 steps, the logged rows, a falling loss, exact
    launch counts (28 K2 and K3 a step; 28 K2 and one K1 an eval batch,
    whose loss runs with train False), one capture of each graph; its
    wall per step beside phase 8's bare step, images/s, the idle share,
    the checkpoint's bytes and save and restore seconds. A checkpoint
    restored in place under the captured graphs
    gives the same 5 steps bit for bit; restored into a fresh state, the
    replayed step equals the eager one; post-hoc EMA on the card within
    1e-6 of float64; ``SamplerService.from_checkpoint`` through a
    ``ModelRegistry`` bit for bit against the in-memory EMA profile 0,
    35 K1 and 980 K2 a sample. Its temporary directory is deleted.
18. The optimizers written for the port at configuration B's full width
    (batch 256, bf16 over f32 masters, the graphed step): 20 timed steps
    each of ``schedule_free_optimizer()`` and ``default_optimizer(
    mu_dtype=torch.bfloat16)``, exact launch counts (28 K2 and 28 K3 a
    step), a finite falling loss, one capture of the step, ms a step
    beside phase 8's AdamW step and the optimizer state's bytes beside
    AdamW's; ``schedule_free_eval_params`` served through one graphed B
    request.
19. The serving stack at B's full width from a checkpoint of phase 18's
    bf16-moment run (saved into a temporary directory that is deleted;
    served in f32, after the command line with TF32 off, so that a
    request batched in one bucket can be held to the same seed alone in
    another):
    ``python -m diffsci_tpu_torch info`` and ``sample --grid``, each a
    subprocess on the card, side by side (the .npy bit for bit the in-process
    ``from_checkpoint`` request, the PNG written without matplotlib);
    ``build_server`` on port 0 with the dispatcher (``batch_window_ms=5``,
    buckets (1, 8, 64)) and one at a time, 32 concurrent one-sample HTTP
    clients with distinct seeds: requests/s, dispatches, exactly 35 K1 and
    980 K2 a bucket run, each response bit for bit its seed alone in the
    same bucket and within phase 2's tolerance in bucket 1, and the HTTP
    overhead of one request; the same in-process under Euler–Maruyama (18
    network calls a dispatch); Picard (window 8, tol 1e-3 and 0) at B's
    and A's bucket 1, 18 and 64 steps, f32, against the
    sequential Euler request (sweeps, wall, one network call's launches a
    sweep, tol 0 in nsteps sweeps within phase 2's tolerance); 1-NFE
    serving at bucket 64 (one K1 and 28 K2, equal to ``get_denoiser``),
    and a cold 1-NFE dispatcher service whose 16 concurrent first
    requests warm each bucket once and get their rows of
    ``sample_onestep`` bit for bit; configuration C's DDIM through the
    dispatcher (one K7 a step a dispatch, each row bit for bit
    ``DDPMModel.sample`` of its row generator);
    AnoDDPM and DDAD on 64 images at step 30 of 100, clean against
    corrupted, ``interpolate_images`` and ``sample_and_filter``, with exact
    launch counts; one request under torch.profiler, its trace read back
    by ``python -m diffsci_tpu_torch profile`` (K1's and K2's rows equal
    to the launch counter, the busy fraction).
20. Card vs CPU, f32, TF32 off, on phase 2's net: Picard at tol 0, 1e-3
    and stochastic on the card's draws; the dispatcher's isolation on the
    card and its row against the CPU; AnoDDPM with replayed draws; three
    schedule-free and three bf16-moment train steps (phase 3's bounds).
21. Card vs CPU, f32, TF32 off, on phase 2's net as a forecaster
    (PUNetGCond over a 2-frame window, CRPS, 2 horizons, a 3-step in-step
    sampler): the CRPS ensemble loss (E = 3, masked and not), the
    autoregressive loss on the card's draws, two graphed
    ``make_ensemble_train_step`` steps (the first the warm-up, the second
    the captured graph's replay) against the CPU's eager ones
    (phase 3's bounds); a small 3D ``AutoencoderKL``'s encode and decode
    through ``BoundAutoencoder``, a latent ``loss_fn`` and a graphed
    latent ``sample`` (phase 2's tolerance, 5 K1), a 2-step
    ``autoregressive_sample`` (x_T replayed into the CPU's run, 10 K1).
22. Configuration F, the forecaster, at full width: PUNetGCond at B's
    widths over 4 latent channels and a 2-frame window (12 in, 4 out,
    plain attention), CRPS over 4 members, 2 horizons, an 18-step Heun
    in-step sampler, bf16 over f32 masters, batch 8: 20 graphed
    ``make_ensemble_train_step`` steps after 3 warm-up steps: s/step,
    items/s, peak memory, capture seconds, a falling loss, exactly 35 K1,
    1036 K2 and 56 K3 a step; one profiled step (idle share) and the
    in-step sampler's share of its device time (the same sample replayed
    as the model's own sampler graph); three graphed steps against their
    eager body (phase 3's bounds, bit for bit reported).
23. Configuration G: ``AutoencoderKL(DDConfig(), embed_dim=4)`` (256² × 1
    fields to 32² × 4 latents) bound in f32. F's network as a latent
    ``EnsembleKarrasModel`` rolls out 3 forecast steps of 8 samples from
    a 2-frame window encoded once and decodes the 24 latents in one call:
    wall, the device time of encoder, sampler and decoder
    (torch.profiler), exactly 105 K1 and 2940 K2, each step's graph
    replay bit for bit its eager body, the decoded shape [3, 8, 256, 256,
    1]; a latent PUNetG at B's widths trains on 8 fields of 256² a batch
    through the graphed ``make_train_step``, the encoder inside the step
    (s/step, peak memory, a falling loss, 28 K2 and 28 K3 a step), then
    is rebuilt by ``karras_model_from_description(..., autoencoder=)``
    and samples as the trained model does (phase 2's tolerance).
24. Card vs CPU, f32, TF32 off, flash attention engaged below its token
    gate: the forward of every network of the zoo's rest at small widths
    (ADM 2D with one 256-channel head, so the wide f32 K4; ADM 3D, mp and
    decoder type 2; DiT; MoE-DiT with a dropping capacity; ConVit softmax
    and linear with learned resampling; PUNetGDeterministic, the encoder
    with its projection, the decoder, PUNetV with slice embeddings;
    MinimalResNet; DASC in all-videos mode) at phase 2's tolerance, and a
    graphed 3-step ``KarrasModel`` sample each of a DiT and an ADM against
    the CPU's eager loop (5 K1, K4 launched).
25. Configuration H: ``DiffusionTransformer`` at DiT-B's widths (768, 12
    heads, 12 blocks) on 256² × 1 fields at patch 4 (4096 tokens, head dim
    64), flash attention, bf16 over f32 masters: a graphed bucket-4 request
    through ``SamplerService`` (buckets 1 and 4: wall, device time, idle
    share, K4's share, exactly 35 K1 and 420 K4) and 20 graphed train
    steps at batch 8 after 3 warm-up steps (s/step, items/s, peak memory,
    capture seconds, one profiled step with the K4-K6 share, exactly 12
    K4, K5 and K6 a step, a falling loss), three graphed steps against
    their eager body (phase 3's bounds); then its MoE twin (4 experts in
    every second block, capacity factor 2): one bucket-4 request and 5
    steps with the same counts, and the dropped fractions.
26. Configuration I: ``ADM`` at ``ADMConfig``'s defaults on 256² × 1 with
    flash attention (the middle block attends over 4096 tokens with one
    head of 256: the wide kernels), the same report as H's: exactly 35 K1
    and 35 K4 a request, one K4, K5 and K6 a step.
27. J, progressive distillation of B (full width, bf16 over f32 masters,
    batch 256 of random data, the teacher B after 200 train steps on the
    batch): the graphed distill step against its
    eager body bit for bit, before and after the teacher is reloaded in
    place; a phase-0 step (17 student steps, Heun teacher) timed over 20
    graphed steps after 3 warm-up steps (s/step, items/s, one profiled
    step, peak memory, capture seconds, exactly 4 K1, 140 K2 and 28 K3 a
    step); the chain 17 -> 9 -> 5 -> 3 -> 2 -> 1 through
    ``distill_progressive`` (20 steps a phase, one graph a phase, finite
    losses, phase 0's last five below its first five, exact launches);
    the 2-step student sampled by ``sample(nsteps=2,
    integrator="euler")`` and the 1-NFE student served through
    ``SamplerService(nsteps=1)``, finite.
28. J-A: one f32 distill step of A (the 3D flash PUNetG, 32³, batch 4),
    card (graphed) against CPU from the same weights and replayed draws
    (phase 3's bounds), launching K1-K6 (4 K1, 100 K2, 20 K3, 5 K4, one
    K5 and K6). K-CPU: two f32 VAE steps of a small VAENet with an
    ``NLayerDiscriminator``, card against CPU, the second step gated:
    every metric, both networks' parameters and both optimizers' moments.
29. K, G's autoencoder trained (``AutoencoderKL(DDConfig(),
    embed_dim=4)``, f32, ``VAEModelConfig()``'s defaults,
    ``NLayerDiscriminator(ndf=64, n_layers=3)``, batch 8 of 256²): 20
    graphed steps after 3 warm-up steps (a falling loss, s/step, items/s,
    peak memory, one profiled step, no kernel of the port), and 3 steps
    graphed against eager bit for bit, the second gated.
30. K-P, the porous-media ``VAENet()`` (3D 64³, batch 2, edge loss in 3D,
    total variation 0.1) over two epochs of 3 graphed steps with
    ``KLAnnealing``: the loss follows the new KL weight.
31. Card vs CPU, f32, TF32 off, the other runtimes at small sizes from
    the same weights and replayed draws: L (``SIModel`` around phase 2's
    net) samples 4 Heun steps on the linear and the "edm" path (graphed),
    runs 4 Euler–Maruyama steps and one graphed train step with the
    running initial norm; M (``SDEModel`` at B's depth, 8 channels) runs
    10 Euler–Maruyama and 5 Heun probability-flow steps and one train
    step; N (``DDPMModuleV1`` around phase 4's HFNet, T 25) runs its DDPM
    and DDIM reverse processes (graphed) and one step under
    ``default_v1_optimizer``; O (``ForecastModel`` over a small 2D
    autoencoder) its loss, prediction and one step: phase 2's tolerance
    and phase 3's bounds.
32. Configuration L, flow matching of porous volumes: ``SIModel`` around
    A's PUNetG (bf16 over f32 masters) served through ``SamplerService``
    at 30 steps, buckets (1, 4), requests (1, 3, 6) (57 network calls a
    bucket run: exactly 57 × 20 K2 and 57 K4), and by the "edm" path and
    Euler–Maruyama (29 calls) at bucket 4, with wall and device time a
    bucket; per-row isolation through the dispatcher; the graphed Heun
    and EM requests bit for bit their eager loops at 6 steps; 20 graphed
    train steps at batch 4 (20 K2 and K3, one K4, K5 and K6 a step, no
    K1; a falling loss; s/step, items/s, peak memory, capture seconds,
    one profiled step), 3 of them bit for bit eager; one ``inpaint`` of
    a 32³ volume (falloff 2, one resampling round), its known region
    exact.
33. M, N and O at full width: ``SDEModel`` around B's PUNetG (f32, VP
    linear), bucket 64, ``sde_sampler`` at 1000 steps and Heun
    probability flow at 500 (one graph of a step, replayed a step; 28 K2
    a network call), 20 graphed steps at batch 256 (28 K2 and K3 a step);
    ``DDPMModuleV1`` around C's HFNet (f32, T 1000) by DDPM and DDIM at
    bucket 16 and 20 steps at batch 128 under ``default_v1_optimizer``;
    ``ForecastModel`` over G's autoencoder with a two-convolution head
    (64 channels), 20 steps at batch 8 and a chunked sample of 8: walls,
    device time a step, the samplers graphed against eager at 20 steps
    bit for bit, no kernel of the port in N or O.
34. Card vs CPU, f32, TF32 off, the metrics and the extras at small
    sizes: the pytorch-fid InceptionV3 on a 2-image batch at 75² (same
    synthetic weights) and its 299² resize from 28² and 512²; FLD (d 64)
    and its 2048-d distances with the TF32 flag on (a float64 product
    rounded to f32, within 1e-5 of float64); ``sample_grid_volume`` with
    a small porosity-conditioned ``SIModel`` from one replayed noise
    cube, plain and periodic (the
    corner cube at phase 2's tolerance, every known region exact);
    ``tiled_decode`` of a norm-free local decoder against the one-shot
    decode of the periodically padded latent.
35. Configuration Q, porous volumes at A's widths (``SIModel`` around A's
    PUNetG with a ``PorosityEmbedder(32)``, bf16 over f32 masters, 30
    steps, per-cube porosities from ``matern_grid_sample``): two 64³
    ``sample_grid_volume`` runs of a (2, 2, 2) grid of 32³ cubes, overlap
    8, plain (36³ cubes) and periodic (40³): exactly 260 network calls
    (5200 K2, 260 K4) a volume, the known regions exact, the periodic
    seams as continuous as interior slices; ``sample_sequential_z`` (3
    blocks of 32³, overlap 8: 87 calls); the ``DiffusionPeriodizer`` (pad
    and blend 8) around the flow field at 32³ (one call at 48³); the
    ``tiled_decode`` of a 128² × 4 latent through G's decoder without mid
    attention (no kernel; max|Δ| from the one-shot decode reported, peak
    memory of both): walls, the periodizer's and the decode's device
    times (the volumes and the stack run once, unprofiled), peak memory.
36. Configuration P, sample-quality evaluation at pytorch-fid's widths:
    2048 "real", 2048 generated and 1024 test images from B's
    ``KarrasModel`` (bucket 64, exact launches), a noised "far" set; the
    InceptionV3's pool3 features at batch 64 (images/s), FID, KID, FLD
    and the generalization gap at d 2048 (the three FIDs' host sqrtm
    side by side, their seconds; the FLD fit's): FID and KID of a set
    with itself ~0, generated closer than far by FID, KID and FLD.
37. The parallel modes over ``torch.distributed``. (a) One NCCL rank at
    full width: B's data-parallel train step (``replicate``,
    ``shard_batch``, the gradient all-reduce captured in the step's
    graph) against the plain graphed step of phase 8, bit for bit over 3
    steps from copies of one state and one set of draws (cuDNN's
    deterministic algorithms in both), each timed (host and device), the
    NCCL kernels of one profiled step listed; B's FSDP step against the
    plain one within phase 3's bounds; A's bucket-4 request through
    ``KarrasModel.sample(mesh=...)`` bit for bit against the request
    without a mesh; H's MoE twin under dp × ep and DiT-B's blocks
    through ``make_dit_pipeline`` at one stage, each against the plain
    forward (phase 2's tolerance); exact launch counts. (b) Two spawned
    ranks share the card over gloo: each collective probed on CUDA
    tensors, then every mode whose collectives gloo carries run at small
    sizes against the same rank's single-process result at the CPU
    tests' bounds; the modes run and those not run are printed.
38. Data-parallel serving, the dp × spatial step and the placed steps.
    (a) One NCCL rank at full width: A's bucket-4 request through
    ``SamplerService(mesh=)`` and over its HTTP server bit for bit the
    service without a mesh on the same model (35 K1, 700 K2, 35 K4; the
    request's wall beside the plain service's); F's ensemble, J's
    distill and K's VAE steps on ``replicate``d states, and A's train
    step on a (1, 1) data × spatial mesh (``shard_state_spatial``), each
    bit for bit the unplaced graphed step over 3 steps (cuDNN's
    deterministic algorithms). (b) Two spawned ranks on the one card
    over gloo: A's mesh service in f32 (rank 0 serves, rank 1 follows)
    against the single-process card service at batch 4 (rtol 1e-4, atol
    1e-5: each rank runs the network at batch 2, where cuDNN may take
    other f32 algorithms; the witness, the single-process sampler graph
    at batch 2 on each half's x_T, shows that gap) and against the
    witness within the CPU tests' bounds; A's full-width step on spatial =
    2 (32³ as two 16 × 32 × 32 slabs, batch 4) in f32 against the
    single-process step on the same weights and draws within the CPU
    tests' bounds, and in bf16 timed (eager, beside the single-process
    eager step), its launches a step exact (30 K2·S sums, 20 applies, 20
    K3·S partials and dx, one K4, K5, K6) and each rank's peak memory
    below the single-process step's; F's ensemble step at DP world 2 in
    f32 against the single-process step within the CPU tests' bounds.
39. FSDP with each layer's weights gathered as it runs (ZeRO 3) and
    composed with tensor parallelism, and the dp × spatial step of D and
    E. (a) One NCCL rank, graphed, at full width: B's FSDP step and its
    FSDP∘TP step on a (1, 1) data × tensor mesh, each bit for bit the
    plain graphed step over 3 steps (cuDNN's deterministic algorithms),
    timed beside phase 37's DP arm; a 64-image Heun sample from the
    FSDP-placed B bit for bit the unplaced model's (35 K1, 980 K2). (b)
    Two gloo ranks on the one card, eager, f32: B's FSDP step over 3
    steps against the single-process step within the CPU tests' bounds,
    the bytes its network's parameters hold between steps exactly the
    blocks and the unsharded tensors (a count), each rank's state bytes
    and peak memory beside the DP step's; as a reading, H's DiT-B at one
    bf16 step (DP against FSDP). (c) Four gloo ranks: B's FSDP∘TP step on
    a (2, 2) data × tensor mesh, f32, against the single-process step
    within the CPU tests' bounds (the group also runs phase 41's FSDP∘EP
    arm). (d) Two gloo ranks, spatial = 2: D at
    full width (32³ × 1, batch 4, ``PorosityEmbedder(32)``, the EDM batch
    norm, circular convolutions, flash bottleneck) in f32 against the
    single-process step on the same weights and replayed draws (the
    running ``mean``/``var`` too) within the CPU tests' bounds, and in
    bf16 timed with its launches a step exact (30 K2·S sums, 20 applies,
    20 K3·S partials and dx, one K4, K5, K6) and its peak memory a rank;
    E's widths on 32² (28² does not split into two slabs that pool
    twice: mp convolutions, cosine attention) in f32: the loss within its
    CPU bound, the parameters within phase 3's bound (E's f32 rounding at
    full width lies above the CPU tests' parameter bound on one process
    too; ``scripts/torch_spatial_rounding.py``), the CPU-bound ratio
    printed.
40. The scripts on the card: each script of ``diffsci_tpu_torch/scripts``
    calls its ``main()`` in-process with ``sys.argv`` set, ``--device
    cuda``. ``train_diffusion_mnist`` at its full defaults (64 channels,
    [2, 4], batch 256, the synthetic blobs, power EMA every 4 steps) for
    90 steps: the loss of step 50 below step 1's, exactly 28 K2 and 28 K3
    a train step and 35 K1 and 980 K2 a run of the 16-sample Heun grid
    (its warm-up and its replay), the checkpoint restored (through
    ``eval_fid``'s restore) bit for bit and its EMA sampling
    ``samples.npy`` again bit for bit; ``eval_fid`` on that checkpoint
    (200 samples at batch 100, FLD too) with exact K1 and K2 counts; every
    other script once at its test sizes, its output files asserted. Each
    script's wall and steps a second are printed beside the card's name
    and power limit.
41. The last four scripts, the sampler graphs keyed on the scheduler, and
    FSDP over an expert-parallel state. ``stochasticity_sweep`` at its
    widths (32 channels, [2], 28²), γ 0.0, 0.5, 1.0 of 250 samples and
    100 steps, sequential and with ``--processes 2``: the two JSONs equal
    bit for bit, the FIDs finite and not all equal, the sequential run's
    K1 and K2 exact (each γ's graph warmed up and replayed once: 2 × 199
    Heun calls and 2 × 2 × 100 Euler–Maruyama calls, 20 K2 a call) and
    the parent of the workers launching nothing. The repair: one model
    sampled at γ 0.5, its ``config.noisescheduler`` swapped to γ 3.0, the
    next sample bit for bit a fresh model's γ 3.0 sample and unlike the
    γ 0.5 one. ``stochasticity_study`` at its widths (32 channels, [2, 4],
    32², batch 128) for 100 steps, 256 samples at 18 NFE a γ over γ 0.01,
    1.0, 5.0: exact launches, which hold one sampler graph (a warm-up and
    three replays). ``picard_restart_trained`` at its widths for 100
    steps, its FID tier at 128 samples: every sampler call's K1 its
    network calls (Picard's the sweeps it reports, a capture's warm-up
    one more), K2 28 a K1, Picard at 18 steps matching Euler's sample,
    Picard at 100 steps in fewer than 100 sweeps; the arms' walls
    printed. ``repro_reference_fid --smoke``, then at 128 channels for 30
    steps (100 samples at 18 NFE a target): three finite FIDs a run, a
    ``--ckpt`` rerun of each the same FIDs bit for bit, train and sample
    launches exact. Four gloo ranks on the card (data 2 × expert 2;
    phase 39's group of four, which ran the arm):
    H's MoE twin cut to 2 blocks (768 wide, 12 heads of 64, 4 experts in
    the second block, 256² × 1 at patch 4, flash) in f32 at batch 8, one
    step of FSDP over dp × ep and of dp × ep against one process's step
    within the CPU tests' bounds, the parameters a rank holds under FSDP
    exactly its blocks and fewer than under dp × ep, K4, K5 and K6 twice
    a step on every rank. Every file goes to a temporary directory.
42. One JSON line lists every kernel with its launches over phases 5 to
    9, 11 to 15 and 17 to 41; the card's name and power limit; then the
    result line.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``python3 chip_smoke.py --profile`` adds to phase 10 one profiled call of
every arm (torch.profiler), eager and graphed: wall time, device kernel
time, the device's idle share, kernel launches on the device and launch
calls of the host, the kernels that take the most time and the sums of
K2's and K3's kernels.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# K1's and K7's checks: the main paths' shapes (B's sampler at bucket 64,
# A's at bucket 4, C's at 16 and 64, A's and B's Picard sweeps at batch
# 8, F's in-step sampler and G's rollout on 8 latents of 32² × 4), ragged
# rows, many short rows, one
# long row, and operands whose base is not 16-byte aligned (contiguous
# views at a storage offset of 1 element: x alone, f alone, x and f, and
# for K7 g alone and all three). (shape, the offset operands)
COMBINE_CASES = (((64, 28, 28, 1), ""), ((4, 32, 32, 32, 1), ""),
                 ((16, 32, 32, 3), ""), ((64, 32, 32, 3), ""),
                 ((8, 32, 32, 32, 1), ""), ((8, 28, 28, 1), ""),
                 ((8, 32, 32, 4), ""),
                 ((3, 1001), ""), ((5, 7), ""), ((4096, 3), ""),
                 ((1, 2 ** 20 + 3), ""), ((64, 28, 28, 1), "x"),
                 ((64, 28, 28, 1), "f"), ((64, 28, 28, 1), "xf"),
                 ((4, 32, 32, 32, 1), "xf"), ((16, 32, 32, 3), "g"),
                 ((16, 32, 32, 3), "xfg"), ((3, 1001), "xfg"))
# each wrapper's operands, and the shape at which bytes, not a launch's
# latency, set its time: K1 at a batch of 8 porous-media volumes of 128³
# (3 × 64 MB), K7 at 64 images of diffusers' google/ddpm-church-256
# (4 × 50 MB)
COMBINES = {"fused_axby": ("xf", (8, 1, 128, 128, 128)),
            "fused_lincomb3": ("xfg", (64, 3, 256, 256))}
# the main paths' launches of K1 (A's buckets 1 and 4, B's 1, 8 and 64)
# and K7 (C's buckets 1 and 16), timed by device time
COMBINE_TIMED = {"fused_axby": ((1, 32, 32, 32, 1), (4, 32, 32, 32, 1),
                                (1, 28, 28, 1), (8, 28, 28, 1),
                                (64, 28, 28, 1)),
                 "fused_lincomb3": ((1, 32, 32, 3), (16, 32, 32, 3))}

# (B, H, T, d) of phase 1's flash checks; the first is config A's, then
# A's Picard sweep (window 8 at bucket 1), H's (DiT-B: 12 heads of 64) and
# I's (ADM: one head of 256) bucket-4 attentions and a head dim of 512
# (ADM at model_channels 128), then head dims above 128 at ragged T: 136
# and 192 (one pass of the wgmma kernels), 320 (two 192-column chunks),
# 200 (aligned rows, zero-padded columns) and 260 (rows not 16-byte
# aligned: the mma.sync wide kernels); then Q's bottleneck attentions at
# ragged T: 36³ and 40³ cubes (18³, 20³ tokens) and the periodizer's 48³
FLASH_SWEEP = ((4, 2, 4096, 32), (1, 2, 4096, 8), (2, 4, 4096, 16),
               (1, 2, 4097, 32), (1, 1, 2049, 64), (1, 1, 2111, 128),
               (2, 1, 2048, 40), (1, 2, 2048, 20), (8, 2, 4096, 32),
               (4, 12, 4096, 64), (4, 1, 4096, 256), (1, 2, 2048, 512),
               (1, 1, 2049, 136), (1, 1, 2111, 192), (1, 2, 2049, 320),
               (2, 1, 2111, 200), (1, 1, 2049, 260),
               (1, 2, 5832, 32), (1, 2, 8000, 32), (1, 2, 13824, 32))
# K4-K6 timed beside SDPA at the new routes: H's and I's serving (bucket 4)
# and training (batch 8) shapes, and head dim 512 (beside SDPA's
# memory-efficient backend where it takes the shape: its flash backend
# takes head dims up to 256)
FLASH_TIMED = (((4, 12, 4096, 64), "H, bucket 4"),
               ((8, 12, 4096, 64), "H, train batch 8"),
               ((4, 1, 4096, 256), "I, bucket 4"),
               ((8, 1, 4096, 256), "I, train batch 8"),
               ((1, 2, 2048, 512), "head dim 512"))

NSTEPS = 18
NFE = 2 * NSTEPS - 1       # Heun with the EDM endpoint rule
DDIM_STEPS = 100           # configuration C's two serving arms
DDPM_STEPS = 1000          # the classical schedule's own T
# the kernels a sample runs, and those a train step runs (its combine is
# the plain expression, as in the JAX package)
FORWARD = ("fused_axby", "norm_silu", "flash_attention")
TRAIN = ("norm_silu", "norm_silu_bwd", "flash_attention",
         "flash_attention_dq", "flash_attention_dkv")
# parts of the port's CUDA kernels' names, for the profile's lines
PORT_KERNELS = ("axby_kernel", "lincomb3_kernel", "norm_silu_",
                "norm_split_", "flash_fwd", "flash_dq", "flash_dkv")
# K2·S and K3·S: the wrapper (its LAUNCHES key), its kernels' names in a
# profile, and the Pallas kernel it replaces half of
SPLIT_NORMS = {
    "norm_silu_stats": ("norm_split_sums", "fused_norm.py:140"),
    "norm_silu_apply": ("norm_split_store", "fused_norm.py:140"),
    "norm_silu_bwd_partials": ("norm_split_sums", "fused_norm.py:191"),
    "norm_silu_bwd_dx": ("norm_split_store", "fused_norm.py:191")}
# their checks: A's slabs over 2 ranks (the full-width spatial step's 32³
# and bottleneck norms), B's train-batch norm split over 2 (28 -> 14 rows
# of 28), an unaligned row and base, and rows beyond a cluster; (shape,
# element offset of x's base)
SPLIT_CASES = (((4, 32, 16, 32, 32), 0), ((4, 64, 8, 16, 16), 0),
               ((256, 64, 14, 28), 0), ((2, 3, 1001), 1),
               ((1, 2, 300000), 0))
# K2's and K3's kernels (one per launch shape), whose device times the
# profile also sums
NORM_KERNELS = {"K2": ("norm_silu_rows", "norm_silu_cluster",
                       "norm_silu_stream"),
                "K3": ("norm_silu_bwd_",)}
# the CUDA API calls by which the host launches work (kernels one at a
# time, a CUDA graph whole), as torch.profiler names them
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
# a buffer larger than the H100's 50 MB L2, written between launches to
# time a kernel with its inputs out of L2
FLUSH_BYTES = 128 * 2 ** 20


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of one call, CUDA events around ``iters`` calls
    after a warm-up (L2 warm)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(evt) -> float:
    """A profiler event's own device time, in µs."""
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def device_ms(fn, iters: int, names=None) -> float:
    """Device time per call: the summed durations of the kernels that
    ``iters`` calls of ``fn`` launch (those whose names contain one of
    ``names``; every kernel when None), from torch.profiler, after a
    warm-up. Unlike ``cuda_ms`` it leaves out the host's time between
    launches. A trace that holds no device event at all is taken again,
    five times at most: the tracer has returned one such empty trace
    among some 60 in one process, and three in a row among some 150
    (scripts/torch_norm_variants.py)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        if events:
            break
    total = sum(device_us(e) for e in events
                if names is None or any(n in e.key for n in names))
    if total == 0:
        raise AssertionError(f"the profiler saw no device time of {names}")
    return total / iters / 1e3


def cold_device_ms(fn, iters: int, names) -> float:
    """``device_ms`` of ``fn`` with its inputs out of L2: a buffer larger
    than L2 is written before each call, and only the kernels whose names
    contain one of ``names`` are counted."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")

    def cold():
        flush.zero_()
        fn()

    return device_ms(cold, iters, names)


def cuda_ms_spread(fn, iters: int, repeats: int = 5):
    """Median, min and max of ``repeats`` runs of ``cuda_ms``."""
    runs = sorted(cuda_ms(fn, iters) for _ in range(repeats))
    return runs[len(runs) // 2], runs[0], runs[-1]


def smi(query: str) -> str:
    """One ``nvidia-smi --query-gpu`` field of card 0."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sfu_floor_ms(n_exp: float) -> float:
    """Least time of ``n_exp`` exponentials on the special-function units:
    16 results per clock per SM (CUDA C Programming Guide, throughput
    table, compute capability 9.0) at the card's maximum SM clock. Printed
    beside ``bound_ms``, not folded into it."""
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_exp / (16 * sms * mhz * 1e6) * 1e3


def tensor_core_counts() -> dict[str, list[list[int]]]:
    """HMMA (``mma.sync``) and HGMMA (``wgmma``) instructions in each
    instantiation of each kernel of the flash libraries, from ``cuobjdump
    -sass`` (the toolkit beside nvcc) of the built libraries: {kernel
    name: [[HMMA, HGMMA] per instantiation]}."""
    from diffsci_tpu_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    counts: dict[str, list[list[int]]] = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        n = None
        for line in sass.splitlines():
            found = re.search(
                r"Function : \S*?(flash_[a-z_]+?_kernel)[IE]", line)
            if found:
                n = counts.setdefault(found.group(1), [])
                n.append([0, 0])
            elif n is not None:
                n[-1][0] += bool(re.search(r"\bHMMA\b", line))
                n[-1][1] += bool(re.search(r"\bHGMMA\b", line))
    return counts


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(shape, dtype, gen, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale
            + shift).to(dtype)


def offset_randn(shape, dtype, offset, gen, scale=1.0):
    """``randn`` as a contiguous view at a storage offset of ``offset``
    elements (1: a base that is not 16-byte aligned)."""
    n = int(np.prod(shape))
    return randn(n + offset, dtype, gen, scale)[offset:].view(shape)


def within(out, ref, dtype, f32_limit):
    """max |out - ref| and whether it is inside the stated tolerance:
    f32_limit in float32; |Δ| <= 2e-2 + 2e-2·|ref| in bfloat16."""
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    if dtype == torch.float32:
        return err, err <= f32_limit
    return err, bool((diff <= 2e-2 + 2e-2 * ref.float().abs()).all())


# K4's tolerance on O. With N(0, 1) scores a typical |O| is sqrt(e/T), a few
# 1e-2 at T = 4096, so an absolute 2e-2 would pass wrong outputs; in bf16
# each entry gets one bf16 step of itself (2^-7·|ref|: both sides round
# their f32 result once) plus 2e-3 of the largest entry.
ATTN_LIMIT = "1e-4 (f32), 2^-7|ref| + 2e-3 max|ref| (bf16)"


def within_attention(out, ref, dtype):
    """K4's O against its plain version: max |out - ref|, the largest
    |out - ref| / ATTN_LIMIT (inside the limit at <= 1) and
    max |out - ref| / max |ref|."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    err, top = float(diff.max()), float(ref.abs().max())
    limit = (1e-4 if dtype == torch.float32
             else 2 ** -7 * ref.abs() + 2e-3 * top)
    return err, float((diff / limit).max()), err / top


# the backward kernels' tolerance, relative to the largest entry of the
# plain version's output: its sums run over up to 256·784 = 200704
# elements (dw, db) or 4097 keys and queries (dQ, dK, dV), in another order
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
GRAD_LIMIT = "1e-4 max|ref| (f32), 1e-2 max|ref| (bf16)"


def within_grad(outs, refs, dtype):
    """max |out - ref| over the outputs, whether each output is inside
    GRAD_TOL of its plain version's largest entry, and the largest ratio
    max |out - ref| / max |ref| (the quantity GRAD_TOL bounds)."""
    err, ok, ratio = 0.0, True, 0.0
    for out, ref in zip(outs, refs):
        e = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        err = max(err, e)
        ratio = max(ratio, e / scale if scale > 0 else float(e > 0))
        ok = ok and e <= GRAD_TOL[dtype] * scale
    return err, ok, ratio


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_combines(fp, gen, record):
    """K1 in its 4 dtype combinations of x and f and K7 in its 8 of x, f
    and g, at every case of COMBINE_CASES and at their byte-bound shapes:
    bit for bit against the plain version where x is f32 (both round
    a·x + b·f (+ c·g) term by term), |Δ| <= 2e-2 + 2e-2·|ref| where it is
    bf16, and the same bits when run again on the same inputs. Then
    euler_update (one K1 launch) against its plain form
    x + (t_next − t)/t·(x − D) at configuration B's sampler state, f32,
    within 1e-5."""
    dts = (torch.float32, torch.bfloat16)
    for name, (operands, big) in COMBINES.items():
        wrapper, plain = getattr(fp, name), getattr(fp, f"{name}_plain")
        for shape, offsets in COMBINE_CASES + ((big, ""),):
            if not set(offsets) <= set(operands):
                continue
            coeffs = [randn(shape[0], torch.float32, gen) for _ in operands]
            worst = {}
            for dtypes in itertools.product(dts, repeat=len(operands)):
                tensors = [offset_randn(shape, dt, int(o in offsets), gen,
                                        40.0 if o == "x" else 1.0)
                           for o, dt in zip(operands, dtypes)]
                out = wrapper(*tensors, *coeffs)
                err, ok = within(out, plain(*tensors, *coeffs), dtypes[0],
                                 0.0)
                ok = ok and out.dtype == dtypes[0] and torch.equal(
                    out, wrapper(*tensors, *coeffs))
                e, o = worst.get(dtypes[0], (0.0, True))
                worst[dtypes[0]] = (max(e, err), o and ok)
            label = (f"{list(shape)}{' +1 ' + offsets if offsets else ''} "
                     f"({2 ** (len(operands) - 1)} combinations of "
                     f"{'/'.join(operands[1:])} dtypes, twice), x")
            for dtype, (err, ok) in worst.items():
                record(name, label, dtype, err, ok,
                       "0 (bit for bit)" if dtype == torch.float32
                       else "2e-2+2e-2|ref|")

    x, f = (randn((64, 28, 28, 1), torch.float32, gen) for _ in range(2))
    c_skip = torch.rand(64, generator=gen, device="cuda")
    c_out = randn(64, torch.float32, gen)
    t = torch.rand(64, generator=gen, device="cuda") * 9 + 1
    t_next = t * (0.5 + 0.4 * torch.rand(64, generator=gen, device="cuda"))
    rows = (64, 1, 1, 1)
    d = c_skip.view(rows) * x + c_out.view(rows) * f
    ref = x + ((t_next - t) / t).view(rows) * (x - d)
    err, ok = within(fp.euler_update(x, f, c_skip, c_out, t, t_next), ref,
                     torch.float32, 1e-5)
    record("fused_axby", "euler_update [64, 28, 28, 1] against "
           "x + (t_next - t)/t·(x - D)", torch.float32, err, ok, "1e-5")


def time_combines(fp, gen):
    """K1 and K7 timed in float32, the main paths' dtype: by device time
    (torch.profiler) at each launch shape of COMBINE_TIMED and at their
    byte-bound shapes, each beside its least time by bytes and beside the
    device time of a PyTorch elementwise pass over the same bytes
    (``torch.add(x, f)`` for K1, ``torch.addcmul(x, f, g)`` for K7: not
    the same function, the card's floor for such a launch); and by the
    host's time a call, back to back under inference mode as the
    sampling loops call them, the wrapper and its plain version in two
    rounds in turn. Returns the records of the kernels line (B's bucket
    64 for K1, C's bucket 16 for K7)."""
    floors = {"fused_axby": ("torch.add(x, f)", lambda x, f: torch.add(x, f)),
              "fused_lincomb3": ("torch.addcmul(x, f, g)",
                                 lambda x, f, g: torch.addcmul(x, f, g))}
    kernel_names = {"fused_axby": ("axby_kernel",),
                    "fused_lincomb3": ("lincomb3_kernel",)}
    records = {}
    for name, (operands, big) in COMBINES.items():
        wrapper, plain = getattr(fp, name), getattr(fp, f"{name}_plain")
        floor_label, floor = floors[name]
        k = len(operands)
        for shape in COMBINE_TIMED[name] + (big,):
            tensors = [randn(shape, torch.float32, gen) for _ in operands]
            coeffs = [randn(shape[0], torch.float32, gen) for _ in operands]
            n = tensors[0].numel()
            # reads each operand and its coefficients, writes out; k
            # products and k - 1 sums an element
            bms, bby = bound(4 * (k + 1) * n + 4 * k * shape[0],
                             (2 * k - 1) * n, torch.float32)
            iters = 20 if shape == big else 200
            dev = device_ms(lambda: wrapper(*tensors, *coeffs), iters,
                            kernel_names[name])
            floor_ms = device_ms(lambda: floor(*tensors), iters)
            log(f"[kernels] device time {name} {list(shape)} float32: "
                f"{dev:.5f} ms, bound {bms:.5f} ms ({bby}; "
                f"{bms / dev:.1%} of it), {floor_label} device "
                f"{floor_ms:.5f} ms")
            if shape == COMBINE_TIMED[name][-1]:
                host = {"kernel": [], "plain": []}
                with torch.inference_mode():
                    for _ in range(2):
                        host["kernel"].append(cuda_ms(
                            lambda: wrapper(*tensors, *coeffs), 200))
                        host["plain"].append(cuda_ms(
                            lambda: plain(*tensors, *coeffs), 200))
                grad_on = cuda_ms(lambda: wrapper(*tensors, *coeffs), 200)
                log(f"[kernels] host ms a call {name} {list(shape)}, back "
                    f"to back under inference mode, two rounds in turn: "
                    f"wrapper {host['kernel'][0]:.4f}, {host['kernel'][1]:.4f}"
                    f"; plain {host['plain'][0]:.4f}, {host['plain'][1]:.4f}"
                    f"; wrapper with autograd on (the Function) "
                    f"{grad_on:.4f}")
                records[name] = dict(
                    shape=f"{list(shape)} float32, host ms under inference "
                          "mode (the better of two rounds)",
                    ms=min(host["kernel"]), device_ms=dev,
                    plain_ms=min(host["plain"]), library_ms=None,
                    bound_ms=bms, bound_by=bby, floor=floor_label,
                    floor_ms=floor_ms)
    return records


def time_flash_routes(fa, gen):
    """K4, K5 and K6 in bf16 at ``FLASH_TIMED`` (medians of 5 timed
    loops) beside SDPA (forward, and the backward asked for dQ or dK, dV)
    on its flash backend where it takes the head dim, else on its
    memory-efficient backend where that takes the shape, with each
    kernel's bound, its time as a share of the bound and the SFU floor of
    its T² exponentials a head; logged only."""
    for shape, label in FLASH_TIMED:
        B, H, T, d = shape
        BH = B * H
        q, k, v, do = (randn(shape, torch.bfloat16, gen) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        reads = 4 * 2 * BH * T * d + 2 * 4 * BH * T
        sfu = sfu_floor_ms(BH * T * T)

        def sdpa_bwd(wrt):
            leaves = [t.detach().requires_grad_(i in wrt)
                      for i, t in enumerate((q, k, v))]
            out = F.scaled_dot_product_attention(*leaves)
            inputs = [leaves[i] for i in wrt]
            return cuda_ms_spread(lambda: torch.autograd.grad(
                out, inputs, do, retain_graph=True), 10)

        backend = (SDPBackend.FLASH_ATTENTION if d <= 256
                   else SDPBackend.EFFICIENT_ATTENTION)
        lib = {}
        for name, fn in (
                ("K4", lambda: cuda_ms_spread(
                    lambda: F.scaled_dot_product_attention(q, k, v), 10)),
                ("K5", lambda: sdpa_bwd((0,))),
                ("K6", lambda: sdpa_bwd((1, 2)))):
            try:  # a yardstick only: "none" where SDPA refuses the shape
                with sdpa_kernel(backend):
                    lib[name] = fn()
            except RuntimeError:
                pass
        which = "SDPA" if d <= 256 else "SDPA (memory-efficient)"
        for name, fn, nbytes, flops in (
                ("K4", lambda: fa.flash_attention_fwd(q, k, v),
                 4 * 2 * BH * T * d + 4 * BH * T, 4 * BH * T * T * d),
                ("K5", lambda: fa.flash_attention_dq(q, k, v, do, lse,
                                                     delta),
                 reads + 2 * BH * T * d, 6 * BH * T * T * d),
                ("K6", lambda: fa.flash_attention_dkv(q, k, v, do, lse,
                                                      delta),
                 reads + 2 * 2 * BH * T * d, 8 * BH * T * T * d)):
            ms = cuda_ms_spread(fn, 10)
            bms, bby = bound(nbytes, flops, torch.bfloat16)
            sdpa = (f"{which} {lib[name][0]:.4f} ms ({lib[name][1]:.4f}-"
                    f"{lib[name][2]:.4f})" if name in lib else "SDPA none")
            log(f"[kernels] time {name} {list(shape)} bf16 ({label}): "
                f"{ms[0]:.4f} ms ({ms[1]:.4f}-{ms[2]:.4f}), "
                f"{100 * bms / ms[0]:.1f} % of bound, {sdpa}, bound "
                f"{bms:.4f} ms ({bby}), SFU floor {sfu:.4f} ms")


def phase_kernels():
    from diffsci_tpu_torch import kernels
    from diffsci_tpu_torch.kernels import (flash_attention as fa,
                                           fused_norm as fn,
                                           fused_precondition as fp)

    t0 = time.perf_counter()
    kernels.build()
    log(f"[kernels] built {len(kernels.SOURCES)} libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator("cuda").manual_seed(0)
    failures = []
    errs = dict.fromkeys(kernels.LAUNCHES, 0.0)

    def record(name, label, dtype, err, ok, limit):
        errs[name] = max(errs[name], err)
        log(f"[kernels] {name} {label} {str(dtype)[6:]}: max_abs_err "
            f"{err:.3e} (limit {limit}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} {label} {dtype}")

    check_combines(fp, gen, record)
    check_split_norms(fn, gen, record)

    # config A serves and trains at batch 4 (and serves at bucket 1);
    # config B serves at bucket 64 and trains at batch 256; A's and B's
    # Picard sweeps run the net at batch 8 (B also serves bucket 8); rows
    # that are not 16-byte aligned (S = 49, 1001) and an x whose base is
    # not (a view at an element offset of 1); off-centre inputs
    # (|μ| = 100σ); rows beyond a cluster's shared memory (f32
    # [1, 2, 300000]: the stream kernel); F's loss at its denoiser batch
    # 32 and its in-step sampler, G's rollout and latent training at batch
    # 8, on 32² latents. (shape, scale, shift, offset)
    norm_cases = [((4, 32, 32, 32, 32), 2.0, 0.3, 0),
                  ((4, 64, 16, 16, 16), 2.0, 0.3, 0),
                  ((1, 32, 32, 32, 32), 2.0, 0.3, 0),
                  ((64, 64, 28, 28), 2.0, 0.3, 0),
                  ((64, 128, 14, 14), 2.0, 0.3, 0),
                  ((64, 256, 7, 7), 2.0, 0.3, 0),
                  ((256, 64, 28, 28), 2.0, 0.3, 0),
                  ((256, 128, 14, 14), 2.0, 0.3, 0),
                  ((256, 256, 7, 7), 2.0, 0.3, 0),
                  ((8, 32, 32, 32, 32), 2.0, 0.3, 0),
                  ((8, 64, 16, 16, 16), 2.0, 0.3, 0),
                  ((8, 64, 28, 28), 2.0, 0.3, 0),
                  ((8, 128, 14, 14), 2.0, 0.3, 0),
                  ((8, 256, 7, 7), 2.0, 0.3, 0),
                  ((32, 64, 32, 32), 2.0, 0.3, 0),
                  ((32, 128, 16, 16), 2.0, 0.3, 0),
                  ((32, 256, 8, 8), 2.0, 0.3, 0),
                  ((8, 64, 32, 32), 2.0, 0.3, 0),
                  ((8, 128, 16, 16), 2.0, 0.3, 0),
                  ((8, 256, 8, 8), 2.0, 0.3, 0),
                  ((3, 5, 7, 7), 2.0, 0.3, 0), ((2, 3, 1001), 2.0, 0.3, 0),
                  ((2, 3, 1001), 2.0, 0.3, 1), ((64, 64, 28, 28), 2.0, 0.3, 1),
                  ((1, 32, 32, 32, 32), 2.0, 0.3, 1),
                  ((1, 32, 32, 32, 32), 1.0, 100.0, 0),
                  ((64, 256, 7, 7), 1.0, 100.0, 0),
                  ((1, 2, 300000), 2.0, 0.3, 0)]
    for shape, scale, shift, offset in norm_cases:
        for kind in ("ln", "rms"):
            for dtype in (torch.float32, torch.bfloat16):
                C = shape[1]
                n = int(np.prod(shape))
                x = randn(n + offset, dtype, gen, scale, shift)[offset:] \
                    .view(shape)
                w = randn((C,), dtype, gen, 0.2, 1.0)
                b = randn((C,), dtype, gen, 0.1)
                y, mean, rstd = fn.norm_silu_fwd(x, w, b, kind)
                ry, rmean, rrstd = fn.norm_silu_plain(x, w, b, kind)
                err, ok = within(y, ry, dtype, 1e-4)
                # the statistics within 1e-4 relative: the mean to
                # max(1, |mean|), rstd to itself
                serr = float(torch.maximum(
                    ((mean - rmean).abs() / rmean.abs().clamp(min=1)).max(),
                    ((rstd - rrstd).abs() / rrstd).max()))
                ok = ok and serr <= 1e-4
                label = (f"{list(shape)}{' +1' if offset else ''}"
                         f"{' shift 100' if shift == 100.0 else ''} {kind}")
                record("norm_silu", f"{label} (stats {serr:.1e})", dtype,
                       err, ok, "1e-4" if dtype == torch.float32 else
                       "2e-2+2e-2|ref|")
                # K3 on the forward's own statistics; in bf16 at A's and B's
                # largest train-step norms it runs twice and must give the
                # same bits (one writer per output, sums in a fixed order)
                g = randn(shape, dtype, gen)
                got = fn.norm_silu_bwd(g, x, mean, rstd, w, b, kind)
                err, ok, ratio = within_grad(
                    got, fn.norm_silu_bwd_plain(g, x, mean, rstd, w, b, kind),
                    dtype)
                if dtype == torch.bfloat16 and (shape, offset, shift) in (
                        ((4, 32, 32, 32, 32), 0, 0.3),
                        ((256, 64, 28, 28), 0, 0.3)):
                    same = all(torch.equal(a, b_) for a, b_ in zip(
                        got, fn.norm_silu_bwd(g, x, mean, rstd, w, b, kind)))
                    log(f"[kernels] norm_silu_bwd {list(shape)} {kind} "
                        f"bfloat16 twice: "
                        f"{'bit-identical' if same else 'DIFFERENT'}")
                    ok = ok and same
                record("norm_silu_bwd", f"{label} (dx, dw, db; "
                       f"max|Δ|/max|ref| {ratio:.1e})", dtype, err, ok,
                       GRAD_LIMIT)

    # K4, and K5/K6 on its own O and lse: config A, the phase 2/3 net's head
    # dim 8, ragged T, every head-dim template, and head dims that are no
    # template's (20: rows not 16-byte aligned, the element-load path)
    for shape in FLASH_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (randn(shape, dtype, gen) for _ in range(3))
            o, lse = fa.flash_attention_fwd(q, k, v)
            ro, rlse = fa.flash_attention_plain(q, k, v)
            err, share, ratio = within_attention(o, ro, dtype)
            lerr = float((lse - rlse).abs().max())
            record("flash_attention", f"{list(shape)} (max|Δ|/max|ref| "
                   f"{ratio:.1e}, largest |Δ|/limit {share:.2f}; lse "
                   f"{lerr:.1e}, limit 1e-3)", dtype, err,
                   share <= 1 and lerr <= 1e-3, ATTN_LIMIT)
            # K5 and K6 on the forward's own O and lse; in bf16 at config
            # A's shape and at every head dim above 128, K4, K5 and K6 each
            # run twice and must give the same bits (one writer per output
            # tile, no atomics)
            twice = dtype == torch.bfloat16 and (shape == FLASH_SWEEP[0]
                                                 or shape[-1] > 128)
            if twice:
                same = torch.equal(o, fa.flash_attention_fwd(q, k, v)[0])
                log(f"[kernels] flash_attention {list(shape)} bfloat16 "
                    f"twice: {'bit-identical' if same else 'DIFFERENT'}")
                if not same:
                    failures.append(f"flash_attention {shape} twice")
            do = randn(shape, dtype, gen)
            delta = (do.float() * o.float()).sum(-1)
            for name, kernel, plain, what in (
                    ("flash_attention_dq", fa.flash_attention_dq,
                     fa.flash_attention_dq_plain, "dQ"),
                    ("flash_attention_dkv", fa.flash_attention_dkv,
                     fa.flash_attention_dkv_plain, "dK, dV")):
                got = kernel(q, k, v, do, lse, delta)
                got = got if isinstance(got, tuple) else (got,)
                ref = plain(q, k, v, do, lse, delta)
                ref = ref if isinstance(ref, tuple) else (ref,)
                err, ok, ratio = within_grad(got, ref, dtype)
                if twice:
                    again = kernel(q, k, v, do, lse, delta)
                    again = again if isinstance(again, tuple) else (again,)
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    log(f"[kernels] {name} {list(shape)} bfloat16 twice: "
                        f"{'bit-identical' if same else 'DIFFERENT'}")
                    ok = ok and same
                record(name, f"{list(shape)} ({what}; max|Δ|/max|ref| "
                       f"{ratio:.1e})", dtype, err, ok, GRAD_LIMIT)

    # the bf16 K4, K5 and K6 run on the tensor cores: mma.sync (HMMA), and
    # wgmma (HGMMA) in the wide K4, K5 and K6 of aligned rows
    counts = tensor_core_counts()
    for kernel, per_instance in sorted(counts.items()):
        log(f"[kernels] sass {kernel}: [HMMA, HGMMA] per instantiation "
            f"{sorted(per_instance)}")
    for kernel, kind in (("flash_fwd_mma_kernel", 0),
                         ("flash_dq_mma_kernel", 0),
                         ("flash_dkv_mma_kernel", 0),
                         ("flash_fwd_wide_mma_kernel", 0),
                         ("flash_dq_wide_mma_kernel", 0),
                         ("flash_dkv_wide_mma_kernel", 0),
                         ("flash_fwd_wgmma_kernel", 1),
                         ("flash_dq_wgmma_kernel", 1),
                         ("flash_dq_wgmma_pair_kernel", 1),
                         ("flash_dkv_wgmma_kernel", 1)):
        if min(c[kind] for c in counts.get(kernel, [[0, 0]])) == 0:
            failures.append(f"{kernel}: no {('HMMA', 'HGMMA')[kind]} "
                            "instructions")
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")

    # -- timings at the main path's shapes --------------------------------
    records = time_combines(fp, gen)

    # K2 at config A's largest norm, and at its serving bucket 1 (32 rows:
    # the cluster split); GroupNorm + SiLU, two PyTorch calls, beside it
    k2_names = NORM_KERNELS["K2"]
    for batch in (4, 1):
        shape = (batch, 32, 32, 32, 32)
        x = randn(shape, torch.bfloat16, gen, 2.0, 0.3)
        w = randn((32,), torch.bfloat16, gen, 0.2, 1.0)
        b = randn((32,), torch.bfloat16, gen, 0.1)
        n = x.numel()
        # 10 flops per element: mean, centred square, normalise, affine,
        # SiLU
        bms, bby = bound(2 * 2 * n + 2 * 2 * 32 + 2 * 4 * batch * 32,
                         10 * n, torch.float32)
        rec = dict(
            shape=f"x [{batch}, 32, 32, 32, 32] bf16 'ln' (config A, "
                  f"bucket {batch})",
            ms=cuda_ms(lambda: fn.norm_silu(x, w, b, "ln"), 50),
            device_ms=device_ms(lambda: fn.norm_silu(x, w, b, "ln"), 50,
                                k2_names),
            plain_ms=cuda_ms(lambda: fn.norm_silu_plain(x, w, b, "ln"), 50),
            library_ms=None, bound_ms=bms, bound_by=bby)

        def two_calls():
            return F.silu(F.group_norm(x, 32, w, b, 1e-5))

        rec["group_norm_silu"] = (cuda_ms(two_calls, 50),
                                  device_ms(two_calls, 50))
        if batch == 4:
            records["norm_silu"] = rec
        else:
            bucket1 = rec

    shape = (4, 2, 4096, 32)
    q, k, v = (randn(shape, torch.bfloat16, gen) for _ in range(3))
    BH, T, d = 8, 4096, 32
    sfu = sfu_floor_ms(BH * T * T)    # K4, K5 and K6 alike

    def flash_record(label, kernel, plain, library, nbytes, flops):
        """Medians of 5 timed loops, with their ranges, for K4-K6 and their
        yardstick, which is pinned to SDPA's flash backend so that it
        cannot change between runs."""
        ms = cuda_ms_spread(kernel, 20)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib = library()
        bms, bby = bound(nbytes, flops, torch.bfloat16)
        return dict(shape=label, ms=ms[0], ms_range=ms[1:],
                    plain_ms=cuda_ms(plain, 20), library_ms=lib[0],
                    library_range=lib[1:], bound_ms=bms, bound_by=bby,
                    sfu_ms=sfu)

    records["flash_attention"] = flash_record(
        "q, k, v [4, 2, 4096, 32] bf16 (config A, bucket 4)",
        lambda: fa.flash_attention_fwd(q, k, v),
        lambda: fa.flash_attention_plain(q, k, v),
        lambda: cuda_ms_spread(
            lambda: F.scaled_dot_product_attention(q, k, v), 20),
        4 * 2 * BH * T * d + 4 * BH * T, 4 * BH * T * T * d)

    # K3 at config A's and config B's largest train-step norms: reads g, x,
    # the [B, C] statistics, w and b, writes dx and the [B, C] partials of
    # dw and db; ~25 flops per element. Its device time with the inputs in
    # L2 and out of it (in a train step x was written by the forward long
    # before).
    k3_records = []
    for shape, label in (((4, 32, 32, 32, 32), "config A, train batch 4"),
                         ((256, 64, 28, 28), "config B, train batch 256")):
        B, C = shape[:2]
        x, g = (randn(shape, torch.bfloat16, gen, 2.0, 0.3)
                for _ in range(2))
        w = randn((C,), torch.bfloat16, gen, 0.2, 1.0)
        b = randn((C,), torch.bfloat16, gen, 0.1)
        _, mean, rstd = fn.norm_silu_fwd(x, w, b, "ln")
        n = x.numel()
        bms, bby = bound(3 * 2 * n + 4 * 4 * B * C + 2 * 2 * C, 25 * n,
                         torch.float32)

        def k3(g=g, x=x, mean=mean, rstd=rstd, w=w, b=b):
            return fn.norm_silu_bwd(g, x, mean, rstd, w, b, "ln")

        k3_records.append(dict(
            shape=f"g, x {list(shape)} bf16 'ln' ({label})",
            ms=cuda_ms(k3, 50),
            device_ms=device_ms(k3, 50, NORM_KERNELS["K3"]),
            cold_device_ms=cold_device_ms(k3, 50, NORM_KERNELS["K3"]),
            plain_ms=cuda_ms(
                lambda: fn.norm_silu_bwd_plain(g, x, mean, rstd, w, b, "ln"),
                50),
            library_ms=None, bound_ms=bms, bound_by=bby))
    records["norm_silu_bwd"] = k3_records[0]

    # K5 and K6 at config A's bottleneck: each reads q, k, v, dO, lse and
    # delta; K5 writes dQ (S, dP, dQ: 6·BH·T²·d flops), K6 dK and dV
    # (S, dP, dV, dK: 8·BH·T²·d). The library yardstick is the backward of
    # scaled_dot_product_attention asked for the same gradients.
    shape = (4, 2, 4096, 32)
    q, k, v, do = (randn(shape, torch.bfloat16, gen) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    reads = 4 * 2 * BH * T * d + 2 * 4 * BH * T

    def sdpa_bwd_ms(wrt):
        leaves = [t.detach().requires_grad_(i in wrt)
                  for i, t in enumerate((q, k, v))]
        out = F.scaled_dot_product_attention(*leaves)
        inputs = [leaves[i] for i in wrt]
        return cuda_ms_spread(lambda: torch.autograd.grad(
            out, inputs, do, retain_graph=True), 20)

    label = "q, k, v, dO [4, 2, 4096, 32] bf16 (config A, train batch 4)"
    records["flash_attention_dq"] = flash_record(
        label, lambda: fa.flash_attention_dq(q, k, v, do, lse, delta),
        lambda: fa.flash_attention_dq_plain(q, k, v, do, lse, delta),
        lambda: sdpa_bwd_ms((0,)), reads + 2 * BH * T * d,
        6 * BH * T * T * d)
    records["flash_attention_dkv"] = flash_record(
        label, lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta),
        lambda: fa.flash_attention_dkv_plain(q, k, v, do, lse, delta),
        lambda: sdpa_bwd_ms((1, 2)), reads + 2 * 2 * BH * T * d,
        8 * BH * T * T * d)
    time_flash_routes(fa, gen)
    records.update(time_split_norms(fn, gen))
    # the records of the kernels line, and after K2's and K3's their second
    # shapes, which are logged only
    extra = {"norm_silu": [bucket1], "norm_silu_bwd": k3_records[1:]}
    timed = [(name, r) for name, rec in records.items()
             for r in [rec] + extra.get(name, [])]
    for name, rec in timed:
        rec["max_abs_err"] = errs[name]
        spread = " (median of 5, {:.4f}-{:.4f})"
        ms = f"{rec['ms']:.4f} ms" + (spread.format(*rec["ms_range"])
                                      if "ms_range" in rec else "")
        if "device_ms" in rec:
            ms += (f" back to back (the host's launch rate), device "
                   f"{rec['device_ms']:.4f} ms")
        if "cold_device_ms" in rec:
            ms += f" (L2 warm), {rec['cold_device_ms']:.4f} ms (L2 cold)"
        lib = ("" if rec["library_ms"] is None else
               f", library {rec['library_ms']:.4f} ms"
               + (spread.format(*rec["library_range"])
                  if "library_range" in rec else ""))
        if "floor_ms" in rec:
            lib += f", {rec['floor']} device {rec['floor_ms']:.4f} ms"
        if "group_norm_silu" in rec:
            lib += (", F.group_norm + F.silu (two calls) {:.4f} ms back to "
                    "back, device {:.4f} ms").format(*rec["group_norm_silu"])
        sfu = (f", SFU floor {rec['sfu_ms']:.4f} ms" if "sfu_ms" in rec
               else "")
        log(f"[kernels] time {name} at {rec['shape']}: {ms}, plain "
            f"{rec['plain_ms']:.4f} ms{lib}, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}){sfu}")
    return records


def check_split_norms(fn, gen, record):
    """K2·S (stats, apply) and K3·S (partials, dx) against their plain
    versions on the same slabs, f32 and bf16, 'ln' and 'rms', at
    SPLIT_CASES, within K2's and K3's bounds: the sums within 1e-4 of
    max(1, |ref|), y as K2's (``within``), the partials and dx as K3's
    (``within_grad``)."""
    for shape, offset in SPLIT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for kind in ("ln", "rms"):
                C, n = shape[1], int(np.prod(shape))
                x = randn(n + offset, dtype, gen, 2.0, 0.3)[offset:] \
                    .view(shape)
                g = randn(shape, dtype, gen)
                w = randn((C,), dtype, gen, 0.2, 1.0)
                b = randn((C,), dtype, gen, 0.1)
                _, mean, rstd = fn.norm_silu_plain(x, w, b, kind)
                label = f"{list(shape)}{' +1' if offset else ''} {kind}"
                err = 0.0
                for square, center in ((False, None), (True, mean),
                                       (True, None)):
                    got = fn.norm_silu_stats(x, center, square)
                    ref = fn.norm_silu_stats_plain(x, center, square)
                    err = max(err, float(((got - ref).abs()
                                          / ref.abs().clamp(min=1)).max()))
                record("norm_silu_stats", f"{label} (sums / max(1, |ref|))",
                       dtype, err, err <= 1e-4, "1e-4")
                y = fn.norm_silu_apply(x, mean, rstd, w, b)
                err, ok = within(y, fn.norm_silu_apply_plain(
                    x, mean, rstd, w, b), dtype, 1e-4)
                record("norm_silu_apply", label, dtype, err, ok,
                       "1e-4" if dtype == torch.float32 else
                       "2e-2+2e-2|ref|")
                parts = fn.norm_silu_bwd_partials(g, x, mean, rstd, w, b)
                ref = fn.norm_silu_bwd_partials_plain(g, x, mean, rstd, w, b)
                err, ok, ratio = within_grad(parts, ref, dtype)
                record("norm_silu_bwd_partials", f"{label} (max|Δ|/max|ref| "
                       f"{ratio:.1e})", dtype, err, ok, GRAD_LIMIT)
                count = n // (shape[0] * C)
                dx = fn.norm_silu_bwd_dx(g, x, mean, rstd, w, b, *ref, count,
                                         kind)
                err, ok, ratio = within_grad(
                    [dx], [fn.norm_silu_bwd_dx_plain(g, x, mean, rstd, w, b,
                                                     *ref, count, kind)],
                    dtype)
                record("norm_silu_bwd_dx", f"{label} (max|Δ|/max|ref| "
                       f"{ratio:.1e})", dtype, err, ok, GRAD_LIMIT)


def time_split_norms(fn, gen) -> dict:
    """K2·S and K3·S timed at A's 32³ slab over 2 ranks (bf16 'ln', x
    [4, 32, 16, 32, 32]): each launch back to back and by device time,
    its plain version, its byte bound (it reads x, or g and x, and writes
    y or dx, or the [B, C] f32 sums), and for the sums the one PyTorch
    call that computes them (``torch.sum`` to f32)."""
    shape = (4, 32, 16, 32, 32)
    B, C = shape[:2]
    x, g = (randn(shape, torch.bfloat16, gen, 2.0, 0.3) for _ in range(2))
    w = randn((C,), torch.bfloat16, gen, 0.2, 1.0)
    b = randn((C,), torch.bfloat16, gen, 0.1)
    _, mean, rstd = fn.norm_silu_plain(x, w, b, "ln")
    s_gu, s_gun = fn.norm_silu_bwd_partials_plain(g, x, mean, rstd, w, b)
    n, count = x.numel(), x.numel() // (B * C)
    rows, stats = 4 * B * C, 2 * 4 * B * C
    calls = {
        "norm_silu_stats": (lambda: fn.norm_silu_stats(x),
                            lambda: fn.norm_silu_stats_plain(x),
                            lambda: torch.sum(x, dim=(2, 3, 4),
                                              dtype=torch.float32),
                            2 * n + rows, 1 * n),
        "norm_silu_apply": (lambda: fn.norm_silu_apply(x, mean, rstd, w, b),
                            lambda: fn.norm_silu_apply_plain(x, mean, rstd,
                                                             w, b),
                            None, 2 * 2 * n + stats, 8 * n),
        "norm_silu_bwd_partials": (
            lambda: fn.norm_silu_bwd_partials(g, x, mean, rstd, w, b),
            lambda: fn.norm_silu_bwd_partials_plain(g, x, mean, rstd, w, b),
            None, 2 * 2 * n + 2 * stats, 16 * n),
        "norm_silu_bwd_dx": (
            lambda: fn.norm_silu_bwd_dx(g, x, mean, rstd, w, b, s_gu, s_gun,
                                        count),
            lambda: fn.norm_silu_bwd_dx_plain(g, x, mean, rstd, w, b, s_gu,
                                              s_gun, count),
            None, 3 * 2 * n + 2 * stats + 2 * rows, 22 * n)}
    records = {}
    for name, (kernel, plain, library, nbytes, flops) in calls.items():
        bms, bby = bound(nbytes, flops, torch.float32)
        records[name] = dict(
            shape=f"{'g, ' if 'bwd' in name else ''}x {list(shape)} bf16 "
                  "'ln' (A's 32³ slab over 2 ranks)",
            ms=cuda_ms(kernel, 50),
            device_ms=device_ms(kernel, 50, (SPLIT_NORMS[name][0],)),
            plain_ms=cuda_ms(plain, 50),
            library_ms=None if library is None else cuda_ms(library, 50),
            bound_ms=bms, bound_by=bby)
    return records


# ---------------------------------------------------------------------------
# phases 2 to 4: card against CPU, end to end
# ---------------------------------------------------------------------------
def small_3d_config():
    """Configuration A's shape at a cut width and depth: 3D 32³ input,
    flash attention over the 16³ = 4096-token bottleneck, head dim 8."""
    from diffsci_tpu_torch import PUNetGConfig

    return PUNetGConfig(dimension=3, model_channels=8, channel_expansion=[2],
                        number_resnet_downward_block=1,
                        number_resnet_upward_block=1,
                        number_resnet_attn_block=2,
                        number_resnet_before_attn_block=1,
                        number_resnet_after_attn_block=1, num_heads=2,
                        attn_backend="flash")


def small_vp_config():
    """The small net under VP: its Fourier time embedding at scale 0.03 in
    place of 30, since VP's c_noise = 999·t spans [0, 999] where EDM's
    log(σ)/4 spans ~[-1.6, 1.1]; at scale 30 one float32 step of c_noise
    (the card's log against the CPU's) turns the phases by ~1e-2 rad."""
    return dataclasses.replace(small_3d_config(), time_projection_scale=0.03)


def phase_card_vs_cpu():
    from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                                   kernels)

    cfg = small_3d_config()
    cpu = KarrasModel(PUNetG(cfg, device="cpu"), KarrasModelConfig.from_edm(),
                      device="cpu")
    state = cpu.init(seed=1)
    gpu = KarrasModel(PUNetG(cfg), KarrasModelConfig.from_edm())
    gpu.net.load_state_dict(state, strict=True)
    nsteps, shape = 3, (32, 32, 32, 1)
    # the card's sample is the graphed entry point; its noise, drawn from
    # the same seed, goes to the CPU's eager loop
    noise = torch.randn((2,) + shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    t0 = time.perf_counter()
    ref = cpu.propagate_white_noise(noise.cpu(), nsteps=nsteps)
    t_cpu = time.perf_counter() - t0
    gpu.compile_sampler(2, shape, nsteps=nsteps)
    kernels.reset_launches()
    out = gpu.sample(2, shape, torch.Generator("cuda").manual_seed(0),
                     nsteps=nsteps).cpu()
    counts = dict(kernels.LAUNCHES)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    ok = bool(torch.isfinite(out).all()) and np.allclose(
        out.numpy(), ref.numpy(), rtol=1e-3, atol=1e-3)
    log(f"[card-vs-cpu] 3D 32^3 mc=8 flash (4096 tokens, head dim 8), "
        f"{nsteps} Heun steps, card graphed: max|card - cpu| {err:.3e} "
        f"(max|cpu| {scale:.3f}; tolerance rtol 1e-3 + atol 1e-3) "
        f"{'ok' if ok else 'FAIL'}; cpu {t_cpu:.1f} s; launches {counts}")
    if not ok or min(counts[k] for k in FORWARD) == 0:
        raise AssertionError("card and CPU disagree, or a kernel was not "
                             "launched")


def phase_train_card_vs_cpu(config: str = "edm"):
    """Three f32 train steps of the small 3D flash net on the CPU and on
    the card (``train_card_vs_cpu``), under the EDM configuration (phase
    3) or the VP one (phase 13: σ of the VP noise sampler, and the VP net
    of phase 11)."""
    from diffsci_tpu_torch import KarrasModel, KarrasModelConfig, PUNetG
    from diffsci_tpu_torch.ops import VPSchedulingFunctions

    net_cfg = small_vp_config() if config == "vp" else small_3d_config()
    make_config = getattr(KarrasModelConfig, f"from_{config}")

    def make_model(dev):
        return KarrasModel(PUNetG(net_cfg, device=dev), make_config(),
                           device=dev)

    def sigma_draw(rng):
        if config == "vp":
            t = rng.random(2).astype(np.float32) * (1 - 1e-5) + 1e-5
            return VPSchedulingFunctions().noise(t).astype(np.float32)
        return np.exp(rng.standard_normal(2) * 1.2 - 1.2).astype(np.float32)

    train_card_vs_cpu(f"{config} 3D 32^3 mc=8 flash", make_model,
                      (2, 32, 32, 32, 1), sigma_draw, TRAIN)


def train_card_vs_cpu(label, make_model, x_shape, sigma_draw, required,
                      y=None, has_mp_weights=False, keep=None, lr=1e-3,
                      nsteps=3, make_tx=None):
    """``nsteps`` f32 train steps of ``make_model(device)`` on the CPU
    (plain versions) and on the card (kernels, the graphed step), from the
    same weights, batch, condition ``y`` and σ/ε draws (and condition-drop
    mask ``keep``, replayed). Loss and grad_norm within rtol 1e-3 per step
    (f32 sums in another order, cuDNN's convolutions against the CPU's);
    parameters and EMA shadows: AdamW moves an entry by ±lr wherever its
    gradient is clear of rounding noise, and by up to 2·lr per step where
    rounding flips a near-zero gradient, so 99.9% of entries within
    0.05·lr and every entry within 2·k·lr after k steps; buffers (the
    batch norm's running statistics) within rtol 1e-5. The ``required``
    kernels must have been launched, K1 not. ``make_tx(lr)`` replaces
    ``default_optimizer``."""
    from diffsci_tpu_torch import (EMATracker, create_train_state,
                                   default_optimizer, kernels,
                                   make_train_step)

    rng = np.random.default_rng(1)
    x = rng.standard_normal(x_shape).astype(np.float32)
    draws = [(sigma_draw(rng), rng.standard_normal(x_shape).astype(
        np.float32)) for _ in range(nsteps)]
    weights = None
    runs = {}
    for dev in ("cpu", "cuda"):
        model = make_model(dev)
        if weights is None:
            # copies: the state dict aliases the parameters, which train
            weights = {k: v.clone() for k, v in model.init(seed=2).items()}
        else:
            model.net.load_state_dict(weights, strict=True)
        tracker = EMATracker(ema_type="power", power_function_stds=[0.05])
        state, tx = create_train_state(model, x_shape, seed=None,
                                       optimizer=(make_tx or
                                                  default_optimizer)(lr),
                                       ema=tracker)
        step = make_train_step(model, tx, ema=tracker,
                               has_mp_weights=has_mp_weights)
        yd = None if y is None else {k: v.to(dev) for k, v in y.items()}
        kernels.reset_launches()
        t0 = time.perf_counter()
        metrics = []
        for sigma, eps in draws:
            state, met = step(state, torch.from_numpy(x).to(dev), yd,
                              sigma=torch.from_numpy(sigma).to(dev),
                              eps=torch.from_numpy(eps).to(dev),
                              keep=None if keep is None else keep.to(dev))
            metrics.append((float(met["train_loss"]),
                            float(met["grad_norm"])))
        runs[dev] = (metrics, state, time.perf_counter() - t0,
                     dict(kernels.LAUNCHES), dict(model.net.named_buffers()))
    (m_cpu, s_cpu, t_cpu, _, b_cpu), (m_card, s_card, t_card, counts,
                                      b_card) = runs["cpu"], runs["cuda"]
    ok = all(np.isfinite(m).all() for m in m_card) and np.allclose(
        m_card, m_cpu, rtol=1e-3, atol=0)
    for name, ref in b_cpu.items():
        ok = ok and bool(torch.allclose(b_card[name].cpu(), ref, rtol=1e-5,
                                        atol=1e-6))
    for what, ours, ref in (("params", s_card.params, s_cpu.params),
                            ("ema", s_card.ema.profiles[0],
                             s_cpu.ema.profiles[0])):
        diff = np.concatenate([(ours[n].detach().cpu() - ref[n].detach())
                               .abs().flatten().numpy() for n in ref])
        q999, worst = float(np.quantile(diff, 0.999)), float(diff.max())
        ok = ok and q999 <= 0.05 * lr and worst <= 2 * nsteps * lr
        log(f"[train card-vs-cpu] {label} {what}: |card - cpu| 99.9% "
            f"{q999:.3e}, max {worst:.3e} (limits {0.05 * lr:.0e}, "
            f"{2 * nsteps * lr:.0e})")
    log(f"[train card-vs-cpu] {label}, {nsteps} f32 steps: "
        f"(loss, grad_norm) card {m_card} cpu {m_cpu} (rtol 1e-3) "
        f"{'ok' if ok else 'FAIL'}; buffers {sorted(b_cpu)} within rtol "
        f"1e-5; cpu {t_cpu:.1f} s, card {t_card:.1f} s; launches {counts}")
    if not ok or counts["fused_axby"] != 0 or \
            min(counts[k] for k in required) == 0:
        raise AssertionError(f"{label}: card and CPU training disagree, or "
                             "the kernels of a train step were not "
                             "launched")


def small_hfnet(device=None):
    """Configuration C's family at a cut width and depth: an HFNet with
    attention in its resampling blocks (8×8 = 64 tokens: plain attention)."""
    from diffsci_tpu_torch import HFNetUncond

    return HFNetUncond(block_channels=(32, 64), channels=3, norm_num_groups=8,
                       attn_up_and_down=True, device=device)


def agree_per_step(ours, ref):
    """max |ours - ref| and whether every step t of the two histories
    agrees within |Δ| <= 1e-3·|ref| + 1e-3·max(1, max|ref_t|): phase 2's
    rtol 1e-3 + atol 1e-3, the atol taken relative to the step's scale,
    since an untrained network's ε̂ does not match x and the DDPM/DDIM
    loops amplify x by up to ~1e4 (f32 sums in another order then differ
    by a fixed share of that scale)."""
    diff = (ours - ref).abs()
    ok = bool(torch.isfinite(ours).all())
    for d, r in zip(diff, ref):
        ok = ok and bool((d <= 1e-3 * r.abs()
                          + 1e-3 * max(1.0, float(r.abs().max()))).all())
    return float(diff.max()), ok


def phase_ddpm_card_vs_cpu():
    """The DDPM path on the CPU (plain versions) and on the card (kernels),
    from the same weights, f32 with TF32 off: 25 DDPM and 25 DDIM steps
    (the classical schedule rebuilt for T = 25; at T ≤ 20 its last β is 1
    and the loop divides by 0, as in the JAX package) through the card's
    graphed ``DDPMModel.sample``, whose noise, drawn again from the same
    seed, the CPU's loop replays; 25 forward (noising) steps from numpy x
    and noise, and loss_fn with its gradient norm. K7 and K1 counts must be
    exact."""
    from diffsci_tpu_torch import DDPMModel, DDPMModelConfig, kernels

    nsteps, x_shape = 25, (2, 16, 16, 3)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32))
    noise_seq = torch.from_numpy(rng.standard_normal(
        (nsteps,) + x_shape).astype(np.float32))
    # the graphed sampler's draws: x_T, then one noise a step
    gen = torch.Generator("cuda").manual_seed(5)
    sample_draws = [torch.randn(x_shape, device="cuda", generator=gen).cpu()
                    for _ in range(nsteps + 1)]
    t = torch.tensor([1.0, 400.0], dtype=torch.float32)
    eps = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32))
    weights = None
    failures = []
    for arm in ("from_ddpm", "from_ddim"):
        runs = {}
        for dev in ("cpu", "cuda"):
            model = DDPMModel(small_hfnet(dev),
                              getattr(DDPMModelConfig, arm)(), device=dev)
            if weights is None:
                weights = {k: v.clone() for k, v in model.init(seed=4).items()}
            model.net.load_state_dict(weights, strict=True)
            integ = model.config.integrator
            if dev == "cuda":
                model.compile_sampler(2, x_shape[1:], nsteps=nsteps)
            kernels.reset_launches()
            t0 = time.perf_counter()
            with torch.inference_mode():
                if dev == "cuda":
                    back = model.sample(
                        2, x_shape[1:], torch.Generator("cuda").manual_seed(5),
                        nsteps=nsteps, record_history=True).cpu()
                else:
                    back = integ.propagate_backward(
                        sample_draws[0], model.noise_predictor,
                        nsteps=nsteps, record_history=True,
                        noise_seq=torch.stack(sample_draws[1:]))
                fwd = integ.propagate_forward(
                    x.to(dev), nsteps=nsteps, record_history=True,
                    noise_seq=noise_seq).cpu()
            seconds = time.perf_counter() - t0
            counts = dict(kernels.LAUNCHES)
            loss = model.loss_fn(x.to(dev), t.to(dev), eps=eps.to(dev),
                                 train=False)
            loss.backward()
            norm = float(torch.sqrt(sum((p.grad.float() ** 2).sum()
                                        for p in model.net.parameters())))
            runs[dev] = (back, fwd, float(loss.detach()), norm, seconds,
                         counts)
        (b_cpu, f_cpu, l_cpu, n_cpu, s_cpu, _), \
            (b_card, f_card, l_card, n_card, s_card, counts) = \
            runs["cpu"], runs["cuda"]
        err_b, ok_b = agree_per_step(b_card, b_cpu)
        err_f, ok_f = agree_per_step(f_card, f_cpu)
        ok_l = np.allclose([l_card, n_card], [l_cpu, n_cpu], rtol=1e-3,
                           atol=0) and np.isfinite([l_card, n_card]).all()
        expected = dict.fromkeys(counts, 0)
        expected.update(fused_lincomb3=nsteps, fused_axby=nsteps)
        ok = ok_b and ok_f and ok_l and counts == expected
        log(f"[ddpm card-vs-cpu] {arm} HFNet(32, 64) 16x16x3, {nsteps} "
            f"steps: backward (card graphed) max|card - cpu| {err_b:.3e} "
            f"(max|cpu| {float(b_cpu.abs().max()):.1f}), forward "
            f"{err_f:.3e}; loss "
            f"{l_card:.6f} / {l_cpu:.6f}, grad norm {n_card:.6f} / "
            f"{n_cpu:.6f} (rtol 1e-3) {'ok' if ok else 'FAIL'}; cpu "
            f"{s_cpu:.1f} s, card {s_card:.1f} s; launches {counts}")
        if not ok:
            failures.append(arm)
    if failures:
        raise AssertionError(f"DDPM card and CPU disagree, or the launch "
                             f"counts are not K7 = K1 = {nsteps}: {failures}")


# ---------------------------------------------------------------------------
# phases 5 to 9: serving and training at full width
# ---------------------------------------------------------------------------
def graph_pool_bytes() -> int | None:
    """Bytes of the device segments that belong to CUDA graphs' private
    memory pools (None where the allocator's snapshot does not say)."""
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" not in segments[0]:
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) != (0, 0))


def mib(nbytes) -> str:
    return "not measured" if nbytes is None else f"{nbytes / 2 ** 20:.1f} MiB"


def serve(label, model, shape, buckets, requests, same_seed_n, nsteps,
          sample_kwargs=None):
    """Drive one model (bf16 compute, random weights from seed 0) through
    SamplerService: warm-up (one eager run and one graph capture per
    bucket: the whole loop for EDM, one step for DDPM/DDIM), then, with
    the launch counts reset, the timed ``requests`` and (when
    ``same_seed_n``) one request of ``same_seed_n`` twice from one seed.
    ``sample_kwargs`` go to the service (the integrator, ``stochastic``).
    Returns the launch counts, the number of bucket runs (graph replays
    of a whole sample) and the service."""
    from diffsci_tpu_torch import SamplerService, kernels

    model.init(seed=0)
    nparams = sum(p.numel() for p in model.net.parameters())
    svc = SamplerService(model, shape, batch_buckets=buckets, nsteps=nsteps,
                         seed=0, sample_kwargs=sample_kwargs)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool0 = graph_pool_bytes()
    warm = svc.warmup()
    pool = None if pool0 is None else graph_pool_bytes() - pool0
    captures = {key[0]: round(g.capture_seconds, 3)
                for key, g in model._graphs.graphs.items()}
    log(f"[{label}] {nparams} parameters, {nsteps} steps; warm-up (eager "
        f"run and capture) seconds per bucket "
        f"{ {b: round(s, 3) for b, s in warm.items()} }, of which capture "
        f"{captures}; graph pool {mib(pool)}")
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    runs = 0
    for n in requests:
        t0 = time.perf_counter()
        out = svc.sample(n)
        dt = time.perf_counter() - t0
        nchunks = -(-n // buckets[-1])
        runs += nchunks
        if out.shape != (n,) + tuple(shape) or not np.isfinite(out).all():
            raise AssertionError(f"{label}: request of {n} gave shape "
                                 f"{out.shape} or non-finite values")
        log(f"[{label}] request {n}: {dt:.4f} s, {n / dt:.2f} samples/s, "
            f"{nchunks} chunk(s), std {out.std():.4f}")
    if same_seed_n:
        seeded = []
        for _ in range(2):
            t0 = time.perf_counter()
            seeded.append(svc.sample(same_seed_n, generator=1234))
            dt = time.perf_counter() - t0
            log(f"[{label}] seeded request {same_seed_n}: {dt:.4f} s, "
                f"{same_seed_n / dt:.2f} samples/s")
        runs += 2 * -(-same_seed_n // buckets[-1])
        if not np.array_equal(*seeded):
            raise AssertionError(f"{label}: one seed gave two different "
                                 "sets of samples")
        log(f"[{label}] same seed, same samples: ok")
    counts = dict(kernels.LAUNCHES)
    log(f"[{label}] stats {svc.stats}; throughput {svc.throughput():.2f} "
        f"samples/s; peak memory over the requests "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; launches "
        f"{counts}")
    return counts, runs, svc


def karras(cfg):
    from diffsci_tpu_torch import KarrasModel, KarrasModelConfig, PUNetG

    return KarrasModel(PUNetG(cfg), KarrasModelConfig.from_edm(),
                       compute_dtype=torch.bfloat16)


def ddpm_c(arm):
    """Configuration C: the DDPM CIFAR-10 UNet's widths in HFNet's attention
    pattern, 32×32×3, bf16 over f32 masters."""
    from diffsci_tpu_torch import DDPMModel, DDPMModelConfig, HFNetUncond

    return DDPMModel(HFNetUncond(block_channels=(128, 256, 256, 256),
                                 channels=3, attn_up_and_down=True),
                     getattr(DDPMModelConfig, arm)(),
                     compute_dtype=torch.bfloat16)


def train(label, cfg, x_shape, steps, per_step, warmup=3, config="edm",
          profiled=False, model=None, y=None, has_mp_weights=False,
          x=None, optimizer=None, keep=None):
    """Train one configuration at full width: bf16 compute over f32 masters,
    AdamW with clip 0.5, power EMA every 4 steps, on one fixed batch.
    ``warmup`` steps, then ``steps`` timed with the host clock and a sync
    on the loss, the launch counts reset just before and read just after
    (they must be ``per_step`` times ``steps``). A fixed draw of σ and ε
    probes the loss before training and after it: it must go down.
    ``config``: the KarrasModelConfig preset ("edm", "vp", "ve");
    ``profiled``: one more step under torch.profiler (device time).
    ``model`` (a bf16 KarrasModel) replaces the one built from ``cfg`` and
    ``config``; ``x`` (default: N(0, 1) from the step's generator) and
    ``y`` are the batch and its condition; ``has_mp_weights`` goes to the
    step; ``optimizer`` replaces AdamW (clip 0.5); ``keep``, a dict,
    receives the train state. Returns the launch counts, the model and the
    milliseconds a timed step took."""
    from diffsci_tpu_torch import (EMATracker, KarrasModel, KarrasModelConfig,
                                   PUNetG, create_train_state, kernels,
                                   make_train_step)

    if model is None:
        model = KarrasModel(PUNetG(cfg),
                            getattr(KarrasModelConfig, f"from_{config}")(),
                            compute_dtype=torch.bfloat16)
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05],
                         update_every=4)
    state, tx = create_train_state(model, x_shape, seed=0, ema=tracker,
                                   optimizer=optimizer)
    if keep is not None:
        keep["state"] = state
    step = make_train_step(model, tx, ema=tracker,
                           has_mp_weights=has_mp_weights)
    nparams = sum(p.numel() for p in state.params.values())
    gen = torch.Generator("cuda").manual_seed(0)
    if x is None:
        x = torch.randn(x_shape, generator=gen, device="cuda")
    probe_sigma = model.config.noisesampler.sample((x_shape[0],), gen)
    # a latent model's ε has the latent shape, and it draws its posterior
    lat = model.latent_shape(x_shape) if getattr(model, "latent_model",
                                                 False) else x_shape
    probe_eps = torch.randn(lat, generator=gen, device="cuda")
    probe_z = torch.randn(lat, generator=gen, device="cuda") \
        if getattr(model, "latent_model", False) else None

    def probe():
        with torch.no_grad():
            if probe_z is not None:
                return float(model.loss_fn(x, probe_sigma, y, eps=probe_eps,
                                           train=False, z_eps=probe_z))
            return float(model.loss_fn(x, probe_sigma, y, eps=probe_eps,
                                       train=False))

    def one_step():
        return step(state, x, y, generator=gen)[1]

    before = probe()
    for _ in range(warmup):
        one_step()
    torch.cuda.synchronize()
    captures = [round(g.capture_seconds, 3)
                for g in state.graphs.graphs.values()]
    log(f"[train {label}] capture seconds (step, EMA update) {captures}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        met = one_step()
        losses.append(met["train_loss"])
    last = float(met["train_loss"])            # the sync
    dt = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = probe()
    losses = [float(v) for v in losses]
    norm = float(met["grad_norm"])
    log(f"[train {label}] {nparams} parameters, batch {x_shape}: {steps} "
        f"steps in {dt:.4f} s, {dt / steps * 1e3:.2f} ms/step, "
        f"{x_shape[0] * steps / dt:.2f} items/s; peak memory {peak:.3f} GiB")
    log(f"[train {label}] loss first {losses[0]:.5f} last {last:.5f}, "
        f"grad_norm {norm:.4f}; fixed-draw loss {before:.5f} before "
        f"training, {after:.5f} after; launches {counts}")
    expected = {k: n * steps for k, n in per_step.items()}
    if not (np.isfinite(losses).all() and np.isfinite(norm)
            and after < before):
        raise AssertionError(f"{label}: training gave a non-finite loss or "
                             "grad_norm, or the loss did not go down")
    if counts != expected:
        raise AssertionError(f"{label}: launch counts {counts}, expected "
                             f"{expected}")
    if profiled:
        profile_call(f"train {label}", "one train step", one_step)
    return counts, model, dt / steps * 1e3


# ---------------------------------------------------------------------------
# phase 10: eager against graphed, in one process
# ---------------------------------------------------------------------------
def walls(fn, reps: int = 3) -> list[float]:
    """Host seconds of ``reps`` calls of ``fn``, each ended by a sync."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def fmt(seconds: list[float]) -> str:
    return "median " + f"{float(np.median(seconds)):.4f} s of " + \
        ", ".join(f"{v:.4f}" for v in seconds)


def graphs_vs_eager_requests(label, svc, n, eager, within):
    """One request of ``n`` through the service (graph replays) twice
    from one seed, against ``eager(noise_generator)`` (the loop's inner
    methods) from the same seed: same bits twice, ``within(graph, eager)``
    holds, and both timed. Returns (graphed, eager) callables."""
    graph = svc.sample(n, generator=99)
    if not np.array_equal(graph, svc.sample(n, generator=99)):
        raise AssertionError(f"{label}: one seed gave two graphed results")
    ref = eager(torch.Generator("cuda").manual_seed(99)).cpu().numpy()
    err, ok = within(torch.from_numpy(graph), torch.from_numpy(ref))
    same = np.array_equal(graph, ref)
    log(f"[graphs {label}] request {n}: graphed against eager max|Δ| "
        f"{err:.3e} ({'bit-identical' if same else 'not bit-identical'}) "
        f"{'ok' if ok else 'FAIL'}; same seed, same bits: ok")
    if not ok:
        raise AssertionError(f"{label}: graphed and eager requests disagree")

    def graphed():
        return svc.sample(n)

    def eager_call():
        return eager(svc._generator).cpu()

    log(f"[graphs {label}] request {n} wall: eager "
        f"{fmt(walls(eager_call))}; graphed {fmt(walls(graphed))}")
    return graphed, eager_call


def within_phase2(out, ref):
    err = float((out - ref).abs().max())
    return err, bool(torch.isfinite(out).all()) and bool(
        torch.allclose(out, ref, rtol=1e-3, atol=1e-3))


def within_float64(card, ref, ref64):
    """The card's float32 result against the CPU's loop with the net in
    float64 (phase 11's form of phase 2's tolerance, for ill-conditioned
    loops): within 1e-3·|ref64| plus the larger of 1e-3 of the state's
    scale and 4× the CPU float32 loop's own distance from ref64. Returns
    (max|card − ref64|, max|ref − ref64|, ok)."""
    ref64 = ref64.float()
    err = float((card - ref64).abs().max())
    own = float((ref - ref64).abs().max())
    scale = max(1.0, float(ref64.abs().max()))
    ok = bool(torch.isfinite(card).all()) and bool(
        ((card - ref64).abs() <= 1e-3 * ref64.abs()
         + max(1e-3 * scale, 4 * own)).all())
    return err, own, ok


def within_phase4(out, ref):
    return agree_per_step(out[None], ref[None])


def train_arms(label, cfg, x_shape, lr=1e-3, steps=3, timed=20, remat=False):
    """Eager (``_raw``) and graphed train steps of one configuration
    (bf16 over f32 masters, AdamW, power EMA every 4 steps), each from
    seed 0 with the same draws: ``steps`` steps held to phase 3's
    tolerances (loss and grad_norm rtol 1e-3; parameters and EMA 99.9 %
    within 0.05·lr, every entry within 2·k·lr), then ``timed`` steps on
    the host clock. With ``remat`` a third arm, graphed under remat, is
    held to the graphed one the same way. Peak memory over the first
    ``steps`` (the eager warm-up and the capture) above the memory the
    arm started from, and the graph pool.
    Returns the arms by name (step, state, model, tx, tracker, take: one
    step on the fixed batch)."""
    from diffsci_tpu_torch import (EMATracker, KarrasModel, KarrasModelConfig,
                                   PUNetG, create_train_state,
                                   make_train_step)

    x = torch.randn(x_shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    arms = {}
    for arm in ("eager", "graphed") + (("graphed remat",) if remat else ()):
        model = KarrasModel(PUNetG(cfg), KarrasModelConfig.from_edm(),
                            compute_dtype=torch.bfloat16)
        tracker = EMATracker(ema_type="power", power_function_stds=[0.05],
                             update_every=4)
        state, tx = create_train_state(model, x_shape, seed=0, ema=tracker)
        step = make_train_step(model, tx, ema=tracker,
                               remat=arm.endswith("remat"),
                               _raw=arm == "eager")
        gen = torch.Generator("cuda").manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start, pool0 = torch.cuda.memory_allocated(), graph_pool_bytes()
        metrics = [step(state, x, generator=gen)[1] for _ in range(steps)]
        metrics = [(float(m["train_loss"]), float(m["grad_norm"]))
                   for m in metrics]
        peak = torch.cuda.max_memory_allocated() - start
        pool = None if pool0 is None else graph_pool_bytes() - pool0
        snap = ({k: v.detach().clone() for k, v in state.params.items()},
                {k: v.clone() for k, v in state.ema.profiles[0].items()})

        def take(step=step, state=state, gen=gen):
            return step(state, x, generator=gen)[1]["train_loss"]

        seconds = walls(take, timed)
        arms[arm] = types.SimpleNamespace(
            metrics=metrics, snap=snap, step=step, state=state, model=model,
            tx=tx, tracker=tracker, take=take)
        log(f"[graphs train {label}] {arm}: {timed} steps, "
            f"{float(np.median(seconds)) * 1e3:.2f} ms/step median "
            f"(min {min(seconds) * 1e3:.2f}); peak memory over the first "
            f"{steps} steps {mib(peak)} above the arm's start (weights, "
            f"AdamW's moments, gradients, activations), graph pool "
            f"{mib(pool)}")
    for arm, ref in (("graphed", "eager"), ("graphed remat", "graphed")):
        if arm not in arms:
            continue
        out, base = arms[arm], arms[ref]
        ok = np.allclose(out.metrics, base.metrics, rtol=1e-3, atol=0) and \
            np.isfinite(out.metrics).all()
        same = out.metrics == base.metrics
        for ours, theirs in zip(out.snap, base.snap):
            diff = torch.cat([(ours[n] - theirs[n]).abs().flatten()
                              for n in theirs]).cpu().numpy()
            ok = ok and float(np.quantile(diff, 0.999)) <= 0.05 * lr and \
                float(diff.max()) <= 2 * steps * lr
            same = same and float(diff.max()) == 0.0
        log(f"[graphs train {label}] {arm} against {ref}, {steps} steps: "
            f"(loss, grad_norm) {out.metrics} / {base.metrics} "
            f"({'bit-identical' if same else 'not bit-identical'}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: {arm} and {ref} train steps "
                                 "disagree")
    return arms


def sample_follows_training(label, arm, shape, nsteps=4):
    """The graphed sampler over a bf16 model whose graphed train steps
    update its masters: sample, replay one more train step, sample again
    from one seed. The second sample must differ from the first and hold
    to phase 2's tolerance against the eager loop run from a cast copy
    built anew from the current masters."""
    model = arm.model

    def graphed():
        return model.sample(1, shape, torch.Generator("cuda").manual_seed(5),
                            nsteps=nsteps)

    first = graphed()
    arm.take()
    second = graphed()
    noise = torch.randn((1,) + tuple(shape), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
    model._reset_cast()              # the next use builds the copy anew
    ref = model.propagate_white_noise(noise, nsteps=nsteps)
    err, ok = within_phase2(second, ref)
    moved = not torch.equal(first, second)
    log(f"[graphs {label}] sample after a replayed train step: moved "
        f"{moved}; against the eager loop on a new cast copy max|Δ| "
        f"{err:.3e} {'ok' if ok and moved else 'FAIL'}")
    if not (ok and moved):
        raise AssertionError(f"{label}: the graphed sampler did not follow "
                             "the replayed train steps")


def phase_graphs(svc_a, svc_b, svc_ddim, cfg_a, cfg_b, profile: bool):
    """Each path eager (the inner methods, ``_raw``) and graphed (the entry
    points) in one process: agreement at phases 2, 3 and 4's tolerances,
    same seed same bits for the graphed requests, walls; A's train step
    under remat; make_train_scan at K = 8 against 8 graphed steps. With
    ``profile``, one profiled call of each arm."""
    from diffsci_tpu_torch import make_train_scan

    def edm(svc, n):
        def eager(gen):
            noise = torch.randn((n,) + svc.shape, device="cuda",
                                generator=gen)
            return svc.model.propagate_white_noise(noise, nsteps=svc.nsteps)
        return eager

    def ddim(gen):
        model = svc_ddim.model
        x = torch.randn((16,) + svc_ddim.shape, device="cuda", generator=gen)
        with torch.inference_mode():
            return model.config.integrator.propagate_backward(
                x, model.noise_predictor, svc_ddim.nsteps, generator=gen)

    calls = {
        "config A": graphs_vs_eager_requests("config A", svc_a, 4,
                                             edm(svc_a, 4), within_phase2),
        "config B": graphs_vs_eager_requests("config B", svc_b, 64,
                                             edm(svc_b, 64), within_phase2),
        "config C DDIM": graphs_vs_eager_requests(
            "config C DDIM", svc_ddim, 16, ddim, within_phase4)}
    x_a = (4, 32, 32, 32, 1)
    train_a = train_arms("config A", cfg_a, x_a, remat=True)
    train_b = train_arms("config B", cfg_b, (256, 28, 28, 1))

    # K = 8 steps a call against 8 calls of the graphed step, on A's
    # graphed state (the scan replays the graph the state holds)
    arm = train_a["graphed"]
    scan = make_train_scan(arm.model, arm.tx, ema=arm.tracker)
    gen = torch.Generator("cuda").manual_seed(3)
    xs = torch.randn((8,) + x_a, device="cuda", generator=gen)
    ngraphs = len(arm.state.graphs.graphs)
    scan(arm.state, xs, generator=gen)
    if len(arm.state.graphs.graphs) != ngraphs:
        raise AssertionError("config A: make_train_scan captured a second "
                             "graph of the state's step")

    def scan8():
        return scan(arm.state, xs, generator=gen)[1]["train_loss"]

    def steps8():
        return [arm.step(arm.state, x, generator=gen) for x in xs]

    log(f"[graphs train config A] make_train_scan K = 8: {fmt(walls(scan8))}"
        f"; 8 graphed steps: {fmt(walls(steps8))}")
    sample_follows_training("config A", arm, x_a[1:])
    if profile:
        for label, (graphed, eager) in calls.items():
            profile_call(label, "request, eager", eager)
            profile_call(label, "request, graphed", graphed)
        for label, arms in (("train config A", train_a),
                            ("train config B", train_b)):
            for name, arm in arms.items():
                profile_call(label, f"one train step, {name}", arm.take)


def profile_call(label, what, fn, top=8):
    """One call of ``fn`` under torch.profiler, after one call to warm up:
    wall time, summed device kernel time, idle share and the heaviest
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # a range annotated on the device (the optimizer's step) spans kernels
    # that are counted on their own
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(device_us(e) for e in kernels) / 1e6
    # launches the host made: kernels one at a time, graphs whole
    host = sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and e.key in HOST_LAUNCHES)
    log(f"[profile {label}] {what}: wall {wall:.4f} s, device kernels "
        f"{busy:.4f} s, idle share {1 - busy / wall:.3f}, "
        f"{sum(e.count for e in kernels)} kernel launches, {host} host "
        f"launch calls")
    # the heaviest kernels, and the port's own kernels wherever they rank
    for rank, e in enumerate(sorted(kernels, key=device_us, reverse=True)):
        if rank < top or any(n in e.key for n in PORT_KERNELS):
            log(f"[profile {label}] {rank + 1:3d} {device_us(e) / 1e3:9.3f}"
                f" ms {device_us(e) / 1e6 / busy:6.1%} x{e.count:<6} "
                f"{e.key[:90]}")
    # K2 and K3 over all their launch shapes
    for kernel, names in NORM_KERNELS.items():
        mine = [e for e in kernels if any(n in e.key for n in names)]
        if mine:
            us = sum(device_us(e) for e in mine)
            log(f"[profile {label}] {kernel} sum {us / 1e3:.3f} ms "
                f"{us / 1e6 / busy:6.1%} x{sum(e.count for e in mine)}")


# ---------------------------------------------------------------------------
# phases 11 to 13: stochastic samplers, VP and VE
# ---------------------------------------------------------------------------
def replayed_draws(n_noise, x_shape, seed):
    """sample()'s draws from a card generator of ``seed``: x_T, then the
    [n_noise, *x_shape] noise of the loop (None when n_noise is 0)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(x_shape, device="cuda", generator=gen)
    noise = torch.randn((n_noise,) + tuple(x_shape), device="cuda",
                        generator=gen) if n_noise else None
    return x, noise


def phase_stochastic_card_vs_cpu():
    """Each new sampling path on the card (the graphed entry point where
    there is one: ``sample``, ``sample_restart``; ``inpaint`` and
    ``repaint`` run eagerly on the card, as in the JAX package) and on the
    CPU (eager, plain versions), from the same weights and the card's
    draws replayed, f32 with TF32 off: EDM churn, Euler–Maruyama, EM with
    the Langevin gate (langevin_interval (0.1, 10), langevin_const 3, a
    langevin_scale of 0.5), DPM++2M and restart; VP and VE under Heun and
    EM; inpaint and RePaint. EDM arms agree at phase 2's rtol 1e-3 + atol
    1e-3. An untrained net drives the VP and VE trajectories to 1e2–1e8
    in three steps, where VE's Heun loop is ill-conditioned: on the CPU
    its float32 result lay ~1e-2 of its scale from the same loop with the
    net in float64 (the plain kernels in float32) and the card's ~7e-4, on
    an H100 host (PERF.md). So the VP and VE arms hold the card to that
    float64 loop, within 1e-3·|ref| plus the larger of 1e-3 of the state's
    scale (phase 4's form of phase 2's tolerance) and 4× the CPU float32
    loop's own distance from it. Returns the card's launch counts."""
    from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                                   kernels, ops)

    torch.backends.cudnn.allow_tf32 = False

    def gated():
        cfg = KarrasModelConfig.from_edm()
        cfg.noisescheduler = ops.EDMScheduler(langevin_const=3.0,
                                              langevin_interval=(0.1, 10.0))
        return cfg

    shape, nsteps = (32, 32, 32, 1), 3
    x_shape = (2,) + shape
    arms = (("EDM churn", KarrasModelConfig.from_edm, {"integrator": "karras"}),
            ("EDM EM", KarrasModelConfig.from_edm, {"stochastic": True}),
            ("EDM EM gated", gated, {"stochastic": True,
                                     "langevin_scale": 0.5}),
            ("EDM DPM++2M", KarrasModelConfig.from_edm,
             {"integrator": "dpmpp2m"}),
            ("VP Heun", KarrasModelConfig.from_vp, {}),
            ("VP EM", KarrasModelConfig.from_vp, {"stochastic": True}),
            ("VE Heun", KarrasModelConfig.from_ve, {}),
            ("VE EM", KarrasModelConfig.from_ve, {"stochastic": True}))
    weights, models = {}, {}

    def pair(make_config, vp):
        """CPU and card models of one configuration on the same weights."""
        net_cfg = small_vp_config() if vp else small_3d_config()
        out = []
        for dev in ("cpu", "cuda"):
            model = KarrasModel(PUNetG(net_cfg, device=dev), make_config(),
                                device=dev)
            if vp not in weights:
                weights[vp] = {k: v.clone()
                               for k, v in model.init(seed=1).items()}
            model.net.load_state_dict(weights[vp], strict=True)
            out.append(model)
        return out

    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    failures = []

    def check(label, card, ref, seconds, ref64=None):
        card = card.cpu()
        if ref64 is None:
            err, ok = within_phase2(card, ref)
            extra = ""
        else:
            err, own, ok = within_float64(card, ref, ref64)
            extra = (f"; against the float64 loop: card {err:.3e}, cpu "
                     f"float32 {own:.3e}")
            err = float((card - ref).abs().max())
        log(f"[stochastic card-vs-cpu] {label}: max|card - cpu| {err:.3e} "
            f"(max|cpu| {float(ref.abs().max()):.4g}){extra} "
            f"{'ok' if ok else 'FAIL'}; card {seconds:.3f} s")
        if not ok:
            failures.append(label)

    for label, make_config, kw in arms:
        cpu, card = pair(make_config, label.startswith("VP"))
        ls = kw.get("langevin_scale")
        n = cpu.config.noisescheduler.noise_steps(
            nsteps, kw.get("stochastic", False), kw.get("integrator"))
        card.compile_sampler(2, shape, nsteps=nsteps, **kw)
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        out = card.sample(2, shape, torch.Generator("cuda").manual_seed(11),
                          nsteps=nsteps, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for k, v in kernels.LAUNCHES.items():
            counts[k] += v - before[k]
        x, noise = replayed_draws(n, x_shape, 11)

        def cpu_loop(dtype):
            with torch.inference_mode():
                return cpu._propagate_white_noise(
                    x.cpu().to(dtype), None, 1.0, nsteps, False,
                    kw.get("integrator"), kw.get("stochastic", False),
                    gate_scale=None if ls is None else torch.tensor(ls),
                    noise_seq=None if noise is None else
                    noise.cpu().to(dtype))

        ref, ref64 = cpu_loop(torch.float32), None
        if not label.startswith("EDM"):
            cpu.net.double()
            ref64 = cpu_loop(torch.float64)
        check(label, out, ref, seconds, ref64)
        if label == "EDM churn":
            models["EDM"] = (cpu, card)

    cpu, card = models["EDM"]
    sched = cpu.config.noisescheduler
    restarts = ((0.3, 2.0, 1),)
    card.sample_restart(2, shape, torch.Generator("cuda").manual_seed(12),
                        nsteps=6, restarts=restarts)
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    out = card.sample_restart(2, shape,
                              torch.Generator("cuda").manual_seed(12),
                              nsteps=6, restarts=restarts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for k, v in kernels.LAUNCHES.items():
        counts[k] += v - before[k]
    x, noises = replayed_draws(sched.restart_jumps(restarts), x_shape, 12)
    x = x.cpu()
    with torch.inference_mode():
        ref = sched._restart(x * sched.maximum_scale,
                             cpu._score(None, 1.0, x), 6, restarts, None,
                             noises.cpu())
    check("EDM restart ((0.3, 2.0, 1),), 6 steps", out, ref, seconds)

    rng = np.random.default_rng(13)
    x_orig = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32))
    mask = torch.from_numpy((rng.random(shape) < 0.5).astype(np.float32))
    for mode in ("inpaint", "repaint"):
        steps, rsteps, nres = 4, 2, 1
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        out = card.inpaint(x_orig.cuda(), mask.cuda(), nsteps=steps,
                           mode=mode, rsteps=rsteps, nresamples=nres,
                           generator=torch.Generator("cuda").manual_seed(14))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for k, v in kernels.LAUNCHES.items():
            counts[k] += v - before[k]
        n_ren = nres * (steps // rsteps - 1) if mode == "repaint" else 0
        x_t, draws = replayed_draws(steps - 1 + n_ren, x_shape, 14)
        x_t, draws = x_t.cpu(), draws.cpu()
        score = cpu._score(None, 1.0, x_orig)
        with torch.inference_mode():
            y_noised = sched.propagate_forward(
                x_orig, score, steps, record_history=True, stochastic=True,
                noise_seq=draws[:steps - 1]).flip(0)
            start = x_t * sched.maximum_scale
            if mode == "inpaint":
                ref = sched.inpaint(start, y_noised, mask, score, steps)
            else:
                ref = sched.repaint(start, y_noised, mask, score, steps,
                                    rsteps, nres,
                                    renoise_noises=draws[steps - 1:])
        check(f"EDM {mode}, {steps} steps (eager on the card)", out, ref,
              seconds)
    torch.backends.cudnn.allow_tf32 = True
    log(f"[stochastic card-vs-cpu] card launches {counts}")
    if failures or min(counts[k] for k in FORWARD) == 0:
        raise AssertionError(f"stochastic paths: card and CPU disagree "
                             f"({failures}), or a kernel was not launched")
    return counts


def restart_nfe(sched, nsteps, restarts):
    """Network calls of one restart sample: the Heun grid's 2·nsteps - 1,
    plus two a step for each of an interval's K passes over its snapped
    width."""
    sigma = np.asarray(sched.scheduling.noise(sched.create_steps(
        nsteps + 1)[:-1]), np.float64)
    nfe = 2 * nsteps - 1
    for lo, hi, k in restarts:
        width = int(np.argmin(np.abs(sigma - lo))) - int(
            np.argmin(np.abs(sigma - hi)))
        nfe += 2 * k * width
    return nfe


def phase_stochastic_serving(cfg_a, cfg_b, zero):
    """Full-width stochastic serving through SamplerService(sample_kwargs=)
    (bf16, random weights from seed 0, 18 steps): B with churn (35 network
    calls a sample), Euler–Maruyama and DPM++2M (18 each), A with EM;
    exact launch counts per bucket run (K1 once a call, K2 28 (B) or 20
    (A), K4 once (A)), one profiled request per arm; a γ sweep of
    langevin_scale on B's bucket 8 that replays one graph and matches the
    eager loop at each γ; and B's restart sample with ((0.05, 2.0, 2),),
    its network calls counted from the snapped grid. Returns the launch
    counts of every arm."""
    from diffsci_tpu_torch import kernels

    b_shape, a_shape = (28, 28, 1), (32, 32, 32, 1)
    arms = (("config B churn", cfg_b, b_shape, (1, 8, 64), (1, 64, 70), 8,
             {"integrator": "karras"}, NFE),
            ("config B EM", cfg_b, b_shape, (1, 8, 64), (1, 64, 70), 8,
             {"stochastic": True}, NSTEPS),
            ("config B DPM++2M", cfg_b, b_shape, (8, 64), (8, 64), 8,
             {"integrator": "dpmpp2m"}, NSTEPS),
            ("config A EM", cfg_a, a_shape, (1, 4), (1, 4, 6), 4,
             {"stochastic": True}, NSTEPS))
    all_counts, services = [], {}
    for label, cfg, shape, buckets, requests, same, kw, nfe in arms:
        counts, runs, svc = serve(label, karras(cfg), shape, buckets,
                                  requests, same, NSTEPS, sample_kwargs=kw)
        a = cfg is cfg_a
        expected = dict(zero, fused_axby=nfe * runs,
                        norm_silu=(20 if a else 28) * nfe * runs,
                        flash_attention=nfe * runs if a else 0)
        if counts != expected:
            raise AssertionError(f"{label}: launch counts {counts}, "
                                 f"expected {expected}")
        log(f"[counts] {label}: {nfe} network calls a sample, {runs} bucket "
            f"runs: {counts}")
        b = buckets[-1]
        profile_call(label, f"request {b}", lambda svc=svc, b=b: svc.sample(b))
        all_counts.append(counts)
        services[label] = svc

    # the γ sweep: one graph of B's EM loop at bucket 8 with a runtime
    # langevin_scale
    model = services["config B EM"].model
    model.compile_sampler(8, b_shape, nsteps=NSTEPS, stochastic=True,
                          langevin_scale=1.0)
    ngraphs = len(model._graphs.graphs)
    for gamma in (0.25, 1.0, 2.5):
        t0 = time.perf_counter()
        out = model.sample(8, b_shape, torch.Generator("cuda").manual_seed(21),
                           nsteps=NSTEPS, stochastic=True,
                           langevin_scale=gamma)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        x, noise = replayed_draws(NSTEPS, (8,) + b_shape, 21)
        with torch.inference_mode():
            ref = model._propagate_white_noise(
                x, None, 1.0, NSTEPS, False, None, True,
                gate_scale=torch.tensor(gamma, device="cuda"),
                noise_seq=noise)
        err, ok = within_phase2(out, ref)
        same = bool(torch.equal(out, ref))
        log(f"[gamma sweep] config B bucket 8, langevin_scale {gamma}: "
            f"graphed against eager max|Δ| {err:.3e} "
            f"({'bit-identical' if same else 'not bit-identical'}), "
            f"{len(model._graphs.graphs)} graphs in the cache; {seconds:.4f} s "
            f"{'ok' if ok else 'FAIL'}")
        if not ok or len(model._graphs.graphs) != ngraphs:
            raise AssertionError("gamma sweep: a new graph was captured or "
                                 "the graphed loop disagrees with the eager "
                                 "one")

    # restart sampling, one graph of B's bucket 8
    model = services["config B churn"].model
    restarts = ((0.05, 2.0, 2),)
    nfe = restart_nfe(model.config.noisescheduler, NSTEPS, restarts)
    t0 = time.perf_counter()
    model.sample_restart(8, b_shape, torch.Generator("cuda").manual_seed(22),
                         nsteps=NSTEPS, restarts=restarts)
    torch.cuda.synchronize()
    log(f"[config B restart] warm-up and capture {time.perf_counter() - t0:.3f}"
        f" s")
    kernels.reset_launches()
    outs = []
    for _ in range(2):
        t0 = time.perf_counter()
        outs.append(model.sample_restart(
            8, b_shape, torch.Generator("cuda").manual_seed(22),
            nsteps=NSTEPS, restarts=restarts))
        torch.cuda.synchronize()
        log(f"[config B restart] request 8: {time.perf_counter() - t0:.4f} s")
    counts = dict(kernels.LAUNCHES)
    expected = dict(zero, fused_axby=2 * nfe, norm_silu=2 * 28 * nfe)
    ok = counts == expected and torch.equal(*outs) and bool(
        torch.isfinite(outs[0]).all())
    log(f"[config B restart] {restarts}: {nfe} network calls a sample; same "
        f"seed, same bits {torch.equal(*outs)}; launches {counts} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"restart: counts {counts}, expected {expected}, "
                             "or two results from one seed")
    profile_call("config B restart", "request 8", lambda: model.sample_restart(
        8, b_shape, torch.Generator("cuda").manual_seed(22), nsteps=NSTEPS,
        restarts=restarts))
    all_counts.append(counts)
    return all_counts


def phase_train_vp_ve(cfg_a, cfg_b, zero):
    """Training under VP and VE at full width, graphed: B under from_vp
    (batch 256), A under from_ve (batch 4), 20 timed steps each with exact
    launch counts and one profiled step; then three f32 VP steps of the
    small net, card against CPU (phase 3's tolerances). Returns the launch
    counts."""
    counts_b, _, _ = train("config B VP", cfg_b, (256, 28, 28, 1), 20,
                        dict(zero, norm_silu=28, norm_silu_bwd=28),
                        config="vp", profiled=True)
    counts_a, _, _ = train("config A VE", cfg_a, (4, 32, 32, 32, 1), 20,
                        dict(zero, norm_silu=20, norm_silu_bwd=20,
                             flash_attention=1, flash_attention_dq=1,
                             flash_attention_dkv=1),
                        config="ve", profiled=True)
    torch.backends.cudnn.allow_tf32 = False
    phase_train_card_vs_cpu("vp")
    torch.backends.cudnn.allow_tf32 = True
    return [counts_b, counts_a]


# ---------------------------------------------------------------------------
# phases 14 to 16: the conditional (D) and magnitude-preserving (E) paths
# ---------------------------------------------------------------------------
GUIDANCE = (2.0, 0.3, 5.0)     # D's IntervalGuidance(scale, σ_lo, σ_hi)


def model_d(cfg, device=None, dtype=torch.bfloat16):
    """Configuration D's runtime: a porosity-conditioned PUNetG under EDM
    with the EDM batch norm, classifier-free guidance by IntervalGuidance
    at serving."""
    from diffsci_tpu_torch import KarrasModel, KarrasModelConfig, PUNetG
    from diffsci_tpu_torch.models.nets import PorosityEmbedder

    return KarrasModel(
        PUNetG(cfg, conditional_embedding=PorosityEmbedder(
            cfg.model_channels), device=device),
        KarrasModelConfig.from_edm(has_edm_batch_norm=True),
        conditional=True, compute_dtype=dtype, device=device)


def model_e(cfg, device=None, dtype=torch.bfloat16, dlw=128):
    """Configuration E's runtime: a magnitude-preserving PUNetG (mp
    convolutions and time MLPs, cosine attention) under EDM with the
    dynamic loss weight."""
    from diffsci_tpu_torch import KarrasModel, KarrasModelConfig, PUNetG

    return KarrasModel(PUNetG(cfg, device=device),
                       KarrasModelConfig.from_edm(dynamic_loss_weight=dlw),
                       compute_dtype=dtype, device=device)


def guided_eager(svc, n):
    """The eager body of a service's request: x_T from the generator, the
    loop's inner methods on the request's condition (on the card), then
    decode (the batch norm's inverse)."""
    from diffsci_tpu_torch.utils import dict_map

    def eager(gen):
        kw = dict(svc.sample_kwargs)
        kw["y"] = dict_map(lambda v: v.cuda(), kw.get("y"))
        noise = torch.randn((n,) + svc.shape, device="cuda", generator=gen)
        with torch.inference_mode():
            return svc.model.decode(svc.model.propagate_white_noise(
                noise, nsteps=svc.nsteps, **kw))
    return eager


def mp_norms(model) -> float:
    """The largest distance of an mp weight's norm per output unit
    (times √(units/numel), the re-projection's α) from the
    re-projection's 1/(1 + 1e-4)."""
    from diffsci_tpu_torch.models.nets.normed import _MagnitudePreserving

    worst = 0.0
    for m in model.net.modules():
        if isinstance(m, _MagnitudePreserving):
            w = m.weight.detach().float()
            n = w.flatten(1).norm(dim=1) * (w.shape[0] / w.numel()) ** 0.5
            worst = max(worst, float((n - 1 / (1 + 1e-4)).abs().max()))
    return worst


def phase_conditional_mp_serving(cfg_d, cfg_e, zero):
    """Serving D and E through SamplerService (bf16, seed 0, 18 Heun
    steps), a graph per bucket: exact launch counts (D: CFG makes 70
    network calls a sample, each 20 K2 and one K4, and 35 K1, one a
    denoiser evaluation; E: 35 calls of 28 K2 and 35 K1, no K4: its
    attention is cosine), one seed one result, the graphed request
    against its eager body, the porosity of a request reaching the
    graph, one profiled request each. Returns the launch counts and the
    services."""
    from diffsci_tpu_torch import IntervalGuidance

    y = {"porosity": torch.tensor([0.3])}
    kw = {"y": y, "guidance": IntervalGuidance(*GUIDANCE)}
    counts_d, runs_d, svc_d = serve(
        "config D", model_d(cfg_d), (32, 32, 32, 1), (1, 4), (1, 4, 6), 4,
        NSTEPS, sample_kwargs=kw)
    expected_d = dict(zero, fused_axby=NFE * runs_d,
                      norm_silu=2 * 20 * NFE * runs_d,
                      flash_attention=2 * NFE * runs_d)
    counts_e, runs_e, svc_e = serve(
        "config E", model_e(cfg_e), (28, 28, 1), (1, 8, 64), (1, 64, 70), 8,
        NSTEPS)
    expected_e = dict(zero, fused_axby=NFE * runs_e,
                      norm_silu=28 * NFE * runs_e)
    if counts_d != expected_d or counts_e != expected_e:
        raise AssertionError(f"launch counts {counts_d} / {counts_e}, "
                             f"expected {expected_d} / {expected_e}")
    log(f"[counts] config D (CFG, 70 network calls a sample): {counts_d}; "
        f"config E (35 calls): {counts_e}")
    graphs_vs_eager_requests("config D", svc_d, 4, guided_eager(svc_d, 4),
                             within_phase2)
    graphs_vs_eager_requests("config E", svc_e, 64, guided_eager(svc_e, 64),
                             within_phase2)
    # the request's porosity is a static input of the graph: another value
    # from the same seed gives another sample, and the first value again
    # the first sample
    first = svc_d.sample(4, generator=5)
    y["porosity"].fill_(0.45)
    other = svc_d.sample(4, generator=5)
    y["porosity"].fill_(0.3)
    again = svc_d.sample(4, generator=5)
    moved = float(np.abs(first - other).max())
    log(f"[config D] porosity 0.3 -> 0.45 from one seed: max|Δ| {moved:.3e}"
        f"; back to 0.3: same bits {np.array_equal(first, again)}")
    if moved == 0.0 or not np.array_equal(first, again):
        raise AssertionError("config D: the request's porosity does not "
                             "reach the graph")
    profile_call("config D", "request 4", lambda: svc_d.sample(4))
    profile_call("config E", "request 64", lambda: svc_e.sample(64))
    return [counts_d, counts_e], svc_d, svc_e


def bn_graph_matches_eager(cfg_d, steps=3):
    """D's train step graphed against eager (bf16, seed 0) on one batch
    whose statistics move the batch norm (x·0.5 + 0.3), σ, ε and the keep
    mask replayed: after every step the running statistics equal, and the
    loss within phase 3's rtol 1e-3."""
    from diffsci_tpu_torch import create_train_state, make_train_step

    gen = torch.Generator("cuda").manual_seed(11)
    x_shape = (4, 32, 32, 32, 1)
    x = torch.randn(x_shape, device="cuda", generator=gen) * 0.5 + 0.3
    y = {"porosity": torch.rand((4, 1), device="cuda", generator=gen)}
    draws = [(torch.exp(torch.randn(4, device="cuda", generator=gen) * 1.2
                        - 1.2),
              torch.randn(x_shape, device="cuda", generator=gen),
              torch.rand(4, device="cuda", generator=gen) < 0.9)
             for _ in range(steps)]
    runs = {}
    for arm in ("eager", "graphed"):
        model = model_d(cfg_d)
        state, tx = create_train_state(model, x_shape, seed=0)
        step = make_train_step(model, tx, _raw=arm == "eager")
        stats, losses = [], []
        for sigma, eps, keep in draws:
            met = step(state, x, y, sigma=sigma, eps=eps, keep=keep)[1]
            losses.append(float(met["train_loss"]))
            stats.append(torch.cat([model.net.bnorm.mean,
                                    model.net.bnorm.var]).cpu())
        runs[arm] = (losses, stats)
    (l_eager, s_eager), (l_graph, s_graph) = runs["eager"], runs["graphed"]
    same = all(torch.equal(a, b) for a, b in zip(s_eager, s_graph))
    ok = same and np.allclose(l_graph, l_eager, rtol=1e-3, atol=0)
    log(f"[train config D] batch norm over {steps} steps, graphed against "
        f"eager: running (mean, var) {[s.tolist() for s in s_graph]}, equal "
        f"{same}; losses {l_graph} / {l_eager} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("config D: the graphed step's batch norm "
                             "statistics differ from the eager steps'")


def porous_batch(n, size, gen):
    """n periodic two-phase volumes of size³ (1 = pore, 0 = solid) and
    their porosities [n, 1]: N(0, 1) noise low-passed on the torus
    (a Gaussian of 3 wavenumbers in the Fourier domain), thresholded at a
    porosity drawn from [0.2, 0.5] per volume. Channels-last."""
    z = torch.randn((n, size, size, size), device="cuda", generator=gen)
    k = torch.fft.fftfreq(size, device="cuda") * size
    k2 = k[:, None, None] ** 2 + k[None, :, None] ** 2 + k[None, None, :] ** 2
    z = torch.fft.ifftn(torch.fft.fftn(z, dim=(1, 2, 3))
                        * torch.exp(-k2 / (2 * 3.0 ** 2)), dim=(1, 2, 3)).real
    phi = 0.2 + 0.3 * torch.rand((n, 1), device="cuda", generator=gen)
    level = torch.quantile(z.reshape(n, -1), phi[:, 0], dim=1).diagonal()
    x = (z < level[:, None, None, None]).float()
    return x[..., None], x.reshape(n, -1).mean(1, keepdim=True)


def phase_conditional_mp_training(cfg_d, cfg_e, zero):
    """Training D (batch 4, the condition-drop draw, the batch norm) and E
    (batch 256, has_mp_weights, the dynamic loss weight) through the
    graphed make_train_step: exact launch counts, a finite falling loss,
    seconds per step, peak memory, one profiled step; D's batch norm
    statistics against eager steps, E's mp weights on the sphere after
    the steps. Returns the launch counts."""
    # D trains on what its users train on: periodic two-phase volumes and
    # their porosities. (On N(0, 1) data the batch norm makes the data
    # Gaussian of std σ_data, for which the untrained net's F ≈ 0 is
    # already the optimal denoiser: the loss starts at its floor.)
    x, phi = porous_batch(4, 32, torch.Generator("cuda").manual_seed(12))
    log(f"[train config D] batch: periodic two-phase volumes, porosity "
        f"{[round(float(p), 4) for p in phi]}")
    counts_d, _, _ = train("config D", cfg_d, (4, 32, 32, 32, 1), 20,
                        dict(zero, norm_silu=20, norm_silu_bwd=20,
                             flash_attention=1, flash_attention_dq=1,
                             flash_attention_dkv=1),
                        profiled=True, model=model_d(cfg_d),
                        y={"porosity": phi}, x=x)
    bn_graph_matches_eager(cfg_d)
    counts_e, model, _ = train("config E", cfg_e, (256, 28, 28, 1), 20,
                            dict(zero, norm_silu=28, norm_silu_bwd=28),
                            profiled=True, model=model_e(cfg_e),
                            has_mp_weights=True)
    worst = mp_norms(model)
    log(f"[train config E] mp weights per output unit after the steps: "
        f"max |α‖w‖ - 1/(1 + 1e-4)| {worst:.3e} (limit 1e-5) "
        f"{'ok' if worst <= 1e-5 else 'FAIL'}")
    if worst > 1e-5:
        raise AssertionError("config E: mp weights left the sphere")
    return [counts_d, counts_e]


def small_d_config():
    """D's options at phase 2's cut: circular convolutions, cond_drop."""
    return dataclasses.replace(small_3d_config(),
                               convolution_type="circular", cond_drop=0.1)


def small_e_config():
    """E's options at a cut width and depth: 2D 16², mp convolutions,
    cosine attention at the 8² bottleneck."""
    from diffsci_tpu_torch import PUNetGConfig

    return PUNetGConfig(model_channels=16, channel_expansion=[2],
                        number_resnet_downward_block=1,
                        number_resnet_upward_block=1,
                        number_resnet_before_attn_block=1,
                        number_resnet_after_attn_block=1,
                        convolution_type="mp", attn_type="cosine")


def phase_conditional_mp_card_vs_cpu():
    """The small conditional and mp nets in f32, TF32 off, card against
    CPU: D's (3 guided Heun steps by IntervalGuidance from one noise, the
    batch norm decoded from non-trivial statistics; card graphed, CPU
    eager; phase 2's tolerance; 10 network calls, 5 K1) and three f32
    train steps each (D with the batch norm and a replayed keep mask, E
    with has_mp_weights and the dynamic loss weight; phase 3's
    tolerances); K2/K3 routing: GroupPix and affine_norm=False nets
    launch neither."""
    from diffsci_tpu_torch import IntervalGuidance, kernels

    cfg = small_d_config()
    cpu = model_d(cfg, "cpu", None)
    state = cpu.init(seed=1)
    state["bnorm.mean"].fill_(0.1)
    state["bnorm.var"].fill_(2.0)
    gpu = model_d(cfg, None, None)
    gpu.net.load_state_dict(state, strict=True)
    nsteps, shape = 3, (32, 32, 32, 1)
    kw = dict(y={"porosity": torch.tensor([0.3])},
              guidance=IntervalGuidance(*GUIDANCE), nsteps=nsteps)
    noise = torch.randn((2,) + shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    ref = cpu.decode(cpu.propagate_white_noise(noise.cpu(), **kw))
    gpu.compile_sampler(2, shape, **kw)
    kernels.reset_launches()
    out = gpu.sample(2, shape, torch.Generator("cuda").manual_seed(0),
                     **kw).cpu()
    counts = dict(kernels.LAUNCHES)
    err, ok = within_phase2(out, ref)
    nfe = 2 * nsteps - 1
    ok = ok and counts["fused_axby"] == nfe and \
        counts["flash_attention"] == 2 * nfe
    log(f"[card-vs-cpu] config D's options (3D 32^3 mc=8 flash, circular, "
        f"porosity, IntervalGuidance{GUIDANCE}, batch norm), {nsteps} Heun "
        f"steps, card graphed: max|card - cpu| {err:.3e} (max|cpu| "
        f"{float(ref.abs().max()):.3f}; tolerance rtol 1e-3 + atol 1e-3) "
        f"{'ok' if ok else 'FAIL'}; launches {counts}")
    if not ok:
        raise AssertionError("config D's options: card and CPU disagree, or "
                             "the launch counts are not CFG's")

    def sigma_draw(rng):
        return np.exp(rng.standard_normal(2) * 1.2 - 1.2).astype(np.float32)

    train_card_vs_cpu(
        "config D's options", lambda dev: model_d(cfg, dev, None),
        (2, 32, 32, 32, 1), sigma_draw, TRAIN,
        y={"porosity": torch.tensor([[0.2], [0.4]])},
        keep=torch.tensor([True, False]))
    train_card_vs_cpu(
        "config E's options (2D 16^2 mc=16 mp, cosine, dynamic loss weight)",
        lambda dev: model_e(small_e_config(), dev, None, dlw=16),
        (2, 16, 16, 1), sigma_draw, ("norm_silu", "norm_silu_bwd"),
        has_mp_weights=True)

    # the norms K2 and K3 serve: spatial, affine, one group per channel;
    # GroupPix (per pixel) and affine_norm=False take the plain path
    from diffsci_tpu_torch import PUNetG

    base = dataclasses.replace(small_e_config(), convolution_type="default",
                               attn_type="default")
    x = torch.randn((2, 1, 16, 16), device="cuda")
    for name, fields, per_norm in (
            ("GroupLN/GroupRMS", {}, 1),
            ("GroupPix", dict(first_resblock_norm="GroupPix",
                              second_resblock_norm="GroupPix"), 0),
            ("affine_norm=False", dict(affine_norm=False), 0)):
        net = PUNetG(dataclasses.replace(base, **fields))
        kernels.reset_launches()
        net(x, torch.zeros(2, device="cuda")).sum().backward()
        counts = {k: kernels.LAUNCHES[k] for k in ("norm_silu",
                                                    "norm_silu_bwd")}
        expected = dict.fromkeys(counts, 2 * 6 * per_norm)
        log(f"[norm routing] {name}: forward and backward of a 12-norm net "
            f"launch {counts} (expected {expected})")
        if counts != expected:
            raise AssertionError(f"{name}: K2/K3 launches {counts}, "
                                 f"expected {expected}")


# ---------------------------------------------------------------------------
# phase 17: the training loop, checkpoints and serving a checkpoint
# ---------------------------------------------------------------------------
FIT_IMAGES = 6144          # random 28×28×1 f32 images, 19.3 MB on disk
FIT_STEPS = 2 * ((FIT_IMAGES - FIT_IMAGES // 10) // 256)   # 2 epochs of 21


def fit_ema():
    """The tracker of phase 17's run: power EMA (0.05, 0.1) every 4 steps
    (``bench.py:107-111``)."""
    from diffsci_tpu_torch import EMATracker

    return EMATracker(ema_type="power", power_function_stds=[0.05, 0.1],
                      update_every=4)


def state_copy(state) -> dict:
    from diffsci_tpu_torch.checkpoint import state_tensors

    return {k: t.detach().clone() for k, t in state_tensors(state).items()}


def fixed_steps(model, state, x, seed, n=5, raw=False):
    """``n`` graphed (or eager) B steps from one generator; the tensors
    after them."""
    from diffsci_tpu_torch import default_optimizer, make_train_step

    step = make_train_step(model, default_optimizer(), ema=fit_ema(),
                           _raw=raw)
    gen = torch.Generator("cuda").manual_seed(seed)
    for _ in range(n):
        step(state, x, generator=gen)
    return state_copy(state)


def max_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def idle_share(prof, seconds: float) -> tuple[float, float]:
    """(device busy seconds, idle share) of a finished torch.profiler run
    over ``seconds`` of host time."""
    from torch.autograd import DeviceType

    busy = sum(device_us(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e6
    return busy, 1 - busy / seconds


def phase_fit_checkpoint_serve(cfg_b, zero, bare_step_ms):
    """Configuration B at full width through the host loop: ``fit_karras``
    on a memmapped .npy of random images (2 epochs of 21 steps at batch
    256, validation on 10% of them, power EMA (0.05, 0.1) every 4 steps,
    cadence and metric saves into a ``CheckpointManager``, steps 31 to 40
    under torch.profiler), exact launch counts and one capture of each
    graph; a checkpoint restored in place under the captured graphs gives
    the same 5 steps bit for bit, and restored into a fresh state in a
    fresh graph cache the same step as the eager one; post-hoc EMA on the
    card against float64; ``SamplerService.from_checkpoint`` (through a
    ``ModelRegistry``) bit for bit against a service over the in-memory
    EMA profile 0, with exact launch counts. Times beside the card's name
    and power limit. Returns the launch counts of the fit and of the
    served request."""
    import pathlib
    import shutil
    import tempfile

    from diffsci_tpu_torch import (CheckpointManager, ModelRegistry,
                                   SamplerService, create_train_state,
                                   fit_karras, kernels, restore_checkpoint,
                                   save_checkpoint)
    from diffsci_tpu_torch.checkpoint import load_description, load_state
    from diffsci_tpu_torch.models.karras import (
        karras_model_from_description, solve_posthoc_weights)

    card = smi("name,power.limit")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    try:
        data = np.random.default_rng(0).standard_normal(
            (FIT_IMAGES, 28, 28, 1), dtype=np.float32)
        np.save(tmp / "images.npy", data)
        images = np.load(tmp / "images.npy", mmap_mode="r")
        model = karras(cfg_b)
        mgr = CheckpointManager(tmp / "ckpts", max_to_keep=2, keep_cadence=1)
        saves = {}                # step -> host seconds of the save call
        manager_save = mgr.save

        def timed_save(step, *args):
            t = time.perf_counter()
            manager_save(step, *args)
            saves[step] = time.perf_counter() - t

        mgr.save = timed_save
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, trainer = fit_karras(
            model, images, batch_size=256, max_epochs=2, val_fraction=0.1,
            ema=fit_ema(), log_dir=tmp / "logs", checkpoint_manager=mgr,
            save_every_steps=10, log_every=10, profile_dir=tmp / "profile",
            profile_steps=(30, 39))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)

        rows = [json.loads(line) for line in
                (tmp / "logs" / "metrics.jsonl").read_text().splitlines()]
        train_rows = {r["step"]: r for r in rows if "train_loss" in r}
        valid = [(r["step"], r["valid_loss"]) for r in rows
                 if "valid_loss" in r]
        steps_logged = sorted(train_rows)
        kinds = sorted(str(k[0]) if isinstance(k, tuple) else k
                       for k in state.graphs.graphs)
        captures = {("eval" if k[0] == "eval" else "train") if isinstance(
            k, tuple) else k: round(g.capture_seconds, 3)
            for k, g in state.graphs.graphs.items()}
        # a train step: a forward and a backward (28 K2, 28 K3; its combine
        # is the plain expression); an eval batch: the loss with train
        # False, whose combine is K1 (the "sample" policy, as in the JAX
        # package), and 28 K2
        n_eval = 2 * ((FIT_IMAGES // 10) // 256)
        expected = dict(zero, fused_axby=n_eval,
                        norm_silu=28 * (FIT_STEPS + n_eval),
                        norm_silu_bwd=28 * FIT_STEPS)
        # the EMA moves on every 4th step: step 42 holds step 40's shadows
        at40 = load_state(mgr.step_dir(40))
        ema_ok = state.ema.num_updates == FIT_STEPS and all(
            torch.equal(at40[f"ema/{i}/{k}"].cuda(), v)
            for i, prof in enumerate(state.ema.profiles)
            for k, v in prof.items())
        ok = (state.step == FIT_STEPS and ema_ok
              and steps_logged == [1, 10, 20, 30, 40]
              and [s for s, _ in valid] == [21, 42]
              and train_rows[40]["train_loss"] < train_rows[1]["train_loss"]
              and counts == expected and len(state.graphs.graphs) == 3
              and np.isfinite([v for _, v in valid]).all())
        log(f"[fit config B] fit_karras over a memmapped .npy of {FIT_IMAGES}"
            f" images: {state.step} steps, validations {valid}, train loss "
            f"step 1 {train_rows[1]['train_loss']:.5f} -> step 40 "
            f"{train_rows[40]['train_loss']:.5f}; EMA updates "
            f"{state.ema.num_updates}, step 42 holds step 40's shadows "
            f"{ema_ok}; logged steps {steps_logged}; graphs {kinds} "
            f"(capture seconds {captures}); launches {counts}, expected "
            f"{expected}; retained checkpoints {mgr.all_steps()} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 17: the fit did not take its steps, "
                                 "log its rows, capture each graph once or "
                                 "launch exactly the expected kernels")
        # host seconds since the fit began at each logged step (after its
        # sync); steps 11-20 hold the cadence save at step 10 and nothing
        # else but steps
        elapsed = {s: s * 256 / r["imgs_per_sec"]
                   for s, r in train_rows.items()}
        window = (elapsed[20] - elapsed[10]) / 10 * 1e3
        loop = (elapsed[20] - elapsed[10] - saves[10]) / 10 * 1e3
        save_copy = mgr.last_save["copy_seconds"]
        busy, idle = idle_share(trainer.profiler, trainer.profile_seconds)
        log(f"[fit config B] {card}: fit wall {wall:.3f} s "
            f"({wall / FIT_STEPS * 1e3:.2f} ms a step over the whole fit: "
            f"captures, 2 validations, 6 saves, the profiled window and its "
            f"trace); steps 11-20 {window:.2f} ms a step with the save at "
            f"step 10, {loop:.2f} ms without it; bare graphed B step of "
            f"phase 8 {bare_step_ms:.2f} ms (ratios "
            f"{window / bare_step_ms:.3f}, {loop / bare_step_ms:.3f}); "
            f"imgs_per_sec at step 40 "
            f"{train_rows[40]['imgs_per_sec']:.1f} (whole fit), "
            f"{256e3 / window:.1f} and {256e3 / loop:.1f} (steps 11-20 with "
            f"and without the save); host seconds of each save call "
            f"{ {k: round(v, 4) for k, v in saves.items()} }")
        # steps 31-40 hold no validation, save or log sync (the window
        # starts after step 30's save has copied to the host; its disk
        # write on the manager's thread may still run)
        log(f"[fit config B] {card}: steps 31-40 under torch.profiler "
            f"(steps only): host {trainer.profile_seconds:.4f} s "
            f"({trainer.profile_seconds * 100:.3f} ms a step, ratio to the "
            f"bare step {trainer.profile_seconds * 100 / bare_step_ms:.3f}),"
            f" device busy {busy:.4f} s, idle share {idle:.3f}; the "
            f"manager's last save: "
            f"{mgr.last_save['bytes']} bytes, device-to-host "
            f"{save_copy:.4f} s, background write "
            f"{mgr.last_save['write_seconds']:.4f} s")

        # restore in place, under the captured graphs
        x = torch.from_numpy(data[:256]).cuda()
        ckpt = tmp / "step42"
        info = save_checkpoint(ckpt, state, model.export_description())
        keys = set(state.graphs.graphs)
        first = fixed_steps(model, state, x, 123)
        t0 = time.perf_counter()
        restore_checkpoint(ckpt, state, model)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        again = fixed_steps(model, state, x, 123)
        same = all(torch.equal(first[k], again[k]) for k in first)
        log(f"[checkpoint config B] {card}: {info['bytes']} bytes "
            f"({info['bytes'] / 2 ** 20:.1f} MiB), save: device-to-host "
            f"{info['copy_seconds']:.4f} s, disk write "
            f"{info['write_seconds']:.4f} s; restore in place "
            f"{restore_s:.4f} s; 5 steps after the restore, under the "
            f"captured graphs, bit for bit the 5 before it (params, AdamW "
            f"moments, EMA): {same} (max|Δ| {max_diff(first, again):.3e}); "
            f"no new capture {set(state.graphs.graphs) == keys}")
        if not same or set(state.graphs.graphs) != keys:
            raise AssertionError("phase 17: steps after an in-place restore "
                                 "differ from the same steps before it")

        # a fresh state in a fresh graph cache: a replay after the restore
        # against the eager step
        fresh = karras(cfg_b)
        fresh_state, _ = create_train_state(fresh, x.shape, seed=None,
                                            ema=fit_ema())
        restore_checkpoint(ckpt, fresh_state, fresh)
        fixed_steps(fresh, fresh_state, x, 7, n=1)        # warm-up, capture
        restore_checkpoint(ckpt, fresh_state, fresh)
        graphed = fixed_steps(fresh, fresh_state, x, 7, n=1)   # a replay
        eager_model = karras(cfg_b)
        eager_state, _ = create_train_state(eager_model, x.shape, seed=None,
                                            ema=fit_ema())
        restore_checkpoint(ckpt, eager_state, eager_model)
        eager = fixed_steps(eager_model, eager_state, x, 7, n=1, raw=True)
        equal = all(torch.equal(graphed[k], eager[k]) for k in graphed)
        log(f"[checkpoint config B] restored into a fresh state and graph "
            f"cache: the replayed step after the restore equals the eager "
            f"step {equal} (max|Δ| {max_diff(graphed, eager):.3e})")
        if not equal:
            raise AssertionError("phase 17: the replayed step of a restored "
                                 "state differs from the eager step")
        del fresh, fresh_state, eager_model, eager_state

        # post-hoc EMA on the card against float64
        restore_checkpoint(ckpt, state, model)
        t0 = time.perf_counter()
        synth = mgr.synthesize_posthoc_ema(state, fit_ema(),
                                           target_std=0.075)
        torch.cuda.synchronize()
        synth_s = time.perf_counter() - t0
        stds = list(fit_ema().power_function_stds)
        by_t = {(s // 4) * 4: s for s in mgr.all_steps() if s >= 4}
        ts = [t for t in sorted(by_t) for _ in stds]
        w = solve_posthoc_weights(ts, stds * len(by_t), max(ts), 0.075)
        snaps = [load_state(mgr.step_dir(by_t[t])) for t in sorted(by_t)]
        worst, scale = 0.0, 0.0
        for name, got in synth.items():
            ref = sum(float(wi) * snap[f"ema/{i}/{name}"].double().numpy()
                      for wi, (snap, i) in zip(w, [(s, i) for s in snaps
                                                   for i in range(len(stds))]))
            worst = max(worst, float(np.abs(got.double().cpu().numpy()
                                            - ref).max()))
            scale = max(scale, float(np.abs(ref).max()))
        ok = worst <= 1e-6 * scale
        log(f"[post-hoc EMA config B] target std 0.075 from checkpoints "
            f"{mgr.all_steps()} dated {sorted(by_t)} (update_every 4), "
            f"weights {np.round(w, 6).tolist()}: on the card {synth_s:.3f} s,"
            f" max|card - float64| {worst:.3e} of max {scale:.3f} (limit "
            f"1e-6 relative) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 17: post-hoc EMA on the card differs "
                                 "from float64")

        # serve the checkpoint through the registry
        registry = ModelRegistry(tmp / "models.json")
        registry.register("mnist-b", str(ckpt), load_description(ckpt))
        entry = registry.entry("mnist-b")
        served = SamplerService.from_checkpoint(
            entry["checkpoint"], (28, 28, 1), batch_buckets=(1, 8, 64))
        reference = karras_model_from_description(entry["description"])
        reference.net.load_state_dict({**dict(model.net.named_buffers()),
                                       **fit_ema().get_params(state.ema, 0)})
        in_memory = SamplerService(reference, (28, 28, 1),
                                   batch_buckets=(1, 8, 64))
        served.warmup()
        in_memory.warmup()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = served.sample(64, generator=2024)
        served_s = time.perf_counter() - t0
        serve_counts = dict(kernels.LAUNCHES)
        ref = in_memory.sample(64, generator=2024)
        expected = dict(zero, fused_axby=NFE, norm_silu=28 * NFE)
        ok = np.array_equal(out, ref) and serve_counts == expected and \
            np.isfinite(out).all()
        log(f"[serve checkpoint config B] {card}: from_checkpoint (f32, "
            f"EMA profile 0) request 64: {served_s:.4f} s, std "
            f"{out.std():.4f}; bit for bit the in-memory service "
            f"{np.array_equal(out, ref)}; launches {serve_counts}, expected "
            f"{expected} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 17: the served checkpoint differs "
                                 "from the in-memory model, or its launch "
                                 "counts are not a Heun sample's")
        return [counts, serve_counts]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phases 18 to 20: the optimizers, the serving stack, card against CPU
# ---------------------------------------------------------------------------
def optimizer_bytes(state) -> int:
    """Bytes of an optimizer's state tensors, each tensor counted once."""
    sizes = {}
    for slot in state.optimizer.state.values():
        for t in slot.values():
            if torch.is_tensor(t):
                sizes[t.data_ptr()] = t.numel() * t.element_size()
    return sum(sizes.values())


def phase_optimizers(cfg_b, zero, adamw_step_ms):
    """Configuration B (batch 256, bf16 over f32 masters, the graphed step)
    under the two optimizers written for the port: 20 timed steps each of
    ``schedule_free_optimizer()`` and ``default_optimizer(mu_dtype=
    torch.bfloat16)`` with exact launch counts, a finite falling loss and
    one capture of the step; ms a step beside phase 8's AdamW step and the
    optimizer state's bytes beside AdamW's f32 moments; then
    ``schedule_free_eval_params`` loaded into a B model and served through
    one graphed request. Returns the launch counts and the bf16-moment
    run's (model, state)."""
    from diffsci_tpu_torch import (SamplerService, default_optimizer,
                                   kernels, schedule_free_eval_params,
                                   schedule_free_optimizer)

    card = smi("name,power.limit")
    per_step = dict(zero, norm_silu=28, norm_silu_bwd=28)
    runs, counts = {}, []
    for label, tx in (("schedule-free", schedule_free_optimizer()),
                      ("bf16 moment", default_optimizer(
                          mu_dtype=torch.bfloat16))):
        keep = {}
        c, model, ms = train(f"config B {label}", cfg_b, (256, 28, 28, 1),
                             20, per_step, optimizer=tx, keep=keep)
        state = keep["state"]
        steps = sum(isinstance(k, tuple) for k in state.graphs.graphs)
        nparams = sum(p.numel() for p in state.params.values())
        nbytes = optimizer_bytes(state)
        adamw = 8 * nparams + 4 * len(state.params)
        log(f"[optimizers config B] {card}: {label}: {ms:.2f} ms a step, "
            f"phase 8's AdamW step {adamw_step_ms:.2f} ms (ratio "
            f"{ms / adamw_step_ms:.3f}); optimizer state {nbytes} bytes "
            f"({nbytes / 1e6:.1f} MB) for {nparams} parameters, AdamW's f32 "
            f"moments and steps {adamw} bytes (saving {adamw - nbytes} "
            f"bytes); step graphs captured {steps}")
        if steps != 1:
            raise AssertionError(f"phase 18: {label} captured {steps} step "
                                 "graphs, expected one")
        counts.append(c)
        runs[label] = (model, state)

    model, state = runs["schedule-free"]
    served = karras(cfg_b)
    served.net.load_state_dict({**dict(model.net.named_buffers()),
                                **schedule_free_eval_params(state)})
    svc = SamplerService(served, (28, 28, 1), batch_buckets=(64,))
    svc.warmup()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = svc.sample(64, generator=5)
    dt = time.perf_counter() - t0
    serve_counts = dict(kernels.LAUNCHES)
    expected = dict(zero, fused_axby=NFE, norm_silu=28 * NFE)
    ok = serve_counts == expected and np.isfinite(out).all()
    log(f"[optimizers config B] {card}: schedule_free_eval_params served "
        f"through one graphed request of 64: {dt:.4f} s, std "
        f"{out.std():.4f}; launches {serve_counts} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 18: the schedule-free eval weights did "
                             "not serve, or not through the kernels")
    return counts + [serve_counts], runs["bf16 moment"]


def http_post(url, obj, timeout=60):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def recorded_dispatches(svc) -> list:
    """Wrap a service's dispatch: the list it returns fills with (bucket,
    the row seeds of each request) per dispatch."""
    record, dispatch = [], svc._dispatch

    def recording(batch, total):
        record.append((svc._bucket(total), [list(r.seeds) for r in batch]))
        dispatch(batch, total)

    svc._dispatch = recording
    return record


def crowd(fn, seeds) -> tuple[dict, float]:
    """``fn(seed)`` from one thread per seed, all at once: the results by
    seed and the wall seconds."""
    import threading

    results, errors = {}, []

    def client(seed):
        try:
            results[seed] = fn(seed)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in seeds]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return results, wall


def isolation(label, model, shape, results, record, sample_kwargs):
    """Each crowded one-row request against the same seed served alone
    through the dispatcher: bit for bit in the bucket its dispatch used,
    and within phase 2's tolerance in bucket 1."""
    from diffsci_tpu_torch import SamplerService
    from diffsci_tpu_torch.serving import row_seeds

    bucket_of = {seeds[0]: b for b, reqs in record for seeds in reqs}
    alone = {}
    for b in sorted(set(bucket_of.values()) | {1}):
        alone[b] = SamplerService(model, shape, batch_buckets=(b,),
                                  batch_window_ms=1.0,
                                  sample_kwargs=sample_kwargs)
    same, close, worst = 0, 0, 0.0
    for seed, got in results.items():
        b = bucket_of[row_seeds(seed, 1)[0]]
        same += np.array_equal(got, alone[b].sample(1, seed))
        err, ok = within_phase2(torch.from_numpy(got),
                                torch.from_numpy(alone[1].sample(1, seed)))
        close += ok
        worst = max(worst, err)
    for svc in alone.values():
        svc.close()
    ok = same == close == len(results)
    log(f"[dispatcher {label}] per-row isolation: {same} of {len(results)} "
        f"crowded requests bit for bit the same seed alone in their "
        f"bucket; against bucket 1 max|Δ| {worst:.3e}, {close} within "
        f"phase 2's tolerance {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase 19: {label}: a row depended on what it "
                             "was batched with")


def dispatch_rows(record, results, run) -> tuple[int, int]:
    """Each dispatch of ``record`` run again as ``run(bucket, the rows'
    generators)``: how many of the crowded one-row requests of
    ``results`` are bit for bit their row there, and how many there
    are."""
    from diffsci_tpu_torch.serving import row_seeds

    by_row = {row_seeds(seed, 1)[0]: got for seed, got in results.items()}
    same = 0
    for b, reqs in record:
        rows = [s for seeds in reqs for s in seeds]
        gens = [torch.Generator("cuda").manual_seed(s) for s in rows]
        out = run(b, gens).cpu().numpy()
        same += sum(np.array_equal(by_row[s], out[i:i + 1])
                    for i, s in enumerate(rows))
    return same, len(results)


def ddpm_dispatcher_arm(model_c, zero, card) -> dict:
    """Configuration C (DDIM, 100 steps, bf16) through the dispatcher at
    buckets (1, 16), over phase 9's model and graphs: 16 concurrent
    one-sample requests, one K7 a step a dispatch and nothing else, and
    each request bit for bit its row of ``DDPMModel.sample`` with its
    dispatch's row generators (x_T and each step's noise from the row's
    own generator)."""
    from diffsci_tpu_torch import SamplerService, kernels

    shape = (32, 32, 3)
    svc = SamplerService(model_c, shape, batch_buckets=(1, 16),
                         nsteps=DDIM_STEPS, batch_window_ms=5.0)
    svc.warmup()
    record = recorded_dispatches(svc)
    kernels.reset_launches()
    results, wall = crowd(lambda s: svc.sample(1, s), range(3000, 3016))
    c = dict(kernels.LAUNCHES)
    svc.close()
    expected = dict(zero, fused_lincomb3=DDIM_STEPS * len(record))
    same, n = dispatch_rows(record, results, lambda b, gens: model_c.sample(
        b, shape, generator=gens, nsteps=DDIM_STEPS))
    ok = c == expected and same == n and all(
        np.isfinite(r).all() and r.shape == (1,) + shape
        for r in results.values())
    log(f"[dispatcher config C DDIM] {card}: 16 concurrent one-sample "
        f"requests in {wall:.4f} s, {len(record)} dispatches (buckets "
        f"{sorted(b for b, _ in record)}); launches {c}, expected "
        f"{expected}; {same} of {n} bit for bit their row of "
        f"DDPMModel.sample with the rows' generators "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 19: DDIM through the dispatcher gave "
                             "wrong launch counts or rows that are not "
                             "their generators'")
    return c


def phase_serving_stack(cfg_a, cfg_b, zero, trained, model_c):
    """The serving stack at configuration B's full width, from a checkpoint
    of phase 18's bf16-moment run saved into a temporary directory that is
    deleted at the end: the command line (``info``, ``sample --grid`` in a
    subprocess, bit for bit the in-process request); ``build_server`` with
    the dispatcher (``batch_window_ms=5``, buckets (1, 8, 64)) against
    one-at-a-time serving, 32 concurrent one-sample clients, per-row
    isolation and exact launches per dispatch; the same with
    Euler–Maruyama in-process; Picard mode at B's and A's bucket 1, 18 and
    64 steps; 1-NFE mode at bucket 64, and a cold 1-NFE dispatcher
    service; configuration C's DDIM through the dispatcher (``model_c``,
    phase 9's model); AnoDDPM, DDAD, ``interpolate_images``
    and ``sample_and_filter``; a profiled request read back by
    ``python -m diffsci_tpu_torch profile``. The command line runs at
    PyTorch's default TF32 setting, as its process does; the rest with
    TF32 off, since it holds a request batched in one bucket against the
    same seed alone in another, where TF32's rounding alone moves a sample
    by phase 2's tolerance. Returns the launch counts."""
    import pathlib
    import shutil
    import tempfile
    import threading

    from diffsci_tpu_torch import (SamplerService, kernels, profiling,
                                   save_checkpoint)
    from diffsci_tpu_torch.serving import build_server

    card = smi("name,power.limit")
    root = os.path.dirname(os.path.abspath(__file__))
    shape = (28, 28, 1)
    model, state = trained
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    counts = []
    tf32 = torch.backends.cudnn.allow_tf32

    procs = []

    def cli_start(*args):
        """``python -m diffsci_tpu_torch *args`` started: (its start,
        the process)."""
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "diffsci_tpu_torch", *map(str, args)],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
        return args[0], time.perf_counter(), procs[-1]

    def cli_end(started):
        """A started command's output and seconds, once it has ended."""
        name, t0, proc = started
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"phase 19: python -m diffsci_tpu_torch "
                                 f"{name} exited {proc.returncode}: "
                                 f"{err[-3000:]}")
        return out, time.perf_counter() - t0

    def cli(*args):
        return cli_end(cli_start(*args))

    try:
        ckpt = tmp / "ckpt"
        save_checkpoint(ckpt, state, model.export_description())
        # `info` and `sample` side by side, each its own process
        info_p = cli_start("info", "--ckpt", ckpt)
        sample_p = cli_start("sample", "--ckpt", ckpt, "--shape", *shape,
                             "--nsamples", 64, "--seed", 11, "--out",
                             tmp / "s.npy", "--grid", tmp / "grid.png")
        info, info_s = cli_end(info_p)
        text, sample_s = cli_end(sample_p)
        tag = json.loads(info)["config_description"]["tag"]
        from_cli = np.load(tmp / "s.npy")
        base = SamplerService.from_checkpoint(ckpt, shape, ema_stds=[0.05],
                                              batch_buckets=(64,))
        in_process = base.sample(64, generator=11)
        png = (tmp / "grid.png").read_bytes()
        same = np.array_equal(from_cli, in_process)
        ok = (tag == "edm" and same and png[:8] == b"\x89PNG\r\n\x1a\n"
              and np.isfinite(from_cli).all())
        log(f"[cli config B] {card}: info {info_s:.1f} s (tag {tag}); "
            f"sample --nsamples 64 --seed 11 --grid {sample_s:.1f} s in a "
            f"subprocess on the card ({text.strip().splitlines()[-1]}); the "
            f".npy bit for bit the in-process from_checkpoint request "
            f"{same}; PNG {len(png)} bytes written without matplotlib "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 19: the command line's sample "
                                 "differs from the in-process request")
        # the rest runs without TF32, in graphs captured without it
        torch.backends.cudnn.allow_tf32 = False
        served = SamplerService.from_checkpoint(
            ckpt, shape, ema_stds=[0.05]).model   # f32, EMA profile 0

        # HTTP: 32 one-sample clients, dispatcher against one at a time
        per_run = {"fused_axby": NFE, "norm_silu": 28 * NFE}
        seeds = list(range(1000, 1032))
        http = {}
        for window in (5.0, 0.0):
            svc = SamplerService(served, shape, batch_buckets=(1, 8, 64),
                                 batch_window_ms=window)
            svc.warmup()
            record = recorded_dispatches(svc) if window else None
            server = build_server(svc, 0, max_nsamples=64)
            url = f"http://127.0.0.1:{server.server_address[1]}/sample"
            threading.Thread(target=server.serve_forever, daemon=True).start()
            http_post(url, {"nsamples": 1, "seed": 1})
            if record is not None:
                record.clear()
            kernels.reset_launches()
            results, wall = crowd(lambda s: np.asarray(http_post(
                url, {"nsamples": 1, "seed": s})["samples"], np.float32),
                seeds)
            c = dict(kernels.LAUNCHES)
            runs = len(record) if window else len(seeds)
            dispatches = svc.stats["batched_dispatches"]
            buckets = sorted(b for b, _ in record) if window else "-"
            expected = dict(zero, **{k: n * runs for k, n in per_run.items()})
            t0 = time.perf_counter()
            http_post(url, {"nsamples": 1, "seed": 7})
            one_http = time.perf_counter() - t0
            server.shutdown()
            server.server_close()
            t0 = time.perf_counter()
            svc.sample(1, 7)
            one_inproc = time.perf_counter() - t0
            svc.close()
            http[window] = (results, wall, record, runs)
            ok = c == expected and all(np.isfinite(r).all() and
                                       r.shape == (1,) + shape
                                       for r in results.values())
            log(f"[http config B] {card}: batch_window_ms {window}: 32 "
                f"concurrent one-sample clients in {wall:.4f} s, "
                f"{len(seeds) / wall:.2f} requests/s; {runs} bucket runs "
                f"(dispatch buckets {buckets}; the service's "
                f"batched_dispatches {dispatches}, the warm-up request's "
                f"included); launches {c}, expected "
                f"{expected}; one request alone over HTTP {one_http:.4f} s, "
                f"in-process {one_inproc:.4f} s (HTTP overhead "
                f"{one_http - one_inproc:.4f} s) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("phase 19: HTTP serving gave a wrong "
                                     "shape, a non-finite value or launch "
                                     "counts that are not a Heun sample's "
                                     "per bucket run")
            counts.append(c)
        results, wall, record, runs = http[5.0]
        log(f"[http config B] dispatcher {len(seeds) / wall:.2f} requests/s "
            f"against one at a time {len(seeds) / http[0.0][1]:.2f} "
            f"(ratio {http[0.0][1] / wall:.3f}), "
            f"{runs} dispatches for {len(seeds)} requests")
        isolation("config B", served, shape, results, record, None)

        # Euler–Maruyama through the dispatcher, in-process
        sto = {"stochastic": True}
        svc = SamplerService(served, shape, batch_buckets=(1, 8, 64),
                             batch_window_ms=5.0, sample_kwargs=sto)
        svc.warmup()
        record = recorded_dispatches(svc)
        kernels.reset_launches()
        results, wall = crowd(lambda s: svc.sample(1, s), seeds)
        c = dict(kernels.LAUNCHES)
        svc.close()
        expected = dict(zero, fused_axby=NSTEPS * len(record),
                        norm_silu=28 * NSTEPS * len(record))
        log(f"[dispatcher config B EM] {card}: 32 concurrent one-sample "
            f"requests in {wall:.4f} s, {len(record)} dispatches (buckets "
            f"{sorted(b for b, _ in record)}); launches {c}, expected "
            f"{expected} {'ok' if c == expected else 'FAIL'}")
        if c != expected:
            raise AssertionError("phase 19: stochastic dispatches did not "
                                 "make 18 network calls each")
        counts.append(c)
        isolation("config B EM", served, shape, results, record, sto)

        counts += picard_arms(cfg_a, served, zero, card)
        counts.append(onestep_arm(model, zero, card))
        counts.append(ddpm_dispatcher_arm(model_c, zero, card))
        counts += feature_arms(model, served, zero, card)
        counts.append(profiled_request(served, zero, card, tmp, cli))
        return counts
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(tmp, ignore_errors=True)


def picard_arms(cfg_a, model_b, zero, card) -> list:
    """Picard latency mode (window 8, tol 1e-3) at B's and A's bucket 1,
    18 and 64 steps, against the sequential Euler request of the same
    seed: sweeps and wall; tol 0 in exactly nsteps sweeps within phase 2's
    tolerance of it; one K1 and one network call's K2 (and K4 in A) a
    sweep. The nets run in f32 with TF32 off (B: the served checkpoint,
    A: random weights from seed 0), since a Picard sweep runs the network
    at batch 8 and the sequential sampler at batch 1, where cuDNN may pick
    other algorithms: with TF32 their rounding alone moves a sample by
    phase 2's tolerance."""
    from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                                   SamplerService, kernels)

    model_a = KarrasModel(PUNetG(cfg_a), KarrasModelConfig.from_edm())
    model_a.init(seed=0)
    counts = []
    for label, model, shape, per_call in (
            ("B", model_b, (28, 28, 1), dict(fused_axby=1, norm_silu=28)),
            ("A", model_a, (32, 32, 32, 1),
             dict(fused_axby=1, norm_silu=20, flash_attention=1))):
        for nsteps in (NSTEPS, 64):
            def service(**kw):
                svc = SamplerService(model, shape, batch_buckets=(1,),
                                     nsteps=nsteps, **kw)
                svc.warmup()
                return svc

            seq = service(sample_kwargs={"integrator": "euler"})
            ref = seq.sample(1, 77)
            seq_wall = walls(lambda: seq.sample(1, 77))
            arms = {}
            for tol in (1e-3, 0.0):
                svc = service(picard={"window": 8, "tol": tol})
                svc.sample(1, 77)
                kernels.reset_launches()
                svc.stats["picard_sweeps"] = 0
                t0 = time.perf_counter()
                out = svc.sample(1, 77)
                wall = time.perf_counter() - t0
                c = dict(kernels.LAUNCHES)
                sweeps = svc.stats["picard_sweeps"]
                err, close = within_phase2(torch.from_numpy(out),
                                           torch.from_numpy(ref))
                expected = dict(zero, **{k: n * sweeps
                                         for k, n in per_call.items()})
                arms[tol] = (sweeps, wall, err, close, c == expected)
                counts.append(c)
            (s3, w3, e3, _, c3), (s0, w0, e0, close0, c0) = \
                arms[1e-3], arms[0.0]
            ok = c3 and c0 and close0 and s0 == nsteps and np.isfinite(e3)
            log(f"[picard config {label}] {card}: f32, bucket 1, {nsteps} "
                f"steps, window 8 (network batch 8): tol 1e-3 {s3} sweeps in "
                f"{w3:.4f} s, max|Δ| to sequential Euler {e3:.3e}; tol 0 "
                f"{s0} sweeps in {w0:.4f} s, max|Δ| {e0:.3e} (within "
                f"phase 2's tolerance: {close0}); sequential Euler {nsteps} "
                f"network calls, "
                f"{fmt(seq_wall)}; launches a sweep as one network call: "
                f"{c3 and c0} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"phase 19: Picard on config {label} at "
                                     f"{nsteps} steps: wrong sweeps, launch "
                                     "counts or result")
    return counts


def onestep_arm(model, zero, card) -> dict:
    """1-NFE serving at bucket 64: one K1 and 28 K2 a request, equal to
    ``get_denoiser(σ_max·ε, σ_max)`` on the request's ε. Then a cold
    dispatcher service at buckets (1, 8), never warmed by hand: 16
    concurrent first requests warm each bucket once (the callers that
    arrive meanwhile wait, and the warm-up replays nothing), and each is
    bit for bit its row of ``sample_onestep`` with its dispatch's row
    generators."""
    from diffsci_tpu_torch import SamplerService, kernels
    from diffsci_tpu_torch.models.karras.distill import sample_onestep

    svc = SamplerService(model, (28, 28, 1), batch_buckets=(64,), nsteps=1)
    svc.warmup()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = svc.sample(64, 99)
    wall = time.perf_counter() - t0
    c = dict(kernels.LAUNCHES)
    eps = torch.randn((64, 28, 28, 1), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(99))
    with torch.inference_mode():
        ref = model.get_denoiser(80.0 * eps, torch.full((64,), 80.0,
                                                        device="cuda"))[0]
    err, close = within_phase2(torch.from_numpy(out), ref.cpu())
    expected = dict(zero, fused_axby=1, norm_silu=28)
    ok = c == expected and close
    log(f"[1-NFE config B] {card}: nsteps=1, a request of 64 in "
        f"{wall:.4f} s; against get_denoiser(80·ε, 80) max|Δ| {err:.3e} "
        f"(bit for bit {np.array_equal(out, ref.cpu().numpy())}); launches "
        f"{c}, expected {expected} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 19: 1-NFE serving is not one denoiser "
                             "call")

    cold = SamplerService(model, (28, 28, 1), batch_buckets=(1, 8),
                          nsteps=1, batch_window_ms=5.0)
    compiles, compile_bucket = [], cold._compile

    def counted(b):
        compiles.append(b)
        compile_bucket(b)

    cold._compile = counted
    record = recorded_dispatches(cold)
    results, wall = crowd(lambda s: cold.sample(1, s), range(2000, 2016))
    cold.close()
    same, n = dispatch_rows(record, results, lambda b, gens: sample_onestep(
        model, b, (28, 28, 1), gens))
    ok = compiles == [1, 8] and same == n
    log(f"[1-NFE config B cold dispatcher] {card}: 16 concurrent first "
        f"requests in {wall:.4f} s (warm-up included), buckets warmed "
        f"{compiles}, {len(record)} dispatches; {same} of {n} bit for bit "
        f"their row of sample_onestep with the rows' generators "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 19: a cold 1-NFE dispatcher warmed a "
                             "bucket twice or mixed up rows")
    return c


def feature_arms(model, served, zero, card) -> list:
    """AnoDDPM and DDAD on 64 B images at step 30 of 100 (clean: samples of
    the served model; corrupted: a bright 12×12 patch), their
    reconstruction errors and walls; ``interpolate_images`` (8 inner
    points, 18 steps) and ``sample_and_filter`` (128 samples in chunks of
    64): walls. Exact launch counts, one K1 a network call."""
    from diffsci_tpu_torch import kernels
    from diffsci_tpu_torch.features import DDAD, AnoDDPM

    sched = model.config.noisescheduler
    clean = model.sample(64, (28, 28, 1), torch.Generator("cuda")
                         .manual_seed(3), nsteps=NSTEPS)
    corrupt = clean.clone()
    corrupt[:, 8:20, 8:20, :] += 3.0

    def score(x, sigma):
        return model.get_score(x, sigma)

    # the guidance term w·(y − x) is stable while w·t·|dt| < 1 on the grid
    t = sched.create_steps(101)
    w = float(0.5 / (t[30:100] * np.abs(np.diff(t)[30:100])).max())
    arms = (("AnoDDPM", AnoDDPM(sched), lambda det, x, g:
             det.reconstruction_error(x, score, 30, 100, spatial_dims=3,
                                      generator=g), 70),
            ("DDAD", DDAD(sched), lambda det, x, g:
             det.reconstruction_error(x, score, 30, 100, w=w, spatial_dims=3,
                                      generator=g), 99 + 2 * 70 - 1))
    counts = []
    for label, det, run, nfe in arms:
        kernels.reset_launches()
        errs, secs = [], []
        with torch.inference_mode():
            for x in (clean, corrupt):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                errs.append(run(det, x, torch.Generator("cuda")
                                .manual_seed(4)))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        c = dict(kernels.LAUNCHES)
        expected = dict(zero, fused_axby=2 * nfe, norm_silu=56 * nfe)
        ok = c == expected and all(bool(torch.isfinite(e).all())
                                   for e in errs)
        log(f"[{label} config B] {card}: 64 images, step 30 of 100"
            f"{f', w {w:.4f}' if label == 'DDAD' else ''}: reconstruction "
            f"error clean {float(errs[0].mean()):.3f}, corrupted "
            f"{float(errs[1].mean()):.3f} (mean over images); "
            f"{secs[0]:.3f} s and {secs[1]:.3f} s eager; launches {c}, "
            f"expected {expected} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"phase 19: {label} launches or errors")
        counts.append(c)

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = model.interpolate_images(clean[0], clean[1], 8, nsteps=NSTEPS,
                                    generator=torch.Generator("cuda"))
    torch.cuda.synchronize()
    interp_s = time.perf_counter() - t0
    c_interp = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = model.sample_and_filter(
        128, (28, 28, 1),
        lambda enc: (lambda v: v > v.median())(enc.std(dim=(1, 2, 3))),
        torch.Generator("cuda").manual_seed(6), nsteps=NSTEPS,
        maximum_batch_size=64)
    torch.cuda.synchronize()
    filter_s = time.perf_counter() - t0
    c_filter = dict(kernels.LAUNCHES)
    calls = (2 * (NSTEPS - 1)) + NFE
    ok = (path.shape == (10, 28, 28, 1) and bool(torch.isfinite(path).all())
          and res["samples"].shape == (128, 28, 28, 1)
          and c_interp == dict(zero, fused_axby=calls, norm_silu=28 * calls)
          and c_filter == dict(zero, fused_axby=2 * NFE,
                               norm_silu=56 * NFE))
    log(f"[features config B] {card}: interpolate_images (8 inner points, "
        f"{NSTEPS} steps each way, eager) {interp_s:.3f} s, launches "
        f"{c_interp}; sample_and_filter 128 in chunks of 64 (graphed; "
        f"kept: a per-image std above its chunk's median) "
        f"{filter_s:.3f} s, hit rate {res['hit_rate']:.3f}, launches "
        f"{c_filter} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 19: interpolation or filtering gave a "
                             "wrong shape, value or launch count")
    return counts + [c_interp, c_filter]


def profiled_request(served, zero, card, tmp, cli) -> dict:
    """One served request of 64 under torch.profiler, its Chrome trace read
    back by ``python -m diffsci_tpu_torch profile``: K1's and K2's rows
    count what the launch counter counts; the busy fraction printed.

    The tracer drops device records now and then, K2's among them
    (scripts/torch_profile_completeness.py counts how often), so the
    request is traced again until two traces hold the same number of
    kernels. Every trace replays the same graph, so that number is the
    request's, and the last of the two is the one held to the counter."""
    from torch.profiler import ProfilerActivity, profile

    from diffsci_tpu_torch import SamplerService, kernels, profiling

    svc = SamplerService(served, (28, 28, 1), batch_buckets=(64,))
    svc.warmup()
    svc.sample(64, 1)
    trace_dir = tmp / "trace"
    trace_dir.mkdir()
    path = trace_dir / "serve.pt.trace.json"
    totals = []
    for _ in range(6):
        kernels.reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            svc.sample(64, 2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        c = dict(kernels.LAUNCHES)
        prof.export_chrome_trace(str(path))
        rows = profiling.op_summary(profiling.parse_trace(str(path)), "cuda",
                                    line=profiling.KERNEL)
        total = sum(r["count"] for r in rows)
        if total and total in totals:
            break
        totals.append(total)
    else:
        raise AssertionError(f"phase 19: no two of six traces of one "
                             f"request held the same number of kernels: "
                             f"{totals}")
    k1 = sum(r["count"] for r in rows if "axby_kernel" in r["name"])
    k2 = sum(r["count"] for r in rows
             if any(n in r["name"] for n in NORM_KERNELS["K2"]))
    text, secs = cli("profile", trace_dir, "--top", 100)
    busy = profiling.device_busy_fraction(profiling.parse_trace(str(path)))
    ok = (k1 == c["fused_axby"] == NFE and k2 == c["norm_silu"]
          and "axby_kernel" in text and "busy fraction (cuda)" in text)
    log(f"[profile config B] {card}: one request of 64 under torch.profiler"
        f" in {wall:.4f} s; `python -m diffsci_tpu_torch profile` "
        f"({secs:.1f} s): K1 rows {k1}, K2 rows {k2}, launch counter "
        f"{c['fused_axby']}, {c['norm_silu']}; busy fraction {busy:.3f} "
        f"(kernels a trace {totals + [total]}) {'ok' if ok else 'FAIL'}")
    for line in text.strip().splitlines()[:16]:
        log(f"[profile config B]   {line}")
    if not ok:
        raise AssertionError("phase 19: the profile's kernel rows differ "
                             "from the launch counter")
    return c


def phase_serving_card_vs_cpu():
    """Phase 2's small net (3D 32³, flash), f32, on the CPU (plain, eager)
    and the card (kernels, graphed) from the same weights and the card's
    draws: Picard at tol 0 and 1e-3 and stochastic (4 steps, window 2);
    the dispatcher's per-row isolation on the card and its rows against
    the CPU; AnoDDPM with replayed draws; three schedule-free and three
    bf16-moment train steps at phase 3's tolerances. Returns the launch
    counts."""
    from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                                   SamplerService, default_optimizer,
                                   kernels, schedule_free_optimizer)
    from diffsci_tpu_torch.features import AnoDDPM
    from diffsci_tpu_torch.ops import parallel_sampling as ps
    from diffsci_tpu_torch.serving import row_seeds

    cfg = small_3d_config()
    cpu = KarrasModel(PUNetG(cfg, device="cpu"), KarrasModelConfig.from_edm(),
                      device="cpu")
    gpu = KarrasModel(PUNetG(cfg), KarrasModelConfig.from_edm())
    gpu.net.load_state_dict(cpu.init(seed=1), strict=True)
    shape = (32, 32, 32, 1)
    counts = []
    log(f"[phase 20] card against CPU on {smi('name,power.limit')}")
    kernels.reset_launches()
    cpu64 = KarrasModel(PUNetG(cfg, device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    cpu64.net.load_state_dict(cpu.net.state_dict(), strict=True)
    cpu64.net.double()

    def cpu_picard(model, x, noise, tol, stochastic, dtype):
        x = x.cpu().to(dtype)
        return ps.picard_window_sample(
            model.config.noisescheduler, x * 80.0,
            model._score(None, 1.0, x), nsteps=4, window=2, tol=tol,
            stochastic=stochastic,
            noise_seq=None if noise is None else noise.cpu().to(dtype),
            return_sweeps=True)

    for tol, stochastic in ((0.0, False), (1e-3, False), (1e-3, True)):
        out, sweeps = gpu.sample_parallel(
            1, shape, torch.Generator("cuda").manual_seed(3), nsteps=4,
            window=2, tol=tol, stochastic=stochastic, return_sweeps=True)
        x, noise = replayed_draws(4 if stochastic else 0, (1,) + shape, 3)
        with torch.inference_mode():
            ref, ref_sweeps = cpu_picard(cpu, x, noise, tol, stochastic,
                                         torch.float32)
        if stochastic:
            # Euler–Maruyama's σ-sized injections make the 4-step loop
            # ill-conditioned: held to the float64 loop, as phase 11 holds
            # VP and VE
            with torch.inference_mode():
                ref64, _ = cpu_picard(cpu64, x, noise, tol, stochastic,
                                      torch.float64)
            err, own, ok = within_float64(out.cpu(), ref, ref64)
            what = (f"against the float64 loop: card {err:.3e}, cpu float32 "
                    f"{own:.3e} (phase 11's tolerance)")
        else:
            err, ok = within_phase2(out.cpu(), ref)
            what = f"max|card - cpu| {err:.3e} (phase 2's tolerance)"
        ok = ok and (sweeps == ref_sweeps == 4 if tol == 0 else
                     abs(sweeps - ref_sweeps) <= 1)
        log(f"[picard card-vs-cpu] tol {tol} "
            f"{'Euler–Maruyama' if stochastic else 'pf-ODE'}: sweeps card "
            f"{sweeps} cpu {ref_sweeps}, {what} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 20: Picard on the card and the CPU "
                                 "disagree")
    counts.append(dict(kernels.LAUNCHES))

    svc = SamplerService(gpu, shape, batch_buckets=(2,), nsteps=3,
                         batch_window_ms=20.0)
    svc.warmup()
    kernels.reset_launches()
    alone = svc.sample(1, 5)
    other = threading_sample(svc, 1, 6)
    crowded = svc.sample(1, 5)
    other.join()
    svc.close()
    counts.append(dict(kernels.LAUNCHES))
    x = torch.randn((1,) + shape, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(row_seeds(5, 1)[0]))
    ref = cpu.propagate_white_noise(x.cpu(), nsteps=3)
    err, ok = within_phase2(torch.from_numpy(crowded), ref)
    ok = ok and np.array_equal(alone, crowded)
    log(f"[dispatcher card-vs-cpu] a request alone and crowded in bucket 2: "
        f"bit for bit {np.array_equal(alone, crowded)}; against the CPU on "
        f"its row's draw max|Δ| {err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 20: dispatcher isolation or card against "
                             "CPU failed")

    gen = torch.Generator("cuda").manual_seed(8)
    x0 = torch.randn((1,) + shape, device="cuda", generator=gen)
    eps = torch.randn((1,) + shape, device="cuda", generator=gen)
    seq = torch.randn((3, 1) + shape, device="cuda", generator=gen)
    kernels.reset_launches()
    outs = []
    for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
        with torch.inference_mode():
            outs.append(AnoDDPM(model.config.noisescheduler).reconstruct(
                x0.to(dev), model.get_score, 3, 6, apply_eps=eps.to(dev),
                noise_seq=seq.to(dev)).cpu())
    counts.append(dict(kernels.LAUNCHES))
    err, ok = within_phase2(*outs)
    log(f"[AnoDDPM card-vs-cpu] step 3 of 6, draws replayed: max|card - "
        f"cpu| {err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 20: AnoDDPM on the card and the CPU "
                             "disagree")

    def make_model(dev):
        return KarrasModel(PUNetG(cfg, device=dev),
                           KarrasModelConfig.from_edm(), device=dev)

    def sigma_draw(rng):
        return np.exp(rng.standard_normal(2) * 1.2 - 1.2).astype(np.float32)

    for label, make_tx in (
            ("schedule-free", lambda lr: schedule_free_optimizer(lr)),
            ("bf16 moment", lambda lr: default_optimizer(
                lr, mu_dtype=torch.bfloat16))):
        kernels.reset_launches()
        train_card_vs_cpu(f"{label} 3D 32^3 mc=8 flash", make_model,
                          (2, 32, 32, 32, 1), sigma_draw, TRAIN,
                          make_tx=make_tx)
        counts.append(dict(kernels.LAUNCHES))
    return counts


# ---------------------------------------------------------------------------
# phases 21 to 23: ensemble/CRPS forecasting, latent diffusion
# ---------------------------------------------------------------------------
F_STEPS = 18               # the in-step sampler's Heun steps (35 calls)
F_HORIZONS = 2
F_MEMBERS = 4
G_PIX = 256                # G's fields: 256² × 1 -> 32² × 4 latents


def busy_seconds(fn) -> tuple[float, float]:
    """(wall seconds, device kernel seconds) of one call of ``fn`` under
    torch.profiler (``profiled_shares``)."""
    return profiled_shares(fn)[:2]


def params_within(ours: dict, ref: dict, lr: float, k: int) -> tuple:
    """Phase 3's bound on parameters after k steps: 99.9 % of entries
    within 0.05·lr, every entry within 2·k·lr. Returns (ok, q999,
    worst)."""
    diff = np.concatenate([(ours[n].detach().float().cpu()
                            - ref[n].detach().float().cpu())
                           .abs().flatten().numpy() for n in ref])
    q999, worst = float(np.quantile(diff, 0.999)), float(diff.max())
    return q999 <= 0.05 * lr and worst <= 2 * k * lr, q999, worst


def small_forecaster(dev, dtype=None, **ens_kw):
    """Phase 2's small 3D net as a forecaster: PUNetGCond over x (1
    channel) and a window of 2 frames, EDM with CRPS, 2 horizons, a
    3-step in-step sampler."""
    from diffsci_tpu_torch import KarrasModelConfig, PUNetGCond
    from diffsci_tpu_torch.models.karras import ensemble as ens

    net = PUNetGCond(dataclasses.replace(small_3d_config(), input_channels=3,
                                         output_channels=1),
                     channel_conditional_items=["y"], device=dev)
    cfg = ens.EnsembleKarrasModelConfig.from_karras_config(
        KarrasModelConfig.from_edm(loss_metric="crps",
                                   autoregressive_loss_steps=F_HORIZONS,
                                   autoregressive_loss_diffusion_steps=3),
        **ens_kw)
    return ens.EnsembleKarrasModel(net, cfg, conditional=True,
                                   compute_dtype=dtype, device=dev)


def small_latent(dev, bound, ens_model=False):
    """Phase 2's small 3D net in the latent space of a small 3D
    autoencoder (32³ × 1 -> 16³ × 2): a KarrasModel, or with
    ``ens_model`` a conditional EnsembleKarrasModel over a 2-frame
    window."""
    from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                                   PUNetGCond)
    from diffsci_tpu_torch.models.karras import ensemble as ens

    if ens_model:
        net = PUNetGCond(dataclasses.replace(small_3d_config(),
                                             input_channels=6,
                                             output_channels=2),
                         channel_conditional_items=["y"], device=dev)
        return ens.EnsembleKarrasModel(
            net, ens.EnsembleKarrasModelConfig.from_edm(), conditional=True,
            autoencoder=bound, device=dev)
    net = PUNetG(dataclasses.replace(small_3d_config(), input_channels=2,
                                     output_channels=2), device=dev)
    return KarrasModel(net, KarrasModelConfig.from_edm(), autoencoder=bound,
                       device=dev)


def small_bound(dev, weights=None):
    """A small 3D AutoencoderKL (ch 8, two levels, mid attention), bound
    in f32; returns (bound, its weights)."""
    from diffsci_tpu_torch.models.nets.vae import AutoencoderKL, DDConfig
    from diffsci_tpu_torch.models.vae import (BoundAutoencoder, VAEModel,
                                              VAEModelConfig)

    dd = DDConfig(z_channels=2, resolution=32, ch=8, ch_mult=(1, 2),
                  num_res_blocks=1, dimension=3)
    vm = VAEModel(AutoencoderKL(dd, 2, device=dev), VAEModelConfig(),
                  device=dev)
    if weights is None:
        weights = {k: v.clone() for k, v in vm.init(seed=5).items()}
    else:
        vm.net.load_state_dict(weights, strict=True)
    return BoundAutoencoder(vm, scale_factor=0.8), weights


def replay_x_T(model, draws):
    """Make ``model``'s samplers take their x_T from ``draws`` in turn
    (the card's draws replayed on the CPU)."""
    it = iter(draws)

    def draw(inputs, generator, langevin_scale):
        inputs[0].copy_(next(it))
        return inputs

    model._draw_inputs = draw


def phase_forecast_card_vs_cpu(zero):
    """Phase 21: the ensemble, autoregressive and latent paths on phase
    2's small net, card against the port's own CPU run in f32, TF32 off,
    at phases 2 and 3's tolerances."""
    from diffsci_tpu_torch import (create_train_state, default_optimizer,
                                   kernels)
    from diffsci_tpu_torch.models.karras import ensemble as ens
    from diffsci_tpu_torch.models.karras.autoregressive import \
        autoregressive_sample

    t_start = time.perf_counter()
    shape, B, lr = (2, 32, 32, 32, 1), 2, 1e-3
    gen = torch.Generator("cuda").manual_seed(21)
    x = torch.randn((B, 32, 32, 32, F_HORIZONS), generator=gen,
                    device="cuda")
    y = {"y": torch.randn((B, 2, 32, 32, 32), generator=gen, device="cuda")}
    mask = (torch.rand(x.shape[:-1] + (1,), generator=gen, device="cuda")
            < 0.25).float()
    card = small_forecaster("cuda", ensemble_size_train=3)
    cpu = small_forecaster("cpu", ensemble_size_train=3)
    weights = {k: v.clone() for k, v in card.init(seed=2).items()}
    cpu.net.load_state_dict(weights, strict=True)
    counts = dict(zero)

    def to_cpu(t):
        return None if t is None else t.cpu()

    # the CRPS ensemble loss, E = 3, masked and not
    sigma = card.config.noisesampler.sample((B,), gen)
    eps = torch.randn((B, 3) + shape[1:], generator=gen, device="cuda")
    for m in (None, mask):
        with torch.no_grad():
            ours = card.loss_fn(x[..., :1], sigma, y, m, train=False,
                                n_ensemble=3, eps=eps)
            ref = cpu.loss_fn(x[..., :1].cpu(), sigma.cpu(),
                              {"y": y["y"].cpu()}, to_cpu(m), train=False,
                              n_ensemble=3, eps=eps.cpu())
        ok = bool(torch.isclose(ours.cpu(), ref, rtol=1e-3, atol=0))
        log(f"[forecast card-vs-cpu] CRPS E=3 {'masked' if m is not None else 'plain'}"
            f": card {float(ours):.6f} cpu {float(ref):.6f} (rtol 1e-3) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("CRPS ensemble loss: card and CPU differ")

    # the 2-horizon AR loss with its 3-step in-step sampler, replayed
    draws = card.draw_autoregressive(card.draw_tensors(x, 3), gen)
    cpu_draws = {k: to_cpu(v) for k, v in draws.items()}
    with torch.no_grad():
        ours, _, hs = card.autoregressive_loss_fn(
            x, y, mask, train=False, n_ensemble=3, draws=draws)
        ref, _, hs_ref = cpu.autoregressive_loss_fn(
            x.cpu(), {"y": y["y"].cpu()}, mask.cpu(), train=False,
            n_ensemble=3, draws=cpu_draws)
    ok = all(bool(torch.isclose(a.cpu(), b, rtol=1e-3, atol=0))
             for a, b in zip(hs + [ours], hs_ref + [ref]))
    log(f"[forecast card-vs-cpu] AR loss, 2 horizons, 3-step in-step "
        f"sampler: card {[round(float(v), 6) for v in hs]} cpu "
        f"{[round(float(v), 6) for v in hs_ref]} (rtol 1e-3) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("AR loss: card and CPU differ")

    # two graphed ensemble train steps (a warm-up, then the graph's
    # replay) against the CPU's eager ones
    step_draws = [card.draw_autoregressive(card.draw_tensors(x, 3), gen)
                  for _ in range(2)]
    runs = {}
    for arm, model in (("cpu", cpu), ("card", card)):
        dev = model.device
        model.net.load_state_dict(weights, strict=True)
        state, tx = create_train_state(model, (B,) + shape[1:-1] + (3,),
                                       seed=None,
                                       optimizer=default_optimizer(lr))
        step = ens.make_ensemble_train_step(model, tx)
        kernels.reset_launches()
        mets = []
        for d in step_draws:
            if arm == "cpu":
                d = {k: to_cpu(v) for k, v in d.items()}
            state, met = step(state, x.to(dev), {"y": y["y"].to(dev)},
                              mask.to(dev), draws=d)
            mets.append([float(met[n]) for n in (
                "train_loss", "ar_loss_horizon_1", "ar_loss_horizon_2")])
        runs[arm] = (mets, state, dict(kernels.LAUNCHES))
    (m_cpu, s_cpu, _), (m_card, s_card, c_step) = runs["cpu"], runs["card"]
    ok_p, q999, worst = params_within(s_card.params, s_cpu.params, lr,
                                      len(step_draws))
    ok = ok_p and np.allclose(m_card, m_cpu, rtol=1e-3, atol=0)
    graphs_n = len(s_card.graphs.graphs)
    log(f"[forecast card-vs-cpu] {len(step_draws)} graphed ensemble steps "
        f"(CRPS E=3, 2 "
        f"horizons): (loss, h1, h2) card {np.round(m_card, 6).tolist()} "
        f"cpu {np.round(m_cpu, 6).tolist()} (rtol 1e-3); params 99.9% "
        f"{q999:.3e}, max {worst:.3e} (limits {0.05 * lr:.0e}, "
        f"{2 * len(step_draws) * lr:.0e}); {graphs_n} graph(s); launches "
        f"{c_step} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok or min(c_step[k] for k in ("fused_axby", "norm_silu",
                                         "norm_silu_bwd")) == 0:
        raise AssertionError("ensemble train step: card and CPU differ, or "
                             "a kernel was not launched")
    counts = {k: counts[k] + c_step[k] for k in counts}

    # a small AutoencoderKL's encode and decode, a latent loss and sample
    bound_card, ae_w = small_bound("cuda")
    bound_cpu, _ = small_bound("cpu", ae_w)
    pix = torch.randn((2, 1, 32, 32, 32), generator=gen, device="cuda")
    with torch.no_grad():
        z = bound_card.encode(pix)
        z_ref = bound_cpu.encode(pix.cpu())
        dec = bound_card.decode(z)
        dec_ref = bound_cpu.decode(z_ref)
    err_z, ok_z = within_phase2(z.cpu(), z_ref)
    err_d, ok_d = within_phase2(dec.cpu(), dec_ref)
    log(f"[forecast card-vs-cpu] AutoencoderKL 3D 32^3 -> {tuple(z.shape)}"
        f": encode |card - cpu| {err_z:.3e}, decode {err_d:.3e} (rtol "
        f"1e-3, atol 1e-3) {'ok' if ok_z and ok_d else 'FAIL'}")
    if not (ok_z and ok_d):
        raise AssertionError("AutoencoderKL: card and CPU differ")
    lat = {"cpu": small_latent("cpu", bound_cpu),
           "card": small_latent("cuda", bound_card)}
    for m in lat.values():
        m.init(seed=6)
    x_pix = pix.movedim(1, -1)
    sig = card.config.noisesampler.sample((2,), gen)
    e = torch.randn((2, 16, 16, 16, 2), generator=gen, device="cuda")
    zq = torch.randn((2, 16, 16, 16, 2), generator=gen, device="cuda")
    with torch.no_grad():
        ours = lat["card"].loss_fn(x_pix, sig, train=False, eps=e, z_eps=zq)
        ref = lat["cpu"].loss_fn(x_pix.cpu(), sig.cpu(), train=False,
                                 eps=e.cpu(), z_eps=zq.cpu())
    ok = bool(torch.isclose(ours.cpu(), ref, rtol=1e-3, atol=0))
    x_T = torch.randn((2, 16, 16, 16, 2), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(3))
    lat["card"].compile_sampler(2, (32, 32, 32, 1), nsteps=3)
    kernels.reset_launches()
    out = lat["card"].sample(2, (32, 32, 32, 1),
                             torch.Generator("cuda").manual_seed(3),
                             nsteps=3).cpu()
    c_lat = dict(kernels.LAUNCHES)
    with torch.no_grad():
        ref_s = lat["cpu"].propagate_white_noise(x_T.cpu(), nsteps=3)
    err, ok_s = within_phase2(out, ref_s)
    log(f"[forecast card-vs-cpu] latent loss card {float(ours):.6f} cpu "
        f"{float(ref):.6f} (rtol 1e-3); latent sample (graphed, decoded "
        f"{tuple(out.shape)}) |card - cpu| {err:.3e} (phase 2's "
        f"tolerance); launches {c_lat} {'ok' if ok and ok_s else 'FAIL'}")
    if not (ok and ok_s) or c_lat["fused_axby"] != 5:
        raise AssertionError("latent loss or sample: card and CPU differ")
    counts = {k: counts[k] + c_lat[k] for k in counts}

    # a 2-step autoregressive_sample, x_T replayed into the CPU's run
    roll = {"cpu": small_latent("cpu", bound_cpu, ens_model=True),
            "card": small_latent("cuda", bound_card, ens_model=True)}
    for m in roll.values():
        m.init(seed=7)
    window = torch.randn((4, 16, 16, 16), generator=gen, device="cuda")
    g = torch.Generator("cuda").manual_seed(8)
    x_Ts = [torch.randn((2, 16, 16, 16, 2), generator=g, device="cuda")
            .cpu() for _ in range(2)]
    replay_x_T(roll["cpu"], x_Ts)
    roll["card"].compile_sampler(
        2, (16, 16, 16, 2), {"y": window[None].expand((2,) + window.shape)},
        nsteps=3, is_latent_shape=True, return_in_latent_space=True)
    kernels.reset_launches()
    out = autoregressive_sample(roll["card"], 2, (16, 16, 16, 2), 2, 2,
                                nsteps_diffusion=3, y={"y": window},
                                y_already_encoded=True,
                                return_intermediate=True,
                                generator=torch.Generator("cuda")
                                .manual_seed(8))
    c_ar = dict(kernels.LAUNCHES)
    ref = autoregressive_sample(roll["cpu"], 2, (16, 16, 16, 2), 2, 2,
                                nsteps_diffusion=3, y={"y": window.cpu()},
                                y_already_encoded=True,
                                return_intermediate=True)
    err_l, ok_l = within_phase2(out["intermediate_latent"].cpu(),
                                ref["intermediate_latent"])
    err_p, ok_p = within_phase2(out["forecasts"].cpu(), ref["forecasts"])
    log(f"[forecast card-vs-cpu] autoregressive_sample, 2 steps of 3: "
        f"latents |card - cpu| {err_l:.3e}, decoded "
        f"{tuple(out['forecasts'].shape)} {err_p:.3e} (phase 2's "
        f"tolerance); launches {c_ar}; phase {time.perf_counter() - t_start:.1f} s "
        f"{'ok' if ok_l and ok_p else 'FAIL'}")
    if not (ok_l and ok_p) or c_ar["fused_axby"] != 10:
        raise AssertionError("autoregressive_sample: card and CPU differ")
    return [counts, c_ar]


def model_f(dev="cuda"):
    """Configuration F: PUNetGCond at B's widths over 4 latent channels
    and a 2-frame window (12 in, 4 out, plain attention), EDM, CRPS over
    4 members, 2 horizons, an 18-step Heun in-step sampler, bf16 over f32
    masters."""
    from diffsci_tpu_torch import KarrasModelConfig, PUNetGConfig, PUNetGCond
    from diffsci_tpu_torch.models.karras import ensemble as ens

    net = PUNetGCond(PUNetGConfig(model_channels=64,
                                  channel_expansion=[2, 4],
                                  input_channels=12, output_channels=4,
                                  attn_backend="xla"),
                     channel_conditional_items=["y"], device=dev)
    cfg = ens.EnsembleKarrasModelConfig.from_karras_config(
        KarrasModelConfig.from_edm(
            loss_metric="crps", autoregressive_loss_steps=F_HORIZONS,
            autoregressive_loss_diffusion_steps=F_STEPS),
        ensemble_size_train=F_MEMBERS)
    return ens.EnsembleKarrasModel(net, cfg, conditional=True,
                                   compute_dtype=torch.bfloat16, device=dev)


def phase_forecaster(zero, steps=20, warmup=3):
    """Phase 22: F trained at full width through the graphed
    ``make_ensemble_train_step``: s/step, items/s, peak memory, capture
    seconds, idle share, the in-step sampler's share of the step's device
    time, exact launches, a falling loss, the graphed step against its
    eager body."""
    from diffsci_tpu_torch import (EMATracker, create_train_state,
                                   default_optimizer, kernels)
    from diffsci_tpu_torch.models.karras import ensemble as ens

    B = 8
    model = model_f()
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05],
                         update_every=4)
    x_shape = (B, 32, 32, 4 * F_HORIZONS)
    state, tx = create_train_state(model, x_shape, seed=0, ema=tracker)
    weights = {k: v.detach().clone() for k, v in state.params.items()}
    step = ens.make_ensemble_train_step(model, tx, ema=tracker)
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(x_shape, generator=gen, device="cuda")
    y = {"y": torch.randn((B, 8, 32, 32), generator=gen, device="cuda")}
    probe = model.draw_autoregressive(model.draw_tensors(x, F_MEMBERS), gen)

    def probe_loss():
        with torch.no_grad():
            return float(model.autoregressive_loss_fn(
                x, y, train=False, n_ensemble=F_MEMBERS, draws=probe)[0])

    before = probe_loss()
    t0 = time.perf_counter()
    for _ in range(warmup):
        step(state, x, y, generator=gen)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    captures = [round(g.capture_seconds, 3)
                for g in state.graphs.graphs.values()]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    kernels.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        met = step(state, x, y, generator=gen)[1]
        losses.append(met["train_loss"])
    last = float(met["train_loss"])                       # the sync
    dt = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = probe_loss()
    losses = [float(v) for v in losses]
    # a network call is 28 K2 (14 blocks); a step is the 2 horizons'
    # forward and backward (56 K2, 56 K3) and 35 network calls and 35
    # combines (K1) of the in-step sampler
    per_step = dict(zero, fused_axby=2 * F_STEPS - 1,
                    norm_silu=28 * (F_HORIZONS + 2 * F_STEPS - 1),
                    norm_silu_bwd=28 * F_HORIZONS)
    expected = {k: n * steps for k, n in per_step.items()}
    log(f"[F] {sum(p.numel() for p in state.params.values())} parameters, "
        f"x {x_shape}, window {tuple(y['y'].shape)}, E {F_MEMBERS} (denoiser "
        f"batch {B * F_MEMBERS}), {F_HORIZONS} horizons, {F_STEPS}-step Heun "
        f"in-step sampler: warm-up {warmup} steps {warm_s:.2f} s, capture "
        f"seconds (step, EMA) {captures}")
    log(f"[F] {steps} graphed steps in {dt:.4f} s: {dt / steps:.4f} s/step, "
        f"{B * steps / dt:.2f} items/s; peak memory {peak:.3f} GiB "
        f"({peak - base:.3f} GiB above the {base:.3f} GiB held before the "
        f"steps); loss "
        f"first {losses[0]:.5f} last {last:.5f}; fixed-draw loss "
        f"{before:.5f} before, {after:.5f} after; launches {counts}, a step "
        f"{per_step}")
    if not (np.isfinite(losses).all() and after < before):
        raise AssertionError("F: non-finite loss, or the loss did not fall")
    if counts != expected:
        raise AssertionError(f"F: launch counts {counts}, expected "
                             f"{expected}")

    # the idle share of a graphed step, and the in-step sampler's share of
    # its device time: the same sample (8 items, the window, 18 Heun steps,
    # bf16) replayed as the model's own sampler graph
    wall, busy = busy_seconds(lambda: step(state, x, y, generator=gen))
    sample_shape = (32, 32, 4)
    model.compile_sampler(B, sample_shape, y, nsteps=F_STEPS)
    wall_s, busy_s = busy_seconds(lambda: model.sample(
        B, sample_shape, gen, y=y, nsteps=F_STEPS))
    log(f"[F] profiled graphed step: wall {wall:.4f} s, device {busy:.4f} s, "
        f"idle share {1 - busy / wall:.3f}; the in-step sampler alone "
        f"(graphed sample of {B}): device {busy_s:.4f} s = "
        f"{busy_s / busy:.1%} of the step's device time")

    # the graphed step against its eager body: three steps each from the
    # same weights and generator (the graphed arm's first is its warm-up)
    arms = {}
    for arm in ("eager", "graphed"):
        with torch.no_grad():
            for k, v in state.params.items():
                v.copy_(weights[k])
        st, tx2 = create_train_state(model, x_shape, seed=None)
        fn = ens.make_ensemble_train_step(model, tx2, _raw=arm == "eager")
        g2 = torch.Generator("cuda").manual_seed(22)
        mets = [float(fn(st, x, y, generator=g2)[1]["train_loss"])
                for _ in range(3)]
        arms[arm] = (mets, {k: v.detach().clone()
                            for k, v in st.params.items()})
    (m_e, p_e), (m_g, p_g) = arms["eager"], arms["graphed"]
    same = all(torch.equal(p_e[k], p_g[k]) for k in p_e) and m_e == m_g
    ok_p, q999, worst = params_within(p_g, p_e, 1e-3, 3)
    ok = ok_p and np.allclose(m_g, m_e, rtol=1e-3, atol=0)
    log(f"[F] graphed against eager, 3 steps from one seed: losses "
        f"{m_g} / {m_e}; params 99.9% {q999:.3e}, max {worst:.3e} (phase "
        f"3's limits); bit for bit {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("F: the graphed step differs from its eager "
                             "body")
    return counts, model


def bound_g():
    """G's autoencoder: ``AutoencoderKL(DDConfig(), embed_dim=4)`` (256² ×
    1 fields to 32² × 4 latents), random weights from seed 0, bound in
    f32."""
    from diffsci_tpu_torch.models.nets.vae import AutoencoderKL, DDConfig
    from diffsci_tpu_torch.models.vae import (BoundAutoencoder, VAEModel,
                                              VAEModelConfig)

    vm = VAEModel(AutoencoderKL(DDConfig(resolution=G_PIX), embed_dim=4),
                  VAEModelConfig())
    vm.init(seed=0)
    return BoundAutoencoder(vm)


def phase_latent(zero, f_model):
    """Phase 23: G. F's network as a latent EnsembleKarrasModel rolls out
    3 forecast steps of 8 samples from a 2-frame 256² window encoded once,
    and decodes the 24 latents in one call: wall, device time of encoder,
    sampler and decoder, exact launches, each step's graph replay against
    its eager body. Then a latent PUNetG at B's widths trains on 256²
    pixels through the graphed ``make_train_step``, the encoder inside
    the step's graph."""
    from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                                   PUNetGConfig, kernels,
                                   karras_model_from_description)
    from diffsci_tpu_torch.models.karras import ensemble as ens
    from diffsci_tpu_torch.models.karras.autoregressive import (
        autoregressive_sample, frames_to_window, window_to_frames)

    bound = bound_g()
    nae = sum(p.numel() for p in bound.model.net.parameters())
    roll = ens.EnsembleKarrasModel(f_model.net.model, f_model.config,
                                   conditional=True, autoencoder=bound,
                                   compute_dtype=torch.bfloat16)
    n, nf, lat_shape = 8, 3, (G_PIX // 8, G_PIX // 8, 4)
    gen = torch.Generator("cuda").manual_seed(23)
    frames = torch.randn((2, 1, G_PIX, G_PIX), generator=gen,
                         device="cuda")

    def encode():
        return frames_to_window(bound.encode(frames))       # [8, 32, 32]

    def rollout(window, seed, latent=False):
        return autoregressive_sample(
            roll, n, lat_shape, nf, 2, nsteps_diffusion=F_STEPS,
            y={"y": window}, y_already_encoded=True,
            return_intermediate=True, return_in_latent=latent,
            generator=torch.Generator("cuda").manual_seed(seed))

    t0 = time.perf_counter()
    rollout(encode(), 1)                  # the warm-up captures the graph
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    window = encode()
    out = rollout(window, 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    expected = dict(zero, fused_axby=nf * (2 * F_STEPS - 1),
                    norm_silu=28 * nf * (2 * F_STEPS - 1))
    fc = out["forecasts"]
    log(f"[G] AutoencoderKL {nae} parameters; rollout of {nf} steps x {n} "
        f"samples, {F_STEPS} Heun steps each: warm-up {warm:.2f} s, wall "
        f"{wall:.4f} s (encode, 3 graphed samples, one decode of "
        f"{nf * n} latents); forecasts {tuple(fc.shape)}; launches {counts}")
    if tuple(fc.shape) != (nf, n, G_PIX, G_PIX, 1) or \
            not bool(torch.isfinite(fc).all()):
        raise AssertionError(f"G: forecasts {tuple(fc.shape)} or non-finite")
    if counts != expected:
        raise AssertionError(f"G: launch counts {counts}, expected "
                             f"{expected}")
    lat = out["intermediate_latent"]
    _, t_enc = busy_seconds(encode)
    _, t_smp = busy_seconds(lambda: rollout(window, 2, latent=True))

    def decode():
        with torch.inference_mode():
            roll.decode(lat.reshape((nf * n,) + lat_shape))

    _, t_dec = busy_seconds(decode)
    total = t_enc + t_smp + t_dec
    log(f"[G] rollout device time: encoder {t_enc:.4f} s ({t_enc / total:.1%}"
        f"), sampler {t_smp:.4f} s ({t_smp / total:.1%}), decoder "
        f"{t_dec:.4f} s ({t_dec / total:.1%}) of {total:.4f} s")

    # each forecast step's replay against its eager body, bit for bit
    g3 = torch.Generator("cuda").manual_seed(2)
    frames_lat, y_win, same = window_to_frames(window, 2), window, []
    for k in range(nf):
        x_T = torch.randn((n,) + lat_shape, generator=g3, device="cuda")
        yb = {"y": y_win[None].expand((n,) + tuple(y_win.shape))}
        with torch.inference_mode():
            eager = roll.propagate_white_noise(x_T, yb, nsteps=F_STEPS,
                                               return_in_latent_space=True)
        same.append(bool(torch.equal(eager, lat[k])))
        frames_lat = torch.cat([frames_lat[1:],
                                lat[k][0].movedim(-1, 0)[None]])
        y_win = frames_to_window(frames_lat)
    log(f"[G] each forecast step's graph replay bit for bit its eager "
        f"body: {same}")
    if not all(same):
        raise AssertionError("G: a forecast step's replay differs from its "
                             "eager body")

    # latent training: B's widths over the 4 latent channels, 8 fields of
    # 256² a batch, the encoder (and its posterior draw) in the step
    model = KarrasModel(PUNetG(PUNetGConfig(model_channels=64,
                                            channel_expansion=[2, 4],
                                            input_channels=4,
                                            output_channels=4)),
                        KarrasModelConfig.from_edm(), autoencoder=bound,
                        compute_dtype=torch.bfloat16)
    c_train, _, _ = train("config G latent", None, (8, G_PIX, G_PIX, 1), 20,
                          dict(zero, norm_silu=28, norm_silu_bwd=28),
                          model=model)

    # the trained latent model rebuilt from its description with the
    # bound autoencoder passed in: the same decoded samples from one seed
    desc = model.export_description()
    rebuilt = karras_model_from_description(desc, autoencoder=bound,
                                            compute_dtype=torch.bfloat16)
    rebuilt.net.load_state_dict(model.net.state_dict(), strict=True)
    shape = (G_PIX, G_PIX, 1)
    kernels.reset_launches()
    a, b = (m.sample(2, shape, torch.Generator("cuda").manual_seed(5),
                     nsteps=6) for m in (model, rebuilt))
    c_desc = dict(kernels.LAUNCHES)
    err, ok = within_phase2(b.float().cpu(), a.float().cpu())
    log(f"[G] latent model rebuilt from its description (autoencoder "
        f"{desc['autoencoder']}): 6-step samples {tuple(a.shape)} |Δ| "
        f"{err:.3e} (phase 2's tolerance), bit for bit "
        f"{bool(torch.equal(a, b))}; launches {c_desc} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok or desc["autoencoder"] is not True or \
            tuple(a.shape) != (2,) + shape:
        raise AssertionError("G: the model rebuilt from its description "
                             "samples differently")
    return [counts, c_train, c_desc]


# ---------------------------------------------------------------------------
# phases 24 to 26: the rest of the score-network zoo; H (DiT-B) and I (ADM)
# ---------------------------------------------------------------------------
H_WIDTHS = dict(nembed=768, nheads=12, nblocks=12, mlp_factor=4,
                patch_size=4, nchannels=1)
HI_SHAPE = (256, 256, 1)   # H's and I's fields
HI_BATCH = 8               # their train batch
FLASH_NAMES = ("flash_fwd", "flash_dq", "flash_dkv")


def perturbed_copy(make, seed):
    """(the module on the CPU, the same weights on the card): weights from
    ``init_parameters(seed)``, each then moved by N(0, 0.05²) so that no
    zero-initialized bias or gate hides a path."""
    from diffsci_tpu_torch.models.nets.layers import init_parameters

    cpu = make("cpu")
    init_parameters(cpu, seed)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    card = make("cuda")
    card.load_state_dict(cpu.state_dict(), strict=True)
    return cpu.eval(), card.eval()


def zoo_nets():
    """Phase 24's networks at small widths: (label, a function that makes
    the net on a device, the inputs on the CPU: a tuple of arguments, and
    a function of the output that picks the tensors to compare)."""
    from diffsci_tpu_torch.models.nets import (
        ADM, ADMConfig, ConVit, ConVitConfig, DASC, DASCConfig,
        DiffusionTransformer, MinimalResNet, MoEDiffusionTransformer,
        PUNetGConfig, PUNetGDecoder, PUNetGDeterministic, PUNetGEncoder,
        PUNetV, PUNetVConfig)

    g = torch.Generator().manual_seed(24)

    def rn(*shape):
        return torch.randn(shape, generator=g)

    t2 = torch.tensor([0.3, -1.1])
    adm_small = dict(model_channels=8, channel_expansion=[2],
                     number_resnet_downward_block=1,
                     number_resnet_upward_block=1, number_resnet_attn_block=2,
                     number_resnet_before_attn_block=1,
                     number_resnet_after_attn_block=1, attn_heads=2,
                     attn_backend="flash")
    pu = dict(model_channels=8, channel_expansion=[2],
              number_resnet_downward_block=1, number_resnet_upward_block=1,
              number_resnet_attn_block=2, number_resnet_before_attn_block=1,
              number_resnet_after_attn_block=1, num_heads=2)
    same = (lambda out: out)
    return [
        # one 256-channel head at the middle: the wide f32 K4
        ("ADM 2D mc=64 x4, one head of 256", lambda d: ADM(ADMConfig(
            **dict(adm_small, model_channels=64, channel_expansion=[4],
                   attn_heads=1)), device=d), (rn(2, 1, 16, 16), t2), same),
        ("ADM 3D", lambda d: ADM(ADMConfig(**dict(adm_small, dimension=3)),
                                 device=d), (rn(2, 1, 8, 8, 8), t2), same),
        ("ADM mp", lambda d: ADM(ADMConfig(**dict(
            adm_small, convolution_type="mp")), device=d),
         (rn(2, 1, 16, 16), t2), same),
        ("ADM decoder 2", lambda d: ADM(ADMConfig(**dict(
            adm_small, decoder_type=2, number_resnet_upward_block=2)),
            device=d), (rn(2, 1, 16, 16), t2), same),
        ("DiT flash", lambda d: DiffusionTransformer(
            nembed=64, nheads=2, nblocks=2, patch_size=4,
            attn_backend="flash", device=d), (rn(2, 1, 32, 32), t2), same),
        ("MoE-DiT dropping", lambda d: MoEDiffusionTransformer(
            nembed=64, nheads=2, nblocks=2, patch_size=4, n_experts=4,
            moe_every=1, capacity_factor=0.5, attn_backend="flash",
            device=d), (rn(2, 1, 32, 32), t2), same),
        ("ConVit softmax", lambda d: ConVit(ConVitConfig(
            embed_dim=16, num_layers=2, num_heads=2,
            has_time_embedding=True), device=d),
         (rn(2, 1, 16, 16), t2), same),
        ("ConVit linear", lambda d: ConVit(ConVitConfig(
            embed_dim=16, num_layers=2, num_heads=2, linear_attention=True,
            with_conv_on_upsample=True, with_conv_on_downsample=True,
            has_time_embedding=True), device=d),
         (rn(2, 1, 16, 16), t2), same),
        ("PUNetGDeterministic", lambda d: PUNetGDeterministic(
            PUNetGConfig(**pu), device=d), (rn(2, 1, 16, 16),), same),
        ("PUNetGEncoder", lambda d: PUNetGEncoder(
            PUNetGConfig(**pu), use_time_embedding=True, output_channels=6,
            device=d), (rn(2, 1, 16, 16), t2), same),
        ("PUNetGDecoder", lambda d: PUNetGDecoder(
            PUNetGConfig(**pu), use_time_embedding=True, device=d),
         (rn(2, 16, 8, 8), t2), same),
        ("PUNetV slices", lambda d: PUNetV(PUNetVConfig(
            **dict(pu, slice_embed_channels=4)), device=d),
         (rn(2, 1, 16, 16), t2, {"yb": rn(2, 3, 4, 16, 16),
                                 "temporal_mask": torch.tensor(
                                     [[1.0, 1.0, 0.0], [1.0, 0.0, 0.0]])}),
         same),
        ("MinimalResNet", lambda d: MinimalResNet(
            in_channels=1, out_classes=3, model_channels=16, n_layers=2,
            device=d), (rn(2, 1, 16, 16),), same),
        ("DASC", lambda d: DASC(DASCConfig(
            in_channels=1, frame_height=16, frame_width=16,
            frames_per_video=3, latent_dim=16, num_videos=4,
            encoder_channels=(8, 16)), device=d),
         (rn(4, 3, 1, 16, 16), True),
         lambda out: torch.cat([out["reconstructed"].flatten(),
                                out["self_represented_features"].flatten(),
                                out["coefficient_matrix"].flatten()])),
    ]


def to_card(args):
    if isinstance(args, dict):
        return {k: to_card(v) for k, v in args.items()}
    if isinstance(args, (tuple, list)):
        return type(args)(to_card(a) for a in args)
    return args.cuda() if torch.is_tensor(args) else args


def graphed_sample_card_vs_cpu(label, make_net, shape, seed):
    """A graphed ``KarrasModel.sample`` (3 Heun steps) on the card against
    the CPU's eager loop on the card's noise (phase 2's form). Returns the
    launch counts of the card's sample."""
    from diffsci_tpu_torch import KarrasModel, KarrasModelConfig, kernels

    cpu = KarrasModel(make_net("cpu"), KarrasModelConfig.from_edm(),
                      device="cpu")
    state = cpu.init(seed=seed)
    gpu = KarrasModel(make_net("cuda"), KarrasModelConfig.from_edm())
    gpu.net.load_state_dict(state, strict=True)
    noise = torch.randn((2,) + shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(seed))
    ref = cpu.propagate_white_noise(noise.cpu(), nsteps=3)
    gpu.compile_sampler(2, shape, nsteps=3)
    kernels.reset_launches()
    out = gpu.sample(2, shape, torch.Generator("cuda").manual_seed(seed),
                     nsteps=3).cpu()
    counts = dict(kernels.LAUNCHES)
    err, ok = within_phase2(out, ref)
    log(f"[zoo] graphed sample {label}, 3 Heun steps: max|card - cpu| "
        f"{err:.3e} (max|cpu| {float(ref.abs().max()):.3f}; rtol 1e-3 + "
        f"atol 1e-3) {'ok' if ok else 'FAIL'}; launches {counts}")
    if not ok or counts["flash_attention"] == 0 or counts["fused_axby"] != 5:
        raise AssertionError(f"zoo: the graphed {label} sample disagrees "
                             "or missed K1/K4")
    return counts


def phase_zoo_card_vs_cpu():
    """Phase 24: every network of this slice at small widths, the card's
    forward against the port's own CPU run in f32 with TF32 off, at phase
    2's tolerance (rtol 1e-3, atol 1e-3), flash attention engaged below
    its token gate; then one graphed DiT sample and one graphed ADM sample
    against the CPU's eager loop. Returns each part's launch counts."""
    from diffsci_tpu_torch import kernels
    from diffsci_tpu_torch.kernels import flash_attention as fa
    from diffsci_tpu_torch.models.nets import (
        ADM, ADMConfig, DiffusionTransformer)

    gate = fa.MIN_TOKENS
    fa.MIN_TOKENS = 1
    all_counts = []
    try:
        for i, (label, make, args, pick) in enumerate(zoo_nets()):
            cpu, card = perturbed_copy(make, 240 + i)
            with torch.no_grad():
                ref = pick(cpu(*args))
                kernels.reset_launches()
                out = pick(card(*to_card(args)))
                torch.cuda.synchronize()
            counts = dict(kernels.LAUNCHES)
            all_counts.append(counts)
            err, ok = within_phase2(out.cpu(), ref)
            used = {k: n for k, n in counts.items() if n}
            log(f"[zoo] {label}: max|card - cpu| {err:.3e} (max|cpu| "
                f"{float(ref.abs().max()):.3f}; rtol 1e-3 + atol 1e-3) "
                f"{'ok' if ok else 'FAIL'}; kernels {used}")
            if not ok:
                raise AssertionError(f"zoo: {label} card and CPU disagree")
            if ("flash" in label or "ADM" in label) and \
                    not counts["flash_attention"]:
                raise AssertionError(f"zoo: {label} did not launch K4")
        all_counts.append(graphed_sample_card_vs_cpu(
            "DiT (nembed 64, 2 heads, 64 tokens)",
            lambda d: DiffusionTransformer(nembed=64, nheads=2, nblocks=2,
                                           attn_backend="flash", device=d),
            (32, 32, 1), 7))
        all_counts.append(graphed_sample_card_vs_cpu(
            "ADM (mc 8, 2 heads)",
            lambda d: ADM(ADMConfig(model_channels=8, channel_expansion=[2],
                                    attn_heads=2, attn_backend="flash"),
                          device=d), (16, 16, 1), 8))
    finally:
        fa.MIN_TOKENS = gate
    return all_counts


def profiled_shares(fn, host: bool = True) -> tuple[float, float, float,
                                                   str]:
    """(wall seconds, device kernel seconds, seconds in K4-K6, each flash
    kernel's launches and device ms a launch) of one call of ``fn`` under
    torch.profiler (taken again when the trace holds no device event).
    ``host=False`` traces the card alone: an eager path's tens of
    thousands of host operations make a trace with host events slow to
    read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU] * host
                     + [ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        busy = sum(device_us(e) for e in events) / 1e6
        if busy > 0:
            flash = [e for e in events
                     if any(n in e.key for n in FLASH_NAMES)]
            each = ", ".join(
                f"{re.search(r'flash_[a-z_]+_kernel', e.key).group(0)} "
                f"{e.count} x {device_us(e) / e.count / 1e3:.4f} ms"
                for e in flash)
            return wall, busy, sum(device_us(e) for e in flash) / 1e6, each
    raise AssertionError("the profiler saw no device time")


def full_width(label, make_model, zero, per_request, per_step, steps=20,
               warmup=3, buckets=(1, 4), eager_check=True):
    """Serve and train one configuration at full width (bf16 over f32
    masters, random weights from seed 0): a graphed bucket-4 request
    through ``SamplerService`` (wall and device time, idle share, the
    share of K4-K6, exact launches ``per_request``) and ``steps`` graphed
    ``make_train_step`` steps at batch 8 after ``warmup`` (s/step,
    items/s, peak memory, capture seconds, one profiled step, exact
    launches ``per_step`` a step, a falling loss), and with
    ``eager_check`` three graphed steps against their eager body. Returns
    (the request's counts, the steps' counts, the model)."""
    import gc

    from diffsci_tpu_torch import (EMATracker, SamplerService,
                                   create_train_state, kernels,
                                   make_train_step)

    model = make_model()
    model.init(seed=0)
    nparams = sum(p.numel() for p in model.net.parameters())
    svc = SamplerService(model, HI_SHAPE, batch_buckets=buckets,
                         nsteps=NSTEPS, seed=0)
    torch.cuda.synchronize()
    warm = svc.warmup()
    captures = {key[0]: round(g.capture_seconds, 3)
                for key, g in model._graphs.graphs.items()}
    n = buckets[-1]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = svc.sample(n)
    wall = time.perf_counter() - t0
    req_counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if out.shape != (n,) + HI_SHAPE or not np.isfinite(out).all():
        raise AssertionError(f"{label}: request gave shape {out.shape} or "
                             "non-finite values")
    pwall, busy, flash, each = profiled_shares(lambda: svc.sample(n))
    log(f"[{label}] {nparams} parameters; warm-up seconds per bucket "
        f"{ {b: round(s, 3) for b, s in warm.items()} }, capture {captures}")
    log(f"[{label}] graphed request of {n} ({NSTEPS}-step Heun, {NFE} "
        f"network calls): wall {wall:.4f} s, {n / wall:.2f} samples/s, "
        f"peak memory {peak:.3f} GiB; profiled: wall {pwall:.4f} s, device "
        f"{busy:.4f} s, idle share {1 - busy / pwall:.3f}, K4 "
        f"{flash:.4f} s = {flash / busy:.1%} of device time ({each}); "
        f"launches {req_counts}")
    expected = dict(zero, **per_request)
    if req_counts != expected:
        raise AssertionError(f"{label}: request launches {req_counts}, "
                             f"expected {expected}")
    del svc, out
    model._reset_cast()
    gc.collect()
    torch.cuda.empty_cache()

    x_shape = (HI_BATCH,) + HI_SHAPE
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05],
                         update_every=4)
    # the served weights (seed 0) are the first step's
    state, tx = create_train_state(model, x_shape, seed=None, ema=tracker)
    weights = {k: v.detach().clone() for k, v in state.params.items()}
    step = make_train_step(model, tx, ema=tracker)
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(x_shape, generator=gen, device="cuda")
    probe_sigma = model.config.noisesampler.sample((HI_BATCH,), gen)
    probe_eps = torch.randn(x_shape, generator=gen, device="cuda")

    def probe():
        with torch.no_grad():
            return float(model.loss_fn(x, probe_sigma, eps=probe_eps,
                                       train=False))

    before = probe()
    t0 = time.perf_counter()
    for _ in range(warmup):
        step(state, x, generator=gen)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    captures = [round(g.capture_seconds, 3)
                for g in state.graphs.graphs.values()]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        met = step(state, x, generator=gen)[1]
        losses.append(met["train_loss"])
    last = float(met["train_loss"])                       # the sync
    dt = time.perf_counter() - t0
    step_counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = probe()
    losses = [float(v) for v in losses]
    swall, sbusy, sflash, each = profiled_shares(
        lambda: step(state, x, generator=gen))
    log(f"[{label}] train batch {x_shape}: warm-up {warmup} steps "
        f"{warm_s:.2f} s, capture seconds (step, EMA) {captures}; {steps} "
        f"graphed steps in {dt:.4f} s: {dt / steps:.4f} s/step, "
        f"{HI_BATCH * steps / dt:.2f} items/s; peak memory {peak:.3f} GiB; "
        f"loss first {losses[0]:.5f} last {last:.5f}; fixed-draw loss "
        f"{before:.5f} before, {after:.5f} after; launches {step_counts}")
    log(f"[{label}] profiled graphed step: wall {swall:.4f} s, device "
        f"{sbusy:.4f} s, idle share {1 - sbusy / swall:.3f}, K4-K6 "
        f"{sflash:.4f} s = {sflash / sbusy:.1%} of device time ({each})")
    expected = {k: v * steps for k, v in dict(zero, **per_step).items()}
    if not (np.isfinite(losses).all() and after < before):
        raise AssertionError(f"{label}: non-finite loss, or the loss did "
                             "not fall")
    if step_counts != expected:
        raise AssertionError(f"{label}: step launches {step_counts}, "
                             f"expected {expected}")
    if eager_check:
        # three steps each from the same weights and generator (the graphed
        # arm's first is its warm-up)
        arms = {}
        for arm in ("eager", "graphed"):
            with torch.no_grad():
                for k, v in state.params.items():
                    v.copy_(weights[k])
            st, tx2 = create_train_state(model, x_shape, seed=None)
            fn = make_train_step(model, tx2, _raw=arm == "eager")
            g2 = torch.Generator("cuda").manual_seed(25)
            mets = [float(fn(st, x, generator=g2)[1]["train_loss"])
                    for _ in range(3)]
            arms[arm] = (mets, {k: v.detach().clone()
                                for k, v in st.params.items()})
            del st, fn
        (m_e, p_e), (m_g, p_g) = arms["eager"], arms["graphed"]
        same = all(torch.equal(p_e[k], p_g[k]) for k in p_e) and m_e == m_g
        ok_p, q999, worst = params_within(p_g, p_e, 1e-3, 3)
        ok = ok_p and np.allclose(m_g, m_e, rtol=1e-3, atol=0)
        log(f"[{label}] graphed against eager, 3 steps from one seed: "
            f"losses {m_g} / {m_e}; params 99.9% {q999:.3e}, max "
            f"{worst:.3e} (phase 3's limits); bit for bit {same} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: the graphed step differs from "
                                 "its eager body")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return req_counts, step_counts, model


def model_h(moe: bool = False):
    """Configuration H: DiT at DiT-B's widths on 256² × 1 fields (patch 4:
    4096 tokens, 12 heads of 64), flash attention, EDM, bf16 over f32
    masters; ``moe``: its MoE twin (4 experts in every second block,
    capacity factor 2)."""
    from diffsci_tpu_torch import KarrasModel, KarrasModelConfig
    from diffsci_tpu_torch.models.nets import (DiffusionTransformer,
                                               MoEDiffusionTransformer)

    net = (MoEDiffusionTransformer(n_experts=4, moe_every=2,
                                   capacity_factor=2.0, attn_backend="flash",
                                   **H_WIDTHS) if moe else
           DiffusionTransformer(attn_backend="flash", **H_WIDTHS))
    return KarrasModel(net, KarrasModelConfig.from_edm(),
                       compute_dtype=torch.bfloat16)


def model_h_moe_f32(nblocks: int = 2):
    """H's MoE twin at H's widths cut to ``nblocks`` blocks (4 experts in
    every second block), flash attention, EDM, in float32."""
    from diffsci_tpu_torch import KarrasModel, KarrasModelConfig
    from diffsci_tpu_torch.models.nets import MoEDiffusionTransformer

    net = MoEDiffusionTransformer(n_experts=4, moe_every=2,
                                  capacity_factor=2.0, attn_backend="flash",
                                  **dict(H_WIDTHS, nblocks=nblocks))
    return KarrasModel(net, KarrasModelConfig.from_edm())


def model_i():
    """Configuration I: ADM at ``ADMConfig``'s defaults (2D, 64 channels,
    expansion (2, 4), one 256-channel head in the middle) on 256² × 1
    fields, flash attention (4096 tokens at head dim 256), EDM, bf16 over
    f32 masters."""
    from diffsci_tpu_torch import KarrasModel, KarrasModelConfig
    from diffsci_tpu_torch.models.nets import ADM, ADMConfig

    return KarrasModel(ADM(ADMConfig(attn_backend="flash")),
                       KarrasModelConfig.from_edm(),
                       compute_dtype=torch.bfloat16)


def phase_h(zero):
    """Phase 25: H served and trained at full width, then its MoE twin
    (one bucket-4 request, 5 graphed steps, the dropped fraction). A
    request is 35 network calls, each a combine (K1) and 12 attentions
    (K4); a step a forward and backward of the 12 blocks (K4, K5, K6 12
    each; the training combine is the plain expression)."""
    from diffsci_tpu_torch.models.nets import MoEFeedForward

    nb = H_WIDTHS["nblocks"]
    per_request = dict(fused_axby=NFE, flash_attention=nb * NFE)
    per_step = dict(flash_attention=nb, flash_attention_dq=nb,
                    flash_attention_dkv=nb)
    counts = list(full_width("H", model_h, zero, per_request, per_step)[:2])
    req, steps, moe = full_width("H MoE", lambda: model_h(moe=True), zero,
                                 per_request, per_step, steps=5, warmup=2,
                                 buckets=(4,), eager_check=False)
    dropped = [float(m.dropped_fraction) for m in moe.net.modules()
               if isinstance(m, MoEFeedForward)]
    log(f"[H MoE] dropped fraction of the last train step, per MoE block "
        f"{[round(f, 4) for f in dropped]}")
    return counts + [req, steps]


def phase_i(zero):
    """Phase 26: I served and trained at full width. A request is 35
    network calls, each a combine (K1) and the middle attention (K4); a
    step one K4, K5 and K6; ADM's norms (one group) take no kernel."""
    per_request = dict(fused_axby=NFE, flash_attention=NFE)
    per_step = dict(flash_attention=1, flash_attention_dq=1,
                    flash_attention_dkv=1)
    return list(full_width("I", model_i, zero, per_request, per_step)[:2])


def threading_sample(svc, n, seed):
    import threading

    t = threading.Thread(target=svc.sample, args=(n, seed))
    t.start()
    return t


# ---------------------------------------------------------------------------
# phases 27 to 31: progressive distillation (J, J-A) and VAE training (K,
# K-P, K-CPU)
# ---------------------------------------------------------------------------
J_BATCH = 256              # B's train batch (bench.py:112)
J_STEPS = 20               # distill steps a phase
J_CHAIN = (17, 1)          # 17 -> 9 -> 5 -> 3 -> 2 -> 1
J_TEACHER_STEPS = 200      # B's train steps that make J's teacher
J_LR = 1e-4                # distill_progressive's default learning rate
K_BATCH = 8                # G's autoencoder trained at batch 8
KP_BATCH = 2               # VAENet 64³ at batch 2
NORMS_B, NORMS_A = 28, 20  # K2 a network call (B, A)


def distill_per_step(heun: bool, norms: int, flash: bool = False) -> dict:
    """The launches of one distill step: the teacher's denoiser calls (4
    under Heun sub-steps, 2 under Euler; each one K1 and a forward), the
    student's forward and backward (its combine is the plain training
    expression)."""
    calls = 4 if heun else 2
    out = dict(fused_axby=calls, norm_silu=norms * (calls + 1),
               norm_silu_bwd=norms)
    if flash:
        out.update(flash_attention=calls + 1, flash_attention_dq=1,
                   flash_attention_dkv=1)
    return out


def state_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[n], b[n]) for n in a)


def phase_distill_b(zero):
    """J: progressive distillation of B (MNIST PUNetG at full width, bf16
    over f32 masters, random weights from seed 0) at batch 256 of random
    data, graphed. The teacher is B after 200 of its train steps on the
    batch. First the graph against the eager step, bit for bit, before
    and after the teacher is reloaded in place (with seed 1's weights);
    one phase-0 step (17 student steps, Heun teacher) timed over 20 steps
    after 3 warm-up steps with exact launches and one profiled step; then
    the whole chain 17 -> 9 -> 5 -> 3 -> 2 -> 1 through
    ``distill_progressive`` (20 steps a phase, lr 1e-4): finite losses,
    phase 0's last five below its first five, exact launches; the 2-step
    student sampled by ``sample(nsteps=2, integrator="euler")`` and the
    1-NFE student served through ``SamplerService(nsteps=1)``."""
    from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                                   PUNetGConfig, SamplerService,
                                   create_train_state, default_optimizer,
                                   kernels, make_train_step)
    from diffsci_tpu_torch.models.karras import distill
    from diffsci_tpu_torch.models.karras.train import _new_train_state

    cfg_b = PUNetGConfig(model_channels=64, channel_expansion=[2, 4])
    shape = (28, 28, 1)

    def model_b():
        return KarrasModel(PUNetG(cfg_b), KarrasModelConfig.from_edm(),
                           compute_dtype=torch.bfloat16)

    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((J_BATCH,) + shape, generator=gen, device="cuda")
    # the teacher: B trained on the batch (an untrained teacher's targets
    # make Adam's first distill steps overshoot at any learning rate)
    trained = model_b()
    state, tx = create_train_state(trained, (J_BATCH,) + shape, seed=0)
    train_step = make_train_step(trained, tx)
    for _ in range(J_TEACHER_STEPS):
        train_step(state, x, generator=gen)
    teacher_sd = {k: v.detach().clone()
                  for k, v in trained.net.state_dict().items()}
    other_sd = {k: v.clone() for k, v in model_b().init(seed=1).items()}
    del trained, state, train_step

    # graph against eager, bit for bit, before and after a teacher swap
    arms = {}
    for graphed in (False, True):
        model = model_b()
        model.net.load_state_dict(teacher_sd)
        teacher = distill._teacher_like(model)
        tx = default_optimizer(J_LR)
        state = _new_train_state(model, tx)
        arms[graphed] = (teacher, state, distill.make_distill_step(
            model, tx, J_CHAIN[0], _raw=not graphed))
    same = []
    for k in range(3):
        if k == 2:
            for teacher, _, _ in arms.values():
                teacher.net.load_state_dict(other_sd)
        idx = torch.randint(0, J_CHAIN[0], (J_BATCH,), generator=gen,
                            device="cuda")
        eps = torch.randn(x.shape, generator=gen, device="cuda")
        mets = {g: step(state, teacher, x, idx=idx, eps=eps)[1]
                for g, (teacher, state, step) in arms.items()}
        same.append(all(torch.equal(mets[True][n], mets[False][n])
                        for n in mets[True])
                    and state_equal(arms[True][1].params,
                                    arms[False][1].params))
    log(f"[J distill B] graph against eager, bit for bit: steps 1-2 "
        f"{same[:2]}, after the teacher reloaded in place {same[2]}")
    if not all(same):
        raise AssertionError("J: the graphed distill step differs from the "
                             "eager one")
    del arms

    # the timed phase-0 step
    model = model_b()
    model.net.load_state_dict(teacher_sd)
    teacher = distill._teacher_like(model)
    tx = default_optimizer(J_LR)
    state = _new_train_state(model, tx)
    step = distill.make_distill_step(model, tx, J_CHAIN[0])

    def one_step():
        return step(state, teacher, x, generator=gen)[1]

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    capture = [round(g.capture_seconds, 3)
               for g in state.graphs.graphs.values()]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(J_STEPS):
        met = one_step()
    float(met["distill_loss"])
    dt = (time.perf_counter() - t0) / J_STEPS
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = distill_per_step(True, NORMS_B)
    expected = dict(zero, **{k: v * J_STEPS for k, v in per_step.items()})
    wall, busy = busy_seconds(one_step)
    log(f"[J distill B] phase-0 step (17 student steps, Heun teacher), "
        f"batch {J_BATCH}: {dt:.4f} s/step, {J_BATCH / dt:.2f} items/s; "
        f"one profiled step wall {wall:.4f} s, device {busy:.4f} s; peak "
        f"memory {peak:.3f} GiB; capture {capture} s; launches a step "
        f"{ {k: v // J_STEPS for k, v in counts.items() if v} }")
    if counts != expected:
        raise AssertionError(f"J: launch counts {counts}, expected "
                             f"{expected}")
    del state, step, teacher

    # the whole chain
    model = model_b()
    snapshots = {}

    def batches():
        while True:
            yield x

    def keep(nsteps, variables, losses):
        if nsteps == 2:
            snapshots[2] = variables

    kernels.reset_launches()
    t0 = time.perf_counter()
    final, history = distill.distill_progressive(
        model, teacher_sd, batches(), gen, start_nsteps=J_CHAIN[0],
        final_nsteps=J_CHAIN[1], steps_per_phase=J_STEPS,
        learning_rate=J_LR, callback=keep)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    chain_counts = dict(kernels.LAUNCHES)
    expected = dict(zero)
    for i, h in enumerate(history):
        for k, v in distill_per_step(i == 0, NORMS_B).items():
            expected[k] += v * J_STEPS
    schedule = [h["nsteps"] for h in history]
    for h in history:
        log(f"[J distill B] phase {h['nsteps']:2d} steps: loss first "
            f"{h['losses'][0]:.5f} last {h['losses'][-1]:.5f}; graphs "
            f"{h['graphs']}, capture {h['capture_seconds']:.3f} s")
    first, last = (np.mean(history[0]["losses"][s]) for s in
                   (slice(0, 5), slice(-5, None)))
    log(f"[J distill B] chain {schedule} in {chain_s:.2f} s; phase 0 mean "
        f"loss first five {first:.5f}, last five {last:.5f}; launches "
        f"{chain_counts}")
    if schedule != [17, 9, 5, 3, 2, 1] or not all(
            np.isfinite(h["losses"]).all() for h in history) \
            or not last < first or chain_counts != expected \
            or any(h["graphs"] != 1 for h in history):
        raise AssertionError(f"J: the chain failed (schedule {schedule}, "
                             f"phase 0 {first} -> {last}, launches "
                             f"{chain_counts}, expected {expected})")

    # the 2-step student sampled, the 1-NFE student served
    two = model_b()
    two.net.load_state_dict(snapshots[2])
    two.compile_sampler(8, shape, nsteps=2, integrator="euler")
    kernels.reset_launches()
    s2 = two.sample(8, shape, torch.Generator("cuda").manual_seed(1),
                    nsteps=2, integrator="euler")
    c2 = dict(kernels.LAUNCHES)
    svc = SamplerService(model, shape, batch_buckets=(8,), nsteps=1)
    svc.warmup()
    kernels.reset_launches()
    t0 = time.perf_counter()
    s1 = svc.sample(8, 3)
    t1 = time.perf_counter() - t0
    c1 = dict(kernels.LAUNCHES)
    log(f"[J distill B] 2-step student: 8 samples std "
        f"{float(s2.std()):.4f}, launches {c2}; 1-NFE student through "
        f"SamplerService(nsteps=1): 8 samples in {t1:.4f} s, std "
        f"{float(np.std(s1)):.4f}, launches {c1}")
    if not (torch.isfinite(s2).all() and np.isfinite(s1).all()
            and c2["fused_axby"] == 2 and c1["fused_axby"] == 1):
        raise AssertionError("J: a distilled student sampled a non-finite "
                             "value or skipped the combine kernel")
    return [counts, chain_counts, c2, c1]


def phase_distill_a_card_vs_cpu(zero):
    """J-A: one distill step of A (the 3D flash PUNetG at full width, 32³,
    batch 4, f32, TF32 off) on the CPU and the card (graphed: its first
    call is the eager warm-up, then the capture) from the same weights
    and replayed interval and ε draws, a teacher of other weights:
    phase 3's bounds (loss and grad_norm rtol 1e-3, parameters 99.9 %
    within 0.05·lr, all within 2·lr); the card's step launches K1-K6."""
    from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                                   PUNetGConfig, default_optimizer, kernels)
    from diffsci_tpu_torch.models.karras import distill
    from diffsci_tpu_torch.models.karras.train import _new_train_state

    cfg_a = PUNetGConfig(dimension=3, model_channels=32,
                         channel_expansion=[2], num_heads=2,
                         attn_backend="flash")
    x_shape, n, lr = (4, 32, 32, 32, 1), 17, 1e-3
    rng = np.random.default_rng(5)
    x = rng.standard_normal(x_shape).astype(np.float32)
    idx = rng.integers(0, n, x_shape[0])
    eps = rng.standard_normal(x_shape).astype(np.float32)
    weights = teacher_w = None
    runs = {}
    for dev in ("cpu", "cuda"):
        model = KarrasModel(PUNetG(cfg_a, device=dev),
                            KarrasModelConfig.from_edm(), device=dev)
        teacher = distill._teacher_like(model)
        if weights is None:
            weights = {k: v.clone() for k, v in model.init(seed=0).items()}
            teacher_w = {k: v.clone() for k, v in
                         teacher.init(seed=1).items()}
        model.net.load_state_dict(weights)
        teacher.net.load_state_dict(teacher_w)
        tx = default_optimizer(lr)
        state = _new_train_state(model, tx)
        step = distill.make_distill_step(model, tx, n)
        kernels.reset_launches()
        t0 = time.perf_counter()
        _, met = step(state, teacher, torch.from_numpy(x).to(dev),
                      idx=torch.from_numpy(idx).to(dev),
                      eps=torch.from_numpy(eps).to(dev))
        m = (float(met["distill_loss"]), float(met["grad_norm"]))
        runs[dev] = (m, state, time.perf_counter() - t0,
                     dict(kernels.LAUNCHES))
    (m_cpu, s_cpu, t_cpu, _), (m_card, s_card, t_card, counts) = \
        runs["cpu"], runs["cuda"]
    ok_p, q999, worst = params_within(s_card.params, s_cpu.params, lr, 1)
    ok = ok_p and np.isfinite(m_card).all() and np.allclose(
        m_card, m_cpu, rtol=1e-3, atol=0)
    expected = dict(zero, **distill_per_step(True, NORMS_A, flash=True))
    log(f"[J-A distill A card-vs-cpu] one f32 step (17 student steps, "
        f"Heun teacher), batch 4 of 32^3: (loss, grad_norm) card {m_card} "
        f"cpu {m_cpu} (rtol 1e-3); params |card - cpu| 99.9% {q999:.3e}, "
        f"max {worst:.3e} (limits {0.05 * lr:.0e}, {2 * lr:.0e}) "
        f"{'ok' if ok else 'FAIL'}; cpu {t_cpu:.1f} s, card {t_card:.1f} "
        f"s (warm-up and capture); launches a step {counts}")
    if not ok or counts != expected:
        raise AssertionError(f"J-A: card and CPU disagree, or launches "
                             f"{counts} are not {expected}")
    return [counts]


def vae_step_counts(zero, counts: dict, label: str) -> None:
    """VAE training runs no kernel of the port (plain GroupNorm, plain
    attention, as in the JAX package)."""
    if counts != zero:
        raise AssertionError(f"{label}: VAE training launched {counts}")


def train_vae(label, model, x, steps, warmup=3, eps_seed=0):
    """``warmup`` graphed steps, then ``steps`` timed (host clock ended by a
    sync); a fixed z-noise probes the loss before and after. Returns
    (metrics of the last step, s/step, peak GiB, capture seconds, loss
    before, after, the launch counts, the state)."""
    from diffsci_tpu_torch import (create_vae_train_state, kernels,
                                   make_vae_train_step)

    state, tx, dtx = create_vae_train_state(model, tuple(x.shape), seed=0)
    step = make_vae_train_step(model, tx, dtx)
    gen = torch.Generator("cuda").manual_seed(eps_seed)
    probe_eps = torch.randn(model.latent_shape(x.shape), generator=gen,
                            device="cuda")

    def probe():
        with torch.no_grad():
            return float(model.loss_fn(x, train=False, eps=probe_eps)[0])

    before = probe()
    for _ in range(warmup):
        step(state, x, generator=gen)
    torch.cuda.synchronize()
    capture = [round(g.capture_seconds, 3)
               for g in state.graphs.graphs.values()]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        _, met = step(state, x, generator=gen)
    float(met["train_loss"])
    dt = (time.perf_counter() - t0) / steps
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return met, dt, peak, capture, before, probe(), counts, state, step


def phase_vae_g(zero):
    """K: G's autoencoder trained (``AutoencoderKL(DDConfig(),
    embed_dim=4)``, 256² × 1 -> 32² × 4, f32, ``VAEModelConfig()``'s
    defaults: Huber, KL 1e-3, adversarial 0.01, threshold 0.85) with
    ``NLayerDiscriminator(ndf=64, n_layers=3)``, batch 8: 20 graphed steps
    after 3 warm-up steps (finite, falling fixed-noise loss; s/step,
    items/s, peak memory, one profiled step), and the graph against the
    eager step bit for bit over 3 steps of a twin with
    ``discriminator_frequency=2`` (the second step gated), on cuDNN's
    deterministic algorithms."""
    from diffsci_tpu_torch import (AutoencoderKL, DDConfig,
                                   NLayerDiscriminator, VAEModel,
                                   VAEModelConfig, create_vae_train_state,
                                   make_vae_train_step)

    def model_g(**kw):
        return VAEModel(AutoencoderKL(DDConfig(), embed_dim=4),
                        VAEModelConfig(**kw),
                        discriminator=NLayerDiscriminator(ndf=64,
                                                          n_layers=3))

    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(K_BATCH, 1, G_PIX, G_PIX, generator=gen, device="cuda")
    model = model_g()
    met, dt, peak, capture, before, after, counts, state, step = train_vae(
        "K", model, x, 20)
    vae_step_counts(zero, counts, "K")
    nparams = sum(p.numel() for p in state.params.values())
    nd = sum(p.numel() for p in state.disc_params.values())
    wall, busy = busy_seconds(lambda: step(state, x, generator=gen))
    log(f"[K VAE G] AutoencoderKL {nparams} parameters + discriminator "
        f"{nd}, batch {K_BATCH} of {G_PIX}^2: {dt:.4f} s/step, "
        f"{K_BATCH / dt:.2f} items/s; one profiled step wall {wall:.4f} s, "
        f"device {busy:.4f} s; peak memory {peak:.3f} GiB; capture "
        f"{capture} s; fixed-noise loss {before:.5f} before, {after:.5f} "
        f"after; last step loss {float(met['train_loss']):.5f}, "
        f"d_accuracy {float(met['d_accuracy']):.4f}, disc_updated "
        f"{float(met['disc_updated']):.0f}")
    if not (np.isfinite(float(met["train_loss"])) and after < before):
        raise AssertionError("K: the loss is not finite or did not fall")
    del state, step, model

    # some of cuDNN's backward algorithms for these f32 convolutions
    # accumulate with atomics (two eager steps differ in their last bits),
    # so the comparison runs on its deterministic ones
    torch.backends.cudnn.deterministic = True
    arms = {}
    latent = None
    for graphed in (False, True):
        twin = model_g(discriminator_frequency=2)
        latent = twin.latent_shape(x.shape)
        st, tx, dtx = create_vae_train_state(twin, tuple(x.shape), seed=0)
        arms[graphed] = (st, make_vae_train_step(twin, tx, dtx,
                                                 _raw=not graphed))
    same, gates = [], []
    for k in range(3):
        eps = torch.randn(latent, generator=gen, device="cuda")
        mets = {g: s(st, x, eps=eps)[1] for g, (st, s) in arms.items()}
        gates.append(float(mets[True]["disc_updated"]))
        same.append(all(torch.equal(mets[True][n], mets[False][n])
                        for n in mets[True])
                    and state_equal(arms[True][0].params,
                                    arms[False][0].params)
                    and state_equal(arms[True][0].disc_params,
                                    arms[False][0].disc_params))
    torch.backends.cudnn.deterministic = False
    log(f"[K VAE G] graph against eager (cuDNN deterministic), bit for bit "
        f"over 3 steps: {same}; gates {gates}")
    if not all(same) or gates[1] != 0.0:
        raise AssertionError("K: the graphed VAE step differs from the "
                             "eager one, or the frequency gate did not "
                             "close")
    return [counts]


def phase_vae_porous(zero):
    """K-P: the porous-media VAENet at ``VAENetConfig()``'s defaults (3D,
    64³ × 1, ch 32, mult (1, 2, 4), two blocks a level, middle attention
    over 4096 tokens), batch 2, f32, ``loss_preprocessor='edges'`` in 3D,
    total variation 0.1, no discriminator, KL annealed 0 -> 1e-3 across
    two epochs of 3 graphed steps: finite losses, the KL weight changed
    between the epochs and each step's main loss its nll + kl_weight·kl
    (rtol 1e-5); s/step and peak memory."""
    from diffsci_tpu_torch import (KLAnnealing, VAEModel, VAEModelConfig,
                                   VAENet, VAENetConfig,
                                   create_vae_train_state, kernels,
                                   make_vae_train_step)

    cfg = VAENetConfig()
    conf = VAEModelConfig(loss_preprocessor="edges",
                          loss_preprocessor_dim=3,
                          total_variation_weight=0.1)
    model = VAEModel(VAENet(cfg), conf)
    annealing = KLAnnealing(conf, 0.0, 1e-3, 1)
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(KP_BATCH, 1, 64, 64, 64, generator=gen, device="cuda")
    state, tx, _ = create_vae_train_state(model, tuple(x.shape), seed=0)
    step = make_vae_train_step(model, tx)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    rows, times = [], []
    for epoch in range(2):
        weight = annealing.on_epoch(epoch)
        for _ in range(3):
            t0 = time.perf_counter()
            _, met = step(state, x, generator=gen)
            rows.append((weight, *(float(met[k]) for k in
                                   ("main_loss", "nll_loss", "kl_loss",
                                    "tv_loss", "train_loss"))))
            times.append(time.perf_counter() - t0)
    counts = dict(kernels.LAUNCHES)
    vae_step_counts(zero, counts, "K-P")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    follows = all(np.isclose(main, nll + w * kl, rtol=1e-5, atol=0)
                  for w, main, nll, kl, _, _ in rows)
    nparams = sum(p.numel() for p in state.params.values())
    log(f"[K-P VAENet] {nparams} parameters, batch {KP_BATCH} of 64^3, "
        f"edges 3D + TV 0.1: s/step (3 graphed after the first) "
        f"{np.mean(times[3:]):.4f}; peak memory {peak:.3f} GiB; graphs "
        f"{len(state.graphs.graphs)}")
    for w, main, nll, kl, tv, total in rows:
        log(f"[K-P VAENet] kl_weight {w:.0e}: loss {total:.5f} (main "
            f"{main:.5f} = nll {nll:.5f} + {w:.0e} x kl {kl:.3f}; tv "
            f"{tv:.5f})")
    if not (follows and rows[0][0] != rows[-1][0] and all(
            np.isfinite(r[1:]).all() for r in rows)
            and len(state.graphs.graphs) == 1):
        raise AssertionError("K-P: a loss was not finite, or it did not "
                             "follow the annealed KL weight")
    return [counts]


def phase_vae_card_vs_cpu():
    """K-CPU: a small VAENet (the reference fixtures' widths, 16²) with an
    ``NLayerDiscriminator(ndf=16, n_layers=2)``, f32, TF32 off: two steps
    on the CPU and the card (graphed) from the same weights and replayed
    z-noise, the accuracy gate open (threshold 1.01) and
    ``discriminator_frequency=2``, so the first step updates the
    discriminator and the second is gated: every metric within rtol 1e-3,
    both networks' parameters within phase 3's bounds, both optimizers'
    Adam moments within 1e-3 (first) and 2e-3 (second) of their largest
    entry, the same counts; the gated step leaves the discriminator's
    weights where they were on both."""
    from diffsci_tpu_torch import (NLayerDiscriminator, VAEModel,
                                   VAEModelConfig, VAENet, VAENetConfig,
                                   create_vae_train_state,
                                   make_vae_train_step)

    cfg = VAENetConfig(dimension=2, in_channels=1, out_channels=1,
                       z_channels=3, z_dim=3, ch=8, ch_mult=[1, 2],
                       num_res_blocks=1, resolution=16, num_groups=1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 1, 16, 16)).astype(np.float32)
    epss = [rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
            for _ in range(2)]
    lr = 1e-4
    runs, weights = {}, None
    for dev in ("cpu", "cuda"):
        model = VAEModel(VAENet(cfg, device=dev), VAEModelConfig(
            discriminator_frequency=2, discriminator_threshold=1.01,
            adversarial_weight=0.05), discriminator=NLayerDiscriminator(
                ndf=16, n_layers=2, device=dev), device=dev)
        state, tx, dtx = create_vae_train_state(model, x.shape, seed=0)
        if weights is None:
            weights = ({k: v.clone() for k, v in model.net.state_dict()
                        .items()}, {k: v.clone() for k, v in
                                    model.discriminator.state_dict()
                                    .items()})
        model.net.load_state_dict(weights[0])
        model.discriminator.load_state_dict(weights[1])
        step = make_vae_train_step(model, tx, dtx)
        mets, gated_same = [], None
        for k, eps in enumerate(epss):
            before = {n: p.detach().clone()
                      for n, p in state.disc_params.items()}
            _, met = step(state, torch.from_numpy(x).to(dev),
                          eps=torch.from_numpy(eps).to(dev))
            mets.append({n: float(v) for n, v in met.items()})
            if k == 1:
                gated_same = state_equal(state.disc_params, before)
        runs[dev] = (mets, state, gated_same)
    (m_cpu, s_cpu, g_cpu), (m_card, s_card, g_card) = runs["cpu"], \
        runs["cuda"]
    ok = g_cpu and g_card and [m["disc_updated"] for m in m_card] == \
        [1.0, 0.0] and all(np.isclose(mc[n], mr[n], rtol=1e-3, atol=1e-7)
                           for mc, mr in zip(m_card, m_cpu) for n in mr)
    lines = []
    for what in ("params", "disc_params"):
        ok_p, q999, worst = params_within(getattr(s_card, what),
                                          getattr(s_cpu, what), lr, 2)
        ok = ok and ok_p
        lines.append(f"{what} 99.9% {q999:.3e} max {worst:.3e}")
    for opt, params in (("optimizer", "params"),
                        ("disc_optimizer", "disc_params")):
        oc, orf = getattr(s_card, opt), getattr(s_cpu, opt)
        names = list(getattr(s_cpu, params))
        for key, bound in (("exp_avg", 1e-3), ("exp_avg_sq", 2e-3)):
            ref = [orf.state[getattr(s_cpu, params)[n]][key] for n in names]
            got = [oc.state[getattr(s_card, params)[n]][key].cpu()
                   for n in names]
            scale = max(float(r.abs().max()) for r in ref)
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            ok = ok and err <= bound * scale
            lines.append(f"{opt} {key} {err / scale:.2e} of max")
        ok = ok and all(float(oc.state[p]["step"]) == 2
                        for p in oc.param_groups[0]["params"])
    log(f"[K-CPU VAE card-vs-cpu] 2 f32 steps (updated, then gated): "
        f"losses card {[round(m['train_loss'], 6) for m in m_card]} cpu "
        f"{[round(m['train_loss'], 6) for m in m_cpu]}; "
        f"{'; '.join(lines)}; gated step left the discriminator: cpu "
        f"{g_cpu}, card {g_card} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K-CPU: the card's VAE steps disagree with "
                             "the CPU's")


# ---------------------------------------------------------------------------
# phases 31 to 33: the other runtimes (L: flow matching of porous volumes,
# M: the SDE stack, N: DDPM v1, O: the deterministic forecaster)
# ---------------------------------------------------------------------------
SI_STEPS = 30              # SIModel.sample's default grid
SI_NFE = 2 * SI_STEPS - 3  # Heun over 28 intervals, then one Euler step
SI_EM_NFE = SI_STEPS - 1   # Euler–Maruyama: one call an interval
M_EM_STEPS = 1000          # sde_sampler's default
M_PF_STEPS = 500           # Heun: 1000 network calls (cut for time)
M_BATCH, N_BATCH, O_BATCH = 256, 128, 8
SHORT_STEPS = 20           # graphed against eager (an eager call ~18 ms)


class ForecastHead(torch.nn.Module):
    """O's network: two 3×3 convolutions with a SiLU between (the head of
    ``tests/test_remaining_components.py``'s forecaster), from the
    conditioning window's latents to the next latent frame."""

    def __init__(self, channels=4, width=64):
        super().__init__()
        self.conv0 = torch.nn.Conv2d(channels, width, 3, padding=1)
        self.conv1 = torch.nn.Conv2d(width, channels, 3, padding=1)

    def forward(self, yc, y=None):
        return self.conv1(F.silu(self.conv0(yc)))


def within_scale(out, ref):
    """Phase 2's rtol 1e-3 + atol 1e-3, the atol taken relative to the
    result's scale (an untrained network's loop amplifies x)."""
    out, ref = out.float().cpu(), ref.float().cpu()
    err = float((out - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    return err, bool(torch.isfinite(out).all()) and bool(
        ((out - ref).abs() <= 1e-3 * ref.abs() + 1e-3 * scale).all())


def model_l(dev="cuda", cfg=None, dtype=torch.bfloat16, **si):
    """Configuration L: an ``SIModel`` around A's PUNetG (3D 32³, flash
    attention over the 4096-token bottleneck), the linear path and the
    Huber loss unless ``si`` says otherwise, bf16 over f32 masters."""
    from diffsci_tpu_torch import PUNetG, PUNetGConfig, SIModel, SIModelConfig

    cfg = cfg or PUNetGConfig(dimension=3, model_channels=32,
                              channel_expansion=[2], num_heads=2,
                              attn_backend="flash")
    return SIModel(PUNetG(cfg, device=dev), SIModelConfig(
        **dict(dict(scheduler="linear", loss_metric="huber"), **si)),
        compute_dtype=dtype, device=dev)


def small_b_config():
    """B's depth at 8 channels: 28 norms a network call (K2), plain
    attention."""
    from diffsci_tpu_torch import PUNetGConfig

    return PUNetGConfig(model_channels=8, channel_expansion=[2, 4])


def small_runtimes(dev):
    """Phase 31's nets, f32, weights from fixed seeds (device-independent):
    L at phase 2's cut (with the running initial norm), M at B's depth cut
    to 8 channels, N around phase 4's small HFNet (T 25), and O over a
    small 2D autoencoder (16² fields to 8² × 4 latents)."""
    from diffsci_tpu_torch import (DDPMModuleV1, DDPMSchedulerV1,
                                   ForecastModel, ForecastModelConfig, PUNetG,
                                   SDEModel)
    from diffsci_tpu_torch.models import sde
    from diffsci_tpu_torch.models.nets.vae import AutoencoderKL, DDConfig
    from diffsci_tpu_torch.models.vae import (BoundAutoencoder, VAEModel,
                                              VAEModelConfig)

    out = {"L": model_l(dev, small_3d_config(), None, initial_norm=True),
           "L-edm": model_l(dev, small_3d_config(), None, scheduler="edm",
                            precondition_fn="edm"),
           "M": SDEModel(PUNetG(small_b_config(), device=dev),
                         sde.VPSchedulerLinear(coef=19.9), device=dev),
           "N": DDPMModuleV1(small_hfnet(dev), DDPMSchedulerV1(T=25),
                             device=dev)}
    vm = VAEModel(AutoencoderKL(DDConfig(resolution=16, ch=8,
                                         ch_mult=(1, 2), num_res_blocks=1),
                                embed_dim=4, device=dev),
                  VAEModelConfig(), device=dev)
    vm.init(seed=7)
    out["O"] = ForecastModel(ForecastHead(4, 8), ForecastModelConfig(
        loss_metric="huber"), autoencoder=BoundAutoencoder(vm), device=dev)
    for seed, model in enumerate(out.values()):
        model.init(seed=seed)
    return out


def one_train_step(model, x, y, t, eps, loss_fn=None, optimizer=None):
    """One train step (graphed on the card: its warm-up) from replayed t
    and ε; returns ((loss, grad_norm), the state)."""
    from diffsci_tpu_torch import create_train_state, make_train_step

    state, tx = create_train_state(model, x.shape, seed=None,
                                   optimizer=optimizer)
    step = make_train_step(model, tx, loss_fn=loss_fn)
    _, met = step(state, x, y, sigma=t, eps=eps)
    return (float(met["train_loss"]), float(met["grad_norm"])), state


def phase_runtimes_card_vs_cpu():
    """Phase 31: L, M, N and O at small sizes, f32 with TF32 off, on the
    CPU (plain versions, eager) and the card (kernels, graphed entry
    points) from the same weights and replayed draws: L's Heun sample
    (graphed, 4 steps) on the linear and the "edm" path, its
    Euler–Maruyama loop with replayed noise and one train step with the
    running initial norm; M's Euler–Maruyama (10 steps) and Heun
    probability-flow (5 steps) loops and one step of its loss; N's DDPM
    and DDIM reverse processes (25 steps, the card's graphed) and one
    step under ``default_v1_optimizer``; O's loss, prediction and one
    step. Results within phase 2's tolerance (its atol relative to the
    loop's scale), train steps within phase 3's bounds (loss and
    grad_norm rtol 1e-3, parameters 99.9 % within 0.05·lr, all within
    2·lr), the running statistics within 1e-5. Returns the card's launch
    counts."""
    from diffsci_tpu_torch import default_v1_optimizer, kernels
    from diffsci_tpu_torch.models import sde

    rng = np.random.default_rng(31)

    def draw(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    shape_l, shape_m, shape_n = (2, 32, 32, 32, 1), (4, 28, 28, 1), \
        (4, 32, 32, 3)
    inputs = dict(
        l_x=draw(*shape_l), l_noise=draw(3, *shape_l), l_eps=draw(*shape_l),
        l_data=draw(*shape_l, scale=2.0) + 0.5,
        l_t=rng.uniform(0.05, 0.95, 2).astype(np.float32),
        m_x=draw(*shape_m), m_noise=draw(10, *shape_m),
        m_data=draw(*shape_m), m_eps=draw(*shape_m),
        m_t=rng.uniform(1e-3, 1.0, 4).astype(np.float32),
        n_x=draw(*shape_n), n_noise=draw(25, *shape_n),
        n_data=draw(*shape_n), n_eps=draw(*shape_n),
        n_t=rng.integers(1, 26, 4).astype(np.float32),
        o_x=draw(2, 16, 16, 1), o_y=draw(2, 8, 8, 4), o_z=draw(2, 8, 8, 4))
    lr = 1e-3
    runs = {}
    for dev in ("cpu", "cuda"):
        def t(name):
            return torch.from_numpy(inputs[name]).to(dev)

        models = small_runtimes(dev)
        L, Le, M, N, O = (models[k] for k in ("L", "L-edm", "M", "N", "O"))
        kernels.reset_launches()
        r = {}
        r["L heun"] = L.sample(2, shape_l[1:], nsteps=4,
                               orig_noise=t("l_x")).cpu()
        r["L edm heun"] = Le.sample(2, shape_l[1:], nsteps=4,
                                    orig_noise=t("l_x")).cpu()
        with torch.no_grad():
            r["L euler-maruyama"] = L.integrate_flow_field(
                t("l_x"), 4, noise_injection=True,
                noise_seq=t("l_noise")).cpu()
        r["L step"] = one_train_step(L, t("l_data"), None, t("l_t"),
                                     t("l_eps"))
        with torch.no_grad():
            x_T = M.scheduler.prior_scale(t("m_x")) * t("m_x")
            r["M euler-maruyama"] = sde.sde_sampler(
                M.scheduler, M.noise_predictor, 4, shape_m[1:], nsteps=10,
                noise_seq=t("m_noise"), x_T=x_T).cpu()
            r["M pf heun"] = sde.pf_sampler(
                M.scheduler, M.noise_predictor, 4, shape_m[1:], nsteps=5,
                x0=x_T).cpu()
        r["M step"] = one_train_step(
            M, t("m_data"), None, t("m_t"), t("m_eps"),
            loss_fn=lambda x, tt, y, mask, eps, M=M: M.loss_fn(
                x, y, t=tt, eps=eps))
        for sampler in ("ddpm", "ddim"):
            r[f"N {sampler}"] = N.backward(t("n_x"), sampler=sampler,
                                           noise_seq=t("n_noise")).cpu()
        r["N step"] = one_train_step(
            N, t("n_data"), None, t("n_t"), t("n_eps"),
            loss_fn=lambda x, tt, y, mask, eps, N=N: N.loss_fn(
                x, tt, y, noise=eps), optimizer=default_v1_optimizer())
        y_o = {"y": t("o_y")}
        with torch.no_grad():
            r["O loss"] = O.loss_fn(t("o_x"), y_o, train=False,
                                    z_eps=t("o_z")).cpu()[None]
        r["O predict"] = O.predict(y_o).cpu()
        r["O step"] = one_train_step(
            O, t("o_x"), y_o, torch.zeros(2, device=dev), t("o_z"),
            loss_fn=lambda x, s, y, mask, eps, O=O: O.loss_fn(
                x, y, mask, z_eps=eps))
        runs[dev] = (r, dict(kernels.LAUNCHES))
    (cpu, _), (card, counts) = runs["cpu"], runs["cuda"]
    ok, lines = True, []
    for name, ref in cpu.items():
        got = card[name]
        if name.endswith("step"):
            (m_cpu, s_cpu), (m_card, s_card) = ref, got
            ok_p, q999, worst = params_within(s_card.params, s_cpu.params,
                                              lr, 1)
            good = ok_p and np.isfinite(m_card).all() and np.allclose(
                m_card, m_cpu, rtol=1e-3, atol=0)
            for k, v in s_cpu.buffers.items():
                if "initial_norm" in k:
                    good = good and np.allclose(
                        s_card.buffers[k].cpu().numpy(), v.numpy(),
                        rtol=1e-5, atol=1e-7)
            lines.append(f"{name} (loss, grad_norm) card {m_card} cpu "
                         f"{m_cpu}, params 99.9% {q999:.2e} max "
                         f"{worst:.2e}{' ok' if good else ' FAIL'}")
        else:
            err, good = within_scale(got, ref)
            lines.append(f"{name} max|Δ| {err:.3e}"
                         f"{' ok' if good else ' FAIL'}")
        ok = ok and good
    log("[31 runtimes card-vs-cpu] " + "; ".join(lines))
    log(f"[31 runtimes card-vs-cpu] launches on the card {counts}")
    if not ok or not (counts["norm_silu"] and counts["norm_silu_bwd"]
                      and counts["flash_attention"]
                      and counts["flash_attention_dq"]):
        raise AssertionError("phase 31: the card disagrees with the CPU, "
                             "or a kernel of L's and M's path was not "
                             f"launched ({counts})")
    return [counts]


def request_device_time(label, fn, n):
    """A graphed request of ``n`` samples: its wall and, profiled, its
    device time and idle share."""
    pwall, busy, _, _ = profiled_shares(fn)
    log(f"[{label}] profiled request of {n}: wall {pwall:.4f} s, device "
        f"{busy:.4f} s, idle share {1 - busy / pwall:.3f}")


def si_isolation(label, model, shape, kw, nsteps):
    """One-row requests from 6 threads at once through a dispatcher
    service (buckets (1, 4)): each row bit for bit ``SIModel.sample`` of
    its row generator alone in the bucket its dispatch used. Its distance
    from the same row alone in bucket 1 is printed, not held: under bf16
    cuDNN picks its algorithms by the batch, and 29 Euler–Maruyama steps
    carry the rounding (phase 19 holds that bound on an f32 model)."""
    from diffsci_tpu_torch import SamplerService
    from diffsci_tpu_torch.serving import row_seeds

    svc = SamplerService(model, shape, batch_buckets=(1, 4), nsteps=nsteps,
                         sample_kwargs=kw, batch_window_ms=20.0)
    svc.warmup()
    record = recorded_dispatches(svc)
    results, wall = crowd(lambda s: svc.sample(1, s), range(500, 506))
    svc.close()
    bucket_of = {seeds[0]: b for b, reqs in record for seeds in reqs}
    same, worst, scale = 0, 0.0, 0.0
    for seed, got in results.items():
        row = row_seeds(seed, 1)[0]

        def alone(b):
            gen = torch.Generator("cuda").manual_seed(row)
            return model.sample(b, shape, [gen], nsteps=nsteps,
                                **kw)[:1].cpu().numpy()

        same += np.array_equal(got, alone(bucket_of[row]))
        worst = max(worst, float(np.abs(got - alone(1)).max()))
        scale = max(scale, float(np.abs(got).max()))
    ok = same == len(results)
    log(f"[{label}] dispatcher: 6 crowded one-row requests in {wall:.3f} "
        f"s, {len(record)} dispatches, buckets "
        f"{sorted(b for b, _ in record)}; {same} bit for bit their row "
        f"alone in their bucket {'ok' if ok else 'FAIL'}; against bucket "
        f"1 max|Δ| {worst:.3e} (max|x| {scale:.3f})")
    if not ok:
        raise AssertionError(f"{label}: a row depended on what it was "
                             "batched with")


def si_graph_vs_eager(label, model, shape, kw, nsteps=6, n=4):
    """A graphed request (its own service, bucket ``n``) against
    ``integrate_flow_field`` on the card from the same seed's draws: bit
    for bit, and the same bits twice."""
    from diffsci_tpu_torch import SamplerService

    svc = SamplerService(model, shape, batch_buckets=(n,), nsteps=nsteps,
                         sample_kwargs=kw)
    graph = svc.sample(n, generator=99)
    again = svc.sample(n, generator=99)
    g = torch.Generator("cuda").manual_seed(99)
    x = torch.randn((n,) + tuple(shape), generator=g, device="cuda")
    seq = torch.randn((nsteps - 1, n) + tuple(shape), generator=g,
                      device="cuda") if kw.get("noise_injection") else None
    with torch.no_grad():
        ref = model.integrate_flow_field(
            x * model._sigma_init(), nsteps, noise_seq=seq, **kw).cpu()
    same = np.array_equal(graph, ref.numpy())
    ok = same and np.array_equal(graph, again)
    log(f"[{label}] graphed request of {n} at nsteps {nsteps} against the "
        f"eager loop on its draws: bit for bit {same}, same seed same bits "
        f"{np.array_equal(graph, again)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the graphed request differs from "
                             "its eager body")


def train_graph_vs_eager(label, model, x_shape, weights, steps=3,
                         loss_fn=None, optimizer=None, y=None, seed=25):
    """``steps`` train steps eager (``_raw``) and graphed from the same
    weights and generator, under deterministic cuDNN: losses and
    parameters bit for bit."""
    from diffsci_tpu_torch import create_train_state, make_train_step

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    arms = {}
    for arm in ("eager", "graphed"):
        with torch.no_grad():
            for k, v in model.net.state_dict().items():
                v.copy_(weights[k])
        st, tx = create_train_state(model, x_shape, seed=None,
                                    optimizer=optimizer)
        fn = make_train_step(model, tx, loss_fn=loss_fn,
                             _raw=arm == "eager")
        g = torch.Generator("cuda").manual_seed(seed)
        x = torch.randn(x_shape, generator=g, device="cuda")
        mets = [float(fn(st, x, y, generator=g)[1]["train_loss"])
                for _ in range(steps)]
        arms[arm] = (mets, {k: v.detach().clone()
                            for k, v in st.params.items()})
        del st, fn
    torch.backends.cudnn.deterministic = det
    (m_e, p_e), (m_g, p_g) = arms["eager"], arms["graphed"]
    same = state_equal(p_e, p_g) and m_e == m_g
    log(f"[{label}] {steps} train steps graphed against eager from one "
        f"seed: losses {m_g} / {m_e}, bit for bit {same} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{label}: the graphed step differs from its "
                             "eager body")


def phase_l(zero):
    """Phase 32: L at full width (A's PUNetG, 32³, bf16 over f32 masters).
    Served through ``SamplerService`` at nsteps 30, buckets (1, 4),
    requests (1, 3, 6) and one seed twice (57 network calls a bucket run:
    57 × 20 K2 and 57 K4), then by the "edm" path and by Euler–Maruyama
    (29 calls) at bucket 4; each bucket's request timed by wall and
    device time; per-row isolation through the dispatcher (EM); the
    graphed Heun and EM requests against their eager loops at nsteps 6,
    bit for bit; 20 graphed train steps at batch 4 (20 K2, 20 K3, one K4,
    K5 and K6 a step, no K1; a falling loss) and 3 steps graphed against
    eager bit for bit; one ``inpaint`` of a 32³ volume (falloff 2, one
    resampling round: 58 network calls), its known region exact."""
    import gc

    from diffsci_tpu_torch import kernels

    shape = (32, 32, 32, 1)
    per_call = dict(norm_silu=NORMS_A, flash_attention=1)

    def calls(n):
        return dict(zero, **{k: v * n for k, v in per_call.items()})

    counts = []
    c, runs, svc = serve("config L", model_l(), shape, (1, 4), (1, 3, 6), 3,
                         SI_STEPS)
    if c != calls(SI_NFE * runs):
        raise AssertionError(f"L: launches {c}, expected "
                             f"{calls(SI_NFE * runs)}")
    counts.append(c)
    for b in (1, 4):
        request_device_time(f"config L bucket {b}",
                            lambda b=b: svc.sample(b), b)
    model = svc.model
    si_graph_vs_eager("config L", model, shape, {})
    del svc
    for label, make, kw, nfe in (
            ("config L edm", lambda: model_l(scheduler="edm",
                                             precondition_fn="edm"), {},
             SI_NFE),
            ("config L EM", model_l, {"noise_injection": True},
             SI_EM_NFE)):
        c, runs, svc = serve(label, make(), shape, (4,), (4,), 0, SI_STEPS,
                             sample_kwargs=kw)
        if c != calls(nfe * runs):
            raise AssertionError(f"{label}: launches {c}, expected "
                                 f"{calls(nfe * runs)}")
        counts.append(c)
        request_device_time(f"{label} bucket 4", lambda: svc.sample(4), 4)
        if kw:
            si_graph_vs_eager(label, svc.model, shape, kw)
            si_isolation(label, svc.model, shape, kw, SI_STEPS)
        del svc
        gc.collect()
        torch.cuda.empty_cache()

    per_step = dict(zero, norm_silu=NORMS_A, norm_silu_bwd=NORMS_A,
                    flash_attention=1, flash_attention_dq=1,
                    flash_attention_dkv=1)
    weights = {k: v.detach().clone()
               for k, v in model.net.state_dict().items()}
    c, model, _ = train("config L", None, (4,) + shape, 20, per_step,
                        model=model, profiled=True)
    counts.append(c)
    train_graph_vs_eager("config L", model, (4,) + shape, weights)

    gen = torch.Generator("cuda").manual_seed(32)
    x_orig = porous_batch(1, 32, gen)[0][0]
    mask = torch.zeros(shape, device="cuda")
    mask[:16] = 1.0
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.inpaint(x_orig, mask, nsamples=4, generator=gen,
                        nsteps=SI_STEPS, mask_falloff=2, resample_steps=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = dict(kernels.LAUNCHES)
    soft = model.create_soft_mask(mask, 2)
    known = (soft == 1.0).expand_as(out)
    exact = bool(torch.equal(out[known], x_orig.expand_as(out)[known]))
    ok = exact and bool(torch.isfinite(out).all()) and \
        c == calls(2 * SI_EM_NFE)
    log(f"[config L inpaint] 4 samples of 32³, half known, falloff 2, one "
        f"resampling round, {SI_STEPS} steps: wall {wall:.3f} s; known "
        f"region ({int(known.sum()) // 4} voxels a sample) exactly x_orig "
        f"{exact}; launches {c} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("L: inpaint's known region, values or launches "
                             "are wrong")
    counts.append(c)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def timed_steps(label, state, one, batch, per_step, zero, probe=None,
                steps=20, warmup=3):
    """``warmup`` graphed steps of ``one()`` (the first eager, then the
    capture), then ``steps`` timed by the host clock ended by a sync on
    the loss, the launch counts reset just before and read just after
    (``per_step`` each); one profiled step (device time, idle share).
    ``probe()``, a fixed-draw loss, is logged before and after. Returns the
    counts."""
    from diffsci_tpu_torch import kernels

    before = probe() if probe else None
    t0 = time.perf_counter()
    for _ in range(warmup):
        one()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    captures = [round(g.capture_seconds, 3)
                for g in state.graphs.graphs.values()]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        met = one()
        losses.append(met["train_loss"])
    last = float(met["train_loss"])                       # the sync
    dt = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    after = probe() if probe else None
    swall, sbusy = busy_seconds(one)
    log(f"[train {label}] batch {batch}: warm-up {warmup} steps "
        f"{warm:.2f} s, capture seconds {captures}; {steps} graphed steps "
        f"in {dt:.4f} s: {dt / steps:.4f} s/step, {batch * steps / dt:.2f} "
        f"items/s; peak memory {peak:.3f} GiB; loss first {losses[0]:.5f} "
        f"last {last:.5f}; fixed-draw loss {before} before, {after} after; "
        f"profiled step wall {swall:.4f} s, device {sbusy:.4f} s, idle "
        f"share {1 - sbusy / swall:.3f}; launches {counts}")
    expected = {k: v * steps for k, v in dict(zero, **per_step).items()}
    if not np.isfinite(losses).all() or counts != expected:
        raise AssertionError(f"{label}: non-finite loss, or launches "
                             f"{counts} are not {expected}")
    return counts


def step_graph_device_ms(label, graph, n=20):
    """Device time a step of a per-step sampler graph: ``n`` replays
    under torch.profiler."""
    def replays():
        for _ in range(n):
            graph.replay()

    wall, busy = busy_seconds(replays)
    log(f"[{label}] {n} replays of the step's graph: device "
        f"{busy / n * 1e3:.3f} ms a step, idle share {1 - busy / wall:.3f}")
    return busy / n


def timed_request(label, fn, n, steps):
    """One request: its wall (host clock ended by a sync), finite."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: non-finite samples")
    log(f"[{label}] request of {n}, {steps} step(s): wall {wall:.3f} s, "
        f"{n / wall:.2f} samples/s, {wall / steps * 1e3:.3f} ms a step, "
        f"std {float(out.std()):.4f}")
    return out


def phase_m(zero):
    """M: ``SDEModel`` around B's PUNetG (28² × 1, f32), VP linear (coef
    19.9), bucket 64: ``sde_sampler`` at 1000 steps and the Heun
    probability flow at 500 (1000 network calls), each step a replay of
    the step's graph (28 K2 a network call); device time a step from 20
    replays; both samplers graphed against eager at 20 steps, bit for
    bit; 20 graphed train steps at batch 256 through
    ``make_train_step(loss_fn=...)`` (28 K2 and 28 K3 a step)."""
    from diffsci_tpu_torch import (SDEModel, create_train_state, kernels,
                                   make_train_step)
    from diffsci_tpu_torch.models import sde

    model = SDEModel(punetg_b(), sde.VPSchedulerLinear(coef=19.9))
    model.init(seed=0)
    shape, n = (28, 28, 1), 64
    counts = []
    for pf, nsteps, nfe in ((False, M_EM_STEPS, M_EM_STEPS),
                            (True, M_PF_STEPS, 2 * M_PF_STEPS)):
        label = f"config M {'pf heun' if pf else 'euler-maruyama'}"
        t0 = time.perf_counter()
        graph = model.compile_sampler(n, shape, probability_flow=pf)
        torch.cuda.synchronize()
        log(f"[{label}] warm-up and capture of the step's graph "
            f"{time.perf_counter() - t0:.3f} s (capture "
            f"{graph.capture_seconds:.3f} s)")
        kernels.reset_launches()
        timed_request(label, lambda: model.sample(
            n, shape, torch.Generator("cuda").manual_seed(1), nsteps=nsteps,
            probability_flow=pf), n, nsteps)
        c = dict(kernels.LAUNCHES)
        if c != dict(zero, norm_silu=NORMS_B * nfe):
            raise AssertionError(f"{label}: launches {c}")
        counts.append(c)
        step_graph_device_ms(label, graph)
        out = model.sample(n, shape, torch.Generator("cuda").manual_seed(9),
                           nsteps=SHORT_STEPS, probability_flow=pf)
        g = torch.Generator("cuda").manual_seed(9)
        x = torch.randn((n,) + shape, generator=g, device="cuda")
        x = model.scheduler.prior_scale(x) * x
        with torch.no_grad():
            ref = (sde.pf_sampler(model.scheduler, model.noise_predictor, n,
                                  shape, nsteps=SHORT_STEPS, x0=x) if pf else
                   sde.sde_sampler(model.scheduler, model.noise_predictor,
                                   n, shape, nsteps=SHORT_STEPS, generator=g,
                                   x_T=x))
        same = torch.equal(out, ref)
        log(f"[{label}] graphed against eager at {SHORT_STEPS} steps: bit "
            f"for bit {same} {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"{label}: graph and eager differ")
    state, tx = create_train_state(model, (M_BATCH,) + shape, seed=None)
    step = make_train_step(model, tx, loss_fn=lambda x, t, y, mask, eps:
                           model.loss_fn(x, y, t=t, eps=eps))
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((M_BATCH,) + shape, generator=gen, device="cuda")
    pt = model.scheduler.sample((M_BATCH,), gen)
    pe = torch.randn(x.shape, generator=gen, device="cuda")

    def probe():
        with torch.no_grad():
            return round(float(model.loss_fn(x, t=pt, eps=pe, train=False)),
                         5)

    counts.append(timed_steps(
        "config M", state, lambda: step(state, x, generator=gen)[1],
        M_BATCH, dict(norm_silu=NORMS_B, norm_silu_bwd=NORMS_B), zero,
        probe))
    return counts


def punetg_b():
    """B's PUNetG (28² × 1, 64 channels, expansion (2, 4))."""
    from diffsci_tpu_torch import PUNetG, PUNetGConfig

    return PUNetG(PUNetGConfig(model_channels=64, channel_expansion=[2, 4]))


def phase_n(zero):
    """N: ``DDPMModuleV1`` around C's HFNet (32² × 3, f32), T 1000: one
    DDPM and one DDIM request at bucket 16 (each step a replay of the
    step's graph; no kernel of the port), device time a step from 20
    replays; both graphed against the eager step loop at T 20 (the same
    network), bit for bit; 20 graphed train steps at batch 128 under
    ``default_v1_optimizer``."""
    from diffsci_tpu_torch import (DDPMModuleV1, DDPMSchedulerV1, HFNetUncond,
                                   create_train_state, default_v1_optimizer,
                                   kernels, make_train_step)

    net = HFNetUncond(block_channels=(128, 256, 256, 256), channels=3,
                      attn_up_and_down=True)
    model = DDPMModuleV1(net, DDPMSchedulerV1(T=1000))
    model.init(seed=0)
    nparams = sum(p.numel() for p in model.net.parameters())
    shape, n = (32, 32, 3), 16
    counts = []
    for sampler in ("ddpm", "ddim"):
        label = f"config N {sampler}"
        t0 = time.perf_counter()
        graph = model.compile_sampler(n, shape, sampler=sampler)
        torch.cuda.synchronize()
        log(f"[{label}] {nparams} parameters; warm-up and capture of the "
            f"step's graph {time.perf_counter() - t0:.3f} s (capture "
            f"{graph.capture_seconds:.3f} s)")
        kernels.reset_launches()
        timed_request(label, lambda: model.sample(
            n, shape, torch.Generator("cuda").manual_seed(1),
            sampler=sampler), n, model.scheduler.T)
        c = dict(kernels.LAUNCHES)
        if c != zero:
            raise AssertionError(f"{label}: launches {c}")
        counts.append(c)
        step_graph_device_ms(label, graph)
        short = DDPMModuleV1(net, DDPMSchedulerV1(T=SHORT_STEPS))
        out = short.sample(n, shape, torch.Generator("cuda").manual_seed(9),
                           sampler=sampler)
        g = torch.Generator("cuda").manual_seed(9)
        x = torch.randn((n,) + shape, generator=g, device="cuda")
        nt = 0 if sampler == "ddim" else 1
        with torch.no_grad():
            for t in range(SHORT_STEPS, 0, -1):
                noise = torch.randn(x.shape, generator=g, device="cuda")
                x = short.step(x, torch.tensor(float(t), device="cuda"),
                               noise, sampler=sampler, noise_type=nt)
        same = torch.equal(out, x)
        log(f"[{label}] graphed against eager at T {SHORT_STEPS}: bit for "
            f"bit {same} {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"{label}: graph and eager differ")
        del short
    state, tx = create_train_state(model, (N_BATCH,) + shape, seed=None,
                                   optimizer=default_v1_optimizer())
    step = make_train_step(model, tx, loss_fn=lambda x, t, y, mask, eps:
                           model.loss_fn(x, t, y, noise=eps))
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((N_BATCH,) + shape, generator=gen, device="cuda")
    pt = model.scheduler.sample((N_BATCH,), gen)
    pe = torch.randn(x.shape, generator=gen, device="cuda")

    def probe():
        with torch.no_grad():
            return round(float(model.loss_fn(x, pt, noise=pe)), 5)

    counts.append(timed_steps(
        "config N", state, lambda: step(state, x, generator=gen)[1],
        N_BATCH, {}, zero, probe))
    return counts


def phase_o(zero):
    """O: ``ForecastModel`` over G's autoencoder (256² × 1 fields ↔ 32² × 4
    latents, f32) with ``ForecastHead`` at 64 channels, Huber loss, batch
    8 with a one-frame latent window: 20 graphed train steps (the encoder
    inside the step) and one ``sample(maximum_batch_size=4)`` of 8 (two
    chunks, each decoded), timed by wall and device time; no kernel of
    the port."""
    from diffsci_tpu_torch import (ForecastModel, ForecastModelConfig,
                                   create_train_state, kernels,
                                   make_train_step)

    model = ForecastModel(ForecastHead(4, 64), ForecastModelConfig(
        loss_metric="huber"), autoencoder=bound_g())
    model.init(seed=0)
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((O_BATCH, G_PIX, G_PIX, 1), generator=gen, device="cuda")
    # the window: one latent frame [8, 32, 32, 4]
    y = {"y": torch.randn(model.latent_shape(x.shape), generator=gen,
                          device="cuda")}
    state, tx = create_train_state(model, x.shape, seed=None)
    # the ε slot (the latent's shape) carries the posterior's draw
    step = make_train_step(model, tx, loss_fn=lambda xx, s, yy, mask, eps:
                           model.loss_fn(xx, yy, mask, z_eps=eps))
    pz = torch.randn(model.latent_shape(x.shape), generator=gen,
                     device="cuda")

    def probe():
        with torch.no_grad():
            return round(float(model.loss_fn(x, y, train=False, z_eps=pz)),
                         5)

    counts = [timed_steps("config O", state,
                          lambda: step(state, x, y, generator=gen)[1],
                          O_BATCH, {}, zero, probe)]
    kernels.reset_launches()
    out = timed_request("config O sample", lambda: model.sample(
        y, maximum_batch_size=4), O_BATCH, 1)
    request_device_time("config O sample", lambda: model.sample(
        y, maximum_batch_size=4), O_BATCH)
    c = dict(kernels.LAUNCHES)
    # chunks of 4 against one call of 8 in f32: with TF32 cuDNN's
    # algorithms differ by the batch (9.3e-3 apart through G's decoder)
    torch.backends.cudnn.allow_tf32 = False
    chunked, whole = (model.sample(y, maximum_batch_size=m).cpu()
                      for m in (4, None))
    torch.backends.cudnn.allow_tf32 = True
    err, ok = within_phase2(chunked, whole)
    ok = ok and out.shape == (O_BATCH, G_PIX, G_PIX, 1) and c == zero
    log(f"[config O sample] chunked (4 + 4) against one call of 8, TF32 "
        f"off: max|Δ| {err:.3e} (phase 2's tolerance), shape "
        f"{tuple(out.shape)}, launches {c} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("O: the chunked sample is wrong")
    return counts + [c]



# ---------------------------------------------------------------------------
# phases 34 to 36: the porous-media extras (Q) and the metrics (P)
# ---------------------------------------------------------------------------
Q_BASE = (32, 32, 32, 1)   # a cube of the grid, a block of the stack
Q_GRID = (2, 2, 2)         # 64³ volumes: cubes of 36³ plain, 40³ periodic
Q_OVERLAP = 8
Q_BLOCKS = 3               # the sequential stack: 32 × 32 × 96
Q_PAD = 8                  # the periodizer's pad and blend width (48³)
Q_LATENT, Q_CHUNK = 128, 32    # the tiled decode: 128² × 4 -> 1024² × 1
Q_DECODER = dict(has_mid_attn=False)   # G's DDConfig without mid attention
Q_MATERN = {"sigma_sq": 1.0, "nu": 1.5, "length_scale": 32.0}
# in a periodic (2, 2, 2) grid each of the 7 inpainted cubes' windows wraps
# on all 3 axes (the lower one before 0, the upper one past the end)
WRAPS_2X2X2 = 7 * 3
P_N, P_TEST, P_BATCH = 2048, 1024, 64
P_FLD_ITERS = 200


def model_q(dev="cuda", cfg=None, dtype=torch.bfloat16):
    """Configuration Q: an ``SIModel`` (linear path, Huber) around A's
    PUNetG with D's porosity conditioning (``PorosityEmbedder`` of the
    model's width) and default convolutions, bf16 over f32 masters."""
    from diffsci_tpu_torch import PUNetG, PUNetGConfig, SIModel, SIModelConfig
    from diffsci_tpu_torch.models.nets import PorosityEmbedder

    cfg = cfg or PUNetGConfig(dimension=3, model_channels=32,
                              channel_expansion=[2], num_heads=2,
                              attn_backend="flash")
    return SIModel(PUNetG(cfg, conditional_embedding=PorosityEmbedder(
        cfg.model_channels), device=dev), SIModelConfig(
            scheduler="linear", loss_metric="huber"),
        compute_dtype=dtype, device=dev)


class Recorded:
    """An ``SIModel`` whose samples and inpaints are kept, with each
    inpaint's x_orig and mask, for the known-region check after a run."""

    def __init__(self, model):
        self.model, self.device, self.calls = model, model.device, []

    def sample(self, *args, **kw):
        out = self.model.sample(*args, **kw)
        self.calls.append(("sample", kw.get("orig_noise"), None, out))
        return out

    def inpaint(self, x_orig, mask, **kw):
        out = self.model.inpaint(x_orig, mask, **kw)
        self.calls.append(("inpaint", x_orig, mask, out))
        return out

    def known_exact(self) -> tuple[int, bool]:
        """(inpaints, whether each left its known region, mask 1 with
        falloff 0, as its x_orig and its values finite)."""
        n, ok = 0, True
        for kind, x_orig, mask, out in self.calls:
            if kind == "inpaint":
                known = mask == 1.0
                ok = ok and bool(known.any()) and bool(torch.equal(
                    out[0][known], x_orig[known])) and bool(
                        torch.isfinite(out).all())
                n += 1
        return n, ok

    def windows_exact(self, vol, grid_map, base, overlap, periodicity):
        """(the cube windows that wrap an axis, whether each inpaint of the
        first run read as its known region what the finished volume
        ``vol`` holds there). Each window is gathered here from the grid by
        modular indices, apart from ``get_cube_spatial_bounds`` and the
        periodic getitem/setitem, so a wrap that goes wrong on the read or
        the write shows; a later cube rewrites a known region unchanged,
        so the first value written is what stays."""
        from diffsci_tpu_torch.extra import get_grid_generation_order

        order, corners = get_grid_generation_order(grid_map)
        todo = order[corners:]
        inpaints = [c for c in self.calls if c[0] == "inpaint"][:len(todo)]
        final = [b * g for b, g in zip(base, grid_map)]
        wraps, ok = 0, len(inpaints) == len(todo)
        for pos, (_, x_orig, mask, _) in zip(todo, inpaints):
            window = vol[0]
            for a, (p, b, n, per) in enumerate(zip(pos, base, final,
                                                   periodicity)):
                ids = np.arange(p * b - overlap // 2,
                                (p + 1) * b + overlap // 2)
                if per:
                    wraps += int(ids[0] < 0 or ids[-1] >= n)
                    ids = ids % n
                else:
                    ids = ids[(ids >= 0) & (ids < n)]
                window = window.index_select(a, torch.as_tensor(
                    ids, device=vol.device))
            known = mask == 1.0
            ok = ok and window.shape == x_orig.shape and bool(
                torch.equal(window[known], x_orig[known]))
        return wraps, ok


def within_rel(out, ref):
    """Phase 2's rtol 1e-3 with its atol 1e-3 taken of the result's
    largest entry (the features of synthetic weights are ~1e-3)."""
    out, ref = out.float().cpu(), ref.float().cpu()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    return err, bool(torch.isfinite(out).all()) and bool(
        ((out - ref).abs() <= 1e-3 * ref.abs() + 1e-3 * scale).all())


class LocalDecoder(torch.nn.Module):
    """A norm-free local decoder (``tests/test_extra.py``'s: conv, SiLU,
    2× nearest upsample, conv; receptive radius 1 + 1/2 latent units, so
    halo 2 is exact), [B, 4, H, W] -> [B, 1, 2H, 2W]."""

    def __init__(self, dev):
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.w1 = torch.randn((16, 4, 3, 3), generator=g).to(dev) * 0.3
        self.w2 = torch.randn((1, 16, 3, 3), generator=g).to(dev) * 0.3

    def forward(self, z):
        h = F.silu(F.conv2d(z, self.w1, padding=1))
        h = h.repeat_interleave(2, 2).repeat_interleave(2, 3)
        return F.conv2d(h, self.w2, padding=1)


def periodic_pad(z, halo):
    """z [B, C, *spatial] padded by ``halo`` on every spatial side with its
    periodic continuation."""
    for d in range(2, z.ndim):
        ids = torch.arange(-halo, z.shape[d] + halo, device=z.device)
        z = z.index_select(d, ids % z.shape[d])
    return z


def mark_memory() -> int:
    """Reset the peak-memory counter; returns the bytes allocated now (what
    earlier phases and the phase's models hold), for ``peak_above``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_above(base: int) -> str:
    """The peak device memory since ``mark_memory`` above its ``base``."""
    return f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.3f} GiB"


def seam_and_interior(vol, i) -> tuple[float, float]:
    """The total over spatial dims of the MSE between a channels-last
    volume's opposite faces (``measure_periodicity_error``) and between the
    adjacent interior slices i - 1 and i."""
    from diffsci_tpu_torch.extra import measure_periodicity_error

    seam = measure_periodicity_error(vol, dimension=3)["total_mse"]
    interior = sum(float(((vol.select(a, i - 1) - vol.select(a, i)) ** 2)
                         .mean()) for a in (1, 2, 3))
    return seam, interior


def phase_extras_card_vs_cpu():
    """Phase 34: the metrics and the extras at small sizes, card against
    CPU, f32 with TF32 off (phase 2's bounds, the atol of the result's
    scale): the InceptionV3 on a 2-image batch at 75² from the same
    synthetic weights and the 299² resize from 28² and from 512²; FLD
    (d 64) with TF32 on, and its distances of 2048-d features against
    float64 (within 1e-5 of their scale, where TF32 is ~1e-3 off); the
    grid orchestrator with a small porosity-conditioned SIModel (phase 2's
    net) from one replayed noise cube, plain and periodic: the corner cube
    (deterministic Heun, the card's graphed sampler) agrees and every
    inpainted cube keeps its known region on both, each read where the
    finished volume holds it (21 wrapped windows in the periodic grid);
    the tiled decode with
    a norm-free local decoder on the card equals the one-shot decode of
    the periodically padded latent. Returns the card's launch counts."""
    from diffsci_tpu_torch import kernels, metrics
    from diffsci_tpu_torch.extra import matern_grid_sample, sample_grid_volume
    from diffsci_tpu_torch.extra import tiled_decode
    from diffsci_tpu_torch.metrics_inception import InceptionV3FID

    fails = []

    def report(label, err, ok, extra=""):
        log(f"[extras card-vs-cpu] {label}: max|Δ| {err:.3e}{extra} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(label)

    gen = torch.Generator().manual_seed(34)
    x = torch.rand((2, 3, 75, 75), generator=gen) * 2 - 1
    with torch.no_grad():
        ref = InceptionV3FID(device="cpu").init(0)(x)
        out = InceptionV3FID(device="cuda").init(0)(x.to("cuda"))
    report(f"InceptionV3 75², batch 2 (max|ref| "
           f"{float(ref.abs().max()):.3e})", *within_rel(out, ref))
    for size in (28, 512):
        img = torch.rand((2, 3, size, size), generator=gen)
        kw = dict(size=(299, 299), mode="bilinear", align_corners=False,
                  antialias=False)
        report(f"resize {size} -> 299", *within_rel(
            F.interpolate(img.to("cuda"), **kw), F.interpolate(img, **kw)))

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        a = torch.randn((256, 2048), generator=gen)
        b = torch.randn((256, 2048), generator=gen)
        ac, bc = a.to("cuda"), b.to("cuda")
        d2 = metrics._pairwise_sq_dists(ac, bc).cpu().double()
        ref64 = torch.cdist(a.double(), b.double()) ** 2
        # the same expression as one product under the TF32 flag
        tf32 = ((ac * ac).sum(1)[:, None] + (bc * bc).sum(1)[None]
                - 2 * ac @ bc.T).cpu().double()
        err = float((d2 - ref64).abs().max())
        report("FLD distances, 2048-d, TF32 flag on", err,
               err <= 1e-5 * float(ref64.max()),
               f" (limit 1e-5 × {float(ref64.max()):.0f}; a TF32 product: "
               f"{float((tf32 - ref64).abs().max()):.3e})")
        train, test = torch.randn((512, 64), generator=gen), torch.randn(
            (256, 64), generator=gen)
        fake = torch.randn((256, 64), generator=gen) + 0.3
        kw = dict(n_iters=50, seed=0)
        card = metrics.fld(train, test, fake, **kw)
        cpu = metrics.fld(train, test, fake, device="cpu", **kw)
        report(f"FLD d 64, 50 steps, TF32 flag on ({card:.4f} against "
               f"{cpu:.4f})", abs(card - cpu),
               abs(card - cpu) <= 1e-3 * max(1.0, abs(cpu)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False

    counts = []
    noise = torch.randn((1, 16, 16, 16, 1), generator=gen)
    for label, per in (("plain", (False,) * 3), ("periodic", (True,) * 3)):
        vols, recs = {}, {}
        for dev in ("cuda", "cpu"):
            model = model_q(dev, small_3d_config(), None)
            model.init(seed=1)
            conds = matern_grid_sample((16,) * 3, (2, 2, 2), 0.0, Q_MATERN,
                                       as_condition=True, seed=0,
                                       device=dev)[0]
            recs[dev] = Recorded(model)
            kernels.reset_launches()
            vols[dev] = sample_grid_volume(
                recs[dev], torch.Generator(dev).manual_seed(5), (2, 2, 2),
                (8, 8, 8, 1), 4, y=conds, nsteps=4, periodicity=per,
                noise_cube=noise).cpu()
            if dev == "cuda":
                counts.append(dict(kernels.LAUNCHES))
        corner = {d: r.calls[0][3].cpu() for d, r in recs.items()}
        err, ok = within_scale(corner["cuda"], corner["cpu"])
        known = {d: r.known_exact() for d, r in recs.items()}
        windows = {d: r.windows_exact(vols[d].to(d), (2, 2, 2), (8, 8, 8), 4,
                                      per) for d, r in recs.items()}
        ok = ok and all(k == (7, True) for k in known.values()) and all(
            w == (WRAPS_2X2X2 if per[0] else 0, True)
            for w in windows.values()) and bool(
            torch.isfinite(vols["cuda"]).all())
        report(f"grid volume {label} (2, 2, 2) of 8³, 4 steps: corner cube "
               f"{tuple(corner['cpu'].shape)} (max|ref| "
               f"{float(corner['cpu'].abs().max()):.3f}); inpaints and "
               f"known regions exact {known}; (wrapped windows, known "
               f"regions as the volume holds them) {windows}", err, ok)

    dec = LocalDecoder("cuda")
    z = torch.randn((1, 4, 32, 32), generator=gen).to("cuda")
    with torch.no_grad():
        tiled = tiled_decode(dec, z, (8, 8), halo=2, upscale=2)
        full = dec(periodic_pad(z, 2))[:, :, 4:-4, 4:-4]
    report("tiled decode (32² in 8² tiles, halo 2) against the one-shot "
           "decode of the periodic padding", *within_rel(tiled, full),
           f", shape {tuple(tiled.shape)} on the host")
    if fails:
        raise AssertionError(f"phase 34: {fails}")
    return counts


def phase_q(zero):
    """Phase 35: Q at full width (A's PUNetG with a porosity embedding, 30
    steps, bf16 over f32 masters). Two 64³ grid volumes (grid (2, 2, 2) of
    32³ cubes, overlap 8; per-cube porosities from a Matern field over
    the grid), plain (36³ cubes) and periodic (40³): the corner cube one
    graphed Heun sample (57 network calls), then 7 eager inpaints of 29
    Euler–Maruyama calls, so 260 calls (5200 K2 and 260 K4) a volume;
    each inpainted cube's known region exact and equal to what the
    finished volume holds at the cube's window, gathered by modular
    indices (the periodic volume's 21 wrapped windows among them); the
    seams' and interior slices' MSE reported. The sequential
    stack (3 blocks of 32³, overlap 8, cosine blend, porosity 0.3 to 0.4):
    3 × 29 calls. The periodizer (pad and blend 8) around the flow field
    at 32³: one call at 48³; the periodicity error before and after. The
    tiled decode of a 128² × 4 latent through G's decoder without mid
    attention in 32² tiles (halo ``decoder_halo_radius``): no kernel of
    the port, its max|Δ| from the one-shot decode of the periodically
    padded latent reported (G's GroupNorms make it tile-dependent). Each
    timed by the host clock, the periodizer and the decode by their
    device time too (a profiled rerun); peak memory."""
    from diffsci_tpu_torch import kernels
    from diffsci_tpu_torch.extra import (DiffusionPeriodizer,
                                         decoder_halo_radius,
                                         make_vertical_porosity_map,
                                         matern_grid_sample,
                                         measure_periodicity_error,
                                         sample_grid_volume,
                                         sample_sequential_z, tiled_decode,
                                         upscale_factor)
    from diffsci_tpu_torch.models.nets.layers import init_parameters
    from diffsci_tpu_torch.models.nets.vae import AutoencoderKL, DDConfig

    per_call = dict(norm_silu=NORMS_A, flash_attention=1)

    def calls(n):
        return dict(zero, **{k: v * n for k, v in per_call.items()})

    def timed(label, fn, expected, profile=True):
        """One run with the counts reset just before and read just after
        (host clock ended by a sync); then, with ``profile``, its device
        time: one more run under the profiler."""
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        if profile:
            busy = profiled_shares(fn, host=False)[1]
            log(f"[config Q {label}] wall {wall:.3f} s, device {busy:.4f} "
                f"s, idle share {1 - busy / wall:.3f} (measured in "
                f"{time.perf_counter() - t0:.1f} s); launches {c}")
        else:
            log(f"[config Q {label}] wall {wall:.3f} s, device time not "
                f"measured (no profiled rerun); launches {c}")
        if c != expected:
            raise AssertionError(f"Q {label}: launches {c}, expected "
                                 f"{expected}")
        return out, c

    model = model_q()
    model.init(seed=0)
    final = tuple(b * g for b, g in zip(Q_BASE, Q_GRID))
    conds = matern_grid_sample(final, Q_GRID, 0.0, Q_MATERN,
                               as_condition=True, seed=0)[0]
    log(f"[config Q] porosities of the grid "
        f"{[round(float(conds[p]['porosity']), 4) for p in np.ndindex(*Q_GRID)]}")
    base = mark_memory()
    counts = []
    # the volumes and the stack run once, unprofiled; the periodizer and
    # the decode are profiled
    for label, per in (("plain", (False,) * 3), ("periodic", (True,) * 3)):
        ext = (Q_BASE[0] + (Q_OVERLAP if per[0] else Q_OVERLAP // 2),) * 3
        graph = model.compile_sampler(1, ext + (1,), y=conds[0, 0, 0],
                                      nsteps=SI_STEPS, is_latent_shape=True,
                                      return_latents=True)
        log(f"[config Q {label}] corner cube {ext}: capture "
            f"{graph.capture_seconds:.3f} s")
        rec = Recorded(model)
        gen = torch.Generator("cuda").manual_seed(35)
        vol, c = timed(f"grid volume {label}", lambda: sample_grid_volume(
            rec, gen, Q_GRID, Q_BASE, Q_OVERLAP, y=conds, nsteps=SI_STEPS,
            periodicity=per), calls(SI_NFE + 7 * SI_EM_NFE), profile=False)
        counts.append(c)
        n, exact = rec.known_exact()
        wraps, held = rec.windows_exact(vol, Q_GRID, Q_BASE[:3], Q_OVERLAP,
                                        per)
        # slices inside the first cube's base, away from its seams
        seam, interior = seam_and_interior(vol, Q_BASE[0] // 2)
        ok = exact and n == 7 and held and wraps == (
            WRAPS_2X2X2 if per[0] else 0) and vol.shape == (
                1,) + final + (1,) and bool(torch.isfinite(vol).all())
        log(f"[config Q {label}] volume {tuple(vol.shape)}, std "
            f"{float(vol.std()):.4f}; {n} inpaints, known regions exact "
            f"{exact}; {wraps} wrapped cube windows, every known "
            f"region as the finished volume holds it {held}; opposite "
            f"faces' MSE {seam:.4f} against adjacent interior slices' "
            f"{interior:.4f} (over {seam / interior:.3f}; the untrained "
            f"net's adjacent slices are no closer than any two) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"Q {label}: the volume, its known "
                                 "regions or its wrap are wrong")

    ymap = list(make_vertical_porosity_map([0.3, 0.4], grid_size=(1, 1))[0,
                                                                         0])
    first = (Q_BASE[0], Q_BASE[1], Q_BASE[2] + Q_OVERLAP // 2, 1)
    graph = model.compile_sampler(1, first, y=ymap[0], nsteps=SI_STEPS,
                                  is_latent_shape=True, noise_injection=True,
                                  return_latents=True)
    log(f"[config Q sequential] first block {first[:3]} (Euler–Maruyama): "
        f"capture {graph.capture_seconds:.3f} s")
    rec = Recorded(model)
    gen = torch.Generator("cuda").manual_seed(36)
    vol, c = timed("sequential stack", lambda: sample_sequential_z(
        rec, gen, Q_BLOCKS, Q_BASE, Q_OVERLAP, y=ymap, nsteps=SI_STEPS),
        calls(Q_BLOCKS * SI_EM_NFE), profile=False)
    counts.append(c)
    n, exact = rec.known_exact()
    ok = exact and n == Q_BLOCKS - 1 and vol.shape == (
        1, Q_BASE[0], Q_BASE[1], Q_BLOCKS * Q_BASE[2], 1) and bool(
            torch.isfinite(vol).all())
    log(f"[config Q sequential] stack {tuple(vol.shape)}, std "
        f"{float(vol.std()):.4f}; known regions exact over {n} inpaints "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("Q: the sequential stack is wrong")

    x = torch.randn((1,) + Q_BASE, generator=gen, device="cuda")
    t = torch.full((1,), 0.5, device="cuda")
    y = conds[0, 0, 0]

    def flow(xx):
        with torch.inference_mode():
            return model.get_flow_field(xx, t, y)

    periodizer = DiffusionPeriodizer(flow, pad=Q_PAD, blend_width=Q_PAD)
    raw = flow(x)
    periodizer(x)       # cuDNN's first calls at the expanded shape
    out, c = timed("periodizer", lambda: periodizer(x), calls(1))
    counts.append(c)
    before = measure_periodicity_error(raw)["total_mse"]
    after = measure_periodicity_error(out)["total_mse"]
    ok = out.shape == x.shape and bool(torch.isfinite(out).all())
    log(f"[config Q periodizer] flow field at {Q_BASE[0]}³ through the net "
        f"at {Q_BASE[0] + 2 * Q_PAD}³: opposite faces' MSE {before:.4f} raw, "
        f"{after:.4f} periodized {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("Q: the periodizer's output is wrong")
    captured = model._graph_cache().graphs.values()
    log(f"[config Q] {len(captured)} graphs captured (one a cube or block "
        f"shape that is sampled), "
        f"{sum(g.capture_seconds for g in captured):.3f} s of capture; peak "
        f"memory of the volumes, the stack and the periodizer "
        f"{peak_above(base)} above the model")
    del model, rec
    torch.cuda.empty_cache()

    cfg = DDConfig(**Q_DECODER)
    ae = AutoencoderKL(cfg, embed_dim=4)
    init_parameters(ae, 0)
    halo, up = decoder_halo_radius(cfg), upscale_factor(cfg)
    z = torch.randn((1, 4, Q_LATENT, Q_LATENT), generator=gen, device="cuda")
    with torch.inference_mode():
        # cuDNN's first calls at the tile's shape (every tile has one)
        ae.decode(z[:, :, :Q_CHUNK + 2 * halo, :Q_CHUNK + 2 * halo])
        base = mark_memory()
        tiled, c = timed(f"tiled decode (halo {halo}, x{up})",
                         lambda: tiled_decode(ae.decode, z, (Q_CHUNK,) * 2,
                                              halo, up), zero)
        counts.append(c)
        peak_tiled = peak_above(base)
        base = mark_memory()
        t0 = time.perf_counter()
        full = ae.decode(periodic_pad(z, halo))
        full = full[:, :, halo * up:-halo * up, halo * up:-halo * up].cpu()
        wall = time.perf_counter() - t0
        peak_full = peak_above(base)
    err = float((tiled - full).abs().max())
    ok = tiled.shape == (1, 1, Q_LATENT * up, Q_LATENT * up) and bool(
        torch.isfinite(tiled).all())
    log(f"[config Q tiled decode] {Q_LATENT}² × 4 -> {tuple(tiled.shape)} "
        f"in {Q_CHUNK}² tiles: peak memory {peak_tiled} above the latent "
        f"and the decoder against {peak_full} one-shot ({wall:.3f} s); "
        f"max|Δ| from the one-shot decode {err:.3e} (max|ref| "
        f"{float(full.abs().max()):.3f}; GroupNorm over each tile) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("Q: the tiled decode is wrong")
    return counts


def phase_p(zero):
    """Phase 36: P at pytorch-fid's widths. B's ``KarrasModel`` (28² × 1,
    bf16, random weights from seed 0) samples 2048 "real", 2048
    "generated" and 1024 test images at bucket 64 (18-step Heun, seeds 1,
    2, 3: exactly 35 K1 and 980 K2 a bucket run), mapped by x·0.5 + 0.5
    (``scripts/eval_fid.py``); a "far" set is the generated one plus
    N(0, 0.3²), clipped to [0, 1]. The pytorch-fid InceptionV3 (synthetic
    weights, seed 0, f32) takes their pool3 features at batch 64 through
    the 299² resize (images/s; no kernel of the port); then FID and KID
    (host float64), FLD and its generalization gap at d 2048 (train the
    real set, test the 1024, gen the first 1024, 200 Adam steps on the
    card). Gates: finite [N, 2048] features; FID and KID of the real set
    with itself ~0; generated closer to real than far by FID, KID and
    FLD. Returns the launch counts."""
    from diffsci_tpu_torch import PUNetGConfig, kernels, metrics
    from diffsci_tpu_torch.metrics_inception import (InceptionV3FID,
                                                     inception_fid_features)

    model = karras(PUNetGConfig(model_channels=64, channel_expansion=[2, 4]))
    model.init(seed=0)
    shape = (28, 28, 1)
    model.compile_sampler(P_BATCH, shape, nsteps=NSTEPS)

    def draw(n, seed):
        g = torch.Generator("cuda").manual_seed(seed)
        out = torch.cat([model.sample(P_BATCH, shape, g, nsteps=NSTEPS)
                         for _ in range(n // P_BATCH)])
        return out * 0.5 + 0.5

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    real, fake, test = draw(P_N, 1), draw(P_N, 2), draw(P_TEST, 3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sampled = dict(kernels.LAUNCHES)
    runs = (2 * P_N + P_TEST) // P_BATCH
    expected = dict(zero, fused_axby=NFE * runs,
                    norm_silu=NORMS_B * NFE * runs)
    log(f"[config P] B's samples: {runs} bucket runs of {P_BATCH} in "
        f"{wall:.3f} s; x·0.5 + 0.5 in [{float(real.min()):.3f}, "
        f"{float(real.max()):.3f}]; launches {sampled}")
    if sampled != expected:
        raise AssertionError(f"P: launches {sampled}, expected {expected}")
    g = torch.Generator("cuda").manual_seed(4)
    far = (fake + 0.3 * torch.randn(fake.shape, generator=g, device="cuda")
           ).clamp(0, 1)
    del model
    torch.cuda.empty_cache()

    net = InceptionV3FID().init(0)
    inception_fid_features(net, real[:P_BATCH])     # cuDNN's first calls
    kernels.reset_launches()
    base = mark_memory()
    t0 = time.perf_counter()
    f_real = inception_fid_features(net, real, P_BATCH)
    f_fake = inception_fid_features(net, fake, P_BATCH)
    wall = time.perf_counter() - t0
    f_far = inception_fid_features(net, far, P_BATCH)
    f_test = inception_fid_features(net, test, P_BATCH)
    pwall, busy = busy_seconds(lambda: inception_fid_features(
        net, real[:P_TEST], P_BATCH))
    c = dict(kernels.LAUNCHES)
    feats = (f_real, f_fake, f_far, f_test)
    ok = all(f.shape == (len(x), 2048) and np.isfinite(f).all()
             for f, x in zip(feats, (real, fake, far, test))) and c == zero
    log(f"[config P features] 2 × {P_N} images through the 299² resize: "
        f"{wall:.3f} s, {2 * P_N / wall:.1f} images/s; {P_TEST} profiled: "
        f"device {busy:.4f} s ({P_TEST / busy:.1f} images/s), idle share "
        f"{1 - busy / pwall:.3f}; peak memory {peak_above(base)} above the "
        f"images and the net; feature "
        f"scale {float(np.abs(f_real).max()):.3e}; launches {c} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("P: the features are wrong")
    del net
    torch.cuda.empty_cache()

    # the three host square roots side by side (LAPACK frees the GIL)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        fid_rg, fid_self, fid_rf = pool.map(
            metrics.fid, (f_real, f_real, f_real), (f_fake, f_real, f_far))
    t_fid = time.perf_counter() - t0
    t0 = time.perf_counter()
    kid_rg = metrics.kid(f_real, f_fake)
    t_kid = time.perf_counter() - t0
    kid_self, kid_rf = metrics.kid(f_real, f_real), metrics.kid(f_real, f_far)
    kw = dict(n_iters=P_FLD_ITERS, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fld_rg = metrics.fld(f_real, f_test, f_fake[:P_TEST], **kw)
    t_fld = time.perf_counter() - t0
    fld_rf = metrics.fld(f_real, f_test, f_far[:P_TEST], **kw)
    gap_rg = metrics.fld_generalization_gap(f_real, f_fake[:P_TEST], **kw)
    gap_rf = metrics.fld_generalization_gap(f_real, f_far[:P_TEST], **kw)
    ok = (abs(fid_self) <= 1e-3 * fid_rf and abs(kid_self) <= 5e-2 * kid_rf
          and fid_rg < fid_rf and kid_rg < kid_rf and fld_rg < fld_rf)
    log(f"[config P metrics] FID real/real {fid_self:.4e}, real/generated "
        f"{fid_rg:.6e}, real/far {fid_rf:.6e} (host sqrtm of 2048²: "
        f"{t_fid:.3f} s for the three side by side); KID "
        f"{kid_self:.4e}, {kid_rg:.6e}, "
        f"{kid_rf:.6e} ({t_kid:.3f} s); FLD generated {fld_rg:.4f}, far "
        f"{fld_rf:.4f} ({t_fld:.3f} s a FLD: two fits of {P_FLD_ITERS} "
        f"steps on the card); generalization gap {gap_rg:.4f}, "
        f"{gap_rf:.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("P: the metrics do not order real, generated "
                             "and far, or a set is not ~0 from itself")
    return [sampled, c]


# ---------------------------------------------------------------------------
# phase 37: the parallel modes (torch.distributed)
# ---------------------------------------------------------------------------
PAR_BACKEND = "nccl"       # part (a)'s process group
PAR_STEPS = 3              # steps held bit for bit (or to phase 3's bounds)
PAR_TIMED = 20             # steps timed on the host clock
PAR_B_BATCH = 256          # B's train batch (phase 8's)
PAR_H_SIDE = 256           # H's fields
PAR_WORLD = 2              # part (b): ranks sharing the one card over gloo
PAR_TIMEOUT = 120          # seconds a group of part (b) may take
# phase 37 (a)'s DP arm (ms a step, device ms), which phase 39 reports
PAR_DP_TIMES: dict = {}
# the collectives of each mode of part (b), and the probes that carry them
PAR_MODES = {
    "dp_step": ("broadcast", "all_reduce"),
    "bnorm_step": ("broadcast", "all_reduce"),
    "fsdp_step": ("broadcast", "all_reduce", "all_gather",
                  "reduce_scatter"),
    "tp_step": ("broadcast", "all_reduce", "all_gather"),
    "dp_sampling": ("all_gather",),
    "ep_forward": ("all_gather", "all_to_all_single", "all_reduce"),
    "pipeline": ("all_reduce", "broadcast", "batch_isend_irecv"),
    "halo_decode": ("batch_isend_irecv", "all_gather"),
}


def par_arm(label, cfg, x, mesh, arm):
    """B's train step (bf16 over f32 masters, AdamW, power EMA every 4
    steps, seed 0, draws from seed 1) as the plain graphed step of phase
    8 (``arm`` "plain"), over a state ``replicate`` placed ("dp", x cut
    by ``shard_batch``), one ``shard_state_fsdp`` placed ("fsdp") or one
    placed by FSDP composed with tensor parallelism on a data × tensor
    ``mesh`` ("fsdp_tp"): ``PAR_STEPS`` steps with the counts reset
    before and read after, then ``PAR_TIMED`` timed ones."""
    from diffsci_tpu_torch import (EMATracker, create_train_state, kernels,
                                   make_train_step)
    from diffsci_tpu_torch.parallel import (replicate, shard_batch,
                                            shard_state_fsdp)

    model = karras(cfg)
    tracker = EMATracker(ema_type="power", power_function_stds=[0.05],
                         update_every=4)
    state, tx = create_train_state(model, x.shape, seed=0, ema=tracker)
    xb = x
    if arm == "dp":
        replicate(state, mesh)
        xb = shard_batch(x, mesh)
    elif arm == "fsdp":
        shard_state_fsdp(state, mesh)
        xb = shard_batch(x, mesh)
    elif arm == "fsdp_tp":
        shard_state_fsdp(state, mesh, tensor_axis="tensor")
        xb = shard_batch(x, mesh)
    step = make_train_step(model, tx, ema=tracker)
    gen = torch.Generator("cuda").manual_seed(1)
    kernels.reset_launches()
    metrics = [step(state, xb, generator=gen)[1] for _ in range(PAR_STEPS)]
    metrics = [(float(m["train_loss"]), float(m["grad_norm"]))
               for m in metrics]
    counts = dict(kernels.LAUNCHES)
    snap = ({k: v.detach().clone() for k, v in state.params.items()},
            {k: v.clone() for k, v in state.ema.profiles[0].items()})

    def take():
        return step(state, xb, generator=gen)[1]["train_loss"]

    seconds = walls(take, PAR_TIMED)
    dev = device_ms(take, 5)
    log(f"[parallel {label}] {arm}: {PAR_STEPS} steps (loss, grad_norm) "
        f"{metrics}; {PAR_TIMED} steps {float(np.median(seconds)) * 1e3:.3f}"
        f" ms/step median (min {min(seconds) * 1e3:.3f}), device "
        f"{dev:.3f} ms/step; launches {counts}")
    return types.SimpleNamespace(metrics=metrics, snap=snap, counts=counts,
                                 take=take, state=state, dev=dev,
                                 ms=float(np.median(seconds)) * 1e3,
                                 model=model)


def nccl_kernels(fn) -> list:
    """The NCCL kernels torch.profiler sees in one call of ``fn`` (after
    one to warm up), with their device microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key[:80], e.count, round(device_us(e), 2))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()]


def phase_parallel_world1(zero):
    """Phase 37 (a): one rank over NCCL at full width."""
    from diffsci_tpu_torch import PUNetGConfig, kernels
    from diffsci_tpu_torch.models.nets import MoEFeedForward
    from diffsci_tpu_torch.parallel import (initialize_distributed,
                                            make_mesh, gather_batch,
                                            shard_batch,
                                            shard_params_expert_parallel)
    from diffsci_tpu_torch.parallel.pipeline import (make_dit_pipeline,
                                                     split_dit_variables)
    import torch.distributed as dist

    initialize_distributed(device_type="cuda")
    if dist.get_backend() != PAR_BACKEND or dist.get_world_size() != 1:
        raise AssertionError(f"phase 37 (a) wants one {PAR_BACKEND} rank, got "
                             f"{dist.get_backend()} x "
                             f"{dist.get_world_size()}")
    mesh = make_mesh(device_type="cuda")
    counts = []

    # B's data-parallel step against phase 8's graphed step, bit for bit
    # (cuDNN's deterministic algorithms, so that each capture picks the
    # same ones)
    cfg_b = PUNetGConfig(model_channels=64, channel_expansion=[2, 4])
    x = torch.randn((PAR_B_BATCH, 28, 28, 1), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    torch.backends.cudnn.deterministic = True
    arms = {arm: par_arm("B", cfg_b, x, mesh, arm)
            for arm in ("plain", "dp", "fsdp")}
    torch.backends.cudnn.deterministic = False
    per_step = dict(zero, norm_silu=NORMS_B, norm_silu_bwd=NORMS_B)
    for arm in arms.values():
        if arm.counts != {k: PAR_STEPS * n for k, n in per_step.items()}:
            raise AssertionError(f"phase 37: B's step launches {arm.counts}")
        counts.append(arm.counts)
    plain, dp, fsdp = arms["plain"], arms["dp"], arms["fsdp"]
    same = dp.metrics == plain.metrics and all(
        float(max((a[n] - b[n]).abs().max() for n in b)) == 0.0
        for a, b in zip(dp.snap, plain.snap))
    log(f"[parallel B] data-parallel step against the plain graphed step, "
        f"{PAR_STEPS} steps: {'bit for bit' if same else 'DIFFERENT'}; "
        f"{dp.ms:.3f} against {plain.ms:.3f} ms/step "
        f"({dp.ms / plain.ms:.4f}x), device {dp.dev:.3f} against "
        f"{plain.dev:.3f} ms ({dp.dev / plain.dev:.4f}x)")
    if not same:
        raise AssertionError("phase 37: the DP step at world 1 is not the "
                             "plain step bit for bit")
    log(f"[parallel B] NCCL kernels in one profiled DP step: "
        f"{nccl_kernels(dp.take)}")
    lr = 1e-3
    ok = np.allclose(fsdp.metrics, plain.metrics, rtol=1e-3, atol=0) and \
        np.isfinite(fsdp.metrics).all()
    for ours, theirs in zip(fsdp.snap, plain.snap):
        diff = torch.cat([(ours[n] - theirs[n]).abs().flatten()
                          for n in theirs]).cpu().numpy()
        q999, worst = float(np.quantile(diff, 0.999)), float(diff.max())
        ok = ok and q999 <= 0.05 * lr and worst <= 2 * PAR_STEPS * lr
        log(f"[parallel B] FSDP against plain: |Δ| 99.9% {q999:.3e}, max "
            f"{worst:.3e}")
    blocks = [k for k, spec in fsdp.state.placement.specs.items()
              if "data" in spec]
    exact = fsdp.metrics == plain.metrics and all(
        float(max((a[n] - b[n]).abs().max() for n in b)) == 0.0
        for a, b in zip(fsdp.snap, plain.snap))
    log(f"[parallel B] FSDP (graphed, world 1, weights gathered layer by "
        f"layer): {len(blocks)} of {len(fsdp.state.params)} tensors "
        f"sharded, (loss, grad_norm) {fsdp.metrics} against "
        f"{plain.metrics} {'ok' if ok else 'FAIL'} "
        f"({'bit for bit' if exact else 'not bit for bit'}); "
        f"{fsdp.ms:.3f} ms/step, device {fsdp.dev:.3f} ms")
    if not ok:
        raise AssertionError("phase 37: FSDP and plain steps disagree")
    PAR_DP_TIMES.update(ms=dp.ms, dev=dp.dev, plain_ms=plain.ms,
                        plain_dev=plain.dev)
    del arms, plain, dp, fsdp
    torch.cuda.empty_cache()

    # A's bucket-4 request through sample(mesh=...), bit for bit
    cfg_a = PUNetGConfig(dimension=3, model_channels=32,
                         channel_expansion=[2], num_heads=2,
                         attn_backend="flash")
    model = karras(cfg_a)
    model.init(seed=0)
    alone = model.sample(4, (32, 32, 32, 1),
                         torch.Generator("cuda").manual_seed(7),
                         nsteps=NSTEPS)
    kernels.reset_launches()
    on_mesh = model.sample(4, (32, 32, 32, 1),
                           torch.Generator("cuda").manual_seed(7),
                           nsteps=NSTEPS, mesh=mesh)
    torch.cuda.synchronize()
    c = dict(kernels.LAUNCHES)
    want = dict(zero, fused_axby=NFE, norm_silu=NORMS_A * NFE,
                flash_attention=NFE)
    log(f"[parallel A] bucket-4 request through sample(mesh=...): "
        f"{'bit for bit' if torch.equal(alone, on_mesh) else 'DIFFERENT'} "
        f"against the request without a mesh; launches {c}")
    if not torch.equal(alone, on_mesh) or c != want:
        raise AssertionError("phase 37: A's sample(mesh=...) differs")
    counts.append(c)
    del model
    torch.cuda.empty_cache()

    # H's MoE twin under dp x ep, and DiT-B's blocks on a 1-stage pipeline
    gen = torch.Generator("cuda").manual_seed(3)
    xh = torch.randn((4, 1, PAR_H_SIDE, PAR_H_SIDE), device="cuda",
                     generator=gen)
    th = torch.rand((4,), device="cuda", generator=gen)
    for label, moe in (("H MoE dp x ep", True), ("H pipeline", False)):
        net = model_h(moe=moe).net.model
        from diffsci_tpu_torch.models.nets.layers import init_parameters
        init_parameters(net, 0)
        net.eval()
        with torch.no_grad():
            ref = net(xh, th)
            if moe:
                m = make_mesh(axes=("data", "expert"), shape=(1, 1),
                              device_type="cuda")
                shard_params_expert_parallel(net, m)
                kernels.reset_launches()
                out = gather_batch(net(shard_batch(xh, m, ("data", "expert")),
                                       shard_batch(th, m,
                                                   ("data", "expert"))),
                                   m, ("data", "expert"))
            else:
                m = make_mesh(axes=("stage",), device_type="cuda")
                forward, _ = make_dit_pipeline(net, m, n_micro=2)
                tensors = dict(net.named_parameters())
                tensors.update(net.named_buffers())
                rest, stacked, _ = split_dit_variables(tensors, net.nblocks)
                kernels.reset_launches()
                out = forward(rest, stacked, xh, th)
            torch.cuda.synchronize()
        c = dict(kernels.LAUNCHES)
        err, ok = within_phase2(out, ref)
        extra = ""
        if moe:
            extra = ", dropped fractions " + str([
                round(float(f.dropped_fraction), 4) for f in net.modules()
                if isinstance(f, MoEFeedForward)])
        log(f"[parallel {label}] forward at batch 4 against the plain "
            f"forward: max|Δ| {err:.3e} {'ok' if ok else 'FAIL'}; launches "
            f"{c}{extra}")
        if not ok or c["flash_attention"] != H_WIDTHS["nblocks"] * (
                1 if moe else 2):
            raise AssertionError(f"phase 37: {label} disagrees")
        counts.append(c)
        del net
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return counts


def _par_probe(name, rank, world, dev):
    """One collective of gloo on CUDA tensors, checked; raises if gloo
    refuses it or it gives a wrong value."""
    import torch.distributed as dist

    x = torch.full((4,), float(rank + 1), device=dev)
    if name == "all_reduce":
        dist.all_reduce(x)
        ok = torch.equal(x.cpu(), torch.full((4,), world * (world + 1) / 2))
    elif name == "broadcast":
        dist.broadcast(x, src=0)
        ok = torch.equal(x.cpu(), torch.ones(4))
    elif name == "all_gather":
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        ok = all(float(p[0]) == i + 1 for i, p in enumerate(parts))
    elif name == "reduce_scatter":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, torch.arange(
            2.0 * world, device=dev) + rank)
        ok = torch.equal(out.cpu(), torch.arange(
            2.0 * rank, 2.0 * rank + 2) * world + world * (world - 1) / 2)
    elif name == "all_to_all_single":
        out = torch.empty(world, device=dev)
        dist.all_to_all_single(out, x[:world] * 10 + torch.arange(
            world, device=dev, dtype=x.dtype))
        ok = all(float(out[i]) == (i + 1) * 10 + rank for i in range(world))
    else:
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
               dist.P2POp(dist.irecv, out, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        ok = float(out[0]) == (rank - 1) % world + 1
    if x.is_cuda:
        torch.cuda.synchronize()
    if not ok:
        raise AssertionError(f"{name} gave a wrong value")


def _par_mode(name, rank, world, dev):
    """One mode of part (b) at small sizes, f32, against the single-process
    result of the same rank on the card, at the CPU tests' bounds.
    Returns its max relative error."""
    from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig,
                                   create_train_state, make_train_step)
    from diffsci_tpu_torch.models.nets.mlp import MLPUncond
    from diffsci_tpu_torch.parallel import (gather_batch, make_mesh,
                                            replicate, shard_batch,
                                            shard_params_expert_parallel,
                                            shard_state_fsdp,
                                            shard_state_tensor_parallel)

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((32, 2)).astype(np.float32))
    sigma = torch.from_numpy(np.exp(rng.standard_normal(32) * 1.2 - 1.2)
                             .astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((32, 2)).astype(np.float32))
    x, sigma, eps = x.to(dev), sigma.to(dev), eps.to(dev)

    def close(a, b, rtol, atol):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
        return float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b))))

    if name.endswith("_step"):
        hidden = {"dp_step": [16], "bnorm_step": [16], "fsdp_step": [64],
                  "tp_step": [64, 64]}[name]
        xs = x + torch.repeat_interleave(torch.arange(
            8.0, device=dev), 4)[:, None] if name == "bnorm_step" else x

        def arm(placed):
            model = KarrasModel(
                MLPUncond(2, hidden, device=dev),
                KarrasModelConfig.from_edm(
                    loss_metric="mse",
                    has_edm_batch_norm=name == "bnorm_step"), device=dev)
            state, tx = create_train_state(model, (32, 2), seed=0)
            xb = xs
            if placed:
                if name == "tp_step":
                    mesh = make_mesh(axes=("data", "tensor"),
                                     shape=(world // 2, 2),
                                     device_type="cuda")
                    shard_state_tensor_parallel(state, mesh, min_size=32)
                else:
                    mesh = make_mesh(device_type="cuda")
                    if name == "fsdp_step":
                        shard_state_fsdp(state, mesh, min_elements=64)
                    else:
                        replicate(state, mesh)
                xb = shard_batch(xs, mesh)
            step = make_train_step(model, tx)
            state, met = step(state, xb, sigma=sigma, eps=eps)
            params = {}
            for k, p in state.params.items():
                p = p.detach()
                for d, a in enumerate(getattr(state.placement, "specs",
                                              {}).get(k, ())):
                    if a is not None:
                        p = gather_batch(p.contiguous(),
                                         state.placement.mesh, a, dim=d)
                params[k] = p.cpu().numpy()
            return float(met["train_loss"]), params

        (l0, p0), (l1, p1) = arm(False), arm(True)
        err = close(l1, l0, 1e-5, 0.0)
        for k in p0:
            err = max(err, close(p1[k], p0[k], 1e-4, 1e-6))
        return err
    if name == "dp_sampling":
        mesh = make_mesh(device_type="cuda")
        model = KarrasModel(MLPUncond(3, hidden_dims=(16,), device=dev),
                            KarrasModelConfig.from_edm(), device=dev)
        model.init(0)
        single = model.sample(16, (3,), torch.Generator(dev).manual_seed(5),
                              nsteps=8)
        sharded = model.sample(16, (3,),
                               torch.Generator(dev).manual_seed(5),
                               nsteps=8, mesh=mesh)
        return close(sharded.cpu(), single.cpu(), 1e-5, 1e-6)
    if name == "ep_forward":
        from diffsci_tpu_torch.models.nets import MoEDiffusionTransformer
        from diffsci_tpu_torch.models.nets.layers import init_parameters
        mesh = make_mesh(axes=("data", "expert"), shape=(world // 2, 2),
                         device_type="cuda")
        net = MoEDiffusionTransformer(nembed=16, nheads=2, nblocks=2,
                                      patch_size=2, nchannels=1, n_experts=4,
                                      moe_every=2, capacity_factor=0.5,
                                      device=dev)
        init_parameters(net, 0)
        xm = torch.randn((8, 1, 8, 8), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
        tm = torch.linspace(0.1, 1.0, 8, device=dev)
        axes = ("data", "expert")
        with torch.no_grad():
            ref = net(xm, tm)
            shard_params_expert_parallel(net, mesh)
            out = gather_batch(net(shard_batch(xm, mesh, axes),
                                   shard_batch(tm, mesh, axes)), mesh, axes)
        return close(out.cpu(), ref.cpu(), 2e-5, 1e-5)
    if name == "pipeline":
        from diffsci_tpu_torch.models.nets import DiffusionTransformer
        from diffsci_tpu_torch.models.nets.layers import init_parameters
        from diffsci_tpu_torch.parallel.pipeline import (
            make_dit_pipeline, shard_stacked_params, split_dit_variables)
        mesh = make_mesh(axes=("stage",), device_type="cuda")
        net = DiffusionTransformer(nembed=32, nheads=2, nblocks=4,
                                   patch_size=4, nchannels=1, device=dev)
        init_parameters(net, 0)
        xd = torch.randn((8, 1, 16, 16), device=dev,
                         generator=torch.Generator(dev).manual_seed(2))
        td = torch.linspace(0.1, 1.0, 8, device=dev)
        forward, _ = make_dit_pipeline(net, mesh, n_micro=4)
        tensors = dict(net.named_parameters())
        tensors.update(net.named_buffers())
        rest, stacked, _ = split_dit_variables(
            {k: v.detach() for k, v in tensors.items()}, 4)
        with torch.no_grad():
            out = forward(rest, shard_stacked_params(stacked, mesh), xd, td)
            ref = net(xd, td)
        return close(out.cpu(), ref.cpu(), 2e-5, 2e-6)
    from diffsci_tpu_torch.extra.chunk_decode import halo_shard_decode
    mesh = make_mesh(axes=("spatial",), device_type="cuda")
    g = torch.Generator(dev).manual_seed(4)
    w1 = torch.randn((8, 2, 3, 3), device=dev, generator=g) * 0.3
    w2 = torch.randn((1, 8, 3, 3), device=dev, generator=g) * 0.3
    z = torch.randn((1, 2, 32, 16), device=dev, generator=g)

    def decode(zz):
        h = F.silu(F.conv2d(zz, w1, padding=1))
        h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return F.conv2d(h, w2, padding=1)

    with torch.no_grad():
        out = halo_shard_decode(decode, z, mesh, "spatial", halo=2,
                                upscale=2)
        ids = torch.arange(-2, 34, device=dev) % 32
        ref = decode(z.index_select(2, ids))[:, :, 4:-4]
    return close(out.cpu(), ref.cpu(), 1e-4, 1e-5)


def _par_rank(rank, world, port, out_dir, what):
    """A rank of part (b): gloo over CUDA tensors on device 0. ``what``
    is "probe" (each collective, its result written as it finishes) or a
    list of modes to run."""
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    if dev.type != "cpu":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    names = PAR_PROBES if what == "probe" else what
    path = os.path.join(out_dir, f"{what if what == 'probe' else 'modes'}"
                                 f".{rank}.json")
    done = {}
    for name in names:
        done[name] = "started"
        with open(path, "w") as f:
            json.dump(done, f)
        try:
            if what == "probe":
                _par_probe(name, rank, world, dev)
                done[name] = True
            else:
                done[name] = _par_mode(name, rank, world, dev)
        except Exception as e:   # recorded; the parent decides
            done[name] = f"{type(e).__name__}: {str(e)[:300]}"
        with open(path, "w") as f:
            json.dump(done, f)
    dist.destroy_process_group()


PAR_PROBES = ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
              "all_to_all_single", "batch_isend_irecv")


def par_group(what, out_dir) -> list:
    """Run ``_par_rank`` in PAR_WORLD spawned processes; every rank's
    record (what it finished, and how), after the group ends or is
    stopped at PAR_TIMEOUT."""
    import socket
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(_par_rank, args=(PAR_WORLD, port, out_dir,
                                              what),
                             nprocs=PAR_WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + PAR_TIMEOUT
    try:
        while time.monotonic() < deadline:
            if ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                break
    except ProcessException as e:      # a rank died
        log(f"[parallel world {PAR_WORLD}] a rank of the {what} group "
            f"ended: {str(e)[:200]}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    records = []
    for rank in range(PAR_WORLD):
        name = f"{what if what == 'probe' else 'modes'}.{rank}.json"
        try:
            with open(os.path.join(out_dir, name)) as f:
                records.append(json.load(f))
        except (OSError, ValueError):
            records.append({})
    return records


def phase_parallel_world2():
    """Phase 37 (b): PAR_WORLD ranks on the one card over gloo."""
    import tempfile

    with tempfile.TemporaryDirectory() as out_dir:
        probes = par_group("probe", out_dir)
        carried = {name for name in PAR_PROBES
                   if all(r.get(name) is True for r in probes)}
        log(f"[parallel world {PAR_WORLD}] gloo on CUDA tensors: "
            f"{ {n: probes[0].get(n, 'not reached') for n in PAR_PROBES} }")
        modes = [m for m, needs in PAR_MODES.items()
                 if set(needs) <= carried]
        skipped = {m: sorted(set(needs) - carried)
                   for m, needs in PAR_MODES.items() if m not in modes}
        ran = par_group(modes, out_dir) if modes else [{}] * PAR_WORLD
    failed = {m: [r.get(m) for r in ran] for m in modes
              if not all(isinstance(r.get(m), float) and r.get(m) <= 1.0
                         for r in ran)}
    log(f"[parallel world {PAR_WORLD}] modes run (max error over the "
        f"bound, per rank): { {m: [r.get(m) for r in ran] for m in modes} }")
    log(f"[parallel world {PAR_WORLD}] modes not run (the collectives gloo "
        f"did not carry for CUDA tensors): {skipped}")
    if failed or not modes:
        raise AssertionError(f"phase 37 (b): modes failed {failed}")


def phase_parallel(zero):
    """Phase 37: (a) then (b)."""
    counts = phase_parallel_world1(zero)
    phase_parallel_world2()
    return counts


# ---------------------------------------------------------------------------
# phase 38: data-parallel serving, the dp × spatial step, the placed steps
# ---------------------------------------------------------------------------
SP_STEPS = 3               # steps held bit for bit at one rank
SP_TIMED = 5               # spatial steps timed in part (b)
SP_TIMEOUT = 300           # seconds part (b)'s group may take
SP_SHAPE = (4, 32, 32, 32, 1)   # A's train batch: 32³ over 2 slabs of 16
# the two-rank f32 mesh service against the single-process service at
# batch 4 (rtol, atol): a few times the gap of the batch-2 witness
SVC_BOUNDS = (1e-4, 1e-5)
A_WIDTH = 32               # A's model_channels
# one A spatial step at 2 ranks: 10 GroupLN (two K2·S sums each) and 10
# GroupRMS (one) norms; K3·S's two halves a norm; the gathered attention
SP_PER_STEP = dict(norm_silu_stats=30, norm_silu_apply=20,
                   norm_silu_bwd_partials=20, norm_silu_bwd_dx=20,
                   flash_attention=1, flash_attention_dq=1,
                   flash_attention_dkv=1)


def cfg_a():
    from diffsci_tpu_torch import PUNetGConfig
    return PUNetGConfig(dimension=3, model_channels=A_WIDTH,
                        channel_expansion=[2], num_heads=2,
                        attn_backend="flash")


def vae_k():
    """K: G's autoencoder with ``NLayerDiscriminator(ndf=64, n_layers=3)``
    and ``VAEModelConfig()``'s defaults."""
    from diffsci_tpu_torch import (AutoencoderKL, DDConfig,
                                   NLayerDiscriminator, VAEModel,
                                   VAEModelConfig)
    return VAEModel(AutoencoderKL(DDConfig(), embed_dim=4), VAEModelConfig(),
                    discriminator=NLayerDiscriminator(ndf=64, n_layers=3))


def karras_f32(cfg):
    """``karras`` in f32 (no compute dtype)."""
    from diffsci_tpu_torch import KarrasModel, KarrasModelConfig, PUNetG

    return KarrasModel(PUNetG(cfg), KarrasModelConfig.from_edm())


def pin_optimizer():
    """The default AdamW and clip with eps 1e-4, as the CPU pins take it
    (tests/_torch_steps.py): Adam's first step lr·g/(|g| + eps) at eps
    1e-8 turns a rounding-level gradient into ±lr."""
    from diffsci_tpu_torch.models.karras.train import AdamWClip
    return AdamWClip(1e-3, 1e-4, 0.9, 0.999, 0.5, eps=1e-4)


def step_snapshot(state) -> dict:
    return {k: v.detach().clone() for k, v in state.params.items()}


def placed_vs_plain(label, make, steps=SP_STEPS):
    """``make(placed)`` -> (state, one(state) -> metrics); the placed arm
    (a one-rank NCCL placement) and the plain arm from the same weights
    and draws, ``steps`` graphed steps each; whether the losses and
    parameters are bit for bit equal, with the placed arm's launches."""
    from diffsci_tpu_torch import kernels

    arms = {}
    for placed in (False, True):
        state, one = make(placed)
        kernels.reset_launches()
        losses = [float(one(state)) for _ in range(steps)]
        torch.cuda.synchronize()
        arms[placed] = (losses, step_snapshot(state), dict(kernels.LAUNCHES))
        del state, one
        torch.cuda.empty_cache()
    (l0, p0, _), (l1, p1, c1) = arms[False], arms[True]
    same = l0 == l1 and all(torch.equal(p0[k], p1[k]) for k in p0)
    log(f"[spatial (a) {label}] placed on one rank against the plain step, "
        f"{steps} graphed steps: {'bit for bit' if same else 'DIFFERENT'} "
        f"(losses {l1} / {l0}); launches {c1}")
    if not same:
        raise AssertionError(f"phase 38: {label} placed differs from plain")
    return c1


def phase_spatial_world1(zero):
    """Phase 38 (a): one NCCL rank at full width."""
    import threading

    import torch.distributed as dist

    from diffsci_tpu_torch import (EMATracker, create_train_state,
                                   create_vae_train_state, default_optimizer,
                                   kernels, make_train_step,
                                   make_vae_train_step)
    from diffsci_tpu_torch.models.karras import distill
    from diffsci_tpu_torch.models.karras import ensemble as ens
    from diffsci_tpu_torch.models.karras.train import _new_train_state
    from diffsci_tpu_torch.parallel import (initialize_distributed,
                                            make_mesh, replicate,
                                            shard_batch, shard_state_spatial)
    from diffsci_tpu_torch.serving import SamplerService, build_server

    initialize_distributed(device_type="cuda")
    if dist.get_backend() != PAR_BACKEND or dist.get_world_size() != 1:
        raise AssertionError("phase 38 (a) wants one NCCL rank")
    mesh = make_mesh(device_type="cuda")
    counts = []

    # A's bucket-4 request through SamplerService(mesh=), HTTP too, against
    # the service without a mesh on the same model (bit for bit)
    model = karras(cfg_a())
    model.init(seed=0)
    plain = SamplerService(model, (32, 32, 32, 1), batch_buckets=(4,),
                           nsteps=NSTEPS)
    meshed = SamplerService(model, (32, 32, 32, 1), batch_buckets=(4,),
                            nsteps=NSTEPS, mesh=mesh)
    plain.warmup()
    meshed.warmup()
    ref = plain.sample(4, 7)
    kernels.reset_launches()
    out = meshed.sample(4, 7)
    c = dict(kernels.LAUNCHES)
    want = dict(zero, fused_axby=NFE, norm_silu=NORMS_A * NFE,
                flash_attention=NFE)
    server = build_server(meshed, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    reply = http_post(f"http://127.0.0.1:{server.server_address[1]}/sample",
                      {"nsamples": 4, "seed": 7})
    server.shutdown()
    via_http = np.asarray(reply["samples"], np.float32)
    walls_plain, walls_mesh = [], []
    for _ in range(3):
        walls_plain += walls(lambda: plain.sample(4, 7), 3)
        walls_mesh += walls(lambda: meshed.sample(4, 7), 3)
    meshed.close()
    ok = np.array_equal(out, ref) and np.array_equal(via_http, ref) \
        and c == want
    log(f"[spatial (a) A] bucket-4 request through SamplerService(mesh=) "
        f"{'bit for bit' if np.array_equal(out, ref) else 'DIFFERENT'}, "
        f"over HTTP {'bit for bit' if np.array_equal(via_http, ref) else 'DIFFERENT'}; "
        f"launches {c}; request {fmt(walls_mesh)} against {fmt(walls_plain)} "
        f"without a mesh (median ratio "
        f"{float(np.median(walls_mesh) / np.median(walls_plain)):.4f})")
    if not ok:
        raise AssertionError("phase 38: A's mesh service differs")
    counts.append(c)
    del model, plain, meshed
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = True
    try:
        # F's ensemble step
        gen = torch.Generator("cuda").manual_seed(0)
        fx = torch.randn((8, 32, 32, 4 * F_HORIZONS), generator=gen,
                         device="cuda")
        fy = {"y": torch.randn((8, 8, 32, 32), generator=gen,
                               device="cuda")}

        def make_f(placed):
            m = model_f()
            state, tx = create_train_state(m, fx.shape, seed=0)
            x = fx
            if placed:
                replicate(state, mesh)
                x = shard_batch(fx, mesh)
            step = ens.make_ensemble_train_step(m, tx)
            g = torch.Generator("cuda").manual_seed(1)
            return state, lambda s: step(s, x, fy, generator=g)[1][
                "train_loss"]
        counts.append(placed_vs_plain("F ensemble", make_f))

        # J's distill step (B's student of a copy of itself, batch 256)
        from diffsci_tpu_torch import PUNetGConfig
        cfg_b = PUNetGConfig(model_channels=64, channel_expansion=[2, 4])
        jx = torch.randn((J_BATCH, 28, 28, 1), generator=gen, device="cuda")

        def make_j(placed):
            m = karras(cfg_b)
            m.init(seed=0)
            teacher = distill._teacher_like(m)
            tx = default_optimizer(J_LR)
            state = _new_train_state(m, tx)
            x = jx
            if placed:
                replicate(state, mesh)
                x = shard_batch(jx, mesh)
            step = distill.make_distill_step(m, tx, 17)
            g = torch.Generator("cuda").manual_seed(2)
            return state, lambda s: step(s, teacher, x, generator=g)[1][
                "distill_loss"]
        counts.append(placed_vs_plain("J distill", make_j))

        # K's VAE step (G's autoencoder, the discriminator on)
        kx = torch.randn((K_BATCH, 1, G_PIX, G_PIX), generator=gen,
                         device="cuda")

        def make_k(placed):
            m = vae_k()
            state, tx, dtx = create_vae_train_state(m, kx.shape, seed=0)
            x = kx
            if placed:
                replicate(state, mesh)
                x = shard_batch(kx, mesh)
            step = make_vae_train_step(m, tx, dtx)
            g = torch.Generator("cuda").manual_seed(3)
            return state, lambda s: step(s, x, generator=g)[1]["train_loss"]
        counts.append(placed_vs_plain("K VAE", make_k))

        # A's train step on a (1, 1) data × spatial mesh
        ax = torch.randn(SP_SHAPE, generator=gen, device="cuda")
        sp_mesh = make_mesh(axes=("data", "spatial"), shape=(1, 1),
                            device_type="cuda")

        def make_a(placed):
            m = karras(cfg_a())
            tracker = EMATracker(ema_type="power",
                                 power_function_stds=[0.05], update_every=4)
            state, tx = create_train_state(m, SP_SHAPE, seed=0, ema=tracker)
            x = ax
            if placed:
                shard_state_spatial(state, sp_mesh, SP_SHAPE)
                x = shard_batch(ax, sp_mesh)
            step = make_train_step(m, tx, ema=tracker)
            g = torch.Generator("cuda").manual_seed(4)
            return state, lambda s: step(s, x, generator=g)[1]["train_loss"]
        counts.append(placed_vs_plain("A on a (1, 1) data x spatial mesh",
                                      make_a))
    finally:
        torch.backends.cudnn.deterministic = False
    dist.destroy_process_group()
    return counts


@torch.inference_mode()
def halves_at_batch(model, shape, n, seed):
    """The samples of an n-row request from ``seed`` as two ranks of a
    mesh service compute them, in one process: the whole request's x_T
    drawn, each half through the sampler's graph at batch n / 2."""
    inputs = model._sampler_inputs(n, model._sample_shape(shape, False),
                                   NSTEPS, None, False, None)
    x, noise, _ = model._draw_inputs(
        inputs, torch.Generator("cuda").manual_seed(seed), None)
    if noise is not None:
        raise AssertionError("the witness replays a deterministic sampler")
    graph = model.compile_sampler(n // 2, shape, nsteps=NSTEPS)
    out = []
    for rows in (slice(0, n // 2), slice(n // 2, n)):
        graph.inputs[0].copy_(x[rows])
        graph.replay()
        out.append(graph.outputs.clone())
    return torch.cat(out).cpu().numpy()


def _sp_rank(rank, world, port, out_dir, names):
    """A rank of part (b): gloo over CUDA tensors on device 0. Writes its
    record (each arm's result, or the error that ended it) to out_dir."""
    import traceback

    import torch.distributed as dist

    from diffsci_tpu_torch import (create_train_state, kernels,
                                   make_train_step)
    from diffsci_tpu_torch.models.karras import ensemble as ens
    from diffsci_tpu_torch.parallel import (make_mesh, replicate,
                                            shard_batch, shard_state_spatial)
    from diffsci_tpu_torch.serving import SamplerService

    card = torch.cuda.is_available()    # False in a CPU rehearsal
    if card:
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    if card:
        kernels.load_all()
    zero = dict.fromkeys(names, 0)
    record = {}
    path = os.path.join(out_dir, f"spatial.{rank}.json")

    def close(a, b, rtol, atol):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b))))

    def arm(name, fn):
        record[name] = "started"
        with open(path, "w") as f:
            json.dump(record, f)
        try:
            record[name] = fn()
        except Exception:     # recorded; the parent decides
            record[name] = "ERROR " + traceback.format_exc()[-1500:]
        with open(path, "w") as f:
            json.dump(record, f)

    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(SP_SHAPE, generator=gen, device="cuda")
    sigma = torch.exp(torch.randn(SP_SHAPE[0], generator=gen,
                                  device="cuda") * 1.2 - 1.2)
    eps = torch.randn(SP_SHAPE, generator=gen, device="cuda")

    def service():
        # A in f32: rank 0 serves bucket 4, rank 1 follows; rank 0 holds
        # the samples against the single-process card service, and against
        # the witness: the single-process sampler graph at batch 2 on each
        # half of the same x_T (the rows and batch each rank runs)
        mesh = make_mesh(device_type="cpu")
        model = karras_f32(cfg_a())
        model.init(seed=0)
        svc = SamplerService(model, (32, 32, 32, 1), batch_buckets=(4,),
                             nsteps=NSTEPS, mesh=mesh)
        if rank:
            svc.follow()
            return dict(ok=True)
        svc.warmup()
        out = svc.sample(4, 7)
        svc.close()
        ref = SamplerService(model, (32, 32, 32, 1), batch_buckets=(4,),
                             nsteps=NSTEPS).sample(4, 7)
        halves = halves_at_batch(model, (32, 32, 32, 1), 4, 7)
        res = dict(err=float(np.max(np.abs(out - ref))),
                   ratio=close(out, ref, *SVC_BOUNDS),
                   cpu_bound_ratio=close(out, ref, 1e-5, 1e-6),
                   witness_err=float(np.max(np.abs(halves - ref))),
                   witness_cpu_bound_ratio=close(halves, ref, 1e-5, 1e-6),
                   halves_err=float(np.max(np.abs(out - halves))),
                   halves_ratio=close(out, halves, 1e-5, 1e-6))
        res["ok"] = bool(np.isfinite(out).all()) and res["ratio"] <= 1.0 \
            and res["halves_ratio"] <= 1.0
        return res

    def spatial_f32():
        # A in f32: the spatial step against the single-process step on
        # the same weights and replayed draws (eager, the pins' AdamW)
        out = {}
        for spatial in (False, True):
            model = karras_f32(cfg_a())
            model.init(seed=0)
            state, tx = create_train_state(model, SP_SHAPE, seed=None,
                                           optimizer=pin_optimizer())
            xb = x
            if spatial:
                sp_mesh = make_mesh(axes=("spatial",), device_type="cpu")
                shard_state_spatial(state, sp_mesh, SP_SHAPE)
                xb = shard_batch(x, sp_mesh)
            met = make_train_step(model, tx)(state, xb, sigma=sigma,
                                             eps=eps)[1]
            out[spatial] = (float(met["train_loss"]), step_snapshot(state))
        err = close(out[True][0], out[False][0], 1e-5, 0.0)
        for k, v in out[False][1].items():
            err = max(err, close(out[True][1][k].cpu(), v.cpu(), 1e-4, 1e-6))
        return err

    def spatial_bf16():
        # A at its bf16 compute: one step's launches, SP_TIMED timed
        # steps, the peak memory against the single-process step's
        res = {}
        for spatial in (False, True):
            if card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            model = karras(cfg_a())
            state, tx = create_train_state(model, SP_SHAPE, seed=0)
            xb = x
            if spatial:
                sp_mesh = make_mesh(axes=("spatial",), device_type="cpu")
                shard_state_spatial(state, sp_mesh, SP_SHAPE)
                xb = shard_batch(x, sp_mesh)
            # eager in both arms (the spatial step over gloo is)
            step = make_train_step(model, tx, _raw=True)
            g = torch.Generator("cuda").manual_seed(1)
            kernels.reset_launches()
            loss = float(step(state, xb, generator=g)[1]["train_loss"])
            c = {k: v for k, v in kernels.LAUNCHES.items() if v}
            seconds = []
            for _ in range(SP_TIMED):     # float() of the loss syncs
                t0 = time.perf_counter()
                float(step(state, xb, generator=g)[1]["train_loss"])
                seconds.append(time.perf_counter() - t0)
            res["spatial" if spatial else "single"] = dict(
                loss=loss, counts=c, ms=float(np.median(seconds)) * 1e3,
                peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                          if card else float(not spatial)),
                slab=list(xb.shape))
            del model, state, step
        want = {k: v for k, v in dict(zero, **SP_PER_STEP).items() if v}
        res["counts_ok"] = res["spatial"]["counts"] == want
        return res

    def ensemble_dp():
        # F in f32 at DP world 2 against the single-process step on the
        # same weights and replayed draws
        out = {}
        fg = torch.Generator("cuda").manual_seed(5)
        fx = torch.randn((8, 32, 32, 4 * F_HORIZONS), generator=fg,
                         device="cuda")
        fy = {"y": torch.randn((8, 8, 32, 32), generator=fg, device="cuda")}
        for placed in (False, True):
            model = model_f()
            model.compute_dtype = None
            state, tx = create_train_state(model, fx.shape, seed=0,
                                           optimizer=pin_optimizer())
            draws = model.draw_autoregressive(
                model.draw_tensors(fx, F_MEMBERS),
                torch.Generator("cuda").manual_seed(6))
            xb, yb = fx, fy
            if placed:
                mesh = make_mesh(device_type="cpu")
                replicate(state, mesh)
                xb, yb = shard_batch(fx, mesh), shard_batch(fy, mesh)
            met = ens.make_ensemble_train_step(model, tx)(
                state, xb, yb, draws=draws)[1]
            out[placed] = (float(met["train_loss"]), step_snapshot(state))
        err = close(out[True][0], out[False][0], 1e-5, 0.0)
        for k, v in out[False][1].items():
            err = max(err, close(out[True][1][k].cpu(), v.cpu(), 1e-4, 1e-6))
        return err

    for name, fn in (("service", service), ("spatial_f32", spatial_f32),
                     ("spatial_bf16", spatial_bf16),
                     ("ensemble_dp", ensemble_dp)):
        arm(name, fn)
    dist.destroy_process_group()


def phase_spatial_world2(zero):
    """Phase 38 (b): two gloo ranks on the one card."""
    import socket
    import tempfile

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    with tempfile.TemporaryDirectory() as out_dir:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        ctx = mp.start_processes(_sp_rank, args=(PAR_WORLD, port, out_dir,
                                                 list(zero)),
                                 nprocs=PAR_WORLD, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + SP_TIMEOUT
        try:
            while time.monotonic() < deadline:
                if ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                    break
        except ProcessException as e:
            log(f"[spatial (b)] a rank ended: {str(e)[:300]}")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        records = []
        for rank in range(PAR_WORLD):
            try:
                with open(os.path.join(out_dir, f"spatial.{rank}.json")) as f:
                    records.append(json.load(f))
            except (OSError, ValueError):
                records.append({})
    for rank, rec in enumerate(records):
        log(f"[spatial (b) rank {rank}] {json.dumps(rec)[:3000]}")
    failed = []
    for rank, rec in enumerate(records):
        for name in ("spatial_f32", "ensemble_dp"):
            if not (isinstance(rec.get(name), float) and rec[name] <= 1.0):
                failed.append((rank, name, str(rec.get(name))[:300]))
        if not (isinstance(rec.get("service"), dict)
                and rec["service"]["ok"]):
            failed.append((rank, "service", str(rec.get("service"))[:300]))
        bf16 = rec.get("spatial_bf16")
        if not (isinstance(bf16, dict) and bf16["counts_ok"]
                and bf16["spatial"]["peak_gib"] < bf16["single"]["peak_gib"]
                and np.isfinite(bf16["spatial"]["loss"])):
            failed.append((rank, "spatial_bf16", str(bf16)[:300]))
    if failed:
        raise AssertionError(f"phase 38 (b) failed: {failed}")
    bf16 = records[0]["spatial_bf16"]
    log(f"[spatial (b)] A's full-width step on spatial = {PAR_WORLD} (slab "
        f"{bf16['spatial']['slab']}), bf16, eager over gloo: "
        f"{bf16['spatial']['ms']:.3f} ms/step against the single-process "
        f"eager step's {bf16['single']['ms']:.3f} ms; peak memory a rank "
        f"{bf16['spatial']['peak_gib']:.3f} GiB against "
        f"{bf16['single']['peak_gib']:.3f} GiB; launches a step "
        f"{bf16['spatial']['counts']}; f32 step against the single-process "
        f"step {records[0]['spatial_f32']:.3f} of the CPU bounds; F's DP "
        f"step {records[0]['ensemble_dp']:.3f}")
    svc = records[0]["service"]
    log(f"[spatial (b)] the mesh service against the single-process "
        f"service at batch 4: max|Δ| {svc['err']:.3e}, {svc['ratio']:.3f} of "
        f"rtol/atol {SVC_BOUNDS}, {svc['cpu_bound_ratio']:.3f} of the CPU "
        f"bounds; the witness (the single-process graph at batch 2 on each "
        f"half's x_T) against batch 4: max|Δ| {svc['witness_err']:.3e}, "
        f"{svc['witness_cpu_bound_ratio']:.3f} of the CPU bounds; the mesh "
        f"service against the witness: max|Δ| {svc['halves_err']:.3e}, "
        f"{svc['halves_ratio']:.3f} of the CPU bounds")
    return [dict(zero, **bf16["spatial"]["counts"])]


def phase_spatial(zero):
    """Phase 38: (a) then (b)."""
    counts = phase_spatial_world1(zero)
    return counts + phase_spatial_world2(zero)


# ---------------------------------------------------------------------------
# phase 39: FSDP with each layer's weights gathered as it runs, FSDP
# composed with tensor parallelism, and the dp × spatial step of D and E
# ---------------------------------------------------------------------------
FS_STEPS = 3               # steps held against the plain / single step
FS_SAMPLE = 64             # the Heun sample from the FSDP-placed B
FS_TIMEOUT = 300           # seconds a group of parts (b) to (d) may take
FS_D_SHAPE = (4, 32, 32, 32, 1)   # D's train batch over 2 slabs of 16
# E's widths on 32²: its pools make 28 -> 14 -> 7, and 28 does not split
# into 2 slabs that each pool twice (a slab must divide by 4)
FS_E_SHAPE = (8, 32, 32, 1)
FS_TIMED = 3               # D's bf16 spatial steps timed
FS_H_SHAPE = (8, 256, 256, 1)     # H's train batch
# E's spatial f32 step: its gaps to the float64 witness at most this
# multiple of the single-process f32 step's own
E_WITNESS = 1.5


def cfg_b():
    from diffsci_tpu_torch import PUNetGConfig
    return PUNetGConfig(model_channels=64, channel_expansion=[2, 4])


def cfg_d():
    return dataclasses.replace(cfg_a(), convolution_type="circular",
                               cond_drop=0.1)


def cfg_e():
    return dataclasses.replace(cfg_b(), convolution_type="mp",
                               attn_type="cosine")


def held_bytes(net) -> int:
    """The bytes a network's parameters hold."""
    return sum(p.numel() * p.element_size() for p in net.parameters())


def state_bytes(state) -> int:
    """The bytes a train state holds between steps: its parameters, their
    gradients, AdamW's moments and the EMA shadows."""
    tensors = list(state.params.values()) + [
        p.grad for p in state.params.values() if p.grad is not None]
    for slot in state.optimizer.state.values():
        tensors += [t for t in slot.values() if torch.is_tensor(t) and t.ndim]
    if state.ema is not None:
        for profile in state.ema.profiles:
            tensors += list(profile.values())
    return sum(t.numel() * t.element_size() for t in tensors)


def witness_gaps(params: dict, ref: dict, grads: dict, ref_grads: dict
                 ) -> tuple:
    """(the parameters' largest gap to the witness ``ref`` in the CPU
    tests' bound, rtol 1e-4 atol 1e-6; the gradients' largest gap to
    ``ref_grads`` over the tensor's largest entry), at the worst tensor."""
    p_gap = max(float(((params[k].detach().cpu().double() - v).abs()
                       / (1e-6 + 1e-4 * v.abs())).max())
                for k, v in ref.items())
    g_gap = max(float((grads[k] - v).abs().max()
                      / (v.abs().max() + 1e-30))
                for k, v in ref_grads.items())
    return p_gap, g_gap


def phase_fsdp_world1(zero):
    """Phase 39 (a): one NCCL rank, graphed, at full width."""
    import torch.distributed as dist

    from diffsci_tpu_torch import create_train_state, kernels
    from diffsci_tpu_torch.parallel import (initialize_distributed,
                                            make_mesh, shard_state_fsdp)

    initialize_distributed(device_type="cuda")
    if dist.get_backend() != PAR_BACKEND or dist.get_world_size() != 1:
        raise AssertionError("phase 39 (a) wants one NCCL rank")
    mesh = make_mesh(device_type="cuda")
    tp_mesh = make_mesh(axes=("data", "tensor"), shape=(1, 1),
                        device_type="cuda")
    x = torch.randn((PAR_B_BATCH, 28, 28, 1), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    torch.backends.cudnn.deterministic = True
    try:
        arms = {"plain": par_arm("B", cfg_b(), x, mesh, "plain"),
                "fsdp": par_arm("B", cfg_b(), x, mesh, "fsdp"),
                "fsdp_tp": par_arm("B", cfg_b(), x, tp_mesh, "fsdp_tp")}
    finally:
        torch.backends.cudnn.deterministic = False
    per_step = dict(zero, norm_silu=NORMS_B, norm_silu_bwd=NORMS_B)
    counts = []
    for arm in arms.values():
        if arm.counts != {k: PAR_STEPS * n for k, n in per_step.items()}:
            raise AssertionError(f"phase 39: B's step launches {arm.counts}")
        counts.append(arm.counts)
    plain = arms["plain"]
    dp = PAR_DP_TIMES
    for name in ("fsdp", "fsdp_tp"):
        arm = arms[name]
        same = arm.metrics == plain.metrics and all(
            float(max((a[n] - b[n]).abs().max() for n in b)) == 0.0
            for a, b in zip(arm.snap, plain.snap))
        specs = arm.state.placement.specs
        log(f"[fsdp (a) B] {name} (graphed, world 1, "
            f"{sum('data' in s for s in specs.values())} of "
            f"{len(arm.state.params)} tensors in blocks, "
            f"{sum('tensor' in s for s in specs.values())} column-parallel) "
            f"against the plain graphed step, {PAR_STEPS} steps: "
            f"{'bit for bit' if same else 'DIFFERENT'}; {arm.ms:.3f} ms/step"
            f", device {arm.dev:.3f} ms, against the plain step's "
            f"{plain.ms:.3f} / {plain.dev:.3f} ms and phase 37's DP arm's "
            f"{dp.get('ms', float('nan')):.3f} / "
            f"{dp.get('dev', float('nan')):.3f} ms")
        if not same:
            raise AssertionError(f"phase 39: B's {name} step differs")
    del arms, plain, arm
    torch.cuda.empty_cache()

    # a Heun sample of 64 from the FSDP-placed B: the cast copy's blocks
    # gathered layer by layer inside the sampler's graph
    out, c, seconds = {}, None, {}
    for placed in (False, True):
        model = karras(cfg_b())
        model.init(seed=0)
        if placed:
            state, _ = create_train_state(model, x.shape, seed=None)
            shard_state_fsdp(state, mesh)
        model.sample(FS_SAMPLE, (28, 28, 1),
                     torch.Generator("cuda").manual_seed(7), nsteps=NSTEPS)
        kernels.reset_launches()
        out[placed] = model.sample(FS_SAMPLE, (28, 28, 1),
                                   torch.Generator("cuda").manual_seed(7),
                                   nsteps=NSTEPS)
        torch.cuda.synchronize()
        if placed:
            c = dict(kernels.LAUNCHES)
        seconds[placed] = walls(lambda: model.sample(
            FS_SAMPLE, (28, 28, 1), torch.Generator("cuda").manual_seed(7),
            nsteps=NSTEPS), 3)
        del model
    want = dict(zero, fused_axby=NFE, norm_silu=NORMS_B * NFE)
    same = torch.equal(out[True], out[False])
    log(f"[fsdp (a) B] {FS_SAMPLE}-image Heun sample from the FSDP-placed "
        f"model: {'bit for bit' if same else 'DIFFERENT'} against the "
        f"unplaced model's; launches {c}; {fmt(seconds[True])} against "
        f"{fmt(seconds[False])}")
    if not same or c != want:
        raise AssertionError("phase 39: the FSDP-placed sample differs")
    counts.append(c)
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    return counts


@contextlib.contextmanager
def counted_collectives():
    """Inside it, the calls of each ``torch.distributed`` collective the
    port makes, by name (a dict filled as they come)."""
    import torch.distributed as dist

    names = ("all_reduce", "all_gather", "all_gather_into_tensor",
             "reduce_scatter_tensor", "broadcast")
    real = {n: getattr(dist, n) for n in names}
    counts = dict.fromkeys(names, 0)

    def wrap(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return real[name](*args, **kwargs)
        return call
    for n in names:
        setattr(dist, n, wrap(n))
    try:
        yield counts
    finally:
        for n in names:
            setattr(dist, n, real[n])


def _fs_rank(rank, world, port, out_dir, names):
    """A rank of parts (b) to (d): gloo over CUDA tensors on device 0.
    Writes its record (each arm's result, or the error that ended it)."""
    import traceback

    import torch.distributed as dist

    from diffsci_tpu_torch import create_train_state, kernels, make_train_step
    from diffsci_tpu_torch.checkpoint import gather_state
    from diffsci_tpu_torch.parallel import (make_mesh, replicate,
                                            shard_batch, shard_state_fsdp,
                                            shard_state_spatial)

    card = torch.cuda.is_available()    # False in a CPU rehearsal
    if card:
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    if card:
        kernels.load_all()
    record = {}
    path = os.path.join(out_dir, f"fsdp.{world}.{rank}.json")

    def close(a, b, rtol, atol):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b))))

    def params_err(ours, ref):
        return max(close(ours[k].cpu(), v.cpu(), 1e-4, 1e-6)
                   for k, v in ref.items())

    def whole(state):
        return {k[len("params/"):]: v for k, v in gather_state(state).items()
                if k.startswith("params/")}

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30 if card else 0.0

    def reset_peak():
        if card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def arm(name, fn):
        record[name] = "started"
        with open(path, "w") as f:
            json.dump(record, f)
        try:
            record[name] = fn()
        except Exception:     # recorded; the parent decides
            record[name] = "ERROR " + traceback.format_exc()[-1500:]
        with open(path, "w") as f:
            json.dump(record, f)

    def b_arms(place, batch=PAR_B_BATCH):
        """B in f32 (the pins' AdamW), FS_STEPS eager steps on replayed
        draws, for each (mode, place(state) -> batch shard); a mode named
        ``*_remat`` steps with ``remat=True``. The single-process arm runs
        eagerly too (a CUDA graph's replay allocates from its own pool,
        which ``max_memory_allocated`` after a reset does not see)."""
        gen = torch.Generator("cuda").manual_seed(11)
        x = torch.randn((batch, 28, 28, 1), generator=gen, device="cuda")
        draws = [(torch.exp(torch.randn(batch, generator=gen,
                                        device="cuda") * 1.2 - 1.2),
                  torch.randn(x.shape, generator=gen, device="cuda"))
                 for _ in range(FS_STEPS)]
        out = {}
        for mode, placer in place.items():
            reset_peak()
            model = karras_f32(cfg_b())
            state, tx = create_train_state(model, x.shape, seed=0,
                                           optimizer=pin_optimizer())
            shard = placer(state)
            step = make_train_step(model, tx, remat=mode.endswith("_remat"),
                                   _raw=mode == "single")
            losses, ms = [], 0.0
            for k, (sigma, eps) in enumerate(draws):
                last = k == FS_STEPS - 1
                calls = counted_collectives() if last \
                    else contextlib.nullcontext({})
                if last and card:      # the peak over one step
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                with calls as collectives:
                    t0 = time.perf_counter()
                    losses.append(float(step(state, shard(x), sigma=sigma,
                                             eps=eps)[1]["train_loss"]))
                    ms = (time.perf_counter() - t0) * 1e3
            specs = state.placement.specs if state.placement else {}
            out[mode] = dict(losses=losses, params=whole(state),
                             held=held_bytes(model.net),
                             state=state_bytes(state), peak=peak_gib(),
                             ms=ms, specs=specs,
                             collectives=dict(collectives))
            del model, state, step
        single = out.pop("single")
        res = {}
        for mode, o in out.items():
            res[mode] = dict(
                err=max(close(o["losses"], single["losses"], 1e-5, 0.0),
                        params_err(o["params"], single["params"])),
                held=o["held"], state=o["state"], peak_gib=o["peak"],
                ms=o["ms"], losses=o["losses"],
                collectives=o["collectives"])
            blocks = {k for k, s in o["specs"].items() if "data" in s}
            sizes = {k: v.numel() * v.element_size()
                     for k, v in single["params"].items()}
            # a block is 1/2 of its tensor along each axis (2 ranks each)
            res[mode]["want_held"] = sum(
                b // 2 ** len([a for a in o["specs"].get(k, ()) if a])
                for k, b in sizes.items())
            res[mode]["blocks"] = len(blocks)
        res["single"] = dict(held=single["held"], state=single["state"],
                             peak_gib=single["peak"], ms=single["ms"],
                             losses=single["losses"])
        return res

    def b_fsdp():
        # part (b): B's FSDP step (and DP's) at world 2
        mesh = make_mesh(device_type="cpu")

        def dp(state):
            replicate(state, mesh)
            return lambda a: shard_batch(a, mesh)

        def fsdp(state):
            shard_state_fsdp(state, mesh)
            return lambda a: shard_batch(a, mesh)
        return b_arms({"single": lambda s: (lambda a: a), "dp": dp,
                       "fsdp": fsdp, "dp_remat": dp, "fsdp_remat": fsdp})

    def c_fsdp_tp():
        # part (c): B's FSDP∘TP step on a (2, 2) data × tensor mesh
        mesh = make_mesh(axes=("data", "tensor"), shape=(2, 2),
                         device_type="cpu")

        def fsdp_tp(state):
            shard_state_fsdp(state, mesh, tensor_axis="tensor")
            return lambda a: shard_batch(a, mesh)
        return b_arms({"single": lambda s: (lambda a: a),
                       "fsdp_tp": fsdp_tp})

    def h_memory():
        # a reading: H's DiT-B, one bf16 step, DP against FSDP
        res = {}
        gen = torch.Generator("cuda").manual_seed(12)
        x = torch.randn(FS_H_SHAPE, generator=gen, device="cuda")
        for mode in ("dp", "fsdp"):
            reset_peak()
            model = model_h()
            state, tx = create_train_state(model, FS_H_SHAPE, seed=0)
            mesh = make_mesh(device_type="cpu")
            (replicate if mode == "dp" else shard_state_fsdp)(state, mesh)
            before = state_bytes(state)
            step = make_train_step(model, tx)
            t0 = time.perf_counter()
            loss = float(step(state, shard_batch(x, mesh),
                              generator=torch.Generator("cuda").manual_seed(
                                  13))[1]["train_loss"])
            res[mode] = dict(loss=loss, state_before=before,
                             state_after=state_bytes(state),
                             held=held_bytes(model.net), peak_gib=peak_gib(),
                             ms=(time.perf_counter() - t0) * 1e3)
            del model, state, step
        return res

    def spatial_f32(make, shape, cond, has_mp, witness=None):
        # D's or E's spatial step in f32 against the single-process step
        # on the same weights and replayed draws; ``witness`` (E): the
        # same single-process step in float64 on the CPU, from the card's
        # initial weights, which both f32 steps' gaps are read against
        gen = torch.Generator("cuda").manual_seed(14)
        if cond:
            x, phi = porous_batch(shape[0], shape[1], gen)
            y = {"porosity": phi}
        else:
            x, y = torch.randn(shape, generator=gen, device="cuda"), None
        sigma = torch.exp(torch.randn(shape[0], generator=gen,
                                      device="cuda") * 1.2 - 1.2)
        eps = torch.randn(shape, generator=gen, device="cuda")
        keep = torch.rand(shape[0], generator=gen, device="cuda") > 0.1 \
            if cond else None
        out = {}
        for spatial in (False, True):
            model = make()
            state, tx = create_train_state(model, shape, seed=0,
                                           optimizer=pin_optimizer())
            xb, yb = x, y
            if spatial:
                mesh = make_mesh(axes=("data", "spatial"), shape=(1, 2),
                                 device_type="cpu")
                shard_state_spatial(state, mesh, shape)
                xb = shard_batch(x, mesh)
                yb = None if y is None else shard_batch(y, mesh)
            if not spatial:
                init = {k: v.detach().cpu().clone()
                        for k, v in model.net.state_dict().items()}
            # eager on one process too: the gradients stay readable
            step = make_train_step(model, tx, has_mp_weights=has_mp,
                                   _raw=not spatial)
            met = step(state, xb, yb, sigma=sigma, eps=eps, keep=keep)[1]
            out[spatial] = (float(met["train_loss"]), step_snapshot(state),
                            {k: v.detach().clone() for k, v in
                             model.net.named_buffers()},
                            {k: v.grad.detach().cpu().double()
                             for k, v in state.params.items()})
            del model, state, step
        loss_err = close(out[True][0], out[False][0], 1e-5, 0.0)
        err = max(loss_err, params_err(out[True][1], out[False][1]))
        for k, v in out[False][2].items():
            err = max(err, close(out[True][2][k].cpu(), v.cpu(), 1e-5, 1e-6))
        _, q999, worst = params_within(out[True][1], out[False][1], 1e-3, 1)
        res = dict(err=err, loss_err=loss_err, q999=q999,
                   worst=worst, buffers=sorted(out[False][2]),
                   loss=out[True][0])
        if witness is not None:
            model = witness()
            model.net.to(torch.float64)
            model.net.load_state_dict(init)
            state, tx = create_train_state(model, shape, seed=None,
                                           optimizer=pin_optimizer())
            met = make_train_step(model, tx, has_mp_weights=has_mp)(
                state, x.cpu().double(), None, sigma=sigma.cpu().double(),
                eps=eps.cpu().double())[1]
            p64 = {k: v.detach() for k, v in state.params.items()}
            g64 = {k: v.grad for k, v in state.params.items()}
            for arm, key in ((True, "spatial"), (False, "single")):
                p_gap, g_gap = witness_gaps(out[arm][1], p64, out[arm][3],
                                            g64)
                res[key] = dict(params=p_gap, grads=g_gap,
                                loss=close(out[arm][0],
                                           float(met["train_loss"]),
                                           1e-5, 0.0))
        return res

    def d_f32():
        return spatial_f32(lambda: model_d(cfg_d(), dtype=None),
                           FS_D_SHAPE, True, False)

    def e_f32():
        return spatial_f32(lambda: model_e(cfg_e(), dtype=None),
                           FS_E_SHAPE, False, True,
                           lambda: model_e(cfg_e(), device="cpu", dtype=None))

    def d_bf16():
        # D at its bf16 compute on spatial = 2: one step's launches,
        # FS_TIMED timed steps, the peak memory a rank
        reset_peak()
        gen = torch.Generator("cuda").manual_seed(15)
        x, phi = porous_batch(FS_D_SHAPE[0], FS_D_SHAPE[1], gen)
        model = model_d(cfg_d())
        state, tx = create_train_state(model, FS_D_SHAPE, seed=0)
        mesh = make_mesh(axes=("data", "spatial"), shape=(1, 2),
                         device_type="cpu")
        shard_state_spatial(state, mesh, FS_D_SHAPE)
        xb, yb = shard_batch(x, mesh), shard_batch({"porosity": phi}, mesh)
        step = make_train_step(model, tx)
        g = torch.Generator("cuda").manual_seed(16)
        kernels.reset_launches()
        loss = float(step(state, xb, yb, generator=g)[1]["train_loss"])
        c = {k: v for k, v in kernels.LAUNCHES.items() if v}
        seconds = []
        for _ in range(FS_TIMED):        # float() of the loss syncs
            t0 = time.perf_counter()
            float(step(state, xb, yb, generator=g)[1]["train_loss"])
            seconds.append(time.perf_counter() - t0)
        return dict(loss=loss, counts=c, ms=float(np.median(seconds)) * 1e3,
                    peak_gib=peak_gib(), slab=list(xb.shape),
                    counts_ok=c == {k: v for k, v in SP_PER_STEP.items()
                                    if v})

    def h_fsdp_ep():
        # phase 41: H's MoE twin cut to 2 blocks, f32, one step of one
        # process, of dp × ep and of FSDP over dp × ep on a (2, 2) data ×
        # expert mesh; the launches of each step
        from diffsci_tpu_torch.parallel import shard_state_expert_parallel
        gen = torch.Generator("cuda").manual_seed(17)
        x = torch.randn(FS_H_SHAPE, generator=gen, device="cuda")
        sigma = torch.exp(torch.randn(FS_H_SHAPE[0], generator=gen,
                                      device="cuda") * 1.2 - 1.2)
        eps = torch.randn(FS_H_SHAPE, generator=gen, device="cuda")
        mesh = make_mesh(axes=("data", "expert"), shape=(2, 2),
                         device_type="cpu")
        axes = ("data", "expert")

        def place(mode, state):
            if mode == "single":
                return lambda a: a
            shard_state_expert_parallel(state, mesh)
            if mode == "fsdp_ep":
                shard_state_fsdp(state, mesh,
                                 existing_specs=state.placement.specs)
            return lambda a: shard_batch(a, mesh, axes)

        out = {}
        for mode in ("single", "ep", "fsdp_ep"):
            reset_peak()
            model = model_h_moe_f32()
            state, tx = create_train_state(model, FS_H_SHAPE, seed=0,
                                           optimizer=pin_optimizer())
            shard = place(mode, state)
            step = make_train_step(model, tx, _raw=mode == "single")
            xs = shard(x)
            if card:
                torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            loss = float(step(state, xs, sigma=sigma, eps=eps)[1][
                "train_loss"])
            ms = (time.perf_counter() - t0) * 1e3
            specs = state.placement.specs if state.placement else {}
            out[mode] = dict(loss=loss, params=whole(state),
                             held=held_bytes(model.net),
                             state=state_bytes(state), peak_gib=peak_gib(),
                             ms=ms, specs=specs,
                             counts={k: v for k, v in
                                     kernels.LAUNCHES.items() if v})
            del model, state, step
        single = out["single"]
        sizes = {k: v.numel() * v.element_size()
                 for k, v in single["params"].items()}
        res = {}
        for mode, o in out.items():
            res[mode] = {k: o[k] for k in ("loss", "held", "state",
                                           "peak_gib", "ms", "counts")}
            if mode == "single":
                continue
            res[mode]["err"] = max(
                close(o["loss"], single["loss"], 1e-5, 0.0),
                params_err(o["params"], single["params"]))
            # a block is 1/2 of its tensor along each axis (2 ranks each)
            res[mode]["want_held"] = sum(
                b // 2 ** len([a for a in o["specs"].get(k, ()) if a])
                for k, b in sizes.items())
        return res

    table = {"b_fsdp": b_fsdp, "c_fsdp_tp": c_fsdp_tp,
             "h_memory": h_memory, "d_f32": d_f32, "d_bf16": d_bf16,
             "e_f32": e_f32, "h_fsdp_ep": h_fsdp_ep}
    for name in names:
        arm(name, table[name])
    dist.destroy_process_group()


def fs_group(world, names, out_dir) -> list:
    """``_fs_rank`` in ``world`` spawned processes; every rank's record,
    after the group ends or is stopped at FS_TIMEOUT."""
    import socket

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.start_processes(_fs_rank, args=(world, port, out_dir, names),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + FS_TIMEOUT
    try:
        while time.monotonic() < deadline:
            if ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                break
    except ProcessException as e:
        log(f"[fsdp world {world}] a rank ended: {str(e)[:300]}")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    records = []
    for rank in range(world):
        try:
            with open(os.path.join(out_dir, f"fsdp.{world}.{rank}.json")) as f:
                records.append(json.load(f))
        except (OSError, ValueError):
            records.append({})
    for rank, rec in enumerate(records):
        log(f"[fsdp world {world} rank {rank}] {json.dumps(rec)[:3000]}")
    return records


def phase_fsdp_spatial(zero):
    """Phase 39: (a) one NCCL rank; (b) and (d) two gloo ranks on the one
    card; (c) four, whose group also runs phase 41's FSDP∘EP arm (one
    start-up for both). Returns the launch counts and the four ranks'
    records."""
    import tempfile

    counts = phase_fsdp_world1(zero)
    with tempfile.TemporaryDirectory() as out_dir:
        two = fs_group(2, ["b_fsdp", "d_f32", "e_f32", "d_bf16",
                           "h_memory"], out_dir)
        four = fs_group(4, ["c_fsdp_tp", "h_fsdp_ep"], out_dir)
    failed = []
    for records, gated in ((two, ("b_fsdp", "d_f32", "e_f32", "d_bf16",
                                  "h_memory")),
                           (four, ("c_fsdp_tp",))):
        for rank, rec in enumerate(records):
            for name in gated:
                r = rec.get(name)
                if not isinstance(r, dict):
                    failed.append((len(records), rank, name, str(r)[:300]))
                elif name in ("b_fsdp", "c_fsdp_tp"):
                    for mode, m in r.items():
                        if mode == "single":
                            continue
                        if not m["err"] <= 1.0 or (
                                not mode.startswith("dp")
                                and m["held"] != m["want_held"]):
                            failed.append((len(records), rank, name, mode,
                                           m["err"], m["held"],
                                           m["want_held"]))
                elif name == "d_bf16":
                    if not (r["counts_ok"] and np.isfinite(r["loss"])):
                        failed.append((2, rank, name, r["counts"]))
                elif name == "h_memory":
                    # H's bytes and times are a reading; its steps ran
                    if not all(np.isfinite(r[m]["loss"])
                               for m in ("dp", "fsdp")):
                        failed.append((2, rank, name, r))
                elif name == "e_f32":
                    # E's f32 rounding at full width lies above the CPU
                    # tests' parameter bound on one process too
                    # (scripts/torch_spatial_rounding.py): the spatial
                    # step's gaps to the float64 witness, parameters and
                    # gradients at the worst tensor, within E_WITNESS of
                    # the single-process f32 step's own, and its loss
                    # within the CPU bound of the single-process loss
                    sp, one = r["spatial"], r["single"]
                    if not (r["loss_err"] <= 1.0
                            and sp["params"] <= E_WITNESS * one["params"]
                            and sp["grads"] <= E_WITNESS * one["grads"]):
                        failed.append((2, rank, name, r["loss_err"], sp,
                                       one))
                elif not r["err"] <= 1.0:
                    failed.append((2, rank, name, r["err"]))
    if failed:
        raise AssertionError(f"phase 39 (b)-(d) failed: {failed}")
    b, c = two[0]["b_fsdp"], four[0]["c_fsdp_tp"]
    gib = 2 ** 30
    log(f"[fsdp (b) B] two gloo ranks, f32, {FS_STEPS} eager steps: FSDP "
        f"against the single-process step {b['fsdp']['err']:.3f} of the CPU "
        f"bounds (DP {b['dp']['err']:.3f}); the network's parameters hold "
        f"{b['fsdp']['held'] / 2 ** 20:.3f} MiB a rank between steps, the "
        f"blocks and unsharded tensors exactly ({b['fsdp']['blocks']} "
        f"blocks; DP {b['dp']['held'] / 2 ** 20:.3f} MiB); the state "
        f"(parameters, gradients, moments) {b['fsdp']['state'] / gib:.4f} "
        f"GiB a rank against DP's {b['dp']['state'] / gib:.4f} and one "
        f"process's {b['single']['state'] / gib:.4f}; peak over a step "
        f"{b['fsdp']['peak_gib']:.3f} against {b['dp']['peak_gib']:.3f} "
        f"(DP) and {b['single']['peak_gib']:.3f} GiB; last step "
        f"{b['fsdp']['ms']:.1f} ms against {b['dp']['ms']:.1f} (DP) and "
        f"{b['single']['ms']:.1f} ms (eager); collectives a step "
        f"{b['fsdp']['collectives']} against DP's {b['dp']['collectives']}")
    log(f"[fsdp (b) B] with remat: FSDP {b['fsdp_remat']['err']:.3f} of the "
        f"CPU bounds (DP {b['dp_remat']['err']:.3f}); peak over a step "
        f"{b['fsdp_remat']['peak_gib']:.3f} against DP's "
        f"{b['dp_remat']['peak_gib']:.3f} GiB; last step "
        f"{b['fsdp_remat']['ms']:.1f} against {b['dp_remat']['ms']:.1f} ms; "
        f"collectives a step {b['fsdp_remat']['collectives']}")
    h = two[0]["h_memory"]
    log(f"[fsdp (b) H] reading, DiT-B one bf16 step at world 2 (losses "
        f"{h['fsdp']['loss']:.6f} FSDP, {h['dp']['loss']:.6f} DP): state "
        f"{h['fsdp']['state_before'] / gib:.4f} GiB a rank before the "
        f"step, {h['fsdp']['state_after'] / gib:.4f} after (DP "
        f"{h['dp']['state_before'] / gib:.4f}, "
        f"{h['dp']['state_after'] / gib:.4f}); parameters "
        f"{h['fsdp']['held'] / gib:.4f} against "
        f"{h['dp']['held'] / gib:.4f} GiB; peak {h['fsdp']['peak_gib']:.3f}"
        f" against {h['dp']['peak_gib']:.3f} GiB; the step "
        f"{h['fsdp']['ms']:.1f} against {h['dp']['ms']:.1f} ms")
    log(f"[fsdp (c) B] four gloo ranks, FSDP∘TP on a (2, 2) data × tensor "
        f"mesh, f32: {c['fsdp_tp']['err']:.3f} of the CPU bounds; "
        f"parameters {c['fsdp_tp']['held'] / 2 ** 20:.3f} MiB a rank "
        f"(exactly its blocks), state {c['fsdp_tp']['state'] / gib:.4f} GiB "
        f"against one process's {c['single']['state'] / gib:.4f}; last step "
        f"{c['fsdp_tp']['ms']:.1f} ms; collectives a step "
        f"{c['fsdp_tp']['collectives']}")
    d, e = two[0]["d_bf16"], two[0]["e_f32"]
    log(f"[fsdp (d)] D's full-width step on spatial = 2 (slab {d['slab']}),"
        f" f32 against the single-process step "
        f"{two[0]['d_f32']['err']:.3f} of the CPU bounds (the batch norm's "
        f"{two[0]['d_f32']['buffers']} too); E's widths on 32² (mp, cosine):"
        f" loss {e['loss_err']:.3f} of its CPU bound, parameters |Δ| 99.9% "
        f"{e['q999']:.3e}, max {e['worst']:.3e}, {e['err']:.3f} of the CPU "
        f"bounds; against the float64 witness, parameters "
        f"{e['spatial']['params']:.4f} of the CPU bound (one process's f32 "
        f"step {e['single']['params']:.4f}, ratio "
        f"{e['spatial']['params'] / e['single']['params']:.4f}), gradients "
        f"{e['spatial']['grads']:.3e} of the tensor's largest (one process "
        f"{e['single']['grads']:.3e}, ratio "
        f"{e['spatial']['grads'] / e['single']['grads']:.4f}; gate "
        f"{E_WITNESS}), losses {e['spatial']['loss']:.3f} and "
        f"{e['single']['loss']:.3f} of the CPU bound; D in bf16, eager over "
        f"gloo: "
        f"{d['ms']:.3f} ms/step, peak {d['peak_gib']:.3f} GiB a rank, "
        f"launches a step {d['counts']}")
    return counts + [dict(zero, **d["counts"])], four


# phase 40: the scripts. train_diffusion_mnist at its full defaults for
# 90 steps (--steps 100 gives 6 epochs of 15 batches of 256, the JAX
# script's epoch rule), then eval_fid on its checkpoint
SCRIPT_MNIST = ["--steps", "100"]
SCRIPT_EVAL = ["--nsamples", "200", "--batch", "100", "--fld"]
B_NORMS = 28               # B's norms a network call (14 ResnetBlockCs)
SCRIPT_NFE = 2 * 18 - 1    # the scripts' 18-step Heun samples
# every other script once, at tests/test_scripts.py's sizes (the rest
# cut alike): flags with OUT for the run's directory, and the files
# it must write there
SCRIPT_SMOKE = {
    "train_diffusion_toy": (["--steps", "20", "--batch", "16"], []),
    "train_diffusion_cifar10": (
        ["--steps", "20", "--batch", "8", "--channels", "8", "--outdir",
         "OUT"], ["ckpt/description.json", "metrics.jsonl", "samples.npy",
                  "samples.png"]),
    "train_diffusion_shapes": (
        ["--steps", "20", "--batch", "8", "--channels", "8", "--size", "32",
         "--num-samples", "64", "--outdir", "OUT"],
        ["ckpt/description.json", "morph.png", "samples.png"]),
    "train_diffusion_conditional": (
        ["--steps", "20", "--batch", "8", "--channels", "8", "--nsamples",
         "4", "--outdir", "OUT"], ["conditional_samples.png"]),
    "train_super_resolution": (
        ["--steps", "20", "--batch", "8", "--channels", "8", "--nsamples",
         "4", "--ndraws", "2", "--outdir", "OUT"], ["sr3.png"]),
    "train_ensemble_forecast": (
        ["--steps", "20", "--batch", "8", "--channels", "8", "--ensemble",
         "2", "--eval-ensemble", "2", "--size", "16", "--outdir", "OUT"],
        ["forecast.png"]),
    "train_vae": (["--steps", "20", "--batch", "4", "--resolution", "16",
                   "--outdir", "OUT"], ["ckpt/state.pt"]),
    "sampler_comparison": (
        ["--steps", "20", "--size", "32", "--num-data", "64", "--nsamples",
         "16", "--model-channels", "8", "--batch-size", "8", "--log-dir",
         "OUT/log", "--out", "OUT/out.json"], ["out.json"]),
    "anomaly_detection": (
        ["--steps", "20", "--batch", "8", "--channels", "8", "--neval", "8",
         "--outdir", "OUT"], ["anomaly.png"]),
    "inpainting_demo": (
        ["--steps", "20", "--batch", "8", "--channels", "8", "--neval", "8",
         "--nsteps", "20", "--mode", "repaint", "--outdir", "OUT"],
        ["repaint.png"]),
    "distill_study": (
        ["--steps", "20", "--phase-steps", "4", "--size", "32",
         "--num-data", "64", "--nsamples", "16", "--model-channels", "8",
         "--batch-size", "8", "--start-nsteps", "3", "--log-dir", "OUT/log",
         "--out", "OUT/out.json"], ["out.json"]),
    "entropy_time_profile": (
        ["--train-steps", "60", "--snapshot-every", "20", "--nsamples",
         "400", "--nsteps", "12", "--ngamma", "3", "--datasize", "200",
         "--batch", "64", "--out", "OUT/etp.json"], ["etp.json"]),
    "correlation_thresholds": (
        ["--input", "OUT/../entropy_time_profile/etp.json",
         "--epoch-threshold", "0", "--nsteps", "12", "--initial-range",
         "0.3", "0.9", "3", "--final-range", "0.05", "0.4", "3",
         "--late-range", "0.01", "0.2", "3", "--out", "OUT/corr.csv"],
        ["corr.csv"]),
}


def run_script(name: str, args: list) -> tuple[float, str, object]:
    """A port script's ``main()`` in-process with ``sys.argv`` set (and
    ``--device cuda``), its standard output captured: (the wall seconds
    to a synchronize, the output, what ``main`` returned)."""
    import importlib
    import io
    module = importlib.import_module(f"diffsci_tpu_torch.scripts.{name}")
    argv, out = sys.argv, io.StringIO()
    sys.argv = [f"{name}.py"] + [str(a) for a in args] + ["--device",
                                                          "cuda"]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            ret = module.main()
        torch.cuda.synchronize()
    finally:
        sys.argv = argv
    return time.perf_counter() - t0, out.getvalue(), ret


def flag(args: list, name: str, default):
    return type(default)(args[args.index(name) + 1]) if name in args \
        else default


def phase_scripts(zero):
    """Phase 40: the scripts on the card (module docstring). Returns the
    launch counts of the mnist run and of the eval."""
    import argparse
    import pathlib
    import shutil
    import tempfile

    from diffsci_tpu_torch import kernels
    from diffsci_tpu_torch.checkpoint import load_state, state_tensors
    from diffsci_tpu_torch.data.loading import split_indices
    from diffsci_tpu_torch.scripts import eval_fid

    card = smi("name,power.limit")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_scripts_"))
    try:
        out = tmp / "mnist"
        kernels.reset_launches()
        wall, text, _ = run_script("train_diffusion_mnist",
                                   SCRIPT_MNIST + ["--outdir", out])
        counts_mnist = dict(kernels.LAUNCHES)
        saved = load_state(out / "ckpt")
        steps = int(saved["step"])
        batch = flag(SCRIPT_MNIST, "--batch", 256)
        n_eval = len(split_indices(4096, 0.05, 0)[1]) // batch
        # a train step: 28 K2 and 28 K3; an eval batch: 1 K1 and 28 K2;
        # the 16-sample grid: its sampler graph's warm-up and one replay
        expected = dict(zero, fused_axby=n_eval + 2 * SCRIPT_NFE,
                        norm_silu=B_NORMS * (steps + n_eval
                                             + 2 * SCRIPT_NFE),
                        norm_silu_bwd=B_NORMS * steps)
        rows = [json.loads(r) for r in
                (out / "metrics.jsonl").read_text().splitlines()]
        losses = {r["step"]: r["train_loss"] for r in rows
                  if "train_loss" in r}
        rate = next(r["imgs_per_sec"] for r in reversed(rows)
                    if "imgs_per_sec" in r)
        samples = np.load(out / "samples.npy")
        ns = argparse.Namespace(ckpt=str(out / "ckpt"),
                                channels=flag(SCRIPT_MNIST, "--channels",
                                              64),
                                ema_stds=[0.05, 0.1], no_ema=False)
        model, state, _ = eval_fid.restore(ns, torch.device("cuda"))
        # every tensor as saved, the parameters holding EMA profile 0
        live = state_tensors(state)
        restored = all(torch.equal(live[k].cpu(), saved[
            "ema/0/" + k[len("params/"):] if k.startswith("params/")
            else k]) for k in live)
        again = model.sample(16, (28, 28, 1),
                             torch.Generator("cuda").manual_seed(0),
                             nsteps=18).cpu().numpy()
        ok = (counts_mnist == expected and restored
              and np.array_equal(again, samples)
              and samples.shape == (16, 28, 28, 1)
              and np.isfinite(samples).all()
              and 50 in losses and losses[50] < losses[1])
        log(f"[scripts] train_diffusion_mnist ({ns.channels} channels, "
            f"batch {batch}): "
            f"{steps} steps, {wall:.2f} s wall ({steps / wall:.2f} steps/s "
            f"over the script; {rate / batch:.2f} steps/s, {rate:.0f} "
            f"images/s in the loop's log), train_loss {losses[1]:.4f} -> "
            f"{losses.get(50, float('nan')):.4f}, checkpoint restored bit "
            f"for bit {restored}, its EMA samples again bit for bit "
            f"{np.array_equal(again, samples)}, launches {counts_mnist} "
            f"(expected {expected}) [{card}]")
        if not ok:
            raise AssertionError(f"train_diffusion_mnist on the card: "
                                 f"counts {counts_mnist} (expected "
                                 f"{expected}), restored {restored}, "
                                 f"losses {losses}")

        kernels.reset_launches()
        wall, text, _ = run_script("eval_fid", ["--ckpt", out / "ckpt"]
                                   + SCRIPT_EVAL)
        counts_eval = dict(kernels.LAUNCHES)
        result = json.loads(text.strip().splitlines()[-1])
        n = flag(SCRIPT_EVAL, "--nsamples", 500)
        b = flag(SCRIPT_EVAL, "--batch", 100)
        sizes = [min(b, n - i) for i in range(0, n, b)]
        # each batch size's sampler graph: a warm-up, then every batch of
        # it a replay
        runs = len(sizes) + len(set(sizes))
        expected_eval = dict(zero, fused_axby=SCRIPT_NFE * runs,
                             norm_silu=B_NORMS * SCRIPT_NFE * runs)
        finite = all(np.isfinite(result[k]) for k in ("fid", "kid", "fld",
                                                      "fld_gen_gap"))
        log(f"[scripts] eval_fid ({n} samples at batch {b}, pixel FID, "
            f"FLD): {wall:.2f} s wall ({n / wall:.1f} samples/s), fid "
            f"{result['fid']:.2f} kid {result['kid']:.4f} fld "
            f"{result['fld']:.2f}, launches {counts_eval} (expected "
            f"{expected_eval}) [{card}]")
        if counts_eval != expected_eval or not finite or \
                result["nsamples"] != n:
            raise AssertionError(f"eval_fid on the card: {counts_eval} "
                                 f"(expected {expected_eval}), {result}")

        for name, (args, files) in SCRIPT_SMOKE.items():
            where = tmp / name
            where.mkdir()
            args = [a.replace("OUT", str(where)) for a in args]
            wall, text, _ = run_script(name, args)
            missing = [f for f in files if not (where / f).is_file()]
            steps = flag(args, "--steps", flag(args, "--train-steps", 0))
            rate = f"{steps / wall:.2f} steps/s" if steps else "no steps"
            log(f"[scripts] {name}: {wall:.2f} s wall ({rate}); "
                f"{text.strip().splitlines()[-1][:160]} [{card}]")
            if missing:
                raise AssertionError(f"{name} on the card wrote no "
                                     f"{missing}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return [counts_mnist, counts_eval]


# ---------------------------------------------------------------------------
# phase 41: the last four scripts, the sampler graphs keyed on the
# scheduler, FSDP over an expert-parallel state
# ---------------------------------------------------------------------------
# the sweep at _build_state's widths (PUNetG 32 channels, expansion [2]:
# 20 norms a network call) with 250 samples of 100 steps a γ, sequential
# and over 2 worker processes
SWEEP = ["--gammas", "0.0", "0.5", "1.0", "--nsamples", "250", "--nsteps",
         "100"]
SWEEP_NORMS = 20
# the study, Picard/restart and the repro at their default widths
# (expansion [2, 4]: B_NORMS a call), cut in steps and samples
STUDY = ["--steps", "100", "--nsamples", "256", "--nfe", "18", "--gammas",
         "0.01", "1.0", "5.0"]
PICARD = ["--train-steps", "100", "--nsamples-fid", "128"]
REPRO_FULL = ["--channels", "128", "--steps", "30", "--nsamples", "100",
              "--nfe", "18"]
REPRO_FILES = ["ckpt/state.pt", "ckpt/description.json", "fid_results.json",
               "metrics.jsonl"]


def heun_calls(nsteps: int) -> int:
    """Network calls of an nsteps Heun sample (the last step is Euler)."""
    return 2 * nsteps - 1


def restart_calls(nsteps: int, restarts) -> int:
    """Network calls of ``sample_restart``: the Heun grid, then each
    interval's K jumps back over its width of the grid
    (``tests/test_torch_card.py``'s rule)."""
    from diffsci_tpu_torch.ops import EDMScheduler
    sigma = EDMScheduler().create_steps(nsteps + 1)[:-1]
    calls = heun_calls(nsteps)
    for lo, hi, k in restarts:
        width = int(np.argmin(np.abs(sigma - lo))) - int(
            np.argmin(np.abs(sigma - hi)))
        calls += 2 * k * width
    return calls


def eval_batches(batch: int, n: int, log_dir, frac: float = 0.05) -> int:
    """The eval batches of a ``fit_karras`` run over ``n`` rows at
    ``batch``: its validations (one an epoch, each a row of the log in
    ``log_dir`` with a ``valid_loss``) times the batches of one pass."""
    import pathlib

    from diffsci_tpu_torch.data.loading import split_indices
    log_file = pathlib.Path(log_dir) / "metrics.jsonl"
    rows = [json.loads(r) for r in log_file.read_text().splitlines()]
    passes = sum("valid_loss" in r for r in rows)
    return passes * (len(split_indices(n, frac, 0)[1]) // batch)


@contextlib.contextmanager
def recorded_samplers():
    """Inside it, every call of ``KarrasModel.sample``, ``sample_parallel``
    and ``sample_restart``: (method, its arguments, the K1 and K2 it
    launched, whether it captured a graph, Picard's sweeps). Picard's
    calls are made with ``return_sweeps=True`` and return what was
    asked. A chunked ``sample`` (``maximum_batch_size``) would record
    each chunk inside its own call: the recorded scripts make none."""
    from diffsci_tpu_torch import KarrasModel, kernels
    calls = []
    real = {n: getattr(KarrasModel, n) for n in
            ("sample", "sample_parallel", "sample_restart")}

    def wrap(name):
        return lambda self, *args, **kwargs: record(name, self, args,
                                                    kwargs)

    def record(name, self, args, kwargs):
        before = dict(kernels.LAUNCHES)
        graphs_before = len(self._graphs.graphs) if self._graphs else 0
        sweeps = None
        if name == "sample_parallel":
            want = kwargs.pop("return_sweeps", False)
            out, sweeps = real[name](self, *args, return_sweeps=True,
                                     **kwargs)
            result = (out, sweeps) if want else out
        else:
            result = real[name](self, *args, **kwargs)
        after = dict(kernels.LAUNCHES)
        graphs_after = len(self._graphs.graphs) if self._graphs else 0
        calls.append(dict(
            name=name, args=args, kwargs=kwargs, sweeps=sweeps,
            k1=after["fused_axby"] - before["fused_axby"],
            k2=after["norm_silu"] - before["norm_silu"],
            captured=graphs_after - graphs_before))
        return result
    for n in real:
        setattr(KarrasModel, n, wrap(n))
    try:
        yield calls
    finally:
        for n, fn in real.items():
            setattr(KarrasModel, n, fn)


def expected_k1(call: dict) -> int:
    """K1 a recorded sampler call launches: its network calls a run,
    twice when it captured its graph (the eager warm-up, then the
    replay; a Picard capture's warm-up is one sweep)."""
    kw = call["kwargs"]
    nsteps = kw.get("nsteps", 100)
    if call["name"] == "sample_parallel":
        return call["sweeps"] + (1 if call["captured"] else 0)
    if call["name"] == "sample_restart":
        per = restart_calls(nsteps, kw.get("restarts", ((0.05, 2.0, 2),)))
    elif kw.get("integrator") == "euler" or kw.get("stochastic"):
        per = nsteps
    else:
        per = heun_calls(nsteps)
    return per * (1 + call["captured"])


def phase_scripts_last(zero, four=None):
    """Phase 41: the last four scripts on the card (module docstring), the
    repair witness of the scheduler-keyed graphs and FSDP over an
    expert-parallel state, whose arm ran in phase 39's four ranks
    (``four``, their records; None: a group of four started here).
    Returns the launch counts."""
    import argparse
    import pathlib
    import shutil
    import tempfile

    from diffsci_tpu_torch import kernels
    from diffsci_tpu_torch.ops import EDMScheduler
    from diffsci_tpu_torch.scripts import stochasticity_sweep

    card = smi("name,power.limit")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_last_"))
    counts = []
    # the scripts run at PyTorch's default precision flags, which the
    # sweep's workers take from the task file
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        # --- the sweep: sequential (counted), then over 2 processes ----
        out = {}
        walls = {}
        for label, extra in (("sequential", []),
                             ("processes", ["--processes", "2"])):
            kernels.reset_launches()
            walls[label], _, _ = run_script(
                "stochasticity_sweep",
                SWEEP + ["--out", tmp / f"sweep_{label}.json"] + extra)
            counts.append(dict(kernels.LAUNCHES))
            out[label] = (tmp / f"sweep_{label}.json").read_text()
        gammas = [float(g) for g in SWEEP[1:SWEEP.index("--nsamples")]]
        nsteps = flag(SWEEP, "--nsteps", 100)
        calls = 2 * sum(heun_calls(nsteps) if g == 0 else nsteps
                        for g in gammas)
        want = dict(zero, fused_axby=calls, norm_silu=SWEEP_NORMS * calls)
        scores = json.loads(out["sequential"])
        same = out["sequential"] == out["processes"]
        ok = (same and counts[0] == want and counts[1] == zero
              and all(np.isfinite(v) for v in scores.values())
              and len(set(scores.values())) == len(gammas))
        log(f"[scripts 41 sweep] {len(gammas)} γ × "
            f"{flag(SWEEP, '--nsamples', 500)} samples of {nsteps} steps: "
            f"sequential {walls['sequential']:.2f} s, --processes 2 "
            f"{walls['processes']:.2f} s; FIDs {scores}; the two JSONs "
            f"equal bit for bit {same}; launches {counts[0]} (expected "
            f"{want}), the parent of the workers {counts[1]} [{card}]")
        if not ok:
            raise AssertionError(f"stochasticity_sweep on the card: same "
                                 f"{same}, {out}, counts {counts[:2]} "
                                 f"(expected {want})")

        # --- the repair: a swapped scheduler gets its own graph ---------
        ns = argparse.Namespace(ckpt=None)
        device = torch.device("cuda")

        def draw(m, gamma):
            m.config.noisescheduler = EDMScheduler(langevin_const=gamma)
            return m.sample(16, (28, 28, 1),
                            torch.Generator("cuda").manual_seed(5),
                            nsteps=18, stochastic=True).cpu()

        model, _ = stochasticity_sweep.build_state(ns, device)
        at_half = draw(model, 0.5)
        swapped = draw(model, 3.0)
        fresh = draw(stochasticity_sweep.build_state(ns, device)[0], 3.0)
        ok = torch.equal(swapped, fresh) and not torch.equal(swapped,
                                                             at_half)
        log(f"[scripts 41 repair] one model sampled at γ 0.5, then its "
            f"scheduler swapped to γ 3.0: bit for bit a fresh model's γ 3.0 "
            f"sample {torch.equal(swapped, fresh)}, max|Δ| from the γ 0.5 "
            f"sample {float((swapped - at_half).abs().max()):.4f}; "
            f"{len(model._graphs.graphs)} graphs captured "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("a swapped scheduler replayed the old "
                                 "scheduler's graph")
        del model

        # --- the study: one sampler graph for the γ sweep ---------------
        kernels.reset_launches()
        wall, text, _ = run_script("stochasticity_study", STUDY + [
            "--log-dir", tmp / "study", "--out", tmp / "study.json"])
        c = dict(kernels.LAUNCHES)
        counts.append(c)
        art = json.loads((tmp / "study.json").read_text())
        steps, nfe = art["train_steps"], art["nfe"]
        n_eval = eval_batches(flag(STUDY, "--batch-size", 128),
                              flag(STUDY, "--num-data", 4096), tmp / "study")
        # one graph: its warm-up, then a replay a γ (EM: nfe calls a run)
        runs = 1 + len(art["sweep"])
        want = dict(zero, fused_axby=n_eval + runs * nfe,
                    norm_silu=B_NORMS * (steps + n_eval + runs * nfe),
                    norm_silu_bwd=B_NORMS * steps)
        fids = [r["fid"] for r in art["sweep"]]
        ok = c == want and all(np.isfinite(fids)) and steps == flag(
            STUDY, "--steps", 1500)
        log(f"[scripts 41 study] {steps} steps, {art['nsamples']} samples "
            f"a γ at {nfe} NFE: {wall:.2f} s wall; FID {fids} at γ "
            f"{[r['gamma'] for r in art['sweep']]}, shape_ok "
            f"{art['shape_ok']}; launches {c} (expected {want}: one "
            f"sampler graph for the {len(fids)} γ) [{card}]")
        if not ok:
            raise AssertionError(f"stochasticity_study on the card: {c} "
                                 f"(expected {want}), FIDs {fids}")

        # --- Picard and restart on the trained model ---------------------
        kernels.reset_launches()
        with recorded_samplers() as calls:
            wall, text, art = run_script("picard_restart_trained", PICARD + [
                "--log-dir", tmp / "picard", "--out", tmp / "picard.json"])
        c = dict(kernels.LAUNCHES)
        counts.append(c)
        steps = art["train_steps"]
        sampled = sum(r["k1"] for r in calls)
        bad = [(r["name"], r["kwargs"], r["k1"], expected_k1(r), r["k2"])
               for r in calls if r["k1"] != expected_k1(r)
               or r["k2"] != B_NORMS * r["k1"]]
        n_eval = eval_batches(flag(PICARD, "--batch-size", 128),
                              flag(PICARD, "--num-data", 4096),
                              tmp / "picard")
        want = dict(zero, fused_axby=n_eval + sampled,
                    norm_silu=B_NORMS * (steps + n_eval + sampled),
                    norm_silu_bwd=B_NORMS * steps)
        arms, claims = art["arms"], art["claims"]
        ok = (not bad and c == want and claims["picard18_matches_euler18"]
              and arms["picard@100_w16"]["sweeps"] < 100
              and all(np.isfinite(a["pixel_fid"]) for a in arms.values()
                      if "pixel_fid" in a))
        log(f"[scripts 41 picard] {steps} steps, {len(calls)} sampler "
            f"calls, each's K1 its network calls (sweeps for Picard) "
            f"{not bad}; {wall:.2f} s wall; device {art['device']}")
        for label, row in arms.items():
            log(f"[scripts 41 picard]   {label}: {row}")
        log(f"[scripts 41 picard] claims {claims}; launches {c} (expected "
            f"{want}) [{card}]")
        if not ok:
            raise AssertionError(f"picard_restart_trained on the card: "
                                 f"calls off {bad}, {c} (expected {want}), "
                                 f"claims {claims}")

        # --- the repro: --smoke, then the full width and a --ckpt rerun --
        for label, args in (("smoke", ["--smoke"]), ("full", REPRO_FULL)):
            outdir = tmp / f"repro_{label}"
            kernels.reset_launches()
            wall, text, first = run_script(
                "repro_reference_fid", args + ["--outdir", outdir])
            c = dict(kernels.LAUNCHES)
            kernels.reset_launches()
            wall2, _, again = run_script(
                "repro_reference_fid", args + ["--outdir", tmp / (
                    f"repro_{label}_again"), "--ckpt", outdir / "ckpt"])
            c2 = dict(kernels.LAUNCHES)
            counts += [c, c2]
            saved = json.loads((outdir / "fid_results.json").read_text())
            steps, nfe = saved["steps_trained"], saved["nfe"]
            # the ODE target's Heun graph and the two SDE targets' EM
            # graphs (a model each): each warmed up, then replayed once
            calls = 2 * (heun_calls(nfe) + 2 * nfe)
            want = dict(zero, fused_axby=calls,
                        norm_silu=B_NORMS * (steps + calls),
                        norm_silu_bwd=B_NORMS * steps)
            want2 = dict(zero, fused_axby=calls, norm_silu=B_NORMS * calls)
            missing = [f for f in REPRO_FILES
                       if not (outdir / f).is_file()]
            ok = (c == want and c2 == want2 and again == first
                  and len(first) == 3 and not missing
                  and all(np.isfinite(v) for v in first.values()))
            log(f"[scripts 41 repro {label}] {steps} steps at "
                f"{flag(args, '--channels', 128) if label == 'full' else 8}"
                f" channels, {saved['nsamples']} samples at {nfe} NFE: "
                f"{wall:.2f} s wall, the --ckpt rerun {wall2:.2f} s; FIDs "
                f"{first} (the rerun bit for bit {again == first}; "
                f"{saved['feature_space']}); launches {c} and {c2} "
                f"(expected {want}, {want2}) [{card}]")
            if not ok:
                raise AssertionError(f"repro_reference_fid {label} on the "
                                     f"card: {c} / {c2} (expected {want} / "
                                     f"{want2}), {first} / {again}, "
                                     f"missing {missing}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # --- FSDP over dp × ep: H's MoE twin on four gloo ranks -------------
    if four is None:
        with tempfile.TemporaryDirectory() as out_dir:
            four = fs_group(4, ["h_fsdp_ep"], out_dir)
    want = {"flash_attention": 2, "flash_attention_dq": 2,
            "flash_attention_dkv": 2}
    failed = []
    for rank, rec in enumerate(four):
        r = rec.get("h_fsdp_ep")
        if not isinstance(r, dict):
            failed.append((rank, str(r)[:600]))
            continue
        for mode, m in r.items():
            if m["counts"] != want or (mode != "single" and (
                    not m["err"] <= 1.0
                    or (mode == "fsdp_ep" and m["held"] != m["want_held"]))):
                failed.append((rank, mode, m["err"] if mode != "single"
                               else None, m["held"], m.get("want_held"),
                               m["counts"]))
        if not r["fsdp_ep"]["held"] < r["ep"]["held"]:
            failed.append((rank, "held", r["fsdp_ep"]["held"],
                           r["ep"]["held"]))
    if failed:
        raise AssertionError(f"phase 41 FSDP∘EP failed: {failed}")
    r = four[0]["h_fsdp_ep"]
    mib = 2 ** 20
    log(f"[scripts 41 fsdp∘ep] H's MoE twin (2 blocks, 4 experts in the "
        f"second) f32 on a (2, 2) data × expert mesh of four gloo ranks, one "
        f"step at batch {FS_H_SHAPE[0]}: FSDP∘EP {r['fsdp_ep']['err']:.3f} "
        f"and dp × ep {r['ep']['err']:.3f} of the CPU bounds against one "
        f"process; parameters {r['fsdp_ep']['held'] / mib:.3f} MiB a rank "
        f"(its blocks exactly) against dp × ep's "
        f"{r['ep']['held'] / mib:.3f} and one process's "
        f"{r['single']['held'] / mib:.3f}; state "
        f"{r['fsdp_ep']['state'] / mib:.3f} against "
        f"{r['ep']['state'] / mib:.3f} and {r['single']['state'] / mib:.3f}"
        f" MiB; peak {r['fsdp_ep']['peak_gib']:.3f} against "
        f"{r['ep']['peak_gib']:.3f} and {r['single']['peak_gib']:.3f} GiB; "
        f"the step {r['fsdp_ep']['ms']:.1f} against {r['ep']['ms']:.1f} and "
        f"{r['single']['ms']:.1f} ms (eager); launches a rank's step "
        f"{r['fsdp_ep']['counts']} [{card}]")
    counts.append(dict(zero, **r["fsdp_ep"]["counts"]))
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "GPU only", file=sys.stderr)
        return 2
    from diffsci_tpu_torch import PUNetGConfig

    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    # the float32 checks of phases 1 to 3 compare full-f32 arithmetic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    def elapsed(phases):
        log(f"[time] phases {phases} done at "
            f"{time.perf_counter() - t_start:.1f} s")

    records = phase_kernels()
    elapsed("1")
    phase_card_vs_cpu()
    phase_train_card_vs_cpu()
    phase_ddpm_card_vs_cpu()
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's default again
    elapsed("2-4")

    cfg_a = PUNetGConfig(dimension=3, model_channels=32,
                         channel_expansion=[2], num_heads=2,
                         attn_backend="flash")
    counts_a, runs_a, svc_a = serve("config A", karras(cfg_a), (32, 32, 32, 1),
                                    (1, 4), (1, 3, 6), 3, NSTEPS)
    cfg_b = PUNetGConfig(model_channels=64, channel_expansion=[2, 4])
    counts_b, runs_b, svc_b = serve("config B", karras(cfg_b), (28, 28, 1),
                                    (1, 8, 64), (1, 64, 70), 8, NSTEPS)

    # every bucket run is one 18-step Heun sample: 35 network calls, each
    # one combine (K1), two norms per ResnetBlockC (K2: 10 blocks in A,
    # 14 in B) and, in A, one bottleneck attention (K4)
    zero = dict.fromkeys(records, 0)
    expected_a = dict(zero, fused_axby=NFE * runs_a,
                      norm_silu=20 * NFE * runs_a,
                      flash_attention=NFE * runs_a)
    expected_b = dict(zero, fused_axby=NFE * runs_b,
                      norm_silu=28 * NFE * runs_b)
    if counts_a != expected_a or counts_b != expected_b:
        raise AssertionError(f"launch counts {counts_a} / {counts_b}, "
                             f"expected {expected_a} / {expected_b}")
    log(f"[counts] serving went through every forward kernel: config A "
        f"{counts_a}, config B {counts_b}")

    # a train step is one forward and one backward of the network: K2 and
    # K3 once per norm, K4, K5 and K6 once per bottleneck attention (in A)
    # and no K1 (the training combine is the plain expression)
    train_a, _, _ = train(
        "config A", cfg_a, (4, 32, 32, 32, 1), 20,
        dict(zero, norm_silu=20, norm_silu_bwd=20, flash_attention=1,
             flash_attention_dq=1, flash_attention_dkv=1))
    train_b, _, step_ms_b = train("config B", cfg_b, (256, 28, 28, 1), 20,
                       dict(zero, norm_silu=28, norm_silu_bwd=28))

    # configuration C: every bucket run is one DDPM/DDIM sample of nsteps
    # steps, each one K7 launch (one replay of the step's graph); UNet2D's
    # norms are plain GroupNorm + SiLU and its largest attention has 256
    # tokens (below the flash gate). The DDPM arm is one request; the seed
    # check is the DDIM arm's.
    counts_ddim, runs_ddim, svc_ddim = serve(
        "config C DDIM", ddpm_c("from_ddim"), (32, 32, 3), (1, 16),
        (1, 16, 20), 16, DDIM_STEPS)
    counts_ddpm, runs_ddpm, _ = serve(
        "config C DDPM", ddpm_c("from_ddpm"), (32, 32, 3), (16,), (16,), 0,
        DDPM_STEPS)
    expected_ddim = dict(zero, fused_lincomb3=DDIM_STEPS * runs_ddim)
    expected_ddpm = dict(zero, fused_lincomb3=DDPM_STEPS * runs_ddpm)
    if counts_ddim != expected_ddim or counts_ddpm != expected_ddpm:
        raise AssertionError(f"launch counts {counts_ddim} / {counts_ddpm}, "
                             f"expected {expected_ddim} / {expected_ddpm}")
    log(f"[counts] DDIM and DDPM serving went through K7 once per step and "
        f"no other kernel: {counts_ddim}, {counts_ddpm}")

    elapsed("5-9")
    phase_graphs(svc_a, svc_b, svc_ddim, cfg_a, cfg_b,
                 "--profile" in sys.argv[1:])

    # the stochastic samplers, VP and VE (phases 11 to 13)
    torch.backends.cuda.matmul.allow_tf32 = False
    counts_11 = phase_stochastic_card_vs_cpu()
    counts_12 = phase_stochastic_serving(cfg_a, cfg_b, zero)
    counts_13 = phase_train_vp_ve(cfg_a, cfg_b, zero)
    elapsed("10-13")

    # the conditional and magnitude-preserving paths (phases 14 to 16)
    cfg_d = dataclasses.replace(cfg_a, convolution_type="circular",
                                cond_drop=0.1)
    cfg_e = dataclasses.replace(cfg_b, convolution_type="mp",
                                attn_type="cosine")
    counts_14, _, _ = phase_conditional_mp_serving(cfg_d, cfg_e, zero)
    counts_15 = phase_conditional_mp_training(cfg_d, cfg_e, zero)
    torch.backends.cudnn.allow_tf32 = False
    phase_conditional_mp_card_vs_cpu()
    torch.backends.cudnn.allow_tf32 = True

    # the training loop, checkpoints and a served checkpoint (phase 17)
    elapsed("14-16")
    counts_17 = phase_fit_checkpoint_serve(cfg_b, zero, step_ms_b)

    # the optimizers, the serving stack, card against CPU (phases 18 to 20)
    counts_18, trained = phase_optimizers(cfg_b, zero, step_ms_b)
    counts_19 = phase_serving_stack(cfg_a, cfg_b, zero, trained,
                                    svc_ddim.model)
    torch.backends.cudnn.allow_tf32 = False
    counts_20 = phase_serving_card_vs_cpu()
    elapsed("17-20")

    # ensemble/CRPS forecasting and latent diffusion (phases 21 to 23)
    counts_21 = phase_forecast_card_vs_cpu(zero)
    torch.backends.cudnn.allow_tf32 = True
    counts_22, f_trained = phase_forecaster(zero)
    counts_23 = phase_latent(zero, f_trained)
    del f_trained
    elapsed("21-23")

    # the rest of the score-network zoo, and H (DiT-B) and I (ADM) at full
    # width (phases 24 to 26)
    torch.backends.cudnn.allow_tf32 = False
    counts_24 = phase_zoo_card_vs_cpu()
    torch.backends.cudnn.allow_tf32 = True
    elapsed("24")
    counts_25 = phase_h(zero)
    elapsed("25")
    counts_26 = phase_i(zero)
    elapsed("26")

    # progressive distillation and VAE training (phases 27 to 30)
    counts_27 = phase_distill_b(zero)
    elapsed("27")
    torch.backends.cudnn.allow_tf32 = False
    counts_28 = phase_distill_a_card_vs_cpu(zero)
    phase_vae_card_vs_cpu()
    torch.backends.cudnn.allow_tf32 = True
    elapsed("28")
    counts_29 = phase_vae_g(zero)
    counts_30 = phase_vae_porous(zero)
    elapsed("29-30")

    # the other runtimes: flow matching (L), the SDE stack (M), DDPM v1 (N)
    # and the deterministic forecaster (O) (phases 31 to 33)
    torch.backends.cudnn.allow_tf32 = False
    counts_31 = phase_runtimes_card_vs_cpu()
    torch.backends.cudnn.allow_tf32 = True
    elapsed("31")
    counts_32 = phase_l(zero)
    elapsed("32")
    counts_33 = phase_m(zero) + phase_n(zero) + phase_o(zero)
    elapsed("33")

    # the porous-media extras (Q) and the metrics (P) (phases 34 to 36)
    torch.backends.cudnn.allow_tf32 = False
    counts_34 = phase_extras_card_vs_cpu()
    torch.backends.cudnn.allow_tf32 = True
    elapsed("34")
    counts_35 = phase_q(zero)
    elapsed("35")
    counts_36 = phase_p(zero)
    elapsed("36")

    # the parallel modes over torch.distributed (phase 37)
    counts_37 = phase_parallel(zero)
    elapsed("37")
    # data-parallel serving, the dp × spatial step, the placed ensemble,
    # distill and VAE steps (phase 38)
    counts_38 = phase_spatial(zero)
    elapsed("38")
    # FSDP gathered layer by layer, FSDP∘TP, D's and E's spatial steps
    # (phase 39)
    counts_39, four = phase_fsdp_spatial(zero)
    elapsed("39")
    # the scripts on the card (phase 40)
    counts_40 = phase_scripts(zero)
    elapsed("40")
    # the last four scripts, the scheduler-keyed graphs, FSDP∘EP (phase 41)
    counts_41 = phase_scripts_last(zero, four)
    elapsed("41")

    sources = {
        "fused_axby": ("diffsci_tpu_torch/csrc/fused_precondition.cu",
                       "diffsci_tpu/kernels/fused_precondition.py:129"),
        "norm_silu": ("diffsci_tpu_torch/csrc/fused_norm.cu",
                      "diffsci_tpu/kernels/fused_norm.py:140"),
        "norm_silu_bwd": ("diffsci_tpu_torch/csrc/fused_norm.cu",
                          "diffsci_tpu/kernels/fused_norm.py:191"),
        "flash_attention": ("diffsci_tpu_torch/csrc/flash_attention.cu",
                            "diffsci_tpu/kernels/flash_attention.py:82"),
        "flash_attention_dq": ("diffsci_tpu_torch/csrc/flash_attention_bwd.cu",
                               "diffsci_tpu/kernels/flash_attention.py:161"),
        "flash_attention_dkv": (
            "diffsci_tpu_torch/csrc/flash_attention_bwd.cu",
            "diffsci_tpu/kernels/flash_attention.py:188"),
        "fused_lincomb3": ("diffsci_tpu_torch/csrc/fused_precondition.cu",
                           "diffsci_tpu/kernels/fused_precondition.py:208"),
        **{name: ("diffsci_tpu_torch/csrc/fused_norm.cu",
                  f"diffsci_tpu/kernels/{replaces}")
           for name, (_, replaces) in SPLIT_NORMS.items()},
    }
    line = []
    for name, (source, replaces) in sources.items():
        rec = records[name]
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(c[name] for c in [counts_a, counts_b, train_a,
                                           train_b, counts_ddim, counts_ddpm,
                                           counts_11, *counts_12,
                                           *counts_13, *counts_14,
                                           *counts_15, *counts_17,
                                           *counts_18, *counts_19,
                                           *counts_20, *counts_21,
                                           counts_22, *counts_23,
                                           *counts_24, *counts_25,
                                           *counts_26, *counts_27,
                                           *counts_28, *counts_29,
                                           *counts_30, *counts_31,
                                           *counts_32, *counts_33,
                                           *counts_34, *counts_35,
                                           *counts_36, *counts_37,
                                           *counts_38, *counts_39,
                                           *counts_40, *counts_41]),
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"]))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
