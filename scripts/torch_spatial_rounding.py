"""How far float32 rounding moves one train step of configuration E's
network (magnitude-preserving convolutions, cosine attention, the dynamic
loss weight 128) at its widths on 32², on the CPU.

    python3 scripts/torch_spatial_rounding.py [--channels 64]

Prints three comparisons, each on the same weights (seed 0) and draws:
- the dp × spatial step (two gloo ranks, spatial = 2) against the
  single-process step: the loss's relative gap and the parameters' gap as
  a multiple of the CPU tests' bound (rtol 1e-4, atol 1e-6; AdamW at eps
  1e-4, ``tests/_torch_steps.py``), with the tensors that set it;
- the single-process gradients in float32 against float64: each tensor's
  largest gap over its largest entry, the largest first;
- the float64 witness that ``chip_smoke.py`` phase 39 (d) holds E's
  spatial step to: the single-process step in float64, and the gaps of
  the spatial and the single-process float32 steps to it (the
  parameters' in the CPU tests' bound, the gradients' over each tensor's
  largest entry, both at the worst tensor), with their ratios.
A parameter whose gradient is a sum that cancels (a bias or a time-MLP
weight ahead of a norm) carries float32's rounding of that sum into the
step; where the second comparison shows such gaps on one process, the
first cannot be held to the CPU tests' bound, whatever the split.
"""

import argparse
import os
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SHAPE = (8, 32, 32, 1)


def model_e(channels, dtype=torch.float32):
    from diffsci_tpu_torch import (KarrasModel, KarrasModelConfig, PUNetG,
                                   PUNetGConfig)
    cfg = PUNetGConfig(model_channels=channels, channel_expansion=[2, 4],
                       convolution_type="mp", attn_type="cosine")
    model = KarrasModel(PUNetG(cfg, device="cpu"),
                        KarrasModelConfig.from_edm(dynamic_loss_weight=128),
                        device="cpu")
    model.init(0)
    model.net.to(dtype)
    return model


def draws():
    g = torch.Generator().manual_seed(14)
    x = torch.randn(SHAPE, generator=g)
    sigma = torch.exp(torch.randn(SHAPE[0], generator=g) * 1.2 - 1.2)
    return x, sigma, torch.randn(SHAPE, generator=g)


def _rank(rank, world, port, channels, out):
    from diffsci_tpu_torch import create_train_state, make_train_step
    from diffsci_tpu_torch.models.karras.train import AdamWClip
    from diffsci_tpu_torch.parallel import (make_mesh, shard_batch,
                                            shard_state_spatial)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    x, sigma, eps = draws()
    res = {}
    for spatial in (False, True):
        model = model_e(channels)
        state, tx = create_train_state(
            model, SHAPE, seed=None,
            optimizer=AdamWClip(1e-3, 1e-4, 0.9, 0.999, 0.5, eps=1e-4))
        xb = x
        if spatial:
            mesh = make_mesh(axes=("data", "spatial"), shape=(1, world),
                             device_type="cpu")
            shard_state_spatial(state, mesh, SHAPE)
            xb = shard_batch(x, mesh)
        met = make_train_step(model, tx, has_mp_weights=True)(
            state, xb, sigma=sigma, eps=eps)[1]
        res[spatial] = (float(met["train_loss"]),
                        {k: v.detach().clone() for k, v in
                         state.params.items()},
                        {k: v.grad.clone() for k, v in
                         state.params.items()})
    if rank == 0:
        out.update(res)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--channels", type=int, default=64)
    args = ap.parse_args()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = mp.Manager().dict()
    mp.spawn(_rank, args=(2, port, args.channels, out), nprocs=2)
    (l0, p0, g0), (l1, p1, g1) = out[False], out[True]
    ratio = {k: float(((p1[k] - p0[k]).abs()
                       / (1e-6 + 1e-4 * p0[k].abs())).max()) for k in p0}
    worst = sorted(ratio.items(), key=lambda kv: -kv[1])[:5]
    print(f"spatial = 2 against one process: loss {l1!r} against {l0!r} "
          f"(relative {abs(l1 - l0) / abs(l0):.3e}); parameters "
          f"{worst[0][1]:.3f}x the CPU tests' bound, at {worst}")
    x, sigma, eps = draws()
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = model_e(args.channels, dtype)
        model.loss_fn(x.to(dtype), sigma.to(dtype),
                      eps=eps.to(dtype)).backward()
        grads[dtype] = {k: p.grad.double()
                        for k, p in model.net.named_parameters()}
    a, b = grads[torch.float32], grads[torch.float64]

    def gap(x, y, k):
        return float((x[k].double() - y[k].double()).abs().max()
                     / (y[k].double().abs().max() + 1e-30))
    rel = sorted(((gap(a, b, k), k) for k in b), reverse=True)[:5]
    print(f"one process, float32 against float64 gradients (largest gap "
          f"over the tensor's largest entry): {rel}")
    print("the tensors that set the spatial gap: the spatial step's "
          "gradient against one process's, and one process's float32 "
          "against float64 (the same measure): " + ", ".join(
              f"{k} {gap(g1, g0, k):.2e} / {gap(a, b, k):.2e}"
              for k, _ in worst))
    # the float64 witness: the single-process step in float64
    model = model_e(args.channels, torch.float64)
    from diffsci_tpu_torch import create_train_state, make_train_step
    from diffsci_tpu_torch.models.karras.train import AdamWClip
    state, tx = create_train_state(
        model, SHAPE, seed=None,
        optimizer=AdamWClip(1e-3, 1e-4, 0.9, 0.999, 0.5, eps=1e-4))
    l64 = float(make_train_step(model, tx, has_mp_weights=True)(
        state, x.double(), sigma=sigma.double(), eps=eps.double())[1][
            "train_loss"])
    p64 = {k: v.detach() for k, v in state.params.items()}
    g64 = {k: v.grad for k, v in state.params.items()}

    def p_gap(p):
        return max(float(((p[k].double() - p64[k]).abs()
                          / (1e-6 + 1e-4 * p64[k].abs())).max())
                   for k in p64)

    def g_gap(g):
        return max(gap(g, g64, k) for k in g64)
    ps, pl, gs, gl = p_gap(p1), p_gap(p0), g_gap(g1), g_gap(g0)
    print(f"float64 witness (loss {l64!r}): parameters' gap in the CPU "
          f"tests' bound, spatial {ps:.4f}, one process {pl:.4f} (ratio "
          f"{ps / pl:.4f}); gradients' gap over the tensor's largest entry, "
          f"spatial {gs:.3e}, one process {gl:.3e} (ratio {gs / gl:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
