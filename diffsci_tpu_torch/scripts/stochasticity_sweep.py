"""Stochasticity sweep: sample with a grid of Langevin constants γ and
score each point of the grid with FID against held-out data.

Port of ``scripts/stochasticity_sweep.py``, the analogue of the reference
stochasticity paper's sweep script (which round-robins its (s_min,
s_max) tasks over 6 GPUs with multiprocessing). Two modes, with the same output
bit for bit on one device:

- sequential (the default): each γ is one sampler run (a CUDA graph on
  the card, keyed on the scheduler, so a new γ captures its own);
- ``--processes N``: the γ grid is dealt round-robin to N worker
  processes (``python -m diffsci_tpu_torch.scripts.stochasticity_sweep
  --worker i --taskfile ...``), the reference's process-level
  parallelism. The parent computes the real features once and ships them
  to every worker in the task file, with one seed per γ that it draws
  from seed 42 (each γ samples from its own ``torch.Generator``) and its
  precision flags (TF32 of matmuls and cuDNN, cuDNN's deterministic and
  benchmark settings), so a worker's results are the sequential run's
  whichever worker runs which γ. ``--device`` is passed on. On a host
  with several cards give each worker its own with ``--pin-env
  CUDA_VISIBLE_DEVICES`` (worker i gets i mod N); one card and the CPU
  are shared.

Usage:
    python -m diffsci_tpu_torch.scripts.stochasticity_sweep
        --ckpt runs/mnist-edm/ckpt --data mnist.npz
        --gammas 0.01 0.1 0.3 1 3 [--processes 3] [--device cuda]
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

from diffsci_tpu_torch.scripts._common import add_device_flag, host
from diffsci_tpu_torch.utils import resolve_device

SEED = 42            # the parent's seed of the per-γ seeds
REAL_SEED = 1        # the N(0, 1) real set without --data
# the precision flags a worker takes from its parent
FLAGS = (("cuda.matmul", "allow_tf32"), ("cudnn", "allow_tf32"),
         ("cudnn", "deterministic"), ("cudnn", "benchmark"))


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=False, default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--gammas", type=float, nargs="+",
                    default=[0.01, 0.1, 0.3, 0.5, 1.0, 2.0, 3.0, 5.0, 8.0])
    ap.add_argument("--nsamples", type=int, default=500)
    ap.add_argument("--nsteps", type=int, default=100)
    ap.add_argument("--out", default="stochasticity_scores.json")
    ap.add_argument("--processes", type=int, default=1,
                    help="distribute gamma arms over N worker processes")
    ap.add_argument("--pin-env", default=None,
                    help="env var set to (worker_id mod processes) in "
                         "each worker, e.g. CUDA_VISIBLE_DEVICES on a "
                         "multi-card host")
    # internal worker-mode flags
    ap.add_argument("--worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--taskfile", default=None, help=argparse.SUPPRESS)
    add_device_flag(ap)
    return ap


def build_state(args, device):
    """The sweep's model (PUNetG, 32 channels, expansion [2], EDM) and its
    train state at 28²×1, from seed 0 or restored from ``--ckpt``."""
    from diffsci_tpu_torch.checkpoint import restore_checkpoint
    from diffsci_tpu_torch.models import (KarrasModel, KarrasModelConfig,
                                          PUNetG, PUNetGConfig,
                                          create_train_state)
    net = PUNetG(PUNetGConfig(model_channels=32, channel_expansion=[2]),
                 device=device)
    model = KarrasModel(net, KarrasModelConfig.from_edm(), device=device)
    state, _ = create_train_state(model, (8, 28, 28, 1), seed=0)
    if args.ckpt:
        state = restore_checkpoint(args.ckpt, state, model)
    return model, state


def features(x) -> np.ndarray:
    """Pixel features (swap for a trained classifier's)."""
    x = host(x)
    return x.reshape(x.shape[0], -1)


def gamma_seeds(n: int) -> np.ndarray:
    """One seed per γ of the grid, drawn in the parent: the sequential and
    the process-parallel modes (and any worker assignment) see the same
    randomness for each γ."""
    return np.random.default_rng(SEED).integers(0, 2 ** 62, size=n)


def evaluate_gammas(model, gammas, seeds, real_feat, args, device) -> dict:
    """Score a list of (index, γ) arms, each sampled from a generator of
    its own seed."""
    from diffsci_tpu_torch import ops
    from diffsci_tpu_torch.metrics import fid

    results = {}
    for (_, gamma), seed in zip(gammas, seeds):
        # γ enters through the scheduler's langevin_const (the reference's
        # schedulers.py:45,219-240); the sampler's graph is keyed on it
        model.config.noisescheduler = ops.EDMScheduler(langevin_const=gamma)
        gen = torch.Generator(device).manual_seed(int(seed))
        samples = model.sample(args.nsamples, (28, 28, 1), gen,
                               nsteps=args.nsteps, stochastic=gamma > 0,
                               maximum_batch_size=250)
        score = float(fid(real_feat, features(samples)))
        results[f"gamma_{gamma}"] = score
        print(f"gamma={gamma}: FID={score:.3f}", flush=True)
    return results


def load_real_feat(args) -> np.ndarray:
    if args.data:
        real = np.load(args.data)["x"].astype(np.float32)
        if real.ndim == 3:
            real = real[..., None]
    else:
        real = np.random.default_rng(REAL_SEED).standard_normal(
            (args.nsamples, 28, 28, 1)).astype(np.float32)
    # the parent computes features over the real set exactly once
    return features(real[:args.nsamples])


def _flag_owner(ns: str):
    return torch.backends.cuda.matmul if ns == "cuda.matmul" else \
        getattr(torch.backends, ns)


def precision_flags() -> np.ndarray:
    """This process's precision flags (``FLAGS``), which the workers
    take."""
    return np.asarray([getattr(_flag_owner(ns), name) for ns, name in FLAGS],
                      bool)


def set_precision_flags(values) -> None:
    for (ns, name), value in zip(FLAGS, values):
        setattr(_flag_owner(ns), name, bool(value))


def worker_main(args):
    device = resolve_device(args.device)
    task = np.load(args.taskfile)
    set_precision_flags(task["flags"])
    mine = [(i, g) for i, g in enumerate(args.gammas)
            if i % args.processes == args.worker]
    seeds = [task["seeds"][i] for i, _ in mine]
    model, _ = build_state(args, device)
    results = evaluate_gammas(model, mine, seeds, task["real_feat"], args,
                              device)
    out = args.taskfile + f".part{args.worker}.json"
    with open(out, "w") as f:
        json.dump(results, f)
    print(f"worker {args.worker}: wrote {out}", flush=True)


def run_workers(args, real_feat, seeds) -> dict:
    """The γ grid over ``args.processes`` worker processes; their merged
    results."""
    root = pathlib.Path(__file__).resolve().parents[2]
    with tempfile.TemporaryDirectory() as td:
        taskfile = os.path.join(td, "task.npz")
        np.savez(taskfile, real_feat=real_feat, seeds=seeds,
                 flags=precision_flags())
        procs = []
        try:
            for w in range(args.processes):
                cmd = [sys.executable, "-m",
                       "diffsci_tpu_torch.scripts.stochasticity_sweep",
                       "--worker", str(w), "--taskfile", taskfile,
                       "--processes", str(args.processes),
                       "--gammas", *[str(g) for g in args.gammas],
                       "--nsamples", str(args.nsamples),
                       "--nsteps", str(args.nsteps),
                       "--device", args.device]
                if args.ckpt:
                    cmd += ["--ckpt", args.ckpt]
                env = dict(os.environ)
                # the package resolves from any working directory
                env["PYTHONPATH"] = os.pathsep.join(
                    [str(root)] + [p for p in env.get(
                        "PYTHONPATH", "").split(os.pathsep) if p])
                if args.pin_env:
                    env[args.pin_env] = str(w % args.processes)
                procs.append(subprocess.Popen(cmd, env=env))
            rcs = [p.wait() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            raise RuntimeError(f"worker exit codes: {rcs}")
        results = {}
        for w in range(args.processes):
            with open(taskfile + f".part{w}.json") as f:
                results.update(json.load(f))
    return results


def main():
    args = build_parser().parse_args()
    if args.worker is not None:
        return worker_main(args)

    device = resolve_device(args.device)
    real_feat = load_real_feat(args)
    seeds = gamma_seeds(len(args.gammas))

    if args.processes <= 1:
        model, _ = build_state(args, device)
        results = evaluate_gammas(model, list(enumerate(args.gammas)),
                                  list(seeds), real_feat, args, device)
    else:
        results = run_workers(args, real_feat, seeds)
        # restore the γ-grid order
        results = {f"gamma_{g}": results[f"gamma_{g}"] for g in args.gammas}

    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
