"""Multi-process data-parallel dry run: N processes, one rank each, one
global mesh, per-process input shards.

Port of ``diffsci_tpu/parallel/mp_dryrun.py``. It checks, end to end:
- the rendezvous (``initialize_distributed`` with an explicit
  coordinator address);
- ``ArrayDataLoader`` yielding only this process's rows of every global
  batch;
- the data-parallel train step over a replicated state (``replicate``),
  whose gradient all-reduce makes the N-process step the single-process
  step.

``run_multiprocess_dryrun`` spawns the ranks and a single-process control
run, and asserts (a) that each rank read exactly its disjoint rows, whose
union is the control's, and (b) that the N-rank losses equal the
control's. It runs on the CPU over gloo (the default) or on the cards
over NCCL (``device_type="cuda"``, one card a rank).

    python -m diffsci_tpu_torch.parallel.mp_dryrun
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

_TAG = "MPDRYRUN"


def _worker(proc_id: int, nprocs: int, port: int, steps: int,
            global_batch: int, device_type: str) -> None:
    import torch
    import torch.distributed as dist

    from diffsci_tpu_torch.data.loading import ArrayDataLoader
    from diffsci_tpu_torch.models import (EMATracker, KarrasModel,
                                          KarrasModelConfig,
                                          create_train_state,
                                          make_train_step)
    from diffsci_tpu_torch.models.nets.mlp import MLPUncond
    from diffsci_tpu_torch.parallel.mesh import (initialize_distributed,
                                                 make_mesh, mesh_device,
                                                 replicate)
    from diffsci_tpu_torch.utils import cap_cpu_threads

    cap_cpu_threads(nprocs)
    initialize_distributed(f"127.0.0.1:{port}", nprocs, proc_id,
                           device_type=device_type)
    assert dist.get_world_size() == nprocs, dist.get_world_size()
    mesh = make_mesh(device_type=device_type)
    device = mesh_device(mesh)

    # a dataset whose column 0 is the row id, so the loader's
    # per-process rows are seen in the batches themselves
    n, dim = 128, 4
    data = np.random.default_rng(99).standard_normal(
        (n, dim)).astype(np.float32)
    data[:, 0] = np.arange(n)
    loader = ArrayDataLoader(data, batch_size=global_batch, seed=5)
    assert loader.local_batch_size == global_batch // nprocs

    model = KarrasModel(MLPUncond(dim=dim, hidden_dims=[16], device=device),
                        KarrasModelConfig.from_edm(loss_metric="mse"),
                        device=device)
    tracker = EMATracker(ema_type="power", power_function_stds=[0.1])
    state, tx = create_train_state(model, (global_batch, dim), seed=0,
                                   ema=tracker)
    state = replicate(state, mesh)
    step_fn = make_train_step(model, tx, ema=tracker)

    generator = torch.Generator(device).manual_seed(7)
    losses, rows = [], []
    it = iter(loader)
    for _ in range(steps):
        local = next(it)
        rows.extend(int(r) for r in local[:, 0])
        state, metrics = step_fn(state, torch.from_numpy(local).to(device),
                                 generator=generator)
        losses.append(float(metrics["train_loss"]))
    print(_TAG + json.dumps({
        "proc": proc_id, "nprocs": nprocs, "world": dist.get_world_size(),
        "losses": losses, "rows": rows}), flush=True)
    dist.destroy_process_group()


def _spawn(args):
    env = dict(os.environ)
    # an uninstalled checkout still imports
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "diffsci_tpu_torch.parallel.mp_dryrun",
         "--worker"] + [str(a) for a in args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _collect(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"mp_dryrun worker failed (rc={proc.returncode}); stderr "
            f"tail:\n{err[-2000:]}")
    for line in out.splitlines():
        if line.startswith(_TAG):
            return json.loads(line[len(_TAG):])
    raise RuntimeError(f"no {_TAG} line in worker output:\n{out[-2000:]}")


def run_multiprocess_dryrun(nprocs: int = 2, steps: int = 3,
                            global_batch: int = 32, rtol: float = 1e-5,
                            device_type: str = "cpu") -> dict:
    """Spawn the ``nprocs``-rank run and a single-process control (each
    rank and the control at once); assert that the ranks' rows are
    disjoint and make up the control's, and that their losses equal the
    control's within ``rtol``. Returns the comparison."""
    from diffsci_tpu_torch.parallel.mesh import _free_port

    port = _free_port()
    procs = [_spawn([i, nprocs, port, steps, global_batch, device_type])
             for i in range(nprocs)]
    procs.append(_spawn([0, 1, _free_port(), steps, global_batch,
                         device_type]))
    try:
        results = [_collect(p) for p in procs[:nprocs]]
        control = _collect(procs[nprocs])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    all_rows = [r for res in sorted(results, key=lambda r: r["proc"])
                for r in res["rows"]]
    assert len(set(all_rows)) == len(all_rows), "processes shared rows"
    assert sorted(all_rows) == sorted(control["rows"]), \
        "union of per-process shards != single-process batches"
    per_proc = {res["proc"]: set(res["rows"]) for res in results}
    for i in range(nprocs):
        for j in range(i + 1, nprocs):
            assert not (per_proc[i] & per_proc[j])
    losses = np.asarray([res["losses"] for res in results])
    assert np.array_equal(losses, np.broadcast_to(losses[0], losses.shape)), \
        "processes disagree on the (replicated) global loss"
    np.testing.assert_allclose(
        losses[0], control["losses"], rtol=rtol,
        err_msg="multi-process loss != single-process loss")
    return {"mp_losses": losses[0].tolist(),
            "control_losses": control["losses"],
            "rows_per_proc": {k: sorted(v) for k, v in per_proc.items()}}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        _worker(*[int(a) for a in argv[1:6]], argv[6])
        return
    summary = run_multiprocess_dryrun()
    print(f"mp_dryrun 2 ranks: losses "
          f"{[round(v, 5) for v in summary['mp_losses']]} == control OK")


if __name__ == "__main__":
    main()
