"""Spawned gloo ranks for the port's parallel tests (torch only, no JAX).

``run_ranks(module, world, payload)`` starts ``world`` processes, each a
rank of one gloo process group on the CPU with its share of the cores
(``cap_cpu_threads``), runs ``module.run(rank, world, payload)`` in each
and returns every rank's result, in rank order. ``module`` is the name
of a module of cases that imports no JAX, so that a rank starts in
seconds; the test file computes the JAX side in its own process. A rank
that does not finish within ``timeout`` seconds fails the test (and all
ranks are stopped), so that a collective that hangs cannot hang the
suite.
"""

from __future__ import annotations

import importlib
import os
import pickle
import socket
import tempfile
import time
import traceback

import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, module, payload, outdir):
    import torch.distributed as dist

    from diffsci_tpu_torch.utils import cap_cpu_threads
    cap_cpu_threads(world)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        result = importlib.import_module(module).run(rank, world, payload)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(module: str, world: int, payload, timeout: float = 240.0):
    with tempfile.TemporaryDirectory() as outdir:
        ctx = mp.start_processes(
            _entry, args=(world, _free_port(), module, payload, outdir),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks of {module} did not "
                                       f"finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        out = []
        for rank in range(world):
            with open(os.path.join(outdir, f"{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def cases(table: dict, rank: int, world: int, payload) -> dict:
    """Run each case of ``table`` (name -> fn(rank, world, payload)) in
    turn; name -> its result, or the traceback's text of the exception it
    raised (so one failing case fails its own test only)."""
    out = {}
    for name, fn in table.items():
        try:
            out[name] = fn(rank, world, payload)
        except Exception:
            out[name] = "ERROR:\n" + traceback.format_exc()
    return out


def result(results: list, name: str, rank: int = 0):
    """A case's result on ``rank``, raising with the rank's traceback when
    the case failed."""
    value = results[rank][name]
    if isinstance(value, str) and value.startswith("ERROR:"):
        raise AssertionError(f"rank {rank}, case {name}:\n{value}")
    return value
