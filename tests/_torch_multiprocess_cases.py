"""The cases of ``tests/test_torch_multiprocess.py`` that run in each gloo
rank (``tests/_torch_ranks.py``; torch only, no JAX)."""

from __future__ import annotations

from diffsci_tpu_torch.data.loading import ArrayDataLoader
from tests._torch_ranks import cases


def case_loader(rank, world, p):
    """This rank's batches over two epochs, the process count and index
    taken from the process group."""
    loader = ArrayDataLoader(p["data"], p["batch"], seed=3)
    assert (loader.process_count, loader.process_index) == (world, rank)
    return [b.copy() for _ in range(2) for b in loader]


def run(rank, world, payload):
    return cases({"loader": case_loader}, rank, world, payload)
