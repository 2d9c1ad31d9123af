"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller names another device:
``device=None`` means ``cuda`` and raises when CUDA is absent, so a run
never falls back to the CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def cap_cpu_threads(ranks: int = 1) -> int:
    """Set torch's CPU threads to this process's share of the machine's
    cores: ``os.cpu_count()`` over the processes that run at once, the
    pytest-xdist workers (``PYTEST_XDIST_WORKER_COUNT``, 1 when unset)
    times ``ranks`` (the processes a test spawns, or the ranks beside
    this one). Without it, each of those processes starts one thread per
    core, and they thrash. Returns the count set."""
    import os
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    n = max(1, (os.cpu_count() or 1) // (workers * max(1, ranks)))
    torch.set_num_threads(n)
    return n
