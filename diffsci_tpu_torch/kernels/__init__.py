"""Hand-written Hopper (sm_90a) kernels of the port.

Each module holds a kernel's wrapper and its plain PyTorch version, and a
``torch.autograd.Function`` that joins a forward kernel to its backward.
The wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel (built from ``csrc/`` at first use) or
raises. ``LAUNCHES`` counts launches per wrapper, so a run can show that
its main path went through the kernels.

A wrapper counts when Python calls it. Under a CUDA graph's capture it
enqueues nothing, and a replay calls no Python: ``counting_capture``
takes a capture's counts back off ``LAUNCHES`` and hands them to the
graph, and ``add_launches`` adds them at every replay
(``utils/graphs.py``).
"""

import contextlib

from diffsci_tpu_torch.kernels._build import SOURCES, build

LAUNCHES = {"fused_axby": 0, "norm_silu": 0, "norm_silu_bwd": 0,
            "flash_attention": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0, "fused_lincomb3": 0,
            "norm_silu_stats": 0, "norm_silu_apply": 0,
            "norm_silu_bwd_partials": 0, "norm_silu_bwd_dx": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def add_launches(counts: dict) -> None:
    """Count the launches of one replay of a graph captured with
    ``counting_capture``."""
    for name, n in counts.items():
        LAUNCHES[name] += n


@contextlib.contextmanager
def counting_capture():
    """Around a capture: yields a dict that holds, on exit, the launches
    each wrapper recorded into the graph, and leaves ``LAUNCHES`` as it
    was before the block (a capture runs no kernel)."""
    before = dict(LAUNCHES)
    recorded = {}
    try:
        yield recorded
    finally:
        recorded.update({name: LAUNCHES[name] - n
                         for name, n in before.items() if LAUNCHES[name] != n})
        LAUNCHES.update(before)


def load_all() -> None:
    """Build (one nvcc per missing source, all at once) and load every
    kernel library, so that no capture is the first call into one."""
    from diffsci_tpu_torch.kernels import (_build, flash_attention,
                                           fused_norm, fused_precondition)
    build()
    for name, signatures in (
            ("fused_precondition", fused_precondition._SIGNATURES),
            ("fused_norm", fused_norm._SIGNATURES),
            ("flash_attention", flash_attention.SIGNATURES),
            ("flash_attention_bwd", flash_attention.BWD_SIGNATURES)):
        _build.load(name, signatures)


__all__ = ["LAUNCHES", "SOURCES", "add_launches", "build",
           "counting_capture", "load_all", "reset_launches"]
