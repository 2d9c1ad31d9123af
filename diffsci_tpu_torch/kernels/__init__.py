"""Hand-written Hopper (sm_90a) kernels of the port.

Each module holds a kernel's wrapper and its plain PyTorch version, and a
``torch.autograd.Function`` that joins a forward kernel to its backward.
The wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel (built from ``csrc/`` at first use) or
raises. ``LAUNCHES`` counts launches per wrapper, so a run can show that
its main path went through the kernels.
"""

from diffsci_tpu_torch.kernels._build import SOURCES, build

LAUNCHES = {"fused_axby": 0, "norm_silu": 0, "norm_silu_bwd": 0,
            "flash_attention": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0, "fused_lincomb3": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


__all__ = ["LAUNCHES", "SOURCES", "build", "reset_launches"]
