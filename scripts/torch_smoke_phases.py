"""Run chosen phases of ``chip_smoke.py`` alone on the card, after building
the kernels: a development runner that saves the whole script's minutes.

    python3 scripts/torch_smoke_phases.py                     # 34 to 36
    python3 scripts/torch_smoke_phases.py phase_l phase_m     # by name

Phases 34 to 36 (``phase_extras_card_vs_cpu``, ``phase_q``, ``phase_p``)
by default; any phase by its function's name (31 to 33:
``phase_runtimes_card_vs_cpu``, ``phase_l``, ``phase_m``, ``phase_n``,
``phase_o``; 40, the scripts: ``phase_scripts``). Each runs under the flags the whole script gives it (TF32
off for the card-against-CPU phases). Prints the card's name and power
limit last.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from diffsci_tpu_torch import kernels  # noqa: E402

# phases that compare the card with the CPU run with TF32 off
NO_TF32 = {"phase_runtimes_card_vs_cpu", "phase_vae_card_vs_cpu",
           "phase_distill_a_card_vs_cpu", "phase_extras_card_vs_cpu"}
# phases that take no launch-count template
NO_ZERO = {"phase_runtimes_card_vs_cpu", "phase_vae_card_vs_cpu",
           "phase_extras_card_vs_cpu"}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    kernels.load_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or ["phase_extras_card_vs_cpu", "phase_q",
                             "phase_p"]
    for name in names:
        t = time.perf_counter()
        torch.backends.cudnn.allow_tf32 = name not in NO_TF32
        fn = getattr(chip_smoke, name)
        fn() if name in NO_ZERO else fn(zero)
        print(f"{name} ok {time.perf_counter() - t:.1f} s", flush=True)
    print(chip_smoke.smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
