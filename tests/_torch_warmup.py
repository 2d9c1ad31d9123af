"""One torch set-up for the port's tests, imported by every
``tests/test_torch_*.py`` (torch only, no JAX).

CPU threads: torch starts one intra-op thread per core in each process,
so the pytest-xdist workers (``-n 6`` on 8 cores) thrashed each other
whenever two ran torch at once (a test of seconds alone took minutes).
Each process takes its share of the cores instead
(``diffsci_tpu_torch.utils.cap_cpu_threads``); a test that spawns ranks
gives each rank its share of that (``tests/_torch_ranks.py``).

torch.exp on the CPU calls MKL's vector exp, which sets itself up on its
first call. When several of torch's threads make that first call at once
(a tensor of 32³ rows, or 200000 σ draws), one thread's share has come
back off by up to 1.5e-4 relative, in about one process of twelve where
XLA's CPU client had run; a test that holds an exp to ~1e-5, or one seed
to one draw, then fails in that process. One small call on one thread
first sets it up.
"""

import torch

from diffsci_tpu_torch.utils import cap_cpu_threads

cap_cpu_threads()
torch.exp(torch.zeros(1))
