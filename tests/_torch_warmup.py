"""One torch warm-up for the port's tests, imported by every
``tests/test_torch_*.py`` that compares numbers (torch only, no JAX).

torch.exp on the CPU calls MKL's vector exp, which sets itself up on its
first call. When several of torch's threads make that first call at once
(a tensor of 32³ rows, or 200000 σ draws), one thread's share has come
back off by up to 1.5e-4 relative, in about one process of twelve where
XLA's CPU client had run; a test that holds an exp to ~1e-5, or one seed
to one draw, then fails in that process. One small call on one thread
first sets it up.
"""

import torch

torch.exp(torch.zeros(1))
