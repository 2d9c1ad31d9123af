from diffsci_tpu_torch.ops import losses
from diffsci_tpu_torch.ops.integrators import (EulerIntegrator,
                                               HeunIntegrator, Integrator)
from diffsci_tpu_torch.ops.noise_samplers import EDMNoiseSampler, NoiseSampler
from diffsci_tpu_torch.ops.preconditioners import (EDMPreconditioner,
                                                   KarrasPreconditioner)
from diffsci_tpu_torch.ops.schedulers import EDMScheduler, Scheduler
from diffsci_tpu_torch.ops.scheduling import (EDMSchedulingFunctions,
                                              SchedulingFunctions)

__all__ = ["EDMNoiseSampler", "EDMPreconditioner", "EDMScheduler",
           "EDMSchedulingFunctions", "EulerIntegrator", "HeunIntegrator",
           "Integrator", "KarrasPreconditioner", "NoiseSampler", "Scheduler",
           "SchedulingFunctions", "losses"]
