from diffsci_tpu_torch.ops import batchnorm, losses, parallel_sampling
from diffsci_tpu_torch.ops.integrators import (DPMSolverPlusPlus2M,
                                               EulerIntegrator,
                                               EulerMaruyamaIntegrator,
                                               HeunIntegrator, Integrator,
                                               KarrasIntegrator,
                                               name_to_integrator)
from diffsci_tpu_torch.ops.noise_samplers import (EDMNoiseSampler,
                                                  NoiseSampler,
                                                  UniformNoiseSampler,
                                                  VENoiseSampler,
                                                  VPNoiseSampler)
from diffsci_tpu_torch.ops.preconditioners import (EDMPreconditioner,
                                                   KarrasPreconditioner,
                                                   NullPreconditioner,
                                                   SR3Preconditioner,
                                                   VEPreconditioner,
                                                   VPPreconditioner)
from diffsci_tpu_torch.ops.preprocessors import (EdgeDetectionPreprocessor,
                                                 make_loss_preprocessor)
from diffsci_tpu_torch.ops.schedulers import (EDMScheduler, Scheduler,
                                              VEScheduler, VPScheduler,
                                              draw_noise, draw_rows)
from diffsci_tpu_torch.ops.scheduling import (EDMSchedulingFunctions,
                                              SchedulingFunctions,
                                              VESchedulingFunctions,
                                              VPSchedulingFunctions,
                                              name_to_scheduling_functions)

__all__ = ["DPMSolverPlusPlus2M", "EDMNoiseSampler",
           "EdgeDetectionPreprocessor", "EDMPreconditioner",
           "EDMScheduler", "EDMSchedulingFunctions", "EulerIntegrator",
           "EulerMaruyamaIntegrator", "HeunIntegrator", "Integrator",
           "KarrasIntegrator", "KarrasPreconditioner", "NoiseSampler",
           "NullPreconditioner", "SR3Preconditioner", "Scheduler",
           "SchedulingFunctions", "UniformNoiseSampler", "VENoiseSampler",
           "VEPreconditioner", "VEScheduler", "VESchedulingFunctions",
           "VPNoiseSampler", "VPPreconditioner", "VPScheduler",
           "VPSchedulingFunctions", "batchnorm", "draw_noise", "draw_rows",
           "losses", "make_loss_preprocessor", "name_to_integrator", "name_to_scheduling_functions",
           "parallel_sampling"]
