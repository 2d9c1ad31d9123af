"""KarrasModel: the EDM denoiser runtime for training and sampling.

Port of ``diffsci_tpu/models/karras/module.py``'s EDM path:
``KarrasModelConfig.from_edm`` (with ``loss_metric``), ``KarrasNet``, and
``KarrasModel``'s ``init``, ``decode``, ``get_denoiser`` (with
``compute_dtype``, CFG and the ``fused_precondition`` policy),
``loss_fn``, ``get_score``, ``sample``, ``propagate_white_noise`` and
``propagate_toward_sample``.

The network's weights live in the module, so the methods take no
``variables`` unless the caller swaps other weights in (``variables=``, a
state dict, e.g. EMA shadows). Randomness is an explicit
``torch.Generator``. Sample shapes and samples are channels-last
([B, *spatial, C]) as in the JAX package; ``KarrasNet`` moves the channel
axis at the network boundary (a reshape for C = 1).

On a CUDA device ``sample`` replays one CUDA graph of the whole sampling
loop per key, as the JAX package runs one jitted program per shape
(``_jitted_sampler``, ``diffsci_tpu/models/karras/module.py:605-643``).
The Heun loop bakes its grid into the graph as Python floats (σ, the
score multiplier and dt), right for a graph keyed on nsteps.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from diffsci_tpu_torch.kernels import fused_precondition
from diffsci_tpu_torch.models.compute import ComputeDtypeMixin
from diffsci_tpu_torch.models.nets.layers import init_parameters
from diffsci_tpu_torch.ops import (losses, noise_samplers, preconditioners,
                                   schedulers)
from diffsci_tpu_torch.utils import (bcast_right, dict_expand_dims, dict_map,
                                     get_minibatch_sizes, graphs,
                                     resolve_device)


class KarrasModelConfig:
    """The math configuration: preconditioner, training noise sampler,
    sampling scheduler and the training loss metric ("huber", "mse" or
    ``{"huber": {"delta": ...}}``)."""

    def __init__(self, preconditioner: preconditioners.KarrasPreconditioner,
                 noisesampler: noise_samplers.NoiseSampler,
                 noisescheduler: schedulers.Scheduler,
                 loss_metric="huber"):
        self.preconditioner = preconditioner
        self.noisesampler = noisesampler
        self.noisescheduler = noisescheduler
        self.loss_metric = loss_metric

    @classmethod
    def from_edm(cls, sigma_data: float = 0.5, prior_mean: float = -1.2,
                 prior_std: float = 1.2, loss_metric="huber"):
        return cls(
            preconditioner=preconditioners.EDMPreconditioner(sigma_data),
            noisesampler=noise_samplers.EDMNoiseSampler(
                sigma_data, prior_mean, prior_std),
            noisescheduler=schedulers.EDMScheduler(),
            loss_metric=loss_metric)


class KarrasNet(nn.Module):
    """Wraps the score network (state-dict prefix ``model.``) and moves
    the channel axis: channels-last in and out, NC* inside."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x, cnoise, y=None):
        out = self.model(x.movedim(-1, 1), cnoise, y)
        return out.movedim(1, -1).contiguous()


def _needs_unsqueeze(y, x) -> bool:
    """Sample-time conditions without the batch dim get one, so they
    broadcast over the batch."""
    if y is None:
        return False
    probe = y["y"] if isinstance(y, dict) and "y" in y else (
        next(iter(y.values())) if isinstance(y, dict) else y)
    return hasattr(probe, "shape") and (probe.ndim == 0 or
                                        probe.shape[0] != x.shape[0])


class KarrasModel(ComputeDtypeMixin):
    """The denoiser runtime around a score network
    ``net(x, t, y=None)`` on [B, C, *spatial]."""

    def __init__(self, model: nn.Module, config: KarrasModelConfig,
                 conditional: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 fused_precondition: bool | str = "sample",
                 device: torch.device | str | None = None):
        """``compute_dtype`` (e.g. ``torch.bfloat16``): the network runs
        with its parameters and input cast to this dtype, while the
        preconditioning, the combine and the sampler state stay float32.

        ``fused_precondition``: route the combine D = c_skip·x + c_out·F
        through kernel K1 — "sample" (default) when ``train`` is False,
        True always, False never."""
        self.device = resolve_device(device)
        self.config = config
        self.conditional = conditional
        self.compute_dtype = compute_dtype
        self.fused_precondition = fused_precondition
        self.net = KarrasNet(model).to(self.device).eval()
        self._loss_metric = losses.make_loss_metric(config.loss_metric)
        self._reset_cast()

    def to(self, device) -> "KarrasModel":
        self.device = resolve_device(device)
        self.net.to(self.device)
        return self

    def init(self, seed: int = 0) -> dict:
        """Draw every weight from ``seed`` (device-independent); returns
        the state dict."""
        init_parameters(self.net, seed)
        return self.net.state_dict()

    def decode(self, x):
        """Identity: a pixel-space model without EDM batch norm."""
        return x

    # ------------------------------------------------------------------
    def get_denoiser(self, x, sigma, y=None, guidance: float = 1.0,
                     train: bool = False, variables=None):
        """D(x; sigma) = c_skip x + c_out F(c_in x, c_noise, y), with
        classifier-free guidance when guidance != 1. x is channels-last,
        sigma [B]. ``train`` runs the network in training mode (dropout)
        and takes the plain combine under the default
        ``fused_precondition="sample"``. Returns (denoiser, c_noise)."""
        pre = self.config.preconditioner
        c_skip_vec = pre.skip_scaling(sigma)
        c_out_vec = pre.output_scaling(sigma)
        c_in = bcast_right(pre.input_scaling(sigma), x)
        cnoise = pre.noise_conditioner(sigma)
        scaled = c_in * x

        net = self._network(train, variables)
        cd = self.compute_dtype
        if cd is not None:
            scaled = scaled.to(cd)
            cnoise_in = cnoise.to(cd)
            y = dict_map(lambda v: v.to(cd) if v.is_floating_point() else v,
                         y)
        else:
            cnoise_in = cnoise

        def net_fwd(yy):
            out = net(scaled, cnoise_in, yy)
            return out.float() if cd is not None else out

        if self.conditional and guidance != 0.0:
            base = net_fwd(y)
            if guidance != 1.0:
                uncond = net_fwd(None)
                base = (1.0 - guidance) * uncond + guidance * base
        else:
            base = net_fwd(None)
        use_fused = (self.fused_precondition is True
                     or (self.fused_precondition == "sample" and not train))
        if use_fused:
            return fused_precondition.denoise_combine(
                x, base, c_skip_vec, c_out_vec), cnoise
        return (bcast_right(c_out_vec, x) * base
                + bcast_right(c_skip_vec, x) * x), cnoise

    # ------------------------------------------------------------------
    def loss_fn(self, x, sigma, y=None, mask=None, train: bool = True,
                eps=None, generator=None, variables=None):
        """The EDM training loss: mean over elements of
        lambda(sigma) · metric(D(x + sigma·eps; sigma), x), masked elements
        (mask == 1) weighted 0. x is channels-last, sigma [B]. ``eps``
        replays a fixed unit-noise draw in place of one from
        ``generator`` (the cross-framework tests feed the same noise to
        both packages). Dropout, when the network has any, draws from
        torch's default generator of the device. Returns the scalar loss
        (the JAX package also returns batch-norm updates, which the port's
        networks do not have)."""
        sigma_b = bcast_right(sigma, x)
        if eps is None:
            eps = torch.randn(x.shape, generator=generator, device=x.device,
                              dtype=x.dtype)
        denoiser, _ = self.get_denoiser(x + sigma_b * eps, sigma, y,
                                        train=train, variables=variables)
        weight = self.config.noisesampler.loss_weighting(sigma_b)
        return self._apply_mask_weight(self._loss_metric(denoiser, x),
                                       weight, mask)

    @staticmethod
    def _apply_mask_weight(loss, weight, mask):
        """mean(weight · loss) with masked elements zeroed (the JAX
        package's form without its dynamic-loss-weight bias)."""
        if mask is not None:
            loss = loss * (1.0 - mask.expand_as(loss))
        return (weight * loss).mean()

    def get_score(self, x, sigma, y=None, guidance: float = 1.0):
        denoiser, _ = self.get_denoiser(x, sigma, y, guidance)
        return (denoiser - x) / bcast_right(sigma, x) ** 2

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def sample(self, nsamples: int, shape, generator=None, y=None,
               guidance: float = 1.0, nsteps: int = 100,
               record_history: bool = False,
               maximum_batch_size: int | None = None):
        """Generate samples from white noise drawn on the model's device
        with ``generator``. ``shape`` is channels-last without the batch
        dim, e.g. (28, 28, 1).

        On a CUDA device the loop is the graph of ``compile_sampler``: the
        noise is drawn into its input, ``y`` copied into its static
        condition, and the graph replayed; the samples are a copy of its
        output. The loop is deterministic after the draw, so the graph
        holds no random number. On the CPU the loop runs eagerly."""
        if maximum_batch_size is not None:
            outs = [self.sample(n, shape, generator, y, guidance, nsteps,
                                record_history)
                    for n in get_minibatch_sizes(nsamples,
                                                 maximum_batch_size)]
            return torch.cat(outs, dim=1 if record_history else 0)
        if self.device.type != "cuda":
            x = torch.randn((nsamples,) + tuple(shape), generator=generator,
                            device=self.device)
            return self.propagate_white_noise(x, y, guidance, nsteps,
                                              record_history)
        graph = self.compile_sampler(nsamples, shape, y, guidance, nsteps,
                                     record_history)
        x, ys = graph.inputs
        torch.randn(x.shape, generator=generator, out=x)
        graphs.fill(ys, y)
        graph.replay()
        return graph.outputs.clone()

    @torch.inference_mode()
    def compile_sampler(self, nsamples: int, shape, y=None,
                        guidance: float = 1.0, nsteps: int = 100,
                        record_history: bool = False):
        """The CUDA graph of ``sample``'s loop for (nsamples, shape,
        guidance, nsteps, record_history, y's shapes): on its first use
        the loop runs once eagerly on the capture stream (the warm-up) and
        is captured; ``SamplerService.warmup`` calls this for every bucket,
        as the JAX service compiles one executable per bucket. Returns the
        ``utils.graphs.Graph``; None on the CPU, where nothing is
        captured."""
        if self.device.type != "cuda":
            return None
        cache = self._graph_cache()
        key = (nsamples, tuple(shape), float(guidance), nsteps,
               record_history, graphs.condition_key(y))
        graph = cache.graphs.get(key)
        if graph is not None:
            return graph
        x = torch.zeros((nsamples,) + tuple(shape), device=self.device)
        ys = graphs.static_like(y, self.device)
        graphs.fill(ys, y)

        def loop():
            return self.propagate_white_noise(x, ys, guidance, nsteps,
                                              record_history)

        cache.warmup(loop)
        graph = cache.capture(key, loop)
        graph.inputs = (x, ys)
        return graph

    @torch.inference_mode()
    def propagate_white_noise(self, x, y=None, guidance: float = 1.0,
                              nsteps: int = 100,
                              record_history: bool = False):
        """x is unit white noise (channels-last); scaled to sigma_max and
        integrated to a sample."""
        x = x * self.config.noisescheduler.maximum_scale
        return self.decode(self.propagate_toward_sample(
            x, y, guidance, nsteps, record_history))

    @torch.inference_mode()
    def propagate_toward_sample(self, x, y=None, guidance: float = 1.0,
                                nsteps: int = 100,
                                record_history: bool = False):
        """Backward propagation with the learned score."""
        y = dict_expand_dims(y, 0) if _needs_unsqueeze(y, x) else y

        def score_fn(xx, sigma):
            return self.get_score(xx, sigma, y, guidance)

        return self.config.noisescheduler.propagate_backward(
            x, score_fn, nsteps, record_history=record_history)
