"""1-NFE sampling with a fully distilled student.

Port of the two pieces of ``diffsci_tpu/models/karras/distill.py`` that
serving needs: ``_check_distillable`` and ``sample_onestep`` (with
``compile_onestep``, its graph). The rest of
progressive distillation (the interval grid, the teacher targets, the
training loop) is not ported yet.

One Euler step σ_max → 0 of the pf-ODE is exactly D(σ_max·ε, σ_max), so
a student distilled down to one step samples with one denoiser call; the
EDM grid of ``sample`` needs at least two steps, so this terminal case
has its own entry.
"""

from __future__ import annotations

import torch

from diffsci_tpu_torch.utils import graphs


def _check_distillable(model, student_nsteps: int) -> None:
    """Distillation needs EDM scheduling (sampler time = σ, constant
    scaling) in the diffusion space, and at least one student step."""
    sf = model.config.noisescheduler.scheduling
    if not (getattr(sf, "constant_scaling", False)
            and getattr(sf, "identity_noise", False)):
        raise NotImplementedError(
            "progressive distillation needs EDM scheduling (sampler time "
            "== sigma, constant scaling); got a scheduler whose time "
            "variable is not sigma")
    if getattr(model, "latent_model", False):
        raise NotImplementedError(
            "distill the latent-space KarrasModel directly (distillation "
            "operates in the diffusion space)")
    if student_nsteps < 1:
        raise ValueError("student_nsteps must be >= 1")


def _onestep_body(model, nsamples: int):
    """D(σ_max·ε, σ_max) of ε ([nsamples, *shape]) and y."""
    smax = float(model.config.noisescheduler.maximum_scale)

    def body(eps, y):
        sigma = torch.full((nsamples,), smax, device=eps.device)
        return model.get_denoiser(smax * eps, sigma, y)[0]
    return body


@torch.inference_mode()
def compile_onestep(model, nsamples: int, shape, y=None):
    """The CUDA graph of ``sample_onestep`` for (nsamples, shape, y's
    shapes) in the model's graph cache: on its first use the call runs
    once eagerly on the capture stream (the warm-up) and is captured; it
    is never replayed here, so a service may capture while another
    thread replays its other graphs. Static inputs (``graph.inputs``): ε,
    None, None and y's tensors. None on the CPU, where nothing is
    captured."""
    _check_distillable(model, 1)
    if model.device.type != "cuda":
        return None
    cache = model._graph_cache()
    key = ("onestep", nsamples, tuple(shape), graphs.condition_key(y))
    graph = cache.graphs.get(key)
    if graph is not None:
        return graph
    body = _onestep_body(model, nsamples)
    eps = torch.zeros((nsamples,) + tuple(shape), device=model.device)
    ys = graphs.static_like(y, model.device)
    graphs.fill(ys, y)
    cache.warmup(lambda: body(eps, ys))
    graph = cache.capture(key, lambda: body(eps, ys))
    graph.inputs = (eps, None, None, ys)
    return graph


@torch.inference_mode()
def sample_onestep(model, nsamples: int, shape, generator=None, y=None):
    """1-NFE generation: ε drawn from ``generator`` (or one generator a
    row, as the service's dispatcher passes them), then
    D(σ_max·ε, σ_max): one network call and one combine (K1). On a CUDA
    device the call replays ``compile_onestep``'s graph, ε its static
    input; on the CPU it runs eagerly. Returns the samples,
    channels-last, not decoded (as the JAX package)."""
    graph = compile_onestep(model, nsamples, shape, y)
    if graph is None:
        eps = torch.zeros((nsamples,) + tuple(shape), device=model.device)
        model._draw_inputs((eps, None, None), generator, None)
        return _onestep_body(model, nsamples)(eps, y)
    model._draw_inputs(graph.inputs[:3], generator, None)
    graphs.fill(graph.inputs[3], y)
    graph.replay()
    return graph.outputs.clone()
