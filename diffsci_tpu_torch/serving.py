"""Sampling service: shape-bucketed, chunked, one device.

Port of ``diffsci_tpu/serving.py:SamplerService`` (with
``sample_kwargs``: the integrator, ``stochastic``, ``langevin_scale``,
``guidance``; and ``from_checkpoint``) without the cross-request
dispatcher (``batch_window_ms``), ``mesh``, ``picard`` and the HTTP
server. Requests are padded up to the
nearest batch bucket and the padding rows dropped; requests above the
largest bucket are split into chunks. On a CUDA device ``warmup()``
captures one CUDA graph per bucket (``compile_sampler``), as the JAX
service compiles one executable per bucket into ``self._compiled[b]``
(``diffsci_tpu/serving.py:157-266``), which also builds and loads the
kernels; a request then replays its buckets' graphs, its draws (x_T and,
for a stochastic integrator, the loop's noise) made from the request's
generator before each replay. Requests are served
one at a time (a lock), the service being one stream on one card.
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np
import torch

from diffsci_tpu_torch.utils import resolve_device


class SamplerService:
    """Front end for a ``KarrasModel``-like runtime with
    ``.sample(nsamples, shape, generator=..., nsteps=..., **kw)`` and
    ``.compile_sampler(nsamples, shape, nsteps=..., **kw)``, where ``kw``
    is ``sample_kwargs`` (e.g. ``{"integrator": "karras"}``,
    ``{"stochastic": True}``)."""

    def __init__(self, model, shape: Sequence[int],
                 batch_buckets: Sequence[int] = (1, 8, 64),
                 nsteps: int = 18, seed: int = 0, sample_kwargs=None,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.sample_kwargs = dict(sample_kwargs or {})
        self.model = model.to(self.device)
        self.shape = tuple(shape)
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.nsteps = nsteps
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self._lock = threading.Lock()
        self._warm: set[int] = set()
        self.stats = {"requests": 0, "samples": 0, "padded": 0,
                      "chunks": 0, "wall_seconds": 0.0}

    @classmethod
    def from_checkpoint(cls, path, shape: Sequence[int],
                        ema_stds: Sequence[float] = (0.05, 0.1),
                        ema_profile: int | None = 0,
                        device: torch.device | str | None = None,
                        **service_kwargs) -> "SamplerService":
        """A service for a training checkpoint directory (``state.pt`` and
        ``description.json``, as ``save_checkpoint`` writes them): the
        model rebuilt from the description
        (``karras_model_from_description``), then the weights of EMA
        profile ``ema_profile`` read from ``state.pt`` into the network,
        or the raw weights when ``ema_profile`` is None or ``ema_stds`` is
        empty (the JAX package's signature; the profiles themselves are
        found in the checkpoint, so any run's checkpoint serves, whatever
        its optimizer or EMA). The buffers (the batch norm's statistics)
        are the checkpoint's. On the CUDA card unless ``device`` says
        otherwise."""
        from diffsci_tpu_torch.checkpoint import (load_description,
                                                  restore_weights)
        from diffsci_tpu_torch.models.karras import \
            karras_model_from_description

        description = load_description(path)
        if not description:
            raise FileNotFoundError(f"no description.json under {path}")
        model = karras_model_from_description(description, device=device)
        restore_weights(path, model, ema_profile if ema_stds else None)
        return cls(model, shape, device=model.device, **service_kwargs)

    def _run(self, batch: int, generator: torch.Generator) -> torch.Tensor:
        out = self.model.sample(batch, self.shape, generator=generator,
                                nsteps=self.nsteps, **self.sample_kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def warmup(self) -> dict[int, float]:
        """Capture every bucket's graph (on a CUDA device; nothing is
        captured on the CPU). Draws no noise, so the service's stream of
        noise is untouched. Returns seconds per bucket."""
        times = {}
        with self._lock:
            for b in self.batch_buckets:
                t0 = time.perf_counter()
                self.model.compile_sampler(b, self.shape, nsteps=self.nsteps,
                                           **self.sample_kwargs)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                times[b] = time.perf_counter() - t0
                self._warm.add(b)
        return times

    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    def sample(self, nsamples: int, generator=None) -> np.ndarray:
        """Generate ``nsamples`` samples, channels-last, as a float32 numpy
        array. ``generator``: a ``torch.Generator`` on the service's
        device, or an int seed; the same seed gives the same samples
        whatever the chunking. None draws from the service's own
        generator."""
        if self._warm != set(self.batch_buckets):
            self.warmup()
        sizes = []
        remaining = nsamples
        while remaining > 0:
            n = min(remaining, self.batch_buckets[-1])
            sizes.append(n)
            remaining -= n
        if not sizes:
            return np.zeros((0,) + self.shape, np.float32)
        if isinstance(generator, int):
            generator = torch.Generator(self.device).manual_seed(generator)
        out = []
        with self._lock:
            gen = self._generator if generator is None else generator
            t0 = time.perf_counter()
            for n in sizes:
                b = self._bucket(n)
                chunk = self._run(b, gen)
                out.append(chunk[:n].cpu().numpy())
                self.stats["chunks"] += 1
                self.stats["padded"] += b - n
            self.stats["requests"] += 1
            self.stats["samples"] += nsamples
            self.stats["wall_seconds"] += time.perf_counter() - t0
        return np.concatenate(out, axis=0)

    def throughput(self) -> float:
        """Lifetime samples per wall-second spent inside sample()."""
        if self.stats["wall_seconds"] == 0:
            return 0.0
        return self.stats["samples"] / self.stats["wall_seconds"]
