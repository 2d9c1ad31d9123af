"""Sampling service: shape-bucketed, chunked, one device or data-parallel
over a mesh; a cross-request dispatcher, a Picard latency mode, 1-NFE
serving, and an HTTP server.

Port of ``diffsci_tpu/serving.py`` (``SamplerService`` with
``sample_kwargs``, ``batch_window_ms``, ``mesh``, ``picard`` and
``from_checkpoint``; ``build_server``). Requests are padded up to the
nearest batch bucket and the padding
rows dropped; requests above the largest bucket are split into chunks.
On a CUDA device ``warmup()`` captures one CUDA graph per bucket, as the
JAX service compiles one executable per bucket
(``diffsci_tpu/serving.py:157-266``), which also builds and loads the
kernels; a request replays its buckets' graphs, its draws made from the
request's generator into the graph's static inputs before each replay.

Three modes:
- plain (default): requests are served one at a time (a lock), the
  service being one stream on one card;
- ``batch_window_ms`` > 0: callers enqueue and block; one dispatcher
  thread waits the window, then serves every queued request that fits the
  largest bucket in one bucket replay. Row i of a request depends on its
  own generator seed only (derived from the request's seed, or drawn from
  the service's seed stream), whatever it is batched with: each row's
  x_T and loop noise are drawn in one call from its own generator
  (``ops.schedulers.draw_rows``). The dispatcher is the only thread that
  replays; it runs on the device and stream of the service's creator. A
  failed dispatch raises in every waiter;
- ``picard={"window": W, "tol": t}``: each bucket runs
  ``KarrasModel.sample_parallel`` (one graph of a Picard sweep, one
  network call of batch W·b a sweep).

``nsteps=1`` on a model with ``get_denoiser`` serves a distilled 1-NFE
student through ``sample_onestep``, in plain and dispatcher mode.

``mesh=`` (a ``DeviceMesh`` with a ``data`` axis): data-parallel serving,
one process a card where the JAX service is one process over the mesh.
Every rank builds the service with the same arguments (checked: a rank
whose arguments differ raises on every rank). Rank 0 is the front end:
``sample()``, the dispatcher and ``build_server`` run there, and
``sample()`` on another rank raises. The other ranks call ``follow()``,
which serves rank 0's bucket runs until rank 0's ``close()`` releases
them. For each bucket run (and each bucket's warm-up) rank 0 broadcasts
a header (the operation, the bucket, what the payload holds, the
service's key) and its payload (the generator's state, or the rows'
seeds under the dispatcher); every rank then runs the model's
``sample(mesh=...)`` (``sample_onestep(mesh=...)`` at ``nsteps=1``) on
its rows of the bucket, whose result ``gather_batch`` gives back, so a
seed gives the samples of the service without a mesh. Every collective
of rank 0 comes from one thread at a time, in one order (a lock around
each message and its run): the caller's under the plain mode, the
dispatcher's under ``batch_window_ms``. ``svc.stats`` and the padded
rows are counted on rank 0.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Sequence

import numpy as np
import torch

from diffsci_tpu_torch.utils import resolve_device


@dataclasses.dataclass
class _PendingRequest:
    """One caller blocked on the dispatcher: the generator seeds of its
    rows, and its result or the dispatch's error."""
    seeds: list
    event: threading.Event
    result: np.ndarray | None = None
    error: BaseException | None = None


# the operations of a mesh service's messages
_STOP, _RUN, _WARM = 0, 1, 2


def row_seeds(seed: int, n: int) -> list[int]:
    """The generator seeds of a request's n rows, from its seed alone."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(
        n, np.uint64) >> np.uint64(1)]


class SamplerService:
    """Front end for a ``KarrasModel``-like runtime with
    ``.sample(nsamples, shape, generator=..., nsteps=..., **kw)`` and
    ``.compile_sampler(nsamples, shape, nsteps=..., **kw)``, where ``kw``
    is ``sample_kwargs`` (e.g. ``{"integrator": "karras"}``,
    ``{"stochastic": True}``); ``KarrasModel`` and ``DDPMModel``, whose
    ``sample`` also takes one generator a row (the dispatcher's
    draws)."""

    def __init__(self, model, shape: Sequence[int],
                 batch_buckets: Sequence[int] = (1, 8, 64),
                 nsteps: int = 18, seed: int = 0, sample_kwargs=None,
                 batch_window_ms: float = 0.0, mesh=None, picard=None,
                 device: torch.device | str | None = None):
        """``batch_window_ms`` > 0: the cross-request dispatcher (module
        docstring). ``picard``: ``KarrasModel.sample_parallel``'s knobs
        (e.g. ``{"window": 8, "tol": 1e-3}``), the latency mode; it cannot
        co-batch (``batch_window_ms`` must be 0) and needs nsteps ≥ 2.
        ``nsteps=1``: 1-NFE serving of a distilled student. ``mesh``: a
        ``DeviceMesh`` with a ``data`` axis, data-parallel serving (module
        docstring); every bucket must divide the axis, and ``picard``
        cannot take a mesh."""
        self.device = resolve_device(device)
        self.sample_kwargs = dict(sample_kwargs or {})
        self.model = model.to(self.device)
        self.shape = tuple(shape)
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.nsteps = nsteps
        self.batch_window_ms = float(batch_window_ms)
        self.picard = dict(picard) if picard else None
        if self.picard is not None and self.batch_window_ms > 0:
            raise ValueError("picard mode cannot co-batch requests "
                             "(shared noise draw); use batch_window_ms=0")
        if self.picard is not None and mesh is not None:
            raise ValueError("picard mode is single-device (latency "
                             "path); drop mesh=")
        self.mesh = mesh
        if mesh is not None:
            from diffsci_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
            self._data = axis_size(mesh, DATA_AXIS)
            bad = [b for b in self.batch_buckets if b % self._data]
            if bad:
                raise ValueError(
                    f"batch_buckets {bad} not divisible by the mesh data "
                    f"axis size {self._data}")
        self.onestep = nsteps == 1 and hasattr(model, "get_denoiser")
        if self.onestep and self.picard is not None:
            raise ValueError("picard mode needs nsteps >= 2; a 1-NFE "
                             "distilled model already IS the latency path")
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self._seeds = np.random.default_rng(seed)
        self._row_generators = [torch.Generator(self.device) for _ in
                                range(self.batch_buckets[-1])] \
            if self.batch_window_ms > 0 else []
        self._lock = threading.Lock()
        self._warm_lock = threading.Lock()
        self._warm: set[int] = set()
        self._stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        self._queue: list[_PendingRequest] = []
        self._queue_signal = threading.Condition()
        self._dispatcher: threading.Thread | None = None
        self._shutdown = False
        self.stats = {"requests": 0, "samples": 0, "padded": 0,
                      "chunks": 0, "wall_seconds": 0.0,
                      "batched_requests": 0, "batched_dispatches": 0,
                      "picard_sweeps": 0}
        if mesh is not None:
            self._join_mesh(mesh, model)

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

    # ------------------------------------------------------------------
    # data-parallel serving: rank 0's messages, the other ranks' loop
    # ------------------------------------------------------------------
    def _join_mesh(self, mesh, model) -> None:
        """Every rank's service: its rank, the messages' device, and the
        service's key (its arguments), held equal on every rank."""
        import torch.distributed as dist

        from diffsci_tpu_torch.parallel.mesh import mesh_device
        self._rank = dist.get_rank()
        self._comm = mesh_device(mesh)
        self._comm_lock = threading.Lock()
        self._released = False
        desc = repr((type(model).__name__, self.shape, self.batch_buckets,
                     self.nsteps, sorted(self.sample_kwargs.items()),
                     self.onestep, self.batch_window_ms > 0))
        self._key = zlib.crc32(desc.encode())
        keys = [torch.zeros(1, dtype=torch.int64, device=self._comm)
                for _ in range(dist.get_world_size())]
        dist.all_gather(keys, torch.full((1,), self._key, dtype=torch.int64,
                                         device=self._comm))
        if any(int(k) != self._key for k in keys):
            raise ValueError("the ranks built SamplerService(mesh=) with "
                             "other arguments: every rank must pass the "
                             "same ones")

    def _send(self, op: int, batch: int = 0, generator=None) -> None:
        """Rank 0: broadcast a run's header and payload (the caller holds
        ``_comm_lock``)."""
        import torch.distributed as dist
        kind, total, payload = 0, 0, torch.zeros(0, dtype=torch.int64)
        if isinstance(generator, (list, tuple)):
            kind, total = 1, len(generator)
            payload = torch.tensor([g.initial_seed() for g in generator],
                                   dtype=torch.int64)
        elif generator is not None:
            payload = generator.get_state().to(torch.int64)
        head = torch.tensor([op, batch, kind, payload.numel(), self._key,
                             total], dtype=torch.int64, device=self._comm)
        dist.broadcast(head, src=0)
        if payload.numel():
            dist.broadcast(payload.to(self._comm), src=0)

    def _receive(self):
        """Another rank: the next header and payload from rank 0, as
        (op, bucket, the run's generator or generators)."""
        import torch.distributed as dist
        head = torch.zeros(6, dtype=torch.int64, device=self._comm)
        dist.broadcast(head, src=0)
        op, batch, kind, n, key, total = (int(v) for v in head.cpu())
        if key != self._key:
            raise RuntimeError("rank 0's service is not this rank's")
        payload = torch.zeros(n, dtype=torch.int64, device=self._comm)
        if n:
            dist.broadcast(payload, src=0)
        payload = payload.cpu()
        if op != _RUN:
            return op, batch, None
        if kind == 1:
            gens = self._row_generators[:total]
            for g, seed in zip(gens, payload.tolist()):
                g.manual_seed(seed)
            return op, batch, gens
        self._generator.set_state(payload.to(torch.uint8))
        return op, batch, self._generator

    def follow(self) -> None:
        """On a rank other than 0 of a mesh service: run rank 0's bucket
        runs and warm-ups, in its order, until rank 0's ``close()``."""
        if self.mesh is None or self._rank == 0:
            raise RuntimeError("follow() is for the ranks other than 0 of "
                               "a SamplerService(mesh=...)")
        while True:
            op, batch, generator = self._receive()
            if op == _STOP:
                return
            if op == _WARM:
                self._warm_bucket(batch)
            else:
                self._bucket_run(batch, generator)

    def _front_end(self, what: str) -> None:
        if self.mesh is not None and self._rank != 0:
            raise RuntimeError(f"{what} runs on rank 0 of a mesh service; "
                               "the other ranks call follow()")

    def _run(self, batch: int, generator) -> torch.Tensor:
        """One bucket run from ``generator`` (or one generator a row); over
        a mesh, announced to the other ranks first."""
        if self.mesh is None:
            return self._bucket_run(batch, generator)
        with self._comm_lock:
            self._send(_RUN, batch, generator)
            return self._bucket_run(batch, generator)

    def _bucket_run(self, batch: int, generator) -> torch.Tensor:
        """The bucket run itself (over a mesh: this rank's rows, the rows
        gathered)."""
        mesh = {} if self.mesh is None else {"mesh": self.mesh}
        if self.onestep:
            from diffsci_tpu_torch.models.karras.distill import \
                sample_onestep
            out = sample_onestep(self.model, batch, self.shape, generator,
                                 **mesh)
        elif self.picard is not None:
            out, sweeps = self.model.sample_parallel(
                batch, self.shape, generator, nsteps=self.nsteps,
                return_sweeps=True, **self.picard)
            self.stats["picard_sweeps"] += sweeps
        else:
            out = self.model.sample(batch, self.shape, generator=generator,
                                    nsteps=self.nsteps, **self.sample_kwargs,
                                    **mesh)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def _compile(self, batch: int) -> None:
        """Capture the graph of a bucket (over a mesh, of its rows on this
        rank)."""
        if self.mesh is not None:
            batch //= self._data
        if self.onestep:
            from diffsci_tpu_torch.models.karras.distill import \
                compile_onestep
            compile_onestep(self.model, batch, self.shape)
        elif self.picard is not None:
            self.model.compile_parallel(batch, self.shape, nsteps=self.nsteps,
                                        **self.picard)
        else:
            self.model.compile_sampler(batch, self.shape, nsteps=self.nsteps,
                                       **self.sample_kwargs)

    def warmup(self) -> dict[int, float]:
        """Capture the graph of every bucket not yet warm (on a CUDA
        device; nothing is captured on the CPU). Draws nothing and replays
        nothing, so the service's stream of noise is untouched and a
        dispatcher serving meanwhile is not disturbed; callers that arrive
        during a warm-up wait for it and then find their buckets warm.
        Returns seconds per bucket captured by this call."""
        self._front_end("warmup()")
        times = {}
        with self._warm_lock, self._lock:
            for b in self.batch_buckets:
                if b in self._warm:
                    continue
                t0 = time.perf_counter()
                if self.mesh is None:
                    self._warm_bucket(b)
                else:
                    # every rank captures the same buckets in one order
                    with self._comm_lock:
                        self._send(_WARM, b)
                        self._warm_bucket(b)
                times[b] = time.perf_counter() - t0
        return times

    def _warm_bucket(self, b: int) -> None:
        self._compile(b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm.add(b)

    def _ensure_warm(self) -> None:
        if self._warm != set(self.batch_buckets):
            self.warmup()

    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    def _sizes(self, nsamples: int) -> list[int]:
        sizes, remaining = [], nsamples
        while remaining > 0:
            sizes.append(min(remaining, self.batch_buckets[-1]))
            remaining -= sizes[-1]
        return sizes

    # ------------------------------------------------------------------
    # cross-request batching (the dispatcher thread)
    # ------------------------------------------------------------------
    def _ensure_dispatcher(self) -> None:
        with self._warm_lock:
            if self._dispatcher is None or not self._dispatcher.is_alive():
                self._shutdown = False
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop, daemon=True,
                    name="sampler-dispatch")
                self._dispatcher.start()

    def close(self) -> None:
        """Stop the dispatcher thread (a no-op without batching); on rank
        0 of a mesh service, then release the other ranks' ``follow()``
        (once; a later call sends nothing)."""
        with self._queue_signal:
            self._shutdown = True
            self._queue_signal.notify_all()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=5)
        if self.mesh is not None and self._rank == 0 and not self._released:
            with self._comm_lock:
                self._send(_STOP)
                self._released = True

    def _dispatch_loop(self) -> None:
        """The dispatcher thread: on the service's device and its creator's
        stream (the graphs' outputs are read there). If the loop itself
        fails, every queued request gets the error and the thread ends; the
        next request starts another."""
        try:
            if self.device.type == "cuda":
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self._stream):
                    self._dispatch_forever()
            else:
                self._dispatch_forever()
        except Exception as e:  # noqa: BLE001  (reaches every waiter)
            with self._queue_signal:
                pending, self._queue = self._queue, []
            for r in pending:
                r.error = e
                r.event.set()

    def _dispatch_forever(self) -> None:
        maxb = self.batch_buckets[-1]
        while True:
            with self._queue_signal:
                while not self._queue and not self._shutdown:
                    self._queue_signal.wait(timeout=0.25)
                if self._shutdown:
                    return
            # the aggregation window: let concurrent requests pile up
            time.sleep(self.batch_window_ms / 1000.0)
            with self._queue_signal:
                batch, total = [], 0
                while self._queue and \
                        total + len(self._queue[0].seeds) <= maxb:
                    req = self._queue.pop(0)
                    batch.append(req)
                    total += len(req.seeds)
            if batch:
                self._dispatch(batch, total)

    def _dispatch(self, batch: list, total: int) -> None:
        """Serve the requests of ``batch`` (``total`` rows) in one bucket
        run; an error reaches every waiter."""
        try:
            b = self._bucket(total)
            seeds = [s for r in batch for s in r.seeds]
            gens = self._row_generators[:total]
            for g, s in zip(gens, seeds):
                g.manual_seed(s)
            out = self._run(b, gens)[:total].cpu().numpy()
            i = 0
            for r in batch:
                r.result = out[i:i + len(r.seeds)]
                i += len(r.seeds)
            with self._lock:
                self.stats["batched_dispatches"] += 1
                self.stats["chunks"] += 1
                self.stats["padded"] += b - total
        except Exception as e:  # noqa: BLE001  (reaches every waiter)
            for r in batch:
                r.error = e
        finally:
            for r in batch:
                r.event.set()

    def _request_seed(self, generator) -> int:
        if generator is None:
            with self._lock:
                return int(self._seeds.integers(2 ** 62))
        if isinstance(generator, int):
            return generator
        return int(torch.randint(2 ** 62, (1,), generator=generator,
                                 device=generator.device))

    def _sample_batched(self, nsamples: int, generator) -> np.ndarray:
        """Enqueue the request's rows (in chunks of at most the largest
        bucket) and block until the dispatcher has served them."""
        self._ensure_warm()
        self._ensure_dispatcher()
        if nsamples <= 0:
            return np.zeros((0,) + self.shape, np.float32)
        seeds = row_seeds(self._request_seed(generator), nsamples)
        pendings = [_PendingRequest(seeds=seeds[i:i + n],
                                    event=threading.Event())
                    for i, n in zip(range(0, nsamples,
                                          self.batch_buckets[-1]),
                                    self._sizes(nsamples))]
        t0 = time.perf_counter()
        with self._queue_signal:
            self._queue.extend(pendings)
            self._queue_signal.notify()
        for p in pendings:
            # a dispatch sets its requests' events whatever happens; a
            # request still queued when the thread ended waits for another
            while not p.event.wait(1.0):
                self._ensure_dispatcher()
            if p.error is not None:
                raise p.error
            if p.result is None:
                raise RuntimeError("the dispatch of this request was "
                                   "interrupted")
        with self._lock:
            self.stats["requests"] += 1
            self.stats["batched_requests"] += 1
            self.stats["samples"] += nsamples
            self.stats["wall_seconds"] += time.perf_counter() - t0
        return np.concatenate([p.result for p in pendings], axis=0)

    # ------------------------------------------------------------------
    def sample(self, nsamples: int, generator=None) -> np.ndarray:
        """Generate ``nsamples`` samples, channels-last, as a float32 numpy
        array. ``generator``: a ``torch.Generator`` on the service's
        device, or an int seed; the same seed gives the same samples
        whatever the chunking. None draws from the service's own
        generator. With ``batch_window_ms`` > 0 the request goes through
        the dispatcher: its rows' generators are seeded from the seed
        (``row_seeds``), so a seed gives the same samples whatever the
        request is batched with. Over a mesh, rank 0 alone takes
        requests."""
        self._front_end("sample()")
        if self.batch_window_ms > 0:
            return self._sample_batched(nsamples, generator)
        self._ensure_warm()
        sizes = self._sizes(nsamples)
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
        """Lifetime samples per wall-second spent inside sample()
        (concurrent requests overlap, so under load this under-reports
        the device's throughput)."""
        if self.stats["wall_seconds"] == 0:
            return 0.0
        return self.stats["samples"] / self.stats["wall_seconds"]


def build_server(svc: SamplerService, port: int = 0,
                 host: str = "127.0.0.1", max_nsamples: int = 256):
    """Stdlib HTTP endpoints over a service: ``GET /healthz``,
    ``GET /stats``, ``POST /sample {"nsamples": N, "seed": S}`` (the seed
    becomes the request's generator seed; without one the service's
    stream is drawn). ``port=0`` picks a free port
    (``server.server_address[1]``). Binds loopback by default (the
    endpoint has no authentication and returns whole tensors as JSON);
    ``max_nsamples`` caps a request. A bad request gets a 400 and the
    server keeps serving. Returns the ``ThreadingHTTPServer``; the caller
    runs ``serve_forever()`` (and ``shutdown()``)."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "warm": True})
            elif self.path == "/stats":
                self._json(200, dict(svc.stats,
                                     throughput=svc.throughput()))
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/sample":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                nsamples = int(req.get("nsamples", 1))
                if not 0 <= nsamples <= max_nsamples:
                    raise ValueError(
                        f"nsamples out of range [0, {max_nsamples}]")
                seed = int(req["seed"]) if "seed" in req else None
                out = svc.sample(nsamples, generator=seed)
                self._json(200, {"shape": list(out.shape),
                                 "samples": out.tolist()})
            except Exception as e:  # noqa: BLE001  (a 400, keep serving)
                self._json(400, {"error": str(e)})

        def log_message(self, fmt, *args):  # no access log
            pass

    class Server(ThreadingHTTPServer):
        # socketserver's listen backlog of 5 drops the connections of a
        # burst of concurrent clients, which retry a second later
        request_queue_size = 128

    return Server((host, port), Handler)
