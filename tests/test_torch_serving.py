"""The port's serving stack on the CPU (after ``tests/test_serving.py``):
the cross-request dispatcher (aggregation, per-row isolation, the drawn
noise rows, stochastic isolation, chunking, ``close()``, errors reaching
every waiter), the Picard latency mode, 1-NFE serving (and a cold
service warmed once under concurrent first requests), a DDPM service
through the dispatcher, the JAX service's ``ValueError``s, ``mesh=``, and
the image grid and its PNG.

Isolation is bit for bit within one bucket (a row's arithmetic does not
depend on the rows beside it); across buckets the network runs at another
batch size, so it is held to rtol 1e-5, atol 1e-6 there, and the drawn
noise rows are compared exactly. Picard at tol 0 is held to the sequential
Euler service at ``tests/test_serving.py``'s rtol 1e-3, atol 1e-4.
"""

import struct
import threading
import time
import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsci_tpu.utils import make_image_grid as jmake_image_grid

from diffsci_tpu_torch import (DDPMModel, DDPMModelConfig, HFNetUncond,
                               KarrasModel, KarrasModelConfig, SamplerService)
from diffsci_tpu_torch.models.karras.distill import sample_onestep
from diffsci_tpu_torch.models.nets import MLPUncond
from diffsci_tpu_torch.serving import row_seeds
from diffsci_tpu_torch.utils import make_image_grid, save_image_grid
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)


def _model():
    model = KarrasModel(MLPUncond(2, (8,), device="cpu"),
                        KarrasModelConfig.from_edm(), device="cpu")
    model.init(0)
    return model


def _service(buckets=(4, 16), window_ms=20.0, **kw):
    return SamplerService(_model(), (2,), batch_buckets=buckets, nsteps=4,
                          batch_window_ms=window_ms, device="cpu", **kw)


def _join(threads, timeout=60.0):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive()


def _crowd(svc, n_threads=6, n=5):
    """Start ``n_threads`` concurrent requests of ``n`` samples."""
    threads = [threading.Thread(target=svc.sample, args=(n, 900 + i))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    return threads


def test_dispatcher_aggregates_concurrent_requests():
    """16 concurrent requests of 2 samples land in fewer bucket runs than
    requests, and every caller gets its own seed's rows."""
    svc = _service()
    svc.warmup()
    results = {}

    def worker(i):
        results[i] = svc.sample(2, 100 + i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    _join(threads)
    svc.close()
    assert sorted(results) == list(range(16))
    assert all(r.shape == (2, 2) and np.isfinite(r).all()
               for r in results.values())
    assert svc.stats["batched_dispatches"] < 16
    assert svc.stats["batched_requests"] == 16
    assert svc.stats["samples"] == 32
    for i, r in results.items():    # alone: another bucket
        np.testing.assert_allclose(r, svc.sample(2, 100 + i), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("stochastic", [False, True])
def test_dispatcher_isolation_within_a_bucket(stochastic):
    """A seeded request gives the same bits alone and crowded in one
    bucket (16), deterministic and under Euler–Maruyama (its loop noise
    drawn per row); across buckets (alone in 4, crowded in 16) within
    rtol 1e-5. The stochastic service differs from the deterministic
    one."""
    kw = {"sample_kwargs": {"stochastic": True}} if stochastic else {}
    one = _service(buckets=(16,), **kw)
    alone = one.sample(3, 7)
    threads = _crowd(one)
    crowded = one.sample(3, 7)
    _join(threads)
    assert one.stats["padded"] > 0
    one.close()
    np.testing.assert_array_equal(alone, crowded)
    two = _service(buckets=(4, 16), **kw)
    small = two.sample(3, 7)
    two.close()
    np.testing.assert_allclose(small, alone, rtol=1e-5, atol=1e-6)
    if stochastic:
        det = _service(buckets=(16,))
        assert not np.allclose(det.sample(3, 7), alone)
        det.close()


@pytest.mark.parametrize("stochastic", [False, True])
def test_noise_rows_are_the_rows_own(stochastic):
    """Row i of a dispatch draws x_T and its loop noise from its own
    generator in one call: exactly ``randn([1 + n, *shape])`` of that
    seed, whatever rows sit beside it; padding rows are zero."""
    model = _model()
    n = 4 if stochastic else 0
    x = torch.empty((6, 2))
    noise = torch.empty((n, 6, 2)) if stochastic else None
    seeds = row_seeds(7, 3) + row_seeds(11, 2)
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    model._draw_inputs((x, noise, None), gens, None)
    for i, s in enumerate(seeds):
        rows = torch.randn((1 + n, 2), generator=torch.Generator()
                           .manual_seed(s))
        torch.testing.assert_close(x[i], rows[0], rtol=0, atol=0)
        if stochastic:
            torch.testing.assert_close(noise[:, i], rows[1:], rtol=0, atol=0)
    assert (x[5] == 0).all()
    assert row_seeds(7, 3) == row_seeds(7, 5)[:3]


def test_dispatcher_chunks_large_requests_and_closes():
    """A request above the largest bucket goes in chunks whose rows keep
    their seeds' values (the first 3 rows of a 10-row request are a 3-row
    request's); ``close()`` stops the dispatcher thread."""
    svc = _service(buckets=(4,), window_ms=5.0)
    out = svc.sample(10, 0)
    assert out.shape == (10, 2) and svc.stats["batched_dispatches"] == 3
    np.testing.assert_array_equal(out[:3], svc.sample(3, 0))
    assert svc._dispatcher.is_alive()
    svc.close()
    assert not svc._dispatcher.is_alive()
    again = _service(buckets=(4,), window_ms=5.0)
    np.testing.assert_array_equal(again.sample(10, 0), out)
    again.close()
    assert again.sample(0).shape == (0, 2)
    again.close()


def test_dispatch_error_reaches_every_waiter():
    """An exception inside a dispatch is raised in every request of that
    dispatch, never an empty or stale result; the service goes on."""
    svc = _service(window_ms=50.0)
    svc.warmup()
    real = svc._run

    def failing(batch, generator):
        raise RuntimeError("dispatch failed")

    svc._run = failing
    errors = []

    def worker(i):
        try:
            svc.sample(2, i)
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    _join(threads)
    assert errors == ["dispatch failed"] * 4
    svc._run = real
    assert svc.sample(2, 0).shape == (2, 2)
    svc.close()


def test_dispatcher_death_reaches_waiters():
    """A dispatcher thread that dies outside a dispatch fails the queued
    requests instead of leaving their callers blocked, and the next
    request starts a new dispatcher."""
    svc = _service(window_ms=200.0)
    svc.warmup()
    real = svc._dispatch_forever

    def dying():
        time.sleep(0.05)
        raise RuntimeError("dispatcher died")

    svc._dispatch_forever = dying
    with pytest.raises(RuntimeError, match="dispatcher died"):
        svc.sample(2, 0)
    svc._dispatch_forever = real
    assert svc.sample(2, 0).shape == (2, 2)
    svc.close()


def test_picard_mode_and_rejected_modes():
    """``picard=`` serves through ``sample_parallel``: one seed one result,
    tol 0 equals the sequential Euler service from the seed in nsteps
    sweeps a bucket run; the JAX service's ValueErrors, those of
    ``mesh=`` too (``picard=`` with a mesh, a bucket that the ``data``
    axis does not divide), before the service touches the process
    group. The mesh service itself is tests/test_torch_parallel.py's."""
    model = _model()
    svc = SamplerService(model, (2,), batch_buckets=(4,), nsteps=6,
                         picard={"window": 4, "tol": 0.0}, device="cpu")
    a = svc.sample(4, 3)
    np.testing.assert_array_equal(a, svc.sample(4, 3))
    assert svc.stats["picard_sweeps"] == 12
    seq = SamplerService(model, (2,), batch_buckets=(4,), nsteps=6,
                         sample_kwargs={"integrator": "euler"}, device="cpu")
    np.testing.assert_allclose(a, seq.sample(4, 3), rtol=1e-3, atol=1e-4)
    fast = SamplerService(model, (2,), batch_buckets=(4,), nsteps=6,
                          picard={"window": 4, "tol": 1e-3}, device="cpu")
    assert np.isfinite(fast.sample(3, 3)).all()
    with pytest.raises(ValueError, match="co-batch"):
        SamplerService(model, (2,), picard={"window": 4},
                       batch_window_ms=2.0, device="cpu")
    with pytest.raises(ValueError, match="nsteps >= 2"):
        SamplerService(model, (2,), nsteps=1, picard={"window": 4},
                       device="cpu")
    data2 = types.SimpleNamespace(mesh_dim_names=("data",),
                                  size=lambda dim: 2)
    with pytest.raises(ValueError, match="single-device"):
        SamplerService(model, (2,), picard={"window": 4}, mesh=data2,
                       device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        SamplerService(model, (2,), batch_buckets=(1, 8), mesh=data2,
                       device="cpu")


def test_onestep_plain_and_windowed():
    """``nsteps=1`` serves ``sample_onestep``: in plain mode the request's
    generator draws ε as ``sample_onestep`` does; through the dispatcher
    one seed gives one result, crowded or not."""
    model = _model()
    svc = SamplerService(model, (2,), batch_buckets=(4,), nsteps=1,
                         device="cpu")
    out = svc.sample(3, 7)
    ref = sample_onestep(model, 4, (2,), torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(out, ref[:3].numpy())
    win = SamplerService(model, (2,), batch_buckets=(8,), nsteps=1,
                         batch_window_ms=20.0, device="cpu")
    alone = win.sample(2, 9)
    threads = _crowd(win, 3, 2)
    crowded = win.sample(2, 9)
    _join(threads)
    win.close()
    assert alone.shape == (2, 2) and np.isfinite(alone).all()
    np.testing.assert_array_equal(alone, crowded)


def test_cold_onestep_dispatcher_warms_each_bucket_once(monkeypatch):
    """Concurrent first requests to a cold 1-NFE dispatcher service: the
    callers that arrive during the warm-up wait for it and do not warm
    again (one compile a bucket), and each gets its seed's rows bit for
    bit, as the same request served alone afterwards."""
    model = _model()
    svc = SamplerService(model, (2,), batch_buckets=(8,), nsteps=1,
                         batch_window_ms=20.0, device="cpu")
    compiles = []
    compile_bucket = svc._compile

    def slow_compile(b):
        compiles.append(b)
        time.sleep(0.2)     # the other callers arrive meanwhile
        compile_bucket(b)

    monkeypatch.setattr(svc, "_compile", slow_compile)
    results = {}

    def worker(i):
        results[i] = svc.sample(2, 40 + i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    _join(threads)
    assert compiles == [8]
    for i, r in results.items():
        np.testing.assert_array_equal(r, svc.sample(2, 40 + i))
    assert svc.warmup() == {} and compiles == [8]
    svc.close()


def test_ddpm_service_through_the_dispatcher():
    """A ``DDPMModel`` service with ``batch_window_ms`` (ancestral DDPM,
    noise drawn at every step): row i draws x_T and its step noise from
    its own generator, so a seeded request gives the same bits alone and
    crowded in one bucket, and equals ``DDPMModel.sample`` with the
    rows' generators."""
    model = DDPMModel(HFNetUncond(block_channels=(8, 16), channels=3,
                                  norm_num_groups=4, device="cpu"),
                      DDPMModelConfig.from_ddpm(), device="cpu")
    model.init(seed=3)
    svc = SamplerService(model, (8, 8, 3), batch_buckets=(8,), nsteps=25,
                         batch_window_ms=20.0, device="cpu")
    alone = svc.sample(3, 7)
    threads = _crowd(svc, 3, 2)
    crowded = svc.sample(3, 7)
    _join(threads)
    svc.close()
    assert alone.shape == (3, 8, 8, 3) and np.isfinite(alone).all()
    np.testing.assert_array_equal(alone, crowded)
    assert svc.stats["batched_dispatches"] < svc.stats["batched_requests"]
    gens = [torch.Generator().manual_seed(s) for s in row_seeds(7, 3)]
    ref = model.sample(8, (8, 8, 3), generator=gens, nsteps=25)
    np.testing.assert_array_equal(alone, ref[:3].numpy())
    assert not np.array_equal(alone, svc.sample(3, 8))


def _decode_png(data: bytes) -> np.ndarray:
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    c = {0: 1, 4: 2, 2: 3, 6: 4}[color]
    assert depth == 8
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + w * c)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("channels", [1, 3])
def test_image_grid_and_png(channels, tmp_path):
    """``make_image_grid`` equals the JAX package's array; the PNG that
    ``save_image_grid`` writes without matplotlib decodes (zlib) to the
    grid mapped from [-1, 1] to 8 bits."""
    imgs = np.random.default_rng(0).uniform(
        -1.2, 1.2, (5, 6, 7, channels)).astype(np.float32)
    grid = make_image_grid(imgs, pad_value=-1.0)
    np.testing.assert_array_equal(
        grid, np.asarray(jmake_image_grid(jnp.asarray(imgs), pad_value=-1.0)))
    assert grid.shape == (2 * 8 + 2, 3 * 9 + 2, channels)
    path = save_image_grid(tmp_path / "g" / "grid.png", imgs)
    pixels = _decode_png(path.read_bytes())
    want = np.round(np.clip((grid + 1.0) / (2.0 + 1e-12), 0, 1) * 255)
    np.testing.assert_array_equal(pixels, want.astype(np.uint8))
    with pytest.raises(ValueError):
        make_image_grid(imgs[0])
