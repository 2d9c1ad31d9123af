"""``GraphCache.capture`` pauses Python's cyclic collector while the body
is captured, and restores it after, also when the body raises: a
``CUDAGraph`` that the collector frees during a capture (an earlier
cache's, left in a reference cycle) destroys its graph inside the capture
and invalidates it (``cudaErrorStreamCaptureInvalidated`` on the card).
The capture itself is replaced by a stand-in here, since the CPU has no
CUDA graphs."""

import contextlib
import gc

import pytest
import torch

from tests import _torch_warmup  # noqa: F401  (CPU threads)

from diffsci_tpu_torch.utils import graphs


@pytest.fixture
def cache(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    c = graphs.GraphCache(torch.device("cpu"))
    monkeypatch.setattr(c, "_side_stream", lambda: None)
    return c


@pytest.mark.parametrize("enabled", [True, False])
def test_capture_pauses_the_cyclic_collector(cache, enabled):
    seen = []
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        cache.capture("k", lambda: seen.append(gc.isenabled()) or 1)
        assert seen == [False]
        assert gc.isenabled() == enabled
        assert cache.graphs["k"].outputs == 1
        with pytest.raises(RuntimeError):
            cache.capture("bad", lambda: (_ for _ in ()).throw(
                RuntimeError("body")))
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()
