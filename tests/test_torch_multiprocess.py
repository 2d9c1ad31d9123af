"""Multi-process input shards and training of the port
(``data/loading.py``, ``parallel/mp_dryrun.py``) at world size 2 and 4
(gloo ranks on the CPU), against the JAX package's loader
(``tests/test_multiprocess.py``): each rank's loader, its process count
and index read from the process group, yields exactly the JAX loader's
rows for that process, every batch of two epochs; the ranks' rows
partition the global batches; bad process configurations raise; and the
two-rank dry run reads disjoint rows and reproduces the single-process
losses (rtol 1e-5)."""

import numpy as np
import pytest

from diffsci_tpu.data.loading import ArrayDataLoader as JArrayDataLoader

from diffsci_tpu_torch.data.loading import ArrayDataLoader
from diffsci_tpu_torch.parallel.mp_dryrun import run_multiprocess_dryrun
from tests import _torch_warmup  # noqa: F401  (MKL's first exp)
from tests._torch_ranks import result, run_ranks

N, DIM, BATCH = 64, 3, 16


def _data():
    data = np.random.default_rng(0).standard_normal((N, DIM)).astype(
        np.float32)
    data[:, 0] = np.arange(N)
    return data


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request):
    return request.param, run_ranks("tests._torch_multiprocess_cases",
                                    request.param,
                                    dict(data=_data(), batch=BATCH))


def test_rank_loaders_match_jax_per_process_loaders(ranks):
    world, res = ranks
    data = _data()
    for rank in range(world):
        ours = result(res, "loader", rank)
        jax_loader = JArrayDataLoader(data, BATCH, seed=3,
                                      process_count=world,
                                      process_index=rank)
        theirs = [np.asarray(b) for _ in range(2) for b in jax_loader]
        assert len(ours) == len(theirs) == 2 * (N // BATCH)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


def test_rank_batches_partition_the_global_batches(ranks):
    world, res = ranks
    loader = ArrayDataLoader(_data(), BATCH, seed=3, process_count=1,
                             process_index=0)
    single = [b for _ in range(2) for b in loader]
    per_rank = [result(res, "loader", rank) for rank in range(world)]
    for i, gbatch in enumerate(single):
        np.testing.assert_array_equal(
            np.concatenate([batches[i] for batches in per_rank]), gbatch)


def test_loader_rejects_bad_process_config():
    data = np.zeros((16, 2))
    with pytest.raises(ValueError, match="not divisible"):
        ArrayDataLoader(data, 6, process_count=4, process_index=0)
    with pytest.raises(ValueError, match="out of range"):
        ArrayDataLoader(data, 8, process_count=2, process_index=2)
    with pytest.raises(ValueError, match="drop_last"):
        ArrayDataLoader(data, 8, process_count=2, process_index=0,
                        drop_last=False)


def test_two_rank_dry_run_matches_one_process():
    summary = run_multiprocess_dryrun(nprocs=2, steps=2, global_batch=16)
    np.testing.assert_allclose(summary["mp_losses"],
                               summary["control_losses"], rtol=1e-5)
    rows = summary["rows_per_proc"]
    assert not set(rows[0]) & set(rows[1])
    assert len(rows[0]) == len(rows[1]) == 2 * 8
