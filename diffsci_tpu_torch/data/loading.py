"""Host-side data loading: shuffled minibatches over array datasets,
per-process shards, a torch ``DataLoader`` adapter, and the copy of
batches to the card ahead of the step that uses them.

Port of ``diffsci_tpu/data/loading.py``. A dataset is a leaf or a tuple,
list or dict of leaves with one leading dimension: numpy arrays, numpy
memmaps (``np.load(path, mmap_mode='r')``; fancy indexing reads only the
gathered rows, so a ``.npy`` corpus larger than RAM streams from disk) or
CPU tensors. Batches keep the dataset's structure and leaf types; they
become tensors on the device in ``prefetch_to_device``.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterator

import numpy as np
import torch

from diffsci_tpu_torch.utils import resolve_device


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of a tuple / list / dict structure (None
    stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _take(leaf, idx: np.ndarray):
    if isinstance(leaf, torch.Tensor):
        return leaf[torch.from_numpy(idx)]
    return leaf[idx]


def _distributed() -> tuple[int, int]:
    """(world size, rank) of ``torch.distributed`` when it is
    initialised, else (1, 0)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ArrayDataLoader:
    """Minibatches over a dataset of equal-leading-dim leaves.

    Each epoch reshuffles with ``np.random.default_rng(seed + epoch)``, as
    the JAX package does, so the same seed gives the same batches in both.
    ``drop_last=True`` by default, so batch shapes are static (one CUDA
    graph of the train step).

    Several processes: ``batch_size`` is the global batch, and each
    process yields its ``batch_size / process_count`` rows of every global
    batch; all derive the same permutation from the shared seed, so the
    per-process batches in process order make the single-process batch.
    ``process_count`` and ``process_index`` default to
    ``torch.distributed``'s world size and rank when it is initialised,
    and to 1 and 0 otherwise.

    ``indices``: the rows of ``dataset`` to load (e.g. one side of
    ``split_indices``), in the order of the gathered subset; each batch
    then reads only its own rows of the dataset, and yields what a loader
    over ``dataset[indices]`` would."""

    def __init__(self, dataset: Any, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 process_count: int | None = None,
                 process_index: int | None = None,
                 indices: np.ndarray | None = None):
        self.dataset = dataset
        leaves = tree_leaves(dataset)
        if not leaves:
            raise ValueError("empty dataset")
        if any(leaf.shape[0] != leaves[0].shape[0] for leaf in leaves):
            raise ValueError("ragged leading dims")
        self.indices = None if indices is None else np.asarray(indices)
        self.n = leaves[0].shape[0] if indices is None else len(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        world, rank = _distributed()
        self.process_count = world if process_count is None \
            else process_count
        self.process_index = rank if process_index is None \
            else process_index
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(
                f"process_index {self.process_index} out of range for "
                f"process_count {self.process_count}")
        if batch_size % self.process_count:
            raise ValueError(
                f"global batch_size {batch_size} not divisible by "
                f"process_count {self.process_count}")
        if self.process_count > 1 and not drop_last:
            raise ValueError(
                "multi-process loading requires drop_last=True: a ragged "
                "final batch would give processes different local shapes")
        self.local_batch_size = batch_size // self.process_count
        self._epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[Any]:
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch) \
                .permutation(self.n)
        else:
            order = np.arange(self.n)
        self._epoch += 1
        end = self.n - self.n % self.batch_size if self.drop_last \
            else self.n
        lo = self.process_index * self.local_batch_size
        hi = lo + self.local_batch_size
        for start in range(0, end, self.batch_size):
            idx = order[start:start + self.batch_size][lo:hi]
            if self.indices is not None:
                idx = self.indices[idx]
            yield tree_map(lambda leaf: _take(leaf, idx), self.dataset)


class TorchLoaderAdapter:
    """A torch ``DataLoader`` (or any iterable of tensors, or tuples /
    dicts of them) as the loader ``Trainer.fit`` and ``fit_karras``
    consume. Its batches are tensors already and pass through as they
    are, so a script written for the JAX package's adapter runs
    unchanged."""

    def __init__(self, loader: Any):
        self.loader = loader

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Any]:
        return iter(self.loader)


def split_indices(n: int, val_fraction: float = 0.1, seed: int = 0
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The (train, val) row indices of ``train_val_split``:
    ``np.random.default_rng(seed)``'s permutation of ``n`` rows, the
    first ``int(n·val_fraction)`` to validation, as in the JAX package.
    Given to ``ArrayDataLoader(indices=...)`` they split a memmapped
    dataset without reading it."""
    order = np.random.default_rng(seed).permutation(n)
    n_val = int(n * val_fraction)
    return order[n_val:], order[:n_val]


def train_val_split(dataset: Any, val_fraction: float = 0.1, seed: int = 0):
    """Random split of a dataset (torch ``random_split``'s analogue) by
    ``split_indices``. Returns (train, val), gathered into memory."""
    train_idx, val_idx = split_indices(tree_leaves(dataset)[0].shape[0],
                                       val_fraction, seed)
    return (tree_map(lambda leaf: _take(leaf, train_idx), dataset),
            tree_map(lambda leaf: _take(leaf, val_idx), dataset))


def buffered(iterator: Iterator[Any], size: int) -> Iterator[Any]:
    """Keep ``size`` items of an iterator made ahead of the consumer."""
    queue: collections.deque = collections.deque()
    it = iter(iterator)
    for _ in range(size):
        try:
            queue.append(next(it))
        except StopIteration:
            break
    while queue:
        out = queue.popleft()
        try:
            queue.append(next(it))
        except StopIteration:
            pass
        yield out


def _host_tensor(leaf) -> torch.Tensor:
    """A CPU tensor of a batch's leaf (a numpy array shares its memory)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    leaf = np.asarray(leaf)
    if not leaf.flags.writeable or not leaf.flags.c_contiguous:
        leaf = np.array(leaf, order="C")
    return torch.from_numpy(leaf)


def prefetch_to_device(iterator: Iterator[Any], size: int = 2,
                       device: torch.device | str | None = None
                       ) -> Iterator[Any]:
    """Batches of ``iterator`` as tensors on ``device``, ``size`` of them
    moved ahead of the consumer (none with ``size`` 0).

    On a CUDA device each leaf is copied into a pinned host buffer, then
    to the device with ``non_blocking=True`` on a copy stream of its own,
    so the copy of batch k+1 overlaps the step on batch k and the host
    does not wait for the card. The consuming stream waits on the copy's
    event before it reads a batch, and a pinned buffer is not reused until
    its copy is done."""
    device = resolve_device(device)
    if device.type == "cuda":
        return _prefetch_cuda(iterator, size, device)
    placed = (tree_map(lambda a: _host_tensor(a).to(device), b)
              for b in iterator)
    return buffered(placed, size) if size > 0 else placed


def _prefetch_cuda(iterator, size: int, device: torch.device):
    stream = torch.cuda.Stream(device)
    # (shape, dtype) -> [(pinned buffer, event of its last copy)]
    pinned: dict = collections.defaultdict(list)
    queue: collections.deque = collections.deque()

    def start(batch):
        event = torch.cuda.Event()
        taken = []

        def leaf(a):
            host = _host_tensor(a)
            free = pinned[(tuple(host.shape), host.dtype)]
            buf = next((i for i, (_, ev) in enumerate(free) if ev.query()),
                       None)
            buf = free.pop(buf)[0] if buf is not None else torch.empty(
                host.shape, dtype=host.dtype, pin_memory=True)
            buf.copy_(host)
            taken.append((free, buf))
            with torch.cuda.stream(stream):
                return buf.to(device, non_blocking=True)

        out = tree_map(leaf, batch)
        event.record(stream)
        for free, buf in taken:
            free.append((buf, event))
        return out, event

    def finish(item):
        out, event = item
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in tree_leaves(out):
            t.record_stream(current)
        return out

    for batch in iterator:
        queue.append(start(batch))
        if len(queue) > size:
            yield finish(queue.popleft())
    while queue:
        yield finish(queue.popleft())
