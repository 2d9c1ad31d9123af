"""Process groups, device meshes and the batch's rows per rank.

Port of ``diffsci_tpu/parallel/mesh.py``. The JAX package is one process
over a mesh of devices, whose arrays carry their sharding, and XLA puts
the collectives in. The port is one process per card (torchrun's model):
every rank calls the same entry points, holds its own rows of a batch
and its own shards of a state, and the collectives are explicit
(``torch.distributed``: NCCL on the card, gloo on the CPU). A result that
the JAX package returns as one global array is returned whole on every
rank.

``make_mesh`` returns a ``torch.distributed.device_mesh.DeviceMesh`` whose
dimension names are the JAX package's axis names (``data``, ``spatial``,
``tensor``, ``expert``, ``stage``), over every rank of the process group
(one device a rank).
"""

from __future__ import annotations

import os
import socket
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from diffsci_tpu_torch.data.loading import tree_map

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"  # the spatial step's and the halo decode's axis
TENSOR_AXIS = "tensor"
EXPERT_AXIS = "expert"
STAGE_AXIS = "stage"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device_type: str = "cuda") -> int:
    """Join the process group; returns its size. Idempotent: a process
    already in a group returns its size.

    With no arguments: torchrun's environment (``MASTER_ADDR``,
    ``WORLD_SIZE``, ``RANK``) when it is set, else a group of this one
    process at a free localhost port. Elsewhere pass
    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id``, as the JAX package's signature takes them. The
    backend: NCCL for ``device_type="cuda"`` (the default), gloo for
    "cpu"; a failed NCCL group raises, nothing falls back to gloo. On the
    card each rank takes device ``LOCAL_RANK`` (or its rank modulo the
    cards it sees)."""
    if dist.is_initialized():
        return dist.get_world_size()
    backend = "nccl" if device_type == "cuda" else "gloo"
    env = os.environ
    if coordinator_address is None and num_processes in (None, 1) \
            and "MASTER_ADDR" in env and "WORLD_SIZE" in env:
        init_method, world, rank = "env://", int(env["WORLD_SIZE"]), \
            int(env.get("RANK", 0))
    elif coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        init_method, world, rank = f"tcp://{coordinator_address}", \
            num_processes, process_id
    elif num_processes in (None, 1):
        init_method, world, rank = f"tcp://127.0.0.1:{_free_port()}", 1, 0
    else:
        raise ValueError(f"num_processes={num_processes} needs a "
                         f"coordinator_address (or torchrun's environment)")
    if device_type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return dist.get_world_size()


def make_mesh(n_devices: int | None = None,
              axes: Sequence[str] = (DATA_AXIS,),
              shape: Sequence[int] | None = None,
              device_type: str | None = None):
    """A ``DeviceMesh`` over every rank of the process group (joined
    first, as ``initialize_distributed()`` joins, when it is not), its
    dimensions named ``axes``. One axis: the shape is (world size,);
    several axes take an explicit shape. ``n_devices``, when given, must
    be the world size (one device a rank). ``device_type``: the mesh's
    devices, "cuda" under NCCL and "cpu" under gloo unless given (gloo
    also carries CUDA tensors)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        initialize_distributed(device_type=device_type or "cuda")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}: a mesh spans the process "
                         f"group's {world} ranks, one device each")
    if shape is None:
        if len(axes) != 1:
            raise ValueError("multi-axis mesh needs an explicit shape")
        shape = (world,)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover the "
                         f"{world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def axis_size(mesh, axis: str | Sequence[str]) -> int:
    """The ranks along ``axis`` (a name or a tuple of names; 1 for an
    axis the mesh lacks)."""
    if isinstance(axis, str):
        axis = (axis,)
    names = mesh.mesh_dim_names
    return int(np.prod([mesh.size(names.index(a)) for a in axis
                        if a in names]))


def axis_index(mesh, axis: str | Sequence[str]) -> int:
    """This rank's index along ``axis`` (row-major over a tuple of
    names)."""
    if isinstance(axis, str):
        axis = (axis,)
    index = 0
    for a in axis:
        if a in mesh.mesh_dim_names:
            index = index * axis_size(mesh, a) + mesh.get_local_rank(a)
    return index


def mesh_device(mesh) -> torch.device:
    """This rank's device in the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_sharding(mesh, axis: str = DATA_AXIS, ndim: int = 1) -> tuple:
    """The spec of a batch: its leading dim over ``axis``, the rest
    whole (the JAX package's ``P(axis, None, ...)``)."""
    return (axis,) + (None,) * (ndim - 1)


def replicated(mesh) -> tuple:
    """The spec of a replicated tensor (``P()``)."""
    return ()


def data_rows(mesh, nsamples: int,
              axis: str | Sequence[str] = DATA_AXIS) -> slice:
    """This rank's rows of a batch of ``nsamples`` over ``axis`` (a name,
    or a tuple of names taken row-major): the i-th of n equal blocks;
    raises when the batch does not divide the axis."""
    n = axis_size(mesh, axis)
    if nsamples % n:
        raise ValueError(f"batch {nsamples} not divisible by mesh "
                         f"'{axis}' axis size {n}")
    k = nsamples // n
    i = axis_index(mesh, axis)
    return slice(i * k, (i + 1) * k)


def shard_batch(batch: Any, mesh, axis: str | Sequence[str] = DATA_AXIS,
                channels_first: bool = False):
    """This rank's rows of every array in ``batch`` (a global batch):
    the ``index``-th of ``n`` equal blocks along the leading dim, ``n``
    the ranks along ``axis`` (a name, or a tuple of names taken
    row-major). On a mesh with a ``spatial`` axis (not in ``axis``),
    arrays of three or more dims, channels-last [B, *spatial, C], are also
    cut into that axis's slabs along their first spatial axis (dim 1), of
    which this rank keeps its own (``parallel/spatial.py``).
    ``channels_first``: the arrays are [B or 1, C, *spatial] (PUNetGCond's
    channel conditions, in the network's layout): the slabs are cut along
    dim 2, and an array of one row, broadcast over the batch, keeps it.
    Arrays keep their type and device. A per-process loader
    (``ArrayDataLoader`` under a process group) already yields this rank's
    rows: pass those to the step as they are."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    cut = SPATIAL_AXIS in mesh.mesh_dim_names and SPATIAL_AXIS not in names
    dim = 2 if channels_first else 1

    def take(x):
        if not (channels_first and x.shape[0] == 1):
            x = x[data_rows(mesh, x.shape[0], axis)]
        if cut and x.ndim >= dim + 2:
            n, k = axis_size(mesh, SPATIAL_AXIS), x.shape[dim]
            if k % n:
                raise ValueError(f"spatial axis {k} not divisible by mesh "
                                 f"'{SPATIAL_AXIS}' axis size {n}")
            i = axis_index(mesh, SPATIAL_AXIS)
            x = x[(slice(None),) * dim
                  + (slice(i * (k // n), (i + 1) * (k // n)),)]
        return x
    return tree_map(take, batch)


def constrain_batch(x, mesh, axis: str = DATA_AXIS):
    """This rank's rows of ``x``, raising when its batch does not divide
    the ``axis`` (the samplers' shared contract)."""
    return x[data_rows(mesh, x.shape[0], axis)]


def gather_batch(x: torch.Tensor, mesh, axis: str | Sequence[str] = DATA_AXIS,
                 dim: int = 0) -> torch.Tensor:
    """The inverse of ``shard_batch``: every rank's rows along ``dim``,
    in rank order, on every rank (an all-gather over the ``axis``
    line)."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    names = tuple(a for a in names if a in mesh.mesh_dim_names)
    n = axis_size(mesh, names)
    if len(names) == 1:
        group = mesh.get_group(names[0])
    elif set(names) == set(mesh.mesh_dim_names):
        group = None
    else:
        raise NotImplementedError(f"gather over axes {names}")
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def rows_of(y, rows: slice, nsamples: int):
    """A condition's rows (tensors, or a flat dict of them, whose leading
    dim is ``nsamples``; others, broadcast over the batch, whole)."""
    def take(v):
        return v[rows] if torch.is_tensor(v) and v.ndim and \
            v.shape[0] == nsamples else v
    if y is None:
        return None
    if isinstance(y, dict):
        return {k: take(v) for k, v in y.items()}
    return take(y)


def _tensors(tree) -> list:
    """The tensors of a module, a train state, or a tuple / list / dict
    structure."""
    from diffsci_tpu_torch.models.karras.train import TrainState
    from diffsci_tpu_torch.models.vae.module import VAETrainState
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, VAETrainState):
        out = list(tree.params.values()) + list(tree.buffers.values()) + \
            list((tree.disc_params or {}).values()) + [tree.counter]
        for opt in (tree.optimizer, tree.disc_optimizer):
            for slot in (opt.state.values() if opt is not None else ()):
                out += [v for v in slot.values() if torch.is_tensor(v)]
        return out
    if isinstance(tree, TrainState):
        out = list(tree.params.values()) + list(tree.buffers.values())
        for slot in tree.optimizer.state.values():
            out += [v for v in slot.values() if torch.is_tensor(v)]
        if tree.ema is not None:
            for profile in tree.ema.profiles:
                out += list(profile.values())
        return out
    out = []
    tree_map(lambda v: out.append(v) if torch.is_tensor(v) else None, tree)
    return out


@torch.no_grad()
def replicate(tree: Any, mesh) -> Any:
    """Every rank's copy of ``tree`` (a train state, a module, or a
    structure of tensors) made rank 0's, in place (a broadcast from rank
    0 over the mesh's group), and returned. A ``TrainState`` (or a
    ``VAETrainState``) then carries its placement (``state.placement``),
    and the train step over it (``make_train_step``,
    ``make_ensemble_train_step``, ``make_distill_step``,
    ``make_vae_train_step``) is the data-parallel step: the batch is each
    rank's rows over the mesh's ``data`` axis, the gradients are averaged
    over the ranks, and the EDM batch norms of its network take their
    statistics over every rank's rows."""
    from diffsci_tpu_torch.models.karras.train import TrainState
    from diffsci_tpu_torch.models.vae.module import VAETrainState
    from diffsci_tpu_torch.ops.batchnorm import DimensionAgnosticBatchNorm
    from diffsci_tpu_torch.parallel.placement import Placement
    for t in _tensors(tree):
        dist.broadcast(t, src=0)
    if isinstance(tree, VAETrainState):
        tree.placement = Placement(mesh, batch_axes=(DATA_AXIS,))
    if isinstance(tree, TrainState):
        tree.placement = Placement(mesh, batch_axes=(DATA_AXIS,))
        for m in tree.module.modules() if tree.module is not None else ():
            if isinstance(m, DimensionAgnosticBatchNorm):
                m.batch_ranks = dist.get_world_size()
    return tree


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad ``x`` with zeros along ``axis`` to a multiple of ``multiple``;
    returns (padded, the real count)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        pad_shape = list(x.shape)
        pad_shape[axis] = rem
        return torch.cat([x, x.new_zeros(pad_shape)], dim=axis), n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad), n


__all__ = ["DATA_AXIS", "EXPERT_AXIS", "SPATIAL_AXIS", "STAGE_AXIS",
           "TENSOR_AXIS", "axis_index", "axis_size",
           "batch_sharding", "constrain_batch", "data_rows", "gather_batch",
           "initialize_distributed", "make_mesh", "mesh_device",
           "pad_to_multiple", "replicate", "replicated", "rows_of",
           "shard_batch"]
