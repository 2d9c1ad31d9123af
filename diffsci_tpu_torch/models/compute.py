"""The network of a runtime in its compute dtype.

``KarrasModel`` and ``DDPMModel`` hold their network in float32 master
weights (``self.net``) and may run it in a lower ``compute_dtype``
(bf16). ``ComputeDtypeMixin`` gives both the callable that runs the
network: the cast inside the autograd graph when gradients are on, so
they land on the f32 masters as autodiff through the JAX package's cast
does, and a cast copy for calls without gradients (sampling), which the
sampler's CUDA graphs read. The cast copy's magnitude-preserving layers
hold their normalized weights (``hoist_from``, ``models/nets/normed.py``),
taken from the masters whenever they change, so a sampling loop does not
normalize them on every network call. A network may name, in its
``read_cast``, parameters that it casts itself as it reads them (FSDP's
blocks, ``parallel/fsdp.py``, whose reads gather them): those stay
float32 on the way in and are read in ``READ_DTYPE``, so that their
gradients are reduced in float32. The cast copy of an FSDP network holds
the blocks in the compute dtype and gathers each layer's as it runs.
"""

from __future__ import annotations

import contextvars
import copy

import torch
import torch.nn as nn

from diffsci_tpu_torch.utils import graphs

# the dtype a network's ``read_cast`` parameters are read in; None: their
# own
READ_DTYPE: contextvars.ContextVar = contextvars.ContextVar(
    "read_dtype", default=None)


class ComputeDtypeMixin:
    """Expects ``self.net`` (an ``nn.Module``), ``self.compute_dtype`` (a
    torch dtype or None) and ``self.device``; call ``_reset_cast()`` in
    ``__init__``."""

    def _reset_cast(self) -> None:
        self._cast_net = None
        self._cast_versions = None
        self._graphs = None
        self._graphs_key = None

    def _masters_changed(self) -> None:
        """The masters were updated where their version counters do not
        move (a replayed CUDA graph of a train step): the cast copy is
        refreshed at its next use."""
        self._cast_versions = None

    def _cast_copy(self) -> nn.Module:
        """The copy of the network with parameters and buffers in
        ``compute_dtype``, for calls that ask no gradient (sampling). It is
        one module for the model's life: whenever a master tensor changed
        (its storage or its in-place version counter, which an eager
        optimizer step moves, or ``_masters_changed``) its tensors are
        refreshed in place, so that a load_state_dict, an init or training
        is always seen and a captured sampler reads the new values. It is
        built anew only when the masters' shapes or devices changed."""
        masters = list(self.net.parameters()) + list(self.net.buffers())
        versions = tuple((t.data_ptr(), t._version) for t in masters)
        if versions == self._cast_versions:
            return self._cast_net
        # outside inference mode, so that the copy holds ordinary tensors
        # whichever context first asks for it
        with torch.inference_mode(False), torch.no_grad():
            cast = None if self._cast_net is None else \
                list(self._cast_net.parameters()) + \
                list(self._cast_net.buffers())
            if cast is None or len(cast) != len(masters) or any(
                    c.shape != m.shape or c.device != m.device
                    for c, m in zip(cast, masters)):
                self._cast_net = copy.deepcopy(self.net).to(
                    self.compute_dtype).requires_grad_(False)
            else:
                torch._foreach_copy_(cast, masters)
            for c, m in zip(self._cast_net.modules(), self.net.modules()):
                if hasattr(c, "hoist_from"):
                    c.hoist_from(m)
        self._cast_versions = versions
        return self._cast_net

    def _inference_net(self) -> nn.Module:
        """The module a call without gradients runs: the network, or its
        cast copy under a compute dtype."""
        return self.net if self.compute_dtype is None else self._cast_copy()

    def _graph_cache(self) -> graphs.GraphCache:
        """The cache of the sampler's CUDA graphs, after bringing the
        weights they read up to date. A graph reads the tensors of
        ``_inference_net()`` as they were at its capture, so the cache is
        dropped, graphs and pool, when those tensors were replaced (a new
        device, a cast copy built anew)."""
        net = self._inference_net()
        key = tuple(t.data_ptr() for t in
                    list(net.parameters()) + list(net.buffers()))
        if self._graphs is None or key != self._graphs_key:
            self._graphs = graphs.GraphCache(self.device)
            self._graphs_key = key
        return self._graphs

    def _network(self, train: bool, variables=None):
        """The callable that runs ``self.net``, in training mode when
        ``train`` (dropout on) and eval mode otherwise.

        With ``compute_dtype``, the parameters go through ``.to(cd)``
        inside the autograd graph (``functional_call`` over cast tensors)
        whenever gradients are on, so gradients land on the f32 masters,
        as autodiff through the JAX package's cast does; calls without
        gradients use the cached cast copy. ``variables`` (tensors by
        state-dict name) stand in for the module's own."""
        cd = self.compute_dtype
        if variables is None and (cd is None or not torch.is_grad_enabled()):
            net = self._inference_net()
            if net.training != train:
                net.train(train)
            return net
        if self.net.training != train:
            self.net.train(train)
        tensors = dict(self.net.named_parameters())
        tensors.update(self.net.named_buffers())
        tensors.update(variables or {})
        if cd is None:
            return lambda *args: torch.func.functional_call(self.net,
                                                            tensors, args)
        own = getattr(self.net, "read_cast", ())
        tensors = {k: v.to(cd) if v.is_floating_point() and k not in own
                   else v for k, v in tensors.items()}

        def call(*args):
            token = READ_DTYPE.set(cd)
            try:
                return torch.func.functional_call(self.net, tensors, args)
            finally:
                READ_DTYPE.reset(token)
        return call
