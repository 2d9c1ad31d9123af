"""The network of a runtime in its compute dtype.

``KarrasModel`` and ``DDPMModel`` hold their network in float32 master
weights (``self.net``) and may run it in a lower ``compute_dtype``
(bf16). ``ComputeDtypeMixin`` gives both the callable that runs the
network: the cast inside the autograd graph when gradients are on, so
they land on the f32 masters as autodiff through the JAX package's cast
does, and a cached cast copy for calls without gradients (sampling).
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn


class ComputeDtypeMixin:
    """Expects ``self.net`` (an ``nn.Module``) and ``self.compute_dtype``
    (a torch dtype or None); call ``_reset_cast()`` in ``__init__``."""

    def _reset_cast(self) -> None:
        self._cast_net = None
        self._cast_key = None

    def _cast_copy(self) -> nn.Module:
        """A copy of the network with parameters and buffers in
        ``compute_dtype``, for calls that ask no gradient (sampling). It is
        rebuilt whenever a master tensor changes (its storage or its
        in-place version counter, which every optimizer step moves), so a
        load_state_dict, an init or training is always seen."""
        tensors = list(self.net.parameters()) + list(self.net.buffers())
        key = tuple((t.data_ptr(), t._version, t.device) for t in tensors)
        if key != self._cast_key:
            # built outside inference mode so that the copy holds ordinary
            # tensors whichever context first asks for it
            with torch.inference_mode(False), torch.no_grad():
                self._cast_net = copy.deepcopy(self.net).to(
                    self.compute_dtype).requires_grad_(False)
            self._cast_key = key
        return self._cast_net

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
            net = self.net if cd is None else self._cast_copy()
            if net.training != train:
                net.train(train)
            return net
        if self.net.training != train:
            self.net.train(train)
        tensors = dict(self.net.named_parameters())
        tensors.update(self.net.named_buffers())
        tensors.update(variables or {})
        if cd is not None:
            tensors = {k: v.to(cd) if v.is_floating_point() else v
                       for k, v in tensors.items()}
        return lambda *args: torch.func.functional_call(self.net, tensors,
                                                        args)
