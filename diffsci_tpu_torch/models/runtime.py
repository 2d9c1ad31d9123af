"""What the runtimes beside ``KarrasModel`` share: the network's wrapper,
the protocol that ``create_train_state`` and ``make_train_step`` read,
and the latent shape of an autoencoder.

``SIModel``, ``SDEModel``, ``DDPMModuleV1`` and ``ForecastModel`` hold
their network as ``RuntimeNet`` (state-dict scope ``model``, as
``KarrasNet``), so that the train step's machinery finds ``model.net``
and ``model.net.model`` as it does for a ``KarrasModel``. The train step
draws a time into σ's slot by ``model.config.noisesampler``: the runtime's
own time draw (SI's ``sample_timestep``, the SDE scheduler's, v1's
uniform step), or zeros for the forecaster, which has none.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from diffsci_tpu_torch.models.compute import ComputeDtypeMixin
from diffsci_tpu_torch.models.nets.layers import init_parameters
from diffsci_tpu_torch.utils import resolve_device


class RuntimeNet(nn.Module):
    """Wraps a runtime's network (state-dict prefix ``model.``) and moves
    the channel axis of its first argument and of its output:
    channels-last outside, [B, C, *spatial] inside (nothing moves on
    [B, dim]). ``initial_norm``: ``SIModel``'s running-stat norm, held
    beside the network so that the train step writes its statistics."""

    def __init__(self, model: nn.Module,
                 initial_norm: nn.Module | None = None):
        super().__init__()
        self.model = model
        if initial_norm is not None:
            self.initial_norm = initial_norm

    def forward(self, x, *args):
        out = self.model(x.movedim(-1, 1), *args)
        return out.movedim(1, -1).contiguous()


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """What the train step reads of a runtime that has no configuration
    of its own: ``noisesampler``, whose ``sample(shape, generator=None,
    device=None, out=None)`` draws the time that travels in σ's slot."""
    noisesampler: object


class NoNoiseLevel:
    """The σ slot of a runtime without a noise level: zeros, drawn from
    nothing."""

    def sample(self, shape, generator=None, device=None, out=None):
        if out is None:
            return torch.zeros(shape, device=device)
        return out.zero_()


def fill_draw(shape, generator, device, out, draw) -> torch.Tensor:
    """``draw(out)`` into ``out``, or into a new float32 tensor of
    ``shape`` on ``device`` (the generator's by default); returns it."""
    if out is None:
        if device is None and generator is not None:
            device = generator.device
        out = torch.empty(shape, device=device)
    draw(out)
    return out


class RuntimeMixin(ComputeDtypeMixin):
    """``to``, ``init``, the latent shape and the posterior draw of a
    runtime holding ``self.net`` (a ``RuntimeNet``), ``self.device`` and
    ``self.autoencoder`` (None, or the ``KarrasModel`` protocol's
    autoencoder on [B, C, *spatial]); call ``_reset_runtime()`` in
    ``__init__``."""

    def _reset_runtime(self) -> None:
        self._latent_shapes: dict = {}
        self._reset_cast()

    @property
    def latent_model(self) -> bool:
        return getattr(self, "autoencoder", None) is not None

    def to(self, device):
        self.device = resolve_device(device)
        self.net.to(self.device)
        return self

    def init(self, seed: int = 0) -> dict:
        """Draw every weight from ``seed`` (device-independent); returns
        the state dict."""
        init_parameters(self.net, seed)
        return self.net.state_dict()

    def latent_shape(self, x_shape) -> tuple:
        """The shape (batch axis included, channels-last) that the runtime
        works in for data of ``x_shape``: ``x_shape`` itself, or an
        autoencoder's latent shape (found once per shape by encoding zeros
        of one item)."""
        x_shape = tuple(x_shape)
        if not self.latent_model:
            return x_shape
        probe = self._latent_shapes.get(x_shape[1:])
        if probe is None:
            x = torch.zeros((1, x_shape[-1]) + x_shape[1:-1],
                            device=self.device)
            with torch.no_grad():
                z = self.autoencoder.encode(x)
            z = z[0] if isinstance(z, tuple) else z
            probe = tuple(z.movedim(1, -1).shape[1:])
            self._latent_shapes[x_shape[1:]] = probe
        return x_shape[:1] + probe

    def draws_posterior(self) -> bool:
        """Whether the runtime draws a posterior sample for its
        autoencoder's encode."""
        return self.latent_model and bool(
            getattr(self.autoencoder, "sample_posterior", False))

    def _draw_posterior(self, x, generator=None):
        """The posterior draw for encoding x (the latent's shape) from
        ``generator``, or None when the runtime draws none."""
        if not self.draws_posterior():
            return None
        return torch.randn(self.latent_shape(x.shape), generator=generator,
                           device=x.device, dtype=x.dtype)

    def _ae_encode(self, x, y=None, z_eps=None, conditional=False):
        """The autoencoder's encode of channels-last x (``z_eps``: its
        posterior draw), channels-last out; with ``conditional`` y is
        passed and whatever else it returns comes back beside."""
        eps = None if z_eps is None else z_eps.movedim(-1, 1)
        xn = x.movedim(-1, 1)
        out = self.autoencoder.encode(xn, y=y, eps=eps) if conditional \
            else self.autoencoder.encode(xn, eps=eps)
        rest = None
        if isinstance(out, tuple):
            out, rest = out
        return out.movedim(1, -1).contiguous(), rest

    def _ae_decode(self, z, y=None, conditional=False):
        zn = z.movedim(-1, 1)
        out = self.autoencoder.decode(zn, y=y) if conditional \
            else self.autoencoder.decode(zn)
        return out.movedim(1, -1).contiguous()
