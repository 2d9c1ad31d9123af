"""DASC: the Deep Aggregation Subspace Clustering network (video anomaly
research), on the NC* layout.

Port of ``diffsci_tpu/models/nets/dasc.py``: ``DASCConfig``,
``AutoEncoderBackbone`` (strided convolutions -> global pool -> latent;
latent -> 4^d cells -> transposed convolutions), ``VideoModelingModule``
(learned-query attention pooling of frame features),
``SelfRepresentationModule`` (the zero-diagonal coefficient matrix A,
OA = Aᵀ O), ``DASC`` (with the feature recovery and ``all_videos_mode``)
and ``dasc_loss``. Module names are the torch reference's
(``auto_encoder.encoder`` / ``decoder`` Sequentials, ``vmm.query``,
``vmm.attention_layers``, ``srm.self_repr``, ``frm_transform``), so its
state dicts load with ``load_state_dict(strict=True)``. The decoder's
transposed convolutions are ``nn.ConvTranspose`` with torch's [I, O, *k]
weights; the JAX package stores them spatially flipped as [*k, I, O]
(``convert`` undoes that). Videos are [B, frames, C, *spatial].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.nn as nn

from diffsci_tpu_torch.models.nets.layers import linear_resize
from diffsci_tpu_torch.parallel.tensor_parallel import whole_weight
from diffsci_tpu_torch.utils import resolve_device, unset

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}


@dataclasses.dataclass(frozen=True)
class DASCConfig:
    """The JAX package's DASCConfig: same fields, same defaults."""
    dimension: int = 2
    in_channels: int = 3
    frame_height: int = 48
    frame_width: int = 42
    frames_per_video: int = 10
    latent_dim: int = 128
    num_videos: int = 100
    num_clusters: int = 10
    encoder_channels: Sequence[int] = (32, 64, 128)
    kernel_size: int = 3
    stride: int = 2
    padding: int = 1
    vmm_hidden_dim: int = 128
    vmm_num_layers: int = 2
    srm_lambda1: float = 1.0
    srm_lambda2: float = 1.0
    dropout: float = 0.0
    use_skip_connections: bool = True

    def __post_init__(self):
        object.__setattr__(self, "encoder_channels",
                           tuple(self.encoder_channels))

    def export_description(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["encoder_channels"] = list(self.encoder_channels)
        return d

    @classmethod
    def from_description(cls, description: dict):
        return cls(**description)


class AutoEncoderBackbone(nn.Module):
    """``encoder``: (strided conv, ReLU) per encoder channel, global mean
    pool, flatten, linear to the latent; ``decoder``: linear, ReLU,
    unflatten to 4^d cells, (transposed conv, ReLU) per stage and a last
    transposed conv to the frame's channels (each doubles the size). A
    frame whose sides are not 4·2^stages is resized to them linearly at
    the end, as in the JAX package."""

    def __init__(self, config: DASCConfig):
        super().__init__()
        cfg = self.config = config
        nd, k = cfg.dimension, cfg.kernel_size
        enc = []
        cin = cfg.in_channels
        for ch in cfg.encoder_channels:
            enc += [_CONV[nd](cin, ch, k, cfg.stride, cfg.padding),
                    nn.ReLU()]
            cin = ch
        enc += [nn.AdaptiveAvgPool2d(1) if nd == 2
                else nn.AdaptiveAvgPool3d(1), nn.Flatten(),
                nn.Linear(cin, cfg.latent_dim)]
        self.encoder = nn.Sequential(*enc)
        rev = tuple(reversed(cfg.encoder_channels))
        dec = [nn.Linear(cfg.latent_dim, rev[0] * 4 ** nd), nn.ReLU(),
               nn.Unflatten(1, (rev[0],) + (4,) * nd)]
        for cin, ch in zip(rev, rev[1:]):
            dec += [_CONV_T[nd](cin, ch, k, cfg.stride, cfg.padding,
                                output_padding=1), nn.ReLU()]
        dec.append(_CONV_T[nd](rev[-1], cfg.in_channels, k, cfg.stride,
                               cfg.padding, output_padding=1))
        self.decoder = nn.Sequential(*dec)

    def encode(self, x):
        return self.encoder(x)

    def decode(self, z):
        cfg = self.config
        h = self.decoder(z)
        target = ((cfg.frame_height, cfg.frame_width) if cfg.dimension == 2
                  else (cfg.frame_height, cfg.frame_width, cfg.frame_width))
        if tuple(h.shape[2:]) != target:
            h = linear_resize(h, target)
        return h

    def forward(self, x):
        return self.decode(self.encode(x))


class VideoModelingModule(nn.Module):
    """Attention pooling of [B, F, d] frame features by the learned
    ``query``, then ``vmm_num_layers - 1`` refinements whose queries are
    tanh(``attention_layers[i]``(video))."""

    def __init__(self, config: DASCConfig):
        super().__init__()
        d = config.latent_dim
        self.query = nn.Parameter(unset(1, d))
        self.attention_layers = nn.ModuleList([
            nn.Linear(d, d) for _ in range(config.vmm_num_layers - 1)])

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.query.copy_(torch.randn(self.query.shape, generator=generator))

    def forward(self, frame_features):
        q = self.query.expand(frame_features.shape[0], -1)
        attn = torch.softmax(torch.einsum("bfd,bd->bf", frame_features, q),
                             dim=-1)
        video = torch.einsum("bf,bfd->bd", attn, frame_features)
        for layer in self.attention_layers:
            q = torch.tanh(layer(video))
            attn = torch.softmax(torch.einsum("bfd,bd->bf", frame_features,
                                              q), dim=-1)
            video = torch.einsum("bf,bfd->bd", attn, frame_features)
        return video, attn


class SelfRepresentationModule(nn.Module):
    """A = W − diag(W) of ``self_repr``'s weight [n, n] (whole under
    tensor parallelism: ``parallel.tensor_parallel.whole_weight``);
    returns (Aᵀ O, A)."""

    def __init__(self, config: DASCConfig):
        super().__init__()
        n = config.num_videos
        self.self_repr = nn.Linear(n, n, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        n = self.self_repr.weight.shape[0]
        bound = math.sqrt(6.0 / (2 * n))
        self.self_repr.weight.copy_(
            (torch.rand((n, n), generator=generator) * 2 - 1) * bound)

    def forward(self, O):
        W = whole_weight(self.self_repr)
        A = W - torch.diag(torch.diagonal(W))
        return A.T @ O, A


class DASC(nn.Module):
    """``net(x, all_videos_mode=False)`` with x [B (videos), F (frames), C,
    *spatial]; returns the reference's dict: ``frame_features``,
    ``video_features``, ``attention_weights``, ``reconstructed`` and, in
    ``all_videos_mode`` (B = num_videos), ``coefficient_matrix`` and
    ``self_represented_features``. Built on ``device`` (default: the CUDA
    card)."""

    def __init__(self, config: DASCConfig,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.auto_encoder = AutoEncoderBackbone(config)
        self.vmm = VideoModelingModule(config)
        self.srm = SelfRepresentationModule(config)
        self.frm_transform = (None if config.use_skip_connections else
                              nn.Linear(config.latent_dim,
                                        config.latent_dim))
        self.to(device)

    def forward(self, x, all_videos_mode: bool = False):
        cfg = self.config
        B, F = x.shape[:2]
        frame_features = self.auto_encoder.encode(
            x.reshape((B * F,) + x.shape[2:])).reshape(B, F, -1)
        video_features, attn = self.vmm(frame_features)
        out = {"frame_features": frame_features,
               "video_features": video_features,
               "attention_weights": attn}
        pooled = video_features
        if all_videos_mode:
            pooled, A = self.srm(video_features)
            out["coefficient_matrix"] = A
            out["self_represented_features"] = pooled
        replicated = pooled[:, None].expand(B, F, cfg.latent_dim)
        recovered = (replicated + frame_features if self.frm_transform is None
                     else self.frm_transform(replicated))
        rec = self.auto_encoder.decode(recovered.reshape(B * F,
                                                         cfg.latent_dim))
        out["reconstructed"] = rec.reshape((B, F) + rec.shape[1:])
        return out

    def export_description(self) -> dict:
        return {"config": self.config.export_description(),
                "model_type": "DASC"}


def dasc_loss(config: DASCConfig, outputs, original, stage: str = "second"):
    """The two-stage loss: 'first' the frame MSE; 'second' adds
    srm_lambda2·mean((OA − O)²) and srm_lambda1·|A|₁ when the outputs
    hold A. Returns (total, {"mse", ["self_repr", "sparsity"], "total"})."""
    losses = {}
    mse = torch.mean((outputs["reconstructed"] - original) ** 2)
    losses["mse"] = total = mse
    if stage == "second" and "coefficient_matrix" in outputs:
        self_repr = torch.mean((outputs["self_represented_features"]
                                - outputs["video_features"]) ** 2)
        sparsity = outputs["coefficient_matrix"].abs().sum()
        losses["self_repr"] = self_repr
        losses["sparsity"] = sparsity
        total = (mse + config.srm_lambda2 * self_repr
                 + config.srm_lambda1 * sparsity)
    losses["total"] = total
    return total, losses


__all__ = ["AutoEncoderBackbone", "DASC", "DASCConfig",
           "SelfRepresentationModule", "VideoModelingModule", "dasc_loss"]
