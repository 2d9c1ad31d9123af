"""KarrasEncoderModel: learned conditioning, the condition y made by a
trainable encoder from x itself.

Port of ``diffsci_tpu/models/karras/encoder.py``. The encoder joins the
score network in one module (``encoder_model.*`` beside ``model.*``), so
one optimizer trains both; the encoder reads x in the network's layout
(channels first) in float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from diffsci_tpu_torch.models.karras.module import (KarrasModel,
                                                    KarrasModelConfig,
                                                    KarrasNet)


class _EncoderKarrasNet(KarrasNet):
    def __init__(self, model, encoder_model, dynamic_loss_weight=None,
                 edm_batch_norm_sigma=None):
        super().__init__(model, dynamic_loss_weight, edm_batch_norm_sigma)
        self.encoder_model = encoder_model


class KarrasEncoderModel(KarrasModel):
    """A ``KarrasModel`` whose loss takes its condition from
    ``encoder_model(x)``; batches carry no condition (``select_batch``
    as an unconditional model's)."""

    def __init__(self, model: nn.Module, encoder_model: nn.Module,
                 config: KarrasModelConfig, masked: bool = False,
                 autoencoder=None, autoencoder_conditional: bool = False,
                 **kwargs):
        self.encoder_model = encoder_model
        super().__init__(model, config, conditional=True, masked=masked,
                         autoencoder=autoencoder,
                         autoencoder_conditional=autoencoder_conditional,
                         **kwargs)
        self.net = _EncoderKarrasNet(
            model, encoder_model, config.dynamic_loss_weight,
            config.extra_args.get("sigma_data", 0.5)
            if config.has_edm_batch_norm else None).to(self.device).eval()
        self._reset_cast()

    def encode_condition(self, x, train: bool = False, variables=None):
        """The encoder's condition of x (channels-last in, the encoder's
        output out); ``variables`` (``encoder_model.*`` by name) stand in
        for its weights."""
        enc = self.net.encoder_model
        enc.train(train)
        xn = x.movedim(-1, 1)
        if variables is None:
            return enc(xn)
        prefix = "encoder_model."
        tensors = dict(enc.named_parameters())
        tensors.update({k[len(prefix):]: v for k, v in variables.items()
                        if k.startswith(prefix)})
        return torch.func.functional_call(enc, tensors, (xn,))

    def loss_fn(self, x, sigma, y=None, mask=None, train: bool = True,
                eps=None, generator=None, variables=None, cond_keep=None,
                return_updates: bool = False, z_eps=None):
        """y from the encoder, then ``KarrasModel.loss_fn``."""
        y = self.encode_condition(x, train=train, variables=variables)
        return super().loss_fn(x, sigma, y, mask, train, eps=eps,
                               generator=generator, variables=variables,
                               cond_keep=cond_keep,
                               return_updates=return_updates, z_eps=z_eps)

    def select_batch(self, batch):
        was = self.conditional
        self.conditional = False
        try:
            return super().select_batch(batch)
        finally:
            self.conditional = was

    def export_description(self) -> dict:
        base = super().export_description()
        enc = getattr(self.encoder_model, "export_description", None)
        return dict(base_description=base,
                    encoder_description=enc() if enc else None)
