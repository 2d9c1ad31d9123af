from diffsci_tpu_torch.models.nets.adm import (ADM, ADMBlock, ADMConfig,
                                               ADMTimeEmbedding)
from diffsci_tpu_torch.models.nets.autoencoders import (
    ChannelAdapterWrapper, load_autoencoder)
from diffsci_tpu_torch.models.nets.classifiers import (ClassifierResBlock,
                                                       MinimalResNet)
from diffsci_tpu_torch.models.nets.convit import ConVit, ConVitConfig
from diffsci_tpu_torch.models.nets.dasc import DASC, DASCConfig, dasc_loss
from diffsci_tpu_torch.models.nets.ddpm_unet import UNet2D
from diffsci_tpu_torch.models.nets.dit import DiffusionTransformer
from diffsci_tpu_torch.models.nets.hfnet import HFNet, HFNetCond, HFNetUncond
from diffsci_tpu_torch.models.nets.mlp import MLPCond, MLPUncond
from diffsci_tpu_torch.models.nets.embedders import (
    CompositeEmbedder, DateGaussianFourierProjection,
    GeoGaussianFourierProjection, PorosityEmbedder, PoreSizeDistEmbedder,
    PoreSizeDistTransformer, PositionalEncoding1d,
    TwoPointCorrelationEmbedder, TwoPointCorrelationTransformer)
from diffsci_tpu_torch.models.nets.moe import (MoEDiffusionTransformer,
                                               MoEFeedForward, moe_aux_loss)
from diffsci_tpu_torch.models.nets.punetg import (PUNetG, PUNetGCond,
                                                  PUNetGConfig,
                                                  calculate_receptive_field)
from diffsci_tpu_torch.models.nets.punetg_variants import (
    PUNetGDecoder, PUNetGDeterministic, PUNetGEncoder, PUNetV, PUNetVConfig)
from diffsci_tpu_torch.models.nets.vae import (AutoencoderKL, DDConfig,
                                               DiagonalGaussianDistribution)
from diffsci_tpu_torch.models.nets.vaenet import (MinimalResnetBlock, VAENet,
                                                  VAENetConfig, divide_dims,
                                                  patched_conv)

__all__ = ["ADM", "ADMBlock", "ADMConfig", "ADMTimeEmbedding",
           "AutoencoderKL", "ChannelAdapterWrapper", "ClassifierResBlock",
           "CompositeEmbedder", "ConVit", "ConVitConfig", "DASC",
           "DASCConfig", "DDConfig", "DateGaussianFourierProjection",
           "DiagonalGaussianDistribution", "DiffusionTransformer",
           "GeoGaussianFourierProjection", "HFNet", "HFNetCond",
           "HFNetUncond", "MLPCond", "MLPUncond", "MinimalResNet",
           "MoEDiffusionTransformer", "MoEFeedForward", "PUNetG",
           "PUNetGCond", "PUNetGConfig", "PUNetGDecoder",
           "PUNetGDeterministic", "PUNetGEncoder", "PUNetV", "PUNetVConfig",
           "PorosityEmbedder", "PoreSizeDistEmbedder",
           "PoreSizeDistTransformer", "PositionalEncoding1d",
           "TwoPointCorrelationEmbedder", "TwoPointCorrelationTransformer",
           "UNet2D", "VAENet", "VAENetConfig", "MinimalResnetBlock",
           "calculate_receptive_field", "dasc_loss", "divide_dims",
           "load_autoencoder", "moe_aux_loss", "patched_conv"]
