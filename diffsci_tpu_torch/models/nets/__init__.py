from diffsci_tpu_torch.models.nets.autoencoders import (
    ChannelAdapterWrapper, load_autoencoder)
from diffsci_tpu_torch.models.nets.ddpm_unet import UNet2D
from diffsci_tpu_torch.models.nets.hfnet import HFNet, HFNetCond, HFNetUncond
from diffsci_tpu_torch.models.nets.mlp import MLPCond, MLPUncond
from diffsci_tpu_torch.models.nets.embedders import (
    CompositeEmbedder, DateGaussianFourierProjection,
    GeoGaussianFourierProjection, PorosityEmbedder, PoreSizeDistEmbedder,
    PoreSizeDistTransformer, PositionalEncoding1d,
    TwoPointCorrelationEmbedder, TwoPointCorrelationTransformer)
from diffsci_tpu_torch.models.nets.punetg import (PUNetG, PUNetGCond,
                                                  PUNetGConfig,
                                                  calculate_receptive_field)
from diffsci_tpu_torch.models.nets.vae import (AutoencoderKL, DDConfig,
                                               DiagonalGaussianDistribution)

__all__ = ["AutoencoderKL", "ChannelAdapterWrapper", "CompositeEmbedder",
           "DDConfig", "DiagonalGaussianDistribution", "DateGaussianFourierProjection",
           "GeoGaussianFourierProjection", "HFNet", "HFNetCond",
           "HFNetUncond", "MLPCond", "MLPUncond", "PUNetG", "PUNetGCond",
           "PUNetGConfig", "PorosityEmbedder", "PoreSizeDistEmbedder",
           "PoreSizeDistTransformer", "PositionalEncoding1d",
           "TwoPointCorrelationEmbedder", "TwoPointCorrelationTransformer",
           "UNet2D", "calculate_receptive_field", "load_autoencoder"]
