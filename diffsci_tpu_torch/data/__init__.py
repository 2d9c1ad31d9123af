from diffsci_tpu_torch.data.toy_datasets import (
    AnalyticalDataset, DiagonalGaussianDataset, MixtureOf1DUniformsDataset,
    MixtureOfGaussiansDataset, MixtureOfPointsDataset, ShapesDataset,
    Single1DUniformDataset, SingleGaussianDataset, SinglePointDataset,
    ZeroDataset, ZeroMeanGaussianDataset)

__all__ = ["AnalyticalDataset", "DiagonalGaussianDataset",
           "MixtureOf1DUniformsDataset", "MixtureOfGaussiansDataset",
           "MixtureOfPointsDataset", "ShapesDataset", "Single1DUniformDataset",
           "SingleGaussianDataset", "SinglePointDataset", "ZeroDataset",
           "ZeroMeanGaussianDataset"]
