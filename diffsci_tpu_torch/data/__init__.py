from diffsci_tpu_torch.data.loading import (ArrayDataLoader,
                                            TorchLoaderAdapter, buffered,
                                            prefetch_to_device,
                                            split_indices, train_val_split)
from diffsci_tpu_torch.data.toy_datasets import (
    AnalyticalDataset, DiagonalGaussianDataset, MixtureOf1DUniformsDataset,
    MixtureOfGaussiansDataset, MixtureOfPointsDataset, ShapesDataset,
    Single1DUniformDataset, SingleGaussianDataset, SinglePointDataset,
    ZeroDataset, ZeroMeanGaussianDataset)

__all__ = ["AnalyticalDataset", "ArrayDataLoader", "DiagonalGaussianDataset",
           "MixtureOf1DUniformsDataset", "MixtureOfGaussiansDataset",
           "MixtureOfPointsDataset", "ShapesDataset", "Single1DUniformDataset",
           "SingleGaussianDataset", "SinglePointDataset",
           "TorchLoaderAdapter", "ZeroDataset", "ZeroMeanGaussianDataset",
           "buffered", "prefetch_to_device", "split_indices",
           "train_val_split"]
