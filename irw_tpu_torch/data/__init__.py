"""The datasets (in memory and read from files), their registry and the
epoch loader."""

from irw_tpu_torch.data.base import BaseDataset, InMemoryDataset, subset
from irw_tpu_torch.data.loader import EpochLoader
from irw_tpu_torch.data.registry import (
    DATASET_REGISTRY,
    QUERY_GALLERY_DATASETS,
    get_dataset,
    get_eval_datasets,
)
from irw_tpu_torch.data.synthetic import (
    SyntheticDataset,
    SyntheticHashingDataset,
    SyntheticVOCDataset,
)

__all__ = ["BaseDataset", "DATASET_REGISTRY", "EpochLoader", "InMemoryDataset",
           "QUERY_GALLERY_DATASETS", "SyntheticDataset", "SyntheticHashingDataset",
           "SyntheticVOCDataset", "get_dataset", "get_eval_datasets", "subset"]
