"""In-memory datasets, their registry and the epoch loader."""

from irw_tpu_torch.data.loader import EpochLoader
from irw_tpu_torch.data.registry import (
    DATASET_REGISTRY,
    QUERY_GALLERY_DATASETS,
    get_dataset,
    get_eval_datasets,
)
from irw_tpu_torch.data.synthetic import (
    InMemoryDataset,
    SyntheticDataset,
    SyntheticHashingDataset,
    SyntheticVOCDataset,
)

__all__ = ["DATASET_REGISTRY", "EpochLoader", "InMemoryDataset", "QUERY_GALLERY_DATASETS",
           "SyntheticDataset", "SyntheticHashingDataset", "SyntheticVOCDataset", "get_dataset",
           "get_eval_datasets"]
