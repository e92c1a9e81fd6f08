"""In-memory datasets and the epoch loader."""

from irw_tpu_torch.data.loader import EpochLoader
from irw_tpu_torch.data.synthetic import InMemoryDataset, SyntheticDataset, SyntheticVOCDataset

__all__ = ["EpochLoader", "InMemoryDataset", "SyntheticDataset", "SyntheticVOCDataset"]
