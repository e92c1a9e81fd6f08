"""In-memory datasets."""

from irw_tpu_torch.data.synthetic import SyntheticDataset, SyntheticVOCDataset

__all__ = ["SyntheticDataset", "SyntheticVOCDataset"]
