"""Dataset registry (port of ``irw_tpu/data/registry.py:31-92``): every
dataset of the JAX registry."""

from __future__ import annotations

from irw_tpu_torch.data.cifar import Cifar10Retrieval, Cifar100RetrievalDataset, CifarDataset
from irw_tpu_torch.data.datasets_image import (
    Cub200Dataset,
    Cub200Indomain,
    ImageFolderDataset,
    ImageNet100Hashing,
    INaturalistDataset,
    InShopDataset,
    SOPDataset,
    StanfordDog12Dataset,
    TexturedDataset,
)
from irw_tpu_torch.data.datasets_multilabel import (
    COCOHashing,
    MIRFlickrHashing,
    NUSWIDEHashing,
    VOC2012Hashing,
)
from irw_tpu_torch.data.landmarks import RevisitedDataset, SfM120kDataset
from irw_tpu_torch.data.synthetic import (
    SyntheticDataset,
    SyntheticHashingDataset,
    SyntheticVOCDataset,
)

DATASET_REGISTRY = {
    "SyntheticDataset": SyntheticDataset,
    "SyntheticHashingDataset": SyntheticHashingDataset,
    "SyntheticVOCDataset": SyntheticVOCDataset,
    "Cub200Dataset": Cub200Dataset,
    "ImageFolderDataset": ImageFolderDataset,
    "Cub200Indomain": Cub200Indomain,
    "SOPDataset": SOPDataset,
    "InShopDataset": InShopDataset,
    "INaturalistDataset": INaturalistDataset,
    "StanfordDog12Dataset": StanfordDog12Dataset,
    "TexturedDataset": TexturedDataset,
    "ImageNet100Hashing": ImageNet100Hashing,
    "VOC2012Hashing": VOC2012Hashing,
    "MIRFlickrHashing": MIRFlickrHashing,
    "COCOHashing": COCOHashing,
    "NUSWIDEHashing": NUSWIDEHashing,
    "CifarDataset": CifarDataset,
    "Cifar100RetrievalDataset": Cifar100RetrievalDataset,
    "Cifar10Retrieval": Cifar10Retrieval,
    "SfM120kDataset": SfM120kDataset,
    "RevisitedDataset": RevisitedDataset,
}

# datasets whose eval side is an explicit query/gallery pair
QUERY_GALLERY_DATASETS = {
    "SyntheticHashingDataset",
    "SyntheticVOCDataset",
    "InShopDataset",
    "VOC2012Hashing",
    "MIRFlickrHashing",
    "COCOHashing",
    "NUSWIDEHashing",
    "ImageNet100Hashing",
    "Cifar10Retrieval",
    "RevisitedDataset",
}


def get_dataset(name: str, mode: str = "train", **kwargs):
    try:
        ctor = DATASET_REGISTRY[name]
    except KeyError as exc:
        raise ValueError(f"unknown dataset {name!r}; available: {sorted(DATASET_REGISTRY)}") from exc
    return ctor(mode=mode, **kwargs)


def get_eval_datasets(name: str, **kwargs):
    """The eval side: a {'query', 'gallery'} dict for the query/gallery
    families, a single test dataset otherwise."""
    if name in QUERY_GALLERY_DATASETS:
        return {"query": get_dataset(name, mode="query", **kwargs),
                "gallery": get_dataset(name, mode="gallery", **kwargs)}
    return get_dataset(name, mode="test", **kwargs)
