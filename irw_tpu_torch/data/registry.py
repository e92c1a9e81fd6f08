"""Dataset registry (port of ``irw_tpu/data/registry.py:57-92``).

The synthetic in-memory datasets are ported; the file-backed ones of the
JAX registry (CUB, SOP, VOC, Cifar, the landmarks ...) read images from
disk through the native decode path and wait for ROADMAP A8c.
"""

from __future__ import annotations

from irw_tpu_torch.data.synthetic import (
    SyntheticDataset,
    SyntheticHashingDataset,
    SyntheticVOCDataset,
)

DATASET_REGISTRY = {
    "SyntheticDataset": SyntheticDataset,
    "SyntheticHashingDataset": SyntheticHashingDataset,
    "SyntheticVOCDataset": SyntheticVOCDataset,
}
_LATER = ("Cub200Dataset", "ImageFolderDataset", "Cub200Indomain", "SOPDataset", "InShopDataset",
          "INaturalistDataset", "StanfordDog12Dataset", "TexturedDataset", "ImageNet100Hashing",
          "VOC2012Hashing", "MIRFlickrHashing", "COCOHashing", "NUSWIDEHashing", "CifarDataset",
          "Cifar100RetrievalDataset", "Cifar10Retrieval", "SfM120kDataset", "RevisitedDataset")

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
    if name in _LATER:
        raise NotImplementedError(f"dataset {name!r} is read from files, which waits for "
                                  "ROADMAP A8c")
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
