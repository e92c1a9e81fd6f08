"""Single-label image datasets (port of ``irw_tpu/data/datasets_image.py:18-212``).

CUB-200, SOP, In-Shop, iNaturalist, Stanford Dogs, Textures, ImageNet-100
and any class-per-folder tree.  Each keeps its split protocol (cited per
class) and reduces to (paths, labels, super_labels) lists; decoding happens
in ``load_image`` and the loader.
"""

from __future__ import annotations

import os

import numpy as np

from irw_tpu_torch.data.base import BaseDataset


class Cub200Dataset(BaseDataset):
    """CUB-200-2011 class-disjoint retrieval split: classes 1-100 train,
    101-200 test (cub200.py:9-51)."""

    def __init__(self, data_dir: str, mode: str = "train", **kw):
        images_txt = os.path.join(data_dir, "images.txt")
        labels_txt = os.path.join(data_dir, "image_class_labels.txt")
        with open(images_txt) as f:
            id_to_path = dict(line.split() for line in f)
        with open(labels_txt) as f:
            id_to_label = {k: int(v) for k, v in (line.split() for line in f)}
        paths, labels = [], []
        for img_id, rel in sorted(id_to_path.items(), key=lambda kv: int(kv[0])):
            lbl = id_to_label[img_id]
            keep = lbl <= 100 if mode == "train" else lbl > 100
            if keep:
                paths.append(os.path.join(data_dir, "images", rel))
                labels.append(lbl - 1)
        super().__init__(paths, self.remap_labels(labels), mode=mode)


class Cub200Indomain(BaseDataset):
    """50/50 per-class split (cub200.py:53-96)."""

    def __init__(self, data_dir: str, mode: str = "train", seed: int = 0, **kw):
        base = Cub200Dataset(data_dir, mode="train")
        all_test = Cub200Dataset(data_dir, mode="test")
        paths = base.paths + all_test.paths
        labels = np.concatenate([base.labels, all_test.labels + 100])
        rng = np.random.RandomState(seed)
        keep = []
        for cls in np.unique(labels):
            idx = np.where(labels == cls)[0]
            rng.shuffle(idx)
            half = len(idx) // 2
            keep.extend(idx[:half] if mode == "train" else idx[half:])
        keep = sorted(keep)
        super().__init__([paths[i] for i in keep], labels[keep], mode=mode)


class SOPDataset(BaseDataset):
    """Stanford Online Products: Ebay_{train,test}.txt with super labels
    (sop.py:8-50)."""

    def __init__(self, data_dir: str, mode: str = "train", **kw):
        fname = "Ebay_train.txt" if mode == "train" else "Ebay_test.txt"
        paths, labels, supers = [], [], []
        with open(os.path.join(data_dir, fname)) as f:
            next(f)  # header: image_id class_id super_class_id path
            for line in f:
                _, class_id, super_id, rel = line.split()
                paths.append(os.path.join(data_dir, rel))
                labels.append(int(class_id) - 1)
                supers.append(int(super_id) - 1)
        super().__init__(paths, self.remap_labels(labels), supers, mode)


class InShopDataset(BaseDataset):
    """DeepFashion In-Shop: list_eval_partition.txt, modes train / query /
    gallery (inshop.py:6-56; the getter builds the query/gallery dict,
    getter.py:169-175)."""

    def __init__(self, data_dir: str, mode: str = "train", **kw):
        part_file = os.path.join(data_dir, "list_eval_partition.txt")
        paths, labels = [], []
        with open(part_file) as f:
            lines = f.read().splitlines()[2:]
        for line in lines:
            rel, item_id, status = line.split()
            if status == mode:
                paths.append(os.path.join(data_dir, rel))
                labels.append(int(item_id.split("_")[-1]))
        super().__init__(paths, self.remap_labels(labels), mode=mode)


class INaturalistDataset(BaseDataset):
    """iNaturalist-2018 retrieval split from Inat_dataset_splits txt files
    (inaturalist.py:7-55)."""

    def __init__(self, data_dir: str, mode: str = "train", **kw):
        split_file = os.path.join(
            data_dir, "Inat_dataset_splits",
            "Inaturalist_train_set1.txt" if mode == "train" else "Inaturalist_test_set1.txt",
        )
        paths, labels = [], []
        with open(split_file) as f:
            for line in f:
                rel = line.strip()
                if not rel:
                    continue
                paths.append(os.path.join(data_dir, rel))
                labels.append(rel.split("/")[1])
        super().__init__(paths, self.remap_labels(labels), mode=mode)


class _FolderDataset(BaseDataset):
    """class-per-subfolder layout."""

    def __init__(self, data_dir: str, mode: str = "train",
                 extensions=(".jpg", ".jpeg", ".png"), **kw):
        paths, labels = [], []
        classes = sorted(
            d for d in os.listdir(data_dir) if os.path.isdir(os.path.join(data_dir, d))
        )
        for ci, cls in enumerate(classes):
            for fname in sorted(os.listdir(os.path.join(data_dir, cls))):
                if fname.lower().endswith(extensions):
                    paths.append(os.path.join(data_dir, cls, fname))
                    labels.append(ci)
        super().__init__(paths, np.asarray(labels), mode=mode)


class StanfordDog12Dataset(_FolderDataset):
    """stanforddog12.py:8 — folder dataset."""


class TexturedDataset(_FolderDataset):
    """textured_data.py:9 — folder dataset."""


class ImageNet100Hashing(BaseDataset):
    """ImageNet-100 hashing protocol: train.txt/query.txt/database.txt
    manifests of "path label" lines (imagenet100.py:6-53); modes train /
    query / gallery(database)."""

    def __init__(self, data_dir: str, mode: str = "train", **kw):
        fname = {"train": "train.txt", "query": "query.txt",
                 "gallery": "database.txt", "database": "database.txt"}[mode]
        paths, labels = [], []
        with open(os.path.join(data_dir, fname)) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                paths.append(os.path.join(data_dir, parts[0]))
                labels.append(int(parts[1]))
        super().__init__(paths, np.asarray(labels), mode=mode)


class ImageFolderDataset(BaseDataset):
    """Generic class-per-subdirectory tree (torchvision ImageFolder layout):

        root/<class_name>/<image>.{jpg,jpeg,png,bmp,webp}

    Not in the reference (its 17 loaders are dataset-specific) — provided so
    arbitrary user data works without writing a parser.  Splits:

    - mode="all": every image (label = sorted-class index);
    - mode="train"/"test" with split="class_disjoint" (default): first
      half of the classes train, second half test (the CUB/SOP retrieval
      convention, cub200.py:9-51);
    - split="in_domain": per-class `holdout` fraction to test, seeded.
    """

    _EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

    def __init__(self, data_dir: str, mode: str = "train",
                 split: str = "class_disjoint", holdout: float = 0.5,
                 seed: int = 0, **kw):
        classes = sorted(
            d for d in os.listdir(data_dir)
            if os.path.isdir(os.path.join(data_dir, d)))
        if not classes:
            raise FileNotFoundError(f"no class subdirectories under {data_dir}")
        paths, labels = [], []
        for idx, cls in enumerate(classes):
            cdir = os.path.join(data_dir, cls)
            for name in sorted(os.listdir(cdir)):
                if name.lower().endswith(self._EXTS):
                    paths.append(os.path.join(cdir, name))
                    labels.append(idx)
        labels = np.asarray(labels)
        if mode != "all":
            if split == "class_disjoint":
                if len(classes) < 2:
                    raise ValueError(
                        f"split='class_disjoint' needs at least 2 class "
                        f"directories under {data_dir}, found "
                        f"{len(classes)} ({classes}); the train half would "
                        f"be empty. Use mode='all' or split='in_domain'.")
                cut = len(classes) // 2
                keep = labels < cut if mode == "train" else labels >= cut
            elif split == "in_domain":
                rng = np.random.RandomState(seed)
                test_mask = np.zeros(len(paths), bool)
                for idx in range(len(classes)):
                    members = np.where(labels == idx)[0]
                    n_test = (0 if holdout <= 0
                              else max(1, int(round(len(members) * holdout))))
                    test_mask[rng.permutation(members)[:n_test]] = True
                keep = ~test_mask if mode == "train" else test_mask
            else:
                raise ValueError(f"unknown split {split!r}")
            paths = [p for p, k in zip(paths, keep) if k]
            labels = labels[keep]
        super().__init__(paths, self.remap_labels(labels), mode=mode)
