"""Multi-label hashing datasets: VOC2012, MIRFlickr, COCO and NUS-WIDE
(port of ``irw_tpu/data/datasets_multilabel.py:25-133``).

VOC: 20-dim float targets from the XML annotations, train = gallery /
database, val = query.  MIRFlickr, COCO and NUS-WIDE: txt manifests of
38-, 80- and 21-dim targets with train / test (query) / database (dbase)
files.  Labels are float vectors: relevance is a label product.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from irw_tpu_torch.data.base import BaseDataset

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class VOC2012Hashing(BaseDataset):
    """voc.py:9-84: train split = database/gallery, val split = query;
    20-dim multi-label vectors parsed from the XML annotations."""

    def __init__(self, data_dir: str, mode: str = "train", **kw):
        root = data_dir
        # accept either the VOCdevkit root or the VOC2012 directory
        if os.path.isdir(os.path.join(root, "VOCdevkit", "VOC2012")):
            root = os.path.join(root, "VOCdevkit", "VOC2012")
        elif os.path.isdir(os.path.join(root, "VOC2012")):
            root = os.path.join(root, "VOC2012")
        split = "train" if mode in ("train", "gallery", "database") else "val"
        split_file = os.path.join(root, "ImageSets", "Main", f"{split}.txt")
        with open(split_file) as f:
            ids = [line.strip() for line in f if line.strip()]
        cls_index = {c: i for i, c in enumerate(VOC_CLASSES)}
        paths, labels = [], []
        for img_id in ids:
            ann = os.path.join(root, "Annotations", f"{img_id}.xml")
            target = np.zeros(len(VOC_CLASSES), np.float32)
            try:
                tree = ET.parse(ann)
                for obj in tree.findall("object"):
                    name = obj.find("name").text.strip().lower()
                    if name in cls_index:
                        target[cls_index[name]] = 1.0
            except (ET.ParseError, FileNotFoundError):
                continue
            paths.append(os.path.join(root, "JPEGImages", f"{img_id}.jpg"))
            labels.append(target)
        super().__init__(paths, np.stack(labels), mode=mode)


class _ManifestMultiLabel(BaseDataset):
    """txt-manifest datasets (flikr_coco.py): ``<split>_img.txt`` lists
    relative paths, ``<split>_label.txt`` lists space-separated 0/1
    vectors.  Falls back to single "<path> <l0> <l1> ..." lines."""

    num_classes = 0

    #: candidate manifest stems per mode; first existing file wins.  The
    #: DSCH-family layout (_data.py:58-61) names its gallery manifest
    #: ``dbase.txt`` and its query manifest ``query.txt``.
    _SPLIT_STEMS = {
        "train": ("train",),
        "query": ("test", "query"),
        "test": ("test", "query"),
        "gallery": ("database", "dbase"),
        "database": ("database", "dbase"),
    }

    def __init__(self, data_dir: str, mode: str = "train", img_dir: str = "", **kw):
        stems = self._SPLIT_STEMS[mode]
        split = next(
            (s for s in stems
             if os.path.exists(os.path.join(data_dir, f"{s}_img.txt"))
             or os.path.exists(os.path.join(data_dir, f"{s}.txt"))),
            stems[0],
        )
        img_file = os.path.join(data_dir, f"{split}_img.txt")
        lbl_file = os.path.join(data_dir, f"{split}_label.txt")
        paths, labels = [], []
        if os.path.exists(img_file) and os.path.exists(lbl_file):
            with open(img_file) as f:
                rels = [line.strip() for line in f if line.strip()]
            with open(lbl_file) as f:
                for line in f:
                    if line.strip():
                        labels.append(np.asarray(line.split(), np.float32))
            paths = [os.path.join(data_dir, img_dir, rel) for rel in rels]
        else:
            with open(os.path.join(data_dir, f"{split}.txt")) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    paths.append(os.path.join(data_dir, img_dir, parts[0]))
                    labels.append(np.asarray(parts[1:], np.float32))
        super().__init__(paths, np.stack(labels), mode=mode)


class MIRFlickrHashing(_ManifestMultiLabel):
    """flikr_coco.py:7-64 — 38 classes."""

    num_classes = 38


class COCOHashing(_ManifestMultiLabel):
    """flikr_coco.py:67-120 — 80 classes."""

    num_classes = 80


class NUSWIDEHashing(_ManifestMultiLabel):
    """NUS-WIDE 21-class multi-label hashing dataset.

    Reference: main/engine/DSCH/_data.py:33,79 (``nuswide`` → 21 classes,
    eval top-k 5000 at :84); manifests are ``train/query/dbase.txt`` lines
    of ``<file> <l0> ... <l20>`` with images under ``images/``
    (_data.py:44-61).
    """

    num_classes = 21
    # protocol top-k 5000 (_data.py:84) comes from the experience config
    # (configs/experience/default.yaml evaluation.top_k), not the dataset

    def __init__(self, data_dir: str, mode: str = "train",
                 img_dir: str = "images", **kw):
        super().__init__(data_dir, mode=mode, img_dir=img_dir, **kw)
