"""The dataset contract (port of ``irw_tpu/data/base.py:11-109``).

``paths``, ``labels`` ((N,) class ids, or (N, C) float multi-label vectors
for VOC, MIRFlickr, COCO and NUS-WIDE), optional ``super_labels`` (N,),
``instance_dict`` (class → indices; for multi-label, class c → the samples
with c active), ``super_dict`` (super → class → indices), ``my_at_R`` (the
largest class: the R of mAP@R) and ``subset``.

``load_image`` decodes a file to an (H, W, 3) uint8 array through the port's
host image loader (``irw_tpu_torch.native``); where that library is not
built, or cannot decode the file (CMYK JPEGs, other containers), it decodes
through Pillow, imported only there, as the JAX package's ``load_image``
decodes every file.  A file that neither reads becomes a black 256 × 256
image, as in the JAX package.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

_JPEG_END = b"\xff\xd9"


def _decode_native(path: str) -> np.ndarray | None:
    """The library's decode of ``path``, or None where it cannot or should
    not: a JPEG that does not end in its end-of-image marker is truncated,
    which libjpeg fills in grey and Pillow refuses."""
    from irw_tpu_torch import native

    size = native.image_size(path)
    if size is None or size[0] <= 0 or size[1] <= 0:
        return None
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(-2, 2)
        if head == b"\xff\xd8" and f.read(2) != _JPEG_END:
            return None
    return native.decode(path, size)


def _decode_pillow(path: str) -> np.ndarray:
    from PIL import Image

    try:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"), dtype=np.uint8)
    except Exception:  # the JAX package's corrupt-image tolerance
        return np.zeros((256, 256, 3), np.uint8)


class BaseDataset:
    """Holds paths and labels; decoding happens in ``load_image`` and the
    loader."""

    paths = None
    super_labels = None
    mode = "train"
    _instance_dict = None
    _super_dict = None

    def __init__(self, paths, labels, super_labels=None, mode: str = "train"):
        self.paths = list(paths)
        self.labels = np.asarray(labels)
        self.super_labels = None if super_labels is None else np.asarray(super_labels)
        self.mode = mode

    def __len__(self):
        return len(self.labels)

    @property
    def multi_label(self) -> bool:
        return self.labels.ndim > 1

    @property
    def instance_dict(self) -> dict:
        """class → indices; for multi-label, class c → the samples with label
        c on."""
        if self._instance_dict is None:
            d = defaultdict(list)
            if self.multi_label:
                for c in range(self.labels.shape[1]):
                    d[c] = np.where(self.labels[:, c] > 0)[0].tolist()
            else:
                for i, lbl in enumerate(self.labels):
                    d[int(lbl)].append(i)
            self._instance_dict = dict(d)
        return self._instance_dict

    @property
    def super_dict(self) -> dict | None:
        """super → class → indices."""
        if self.super_labels is None:
            return None
        if self._super_dict is None:
            d = defaultdict(lambda: defaultdict(list))
            for i, (lbl, sup) in enumerate(zip(self.labels, self.super_labels)):
                d[int(sup)][int(lbl)].append(i)
            self._super_dict = {s: dict(c) for s, c in d.items()}
        return self._super_dict

    @property
    def my_at_R(self) -> int:
        """The largest class's size: the R of mAP@R."""
        return max(len(v) for v in self.instance_dict.values())

    def load_image(self, index: int) -> np.ndarray:
        """Sample ``index`` as an (H, W, 3) uint8 array."""
        path = str(self.paths[index])
        try:
            img = _decode_native(path)
        except OSError:
            img = None
        return _decode_pillow(path) if img is None else img

    def __getitem__(self, index: int) -> dict:
        return {"image": self.load_image(index), "label": self.labels[index],
                "path": None if self.paths is None else self.paths[index]}

    @staticmethod
    def remap_labels(raw_labels) -> np.ndarray:
        """Dense 0..K-1 labels in the raw labels' sort order."""
        lut = {lbl: i for i, lbl in enumerate(sorted(set(raw_labels)))}
        return np.asarray([lut[lbl] for lbl in raw_labels])


class InMemoryDataset(BaseDataset):
    """A dataset whose ``images`` (N, H, W, 3) uint8 are kept in memory:
    ``load_image`` reads them, and the loader hands them to the host stage
    as they are."""

    images: np.ndarray

    def load_image(self, index: int) -> np.ndarray:
        return self.images[index]


def subset(dataset: BaseDataset, indices, mode: str | None = None) -> BaseDataset:
    """A re-indexed shallow copy of ``dataset`` (of its class); in-memory
    datasets carry their images along."""
    indices = np.asarray(indices)
    out = BaseDataset.__new__(type(dataset))
    out.paths = None if dataset.paths is None else [dataset.paths[i] for i in indices]
    out.labels = dataset.labels[indices]
    out.super_labels = None if dataset.super_labels is None else dataset.super_labels[indices]
    out.mode = mode or dataset.mode
    if hasattr(dataset, "images"):
        out.images = dataset.images[indices]
    return out
