"""Landmark retrieval datasets (port of ``irw_tpu/data/landmarks.py:19-56``):
SfM-120k for training, revisited Oxford/Paris for evaluation with their
easy / hard / junk ground truth.

Layouts, under ``data_dir``:

- ``SfM120kDataset``: ``retrieval-SfM-120k.pkl`` ({"train" | "val": {"cids",
  "cluster", ...}}) and ``ims/<cid[-2:]>/<cid[-4:-2]>/<cid[-6:-4]>/<cid>``;
  a mode other than ``train`` or ``val`` reads ``train``; the labels are
  the 3D clusters.
- ``RevisitedDataset(city)``: ``<city>/gnd_<city>.pkl`` ({"imlist",
  "qimlist", "gnd"}) and ``<city>/jpg/<name>.jpg``; the ``query`` and
  ``test`` modes serve ``qimlist`` and keep each query's ``bbx`` (stored,
  never cropped), every other mode serves ``imlist``; the labels are the
  positions (identity labels): ``gnd`` drives the evaluation
  (``engine.landmark``).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from irw_tpu_torch.data.base import BaseDataset


class SfM120kDataset(BaseDataset):
    def __init__(self, data_dir: str, mode: str = "train", **kw):
        with open(os.path.join(data_dir, "retrieval-SfM-120k.pkl"), "rb") as f:
            db = pickle.load(f)[mode if mode in ("train", "val") else "train"]
        paths = [os.path.join(data_dir, "ims", cid[-2:], cid[-4:-2], cid[-6:-4], cid)
                 for cid in db["cids"]]
        super().__init__(paths, np.asarray(db["cluster"]), mode=mode)


class RevisitedDataset(BaseDataset):
    def __init__(self, data_dir: str, city: str = "roxford5k", mode: str = "gallery", **kw):
        with open(os.path.join(data_dir, city, f"gnd_{city}.pkl"), "rb") as f:
            cfg = pickle.load(f)
        self.city = city
        self.gnd = cfg["gnd"]
        if mode in ("query", "test"):
            names = cfg["qimlist"]
            self.bbx = [g.get("bbx") for g in self.gnd]
        else:
            names = cfg["imlist"]
            self.bbx = None
        paths = [os.path.join(data_dir, city, "jpg", f"{name}.jpg") for name in names]
        super().__init__(paths, np.arange(len(paths)), mode=mode)
