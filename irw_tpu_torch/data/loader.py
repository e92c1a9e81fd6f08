"""The epoch loader (port of ``irw_tpu/data/loader.py:21-182``).

Iterates the sampler's batch index lists; each batch is ``{"image": (B, H,
W, 3) uint8, "label", "index"}``, ``index`` being the dataset positions the
XBM memory is keyed on.  A training host stage with ``MultiCrop`` adds
``crop_0`` … ``crop_{n-1}``, each crop's images stacked, and ``image`` is
``crop_0``.  Batch ``b`` draws its augmentations from
``np.random.RandomState(seed * 100003 + b)`` (``train`` selects them).
With ``num_workers`` > 0 the batches are made up to ``prefetch`` ahead on
that many threads and come out in the sampler's order; with 0 each is made
when it is asked for.

Each batch takes one of three routes, recorded in ``routes`` (batch index
→ route):

- ``memory``: an in-memory dataset's stored images, through the host stage
  (``transforms.HostTransform``), or as they are with ``host_transform=None``;
- ``native``: a file-backed dataset whose ``load_image`` is the base one,
  with a host stage the library can plan (``native_plannable``) and the
  library built (``native`` not False/"off"; ``native.get_lib`` logs a
  warning when it does not build): the files are decoded and the
  plans run in the library's threads (one a call when ``num_workers`` > 0),
  samples it cannot decode through ``load_image`` and the same plan.  A
  batch it cannot make (a crop past an image's edge, outputs of two sizes)
  is made on the host route from a fresh ``RandomState`` of the same seed;
- ``host``: ``load_image`` and the numpy host stage, whose pixels are
  Pillow's.

``native_fast_scale`` (default: ``train``) lets JPEGs decode at a reduced
DCT scale where a plan opens with a resize: a few LSB off the full decode.
A file-backed dataset with no host stage is given ``HostTransform()``.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from irw_tpu_torch.data.base import BaseDataset
from irw_tpu_torch.transforms.host import HostTransform, apply, native_plan, native_plannable


class EpochLoader:
    def __init__(self, dataset, batches, host_transform=None, num_workers: int = 8,
                 prefetch: int = 4, train: bool = True, seed: int = 0,
                 native: bool | str = "auto", native_fast_scale: bool | None = None):
        self.dataset = dataset
        self.batches = list(batches)
        self.in_memory = hasattr(dataset, "images")
        if host_transform is None and not self.in_memory:
            host_transform = HostTransform()
        self.host_transform = host_transform
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.train = train
        self.seed = seed
        self.native = native
        self.native_fast_scale = train if native_fast_scale is None else native_fast_scale
        self.routes: dict[int, str] = {}
        self._native_ok: bool | None = None

    def __len__(self):
        return len(self.batches)

    def _native_eligible(self) -> bool:
        if self._native_ok is None:
            ok = (self.native not in (False, "off")
                  and type(self.dataset).load_image is BaseDataset.load_image
                  and getattr(self.dataset, "paths", None) is not None
                  and native_plannable(self.host_transform.ops, self.train))
            if ok:
                from irw_tpu_torch import native

                ok = native.available()
            self._native_ok = bool(ok)
        return self._native_ok

    def _native_batch(self, indices, rng):
        """The batch through the library, or None: the caller makes it on
        the host route from a fresh rng."""
        from irw_tpu_torch import native

        paths, plans, out_size = [], [], None
        for i in indices:
            path = str(self.dataset.paths[int(i)])
            size = native.image_size(path)
            if size is None or size[0] <= 0 or size[1] <= 0:
                img = self.dataset.load_image(int(i))  # the header did not read
                size = (img.shape[1], img.shape[0])
            planned = native_plan(self.host_transform.ops, size[0], size[1], rng, self.train)
            if planned is None:
                return None
            steps, out_w, out_h = planned
            if out_size not in (None, (out_w, out_h)):
                return None
            out_size = (out_w, out_h)
            paths.append(path)
            plans.append(steps)
        if out_size is None:
            return None
        images, status = native.load_batch(
            paths, [native.pack_plan(s) for s in plans], out_size[0], out_size[1],
            n_threads=1 if self.num_workers > 0 else 0, fast_scale=self.native_fast_scale)
        for j in np.nonzero(status)[0]:
            images[j] = apply(self.dataset.load_image(int(indices[j])), plans[j])
        return images

    def _host(self, images, rng):
        """The host stage over ``images``: (B, H, W, 3), or in training with
        ``MultiCrop`` one list of crops an image."""
        host = self.host_transform
        if self.train and host.multi_crop is not None:
            return [host.crops(img, rng) for img in images]
        return host.batch(images, rng, self.train)

    def _images(self, batch_idx: int, indices):
        if self.in_memory and self.host_transform is None:
            return self.dataset.images[indices], "memory"
        if self.in_memory:
            rng = np.random.RandomState(self.seed * 100003 + batch_idx)
            return self._host([self.dataset.images[i] for i in indices], rng), "memory"
        if self._native_eligible():
            images = self._native_batch(indices, np.random.RandomState(
                self.seed * 100003 + batch_idx))
            if images is not None:
                return images, "native"
        rng = np.random.RandomState(self.seed * 100003 + batch_idx)
        return self._host([self.dataset.load_image(int(i)) for i in indices], rng), "host"

    def _load_batch(self, batch_idx: int, indices) -> dict:
        indices = np.asarray(indices)
        images, route = self._images(batch_idx, indices)
        self.routes[batch_idx] = route
        out = {"label": self.dataset.labels[indices], "index": indices}
        if isinstance(images, list):  # multi-crop: same-shaped crops stacked
            for c in range(len(images[0])):
                out[f"crop_{c}"] = np.stack([crops[c] for crops in images])
            out["image"] = out["crop_0"]
        else:
            out["image"] = images
        return out

    def __iter__(self):
        self.routes = {}
        if self.num_workers <= 0:
            for b_idx, indices in enumerate(self.batches):
                yield self._load_batch(b_idx, indices)
            return
        with ThreadPoolExecutor(self.num_workers, thread_name_prefix="loader") as pool:
            pending = deque()
            try:
                for b_idx, indices in enumerate(self.batches):
                    pending.append(pool.submit(self._load_batch, b_idx, indices))
                    if len(pending) > self.prefetch:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:  # the consumer stopped early: drop what has not started
                for future in pending:
                    future.cancel()
