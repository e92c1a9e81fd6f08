#!/usr/bin/env python3
"""How fast the host transform stage runs on this machine's CPUs.

    python3 tools/host_stage_times.py [BATCHES]

The flagship study's host stage (``configs/transform/voc_swt.yaml``'s train
split through ``irw_tpu_torch.transforms.build_transforms``: Resize 256,
RandomResizedCrop 224, ColorJitter, flip) on batches of 96 of the study's
synthetic 64² VOC images, with its train ops and its eval ops (the loop's
eval walks the same stage with ``train=False``):

- ``alone``: one batch after another on the calling thread (median);
- ``threads_N``: BATCHES batches on N threads (N = 1, 2, 4, 8), the wall
  time over their count, as ``EpochLoader``'s threads would run them;
- ``processes_8``: the same on 8 spawned processes that hold the images
  (the batch's indices and seed sent in), timed over a second pass;
- ``pil`` / ``pil_threads_8`` (where Pillow is installed): each image's
  drawn steps run through PIL (the JAX package's host stage), for scale.

Prints one JSON line per measurement, then the host's ``os.cpu_count()``.
Needs no card and imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import multiprocessing
import os
import statistics
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from irw_tpu_torch.config import compose  # noqa: E402
from irw_tpu_torch.data import SyntheticVOCDataset  # noqa: E402
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR  # noqa: E402
from irw_tpu_torch.transforms import HostTransform, build_transforms  # noqa: E402
from irw_tpu_torch.transforms.host import plan  # noqa: E402

BATCH = 96
_WORKER: dict = {}


def _setup(images, ops):
    _WORKER.update(images=images, host=HostTransform(ops))


def _batch(args):
    indices, seed, train = args
    images = _WORKER["images"]
    return _WORKER["host"].batch([images[i] for i in indices], np.random.RandomState(seed),
                                 train).shape


def _pil_batch(host, images, indices, seed, train):
    """Each image's drawn steps through PIL (crop, bilinear/bicubic resize,
    flip, ImageEnhance), as the JAX package's host stage runs them."""
    from PIL import Image, ImageEnhance

    enhancers = {"brightness": ImageEnhance.Brightness, "contrast": ImageEnhance.Contrast,
                 "saturation": ImageEnhance.Color}
    rng = np.random.RandomState(seed)
    out = []
    for i in indices:
        img = Image.fromarray(images[i])
        steps, _, _ = plan(host.ops, img.width, img.height, rng, train)
        for step in steps:
            if step[0] == "crop":
                _, left, top, cw, ch = step
                img = img.crop((left, top, left + cw, top + ch))
            elif step[0] == "resize":
                _, tw, th, filt = step
                img = img.resize((tw, th), Image.BICUBIC if filt else Image.BILINEAR)
            elif step[0] == "flip":
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            else:
                img = enhancers[step[0]](img).enhance(step[1])
        out.append(np.asarray(img))
    return np.stack(out).shape


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_batches = int(argv[0]) if argv else 16
    cfg = compose(CONFIG_DIR, "default", ["transform=voc_swt"]).transform.train
    host, _ = build_transforms(cfg, device="cpu")
    images = SyntheticVOCDataset(num_train=n_batches * BATCH, seed=0).images
    order = np.random.RandomState(0).permutation(len(images))
    batches = [order[b * BATCH:(b + 1) * BATCH] for b in range(n_batches)]
    have_pil = importlib.util.find_spec("PIL") is not None

    def report(split, name, ms):
        print(json.dumps({"split": split, "mode": name, "ms_per_batch": ms, "batch": BATCH}),
              flush=True)

    for train in (True, False):
        split = "train" if train else "eval"
        times = []
        for b in range(4):
            t0 = time.perf_counter()
            host.batch([images[i] for i in batches[b]], np.random.RandomState(b), train)
            times.append((time.perf_counter() - t0) * 1e3)
        report(split, "alone", statistics.median(times))
        for n in (1, 2, 4, 8):
            with ThreadPoolExecutor(n) as pool:
                t0 = time.perf_counter()
                list(pool.map(lambda b: host.batch([images[i] for i in batches[b]],
                                                   np.random.RandomState(b), train),
                              range(n_batches)))
                report(split, f"threads_{n}", (time.perf_counter() - t0) / n_batches * 1e3)
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(8, mp_context=ctx, initializer=_setup,
                                 initargs=(images, host.ops)) as pool:
            # a first pass starts every worker (each imports the package)
            list(pool.map(_batch, [(batches[b], b, train) for b in range(n_batches)]))
            t0 = time.perf_counter()
            list(pool.map(_batch, [(batches[b], b, train) for b in range(n_batches)]))
            report(split, "processes_8", (time.perf_counter() - t0) / n_batches * 1e3)
        if have_pil:
            times = []
            for b in range(4):
                t0 = time.perf_counter()
                _pil_batch(host, images, batches[b], b, train)
                times.append((time.perf_counter() - t0) * 1e3)
            report(split, "pil", statistics.median(times))
            with ThreadPoolExecutor(8) as pool:
                t0 = time.perf_counter()
                list(pool.map(lambda b: _pil_batch(host, images, batches[b], b, train),
                              range(n_batches)))
                report(split, "pil_threads_8", (time.perf_counter() - t0) / n_batches * 1e3)
    print(json.dumps({"cpu_count": os.cpu_count(), "pil": have_pil}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
