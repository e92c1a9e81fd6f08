"""The port's host transform stage and loader against irw_tpu's (PIL), bit
for bit.

Each op of ``irw_tpu_torch.transforms.host`` runs beside
``irw_tpu.transforms.pipeline.HostTransform`` on the same seeded uint8
images (sizes 5-300), the same ``np.random.RandomState`` draws (crop boxes,
jitter factors, flips) and, for the train ops, both ``train`` settings:
the images must be equal and each rng left in the same state.  The
pipelines of ``configs/transform/voc_swt.yaml`` go through both packages'
``EpochLoader`` at ``num_workers`` 0 and 3.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import numpy as np
import pytest
from PIL import Image

from irw_tpu.data.loader import EpochLoader as JaxEpochLoader
from irw_tpu.data.synthetic import SyntheticVOCDataset as JaxSyntheticVOC
from irw_tpu.transforms.pipeline import HostTransform as JaxHostTransform
from irw_tpu.transforms.pipeline import build_transforms as jax_build_transforms
from irw_tpu_torch.data import EpochLoader, SyntheticVOCDataset, get_dataset
from irw_tpu_torch.samplers import RandomSampler
from irw_tpu_torch.transforms import HostTransform, build_transforms
from irw_tpu_torch.transforms.host import BICUBIC, BILINEAR, enhance, resize
from test_torch_multi_dino import YAML

CONFIGS = YAML.parents[1]
JITTER = {"brightness": 0.25, "contrast": 0.25, "saturation": 0.25, "hue": 0}


def _voc_swt():
    from irw_tpu_torch.config.yaml_lite import load

    return load(CONFIGS / "transform/voc_swt.yaml")


def _image(rng, h, w):
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _both(ops, img, seed, train):
    """The op list through both packages from one seed: (ours, ref, the two
    rngs' next draws)."""
    r_ours, r_ref = np.random.RandomState(seed), np.random.RandomState(seed)
    ours = HostTransform(ops)(img, r_ours, train)
    ref = JaxHostTransform(ops)(Image.fromarray(img), r_ref, train)
    return ours, ref, (r_ours.randint(1 << 30), r_ref.randint(1 << 30))


@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
def test_resize_matches_pil(filt):
    """``Image.resize`` over 150 random (in, out) size pairs between 5 and 300."""
    rng = np.random.RandomState(0 if filt == "bilinear" else 1)
    ours_f, pil_f = {"bilinear": (BILINEAR, Image.BILINEAR),
                     "bicubic": (BICUBIC, Image.BICUBIC)}[filt]
    for _ in range(150):
        (h, w), (oh, ow) = rng.randint(5, 301, 2), rng.randint(5, 301, 2)
        img = _image(rng, h, w)
        ref = np.asarray(Image.fromarray(img).resize((int(ow), int(oh)), pil_f))
        np.testing.assert_array_equal(resize(img, ow, oh, ours_f), ref, err_msg=f"{(h, w, oh, ow)}")


def test_resize_window_is_the_crop_of_the_resize():
    """A resize computed only over a crop window equals the crop of PIL's."""
    rng = np.random.RandomState(2)
    for _ in range(40):
        (h, w), (oh, ow) = rng.randint(5, 120, 2), rng.randint(8, 300, 2)
        cw, ch = rng.randint(1, ow + 1), rng.randint(1, oh + 1)
        left, top = rng.randint(0, ow - cw + 1), rng.randint(0, oh - ch + 1)
        img = _image(rng, h, w)
        ref = np.asarray(Image.fromarray(img).resize((int(ow), int(oh)), Image.BILINEAR)
                         .crop((left, top, left + cw, top + ch)))
        np.testing.assert_array_equal(resize(img, ow, oh, BILINEAR, (left, top, cw, ch)), ref)


@pytest.mark.parametrize("kind", ["brightness", "contrast", "saturation"])
def test_enhance_matches_pil(kind):
    """``ImageEnhance`` over 200 random images and factors in [0, 2], and
    the factors 0 and 1."""
    from PIL import ImageEnhance

    cls = {"brightness": ImageEnhance.Brightness, "contrast": ImageEnhance.Contrast,
           "saturation": ImageEnhance.Color}[kind]
    rng = np.random.RandomState(3)
    for i in range(200):
        img = _image(rng, *rng.randint(5, 120, 2))
        factor = (0.0, 1.0)[i] if i < 2 else rng.uniform(0, 2)
        ref = np.asarray(cls(Image.fromarray(img)).enhance(factor))
        np.testing.assert_array_equal(enhance(img, kind, factor), ref, err_msg=f"{factor}")


OP_CASES = {
    "Resize": [("Resize", {"size": 37})],
    "Resize_pair": [("Resize", {"size": [29, 61]})],
    "CenterCrop": [("CenterCrop", {"size": 24})],
    "CenterCrop_past_the_edge": [("CenterCrop", {"size": [310, 17]})],
    "RandomCrop": [("RandomCrop", {"size": 20})],
    "RandomCrop_larger": [("RandomCrop", {"size": 302})],
    "RandomResizedCrop": [("RandomResizedCrop", {"size": 32, "scale": [0.16, 1],
                                                 "ratio": [0.75, 1.33]})],
    "RandomResizedCrop_defaults": [("RandomResizedCrop", {"size": 40})],
    "RandomHorizontalFlip": [("RandomHorizontalFlip", {"p": 0.5})],
    "ColorJitter": [("ColorJitter", JITTER)],
    "ColorJitter_two": [("ColorJitter", {"brightness": 0.6, "saturation": 0.9})],
    "FixSize_odd": [("Resize", {"size": 51}), ("FixSize", {"level": 1})],
    "FixSize_level2": [("Resize", {"size": [45, 30]}), ("FixSize", {"level": 2})],
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_host_ops_match_pil(case):
    """Each op on 12 random images of 5-300 pixels a side, with the train
    and the eval setting: equal pixels, and the rng left where PIL's is."""
    rng = np.random.RandomState(sorted(OP_CASES).index(case))
    for i in range(12):
        img = _image(rng, *rng.randint(5, 301, 2))
        for train in (True, False):
            ours, ref, (a, b) = _both(OP_CASES[case], img, 100 + i, train)
            assert ours.dtype == np.uint8 and ours.shape == ref.shape, (case, i, train)
            np.testing.assert_array_equal(ours, ref, err_msg=f"{case} {i} {train}")
            assert a == b, (case, i, train)


@pytest.mark.parametrize("split", ["train", "test"])
def test_voc_swt_pipeline_matches_pil(split):
    """``configs/transform/voc_swt.yaml``'s host ops over a batch of the
    study's 64² images, drawn as a batch: the same ops, the same images."""
    cfg = _voc_swt()[split]
    ours, _ = build_transforms(cfg, device="cpu")
    ref, _ = jax_build_transforms(cfg)
    assert ours.ops == ref.ops
    images = SyntheticVOCDataset(num_train=12, seed=1).images
    for train in (True, False):
        r_ours, r_ref = np.random.RandomState(9), np.random.RandomState(9)
        batch = ours.batch(list(images), r_ours, train)
        expected = np.stack([ref(Image.fromarray(x), r_ref, train) for x in images])
        assert batch.shape == (12, 224, 224, 3)
        np.testing.assert_array_equal(batch, expected)
        assert r_ours.randint(1 << 30) == r_ref.randint(1 << 30)


@pytest.mark.parametrize("num_workers", [0, 3])
def test_loader_matches_jax(num_workers):
    """voc_swt's train ops with seed + epoch, and the eval walk, through both
    loaders: the same batches in the same order."""
    host, _ = build_transforms(_voc_swt()["train"], device="cpu")
    jhost, _ = jax_build_transforms(_voc_swt()["train"])
    ds, jds = SyntheticVOCDataset(num_train=20, seed=2), JaxSyntheticVOC(num_train=20, seed=2)
    epoch, seed = 3, 333
    batches = RandomSampler(ds, 4, seed=seed).reshuffle(epoch).batches
    order = np.arange(len(ds))
    for train, idx in ((True, batches), (False, [order[i:i + 8] for i in range(0, 20, 8)])):
        ours = list(EpochLoader(ds, idx, host, num_workers=num_workers, prefetch=2, train=train,
                                seed=seed + epoch))
        ref = list(JaxEpochLoader(jds, idx, jhost, num_workers=num_workers, prefetch=2,
                                  train=train, seed=seed + epoch, native=False))
        assert len(ours) == len(ref) == len(idx)
        for a, b in zip(ours, ref):
            for key in ("image", "label", "index"):
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{key} {train}")


def test_file_backed_datasets_name_a8c():
    """Every file-backed dataset of the JAX registry is ported (the landmarks
    are held in ``tests/test_torch_landmarks.py``); an unknown name still
    raises."""
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset("NoSuchDataset")
