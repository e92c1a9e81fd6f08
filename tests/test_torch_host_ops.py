"""The host ops ported last (ROADMAP A8c) against irw_tpu's PIL
``HostTransform`` and this machine's Pillow, bit for bit: ``ColorJitter``
with a hue, ``RandomGrayscale``, ``GaussianBlur`` and ``MultiCrop``.

- ``gaussian_blur`` against ``ImageFilter.GaussianBlur`` (Pillow's three box
  blurs an axis with a fractional radius) at radii 0.1-2.0, on images down
  to one pixel wide (narrower than the box);
- the hue round trip over all 2^24 RGB colours (one 4096 × 4096 image) at
  shifts 0, -26 and +13 through irw_tpu's own ``_color_jitter``, and
  ``hsv_to_rgb`` over all 2^24 HSV triples;
- each op and ``MultiCrop`` through both ``HostTransform``s from one
  ``RandomState``: the images (or crop lists) equal and each rng left in
  the same state; the multi-crop batch keys of both ``EpochLoader``s;
- ``native_plan``'s grayscale and blur steps against irw_tpu's ``plan``,
  and the native route over the port's library in both packages;
- every ``configs/transform`` file built by both ``build_transforms``;
- ``transform=multicrop`` (one crop size, as irw_tpu's ``run`` stacks the
  first batch's crops) through both packages' ``run`` with a narrow
  ConvNeXt in both factories.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn
from flax import traverse_util
from PIL import Image, ImageFilter

import run as jax_run
from irw_tpu.config import compose as jax_compose
from irw_tpu.data.loader import EpochLoader as JaxEpochLoader
from irw_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from irw_tpu.models import convnext as jax_convnext
from irw_tpu.models.retrieval_net import RetrievalNet as JaxRetrievalNet
from irw_tpu.transforms import pipeline as jax_pipeline
from irw_tpu.transforms.pipeline import HostTransform as JaxHostTransform
from irw_tpu_torch import run as port_run
from irw_tpu_torch.bridge import load_jax_loss_params, load_jax_variables
from irw_tpu_torch.config import compose
from irw_tpu_torch.data import EpochLoader, SyntheticDataset
from irw_tpu_torch.models import convnext
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from irw_tpu_torch.transforms import HostTransform, build_transforms
from irw_tpu_torch.transforms.host import (
    gaussian_blur,
    hsv_to_rgb,
    hue_shift,
    native_plan,
    native_plannable,
    rgb_to_hsv,
)
from test_torch_default_runs import LOCAL, check_runs
from test_torch_native_loader import (  # noqa: F401
    BATCHES,
    jax_on_port_library,
    library,
    voc,
)
from test_torch_vit import randomize

MULTICROP = {"size_crops": [32, 16], "nmb_crops": [2, 3], "min_scale_crops": [0.5, 0.2],
             "max_scale_crops": [1.0, 0.5]}
JITTER_HUE = {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4, "hue": 0.1}
OP_CASES = {
    "hue": [("ColorJitter", {"hue": 0.3})],
    "jitter_hue": [("ColorJitter", JITTER_HUE)],
    "grayscale": [("RandomGrayscale", {"p": 0.5})],
    "blur": [("GaussianBlur", {"sigma": [0.1, 2.0]})],
    "blur_fixed": [("GaussianBlur", {"sigma": 1.3, "p": 0.7})],
    "pipeline": [("Resize", {"size": 40}), ("RandomResizedCrop", {"size": 24}),
                 ("ColorJitter", JITTER_HUE), ("RandomGrayscale", {"p": 0.3}),
                 ("GaussianBlur", {"p": 0.5}), ("RandomHorizontalFlip", {})],
}


def _image(rng, h, w):
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _photo(rng, h, w):
    """Smooth with noise: a blur and the hue have something to move."""
    yy, xx = np.mgrid[0:h, 0:w]
    arr = np.stack([(xx * 7) % 256, (yy * 5) % 256, ((xx + 2 * yy) * 3) % 256], -1)
    return np.clip(arr + rng.randint(0, 60, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("radius", [0.1, 0.37, 0.9, 1.25, 2.0])
def test_gaussian_blur_matches_pillow(radius):
    """Sizes from 1 × 1 up, widths and heights 1 and 2 below the box's
    radius (up to 1.375 at r = 2), and 20 more radii drawn in [0.1, 2]."""
    rng = np.random.RandomState(int(radius * 100))
    sizes = [(1, 1), (1, 7), (2, 9), (9, 2), (3, 3), (13, 31), (64, 48), (5, 300)]
    radii = [radius] * len(sizes) + list(rng.uniform(0.1, 2.0, 20))
    sizes += [tuple(rng.randint(1, 60, 2)) for _ in range(20)]
    for (h, w), r in zip(sizes, radii):
        img = _image(rng, h, w)
        ref = np.asarray(Image.fromarray(img).filter(ImageFilter.GaussianBlur(float(r))))
        np.testing.assert_array_equal(gaussian_blur(img, float(r)), ref, err_msg=f"{h, w, r}")


@pytest.fixture(scope="module")
def every_colour():
    """All 2^24 RGB colours as one 4096 × 4096 image."""
    code = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([code >> 16, (code >> 8) & 255, code & 255], -1).astype(np.uint8).reshape(
        4096, 4096, 3)


class _Draws:
    """A stand-in RandomState for irw_tpu's ``_color_jitter``: the hue factor
    ``f`` and the identity permutation."""

    def __init__(self, f):
        self.f = f

    def uniform(self, lo, hi):
        return self.f

    def permutation(self, n):
        return np.arange(n)


@pytest.mark.parametrize("factor", [0.0, -0.1, 0.05], ids=["shift0", "shift-26", "shift+13"])
def test_hue_round_trip_matches_jax_on_every_colour(every_colour, factor):
    """irw_tpu's ``_color_jitter`` with a hue alone (Pillow's HSV round trip,
    H + round(f · 255) mod 256) against ``hue_shift`` over every colour."""
    ref = np.asarray(jax_pipeline._color_jitter(Image.fromarray(every_colour), _Draws(factor),
                                                hue=0.5))
    np.testing.assert_array_equal(hue_shift(every_colour, factor), ref)


def test_hsv_conversions_match_pillow_on_every_triple(every_colour):
    """``hsv_to_rgb`` over every (h, s, v) and ``rgb_to_hsv`` over every
    colour, in blocks of rows."""
    ref = np.asarray(Image.fromarray(every_colour, mode="HSV").convert("RGB"))
    hsv = np.asarray(Image.fromarray(every_colour).convert("HSV"))
    for top in range(0, 4096, 256):
        rows = slice(top, top + 256)
        np.testing.assert_array_equal(hsv_to_rgb(every_colour[rows]), ref[rows])
        np.testing.assert_array_equal(rgb_to_hsv(every_colour[rows]), hsv[rows])


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_host_ops_match_jax(case):
    """Each op list over 12 images (5-70 pixels a side) from one seed each,
    in training and at eval (where these ops do nothing): equal images, and
    each rng left in the same state."""
    ops = OP_CASES[case]
    rng = np.random.RandomState(len(case))
    ours_t, ref_t = HostTransform(ops), JaxHostTransform(ops)
    for k in range(12):
        img = _photo(rng, *rng.randint(5, 71, 2))
        for train in (True, False):
            r_ours, r_ref = np.random.RandomState(k), np.random.RandomState(k)
            ours = ours_t(img, r_ours, train)
            ref = np.asarray(ref_t(Image.fromarray(img), r_ref, train))
            np.testing.assert_array_equal(ours, ref, err_msg=f"{case} {k} {train}")
            assert r_ours.randint(1 << 30) == r_ref.randint(1 << 30)


def test_multicrop_matches_jax():
    """``MultiCrop`` (2 × 32² + 3 × 16² crops, colour distortion, blur) on 8
    images: the same list of crops from one rng; at eval the other ops run
    and MultiCrop is skipped."""
    ops = [("Resize", {"size": 24}), ("MultiCrop", MULTICROP)]
    rng = np.random.RandomState(3)
    ours_t, ref_t = HostTransform(ops), JaxHostTransform(ops)
    assert ours_t.multi_crop == ref_t.multi_crop == MULTICROP
    r_ours, r_ref = np.random.RandomState(0), np.random.RandomState(0)
    for k in range(8):
        img = _photo(rng, *rng.randint(20, 90, 2))
        ours, ref = ours_t(img, r_ours, True), ref_t(Image.fromarray(img), r_ref, True)
        assert isinstance(ours, list) and len(ours) == len(ref) == 5
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b, err_msg=f"image {k}")
        np.testing.assert_array_equal(ours_t(img, r_ours, False),
                                      ref_t(Image.fromarray(img), r_ref, False))
    assert r_ours.randint(1 << 30) == r_ref.randint(1 << 30)
    # the first batch as irw_tpu's run stacks it (run.py's np.stack): ragged
    # crops do not stack, in either package
    with pytest.raises(ValueError):
        ours_t.batch([img, img], np.random.RandomState(0), True)
    r_ref = np.random.RandomState(0)
    with pytest.raises(ValueError):
        np.stack([ref_t(Image.fromarray(img), r_ref, True) for _ in range(2)])
    one_size = HostTransform([("MultiCrop", dict(MULTICROP, nmb_crops=[2, 0]))])
    assert one_size.batch([img, img], np.random.RandomState(0), True).shape == (2, 2, 32, 32, 3)


@pytest.mark.parametrize("in_memory", [True, False], ids=["memory", "files"])
def test_multicrop_batches_match_jax_loader(in_memory, voc):  # noqa: F811
    """Both ``EpochLoader``s over a multi-crop host stage (after
    ``tests/test_data.py::test_multi_crop_branch``): ``crop_0`` … ``crop_4``
    stacked, ``image`` = ``crop_0``, equal arrays; from stored images and
    from JPEG files (Pillow on both sides)."""
    if in_memory:
        ours_ds = SyntheticDataset(num_samples=16, num_classes=4, image_size=40, seed=2)
        ref_ds = JaxSyntheticDataset(num_samples=16, num_classes=4, image_size=40, seed=2)
        batches = [np.arange(0, 8), np.arange(8, 16)]
    else:
        ours_ds, ref_ds = voc
        batches = BATCHES
    host_ops = [("Resize", {"size": 32}), ("MultiCrop", MULTICROP)]
    ours = list(EpochLoader(ours_ds, batches, HostTransform(host_ops), num_workers=2, seed=4,
                            native=False))
    ref = list(JaxEpochLoader(ref_ds, batches, JaxHostTransform(host_ops), num_workers=2, seed=4,
                              native=False))
    for a, b in zip(ours, ref, strict=True):
        assert set(a) == set(b) == {"image", "label", "index"} | {f"crop_{c}" for c in range(5)}
        assert a["crop_0"].shape == (len(a["index"]), 32, 32, 3)
        assert a["crop_4"].shape == (len(a["index"]), 16, 16, 3)
        assert a["image"] is a["crop_0"]
        for key in b:
            if in_memory:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            else:  # the port's decode of the JPEGs is Pillow's to 1 LSB
                assert np.abs(a[key].astype(int) - b[key]).max() <= 1, key


PIXEL_OPS = [("Resize", {"size": 40}), ("RandomGrayscale", {"p": 0.5}),
             ("GaussianBlur", {"p": 0.5}), ("RandomHorizontalFlip", {})]


def test_native_plan_emits_grayscale_and_blur_as_jax():
    """``native_plan`` over the pixel ops: irw_tpu's ``plan``'s steps,
    ``("grayscale",)`` and ``("blur", r)`` among them; a hue or MultiCrop in
    training gates the op list off the library, as irw_tpu's does."""
    seen = set()
    for seed in range(24):
        for train in (True, False):
            ours = native_plan(PIXEL_OPS, 50, 40, np.random.RandomState(seed), train)
            ref = JaxHostTransform(PIXEL_OPS).plan(50, 40, np.random.RandomState(seed), train)
            assert ours[1:] == ref[1:]
            assert [tuple(s) for s in ours[0]] == [tuple(s) for s in ref[0]], seed
            seen.update(s[0] for s in ours[0])
    assert {"grayscale", "blur"} <= seen
    for ops in (OP_CASES["jitter_hue"], [("MultiCrop", MULTICROP)], PIXEL_OPS):
        for train in (True, False):
            assert native_plannable(ops, train) == JaxHostTransform(ops).native_plannable(train)


def test_native_route_runs_grayscale_and_blur_as_jax(voc, jax_on_port_library):  # noqa: F811
    """The pixel ops on the library's native route in both packages (the
    library's blur is a true Gaussian in both): bit for bit."""
    ours_ds, ref_ds = voc
    loader = EpochLoader(ours_ds, BATCHES, HostTransform(PIXEL_OPS), num_workers=0, seed=6)
    batches = list(loader)
    assert set(loader.routes.values()) == {"native"}
    for a, b in zip(batches, JaxEpochLoader(ref_ds, BATCHES, JaxHostTransform(PIXEL_OPS),
                                            num_workers=0, seed=6), strict=True):
        np.testing.assert_array_equal(a["image"], b["image"])


TRANSFORM_CONFIGS = sorted(p.stem for p in (Path(CONFIG_DIR) / "transform").glob("*.yaml"))


def test_transform_configs_are_counted():
    assert len(TRANSFORM_CONFIGS) == 34 and "multicrop" in TRANSFORM_CONFIGS


@pytest.mark.parametrize("config", TRANSFORM_CONFIGS)
def test_transform_config_builds_as_jax(config):
    """Every ``configs/transform`` file, composed and split by both
    packages' ``build_transforms``: the same host and device op lists."""
    cfg = compose(CONFIG_DIR, "default", [f"transform={config}"]).transform
    assert cfg.to_dict() == jax_compose(CONFIG_DIR, "default",
                                        [f"transform={config}"]).transform.to_dict()
    for split in ("train", "test"):
        host, dev = build_transforms(cfg.get(split) or {}, device="cpu")
        jhost, jdev = jax_pipeline.build_transforms(cfg.get(split) or {})
        assert host.ops == jhost.ops and host.multi_crop == jhost.multi_crop
        assert [(n, tuple(sorted(kw.items()))) for n, kw in dev.ops] == list(jdev.ops)


NARROW = {"depths": (1,), "dims": (16,)}
MULTICROP_RUN = ["dataset=synthetic", "dataset.kwargs.num_samples=32",
                 "dataset.kwargs.image_size=40", "transform=multicrop", "model=convnext",
                 "transform.train.MultiCrop.size_crops=[32,16]",
                 "transform.train.MultiCrop.nmb_crops=[1,0]", "transform.test.Resize.size=32",
                 "model.kwargs.embed_dim=64", "dataset.sampler.kwargs.batch_size=8",
                 "experience.max_iter=1",
                 "experience.step_per_epoch=2", "experience.train_eval_freq=1",
                 "experience.eval_bs=16", "experience.evaluation.top_k=32"] + LOCAL


def _jitted_init(self, rngs, x, train=False):
    """flax's ``init`` as one jitted program: op by op it compiles each
    initializer on its own."""
    return jax.jit(lambda r, x: nn.Module.init(self, r, x, train=train))(rngs, x)


def test_multicrop_composition_runs_as_jax(tmp_path):
    """``transform=multicrop`` with one 32² crop an image (irw_tpu's ``run``
    stacks the first batch's crop lists, so the crops must share a size) and
    ``model=convnext`` narrowed to two stages of one block (16, 32) in both
    factories; both packages' ``run`` from the same weights (LayerScale
    redrawn about 1): the train metrics and the eval to 1e-5."""
    captured = {}
    jax_init, port_init = jax_run.init_train_state, port_run.init_train_state

    def jax_state(*args, **kwargs):
        state = jax_init(*args, **kwargs)
        flat = traverse_util.flatten_dict(randomize({"params": state.params}, 0))
        rng = np.random.RandomState(1)
        for path in flat:
            if path[-1] == "gamma":
                flat[path] = (1.0 + 0.1 * rng.randn(*flat[path].shape)).astype(np.float32)
        variables = traverse_util.unflatten_dict(flat)
        captured.update(variables=variables, loss_params=jax.device_get(state.loss_params))
        return state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]))

    def port_state(model, losses, *args, **kwargs):
        state = port_init(model, losses, *args, **kwargs)
        load_jax_variables(model, captured["variables"])
        load_jax_loss_params(losses, captured["loss_params"])
        return state

    jcfg = jax_compose(CONFIG_DIR, "default", MULTICROP_RUN + [f"experience.log_dir={tmp_path}/jax"])
    cfg = compose(CONFIG_DIR, "default", MULTICROP_RUN + [f"experience.log_dir={tmp_path}/port"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setattr(jax_convnext, "convnext_tiny", lambda **kw: jax_convnext.ConvNeXt(**NARROW, **kw))
        mp.setattr(convnext, "convnext_tiny", lambda **kw: convnext.ConvNeXt(**NARROW, **kw))
        mp.setattr(JaxRetrievalNet, "init", _jitted_init)
        mp.setattr(jax_run, "init_train_state", jax_state)
        mp.setattr(port_run, "init_train_state", port_state)
        jax_metrics = jax_run.run(jcfg)
        metrics = port_run.run(cfg, device="cpu")
    assert cfg.transform.train.MultiCrop.nmb_crops == [1, 0]
    check_runs(tmp_path, cfg, jax_metrics, metrics)
