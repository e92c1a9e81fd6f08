"""The port's host image loader (``irw_tpu_torch/native``), ``load_image``
and the file routes of ``EpochLoader`` against irw_tpu's, on a VOC tree of
small JPEGs that the test writes (40-96 × 30-64), with one CMYK JPEG, one
grayscale JPEG, one PNG named ``.jpg``, one JPEG cut in its scan data and
one cut in its header.

irw_tpu's native route runs the port's built library: its ``get_lib`` is
patched to return it, bound with ``irw_tpu.native._bind``, so the JAX
package's plans, draws and fallbacks run over the same compiled C and its
own build is never run.  Tolerances: the native route bit for bit; the
route through ``load_image`` and the numpy host stage against irw_tpu's PIL
route to 1 LSB (the two decoders; ``test_native_loader.py``'s bound), and
equal where both decode through Pillow.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import irw_tpu.native as jax_native
from irw_tpu.data.loader import EpochLoader as JaxEpochLoader
from irw_tpu.data.registry import get_dataset as jax_get_dataset
from irw_tpu.transforms.pipeline import HostTransform as JaxHostTransform
from irw_tpu_torch import native
from irw_tpu_torch.data import EpochLoader, get_dataset
from irw_tpu_torch.native import build
from irw_tpu_torch.transforms import HostTransform
from irw_tpu_torch.transforms.host import native_plan, native_plannable

REPO = Path(__file__).resolve().parents[1]
VOC_NAMES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat", "chair", "cow",
             "diningtable", "dog", "horse", "motorbike", "person", "pottedplant", "sheep", "sofa",
             "train", "tvmonitor")
# sample index in the train split → how its file is written
SPECIAL = {3: "cmyk", 4: "gray", 5: "png", 6: "cut_scan", 7: "cut_header"}
# configs/transform/voc_swt.yaml's host ops at test size, and its test ops
TRAIN_OPS = [("Resize", {"size": 48}),
             ("RandomResizedCrop", {"size": 32, "scale": [0.16, 1], "ratio": [0.75, 1.33]}),
             ("ColorJitter", {"brightness": 0.25, "contrast": 0.25, "saturation": 0.25, "hue": 0}),
             ("RandomHorizontalFlip", {"p": 0.5})]
TEST_OPS = [("Resize", {"size": 40}), ("CenterCrop", {"size": 32})]
BATCHES = [np.arange(0, 6), np.arange(6, 12), np.array([11, 3, 7, 0, 5, 9])]


def write_image(path, arr, kind="jpeg"):
    img = Image.fromarray(arr)
    if kind == "cmyk":
        img.convert("CMYK").save(path, "JPEG", quality=90)
    elif kind == "gray":
        img.convert("L").save(path, "JPEG", quality=90)
    elif kind == "png":
        img.save(path, "PNG")
    else:
        img.save(path, "JPEG", quality=90)
    if kind.startswith("cut"):
        data = Path(path).read_bytes()
        Path(path).write_bytes(data[:len(data) // 2] if kind == "cut_scan" else data[:100])


def pattern(rs, w, h, k):
    """A smooth image with some noise: JPEG-sized like a photograph's."""
    yy, xx = np.mgrid[0:h, 0:w]
    arr = np.stack([(xx * 3 + k * 10) % 256, (yy * 5) % 256, ((xx + yy) * 2) % 256], -1)
    return np.clip(arr + rs.randint(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)


def write_voc_tree(data_dir, n_train=12, n_val=6, seed=0, sizes=((40, 97), (30, 65)),
                   special=SPECIAL, devkit=True):
    """A VOC2012 tree under ``data_dir`` (in ``VOCdevkit/VOC2012`` or in
    ``VOC2012``): train and val ids, XML annotations of 1-3 objects, JPEGs."""
    root = Path(data_dir, "VOCdevkit", "VOC2012") if devkit else Path(data_dir, "VOC2012")
    for sub in ("ImageSets/Main", "Annotations", "JPEGImages"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    ids = [f"2008_{i:06d}" for i in range(n_train + n_val)]
    (root / "ImageSets/Main/train.txt").write_text("\n".join(ids[:n_train]) + "\n")
    (root / "ImageSets/Main/val.txt").write_text("\n".join(ids[n_train:]) + "\n")
    for k, img_id in enumerate(ids):
        names = rs.choice(VOC_NAMES, rs.randint(1, 4))
        objects = "".join(f"<object><name>{n}</name><difficult>0</difficult></object>"
                          for n in names)
        (root / "Annotations" / f"{img_id}.xml").write_text(
            f"<annotation><filename>{img_id}.jpg</filename>{objects}</annotation>")
        w, h = rs.randint(*sizes[0]), rs.randint(*sizes[1])
        write_image(root / "JPEGImages" / f"{img_id}.jpg", pattern(rs, w, h, k),
                    special.get(k, "jpeg"))
    return str(data_dir)


@pytest.fixture(scope="module")
def library():
    lib = native.get_lib()
    assert lib is not None, build.LAST_BUILD.get("error")
    return lib


@pytest.fixture()
def jax_on_port_library(library, monkeypatch):
    """irw_tpu's native route over the port's library (its build never runs)."""
    jax_native._bind(library)
    monkeypatch.setattr(jax_native, "get_lib", lambda: library)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    data_dir = write_voc_tree(tmp_path_factory.mktemp("voc"))
    return (get_dataset("VOC2012Hashing", data_dir=data_dir),
            jax_get_dataset("VOC2012Hashing", data_dir=data_dir))


def test_library_builds_into_the_ports_own_path(library):
    path = build.lib_path()
    assert path.parent == REPO / "build" / "irw_tpu_torch" and path.exists()
    assert path.name.startswith("libirwloader-") and path.suffix == ".so"
    assert library.irw_abi_version() == 1 and native.available()
    assert build.SRC == REPO / "irw_tpu_torch" / "native" / "src" / "irw_loader.cpp"


def test_source_is_the_jax_packages_copy():
    """The same C++ below the header, comment lines aside."""
    def code(lines):
        return [line for line in lines if not line.lstrip().startswith("//")]

    ours = build.SRC.read_text().splitlines()
    ref = (REPO / "irw_tpu" / "native" / "src" / "irw_loader.cpp").read_text().splitlines()
    assert len(ours) == len(ref) + 2 and code(ours[2:]) == code(ref)
    assert "irw_tpu/native/src/irw_loader.cpp" in ours[0]


def test_two_processes_building_at_once_both_load_a_whole_library(tmp_path):
    code = ("import ctypes, sys\n"
            "from irw_tpu_torch.native import _bind, build\n"
            "path = build.build(sys.argv[1])\n"
            "lib = ctypes.CDLL(path)\n"
            "_bind(lib)\n"
            "print(path, lib.irw_abi_version())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    path = str(build.lib_path(tmp_path))
    assert [out.split() for out, _ in outs] == [[path, "1"], [path, "1"]]
    assert sorted(p.name for p in tmp_path.iterdir()) == [Path(path).name]  # no .tmp left
    ctypes.CDLL(path)


def test_bindings_match_the_jax_packages():
    assert (native.PLAN_STRIDE, native.PLAN_STEP, native._FP16) == (
        jax_native.PLAN_STRIDE, jax_native.PLAN_STEP, jax_native._FP16)
    steps = [("crop", 1, 2, 30, 20), ("resize", 16, 12, 1), ("flip",), ("brightness", 0.8125),
             ("saturation", 1.2), ("grayscale",), ("blur", 1.5)]
    np.testing.assert_array_equal(native.pack_plan(steps), jax_native.pack_plan(steps))


def test_pixel_ops_gate_plannability():
    """ColorJitter without a hue plans; with a hue it does not, in training
    only (``tests/test_native_loader.py:103-112``); MultiCrop plans only at
    eval; every op list as irw_tpu's."""
    cases = [[("Resize", {"size": 48}), ("ColorJitter", {"brightness": 0.4})],
             [("Resize", {"size": 48}), ("ColorJitter", {"hue": 0.1})],
             [("MultiCrop", {}), ("Resize", {"size": 48})],
             [("RandomGrayscale", {"p": 0.2}), ("GaussianBlur", {})], [("Perspective", {})],
             TRAIN_OPS, TEST_OPS, [("FixSize", {"level": 2})]]
    for ops in cases:
        for train in (True, False):
            assert native_plannable(ops, train) == JaxHostTransform(ops).native_plannable(train)
    assert native_plannable(cases[0], True) and native_plannable(cases[0], False)
    assert not native_plannable(cases[1], True) and native_plannable(cases[1], False)
    assert native_plannable(HostTransform(TRAIN_OPS).ops, True)


@pytest.mark.parametrize("ops", [
    TRAIN_OPS, TEST_OPS,
    [("CenterCrop", {"size": 64})],                       # past the edge: no plan
    [("RandomCrop", {"size": 36}), ("RandomHorizontalFlip", {"p": 0.5})],
    [("Resize", {"size": [30, 50]}), ("RandomCrop", {"size": [20, 40]}), ("FixSize", {"level": 3})],
    [("RandomResizedCrop", {"size": 24}), ("ColorJitter", {"contrast": 0.5, "saturation": 0.3})],
], ids=["voc_swt_train", "voc_swt_test", "center_past_edge", "random_crop", "fix_size", "rrc_cj"])
def test_native_plan_is_jax_plan(ops):
    """The same draws, steps and output size as irw_tpu's ``plan``, or None
    where it gives None, over image sizes on both sides of the crops."""
    rs = np.random.RandomState(0)
    for seed in range(24):
        w, h = int(rs.randint(20, 90)), int(rs.randint(20, 90))
        for train in (True, False):
            ours = native_plan(ops, w, h, np.random.RandomState(seed), train)
            ref = JaxHostTransform(ops).plan(w, h, np.random.RandomState(seed), train)
            if ref is None:
                assert ours is None, (w, h, seed, train)
                continue
            assert ours is not None and ours[1:] == ref[1:]
            assert [tuple(s) for s in ours[0]] == [tuple(s) for s in ref[0]], (w, h, seed)


def test_load_image_matches_jax(voc):
    """Every sample: the library's decode against irw_tpu's PIL decode;
    the CMYK JPEG through the Pillow branch, equal; both cut files black
    256 × 256."""
    ours, ref = voc
    for i in range(len(ref)):
        a, b = ours.load_image(i), np.asarray(ref.load_image(i))
        assert a.dtype == np.uint8 and a.shape == b.shape, i
        tol = 0 if SPECIAL.get(i) in ("cmyk", "cut_scan", "cut_header") else 1
        assert np.abs(a.astype(int) - b).max() <= tol, i
    for i in (6, 7):
        assert ours.load_image(i).shape == (256, 256, 3) and not ours.load_image(i).any()
    assert native.decode(ours.paths[3], native.image_size(ours.paths[3])) is None  # CMYK: status 2
    assert ours[0]["path"] == ref[0]["path"] and (ours[0]["label"] == ref[0]["label"]).all()


def test_load_image_without_the_library_decodes_through_pillow(voc, monkeypatch):
    ours, ref = voc
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert not native.available()
    for i in range(len(ref)):
        np.testing.assert_array_equal(ours.load_image(i), np.asarray(ref.load_image(i)))


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_epoch_loader_native_route_is_jax_bit_for_bit(voc, jax_on_port_library, train, workers):
    """Three batches through both loaders' native routes (DCT-scaled decode
    in training, as the default): the CMYK sample through each package's
    fallback, the header-cut file's black image planned from its size."""
    ours, ref = voc
    ops = TRAIN_OPS if train else TEST_OPS
    loader = EpochLoader(ours, BATCHES, HostTransform(ops), num_workers=workers, train=train,
                         seed=5)
    batches = list(loader)
    assert loader.routes == dict.fromkeys(range(len(BATCHES)), "native")
    ref_batches = list(JaxEpochLoader(ref, BATCHES, JaxHostTransform(ops), num_workers=workers,
                                      train=train, seed=5))
    for a, b in zip(batches, ref_batches, strict=True):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])
        np.testing.assert_array_equal(a["index"], b["index"])


def test_epoch_loader_redraws_a_batch_the_library_cannot_make(voc, jax_on_port_library):
    """A crop past the edge of an image (CenterCrop 64 of 40-96 × 30-64):
    no plan, so the batch is made on the host route from a fresh rng, as
    irw_tpu makes it through PIL."""
    ours, ref = voc
    ops = [("CenterCrop", {"size": 64}), ("RandomHorizontalFlip", {"p": 0.5})]
    loader = EpochLoader(ours, BATCHES, HostTransform(ops), num_workers=0, seed=2)
    batches = list(loader)
    assert set(loader.routes.values()) == {"host"}
    for a, b in zip(batches, JaxEpochLoader(ref, BATCHES, JaxHostTransform(ops), num_workers=0,
                                            seed=2), strict=True):
        assert np.abs(a["image"].astype(int) - b["image"]).max() <= 1


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_epoch_loader_host_route_matches_jax_pil(voc, train):
    ours, ref = voc
    ops = TRAIN_OPS if train else TEST_OPS
    loader = EpochLoader(ours, BATCHES, HostTransform(ops), num_workers=2, train=train, seed=7,
                         native=False)
    batches = list(loader)
    assert set(loader.routes.values()) == {"host"}
    for a, b in zip(batches, JaxEpochLoader(ref, BATCHES, JaxHostTransform(ops), num_workers=2,
                                            train=train, seed=7, native=False), strict=True):
        assert np.abs(a["image"].astype(int) - b["image"]).max() <= 1
        np.testing.assert_array_equal(a["label"], b["label"])


def test_file_dataset_without_a_host_stage_is_resized_as_jax(voc, jax_on_port_library):
    """``host_transform=None``: irw_tpu's default ``HostTransform()``
    (Resize 224), on the native route in both."""
    ours, ref = voc
    a, = EpochLoader(ours, BATCHES[:1], num_workers=0, train=False)
    b, = JaxEpochLoader(ref, BATCHES[:1], num_workers=0, train=False)
    assert a["image"].shape == (6, 224, 224, 3)
    np.testing.assert_array_equal(a["image"], b["image"])


def test_a_library_that_does_not_build_is_reported_and_files_decode_through_pillow(
        voc, monkeypatch, caplog):
    """A failed build is logged once, with the compiler's error; the loader
    then takes the host route, equal to irw_tpu's PIL route; and
    IRW_DISABLE_NATIVE switches a fresh process's library off."""
    ours, ref = voc

    def failed_build(build_dir=None):
        build.LAST_BUILD.clear()
        build.LAST_BUILD["error"] = "fatal error: jpeglib.h: No such file or directory"

    monkeypatch.setattr(build, "build", failed_build)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    loader = EpochLoader(ours, BATCHES, HostTransform(TEST_OPS), num_workers=0, train=False)
    with caplog.at_level("WARNING"):
        batches = list(loader)
        list(EpochLoader(ours, BATCHES[:1], HostTransform(TEST_OPS), num_workers=0))
    assert set(loader.routes.values()) == {"host"} and not native.available()
    warned = [r.getMessage() for r in caplog.records if "did not build" in r.getMessage()]
    assert len(warned) == 1 and "jpeglib.h" in warned[0]
    for a, b in zip(batches, JaxEpochLoader(ref, BATCHES, JaxHostTransform(TEST_OPS),
                                            num_workers=0, train=False, native=False)):
        np.testing.assert_array_equal(a["image"], b["image"])
    out = subprocess.run([sys.executable, "-c", "from irw_tpu_torch import native; "
                          "print(native.available())"], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "IRW_DISABLE_NATIVE": "1"}, timeout=120)
    assert out.stdout.strip() == "False"
