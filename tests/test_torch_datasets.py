"""The port's file-backed datasets against irw_tpu's, on trees the test
writes: VOC (the three root layouts, an id without annotation, a broken
XML), the MIRFlickr/COCO/NUS-WIDE manifests (both file formats, the DSCH
``dbase``/``query`` stems, NUS-WIDE's ``images/``), the CIFAR pickles
(CIFAR-10 at full size, random bytes, so ``Cifar10Retrieval``'s seeded
100/500 split per class is the real one), CUB-200 (classes on both sides of
100), SOP, In-Shop, iNaturalist, the folder datasets, ImageNet-100 and
``ImageFolderDataset`` with each split.

Each dataset's ``paths``, ``labels``, ``super_labels``, ``instance_dict``,
``super_dict``, ``my_at_R`` and mode equal irw_tpu's, for every mode; so do
both kinds of ``subset``, the registry, and every ``configs/dataset`` file
but the landmarks' through both ``compose`` and ``Getter``.  Nothing is
decoded here but the CUB job's first batch (``load_image`` and the host
stage against irw_tpu's PIL route, to 1 LSB, and the device stage's bands).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import pickle
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from irw_tpu.config import compose as jax_compose
from irw_tpu.data import base as jax_base
from irw_tpu.data.registry import DATASET_REGISTRY as JAX_REGISTRY
from irw_tpu.data.registry import get_dataset as jax_get_dataset
from irw_tpu.getter import Getter as JaxGetter
from irw_tpu_torch.config import compose
from irw_tpu_torch.data import (
    DATASET_REGISTRY,
    BaseDataset,
    InMemoryDataset,
    get_dataset,
    subset,
)
from irw_tpu_torch.getter import Getter
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from test_torch_native_loader import pattern, write_image, write_voc_tree

ALL_MODES = ("train", "query", "test", "gallery", "database")


def assert_same(ours, ref):
    """The contract's fields; the port's synthetic sets keep no paths."""
    assert type(ours).__name__ == type(ref).__name__ and len(ours) == len(ref)
    if not type(ours).__name__.startswith("Synthetic"):
        assert ours.paths == ref.paths and ours.mode == ref.mode
    np.testing.assert_array_equal(ours.labels, ref.labels)
    assert ours.labels.dtype == ref.labels.dtype and ours.labels.shape == ref.labels.shape
    if ref.super_labels is None:
        assert ours.super_labels is None and ours.super_dict is None
    else:
        np.testing.assert_array_equal(ours.super_labels, ref.super_labels)
        if not ref.multi_label:  # neither package groups multi-label vectors by super label
            assert ours.super_dict == ref.super_dict
    if len(ref):
        assert ours.instance_dict == ref.instance_dict and ours.my_at_R == ref.my_at_R
    if hasattr(ref, "images"):
        assert ours.images.shape == ref.images.shape and np.array_equal(ours.images, ref.images)


def both(name, **kwargs):
    return get_dataset(name, **kwargs), jax_get_dataset(name, **kwargs)


def _lines(path, lines):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("".join(f"{line}\n" for line in lines))


def _touch(root, rels):
    for rel in rels:
        Path(root, rel).parent.mkdir(parents=True, exist_ok=True)
        Path(root, rel).write_bytes(b"")


def write_manifests(root, n_classes, rs, single_file, stems, img_dir=""):
    """``<stem>_img.txt`` + ``<stem>_label.txt``, or ``<stem>.txt`` lines of
    ``<file> <l0> ...``, for the stems of train, query and gallery."""
    for stem, n in zip(stems, (10, 4, 14)):
        rels = [f"im/{stem}_{i}.jpg" for i in range(n)]
        labels = [" ".join(map(str, rs.randint(0, 2, n_classes))) for _ in range(n)]
        if single_file:
            _lines(Path(root, f"{stem}.txt"), [f"{r} {l}" for r, l in zip(rels, labels)] + [""])
        else:
            _lines(Path(root, f"{stem}_img.txt"), rels)
            _lines(Path(root, f"{stem}_label.txt"), labels)
        _touch(Path(root, img_dir), rels)
    return str(root)


def write_cub(root, rs, image_files=False, per_class=6):
    """CUB-200's ``images.txt`` / ``image_class_labels.txt`` over classes 1-4
    and 101-104, ids out of order; with ``image_files`` the JPEGs too."""
    classes = [1, 2, 3, 4, 101, 102, 103, 104]
    entries = [(c, k) for c in classes for k in range(per_class)]
    ids = rs.permutation(len(entries)) + 1
    _lines(Path(root, "images.txt"),
           [f"{i} {c:03d}.Bird_{c}/Bird_{c}_{k:04d}.jpg" for i, (c, k) in zip(ids, entries)])
    _lines(Path(root, "image_class_labels.txt"), [f"{i} {c}" for i, (c, _) in zip(ids, entries)])
    for n, (c, k) in enumerate(entries):
        path = Path(root, "images", f"{c:03d}.Bird_{c}", f"Bird_{c}_{k:04d}.jpg")
        path.parent.mkdir(parents=True, exist_ok=True)
        if image_files:
            write_image(path, pattern(rs, int(rs.randint(40, 97)), int(rs.randint(30, 65)), n))
    return str(root)


def write_folders(root, rs):
    for c, name in enumerate(("n02085620-Chihuahua", "n02085782-Japanese_spaniel", "banded",
                              "zigzagged", "empty_class")):
        n = 0 if name == "empty_class" else 3 + c
        _touch(root, [f"{name}/img_{i}.{('jpg', 'JPEG', 'png', 'bmp')[i % 4]}" for i in range(n)])
        _touch(root, [f"{name}/notes.txt"])
    return str(root)


def write_cifar10(root):
    d = Path(root, "cifar-10-batches-py")
    d.mkdir(parents=True)
    rs = np.random.RandomState(10)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rs.randint(0, 256, (10000, 3072), np.uint8),
                 b"labels": rs.randint(0, 10, 10000).tolist()}
        with open(d / name, "wb") as f:
            pickle.dump(batch, f)
    return str(root)


def write_cifar100(root):
    d = Path(root, "cifar-100-python")
    d.mkdir(parents=True)
    rs = np.random.RandomState(100)
    for name, n in (("train", 600), ("test", 200)):
        fine = rs.randint(0, 100, n)
        batch = {b"data": rs.randint(0, 256, (n, 3072), np.uint8), b"fine_labels": fine.tolist(),
                 b"coarse_labels": (fine // 5).tolist()}
        with open(d / name, "wb") as f:
            pickle.dump(batch, f)
    return str(root)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One tree of each layout, made once."""
    base = tmp_path_factory.mktemp("datasets")
    rs = np.random.RandomState(0)
    out = {"voc": write_voc_tree(base / "voc", n_train=8, n_val=4, special={})}
    # an id with no annotation and one whose XML does not parse: both skipped
    voc = base / "voc" / "VOCdevkit" / "VOC2012"
    with open(voc / "ImageSets/Main/train.txt", "a") as f:
        f.write("2008_missing\n2008_broken\n")
    (voc / "Annotations" / "2008_broken.xml").write_text("<annotation><object>")
    out["mirflickr"] = write_manifests(base / "mirflickr", 38, rs, False,
                                       ("train", "test", "database"))
    out["coco"] = write_manifests(base / "coco", 80, rs, True, ("train", "query", "dbase"))
    out["nuswide"] = write_manifests(base / "nuswide", 21, rs, True, ("train", "query", "dbase"),
                                     img_dir="images")
    out["cub"] = write_cub(base / "cub", rs, image_files=True)
    sop = base / "sop"
    for split, offset in (("train", 0), ("test", 10)):
        _lines(sop / f"Ebay_{split}.txt", ["image_id class_id super_class_id path"] + [
            f"{i + 1} {offset + 2 * (i // 3) + 1} {(i // 4) % 3 + 1} bicycle_final/{split}_{i}.JPG"
            for i in range(12)])
    out["sop"] = str(sop)
    _lines(base / "inshop" / "list_eval_partition.txt",
           ["18", "image_name item_id evaluation_status"]
           + [f"img/WOMEN/Dresses/id_{i // 3:08d}/{i:02d}_1_front.jpg id_{100 + i // 3:08d} "
              f"{('train', 'query', 'gallery')[i % 3]}" for i in range(18)])
    out["inshop"] = str(base / "inshop")
    for split in ("train", "test"):
        _lines(base / "inat" / "Inat_dataset_splits" / f"Inaturalist_{split}_set1.txt",
               [f"train_val2018/{('Plantae', 'Aves')[i % 2]}/{5000 + i % 5 + (split == 'test') * 9}"
                f"/{split}_{i}.jpg" for i in range(15)] + [""])
    out["inat"] = str(base / "inat")
    out["folders"] = write_folders(base / "folders", rs)
    for fname, n in (("train.txt", 10), ("query.txt", 4), ("database.txt", 12)):
        _lines(base / "imagenet100" / fname,
               [f"train/n0{i % 3}/{fname[:-4]}_{i}.JPEG {i % 3}" for i in range(n)] + [""])
    out["imagenet100"] = str(base / "imagenet100")
    out["cifar10"] = write_cifar10(base / "cifar10")
    out["cifar100"] = write_cifar100(base / "cifar100")
    out["sfm"] = chip_smoke.write_sfm_tree(base / "sfm", 8, 2, (40, 32), n_val=2, seed=3)
    out["revisited"] = chip_smoke.write_revisited_tree(base / "revisitop", "roxford5k", 3, 10,
                                                       (2, 2, 2), (40, 32), seed=4)
    return out


@pytest.mark.parametrize("layout", ["VOCdevkit", "VOC2012", "itself"])
def test_voc_matches_jax_for_every_root_layout(trees, tmp_path, layout):
    if layout == "VOCdevkit":
        data_dir = trees["voc"]
    else:
        write_voc_tree(tmp_path, n_train=5, n_val=3, special={}, devkit=False)
        data_dir = str(tmp_path) if layout == "VOC2012" else str(tmp_path / "VOC2012")
    for mode in ("train", "gallery", "database", "query", "test", "val"):
        ours, ref = both("VOC2012Hashing", data_dir=data_dir, mode=mode)
        assert_same(ours, ref)
        assert ours.labels.shape[1] == 20 and ours.multi_label
    train, query = get_dataset("VOC2012Hashing", data_dir=data_dir), get_dataset(
        "VOC2012Hashing", data_dir=data_dir, mode="query")
    assert len(train) == (8 if layout == "VOCdevkit" else 5) and len(query) == (
        4 if layout == "VOCdevkit" else 3)


@pytest.mark.parametrize("name,tree", [("MIRFlickrHashing", "mirflickr"), ("COCOHashing", "coco"),
                                       ("NUSWIDEHashing", "nuswide")])
def test_manifest_datasets_match_jax(trees, name, tree):
    for mode in ALL_MODES:
        ours, ref = both(name, data_dir=trees[tree], mode=mode)
        assert_same(ours, ref)
        assert ours.labels.shape[1] == {"MIRFlickrHashing": 38, "COCOHashing": 80,
                                        "NUSWIDEHashing": 21}[name]
        assert all(Path(p).exists() for p in ours.paths)
    assert "/images/im/" in get_dataset("NUSWIDEHashing", data_dir=trees["nuswide"]).paths[0]


@pytest.mark.parametrize("name,tree,modes", [
    ("Cub200Dataset", "cub", ("train", "test")),
    ("Cub200Indomain", "cub", ("train", "test")),
    ("SOPDataset", "sop", ("train", "test")),
    ("InShopDataset", "inshop", ("train", "query", "gallery")),
    ("INaturalistDataset", "inat", ("train", "test")),
    ("StanfordDog12Dataset", "folders", ("train", "test")),
    ("TexturedDataset", "folders", ("train",)),
    ("ImageNet100Hashing", "imagenet100", ("train", "query", "gallery", "database")),
])
def test_image_datasets_match_jax(trees, name, tree, modes):
    for mode in modes:
        for seed in (0, 42):
            ours, ref = both(name, data_dir=trees[tree], mode=mode, seed=seed)
            assert_same(ours, ref)
            assert len(ours)


def test_cub_splits_classes_at_100(trees):
    train, test = (get_dataset("Cub200Dataset", data_dir=trees["cub"], mode=m)
                   for m in ("train", "test"))
    assert sorted(train.instance_dict) == sorted(test.instance_dict) == [0, 1, 2, 3]
    assert all("/00" in p for p in train.paths) and all("/10" in p for p in test.paths)


@pytest.mark.parametrize("kwargs", [
    {"mode": "all"}, {"mode": "train"}, {"mode": "test"},
    {"mode": "train", "split": "in_domain", "seed": 3},
    {"mode": "test", "split": "in_domain", "holdout": 0.25},
    {"mode": "test", "split": "in_domain", "holdout": 0},
], ids=["all", "disjoint_train", "disjoint_test", "in_domain_train", "in_domain_test",
        "holdout_0"])
def test_image_folder_matches_jax(trees, kwargs):
    assert_same(*both("ImageFolderDataset", data_dir=trees["folders"], **kwargs))


def test_image_folder_refuses_as_jax(tmp_path):
    with pytest.raises(FileNotFoundError):
        get_dataset("ImageFolderDataset", data_dir=str(tmp_path))
    _touch(tmp_path, ["only/a.jpg"])
    with pytest.raises(ValueError, match="class_disjoint"):
        get_dataset("ImageFolderDataset", data_dir=str(tmp_path))
    with pytest.raises(ValueError, match="unknown split"):
        get_dataset("ImageFolderDataset", data_dir=str(tmp_path), split="random")
    assert len(get_dataset("ImageFolderDataset", data_dir=str(tmp_path), mode="all")) == 1


def test_cifar10_retrieval_split_matches_jax(trees):
    """The seeded 100 queries and 500 train images a class, the database all
    but the queries, and plain CIFAR-10's 50k/10k, with their images."""
    sets = {}
    for mode in ("train", "query", "gallery"):
        ours, ref = both("Cifar10Retrieval", data_dir=trees["cifar10"], mode=mode, seed=42)
        assert_same(ours, ref)
        assert isinstance(ours, InMemoryDataset) and ours.images.shape[1:] == (32, 32, 3)
        sets[mode] = ours
    assert len(sets["query"]) == 1000 and len(sets["train"]) == 5000
    assert len(sets["gallery"]) == 59000
    assert {len(v) for v in sets["query"].instance_dict.values()} == {100}
    assert {len(v) for v in sets["train"].instance_dict.values()} == {500}
    for mode in ("train", "test"):
        ours, ref = both("CifarDataset", data_dir=trees["cifar10"], mode=mode)
        assert_same(ours, ref)
        assert len(ours) == (50000 if mode == "train" else 10000)
        np.testing.assert_array_equal(ours.load_image(3), np.asarray(ref.load_image(3)))


def test_cifar100_retrieval_matches_jax(trees):
    for mode in ("train", "test"):
        ours, ref = both("Cifar100RetrievalDataset", data_dir=trees["cifar100"], mode=mode)
        assert_same(ours, ref)
        assert ours.super_dict and (ours.labels < 50).all() == (mode == "train")


def test_subset_of_both_kinds_matches_jax(trees):
    idx = [5, 0, 3, 3]
    ours, ref = both("VOC2012Hashing", data_dir=trees["voc"], mode="train")
    assert_same(subset(ours, idx), jax_base.subset(ref, idx))
    assert_same(subset(ours, idx, mode="eval"), jax_base.subset(ref, idx, mode="eval"))
    ours, ref = both("Cifar100RetrievalDataset", data_dir=trees["cifar100"])
    sub = subset(ours, idx)
    assert_same(sub, jax_base.subset(ref, idx))
    np.testing.assert_array_equal(sub.load_image(0), ours.images[5])
    ours, ref = both("SOPDataset", data_dir=trees["sop"])
    assert_same(subset(ours, idx), jax_base.subset(ref, idx))


def test_remap_labels_as_jax():
    for raw in (["b", "a", "c", "a", "b"], [7, 3, 3, 100, 7]):
        np.testing.assert_array_equal(BaseDataset.remap_labels(raw),
                                      jax_base.BaseDataset.remap_labels(raw))


def test_registry_holds_every_jax_dataset_but_the_landmarks():
    """Every dataset of the JAX registry, the landmarks too (ROADMAP A8c)."""
    assert set(DATASET_REGISTRY) == set(JAX_REGISTRY)
    for name, cls in DATASET_REGISTRY.items():
        assert cls.__name__ == JAX_REGISTRY[name].__name__


CONFIG_TREES = {
    "cifar": "cifar10", "cifar10": "cifar10", "cifar10_hashing": "cifar10", "cifar100": "cifar100",
    "coco": "coco", "cub": "cub", "cub_indomain": "cub", "cub_mps": "cub",
    "image_folder": "folders", "imagenet100": "imagenet100", "inaturalist": "inat",
    "inshop": "inshop", "mflickr": "mirflickr", "mirflickr": "mirflickr", "nuswide": "nuswide",
    "sdd": "folders", "sop": "sop", "stanforddogs": "folders", "textured": "folders",
    "textured_rdm": "folders", "voc": "voc", "sfm120k": "sfm", "roxford": "revisited"}
SYNTHETIC_CUTS = {
    "synthetic": ["dataset.kwargs.num_samples=30", "dataset.kwargs.image_size=16"],
    "synthetic_hashing": ["dataset.kwargs.num_samples=40", "dataset.kwargs.image_size=16"],
    **{name: ["dataset.kwargs.num_train=30", "dataset.kwargs.num_query=10",
              "dataset.kwargs.image_size=16"]
       for name in ("voc_synthetic", "voc_synthetic_hard", "mirflickr_synthetic")}}
DATASET_CONFIGS = sorted(p.stem for p in (Path(CONFIG_DIR) / "dataset").glob("*.yaml"))


def test_dataset_configs_are_counted():
    assert len(DATASET_CONFIGS) == 28
    assert set(DATASET_CONFIGS) == set(CONFIG_TREES) | set(SYNTHETIC_CUTS)


@pytest.mark.parametrize("config", DATASET_CONFIGS)
def test_dataset_config_composes_and_builds_as_jax(trees, config):
    """Every one of the 28 files builds through ``compose`` and ``Getter``
    (the train set and the eval side) as irw_tpu's."""
    overrides = [f"dataset={config}"] + SYNTHETIC_CUTS.get(
        config, [f"dataset.kwargs.data_dir={trees.get(CONFIG_TREES.get(config))}"])
    cfg = compose(CONFIG_DIR, "default", overrides).dataset
    assert cfg.to_dict() == jax_compose(CONFIG_DIR, "default", overrides).dataset.to_dict()
    (train, evals), (jtrain, jevals) = Getter().get_dataset(cfg), JaxGetter().get_dataset(cfg)
    assert_same(train, jtrain)
    test, jtest = evals["test"], jevals["test"]
    if isinstance(jtest, dict):
        assert set(test) == set(jtest) == {"query", "gallery"}
        for key in jtest:
            assert_same(test[key], jtest[key])
    else:
        assert_same(test, jtest)
    assert len(train)


def test_chip_smoke_file_jobs_compose_and_their_trees_parse(tmp_path, monkeypatch):
    """``chip_smoke.py``'s files phase: its VOC job is the ablation's first,
    its cuts and its CUB job set keys the configs have, and the trees it
    writes (here at 8 + 4 VOC and 2 × (2 + 1) CUB images of 50 × 40) parse
    alike in both packages."""
    import chip_smoke
    from irw_tpu_torch.studies import run_plan

    study = Path(CONFIG_DIR).parent / "studies" / "voc_lambda_ablation.yaml"
    _, job = run_plan.expand_jobs(run_plan.load_plan(str(study)))[0]
    assert chip_smoke.FILES_JOB in job
    cfg = compose(CONFIG_DIR, "default", job + chip_smoke.FILES_CUTS)
    assert (cfg.dataset.name, cfg.dataset.sampler.kwargs.batch_size, cfg.experience.max_iter,
            cfg.experience.evaluation.top_k) == ("VOC2012Hashing", 96, 2, 384)
    assert cfg.model.kwargs.fusion_config.ortho_weight == 0 and chip_smoke.FILES_STEPS == 4
    cub = compose(CONFIG_DIR, "default", chip_smoke.FILES_CUB_JOB)
    assert (cub.dataset.name, cub.dataset.sampler.kwargs.batch_size, cub.model.kwargs.backbone_name,
            cub.loss[0].name) == ("Cub200Dataset", 128, "wcnn_attention_ce",
                                  "MultiCrossEntropyLoss")
    assert chip_smoke.FILES_CUB_STEPS == 2

    for name, value in (("FILES_VOC_TRAIN", 8), ("FILES_VOC_VAL", 4), ("FILES_IMAGE", (50, 40)),
                        ("FILES_CUB_CLASSES", 2), ("FILES_CUB_TRAIN", 2), ("FILES_CUB_TEST", 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    voc, cub_dir = chip_smoke._write_file_trees(str(tmp_path))
    for mode in ("train", "query"):
        ours, ref = both("VOC2012Hashing", data_dir=voc, mode=mode)
        assert_same(ours, ref)
        assert len(ours) == (8 if mode == "train" else 4)
    for mode in ("train", "test"):
        ours, ref = both("Cub200Dataset", data_dir=cub_dir, mode=mode)
        assert_same(ours, ref)
        assert len(ours) == (4 if mode == "train" else 2)
        assert {ours.load_image(i).shape for i in range(len(ours))} <= {(40, 50, 3), (50, 40, 3)}
