"""The port's samplers, datasets and epoch loader against irw_tpu's.

The samplers are numpy index algebra: one (seed, epoch) must give the same
batches in both packages, exactly.  The synthetic datasets must give the
same uint8 images, labels and super-labels, and the index maps the samplers
draw from.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import threading

import numpy as np
import pytest

from irw_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from irw_tpu.data.synthetic import SyntheticVOCDataset as JaxSyntheticVOC
from irw_tpu.samplers import get_sampler as jax_get_sampler
from irw_tpu_torch.data import EpochLoader, SyntheticDataset, SyntheticVOCDataset
from irw_tpu_torch.transforms import HostTransform
from irw_tpu_torch.samplers import (HierarchicalSampler, MPerClassSampler, RandomSampler,
                                    get_sampler)

EPOCHS = (0, 1, 2)


def _datasets(kind):
    """(port, JAX) datasets of one kind at a small size."""
    if kind == "single":
        kw = {"num_samples": 60, "num_classes": 6, "image_size": 8, "seed": 3}
        return SyntheticDataset(**kw), JaxSyntheticDataset(**kw)
    if kind == "voc":
        kw = {"num_train": 50, "image_size": 8, "seed": 3}
        return SyntheticVOCDataset(**kw), JaxSyntheticVOC(**kw)
    kw = {"num_train": 50, "image_size": 16, "seed": 3, "hard": True}
    return SyntheticVOCDataset(**kw), JaxSyntheticVOC(**kw)


SAMPLERS = {
    "random": ("RandomSampler", "voc", {"batch_size": 8}),
    "random_single": ("RandomSampler", "single", {"batch_size": 7, "seed": 5}),
    "m_per_class": ("MPerClassSampler", "single", {"batch_size": 8, "samples_per_class": 4}),
    "m_per_class_multilabel": ("MPerClassSampler", "voc",
                               {"batch_size": 6, "samples_per_class": 2, "seed": 1}),
    "hierarchical": ("HierarchicalSampler", "single",
                     {"batch_size": 8, "samples_per_class": 2, "batches_per_super_pair": 3}),
    "hierarchical_all": ("HierarchicalSampler", "single",
                         {"batch_size": 24, "samples_per_class": 0, "batches_per_super_pair": 2,
                          "seed": 2, "drop_incomplete": False}),
}


@pytest.mark.parametrize("case", sorted(SAMPLERS))
def test_sampler_batches_match_jax(case):
    name, kind, kwargs = SAMPLERS[case]
    ds, jds = _datasets(kind)
    ours, ref = get_sampler(name, ds, **kwargs), jax_get_sampler(name, jds, **kwargs)
    for epoch in EPOCHS:
        ours.reshuffle(epoch)
        ref.reshuffle(epoch)
        assert len(ours) == len(ref) > 0, epoch
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    # another epoch, another order
    assert not all(np.array_equal(a, b) for a, b in
                   zip(ours.reshuffle(0).batches, ref.reshuffle(1).batches))


@pytest.mark.parametrize("kind", ["single", "voc", "hard"])
def test_datasets_match_jax(kind):
    ds, jds = _datasets(kind)
    np.testing.assert_array_equal(ds.images, jds.images)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    np.testing.assert_array_equal(ds.super_labels, jds.super_labels)
    assert ds.images.dtype == np.uint8 and len(ds) == len(jds)
    assert ds.instance_dict == jds.instance_dict
    if kind == "single":
        assert ds.super_dict == jds.super_dict


def test_hard_voc_query_split_matches_jax():
    kw = {"num_query": 12, "mode": "query", "image_size": 16, "seed": 1, "hard": True}
    ds, jds = SyntheticVOCDataset(**kw), JaxSyntheticVOC(**kw)
    np.testing.assert_array_equal(ds.images, jds.images)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    assert len(ds) == 12 and ds.labels.dtype == np.float32
    assert (1 <= ds.labels.sum(1)).all() and (ds.labels.sum(1) <= 3).all()


@pytest.mark.parametrize("num_workers", [0, 3])
def test_epoch_loader_yields_the_sampler_batches(num_workers):
    """In the sampler's order, also with gathers running ahead on threads."""
    ds, _ = _datasets("voc")
    sampler = RandomSampler(ds, 8, seed=2).reshuffle(1)
    loader = EpochLoader(ds, sampler.batches, None, num_workers=num_workers, prefetch=2,
                         train=True, seed=5)
    out = list(loader)
    assert len(out) == len(loader) == len(sampler) == 6
    for batch, indices in zip(out, sampler.batches):
        np.testing.assert_array_equal(batch["index"], indices)
        np.testing.assert_array_equal(batch["image"], ds.images[indices])
        np.testing.assert_array_equal(batch["label"], ds.labels[indices])
        assert batch["image"].shape == (8, 8, 8, 3) and batch["image"].dtype == np.uint8
    batches = iter(loader)  # a consumer that stops early leaves no thread behind
    np.testing.assert_array_equal(next(batches)["index"], sampler.batches[0])
    batches.close()
    assert not [t for t in threading.enumerate() if t.name.startswith("loader")]
    # with a host stage: its images, uint8, in the same batches
    host = HostTransform([("Resize", {"size": 12}), ("CenterCrop", {"size": 10})])
    staged = list(EpochLoader(ds, sampler.batches, host, num_workers=num_workers, prefetch=2))
    assert [b["image"].shape for b in staged] == [(8, 10, 10, 3)] * 6
    assert all(b["image"].dtype == np.uint8 for b in staged)


def test_sampler_arguments_are_checked():
    ds, _ = _datasets("single")
    with pytest.raises(ValueError, match="unknown sampler"):
        get_sampler("DistributedSampler", ds, batch_size=4)
    with pytest.raises(ValueError, match="samples_per_class"):
        MPerClassSampler(ds, batch_size=6, samples_per_class=4)
    with pytest.raises(ValueError, match="multiple"):
        HierarchicalSampler(ds, batch_size=7)
    with pytest.raises(ValueError, match="super-labels"):
        HierarchicalSampler(ds, batch_size=20, samples_per_class=2, nb_categories=10)
