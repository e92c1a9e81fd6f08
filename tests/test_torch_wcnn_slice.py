"""The DWT serving slice end to end on both packages: synthetic CUB-style
images → DeviceTransform with ``configs/transform/cub_dwt.yaml``'s test
device ops (Normalize → CustomTransform haar level 1: kernel K4's route) →
``RetrievalNet`` with ``configs/model/wcnn_attention_ce.yaml``'s kwargs (four
ResNet-50 branches, CBAM gate, f32) → L2-normalised embeddings → the cosine
``evaluate`` suite with drop-self.

Same weights through the bridge (the flax init with BatchNorm statistics
and biases redrawn).  64² images give 32² subbands.  Embeddings agree to
1e-4 and every metric to 1e-5.  Also holds ``chip_smoke.py``'s inlined
configs to the YAML files they copy.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
from pathlib import Path

import jax
import numpy as np
import yaml

import chip_smoke
from irw_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from irw_tpu.engine.evaluate import compute_embeddings as jax_embeddings
from irw_tpu.engine.evaluate import evaluate as jax_evaluate
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.transforms.pipeline import DEVICE_OPS
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu.transforms.pipeline import HostTransform
from irw_tpu_torch.bridge import load_jax_variables
from irw_tpu_torch.data import SyntheticDataset
from irw_tpu_torch.engine import compute_embeddings, evaluate
from irw_tpu_torch.models import get_model
from irw_tpu_torch.models.wresnet import WCNNAttention
from irw_tpu_torch.transforms import DeviceTransform
from test_torch_resnet import randomize_all

REPO = Path(__file__).resolve().parents[1]
IMG = 64


def load_yaml(rel):
    with open(REPO / rel) as f:
        return yaml.safe_load(f)


def test_chip_smoke_configs_match_the_yaml():
    model = load_yaml("configs/model/wcnn_attention_ce.yaml")
    assert chip_smoke.WCNN == {"name": model["name"], "kwargs": model["kwargs"]}
    test = load_yaml("configs/transform/cub_dwt.yaml")["test"]
    assert chip_smoke.DWT_OPS == [(k, v) for k, v in test.items() if k in DEVICE_OPS]


def test_wcnn_slice_end_to_end_matches_jax():
    cfg = load_yaml("configs/model/wcnn_attention_ce.yaml")
    ops = chip_smoke.DWT_OPS
    ds = SyntheticDataset(num_samples=24, num_classes=4, image_size=IMG, seed=5)
    jds = JaxSyntheticDataset(num_samples=24, num_classes=4, image_size=IMG, seed=5)
    np.testing.assert_array_equal(ds.images, jds.images)

    jdt = JaxDeviceTransform(ops)
    jmodel = jax_get_model(cfg["name"], **cfg["kwargs"])
    variables = jax.jit(lambda r, x: jmodel.init(r, x, train=True))(
        {"params": jax.random.PRNGKey(0)}, jdt(jds.images[:2]))
    variables = randomize_all(variables, 7)
    model = get_model(cfg["name"], device="cpu", **cfg["kwargs"])
    assert isinstance(model, WCNNAttention) and model.ce
    load_jax_variables(model, variables)

    dt = DeviceTransform(ops, device="cpu")
    host = HostTransform([("Resize", {"size": IMG})])  # same size: PIL copies
    apply_fn = lambda v, x: jmodel.apply(v, x, train=False)  # noqa: E731
    emb, labels = compute_embeddings(model, ds, dt, batch_size=8, device="cpu")
    jemb, jlabels = jax_embeddings(apply_fn, variables, jds, host, jdt, batch_size=8,
                                   num_workers=0)
    np.testing.assert_array_equal(labels, jlabels)
    assert emb.shape == (24, 2048)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=0, atol=1e-4)

    ours = evaluate(model, ds, dt, batch_size=8, distance_metric="cosine", device="cpu")
    ref = jax_evaluate(apply_fn, variables, jds, host, jdt, batch_size=8, num_workers=0,
                       distance_metric="cosine")
    assert set(ours) == set(ref)
    assert not any("bit" in key or "hash" in key for key in ours)  # no Hamming statistics
    for key in ref:
        assert abs(ours[key] - ref[key]) <= 1e-5, key
