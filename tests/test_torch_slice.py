"""The served slice end to end on both packages: synthetic VOC images →
DeviceTransform (Haar SWT) → small flagship MultiDinoHashing (the YAML's
kwargs at depth 2 on 24² images, f32, attention on the kernel route) →
±1 codes → Hamming ``evaluate`` with drop-self.

Same weights through the bridge.  The codes agree exactly, so every metric
agrees to 1e-6.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np

from irw_tpu.data.synthetic import SyntheticVOCDataset as JaxSyntheticVOC
from irw_tpu.engine.evaluate import compute_embeddings as jax_embeddings
from irw_tpu.engine.evaluate import evaluate as jax_evaluate
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu.transforms.pipeline import HostTransform
from irw_tpu_torch.bridge import load_jax_variables
from irw_tpu_torch.data import SyntheticVOCDataset
from irw_tpu_torch.engine import compute_embeddings, evaluate
from irw_tpu_torch.models import get_model
from irw_tpu_torch.transforms import DeviceTransform
from test_torch_multi_dino import flagship_yaml
from test_torch_vit import randomize

IMG = 24  # one 14-pixel patch per band image: CLS + 1 token keeps the test fast
OPS = [("SWTTransform", {"level": 1, "wavelet": "haar"})]


def test_synthetic_voc_images_match():
    ours = SyntheticVOCDataset(num_train=5, num_query=3, image_size=16, mode="query", seed=2)
    ref = JaxSyntheticVOC(num_train=5, num_query=3, image_size=16, mode="query", seed=2)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.labels, ref.labels)


def test_slice_end_to_end_matches_jax():
    check_slice_matches_jax({"depth": 2, "dtype": "float32", "vmem_attn": True})


def check_slice_matches_jax(vit_kwargs):
    """The small flagship with ``vit_kwargs`` on both packages: same
    embeddings and labels, every metric to 1e-6."""
    cfg = flagship_yaml()
    kw = dict(cfg["kwargs"], vit_kwargs=vit_kwargs)
    jmodel = jax_get_model(cfg["name"], **kw)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "band_drop": jax.random.PRNGKey(2)}
    variables = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(
        rngs, jnp.zeros((1, 4, IMG, IMG, 3)))
    variables = randomize(variables, 5)
    model = get_model(cfg["name"], device="cpu",
                      **dict(kw, vit_kwargs=dict(vit_kwargs, img_size=IMG)))
    load_jax_variables(model, variables)

    ds = SyntheticVOCDataset(num_train=36, image_size=IMG, seed=3)
    jds = JaxSyntheticVOC(num_train=36, image_size=IMG, seed=3)
    host = HostTransform([("Resize", {"size": IMG})])  # same size: PIL copies
    jdt = JaxDeviceTransform(OPS)
    apply_fn = lambda v, x: jmodel.apply(v, x, train=False)  # noqa: E731
    dt = DeviceTransform(OPS, device="cpu")

    emb, labels = compute_embeddings(model, ds, dt, batch_size=16, device="cpu")
    jemb, jlabels = jax_embeddings(apply_fn, variables, jds, host, jdt, batch_size=16,
                                   num_workers=0)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(emb.numpy(), np.asarray(jemb))

    ours = evaluate(model, ds, dt, batch_size=16, distance_metric="hamming", device="cpu")
    ref = jax_evaluate(apply_fn, variables, jds, host, jdt, batch_size=16, num_workers=0,
                       distance_metric="hamming")
    assert set(ours) == set(ref)
    for key in ref:
        assert abs(ours[key] - ref[key]) <= 1e-6, key
