"""``evaluate`` on a half-precision trunk's embeddings, against irw_tpu's."""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import jax.numpy as jnp
import numpy as np
import torch

from irw_tpu_torch.bridge import load_jax_variables
from test_torch_fusion_heads import numpy_init
from test_torch_trunks_half_models import _np


def test_bf16_embeddings_evaluate_as_jax():
    """``evaluate`` reads a bf16 trunk's embeddings as JAX's does.  The
    ResNetCE (depth 18, full width) in bf16 embeds 24 synthetic images into
    bf16 unit rows in both packages, within two bf16 ulps of each other; the
    port's cosine metric suite on JAX's bf16 embeddings gives JAX's metrics
    (1e-5); the port's ``evaluate`` runs end to end on its own.  (The two
    packages' ``evaluate`` differ by whatever ranks a one-ulp difference of
    the embeddings swaps: 0.0035 of map here.)"""
    from irw_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
    from irw_tpu.engine.evaluate import compute_embeddings as jax_embeddings
    from irw_tpu.models import hashing_nets as jax_hashing
    from irw_tpu.ops.metrics import compute_retrieval_metrics as jax_metrics
    from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
    from irw_tpu.transforms.pipeline import HostTransform
    from irw_tpu_torch.data import SyntheticDataset
    from irw_tpu_torch.engine import compute_embeddings, evaluate
    from irw_tpu_torch.models import hashing_nets
    from irw_tpu_torch.ops.metrics import compute_retrieval_metrics
    from irw_tpu_torch.transforms import DeviceTransform

    ops = [("Normalize", {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]})]
    ds = SyntheticDataset(num_samples=24, num_classes=4, image_size=32, seed=5)
    jds = JaxSyntheticDataset(num_samples=24, num_classes=4, image_size=32, seed=5)
    jdt = JaxDeviceTransform(ops)
    jmodel = jax_hashing.ResNetCE(num_classes=5, depth=18, dtype=jnp.bfloat16)
    variables = numpy_init(jmodel, jdt(jnp.asarray(jds.images[:2])), seed=6, train=True)
    model = hashing_nets.ResNetCE(num_classes=5, depth=18, dtype="bfloat16")
    load_jax_variables(model, variables)
    model.eval()
    dt = DeviceTransform(ops, device="cpu")
    host = HostTransform([("Resize", {"size": 32})])  # same size: PIL copies
    apply_fn = lambda v, x: jmodel.apply(v, x, train=False)  # noqa: E731
    emb, labels = compute_embeddings(model, ds, dt, batch_size=8, device="cpu")
    jemb, jlabels = jax_embeddings(apply_fn, variables, jds, host, jdt, batch_size=8,
                                   num_workers=0)
    assert emb.dtype == torch.bfloat16 and str(jemb.dtype) == "bfloat16"
    assert float(np.abs(_np(emb) - np.asarray(jemb, np.float32)).max()) <= 2.0 ** -7
    ref = jax_metrics(jemb, jnp.asarray(jlabels), jemb, jnp.asarray(jlabels), metric="cosine",
                      k=None, same_source=True)
    theirs = torch.from_numpy(np.asarray(jemb, np.float32)).bfloat16()
    ours = compute_retrieval_metrics(theirs, torch.as_tensor(labels), theirs,
                                     torch.as_tensor(labels), metric="cosine", k=None,
                                     same_source=True, with_hashing_stats=False)
    assert set(ours) == set(ref)
    for key in ref:
        assert abs(float(ours[key]) - float(ref[key])) <= 1e-5, key
    res = evaluate(model, ds, dt, batch_size=8, distance_metric="cosine", device="cpu")
    assert all(np.isfinite(v) for v in res.values()) and 0.0 <= res["map_level0"] <= 1.0
