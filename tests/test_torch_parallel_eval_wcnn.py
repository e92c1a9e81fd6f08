"""The WCNN's evaluation over a process group (ROADMAP A13a): uint8 images →
``configs/transform/cub_dwt.yaml``'s device ops (Normalize, CustomTransform:
K4's route) → ``wcnn_attention_ce`` on resnet18 branches with the CBAM gate
→ L2-normalised embeddings → the cosine suite, at worlds 2 and 3, against
the single-device port (the first queries' top-k indices over the gathered
embeddings equal, metrics within 1e-6) and ``irw_tpu.engine.evaluate`` on its
8-device mesh (within 1e-5, as ``tests/test_torch_wcnn_slice.py`` holds the
single-device paths), weights through the bridge.  Cases: self-retrieval
with drop-self and a tail batch; two levels of class ids with a distractor
set joined to the query set's gallery.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from irw_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from irw_tpu.engine.evaluate import evaluate as jax_evaluate
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu.transforms.pipeline import HostTransform
from irw_tpu_torch.bridge import load_jax_variables
from irw_tpu_torch.data import SyntheticDataset
from irw_tpu_torch.engine import compute_embeddings, evaluate
from irw_tpu_torch.models import get_model
from irw_tpu_torch.transforms import DeviceTransform
from test_torch_resnet import randomize_all
from torch_dist_worker import first_indices, spawn_group

WORLDS = (2, 3)
IMG = 32
NAME, KW = "wcnn_attention_ce", {"attention": "cbam", "backbone": "resnet18", "num_classes": 4}


def _single(n, seed, levels=False):
    return {"kind": "single", "levels": levels,
            "kwargs": {"num_samples": n, "num_classes": 4, "image_size": IMG, "seed": seed}}


# name → (datasets spec, batch size)
CASES = {
    "self_tail": (_single(26, 5), 6),
    "levels_distractor": ({"query": _single(14, 6, True), "gallery": "query",
                           "distractor": _single(10, 7, True)}, 6),
}


def _dataset(spec, jax_side: bool):
    ds = (JaxSyntheticDataset if jax_side else SyntheticDataset)(**spec["kwargs"])
    if spec["levels"]:
        ds.labels = np.stack([ds.labels, ds.labels // 2], axis=1)
    return ds


def _datasets(spec, jax_side: bool):
    if "kind" in spec:
        return _dataset(spec, jax_side)
    query = _dataset(spec["query"], jax_side)
    return {"query": query, "gallery": query,
            "distractor": _dataset(spec["distractor"], jax_side)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jmodel = jax_get_model(NAME, **KW)
    jdt = JaxDeviceTransform(chip_smoke.DWT_OPS)
    variables = jax.jit(lambda r, x: jmodel.init(r, x, train=True))(
        {"params": jax.random.PRNGKey(0)},
        jdt(JaxSyntheticDataset(num_samples=2, image_size=IMG).images))
    variables = randomize_all(variables, 3)
    model = get_model(NAME, device="cpu", **KW)
    load_jax_variables(model, variables)
    workdir = tmp_path_factory.mktemp("groups")
    weights = str(workdir / "wcnn.pt")
    torch.save(model.state_dict(), weights)
    spec = {"name": NAME, "kwargs": KW, "weights": weights}
    tasks = {c: ("evaluate", dict(model=spec, datasets=d, ops=chip_smoke.DWT_OPS, batch_size=b,
                                  distance_metric="cosine"))
             for c, (d, b) in CASES.items()}
    handles = {w: spawn_group(w, workdir / f"world{w}", tasks) for w in WORLDS}

    transform = DeviceTransform(chip_smoke.DWT_OPS, device="cpu")
    apply_fn = jax.jit(lambda v, x: jmodel.apply(v, jnp.asarray(x), train=False))
    host = HostTransform([("Resize", {"size": IMG})])  # same size: PIL copies
    port, ref = {}, {}
    for c, (d, b) in CASES.items():
        port[c] = evaluate(model, _datasets(d, False), transform, batch_size=b,
                           distance_metric="cosine", device="cpu", num_workers=0)
        query = _dataset(d if "kind" in d else d["query"], False)
        port[f"first_{c}"] = first_indices(compute_embeddings(
            model, query, transform, b, device="cpu", num_workers=0)[0], "cosine")
        ref[c] = jax_evaluate(apply_fn, variables, _datasets(d, True), host, jdt, batch_size=b,
                              num_workers=0, distance_metric="cosine")
    return {"groups": {w: h.results() for w, h in handles.items()}, "port": port, "jax": ref}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_wcnn_evaluate_matches_single_device_and_jax(runs, case, world):
    answers = [r[case] for r in runs["groups"][world]]
    for a in answers:
        assert "error" not in a, a.get("traceback")
        assert a["metrics"] == answers[0]["metrics"]
        np.testing.assert_array_equal(a["first"], runs["port"][f"first_{case}"])
    ours, port, ref = answers[0]["metrics"], runs["port"][case], runs["jax"][case]
    assert set(ours) == set(port) == set(ref)
    if case == "levels_distractor":
        assert {"map_level0", "map_level1"} <= set(ours)
    for key in ref:
        assert abs(ours[key] - port[key]) <= 1e-6, key
        assert abs(ours[key] - ref[key]) <= 1e-5, key
