"""The port's evaluation over a process group (ROADMAP A13a) against its
single-device path and the JAX package's 8-device mesh.

Ranks are spawned by ``torch_dist_worker.spawn_group`` on ``gloo`` with a
file rendezvous, one group a world size (2, and 3: the query chunks are not
a multiple of it) running every case of this file; JAX's side is computed
here while they run.  Held:

- ``parallel.eval_sharding.sharded_retrieval_metrics`` (cosine, Hamming on
  ±1 codes with the bit balance, multi-label indicators, ``same_source``
  with ``max_bin_count``, duplicate codes tied across the ranks' query
  chunks): every rank's dict equals the single-device port's bit for bit,
  and is within 1e-5 of ``irw_tpu.parallel.eval_sharding`` on conftest's 8
  devices, as ``tests/test_sharding.py`` holds JAX;
- ``engine.evaluate._metric_suite`` with two levels of class ids, split and
  with ``force_single_device``;
- ``engine.evaluate`` of the small flagship (test_tiny, SWT, Hamming codes)
  with a tail batch, a distractor set, and a batch size the ranks do not
  divide (every rank embeds all of it, with JAX's warning), against the
  single-device port (the first queries' top-k indices over the gathered
  embeddings equal, metrics within 1e-6) and ``irw_tpu.engine.evaluate``
  (weights through the bridge);
- one rank out of memory at its second batch, and one rank out of memory in
  its share of the scoring: every rank retries at half the batch and query
  chunk 256, and the answer is the single-device one there;
- training under the group raises naming A13b; ``replicate`` gives every
  rank rank 0's parameters and buffers; a rank imports nothing of JAX.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.data.synthetic import SyntheticVOCDataset as JaxSyntheticVOC
from irw_tpu.engine.evaluate import evaluate as jax_evaluate
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.parallel.eval_sharding import sharded_retrieval_metrics as jax_sharded
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu.transforms.pipeline import HostTransform
from irw_tpu_torch.bridge import load_jax_variables
from irw_tpu_torch.data import SyntheticVOCDataset
from irw_tpu_torch.engine import compute_embeddings, evaluate
from irw_tpu_torch.engine.evaluate import _metric_suite
from irw_tpu_torch.models import get_model
from irw_tpu_torch.ops.metrics import compute_retrieval_metrics
from irw_tpu_torch.parallel import local_rows, pad_to_multiple, world_size
from irw_tpu_torch.transforms import DeviceTransform
from test_torch_multi_dino import flagship_yaml
from test_torch_vit import randomize
from torch_dist_worker import first_indices, spawn_group

WORLDS = (2, 3)
IMG = 24
OPS = [("SWTTransform", {"level": 1, "wavelet": "haar"})]
VIT = {"depth": 1, "dtype": "float32", "vmem_attn": True}


def _metric_cases() -> dict:
    """name → (query, query labels, gallery, gallery labels, metric kwargs)."""
    rs = np.random.RandomState(0)
    cos_q, cos_g = rs.randn(37, 16).astype(np.float32), rs.randn(53, 16).astype(np.float32)
    codes = np.sign(rs.randn(41, 32)).astype(np.float32)
    ml_q, ml_g = (np.sign(rs.randn(n, 32)).astype(np.float32) for n in (13, 47))
    ml_ql, ml_gl = ((rs.rand(n, 6) > 0.6).astype(np.float32) for n in (13, 47))
    self_g = rs.randn(29, 8).astype(np.float32)
    # four distinct 8-bit codes repeated: every score ties, in every rank's chunks
    patterns = np.sign(rs.randn(4, 8)).astype(np.float32)
    tie_g = patterns[rs.randint(0, 4, 31)]
    tie_q = patterns[np.arange(22) % 4]   # every chunk of 4 holds every code
    return {
        "cosine": (cos_q, rs.randint(0, 5, 37), cos_g, rs.randint(0, 5, 53),
                   {"metric": "cosine", "k": 40, "query_chunk": 8}),
        "hamming_self": (codes, rs.randint(0, 4, 41), codes, None,
                         {"metric": "hamming", "same_source": True,
                          "with_hashing_stats": True, "query_chunk": 16}),
        "multi_label": (ml_q, ml_ql, ml_g, ml_gl,
                        {"metric": "hamming", "k": 47, "with_hashing_stats": True}),
        "same_source_max_bin": (self_g, rs.randint(0, 3, 29), self_g, None,
                                {"metric": "cosine", "same_source": True,
                                 "k": "max_bin_count", "query_chunk": 5}),
        "ties": (tie_q, rs.randint(0, 3, 22), tie_g, rs.randint(0, 3, 31),
                 {"metric": "hamming", "k": 31, "with_hashing_stats": True,
                  "query_chunk": 4}),
    }


def _resolved(case):
    q, ql, g, gl, kw = case
    return q, ql, g, ql if gl is None else gl, kw


def _suite_case():
    rs = np.random.RandomState(1)
    emb = rs.randn(23, 12).astype(np.float32)
    labels = np.stack([rs.randint(0, 6, 23), rs.randint(0, 3, 23)], axis=1)
    return emb, labels


def _flagship():
    """(JAX model, its variables, the port's kwargs, the port model) at
    test_tiny width, one block, f32, attention on the kernel route."""
    cfg = flagship_yaml()
    kw = dict(cfg["kwargs"], vit_kwargs=VIT)
    jmodel = jax_get_model(cfg["name"], **kw)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "band_drop": jax.random.PRNGKey(2)}
    variables = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(
        rngs, jnp.zeros((1, 4, IMG, IMG, 3)))
    variables = randomize(variables, 5)
    port_kw = dict(kw, vit_kwargs=dict(VIT, img_size=IMG))
    model = get_model(cfg["name"], device="cpu", **port_kw)
    load_jax_variables(model, variables)
    return jmodel, variables, port_kw, model, cfg["name"]


def _voc(n, seed, mode="train"):
    return {"kind": "voc", "kwargs": {"num_train": n, "num_query": n, "mode": mode,
                                      "image_size": IMG, "seed": seed}}


# name → (datasets spec, batch size): a tail batch (30 = 2 × 12 + 6), a
# query/gallery/distractor split, and batch 9, which 2 ranks do not divide
EVAL_CASES = {
    "self_tail": (_voc(30, 3), 12),
    "distractor": ({"query": _voc(9, 4, "query"), "gallery": _voc(20, 4),
                    "distractor": _voc(10, 6)}, 6),
    "batch_not_divided": (_voc(22, 7), 9),
}
OOM = {"n": 70, "batch": 64, "chunk": 16}


def _spec_dataset(spec, jax_side: bool):
    cls = JaxSyntheticVOC if jax_side else SyntheticVOCDataset
    return cls(**spec["kwargs"])


def _spec_datasets(spec, jax_side: bool):
    if "kind" in spec:
        return _spec_dataset(spec, jax_side)
    out = {"query": _spec_dataset(spec["query"], jax_side),
           "gallery": _spec_dataset(spec["gallery"], jax_side)}
    if "distractor" in spec:
        out["distractor"] = _spec_dataset(spec["distractor"], jax_side)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through a group of each world size, the single-device
    port and JAX: {"groups": {world: [rank answers]}, "port": ..., "jax": ...}."""
    cases = _metric_cases()
    jmodel, variables, port_kw, model, name = _flagship()
    workdir = tmp_path_factory.mktemp("groups")
    weights = str(workdir / "flagship.pt")
    torch.save(model.state_dict(), weights)
    spec = {"name": name, "kwargs": port_kw, "weights": weights}
    emb, labels = _suite_case()
    tasks = {f"metrics_{c}": ("metrics", dict(query=q, query_labels=ql, gallery=g,
                                              gallery_labels=gl, **kw))
             for c, (q, ql, g, gl, kw) in ((c, _resolved(v)) for c, v in cases.items())}
    tasks.update({f"eval_{c}": ("evaluate", dict(model=spec, datasets=d, ops=OPS, batch_size=b,
                                                 distance_metric="hamming"))
                  for c, (d, b) in EVAL_CASES.items()})
    tasks["suite"] = ("suite", dict(query=emb, query_labels=labels, gallery=emb,
                                    gallery_labels=labels,
                                    cfg={"distance_metric": "cosine", "top_k": None,
                                         "same_source": True, "query_chunk": 7}))
    tasks["suite_forced"] = ("suite", dict(tasks["suite"][1], cfg=dict(
        tasks["suite"][1]["cfg"], force_single_device=True)))
    tasks["oom"] = ("evaluate", dict(model=spec, datasets=_voc(OOM["n"], 8), ops=OPS,
                                     batch_size=OOM["batch"], distance_metric="hamming",
                                     oom={"at": 2, "on_rank": 1}))
    tasks["oom_metric"] = ("evaluate", dict(model=spec, datasets=_voc(OOM["n"], 8), ops=OPS,
                                            batch_size=OOM["batch"], query_chunk=OOM["chunk"],
                                            distance_metric="hamming",
                                            oom_metric={"at": 1, "on_rank": 1}))
    tasks["training"] = ("training", {})
    tasks["replicate"] = ("replicate", {"seed": 11})
    handles = {w: spawn_group(w, workdir / f"world{w}", tasks) for w in WORLDS}

    # the single-device port and JAX while the ranks run
    port, ref = {}, {}
    for c, case in cases.items():
        q, ql, g, gl, kw = _resolved(case)
        port[f"metrics_{c}"] = compute_retrieval_metrics(
            torch.from_numpy(q), torch.from_numpy(ql), torch.from_numpy(g),
            torch.from_numpy(gl), **kw)
        jkw = {key: v for key, v in kw.items() if key != "query_chunk"}
        ref[f"metrics_{c}"] = jax_sharded(q, ql, g, gl, **jkw)
    transform = DeviceTransform(OPS, device="cpu")
    apply_fn = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    host = HostTransform([("Resize", {"size": IMG})])  # same size: PIL copies
    for c, (d, b) in EVAL_CASES.items():
        port[f"eval_{c}"] = evaluate(model, _spec_datasets(d, False), transform, batch_size=b,
                                     distance_metric="hamming", device="cpu", num_workers=0)
        query = _spec_datasets(d if "kind" in d else d["query"], False)
        port[f"first_{c}"] = first_indices(compute_embeddings(
            model, query, transform, b, device="cpu", num_workers=0)[0], "hamming")
        ref[f"eval_{c}"] = jax_evaluate(apply_fn, variables, _spec_datasets(d, True), host,
                                        JaxDeviceTransform(OPS), batch_size=b, num_workers=0,
                                        distance_metric="hamming")
    port["oom"] = evaluate(model, _spec_datasets(_voc(OOM["n"], 8), False), transform,
                           batch_size=OOM["batch"] // 2, query_chunk=256,
                           distance_metric="hamming", device="cpu", num_workers=0)
    cfg = dict(tasks["suite"][1]["cfg"])
    port["suite"] = _metric_suite(torch.from_numpy(emb), labels, torch.from_numpy(emb), labels,
                                  cfg)
    return {"groups": {w: h.results() for w, h in handles.items()}, "port": port, "jax": ref}


def _answers(runs, world, task):
    answers = [r[task] for r in runs["groups"][world]]
    for a in answers:
        assert not (isinstance(a, dict) and "error" in a), a.get("traceback")
    return answers


def _close(ours: dict, ref: dict, tol: float):
    assert set(ours) == set(ref)
    for key, value in ref.items():
        assert abs(ours[key] - value) <= tol, (key, ours[key], value)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(_metric_cases()))
def test_sharded_metrics_match_single_device_and_jax(runs, case, world):
    answers = _answers(runs, world, f"metrics_{case}")
    for a in answers:   # every rank's dict: the single device's, bit for bit
        assert a["metrics"] == runs["port"][f"metrics_{case}"]
    _close(answers[0]["metrics"], runs["jax"][f"metrics_{case}"], 1e-5)


def test_tie_case_ties_across_every_shard_boundary():
    """The ties case's queries hold each code in the query chunks of more
    than one rank at worlds 2 and 3, and every rank ranks a chunk: a tie's
    order is each rank's own, and must still come out the single device's."""
    query, _, _, _, kw = _metric_cases()["ties"]
    chunks = [query[s:s + kw["query_chunk"]] for s in range(0, len(query), kw["query_chunk"])]
    for world in WORLDS:
        per = -(-len(chunks) // world)
        blocks = [np.concatenate(chunks[r * per:(r + 1) * per]) for r in range(world)]
        for code in np.unique(query, axis=0):
            held = [bool((b == code).all(axis=1).any()) for b in blocks]
            assert sum(held) >= 2, (world, code)


@pytest.mark.parametrize("world", WORLDS)
def test_metric_suite_levels_sharded_and_forced(runs, world):
    sharded = _answers(runs, world, "suite")
    forced = _answers(runs, world, "suite_forced")
    assert {"map_level0", "map_level1"} <= set(sharded[0])
    for a, b in zip(sharded, forced):
        assert a == runs["port"]["suite"]   # the query chunks split: the same arithmetic
        assert b == runs["port"]["suite"]   # one device: the same arithmetic


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_flagship_evaluate_matches_single_device_and_jax(runs, case, world):
    answers = _answers(runs, world, f"eval_{case}")
    for a in answers:
        assert a["metrics"] == answers[0]["metrics"]
        np.testing.assert_array_equal(a["first"], runs["port"][f"first_{case}"])
    _close(answers[0]["metrics"], runs["port"][f"eval_{case}"], 1e-6)
    _close(answers[0]["metrics"], runs["jax"][f"eval_{case}"], 1e-5)


def test_one_rank_out_of_memory_makes_every_rank_retry(runs):
    """Rank 1 runs out of memory at its second batch of 32 rows (its block
    of batch 64): both ranks retry at batch 32, blocks of 16, and the answer
    is the single-device one at batch 32 and query chunk 256."""
    answers = _answers(runs, 2, "oom")
    assert [a["batches"] for a in answers] == [[32, 32, 16, 16, 16]] * 2
    for a in answers:
        _close(a["metrics"], runs["port"]["oom"], 1e-6)


def test_one_rank_out_of_memory_in_the_scoring_makes_every_rank_retry(runs):
    """Rank 1 runs out of memory in its first query chunk of 16 (70 queries:
    rank 0 ranks chunks 0-2, rank 1 chunks 3-4): rank 0 finishes its share,
    both retry at batch 32 and query chunk 256 (one chunk, rank 0's), and
    the answer is the single-device one there."""
    answers = _answers(runs, 2, "oom_metric")
    assert [a["metric_calls"] for a in answers] == [[16, 16, 16, 70], [16]]
    for a in answers:
        _close(a["metrics"], runs["port"]["oom"], 1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_training_under_a_group_names_a13b(runs, world):
    (answer, *_) = _answers(runs, world, "training")
    assert set(answer) == {"build_train_step", "run"}
    assert all(msg and "A13b" in msg and f"{world} ranks" in msg for msg in answer.values())


@pytest.mark.parametrize("world", WORLDS)
def test_replicate_gives_every_rank_rank_0s_state(runs, world):
    states = _answers(runs, world, "replicate")
    torch.manual_seed(11)
    net = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    net[1].running_mean.normal_()
    net[1].num_batches_tracked.fill_(5)
    for state in states:
        assert state.keys() == net.state_dict().keys()
        for key, value in net.state_dict().items():
            assert torch.equal(state[key], value), key


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_nothing_of_the_reference(runs, world):
    """A rank runs the port alone: ``torch_dist_worker`` and what it ran
    import no JAX, flax or irw_tpu (the test process does)."""
    assert [r["reference_modules"] for r in runs["groups"][world]] == [[]] * world


def test_local_rows_and_padding_lay_out_as_the_data_axis():
    assert world_size() == 1   # no group in the test process
    assert [local_rows(12, r, 3) for r in range(3)] == [slice(0, 4), slice(4, 8), slice(8, 12)]
    with pytest.raises(ValueError, match="evenly"):
        local_rows(10, 0, 3)
    padded, n = pad_to_multiple(np.ones((7, 2)), 4)
    assert n == 7 and padded.shape == (8, 2) and not padded[7].any()
