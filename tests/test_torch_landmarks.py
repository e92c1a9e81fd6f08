"""Landmark retrieval (ROADMAP A8c and A12's eval protocols) against
irw_tpu: SfM-120k and revisited Oxford/Paris, the junk-corrected mAP,
``evaluate`` with ``gnd``, with a distractor gallery and with its
out-of-memory retry, the distractor getter, ``landmark_bench`` and the
landmark recipe through both packages' ``run``.

The trees are ``chip_smoke.py``'s writers at test size (a roxford5k tree of
4 queries and 24 gallery JPEGs of 48 × 40, gnd 3 easy, 4 hard and 3 junk a
query; an SfM tree of 12 train and 4 val JPEGs in 3 clusters).  ``evaluate``
is held with one tiny model on both sides: a flax ``Dense`` over the
flattened 8² image, carried into ``torch.nn.Linear`` by the bridge.
Tolerances: the batched mAP to 1e-6 against irw_tpu and against the float64
scalar oracle; ``evaluate``'s metrics to 1e-6; the run's metrics to 1e-5
relative (``test_torch_default_runs.check_runs``).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

import chip_smoke
from irw_tpu.config import compose as jax_compose
from irw_tpu.data.registry import get_dataset as jax_get_dataset
from irw_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from irw_tpu.data.synthetic import SyntheticVOCDataset as JaxSyntheticVOC
from irw_tpu.engine import landmark as jax_landmark
from irw_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from irw_tpu.engine.evaluate import evaluate as jax_evaluate
from irw_tpu.getter import Getter as JaxGetter
from irw_tpu.models.baselines import SingleBandNet as JaxSingleBandNet
from irw_tpu.transforms.pipeline import HostTransform as JaxHostTransform
from irw_tpu_torch.benchmarks import landmark_bench
from irw_tpu_torch.bridge import _dense
from irw_tpu_torch.config import compose
from irw_tpu_torch.data import SyntheticDataset, SyntheticVOCDataset, get_dataset
from irw_tpu_torch.engine import evaluate, load_checkpoint_meta
from irw_tpu_torch.engine.landmark import evaluate_cities, landmark_evaluation
from irw_tpu_torch.getter import Getter
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from irw_tpu_torch.transforms import HostTransform
from test_torch_datasets import assert_same
# _no_tensorboard: the autouse fixture that keeps TensorFlow from importing
from test_torch_default_runs import _no_tensorboard, check_runs, run_both  # noqa: F401
from test_torch_host_ops import _jitted_init
from test_torch_native_loader import jax_on_port_library, library  # noqa: F401

IMG, EMB = 8, 16
CITY = "roxford5k"
GND_COUNTS = (3, 4, 3)
HOST = [("Resize", {"size": IMG})]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("landmarks")
    return {"revisited": chip_smoke.write_revisited_tree(root / "revisitop", CITY, 4, 24,
                                                         GND_COUNTS, (48, 40), seed=0),
            "sfm": chip_smoke.write_sfm_tree(root / "sfm", 12, 3, (40, 32), n_val=4, seed=1)}


def _same_gnd(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_sfm120k_matches_jax(trees, mode):
    """Paths ``ims/cid[-2:]/cid[-4:-2]/cid[-6:-4]/cid``, cluster labels; a
    mode other than train or val reads train."""
    ours = get_dataset("SfM120kDataset", data_dir=trees["sfm"], mode=mode)
    assert_same(ours, jax_get_dataset("SfM120kDataset", data_dir=trees["sfm"], mode=mode))
    assert len(ours) == (4 if mode == "val" else 12)
    assert ours.load_image(0).shape == (32, 40, 3)


@pytest.mark.parametrize("mode", ["query", "test", "gallery", "train"])
def test_revisited_matches_jax(trees, mode):
    """``query``/``test`` serve ``qimlist`` and keep the bbx, every other mode
    ``imlist``; identity labels; ``gnd`` and ``city`` as irw_tpu's."""
    ours = get_dataset("RevisitedDataset", data_dir=trees["revisited"], city=CITY, mode=mode)
    ref = jax_get_dataset("RevisitedDataset", data_dir=trees["revisited"], city=CITY, mode=mode)
    assert_same(ours, ref)
    assert ours.city == ref.city == CITY and ours.bbx == ref.bbx
    assert (ours.bbx is None) == (mode in ("gallery", "train"))
    _same_gnd(ours.gnd, ref.gnd)
    assert len(ours) == (4 if mode in ("query", "test") else 24)


def _embeddings(seed, nq=9, ng=60, d=8):
    """Random embeddings with two identical gallery rows (a tie), a zero
    gallery row and a zero query."""
    rs = np.random.RandomState(seed)
    q, g = rs.randn(nq, d).astype(np.float32), rs.randn(ng, d).astype(np.float32)
    g[6], g[7], q[2] = g[5], 0.0, 0.0
    return rs, q, g


def _gnd(rs, nq, ng, counts):
    gnd = []
    for _ in range(nq):
        perm = rs.permutation(ng)
        e, h, j = counts
        gnd.append({"easy": perm[:e], "hard": perm[e:e + h], "junk": perm[e + h:e + h + j]})
    return gnd


@pytest.mark.parametrize("counts", [(1, 1, 0), (3, 4, 3), (10, 12, 15), (0, 6, 2), (0, 0, 5)],
                         ids=["sparse", "small", "dense", "no_easy", "no_positives"])
def test_batched_map_matches_jax_and_the_oracle(counts):
    """Random embeddings at five gnd densities, ties, a zero row and (in
    every case) a query without positives: the port's batched mAP against
    irw_tpu's ``landmark_evaluation`` and the scalar oracle, to 1e-6."""
    rs, q, g = _embeddings(sum(counts))
    gnd = _gnd(rs, len(q), len(g), counts)
    gnd[4] = {"easy": [], "hard": [], "junk": [1, 2]}
    gnd[5] = {"hard": np.array([6]), "junk": np.array([5])}  # the tie, one side junk
    ours = landmark_evaluation(q, g, gnd, device="cpu")
    ref = jax_landmark.landmark_evaluation(q, g, gnd)
    assert set(ours) == set(ref) == {"map_medium", "map_hard"}
    for key in ref:
        assert ours[key] == pytest.approx(ref[key], abs=1e-6), key
        oracle = chip_smoke._map_oracle(q, g, gnd, key[4:])
        assert ours[key] == pytest.approx(oracle, abs=1e-6), key
        assert 0.0 <= ours[key] <= 1.0


def test_batched_map_full_f32_whatever_the_tf32_flag(monkeypatch):
    """The similarity is computed with TF32 off and the flag restored."""
    seen = []
    real = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    rs, q, g = _embeddings(3)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    landmark_evaluation(q, g, _gnd(rs, len(q), len(g), (2, 2, 2)), device="cpu")
    assert seen == [False, False] and torch.backends.cuda.matmul.allow_tf32


class _JaxEmbedder(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.Dense(EMB)(x.reshape(x.shape[0], -1))


class _Embedder(torch.nn.Module):
    """The same Dense; with ``oom_above`` it raises ``torch.OutOfMemoryError``
    on a batch larger than that, with ``fail`` any error it is given."""

    def __init__(self, oom_above=None, fail=None):
        super().__init__()
        self.dense = torch.nn.Linear(IMG * IMG * 3, EMB)
        self.oom_above, self.fail, self.batches = oom_above, fail, []

    def forward(self, x):
        self.batches.append(x.shape[0])
        if self.fail is not None:
            raise self.fail
        if self.oom_above is not None and x.shape[0] > self.oom_above:
            raise torch.OutOfMemoryError("CUDA out of memory (raised by the test)")
        return self.dense(x.reshape(x.shape[0], -1))


@pytest.fixture(scope="module")
def embedder():
    """(JAX apply, its variables, a factory of the port's embedder with the
    same weights)."""
    jmodel = _JaxEmbedder()
    variables = jmodel.init(jax.random.PRNGKey(0), np.zeros((1, IMG, IMG, 3), np.float32))
    weights = {k: torch.from_numpy(np.array(v)) for k, v in
               _dense(variables["params"]["Dense_0"]).items()}

    def port(**kw):
        model = _Embedder(**kw)
        model.dense.load_state_dict(weights)
        return model
    return jax.jit(jmodel.apply), variables, port


def _both(kind, seed, n):
    ours = {"single": SyntheticDataset, "voc": SyntheticVOCDataset}[kind]
    ref = {"single": JaxSyntheticDataset, "voc": JaxSyntheticVOC}[kind]
    size = {"image_size": IMG, "seed": seed}
    if kind == "voc":
        return ours(num_train=n, **size), ref(num_train=n, **size)
    return ours(num_samples=n, num_classes=4, **size), ref(num_samples=n, num_classes=4, **size)


def _evaluate_both(embedder, build, metric="cosine", **kw):
    """``build(port_or_jax)`` → the datasets argument; both evaluates at batch
    8 with an 8² Resize host stage (a copy), no device transform."""
    apply, variables, port = embedder
    ours = evaluate(port(), build(0), batch_size=8, distance_metric=metric, device="cpu",
                    host_transform=HostTransform(HOST), num_workers=0, **kw)
    ref = jax_evaluate(apply, variables, build(1), JaxHostTransform(HOST), None, batch_size=8,
                       num_workers=0, distance_metric=metric, **kw)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        assert ours[key] == pytest.approx(value, abs=1e-6), key
    return ours


def _labels_levels(ds):
    """Two levels of class ids: the class and the class // 2."""
    ds.labels = np.stack([ds.labels, ds.labels // 2], axis=1)
    return ds


DISTRACTOR_CASES = {
    "single_label": ("single", None),
    "multi_label": ("voc", None),
    "multi_level": ("single", _labels_levels),
    "self_gallery": ("single", "self"),
}


@pytest.mark.parametrize("case", sorted(DISTRACTOR_CASES))
def test_evaluate_with_distractors_matches_jax(embedder, case):
    """A distractor set joins the gallery: 1-D labels as -424242, multi-label
    rows all zero, multi-level ids -424242 a level; one dataset as query and
    gallery runs with drop-self (after ``tests/test_engine.py:551, :783``)."""
    kind, extra = DISTRACTOR_CASES[case]

    def build(side):
        (q, jq), (g, jg), (d, jd) = (_both(kind, s, n) for s, n in ((21, 8), (22, 24), (23, 16)))
        q, g, d = (q, g, d) if side == 0 else (jq, jg, jd)
        if callable(extra):
            q, g, d = extra(q), extra(g), extra(d)
        return {"query": q, "gallery": q if extra == "self" else g, "distractor": d}

    metric = "hamming" if kind == "voc" else "cosine"
    ours = _evaluate_both(embedder, build, metric=metric)
    levels = 2 if extra is _labels_levels else 1
    assert {f"map_level{level}" for level in range(levels)} <= set(ours)


@pytest.mark.parametrize("distractor", [False, True], ids=["gnd", "gnd_distractor"])
def test_evaluate_with_gnd_matches_jax(embedder, distractor):
    """A query set carrying ``gnd`` is scored by the landmark protocol,
    distractors appended to its gallery."""
    rs = np.random.RandomState(5)
    gnd = _gnd(rs, 6, 20, (3, 4, 3))

    def build(side):
        (q, jq), (g, jg), (d, jd) = (_both("single", s, n) for s, n in ((31, 6), (32, 20), (33, 8)))
        q, g, d = (q, g, d) if side == 0 else (jq, jg, jd)
        q.gnd = gnd
        return {"query": q, "gallery": g, **({"distractor": d} if distractor else {})}

    ours = _evaluate_both(embedder, build)
    assert set(ours) == {"map_medium", "map_hard"}


def test_evaluate_retries_once_at_half_the_batch_out_of_memory(embedder, caplog):
    """An out-of-memory error above batch 40: the retry at max(64 // 2, 32)
    and a query chunk of 256 gives the batch-32 result."""
    _, _, port = embedder
    ds = SyntheticDataset(num_samples=70, num_classes=4, image_size=IMG, seed=3)
    kw = dict(device="cpu", host_transform=HostTransform(HOST), num_workers=0)
    model = port(oom_above=40)
    out = evaluate(model, ds, batch_size=64, **kw)
    assert model.batches[0] == 64 and set(model.batches[1:]) == {32}
    assert out == evaluate(port(), ds, batch_size=32, query_chunk=256, **kw)
    assert "retrying once at batch 32" in caplog.text
    small = port(oom_above=40)
    assert evaluate(small, ds, batch_size=16, **kw) == evaluate(port(), ds, batch_size=16, **kw)
    assert set(small.batches) == {16}


def test_evaluate_raises_a_second_out_of_memory_and_other_errors(embedder):
    _, _, port = embedder
    ds = SyntheticDataset(num_samples=40, num_classes=4, image_size=IMG, seed=3)
    kw = dict(device="cpu", host_transform=HostTransform(HOST), num_workers=0)
    model = port(oom_above=16)
    with pytest.raises(torch.OutOfMemoryError):
        evaluate(model, ds, batch_size=64, **kw)
    assert model.batches == [64, 32]
    model = port(fail=RuntimeError("not a memory error"))
    with pytest.raises(RuntimeError, match="not a memory error"):
        evaluate(model, ds, batch_size=64, **kw)
    assert model.batches == [64]


@pytest.mark.parametrize("config", ["voc_synthetic", "synthetic"])
def test_getter_distractor_matches_jax(config):
    """``dataset.distractor`` ({name, mode, kwargs}) through both getters: a
    query/gallery family keeps its pair, one test split becomes its own
    query and gallery."""
    cfg = {"name": "SyntheticDataset" if config == "synthetic" else "SyntheticVOCDataset",
           "kwargs": {"image_size": 8, "seed": 1},
           "distractor": {"name": "SyntheticDataset", "mode": "test",
                          "kwargs": {"num_samples": 12, "image_size": 8, "seed": 9}}}
    (_, ours), (_, ref) = Getter().get_dataset(cfg), JaxGetter().get_dataset(cfg)
    test, jtest = ours["test"], ref["test"]
    assert set(test) == set(jtest) == {"query", "gallery", "distractor"}
    assert (test["query"] is test["gallery"]) == (jtest["query"] is jtest["gallery"])
    for key in jtest:
        assert_same(test[key], jtest[key])


def test_landmark_bench_draws_as_jax_and_runs_on_the_cpu():
    """``landmark_bench``'s draws are ``benchmarks/landmark_bench.py``'s
    (queries, gallery, one permutation a query: 120 easy, 130 hard, 150
    junk); ``run`` at a small size gives irw_tpu's maps."""
    q, g, gnd = landmark_bench.make_inputs(5, 500, 16)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(q, rng.randn(5, 16).astype(np.float32))
    np.testing.assert_array_equal(g, rng.randn(500, 16).astype(np.float32))
    perm = rng.permutation(500)
    np.testing.assert_array_equal(gnd[0]["junk"], perm[250:400])
    out = landmark_bench.run(nq=5, ng=500, d=16, iters=1, device="cpu")
    ref = jax_landmark.landmark_evaluation(q, g, gnd)
    assert out["shape"] == [5, 500, 16] and out["device"] == "cpu" and out["ms"] > 0
    for key in ref:
        assert out[key] == pytest.approx(ref[key], abs=1e-6)


def test_evaluate_cities_matches_jax(trees, embedder, jax_on_port_library):  # noqa: F811
    """Both cities' loops over one city's tree: the same keys and maps (the
    JPEGs decoded by the same library in both)."""
    apply, variables, port = embedder
    ours = evaluate_cities(port(), trees["revisited"], cities=(CITY,), batch_size=8,
                           device="cpu", host_transform=HostTransform(HOST), num_workers=0)
    ref = jax_landmark.evaluate_cities(apply, variables, trees["revisited"], cities=(CITY,),
                                       host_transform=JaxHostTransform(HOST), batch_size=8,
                                       num_workers=0)
    assert set(ours) == set(ref) == {f"{CITY}_map_medium", f"{CITY}_map_hard"}
    for key in ref:
        assert ours[key] == pytest.approx(ref[key], abs=1e-6), key


SFM_RECIPE = ["dataset=sfm120k", "transform=sfm120k", "model=deit", "optimizer=sfm120k_deit",
              "loss=roadmap", "experience=landmarks"]


def test_sfm_recipe_composes_and_builds_as_jax(trees):
    """The SfM recipe composes alike; both getters build its train set and
    its eval side, which is ``SfM120kDataset(mode="test")``: the train split
    (``sfm120k.yaml``'s ``evaluation`` list is read by neither, C12); the
    landmark experience asks for split ``rparis6k`` and ``mapH``, which no
    eval gives; ``sub_batch`` 128 is the batch."""
    overrides = SFM_RECIPE + [f"dataset.kwargs.data_dir={trees['sfm']}"]
    cfg, jcfg = compose(CONFIG_DIR, "default", overrides), jax_compose(CONFIG_DIR, "default",
                                                                        overrides)
    assert cfg.to_dict() == jcfg.to_dict()
    (train, evals), (jtrain, jevals) = (Getter().get_dataset(cfg.dataset),
                                        JaxGetter().get_dataset(jcfg.dataset))
    assert_same(train, jtrain)
    assert_same(evals["test"], jevals["test"])
    assert evals["test"].mode == "test" and evals["test"].paths == train.paths
    assert cfg.dataset.evaluation[0].name == "RevisitedDataset" and set(evals) == {"test"}
    exp = cfg.experience
    assert (exp.eval_split, exp.principal_metric, exp.sub_batch) == ("rparis6k", "mapH", 128)
    assert cfg.dataset.sampler.kwargs.batch_size == 128 and exp.sub_batch >= 128
    assert cfg.model.kwargs.backbone_name == "vit_deit_distilled"


ROXFORD_RUN = ["dataset=roxford", "experience=landmarks",
               "transform.train.RandomResizedCrop.size=32", "transform.test.Resize.size=32",
               "dataset.sampler.kwargs.batch_size=8", "experience.max_iter=1",
               "experience.step_per_epoch=2", "experience.eval_bs=8", "experience.num_workers=0",
               "+experience.use_mesh=false"]


def test_roxford_landmarks_runs_as_jax(trees, tmp_path, jax_on_port_library):  # noqa: F811
    """``dataset=roxford experience=landmarks`` through both packages' ``run``
    from the same weights (the default ``single_band_tiny`` on 32² crops,
    two steps of 8 over the gallery, irw_tpu's mesh off): the train metrics and
    ``map_medium``/``map_hard`` of split ``test``; no best score in either
    checkpoint (the principal metric ``mapH`` of split ``rparis6k``, C12)."""
    overrides = ROXFORD_RUN + [f"dataset.kwargs.data_dir={trees['revisited']}"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxSingleBandNet, "init", _jitted_init)
        jax_metrics, metrics, _, cfg = run_both(overrides, tmp_path)
    assert cfg.dataset.name == "RevisitedDataset"
    check_runs(tmp_path, cfg, jax_metrics, metrics)
    assert set(metrics["test"]) == {"map_medium", "map_hard"}
    assert 0 < metrics["test"]["map_medium"] <= 1
    assert load_checkpoint_meta(tmp_path / "port" / "landmarks")["best_score"] is None
    _, meta = jax_load_checkpoint(str(tmp_path / "jax" / "landmarks"))
    assert meta["best_score"] is None


def test_chip_smoke_landmark_recipe_composes():
    """``chip_smoke.py``'s landmarks phase: its SfM job is the recipe with
    keys the configs have."""
    cfg = compose(CONFIG_DIR, "default", chip_smoke.LANDMARK_SFM_JOB)
    assert chip_smoke.LANDMARK_SFM_JOB[:len(SFM_RECIPE)] == SFM_RECIPE
    assert (cfg.dataset.sampler.name, cfg.dataset.sampler.kwargs.batch_size,
            cfg.dataset.sampler.kwargs.samples_per_class) == ("MPerClassSampler", 128, 4)
    assert cfg.experience.max_iter == 1 and cfg.experience.test_eval_freq == 1
    assert chip_smoke.LANDMARK_COUNTS == (70, 4993) and chip_smoke.LANDMARK_GND == (120, 130, 150)
