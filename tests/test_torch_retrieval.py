"""The port's distances, k-NN and metric suite against irw_tpu's.

Inputs are tie-heavy: ±1 codes of few bits, so Hamming distances collide
constantly and the ranking order among ties (``jax.lax.top_k``: lower index
first) decides every metric.  Indices must match exactly; metrics to 1e-6
(both sum the same f32 terms per query chunk).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.ops.distances import pairwise_distance as jax_pairwise
from irw_tpu.ops.knn import knn as jax_knn
from irw_tpu.ops.metrics import compute_retrieval_metrics as jax_metrics
from irw_tpu.utils.label_matrix import create_label_matrix as jax_label_matrix
from irw_tpu_torch.ops.distances import pairwise_distance
from irw_tpu_torch.ops.knn import knn
from irw_tpu_torch.ops.metrics import compute_retrieval_metrics
from irw_tpu_torch.utils.label_matrix import create_label_matrix

TOL = 1e-6


def _codes(n, bits, seed):
    return np.sign(np.random.RandomState(seed).randn(n, bits)).astype(np.float32)


@pytest.mark.parametrize("metric", ["hamming", "cosine", "ip", "l2", "sql2"])
def test_pairwise_distance(metric):
    rng = np.random.RandomState(0)
    q, g = rng.randn(7, 16).astype(np.float32), rng.randn(11, 16).astype(np.float32)
    if metric == "hamming":
        q, g = np.sign(q), np.sign(g)
    ours = pairwise_distance(torch.from_numpy(q), torch.from_numpy(g), metric).numpy()
    ref = np.asarray(jax_pairwise(jnp.asarray(q), jnp.asarray(g), metric))
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("labels_kind", ["int", "multi"])
def test_label_matrix(labels_kind):
    rng = np.random.RandomState(1)
    labels = (rng.randint(0, 4, 9) if labels_kind == "int"
              else (rng.rand(9, 5) > 0.6).astype(np.float32))
    ours = create_label_matrix(torch.from_numpy(labels)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_label_matrix(jnp.asarray(labels))))


@pytest.mark.parametrize("same_source", [False, True])
def test_knn_tie_order_matches_top_k(same_source):
    codes = _codes(40, 4, 2)  # 4 bits: 16 distinct codes, ties everywhere
    q = torch.from_numpy(codes)
    idx, scores = knn(q, q, k=25, metric="hamming", same_source=same_source, query_chunk=16)
    ref_idx, ref_scores = jax_knn(jnp.asarray(codes), jnp.asarray(codes), k=25,
                                  metric="hamming", same_source=same_source, query_chunk=16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), atol=0)


@pytest.mark.parametrize("same_source,k,labels_kind", [
    (True, None, "multi"), (False, None, "multi"), (True, 10, "multi"),
    (True, "max_bin_count", "int"), (False, 7, "int"),
])
def test_metrics_match_reference(same_source, k, labels_kind):
    rng = np.random.RandomState(3)
    n = 60
    codes = _codes(n, 6, 4)
    labels = ((rng.rand(n, 8) > 0.8).astype(np.float32) if labels_kind == "multi"
              else rng.randint(0, 5, n))
    gallery, glabels = (codes, labels) if same_source else (_codes(45, 6, 5), labels[:45][::-1].copy())
    ours = compute_retrieval_metrics(
        torch.from_numpy(codes), torch.from_numpy(labels), torch.from_numpy(gallery),
        torch.from_numpy(glabels), metric="hamming", k=k, same_source=same_source,
        with_hashing_stats=True, query_chunk=16)
    ref = jax_metrics(jnp.asarray(codes), jnp.asarray(labels), jnp.asarray(gallery),
                      jnp.asarray(glabels), metric="hamming", k=k, same_source=same_source,
                      with_hashing_stats=True, query_chunk=16)
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key] == pytest.approx(ref[key], abs=TOL), key


def test_lone_queries_masked_from_map_but_not_maphashing():
    codes = _codes(6, 8, 6)
    labels = np.array([0, 0, 1, 1, 2, 3])  # queries 4 and 5 are lone
    res = compute_retrieval_metrics(torch.from_numpy(codes), torch.from_numpy(labels),
                                    torch.from_numpy(codes), torch.from_numpy(labels),
                                    metric="hamming", same_source=True,
                                    with_hashing_stats=True)
    assert res["maphashing"] == pytest.approx(res["map"] * 4 / 6)


def test_voc_anchor_map():
    """bench.py:121-122, 276-289: RandomState(0) codes and labels drawn after
    the 64×224×224×3 uint8 batch give voc_eval_map 0.3865 (BENCH_r04/r05)."""
    rng = np.random.RandomState(0)
    rng.randint(0, 255, (64, 224, 224, 3), dtype=np.uint8)
    n = 5717
    codes = torch.from_numpy(np.sign(rng.randn(n, 64)).astype(np.float32))
    labels = torch.from_numpy((rng.rand(n, 20) > 0.85).astype(np.float32))
    res = compute_retrieval_metrics(codes, labels, codes, labels, metric="hamming", k=n,
                                    same_source=True, with_hashing_stats=True)
    assert res["num_k"] == n - 1
    assert round(res["map"], 4) == 0.3865
