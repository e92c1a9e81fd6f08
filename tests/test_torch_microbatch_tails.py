"""The port's micro-batched train step against irw_tpu's at the two ragged
chunkings of ``test_torch_microbatch.py``'s batch of 15: a separate tail
(6 + 6 + 3) and a tail of one merged into the last chunk (7 + 8); the same
checks and tolerances."""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import pytest

from test_torch_microbatch import CHUNKINGS, _step_pair, check_running_statistics, check_step


@pytest.fixture(scope="module", params=["tail", "tail_of_one"])
def pair(request):
    return request.param, _step_pair(CHUNKINGS[request.param][0])


def test_microbatched_step_matches_jax(pair):
    check_step(pair)


def test_chunked_running_statistics_are_one_update_per_chunk(pair):
    check_running_statistics(pair)
