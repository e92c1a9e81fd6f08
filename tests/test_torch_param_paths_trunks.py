"""``bridge.jax_param_paths`` against irw_tpu's flax trees, continued from
``tests/test_torch_param_paths.py`` (same check, full width): the
single-trunk configs of ``configs/model/`` (the baselines, the hashing
ResNets, ``RetrievalNet`` over a ViT, ResNet or ConvNeXt).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import pytest

from test_torch_factory import SINGLE_TRUNK
from test_torch_param_paths import _config_shapes, assert_paths_are_the_leaves


@pytest.mark.parametrize("config", SINGLE_TRUNK)
def test_trunk_config_param_paths_are_the_flax_leaves(config):
    assert_paths_are_the_leaves(*_config_shapes(config))
