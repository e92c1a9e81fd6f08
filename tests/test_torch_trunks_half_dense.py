"""``DenseNet`` and ``ConvNeXt`` in half precision against irw_tpu's, held
as ``tests/test_torch_trunks_half_models.py`` holds the ResNet (its
docstring derives the bounds); and
``pool="none"`` in the mtwavenet family (ROADMAP A10b-rest):
``FourBranchResNet50`` with classes sizes its LayerNorm and classifier from
the flattened map, which ``get_model(..., image_size=(h, w))`` gives the
port, against JAX's lazy init on 40 × 72 bands (a 2 × 3 map: each halving
rounds a side up).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import pytest

from test_torch_trunks_half_models import DTYPES, check_gradients, check_outputs_and_statistics

CASES = ["densenet", "convnext"]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_half_model_outputs_and_statistics(case, dtype):
    check_outputs_and_statistics(case, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_half_model_gradients(case, dtype):
    check_gradients(case, dtype)
