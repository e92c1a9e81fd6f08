"""The dtype flow of ``HybridMultiBranch`` (ResNet-50 on LL, DenseNet-121 on the details) in bfloat16 in half precision against
``jax.eval_shape`` of the JAX modules, as ``tests/test_torch_trunks_half_flow.py``
holds it (its docstring says how) (one dtype a file: each
traces the JAX model's parameters once, about 10 s)."""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import pytest

from test_torch_trunks_half_flow import _k4_plain, check_flow  # noqa: F401


@pytest.mark.parametrize("dtype", ["bfloat16"])
@pytest.mark.parametrize("name", ['hybrid_mtwavenet_v2_ce'])
def test_family_dtype_flow_matches_jax(name, dtype):
    check_flow(name, dtype)
