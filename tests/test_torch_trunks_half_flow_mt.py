"""The dtype flow of ``FourBranchResNet50`` and its fusion in half precision against
``jax.eval_shape`` of the JAX modules, as ``tests/test_torch_trunks_half_flow.py``
holds it (its docstring says how)."""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import pytest

from test_torch_trunks_half_flow import DTYPES, _k4_plain, check_flow  # noqa: F401


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ['mtwavenet50', 'mtwavenet50_fusion'])
def test_family_dtype_flow_matches_jax(name, dtype):
    check_flow(name, dtype)
