"""The ``use_flash`` slice end to end on both packages: the small flagship
(the YAML's kwargs at depth 2, f32) with ``vit_kwargs={"use_flash": True}``.

- Serve: synthetic VOC images → DeviceTransform (Haar SWT) → the model →
  ±1 codes → Hamming ``evaluate``, as ``test_torch_slice``: the same codes,
  every metric to 1e-6.
- Train: two full ``build_train_step`` steps against ``irw_tpu``'s train
  step (block remat, HashLoss, AdamW), as ``test_torch_train_step``:
  metrics to 1e-5 relative, parameter updates to 1e-3·lr.

The banded JAX flagship with ``use_flash`` does not run in Pallas interpret
mode on this JAX (the remat'd kernel's effects fail partial evaluation; under
``nn.vmap`` the interpreter's grid fails), so inside these tests the library
kernel is swapped for the library's own plain reference,
``mha_reference_no_custom_vjp``, which takes the same segment ids; nothing in
``irw_tpu`` changes.  The port runs ``flash_attention`` (its plain versions
on the CPU), whose exact arithmetic ``test_torch_flash`` holds to the kernel
itself in interpret mode.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import pytest
from jax.experimental.pallas.ops.tpu import flash_attention as jax_flash

from test_torch_slice import check_slice_matches_jax
from test_torch_train_step import STEPS, check_step_metrics, check_step_updates, run_steps

FLASH_F32 = {"depth": 2, "dtype": "float32", "use_flash": True}


@pytest.fixture()
def library_reference(monkeypatch):
    monkeypatch.setattr(jax_flash, "flash_attention", jax_flash.mha_reference_no_custom_vjp)


def test_flash_slice_end_to_end_matches_jax(library_reference):
    check_slice_matches_jax(FLASH_F32)


@pytest.fixture(scope="module")
def flash_steps():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_flash, "flash_attention", jax_flash.mha_reference_no_custom_vjp)
        steps = run_steps(FLASH_F32)
    model = steps[3].model
    assert model.backbone.vit.remat_blocks and not model.frozen_backbone
    assert model.backbone.vit.blocks[0].attn.core.__name__ == "flash_attention"
    return steps


def test_flash_step_metrics_match_jax(flash_steps):
    check_step_metrics(flash_steps)


@pytest.mark.parametrize("i", range(STEPS))
def test_flash_step_updates_match_jax(flash_steps, i):
    check_step_updates(flash_steps, i)
