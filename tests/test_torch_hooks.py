"""The fixed-batch instrumentor against irw_tpu's (``irw_tpu/hooks``);
``tests/test_torch_extras_runs.py`` runs it through ``run``.

``capture_features``: the small flagship (test_tiny towers of 3 blocks on
16² images, f32, eval mode) unscanned, where ``Block_2`` exists, and
scanned (``scan_blocks``, as the dinov2 presets build the full-width
flagship), where no ``Block_<i>`` scope exists and the default filter keeps
the fusion head's and ``HashHead``'s captures only: the same keys as flax's
``capture_intermediates``, and the values within 1e-4.
``capture_gradients``: every leaf's gradient of a random projection of the
training output, in the flax layout (a scanned stack's blocks stacked on
its depth axis), within 1e-4 of the leaf's largest (the key projections'
biases, whose gradients are exact zeros, at their shapes only).  The
``HashHead`` has no BatchNorm here: a training-mode BatchNorm over 4
samples magnifies rounding past 1e-4.  ``FixedBatchInstrumentor``: the snapshot and the dump
files' keys and values.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.hooks import FixedBatchInstrumentor as JaxInstrumentor
from irw_tpu.hooks import capture_features as jax_capture_features
from irw_tpu.hooks import capture_gradients as jax_capture_gradients
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu_torch.bridge import load_jax_variables
from irw_tpu_torch.hooks import FixedBatchInstrumentor, capture_features, capture_gradients
from irw_tpu_torch.models import get_model
from irw_tpu_torch.transforms import DeviceTransform
from test_torch_fusion_heads import numpy_init

IMG, BATCH, TOL = 16, 4, 1e-4
SWT = [("SWTTransform", {"level": 1, "wavelet": "haar"})]
FUSION = {"type": "cross_attention_advanced", "output_dim": 64, "num_heads": 2, "dropout": 0.0,
          "sub_band_dropout_p": 0.0}  # no training-mode mask: its bits cannot match
_PAIRS = {}


def _images():
    return np.random.RandomState(2).randint(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)


def _pair(scan: bool):
    """(JAX model, variables, port model, bands) of the small flagship."""
    if scan not in _PAIRS:
        kw = dict(backbone="test_tiny", fusion_config=FUSION, frozen_backbone=False,
                  use_bn=False)
        vit = {"depth": 3, "scan_blocks": scan}
        jmodel = jax_get_model("multidino_attention_hashing", **kw, vit_kwargs=vit)
        bands = JaxDeviceTransform(SWT)(jnp.asarray(_images()))
        variables = numpy_init(jmodel, bands, seed=4, train=True)
        model = get_model("multidino_attention_hashing", device="cpu", **kw,
                          vit_kwargs=dict(vit, img_size=IMG))
        load_jax_variables(model, variables)
        _PAIRS[scan] = (jmodel, variables, model.eval(), np.asarray(bands))
    return _PAIRS[scan]


def _close(ours, ref, what):
    np.testing.assert_allclose(np.asarray(ours, np.float32), np.asarray(ref, np.float32),
                               atol=TOL, rtol=TOL, err_msg=what)


@pytest.mark.parametrize("scan", [False, True], ids=["unscanned", "scanned"])
def test_capture_features_matches_jax(scan):
    jmodel, variables, model, bands = _pair(scan)
    _, jaux, jflat = jax.jit(lambda v, x: jax_capture_features(jmodel, v, x))(
        variables, jnp.asarray(bands))
    _, aux, flat = capture_features(model, torch.from_numpy(bands))
    assert sorted(flat) == sorted(jflat)
    blocks = {k.split("/")[2] for k in flat if "/Block_" in k}
    assert blocks == (set() if scan else {"Block_2"})
    assert any(k.startswith("HashHead_0/Dense_0/") for k in flat)
    for key, value in jflat.items():
        assert tuple(flat[key].shape) == value.shape, key
        _close(flat[key], value, key)
    assert set(aux) == set(jaux)


def test_capture_features_leaves_the_statistics(monkeypatch):
    _, _, model, bands = _pair(True)
    before = [b.clone() for b in model.buffers()]
    capture_features(model, torch.from_numpy(bands), train=True,
                     filter_fn=lambda path, _: path[0] == "HashHead_0")
    assert all(torch.equal(a, b) for a, b in zip(before, model.buffers()))
    assert not model.training


# a random projection of the codes: mean(out²) would be all but constant after
# the HashHead's BatchNorm, and its gradient rounding noise
PROJECTION = np.random.RandomState(6).randn(BATCH, 64).astype(np.float32)


def _loss(output):
    return (output * torch.from_numpy(PROJECTION)).sum()


def _jax_loss(output):
    return jnp.sum(output * PROJECTION)


@pytest.mark.parametrize("scan", [False, True], ids=["unscanned", "scanned"])
def test_capture_gradients_matches_jax(scan):
    jmodel, variables, model, bands = _pair(scan)
    ref = jax.jit(lambda v, x: jax_capture_gradients(jmodel, v, x, _jax_loss))(
        variables, jnp.asarray(bands))
    ours = capture_gradients(model, torch.from_numpy(bands), _loss)
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        assert tuple(ours[key].shape) == value.shape, key
        if key.endswith("key/bias"):  # an exact zero: rounding noise on both sides
            continue
        scale = max(float(np.abs(np.asarray(value)).max()), 1e-3)
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(value), rtol=0,
                                   atol=TOL * scale, err_msg=key)
    assert not model.training and all(p.grad is None for p in model.parameters())


def test_instrumentor_dumps_match_jax(tmp_path):
    """The snapshot and the dump against JAX's (the JAX dump without a
    ``loss_fn``: its gradients op by op outlast the test; the port's
    ``grad/`` entries are the leaves ``capture_gradients`` holds above)."""
    jmodel, variables, model, bands = _pair(True)
    batch = {"image": _images(), "label": np.zeros((BATCH, 20), np.float32),
             "index": np.arange(BATCH)}
    ours = FixedBatchInstrumentor(model, str(tmp_path / "port"), target_epochs=(2,))
    ref = JaxInstrumentor(jmodel, str(tmp_path / "jax"), target_epochs=(2,))
    for inst in (ours, ref):
        inst.snapshot_batch(batch)
        inst.snapshot_batch({k: v + 1 for k, v in batch.items()})  # the first batch stays
    assert ours.maybe_dump(1, DeviceTransform(SWT, device="cpu")) is None
    path = ours.maybe_dump(2, DeviceTransform(SWT, device="cpu"), loss_fn=_loss)
    jpath = ref.maybe_dump(2, variables, JaxDeviceTransform(SWT))
    _same_files(tmp_path / "port" / "fixed_batch.npz", tmp_path / "jax" / "fixed_batch.npz")
    with np.load(path) as dump:
        grads = {k for k in dump.files if k.startswith("grad/")}
        np.savez(tmp_path / "features.npz", **{k: dump[k] for k in dump.files
                                               if k not in grads})
    keys = _same_files(tmp_path / "features.npz", jpath)
    assert any(k.startswith("aux/") for k in keys) and any(k.startswith("feat/") for k in keys)
    assert grads == {f"grad/{k}" for k in capture_gradients(model, torch.from_numpy(bands),
                                                            _loss)}


def _same_files(path, jpath) -> list:
    with np.load(path) as ours, np.load(jpath) as ref:
        assert sorted(ours.files) == sorted(ref.files)
        for key in ref.files:
            if key.endswith("key/bias"):
                continue
            scale = max(float(np.abs(ref[key].astype(np.float32)).max()), 1e-3)
            np.testing.assert_allclose(ours[key].astype(np.float32),
                                       ref[key].astype(np.float32), rtol=0,
                                       atol=TOL * scale, err_msg=key)
        return list(ref.files)


def test_chip_smoke_hook_features_are_the_scanned_flagships():
    """``chip_smoke.HOOK_FEATURES``, the keys its engine_extras phase wants in
    the full-width flagship's dumps, are what irw_tpu captures of a scanned
    flagship with the YAML's head (``use_bn``, fusion dropout) under the
    default filter."""
    import chip_smoke

    kw = dict(backbone="test_tiny", frozen_backbone=False, use_bn=True,
              fusion_config=dict(FUSION, dropout=0.1))
    jmodel = jax_get_model("multidino_attention_hashing", **kw,
                           vit_kwargs={"depth": 3, "scan_blocks": True})
    bands = JaxDeviceTransform(SWT)(jnp.asarray(_images()))
    variables = numpy_init(jmodel, bands, seed=5, train=True)
    _, _, jflat = jax.jit(lambda v, x: jax_capture_features(jmodel, v, x))(variables, bands)
    assert tuple(sorted(jflat)) == chip_smoke.HOOK_FEATURES
    model = get_model("multidino_attention_hashing", device="cpu", **kw,
                      vit_kwargs={"depth": 3, "scan_blocks": True, "img_size": IMG})
    load_jax_variables(model, variables)
    _, _, flat = capture_features(model.eval(), torch.from_numpy(np.asarray(bands)))
    assert tuple(sorted(flat)) == chip_smoke.HOOK_FEATURES
