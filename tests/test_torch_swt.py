"""The port's level-1 Haar SWT and device transform against irw_tpu.

On the CPU ``haar_swt2`` runs its plain version; the JAX side runs
``haar_swt2_pallas`` in interpret mode, as tests/test_wavelets.py does, and
the jnp ``swt2``.  Tolerance 1e-6: both compute the same f32 arithmetic.

``CustomTransform`` (the lifting DWT) takes the JAX package's three routes;
each is held to the JAX ``DeviceTransform`` at 1e-5 · max(1, max|ref|)
(the jitted jnp chain rounds a few ulps apart, tests/test_torch_lifting.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.ops.wavelets import swt2
from irw_tpu.ops.wavelets.pallas_dwt import haar_swt2_pallas
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu_torch.ops.wavelets import haar_swt2_plain
from irw_tpu_torch.transforms import DeviceTransform, pipeline

TOL = 1e-6


@pytest.mark.parametrize("shape", [(3, 16, 16), (2, 10, 14)])
def test_plain_swt_matches_pallas_and_swt2(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    ours = haar_swt2_plain(torch.from_numpy(x)).numpy()
    pallas = np.asarray(haar_swt2_pallas(jnp.asarray(x), interpret=True))
    (ca, (ch, cv, cd)), = swt2(jnp.asarray(x), "haar", level=1)
    ref = np.stack([np.asarray(a) for a in (ca, ch, cv, cd)], axis=1)
    assert ours.shape == (shape[0], 4) + shape[1:]
    np.testing.assert_allclose(ours, pallas, atol=TOL, rtol=0)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


def test_swt_low_precision_input_computes_in_f32():
    x = np.random.RandomState(1).randn(2, 8, 8).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = haar_swt2_plain(xb)
    assert out.dtype == torch.bfloat16
    ref = haar_swt2_pallas(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), interpret=True)
    # the f32 values agree to rounding; the casts back may then land one
    # bf16 ulp (2^-7 relative at most) apart
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("ops", [
    [("SWTTransform", {"level": 1, "wavelet": "haar"})],
    [("Normalize", {}), ("SWTTransform", {"level": 1, "wavelet": "haar"}), ("RGBToBGR", {})],
])
def test_device_transform_matches_jax(ops):
    images = np.random.RandomState(3).randint(0, 255, (3, 16, 12, 3), dtype=np.uint8)
    ours = DeviceTransform(ops, device="cpu")(images).numpy()
    ref = np.asarray(JaxDeviceTransform(ops)(images))
    assert ours.shape == ref.shape == (3, 4, 16, 12, 3)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("ops", [
    [("SWTTransform", {"level": 2, "wavelet": "haar"})],
    [("SWTTransform", {"level": 1, "wavelet": "db2"})],
    [("DWTTransform", {})],
    [("ResizeSubBands", {"size": 8})],
])
def test_device_transform_later_ops_raise(ops):
    with pytest.raises(NotImplementedError, match="A9"):
        DeviceTransform(ops, device="cpu")


NORMALIZE = ("Normalize", {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]})
CUB_DWT = ("CustomTransform", {"decompose_levels": 1, "basis": "haar", "coarse_only": True,
                               "ll_only": False})


@pytest.mark.parametrize("ops,size,shape,k4", [
    # route 1, K4: configs/transform/cub_dwt.yaml's test device ops
    ([NORMALIZE, CUB_DWT], (16, 12), (4, 8, 6, 3), True),
    ([("CustomTransform", {"levels": 2, "basis": "cdf97"})], (16, 24), (4, 4, 6, 3), True),
    ([("CustomTransform", {"decompose_levels": 2, "basis": "bior_spline_48"})], (32, 32),
     (4, 8, 8, 3), True),
    # cdf97 at 6 x 6: K4 lifts it as is, the stack pads it to 8 x 8 first
    ([("CustomTransform", {"decompose_levels": 1, "basis": "cdf97"})], (6, 6), (4, 3, 3, 3), True),
    ([("CustomTransform", {"decompose_levels": 1, "basis": "cdf97", "ll_only": True})], (6, 6),
     (4, 4, 3), False),
    # route 2: ll_only, or H and W that do not divide by 2^levels
    ([("CustomTransform", {"decompose_levels": 2, "ll_only": True})], (16, 12), (4, 3, 3),
     False),
    ([("CustomTransform", {"decompose_levels": 2, "basis": "daub4"})], (20, 14), (4, 5, 4, 3),
     False),
    # route 3: the full 2-level stack (coarse LL + 6 detail bands), WCNN_ALL's input
    ([NORMALIZE, ("CustomTransform", {"decompose_levels": 2, "basis": "haar",
                                       "coarse_only": False})], (16, 12), (7, 4, 3, 3), False),
    ([("CustomTransform", {"levels": 3, "basis": "cdf53", "coarse_only": False})], (32, 16),
     (10, 4, 2, 3), False),
])
def test_custom_transform_matches_jax(monkeypatch, ops, size, shape, k4):
    calls = []
    real = pipeline.lifting_multi_level
    monkeypatch.setattr(pipeline, "lifting_multi_level",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    images = np.random.RandomState(4).randint(0, 255, (2, *size, 3), dtype=np.uint8)
    ours = DeviceTransform(ops, device="cpu")(images).numpy()
    ref = np.asarray(JaxDeviceTransform(ops)(images))
    assert ours.shape == ref.shape == (2, *shape)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))
    assert calls == ([(6, *size)] if k4 else [])  # one K4 call on (B·C, H, W), or none


def test_custom_transform_unknown_basis_raises():
    with pytest.raises(ValueError, match="unknown lifting basis"):
        DeviceTransform([("CustomTransform", {"basis": "db2"})], device="cpu")(
            np.zeros((1, 8, 8, 3), np.uint8))
