"""The port's level-1 Haar SWT and device transform against irw_tpu.

On the CPU ``haar_swt2`` runs its plain version; the JAX side runs
``haar_swt2_pallas`` in interpret mode, as tests/test_wavelets.py does, and
the jnp ``swt2``.  Tolerance 1e-6: both compute the same f32 arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.ops.wavelets import swt2
from irw_tpu.ops.wavelets.pallas_dwt import haar_swt2_pallas
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu_torch.ops.wavelets import haar_swt2_plain
from irw_tpu_torch.transforms import DeviceTransform

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
    [("CustomTransform", {"levels": 1})],
    [("DWTTransform", {})],
    [("ResizeSubBands", {"size": 8})],
])
def test_device_transform_later_ops_raise(ops):
    with pytest.raises(NotImplementedError, match="A9"):
        DeviceTransform(ops, device="cpu")
