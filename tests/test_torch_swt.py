"""The port's level-1 Haar SWT and device transform against irw_tpu.

On the CPU ``haar_swt2`` runs its plain version; the JAX side runs
``haar_swt2_pallas`` in interpret mode, as tests/test_wavelets.py does, and
the jnp ``swt2``.  Tolerance 1e-6: both compute the same f32 arithmetic.

``CustomTransform`` (the lifting DWT) takes the JAX package's three routes;
each is held to the JAX ``DeviceTransform`` at 1e-5 · max(1, max|ref|)
(the jitted jnp chain rounds a few ulps apart, tests/test_torch_lifting.py),
as are ``SWTTransform`` at another wavelet or level, ``DWTTransform`` and
``ResizeSubBands`` (the filter bank and the resize sum in another order,
tests/test_torch_dwt.py).  The device stages of the three DWT configs,
``cifar_dwt``, ``dwt_all_subs`` and ``sdd_dwt_all_subs``, both splits, are
held to the JAX package's the same way.  Then one slice a path, images →
both packages' device stage → the WCNN model with the same weights (the
bridge) at resnet18 width → embeddings at the WCNN tolerance 1e-4:
``wcnn_attention_all_subs`` on ``dwt_all_subs`` (7 bands, ResizeSubBands),
``wcnn_attention_ce`` on ``cifar_dwt`` (DWTTransform).  The configs come
through the port's ``compose``; ResizeSubBands' size and the images are cut
to 16² and 32² there.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from irw_tpu.models import get_model as jax_get_model
from irw_tpu.ops.wavelets import swt2
from irw_tpu.ops.wavelets.pallas_dwt import haar_swt2_pallas
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu.transforms.pipeline import build_transforms as jax_build_transforms
from irw_tpu_torch.bridge import load_jax_variables
from irw_tpu_torch.config import compose
from irw_tpu_torch.models import get_model
from irw_tpu_torch.models.wresnet import WCNNAttention
from irw_tpu_torch.ops.wavelets import haar_swt2_plain
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from irw_tpu_torch.transforms import DeviceTransform, build_transforms, pipeline

TOL = 1e-6
WCNN_TOL = 1e-4


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


def close(ours, ref, tol=1e-5):
    ref = np.asarray(ref)
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("ops,shape", [
    ([("SWTTransform", {"level": 2, "wavelet": "haar"})], (4, 16, 12, 3)),
    ([("SWTTransform", {"level": 1, "wavelet": "db2"})], (4, 16, 12, 3)),
    ([("DWTTransform", {})], (4, 8, 6, 3)),
    ([("DWTTransform", {}), ("ResizeSubBands", {"size": 8})], (4, 8, 8, 3)),
])
def test_device_transform_wavelet_ops_match_jax(monkeypatch, ops, shape):
    """SWT at another wavelet or level (the coarsest tuple of ``swt2``),
    ``DWTTransform`` (``wavedec2``, symmetric) and ``ResizeSubBands``; none
    calls K1."""
    monkeypatch.setattr(pipeline, "haar_swt2", None)
    images = np.random.RandomState(5).randint(0, 255, (3, 16, 12, 3), dtype=np.uint8)
    ours = DeviceTransform(ops, device="cpu")(images)
    ref = JaxDeviceTransform(ops)(images)
    assert ours.shape == (3, *shape)
    close(ours, ref)


@pytest.mark.parametrize("ops", [
    [("SWTTransform", {"level": 1, "wavelet": "db5"})],
    [("DWTTransform", {"wavelet": "haar", "mode": "wrap"})],
])
def test_device_transform_bad_wavelet_args_raise(ops):
    with pytest.raises(ValueError, match="unknown wavelet|extension mode"):
        DeviceTransform(ops, device="cpu")(np.zeros((1, 8, 8, 3), np.uint8))


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("name", ["cifar_dwt", "dwt_all_subs", "sdd_dwt_all_subs"])
def test_config_device_stage_matches_jax(name, split):
    """``build_transforms`` of both packages on one split of the config:
    the same host ops in the same order (the crops of ``sdd_dwt_all_subs``,
    listed after the DWT, run on the host first; ``FixSize`` before
    ``DWTTransform``), and the same device stage on the same uint8 images."""
    cfg = compose(CONFIG_DIR, "default", [f"transform={name}"]).transform[split]
    host, device = build_transforms(cfg, device="cpu")
    jhost, jdevice = jax_build_transforms(cfg)
    assert [n for n, _ in host.ops] == [n for n, _ in jhost.ops]
    images = np.random.RandomState(6).randint(0, 255, (2, 32, 32, 3), dtype=np.uint8)
    ours = device(images)
    ref = jdevice(images)
    bands = {"cifar_dwt": (4, 16, 16), "dwt_all_subs": (7, 112, 112),
             "sdd_dwt_all_subs": (7, 256, 256)}[name]
    assert ours.shape == (2, *bands, 3)
    close(ours, ref)


def _random_variables(jmodel, bands, seed):
    """Every variable of ``jmodel`` drawn with numpy from its shapes
    (``jax.eval_shape`` of the init: no init compile): kernels at
    1/sqrt(fan-in), BatchNorm scales and variances in [0.5, 1.5), means and
    biases small."""
    shapes = jax.eval_shape(
        lambda x: jmodel.init({"params": jax.random.PRNGKey(0)}, x, train=True), bands)
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in traverse_util.flatten_dict(shapes).items():
        shape = leaf.shape
        if path[-1] == "kernel":      # banded HWIO convs (S, H, W, I, O), or Dense (I, O)
            value = rng.randn(*shape) / np.sqrt(np.prod(shape[1:-1] if len(shape) == 5
                                                        else shape[:1]))
        elif path[-1] in ("scale", "var"):
            value = 0.5 + rng.rand(*shape)
        else:
            value = 0.1 * rng.randn(*shape)
        out[path] = jnp.asarray(value, jnp.float32)
    return traverse_util.unflatten_dict(out)


def _slice(model_name, transform_name, overrides, num_bands):
    """Images → both packages' device stage of the config's test split → the
    config's model at resnet18 width, one set of weights: (embeddings, gate)
    of each."""
    cfg = compose(CONFIG_DIR, "default", [f"model={model_name}", f"transform={transform_name}",
                                          *overrides])
    _, device = build_transforms(cfg.transform.test, device="cpu")
    _, jdevice = jax_build_transforms(cfg.transform.test)
    images = np.random.RandomState(7).randint(0, 255, (3, 32, 32, 3), dtype=np.uint8)
    bands, jbands = device(images), jdevice(images)
    close(bands, jbands)
    kw = dict(cfg.model.kwargs, backbone="resnet18", num_classes=5)
    jmodel = jax_get_model(cfg.model.name, **kw)
    variables = _random_variables(jmodel, jbands, 8)
    model = get_model(cfg.model.name, device="cpu", **kw)
    assert isinstance(model, WCNNAttention) and len(model.backbone.branches) == num_bands
    load_jax_variables(model, variables)
    jemb, jaux = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jbands)
    with torch.no_grad():
        emb, aux = model.eval()(bands)
    return (emb, aux["gate"]), (jemb, jaux["gate"])


@pytest.mark.parametrize("model_name,transform_name,overrides,num_bands", [
    # path A: two lifting levels, 7 bands of 8², ResizeSubBands to 16²
    ("wcnn_attention_all_subs", "dwt_all_subs", ["transform.test.ResizeSubBands.size=16"], 7),
    # path B: DWTTransform haar level 1 symmetric, 4 bands of 16²
    ("wcnn_attention_ce", "cifar_dwt", [], 4),
])
def test_dwt_slice_matches_jax(model_name, transform_name, overrides, num_bands):
    (emb, gate), (jemb, jgate) = _slice(model_name, transform_name, overrides, num_bands)
    assert emb.shape == (3, 512) and gate.shape == (3, num_bands)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=0, atol=WCNN_TOL)
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=0, atol=WCNN_TOL)


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
