"""``bridge.jax_param_paths`` and ``bridge.to_flax_leaves`` against irw_tpu's
flax trees, continued from ``tests/test_torch_param_paths.py`` (same
check): the WCNN configs of ``configs/model/`` at full width, the fusion
heads of every ``get_fusion_head`` type, the bare trunks
``from_jax_variables`` reads (ResNet, DenseNet, ConvNeXt), the subband
gates, a bare ViT unrolled, scanned, scanned in groups and with each
Block route; and a module
class without rules raises.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from irw_tpu.models import convnext as jax_convnext
from irw_tpu.models import densenet as jax_densenet
from irw_tpu.models import resnet as jax_resnet
from irw_tpu.models.attention_blocks import SUBBAND_GATES as JAX_GATES
from irw_tpu.models.fusion import get_fusion_head as jax_fusion_head
from irw_tpu.models.vit import VisionTransformer as JaxViT
from irw_tpu_torch.bridge import from_jax_variables, jax_param_paths, to_flax_leaves
from irw_tpu_torch.models import convnext, densenet, resnet
from irw_tpu_torch.models.attention_blocks import SUBBAND_GATES
from irw_tpu_torch.models.fusion import get_fusion_head
from irw_tpu_torch.models.vit import VisionTransformer
from test_torch_factory import WCNN_FAMILY
from test_torch_param_paths import RNGS, _config_shapes, assert_paths_are_the_leaves


@pytest.mark.parametrize("config", WCNN_FAMILY)
def test_wcnn_config_param_paths_are_the_flax_leaves(config):
    assert_paths_are_the_leaves(*_config_shapes(config))


HEAD_TYPES = ("standard", "temperature", "self_attention", "semantic", "gated",
              "temperature_gated", "cross_attention_bottleneck", "cross_attention_advanced", "cbam", "eca")


@pytest.mark.parametrize("ftype", HEAD_TYPES)
def test_fusion_head_param_paths_are_the_flax_leaves(ftype):
    cfg = {"type": ftype, "output_dim": 16, "num_heads": 2, "dropout": 0.0,
           "sub_band_dropout_p": 0.0}
    shapes = jax.eval_shape(lambda: jax_fusion_head(cfg, 24).init(RNGS, jnp.zeros((2, 4, 24)),
                                                              train=True))
    assert_paths_are_the_leaves(get_fusion_head(cfg, 24), shapes)


TRUNKS = {
    "resnet18": (jax_resnet.resnet18, resnet.resnet18),
    "resnet50": (jax_resnet.resnet50, resnet.resnet50),
    "densenet121": (jax_densenet.densenet121, densenet.densenet121),
    "convnext_tiny": (jax_convnext.convnext_tiny, convnext.convnext_tiny),
}


@pytest.mark.parametrize("name", sorted(TRUNKS))
def test_bare_trunk_param_paths_are_the_flax_leaves(name):
    jctor, ctor = TRUNKS[name]
    shapes = jax.eval_shape(lambda: jctor().init(RNGS, jnp.zeros((1, 64, 64, 3)), train=False))
    with torch.device("meta"):
        model = ctor()
    assert_paths_are_the_leaves(model, shapes)


@pytest.mark.parametrize("gate", sorted(SUBBAND_GATES))
def test_subband_gate_param_paths_are_the_flax_leaves(gate):
    shapes = jax.eval_shape(lambda: JAX_GATES[gate]().init(RNGS, jnp.zeros((2, 4, 32))))
    assert_paths_are_the_leaves(SUBBAND_GATES[gate](32), shapes)


VIT = dict(embed_dim=32, depth=4, num_heads=2, patch_size=8)


def _vit_pair(**layout):
    jvit = JaxViT(img_size=16, **VIT, **layout)
    shapes = jax.eval_shape(lambda: jvit.init(RNGS, jnp.zeros((1, 16, 16, 3))))
    return VisionTransformer(img_size=16, **VIT, **layout), shapes


@pytest.mark.parametrize("layout", [{}, {"scan_blocks": True},
                                    {"scan_blocks": True, "scan_group": 2},
                                    {"use_flash": True}, {"split_cls": True},
                                    {"fused_qkv": True}, {"ln_fused": True}],
                         ids=["unrolled", "scanned", "grouped", "flash", "split_cls",
                              "fused_qkv", "ln_fused"])
def test_vit_layouts_param_paths_and_leaves(layout):
    """A bare ViT unrolled, scanned, scanned in groups of two and with each
    other Block route: the paths, and ``to_flax_leaves`` of the port's
    parameters gives back the flax tree the bridge read them from, leaf for
    leaf and in its layout."""
    model, shapes = _vit_pair(**layout)
    assert_paths_are_the_leaves(model, shapes)
    rng = np.random.RandomState(0)
    flat = {"/".join(p): rng.randn(*leaf.shape).astype(np.float32) for p, leaf in
            traverse_util.flatten_dict(dict(shapes["params"])).items()}
    tree = traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
    state = from_jax_variables({"params": tree})
    leaves = to_flax_leaves(model, {n: torch.from_numpy(np.ascontiguousarray(state[n]))
                                    for n, _ in model.named_parameters()})
    assert set(leaves) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(leaves[path].numpy(), value, err_msg=path)


def test_unknown_owner_class_raises():
    class Wrapper(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = torch.nn.Linear(2, 2)

    with pytest.raises(ValueError, match="no flax scope for the children of a Wrapper"):
        jax_param_paths(Wrapper())
