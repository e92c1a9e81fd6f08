"""Pretrained weights: ``irw_tpu_torch.tools.convert_torch_weights`` and
``irw_tpu_torch.utils.pretrained`` against ``tools/convert_torch_weights.py``
and ``irw_tpu/utils/pretrained.py``.

The torch checkpoints are made here from a seed, in the layouts the real
files use (``tests/test_converter_numeric.py``'s naming): torchvision's
ResNet (basic blocks, and bottlenecks at one block a stage) and DenseNet
at narrow widths, torch.hub's DINOv2 ViT (128 wide, 2 heads of 64, 2
blocks, patch 14), and transformers' own torch ``CLIPVisionModel``,
``ViTModel`` and ``SiglipVisionModel`` at width 32, 2 layers, patch 8, 32²
(their weights redrawn from the seed).  Each is converted by both tools; the
converted JAX module and the port's module with the converted state dict
give the same forward to 1e-5 (f32).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from irw_tpu.models import hf_wrapper as jax_hf
from irw_tpu.models.densenet import DenseNet as JaxDenseNet
from irw_tpu.models.resnet import BasicBlock as JaxBasicBlock
from irw_tpu.models.resnet import Bottleneck as JaxBottleneck
from irw_tpu.models.resnet import ResNet as JaxResNet
from irw_tpu.models.vit import VisionTransformer as JaxViT
from irw_tpu.utils import pretrained as jax_pretrained
from irw_tpu_torch.bridge import to_flax_leaves
from irw_tpu_torch.models import get_model
from irw_tpu_torch.models.densenet import DenseNet
from irw_tpu_torch.models.hf_wrapper import HuggingFaceVisionWrapper
from irw_tpu_torch.models.resnet import ResNet
from irw_tpu_torch.models.vit import VisionTransformer
from irw_tpu_torch.tools import convert_torch_weights as port_convert
from irw_tpu_torch.utils import pretrained
from tools import convert_torch_weights as jax_convert

TOL = 1e-5
HF_TINY = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
           "image_size": 32, "patch_size": 8, "intermediate_size": 128}
DINO = {"embed_dim": 128, "depth": 2, "num_heads": 2, "patch_size": 14}


def _bn(sd, key, c, rng):
    sd[f"{key}.weight"] = 1.0 + 0.1 * rng.randn(c)
    sd[f"{key}.bias"] = 0.1 * rng.randn(c)
    sd[f"{key}.running_mean"] = 0.1 * rng.randn(c)
    sd[f"{key}.running_var"] = 1.0 + 0.1 * rng.rand(c)
    sd[f"{key}.num_batches_tracked"] = np.array(7)


def _conv(sd, key, cout, cin, k, rng):
    sd[f"{key}.weight"] = rng.randn(cout, cin, k, k) / np.sqrt(cin * k * k)


def _tensors(sd):
    return {k: torch.as_tensor(np.asarray(v, np.float32) if np.asarray(v).dtype.kind == "f"
                               else np.asarray(v)) for k, v in sd.items()}


def torchvision_resnet(stage_sizes, bottleneck: bool, width: int, seed: int = 0) -> dict:
    """torchvision's ResNet state-dict layout (``conv1``, ``bn1``,
    ``layer{s}.{b}.conv{c}``/``bn{c}``, ``downsample.0/1``)."""
    rng, sd = np.random.RandomState(seed), {}
    _conv(sd, "conv1", width, 3, 7, rng)
    _bn(sd, "bn1", width, rng)
    cin, expansion = width, 4 if bottleneck else 1
    for s, n in enumerate(stage_sizes):
        planes = width * 2 ** s
        for b in range(n):
            pre = f"layer{s + 1}.{b}"
            shapes = ([(planes, cin, 1), (planes, planes, 3), (planes * 4, planes, 1)]
                      if bottleneck else [(planes, cin, 3), (planes, planes, 3)])
            for c, (o, i, k) in enumerate(shapes, start=1):
                _conv(sd, f"{pre}.conv{c}", o, i, k, rng)
                _bn(sd, f"{pre}.bn{c}", o, rng)
            if (s > 0 and b == 0) or cin != planes * expansion:
                _conv(sd, f"{pre}.downsample.0", planes * expansion, cin, 1, rng)
                _bn(sd, f"{pre}.downsample.1", planes * expansion, rng)
            cin = planes * expansion
    return _tensors(sd)


def torchvision_densenet(block_sizes, growth: int, init: int, seed: int = 0) -> dict:
    rng, sd = np.random.RandomState(seed), {}
    _conv(sd, "features.conv0", init, 3, 7, rng)
    _bn(sd, "features.norm0", init, rng)
    c = init
    for bi, n in enumerate(block_sizes, start=1):
        for li in range(1, n + 1):
            pre = f"features.denseblock{bi}.denselayer{li}"
            _bn(sd, f"{pre}.norm1", c, rng)
            _conv(sd, f"{pre}.conv1", 4 * growth, c, 1, rng)
            _bn(sd, f"{pre}.norm2", 4 * growth, rng)
            _conv(sd, f"{pre}.conv2", growth, 4 * growth, 3, rng)
            c += growth
        if bi < len(block_sizes):
            _bn(sd, f"features.transition{bi}.norm", c, rng)
            _conv(sd, f"features.transition{bi}.conv", c // 2, c, 1, rng)
            c //= 2
    _bn(sd, "features.norm5", c, rng)
    return _tensors(sd)


def hub_dinov2(embed_dim: int, depth: int, patch_size: int, tokens: int, seed: int = 0,
               layerscale: bool = True) -> dict:
    """torch.hub's DINOv2 layout (``blocks.N.attn.qkv``, ``ls1.gamma``,
    ``mask_token``, …)."""
    rng, d, sd = np.random.RandomState(seed), embed_dim, {}
    sd["cls_token"] = 0.02 * rng.randn(1, 1, d)
    sd["mask_token"] = np.zeros((1, d))
    sd["pos_embed"] = 0.02 * rng.randn(1, tokens, d)
    _conv(sd, "patch_embed.proj", d, 3, patch_size, rng)
    sd["patch_embed.proj.bias"] = 0.1 * rng.randn(d)
    for i in range(depth):
        b = f"blocks.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{b}.{norm}.weight"] = 1.0 + 0.1 * rng.randn(d)
            sd[f"{b}.{norm}.bias"] = 0.1 * rng.randn(d)
        for name, (o, i_) in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                              ("mlp.fc1", (4 * d, d)), ("mlp.fc2", (d, 4 * d))):
            sd[f"{b}.{name}.weight"] = rng.randn(o, i_) / np.sqrt(i_)
            sd[f"{b}.{name}.bias"] = 0.1 * rng.randn(o)
        if layerscale:
            sd[f"{b}.ls1.gamma"] = 0.5 + 0.1 * rng.randn(d)
            sd[f"{b}.ls2.gamma"] = 0.5 + 0.1 * rng.randn(d)
    sd["norm.weight"] = 1.0 + 0.1 * rng.randn(d)
    sd["norm.bias"] = 0.1 * rng.randn(d)
    return _tensors(sd)


def hf_torch_model(variant: str, seed: int = 0):
    """transformers' own torch tower for ``variant`` at ``HF_TINY``, every
    float weight redrawn from ``seed``; returns its state dict."""
    kind = jax_hf.HF_DEFAULT_CONFIGS[variant]["kind"]
    cls, cfg_cls = {"clip": (transformers.CLIPVisionModel, transformers.CLIPVisionConfig),
                    "vit": (transformers.ViTModel, transformers.ViTConfig),
                    "siglip": (transformers.SiglipVisionModel,
                               transformers.SiglipVisionConfig)}[kind]
    model = cls(cfg_cls(**HF_TINY))
    rng = np.random.RandomState(seed)
    sd = model.state_dict()
    for name, t in sd.items():
        if t.is_floating_point():
            base = 1.0 if "norm" in name and name.endswith(".weight") else 0.0   # the LN scales
            t.copy_(torch.from_numpy((base + 0.05 * rng.randn(*t.shape)).astype(np.float32)))
    return sd


def _images(seed, size, batch=2):
    return np.random.RandomState(seed).randn(batch, size, size, 3).astype(np.float32)


def _jax_apply(module, variables, x, **kw):
    out = jax.jit(lambda v, x: module.apply(v, x, **kw))(variables, jnp.asarray(x))
    return np.asarray(out[0] if isinstance(out, tuple) else out)


def _port_apply(module, state, x):
    module.load_state_dict(state, strict=True)
    module.eval()
    with torch.no_grad():
        out = module(torch.from_numpy(x))
    return (out[0] if isinstance(out, tuple) else out).numpy()


CNN_CASES = {
    "resnet18": (lambda: torchvision_resnet((2, 2, 2, 2), False, 16),
                 lambda sd: jax_convert.convert_resnet(sd, (2, 2, 2, 2), bottleneck=False),
                 lambda sd: port_convert.convert(sd, "resnet18"),
                 lambda: JaxResNet((2, 2, 2, 2), JaxBasicBlock, width=16),
                 lambda: ResNet((2, 2, 2, 2), "basic", width=16)),
    "resnet50_one_block_a_stage": (
        lambda: torchvision_resnet((1, 1, 1, 1), True, 16),
        lambda sd: jax_convert.convert_resnet(sd, (1, 1, 1, 1), bottleneck=True),
        lambda sd: port_convert.to_state_dict(port_convert.convert_resnet(sd, (1, 1, 1, 1))),
        lambda: JaxResNet((1, 1, 1, 1), JaxBottleneck, width=16),
        lambda: ResNet((1, 1, 1, 1), "bottleneck", width=16)),
    "densenet": (lambda: torchvision_densenet((2, 1), 8, 16),
                 lambda sd: jax_convert.convert_densenet(sd, (2, 1)),
                 lambda sd: port_convert.to_state_dict(port_convert.convert_densenet(sd, (2, 1))),
                 lambda: JaxDenseNet((2, 1), growth_rate=8, init_features=16),
                 lambda: DenseNet((2, 1), growth_rate=8, init_features=16)),
}


@pytest.mark.parametrize("case", sorted(CNN_CASES))
def test_cnn_conversion_serves_as_jax(case):
    make_sd, jax_conv, port_conv, jax_model, port_model = CNN_CASES[case]
    sd = make_sd()
    x = _images(1, 32)
    ref = _jax_apply(jax_model(), jax.tree_util.tree_map(jnp.asarray, jax_conv(sd)), x)
    ours = _port_apply(port_model(), port_conv(sd), x)
    assert ours.shape == ref.shape and np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("layerscale", [True, False], ids=["ls", "no_ls"])
def test_dinov2_conversion_serves_as_jax(layerscale):
    sd = hub_dinov2(DINO["embed_dim"], DINO["depth"], DINO["patch_size"], 5, seed=2,
                    layerscale=layerscale)
    x = _images(3, 28)
    ref = _jax_apply(JaxViT(**DINO, img_size=28, exact_gelu=True),
                     jax.tree_util.tree_map(jnp.asarray, jax_convert.convert_dinov2(sd)), x)
    ours = _port_apply(VisionTransformer(**DINO, img_size=28, exact_gelu=True),
                       port_convert.convert(sd, "dinov2_vits14"), x)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("variant", ["clip_vit_b16", "vit_b16_hf", "siglip2"])
def test_hf_conversion_serves_as_jax(variant):
    sd = hf_torch_model(variant, seed=4)
    x = _images(5, 32)
    jm = jax_hf.HuggingFaceVisionWrapper(variant=variant, config_overrides=HF_TINY)
    tree = jax_convert.convert_hf_vision(dict(sd), variant=variant, **HF_TINY)
    ref = _jax_apply(jm, jax.tree_util.tree_map(jnp.asarray, tree), x)
    ours = _port_apply(HuggingFaceVisionWrapper(variant, config_overrides=HF_TINY),
                       port_convert.convert(dict(sd), variant, **HF_TINY), x)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)


def test_hf_conversion_names_a_missing_tensor():
    sd = hf_torch_model("clip_vit_b16")
    sd.pop("vision_model.post_layernorm.weight")
    with pytest.raises(ValueError, match="vision_model.post_layernorm.weight"):
        port_convert.convert(sd, "clip_vit_b16", **HF_TINY)


def _tiny_flagship(patch: int = 14, img: int = 28):
    return get_model("multidino_attention_hashing", device="cpu", backbone="test_tiny",
                     fusion_config={"type": "cross_attention_advanced", "output_dim": 64,
                                    "num_heads": 2},
                     vit_kwargs={"img_size": img, "embed_dim": 128, "num_heads": 2,
                                 "patch_size": patch, "exact_gelu": True})


def test_graft_fills_every_band_as_jax():
    """The converted tower lands in all four bands, as the JAX graft's
    broadcast puts it (the grafted leaves compared through the bridge's
    flax paths), the heads untouched, and each band's CLS feature equals
    the converted ViT's own forward."""
    sd = hub_dinov2(DINO["embed_dim"], DINO["depth"], DINO["patch_size"], 5, seed=6)
    model = _tiny_flagship()
    heads = {k: v.clone() for k, v in model.state_dict().items()
             if not k.startswith("backbone.")}
    pretrained.graft_flagship_backbone(model, port_convert.convert(sd, "dinov2_vits14"))
    jax_tower = jax_pretrained.broadcast_to_bands(jax_convert.convert_dinov2(sd)["params"])
    flat = dict(jax.tree_util.tree_flatten_with_path(jax_tower)[0])
    ours = to_flax_leaves(model, {n: p.detach() for n, p in model.named_parameters()
                                  if n.startswith("backbone.vit.")})
    prefix = "BandedViT_0/VmapVisionTransformer_0/"
    assert len(ours) == len(flat)
    for path, leaf in flat.items():
        key = prefix + "/".join(str(getattr(p, "key", p)) for p in path)
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(leaf, np.float32), key)
    for k, v in heads.items():
        assert torch.equal(model.state_dict()[k], v), k
    x = _images(7, 28)
    vit = VisionTransformer(**DINO, img_size=28, exact_gelu=True)
    single = _port_apply(vit, port_convert.convert(sd, "dinov2_vits14"), x)
    with torch.no_grad():
        bands = model.backbone.vit(torch.from_numpy(np.stack([x] * 4)))
    for s in range(4):
        np.testing.assert_allclose(bands[s].numpy(), single, rtol=0, atol=TOL)


def test_graft_single_vit_loads_the_tower():
    sd = hub_dinov2(64, 2, 8, 5, seed=8)   # one 64-wide head: the hub layout's
    model = get_model("dino_hash_baseline", device="cpu", backbone="test_tiny",
                      vit_kwargs={"img_size": 16, "exact_gelu": True})
    pretrained.graft_single_vit(model, port_convert.convert(sd, "dinov2_vits14"))
    assert torch.equal(model.backbone.pos_embed, sd["pos_embed"][0].float())


def test_graft_refuses_a_mismatched_tree():
    model = _tiny_flagship()
    converted = port_convert.convert(
        hub_dinov2(DINO["embed_dim"], DINO["depth"], DINO["patch_size"], 5), "dinov2_vits14")
    with pytest.raises(ValueError, match="structure"):
        pretrained.graft_flagship_backbone(
            model, {k: v for k, v in converted.items() if not k.startswith("blocks.1.")})
    wide = port_convert.convert(hub_dinov2(DINO["embed_dim"], DINO["depth"],
                                           DINO["patch_size"], 10), "dinov2_vits14")
    with pytest.raises(ValueError, match=r"pos_embed: model \(4, 5, 128\) vs converted "
                                         r"\(4, 10, 128\)"):
        pretrained.graft_flagship_backbone(model, wide)


def test_cli_round_trip(tmp_path):
    """``.pth`` (a torchvision checkpoint, under ``state_dict`` as some
    files keep it) → ``--kind resnet18`` → ``.pt`` → ``load_converted``."""
    sd = torchvision_resnet((2, 2, 2, 2), False, 64, seed=9)
    torch.save({"state_dict": sd}, tmp_path / "r18.pth")
    port_convert.main(["--kind", "resnet18", "--src", str(tmp_path / "r18.pth"),
                       "--dst", str(tmp_path / "r18.pt")])
    state = pretrained.load_converted(str(tmp_path / "r18.pt"))
    model = ResNet((2, 2, 2, 2), "basic")
    model.load_state_dict(state, strict=True)
    assert all(v.dtype == torch.float32 for v in state.values())
    assert torch.equal(model.stem.weight, sd["conv1.weight"])
