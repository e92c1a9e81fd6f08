"""Convert pretrained torch checkpoints into the port's state dicts (port of
``tools/convert_torch_weights.py``).

Reads the same state-dict files as the JAX tool: torchvision's ResNets and
DenseNet-121, torch.hub's DINOv2 ViTs and the transformers vision towers
(CLIP, HF ViT, SigLIP), and writes the state dict of the port's module for
the kind (``models.resnet.ResNet``, ``models.densenet.DenseNet``,
``models.vit.VisionTransformer``, ``models.hf_wrapper.HuggingFaceVisionWrapper``)
as a ``.pt`` file of f32 tensors, which ``utils.pretrained.load_converted``
reads:

    python -m irw_tpu_torch.tools.convert_torch_weights --kind resnet50 \\
        --src r50.pth --dst r50.pt
    python -m irw_tpu_torch.tools.convert_torch_weights --kind dinov2_vits14 \\
        --src dinov2_vits14_pretrain.pth --dst dinov2_vits14.pt
    python -m irw_tpu_torch.tools.convert_torch_weights --kind siglip2 \\
        --src model.pth --dst siglip2.pt --config-json config.json

The ResNet, DenseNet, DINOv2 and SigLIP layouts are the JAX tool's own
numpy code (``convert_resnet``, ``convert_densenet``, ``convert_dinov2``,
``convert_siglip``: torch → flax trees), carried into the port's names by
``bridge.from_jax_variables``.  The CLIP and HF ViT towers keep the
transformers names (``models/hf_towers.py``), so their state dict maps
directly (``convert_hf_vision``; the JAX tool goes through transformers'
own torch → flax rules).  The source is read with
``torch.load(weights_only=True)`` (the JAX tool unpickles with
``weights_only=False``): a checkpoint that pickles more than tensors and
containers is refused.  ``--scan`` is accepted for the JAX tool's command
lines; the port's ViT keeps one module per block either way.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

HF_KINDS = ("clip_vit_b32", "clip_vit_b16", "vit_b16_hf", "siglip2", "metaclip2")
RESNET_STAGES = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
KINDS = (*RESNET_STAGES, "densenet121", "dinov2_vits14", "dinov2_vitb14", *HF_KINDS)


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _conv(sd, key):
    return {"kernel": _t(sd[key + ".weight"]).transpose(2, 3, 1, 0)}


def _bn(sd, key):
    return ({"scale": _t(sd[key + ".weight"]), "bias": _t(sd[key + ".bias"])},
            {"mean": _t(sd[key + ".running_mean"]), "var": _t(sd[key + ".running_var"])})


def convert_resnet(sd: dict, stage_sizes=(3, 4, 6, 3), bottleneck: bool = True) -> dict:
    """torchvision ResNet state dict → flax ``ResNet`` variables
    (``convert_torch_weights.py:42-95``): OIHW → HWIO, the blocks as
    ``Bottleneck_i``/``BasicBlock_i`` in order, BatchNorm affine and
    running statistics."""
    params, stats = {}, {}
    params["Conv_0"] = _conv(sd, "conv1")
    params["BatchNorm_0"], stats["BatchNorm_0"] = _bn(sd, "bn1")
    block_name = "Bottleneck" if bottleneck else "BasicBlock"
    n_convs = 3 if bottleneck else 2
    block_i = 0
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        for b in range(n_blocks):
            prefix = f"layer{stage}.{b}"
            bp, bs = {}, {}
            for c in range(n_convs):
                bp[f"Conv_{c}"] = _conv(sd, f"{prefix}.conv{c + 1}")
                bp[f"BatchNorm_{c}"], bs[f"BatchNorm_{c}"] = _bn(sd, f"{prefix}.bn{c + 1}")
            if f"{prefix}.downsample.0.weight" in sd:
                bp[f"Conv_{n_convs}"] = _conv(sd, f"{prefix}.downsample.0")
                bp[f"BatchNorm_{n_convs}"], bs[f"BatchNorm_{n_convs}"] = _bn(
                    sd, f"{prefix}.downsample.1")
            params[f"{block_name}_{block_i}"], stats[f"{block_name}_{block_i}"] = bp, bs
            block_i += 1
    return {"params": params, "batch_stats": stats}


def convert_densenet(sd: dict, block_sizes=(6, 12, 24, 16)) -> dict:
    """torchvision DenseNet state dict → flax ``DenseNet`` variables
    (``convert_torch_weights.py:98-127``)."""
    params, stats = {}, {}
    params["Conv_0"] = _conv(sd, "features.conv0")
    params["BatchNorm_0"], stats["BatchNorm_0"] = _bn(sd, "features.norm0")
    dl = tr = 0
    for bi, n_layers in enumerate(block_sizes, start=1):
        for li in range(1, n_layers + 1):
            pre = f"features.denseblock{bi}.denselayer{li}"
            bp, bs = {}, {}
            bp["BatchNorm_0"], bs["BatchNorm_0"] = _bn(sd, f"{pre}.norm1")
            bp["Conv_0"] = _conv(sd, f"{pre}.conv1")
            bp["BatchNorm_1"], bs["BatchNorm_1"] = _bn(sd, f"{pre}.norm2")
            bp["Conv_1"] = _conv(sd, f"{pre}.conv2")
            params[f"DenseLayer_{dl}"], stats[f"DenseLayer_{dl}"] = bp, bs
            dl += 1
        if bi < len(block_sizes):
            pre = f"features.transition{bi}"
            tp, ts = {}, {}
            tp["BatchNorm_0"], ts["BatchNorm_0"] = _bn(sd, f"{pre}.norm")
            tp["Conv_0"] = _conv(sd, f"{pre}.conv")
            params[f"Transition_{tr}"], stats[f"Transition_{tr}"] = tp, ts
            tr += 1
    params["BatchNorm_1"], stats["BatchNorm_1"] = _bn(sd, "features.norm5")
    return {"params": params, "batch_stats": stats}


def convert_dinov2(sd: dict) -> dict:
    """torch.hub DINOv2 ViT state dict → flax ``VisionTransformer``
    variables, unrolled ``Block_i`` (``convert_torch_weights.py:130-186``):
    the fused qkv split into query/key/value (D, H, hd) with 64-wide heads,
    the projection (H, hd, D), a missing LayerScale 1e-5."""
    p: dict = {"cls_token": _t(sd["cls_token"]), "pos_embed": _t(sd["pos_embed"]),
               "PatchEmbed_0": {"Conv_0": {
                   "kernel": _t(sd["patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
                   "bias": _t(sd["patch_embed.proj.bias"])}}}
    depth = max(int(k.split(".")[1]) for k in sd if k.startswith("blocks.")) + 1
    for i in range(depth):
        b = f"blocks.{i}"
        dim = _t(sd[f"{b}.norm1.weight"]).shape[0]
        heads = dim // 64
        qkv_w = np.split(_t(sd[f"{b}.attn.qkv.weight"]), 3, axis=0)   # 3 × (D, D)
        qkv_b = np.split(_t(sd[f"{b}.attn.qkv.bias"]), 3, axis=0)
        attn = {name: {"kernel": w.T.reshape(dim, heads, dim // heads),
                       "bias": bb.reshape(heads, dim // heads)}
                for name, w, bb in zip(("query", "key", "value"), qkv_w, qkv_b)}
        attn["out"] = {"kernel": _t(sd[f"{b}.attn.proj.weight"]).T.reshape(heads, dim // heads,
                                                                           dim),
                       "bias": _t(sd[f"{b}.attn.proj.bias"])}

        def ls(name):
            key = f"{b}.{name}.gamma"
            return _t(sd[key]) if key in sd else np.ones(dim) * 1e-5

        p[f"Block_{i}"] = {
            "norm1": {"LayerNorm_0": {"scale": _t(sd[f"{b}.norm1.weight"]),
                                      "bias": _t(sd[f"{b}.norm1.bias"])}},
            "attn": attn,
            "ls1": ls("ls1"),
            "norm2": {"LayerNorm_0": {"scale": _t(sd[f"{b}.norm2.weight"]),
                                      "bias": _t(sd[f"{b}.norm2.bias"])}},
            "Mlp_0": {"Dense_0": {"kernel": _t(sd[f"{b}.mlp.fc1.weight"]).T,
                                  "bias": _t(sd[f"{b}.mlp.fc1.bias"])},
                      "Dense_1": {"kernel": _t(sd[f"{b}.mlp.fc2.weight"]).T,
                                  "bias": _t(sd[f"{b}.mlp.fc2.bias"])}},
            "ls2": ls("ls2"),
        }
    p["norm"] = {"LayerNorm_0": {"scale": _t(sd["norm.weight"]), "bias": _t(sd["norm.bias"])}}
    return {"params": p}


def convert_siglip(sd: dict) -> dict:
    """torch ``SiglipVisionModel`` state dict → the flax variables of
    ``HuggingFaceVisionWrapper(variant='siglip2')``
    (``convert_torch_weights.py:208-266``): Linear (out, in) → kernel
    (in, out), the pooling head's fused ``in_proj`` split row-wise into
    q/k/v."""
    pre = "vision_model."
    sd = {k[len(pre):] if k.startswith(pre) else k: _t(v)
          for k, v in sd.items() if "position_ids" not in k}

    def lin(key):
        return {"kernel": sd[f"{key}.weight"].T, "bias": sd[f"{key}.bias"]}

    def ln(key):
        return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}

    tower: dict = {
        "patch_embedding": {"kernel": sd["embeddings.patch_embedding.weight"].transpose(2, 3, 1, 0),
                            "bias": sd["embeddings.patch_embedding.bias"]},
        "position_embedding": sd["embeddings.position_embedding.weight"],
        "post_layernorm": ln("post_layernorm"),
    }
    depth = max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layers.")) + 1
    for i in range(depth):
        p = f"encoder.layers.{i}"
        tower[f"layers_{i}"] = {
            "layer_norm1": ln(f"{p}.layer_norm1"), "layer_norm2": ln(f"{p}.layer_norm2"),
            "q_proj": lin(f"{p}.self_attn.q_proj"), "k_proj": lin(f"{p}.self_attn.k_proj"),
            "v_proj": lin(f"{p}.self_attn.v_proj"), "out_proj": lin(f"{p}.self_attn.out_proj"),
            "fc1": lin(f"{p}.mlp.fc1"), "fc2": lin(f"{p}.mlp.fc2"),
        }
    d = tower["position_embedding"].shape[-1]
    in_w, in_b = sd["head.attention.in_proj_weight"], sd["head.attention.in_proj_bias"]
    tower["head"] = {
        "probe": sd["head.probe"],
        "q_proj": {"kernel": in_w[:d].T, "bias": in_b[:d]},
        "k_proj": {"kernel": in_w[d:2 * d].T, "bias": in_b[d:2 * d]},
        "v_proj": {"kernel": in_w[2 * d:].T, "bias": in_b[2 * d:]},
        "out_proj": lin("head.attention.out_proj"),
        "layernorm": ln("head.layernorm"),
        "fc1": lin("head.mlp.fc1"), "fc2": lin("head.mlp.fc2"),
    }
    return {"params": {"tower": tower}}


def to_state_dict(variables: dict) -> dict:
    """A flax variables tree → the port module's state dict of f32 tensors
    (``bridge.from_jax_variables``)."""
    from irw_tpu_torch.bridge import from_jax_variables

    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in from_jax_variables(variables).items()}


def convert_hf_vision(sd: dict, variant: str = "clip_vit_b16", **config_overrides) -> dict:
    """A transformers vision-tower state dict (``CLIPVisionModel``,
    ``ViTModel``, ``SiglipVisionModel``) → the state dict of the port's
    ``HuggingFaceVisionWrapper(variant, config_overrides=…)``.  CLIP and
    the HF ViT keep the transformers names under ``tower.``; every entry
    the wrapper holds must be there with its shape (buffers such as
    ``position_ids`` are dropped)."""
    from irw_tpu_torch.models.hf_wrapper import HF_DEFAULT_CONFIGS, HuggingFaceVisionWrapper

    if HF_DEFAULT_CONFIGS[variant]["kind"] == "siglip":
        return to_state_dict(convert_siglip(sd))
    with torch.device("meta"):
        wanted = HuggingFaceVisionWrapper(variant, config_overrides=config_overrides).state_dict()
    out = {}
    for name, ref in wanted.items():
        src = sd.get(name[len("tower."):])
        if src is None or tuple(src.shape) != tuple(ref.shape):
            raise ValueError(f"{variant}: the state dict has "
                             f"{None if src is None else tuple(src.shape)} for "
                             f"{name[len('tower.'):]}, the tower {tuple(ref.shape)}")
        out[name] = torch.as_tensor(_t(src), dtype=torch.float32)
    return out


def convert(sd: dict, kind: str, **config_overrides) -> dict:
    """``sd`` (a torch checkpoint's state dict) → the port's state dict for
    ``kind``."""
    if kind in RESNET_STAGES:
        return to_state_dict(convert_resnet(sd, RESNET_STAGES[kind],
                                            bottleneck=kind != "resnet18"))
    if kind == "densenet121":
        return to_state_dict(convert_densenet(sd))
    if kind in HF_KINDS:
        return convert_hf_vision(sd, variant=kind, **config_overrides)
    if kind.startswith("dinov2_"):
        return to_state_dict(convert_dinov2(sd))
    raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")


def config_overrides_from(path: str) -> dict:
    """The HF preset keys a checkpoint's ``config.json`` sets (its
    ``vision_config`` where it has one)."""
    with open(path) as f:
        cj = json.load(f)
    cj = cj.get("vision_config", cj)
    return {k: cj[k] for k in ("hidden_size", "num_hidden_layers", "num_attention_heads",
                               "image_size", "patch_size", "intermediate_size", "hidden_act",
                               "layer_norm_eps") if k in cj}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--kind", required=True, choices=list(KINDS))
    parser.add_argument("--src", required=True)
    parser.add_argument("--dst", required=True)
    parser.add_argument("--scan", action="store_true",
                        help="the JAX tool's scanned layout; the port's is the same either way")
    parser.add_argument("--config-json", default=None,
                        help="HF kinds only: the checkpoint's own config.json "
                             "(vision_config honoured); its keys override the preset")
    args = parser.parse_args(argv)

    sd = torch.load(args.src, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    overrides = config_overrides_from(args.config_json) if args.config_json else {}
    if overrides and args.kind not in HF_KINDS:
        parser.error("--config-json applies to the HF kinds only")
    torch.save(convert(sd, args.kind, **overrides), args.dst)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
