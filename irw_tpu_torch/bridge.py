"""Carry ``irw_tpu`` (flax) variables into the port's modules.

``from_jax_variables(variables)`` maps a flax variables tree — ``params``
and, for models with BatchNorm, ``batch_stats`` — to a state dict of numpy
arrays for the matching ``irw_tpu_torch`` module.  It needs no JAX: leaves
are read with ``np.asarray``.  Handled layouts:

- the multi-band ViT family: ``BandedViT_0/VmapVisionTransformer_0/…``
  with the band axis leading (``MultiDinoHashing``, ``MultiDinoAttention``)
  or the unbanded ``VisionTransformer_0`` and the top-level (S, P, D)
  ``prompts`` (``SharedDinoHashing``); beside it the fusion head
  (``StandardFusionHead_0``, ``SemanticFusionHead_0``, ``GatedFusionHead_0``,
  ``CrossAttentionBottleneckHead_0`` or ``GateFusionHead_0`` with its
  BatchNorm statistics) and the ``HashHead_0`` (its BatchNorm, or without
  one the Dense bias); or a bare ``VisionTransformer`` tree (its own
  ``prompts`` too);
- a LayerNorm as ``LayerNorm_0/{scale,bias}``, or a DSLN's per-domain
  ``scale``/``bias`` of shape (num_domains, D);
- ``BandedResNet_0/VmapResNet_0/…`` with the band axis leading (a ``WCNN``,
  ``WCNNAttention``, ``WaveResNet`` or ``WaveResNetCE``, whose 1×1 stem
  kernel is (1, 1, 3, 64); the subband gate's Dense or ECA conv and the
  classifiers ``DenseGeneral_0`` (``branch_classifiers``) and ``Dense_0``
  beside it), or a bare ``ResNet`` tree (``Conv_0``, ``BatchNorm_0``,
  ``Bottleneck_i`` or ``BasicBlock_i``), or a bare subband gate;
- the mtwavenet family: ``_BandedStagedResNet_0`` with ``VmapStem_0``,
  ``VmapStage_0..3`` (their blocks numbered per stage, the band axis
  leading), ``att_block1..4`` (``CrossBandAttention``: ``Dense_0``,
  ``Dense_1``, and with its spatial gate ``Conv_0`` and ``BatchNorm_0``) and
  ``branch_ln``; beside it ``DenseGeneral_0``, ``ChannelGate1D_0`` and
  ``Dense_0``; ``HybridMultiBranch``'s ``ResNet_0``, ``VmapDenseNet_0`` and
  ``Dense_0``; a bare ``ChannelGate1D`` or ``CrossBandAttention``;
- the single-trunk models: the baselines' ``VisionTransformer_0`` (or
  ``BandedViT_0``) with its ``HashHead_0`` or classifier ``Dense_0``
  (``DINOHashBaseline``, ``SingleBandNet``, ``DinoModelCE``,
  ``MultiDinoModel``); ``ResNet_0`` with ``Dense_0`` (and ``LayerNorm_0``)
  of the hashing ResNets, ``ResNet50Mod``'s ``ResNet50DSCH_0``;
  ``RetrievalNet``'s ``backbone``, ``LayerNorm_0`` and projection
  ``fc/Dense_i`` (with ``BatchNorm_i`` or ``LayerNorm_i`` between); bare
  ``DenseNet`` (``DenseLayer_i``, ``Transition_i``) and ``ConvNeXt``
  (``ConvNeXtBlock_i``, whose depthwise kernel (7, 7, 1, C) becomes
  (C, 1, 7, 7)) trees;
- the scanned block stack ``blocks/Block_0/…`` with a depth axis after the
  band axis (``tools/convert_torch_weights.py:189-205``), its grouped form
  ``blocks/inner/Block_0/…`` (depth split as (G, k)), and unrolled
  ``Block_i``;
- MHA kernels (D, H, hd) and (H, hd, D) → Linear (H·hd, D) and (D, H·hd);
  a ``use_flash`` Block's ``attn_qkv`` kernel (D, 3, H, hd) and bias
  (3, H, hd) → Linear (3·H·hd, D) and (3·H·hd,), its ``attn_out`` as Dense;
- the HF vision wrapper's ``tower`` (``models/hf_wrapper.py``), alone or as
  ``RetrievalNet``'s ``backbone``: CLIP's ``vision_model/{embeddings,
  pre_layrnorm,encoder/layers/<i>,post_layernorm}``, the HF ViT's
  ``{embeddings,encoder/layer/<i>,layernorm,pooler}`` and SigLIP's
  ``{patch_embedding,position_embedding,layers_<i>,post_layernorm,head}``,
  each level named as the port's module; an ``nn.Embed`` table
  (``embedding``) → ``weight``;
- Dense (in, out) → Linear (out, in);
- conv HWIO → OIHW (the inverse of ``convert_torch_weights.py:131-186``);
- ``batch_stats`` mean/var → BatchNorm ``running_mean``/``running_var``.

``load_jax_loss_params`` carries a JAX train state's ``loss_params`` (the
HashLoss and HHF proxies, ArcFace's class weights, and the nested trees of
``MultiLoss``'s ``b<i>_l<j>`` and ``MultiEmbeddingLoss``'s ``inner``) into
the port's loss modules.
"""

from __future__ import annotations

import numpy as np


def _a(x) -> np.ndarray:
    return np.asarray(x)


def _dense(t) -> dict:
    out = {"weight": np.swapaxes(_a(t["kernel"]), -1, -2)}
    if "bias" in t:
        out["bias"] = _a(t["bias"])
    return out


def _ln(t) -> dict:
    return {"weight": _a(t["scale"]), "bias": _a(t["bias"])}


def _domain_ln(t) -> dict:
    """A ``DomainLayerNorm``: its ``LayerNorm_0`` child with one domain, its
    own (num_domains, D) ``scale``/``bias`` with several."""
    return _ln(t["LayerNorm_0"] if "LayerNorm_0" in t else t)


def _mha(t) -> dict:
    out = {}
    for name in ("query", "key", "value"):
        k, b = _a(t[name]["kernel"]), _a(t[name]["bias"])     # (…, D, H, hd), (…, H, hd)
        out[f"{name}.weight"] = np.swapaxes(k.reshape(*k.shape[:-2], -1), -1, -2)
        out[f"{name}.bias"] = b.reshape(*b.shape[:-2], -1)
    k = _a(t["out"]["kernel"])                                 # (…, H, hd, D)
    out["out.weight"] = np.swapaxes(k.reshape(*k.shape[:-3], -1, k.shape[-1]), -1, -2)
    out["out.bias"] = _a(t["out"]["bias"])
    return out


def _flash_mha(t) -> dict:
    """A ``use_flash`` Block's ``attn_qkv`` and ``attn_out`` → ``FlashAttention``."""
    k, b = _a(t["attn_qkv"]["kernel"]), _a(t["attn_qkv"]["bias"])  # (…, D, 3, H, hd), (…, 3, H, hd)
    out = {"qkv.weight": np.swapaxes(k.reshape(*k.shape[:-3], -1), -1, -2),
           "qkv.bias": b.reshape(*b.shape[:-3], -1)}
    out.update(_prefixed("out", _dense(t["attn_out"])))
    return out


def _prefixed(prefix: str, d: dict) -> dict:
    return {f"{prefix}.{k}": v for k, v in d.items()}


def _block(t) -> dict:
    sd = {}
    sd.update(_prefixed("norm1", _domain_ln(t["norm1"])))
    sd.update(_prefixed("attn", _flash_mha(t) if "attn_qkv" in t else _mha(t["attn"])))
    sd["ls1"] = _a(t["ls1"])
    sd.update(_prefixed("norm2", _domain_ln(t["norm2"])))
    sd.update(_prefixed("mlp.fc1", _dense(t["Mlp_0"]["Dense_0"])))
    sd.update(_prefixed("mlp.fc2", _dense(t["Mlp_0"]["Dense_1"])))
    sd["ls2"] = _a(t["ls2"])
    return sd


def _map_leaves(fn, tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(_a(tree))


def _block_trees(t, lead: int) -> list:
    """Per-block parameter trees; ``lead`` = number of band axes before depth."""
    if "blocks" in t:
        stack = t["blocks"]
        if "inner" in stack:  # grouped remat scan: (…, G, k, …) → (…, G·k, …)
            stack = _map_leaves(
                lambda x: x.reshape(*x.shape[:lead], -1, *x.shape[lead + 2:]),
                stack["inner"])
        stack = stack["Block_0"]
        depth = _a(stack["ls1"]).shape[lead]
        return [_map_leaves(lambda x, i=i: np.take(x, i, axis=lead), stack)
                for i in range(depth)]
    blocks = []
    while f"Block_{len(blocks)}" in t:
        blocks.append(t[f"Block_{len(blocks)}"])
    return blocks


def _vit(t, lead: int) -> dict:
    sd = {}
    conv = t["PatchEmbed_0"]["Conv_0"]
    k = _a(conv["kernel"])                                     # (…, p, p, C, D)
    sd["patch_embed.weight"] = np.moveaxis(k, (-1, -2), (-4, -3))  # (…, D, C, p, p)
    sd["patch_embed.bias"] = _a(conv["bias"])
    cls, pos = _a(t["cls_token"]), _a(t["pos_embed"])          # (…, 1, 1, D), (…, 1, N, D)
    sd["cls_token"] = cls.reshape(*cls.shape[:-3], 1, cls.shape[-1])
    sd["pos_embed"] = pos.reshape(*pos.shape[:-3], *pos.shape[-2:])
    for i, blk in enumerate(_block_trees(t, lead)):
        sd.update(_prefixed(f"blocks.{i}", _block(blk)))
    sd.update(_prefixed("norm", _domain_ln(t["norm"])))
    if "prompts" in t:
        sd["prompts"] = _a(t["prompts"])
    return sd


_HEADS = ("StandardFusionHead_0", "SemanticFusionHead_0", "GatedFusionHead_0",
          "CrossAttentionBottleneckHead_0", "GateFusionHead_0")


def _fusion_head(t, stats) -> dict:
    """A fusion head's tree (and its ``batch_stats``) → its state dict."""
    if "BatchNorm_0" in t:  # GateFusionHead: a subband gate, Dense, BatchNorm
        gate = next(k for k in _GATES if k in t)
        return {**_prefixed("gate", _gate(t[gate])), **_prefixed("fc", _dense(t["Dense_0"])),
                **_prefixed("bn", _batch_norm(t["BatchNorm_0"], stats["BatchNorm_0"]))}
    sd = {}
    for key in ("query_token", "query_tokens"):
        if key in t:
            sd[key] = _a(t[key])
    if "_AttnCore_0" in t:
        sd.update(_prefixed("core.attn",
                            _mha(t["_AttnCore_0"]["MultiHeadDotProductAttention_0"])))
    if "Dense_0" in t:  # GatedFusionHead: the gate net's Dense layers, at the head's level
        sd.update(_prefixed("gate_fc1", _dense(t["Dense_0"])))
        sd.update(_prefixed("gate_fc2", _dense(t["Dense_1"])))
    sd.update(_prefixed("norm1", _ln(t["norm1"])))
    sd.update(_prefixed("mlp.fc1", _dense(t["Mlp_0"]["Dense_0"])))
    sd.update(_prefixed("mlp.fc2", _dense(t["Mlp_0"]["Dense_1"])))
    if "out_proj" in t:
        sd.update(_prefixed("out_proj", _dense(t["out_proj"])))
    sd.update(_prefixed("norm2", _ln(t["norm2"])))
    i = 0
    while f"proj_{i}" in t:
        sd.update(_prefixed(f"proj.{i}", _dense(t[f"proj_{i}"])))
        i += 1
    return sd


def _conv(kernel) -> np.ndarray:
    """flax conv kernel (…, kh, kw, in, out) → torch (…, out, in, kh, kw)."""
    return np.moveaxis(_a(kernel), (-1, -2), (-4, -3))


def _batch_norm(params, stats) -> dict:
    return {"weight": _a(params["scale"]), "bias": _a(params["bias"]),
            "running_mean": _a(stats["mean"]), "running_var": _a(stats["var"]),
            "num_batches_tracked": np.array(0, dtype=np.int64)}


def _resnet(params, stats) -> dict:
    """A ``ResNet`` tree (no band axis) → ``models.resnet.ResNet``."""
    sd = {"stem.weight": _conv(params["Conv_0"]["kernel"])}
    sd.update(_prefixed("stem_norm", _batch_norm(params["BatchNorm_0"], stats["BatchNorm_0"])))
    name = "Bottleneck" if "Bottleneck_0" in params else "BasicBlock"
    i = 0
    while f"{name}_{i}" in params:
        blk, blk_stats = params[f"{name}_{i}"], stats[f"{name}_{i}"]
        j = 0
        while f"Conv_{j}" in blk:
            sd[f"blocks.{i}.convs.{j}.weight"] = _conv(blk[f"Conv_{j}"]["kernel"])
            sd.update(_prefixed(f"blocks.{i}.norms.{j}",
                                _batch_norm(blk[f"BatchNorm_{j}"], blk_stats[f"BatchNorm_{j}"])))
            j += 1
        i += 1
    return sd


def _gate(tree) -> dict:
    """A subband gate's own tree → its state dict: ``SubbandCBAM``
    (``SubbandChannelGate_0``), ``SubbandChannelGate`` (``Dense_0``,
    ``Dense_1``: the MLP shared by both pools) or ``SubbandEca`` (``Conv_0``,
    kernel (k, 1, 1))."""
    if "SubbandChannelGate_0" in tree:
        return _prefixed("gate", _gate(tree["SubbandChannelGate_0"]))
    if "Conv_0" in tree:
        return {"weight": _a(tree["Conv_0"]["kernel"]).reshape(1, 1, -1)}
    return {**_prefixed("fc1", _dense(tree["Dense_0"])), **_prefixed("fc2", _dense(tree["Dense_1"]))}


_GATES = ("SubbandCBAM_0", "SubbandEca_0", "SubbandChannelGate_0")


def _take(tree, s: int):
    """Band ``s`` of a tree whose leaves lead with the band axis."""
    return _map_leaves(lambda x: x[s], tree)


def _wcnn(variables) -> dict:
    """``WCNN`` / ``WCNNAttention`` / ``WaveResNet(CE)``: per-band ResNets,
    gate, classifiers."""
    params = variables["params"]
    tree = params["BandedResNet_0"]["VmapResNet_0"]
    stats = variables["batch_stats"]["BandedResNet_0"]["VmapResNet_0"]
    bands = _a(tree["Conv_0"]["kernel"]).shape[0]
    sd = {}
    for s in range(bands):
        sd.update(_prefixed(f"backbone.branches.{s}",
                            _resnet(_take(tree, s), _take(stats, s))))
    return {**sd, **_heads(params)}


def _heads(params) -> dict:
    """The heads beside a wavelet CNN's trunk: a subband gate or
    ``ChannelGate1D_0`` → ``gate``, the per-band classifier
    (``DenseGeneral_0``, or ``branch_classifiers``) → ``branch_classifier``,
    ``Dense_0`` → ``classifier``."""
    sd = {}
    for name in (*_GATES, "ChannelGate1D_0"):
        if name in params:
            sd.update(_prefixed("gate", _gate(params[name])))
    for name in ("DenseGeneral_0", "branch_classifiers"):
        if name in params:
            sd.update(_prefixed("branch_classifier", _dense(params[name])))
    if "Dense_0" in params:
        sd.update(_prefixed("classifier", _dense(params["Dense_0"])))
    return sd


def _cross_band(params, stats) -> dict:
    """A ``CrossBandAttention``: its MLP, and the spatial gate's conv and
    BatchNorm where it has them."""
    sd = {**_prefixed("fc1", _dense(params["Dense_0"])),
          **_prefixed("fc2", _dense(params["Dense_1"]))}
    if "Conv_0" in params:
        sd["spatial.weight"] = _conv(params["Conv_0"]["kernel"])
        sd.update(_prefixed("spatial_norm", _batch_norm(params["BatchNorm_0"],
                                                        stats["BatchNorm_0"])))
    return sd


def _staged(params, stats) -> dict:
    """``_BandedStagedResNet_0`` → ``BandedStagedResNet``: each band's stem
    and stages gathered into one ``ResNet`` tree (blocks numbered across the
    stages), the stage attentions and the LayerNorm."""
    bands = _a(params["VmapStem_0"]["Conv_0"]["kernel"]).shape[0]
    flat_p, flat_s = dict(params["VmapStem_0"]), dict(stats["VmapStem_0"])
    stage = block = 0
    while f"VmapStage_{stage}" in params:
        p, st = params[f"VmapStage_{stage}"], stats[f"VmapStage_{stage}"]
        name = "Bottleneck" if "Bottleneck_0" in p else "BasicBlock"
        j = 0
        while f"{name}_{j}" in p:
            flat_p[f"{name}_{block}"] = p[f"{name}_{j}"]
            flat_s[f"{name}_{block}"] = st[f"{name}_{j}"]
            j, block = j + 1, block + 1
        stage += 1
    sd = {}
    for s in range(bands):
        sd.update(_prefixed(f"branches.{s}", _resnet(_take(flat_p, s), _take(flat_s, s))))
    for i in range(stage):
        sd.update(_prefixed(f"att_blocks.{i}", _cross_band(params[f"att_block{i + 1}"],
                                                           stats.get(f"att_block{i + 1}", {}))))
    if "branch_ln" in params:
        sd.update(_prefixed("branch_ln", _ln(params["branch_ln"])))
    return sd


def _mtwavenet(params, stats) -> dict:
    """``FourBranchResNet(50)`` / ``FourBranchResNet50Fusion``."""
    sd = _prefixed("backbone", _staged(params["_BandedStagedResNet_0"],
                                       stats["_BandedStagedResNet_0"]))
    return {**sd, **_heads(params)}


def _hybrid(params, stats) -> dict:
    """``HybridMultiBranch``: the LL ResNet, the per-band DenseNets, the
    classifier."""
    sd = _prefixed("ll_trunk", _resnet(params["ResNet_0"], stats["ResNet_0"]))
    dense_p, dense_s = params["VmapDenseNet_0"], stats["VmapDenseNet_0"]
    for s in range(_a(dense_p["Conv_0"]["kernel"]).shape[0]):
        sd.update(_prefixed(f"detail_trunks.{s}", _densenet(_take(dense_p, s),
                                                            _take(dense_s, s))))
    return {**sd, **_heads(params)}


def _densenet(params, stats) -> dict:
    """A ``DenseNet`` tree → ``models.densenet.DenseNet``."""
    sd = {"stem.weight": _conv(params["Conv_0"]["kernel"])}
    sd.update(_prefixed("stem_norm", _batch_norm(params["BatchNorm_0"], stats["BatchNorm_0"])))
    for kind, prefix, parts in (("DenseLayer", "layers", (("norm1", "BatchNorm_0"),
                                                          ("conv1", "Conv_0"),
                                                          ("norm2", "BatchNorm_1"),
                                                          ("conv2", "Conv_1"))),
                                ("Transition", "transitions", (("norm", "BatchNorm_0"),
                                                               ("conv", "Conv_0")))):
        i = 0
        while f"{kind}_{i}" in params:
            t, st = params[f"{kind}_{i}"], stats[f"{kind}_{i}"]
            for port, jax_name in parts:
                key = f"{prefix}.{i}.{port}"
                if jax_name.startswith("Conv"):
                    sd[f"{key}.weight"] = _conv(t[jax_name]["kernel"])
                else:
                    sd.update(_prefixed(key, _batch_norm(t[jax_name], st[jax_name])))
            i += 1
    sd.update(_prefixed("norm", _batch_norm(params["BatchNorm_1"], stats["BatchNorm_1"])))
    return sd


def _conv_bias(t) -> dict:
    out = {"weight": _conv(t["kernel"])}
    if "bias" in t:
        out["bias"] = _a(t["bias"])
    return out


def _convnext(params) -> dict:
    """A ``ConvNeXt`` tree → ``models.convnext.ConvNeXt``: ``Conv_0`` and
    ``LayerNorm_0`` the stem, ``LayerNorm_s``/``Conv_s`` the downsampling
    before stage s, the last ``LayerNorm`` the final norm."""
    sd = {**_prefixed("stem", _conv_bias(params["Conv_0"])),
          **_prefixed("stem_norm", _ln(params["LayerNorm_0"]))}
    stages = sum(1 for k in params if k.startswith("Conv_"))
    for s in range(1, stages):
        sd.update(_prefixed(f"down_norms.{s - 1}", _ln(params[f"LayerNorm_{s}"])))
        sd.update(_prefixed(f"downsamples.{s - 1}", _conv_bias(params[f"Conv_{s}"])))
    sd.update(_prefixed("norm", _ln(params[f"LayerNorm_{stages}"])))
    i = 0
    while f"ConvNeXtBlock_{i}" in params:
        t = params[f"ConvNeXtBlock_{i}"]
        sd.update(_prefixed(f"blocks.{i}", {
            **_prefixed("dwconv", _conv_bias(t["Conv_0"])),
            **_prefixed("norm", _ln(t["LayerNorm_0"])),
            **_prefixed("fc1", _dense(t["Dense_0"])), **_prefixed("fc2", _dense(t["Dense_1"])),
            "gamma": _a(t["gamma"])}))
        i += 1
    return sd


def _hf_tree(t) -> dict:
    """An HF tower's flax tree → its state dict, level by level: a Dense
    (2-D ``kernel``), a Conv (4-D ``kernel``), a LayerNorm (``scale``), an
    ``nn.Embed`` (``embedding``) or a bare parameter."""
    sd = {}
    for name, sub in t.items():
        if not hasattr(sub, "items"):
            sd[name] = _a(sub)
        elif "kernel" in sub:
            sd.update(_prefixed(name, _conv_bias(sub) if _a(sub["kernel"]).ndim == 4
                                else _dense(sub)))
        elif "scale" in sub:
            sd.update(_prefixed(name, _ln(sub)))
        elif "embedding" in sub:
            sd[f"{name}.weight"] = _a(sub["embedding"])
        else:
            sd.update(_prefixed(name, _hf_tree(sub)))
    return sd


def _trunk(params, stats) -> dict:
    """A bare trunk: ViT, DenseNet, ConvNeXt, ResNet or the HF wrapper."""
    if "tower" in params:
        return _hf_tree(params)
    if "PatchEmbed_0" in params:
        return _vit(params, lead=0)
    if "DenseLayer_0" in params:
        return _densenet(params, stats)
    if "ConvNeXtBlock_0" in params:
        return _convnext(params)
    return _resnet(params, stats)


def _projection(params, stats) -> dict:
    """``ProjectionHead``: ``Dense_i`` → ``layers.i``, the norm between
    layers i and i + 1 (``BatchNorm_i`` or ``LayerNorm_i``) → ``norms.i``."""
    sd, i = {}, 0
    while f"Dense_{i}" in params:
        sd.update(_prefixed(f"layers.{i}", _dense(params[f"Dense_{i}"])))
        if f"BatchNorm_{i}" in params:
            sd.update(_prefixed(f"norms.{i}", _batch_norm(params[f"BatchNorm_{i}"],
                                                          stats[f"BatchNorm_{i}"])))
        elif f"LayerNorm_{i}" in params:
            sd.update(_prefixed(f"norms.{i}", _ln(params[f"LayerNorm_{i}"])))
        i += 1
    return sd


def _single_trunk(params, stats) -> dict:
    """The hashing ResNets (``ResNet_0``, ``LayerNorm_0``, ``Dense_0``),
    ``ResNet50Mod`` (``ResNet50DSCH_0``) and ``RetrievalNet`` (``backbone``,
    ``LayerNorm_0``, ``fc``)."""
    if "ResNet50DSCH_0" in params:
        return _prefixed("dsch", _single_trunk(params["ResNet50DSCH_0"],
                                               stats["ResNet50DSCH_0"]))
    if "ResNet_0" in params:
        sd = _prefixed("trunk", _resnet(params["ResNet_0"], stats["ResNet_0"]))
        if "Dense_0" in params:
            sd.update(_prefixed("fc", _dense(params["Dense_0"])))
    else:
        sd = _prefixed("backbone", _trunk(params["backbone"], stats.get("backbone", {})))
        if "fc" in params:
            sd.update(_prefixed("fc", _projection(params["fc"], stats.get("fc", {}))))
    if "LayerNorm_0" in params:
        sd.update(_prefixed("norm", _ln(params["LayerNorm_0"])))
    return sd


def _hash_head(params, stats) -> dict:
    """``HashHead_0``: the Dense, then its BatchNorm, or its bias without one."""
    sd = _prefixed("linear", _dense(params["Dense_0"]))
    if "BatchNorm_0" in params:
        sd.update(_prefixed("bn", _batch_norm(params["BatchNorm_0"], stats["BatchNorm_0"])))
    return sd


def from_jax_variables(variables) -> dict:
    """flax variables of a model of the multi-band ViT family, a baseline, a
    single-trunk model, a ``VisionTransformer``, ``ResNet``, ``DenseNet`` or
    ``ConvNeXt``, a fusion head, a wavelet CNN (``WCNN``, ``WCNNAttention``,
    ``WaveResNet(CE)``, the mtwavenet family, ``HybridMultiBranch``), the HF
    vision wrapper, a subband gate, ``ChannelGate1D`` or
    ``CrossBandAttention`` → the port
    module's state dict (numpy arrays).  A bare ``ChannelGate1D`` or
    ``CrossBandAttention`` without its spatial gate is the subband gate's
    tree (``fc1``, ``fc2``)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if "norm2" in params or ("BatchNorm_0" in params and any(g in params for g in _GATES)):
        return _fusion_head(params, stats)
    if "BandedResNet_0" in params:
        return _wcnn(variables)
    if "tower" in params:
        return _hf_tree(params)
    if "_BandedStagedResNet_0" in params:
        return _mtwavenet(params, stats)
    if "VmapDenseNet_0" in params:
        return _hybrid(params, stats)
    if {"Dense_0", "Dense_1", "Conv_0"} <= set(params) <= {"Dense_0", "Dense_1", "Conv_0",
                                                          "BatchNorm_0"}:
        return _cross_band(params, stats)   # with its spatial gate
    if "PatchEmbed_0" in params or ("Conv_0" in params and ("BatchNorm_0" in params
                                                            or "LayerNorm_0" in params)):
        return _trunk(params, stats)
    if set(params) in ({"SubbandChannelGate_0"}, {"Conv_0"}, {"Dense_0", "Dense_1"}):
        return _gate(params)
    if {"ResNet_0", "ResNet50DSCH_0", "backbone"} & set(params):
        return _single_trunk(params, stats)
    heads = [k for k in params if k in _HEADS]
    if len(heads) > 1:
        raise ValueError(f"expected one fusion head, found {heads} in {sorted(params)}")
    if "BandedViT_0" in params:
        sd = _prefixed("backbone.vit",
                       _vit(params["BandedViT_0"]["VmapVisionTransformer_0"], lead=1))
    elif "VisionTransformer_0" in params:
        # the shared tower of the family, or a baseline's bare ViT
        sd = _prefixed("backbone.vit" if heads else "backbone",
                       _vit(params["VisionTransformer_0"], lead=0))
        if "prompts" in params:
            sd["prompts"] = _a(params["prompts"])
    else:
        raise ValueError(f"no bridge for a tree with {sorted(params)}; the port carries the "
                         "multi-band ViT family, the baselines, the single-trunk models, "
                         "VisionTransformer, ResNet, DenseNet, ConvNeXt, the wavelet CNNs "
                         "and the gates")
    if heads:
        sd.update(_prefixed("head", _fusion_head(params[heads[0]], stats.get(heads[0], {}))))
    elif "Dense_0" in params:  # DinoModelCE's classifier
        sd.update(_prefixed("classifier", _dense(params["Dense_0"])))
    if "HashHead_0" in params:
        sd.update(_prefixed("hash_head", _hash_head(params["HashHead_0"],
                                                    stats.get("HashHead_0", {}))))
    return sd


def load_jax_variables(model, variables):
    """Load flax ``variables`` into ``model`` strictly (every parameter and
    buffer must be covered, with matching shapes); returns ``model``."""
    import torch

    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in from_jax_variables(variables).items()}
    model.load_state_dict(sd, strict=True)
    return model


def _flatten(tree, prefix: str = "") -> dict:
    """A nested dict of leaves → {"a.b.leaf": leaf}; empty subtrees vanish."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


def load_jax_loss_params(losses, loss_params):
    """Load a JAX train state's ``loss_params`` (loss index → tree, e.g.
    ``{"0": {"proxies": (C, D)}}`` or ``{"0": {"b0_l1": {"weights": …}}}``)
    into the port's ``[(loss, weight)]``, strictly; returns ``losses``."""
    import torch

    for idx, (loss, _) in enumerate(losses):
        tree = _flatten(loss_params.get(str(idx)) or {})
        loss.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32))
                              for k, v in tree.items()}, strict=True)
    return losses


# ---------------------------------------------------------------------------
# the port's names → flax paths and layouts (the inverse of the mapping above)
# ---------------------------------------------------------------------------

# owner class → {the port's child, or a ModuleList ``a`` for each of its items
# ``a.i``: its flax scope relative to the owner's; "" where the child's
# parameters sit at the owner's level (a band axis), "../x" a sibling scope}
_SCOPES = {
    "BandedViT": {"vit": "VmapVisionTransformer_0"},
    "SharedViT": {"vit": "VisionTransformer_0"},
    "VisionTransformer": {"patch_embed": "PatchEmbed_0/Conv_0"},
    "Block": {"attn": "attn", "mlp": "Mlp_0"},
    "FlashAttention": {"qkv": "../attn_qkv", "out": "../attn_out"},
    "Mlp": {"fc1": "Dense_0", "fc2": "Dense_1"},
    "AttnCore": {"attn": "MultiHeadDotProductAttention_0"},
    "HashHead": {"linear": "Dense_0", "bn": "BatchNorm_0"},
    "GatedFusionHead": {"gate_fc1": "Dense_0", "gate_fc2": "Dense_1", "mlp": "Mlp_0"},
    "GateFusionHead": {"fc": "Dense_0", "bn": "BatchNorm_0"},
    "SubbandCBAM": {"gate": "SubbandChannelGate_0"},
    "SubbandChannelGate": {"fc1": "Dense_0", "fc2": "Dense_1"},
    "ChannelGate1D": {"fc1": "Dense_0", "fc2": "Dense_1"},
    "CrossBandAttention": {"fc1": "Dense_0", "fc2": "Dense_1", "spatial": "Conv_0",
                           "spatial_norm": "BatchNorm_0"},
    "BandedResNet": {"branches": ""},
    "BandedStagedResNet": {"branches": ""},
    "ResNet": {"stem": "Conv_0", "stem_norm": "BatchNorm_0"},
    "DenseNet": {"stem": "Conv_0", "stem_norm": "BatchNorm_0", "norm": "BatchNorm_1"},
    "DenseLayer": {"norm1": "BatchNorm_0", "conv1": "Conv_0", "norm2": "BatchNorm_1",
                   "conv2": "Conv_1"},
    "Transition": {"norm": "BatchNorm_0", "conv": "Conv_0"},
    "ConvNeXt": {"stem": "Conv_0", "stem_norm": "LayerNorm_0"},
    "ConvNeXtBlock": {"dwconv": "Conv_0", "norm": "LayerNorm_0", "fc1": "Dense_0",
                      "fc2": "Dense_1"},
    "FourBranchResNet": {"backbone": "_BandedStagedResNet_0",
                         "branch_classifier": "DenseGeneral_0"},
    "FourBranchResNet50Fusion": {"backbone": "_BandedStagedResNet_0",
                                 "branch_classifier": "DenseGeneral_0",
                                 "gate": "ChannelGate1D_0", "classifier": "Dense_0"},
    "HybridMultiBranch": {"ll_trunk": "ResNet_0", "detail_trunks": "VmapDenseNet_0",
                          "classifier": "Dense_0"},
    "RetrievalNet": {"backbone": "backbone", "norm": "LayerNorm_0", "fc": "fc"},
    "ResNetCE": {"trunk": "ResNet_0", "fc": "Dense_0"},
    "ResNetHashing": {"trunk": "ResNet_0", "fc": "Dense_0", "norm": "LayerNorm_0"},
    "ResNet50DSCH": {"trunk": "ResNet_0", "fc": "Dense_0", "norm": "LayerNorm_0"},
    "ResNet50Mod": {"dsch": "ResNet50DSCH_0"},
    "HuggingFaceVisionWrapper": {"tower": "tower"},
}
_QUERY_HEADS = ("StandardFusionHead", "SemanticFusionHead", "CrossAttentionBottleneckHead")
_WAVELET_CNNS = ("WCNN", "WCNNAttention", "WaveResNet", "WaveResNetCE")
_FAMILY = ("MultiDinoHashing", "MultiDinoAttention", "SharedDinoHashing",
           "PromptedSharedDinoHashing", "PretrainedMultiDinoHashing", "MultiDinoHashingTF",
           "DINOHashBaseline", "SingleBandNet", "DinoModelCE", "MultiDinoModel")
# owner classes whose children carry their flax names: the attention modules'
# query/key/value/out, and the HF towers (plain ``Module`` containers included)
_OWN_NAMES = ("Attention", "FusedMHA", "SplitCLSMHA", "QuantMHA", "MultiHeadAttention", "Module",
              "CLIPVisionTower", "_CLIPLayer", "ViTTower", "_ViTLayer", "SiglipVisionTower",
              "SiglipAttentionBlock", "SiglipPoolingHead")
# owner classes with rules below, where a child they do not name keeps its
# name (a fusion head's ``norm1``/``norm2``/``out_proj``, ``branch_ln``)
_RULED = (*_SCOPES, *_QUERY_HEADS, *_WAVELET_CNNS, *_FAMILY, *_OWN_NAMES, "BasicBlock",
          "Bottleneck", "ProjectionHead")
_SCALES = ("LayerNorm", "FusedLayerNorm", "DomainLayerNorm", "BatchNorm", "BatchNorm1d",
           "BatchNorm2d")


def _child_scope(owner, name: str, child, parent) -> str:
    """The flax scope (relative to ``owner``'s) of ``owner``'s child ``name``
    (``a.i`` for item i of the ModuleList ``a``); ``parent`` is ``owner``'s
    own parent, None at the root.  Raises for an owner class it has no rules
    for."""
    kind, child_kind = type(owner).__name__, type(child).__name__
    head, _, index = name.partition(".")
    if kind not in _RULED:
        raise ValueError(f"no flax scope for the children of a {kind} (child {name!r}); "
                         "bridge.jax_module_paths covers the layouts from_jax_variables reads")
    if kind == "ResNet" and type(parent).__name__ == "BandedStagedResNet":
        # one band of the staged trunk: VmapStem_0, VmapStage_k with blocks from 0 a stage
        if head != "blocks":
            return f"VmapStem_0/{_SCOPES['ResNet'][name]}"
        i = int(index)
        stage = next(k for k, end in enumerate(owner.stage_ends) if i < end)
        return f"VmapStage_{stage}/{child_kind}_{i - (owner.stage_ends[stage - 1] if stage else 0)}"
    rules = _SCOPES.get(kind, {})
    if name in rules or head in rules:
        return rules.get(name, rules.get(head))
    if kind == "VisionTransformer" and head == "blocks":
        if not getattr(owner, "scan_blocks", False):
            return f"Block_{index}"
        return "blocks/inner/Block_0" if getattr(owner, "scan_group", 1) > 1 else \
            "blocks/Block_0"
    if kind in ("VisionTransformer", "Block") and child_kind in ("LayerNorm", "FusedLayerNorm"):
        return f"{name}/LayerNorm_0"  # a DomainLayerNorm of one domain
    if kind in _FAMILY or kind in _WAVELET_CNNS:
        if name == "hash_head":
            return "HashHead_0"
        if name in ("head", "gate"):
            return f"{child_kind}_0"
        if name == "classifier":
            return "Dense_0"
        if name == "branch_classifier":
            return "branch_classifiers" if kind == "WaveResNetCE" else "DenseGeneral_0"
        if name == "backbone":
            # SharedViT is the port's alone: its ViT sits at the model's level
            return {"VisionTransformer": "VisionTransformer_0", "BandedViT": "BandedViT_0",
                    "BandedResNet": "BandedResNet_0/VmapResNet_0"}.get(child_kind, "")
    if kind == "GateFusionHead" and name == "gate":
        return f"{child_kind}_0"
    if kind in _QUERY_HEADS or kind == "GatedFusionHead":
        if name == "core":
            return "_AttnCore_0"
        if name == "mlp":
            return "Mlp_0"
        if head == "proj":
            return f"proj_{index}"
    if kind in ("ResNet", "ConvNeXt") and head == "blocks":
        return f"{child_kind}_{index}"
    if kind in ("BasicBlock", "Bottleneck") and head in ("convs", "norms"):
        return f"{'Conv' if head == 'convs' else 'BatchNorm'}_{index}"
    if kind == "DenseNet" and head in ("layers", "transitions"):
        return f"{child_kind}_{index}"
    if kind == "ConvNeXt":
        # LayerNorm_s and Conv_s downsample before stage s; the last LayerNorm is the final norm
        if head in ("down_norms", "downsamples"):
            return f"{'LayerNorm' if head == 'down_norms' else 'Conv'}_{int(index) + 1}"
        if name == "norm":
            return f"LayerNorm_{len(owner.downsamples) + 1}"
    if kind == "BandedStagedResNet" and head == "att_blocks":
        return f"att_block{int(index) + 1}"
    if kind == "ProjectionHead":
        if head == "layers":
            return f"Dense_{index}"
        if head == "norms":
            return f"{'BatchNorm' if child_kind == 'BatchNorm' else 'LayerNorm'}_{index}"
    return name.replace(".", "/")


def _join(prefix: str, scope: str) -> str:
    while scope.startswith("../"):
        prefix, scope = prefix.rpartition("/")[0], scope[3:]
    return "/".join(p for p in (prefix, scope) if p)


def jax_module_paths(model) -> dict:
    """Each module of ``model`` (its name in ``named_modules``, "" for the
    model) → the flax scope path of the module the bridge reads its
    parameters from, e.g. ``hash_head.linear`` → ``HashHead_0/Dense_0`` and,
    in the banded ViT, ``backbone.vit.blocks.2.mlp`` →
    ``BandedViT_0/VmapVisionTransformer_0/Block_2/Mlp_0`` (with
    ``scan_blocks``, ``…/blocks/Block_0/Mlp_0``).  It covers the layouts
    listed in this module's docstring, and raises for a module class it has
    no rules for."""
    import torch.nn as nn

    out = {"": ""}

    def walk(module, parent, port: str, scope: str):
        for name, child in module.named_children():
            items = ([(f"{name}.{i}", c) for i, c in child.named_children()]
                     if isinstance(child, nn.ModuleList) else [(name, child)])
            for cname, c in items:
                port_name = f"{port}.{cname}" if port else cname
                out[port_name] = _join(scope, _child_scope(module, cname, c, parent))
                walk(c, module, port_name, out[port_name])

    walk(model, None, "", "")
    return out


def jax_param_paths(model) -> dict:
    """Each parameter of ``model`` → the flax path of the leaf the bridge
    carries into it: its module's scope (``jax_module_paths``) and the leaf's
    flax name (``kernel`` of a Dense or Conv, ``scale`` of a LayerNorm or
    BatchNorm, ``embedding`` of an ``nn.Embed``, else its own name)."""
    modules = dict(model.named_modules())
    scopes = jax_module_paths(model)
    out = {}
    for name, _ in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        kind = type(modules[owner]).__name__
        if leaf == "weight":
            if kind in _SCALES:
                leaf = "scale"
            elif kind == "Embedding":
                leaf = "embedding"
            elif kind == "SubbandEca":
                leaf = "Conv_0/kernel"
            else:
                leaf = "kernel"
        out[name] = _join(scopes[owner], leaf)
    return out


def _flax_layout(module, attr: str, leaf: str, parent, t):
    """``t``, shaped as the parameter ``leaf`` of ``module`` (``attr`` in
    ``parent``), in the layout of the flax leaf the bridge reads it from:
    the inverse of the transposes and reshapes above."""
    import torch

    kind = type(module).__name__
    h = getattr(parent, "num_heads", None)
    if leaf == "weight" and (kind == "PatchEmbed" or isinstance(module, torch.nn.Conv2d)):
        return torch.movedim(t, (-4, -3), (-1, -2))     # OIHW → HWIO
    if leaf == "weight" and kind == "SubbandEca":
        return t.reshape(-1, 1, 1)
    if leaf in ("cls_token", "pos_embed"):
        return t.unsqueeze(-3)
    if not isinstance(module, torch.nn.Linear) and kind not in ("Linear", "QuantDense"):
        return t
    if leaf == "weight":
        t = t.transpose(-1, -2)                          # (…, in, out)
        if h and attr == "out" and type(parent).__name__ != "FlashAttention":
            return t.reshape(*t.shape[:-2], h, -1, t.shape[-1])
    if h and attr in ("query", "key", "value"):
        return t.reshape(*t.shape[:-1], h, -1)
    if h and attr == "qkv":
        return t.reshape(*t.shape[:-1], 3, h, -1)
    return t


def to_flax_leaves(model, tensors: dict) -> dict:
    """``tensors``, {``model``'s parameter name: a tensor of its shape} (its
    gradient, say) → {flax path: the tensor in the flax leaf's layout}.
    Several port tensors on one flax leaf are a band or scan axis: the
    per-band trunks stacked on the leading axis, a scanned ViT's blocks on
    its depth axis (after the band axis of ``BandedViT_0``; as (G, k) in a
    grouped scan)."""
    import torch

    modules = dict(model.named_modules())
    paths = jax_param_paths(model)
    grouped: dict = {}
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        parent = modules[owner.rpartition(".")[0]] if owner else None
        grouped.setdefault(paths[name], []).append(
            (name, _flax_layout(modules[owner], owner.rpartition(".")[2], leaf, parent, t)))
    out = {}
    for path, items in grouped.items():
        if len(items) == 1:
            out[path] = items[0][1]
            continue
        axis = 1 if path.startswith("BandedViT_0") else 0
        stacked = torch.stack([t for _, t in items], dim=axis)
        if "/blocks/inner/" in f"/{path}":
            vit = modules[items[0][0].rpartition(".blocks.")[0]]
            stacked = stacked.reshape(*stacked.shape[:axis], vit.scan_group, -1,
                                      *stacked.shape[axis + 1:])
        out[path] = stacked
    return out
