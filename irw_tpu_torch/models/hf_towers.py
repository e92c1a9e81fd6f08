"""The transformers vision towers of the HF vision wrapper, native in PyTorch.

In the JAX package these towers are transformers' Flax modules, built from a
config by ``irw_tpu/models/hf_wrapper.py``; here each computes what its Flax
module computes, and its parameters carry the Flax (and the torch
transformers) names:

- ``CLIPVisionTower`` (``FlaxCLIPVisionModule``, ``models/clip/
  modeling_flax_clip.py``): ``vision_model.embeddings`` (``class_embedding``
  (D,), a patch conv WITHOUT bias, ``position_embedding`` an N + 1 row
  table) → ``pre_layrnorm`` → ``encoder.layers.{i}`` (``layer_norm1``,
  ``self_attn.{q,k,v,out}_proj``, ``layer_norm2``, ``mlp.fc1``/``fc2``) →
  the pooled output ``post_layernorm(last_hidden[:, 0])``.  Defaults of
  ``CLIPVisionConfig``: ``quick_gelu``, LayerNorm eps 1e-5.
- ``ViTTower`` (``FlaxViTModule``, ``models/vit/modeling_flax_vit.py``):
  ``embeddings`` (``cls_token`` (1, 1, D), ``position_embeddings``
  (1, N + 1, D), ``patch_embeddings.projection`` a patch conv WITH bias) →
  ``encoder.layer.{i}`` (``layernorm_before``, ``attention.attention.{query,
  key,value}``, ``attention.output.dense``, the residual,
  ``layernorm_after``, ``intermediate.dense`` and ``hidden_act``,
  ``output.dense``, the residual) → ``layernorm`` → the pooled output
  ``tanh(pooler.dense(h[:, 0]))``.  Defaults of ``ViTConfig``: exact erf
  GELU, LayerNorm eps 1e-12.

Both position tables have a fixed length, as the Flax modules' (no
interpolation): an input whose patch count differs raises, as JAX's
broadcast of the sum does.  Attention is flax's ``dot_product_attention``
(q / √hd, f32 scores and softmax), no kernel: transformers' Flax towers
reach no Pallas kernel.  No dropout: every dropout rate of both configs is 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from irw_tpu_torch.models.layers import LayerNorm, Linear, trunc_normal_
from irw_tpu_torch.models.siglip import attend, init_linears, resolve_act
from irw_tpu_torch.models.vit import PatchEmbed

# transformers' Flax ACT2FN (modeling_flax_utils.py), the names a CLIP or ViT
# config may give as hidden_act
HF_ACTIVATIONS = {
    "gelu": F.gelu,
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
}


def _group(**children) -> nn.Module:
    """A module that only names its children (a level of the Flax tree)."""
    group = nn.Module()
    for name, child in children.items():
        group.add_module(name, child)
    return group


def _check_patches(n: int, table: int, what: str):
    if n != table:
        raise ValueError(f"{what}: {n} patches against a position table of {table} rows; the "
                         "table has a fixed length (image_size // patch_size squared), as the "
                         "Flax module's")


def _normal_(t: torch.Tensor, std: float, generator=None):
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


class _CLIPLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate_size: int, eps: float, act: str):
        super().__init__()
        self.num_heads = num_heads
        self.act = resolve_act(act, HF_ACTIVATIONS)
        self.layer_norm1 = LayerNorm(dim, eps)
        self.self_attn = _group(**{n: Linear(dim, dim)
                                   for n in ("q_proj", "k_proj", "v_proj", "out_proj")})
        self.layer_norm2 = LayerNorm(dim, eps)
        self.mlp = _group(fc1=Linear(dim, intermediate_size), fc2=Linear(intermediate_size, dim))

    def forward(self, x):
        a, h = self.self_attn, self.layer_norm1(x)
        x = x + a.out_proj(attend(a.q_proj(h), a.k_proj(h), a.v_proj(h), self.num_heads))
        return x + self.mlp.fc2(self.act(self.mlp.fc1(self.layer_norm2(x))))


class CLIPVisionTower(nn.Module):
    """``FlaxCLIPVisionModule``: (B, H, W, C) → (pooled (B, D), last hidden
    state (B, N + 1, D), not post-normed)."""

    def __init__(self, hidden_size: int = 768, num_hidden_layers: int = 12,
                 num_attention_heads: int = 12, image_size: int = 224, patch_size: int = 16,
                 intermediate_size: int = 3072, hidden_act: str = "quick_gelu",
                 layer_norm_eps: float = 1e-5, in_chans: int = 3):
        super().__init__()
        d, eps = hidden_size, layer_norm_eps
        self.num_patches = (image_size // patch_size) ** 2
        self.vision_model = _group(
            embeddings=_group(patch_embedding=PatchEmbed(in_chans, d, patch_size, bias=False),
                              position_embedding=nn.Embedding(self.num_patches + 1, d)),
            pre_layrnorm=LayerNorm(d, eps),
            encoder=_group(layers=nn.ModuleList(
                _CLIPLayer(d, num_attention_heads, intermediate_size, eps, hidden_act)
                for _ in range(num_hidden_layers))),
            post_layernorm=LayerNorm(d, eps))
        self.vision_model.embeddings.class_embedding = nn.Parameter(torch.empty(d))

    def fit_grid(self, height: int, width: int):
        """JAX's init at (height, width): the table keeps its length, so a
        grid of another patch count raises."""
        p = self.vision_model.embeddings.patch_embedding.patch_size
        _check_patches((height // p) * (width // p), self.num_patches, "CLIP vision tower")

    def reset_parameters(self, generator=None):
        emb = self.vision_model.embeddings
        init_linears(self, generator)
        for lin in (m for m in self.modules() if isinstance(m, Linear)):
            _normal_(lin.weight, 0.01, generator)
        _normal_(emb.class_embedding, 0.02, generator)
        _normal_(emb.patch_embedding.weight, 0.01, generator)
        _normal_(emb.position_embedding.weight, 0.01, generator)

    def forward(self, x):
        vm = self.vision_model
        emb = vm.embeddings
        patches = emb.patch_embedding(x)                                 # (B, N, D)
        b, n, d = patches.shape
        _check_patches(n, self.num_patches, "CLIP vision tower")
        h = torch.cat([emb.class_embedding.expand(b, 1, d), patches], dim=1)
        h = vm.pre_layrnorm(h + emb.position_embedding.weight)
        for layer in vm.encoder.layers:
            h = layer(h)
        return vm.post_layernorm(h[:, 0]), h


class _ViTLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate_size: int, eps: float, act: str):
        super().__init__()
        self.num_heads = num_heads
        self.act = resolve_act(act, HF_ACTIVATIONS)
        self.attention = _group(
            attention=_group(query=Linear(dim, dim), key=Linear(dim, dim),
                             value=Linear(dim, dim)),
            output=_group(dense=Linear(dim, dim)))
        self.intermediate = _group(dense=Linear(dim, intermediate_size))
        self.output = _group(dense=Linear(intermediate_size, dim))
        self.layernorm_before = LayerNorm(dim, eps)
        self.layernorm_after = LayerNorm(dim, eps)

    def forward(self, x):
        a, h = self.attention.attention, self.layernorm_before(x)
        ctx = attend(a.query(h), a.key(h), a.value(h), self.num_heads)
        x = x + self.attention.output.dense(ctx)
        h = self.act(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(h)


class ViTTower(nn.Module):
    """``FlaxViTModule`` with its pooler: (B, H, W, C) → (pooled (B, D),
    last hidden state (B, N + 1, D), after ``layernorm``)."""

    def __init__(self, hidden_size: int = 768, num_hidden_layers: int = 12,
                 num_attention_heads: int = 12, image_size: int = 224, patch_size: int = 16,
                 intermediate_size: int = 3072, hidden_act: str = "gelu",
                 layer_norm_eps: float = 1e-12, in_chans: int = 3):
        super().__init__()
        d, eps = hidden_size, layer_norm_eps
        self.num_patches = (image_size // patch_size) ** 2
        self.embeddings = _group(patch_embeddings=_group(
            projection=PatchEmbed(in_chans, d, patch_size)))
        self.embeddings.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.embeddings.position_embeddings = nn.Parameter(torch.empty(1, self.num_patches + 1, d))
        self.encoder = _group(layer=nn.ModuleList(
            _ViTLayer(d, num_attention_heads, intermediate_size, eps, hidden_act)
            for _ in range(num_hidden_layers)))
        self.layernorm = LayerNorm(d, eps)
        self.pooler = _group(dense=Linear(d, d))

    def fit_grid(self, height: int, width: int):
        """JAX's init at (height, width): as ``CLIPVisionTower.fit_grid``."""
        p = self.embeddings.patch_embeddings.projection.patch_size
        _check_patches((height // p) * (width // p), self.num_patches, "ViT tower")

    def reset_parameters(self, generator=None):
        """ViTConfig's init: every kernel and token truncated normal at
        0.02/√fan_in (flax ``variance_scaling``), biases zero."""
        emb = self.embeddings
        init_linears(self, generator)
        proj = emb.patch_embeddings.projection
        for w in [proj.weight] + [m.weight for m in self.modules() if isinstance(m, Linear)]:
            trunc_normal_(w, 0.02 / math.sqrt(math.prod(w.shape[1:])) / 0.87962566, generator)
        nn.init.zeros_(proj.bias)
        trunc_normal_(emb.cls_token, 0.02 / 0.87962566, generator)
        trunc_normal_(emb.position_embeddings,
                      0.02 / math.sqrt(emb.position_embeddings.shape[1]) / 0.87962566, generator)

    def forward(self, x):
        emb = self.embeddings
        patches = emb.patch_embeddings.projection(x)                     # (B, N, D)
        b, n, d = patches.shape
        _check_patches(n, self.num_patches, "ViT tower")
        h = torch.cat([emb.cls_token.expand(b, 1, d), patches], dim=1) + emb.position_embeddings
        for layer in self.encoder.layer:
            h = layer(h)
        h = self.layernorm(h)
        return torch.tanh(self.pooler.dense(h[:, 0])), h
