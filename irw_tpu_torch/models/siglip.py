"""SigLIP vision tower (port of ``irw_tpu/models/siglip.py``): the
architecture behind the ``siglip2`` backbone (``configs/model/siglip2.yaml``,
google/siglip2-base-patch16-224).

Patch conv with bias (no CLS token) → + learned position embeddings →
pre-LN encoder layers ``layers_{i}`` (``layer_norm1``, ``q_proj``/``k_proj``/
``v_proj``/``out_proj``, ``layer_norm2``, ``fc1``/``fc2`` around
``hidden_act``) → ``post_layernorm`` → the attention-pooling ``head``: a
learned (1, 1, D) ``probe`` attends over the tokens, then
``attn_out + mlp(layernorm(attn_out))``, token 0.  The parameter names are
the JAX module's.  Attention is flax's dot-product attention, q / √hd in f32:
no kernel of the port runs here, as no Pallas kernel runs in the JAX tower.

At a patch grid of another size than ``image_size // patch_size`` squared
the position table is resized as ``jax.image.resize(..., "bilinear")``
(antialiased when it shrinks), ``ops.wavelets.resize.resize_bilinear``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from irw_tpu_torch.models.layers import LayerNorm, Linear
from irw_tpu_torch.models.vit import PatchEmbed, _div_sqrt
from irw_tpu_torch.ops.wavelets.resize import resize_bilinear

# the torch transformers ACT2FN names reproduced exactly (siglip.py:41-55); a
# checkpoint config with another hidden_act fails rather than diverge
_ACTIVATIONS = {
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": F.gelu,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "relu": F.relu,
}


def resolve_act(name: str, table: dict = _ACTIVATIONS):
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"unsupported hidden_act {name!r}; supported: {sorted(table)}") from None


def attend(q, k, v, num_heads: int):
    """flax dot-product attention over heads: q (B, Nq, D), k and v (B, N, D)
    → (B, Nq, D); q / √hd with the divisor rounded to q's dtype, scores and
    softmax in that dtype."""
    b, nq, d = q.shape
    hd = d // num_heads
    q, k, v = (t.reshape(b, -1, num_heads, hd) for t in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", _div_sqrt(q, hd), k)
    ctx = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return ctx.reshape(b, nq, d)


def init_linears(module: nn.Module, generator=None):
    """Every Linear of ``module`` lecun-normal with zero bias (flax Dense's
    init), every LayerNorm ones and zeros."""
    for m in module.modules():
        if isinstance(m, Linear):
            m.reset_parameters(generator)
        elif isinstance(m, LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


class SiglipAttentionBlock(nn.Module):
    """One pre-LN encoder layer: x += attn(ln1(x)); x += mlp(ln2(x))."""

    def __init__(self, dim: int, num_heads: int, intermediate_size: int,
                 layer_norm_eps: float = 1e-6, hidden_act: str = "gelu_pytorch_tanh"):
        super().__init__()
        self.num_heads = num_heads
        self.act = resolve_act(hidden_act)
        self.layer_norm1 = LayerNorm(dim, layer_norm_eps)
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(dim, dim)
                                                                for _ in range(4))
        self.layer_norm2 = LayerNorm(dim, layer_norm_eps)
        self.fc1 = Linear(dim, intermediate_size)
        self.fc2 = Linear(intermediate_size, dim)

    def forward(self, x):
        h = self.layer_norm1(x)
        x = x + self.out_proj(attend(self.q_proj(h), self.k_proj(h), self.v_proj(h),
                                     self.num_heads))
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


class SiglipPoolingHead(nn.Module):
    """The multihead-attention pooling head: the probe cross-attends over the
    tokens, then a residual MLP on its LayerNorm (named ``layernorm``);
    returns token 0."""

    def __init__(self, dim: int, num_heads: int, intermediate_size: int,
                 layer_norm_eps: float = 1e-6, hidden_act: str = "gelu_pytorch_tanh"):
        super().__init__()
        self.num_heads = num_heads
        self.act = resolve_act(hidden_act)
        self.probe = nn.Parameter(torch.empty(1, 1, dim))
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(dim, dim)
                                                                for _ in range(4))
        self.layernorm = LayerNorm(dim, layer_norm_eps)
        self.fc1 = Linear(dim, intermediate_size)
        self.fc2 = Linear(intermediate_size, dim)

    def forward(self, tokens):
        probe = self.probe.expand(tokens.shape[0], 1, -1)
        attn_out = self.out_proj(attend(self.q_proj(probe), self.k_proj(tokens),
                                        self.v_proj(tokens), self.num_heads))
        h = self.fc2(self.act(self.fc1(self.layernorm(attn_out))))
        return (attn_out + h)[:, 0]


class SiglipVisionTower(nn.Module):
    """Patch conv → + position embeddings → encoder → post-LN →
    attention pool.  (B, H, W, C) → (pooled (B, D), last hidden state)."""

    def __init__(self, hidden_size: int = 768, num_layers: int = 12, num_heads: int = 12,
                 patch_size: int = 16, image_size: int = 224, intermediate_size: int = 3072,
                 layer_norm_eps: float = 1e-6, hidden_act: str = "gelu_pytorch_tanh",
                 in_chans: int = 3):
        super().__init__()
        self.num_layers = num_layers
        self.patch_embedding = PatchEmbed(in_chans, hidden_size, patch_size)
        self.position_embedding = nn.Parameter(
            torch.empty((image_size // patch_size) ** 2, hidden_size))
        for i in range(num_layers):
            self.add_module(f"layers_{i}", SiglipAttentionBlock(
                hidden_size, num_heads, intermediate_size, layer_norm_eps, hidden_act))
        self.post_layernorm = LayerNorm(hidden_size, layer_norm_eps)
        self.head = SiglipPoolingHead(hidden_size, num_heads, intermediate_size,
                                      layer_norm_eps, hidden_act)

    def reset_parameters(self, generator=None):
        self.patch_embedding.reset_parameters(generator)
        init_linears(self, generator)
        d = self.position_embedding.shape[-1]
        with torch.no_grad():
            self.position_embedding.normal_(0.0, 1.0 / math.sqrt(d), generator=generator)
            self.head.probe.normal_(0.0, 1.0, generator=generator)

    def positions(self, gh: int, gw: int):
        """The (gh·gw, D) position rows of a gh × gw grid: the table itself
        when it holds gh·gw rows, else its square grid resized."""
        pos = self.position_embedding
        num_pos, d = pos.shape
        if gh * gw == num_pos:
            return pos
        side = math.isqrt(num_pos)
        return resize_bilinear(pos.reshape(side, side, d), (gh, gw)).reshape(gh * gw, d)

    def forward(self, x):
        p = self.patch_embedding.patch_size
        h = self.patch_embedding(x)
        h = h + self.positions(x.shape[-3] // p, x.shape[-2] // p)
        for i in range(self.num_layers):
            h = getattr(self, f"layers_{i}")(h)
        h = self.post_layernorm(h)
        return self.head(h), h
