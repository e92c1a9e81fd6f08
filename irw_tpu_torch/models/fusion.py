"""Learned-query cross-attention fusion over subband embeddings (port of
``irw_tpu/models/fusion.py:30-64, 135-195, 217-261``).

The head takes the per-band embedding stack (B, S, D_in) and returns
``(fused, aux)`` with ``aux["ortho_loss"]``, ``aux["ortho_raw"]`` and
``aux["attn_weights"]``.  It runs in f32: the bands arrive in the backbone's
compute dtype and flax promotes them against the f32 parameters
(fusion.py:153), so they are cast the same way here.  In training mode it
applies dropout (inside the MHA, broadcast over batch and heads, and after
its MLP), the subband-LL dropout, and the ortho loss; the masks come from
the ``rngs`` generators passed to ``forward`` (flax's ``dropout`` and
``band_drop`` streams).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from irw_tpu_torch.models.layers import LayerNorm, Linear, Mlp, l2_normalize, trunc_normal_
from irw_tpu_torch.ops.attention import dot_product_attention


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (f32, no kernel): q from
    ``inputs_q``, k and v from ``inputs_kv``; dropout on the probabilities
    in training mode."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.query, self.key, self.value, self.out = (Linear(dim, dim) for _ in range(4))

    def forward(self, inputs_q, inputs_kv, generator: torch.Generator | None = None):
        h = self.num_heads
        d = inputs_q.shape[-1]
        q = self.query(inputs_q).reshape(*inputs_q.shape[:-1], h, d // h)
        k = self.key(inputs_kv).reshape(*inputs_kv.shape[:-1], h, d // h)
        v = self.value(inputs_kv).reshape(*inputs_kv.shape[:-1], h, d // h)
        o = dot_product_attention(q, k, v, dropout_rate=self.dropout,
                                  deterministic=not self.training, generator=generator)
        return self.out(o.reshape(inputs_q.shape))


class AttnCore(nn.Module):
    """``_AttnCore`` (fusion.py:43-64): q tokens attend over band tokens.
    ``attn_weights`` is a separate single-head softmax(q·kvᵀ/√d), not the
    MHA's own probabilities (fusion.py:59-63)."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.attn = MultiHeadAttention(dim, num_heads, dropout)

    def forward(self, q, kv, generator: torch.Generator | None = None):
        out = self.attn(q, kv, generator)
        d = q.shape[-1]
        logits = torch.einsum("bqd,bkd->bqk", q, kv) / torch.tensor(math.sqrt(d), dtype=q.dtype)
        return out, torch.softmax(logits, dim=-1)


class CrossAttentionBottleneckHead(nn.Module):
    """N learned query tokens over the bands (fusion.py:135-195).

    Training terms (zero in eval, as ``jnp.where(train, …, 0)``):
    ``advanced`` picks the hinge Gram loss on the query tokens,
    relu(‖q̂q̂ᵀ − I‖_F − margin)²; otherwise the attention-matrix loss
    ‖M Mᵀ − I‖²_F on the batch-mean ``attn_weights``, zeroed when the LL band
    was dropped.  ``ortho_raw`` is the term before ``ortho_weight``.
    """

    def __init__(self, input_dim: int, embed_dim: int = 384, num_queries: int = 4,
                 num_heads: int = 8, dropout: float = 0.1, sub_band_dropout_p: float = 0.3,
                 ortho_weight: float = 0.1, margin: float = 0.0, advanced: bool = False,
                 num_bands: int = 4):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_queries = num_queries
        self.sub_band_dropout_p = sub_band_dropout_p
        self.ortho_weight = ortho_weight
        self.margin = margin
        self.advanced = advanced
        # _project_bands (fusion.py:30-40): one Dense per band, identity when
        # the backbone width already equals embed_dim
        self.proj = (nn.ModuleList(Linear(input_dim, embed_dim) for _ in range(num_bands))
                     if input_dim != embed_dim else None)
        self.query_tokens = nn.Parameter(torch.zeros(1, num_queries, embed_dim))
        self.core = AttnCore(embed_dim, num_heads, dropout)
        self.norm1 = LayerNorm(embed_dim)
        self.mlp = Mlp(embed_dim, embed_dim * 4, embed_dim, dropout=dropout)
        self.out_proj = Linear(embed_dim * num_queries, embed_dim)
        self.norm2 = LayerNorm(embed_dim)

    def reset_parameters(self, generator=None):
        trunc_normal_(self.query_tokens, 0.02, generator)
        for m in self.modules():
            if isinstance(m, Linear):
                m.reset_parameters(generator)

    def forward(self, bands, rngs: dict | None = None):
        rngs = rngs or {}
        bands = bands.float()
        b = bands.shape[0]
        kv = bands if self.proj is None else torch.stack(
            [p(bands[:, i]) for i, p in enumerate(self.proj)], dim=1)
        mask_ll = bands.new_zeros(())
        if self.training and self.sub_band_dropout_p > 0:
            # one draw per batch: drop the LL band for the whole batch
            u = torch.rand((), generator=rngs.get("band_drop"), device=kv.device)
            mask_ll = (u < self.sub_band_dropout_p).float()
            kv = torch.cat([kv[:, :1] * (1.0 - mask_ll), kv[:, 1:]], dim=1)
        qb = self.query_tokens.expand(b, self.num_queries, self.embed_dim)
        attn_out, weights = self.core(qb, kv, rngs.get("dropout"))
        raw = bands.new_zeros(())
        if self.training:
            eye = torch.eye(self.num_queries, device=kv.device)
            if self.advanced:
                qn = l2_normalize(self.query_tokens[0])
                raw = F.relu(torch.linalg.norm(qn @ qn.T - eye) - self.margin) ** 2
            else:
                m = weights.mean(dim=0)
                raw = torch.sum((m @ m.T - eye) ** 2) * (1.0 - mask_ll)
        x = self.norm1(qb + attn_out)
        x = x + self.mlp(x, rngs.get("dropout"))
        x = self.norm2(self.out_proj(x.reshape(b, -1)))
        return x, {"ortho_loss": self.ortho_weight * raw, "ortho_raw": raw,
                   "attn_weights": weights}


_OTHER_HEADS = ("standard", "temperature", "self_attention", "semantic", "gated",
                "temperature_gated", "cbam", "eca")


def get_fusion_head(fusion_config: dict, input_dim: int, num_bands: int = 4):
    """Dispatcher with the reference's config keys (fusion.py:217-261); this
    slice ports the two ``cross_attention_*`` heads."""
    cfg = dict(fusion_config)
    ftype = cfg.get("type", "standard")
    if ftype in ("cross_attention_bottleneck", "cross_attention_advanced"):
        return CrossAttentionBottleneckHead(
            input_dim=input_dim,
            embed_dim=cfg.get("output_dim", 384),
            num_queries=cfg.get("num_queries", 4),
            num_heads=cfg.get("num_heads", 8),
            dropout=cfg.get("dropout", 0.1),
            sub_band_dropout_p=cfg.get("sub_band_dropout_p", 0.3),
            ortho_weight=cfg.get("ortho_weight", 0.1),
            margin=cfg.get("margin", 0.0),
            advanced=ftype == "cross_attention_advanced",
            num_bands=num_bands,
        )
    if ftype in _OTHER_HEADS:
        raise NotImplementedError(f"fusion head {ftype!r} waits for ROADMAP A10")
    raise ValueError(f"unknown fusion head type {ftype!r}")
