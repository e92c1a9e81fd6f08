"""The fusion heads over subband embeddings (port of
``irw_tpu/models/fusion.py``).

Every head takes the per-band embedding stack (B, S, D_in) and returns
``(fused, aux)``: ``aux["ortho_loss"]`` always (zero but for the
cross-attention bottleneck heads, which add ``aux["ortho_raw"]``), and
``aux["attn_weights"]`` (the attention heads) or ``aux["gate"]`` (the gated
and gate heads) for introspection; no loss reads those two.  The heads run
in f32: the bands arrive in the backbone's compute dtype and flax promotes
them against the f32 parameters (fusion.py:153), so they are cast the same
way here, except ``GateFusionHead``, whose subband gate pools in the bands'
dtype as the JAX gate does.  In training mode the heads apply dropout
(inside the MHA, broadcast over batch and heads, after the MLP, or after
the gate head's BatchNorm), the subband-LL dropout and the ortho loss; the
masks come from the ``rngs`` generators passed to ``forward`` (flax's
``dropout`` and ``band_drop`` streams).

``get_fusion_head`` maps the config's ``type`` to a head
(fusion.py:217-261): ``standard``, ``temperature`` (the query token divided
by the temperature) and ``self_attention`` (the query added back before
``norm1``) to ``StandardFusionHead``; ``semantic`` to
``SemanticFusionHead`` (the projected LL band is the query); ``gated`` and
``temperature_gated`` to ``GatedFusionHead``; the two
``cross_attention_*`` types to ``CrossAttentionBottleneckHead``; ``cbam``
and ``eca`` to ``GateFusionHead``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from irw_tpu_torch.models.attention_blocks import SubbandCBAM, SubbandEca
from irw_tpu_torch.models.layers import (
    BatchNorm,
    LayerNorm,
    Linear,
    Mlp,
    apply_dropout,
    l2_normalize,
    trunc_normal_,
)
from irw_tpu_torch.ops.attention import dot_product_attention


def band_projections(input_dim: int, embed_dim: int, num_bands: int):
    """``_project_bands``' parameters (fusion.py:30-40): one Dense per band,
    or None (the identity) when the backbone width already equals
    ``embed_dim``."""
    if input_dim == embed_dim:
        return None
    return nn.ModuleList(Linear(input_dim, embed_dim) for _ in range(num_bands))


def project_bands(proj, bands):
    """(B, S, D_in) → (B, S, E) through ``band_projections``' modules."""
    if proj is None:
        return bands
    return torch.stack([p(bands[:, i]) for i, p in enumerate(proj)], dim=1)


def _reset_linears(module, generator):
    for m in module.modules():
        if isinstance(m, Linear):
            m.reset_parameters(generator)


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


def _zero(x):
    return x.new_zeros((), dtype=torch.float32)


class _QueryHead(nn.Module):
    """The parameters shared by the standard and semantic heads: the band
    projections, the attention core, ``norm1``, the MLP and ``norm2``."""

    def __init__(self, input_dim: int, embed_dim: int, num_heads: int, dropout: float,
                 num_bands: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.proj = band_projections(input_dim, embed_dim, num_bands)
        self.core = AttnCore(embed_dim, num_heads, dropout)
        self.norm1 = LayerNorm(embed_dim)
        self.mlp = Mlp(embed_dim, embed_dim * 4, embed_dim, dropout=dropout)
        self.norm2 = LayerNorm(embed_dim)

    def reset_parameters(self, generator=None):
        _reset_linears(self, generator)

    def _tail(self, x, generator):
        """norm1 → x + MLP(x) → norm2 → the query row."""
        x = self.norm1(x)
        x = x + self.mlp(x, generator)
        return self.norm2(x)[:, 0]


class StandardFusionHead(_QueryHead):
    """One learned query token over the bands (fusion.py:67-89):
    ``temperature`` divides the query before the core (``temperature``),
    ``residual_query`` adds it back before ``norm1`` (``self_attention``)."""

    def __init__(self, input_dim: int, embed_dim: int = 384, num_heads: int = 8,
                 dropout: float = 0.1, residual_query: bool = False,
                 temperature: float | None = None, num_bands: int = 4):
        super().__init__(input_dim, embed_dim, num_heads, dropout, num_bands)
        self.residual_query = residual_query
        self.temperature = temperature
        self.query_token = nn.Parameter(torch.zeros(1, 1, embed_dim))

    def reset_parameters(self, generator=None):
        trunc_normal_(self.query_token, 0.02, generator)
        super().reset_parameters(generator)

    def forward(self, bands, rngs: dict | None = None):
        gen = (rngs or {}).get("dropout")
        bands = bands.float()
        kv = project_bands(self.proj, bands)
        q = self.query_token.expand(bands.shape[0], 1, self.embed_dim)
        if self.temperature is not None:
            q = q / self.temperature
        attn_out, weights = self.core(q, kv, gen)
        x = self._tail(q + attn_out if self.residual_query else attn_out, gen)
        return x, {"ortho_loss": _zero(x), "attn_weights": weights}


class SemanticFusionHead(_QueryHead):
    """The projected LL band is the query (fusion.py:92-107)."""

    def __init__(self, input_dim: int, embed_dim: int = 512, num_heads: int = 4,
                 dropout: float = 0.1, num_bands: int = 4):
        super().__init__(input_dim, embed_dim, num_heads, dropout, num_bands)

    def forward(self, bands, rngs: dict | None = None):
        gen = (rngs or {}).get("dropout")
        kv = project_bands(self.proj, bands.float())
        attn_out, weights = self.core(kv[:, :1], kv, gen)
        x = self._tail(attn_out, gen)
        return x, {"ortho_loss": _zero(x), "attn_weights": weights}


class GatedFusionHead(nn.Module):
    """A sigmoid gate per band from Dense(E/2) → relu → Dense(1), the gated
    bands SUMMED (fusion.py:110-132); ``temperature`` divides the gate's
    logit (``temperature_gated``).  ``aux["gate"]`` is the (B, S) gate."""

    def __init__(self, input_dim: int, embed_dim: int = 512, dropout: float = 0.1,
                 temperature: float | None = None, num_bands: int = 4):
        super().__init__()
        self.embed_dim = embed_dim
        self.temperature = temperature
        self.proj = band_projections(input_dim, embed_dim, num_bands)
        # flax builds these inside the head's compact call: Dense_0, Dense_1
        self.gate_fc1 = Linear(embed_dim, embed_dim // 2)
        self.gate_fc2 = Linear(embed_dim // 2, 1)
        self.norm1 = LayerNorm(embed_dim)
        self.mlp = Mlp(embed_dim, embed_dim * 4, embed_dim, dropout=dropout)
        self.norm2 = LayerNorm(embed_dim)

    def reset_parameters(self, generator=None):
        _reset_linears(self, generator)

    def forward(self, bands, rngs: dict | None = None):
        gen = (rngs or {}).get("dropout")
        feats = project_bands(self.proj, bands.float())
        raw = self.gate_fc2(F.relu(self.gate_fc1(feats)))       # (B, S, 1)
        if self.temperature is not None:
            raw = raw / self.temperature
        gates = torch.sigmoid(raw)
        x = self.norm1((feats * gates).sum(dim=1))
        x = self.norm2(x + self.mlp(x, gen))
        return x, {"ortho_loss": _zero(x), "gate": gates[..., 0]}


class GateFusionHead(nn.Module):
    """A subband gate's weighted mean of the raw bands, then Dense →
    BatchNorm → relu → dropout (``AdvancedFusionModule``, fusion.py:198-214).
    The gate (``SubbandCBAM`` or ``SubbandEca``) pools the bands in their own
    dtype; ``aux["gate"]`` is its (B, S) output."""

    def __init__(self, input_dim: int, embed_dim: int = 384, gate: str = "cbam",
                 dropout: float = 0.1, num_bands: int = 4):
        super().__init__()
        self.embed_dim = embed_dim
        self.dropout = dropout
        self.gate = (SubbandCBAM if gate == "cbam" else SubbandEca)(num_bands)
        self.fc = Linear(input_dim, embed_dim)
        self.bn = BatchNorm(embed_dim)

    def reset_parameters(self, generator=None):
        self.gate.reset_parameters(generator)
        self.fc.reset_parameters(generator)
        self.bn.reset_parameters()

    def forward(self, bands, rngs: dict | None = None):
        fused, alphas = self.gate(bands)
        x = F.relu(self.bn(self.fc(fused)))
        x = apply_dropout(x, self.dropout, self.training, (rngs or {}).get("dropout"))
        return x, {"ortho_loss": _zero(x), "gate": alphas}


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
        self.proj = band_projections(input_dim, embed_dim, num_bands)
        self.query_tokens = nn.Parameter(torch.zeros(1, num_queries, embed_dim))
        self.core = AttnCore(embed_dim, num_heads, dropout)
        self.norm1 = LayerNorm(embed_dim)
        self.mlp = Mlp(embed_dim, embed_dim * 4, embed_dim, dropout=dropout)
        self.out_proj = Linear(embed_dim * num_queries, embed_dim)
        self.norm2 = LayerNorm(embed_dim)

    def reset_parameters(self, generator=None):
        trunc_normal_(self.query_tokens, 0.02, generator)
        _reset_linears(self, generator)

    def forward(self, bands, rngs: dict | None = None):
        rngs = rngs or {}
        bands = bands.float()
        b = bands.shape[0]
        kv = project_bands(self.proj, bands)
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


def get_fusion_head(fusion_config: dict, input_dim: int, num_bands: int = 4):
    """Dispatcher with the reference's config keys (fusion.py:217-261): type,
    output_dim, num_heads, dropout, temperature, num_queries,
    sub_band_dropout_p, ortho_weight, margin.  Other keys (``input_dim``,
    ``use_all_tokens``) are ignored, as the JAX dispatcher ignores them."""
    cfg = dict(fusion_config)
    ftype = cfg.get("type", "standard")
    num_heads = cfg.get("num_heads", 8)
    dropout = cfg.get("dropout", 0.1)
    common = dict(input_dim=input_dim, embed_dim=cfg.get("output_dim", 384),
                  num_bands=num_bands)
    if ftype in ("standard", "temperature", "self_attention"):
        return StandardFusionHead(
            num_heads=num_heads, dropout=dropout, residual_query=ftype == "self_attention",
            temperature=cfg.get("temperature", 0.1) if ftype == "temperature" else None,
            **common)
    if ftype == "semantic":
        return SemanticFusionHead(num_heads=num_heads, dropout=dropout, **common)
    if ftype in ("gated", "temperature_gated"):
        return GatedFusionHead(
            dropout=dropout,
            temperature=cfg.get("temperature", 0.1) if ftype == "temperature_gated" else None,
            **common)
    if ftype in ("cross_attention_bottleneck", "cross_attention_advanced"):
        return CrossAttentionBottleneckHead(
            num_queries=cfg.get("num_queries", 4),
            num_heads=num_heads,
            dropout=dropout,
            sub_band_dropout_p=cfg.get("sub_band_dropout_p", 0.3),
            ortho_weight=cfg.get("ortho_weight", 0.1),
            margin=cfg.get("margin", 0.0),
            advanced=ftype == "cross_attention_advanced",
            **common,
        )
    if ftype in ("cbam", "eca"):
        return GateFusionHead(gate=ftype, dropout=dropout, **common)
    raise ValueError(f"unknown fusion head type {ftype!r}")
