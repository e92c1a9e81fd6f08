"""DINOv2-style Vision Transformer (port of
``irw_tpu/models/vit.py:43-60, 62-88, 115-153, 204-296, 320-391, 420-619,
636-675``).

Patch embed → [CLS | patches] + position embeddings → pre-norm blocks with
LayerScale → final LayerNorm → the CLS token.  With ``bands=S`` every
parameter carries a leading band axis and the forward maps (S, B, H, W, C) →
(S, B, D) as one batched computation: ``multi_dino.BandedViT`` is that, with
S = 4.  The JAX ``scan_blocks`` and ``scan_group`` layouts are only ways of
storing parameters: the port accepts both flags, keeps a Python loop over
blocks, and ``bridge`` unstacks the depth axis.

Compute policy (``dtype``): f32 parameters are cast to the compute dtype at
use (vit.py:375-381, 491-494), so the residual stream stays in it;
LayerNorm statistics are f32 and the result is cast back.  The attention
follows the Block's routing (vit.py:345-374), in this order: ``use_flash``
takes ``FlashAttention`` (one fused q/k/v projection, ``ops.flash_attention``:
kernels K6-fwd and K6-bwd on the card); ``split_cls`` takes ``SplitCLSMHA``
(the CLS token split off, a two-block softmax); ``fused_qkv`` takes
``FusedMHA`` (one q/k/v matmul); else ``Attention``, whose core with
``vmem_attn`` is ``ops.attention.vmem_attention_fn`` (kernels K2 forward and
K3 backward on the card) and otherwise, or while attention dropout is active,
flax's ``dot_product_attention`` semantics.  All but ``FlashAttention`` keep
the MHA parameters ``query``/``key``/``value``/``out``.  ``ln_fused`` swaps
every LayerNorm (``norm1``, ``norm2``, the final ``norm``) for
``ops.fused_ln.FusedLayerNorm``, same parameters.  ``quant_int8`` (ROADMAP
A14) raises.

Two extras of the unbanded ViT serve the shared-tower models
(``multi_dino.SharedDinoHashing``): ``num_domains`` > 1 gives every
LayerNorm per-domain parameters (``DomainLayerNorm``, the DSLN), selected by
the ``domain`` id of each sample passed to ``forward``; a ``prompts``
argument (P tokens per sample) is inserted after the CLS token, after the
position sum.  ``num_prompts`` gives the ViT its own (1, P, D) prompt
tokens, used when no ``prompts`` are passed (vit.py:482-489).

Training: ``dropout`` drops attention probabilities (not on the flash
route, which has no attention dropout, as ``_flash_mha``) and MLP outputs,
with masks drawn from the ``generator`` passed to ``forward`` (flax's
``dropout`` rng stream).  ``remat_blocks`` recomputes each block in the
backward (``torch.utils.checkpoint``), the port of the scanned-block
``nn.remat`` with policy ``None`` or ``"nothing"``; the selective policies
wait for ROADMAP A6-remainder.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from irw_tpu_torch.models.layers import (
    LayerNorm,
    Linear,
    Mlp,
    apply_dropout,
    draw_seed,
    linear,
    trunc_normal_,
)
from irw_tpu_torch.ops.attention import dot_product_attention, vmem_attention_fn
from irw_tpu_torch.ops.flash_attention import flash_attention
from irw_tpu_torch.ops.fused_ln import FusedLayerNorm

_REMAT_POLICIES = (None, "nothing")
_LATER_REMAT_POLICIES = ("dots", "dots_no_batch", "dots_no_batch_gelu", "everything",
                         "dots_no_batch_attn", "dots_no_batch_gelu_attn")


class PatchEmbed(nn.Module):
    """flax ``Conv`` with a p×p kernel, stride p, VALID padding, as one
    matmul over flattened patches.  Weight in torch's OIHW layout; no bias
    with ``bias=False`` (CLIP's patch conv)."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int = 14,
                 bands: int | None = None, dtype: torch.dtype = torch.float32,
                 bias: bool = True):
        super().__init__()
        lead = () if bands is None else (bands,)
        self.patch_size = patch_size
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(*lead, embed_dim, in_chans, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(*lead, embed_dim)) if bias else None

    def reset_parameters(self, generator=None):
        fan_in = math.prod(self.weight.shape[-3:])
        trunc_normal_(self.weight, 1.0 / math.sqrt(fan_in) / 0.87962566, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        """(…, H, W, C) → (…, Np, D)."""
        p = self.patch_size
        *pre, h, w, c = x.shape
        hp, wp = h // p, w // p
        x = x[..., : hp * p, : wp * p, :].to(self.dtype)
        x = x.reshape(*pre, hp, p, wp, p, c).transpose(-4, -3)
        patches = x.reshape(*pre, hp * wp, p * p * c)
        # OIHW → (O, H·W·C) in the patches' (ph, pw, c) order
        lead = self.weight.dim() - 4
        perm = list(range(lead)) + [lead, lead + 2, lead + 3, lead + 1]
        wmat = self.weight.permute(*perm).reshape(*self.weight.shape[:lead + 1], -1)
        wmat = wmat.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if lead == 0:
            return F.linear(patches, wmat, b)
        s = patches.shape[0]
        y = torch.bmm(patches.reshape(s, -1, patches.shape[-1]), wmat.transpose(1, 2))
        return (y + b[:, None, :]).reshape(*pre, hp * wp, wmat.shape[1])


class DomainLayerNorm(nn.Module):
    """``DomainLayerNorm``'s multi-domain path (vit.py:80-88): a LayerNorm
    whose scale and bias rows, (num_domains, D), are picked per sample by
    ``domain`` (B,) and broadcast over the tokens of (B, N, D).

    Unlike ``LayerNorm`` it computes in x's dtype, as the JAX module does: in
    bf16 the mean (summed in f32) is rounded to bf16, the variance is the
    two-pass mean((x − mean)²), and 1/sqrt(var + 1e-6) is taken in bf16 with
    1e-6 rounded to bf16 first (a weakly typed constant).  The f32 scale and
    bias then promote the output to f32.  The backward of the row gather is a
    scatter-add over the domains."""

    eps = 1e-6

    def __init__(self, dim: int, num_domains: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_domains, dim))
        self.bias = nn.Parameter(torch.zeros(num_domains, dim))

    def forward(self, x, domain):
        if domain is None:
            raise ValueError("a DomainLayerNorm with several domains needs the domain id of "
                             "each sample")
        mean = x.float().mean(dim=-1, keepdim=True).to(x.dtype)
        centred = x - mean
        var = (centred * centred).float().mean(dim=-1, keepdim=True).to(x.dtype)
        eps = torch.full((), self.eps, dtype=x.dtype, device=x.device)
        y = centred * torch.reciprocal(torch.sqrt(var + eps))
        return y * self.weight[domain][:, None, :] + self.bias[domain][:, None, :]


def domain_layer_norm(dim: int, fused: bool = False, num_domains: int = 1,
                      **kw) -> nn.Module:
    """``DomainLayerNorm`` (vit.py:62-88).  With one domain it is a
    LayerNorm: flax's, or with ``fused`` the one whose backward recomputes its
    statistics (vit.py:72-79), same parameters.  With several it has
    per-domain parameters and ignores ``fused``, as the JAX module does."""
    if num_domains > 1:
        if kw.get("bands") is not None:
            raise ValueError("per-domain LayerNorms belong to the unbanded (shared) ViT")
        return DomainLayerNorm(dim, num_domains)
    return (FusedLayerNorm if fused else LayerNorm)(dim, **kw)


def _norm(norm, x, domain):
    """``norm(x)``, with the samples' ``domain`` ids for a ``DomainLayerNorm``."""
    return norm(x, domain) if isinstance(norm, DomainLayerNorm) else norm(x)


class _MHA(nn.Module):
    """The parameters of flax ``MultiHeadDotProductAttention``: the q/k/v/out
    projections, shared by every attention route but the flash one."""

    def __init__(self, dim: int, num_heads: int, bands: int | None = None,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.query, self.key, self.value, self.out = (
            Linear(dim, dim, bands=bands, dtype=dtype) for _ in range(4))


class Attention(_MHA):
    """flax ``MultiHeadDotProductAttention`` self-attention: q/k/v/out
    projections around an attention core on (…, N, H, hd).  Active dropout
    takes ``dot_product_attention`` (vmem_attention.py:338-343)."""

    def __init__(self, dim: int, num_heads: int, vmem_attn: bool = False,
                 bands: int | None = None, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__(dim, num_heads, bands, dtype, dropout)
        # a plain attribute, so a caller can hold the kernel against its plain
        # version on the same weights (chip_smoke.py does)
        self.core = vmem_attention_fn if vmem_attn else dot_product_attention

    def forward(self, y, generator: torch.Generator | None = None):
        *pre, n, d = y.shape
        h = self.num_heads
        q, k, v = (proj(y).reshape(*pre, n, h, d // h)
                   for proj in (self.query, self.key, self.value))
        if self.training and self.dropout > 0.0:
            o = dot_product_attention(q, k, v, dropout_rate=self.dropout, deterministic=False,
                                      generator=generator)
        else:
            o = self.core(q, k, v)
        return self.out(o.reshape(*pre, n, d))


class FlashAttention(nn.Module):
    """``_flash_mha`` (vit.py:268-296): one fused projection ``qkv`` (flax
    ``DenseGeneral((3, H, hd))`` named ``attn_qkv``, its output read as
    (…, N, 3, H, hd)), the flash attention core with scale 1/√hd (q, k, v
    passed as strided views of the projection) and ``out`` (``attn_out``).
    No attention dropout, in training too: ``_flash_mha`` has none."""

    def __init__(self, dim: int, num_heads: int, bands: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bands=bands, dtype=dtype)
        self.out = Linear(dim, dim, bands=bands, dtype=dtype)
        # a plain attribute, so a caller can hold the kernels against their
        # plain versions on the same weights (chip_smoke.py does)
        self.core = flash_attention

    def forward(self, y, generator: torch.Generator | None = None):
        *pre, n, d = y.shape
        h = self.num_heads
        q, k, v = self.qkv(y).reshape(*pre, n, 3, h, d // h).unbind(-3)
        return self.out(self.core(q, k, v).reshape(*pre, n, d))


def _div_sqrt(q, hd: int):
    """q / √hd with the divisor rounded to q's dtype first, as JAX's weak
    typing of ``q / math.sqrt(hd)`` does.  The divisor is a tensor on q's
    device: PyTorch's CUDA division by a host scalar multiplies by the
    reciprocal."""
    return q / torch.full((), math.sqrt(hd), dtype=q.dtype, device=q.device)


class FusedMHA(_MHA):
    """``FusedMHA`` (vit.py:115-153): self-attention with ONE q/k/v matmul
    over the MHA parameters.  The three (out, in) weights are concatenated
    on the output axis into (3·D, D) at every call and the result is read as
    (…, N, 3, H, hd); q / √hd, scores and softmax in the compute dtype,
    dropout over the whole probability tensor (not broadcast), P·V, ``out``."""

    def forward(self, y, generator: torch.Generator | None = None):
        *pre, n, d = y.shape
        h = self.num_heads
        projs = (self.query, self.key, self.value)
        qkv = linear(y, torch.cat([p.weight for p in projs], dim=-2),
                     torch.cat([p.bias for p in projs], dim=-1), self.query.dtype)
        q, k, v = qkv.reshape(*pre, n, 3, h, d // h).unbind(-3)
        scores = torch.einsum("...qhd,...khd->...hqk", _div_sqrt(q, d // h), k)
        weights = apply_dropout(torch.softmax(scores, dim=-1), self.dropout, self.training,
                                generator)
        ctx = torch.einsum("...hqk,...khd->...qhd", weights, v)
        return self.out(ctx.reshape(*pre, n, d))


def _softmax_blocks(s_core, s_extra):
    """softmax over concat([s_extra, s_core], -1) without forming the
    concat (vit.py:236-245); returns (w_extra, w_core)."""
    m = torch.maximum(s_core.amax(dim=-1, keepdim=True), s_extra.amax(dim=-1, keepdim=True))
    e_core, e_extra = torch.exp(s_core - m), torch.exp(s_extra - m)
    denom = e_core.sum(dim=-1, keepdim=True) + e_extra.sum(dim=-1, keepdim=True)
    return e_extra / denom, e_core / denom


class SplitCLSMHA(_MHA):
    """``SplitCLSMHA`` (vit.py:204-265): self-attention over N = 1 + P tokens
    with the CLS token split off, so that the core is a (P, P) block: patch
    rows and the CLS row each take a two-block softmax over [CLS | patches],
    the rank-1 CLS column and row folded back in.  MHA parameters; q / √hd
    and every product in the compute dtype; dropout on the four probability
    pieces separately, in the order patch·patch, patch·CLS, CLS·patch,
    CLS·CLS."""

    def forward(self, y, generator: torch.Generator | None = None):
        *pre, n, d = y.shape
        h = self.num_heads
        q, k, v = (proj(y).reshape(*pre, n, h, d // h).transpose(-3, -2)   # (…, H, N, hd)
                   for proj in (self.query, self.key, self.value))
        q = _div_sqrt(q, d // h)
        (qc, qp), (kc, kp), (vc, vp) = ((t[..., :1, :], t[..., 1:, :]) for t in (q, k, v))
        # patch rows, then the CLS row: scores against [CLS | patches]
        w_pc, w_pp = _softmax_blocks(qp @ kp.transpose(-2, -1), qp @ kc.transpose(-2, -1))
        w_cc, w_cp = _softmax_blocks(qc @ kp.transpose(-2, -1), qc @ kc.transpose(-2, -1))
        w_pp, w_pc, w_cp, w_cc = (apply_dropout(w, self.dropout, self.training, generator)
                                  for w in (w_pp, w_pc, w_cp, w_cc))
        out_p = w_pp @ vp + w_pc * vc
        out_c = w_cp @ vp + w_cc * vc
        ctx = torch.cat([out_c, out_p], dim=-2).transpose(-3, -2)           # (…, N, H, hd)
        return self.out(ctx.reshape(*pre, n, d))


def _per_band(param, x):
    """(D,) or (S, D) parameter → broadcastable against (…, N, D) / (S, …, N, D)."""
    if param.dim() == 1:
        return param
    return param.reshape((param.shape[0],) + (1,) * (x.dim() - 2) + (param.shape[1],))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layerscale_init: float = 1e-5, vmem_attn: bool = False,
                 exact_gelu: bool = False, bands: int | None = None,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 use_flash: bool = False, split_cls: bool = False, fused_qkv: bool = False,
                 ln_fused: bool = False, num_domains: int = 1):
        super().__init__()
        lead = () if bands is None else (bands,)
        self.dtype = dtype
        self.norm1 = domain_layer_norm(dim, ln_fused, num_domains, bands=bands, dtype=dtype)
        # vit.py:345-374: use_flash, then split_cls, then fused_qkv, then the
        # MHA route with or without vmem_attn
        if use_flash:
            self.attn = FlashAttention(dim, num_heads, bands, dtype)
        elif split_cls or fused_qkv:
            self.attn = (SplitCLSMHA if split_cls else FusedMHA)(
                dim, num_heads, bands, dtype, dropout)
        else:
            self.attn = Attention(dim, num_heads, vmem_attn, bands, dtype, dropout)
        self.ls1 = nn.Parameter(torch.full((*lead, dim), layerscale_init))
        self.norm2 = domain_layer_norm(dim, ln_fused, num_domains, bands=bands, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, exact_gelu, bands, dtype, dropout)
        self.ls2 = nn.Parameter(torch.full((*lead, dim), layerscale_init))

    def forward(self, x, generator: torch.Generator | None = None, domain=None):
        x = torch.addcmul(x, self.attn(_norm(self.norm1, x, domain), generator),
                          _per_band(self.ls1, x).to(self.dtype))
        return torch.addcmul(x, self.mlp(_norm(self.norm2, x, domain), generator),
                             _per_band(self.ls2, x).to(self.dtype))


def _run_block(blk, tokens, seed: int | None, domain=None):
    """``blk`` with its dropout generator made from ``seed`` inside the call,
    so that a block recomputed in the backward draws the same masks (and
    sees the same ``domain`` ids)."""
    gen = None if seed is None else torch.Generator(device=tokens.device).manual_seed(seed)
    return blk(tokens, gen, domain)


class VisionTransformer(nn.Module):
    """DINOv2-flavoured ViT returning the normalised CLS token.

    Input (B, H, W, C) → (B, D), or with ``bands=S`` (S, B, H, W, C) →
    (S, B, D).  ``img_size`` fixes the position-embedding length, which the
    JAX module infers at init.  ``num_domains`` and ``num_prompts`` (the
    unbanded ViT only) are described in the module's docstring.
    """

    def __init__(self, embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 patch_size: int = 14, mlp_ratio: float = 4.0, img_size: int = 224,
                 in_chans: int = 3, layerscale_init: float = 1e-5,
                 vmem_attn: bool = False, exact_gelu: bool = False,
                 dtype: torch.dtype | str = torch.float32, bands: int | None = None,
                 dropout: float = 0.0, remat_blocks: bool = False,
                 remat_policy: str | None = None, use_flash: bool = False,
                 scan_blocks: bool = False, scan_group: int = 1, fused_qkv: bool = False,
                 split_cls: bool = False, ln_fused: bool = False, quant_int8: bool = False,
                 num_domains: int = 1, num_prompts: int = 0):
        super().__init__()
        if isinstance(dtype, str):  # 'bfloat16' / 'float32' from YAML configs
            dtype = getattr(torch, dtype)
        # the JAX module's parameter layout only (the bridge unstacks it and
        # names flax paths by it): the port always loops over its blocks
        self.scan_blocks, self.scan_group = scan_blocks, scan_group
        if quant_int8:  # the Block variant not ported yet (vit.py:333)
            raise NotImplementedError("ViT quant_int8=True waits for ROADMAP A14")
        if remat_policy in _LATER_REMAT_POLICIES:
            raise NotImplementedError(f"remat_policy {remat_policy!r} waits for ROADMAP "
                                      "A6-remainder; the port remats whole blocks "
                                      "(None or 'nothing')")
        if remat_policy not in _REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        if bands is not None and num_prompts:
            raise ValueError("prompt tokens belong to the unbanded (shared) ViT")
        lead = () if bands is None else (bands,)
        self.embed_dim = embed_dim
        self.num_domains = num_domains
        self.layerscale_init = layerscale_init
        self.dtype = dtype
        self.dropout = dropout
        self.remat_blocks = remat_blocks
        num_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size, bands, dtype)
        self.cls_token = nn.Parameter(torch.zeros(*lead, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(*lead, num_patches + 1, embed_dim))
        self.prompts = (nn.Parameter(torch.zeros(1, num_prompts, embed_dim))
                        if num_prompts else None)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, layerscale_init, vmem_attn,
                  exact_gelu, bands, dtype, dropout, use_flash, split_cls, fused_qkv, ln_fused,
                  num_domains)
            for _ in range(depth))
        self.norm = domain_layer_norm(embed_dim, ln_fused, num_domains, bands=bands,
                                      dtype=dtype)

    def fit_grid(self, height: int, width: int):
        """Position embeddings for (height, width) inputs, one row per patch
        and one for CLS, as the JAX init sizes them from its sample input;
        drawn by ``reset_parameters``."""
        p = self.patch_embed.patch_size
        pos = self.pos_embed
        self.pos_embed = nn.Parameter(pos.new_zeros(*pos.shape[:-2], (height // p) * (width // p)
                                                    + 1, pos.shape[-1]))

    def reset_parameters(self, generator=None):
        self.patch_embed.reset_parameters(generator)
        trunc_normal_(self.cls_token, 0.02, generator)
        trunc_normal_(self.pos_embed, 0.02, generator)
        if self.prompts is not None:
            trunc_normal_(self.prompts, 0.02, generator)
        for m in self.modules():
            if isinstance(m, Linear):
                m.reset_parameters(generator)
            elif isinstance(m, (LayerNorm, FusedLayerNorm, DomainLayerNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for blk in self.blocks:
            nn.init.constant_(blk.ls1, self.layerscale_init)
            nn.init.constant_(blk.ls2, self.layerscale_init)

    def forward(self, x, generator: torch.Generator | None = None, domain=None, prompts=None):
        """``domain``: (B,) domain ids (read with ``num_domains`` > 1);
        ``prompts``: (B, P, D) tokens to insert after CLS."""
        tokens = self.patch_embed(x)                            # (…, B, Np, D)
        *pre, _, d = tokens.shape
        cls, pos = self.cls_token, self.pos_embed
        if pos.dim() == 3:  # per band: (S, N, D) → (S, 1, N, D)
            cls, pos = cls[:, None], pos[:, None]
        cls = cls.expand(*pre, 1, d)
        # the f32 cls/pos promote the concat, and the sum is cast back to the
        # compute dtype, as in vit.py:479-494
        tokens = torch.cat([cls.float(), tokens.float()], dim=-2) + pos
        if prompts is None and self.prompts is not None:
            prompts = self.prompts.expand(tokens.shape[0], -1, -1)
        if prompts is not None:  # after CLS, without position embeddings (vit.py:482-489)
            tokens = torch.cat([tokens[:, :1], prompts.float(), tokens[:, 1:]], dim=1)
        tokens = tokens.to(self.dtype)
        if self.num_domains <= 1:
            domain = None
        for blk in self.blocks:
            # one seed per block, as nn.scan splits the dropout rng
            seed = draw_seed(generator) if self.training and self.dropout > 0.0 else None
            if self.remat_blocks and torch.is_grad_enabled():
                tokens = checkpoint(_run_block, blk, tokens, seed, domain, use_reentrant=False)
            else:
                tokens = _run_block(blk, tokens, seed, domain)
        return _norm(self.norm, tokens, domain)[..., 0, :]


VIT_DIMS = {
    "dinov2_vits14": 384,
    "dinov2_vitb14": 768,
    "dinov3_vits16": 384,
    "dinov3_vitb16": 768,
    "vit_small": 384,
    "vit_base": 768,
    "deit_small": 384,
    "deit_base": 768,
    "vit_tiny": 64,
    "test_tiny": 64,
}


def vit_config(name: str, **kw) -> dict:
    """Constructor kwargs for a named ViT variant (vit.py:650-671).
    ``scan_blocks`` is kept as the JAX presets set it: it names the flax
    layout (``bridge.jax_module_paths``), and the port loops over blocks
    whatever it says."""
    if name in ("dinov2_vits14", "vit_small", "deit_small"):
        base = dict(embed_dim=384, depth=12, num_heads=6, scan_blocks=True)
    elif name in ("dinov2_vitb14", "vit_base", "deit_base"):
        base = dict(embed_dim=768, depth=12, num_heads=12, scan_blocks=True)
    elif name.startswith("dinov3_vits"):
        base = dict(embed_dim=384, depth=12, num_heads=6, patch_size=16, scan_blocks=True)
    elif name.startswith("dinov3_vitb"):
        base = dict(embed_dim=768, depth=12, num_heads=12, patch_size=16, scan_blocks=True)
    elif name in ("vit_tiny", "test_tiny"):
        base = dict(embed_dim=64, depth=2, num_heads=2, patch_size=8)
    else:
        raise ValueError(f"unknown ViT variant {name!r}")
    base.update(kw)
    return base


def make_vit(name: str, **kw) -> VisionTransformer:
    return VisionTransformer(**vit_config(name, **kw))
