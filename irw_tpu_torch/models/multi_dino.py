"""The multi-band ViT family (port of ``irw_tpu/models/multi_dino.py``).

``BandedViT`` holds the four per-band backbones as ONE ViT whose parameters
carry a leading band axis: per-band projections are batched matmuls over
that axis, and attention sees (S·B, N, H, hd), so a forward launches the
attention kernel once per block, not once per block and band.
``SharedViT`` is the other layout, one tower whose weights every band
shares, run over the band-major batch (all LL first, then LH, …), so its
attention also sees (S·B, N, H, hd).  Band input layout is (B, S, H, W, C),
S ordered [LL, LH, HL, HH].

The models, each ``forward(x, rngs) -> (output, aux)``:

- ``MultiDinoAttention``: BandedViT → fusion head → L2-normalised
  embedding, read by cosine (multi_dino.py:96-122);
- ``MultiDinoHashing``: BandedViT → fusion head → HashHead; logits in
  training (tanh of them with ``tanh_train``, the ``MultiDinoHashingTF``
  variant), ±1 codes in eval (multi_dino.py:125-156);
- ``SharedDinoHashing``: SharedViT → fusion head → HashHead with BatchNorm;
  tanh in training, ±1 codes in eval; optional per-band prompt tokens and
  per-band LayerNorms (DSLN) inside the tower (multi_dino.py:159-217);
- ``PromptedSharedDinoHashing`` and ``PretrainedMultiDinoHashing``, the
  constructors of multi_dino.py:220-232.

``rngs`` maps flax's rng streams ``"dropout"`` and ``"band_drop"`` to
``torch.Generator``s.  ``frozen_backbone`` (the JAX default) runs the tower
in eval mode and names it in ``frozen_param_collections``, which the
optimizers leave out and whose gradients the train step drops, as
``requires_grad=False`` did in the reference.  A frozen tower runs under
``no_grad``, unless prompts or DSLN need the gradient to pass through it
(multi_dino.py:204-207).
"""

from __future__ import annotations

import torch
from torch import nn

from irw_tpu_torch.models.fusion import get_fusion_head
from irw_tpu_torch.models.layers import HashHead, binarize, l2_normalize, trunc_normal_
from irw_tpu_torch.models.vit import VIT_DIMS, VisionTransformer, vit_config


class BandedViT(nn.Module):
    """(B, S, H, W, C) → CLS stack (B, S, D), independent weights per band."""

    def __init__(self, backbone: str = "dinov2_vits14", num_bands: int = 4,
                 vit_kwargs: dict | None = None):
        super().__init__()
        self.vit = VisionTransformer(**vit_config(backbone, **(vit_kwargs or {})),
                                     bands=num_bands)

    def reset_parameters(self, generator=None):
        self.vit.reset_parameters(generator)

    def forward(self, x, generator: torch.Generator | None = None):
        return self.vit(x.transpose(0, 1), generator).transpose(0, 1)


class SharedViT(nn.Module):
    """(B, S, H, W, C) → CLS stack (B, S, D) through one tower over the
    band-major flattened batch (multi_dino.py:177-211): in,
    ``swapaxes(0, 1).reshape(S·B, …)``; out, ``cls.reshape(S, B, D)
    .swapaxes(0, 1)``.  With ``use_dsln`` every LayerNorm of the tower has
    one parameter row per band, and sample s·B + i reads row s."""

    def __init__(self, backbone: str = "dinov2_vits14", num_bands: int = 4,
                 use_dsln: bool = False, vit_kwargs: dict | None = None):
        super().__init__()
        vit_kw = dict(vit_kwargs or {})
        if use_dsln:
            vit_kw["num_domains"] = num_bands
        self.use_dsln = use_dsln
        self.vit = VisionTransformer(**vit_config(backbone, **vit_kw))

    def reset_parameters(self, generator=None):
        self.vit.reset_parameters(generator)

    def forward(self, x, generator: torch.Generator | None = None, prompts=None):
        b, s = x.shape[:2]
        flat = x.transpose(0, 1).reshape(b * s, *x.shape[2:])
        domain = (torch.arange(s, device=x.device).repeat_interleave(b) if self.use_dsln
                  else None)
        cls = self.vit(flat, generator, domain, prompts)
        return cls.reshape(s, b, cls.shape[-1]).transpose(0, 1)


class _FrozenTower(nn.Module):
    """What the family shares: ``backbone`` (the tower), ``head`` (the fusion
    head), a frozen tower in eval mode, ``frozen_param_collections``."""

    frozen_backbone: bool

    @property
    def frozen_param_collections(self) -> tuple:
        return ("backbone",) if self.frozen_backbone else ()

    def train(self, mode: bool = True):
        super().train(mode)
        if self.frozen_backbone:
            self.backbone.train(False)
        return self

    def reset_parameters(self, generator: torch.Generator | None = None):
        for child in self.children():
            child.reset_parameters(generator)

    def _bands(self, x, rngs: dict, needs_grad: bool = False, **kw):
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and (needs_grad or not self.frozen_backbone)):
            return self.backbone(x, rngs.get("dropout"), **kw)


class MultiDinoAttention(_FrozenTower):
    """BandedViT → fusion head → L2-normalised embedding (multi_dino.py:96-122);
    no hash head, so retrieval reads it by cosine."""

    def __init__(self, backbone: str = "dinov2_vits14", fusion_config: dict | None = None,
                 num_bands: int = 4, frozen_backbone: bool = True,
                 vit_kwargs: dict | None = None):
        super().__init__()
        dim = VIT_DIMS[backbone]
        self.frozen_backbone = frozen_backbone
        self.backbone = BandedViT(backbone, num_bands, vit_kwargs)
        self.head = get_fusion_head(fusion_config or {"output_dim": dim}, dim, num_bands)

    def forward(self, x, rngs: dict | None = None):
        rngs = rngs or {}
        fused, aux = self.head(self._bands(x, rngs), rngs)
        return l2_normalize(fused), aux


class MultiDinoHashing(_FrozenTower):
    """BandedViT → fusion head → HashHead (multi_dino.py:125-156).

    ``forward(x, rngs)`` returns ``(codes, aux)`` in eval mode (±1 codes) and
    ``(logits, aux)`` in training mode (``binarize(train=True,
    "identity")``), or ``tanh(logits)`` with ``tanh_train`` (the
    ``MultiDinoHashingTF`` continuation variant, multi_dino.py:151);
    ``forward_logits`` returns the logits in either mode.
    """

    def __init__(self, backbone: str = "dinov2_vits14", fusion_config: dict | None = None,
                 nbits: int = 64, use_bn: bool = True, num_bands: int = 4,
                 frozen_backbone: bool = True, tanh_train: bool = False,
                 vit_kwargs: dict | None = None):
        super().__init__()
        dim = VIT_DIMS[backbone]
        self.frozen_backbone = frozen_backbone
        self.tanh_train = tanh_train
        self.backbone = BandedViT(backbone, num_bands, vit_kwargs)
        self.head = get_fusion_head(fusion_config or {"output_dim": dim}, dim, num_bands)
        self.hash_head = HashHead(self.head.embed_dim, nbits, use_bn)

    def forward_logits(self, x, rngs: dict | None = None):
        rngs = rngs or {}
        fused, aux = self.head(self._bands(x, rngs), rngs)
        return self.hash_head(fused), aux

    def forward(self, x, rngs: dict | None = None):
        logits, aux = self.forward_logits(x, rngs)
        return binarize(logits, self.training, "tanh" if self.tanh_train else "identity"), aux


class SharedDinoHashing(_FrozenTower):
    """SharedViT → fusion head → HashHead with BatchNorm; tanh of the logits
    in training, ±1 codes in eval (multi_dino.py:159-217).

    ``num_prompts`` > 0 adds ``prompts``, a learned (S, P, D) bank at the
    model's top level, repeated band-major over the batch and inserted after
    each sample's CLS token; ``use_dsln`` gives the tower's LayerNorms one
    parameter row per band.  Under a frozen tower the prompts still train,
    but the DSLN rows live inside the tower, so ``frozen_param_collections``
    covers them and they stay frozen, as in JAX."""

    def __init__(self, backbone: str = "dinov2_vits14", fusion_config: dict | None = None,
                 nbits: int = 64, num_bands: int = 4, frozen_backbone: bool = True,
                 num_prompts: int = 0, use_dsln: bool = False, vit_kwargs: dict | None = None):
        super().__init__()
        dim = VIT_DIMS[backbone]
        self.frozen_backbone = frozen_backbone
        self.num_prompts = num_prompts
        self.use_dsln = use_dsln
        self.backbone = SharedViT(backbone, num_bands, use_dsln, vit_kwargs)
        self.prompts = (nn.Parameter(torch.zeros(num_bands, num_prompts, dim))
                        if num_prompts > 0 else None)
        self.head = get_fusion_head(fusion_config or {"output_dim": dim}, dim, num_bands)
        self.hash_head = HashHead(self.head.embed_dim, nbits, use_bn=True)

    def reset_parameters(self, generator: torch.Generator | None = None):
        super().reset_parameters(generator)
        if self.prompts is not None:
            trunc_normal_(self.prompts, 0.02, generator)

    def forward_logits(self, x, rngs: dict | None = None):
        rngs = rngs or {}
        prompts = (None if self.prompts is None
                   else self.prompts.repeat_interleave(x.shape[0], dim=0))  # (S·B, P, D)
        bands = self._bands(x, rngs, needs_grad=self.num_prompts > 0 or self.use_dsln,
                            prompts=prompts)
        fused, aux = self.head(bands, rngs)
        return self.hash_head(fused), aux

    def forward(self, x, rngs: dict | None = None):
        logits, aux = self.forward_logits(x, rngs)
        return binarize(logits, self.training, "tanh"), aux


def PromptedSharedDinoHashing(num_prompts: int = 10, **kw) -> SharedDinoHashing:
    """The shared tower with per-band prompt tokens (multi_dino.py:220-223)."""
    return SharedDinoHashing(num_prompts=num_prompts, **kw)


def PretrainedMultiDinoHashing(**kw) -> MultiDinoHashing:
    """A frozen MultiDinoHashing by default (multi_dino.py:226-232): the
    'pretrained' part is weight loading, the frozen part the optimizer
    mask."""
    kw.setdefault("frozen_backbone", True)
    return MultiDinoHashing(**kw)
