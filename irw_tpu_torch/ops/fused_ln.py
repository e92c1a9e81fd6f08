"""LayerNorm whose backward recomputes its statistics (port of
``irw_tpu/ops/fused_ln.py:38-109``).

``fused_layernorm`` is a ``torch.autograd.Function`` that saves ONLY
``(x, scale)``: x is the block input that the residual stream (or the block's
checkpoint) already holds, and the f32 mean and rstd planes are recomputed in
the backward instead of being kept between the passes.  The arithmetic is
flax's LayerNorm: f32 statistics with the fast variance max(E[x²] − E[x]², 0),
eps inside the rsqrt, y = (x − μ)·(r·scale) + bias in f32, then one cast.

``FusedLayerNorm`` has ``models.layers.LayerNorm``'s parameters (``weight``,
``bias``, optional band axis), so state dicts and ``bridge`` apply unchanged.
Plain PyTorch: the JAX function is not a Pallas kernel either (XLA fuses it).
"""

from __future__ import annotations

import torch
from torch import nn


def _stats(xf, eps: float):
    """f32 mean and rstd over the last axis: flax's ``use_fast_variance``
    formula (E[x²] − E[x]², clamped at 0)."""
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return mu, torch.rsqrt(var + eps)


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        xf = x.float()
        mu, r = _stats(xf, eps)
        return ((xf - mu) * (r * scale.float()) + bias.float()).to(out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors  # unpacked once: checkpoint refuses a second unpack
        xf, dyf = x.float(), dy.float()
        mu, r = _stats(xf, ctx.eps)
        xhat = (xf - mu) * r
        # the parameters' gradients reduce over every axis but the last
        red = tuple(range(dyf.dim() - 1))
        dscale = (dyf * xhat).sum(dim=red)
        dbias = dyf.sum(dim=red)
        dxhat = dyf * scale.float()
        dx = r * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                  - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
        return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype), None, None


def fused_layernorm(x, scale, bias, eps: float = 1e-6, out_dtype: torch.dtype | None = None):
    """``LayerNorm(x) * scale + bias`` over the last axis with f32
    statistics, and a backward that recomputes them instead of saving them.
    ``scale`` and ``bias`` are (D,); ``out_dtype`` defaults to ``x.dtype``."""
    return _FusedLayerNorm.apply(x, scale, bias, eps, out_dtype or x.dtype)


class FusedLayerNorm(nn.Module):
    """Drop-in for ``models.layers.LayerNorm`` (same parameters, eps and
    dtype semantics) over ``fused_layernorm``; with a band axis each band
    takes its own scale and bias."""

    def __init__(self, dim: int, eps: float = 1e-6, bands: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        lead = () if bands is None else (bands,)
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(*lead, dim))
        self.bias = nn.Parameter(torch.zeros(*lead, dim))

    def forward(self, x):
        if self.weight.dim() == 1:
            return fused_layernorm(x, self.weight, self.bias, self.eps, self.dtype)
        return torch.stack([  # per band: its own scale and bias
            fused_layernorm(x[s], self.weight[s], self.bias[s], self.eps, self.dtype)
            for s in range(x.shape[0])])
