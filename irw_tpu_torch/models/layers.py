"""Shared building blocks (port of ``irw_tpu/models/layers.py:14-154``).

``Linear`` and ``LayerNorm`` take an optional leading band axis: with
``bands=S`` each holds S independent parameter sets and maps (S, …, in) →
(S, …, out) as one batched matmul — how ``BandedViT`` runs four backbones as
one forward.  Parameters live in f32; ``dtype`` is the compute dtype they are
cast to at use, as the flax modules do (``vit.py:375-381``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator | None = None):
    """Truncated normal at ±2σ (flax ``truncated_normal`` / ``trunc_normal_init``)."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                                     generator=generator)


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    return x / torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


def linear(x, weight, bias, dtype: torch.dtype):
    """x·weightᵀ + bias in ``dtype``: weight (out, in), or (S, out, in) with x
    (S, …, in) as one batched matmul over the band axis."""
    w = weight.to(dtype)
    b = None if bias is None else bias.to(dtype)
    x = x.to(dtype)
    if w.dim() == 2:
        return F.linear(x, w, b)
    s, *mid, d = x.shape
    y = torch.bmm(x.reshape(s, -1, d), w.transpose(1, 2))
    if b is not None:
        # a separate add: baddbmm would first copy the broadcast bias into
        # the whole output, which measured slower on the H100 (PERF.md)
        y = y + b[:, None, :]
    return y.reshape(s, *mid, w.shape[1])


class Linear(nn.Module):
    """flax ``Dense`` with weights in torch's (out, in) layout, optionally
    one per band.  Init: variance scaling 1/fan_in, truncated normal (flax's
    lecun_normal) — tests and ``bridge`` overwrite it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 bands: int | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        lead = () if bands is None else (bands,)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(*lead, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(*lead, out_features)) if bias else None

    def reset_parameters(self, generator=None):
        # 0.8796 is the std of a unit normal truncated at ±2 (flax lecun_normal)
        trunc_normal_(self.weight, 1.0 / math.sqrt(self.weight.shape[-1]) / 0.87962566,
                      generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return linear(x, self.weight, self.bias, self.dtype)


class LayerNorm(nn.Module):
    """flax ``LayerNorm`` (eps 1e-6): statistics, scale and bias in f32, the
    result cast to ``dtype`` once (flax/linen/normalization.py
    ``_normalize``).  flax takes the variance as E[x²] − E[x]²; PyTorch's
    ``layer_norm`` centres first — the two agree to f32 rounding."""

    def __init__(self, dim: int, eps: float = 1e-6, bands: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        lead = () if bands is None else (bands,)
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(*lead, dim))
        self.bias = nn.Parameter(torch.zeros(*lead, dim))

    def forward(self, x):
        dim = x.shape[-1:]
        if self.weight.dim() == 1:
            return F.layer_norm(x.float(), dim, self.weight, self.bias, self.eps).to(self.dtype)
        return torch.stack([  # per band: its own scale and bias
            F.layer_norm(x[s].float(), dim, self.weight[s], self.bias[s], self.eps).to(self.dtype)
            for s in range(x.shape[0])])


def apply_dropout(x, rate: float, training: bool, generator: torch.Generator | None = None):
    """flax ``Dropout``: keep each element with probability 1 − rate and
    divide the kept ones by it.  The mask comes from ``generator`` (flax's
    ``dropout`` rng stream); its bits cannot match JAX's."""
    if not training or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


def draw_seed(generator: torch.Generator | None) -> int | None:
    """One seed drawn from ``generator`` (flax's split of an rng stream), to
    seed a child generator; ``None`` stays ``None``."""
    if generator is None:
        return None
    return int(torch.randint(0, 2 ** 62, (), generator=generator, device=generator.device))


class Mlp(nn.Module):
    """Linear → GELU → Linear → Dropout (``layers.py:62-99``).  GELU is the
    tanh form by default (flax ``nn.gelu``); ``exact_gelu=True`` is the erf
    form."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 exact_gelu: bool = False, bands: int | None = None,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim, bands=bands, dtype=dtype)
        self.fc2 = Linear(hidden_dim, out_dim, bands=bands, dtype=dtype)
        self.approximate = "none" if exact_gelu else "tanh"
        self.dropout = dropout

    def forward(self, x, generator: torch.Generator | None = None):
        x = self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))
        return apply_dropout(x, self.dropout, self.training, generator)


class HashHead(nn.Module):
    """Linear hash projection (no bias) + BatchNorm1d (``layers.py:123-146``)
    with flax ``BatchNorm`` semantics, eps 1e-5.  Eval: the running
    statistics.  Training: the batch mean and the BIASED batch variance,
    max(E[x²] − E[x]², 0) in f32, and the running statistics updated in place
    as 0.99·running + 0.01·batch (flax momentum 0.99, torch momentum 0.01 —
    torch's ``BatchNorm1d`` would store the unbiased variance)."""

    momentum = 0.99

    def __init__(self, in_dim: int, nbits: int, use_bn: bool = True):
        super().__init__()
        if not use_bn:
            raise NotImplementedError("HashHead(use_bn=False) waits for ROADMAP A10")
        self.linear = Linear(in_dim, nbits, bias=False)
        self.bn = nn.BatchNorm1d(nbits, eps=1e-5, momentum=1.0 - self.momentum)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.linear.weight.normal_(0.0, 0.01, generator=generator)
        self.bn.reset_parameters()

    def forward(self, x):
        x = self.linear(x.float())
        bn = self.bn
        if self.training:
            mean = x.mean(dim=0)
            var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
            with torch.no_grad():
                bn.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                bn.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = bn.running_mean, bn.running_var
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return (x - mean) * mul + bn.bias


def binarize(logits, train: bool = False, continuous: str = "identity"):
    """Continuous relaxation in train, sign codes in eval (``layers.py:149-154``)."""
    if train:
        return torch.tanh(logits) if continuous == "tanh" else logits
    return torch.sign(logits)
