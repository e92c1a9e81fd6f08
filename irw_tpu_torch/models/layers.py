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


def zero_aux(out: torch.Tensor) -> dict:
    """The aux dict of a model without an ortho term: ``ortho_loss`` 0 on
    ``out``'s device."""
    return {"ortho_loss": torch.zeros((), device=out.device)}


def global_pool(x, pool: str = "avg"):
    """(B, H, W, C) → (B, C) (``layers.py:21-35``): ``default``/``avg`` the
    mean, ``max`` the max, ``avg_max`` half their sum, ``none`` the map
    flattened in (H, W, C) order."""
    if pool in ("avg", "default"):
        return x.mean(dim=(-3, -2))
    if pool == "max":
        return x.amax(dim=(-3, -2))
    if pool == "avg_max":
        return 0.5 * (x.mean(dim=(-3, -2)) + x.amax(dim=(-3, -2)))
    if pool == "none":
        return x.reshape(x.shape[0], -1)
    raise ValueError(f"unknown pool {pool!r}")


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
    lecun_normal) — tests and ``bridge`` overwrite it.  ``round_first``: in
    a half dtype the bias is added after the product is rounded to it, as
    flax adds it (``linear.py:275-290``), where ``F.linear`` may add it in
    the accumulator."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 bands: int | None = None, dtype: torch.dtype = torch.float32,
                 round_first: bool = False):
        super().__init__()
        lead = () if bands is None else (bands,)
        self.dtype = dtype
        self.round_first = round_first and dtype != torch.float32
        self.weight = nn.Parameter(torch.empty(*lead, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(*lead, out_features)) if bias else None

    def reset_parameters(self, generator=None):
        # 0.8796 is the std of a unit normal truncated at ±2 (flax lecun_normal)
        trunc_normal_(self.weight, 1.0 / math.sqrt(self.weight.shape[-1]) / 0.87962566,
                      generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        if self.round_first and self.bias is not None:
            return linear(x, self.weight, None, self.dtype) + self.bias.to(self.dtype)
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
        # flax's own arithmetic in place of ``layer_norm`` (the int8 path's
        # blocks, whose requantization would magnify a rounding difference)
        self.flax_arithmetic = False

    def forward(self, x):
        dim = x.shape[-1:]
        if self.flax_arithmetic:
            return flax_layer_norm(x, self.weight, self.bias, self.eps).to(self.dtype)
        if self.weight.dim() == 1:
            return F.layer_norm(x.float(), dim, self.weight, self.bias, self.eps).to(self.dtype)
        return torch.stack([  # per band: its own scale and bias
            F.layer_norm(x[s].float(), dim, self.weight[s], self.bias[s], self.eps).to(self.dtype)
            for s in range(x.shape[0])])


def flax_layer_norm(x, weight, bias, eps: float):
    """flax ``LayerNorm``'s arithmetic (``_compute_stats`` with the fast
    variance, ``_normalize``) in f32: mean and E[x²] of x in f32, var =
    max(E[x²] − mean², 0), (x − mean) · (rsqrt(var + eps) · scale) + bias.
    ``weight`` and ``bias`` (D,) or per band (S, D) against (S, …, D)."""
    if weight.dim() == 2:
        shape = (weight.shape[0],) + (1,) * (x.dim() - 2) + (weight.shape[1],)
        weight, bias = weight.reshape(shape), bias.reshape(shape)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (xf - mean) * (torch.rsqrt(var + eps) * weight) + bias


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


class QuantDense(Linear):
    """``QuantDense`` (``layers.py:39-59``): a ``Linear`` whose matmul runs
    on the int8 path (``ops.quant.quant_dense_apply``) over its unchanged
    float weight, x cast to ``dtype`` first.  Serving only: the quantizer's
    round has no gradient."""

    def forward(self, x):
        from irw_tpu_torch.ops.quant import quant_dense_apply

        return quant_dense_apply(x.to(self.dtype), self.weight.transpose(-1, -2), self.bias,
                                 out_dtype=self.dtype)


def gelu_tanh_jnp(x):
    """``jax.nn.gelu(x, approximate=True)`` as jnp computes it, op by op in
    x's dtype: 0.5 · (1 + tanh(√(2/π) · (x + 0.044715 · x³))) · x, each
    constant rounded to the dtype first.  In bf16 it gives jnp's bits, where
    ``F.gelu`` rounds once."""
    def c(v):
        return torch.full((), v, dtype=x.dtype, device=x.device)

    inner = c(math.sqrt(2.0 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


class Mlp(nn.Module):
    """Linear → GELU → Linear → Dropout (``layers.py:62-99``).  GELU is the
    tanh form by default (flax ``nn.gelu``); ``exact_gelu=True`` is the erf
    form.  ``quant_int8=True`` makes both Linears ``QuantDense``, the same
    parameters, and takes the tanh form as jnp computes it
    (``gelu_tanh_jnp``): the int8 requantization after it would turn a
    rounding difference into a different integer."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 exact_gelu: bool = False, bands: int | None = None,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 quant_int8: bool = False):
        super().__init__()
        dense = QuantDense if quant_int8 else Linear
        self.fc1 = dense(in_dim, hidden_dim, bands=bands, dtype=dtype)
        self.fc2 = dense(hidden_dim, out_dim, bands=bands, dtype=dtype)
        self.approximate = "none" if exact_gelu else "tanh"
        self.jnp_gelu = quant_int8 and not exact_gelu
        self.dropout = dropout

    def forward(self, x, generator: torch.Generator | None = None):
        h = self.fc1(x)
        h = gelu_tanh_jnp(h) if self.jnp_gelu else F.gelu(h, approximate=self.approximate)
        return apply_dropout(self.fc2(h), self.dropout, self.training, generator)


class BatchNorm(nn.BatchNorm1d):
    """flax ``BatchNorm`` over the last axis of (B, C), eps 1e-5.  Eval: the
    running statistics.  Training: the batch mean and the BIASED batch
    variance, max(E[x²] − E[x]², 0) in f32, and the running statistics
    updated in place as 0.99·running + 0.01·batch (flax momentum 0.99, torch
    momentum 0.01 — torch's ``BatchNorm1d`` would store the unbiased
    variance)."""

    momentum_flax = 0.99

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=1.0 - self.momentum_flax)

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=0)
            var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum_flax
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class ProjectionHead(nn.Module):
    """Linear layers of widths ``dims`` (``layers.py:102-120``); between two
    of them ``norm`` (``bn``: flax BatchNorm, momentum 0.99; ``ln``:
    LayerNorm; ``None``: nothing), then ReLU.  One width is one Linear."""

    def __init__(self, in_dim: int, dims, norm: str | None = None):
        super().__init__()
        widths = [in_dim, *dims]
        self.norm_kind = norm
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        inner = widths[1:-1]
        if norm == "bn":
            self.norms = nn.ModuleList(BatchNorm(d) for d in inner)
        elif norm == "ln":
            self.norms = nn.ModuleList(LayerNorm(d) for d in inner)
        elif norm is None:
            self.norms = None
        else:
            raise ValueError(f"unknown projection norm {norm!r}")

    def reset_parameters(self, generator=None):
        for layer in self.layers:
            layer.reset_parameters(generator)
        for norm in self.norms or ():
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)
            if isinstance(norm, BatchNorm):
                norm.reset_running_stats()

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                if self.norms is not None:
                    x = self.norms[i](x)
                x = F.relu(x)
        return x


class HashHead(nn.Module):
    """Linear hash projection + BatchNorm bit centering (``layers.py:123-146``):
    the projection without bias, then ``BatchNorm``.  ``use_bn=False`` gives
    the projection a zero-init bias and no BatchNorm, as the reference's
    ``bias=not use_bn``.  The projection's weight is drawn from N(0, 0.01²)."""

    def __init__(self, in_dim: int, nbits: int, use_bn: bool = True):
        super().__init__()
        self.linear = Linear(in_dim, nbits, bias=not use_bn)
        self.bn = BatchNorm(nbits) if use_bn else None

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.linear.weight.normal_(0.0, 0.01, generator=generator)
        if self.linear.bias is not None:
            nn.init.zeros_(self.linear.bias)
        if self.bn is not None:
            self.bn.reset_parameters()

    def forward(self, x):
        x = self.linear(x.float())
        return x if self.bn is None else self.bn(x)


def binarize(logits, train: bool = False, continuous: str = "identity"):
    """Continuous relaxation in train, sign codes in eval (``layers.py:149-154``)."""
    if train:
        return torch.tanh(logits) if continuous == "tanh" else logits
    return torch.sign(logits)
