"""Subband gates and the cross-band stage attention (port of
``irw_tpu/models/attention_blocks.py``).

Each subband gate takes (B, S, D) and returns the gate-weighted MEAN over
subbands, einsum('bsd,bs->bd') / S, with the (B, S) gate.  The pools over D
are taken in the input's dtype (a bf16 backbone's, for the ViT fusion heads)
and the gate and the weighted mean in f32, as the JAX gates
(``dtype=float32``) promote them.  ``ChannelGate1D`` (mtwavenet's fusion) is
the same gate with the weighted SUM, no ``/ S`` (attention_blocks.py:86-105).
``CrossBandAttention`` gates the stage maps of every band over their S·C
channels, band-major (attention_blocks.py:108-152), in the trunk's
``dtype``: its Dense layers, conv and BatchNorm compute in it (the bias
added after the rounding, as flax's), and the pools, the sigmoid and the
gating products stay in it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from irw_tpu_torch.models.layers import Linear
from irw_tpu_torch.models.resnet import Conv2d, compute_dtype, lecun_normal_


def _fuse(x, scale):
    return torch.einsum("bsd,bs->bd", x.to(scale.dtype), scale) / x.shape[1]


class SubbandChannelGate(nn.Module):
    """avg- and max-pool over D per band, one MLP (reduction ratio 1) shared
    by both pools, sigmoid of the sum (wresnet.py ChannelGate.forward:121-144)."""

    def __init__(self, num_subbands: int = 4):
        super().__init__()
        self.fc1 = Linear(num_subbands, num_subbands)
        self.fc2 = Linear(num_subbands, num_subbands)

    def reset_parameters(self, generator=None):
        self.fc1.reset_parameters(generator)
        self.fc2.reset_parameters(generator)

    def forward(self, x):
        att = sum(self.fc2(F.relu(self.fc1(pooled))) for pooled in (x.mean(dim=-1),
                                                                    x.amax(dim=-1)))
        scale = torch.sigmoid(att)
        return _fuse(x, scale), scale


class SubbandEca(nn.Module):
    """ECA: a bias-free 1-D conv of width 3 over the per-band means, flax
    ``padding='SAME'`` (wresnet.py Eca1D_layer:214-239)."""

    def __init__(self, num_subbands: int = 4):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, 1, 3))

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, generator)

    def forward(self, x):
        pooled = x.mean(dim=-1)[:, None].to(self.weight.dtype)
        scale = torch.sigmoid(F.conv1d(pooled, self.weight, padding=1)[:, 0])
        return _fuse(x, scale), scale


class SubbandCBAM(nn.Module):
    """CBAM with ``no_spatial=True``, the only form the reference builds
    (wresnet.py:197-208): the channel gate."""

    def __init__(self, num_subbands: int = 4):
        super().__init__()
        self.gate = SubbandChannelGate(num_subbands)

    def reset_parameters(self, generator=None):
        self.gate.reset_parameters(generator)

    def forward(self, x):
        return self.gate(x)


SUBBAND_GATES = {"cbam": SubbandCBAM, "eca": SubbandEca, "channel": SubbandChannelGate}


class ChannelGate1D(nn.Module):
    """mtwavenet's fusion gate: ``SubbandChannelGate``'s MLP and sigmoid,
    returning the gate-weighted SUM over subbands (no ``/ S``)."""

    def __init__(self, num_subbands: int = 4):
        super().__init__()
        self.fc1 = Linear(num_subbands, num_subbands)
        self.fc2 = Linear(num_subbands, num_subbands)

    def reset_parameters(self, generator=None):
        self.fc1.reset_parameters(generator)
        self.fc2.reset_parameters(generator)

    def forward(self, x):
        att = sum(self.fc2(F.relu(self.fc1(pooled))) for pooled in (x.mean(dim=-1),
                                                                    x.amax(dim=-1)))
        scale = torch.sigmoid(att)
        return torch.einsum("bsd,bs->bd", x.to(scale.dtype), scale), scale


class CrossBandAttention(nn.Module):
    """Channel attention over the S bands' stage maps taken as one map of
    S·C channels, band-major (channel s·C + c, the JAX module's
    ``moveaxis(x, 1, -2).reshape(b, h, w, s * c)``): avg- and max-pool over
    the map, one MLP (S·C → S·C → S·C, reduction ratio 1) shared by both
    pools, sigmoid of the sum, times the maps.  With ``no_spatial=False`` a
    spatial gate follows: the channels' max and mean (in that order) → a
    bias-free 7×7 conv (pad 3) → a BatchNorm on its running statistics in
    both modes (flax ``use_running_average=True``, eps 1e-5) → sigmoid.

    Takes and returns the bands as a list of S (B, C, H, W) tensors, so
    each band's memory stays as its trunk left it; returns the (B, S·C)
    gate beside them."""

    def __init__(self, channels: int, no_spatial: bool = True, dtype="float32"):
        super().__init__()
        self.dtype = dtype = compute_dtype(dtype)
        self.fc1 = Linear(channels, channels, dtype=dtype, round_first=True)
        self.fc2 = Linear(channels, channels, dtype=dtype, round_first=True)
        self.no_spatial = no_spatial
        if not no_spatial:
            self.spatial = Conv2d(2, 1, 7, padding=3, bias=False, dtype=dtype)
            self.spatial_norm = nn.BatchNorm2d(1, eps=1e-5)

    def reset_parameters(self, generator=None):
        self.fc1.reset_parameters(generator)
        self.fc2.reset_parameters(generator)
        if not self.no_spatial:
            lecun_normal_(self.spatial.weight, generator)
            self.spatial_norm.reset_parameters()

    def forward(self, bands):
        avg = torch.cat([y.mean(dim=(2, 3)) for y in bands], dim=-1)     # (B, S·C)
        mx = torch.cat([y.amax(dim=(2, 3)) for y in bands], dim=-1)
        scale = torch.sigmoid(self.fc2(F.relu(self.fc1(avg))) + self.fc2(F.relu(self.fc1(mx))))
        out = [y * w[:, :, None, None] for y, w in zip(bands, scale.chunk(len(bands), dim=-1))]
        if not self.no_spatial:
            stacked = torch.cat(out, dim=1)
            pooled = torch.stack([stacked.amax(dim=1), stacked.mean(dim=1)], dim=1)
            norm = self.spatial_norm
            spatial = F.batch_norm(self.spatial(pooled), norm.running_mean, norm.running_var,
                                   norm.weight, norm.bias, False, 0.0, norm.eps)
            gate = torch.sigmoid(spatial)
            out = [y * gate for y in out]
        return out, scale
