"""Subband gates over the branch-embedding stack (port of
``irw_tpu/models/attention_blocks.py:19-83``).

Each gate takes (B, S, D) and returns the gate-weighted MEAN over subbands,
einsum('bsd,bs->bd') / S, with the (B, S) gate.  The pools over D are taken
in the input's dtype (a bf16 backbone's, for the ViT fusion heads) and the
gate and the weighted mean in f32, as the JAX gates (``dtype=float32``)
promote them.  ``ChannelGate1D`` and ``CrossBandAttention`` belong to
mtwavenet and wait for ROADMAP A10b.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from irw_tpu_torch.models.layers import Linear
from irw_tpu_torch.models.resnet import lecun_normal_


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
