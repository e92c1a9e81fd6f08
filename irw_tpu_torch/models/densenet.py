"""DenseNet (port of ``irw_tpu/models/densenet.py``): (B, H, W, C) →
globally average-pooled (B, D), 1024-d for ``densenet121`` (growth 32,
blocks (6, 12, 24, 16)).

The stem is a 7×7 stride-2 conv (pad 3) → BatchNorm → ReLU → 3×3 stride-2
max-pool padded with −inf; each ``DenseLayer`` is BatchNorm → ReLU → 1×1
conv to ``bn_size``·growth → BatchNorm → ReLU → 3×3 conv (pad 1) to growth,
concatenated onto its input; each ``Transition`` halves the channels (BN →
ReLU → 1×1 conv) and average-pools 2×2 with stride 2 over whole windows
(flax's VALID); a last BatchNorm → ReLU, then the mean.  Convs are
bias-free.  BatchNorm is ``resnet.BatchNorm`` (flax momentum 0.9);
``frozen_bn`` (densenet.py:46-70) pins every BatchNorm to its running
statistics in training, as ``ResNet``'s does.  Inside, NCHW views of the
NHWC input.  ``dtype`` is the compute dtype of every conv and BatchNorm
(``resnet.compute_dtype``); the concat, the pools and the mean stay in it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from irw_tpu_torch.models.resnet import (BatchNorm, _conv, compute_dtype, freeze_batch_norms,
                                         lecun_normal_)


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int, bn_size: int = 4, dtype=torch.float32):
        super().__init__()
        self.norm1 = BatchNorm(cin, dtype)
        self.conv1 = _conv(cin, bn_size * growth_rate, 1, dtype=dtype)
        self.norm2 = BatchNorm(bn_size * growth_rate, dtype)
        self.conv2 = _conv(bn_size * growth_rate, growth_rate, 3, 1, 1, dtype)

    def forward(self, x):
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, cin: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.norm = BatchNorm(cin, dtype)
        self.conv = _conv(cin, out_channels, 1, dtype=dtype)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    def __init__(self, block_sizes=(6, 12, 24, 16), growth_rate: int = 32,
                 init_features: int = 64, frozen_bn: bool = False, dtype="float32"):
        super().__init__()
        self.dtype = dtype = compute_dtype(dtype)
        self.frozen_bn = frozen_bn
        self.block_sizes = tuple(block_sizes)
        self.stem = _conv(3, init_features, 7, 2, 3, dtype)
        self.stem_norm = BatchNorm(init_features, dtype)
        layers, transitions, channels = [], [], init_features
        for block_idx, n_layers in enumerate(self.block_sizes):
            for _ in range(n_layers):
                layers.append(DenseLayer(channels, growth_rate, dtype=dtype))
                channels += growth_rate
            if block_idx < len(self.block_sizes) - 1:
                transitions.append(Transition(channels, channels // 2, dtype))
                channels //= 2
        self.layers = nn.ModuleList(layers)
        self.transitions = nn.ModuleList(transitions)
        self.norm = BatchNorm(channels, dtype)
        self.out_dim = channels

    def train(self, mode: bool = True):
        super().train(mode)
        if self.frozen_bn:
            freeze_batch_norms(self)
        return self

    def reset_parameters(self, generator: torch.Generator | None = None):
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight, generator)
            elif isinstance(mod, BatchNorm):
                mod.reset_parameters()

    def forward(self, x, rngs: dict | None = None):
        x = x.permute(0, 3, 1, 2)  # NHWC memory as an NCHW view
        x = F.max_pool2d(F.relu(self.stem_norm(self.stem(x))), 3, 2, padding=1)
        layers = iter(self.layers)
        for block_idx, n_layers in enumerate(self.block_sizes):
            for _ in range(n_layers):
                x = next(layers)(x)
            if block_idx < len(self.transitions):
                x = self.transitions[block_idx](x)
        return F.relu(self.norm(x)).mean(dim=(2, 3))


def densenet121(**kw) -> DenseNet:
    return DenseNet(block_sizes=(6, 12, 24, 16), **kw)
