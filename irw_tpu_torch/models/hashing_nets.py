"""Single-trunk CE and hashing ResNets (port of
``irw_tpu/models/hashing_nets.py``).

Each ``forward(x, rngs, alpha=1.0) -> (output, {"ortho_loss": 0})`` on plain
images (B, H, W, C):

- ``ResNetCE``: classifier logits in training, the L2-normalised pooled
  features in eval; the classifier's weight and bias start at zero, and
  ``frozen_bn`` (the default) pins every BatchNorm to its running
  statistics (hashing_nets.py:31-48);
- ``ResNetHashing``: tanh(α·fc) in training, sign(fc) in eval, the fc
  weight drawn from N(0, 0.01²); α is the engine's per-epoch continuation,
  passed by the train step (hashing_nets.py:51-67).  ``ResNetHashingAlpha``
  is the same module;
- ``ResNet50DSCH``: the ResNet-50's last stage pooled (``avg``, or
  ``avg_max`` with ``double_pool``), optionally LayerNorm'd, then an
  ``n_bits`` Linear, optionally L2-normalised; the same in both modes
  (hashing_nets.py:74-95);
- ``ResNet50Mod``: a ``ResNet50DSCH`` with tanh(α·codes) in training and
  sign(codes) in eval (hashing_nets.py:98-112).

``dtype`` (``resnet.compute_dtype``) is the trunk's compute dtype, as the
JAX modules hand it to their ResNet; the fc and the LayerNorm take none in
JAX, so they compute in float32 on half-precision features, as jnp
promotes them.  ``ResNetCE``'s eval embedding stays in the trunk's dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from irw_tpu_torch.models.layers import (LayerNorm, Linear, global_pool, l2_normalize,
                                         zero_aux)
from irw_tpu_torch.models.resnet import ResNet


def _trunk(depth: int, frozen_bn: bool, dtype) -> ResNet:
    """``_trunk`` (hashing_nets.py:23-28): 18 → basic blocks, 101 → (3, 4,
    23, 3) bottlenecks, any other depth the ResNet-50."""
    if depth == 18:
        return ResNet((2, 2, 2, 2), "basic", frozen_bn=frozen_bn, dtype=dtype)
    if depth == 101:
        return ResNet((3, 4, 23, 3), "bottleneck", frozen_bn=frozen_bn, dtype=dtype)
    return ResNet((3, 4, 6, 3), "bottleneck", frozen_bn=frozen_bn, dtype=dtype)


class ResNetCE(nn.Module):
    def __init__(self, num_classes: int = 100, depth: int = 50, frozen_bn: bool = True,
                 dtype="float32"):
        super().__init__()
        self.trunk = _trunk(depth, frozen_bn, dtype)
        self.fc = Linear(self.trunk.out_dim, num_classes)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.trunk.reset_parameters(generator)
        nn.init.zeros_(self.fc.weight)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x, rngs: dict | None = None):
        feats = self.trunk(x)
        if self.training:
            logits = self.fc(feats)
            return logits, zero_aux(logits)
        return l2_normalize(feats), zero_aux(feats)


class ResNetHashing(nn.Module):
    def __init__(self, nbits: int = 64, depth: int = 50, frozen_bn: bool = True,
                 dtype="float32"):
        super().__init__()
        self.trunk = _trunk(depth, frozen_bn, dtype)
        self.fc = Linear(self.trunk.out_dim, nbits)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.trunk.reset_parameters(generator)
        with torch.no_grad():
            self.fc.weight.normal_(0.0, 0.01, generator=generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x, rngs: dict | None = None, alpha: float = 1.0):
        codes = self.fc(self.trunk(x))
        if self.training:
            return torch.tanh(alpha * codes), zero_aux(codes)
        return torch.sign(codes), zero_aux(codes)


def ResNetHashingAlpha(**kw) -> ResNetHashing:
    return ResNetHashing(**kw)


class ResNet50DSCH(nn.Module):
    def __init__(self, n_bits: int = 64, double_pool: bool = False,
                 use_layernorm: bool = False, normalize: bool = False, frozen_bn: bool = False,
                 dtype="float32"):
        super().__init__()
        self.double_pool = double_pool
        self.normalize = normalize
        self.trunk = ResNet((3, 4, 6, 3), "bottleneck", frozen_bn=frozen_bn, dtype=dtype)
        self.norm = LayerNorm(self.trunk.out_dim) if use_layernorm else None
        self.fc = Linear(self.trunk.out_dim, n_bits)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.trunk.reset_parameters(generator)
        if self.norm is not None:
            nn.init.ones_(self.norm.weight)
            nn.init.zeros_(self.norm.bias)
        self.fc.reset_parameters(generator)

    def forward(self, x, rngs: dict | None = None, alpha: float = 1.0):
        fmap = self.trunk(x, return_stages=True)[-1]
        feats = global_pool(fmap, "avg_max" if self.double_pool else "avg")
        if self.norm is not None:
            feats = self.norm(feats)
        codes = self.fc(feats)
        if self.normalize:
            codes = l2_normalize(codes)
        return codes, zero_aux(codes)


class ResNet50Mod(nn.Module):
    def __init__(self, n_bits: int = 64, dtype="float32"):
        super().__init__()
        self.dsch = ResNet50DSCH(n_bits=n_bits, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.dsch.reset_parameters(generator)

    def forward(self, x, rngs: dict | None = None, alpha: float = 1.0):
        codes, aux = self.dsch(x)
        if self.training:
            return torch.tanh(alpha * codes), aux
        return torch.sign(codes), aux
