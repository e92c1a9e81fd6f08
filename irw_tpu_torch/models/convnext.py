"""ConvNeXt (port of ``irw_tpu/models/convnext.py``): (B, H, W, C) → (B, D),
D = the last stage's width, 768 for ``convnext_tiny`` and ``convnext_small``.

A 4×4 stride-4 patchify conv and a LayerNorm; per stage after the first a
LayerNorm and a 2×2 stride-2 conv; ``ConvNeXtBlock``s; the spatial mean and
a last LayerNorm.  A block is a 7×7 depthwise conv with bias (pad 3) →
LayerNorm → Linear to 4·dim → GELU (tanh form, flax's ``nn.gelu``) → Linear
back → times the LayerScale ``gamma`` (initialised to 1e-6), added to the
block's input.  Every conv has a bias; LayerNorm's eps is 1e-6.

The stem and downsampling convs are flax ``nn.Conv`` with its default
``'SAME'`` padding: on a size the stride does not divide they pad
(total = (out − 1)·stride + k − in) with the smaller half at the top and
left, as XLA pads.  The blocks run on NHWC tensors (LayerNorm and Linear on
the channel axis), the convs on NCHW views of them.

``dtype`` (``resnet.compute_dtype``) is the compute dtype of every conv,
Linear and LayerNorm, as the JAX module passes it; parameters stay
float32.  The LayerScale product promotes: ``y * gamma`` with a float32
``gamma`` is float32, so from the first block on the residual stream is
float32 and each conv and LayerNorm casts it back (convnext.py:29-30).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from irw_tpu_torch.models.layers import LayerNorm, Linear
from irw_tpu_torch.models.resnet import Conv2d, compute_dtype, lecun_normal_


def _same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(conv: Conv2d, x):
    """``conv`` (no padding of its own) over the NHWC ``x`` with flax's
    ``'SAME'`` padding; NHWC out."""
    x = x.permute(0, 3, 1, 2)
    (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
    top, bottom = _same_pad(x.shape[2], kh, sh)
    left, right = _same_pad(x.shape[3], kw, sw)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return conv(x).permute(0, 2, 3, 1)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layerscale_init: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.layerscale_init = layerscale_init
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = LayerNorm(dim, dtype=dtype)
        self.fc1 = Linear(dim, 4 * dim, dtype=dtype, round_first=True)
        self.fc2 = Linear(4 * dim, dim, dtype=dtype, round_first=True)
        self.gamma = nn.Parameter(torch.full((dim,), layerscale_init))

    def forward(self, x):
        y = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = self.fc2(F.gelu(self.fc1(self.norm(y)), approximate="tanh"))
        return x + y * self.gamma


class ConvNeXt(nn.Module):
    def __init__(self, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), dtype="float32"):
        super().__init__()
        self.dtype = dtype = compute_dtype(dtype)
        self.depths = tuple(depths)
        self.stem = Conv2d(3, dims[0], 4, stride=4, dtype=dtype)
        self.stem_norm = LayerNorm(dims[0], dtype=dtype)
        self.down_norms = nn.ModuleList(LayerNorm(d, dtype=dtype) for d in dims[:-1])
        self.downsamples = nn.ModuleList(Conv2d(a, b, 2, stride=2, dtype=dtype)
                                         for a, b in zip(dims[:-1], dims[1:]))
        self.blocks = nn.ModuleList(ConvNeXtBlock(dim, dtype=dtype)
                                    for depth, dim in zip(depths, dims) for _ in range(depth))
        self.norm = LayerNorm(dims[-1], dtype=dtype)
        self.out_dim = dims[-1]

    def reset_parameters(self, generator: torch.Generator | None = None):
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight, generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, Linear):
                mod.reset_parameters(generator)
            elif isinstance(mod, LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
        for blk in self.blocks:
            nn.init.constant_(blk.gamma, blk.layerscale_init)

    def forward(self, x, rngs: dict | None = None):
        x = self.stem_norm(conv_same(self.stem, x))
        blocks = iter(self.blocks)
        for stage, depth in enumerate(self.depths):
            if stage > 0:
                x = conv_same(self.downsamples[stage - 1], self.down_norms[stage - 1](x))
            for _ in range(depth):
                x = next(blocks)(x)
        return self.norm(x.mean(dim=(1, 2)))


def convnext_tiny(**kw) -> ConvNeXt:
    return ConvNeXt(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), **kw)


def convnext_small(**kw) -> ConvNeXt:
    return ConvNeXt(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768), **kw)
