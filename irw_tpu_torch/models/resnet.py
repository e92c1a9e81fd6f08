"""ResNet family, the conv backbone of the wavelet-CNN models (port of
``irw_tpu/models/resnet.py:23-125``).

Input and output keep the JAX package's NHWC layout at the module boundary:
``ResNet`` takes (B, H, W, C) and returns pooled (B, D) features, or with
``return_stages`` the four stages' (B, h, w, C) maps; inside, the tensors are
NCHW views of channels-last memory, which cuDNN takes as they are.  The
compute dtype is the JAX modules' ``dtype`` (``compute_dtype``: float32,
bfloat16 or float16, as a config's string or a torch dtype); parameters and
BatchNorm statistics stay float32, as flax's ``param_dtype``.  flax
semantics kept:

- ``BatchNorm``: eps 1e-5, flax momentum 0.9 (= torch momentum 0.1); eval
  uses the running statistics; training normalises with the batch
  statistics as flax computes them and updates the running variance with
  the BIASED batch variance (torch's own module would store the unbiased
  one);
- 3×3 convs pad 1, the stem (``stem_kernel`` × ``stem_kernel``, stride
  ``stem_stride``; 7 and 2 by default) pads ``stem_kernel // 2``; the 1×1
  projections of ``padding='SAME'`` pad nothing at any size;
- the stem's 3×3 stride-2 max-pool pads with −inf; a 1×1 stem has none
  (resnet.py:80-98, ``WaveResNet``'s stem over half-resolution bands);
- convs are bias-free; parameters start from flax's initialisers
  (lecun-normal kernels, BatchNorm scale 1 and bias 0);
- in a half dtype (flax ``promote_dtype``, ``linear.py:687-688``) a conv
  casts its input and kernel (and bias) to the dtype, the bias added after
  the product is rounded; a BatchNorm takes its statistics from x in
  float32 and computes y in float32, cast to the dtype once
  (``normalization.py:111-116, :205-226``); ReLU, max-pool, the residual
  add and the pooled mean stay in the dtype;
- ``frozen_bn`` (resnet.py:85-87): in training every BatchNorm normalises
  with its running statistics and leaves them untouched, as flax's
  ``use_running_average``; the gradient still reaches scale and bias.

``stem`` and ``stage`` run the trunk piece by piece on NCHW views, as the
stage-interleaved trunk of ``mtwavenet`` drives it; ``forward`` is the two
in order.

``convs`` and ``norms`` of a block follow flax's auto-naming order
(``Conv_i``/``BatchNorm_i``; a projection comes last), which is all the
bridge needs.
"""

from __future__ import annotations

import math
import warnings

import torch
import torch.nn.functional as F
from torch import nn

from irw_tpu_torch.models.layers import trunc_normal_


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None):
    """flax ``lecun_normal``: truncated normal (±2σ) of variance 1/fan_in,
    fan_in = every axis but the output one."""
    fan_in = weight[0].numel()
    # 0.8796 is the std of a unit normal truncated at ±2
    return trunc_normal_(weight, 1.0 / math.sqrt(fan_in) / 0.87962566, generator)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def compute_dtype(dtype) -> torch.dtype:
    """A module's ``dtype`` (a config's string, a torch dtype, or None for
    float32) as the torch dtype it computes in.  ``float64`` computes in
    float32, as jnp casts to it with 64-bit types off (with the same
    warning); any other name raises a ``ValueError`` that names it."""
    if dtype is None:
        return torch.float32
    name = str(dtype).removeprefix("torch.")
    if name == "float64":
        warnings.warn("dtype float64 is not available, and will be truncated to float32 (as "
                      "jnp does with 64-bit types off)", UserWarning, stacklevel=3)
        return torch.float32
    if name not in _DTYPES:
        raise ValueError(f"dtype {dtype!r} is not one the trunks compute in: "
                         f"{sorted(_DTYPES)} (or float64, as float32)")
    return _DTYPES[name]


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv`` in ``dtype``: in a half dtype the input, kernel and
    bias are cast to it at use, the bias added after the product is rounded
    to it.  In float32 it is PyTorch's own conv in its parameters' dtype.

    On the CPU the half-precision operands are multiplied in float32 and the
    product rounded once, as a half-precision conv accumulates: PyTorch's
    CPU bf16 conv (2.13) returns non-finite kernel gradients where a tap
    sees only padding (a 3×3 stride-2 conv over 1×1 maps)."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = compute_dtype(dtype)

    def forward(self, x):
        if self.dtype == torch.float32:
            return super().forward(x.to(self.weight.dtype))
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if x.device.type == "cpu":
            y = self._conv_forward(x.float(), w.float(), None).to(self.dtype)
        else:
            y = self._conv_forward(x, w, None)
        return y if self.bias is None else y + self.bias.to(self.dtype)[:, None, None]


class BatchNorm(nn.BatchNorm2d):
    """flax ``BatchNorm`` over the channel axis of an NCHW tensor, output in
    ``dtype``.  Eval: PyTorch's (cuDNN's) batch norm on the running
    statistics, which computes in float32 and rounds once.  Training:
    flax's arithmetic (``flax/linen/normalization.py`` ``_compute_stats``,
    ``_normalize``) on x promoted to the statistics' float32: var =
    max(E[x²] − E[x]², 0), y = (x − mean) · (rsqrt(var + eps) · scale) +
    bias, cast to ``dtype`` once, and the running statistics updated in
    place as 0.9·running + 0.1·batch with that biased variance.  In
    float32 nothing is cast: the module follows its parameters' dtype."""

    momentum_flax = 0.9

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__(channels, eps=1e-5, momentum=1.0 - self.momentum_flax)
        self.dtype = compute_dtype(dtype)

    def forward(self, x):
        half = self.dtype != torch.float32
        if not (half and x.dtype == self.dtype and not self.training):
            x = x.to(self.running_mean.dtype)
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
            return y.to(self.dtype) if half else y
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum_flax
            self.running_mean.mul_(m).add_((1.0 - m) * mean)
            self.running_var.mul_(m).add_((1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype) if half else y


def freeze_batch_norms(module: nn.Module) -> None:
    """Every ``BatchNorm`` of ``module`` back in eval mode (``frozen_bn``)."""
    for mod in module.modules():
        if isinstance(mod, BatchNorm):
            mod.train(False)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
          dtype=torch.float32) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False, dtype=dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        convs = [_conv(cin, filters, 3, stride, 1, dtype), _conv(filters, filters, 3, 1, 1, dtype)]
        self.project = stride != 1 or cin != filters
        if self.project:
            convs.append(_conv(cin, filters, 1, stride, dtype=dtype))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(BatchNorm(c.out_channels, dtype) for c in convs)

    def forward(self, x):
        y = F.relu(self.norms[0](self.convs[0](x)))
        y = self.norms[1](self.convs[1](y))
        residual = self.norms[2](self.convs[2](x)) if self.project else x
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        convs = [_conv(cin, filters, 1, dtype=dtype), _conv(filters, filters, 3, stride, 1, dtype),
                 _conv(filters, filters * 4, 1, dtype=dtype)]
        self.project = stride != 1 or cin != filters * 4
        if self.project:
            convs.append(_conv(cin, filters * 4, 1, stride, dtype=dtype))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(BatchNorm(c.out_channels, dtype) for c in convs)

    def forward(self, x):
        y = F.relu(self.norms[0](self.convs[0](x)))
        y = F.relu(self.norms[1](self.convs[1](y)))
        y = self.norms[2](self.convs[2](y))
        residual = self.norms[3](self.convs[3](x)) if self.project else x
        return F.relu(y + residual)


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class ResNet(nn.Module):
    """Stage-structured ResNet: (B, H, W, C) → globally average-pooled (B, D)."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), block: str = "bottleneck", width: int = 64,
                 frozen_bn: bool = False, stem_kernel: int = 7, stem_stride: int = 2,
                 dtype="float32"):
        super().__init__()
        cls = BLOCKS[block]
        self.dtype = dtype = compute_dtype(dtype)
        self.frozen_bn = frozen_bn
        self.stem_pool = stem_kernel > 1
        self.stem = _conv(3, width, stem_kernel, stem_stride, stem_kernel // 2, dtype)
        self.stem_norm = BatchNorm(width, dtype)
        blocks, cin, self.stage_dims = [], width, []
        for stage, num_blocks in enumerate(stage_sizes):
            filters = width * 2 ** stage
            for i in range(num_blocks):
                blocks.append(cls(cin, filters, 2 if stage > 0 and i == 0 else 1, dtype))
                cin = filters * cls.expansion
            self.stage_dims.append(cin)
        self.blocks = nn.ModuleList(blocks)
        self.stage_ends = [sum(stage_sizes[:i + 1]) for i in range(len(stage_sizes))]
        self.out_dim = cin

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

    def stem_forward(self, x):
        """The stem on an NCHW view: conv → BatchNorm → ReLU (→ max-pool)."""
        x = F.relu(self.stem_norm(self.stem(x)))
        return F.max_pool2d(x, 3, 2, padding=1) if self.stem_pool else x

    def stage_forward(self, stage: int, x):
        """Stage ``stage``'s blocks on an NCHW view."""
        start = self.stage_ends[stage - 1] if stage else 0
        for blk in self.blocks[start:self.stage_ends[stage]]:
            x = blk(x)
        return x

    def forward(self, x, rngs: dict | None = None, *, return_stages: bool = False):
        """``rngs`` is unused: a bare trunk takes the models' call."""
        x = self.stem_forward(x.permute(0, 3, 1, 2))  # NHWC memory as an NCHW view
        stages = []
        for stage in range(len(self.stage_ends)):
            x = self.stage_forward(stage, x)
            stages.append(x.permute(0, 2, 3, 1))
        if return_stages:
            return stages
        return x.mean(dim=(2, 3))


def resnet18(**kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block="basic", **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block="basic", **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block="bottleneck", **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), block="bottleneck", **kw)
