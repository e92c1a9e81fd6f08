"""Bilinear resize as ``jax.image.resize(method="bilinear")`` computes it,
the arithmetic of ``ResizeSubBands`` (``irw_tpu/transforms/pipeline.py:482-490``).

That call is ``scale_and_translate`` with the triangle kernel, half-pixel
centres and ``antialias=True``: per axis of input size m and output size n,
with s = n / m, output sample i sits at f_i = (i + 0.5) / s − 0.5 in the
input, its weights are max(0, 1 − |f_i − j| / max(1/s, 1)) over the input
samples j (the kernel widens by 1/s when downsampling), renormalised to sum
to 1 over the samples in range, and zero where f_i lies outside
[−0.5, m − 0.5].  The weight matrix is built in f32 from 1/s taken in
double, as JAX builds it (``compute_weight_mat`` is handed s as a Python
float).  ``F.interpolate`` does not widen its kernel when it
downsamples, so it is not this arithmetic.

Each output sample reads a few input samples (2 when upsampling, about
2/s + 1 when downsampling), so the weights are applied as that many
gathered multiply-adds along the axis, in f32 on every device: no matmul,
hence no TF32 on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def weight_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(index, weight), each (out_size, K): the input samples each output
    sample reads and their f32 weights (K the most any output reads; unused
    slots have weight 0)."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)     # in double: JAX passes the scale as a float
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - x)                       # (in, out)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(in_size - 0.5))
    weights = np.where(inside[None, :], weights, f32(0.0)).astype(f32).T   # (out, in)
    k = max(1, int((weights != 0).sum(axis=1).max()))
    index = np.zeros((out_size, k), dtype=np.int64)
    taps = np.zeros((out_size, k), dtype=f32)
    for i, row in enumerate(weights):
        nz = np.flatnonzero(row)
        index[i, :len(nz)] = nz
        taps[i, :len(nz)] = row[nz]
    return index, taps


def _resize_axis(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    in_size = x.shape[dim]
    if in_size == out_size:      # an identity warp: JAX skips the axis
        return x
    index, taps = weight_taps(in_size, out_size)
    shape = [1] * x.dim()
    shape[dim] = out_size
    acc = None
    for k in range(index.shape[1]):
        idx = torch.from_numpy(index[:, k]).to(x.device)
        w = torch.from_numpy(taps[:, k]).to(device=x.device, dtype=x.dtype).reshape(shape)
        term = w * x.index_select(dim, idx)
        acc = term if acc is None else acc + term
    return acc


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Resize H and W of (..., H, W, C) to ``size`` (an int or an (h, w)
    pair) as ``jax.image.resize(..., method="bilinear")``."""
    h, w = (size, size) if isinstance(size, int) else tuple(int(s) for s in size)
    return _resize_axis(_resize_axis(x, -3, h), -2, w)
