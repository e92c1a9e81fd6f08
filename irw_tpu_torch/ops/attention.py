"""Fused multi-head attention forward for short sequences (ViT, N = 257).

Port of ``irw_tpu/ops/vmem_attention.py``: ``fused_attention`` (:273-324,
kernel body ``_fwd_kernel`` :166-173) and ``vmem_attention_fn``'s routing
rule (:327-370).  ``fused_attention`` launches the CUDA kernel K2
(``csrc/attention_fwd.cu``) for CUDA tensors and runs ``attention_plain`` for
CPU tensors.  The public layout stays ``(…, N, H, hd)``; the kernel reads it
through strides (the JAX wrapper's transpose to (B, H, N, hd) existed only
for Mosaic's block rules).

The attention backward kernel (``_bwd_kernel``, K3) lands with the training
slice: until then a call that needs a gradient raises, on every device.
The multi-device mesh context (vmem_attention.py:57-138) waits for ROADMAP
A13.
"""

from __future__ import annotations

import ctypes
import math

import torch

from irw_tpu_torch import cuda_lib

_NO_BACKWARD = ("fused_attention has no backward yet: the attention backward "
                "kernel lands with the training slice, ROADMAP A6/B2")


def attention_plain(q, k, v, scale: float | None = None):
    """The TPU kernel's math in plain PyTorch: f32 scores times scale, f32
    softmax with max subtraction, the NORMALISED probabilities cast to the
    input dtype, P·V accumulated in f32 and cast to the output dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    o = torch.einsum("...hqk,...khd->...qhd", p.float(), v.float())
    return o.to(q.dtype)


_SIGNATURES = {
    "irw_attention_fwd": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
        + [ctypes.c_longlong] * 12 + [ctypes.c_void_p],
        ctypes.c_int),
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it through its strides: head_dim
    contiguous and, for bf16 (16-byte loads), every row start 16-byte
    aligned.  Otherwise a contiguous copy."""
    ok = t.stride(-1) == 1
    if ok and t.dtype == torch.bfloat16:
        ok = t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
    return t if ok else t.contiguous()


def fused_attention(q, k, v, *, scale: float | None = None):
    """softmax(q·kᵀ·scale)·v per head; q, k, v ``(…, N, H, hd)`` of one shape.

    ``scale`` defaults to 1/√hd.  CPU tensors: ``attention_plain``.  CUDA
    tensors: kernel K2 (f32 or bf16, hd ∈ {32, 64, 128}), counted in
    ``fused_attention.launches``.  Raises if a gradient is needed.
    """
    if q.shape != k.shape or q.shape != v.shape or q.dim() < 3:
        raise ValueError(f"fused_attention takes q, k, v of one (..., N, H, hd) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"fused_attention: mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(_NO_BACKWARD)
    *lead, n, h, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"fused_attention: no kernel for devices "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"fused_attention kernel takes head_dim in {_HEAD_DIMS}, got {hd}")
    b = math.prod(lead)
    # flatten the batch dims without copying when the layout allows it
    q3, k3, v3 = (_kernel_layout(t.reshape(b, n, h, hd)) for t in (q, k, v))
    out = torch.empty((b, n, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out.reshape(q.shape)
    lib = cuda_lib.load("attention_fwd", _SIGNATURES)
    strides = [s for t in (q3, k3, v3, out) for s in t.stride()[:3]]
    status = lib.irw_attention_fwd(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], b, n, h, hd, float(scale), *strides,
        cuda_lib.stream_of(q3))
    cuda_lib.check(status, "fused_attention", lib)
    fused_attention.launches += 1
    return out.reshape(q.shape)


fused_attention.launches = 0


def dot_product_attention(query, key, value, bias=None, mask=None,
                          dropout_rate: float = 0.0, deterministic: bool = True,
                          generator: torch.Generator | None = None):
    """flax ``dot_product_attention`` semantics — the JAX package's own
    non-kernel path: q scaled by 1/√depth in the input dtype, scores and
    softmax in the input dtype, optional bias and boolean mask (masked
    scores set to the dtype's min), dropout broadcast over batch and heads.
    Layout (…, N, H, hd) for q, (…, M, H, hd) for k and v."""
    depth = query.shape[-1]
    query = query / torch.tensor(math.sqrt(depth), dtype=query.dtype)
    w = torch.einsum("...qhd,...khd->...hqk", query, key)
    if bias is not None:
        w = w + bias
    if mask is not None:
        w = torch.where(mask, w, torch.finfo(w.dtype).min)
    w = torch.softmax(w, dim=-1).to(query.dtype)
    if dropout_rate > 0.0 and not deterministic:
        keep_prob = 1.0 - dropout_rate
        shape = (1,) * (key.dim() - 2) + tuple(w.shape[-2:])
        keep = torch.rand(shape, generator=generator, device=w.device) < keep_prob
        w = w * (keep.to(w.dtype) / torch.tensor(keep_prob, dtype=w.dtype))
    return torch.einsum("...hqk,...khd->...qhd", w, value)


def vmem_attention_fn(query, key, value, bias=None, mask=None,
                      dropout_rate: float = 0.0, deterministic: bool = True,
                      generator: torch.Generator | None = None):
    """Attention for a ViT block with ``vmem_attn`` on
    (vmem_attention.py:327-370): the fused kernel for plain self-attention;
    bias, mask, active dropout or q.shape ≠ k.shape take
    ``dot_product_attention`` instead."""
    needs_plain = (bias is not None or mask is not None
                   or (dropout_rate > 0.0 and not deterministic)
                   or query.shape != key.shape)
    if needs_plain:
        return dot_product_attention(query, key, value, bias=bias, mask=mask,
                                     dropout_rate=dropout_rate,
                                     deterministic=deterministic, generator=generator)
    return fused_attention(query, key, value)
