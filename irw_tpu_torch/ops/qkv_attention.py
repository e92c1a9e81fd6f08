"""The attention segment in one call: q/k/v projections with bias, per-head
softmax attention, heads concatenated (no output projection, forward only).

Port of ``benchmarks/vmem_qkv_micro.py``'s ``fused_qkv_attention`` (:65-89)
over the kernel body ``_qkv_attn_kernel`` (:46-62), whose point is that Q, K
and V never reach device memory.  For CUDA tensors ``fused_qkv_attention``
launches kernel K5 (``csrc/qkv_attention.cu``) and raises rather than fall
back; for CPU tensors it runs ``qkv_attention_plain``.  The JAX wrapper's
``block_b`` (sequences per TPU grid step) and ``interpret`` have no numeric
meaning and no counterpart here.  Like the JAX kernel it has no gradient: it
raises when an input requires one.
"""

from __future__ import annotations

import ctypes
import math

import torch

from irw_tpu_torch import cuda_lib
from irw_tpu_torch.ops.attention import attention_plain

_SIGNATURES = {
    "irw_qkv_attention": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "irw_qkv_attention_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_longlong),
    "irw_qkv_attention_max_smem": ([], ctypes.c_longlong),
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def qkv_attention_plain(x, wq, wk, wv, bq, bk, bv, *, heads: int):
    """The TPU kernel's math in plain PyTorch, at its rounding points: each
    projection accumulated in f32, the bias added in f32, one cast to x's
    dtype; per head the f32 scores times 1/√hd, the NORMALISED probabilities
    cast to x's dtype, P·V accumulated in f32 and cast; heads concatenated.

    x (B, N, D); wq, wk, wv (D, H·hd) in Dense (in, out) layout; bq, bk, bv
    (H·hd,) → (B, N, H·hd)."""
    b, n, _ = x.shape
    hd = wq.shape[-1] // heads
    xf = x.float()
    q, k, v = ((xf @ w.float() + bias.float()).to(x.dtype).reshape(b, n, heads, hd)
               for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
    return attention_plain(q, k, v, 1.0 / math.sqrt(hd)).reshape(b, n, heads * hd)


def _check_inputs(x, weights, biases, heads: int) -> bool:
    """True when every tensor lies on the CPU (the plain version's case),
    False for the CUDA kernel's; raises for anything neither takes."""
    tensors = (x, *weights, *biases)
    if x.dim() != 3:
        raise ValueError(f"fused_qkv_attention takes x of shape (B, N, D), got {tuple(x.shape)}")
    d, out = x.shape[-1], weights[0].shape[-1]
    if any(w.shape != (d, out) for w in weights) or any(b.shape != (out,) for b in biases):
        raise ValueError("fused_qkv_attention takes weights (D, H·hd) and biases (H·hd,), got "
                         f"{[tuple(t.shape) for t in tensors[1:]]} for x {tuple(x.shape)}")
    if heads <= 0 or out % heads:
        raise ValueError(f"fused_qkv_attention: {out} output features do not split into "
                         f"{heads} heads")
    if any(t.dtype != x.dtype for t in tensors):
        raise ValueError(f"fused_qkv_attention: mixed dtypes {[t.dtype for t in tensors]}")
    if any(t.requires_grad for t in tensors) and torch.is_grad_enabled():
        raise NotImplementedError(
            "fused_qkv_attention has no backward (the TPU kernel it ports has none): call it "
            "under torch.no_grad() or on tensors that need no gradient")
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("fused_qkv_attention: no kernel for devices "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_qkv_attention kernel takes float32 or bfloat16, got {x.dtype}")
    if out // heads not in _HEAD_DIMS:
        raise ValueError(f"fused_qkv_attention kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {out // heads}")
    if x.dtype == torch.bfloat16 and d % 8:
        raise ValueError("fused_qkv_attention kernel reads bf16 rows in 16-byte pieces: D must "
                         f"be a multiple of 8, got {d}")
    return False


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel's bf16 loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_qkv_attention(x, wq, wk, wv, bq, bk, bv, *, heads: int):
    """softmax((x·wq + bq)_h (x·wk + bk)_hᵀ / √hd) (x·wv + bv)_h per head h,
    heads concatenated: (B, N, D) → (B, N, H·hd), in x's dtype.

    CPU tensors: ``qkv_attention_plain``.  CUDA tensors: kernel K5 (f32 or
    bf16, hd ∈ {32, 64, 128}), counted in ``fused_qkv_attention.launches``;
    it raises for anything else.  The kernel keeps one head's K and V of a
    whole sequence in shared memory, which bounds N: at hd = 64, N ≤ 704 in
    bf16 and N ≤ 320 in f32; at hd = 128, N ≤ 320 in bf16 and N ≤ 128 in f32.
    No gradient: raises when an input requires one.
    """
    if _check_inputs(x, (wq, wk, wv), (bq, bk, bv), heads):
        return qkv_attention_plain(x, wq, wk, wv, bq, bk, bv, heads=heads)
    b, n, d = x.shape
    out_features = wq.shape[-1]
    hd = out_features // heads
    out = torch.empty((b, n, out_features), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load("qkv_attention", _SIGNATURES)
    code = _DTYPE_CODES[x.dtype]
    need, most = lib.irw_qkv_attention_smem_bytes(code, n, hd), lib.irw_qkv_attention_max_smem()
    if need > most:
        raise ValueError(f"fused_qkv_attention kernel keeps K and V of all {n} rows in shared "
                         f"memory: {need} bytes at head_dim {hd} {x.dtype}, the card gives a "
                         f"block {most}")
    tensors = [_kernel_layout(t) for t in (x, wq, wk, wv, bq, bk, bv)]
    status = lib.irw_qkv_attention(
        *(t.data_ptr() for t in tensors), out.data_ptr(), code, b, n, d, heads, hd,
        1.0 / math.sqrt(hd), cuda_lib.stream_of(out))
    cuda_lib.check(status, "fused_qkv_attention", lib)
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0
