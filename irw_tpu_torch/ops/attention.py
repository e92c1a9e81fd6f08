"""Fused multi-head attention for short sequences (ViT, N = 257), forward
and backward.

Port of ``irw_tpu/ops/vmem_attention.py``: ``fused_attention`` (:273-324)
with its custom VJP ``_core`` (:242-256) over the kernel bodies
``_fwd_kernel`` (:166-173) and ``_bwd_kernel`` (:176-192), and
``vmem_attention_fn``'s routing rule (:327-370).  ``fused_attention`` is a
``torch.autograd.Function`` when a gradient will be taken: for CUDA tensors
its forward launches kernel K2 (``csrc/attention_fwd.cu``) and its backward
kernel K3 (``csrc/attention_bwd.cu``), and it raises rather than fall back;
for CPU tensors they run ``attention_plain`` and ``attention_plain_bwd``.
The forward is the custom op ``irw_tpu_torch::attention_fwd``
(``ops.library``), which an exported eval forward calls by name.  Where the
TPU kernel's VJP saves only q, k and v and recomputes everything, the
forward here also saves each row's softmax statistics (max m and sum l of
exp(s − m), an f32 (2, B·H, N) tensor) when autograd will need them, and
the backward reads them instead of recomputing them: the same values, since
both kernels form them by the same online update over the same key chunks.
The public layout stays ``(…, N, H, hd)``; the kernels read it through
strides (the JAX wrapper's transpose to (B, H, N, hd) existed only for
Mosaic's block rules).

The multi-device mesh context (vmem_attention.py:57-138) waits for ROADMAP
A13.
"""

from __future__ import annotations

import ctypes
import math

import torch

from irw_tpu_torch import cuda_lib
from irw_tpu_torch.ops.library import kernel_op


def _scores(q, k, scale: float):
    return torch.einsum("...qhd,...khd->...hqk", q.float(), k.float()) * scale


def _row_stats(s):
    """Row max m, exp(s − m) and its row sum l of the f32 scores."""
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return m, e, e.sum(dim=-1, keepdim=True)


def _pack_stats(m, l):
    """(…, H, N, 1) row max and sum → the kernels' f32 (2, B·H, N) layout."""
    n = m.shape[-2]
    return torch.stack([m.reshape(-1, n), l.reshape(-1, n)])


def attention_plain(q, k, v, scale: float | None = None, *, with_stats: bool = False):
    """The TPU kernel's math in plain PyTorch: f32 scores times scale, f32
    softmax with max subtraction, the NORMALISED probabilities cast to the
    input dtype, P·V accumulated in f32 and cast to the output dtype.  With
    ``with_stats`` also the row statistics (2, B·H, N) that the backward
    takes."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, scale)
    m, e, l = _row_stats(s)
    p = (e / l).to(q.dtype)
    o = torch.einsum("...hqk,...khd->...qhd", p.float(), v.float()).to(q.dtype)
    return (o, _pack_stats(m, l)) if with_stats else o


def attention_plain_bwd(q, k, v, g, scale: float | None = None, stats=None):
    """dq, dk, dv of ``attention_plain`` with the TPU backward kernel's math
    and rounding points (``_bwd_kernel``): P in f32, dv = bf16(P)ᵀ·g,
    dp = g·vᵀ, t = rowsum(dp ∘ P) with the f32 P, ds = (P ∘ (dp − t)·scale)
    rounded to the input dtype, dq = ds·k and dk = dsᵀ·q, every product
    accumulated in f32 and each result cast to the input dtype.  P is
    exp(s − m)/l from the saved row statistics ``stats`` (2, B·H, N) when
    given, else recomputed."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s = _scores(q, k, scale)
    if stats is None:
        _, e, l = _row_stats(s)
        p = e / l
    else:
        m, l = (x.reshape(*s.shape[:-1], 1) for x in stats)
        p = torch.exp(s - m) / l
    dv = torch.einsum("...hqk,...qhd->...khd", p.to(q.dtype).float(), gf)
    dp = torch.einsum("...qhd,...khd->...hqk", gf, vf)
    t = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - t) * scale).to(q.dtype).float()
    dq = torch.einsum("...hqk,...khd->...qhd", ds, kf)
    dk = torch.einsum("...hqk,...qhd->...khd", ds, qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


_FWD_SIGNATURES = {
    "irw_attention_fwd": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float]
        + [ctypes.c_longlong] * 12 + [ctypes.c_void_p],
        ctypes.c_int),
    "irw_attention_fwd_variant": ([ctypes.c_int] * 3, ctypes.c_int),
}
_BWD_SIGNATURES = {
    "irw_attention_bwd": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.c_float] + [ctypes.c_longlong] * 21 + [ctypes.c_void_p],
        ctypes.c_int),
    "irw_attention_bwd_variant": ([ctypes.c_int] * 3, ctypes.c_int),
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_SURFACE = ("float32 or bfloat16 tensors of one (..., N, H, hd) shape on one CUDA device, "
            f"head_dim in {_HEAD_DIMS}")


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it through its strides: head_dim
    contiguous and, for bf16 (16-byte loads), every row start 16-byte
    aligned.  Otherwise a contiguous copy."""
    ok = t.stride(-1) == 1
    if ok and t.dtype == torch.bfloat16:
        ok = t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
    return t if ok else t.contiguous()


def _check_inputs(what: str, *ts) -> bool:
    """Validate q, k, v (and g) for ``what``; True when they lie on the CPU
    (the plain version's case), False for the CUDA kernel's, and raise for
    anything the kernel does not take."""
    q = ts[0]
    if any(t.shape != q.shape for t in ts) or q.dim() < 3:
        raise ValueError(f"{what} takes tensors of one (..., N, H, hd) shape, "
                         f"got {[tuple(t.shape) for t in ts]}")
    if any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{what}: mixed dtypes {[t.dtype for t in ts]}")
    if all(t.device.type == "cpu" for t in ts):
        return True
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{what}: no kernel for devices {[str(t.device) for t in ts]}; "
                         f"the kernel takes {_SURFACE}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: no kernel for {q.dtype}; the kernel takes {_SURFACE}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{what}: no kernel for head_dim {q.shape[-1]}; the kernel takes "
                         f"{_SURFACE}")
    return False


def _fwd_cpu(q, k, v, scale: float, with_stats: bool):
    """The op's CPU implementation: ``attention_plain``."""
    if with_stats:
        o, stats = attention_plain(q, k, v, scale, with_stats=True)
    else:
        o, stats = attention_plain(q, k, v, scale), q.new_empty((0,), dtype=torch.float32)
    return o.contiguous(), stats


def _fwd_cuda(q, k, v, scale: float, with_stats: bool):
    """The op's CUDA implementation: kernel K2 (statistics (0,) without
    ``with_stats``)."""
    _check_inputs("fused_attention", q, k, v)
    *lead, n, h, hd = q.shape
    b = math.prod(lead)
    # flatten the batch dims without copying when the layout allows it
    q3, k3, v3 = (_kernel_layout(t.reshape(b, n, h, hd)) for t in (q, k, v))
    out = torch.empty((b, n, h, hd), dtype=q.dtype, device=q.device)
    stats = torch.empty((2, b * h, n) if with_stats else (0,), dtype=torch.float32,
                        device=q.device)
    if out.numel() == 0:
        return out.reshape(q.shape), stats
    lib = cuda_lib.load("attention_fwd", _FWD_SIGNATURES)
    strides = [s for t in (q3, k3, v3, out) for s in t.stride()[:3]]
    status = lib.irw_attention_fwd(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
        stats.data_ptr() if with_stats else None,
        _DTYPE_CODES[q.dtype], b, n, h, hd, float(scale), *strides,
        cuda_lib.stream_of(q3))
    cuda_lib.check(status, "fused_attention", lib)
    fused_attention.launches += 1
    return out.reshape(q.shape), stats


def _fwd_fake(q, k, v, scale: float, with_stats: bool):
    *lead, n, h, _ = q.shape
    b = math.prod(lead)
    return q.new_empty(q.shape), q.new_empty((2, b * h, n) if with_stats else (0,),
                                             dtype=torch.float32)


_FWD_OP = kernel_op("attention_fwd",
                    "(Tensor q, Tensor k, Tensor v, float scale, bool with_stats) "
                    "-> (Tensor, Tensor)", _fwd_cpu, _fwd_cuda, _fwd_fake)


def _forward(q, k, v, scale: float, with_stats: bool = False):
    """The forward without autograd, the op ``irw_tpu_torch::attention_fwd``:
    ``attention_plain`` on the CPU, K2 on the card.  Returns (out, the row
    statistics (2, B·H, N) with ``with_stats``, else None)."""
    _check_inputs("fused_attention", q, k, v)
    out, stats = _FWD_OP(q, k, v, float(scale), bool(with_stats))
    return out, (stats if with_stats else None)


def fused_attention_bwd(q, k, v, g, scale: float | None = None, stats=None):
    """(dq, dk, dv) of ``fused_attention`` for the output gradient ``g``.

    ``stats``: the forward's row statistics (2, B·H, N) f32, or None to
    compute them here.  CPU tensors: ``attention_plain_bwd``.  CUDA tensors:
    kernel K3 (f32 or bf16, hd ∈ {32, 64, 128}), counted in
    ``fused_attention_bwd.launches``; it raises for anything else.
    """
    cpu = _check_inputs("fused_attention_bwd", q, k, v, g)
    *lead, n, h, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    b = math.prod(lead)
    if stats is not None and (stats.shape != (2, b * h, n) or stats.dtype != torch.float32
                              or stats.device != q.device):
        raise ValueError(f"fused_attention_bwd: stats must be float32 (2, {b * h}, {n}) on "
                         f"{q.device}, got {stats.dtype} {tuple(stats.shape)} on {stats.device}")
    if cpu:
        return attention_plain_bwd(q, k, v, g, scale, stats)
    # g comes from autograd and may be strided or expanded: copied if the
    # kernel cannot read it in place
    q3, k3, v3, g3 = (_kernel_layout(t.reshape(b, n, h, hd)) for t in (q, k, v, g))
    grads = [torch.empty((b, n, h, hd), dtype=q.dtype, device=q.device) for _ in range(3)]
    if q3.numel() == 0:
        return tuple(t.reshape(q.shape) for t in grads)
    have = stats is not None
    ml = stats.contiguous() if have else torch.empty((2, b * h, n), dtype=torch.float32,
                                                     device=q.device)
    tw = torch.empty((b * h, n), dtype=torch.float32, device=q.device)  # the tiled path's t
    lib = cuda_lib.load("attention_bwd", _BWD_SIGNATURES)
    tensors = (q3, k3, v3, g3, *grads)
    strides = [s for t in tensors for s in t.stride()[:3]]
    status = lib.irw_attention_bwd(
        *(t.data_ptr() for t in tensors), ml.data_ptr(), int(have), tw.data_ptr(),
        _DTYPE_CODES[q.dtype], b, n, h, hd, float(scale), *strides,
        cuda_lib.stream_of(q3))
    cuda_lib.check(status, "fused_attention_bwd", lib)
    fused_attention_bwd.launches += 1
    return tuple(t.reshape(q.shape) for t in grads)


fused_attention_bwd.launches = 0


def kernel_variants(n: int, hd: int, dtype=torch.bfloat16) -> dict:
    """Which kernel K2 and K3 run for sequence length ``n``, head dim ``hd``
    and ``dtype`` on the card: ``{"fwd": "plane" | "tiled", "bwd": …}``.
    The plane paths hold a whole (batch, head) plane in shared memory
    (csrc/attention_fwd.cu, attention_bwd.cu); builds the libraries."""
    code = _DTYPE_CODES[dtype]
    names = ("tiled", "plane")
    fwd = cuda_lib.load("attention_fwd", _FWD_SIGNATURES).irw_attention_fwd_variant(code, n, hd)
    bwd = cuda_lib.load("attention_bwd", _BWD_SIGNATURES).irw_attention_bwd_variant(code, n, hd)
    return {"fwd": names[fwd], "bwd": names[bwd]}


class _Attention(torch.autograd.Function):
    """The custom VJP of ``_core``.  The kernel route (``plain`` False)
    saves q, k, v and, with ``with_stats``, the forward's row statistics,
    which the backward reads; ``plain`` picks ``attention_plain`` and
    ``attention_plain_bwd`` on any device, saving q, k, v only, as the TPU
    kernel's VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, scale, plain, with_stats):
        ctx.scale, ctx.plain = scale, plain
        if plain:
            ctx.save_for_backward(q, k, v)
            return attention_plain(q, k, v, scale)
        out, stats = _forward(q, k, v, scale, with_stats)
        ctx.save_for_backward(q, k, v, *(() if stats is None else (stats,)))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, *stats = ctx.saved_tensors  # one unpack: checkpoint allows no second
        if ctx.plain:
            return (*attention_plain_bwd(q, k, v, g, ctx.scale), None, None, None)
        grads = fused_attention_bwd(q, k, v, g, ctx.scale, stats[0] if stats else None)
        return (*grads, None, None, None)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def fused_attention(q, k, v, *, scale: float | None = None):
    """softmax(q·kᵀ·scale)·v per head; q, k, v ``(…, N, H, hd)`` of one shape.

    ``scale`` defaults to 1/√hd.  CPU tensors: ``attention_plain`` forward,
    ``attention_plain_bwd`` backward.  CUDA tensors: kernels K2 forward and
    K3 backward (f32 or bf16, hd ∈ {32, 64, 128}), counted in
    ``fused_attention.launches`` and ``fused_attention_bwd.launches``.
    When a gradient will be taken, the forward also writes the row
    statistics and the backward reads them (no inference-mode cost).
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _needs_grad(q, k, v):  # no autograd node: what an exported program traces
        return _forward(q, k, v, float(scale))[0]
    return _Attention.apply(q, k, v, float(scale), False, True)


fused_attention.launches = 0


def attention_plain_autograd(q, k, v, *, scale: float | None = None):
    """``fused_attention`` with the plain versions on every device: the
    forward is ``attention_plain``, the backward ``attention_plain_bwd``.
    What the kernel route is held against on the card."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Attention.apply(q, k, v, float(scale), True, False)


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
