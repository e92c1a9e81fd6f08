"""Flash attention over 128-key blocks, forward and backward: the attention
core of a ViT block with ``use_flash`` on.

Port of ``irw_tpu/models/vit.py``'s ``_flash_mha`` (:268-296) attention
core and of JAX's library kernel it calls,
``jax/experimental/pallas/ops/tpu/flash_attention.py``: the forward
``_flash_attention_kernel_single_batch`` (:342-481, several key blocks)
and ``…_single_step`` (:484-557, one block), the custom VJP (:234-318) with its
two backward kernels ``_flash_attention_dkv_kernel`` (:796-938) and
``_flash_attention_dq_kernel`` (:1146-1284).  The scale is ``_flash_mha``'s
``sm_scale``, 1/√hd.  ``_flash_mha`` pads the sequence to a multiple of 128
and masks the padding with segment ids; here the padding is implicit: keys
at or past N (read as zeros) get ``MASK_VALUE`` added to their scores, as
the library does across segments, and rows past N are never stored.

``flash_attention`` is a ``torch.autograd.Function`` when a gradient will be
taken (its forward the custom op ``irw_tpu_torch::flash_attention_fwd``,
``ops.library``): for CUDA tensors its forward launches kernel K6-fwd
(``csrc/flash_attention_fwd.cu``) and its backward K6-bwd
(``csrc/flash_attention_bwd.cu``); it raises rather than fall back.  For
CPU tensors they run ``flash_attention_plain`` and
``flash_attention_plain_bwd``.  Like the library's VJP, the forward saves
q, k, v, o and the row statistics l and m; the backward kernels form
``di = rowsum(o · do)`` (:273-275) themselves from o.  The public layout is
``(…, N, H, hd)``: the kernels read q, k and v through their strides, so
the three views of a fused ``(…, N, 3, H, hd)`` projection need no copy.
``flash_kernel_variants`` says which kernels run on the card for a shape:
bf16 planes that fit in shared memory take the plane paths (one thread
block per (batch, head) plane), the rest the tiled paths.
"""

from __future__ import annotations

import ctypes
import math

import torch

from irw_tpu_torch import cuda_lib
from irw_tpu_torch.ops.library import kernel_op

BLOCK = 128   # keys per block (and the padding multiple), as the library's defaults
# the library's DEFAULT_MASK_VALUE, -0.7 · float32 max (flash_attention.py:32)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _scale(hd: int) -> float:
    """``_flash_mha``'s sm_scale; the kernels compute it alike (1 / sqrt in
    double, then float32)."""
    return 1.0 / math.sqrt(hd)


def _to_bhnd(t, np_: int):
    """(B, N, H, hd) → (B, H, Np, hd) f32, zero-padded to Np rows."""
    t = t.transpose(1, 2).float()
    return torch.nn.functional.pad(t, (0, 0, 0, np_ - t.shape[2]))


def _key_mask(n: int, np_: int, device) -> torch.Tensor:
    """(Np,) f32 added to every row's scores: 0 for keys below n,
    ``MASK_VALUE`` for the padding."""
    return torch.where(torch.arange(np_, device=device) < n, 0.0,
                       torch.tensor(MASK_VALUE, dtype=torch.float32, device=device))


def _flatten(t):
    *lead, n, h, hd = t.shape
    return t.reshape(math.prod(lead), n, h, hd), lead


def flash_attention_plain(q, k, v, *, save_residuals: bool = False):
    """The library's forward kernel step by step in plain PyTorch.

    q, k, v ``(…, N, H, hd)`` of one shape and dtype.  Keys in blocks of 128
    (the sequence zero-padded to a multiple of 128); per block s = f32(q·kᵀ)
    then × 1/√hd, ``MASK_VALUE`` added at the padded keys, the running max
    m, alpha = exp(m_prev − m_next), l_next = rowsum(p) + alpha·l_prev and
    acc = acc·(l_corr·(1/l_next)) + f32(p rounded to the input dtype · v)·
    (1/l_next); the output cast once.  A single block (N ≤ 128) takes the
    library's one-step kernel: p = exp(s − m) / l, then the product.

    Returns o ``(…, N, H, hd)``, and with ``save_residuals`` also l and m
    ``(…, H, N)`` f32, the final row sum and max.
    """
    (q3, lead), k3, v3 = _flatten(q), _flatten(k)[0], _flatten(v)[0]
    b, n, h, hd = q3.shape
    scale = _scale(hd)
    np_ = -(-n // BLOCK) * BLOCK
    qf, kf, vf = (_to_bhnd(t, np_) for t in (q3, k3, v3))
    mask = _key_mask(n, np_, q.device)
    rnd = q.dtype  # p is rounded to v's dtype before the product

    def scores(kb):
        s = torch.matmul(qf, kf[:, :, kb].transpose(-1, -2)) * scale
        return s + mask[kb]

    if np_ == BLOCK:  # _flash_attention_kernel_single_batch_single_step
        s = scores(slice(0, BLOCK))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        p = p / l
        acc = torch.matmul(p.to(rnd).float(), vf)
    else:
        m = torch.full((b, h, np_, 1), -math.inf, device=q.device)
        l = torch.zeros((b, h, np_, 1), device=q.device)
        acc = torch.zeros((b, h, np_, hd), device=q.device)
        for start in range(0, np_, BLOCK):
            kb = slice(start, start + BLOCK)
            s = scores(kb)
            m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_next)
            l_corr = torch.exp(m - m_next) * l
            l_next = p.sum(dim=-1, keepdim=True) + l_corr
            inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
            acc = acc * (l_corr * inv)
            acc = acc + torch.matmul(p.to(rnd).float(), vf[:, :, kb]) * inv
            m, l = m_next, l_next
    o = acc[:, :, :n].transpose(1, 2).to(q.dtype).reshape(q.shape)
    if not save_residuals:
        return o
    l, m = (t[:, :, :n, 0].reshape(*lead, h, n) for t in (l, m))
    return o, l, m


def flash_attention_plain_bwd(q, k, v, o, do, l, m):
    """(dq, dk, dv) with the library's backward math, in plain PyTorch:
    di = rowsum(f32 o · f32 do); per (query block, key block) p = exp(s − m)
    · (1/l) with s as in the forward, dv += p rounded to do's dtype ᵀ·do,
    ds = (do·vᵀ − di)·p·scale, dk += ds rounded ᵀ·q and dq += ds rounded ·k,
    each accumulated in f32 over the 128-blocks in the kernels' order (dk,
    dv over query blocks, dq over key blocks) and cast once."""
    (q3, _), k3, v3, o3, do3 = _flatten(q), *(_flatten(t)[0] for t in (k, v, o, do))
    b, n, h, hd = q3.shape
    scale = _scale(hd)
    np_ = -(-n // BLOCK) * BLOCK
    qf, kf, vf, dof = (_to_bhnd(t, np_) for t in (q3, k3, v3, do3))
    di = (o3.float() * do3.float()).sum(dim=-1).transpose(1, 2)           # (B, H, N)
    pad = (0, np_ - n)
    di = torch.nn.functional.pad(di, pad)[..., None]
    # padded rows have do = 0, so their p never reaches a gradient: any finite l
    m = torch.nn.functional.pad(m.reshape(b, h, n), pad)[..., None]
    inv_l = 1.0 / torch.nn.functional.pad(l.reshape(b, h, n), pad, value=1.0)[..., None]
    mask = _key_mask(n, np_, q.device)
    rnd = do.dtype

    def grads_of(qb, kb):
        s = torch.matmul(qf[:, :, qb], kf[:, :, kb].transpose(-1, -2)) * scale
        s = s + mask[kb]
        p = torch.exp(s - m[:, :, qb]) * inv_l[:, :, qb]
        dp = torch.matmul(dof[:, :, qb], vf[:, :, kb].transpose(-1, -2))
        ds = (dp - di[:, :, qb]) * p * scale
        return p.to(rnd).float(), ds.to(rnd).float()

    blocks = [slice(i, i + BLOCK) for i in range(0, np_, BLOCK)]
    dq, dk, dv = (torch.zeros((b, h, np_, hd), device=q.device) for _ in range(3))
    for kb in blocks:      # _flash_attention_dkv_kernel: the query blocks in order
        for qb in blocks:
            p, ds = grads_of(qb, kb)
            dv[:, :, kb] += torch.matmul(p.transpose(-1, -2), dof[:, :, qb])
            dk[:, :, kb] += torch.matmul(ds.transpose(-1, -2), qf[:, :, qb])
    for qb in blocks:      # _flash_attention_dq_kernel: the key blocks in order
        for kb in blocks:
            _, ds = grads_of(qb, kb)
            dq[:, :, qb] += torch.matmul(ds, kf[:, :, kb])
    return tuple(t[:, :, :n].transpose(1, 2).to(q.dtype).reshape(q.shape) for t in (dq, dk, dv))


_FWD_SIGNATURES = {
    "irw_flash_attention_fwd": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12 + [ctypes.c_void_p],
        ctypes.c_int),
    "irw_flash_attention_fwd_variant": ([ctypes.c_int] * 3, ctypes.c_int),
}
_BWD_SIGNATURES = {
    "irw_flash_attention_bwd": (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 24
        + [ctypes.c_void_p],
        ctypes.c_int),
    "irw_flash_attention_bwd_variant": ([ctypes.c_int] * 3, ctypes.c_int),
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


def _check_inputs(what: str, *ts) -> bool:
    """Validate q, k, v (and o, do) for ``what``; True when they lie on the
    CPU (the plain version's case), False for the CUDA kernel's, and raise
    for anything the kernel does not take."""
    q = ts[0]
    if any(t.shape != q.shape for t in ts) or q.dim() < 3:
        raise ValueError(f"{what} takes tensors of one (..., N, H, hd) shape, "
                         f"got {[tuple(t.shape) for t in ts]}")
    if any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{what}: mixed dtypes {[t.dtype for t in ts]}")
    if all(t.device.type == "cpu" for t in ts):
        return True
    surface = ("float32 or bfloat16 tensors of one (..., N, H, hd) shape on one CUDA device, "
               f"head_dim in {_HEAD_DIMS}")
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{what}: no kernel for devices {[str(t.device) for t in ts]}; the "
                         f"kernel takes {surface}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: no kernel for {q.dtype}; the kernel takes {surface}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{what}: no kernel for head_dim {q.shape[-1]}; the kernel takes "
                         f"{surface}")
    return False


def _fwd_cpu(q, k, v, save_residuals: bool):
    """The op's CPU implementation: ``flash_attention_plain``, its l and m
    stacked as (2, …, H, N) (shape (0,) without ``save_residuals``)."""
    if not save_residuals:
        o = flash_attention_plain(q, k, v)
        return o.contiguous(), q.new_empty((0,), dtype=torch.float32)
    o, l, m = flash_attention_plain(q, k, v, save_residuals=True)
    return o.contiguous(), torch.stack([l, m])


def _fwd_cuda(q, k, v, save_residuals: bool):
    """The op's CUDA implementation: kernel K6-fwd."""
    _check_inputs("flash_attention", q, k, v)
    *lead, n, h, hd = q.shape
    b = math.prod(lead)
    q3, k3, v3 = (_kernel_layout(t.reshape(b, n, h, hd)) for t in (q, k, v))
    out = torch.empty((b, n, h, hd), dtype=q.dtype, device=q.device)
    stats = torch.empty((2, b, h, n) if save_residuals else (0,), dtype=torch.float32,
                        device=q.device)
    lib = cuda_lib.load("flash_attention_fwd", _FWD_SIGNATURES)
    strides = [s for t in (q3, k3, v3, out) for s in t.stride()[:3]]
    l_ptr = stats[0].data_ptr() if save_residuals else None
    m_ptr = stats[1].data_ptr() if save_residuals else None
    with cuda_lib.on_device(q3):
        status = lib.irw_flash_attention_fwd(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), l_ptr, m_ptr,
            _DTYPE_CODES[q.dtype], b, n, h, hd, *strides, cuda_lib.stream_of(q3))
    cuda_lib.check(status, "flash_attention", lib)
    flash_attention_fwd.launches += 1
    return out.reshape(q.shape), stats.reshape((2, *lead, h, n) if save_residuals else (0,))


def _fwd_fake(q, k, v, save_residuals: bool):
    *lead, n, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((2, *lead, h, n) if save_residuals else (0,),
                                             dtype=torch.float32)


_FWD_OP = kernel_op("flash_attention_fwd",
                    "(Tensor q, Tensor k, Tensor v, bool save_residuals) -> (Tensor, Tensor)",
                    _fwd_cpu, _fwd_cuda, _fwd_fake)


def flash_attention_fwd(q, k, v, *, save_residuals: bool = False):
    """The forward without autograd, the op ``irw_tpu_torch::flash_attention_fwd``:
    ``flash_attention_plain`` on the CPU, K6-fwd on the card (counted in
    ``flash_attention_fwd.launches``).  Returns o, or (o, l, m) with
    ``save_residuals``."""
    _check_inputs("flash_attention", q, k, v)
    o, stats = _FWD_OP(q, k, v, bool(save_residuals))
    if not save_residuals:
        return o
    return o, stats[0], stats[1]


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, o, do, l, m):
    """(dq, dk, dv) of ``flash_attention`` for the output gradient ``do``,
    from the forward's o, l and m.

    CPU tensors: ``flash_attention_plain_bwd``.  CUDA tensors: kernel
    K6-bwd, di = rowsum(o · do) included (f32 or bf16, hd ∈ {32, 64, 128};
    one kernel on the plane path, two on the tiled path, no atomics),
    counted once per call in ``flash_attention_bwd.launches``; it raises
    for anything else."""
    if _check_inputs("flash_attention_bwd", q, k, v, o, do):
        return flash_attention_plain_bwd(q, k, v, o, do, l, m)
    *lead, n, h, hd = q.shape
    b = math.prod(lead)
    if l.device != q.device or m.device != q.device:
        raise ValueError("flash_attention_bwd: l and m must lie on q's device")
    lm = [t.reshape(b, h, n).float().contiguous() for t in (l, m)]
    q3, k3, v3, o3, do3 = (_kernel_layout(t.reshape(b, n, h, hd)) for t in (q, k, v, o, do))
    grads = [torch.empty((b, n, h, hd), dtype=q.dtype, device=q.device) for _ in range(3)]
    di = torch.empty((b, h, n), dtype=torch.float32, device=q.device)  # the tiled path's
    lib = cuda_lib.load("flash_attention_bwd", _BWD_SIGNATURES)
    tensors = (q3, k3, v3, o3, do3, *grads)
    strides = [s for t in tensors for s in t.stride()[:3]]
    with cuda_lib.on_device(q3):
        status = lib.irw_flash_attention_bwd(
            *(t.data_ptr() for t in tensors), lm[0].data_ptr(), lm[1].data_ptr(), di.data_ptr(),
            _DTYPE_CODES[q.dtype], b, n, h, hd, *strides, cuda_lib.stream_of(q3))
    cuda_lib.check(status, "flash_attention_bwd", lib)
    flash_attention_bwd.launches += 1
    return tuple(t.reshape(q.shape) for t in grads)


flash_attention_bwd.launches = 0


def flash_kernel_variants(n: int, hd: int, dtype=torch.bfloat16) -> dict:
    """Which kernel K6-fwd and K6-bwd run for sequence length ``n``, head
    dim ``hd`` and ``dtype`` on the card: ``{"fwd": "plane" | "tiled",
    "bwd": …}``.  The plane paths hold a whole (batch, head) plane in shared
    memory (bf16: the forward while K and V fit, N ≤ 860 at hd 64, the
    backward at hd ≤ 64 and N ≤ 272); builds the libraries."""
    code = _DTYPE_CODES[dtype]
    names = ("tiled", "plane")
    fwd = cuda_lib.load("flash_attention_fwd", _FWD_SIGNATURES)
    bwd = cuda_lib.load("flash_attention_bwd", _BWD_SIGNATURES)
    return {"fwd": names[fwd.irw_flash_attention_fwd_variant(code, n, hd)],
            "bwd": names[bwd.irw_flash_attention_bwd_variant(code, n, hd)]}


class _FlashAttention(torch.autograd.Function):
    """The library's custom VJP (flash_attention.py:234-318): the forward
    keeps o, l and m when a gradient is needed and saves q, k, v, o, l, m;
    the backward runs K6-bwd from them.  ``plain`` picks the plain versions
    on any device in place of the kernel wrappers."""

    @staticmethod
    def forward(ctx, q, k, v, plain):
        ctx.plain = plain
        save = any(ctx.needs_input_grad[:3])
        fwd = flash_attention_plain if plain else flash_attention_fwd
        res = fwd(q, k, v, save_residuals=save)
        if not save:
            return res
        o, l, m = res
        ctx.save_for_backward(q, k, v, o, l, m)
        return o

    @staticmethod
    def backward(ctx, do):
        bwd = flash_attention_plain_bwd if ctx.plain else flash_attention_bwd
        # unpacked once: torch.utils.checkpoint (block remat) refuses a second unpack
        q, k, v, o, l, m = ctx.saved_tensors
        return (*bwd(q, k, v, o, do, l, m), None)


def flash_attention(q, k, v):
    """softmax(q·kᵀ/√hd)·v per head, by 128-key blocks; q, k, v
    ``(…, N, H, hd)`` of one shape (they may be strided views of one fused
    projection).

    CPU tensors: the plain versions.  CUDA tensors: kernels K6-fwd and
    K6-bwd (f32 or bf16, hd ∈ {32, 64, 128}), counted in
    ``flash_attention_fwd.launches`` and ``flash_attention_bwd.launches``.
    """
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return flash_attention_fwd(q, k, v)   # no autograd node: what an exported program traces
    return _FlashAttention.apply(q, k, v, False)


def flash_attention_plain_autograd(q, k, v):
    """``flash_attention`` with the plain versions on every device: what the
    kernel route is held against on the card."""
    return _FlashAttention.apply(q, k, v, True)
