"""Int8 post-training quantization for the serving path (port of
``irw_tpu/ops/quant.py:42-155``).

- Weights: symmetric per-output-channel int8, quantized on the fly from the
  unchanged float parameters at every call, so checkpoints and converted
  weights apply as they are.  ``compress_params_int8`` stores the quant-path
  weights as int8 plus scales instead (an exported artifact bakes those),
  and a ``quant_int8`` model on ``decompress_params_int8``'s reconstruction
  reproduces the float weights' outputs to 1 ulp: the scale amax/127 is a
  fixed point of requantization, up to the (127·s)/127 round trip.
- Activations: dynamic symmetric per-token (last-axis) int8.
- Accumulation: exact int32 (``int8_dot``), then the dequant multiply by the
  two scales in the compute dtype.

The attention core, LayerNorms, GELU and residuals stay in the float compute
dtype.  Weak typing, as jnp computes it: ``amax / 127`` is taken in x's dtype
(bf16 on the flagship) before the scale is cast to f32; ``x / scale``
promotes x to f32; ``round`` is half to even; the dequant is
``acc.to(out) * (xs * ws).to(out)``, in that order.

The int32 product runs outside any kernel of the JAX package too (XLA's
``dot_general`` with ``preferred_element_type=int32``): on the card it is
``torch._int_mm`` (cuBLASLt's int8 GEMM; ``int8_matmul`` pads its operands
with zeros, which add nothing), on the CPU an int32 ``torch.mm``.  Both give
the exact integers.

Layouts are the JAX package's at the public functions: a kernel is (K, N),
(in, out); the port's ``Linear`` weight (out, in) is passed transposed.  A
kernel may carry a leading band axis, (S, K, N) with x (S, …, K): each band
is quantized and multiplied on its own, as the vmapped JAX module does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

_INT8_MAX = 127.0


def quantize_symmetric(x: torch.Tensor, reduce_axes, dtype: torch.dtype = torch.float32):
    """Symmetric int8 quantization along ``reduce_axes``: ``(q, scale)``
    with q in [-127, 127] int8 and ``scale`` (x's shape, ``reduce_axes`` of
    size 1, in ``dtype``) such that ``q * scale ≈ x``."""
    dims = tuple(int(a) for a in reduce_axes)
    amax = x.abs().amax(dim=dims, keepdim=True)
    # amax / 127 in x's dtype (a weakly typed constant), zero-guarded
    ratio = amax / torch.full((), _INT8_MAX, dtype=amax.dtype, device=amax.device)
    scale = torch.where(amax > 0, ratio, torch.ones_like(ratio)).to(dtype)
    q = torch.clamp(torch.round(x.to(torch.promote_types(x.dtype, dtype)) / scale),
                    -_INT8_MAX, _INT8_MAX).to(torch.int8)
    return q, scale


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 · (K, N) int8 → (M, N) int32, exact: ``torch._int_mm``
    on the card, an int32 ``torch.mm`` on the CPU.  On the card the rows are
    padded with zeros to a multiple of 8 plus 16 (``_int_mm`` takes more
    than 16; a pad that does not depend on M keeps an exported batch
    symbolic), the depth and the width to multiples of 8, and b is laid out
    column-major."""
    m, n = a.shape[0], b.shape[1]
    if a.device.type != "cuda":
        return torch.mm(a.to(torch.int32), b.to(torch.int32))
    k = a.shape[1]
    a = F.pad(a, (0, (-k) % 8, 0, (-m) % 8 + 16))
    b = F.pad(b, (0, (-n) % 8, 0, (-k) % 8))
    return torch._int_mm(a.contiguous(), b.t().contiguous().t())[:m, :n]


def int8_dot(x: torch.Tensor, kernel: torch.Tensor, out_dtype: torch.dtype | None = None):
    """``x @ kernel`` with dynamic int8 quantization: x (…, K) per token,
    ``kernel`` (K, N) per output channel (over K), int32 accumulation.
    Returns (…, N) in ``out_dtype`` (default x's).  With a band axis:
    ``kernel`` (S, K, N) and x (S, …, K)."""
    out_dtype = out_dtype or x.dtype
    xq, xs = quantize_symmetric(x, (-1,))
    wq, ws = quantize_symmetric(kernel, (-2,))
    k, n = kernel.shape[-2:]
    if kernel.dim() == 2:
        acc = int8_matmul(xq.reshape(-1, k), wq).reshape(*x.shape[:-1], n)
    else:
        acc = torch.stack([int8_matmul(xq[s].reshape(-1, k), wq[s]).reshape(*x.shape[1:-1], n)
                           for s in range(kernel.shape[0])])
        ws = ws.reshape(ws.shape[0], *(1,) * (x.dim() - 2), n)
    return acc.to(out_dtype) * (xs * ws).to(out_dtype)


class QuantizedLeaf(NamedTuple):
    """An int8-compressed weight: ``q * s`` reconstructs the float leaf."""

    q: torch.Tensor   # int8, the weight's shape
    s: torch.Tensor   # f32 scale, the reduced axis kept as size 1


def _quant_leaf_axes(path: str):
    """Whether the leaf at flax ``path`` (``bridge.jax_param_paths``) is on
    the ``quant_int8`` matmul path: a ``kernel`` of a ViT block's
    ``query``/``key``/``value``/``out`` or of its Mlp's ``Dense_*``
    (quant.py:103-127).  In the port's (…, out, in) layout every such
    kernel reduces its last axis, the groups of the JAX kernels' d, (h, hd)
    and K axes; leading band axes stay."""
    names = path.split("/")
    if not any(n.startswith("Block_") or n == "blocks" for n in names):
        return None  # only the ViT tower runs the quant path
    if names[-1] != "kernel":
        return None
    if names[-2] in ("query", "key", "value", "out") or names[-2].startswith("Dense_"):
        return (-1,)
    return None


def compress_params_int8(model, state: dict | None = None) -> dict:
    """``model``'s parameters (or ``state``, a state dict of it) with each
    quant-path weight replaced by a ``QuantizedLeaf`` (int8 and its
    per-channel f32 scale); the leaves are chosen by their flax path through
    ``bridge.jax_param_paths``.  The rest, buffers included, as they are."""
    from irw_tpu_torch.bridge import jax_param_paths

    paths = jax_param_paths(model)
    state = dict(model.state_dict() if state is None else state)
    out = {}
    for name, leaf in state.items():
        axes = _quant_leaf_axes(paths[name]) if name in paths else None
        if axes is None or leaf.dim() < 2:
            out[name] = leaf
        else:
            out[name] = QuantizedLeaf(*quantize_symmetric(leaf.detach().float(), axes))
    return out


def decompress_params_int8(tree: dict, dtype: torch.dtype = torch.float32) -> dict:
    """The float weights of a ``compress_params_int8`` dict: ``q * s`` in
    ``dtype`` for each ``QuantizedLeaf``, the rest as they are."""
    return {name: (leaf.q.to(dtype) * leaf.s.to(dtype)
                   if isinstance(leaf, QuantizedLeaf) else leaf)
            for name, leaf in tree.items()}


def quant_dense_apply(x, kernel, bias=None, out_dtype: torch.dtype | None = None):
    """A Dense on the int8 path: ``int8_dot(x, kernel) + bias`` (bias cast
    to the output's dtype); ``kernel`` (K, N), or (S, K, N) per band."""
    out = int8_dot(x, kernel, out_dtype=out_dtype)
    if bias is not None:
        if bias.dim() == 2:  # per band: (S, N) against (S, …, N)
            bias = bias.reshape(bias.shape[0], *(1,) * (out.dim() - 2), bias.shape[1])
        out = out + bias.to(out.dtype)
    return out
