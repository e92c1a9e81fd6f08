"""Micro-benchmark of the attention segment: the q/k/v projections fused
INTO the attention kernel (kernel K5, x → context in one launch, Q/K/V never
in device memory) against the production segment (three projections, then
the fused attention kernel K2) and the stock segment (projections, einsum
scores, f32 softmax, einsum).

Port of ``benchmarks/vmem_qkv_micro.py``: same inputs (numpy
``RandomState(seed)``, weights / √d, biases · 0.01, bf16), same result keys
without ``block_b`` (a TPU grid parameter).

    python -m irw_tpu_torch.benchmarks.vmem_qkv_micro [--b 192 --n 257 --heads 6 --d 384]

One JSON line out.  Forward only: K5 has no backward.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from irw_tpu_torch.benchmarks import device_label, max_abs_diff, timed_ms
from irw_tpu_torch.device import resolve_device
from irw_tpu_torch.ops.attention import fused_attention
from irw_tpu_torch.ops.qkv_attention import fused_qkv_attention


def ref_segment(x, wq, wk, wv, bq, bk, bv, *, heads: int, vmem: bool = True):
    """The production segment (vmem_qkv_micro.py:92-106): three projections
    in x's dtype, then ``fused_attention`` (``vmem=True``: kernel K2 on the
    card) or the stock einsum attention: q divided by √hd ROUNDED to x's
    dtype, scores in x's dtype, softmax in f32 cast back, P·V in x's dtype."""
    b, n, _ = x.shape
    hd = wq.shape[-1] // heads
    q, k, v = (F.linear(x, w.t(), bias).reshape(b, n, heads, hd)
               for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
    if vmem:
        o = fused_attention(q, k, v)
    else:
        # a tensor on q's device: PyTorch's CUDA division by a host scalar
        # multiplies by the reciprocal
        root = torch.full((), math.sqrt(hd), dtype=q.dtype, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q / root, k)
        p = torch.softmax(s.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o.reshape(b, n, heads * hd)


def make_inputs(b: int, n: int, d: int, seed: int = 0, device="cpu",
                dtype: torch.dtype = torch.bfloat16):
    """x (b, n, d), wq/wk/wv (d, d) / √d, bq/bk/bv (d,) · 0.01 from numpy's
    ``RandomState(seed)``, in the JAX script's draw order."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(b, n, d)]
    arrays += [rng.randn(d, d) / np.sqrt(d) for _ in range(3)]
    arrays += [rng.randn(d) * 0.01 for _ in range(3)]
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)
                 for a in arrays)


def run(b: int = 192, n: int = 257, heads: int = 6, d: int = 384, iters: int = 50,
        device=None, seed: int = 0) -> dict:
    device = resolve_device(device)
    args = make_inputs(b, n, d, seed, device)
    with torch.no_grad():
        fused = lambda: fused_qkv_attention(*args, heads=heads)  # noqa: E731
        prod = lambda: ref_segment(*args, heads=heads, vmem=True)  # noqa: E731
        stock = lambda: ref_segment(*args, heads=heads, vmem=False)  # noqa: E731
        diff = max_abs_diff(fused(), prod())
        return {
            "shape": [b, n, heads, d // heads],
            "fwd_maxdiff_vs_prod": diff,
            "fusedqkv_fwd_ms": timed_ms(fused, iters, device),
            "prod_fwd_ms": timed_ms(prod, iters, device),
            "stock_fwd_ms": timed_ms(stock, iters, device),
            "device": device_label(device),
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--b", type=int, default=192)
    ap.add_argument("--n", type=int, default=257)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--d", type=int, default=384)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain versions")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.b, a.n, a.heads, a.d, a.iters, a.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
