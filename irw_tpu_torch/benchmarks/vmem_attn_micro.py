"""Micro-benchmark of the fused attention kernels (K2 forward, K3 backward)
against the stock einsum attention, at the flagship's training shape
(bands · B = 192, N = 257, H = 6, hd = 64, bf16).

Port of ``benchmarks/vmem_attn_micro.py``: same inputs (numpy
``RandomState(seed)``: q, k, v, then the cotangent), same result keys without
``bb_fwd``/``bb_bwd`` (TPU grid parameters).

    python -m irw_tpu_torch.benchmarks.vmem_attn_micro [--b 192 --n 257 --h 6 --hd 64]

One JSON line out.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from irw_tpu_torch.benchmarks import device_label, max_abs_diff, timed_ms
from irw_tpu_torch.device import resolve_device
from irw_tpu_torch.ops.attention import fused_attention


def ref_attention(q, k, v):
    """The stock attention (vmem_attn_micro.py:27-31): q divided by √hd
    rounded to q's dtype, scores in q's dtype, softmax in f32 cast back."""
    root = torch.full((), math.sqrt(q.shape[-1]), dtype=q.dtype, device=q.device)
    s = torch.einsum("...qhd,...khd->...hqk", q / root, k)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("...hqk,...khd->...qhd", p, v)


def run(b: int = 192, n: int = 257, h: int = 6, hd: int = 64, iters: int = 50,
        device=None, seed: int = 0) -> dict:
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    shape = (b, n, h, hd)
    q, k, v, cot = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                    .to(device=device, dtype=torch.bfloat16) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def grads(fn):
        return torch.autograd.grad(fn(*leaves), leaves, cot)

    with torch.no_grad():
        diff = max_abs_diff(fused_attention(q, k, v), ref_attention(q, k, v))
    gdiff = max(max_abs_diff(a, r)
                for a, r in zip(grads(fused_attention), grads(ref_attention)))
    with torch.no_grad():
        fused_fwd = timed_ms(lambda: fused_attention(q, k, v), iters, device)
        ref_fwd = timed_ms(lambda: ref_attention(q, k, v), iters, device)
    return {
        "shape": list(shape),
        "fwd_maxdiff": diff,
        "grad_maxdiff": gdiff,
        "fused_fwd_ms": fused_fwd,
        "ref_fwd_ms": ref_fwd,
        "fused_fwdbwd_ms": timed_ms(lambda: grads(fused_attention), iters, device),
        "ref_fwdbwd_ms": timed_ms(lambda: grads(ref_attention), iters, device),
        "device": device_label(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--b", type=int, default=192)
    ap.add_argument("--n", type=int, default=257)
    ap.add_argument("--h", type=int, default=6)
    ap.add_argument("--hd", type=int, default=64)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain versions")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.b, a.n, a.h, a.hd, a.iters, a.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
