"""Inference A/B on the FROZEN flagship: the stock attention against the
fused attention kernel (``vmem_attn``: K2) and the kernel plus the LayerNorm
whose backward recomputes its statistics (``ln_fused``).

Port of ``benchmarks/infer_vmem_ab.py``: the factory turns ``vmem_attn`` on
only for unfrozen backbones, so serving runs without the kernel unless it is
asked for.  The three variants share one set of weights (seed 0) and serve
uint8 batches through ``DeviceTransform`` (Haar SWT: K1) and the model.

    python -m irw_tpu_torch.benchmarks.infer_vmem_ab [48 64 96]

One JSON line per variant and batch: ``variant``, ``batch``, ``ips``, ``ms``,
``mfu`` (against the card's dense bf16 peak; null where the card is unknown
or the run is on the CPU), ``peak`` (the card's name).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from irw_tpu_torch.device import resolve_device
from irw_tpu_torch.models import get_model
from irw_tpu_torch.transforms import DeviceTransform
from irw_tpu_torch.utils.flops import device_peak_flops, flagship_forward_flops

VARIANTS = (("stock", {}),
            ("vmem", {"vmem_attn": True}),
            ("vmem+ln", {"vmem_attn": True, "ln_fused": True}))


def build_pipeline(device, backbone: str = "dinov2_vits14", nbits: int = 64,
                   embed_dim: int = 384, num_heads: int = 8, dtype: str = "bfloat16",
                   vit_kwargs: dict | None = None, **vit_flags):
    """The frozen flagship of ``bench.py:36-59`` and its device transform;
    returns (model, pipeline) with ``pipeline(uint8 images) → ±1 codes``."""
    model = get_model(
        "multidino_attention_hashing_ortho", device=device, seed=0, backbone=backbone,
        nbits=nbits, frozen_backbone=True,
        vit_kwargs={"dtype": dtype, **(vit_kwargs or {}), **vit_flags},
        fusion_config={"type": "cross_attention_advanced", "output_dim": embed_dim,
                       "num_queries": 4, "num_heads": num_heads, "ortho_weight": 0.01})
    transform = DeviceTransform([("SWTTransform", {"level": 1, "wavelet": "haar"})], device=device)

    def pipeline(images_u8):
        with torch.inference_mode():
            return model(transform(images_u8))[0]

    return model, pipeline


def time_pipeline(pipeline, batch, iters: int, device: torch.device) -> float:
    """Seconds per call: one warm-up, then ``iters`` calls ended by a
    synchronize (the host clock around device work, as ``bench.py:81-95``)."""
    pipeline(batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = pipeline(batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    del out
    return (time.perf_counter() - t0) / iters


def run(batches=(48, 64, 96), iters: int = 10, device=None, seed: int = 0, image_size: int = 224,
        **pipeline_kwargs) -> list[dict]:
    """The sweep; ``pipeline_kwargs`` go to ``build_pipeline`` (a test passes
    a tiny backbone).  The same weights and the same batches for all three
    variants."""
    device = resolve_device(device)
    peak, peak_label = device_peak_flops(device)
    rng = np.random.RandomState(seed)
    images = {b: rng.randint(0, 255, (b, image_size, image_size, 3), dtype=np.uint8)
              for b in batches}
    results, weights = [], None
    for label, flags in VARIANTS:
        model, pipeline = build_pipeline(device, **pipeline_kwargs, **flags)
        if weights is None:  # identical parameter tree across the variants
            weights = model.state_dict()
        model.load_state_dict(weights)
        vit = model.backbone.vit
        fwd = flagship_forward_flops(image_size, vit.patch_embed.patch_size, vit.embed_dim,
                                     len(vit.blocks), vit.cls_token.shape[0])
        for b in batches:
            dt = time_pipeline(pipeline, images[b], iters, device)
            ips = b / dt
            results.append({"variant": label, "batch": b, "ips": round(ips, 1),
                            "ms": round(dt * 1000, 2),
                            "mfu": None if peak is None else round(fwd * ips / peak, 4),
                            "peak": peak_label})
    return results


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    for res in run(batches=tuple(int(b) for b in (argv or [48, 64, 96]))):
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
