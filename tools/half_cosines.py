#!/usr/bin/env python3
"""How far a half-precision CNN trunk strays from its float32 run, on the CPU.

    python3 tools/half_cosines.py [NAME ...]

Builds each registry model (all of ``MODELS`` when no NAME is given) at full
width from seed 0 three times, in float32, bfloat16 and float16 (the same
weights: they are drawn before the dtype matters), runs the same inputs
through each in eval mode, and prints, per half dtype, the smallest cosine
between a row of its L2-normalised output and the float32 run's, and one
minus it.  Inputs: 4 uint8 224² images from a seeded generator, through
``cub_dwt``'s device stage (Normalize, the level-1 haar lifting DWT) for the
band models, Normalize alone for the single trunks, and the images in
[0, 1) for ``wresnet_ce`` (its DWT is inside the model).  ``chip_smoke.py``'s
``HALF_COSINE`` bounds are ten times these.  Two intra-op threads; the
ResNet-50 families take about 1.5 min each.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from irw_tpu_torch.models import get_model  # noqa: E402
from irw_tpu_torch.transforms import DeviceTransform  # noqa: E402

CUB_DWT = [("Normalize", {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}),
           ("CustomTransform", {"decompose_levels": 1, "basis": "haar", "coarse_only": True,
                                "ll_only": False})]
# registry name → (keyword arguments, input: "bands", "images" or "raw")
MODELS = {
    "wcnn_attention_ce": ({"num_classes": 64}, "bands"),
    "wresnet_ce": ({"num_classes": 200}, "raw"),
    "mtwavenet50": ({}, "bands"),
    "hybrid_mtwavenet_v2_ce": ({"num_classes": 200}, "bands"),
    "resnet_ce": ({"num_classes": 200}, "images"),
    "convnext": ({}, "images"),
    "densenet121": ({}, "images"),
}


def main(names) -> None:
    torch.set_num_threads(2)
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (4, 224, 224, 3), generator=gen, dtype=torch.uint8)
    inputs = {"bands": DeviceTransform(CUB_DWT, device="cpu")(images),
              "images": DeviceTransform(CUB_DWT[:1], device="cpu")(images),
              "raw": torch.rand(2, 224, 224, 3, generator=gen)}
    for name in names:
        kwargs, kind = MODELS[name]
        t0 = time.perf_counter()
        outs = {}
        for dtype in ("float32", "bfloat16", "float16"):
            model = get_model(name, device="cpu", seed=0, dtype=dtype, **kwargs)
            with torch.no_grad():
                out = model(inputs[kind])
            out = out[0] if isinstance(out, tuple) else out
            outs[dtype] = torch.nn.functional.normalize(out.float(), dim=-1)
            del model
        for dtype in ("bfloat16", "float16"):
            cos = float((outs[dtype] * outs["float32"]).sum(-1).min())
            print(f"{name} {dtype}: min cosine to float32 {cos:.7f}, 1 - cosine {1 - cos:.3e} "
                  f"({time.perf_counter() - t0:.0f} s, CPU)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(MODELS))
