#!/usr/bin/env python3
"""Time variants of kernel K5's bf16 plane path on one CUDA card.

    python3 tools/k5_variants.py STAGES=2 PATCH=pv64 PATCH=probe_noload

Each argument names one variant of ``irw_tpu_torch/csrc/qkv_attention.cu``
by what it changes: ``STAGES`` (``kStages``, the stages of the TMA ring) or
``PATCH``, one of the named source edits in ``PATCHES`` (a ``probe_`` edit
breaks the result on purpose, to see what a part of the kernel costs: it is
timed, not checked); several join with commas.  A variant whose shared
memory exceeds a block's takes K5's tiled path, as the committed kernel
would.  The committed source is always timed too, as ``committed``.

Every variant is built from a copy of the sources (one nvcc each, in
parallel, into ``build/k5_variants/``), checked against
``qkv_attention_plain`` at the K5 limit of ``chip_smoke.py`` (2^-6 of
max(1, max|o|)), and timed with CUDA events at x (B, 257, D) bf16 with 6
heads of 64: B = 192 and 256 at D = 384, and B = 192 at D = 64 and 768 (the
attention half does not depend on D, so the three D split a variant's time
into its projection and the rest).  Variants run in turns, three rounds of
20 calls after 3 warm-ups each; the median of the rounds is printed.  One
JSON line per variant (with the plane kernels' registers and spills from
ptxas), then the card's name and power limit.  Needs the card; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import cu_variants  # noqa: E402

CONSTANTS = {"STAGES": "kStages"}
# named edits of the source a variant may also take (PATCH=name): the text
# replaced, then its replacement
PATCHES = {
    # pass 2 over 64-key chunks
    "pv64": [("    for_key_chunks<32>(n, [&](auto cols, int k0) {",
              "    for_key_chunks<64>(n, [&](auto cols, int k0) {")],
    # probes (wrong results, timed but not checked): the projection without
    # its copies after the first stages (and without waiting for them), and
    # without its products
    "probe_noload": [("            if (threadIdx.x == 0 && s + kStages - 1 < steps) "
                      "load(s + kStages - 1);\n"
                      "            mbar_wait(bars + 8 * (s % kStages), (s / kStages) & 1);",
                      "            if (s < kStages - 1) "
                      "mbar_wait(bars + 8 * (s % kStages), (s / kStages) & 1);")],
    "probe_noproject": [("            plane_project<HD>(acc, sX, sX + rows * kXC, row0);\n", "")],
}
SHAPES = [(192, 257, 384), (256, 257, 384), (192, 257, 64), (192, 257, 768)]
HEADS, HD = 6, 64


def _inputs(b, n, d, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, n, d, generator=gen, device="cuda")
    ws = [torch.randn(d, HEADS * HD, generator=gen, device="cuda") / math.sqrt(d)
          for _ in range(3)]
    bs = [torch.randn(HEADS * HD, generator=gen, device="cuda") * 0.01 for _ in range(3)]
    return [t.to(torch.bfloat16) for t in (x, *ws, *bs)]


def main(argv=None) -> int:
    import torch

    from irw_tpu_torch import cuda_lib
    from irw_tpu_torch.ops.qkv_attention import _SIGNATURES, qkv_attention_plain

    if not torch.cuda.is_available():
        print("k5_variants: needs a CUDA card", file=sys.stderr)
        return 1
    specs = [""] + list(argv if argv is not None else sys.argv[1:])
    t0 = time.perf_counter()
    built = cu_variants.build("qkv_attention.cu", specs, CONSTANTS, PATCHES, entries="plane")
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    calls = {tag: cu_variants.load(path, _SIGNATURES) for tag, (path, _) in built.items()}

    cases = {shape: _inputs(*shape, seed=i) for i, shape in enumerate(SHAPES)}
    outs = {shape: torch.empty(shape[0], shape[1], HEADS * HD, dtype=torch.bfloat16,
                               device="cuda") for shape in SHAPES}

    def launcher(lib, shape):
        b, n, d = shape
        args = [t.data_ptr() for t in cases[shape]]
        out = outs[shape]
        stream = cuda_lib.stream_of(out)

        def call():
            status = lib.irw_qkv_attention(*args, out.data_ptr(), 1, b, n, d, HEADS, HD,
                                           1.0 / math.sqrt(HD), stream)
            cuda_lib.check(status, "k5 variant", lib)
        return call

    errors = {}
    with torch.no_grad():
        for shape in SHAPES:
            ref = qkv_attention_plain(*cases[shape], heads=HEADS).float()
            tol = 2 ** -6 * max(1.0, ref.abs().max().item())
            for tag, lib in calls.items():
                launcher(lib, shape)()
                torch.cuda.synchronize()
                err = (outs[shape].float() - ref).abs().max().item()
                errors[tag] = max(errors.get(tag, 0.0), err)
                if not err <= tol and "probe_" not in tag:
                    raise AssertionError(f"variant {tag} at {shape}: {err} > {tol}")

    times = cu_variants.time_in_turns(list(calls), SHAPES,
                                      lambda tag, shape: launcher(calls[tag], shape))
    for tag in calls:
        ms = {"x".join(map(str, shape)): times[tag][shape] for shape in SHAPES}
        t64, t384, t768 = (ms[f"192x257x{d}"] for d in (64, 384, 768))
        per_col = (t768 - t64) / (768 - 64)   # ms per column of D at B = 192
        print(json.dumps({"variant": tag, "ms": ms, "max_abs_err": errors[tag],
                          "projection_ms_at_384": per_col * 384,
                          "rest_ms_at_384": t384 - per_col * 384,
                          "ptxas": built[tag][1]}), flush=True)
    print(cu_variants.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
