#!/usr/bin/env python3
"""Smoke test of irw_tpu_torch on one CUDA card (built for an H100, sm_90a).

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases build,swt,attention

Drives the port's serving path — uint8 images → DeviceTransform (/255, Haar
SWT: kernel K1) → the flagship MultiDinoHashing (4 × DINOv2 ViT-S/14 at
224², bf16, cross_attention_advanced fusion, 64 bits; 12 attention blocks,
kernel K2 each) → ±1 codes → Hamming retrieval metrics — and prints one
line per phase:

1. card: name and power limit (nvidia-smi);
2. build: both kernels from ``irw_tpu_torch/csrc``, one nvcc each, in parallel;
3. swt: K1 against ``haar_swt2_plain`` at (192, 224, 224) f32, timed;
4. attention: K2 against ``attention_plain`` at (256, 257, 6, 64) bf16 and
   at ragged, f32 and other head-dim shapes, timed beside SDPA;
5. serve: full-width flagship with seeded random weights (LayerScale set to
   1 so attention reaches the codes), launch counts per batch, codes held
   against the same model on the plain versions, img/s;
6. profile: one served batch under torch.profiler, device time by kernel
   group and the device's idle share;
7. retrieval: ``evaluate`` on a few hundred images, GPU metrics against the
   CPU port, and bench.py's VOC anchor (map 0.3865 at k = 5717).

Then a JSON line of per-kernel numbers, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the exit code
is non-zero and the last line is not printed.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

PHASES = ("card", "build", "swt", "attention", "serve", "profile", "retrieval")

# configs/model/multidino_attention_hashing_ortho.yaml (name + kwargs); the card
# has no PyYAML, and tests/test_torch_multi_dino.py holds this dict to the file
FLAGSHIP = {
    "name": "MultiDinoHashing",
    "kwargs": {
        "backbones_config": [{"name": "dinov2_vits14", "frozen": False}] * 4,
        "binary_config": {"nbits": 64},
        "use_bn": True,
        "fusion_config": {"use_all_tokens": False, "type": "cross_attention_advanced",
                          "output_dim": 384, "num_heads": 8, "dropout": 0.1,
                          "num_queries": 4, "sub_band_dropout_p": 0, "ortho_weight": 0.01},
        "with_autocast": True,
    },
}
# configs/transform/voc_swt.yaml's test split, device ops (Resize/CenterCrop
# are host geometry; the synthetic images are made at 224 already)
SWT_OPS = [("SWTTransform", {"level": 1, "wavelet": "haar"})]

BATCH = 64
SERVE_BATCHES = 6      # timed on the host clock: more batches, less noise
K1_SHAPE = (3 * BATCH, 224, 224)
K2_SHAPE = (4 * BATCH, 257, 6, 64)
K1_TOL = 1e-5
# both sides round the same normalised P and output to bf16: at most one bf16
# ulp apart for |o| < 2, well under BENCH_r05's 0.0117 parity bar
K2_TOL = {"bfloat16": 2 ** -7, "float32": 1e-5}
LOGIT_MARGIN = 0.05     # codes must agree wherever |logit| exceeds this
VOC_ANCHOR_MAP = 0.3865

# the card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_card(state):
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    state["card"] = smi[0]
    print(smi[0], flush=True)  # name, power limit: as nvidia-smi gives them
    log("card", f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} | "
                f"torch {torch.__version__}, CUDA {torch.version.cuda}")


def phase_build(state):
    from irw_tpu_torch import cuda_lib

    t0 = time.perf_counter()
    report = cuda_lib.build(cuda_lib.KERNELS)
    wall = time.perf_counter() - t0
    for name, rep in report.items():
        usage = [ln.strip() for ln in rep["ptxas"].splitlines() if "Used" in ln]
        log("build", f"{name}: {rep['seconds']:.1f} s; " + " | ".join(usage))
    log("build", f"{len(report)} kernels built in {wall:.1f} s wall (parallel nvcc)")


def phase_swt(state):
    import torch

    from irw_tpu_torch.ops.wavelets import haar_swt2, haar_swt2_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(K1_SHAPE, generator=gen, device="cuda")
    out = haar_swt2(x)
    ref = haar_swt2_plain(x)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    log("swt", f"K1 haar_swt2 {K1_SHAPE} f32: max|kernel - plain| = {err:.3e} (limit {K1_TOL})")
    if not err <= K1_TOL:
        raise AssertionError(f"K1 disagrees with its plain version: {err}")
    # yardstick: one conv with circular padding computes the same bands
    # (shifted by one row and column); TF32 off so it is the same f32 math
    torch.backends.cudnn.allow_tf32 = False
    s = math.sqrt(2.0) / 2.0
    w = torch.tensor([[[[1, 1], [1, 1]]], [[[1, 1], [-1, -1]]],
                      [[[1, -1], [1, -1]]], [[[1, -1], [-1, 1]]]],
                     dtype=torch.float32, device="cuda") * (s * s)
    conv = torch.nn.Conv2d(1, 4, 2, padding=1, padding_mode="circular", bias=False).cuda()
    conv.weight.data.copy_(w)
    with torch.no_grad():
        lib_out = conv(x[:, None])[:, :, 1:, 1:]
    lib_err = (lib_out - ref).abs().max().item()
    log("swt", f"library conv2d(circular) vs plain: {lib_err:.3e}")
    x4 = x[:, None]
    ms = time_ms(lambda: haar_swt2(x))
    plain_ms = time_ms(lambda: haar_swt2_plain(x))
    with torch.no_grad():
        lib_ms = time_ms(lambda: conv(x4))
    n, h, w_ = K1_SHAPE
    nbytes = 4 * n * h * w_ * (1 + 4)
    flops = 16 * n * h * w_
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    log("swt", f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | conv2d {lib_ms:.4f} ms | "
               f"bound {b_ms:.4f} ms ({b_by}) | {state['card']}")
    state["kernels"]["haar_swt2"] = {
        "name": "haar_swt2", "route": "cuda", "source": "irw_tpu_torch/csrc/haar_swt2.cu",
        "replaces": "irw_tpu/ops/wavelets/pallas_dwt.py:285", "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms}


def _attention_case(shape, dtype, seed):
    import torch

    from irw_tpu_torch.ops.attention import attention_plain, fused_attention

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    with torch.no_grad():
        out = fused_attention(q, k, v)
        ref = attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = K2_TOL[str(dtype).removeprefix("torch.")]
    log("attention", f"K2 {tuple(shape)} {dtype}: max|kernel - plain| = {err:.3e} "
                     f"(limit {tol:.3e}, max|o| {ref.float().abs().max().item():.3f})")
    if not err <= tol:
        raise AssertionError(f"K2 disagrees with its plain version at {shape} {dtype}: {err}")
    return (q, k, v), err


def phase_attention(state):
    import torch
    import torch.nn.functional as F

    from irw_tpu_torch.ops.attention import attention_plain, fused_attention

    for shape, dtype in [((3, 50, 2, 64), torch.bfloat16), ((3, 50, 2, 64), torch.float32),
                         ((2, 70, 3, 32), torch.float32), ((2, 130, 1, 128), torch.bfloat16),
                         ((64, 257, 6, 64), torch.float32)]:
        _attention_case(shape, dtype, seed=2)
    (q, k, v), err = _attention_case(K2_SHAPE, torch.bfloat16, seed=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # SDPA's (B, H, N, hd)
    with torch.no_grad():
        ms = time_ms(lambda: fused_attention(q, k, v))
        plain_ms = time_ms(lambda: attention_plain(q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    b, n, h, hd = K2_SHAPE
    nbytes = 4 * b * n * h * hd * 2
    flops = 4 * b * h * n * n * hd
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    log("attention", f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | SDPA {lib_ms:.4f} ms | "
                     f"bound {b_ms:.4f} ms ({b_by}) | {state['card']}")
    state["kernels"]["fused_attention"] = {
        "name": "fused_attention", "route": "cuda",
        "source": "irw_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "irw_tpu/ops/vmem_attention.py:207", "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms}


def _flagship_model():
    import torch

    from irw_tpu_torch.models import get_model

    model = get_model(FLAGSHIP["name"], seed=0, **FLAGSHIP["kwargs"])
    with torch.no_grad():  # LayerScale 1: at the 1e-5 init attention barely reaches the codes
        for blk in model.backbone.vit.blocks:
            blk.ls1.fill_(1.0)
            blk.ls2.fill_(1.0)
    return model


def phase_serve(state):
    import torch

    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.ops.attention import attention_plain, fused_attention
    from irw_tpu_torch.ops.wavelets import haar_swt2, haar_swt2_plain
    from irw_tpu_torch.transforms import DeviceTransform

    model = _flagship_model()
    vit = model.backbone.vit
    assert vit.dtype == torch.bfloat16 and vit.embed_dim == 384 and len(vit.blocks) == 12
    assert all(blk.attn.core.__name__ == "vmem_attention_fn" for blk in vit.blocks)
    state["model"] = model
    transform = DeviceTransform(SWT_OPS)
    ds = SyntheticVOCDataset(num_train=BATCH * (SERVE_BATCHES + 1), image_size=224, seed=0)
    batches = [ds.images[i * BATCH:(i + 1) * BATCH] for i in range(SERVE_BATCHES + 1)]

    with torch.inference_mode():
        model(transform(batches[0]))  # warm-up: cuBLAS handles, allocator
        torch.cuda.synchronize()
        haar_swt2.launches = fused_attention.launches = 0
        outs, per_batch = [], []
        t0 = time.perf_counter()
        for images in batches[1:]:
            before = (haar_swt2.launches, fused_attention.launches)
            bands = transform(images)
            logits, aux = model.forward_logits(bands)
            outs.append((images, logits, torch.sign(logits)))
            per_batch.append((haar_swt2.launches - before[0],
                              fused_attention.launches - before[1]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {"haar_swt2": haar_swt2.launches, "fused_attention": fused_attention.launches}
        state["launches"] = counts
        log("serve", f"launches over {SERVE_BATCHES} batches: {counts}; per batch "
                     f"(K1, K2): {per_batch}")
        if per_batch != [(1, 12)] * SERVE_BATCHES:
            raise AssertionError(f"expected K1 = 1 and K2 = 12 launches per batch, got {per_batch}")
        ips = SERVE_BATCHES * BATCH / seconds
        log("serve", f"{ips:.1f} img/s (batch {BATCH}, SWT + 4 x ViT-S/14 + fusion + hash, "
                     f"bf16) | {state['card']}")

        # the same weights on the plain versions, on the card
        cores = [blk.attn.core for blk in vit.blocks]
        for blk in vit.blocks:
            blk.attn.core = attention_plain
        try:
            for i, (images, logits, codes) in enumerate(outs):
                x = torch.from_numpy(images).cuda().float() / 255.0
                b, h, w, c = x.shape
                flat = haar_swt2_plain(x.permute(0, 3, 1, 2).reshape(b * c, h, w))
                bands_ref = flat.reshape(b, c, 4, h, w).permute(0, 2, 3, 4, 1)
                ref, _ = model.forward_logits(bands_ref)
                if not (torch.isfinite(logits).all() and logits.shape == (BATCH, 64)):
                    raise AssertionError(f"batch {i}: logits not finite / wrong shape")
                sure = ref.abs() > LOGIT_MARGIN
                n_sure = int(sure.sum())
                n_differ = int(((codes != torch.sign(ref)) & sure).sum())
                dmax = (logits - ref).abs().max().item()
                log("serve", f"batch {i}: max|logit - plain| = {dmax:.3e}; codes differ at "
                             f"{n_differ} of the {n_sure}/{sure.numel()} bits with "
                             f"|logit| > {LOGIT_MARGIN}")
                if n_differ or 2 * n_sure < sure.numel():
                    raise AssertionError(f"batch {i}: codes disagree with the plain path")
        finally:
            for blk, core in zip(vit.blocks, cores):
                blk.attn.core = core


_KERNEL_GROUPS = (("K2 attention", ("attention_fwd",)), ("K1 swt", ("haar_swt2",)),
                  ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet")),
                  ("reduce", ("reduce",)), ("elementwise", ("elementwise", "vectorized")))


def phase_profile(state):
    """Device time of one served batch by kernel, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.transforms import DeviceTransform

    model = state["model"] if "model" in state else _flagship_model()
    transform = DeviceTransform(SWT_OPS)
    images = SyntheticVOCDataset(num_train=BATCH, image_size=224, seed=2).images
    with torch.inference_mode():
        model(transform(images))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(transform(images))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:  # a measurement, not a check: say so rather than guess
        log("profile", "the profiler recorded no device kernel: device time not measured")
        return
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    groups = {g: 0.0 for g, _ in _KERNEL_GROUPS}
    groups["other"] = 0.0
    for name, us in by_name.items():
        low = name.lower()
        group = next((g for g, keys in _KERNEL_GROUPS if any(k in low for k in keys)), "other")
        groups[group] += us
    log("profile", f"one batch of {BATCH}: wall {wall_us / 1e3:.2f} ms, device busy "
                   f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f} | {state['card']}")
    log("profile", "by group: " + ", ".join(f"{g} {us / 1e3:.2f} ms ({us / busy:.1%})"
                                            for g, us in groups.items()))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log("profile", f"{us / 1e3:8.3f} ms  {name[:110]}")


def phase_retrieval(state):
    import torch

    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.engine import compute_embeddings, evaluate
    from irw_tpu_torch.ops.metrics import compute_retrieval_metrics
    from irw_tpu_torch.transforms import DeviceTransform

    model = state["model"] if "model" in state else _flagship_model()
    transform = DeviceTransform(SWT_OPS)
    ds = SyntheticVOCDataset(num_train=320, image_size=224, seed=1)
    t0 = time.perf_counter()
    res = evaluate(model, ds, transform, batch_size=BATCH, distance_metric="hamming")
    log("retrieval", f"evaluate on {len(ds)} images: {time.perf_counter() - t0:.2f} s; "
                     f"map {res['map_level0']:.4f}, recall@1 {res['recall_at_1_level0']:.4f}, "
                     f"bit_balance {res['bit_balance_level0']:.4f}")
    if not all(math.isfinite(v) for v in res.values()) or not 0.0 <= res["map_level0"] <= 1.0:
        raise AssertionError(f"evaluate gave non-finite or out-of-range metrics: {res}")
    emb, labels = compute_embeddings(model, ds, transform, BATCH)
    if emb.shape != (len(ds), 64) or not torch.isin(emb, torch.tensor([-1.0, 1.0], device=emb.device)).all():
        raise AssertionError("embeddings are not ±1 codes of shape (N, 64)")
    # the same ranking and metrics from the CPU port (tie order, masking)
    cpu = compute_retrieval_metrics(emb.cpu(), torch.from_numpy(labels), emb.cpu(),
                                    torch.from_numpy(labels), metric="hamming",
                                    same_source=True, with_hashing_stats=True)
    gpu = {k.removesuffix("_level0"): v for k, v in res.items()}
    worst = max(abs(cpu[k] - gpu[k]) for k in cpu)
    log("retrieval", f"GPU vs CPU metrics: max diff {worst:.2e}")
    if worst > 1e-5:
        raise AssertionError(f"GPU and CPU metrics disagree by {worst}")

    # bench.py:121-122, 276-289: the VOC-sized anchor (RandomState(0) draws)
    rng = np.random.RandomState(0)
    rng.randint(0, 255, (BATCH, 224, 224, 3), dtype=np.uint8)
    n = 5717
    codes = torch.from_numpy(np.sign(rng.randn(n, 64)).astype(np.float32)).cuda()
    vlabels = torch.from_numpy((rng.rand(n, 20) > 0.85).astype(np.float32)).cuda()

    def run():
        return compute_retrieval_metrics(codes, vlabels, codes, vlabels, metric="hamming",
                                         k=n, same_source=True, with_hashing_stats=True)

    t0 = time.perf_counter()
    run()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    voc = run()
    steady = time.perf_counter() - t0
    log("retrieval", f"VOC anchor: map {voc['map']:.6f} (round 4: {round(voc['map'], 4)}, "
                     f"expected {VOC_ANCHOR_MAP}), k {voc['num_k']}; {first:.3f} s first, "
                     f"{steady:.3f} s steady | {state['card']}")
    if round(voc["map"], 4) != VOC_ANCHOR_MAP:
        raise AssertionError(f"VOC anchor map {voc['map']} != {VOC_ANCHOR_MAP}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {','.join(PHASES)}")
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card",
              file=sys.stderr)
        return 2
    try:
        import irw_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})", file=sys.stderr)
        return 2

    state = {"kernels": {}, "card": None}
    phase_card(state)
    runners = {"build": phase_build, "swt": phase_swt, "attention": phase_attention,
               "serve": phase_serve, "profile": phase_profile, "retrieval": phase_retrieval}
    for name in phases:
        if name != "card":
            t0 = time.perf_counter()
            runners[name](state)
            log(name, f"phase done in {time.perf_counter() - t0:.1f} s")

    launches = state.get("launches", {})
    kernels = [dict(k, launches=launches.get(k["name"])) for k in state["kernels"].values()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
