#!/usr/bin/env python3
"""Smoke test of irw_tpu_torch on one CUDA card (built for an H100, sm_90a).

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases card,build,attention,train
    python3 chip_smoke.py --phases card,build,dwt,wcnn
    python3 chip_smoke.py --phases card,build,flash,flash_serve,flash_train
    python3 chip_smoke.py --phases card,build,qkv,qkv_micro,variants

Drives the port's serving path — uint8 images → DeviceTransform (/255, Haar
SWT: kernel K1) → the flagship MultiDinoHashing (4 × DINOv2 ViT-S/14 at
224², bf16, cross_attention_advanced fusion, 64 bits; 12 attention blocks,
kernel K2 each) → ±1 codes → Hamming retrieval metrics — its training
path — the same model in training mode with block remat, HashLoss and
AdamW, attention backward on kernel K3 — and the DWT serving path — uint8
images → DeviceTransform (Normalize, CustomTransform haar level 1: kernel
K4) → RetrievalNet ``wcnn_attention_ce`` (4 × ResNet-50 at 112², CBAM
subband gate, f32) → L2-normalised embeddings → cosine retrieval metrics —
and the flagship with ``vit_kwargs={"use_flash": True}``, served and
trained with every block's attention on the flash kernels K6-fwd and K6-bwd
— and the attention-segment path — the micro-benchmarks that drive kernel K5
(q/k/v projections fused into the attention), K2 and K3, and the flagship
with the ViT Block variants ``fused_qkv``, ``split_cls`` and ``ln_fused`` —
and prints one line per phase:

1. card: name and power limit (nvidia-smi);
2. build: the kernels from ``irw_tpu_torch/csrc``, one nvcc each, in parallel;
3. swt: K1 against ``haar_swt2_plain`` at (192, 224, 224) f32, timed;
4. attention: K2 against ``attention_plain`` at (256, 257, 6, 64) bf16, K3
   against ``attention_plain_bwd`` at (384, 257, 6, 64) bf16, both also at
   ragged, f32 and other head-dim shapes; timed beside SDPA;
5. serve: full-width flagship with seeded random weights (LayerScale set to
   1 so attention reaches the codes), launch counts per batch, codes held
   against the same model on the plain versions, img/s;
6. profile: one served batch under torch.profiler, device time by kernel
   group and the device's idle share;
7. retrieval: ``evaluate`` on a few hundred images, GPU metrics against the
   CPU port, and bench.py's VOC anchor (map 0.3865 at k = 5717);
8. train: the full-width flagship trains at batch 96 (HashLoss,
   ``configs/optimizer/basic.yaml``'s AdamW at epoch 1): launch counts per
   step, trained img/s over the synchronised window of 5 steps (each
   step's time beside it), the path's own peak memory and finite metrics;
   one step on the kernel route held against the plain route (loss, and
   the gradient of each top-level module); one step profiled;
9. dwt: K4 against ``lifting_multi_level_plain`` for haar at levels 1-3 at
   the served shape (192, 224, 224), cdf97 at (192, 448, 448), bior48 and
   daub4 at level 2, and a ragged batch of non-square planes; timed beside
   the ``conv2d`` that computes haar level 1;
10. wcnn: the full-width WCNN-attention model serves batches of 64: launch
   counts per batch, embeddings held against the same model with K4's
   plain version, img/s, peak memory, one batch profiled; then ``evaluate``
   (cosine) on a CUB-test-sized synthetic set (5794 images, 100 classes);
11. flash: K6-fwd against ``flash_attention_plain`` at the served shape
   (256, 257, 6, 64) bf16 on the strided views of a fused projection, as
   the path gives them, at f32, head dims 32 and 128, N = 37 (one key
   block) and N = 384 (no masked key); K6-bwd against
   ``flash_attention_plain_bwd`` at the training shape (384, 257, 6, 64) in
   bf16 on the fused views with the kernel forward's o, l, m, as the path
   gives them, in f32 and at other shapes; both timed on the path's layout
   beside SDPA;
12. flash_serve: the full-width flagship with ``use_flash`` serves batches
   of 64 (launch counts, codes against the plain route, img/s), one batch
   profiled;
13. flash_train: the same model trains at batch 96 (launch counts per step,
   the kernel route against the plain route, trained img/s, peak memory),
   one step profiled;
14. qkv: K5 against ``qkv_attention_plain`` at the micro-benchmark's default
   (192, 257, 384) bf16 with 6 heads, at the flagship's served rows
   (256, 257, 384), in f32, at head dims 32 (a scale that is no power of
   two) and 128, at N = 37, at D = 96 (a ragged last chunk) and at D = 768
   with 12 heads; timed beside its plain version, the production segment
   (three ``F.linear`` + K2) and, as a two-call yardstick, one ``F.linear``
   onto (D, 3D) followed by SDPA;
15. qkv_micro: ``irw_tpu_torch.benchmarks.vmem_qkv_micro.run()`` and
   ``vmem_attn_micro.run()`` at their full default widths: their JSON, their
   maxdiffs against stated limits, and the launches of K5, K2 and K3;
16. variants: the full-width flagship served with ``fused_qkv``, with
   ``split_cls`` and with ``vmem_attn + ln_fused`` (codes against the default
   route, img/s, launch counts: never K5), ``infer_vmem_ab``'s sweep of the
   frozen flagship, and train steps at batch 96 with ``ln_fused`` on the
   K2/K3 route against the same steps without it.

Then a JSON line of per-kernel numbers, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the exit code
is non-zero and the last line is not printed.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np

PHASES = ("card", "build", "swt", "attention", "serve", "profile", "retrieval", "train", "dwt",
          "wcnn", "flash", "flash_serve", "flash_train", "qkv", "qkv_micro", "variants")

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
# configs/loss/hash_loss.yaml and configs/optimizer/basic.yaml; the protocol's
# experience settings (studies/voc_lambda_protocol.yaml over
# configs/experience/default.yaml)
HASH_LOSS = [{"name": "HashLoss", "weight": 1.0,
              "kwargs": {"num_classes": 20, "embedding_size": 64, "quant_weight": 0.1,
                         "scale": 15.0,
                         "optimizer": {"name": "AdamW",
                                       "kwargs": {"lr": 0.0001, "weight_decay": 0.0001}}}}]
OPTIMIZER = [{"name": "AdamW", "params": None,
              "kwargs": {"lr": 1.0e-05, "weight_decay": 0.0005},
              "scheduler_on_epoch": {"name": "CosineAnnealingLR",
                                     "kwargs": {"T_max": 50, "eta_min": 1.0e-07}},
              "scheduler_on_step": None, "scheduler_on_val": None}]
PROTOCOL = {"clip_grad": None, "warm_up": 0, "ortho_scale": None}
# configs/transform/voc_swt.yaml's test split, device ops (Resize/CenterCrop
# are host geometry; the synthetic images are made at 224 already)
SWT_OPS = [("SWTTransform", {"level": 1, "wavelet": "haar"})]
# configs/model/wcnn_attention_ce.yaml (name + kwargs) and
# configs/transform/cub_dwt.yaml's test split, device ops (Resize/CenterCrop
# are host geometry); tests/test_torch_wcnn_slice.py holds both to the files
WCNN = {
    "name": "RetrievalNet",
    "kwargs": {"backbone_name": "wcnn_attention_ce", "embed_dim": 512, "norm_features": False,
               "without_fc": False, "with_autocast": True, "attention": True,
               "decom_level": 1, "wave": "haar", "feature_size": 512, "attention_type": "cbam",
               "coarse_only": True, "num_classes": 64, "pretrained": False},
}
DWT_OPS = [("Normalize", {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}),
           ("CustomTransform", {"decompose_levels": 1, "basis": "haar", "coarse_only": True,
                                "ll_only": False})]

BATCH = 64
SERVE_BATCHES = 6      # timed on the host clock: more batches, less noise
K1_SHAPE = (3 * BATCH, 224, 224)
K2_SHAPE = (4 * BATCH, 257, 6, 64)
K1_TOL = 1e-5
# both sides round the same normalised P and output to bf16: at most one bf16
# ulp apart for |o| < 2, well under BENCH_r05's 0.0117 parity bar
K2_TOL = {"bfloat16": 2 ** -7, "float32": 1e-5}
TRAIN_BATCH = 96         # studies/voc_lambda_protocol.yaml
K3_SHAPE = (4 * TRAIN_BATCH, 257, 6, 64)
# K3: both sides round P and ds to bf16 at the same points; only the f32
# accumulation order differs, which can move a ds element by one bf16 ulp
K3_TOL_BF16 = 2 ** -6    # of max|ref|, per output
K3_TOL_F32 = 1e-5
TRAIN_STEPS = 5
TRAIN_METRICS = ("total_loss", "grad_norm", "batch_map", "loss_0_HashLoss", "ortho_raw")
# the same step with every block's attention on the plain versions: the two
# routes round P and ds alike, so the loss and the gradients differ only by
# f32 accumulation order carried through twelve bf16 blocks
ROUTE_LOSS_TOL = 1e-3
ROUTE_COSINE = 0.999
LOGIT_MARGIN = 0.05     # codes must agree wherever |logit| exceeds this
VOC_ANCHOR_MAP = 0.3865
# K4 and its plain version round every product, sum and quotient alike; the
# limits, of max(1, max|plain|), leave room for an FMA contraction
K4_TOL = {"haar": 1e-5, "other": 1e-4}
K4_SHAPE = K1_SHAPE       # (3 · 64) planes of 224²: one served batch
K4_CDF97_SHAPE = (3 * BATCH, 448, 448)   # configs/transform/cub_dwt_cdf97.yaml
WCNN_BATCHES = 6
WCNN_EMB_TOL = 1e-4      # K4 against its plain version, on the L2-normalised embeddings
CUB_TEST = 5794          # CUB-200-2011's test split (100 classes)
# K6: the flagship's attention with use_flash, served (4 bands x 64) and
# trained (4 bands x 96); the forward's outputs are averages of unit-normal
# rows (|o| < 2), so one bf16 ulp flip is at most 2^-7 absolute; the
# backward's limits are of max|plain| per output, as K3's
K6_SERVE_SHAPE = K2_SHAPE
K6_TRAIN_SHAPE = K3_SHAPE
K6_FWD_TOL = K2_TOL
FLASH = {"use_flash": True}
# K5: benchmarks/vmem_qkv_micro.py's defaults.  Kernel and plain version round
# q, k, v (after the f32 bias add), the normalised P and o alike; only the f32
# accumulation order differs.  K2 gets q, k, v already rounded and stays
# within one bf16 ulp of o (2^-7 for |o| < 2); here a one-ulp flip of a q, k
# or v element is also carried through the scores into every P of its row, so
# the bf16 limit is two ulps, of max(1, max|o|).  f32: the same math in
# another order, through two chained products
K5_SHAPE = (192, 257, 384)
K5_HEADS = 6
K5_TOL = {"bfloat16": 2 ** -6, "float32": 1e-5}
# the micro-benchmarks' parity bars.  K5 against the production segment:
# cuBLAS rounds q, k, v where K5 does, in another accumulation order, so K5's
# own limit.  K2 and K3 against the stock attention, which rounds the scores
# to bf16 before its softmax where the kernels keep them in f32: a few bf16
# ulps of the largest output (unit-normal q, k, v give max|o| in [1, 2): an
# ulp is 2^-7) and of the largest gradient ([2, 4): 2^-6).  The JAX package's
# own run of the same micro gave 0.0117 and 0.0156 (BENCH_r05.json), the port
# on an H100 0.0156 (two ulps) and 0.0234: the forward limit is three ulps,
# the gradient limit two
MICRO_FWD_TOL = 3 * 2 ** -7
MICRO_GRAD_TOL = 2 ** -5
VARIANT_BATCHES = 4      # timed served batches per Block variant
LN_TRAIN_STEPS = 3       # the first from identical weights: its loss is compared
LN_LOSS_TOL = 1e-3       # ln_fused against the plain LayerNorm, relative

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


def _kernel_name(mangled: str) -> str:
    """``name<HD>`` of a mangled kernel template instance: walk the nested
    name's length-prefixed parts to the one ending in ``kernel``, then read
    its int template argument."""
    pos = 3 if mangled.startswith("_ZN") else 2
    while (m := re.match(r"\d+", mangled[pos:])):
        start = pos + m.end()
        pos = start + int(m.group())
        ident = mangled[start:pos]
        if ident.endswith("kernel"):
            arg = re.match(r"ILi(\d+)E", mangled[pos:])
            return ident + (f"<{arg.group(1)}>" if arg else "")
    return mangled


def phase_build(state):
    from irw_tpu_torch import cuda_lib

    t0 = time.perf_counter()
    report = cuda_lib.build(cuda_lib.KERNELS)
    wall = time.perf_counter() - t0
    for name, rep in report.items():
        # ptxas names each entry function, then its registers and spills
        usage, entry = [], "?"
        for ln in rep["ptxas"].splitlines():
            if "Compiling entry function" in ln:
                entry = _kernel_name(ln.split("'")[1] if "'" in ln else ln.strip())
            elif "Used" in ln:
                usage.append(f"{entry}: {ln.split(':', 1)[-1].strip()}")
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
    tf32 = torch.backends.cudnn.allow_tf32
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
    torch.backends.cudnn.allow_tf32 = tf32
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


def _attention_bwd_case(shape, dtype, seed):
    """K3 against ``attention_plain_bwd`` on unit-normal q, k, v, g; the
    largest error over dq, dk, dv relative to each output's limit."""
    import torch

    from irw_tpu_torch.ops.attention import attention_plain_bwd, fused_attention_bwd

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    outs = fused_attention_bwd(q, k, v, g)
    refs = attention_plain_bwd(q, k, v, g)
    torch.cuda.synchronize()
    worst, report = 0.0, []
    for name, out, ref in zip(("dq", "dk", "dv"), outs, refs):
        err = (out.float() - ref.float()).abs().max().item()
        peak = ref.float().abs().max().item()
        tol = K3_TOL_F32 if dtype == torch.float32 else K3_TOL_BF16 * peak
        report.append(f"{name} {err:.3e} (limit {tol:.3e})")
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"K3 {name} disagrees with its plain version at {shape} "
                                 f"{dtype}: {err} > {tol}")
        worst = max(worst, err)
    log("attention", f"K3 {tuple(shape)} {dtype}: max|kernel - plain| " + ", ".join(report))
    return (q, k, v, g), worst


def phase_attention(state):
    import torch
    import torch.nn.functional as F

    from irw_tpu_torch.ops.attention import (
        attention_plain,
        attention_plain_bwd,
        fused_attention,
        fused_attention_bwd,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
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
    log("attention", f"K2 at the serve shape {K2_SHAPE}: kernel {ms:.4f} ms | plain "
                     f"{plain_ms:.4f} ms | SDPA {lib_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by}) "
                     f"| {state['card']}")
    state["kernels"]["fused_attention"] = {
        "name": "fused_attention", "route": "cuda",
        "source": "irw_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "irw_tpu/ops/vmem_attention.py:207", "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms}

    # K3, and K2 at the training shape
    for shape, dtype in [((3, 50, 2, 64), torch.bfloat16), ((3, 50, 2, 64), torch.float32),
                         ((2, 70, 3, 32), torch.float32), ((2, 70, 3, 32), torch.bfloat16),
                         ((2, 130, 1, 128), torch.bfloat16), ((2, 130, 1, 128), torch.float32),
                         ((2, 3, 65, 1, 64), torch.float32), ((64, 257, 6, 64), torch.float32)]:
        _attention_bwd_case(shape, dtype, seed=3)
    (q, k, v, g), err = _attention_bwd_case(K3_SHAPE, torch.bfloat16, seed=4)
    qt, kt, vt, gt = (t.transpose(1, 2) for t in (q, k, v, g))
    with torch.no_grad():
        fwd_train_ms = time_ms(lambda: fused_attention(q, k, v))
    ms = time_ms(lambda: fused_attention_bwd(q, k, v, g))
    plain_ms = time_ms(lambda: attention_plain_bwd(q, k, v, g), iters=5)
    qr, kr, vr = (t.detach().requires_grad_() for t in (qt, kt, vt))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qr, kr, vr)
        torch.autograd.grad(out, (qr, kr, vr), gt)

    with torch.no_grad():
        sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qr, kr, vr))
    lib_ms = time_ms(sdpa_fwd_bwd) - sdpa_fwd_ms
    b, n, h, hd = K3_SHAPE
    nbytes = 7 * b * n * h * hd * 2
    flops = 10 * b * h * n * n * hd
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    log("attention", f"K2 at the training shape {K3_SHAPE}: kernel {fwd_train_ms:.4f} ms | "
                     f"{state['card']}")
    log("attention", f"K3 at {K3_SHAPE}: kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
                     f"SDPA backward {lib_ms:.4f} ms (fwd+bwd minus fwd {sdpa_fwd_ms:.4f}) | "
                     f"bound {b_ms:.4f} ms ({b_by}) | {state['card']}")
    state["kernels"]["fused_attention_bwd"] = {
        "name": "fused_attention_bwd", "route": "cuda",
        "source": "irw_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "irw_tpu/ops/vmem_attention.py:227", "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms}


def _flagship_model(vit_kwargs=None):
    """The flagship from its YAML kwargs at full width, random weights from
    seed 0; ``vit_kwargs`` are added to the backbone's (``FLASH``)."""
    import torch

    from irw_tpu_torch.models import get_model

    kwargs = dict(FLAGSHIP["kwargs"], vit_kwargs=dict(vit_kwargs or {}))
    model = get_model(FLAGSHIP["name"], seed=0, **kwargs)
    vit = model.backbone.vit
    assert vit.dtype == torch.bfloat16 and vit.embed_dim == 384 and len(vit.blocks) == 12
    with torch.no_grad():  # LayerScale 1: at the 1e-5 init attention barely reaches the codes
        for blk in vit.blocks:
            blk.ls1.fill_(1.0)
            blk.ls2.fill_(1.0)
    return model


def _check_cores(model, name: str):
    """Every block's attention core is ``name`` (the kernel route)."""
    cores = {blk.attn.core.__name__ for blk in model.backbone.vit.blocks}
    if cores != {name}:
        raise AssertionError(f"expected every block's attention core to be {name}, got {cores}")


KERNEL_IDS = ("K1", "K2", "K3", "K4", "K6-fwd", "K6-bwd", "K5")


def _kernel_wrappers():
    """The wrappers of every kernel (in ``KERNEL_IDS``' order), whose
    ``launches`` each path sets to 0 and reads."""
    from irw_tpu_torch.ops.attention import fused_attention, fused_attention_bwd
    from irw_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from irw_tpu_torch.ops.qkv_attention import fused_qkv_attention
    from irw_tpu_torch.ops.wavelets import haar_swt2, lifting_multi_level

    return (haar_swt2, fused_attention, fused_attention_bwd, lifting_multi_level,
            flash_attention_fwd, flash_attention_bwd, fused_qkv_attention)


def _launch_counts(kernels) -> dict:
    return {fn.__name__: fn.launches for fn in kernels}


def _check_launches(phase: str, per_run: list, expected: tuple, what: str):
    log(phase, f"launches per {what} ({', '.join(KERNEL_IDS)}): {per_run}")
    if per_run != [expected] * len(per_run):
        want = ", ".join(f"{k} = {n}" for k, n in zip(KERNEL_IDS, expected))
        raise AssertionError(f"{phase}: expected {want} launches per {what}, got {per_run}")


def _release_earlier_phases(state) -> int:
    """Drop what earlier phases keep on the card (the served flagship that
    profile and retrieval reuse); the bytes still allocated, above which a
    path's own peak memory is counted."""
    import gc

    import torch

    state.pop("model", None)
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _serve_flagship(state, phase: str, model, expected: tuple, plain_core, held: int):
    """SERVE_BATCHES timed batches of BATCH through the flagship ``model``:
    the launches of every kernel per batch must equal ``expected``; then the
    codes are held against the same weights with every block's attention
    core set to ``plain_core`` and K1's plain version, on the card.  Peak
    memory is counted above the ``held`` bytes allocated before the model
    was built."""
    import torch

    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.ops.wavelets import haar_swt2_plain
    from irw_tpu_torch.transforms import DeviceTransform

    vit = model.backbone.vit
    transform = DeviceTransform(SWT_OPS)
    ds = SyntheticVOCDataset(num_train=BATCH * (SERVE_BATCHES + 1), image_size=224, seed=0)
    batches = [ds.images[i * BATCH:(i + 1) * BATCH] for i in range(SERVE_BATCHES + 1)]

    kernels = _kernel_wrappers()
    with torch.inference_mode():
        model(transform(batches[0]))  # warm-up: cuBLAS handles, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        outs, per_batch = [], []
        t0 = time.perf_counter()
        for images in batches[1:]:
            before = [fn.launches for fn in kernels]
            bands = transform(images)
            logits, aux = model.forward_logits(bands)
            outs.append((images, logits, torch.sign(logits)))
            per_batch.append(tuple(fn.launches - b for fn, b in zip(kernels, before)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _launch_counts(kernels)
        state["launches"][phase] = counts
        peak = torch.cuda.max_memory_allocated() - held
        log(phase, f"launches over {SERVE_BATCHES} batches: {counts}")
        _check_launches(phase, per_batch, expected, "batch")
        ips = SERVE_BATCHES * BATCH / seconds
        log(phase, f"{ips:.1f} img/s, {seconds / SERVE_BATCHES * 1e3:.1f} ms per batch (batch "
                   f"{BATCH}, SWT + 4 x ViT-S/14 + fusion + hash, bf16) | the path's own peak "
                   f"memory {peak / 2 ** 30:.2f} GiB (above {held / 2 ** 30:.2f} GiB held "
                   f"before its model) | {state['card']}")

        # the same weights on the plain versions, on the card
        cores = [blk.attn.core for blk in vit.blocks]
        for blk in vit.blocks:
            blk.attn.core = plain_core
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
                log(phase, f"batch {i}: max|logit - plain| = {dmax:.3e}; codes differ at "
                           f"{n_differ} of the {n_sure}/{sure.numel()} bits with "
                           f"|logit| > {LOGIT_MARGIN}")
                if n_differ or 2 * n_sure < sure.numel():
                    raise AssertionError(f"batch {i}: codes disagree with the plain path")
        finally:
            for blk, core in zip(vit.blocks, cores):
                blk.attn.core = core
    return seconds / SERVE_BATCHES * 1e3


def phase_serve(state):
    from irw_tpu_torch.ops.attention import attention_plain

    held = _release_earlier_phases(state)
    model = _flagship_model()
    _check_cores(model, "vmem_attention_fn")
    state["model"] = model
    _serve_flagship(state, "serve", model, (1, 12, 0, 0, 0, 0, 0), attention_plain, held)


_KERNEL_GROUPS = (("K3 attention bwd", ("attention_bwd",)), ("K2 attention", ("attention_fwd",)),
                  ("K6 flash bwd", ("flash_bwd",)), ("K6 flash fwd", ("flash_fwd",)),
                  ("K1 swt", ("haar_swt2",)),
                  ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet")),
                  ("reduce", ("reduce",)), ("elementwise", ("elementwise", "vectorized")))


def _device_profile(phase: str, run, what: str, state, groups=_KERNEL_GROUPS) -> float | None:
    """Device time of one ``run()`` by kernel group, from torch.profiler,
    the device's idle share over the call's wall time (which the profiler's
    own host overhead lengthens), and the idle gaps between its first and
    last kernel with the kernels after the largest ones.  Returns the
    device-busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:  # a measurement, not a check: say so rather than guess
        log(phase, "the profiler recorded no device kernel: device time not measured")
        return None
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    by_group = {g: 0.0 for g, _ in groups}
    by_group["other"] = 0.0
    for name, us in by_name.items():
        low = name.lower()
        group = next((g for g, keys in groups if any(k in low for k in keys)), "other")
        by_group[group] += us
    log(phase, f"{what}: wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, "
               f"idle share {1 - busy / wall_us:.3f} | {state['card']}")
    log(phase, "by group: " + ", ".join(f"{g} {us / 1e3:.2f} ms ({us / busy:.1%})"
                                        for g, us in by_group.items()))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(phase, f"{us / 1e3:8.3f} ms  {name[:110]}")
    kernels.sort(key=lambda e: e.time_range.start)
    gaps = sorted(((b.time_range.start - a.time_range.end, b.name)
                   for a, b in zip(kernels, kernels[1:])), reverse=True)
    idle = sum(g for g, _ in gaps if g > 0)
    log(phase, f"device idle between its kernels {idle / 1e3:.2f} ms; largest gaps: "
               + "; ".join(f"{g / 1e3:.3f} ms before {name[:48]}" for g, name in gaps[:3]))
    return busy / 1e3


def phase_profile(state):
    """Device time of one served batch by kernel, from torch.profiler."""
    import torch

    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.transforms import DeviceTransform

    model = state["model"] if "model" in state else _flagship_model()
    transform = DeviceTransform(SWT_OPS)
    images = SyntheticVOCDataset(num_train=BATCH, image_size=224, seed=2).images
    with torch.inference_mode():
        model(transform(images))
        _device_profile("profile", lambda: model(transform(images)),
                        f"one batch of {BATCH}", state)


def _route_step(tstate, step, batch, hyper, snapshot, core=None):
    """One train step from ``snapshot`` (parameters, BatchNorm statistics,
    HashLoss proxies, rng states), optionally with every block's attention
    core replaced; returns (total_loss, flattened gradient per top-level
    module)."""
    import torch

    model = tstate.model
    model.load_state_dict(snapshot["model"])
    tstate.losses[0][0].load_state_dict(snapshot["loss"])
    for name, gen in tstate.generators.items():
        gen.set_state(snapshot["rng"][name])
    blocks = model.backbone.vit.blocks
    cores = [blk.attn.core for blk in blocks]
    if core is not None:
        for blk in blocks:
            blk.attn.core = core
    try:
        metrics = step(tstate, batch, hyper)
    finally:
        for blk, c in zip(blocks, cores):
            blk.attn.core = c
    grads = {m: torch.cat([p.grad.float().flatten() for p in getattr(model, m).parameters()
                           if p.grad is not None])
             for m in ("backbone", "head", "hash_head")}
    return float(metrics["total_loss"]), grads


def _train_flagship(state, phase: str, model, expected: tuple, plain_core, held: int):
    """The flagship ``model`` trains: TRAIN_STEPS AdamW steps at batch 96,
    trained img/s over the whole window to a synchronize (each step's time
    between CUDA events beside it), whose launches of every kernel per step
    must equal ``expected``; peak memory above the ``held`` bytes allocated
    before the model was built; the kernel route held against the same step
    with every block's attention core set to ``plain_core``; one step
    profiled."""
    import torch

    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.engine import build_train_step, init_train_state
    from irw_tpu_torch.engine.train import _build_hyper
    from irw_tpu_torch.losses import build_losses
    from irw_tpu_torch.transforms import DeviceTransform

    assert model.backbone.vit.remat_blocks and not model.frozen_backbone
    ds = SyntheticVOCDataset(num_train=TRAIN_BATCH * 2, image_size=224, seed=3)
    batches = [{"image": ds.images[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                "label": ds.labels[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]} for i in range(2)]
    tstate = init_train_state(model, build_losses(HASH_LOSS), OPTIMIZER, HASH_LOSS, seed=0)
    step = build_train_step(DeviceTransform(SWT_OPS), clip_grad=PROTOCOL["clip_grad"],
                            proxy_map_metric="hamming")

    def hyper():
        return _build_hyper(tstate.optimizer_entries, 1, tstate.step, PROTOCOL["warm_up"], None,
                            PROTOCOL["ortho_scale"])

    step(tstate, batches[0], hyper())  # warm-up: cuBLAS handles, allocator, build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = _kernel_wrappers()
    for fn in kernels:
        fn.launches = 0
    per_step, metrics = [], []
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        before = [fn.launches for fn in kernels]
        marks[i].record()
        metrics.append(step(tstate, batches[i % 2], hyper()))
        per_step.append(tuple(fn.launches - b for fn, b in zip(kernels, before)))
    marks[-1].record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    mean_ms = seconds / TRAIN_STEPS * 1e3
    counts = _launch_counts(kernels)
    state["launches"][phase] = counts
    peak = torch.cuda.max_memory_allocated() - held
    log(phase, f"launches over {TRAIN_STEPS} steps: {counts}")
    _check_launches(phase, per_step, expected, "step")
    log(phase, f"{TRAIN_STEPS * TRAIN_BATCH / seconds:.1f} trained img/s, {mean_ms:.1f} ms per "
               f"step over the window (batch {TRAIN_BATCH}, bf16, block remat, AdamW); steps "
               + ", ".join(f"{t:.1f}" for t in step_ms)
               + f" ms between CUDA events, median {statistics.median(step_ms):.1f} | the "
               f"path's own peak memory {peak / 2 ** 30:.2f} GiB (above {held / 2 ** 30:.2f} "
               f"GiB held before its model) | {state['card']}")
    for i, m in enumerate(metrics):
        values = {k: float(v) for k, v in m.items()}
        log(phase, f"step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in values.items()))
        if not all(math.isfinite(values[k]) for k in TRAIN_METRICS):
            raise AssertionError(f"step {i}: non-finite metrics {values}")

    # the kernel route against the plain route, from one saved state
    snapshot = {"model": {k: v.clone() for k, v in model.state_dict().items()},
                "loss": {k: v.clone() for k, v in tstate.losses[0][0].state_dict().items()},
                "rng": {k: g.get_state() for k, g in tstate.generators.items()}}
    loss_k, grads_k = _route_step(tstate, step, batches[0], hyper(), snapshot)
    loss_p, grads_p = _route_step(tstate, step, batches[0], hyper(), snapshot, core=plain_core)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cosines = {m: float(torch.nn.functional.cosine_similarity(grads_k[m], grads_p[m], dim=0))
               for m in grads_k}
    log(phase, f"kernel vs plain route: total_loss {loss_k:.6f} vs {loss_p:.6f} (rel "
               f"{rel:.2e}, limit {ROUTE_LOSS_TOL}); gradient cosine per module "
               + ", ".join(f"{m} {c:.6f}" for m, c in cosines.items())
               + f" (limit {ROUTE_COSINE})")
    if not (rel <= ROUTE_LOSS_TOL and all(c >= ROUTE_COSINE for c in cosines.values())):
        raise AssertionError(f"the kernel route disagrees with the plain route: {rel}, {cosines}")

    busy_ms = _device_profile(phase, lambda: step(tstate, batches[1], hyper()),
                              f"one train step of {TRAIN_BATCH}", state)
    if busy_ms is not None:
        log(phase, f"idle share against the timed steps' {mean_ms:.1f} ms: "
                   f"{1 - busy_ms / mean_ms:.3f}")


def phase_train(state):
    """The flagship trains with K2 and K3 (``vmem_attn``, the factory's
    default for unfrozen backbones on the card)."""
    from irw_tpu_torch.ops.attention import attention_plain_autograd

    held = _release_earlier_phases(state)
    model = _flagship_model()
    _check_cores(model, "vmem_attention_fn")
    _train_flagship(state, "train", model, (1, 24, 12, 0, 0, 0, 0), attention_plain_autograd, held)


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

def _lifting_flops(n: int, h: int, w: int, levels: int, basis: str) -> float:
    """Operations of the multi-level lifting DWT: per level, each step adds
    2 per tap (1 mul + 1 add; a cdf97 pair step 3) to every target element,
    along H over the plane and along W over the rows the next stage needs,
    then one scale per element and the v6 products."""
    from irw_tpu_torch.ops.wavelets.lifting_dwt import kernel_steps

    steps, _ = kernel_steps(basis)
    per_pair = sum(3 if pair else 2 * len(shifts) for _, pair, shifts, _ in steps)
    flops = 0.0
    for lvl in range(levels):
        hl, wl = h >> lvl, w >> lvl
        rows = hl if lvl == levels - 1 else hl // 2   # the W pass of an earlier level: LL only
        flops += n * (wl * (hl // 2) * per_pair + hl * wl          # H pass and its scale
                      + rows * (wl // 2) * per_pair + 2 * rows * wl)  # W pass, scale, v6
    return flops


def _k4_case(basis, levels, shape, seed, time_it=False):
    """K4 against ``lifting_multi_level_plain`` on uniform [0, 1) planes;
    returns (x, max error, max|plain|)."""
    import torch

    from irw_tpu_torch.ops.wavelets import lifting_multi_level, lifting_multi_level_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(shape, generator=gen, device="cuda") * 2.0 - 1.0
    out = lifting_multi_level(x, levels, basis)
    ref = lifting_multi_level_plain(x, levels, basis)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    peak = ref.abs().max().item()
    tol = K4_TOL["haar" if basis == "haar" else "other"] * max(1.0, peak)
    n, h, w = shape
    msg = (f"K4 {basis} l={levels} {tuple(shape)} f32: max|kernel - plain| = {err:.3e} "
           f"(limit {tol:.3e})")
    if time_it:
        ms = time_ms(lambda: lifting_multi_level(x, levels, basis))
        nbytes = 4 * (n * h * w + n * 4 * (h >> levels) * (w >> levels))
        b_ms, b_by = bound_ms(nbytes, _lifting_flops(n, h, w, levels, basis), "float32")
        msg += f" | kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
    log("dwt", msg)
    if not (err <= tol and out.shape == ref.shape and torch.isfinite(out).all()):
        raise AssertionError(f"K4 disagrees with its plain version: {basis} l={levels} "
                             f"{shape}: {err} > {tol}")
    return x, err


def phase_dwt(state):
    import torch
    import torch.nn.functional as F

    from irw_tpu_torch.ops.wavelets import lifting_multi_level, lifting_multi_level_plain

    for basis, levels, shape in [("haar", 2, K4_SHAPE), ("haar", 3, K4_SHAPE),
                                 ("cdf97", 2, K4_CDF97_SHAPE), ("bior48", 2, K4_SHAPE),
                                 ("daub4", 2, K4_SHAPE), ("haar", 2, (5, 72, 200)),
                                 ("coif12", 2, (5, 72, 200)), ("rev_bior_spline_39", 1, (3, 20, 12))]:
        _k4_case(basis, levels, shape, seed=5, time_it=shape[0] == 3 * BATCH)

    # cdf97 level 1 at cub_dwt_cdf97.yaml's 448² (no single library call computes it)
    x, err = _k4_case("cdf97", 1, K4_CDF97_SHAPE, seed=6)
    ms = time_ms(lambda: lifting_multi_level(x, 1, "cdf97"))
    plain_ms = time_ms(lambda: lifting_multi_level_plain(x, 1, "cdf97"), iters=5)
    n, h, w = K4_CDF97_SHAPE
    b_ms, b_by = bound_ms(4 * n * h * w * 2, _lifting_flops(n, h, w, 1, "cdf97"), "float32")
    log("dwt", f"K4 cdf97 l=1 at {K4_CDF97_SHAPE}: kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
               f"library — | bound {b_ms:.4f} ms ({b_by}) | {state['card']}")

    # the served case, haar level 1 at (192, 224, 224)
    x, err = _k4_case("haar", 1, K4_SHAPE, seed=7)
    # yardstick: conv2d, stride 2, with the four 2x2 haar · v6 filters computes
    # the same bands up to rounding; TF32 off so it is the same f32 math
    r = 1.0 / math.sqrt(2.0)
    filt = torch.tensor([[[[0.25, 0.25], [0.25, 0.25]]], [[[-0.5, -0.5], [0.5, 0.5]]],
                         [[[-0.5, 0.5], [-0.5, 0.5]]], [[[r, -r], [-r, r]]]],
                        dtype=torch.float32, device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x4 = x[:, None]
        with torch.no_grad():
            lib_err = (F.conv2d(x4, filt, stride=2) - lifting_multi_level_plain(x)).abs().max()
            log("dwt", f"library conv2d(stride 2, haar·v6 filters) vs plain: {lib_err.item():.3e}")
            lib_ms = time_ms(lambda: F.conv2d(x4, filt, stride=2))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    ms = time_ms(lambda: lifting_multi_level(x))
    plain_ms = time_ms(lambda: lifting_multi_level_plain(x))
    n, h, w = K4_SHAPE
    b_ms, b_by = bound_ms(4 * n * h * w * 2, _lifting_flops(n, h, w, 1, "haar"), "float32")
    log("dwt", f"K4 haar l=1 at the served shape {K4_SHAPE}: kernel {ms:.4f} ms | plain "
               f"{plain_ms:.4f} ms | conv2d {lib_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by}) | "
               f"{state['card']}")
    state["kernels"]["lifting_multi_level"] = {
        "name": "lifting_multi_level", "route": "cuda",
        "source": "irw_tpu_torch/csrc/lifting_dwt.cu",
        "replaces": "irw_tpu/ops/wavelets/pallas_dwt.py:208", "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms}


_WCNN_GROUPS = (("K4 lifting", ("lift_h_kernel", "lift_w_kernel")),
                ("BatchNorm/ReLU elementwise", ("bn_fw", "batch_norm", "batchnorm", "elementwise",
                                                "vectorized")),
                ("cuDNN convs", ("conv", "xmma", "implicit", "cudnn", "fprop", "winograd",
                                 "gemm", "cutlass", "nvjet", "sm90_", "sm80_")),
                ("reduce", ("reduce",)))


def phase_wcnn(state):
    """The DWT serving path at full width: WCNN_BATCHES timed batches of 64,
    the K4 route held against the plain route, one batch profiled, then the
    cosine ``evaluate`` on a CUB-test-sized set."""
    import torch

    from irw_tpu_torch.data import SyntheticDataset
    from irw_tpu_torch.engine import evaluate
    from irw_tpu_torch.models import get_model
    from irw_tpu_torch.models.wresnet import WCNNAttention
    from irw_tpu_torch.ops.wavelets import lifting_multi_level_plain
    from irw_tpu_torch.transforms import DeviceTransform, pipeline

    t0 = time.perf_counter()
    model = get_model(WCNN["name"], seed=0, **WCNN["kwargs"])
    build_s = time.perf_counter() - t0
    assert isinstance(model, WCNNAttention) and model.backbone.out_dim == 2048
    assert len(model.backbone.branches) == 4 and len(model.backbone.branches[0].blocks) == 16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    precision = (f"f32 parameters; cuDNN convs allow TF32 = {torch.backends.cudnn.allow_tf32}, "
                 f"matmuls allow TF32 = {torch.backends.cuda.matmul.allow_tf32}")
    log("wcnn", f"model built in {build_s:.1f} s (4 x ResNet-50, CBAM gate, 64 classes); "
                f"{precision}")
    transform = DeviceTransform(DWT_OPS)
    ds = SyntheticDataset(num_samples=BATCH * (WCNN_BATCHES + 1), num_classes=100,
                          image_size=224, seed=4)
    batches = [ds.images[i * BATCH:(i + 1) * BATCH] for i in range(WCNN_BATCHES + 1)]
    kernels = _kernel_wrappers()

    with torch.inference_mode():
        model(transform(batches[0]))  # warm-up: cuDNN plans, allocator, K4's build
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        outs, per_batch = [], []
        t0 = time.perf_counter()
        for images in batches[1:]:
            before = [fn.launches for fn in kernels]
            emb, aux = model(transform(images))
            outs.append((images, emb, aux["gate"]))
            per_batch.append(tuple(fn.launches - b for fn, b in zip(kernels, before)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _launch_counts(kernels)
        state["launches"]["wcnn"] = counts
        peak = torch.cuda.max_memory_allocated()
        log("wcnn", f"launches over {WCNN_BATCHES} batches: {counts}")
        _check_launches("wcnn", per_batch, (0, 0, 0, 1, 0, 0, 0), "batch")
        log("wcnn", f"{WCNN_BATCHES * BATCH / seconds:.1f} img/s (batch {BATCH}, Normalize + "
                    f"haar DWT + 4 x ResNet-50 at 112² + CBAM gate) | peak memory "
                    f"{peak / 2 ** 30:.2f} GiB | {precision} | {state['card']}")

        # the same model with CustomTransform on K4's plain version
        kernel_fn = pipeline.lifting_multi_level
        pipeline.lifting_multi_level = lifting_multi_level_plain
        try:
            for i, (images, emb, gate) in enumerate(outs):
                ref, ref_aux = model(transform(images))
                if not (emb.shape == (BATCH, 2048) and torch.isfinite(emb).all()
                        and torch.allclose(emb.norm(dim=-1), torch.ones_like(emb[:, 0]),
                                           atol=1e-5)
                        and gate.shape == (BATCH, 4)):
                    raise AssertionError(f"batch {i}: embeddings not finite, unit, (64, 2048)")
                dmax = (emb - ref).abs().max().item()
                gmax = (gate - ref_aux["gate"]).abs().max().item()
                log("wcnn", f"batch {i}: max|emb - plain route| = {dmax:.3e} (limit "
                            f"{WCNN_EMB_TOL}), gate {gmax:.3e}")
                if not dmax <= WCNN_EMB_TOL:
                    raise AssertionError(f"batch {i}: the K4 route disagrees with the plain "
                                         f"route: {dmax}")
        finally:
            pipeline.lifting_multi_level = kernel_fn

        images = batches[1]
        busy_ms = _device_profile("wcnn", lambda: model(transform(images)),
                                  f"one batch of {BATCH}", state, _WCNN_GROUPS)
        if busy_ms is not None:
            batch_ms = seconds / WCNN_BATCHES * 1e3
            log("wcnn", f"idle share against the timed batches' {batch_ms:.1f} ms: "
                        f"{1 - busy_ms / batch_ms:.3f}")

    t0 = time.perf_counter()
    cub = SyntheticDataset(num_samples=CUB_TEST, num_classes=100, image_size=224, seed=5)
    make_s = time.perf_counter() - t0
    k = min(5000, len(cub) - 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = evaluate(model, cub, transform, batch_size=BATCH, top_k=k, distance_metric="cosine")
    eval_s = time.perf_counter() - t0
    log("wcnn", f"evaluate (cosine, k {k}) on {len(cub)} images of 224², 100 classes: "
                f"{eval_s:.2f} s ({make_s:.1f} s to make the set); map "
                f"{res['map_level0']:.4f}, map_at_r {res['map_at_r_level0']:.4f}, recall@1 "
                f"{res['recall_at_1_level0']:.4f} | {state['card']}")
    if not (all(math.isfinite(v) for v in res.values()) and 0.0 <= res["map_level0"] <= 1.0
            and res["num_k_level0"] == k):
        raise AssertionError(f"evaluate gave non-finite or out-of-range metrics: {res}")


def _qkv(shape, dtype, gen, fused: bool):
    """Unit-normal q, k, v of ``shape``; with ``fused`` the three strided
    views of one (…, N, 3, H, hd) projection, as ``FlashAttention`` passes
    them."""
    import torch

    if fused:
        *lead, n, h, hd = shape
        qkv = torch.randn((*lead, n, 3, h, hd), generator=gen, device="cuda").to(dtype)
        return qkv.unbind(-3)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))


def _flash_fwd_case(shape, dtype, seed, fused=False, residuals=False):
    """K6-fwd against ``flash_attention_plain`` on unit-normal q, k, v
    (``_qkv``); returns (q, k, v), the error."""
    import torch

    from irw_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _qkv(shape, dtype, gen, fused)
    out = flash_attention_fwd(q, k, v, save_residuals=residuals)
    ref = flash_attention_plain(q, k, v, save_residuals=residuals)
    torch.cuda.synchronize()
    if residuals:
        (out, l, m), (ref, rl, rm) = out, ref
        stats = max(((l - rl).abs() / rl).max().item(), ((m - rm).abs().max().item()))
    err = (out.float() - ref.float()).abs().max().item()
    tol = K6_FWD_TOL[str(dtype).removeprefix("torch.")]
    what = f"K6-fwd {tuple(shape)} {dtype}" + (" fused views" if fused else "")
    log("flash", f"{what}: max|kernel - plain| = {err:.3e} (limit {tol:.3e}, max|o| "
                 f"{ref.float().abs().max().item():.3f})"
                 + (f"; l, m {stats:.3e} (limit 1e-5)" if residuals else ""))
    if not (err <= tol and torch.isfinite(out).all() and (not residuals or stats <= 1e-5)):
        raise AssertionError(f"{what} disagrees with its plain version: {err}")
    return (q, k, v), err


def _flash_bwd_case(shape, dtype, seed, path_layout=False):
    """K6-bwd against ``flash_attention_plain_bwd`` from the same residuals
    on unit-normal q, k, v, do: the plain forward's o, l, m, or with
    ``path_layout`` the strided views of a fused projection and the kernel
    forward's o, l, m, as the training path gives them; returns the inputs
    and the largest error over dq, dk, dv."""
    import torch

    from irw_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        flash_attention_plain,
        flash_attention_plain_bwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _qkv(shape, dtype, gen, path_layout)
    do = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    fwd = flash_attention_fwd if path_layout else flash_attention_plain
    o, l, m = fwd(q, k, v, save_residuals=True)
    outs = flash_attention_bwd(q, k, v, o, do, l, m)
    refs = flash_attention_plain_bwd(q, k, v, o, do, l, m)
    torch.cuda.synchronize()
    worst, report = 0.0, []
    for name, out, ref in zip(("dq", "dk", "dv"), outs, refs):
        err = (out.float() - ref.float()).abs().max().item()
        peak = ref.float().abs().max().item()
        tol = K3_TOL_F32 if dtype == torch.float32 else K3_TOL_BF16 * peak
        report.append(f"{name} {err:.3e} (limit {tol:.3e})")
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"K6-bwd {name} disagrees with its plain version at {shape} "
                                 f"{dtype}: {err} > {tol}")
        worst = max(worst, err)
    what = " fused views, kernel o, l, m" if path_layout else ""
    log("flash", f"K6-bwd {tuple(shape)} {dtype}{what}: max|kernel - plain| " + ", ".join(report))
    return (q, k, v, o, do, l, m), worst


def phase_flash(state):
    """K6-fwd and K6-bwd against their plain versions, then timed at the
    served and the training shape, on the path's layout, beside SDPA and
    their bounds."""
    import torch
    import torch.nn.functional as F

    from irw_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        flash_attention_plain,
        flash_attention_plain_bwd,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    bf16, f32 = torch.bfloat16, torch.float32
    for shape, dtype in [((64, 257, 6, 64), f32), ((8, 257, 6, 32), f32), ((8, 257, 2, 128), f32),
                         ((8, 257, 2, 128), bf16), ((8, 37, 6, 64), bf16), ((8, 37, 6, 32), f32),
                         ((8, 384, 6, 64), bf16), ((8, 384, 6, 64), f32),
                         (K6_SERVE_SHAPE, bf16)]:
        _flash_fwd_case(shape, dtype, seed=10)
    _flash_fwd_case(K6_TRAIN_SHAPE, bf16, seed=12, fused=True, residuals=True)
    (q, k, v), err = _flash_fwd_case(K6_SERVE_SHAPE, bf16, seed=11, fused=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # SDPA's (B, H, N, hd)
    with torch.no_grad():
        ms = time_ms(lambda: flash_attention_fwd(q, k, v))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v), iters=5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    b, n, h, hd = K6_SERVE_SHAPE
    b_ms, b_by = bound_ms(4 * b * n * h * hd * 2, 4 * b * h * n * n * hd, "bfloat16")
    log("flash", f"K6-fwd at the serve shape {K6_SERVE_SHAPE}, fused views: kernel {ms:.4f} ms "
                 f"| plain {plain_ms:.4f} ms | SDPA {lib_ms:.4f} ms | bound {b_ms:.4f} ms "
                 f"({b_by}) | {state['card']}")
    state["kernels"]["flash_attention_fwd"] = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "irw_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms}

    for shape, dtype in [((8, 37, 2, 32), f32), ((8, 37, 2, 64), bf16), ((8, 384, 2, 128), bf16),
                         ((4, 130, 2, 128), f32), ((2, 3, 200, 2, 64), f32),
                         (K6_TRAIN_SHAPE, f32)]:
        _flash_bwd_case(shape, dtype, seed=13)
    (q, k, v, o, do, l, m), err = _flash_bwd_case(K6_TRAIN_SHAPE, bf16, seed=14, path_layout=True)
    with torch.no_grad():
        fwd_train_ms = time_ms(lambda: flash_attention_fwd(q, k, v, save_residuals=True))
    ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, do, l, m))
    plain_ms = time_ms(lambda: flash_attention_plain_bwd(q, k, v, o, do, l, m), iters=3)
    qr, kr, vr = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qr, kr, vr)
        torch.autograd.grad(out, (qr, kr, vr), dot)

    with torch.no_grad():
        sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qr, kr, vr))
    lib_ms = time_ms(sdpa_fwd_bwd) - sdpa_fwd_ms
    b, n, h, hd = K6_TRAIN_SHAPE
    # read q, k, v, do and l, m, di; write dq, dk, dv; five products
    nbytes = 7 * b * n * h * hd * 2 + 3 * b * h * n * 4
    b_ms, b_by = bound_ms(nbytes, 10 * b * h * n * n * hd, "bfloat16")
    log("flash", f"K6-fwd with l, m at the training shape {K6_TRAIN_SHAPE}, fused views: "
                 f"kernel {fwd_train_ms:.4f} ms | {state['card']}")
    log("flash", f"K6-bwd at {K6_TRAIN_SHAPE}, fused views (di, then the dK/dV and dQ "
                 f"kernels): kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | SDPA backward "
                 f"{lib_ms:.4f} ms (fwd+bwd minus fwd {sdpa_fwd_ms:.4f}) | bound {b_ms:.4f} ms "
                 f"({b_by}) | {state['card']}")
    state["kernels"]["flash_attention_bwd"] = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "irw_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121,1456",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms}


def phase_flash_serve(state):
    """The flagship with ``use_flash`` serves: K1 = 1 and K6-fwd = 12
    launches per batch, codes against the plain route, img/s, one batch
    profiled."""
    import torch

    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.ops.flash_attention import flash_attention_plain_autograd
    from irw_tpu_torch.transforms import DeviceTransform

    held = _release_earlier_phases(state)
    model = _flagship_model(FLASH)
    _check_cores(model, "flash_attention")
    batch_ms = _serve_flagship(state, "flash_serve", model, (1, 0, 0, 0, 12, 0, 0),
                               flash_attention_plain_autograd, held)
    transform = DeviceTransform(SWT_OPS)
    images = SyntheticVOCDataset(num_train=BATCH, image_size=224, seed=2).images
    with torch.inference_mode():
        busy_ms = _device_profile("flash_serve", lambda: model(transform(images)),
                                  f"one batch of {BATCH}", state)
    if busy_ms is not None:
        log("flash_serve", f"idle share against the timed batches' {batch_ms:.1f} ms: "
                           f"{1 - busy_ms / batch_ms:.3f}")


def phase_flash_train(state):
    """The flagship with ``use_flash`` trains: K1 = 1, K6-fwd = 24 (forward
    and remat recompute) and K6-bwd = 12 launches per step; the factory's
    ``vmem_attn`` for unfrozen backbones is on, and the flash route wins."""
    from irw_tpu_torch.ops.flash_attention import flash_attention_plain_autograd

    held = _release_earlier_phases(state)
    model = _flagship_model(FLASH)
    _check_cores(model, "flash_attention")
    _train_flagship(state, "flash_train", model, (1, 0, 0, 0, 24, 12, 0),
                    flash_attention_plain_autograd, held)


def _k5_inputs(b, n, d, heads_dim, dtype, seed):
    """x unit normal, weights (d, heads_dim) / sqrt(d), biases * 0.01 (the
    micro-benchmark's scales), drawn on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = draw(b, n, d)
    ws = [draw(d, heads_dim) / math.sqrt(d) for _ in range(3)]
    bs = [draw(heads_dim) * 0.01 for _ in range(3)]
    return tuple(t.to(dtype) for t in (x, *ws, *bs))


def _k5_case(b, n, d, heads, hd, dtype, seed):
    """K5 against ``qkv_attention_plain``; returns the inputs and the error."""
    import torch

    from irw_tpu_torch.ops.qkv_attention import fused_qkv_attention, qkv_attention_plain

    args = _k5_inputs(b, n, d, heads * hd, dtype, seed)
    with torch.no_grad():
        out = fused_qkv_attention(*args, heads=heads)
        ref = qkv_attention_plain(*args, heads=heads)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    peak = ref.float().abs().max().item()
    tol = K5_TOL[str(dtype).removeprefix("torch.")] * max(1.0, peak)
    log("qkv", f"K5 x ({b}, {n}, {d}) {dtype}, {heads} heads of {hd}: max|kernel - plain| = "
               f"{err:.3e} (limit {tol:.3e}, max|o| {peak:.3f})")
    if not (err <= tol and out.shape == ref.shape and torch.isfinite(out).all()):
        raise AssertionError(f"K5 disagrees with its plain version at ({b}, {n}, {d}) {dtype}, "
                             f"{heads} x {hd}: {err} > {tol}")
    return args, err


def phase_qkv(state):
    """K5 against its plain version, then timed at the micro-benchmark's
    default shape and at the flagship's served rows beside the plain version,
    the production segment and the two-call library yardstick."""
    import torch
    import torch.nn.functional as F

    from irw_tpu_torch.benchmarks.vmem_qkv_micro import ref_segment
    from irw_tpu_torch.ops.qkv_attention import fused_qkv_attention, qkv_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    bf16, f32 = torch.bfloat16, torch.float32
    for b, n, d, heads, hd, dtype in [
            (3, 37, 64, 2, 32, f32), (3, 37, 64, 2, 32, bf16),          # N = 37: one key tile
            (8, 37, 384, 6, 64, bf16),
            (8, 257, 192, 6, 32, bf16), (8, 257, 192, 6, 32, f32),      # hd = 32
            (4, 257, 96, 3, 32, bf16), (4, 257, 96, 3, 32, f32),        # D = 96: a ragged chunk
            (8, 257, 256, 2, 128, bf16), (4, 100, 256, 2, 128, f32),    # hd = 128
            (2, 130, 128, 1, 128, bf16),
            (8, 257, 768, 12, 64, bf16),                                # ViT-B width
            (32, 257, 384, 6, 64, f32),
            (256, 257, 384, 6, 64, bf16)]:                              # the flagship's served rows
        args, _ = _k5_case(b, n, d, heads, hd, dtype, seed=20)
    with torch.no_grad():
        served_ms = time_ms(lambda: fused_qkv_attention(*args, heads=6))
    log("qkv", f"K5 at the flagship's served rows (256, 257, 384) bf16: kernel {served_ms:.4f} ms "
               f"| {state['card']}")

    b, n, d = K5_SHAPE
    heads, hd = K5_HEADS, d // K5_HEADS
    args, err = _k5_case(b, n, d, heads, hd, bf16, seed=21)
    x, wq, wk, wv, bq, bk, bv = args
    # the yardstick's fused (3D, D) weight, made once outside the timed calls
    w_qkv = torch.cat([wq, wk, wv], dim=1).t().contiguous()
    b_qkv = torch.cat([bq, bk, bv])

    def two_calls():
        q, k, v = F.linear(x, w_qkv, b_qkv).reshape(b, n, 3, heads, hd).unbind(2)
        return F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v)))

    with torch.no_grad():
        lib_err = (two_calls().transpose(1, 2).reshape(b, n, d).float()
                   - qkv_attention_plain(*args, heads=heads).float()).abs().max().item()
        ms = time_ms(lambda: fused_qkv_attention(*args, heads=heads))
        plain_ms = time_ms(lambda: qkv_attention_plain(*args, heads=heads), iters=5)
        prod_ms = time_ms(lambda: ref_segment(*args, heads=heads, vmem=True))
        lib_ms = time_ms(two_calls)
    nbytes = 2 * (2 * b * n * d + 3 * d * d + 3 * d)
    flops = 3 * 2 * b * n * d * d + 4 * b * heads * n * n * hd
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    log("qkv", f"library F.linear (D, 3D) + SDPA vs plain: {lib_err:.3e}")
    log("qkv", f"K5 at {K5_SHAPE} bf16, {heads} heads: kernel {ms:.4f} ms | plain {plain_ms:.4f} "
               f"ms | production segment (3 x F.linear + K2) {prod_ms:.4f} ms | two library "
               f"calls (F.linear onto (D, 3D), then SDPA) {lib_ms:.4f} ms | bound {b_ms:.4f} ms "
               f"({b_by}) | {state['card']}")
    state["kernels"]["fused_qkv_attention"] = {
        "name": "fused_qkv_attention", "route": "cuda",
        "source": "irw_tpu_torch/csrc/qkv_attention.cu",
        "replaces": "benchmarks/vmem_qkv_micro.py:82", "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "library_calls": 2, "prod_segment_ms": prod_ms,
        "served_rows_ms": served_ms}


def phase_qkv_micro(state):
    """The two attention-segment micro-benchmarks at their full default
    widths, through their ``run()`` entry points: K5's main path."""
    from irw_tpu_torch.benchmarks import WARMUP, vmem_attn_micro, vmem_qkv_micro

    kernels = _kernel_wrappers()
    iters = 50
    calls = WARMUP + iters + 1   # one comparison call, then a warmed-up timed window

    for fn in kernels:
        fn.launches = 0
    res = vmem_qkv_micro.run(iters=iters)
    counts = _launch_counts(kernels)
    state["launches"]["qkv_micro"] = counts
    print(json.dumps(res), flush=True)
    log("qkv_micro", f"vmem_qkv_micro launches: {counts} | {state['card']}")
    want = dict.fromkeys(counts, 0) | {"fused_qkv_attention": calls, "fused_attention": calls}
    if counts != want:
        raise AssertionError(f"vmem_qkv_micro: expected launches {want}, got {counts}")
    if res["shape"] != [192, 257, 6, 64] or not res["fwd_maxdiff_vs_prod"] <= MICRO_FWD_TOL:
        raise AssertionError(f"vmem_qkv_micro: K5 is {res['fwd_maxdiff_vs_prod']} from the "
                             f"production segment (limit {MICRO_FWD_TOL}) at {res['shape']}")

    for fn in kernels:
        fn.launches = 0
    res = vmem_attn_micro.run(iters=iters)
    counts = _launch_counts(kernels)
    state["launches"]["attn_micro"] = counts
    print(json.dumps(res), flush=True)
    log("qkv_micro", f"vmem_attn_micro launches: {counts} | {state['card']}")
    # K2: the forward window and the forward-backward window, and one
    # comparison call before each; K3: the forward-backward window and its call
    want = dict.fromkeys(counts, 0) | {"fused_attention": 2 * calls, "fused_attention_bwd": calls}
    if counts != want:
        raise AssertionError(f"vmem_attn_micro: expected launches {want}, got {counts}")
    if not (res["shape"] == [192, 257, 6, 64] and res["fwd_maxdiff"] <= MICRO_FWD_TOL
            and res["grad_maxdiff"] <= MICRO_GRAD_TOL):
        raise AssertionError(f"vmem_attn_micro: fwd_maxdiff {res['fwd_maxdiff']} (limit "
                             f"{MICRO_FWD_TOL}), grad_maxdiff {res['grad_maxdiff']} (limit "
                             f"{MICRO_GRAD_TOL})")


def _serve_variant(state, label, model, batches, ref_logits, expected):
    """VARIANT_BATCHES timed batches through ``model``; launches per batch
    must equal ``expected``; with ``ref_logits`` the codes must agree with the
    default route's wherever |logit| > LOGIT_MARGIN.  Returns the logits."""
    import torch

    from irw_tpu_torch.transforms import DeviceTransform

    transform = DeviceTransform(SWT_OPS)
    kernels = _kernel_wrappers()
    with torch.inference_mode():
        model(transform(batches[0]))  # warm-up
        torch.cuda.synchronize()
        for fn in kernels:
            fn.launches = 0
        logits, per_batch = [], []
        t0 = time.perf_counter()
        for images in batches:
            before = [fn.launches for fn in kernels]
            logits.append(model.forward_logits(transform(images))[0])
            per_batch.append(tuple(fn.launches - b for fn, b in zip(kernels, before)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    _check_launches("variants", per_batch, expected, f"batch, {label}")
    log("variants", f"{label}: {len(batches) * BATCH / seconds:.1f} img/s, "
                    f"{seconds / len(batches) * 1e3:.1f} ms per batch (batch {BATCH}, bf16) | "
                    f"{state['card']}")
    for i, (ours, ref) in enumerate(zip(logits, ref_logits or [])):
        if not (torch.isfinite(ours).all() and ours.shape == (BATCH, 64)):
            raise AssertionError(f"{label}, batch {i}: logits not finite / wrong shape")
        sure = ref.abs() > LOGIT_MARGIN
        n_sure = int(sure.sum())
        n_differ = int(((torch.sign(ours) != torch.sign(ref)) & sure).sum())
        log("variants", f"{label}, batch {i}: max|logit - default route| = "
                        f"{(ours - ref).abs().max().item():.3e}; codes differ at {n_differ} of the "
                        f"{n_sure}/{sure.numel()} bits with |logit| > {LOGIT_MARGIN}")
        if n_differ or 2 * n_sure < sure.numel():
            raise AssertionError(f"{label}, batch {i}: codes disagree with the default route")
    return logits


def _ln_train_steps(state, vit_kwargs, batches):
    """LN_TRAIN_STEPS steps of the flagship with ``vit_kwargs`` from seed 0;
    returns each step's metrics, the mean ms of the steps after the first
    and the path's own peak memory."""
    import torch

    from irw_tpu_torch.engine import build_train_step, init_train_state
    from irw_tpu_torch.engine.train import _build_hyper
    from irw_tpu_torch.losses import build_losses
    from irw_tpu_torch.transforms import DeviceTransform

    held = _release_earlier_phases(state)
    model = _flagship_model(vit_kwargs)
    _check_cores(model, "vmem_attention_fn")
    tstate = init_train_state(model, build_losses(HASH_LOSS), OPTIMIZER, HASH_LOSS, seed=0)
    step = build_train_step(DeviceTransform(SWT_OPS), clip_grad=PROTOCOL["clip_grad"],
                            proxy_map_metric="hamming")
    kernels = _kernel_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, per_step, t_after_first = [], [], None
    for i in range(LN_TRAIN_STEPS):
        for fn in kernels:
            fn.launches = 0
        hyper = _build_hyper(tstate.optimizer_entries, 1, tstate.step, PROTOCOL["warm_up"], None,
                             PROTOCOL["ortho_scale"])
        metrics.append({k: float(v) for k, v in step(tstate, batches[i % 2], hyper).items()})
        per_step.append(tuple(fn.launches for fn in kernels))
        if i == 0:
            torch.cuda.synchronize()
            t_after_first = time.perf_counter()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_after_first) / (LN_TRAIN_STEPS - 1) * 1e3
    peak = torch.cuda.max_memory_allocated() - held
    what = "ln_fused" if vit_kwargs else "plain LayerNorm"
    _check_launches("variants", per_step, (1, 24, 12, 0, 0, 0, 0), f"train step, {what}")
    for i, m in enumerate(metrics):
        log("variants", f"train, {what}, step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in m.items()))
        if not all(math.isfinite(m[k]) for k in TRAIN_METRICS):
            raise AssertionError(f"train, {what}, step {i}: non-finite metrics {m}")
    log("variants", f"train, {what}: {step_ms:.1f} ms per step after the first (batch "
                    f"{TRAIN_BATCH}, K2/K3 route, block remat) | the path's own peak memory "
                    f"{peak / 2 ** 30:.2f} GiB | {state['card']}")
    return metrics, peak


def phase_variants(state):
    """The ViT Block variants at full width: served against the default
    route, the frozen flagship's A/B sweep, and training with ``ln_fused``."""
    from irw_tpu_torch.benchmarks import infer_vmem_ab
    from irw_tpu_torch.data import SyntheticVOCDataset

    _release_earlier_phases(state)
    ds = SyntheticVOCDataset(num_train=BATCH * VARIANT_BATCHES, image_size=224, seed=6)
    batches = [ds.images[i * BATCH:(i + 1) * BATCH] for i in range(VARIANT_BATCHES)]
    model = _flagship_model()
    _check_cores(model, "vmem_attention_fn")
    weights = model.state_dict()
    ref = _serve_variant(state, "default route (vmem_attn)", model, batches, None,
                         (1, 12, 0, 0, 0, 0, 0))
    # fused_qkv and split_cls are routed before the MHA route, so the factory's
    # vmem_attn does not reach a kernel there; none of them launches K5
    for label, flags, expected in (
            ("fused_qkv", {"fused_qkv": True}, (1, 0, 0, 0, 0, 0, 0)),
            ("split_cls", {"split_cls": True}, (1, 0, 0, 0, 0, 0, 0)),
            ("vmem_attn + ln_fused", {"ln_fused": True}, (1, 12, 0, 0, 0, 0, 0))):
        del model
        model = _flagship_model(flags)
        model.load_state_dict(weights)  # the same parameter tree for every variant
        _serve_variant(state, label, model, batches, ref, expected)
    del model, weights, ref

    _release_earlier_phases(state)
    for res in infer_vmem_ab.run(batches=(48, 64, 96)):
        print(json.dumps(res), flush=True)
        if not (res["ips"] > 0 and res["mfu"] is not None and 0 < res["mfu"] < 1):
            raise AssertionError(f"infer_vmem_ab gave {res}")

    tds = SyntheticVOCDataset(num_train=TRAIN_BATCH * 2, image_size=224, seed=3)
    tbatches = [{"image": tds.images[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                 "label": tds.labels[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]} for i in range(2)]
    plain, plain_peak = _ln_train_steps(state, None, tbatches)
    fused, fused_peak = _ln_train_steps(state, {"ln_fused": True}, tbatches)
    rels = [abs(f["total_loss"] - p["total_loss"]) / abs(p["total_loss"])
            for f, p in zip(fused, plain)]
    log("variants", "train, ln_fused against the plain LayerNorm: total_loss relative "
                    + ", ".join(f"step {i} {r:.2e}" for i, r in enumerate(rels))
                    + f" (limit {LN_LOSS_TOL} at step 0, from identical weights); peak memory "
                      f"{fused_peak / 2 ** 30:.2f} against {plain_peak / 2 ** 30:.2f} GiB")
    if not rels[0] <= LN_LOSS_TOL:
        raise AssertionError(f"ln_fused moves the first step's loss by {rels[0]}")
    _release_earlier_phases(state)


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

    state = {"kernels": {}, "card": None, "launches": {}}
    phase_card(state)
    runners = {"build": phase_build, "swt": phase_swt, "attention": phase_attention,
               "serve": phase_serve, "profile": phase_profile, "retrieval": phase_retrieval,
               "train": phase_train, "dwt": phase_dwt, "wcnn": phase_wcnn, "flash": phase_flash,
               "flash_serve": phase_flash_serve, "flash_train": phase_flash_train,
               "qkv": phase_qkv, "qkv_micro": phase_qkv_micro, "variants": phase_variants}
    for name in phases:
        if name != "card":
            t0 = time.perf_counter()
            runners[name](state)
            log(name, f"phase done in {time.perf_counter() - t0:.1f} s")

    # launches: the count over the run of the path that runs the kernel (the
    # train phases' timed steps for K1-K3 and K6, the wcnn phase's batches for
    # K4, the qkv micro-benchmark's run for K5); per train step and per served
    # batch of each path beside it
    runs = state["launches"]
    main_paths = {"lifting_multi_level": "wcnn", "flash_attention_fwd": "flash_train",
                  "flash_attention_bwd": "flash_train", "fused_qkv_attention": "qkv_micro"}
    trained = {"flagship": ("train", TRAIN_STEPS), "flash": ("flash_train", TRAIN_STEPS)}
    served = {"flagship": ("serve", SERVE_BATCHES), "wcnn": ("wcnn", WCNN_BATCHES),
              "flash": ("flash_serve", SERVE_BATCHES)}

    def per_run(paths, name):
        return {path: runs[key].get(name, 0) / n for path, (key, n) in paths.items() if key in runs}

    kernels = []
    for k in state["kernels"].values():
        main_path = runs.get(main_paths.get(k["name"], "train"), {})
        kernels.append(dict(k, launches=main_path.get(k["name"]),
                            launches_per_train_step=per_run(trained, k["name"]),
                            launches_per_served_batch=per_run(served, k["name"])))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
