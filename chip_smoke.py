#!/usr/bin/env python3
"""Smoke test of irw_tpu_torch on one CUDA card (built for an H100, sm_90a).

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases card,build,attention,train
    python3 chip_smoke.py --phases card,build,loop
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
4. attention: K2 against ``attention_plain`` and K3 against
   ``attention_plain_bwd`` from N = 1 to 577 (the ViT at 336²), head dims
   32, 64 and 128, bf16 and f32, strided views: both the plane and the
   tiled path of each; K3 fed K2's saved row statistics against the
   standalone K3, bit for bit; K2 timed at (192 | 256 | 384, 257, 6, 64) and
   K3 at (384, 257, 6, 64) bf16, beside SDPA and their bounds;
5. serve: full-width flagship with seeded random weights (LayerScale set to
   1 so attention reaches the codes), 3 warm-up batches, then img/s over 20
   batches in one synchronised window, launch counts per batch, codes held
   against the same model on the plain versions;
6. profile: one served batch under torch.profiler, device time by kernel
   group and the device's idle share;
7. retrieval: ``evaluate`` on a few hundred images, GPU metrics against the
   CPU port, and bench.py's VOC anchor (map 0.3865 at k = 5717);
8. train: the full-width flagship trains at batch 96 (HashLoss,
   ``configs/optimizer/basic.yaml``'s AdamW at epoch 1): 3 warm-up steps,
   then trained img/s over one synchronised window of 20 steps (each step's
   time between CUDA events beside it), launch counts per step, the path's
   own peak memory and finite metrics;
   one step on the kernel route held against the plain route (loss, and
   the gradient of each top-level module); one step profiled;
9. loop: the flagship study's epoch loop (``engine.train``) at full width:
   2 epochs of 4 steps at batch 96 with ``memory=voc``'s XBM on 480
   synthetic VOC train images, a Hamming eval of 384 queries against them
   at epoch 2, async rolling checkpoints every epoch and ``epoch_N`` at
   each; launches per train step and per eval batch, each epoch's trained
   img/s, the eval, save and load seconds, the checkpoint's bytes, the
   peak memory, finite metrics, the XBM's slots; then a fresh state resumed
   from ``epoch_1`` (restored bit for bit) trains epoch 2 again, held to
   the uninterrupted run;
10. dwt: K4 against ``lifting_multi_level_plain`` for haar at levels 1-3 at
   the served shape (192, 224, 224), cdf97 at (192, 448, 448), bior48 and
   daub4 at level 2, and a ragged batch of non-square planes, logging the
   path each case took (register or tile: one launch) and requiring the one
   ``lifting_kernel_variants`` names; cdf97 at level 5 on (192, 256, 256),
   which must take the two-pass path (two kernels a level); timed over CUDA
   events, with L2 flushed before each call, as device time and as the
   host's issue time, beside the ``conv2d`` that computes haar level 1, and
   cdf97 beside one ``conv2d`` of the 9 x 9 analysis filters at stride 2
   (both also as device time);
11. wcnn: the full-width WCNN-attention model serves batches of 64: launch
   counts per batch, embeddings held against the same model with K4's
   plain version, img/s, peak memory, one batch profiled; then ``evaluate``
   (cosine) on a CUB-test-sized synthetic set (5794 images, 100 classes);
12. flash: K6-fwd (o, l, m) and K6-bwd against ``flash_attention_plain``
   and ``flash_attention_plain_bwd`` over the kernels' surface (N from 1 to
   577 through the one-step boundary 128/129, head dims 32, 64 and 128,
   bf16 and f32, the strided views of one fused projection, the backward
   fed the kernel forward's o, l, m), logging the path each took and
   requiring both the plane and the tiled path of each; then at the served
   shape (256, 257, 6, 64) and the training shape (384, 257, 6, 64) bf16
   on the fused views, as the path gives them, and at larger f32 shapes;
   K6-fwd timed at the served shape and, with l and m, at the training
   shape, K6-bwd at the training shape, each beside SDPA at that shape;
13. flash_serve: the full-width flagship with ``use_flash`` serves batches
   of 64 (launch counts, codes against the plain route, img/s), one batch
   profiled;
14. flash_train: the same model trains at batch 96 (launch counts per step,
   the kernel route against the plain route, trained img/s, peak memory),
   one step profiled;
15. qkv: K5's kernels with their registers and spills from the build; K5
   against ``qkv_attention_plain`` over its surface (N = 1 to 289, one past
   the bf16 plane path's 288, head dims 32, 64 and 128, D = 64 to 768 with
   a ragged 96, bf16, and f32 at N = 37 and 257), logging the path each case
   took and requiring the one ``qkv_kernel_variants`` names; then at the
   micro-benchmark's default (192, 257, 384) bf16 with 6 heads, at the
   flagship's served rows (256, 257, 384), in f32, at head dims 32 (a scale
   that is no power of two) and 128, at N = 37, at D = 96 (a ragged last
   chunk) and at D = 768 with 12 heads; timed at both bf16 shapes beside
   the production segment (three ``F.linear`` + K2), the two-call yardstick
   (one ``F.linear`` onto (D, 3D), then SDPA) and the bound, and at the
   default shape beside its plain version;
16. qkv_micro: ``irw_tpu_torch.benchmarks.vmem_qkv_micro.run()`` and
   ``vmem_attn_micro.run()`` at their full default widths: their JSON, their
   maxdiffs against stated limits, and the launches of K5, K2 and K3;
17. variants: the full-width flagship served with ``fused_qkv``, with
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

PHASES = ("card", "build", "swt", "attention", "serve", "profile", "retrieval", "train", "loop",
          "dwt", "wcnn", "flash", "flash_serve", "flash_train", "qkv", "qkv_micro", "variants")

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
# configs/memory/voc.yaml; tests/test_torch_loop.py holds this dict to the file
MEMORY = {"name": "XBM", "kwargs": {"size": 5717, "weight": 1.0, "activate_after": 1,
                                    "unique": True}}
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
# the serve and train windows: warm-up calls, then timed ones over one
# synchronised window on the host clock (more calls, less noise); the served
# batches cycle through SERVE_DISTINCT images sets, each held against the
# plain route
WARMUP_CALLS = 3
SERVE_BATCHES = 20
SERVE_DISTINCT = 4
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
# K2's row statistics against the plain f32 softmax's: the same f32 math over
# scores summed in another order (m absolute, l relative)
STATS_TOL = 1e-4
TRAIN_STEPS = 20
TRAIN_METRICS = ("total_loss", "grad_norm", "batch_map", "loss_0_HashLoss", "ortho_raw")
# the same step with every block's attention on the plain versions: the two
# routes round P and ds alike, so the loss and the gradients differ only by
# f32 accumulation order carried through twelve bf16 blocks
ROUTE_LOSS_TOL = 1e-3
ROUTE_COSINE = 0.999
LOGIT_MARGIN = 0.05     # codes must agree wherever |logit| exceeds this
# the loop phase: the study's protocol (studies/voc_lambda_protocol.yaml) cut
# to 2 epochs of 4 steps on a reduced synthetic VOC (train == gallery, a
# disjoint query set), eval at the last epoch, a rolling save every epoch
LOOP_TRAIN, LOOP_QUERY = 480, 384
LOOP_EPOCHS, LOOP_STEPS = 2, 4
LOOP = {"experience": {
    "max_iter": LOOP_EPOCHS, "step_per_epoch": LOOP_STEPS, "seed": 0, "num_workers": 8,
    "train_eval_freq": -1, "test_eval_freq": 2, "eval_split": "test",
    "principal_metric": "map_level0", "eval_bs": 1000,
    "evaluation": {"top_k": LOOP_TRAIN, "distance_metric": "hamming"},
    "checkpoint_freq": 1, "async_checkpoint": True, "save_model": 1,
    "sub_batch": TRAIN_BATCH, **PROTOCOL}}
LOOP_EVAL_BATCHES = 2   # the query set and the gallery, each one padded batch of eval_bs
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
# the saved statistics against the plain forward's: l relative, m absolute
# (plus 1e-5 of |m|: the same f32 scores summed in another order)
K6_STATS_TOL = 1e-5
K6_M_TOL = 1e-6
# K6 over its surface (B = 2, H = 3): one row to the ViT's 577 at 336²;
# 128 and 129 are the one-step boundary and a last block with one valid key
K6_SURFACE_N = (1, 37, 64, 65, 127, 128, 129, 256, 257, 577)
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
# K5's surface: N from one row to one past the bf16 plane path's N <= 288,
# through 64/65 and 128; D from one 64-column chunk to ViT-B's 768, with a
# ragged 96
K5_SURFACE_N = (1, 16, 37, 64, 65, 128, 257, 288, 289)
K5_SURFACE_D = (64, 96, 384, 768)
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


def time_ms_cold(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` with L2 flushed before each call: a 64 MB scratch
    write (more than the H100's 50 MB L2), then the call between its own
    CUDA events."""
    import torch

    scratch = torch.empty(16 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        scratch.fill_(1.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: each call between its own CUDA
    events, queued behind a sleep kernel of about 1 ms, so the host has
    issued the whole call before the card reaches it and the events time the
    card alone (what the host spends issuing the call is hidden)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def host_ms(fn, calls: int = 20) -> float:
    """Host time to issue one call of ``fn``, the card kept busy ahead of it:
    it bounds ``time_ms`` from below where it exceeds the device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def k4_times(fn) -> dict:
    """K4's timings of one case: over CUDA events (``ms``), with L2 flushed
    (``cold_ms``), device time (``device_ms``) and the host's issue time
    (``host_ms``)."""
    return {"ms": time_ms(fn), "cold_ms": time_ms_cold(fn), "device_ms": device_ms(fn),
            "host_ms": host_ms(fn)}


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
    """``name<HD>`` (``name<L, C>``) of a mangled kernel template instance:
    walk the nested name's length-prefixed parts to the one ending in
    ``kernel``, then read its int template arguments."""
    pos = 3 if mangled.startswith("_ZN") else 2
    while (m := re.match(r"\d+", mangled[pos:])):
        start = pos + m.end()
        pos = start + int(m.group())
        ident = mangled[start:pos]
        if ident.endswith("kernel"):
            args = re.match(r"I((?:Li\d+E)+)E", mangled[pos:])
            return ident + (f"<{', '.join(re.findall(r'Li(\d+)E', args.group(1)))}>"
                            if args else "")
    return mangled


def phase_build(state):
    from irw_tpu_torch import cuda_lib

    t0 = time.perf_counter()
    report = cuda_lib.build(cuda_lib.KERNELS)
    wall = time.perf_counter() - t0
    state["ptxas"] = {name: rep["ptxas"] for name, rep in report.items()}
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


def _attention_case(shape, dtype, seed, variants=None, strided=False):
    """K2 against ``attention_plain`` on unit-normal q, k, v (with
    ``strided`` the views of one (…, N, 3, H, hd) projection); the kernel
    variant it ran is added to ``variants``."""
    import torch

    from irw_tpu_torch.ops.attention import attention_plain, fused_attention, kernel_variants

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _qkv(shape, dtype, gen, strided)
    with torch.no_grad():
        out = fused_attention(q, k, v)
        ref = attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = K2_TOL[str(dtype).removeprefix("torch.")]
    variant = kernel_variants(shape[-3], shape[-1], dtype)["fwd"]
    if variants is not None:
        variants.add(variant)
    log("attention", f"K2 {tuple(shape)} {dtype}{' strided' if strided else ''} ({variant}): "
                     f"max|kernel - plain| = {err:.3e} (limit {tol:.3e}, max|o| "
                     f"{ref.float().abs().max().item():.3f})")
    if not (err <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"K2 disagrees with its plain version at {shape} {dtype}: {err}")
    return (q, k, v), err


def _attention_bwd_case(shape, dtype, seed, variants=None):
    """K3 against ``attention_plain_bwd`` on unit-normal q, k, v, g; then the
    route autograd takes (K2's saved statistics, read by K3) against the
    standalone K3, which computes them itself: the same bits, and K2's
    statistics against the plain ones.  Returns the inputs and the largest
    error over dq, dk, dv relative to each output's limit."""
    import torch

    from irw_tpu_torch.ops.attention import (
        _forward,
        attention_plain,
        attention_plain_bwd,
        fused_attention_bwd,
        kernel_variants,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    outs = fused_attention_bwd(q, k, v, g)
    refs = attention_plain_bwd(q, k, v, g)
    scale = 1.0 / math.sqrt(shape[-1])
    with torch.no_grad():
        _, stats = _forward(q, k, v, scale, with_stats=True)
        _, ref_stats = attention_plain(q, k, v, with_stats=True)
    saved = fused_attention_bwd(q, k, v, g, stats=stats)
    torch.cuda.synchronize()
    variant = kernel_variants(shape[-3], shape[-1], dtype)["bwd"]
    if variants is not None:
        variants.add(variant)
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
    same = all(torch.equal(a, b) for a, b in zip(saved, outs))
    m_err = (stats[0] - ref_stats[0]).abs().max().item()
    l_err = ((stats[1] - ref_stats[1]).abs() / ref_stats[1]).max().item()
    log("attention", f"K3 {tuple(shape)} {dtype} ({variant}): max|kernel - plain| "
                     + ", ".join(report) + f"; with K2's saved statistics: "
                     f"{'the same bits' if same else 'DIFFERENT bits'}; K2's m {m_err:.2e}, "
                     f"l {l_err:.2e} relative from the plain statistics (limit {STATS_TOL})")
    if not (same and m_err <= STATS_TOL and l_err <= STATS_TOL):
        raise AssertionError(f"K3 at {shape} {dtype}: the saved-statistics route differs from "
                             f"the standalone K3 ({same}) or K2's statistics from the plain "
                             f"ones (m {m_err}, l {l_err})")
    return (q, k, v, g), worst


def _attention_bound(shape, tensors: int, products: int, stats: bool):
    """The bf16 bound of attention at ``shape``: ``tensors`` (B, N, H, hd)
    tensors read or written once, the f32 row statistics with ``stats``,
    and ``products`` (B H N² hd)-sized products of two flops a term."""
    b, n, h, hd = shape
    nbytes = tensors * b * n * h * hd * 2 + (2 * b * h * n * 4 if stats else 0)
    return bound_ms(nbytes, 2 * products * b * h * n * n * hd, "bfloat16")


def phase_attention(state):
    import torch
    import torch.nn.functional as F

    from irw_tpu_torch.ops.attention import (
        _forward,
        attention_plain,
        attention_plain_bwd,
        fused_attention,
        fused_attention_bwd,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    bf16, f32 = torch.bfloat16, torch.float32
    fwd_variants, bwd_variants = set(), set()
    # N = 1, 50, 64, 65, 257 and 577 (the ViT at 336²), hd 32, 64 and 128: the
    # plane path, and the tiled one past its shared memory (hd 128 at N = 577)
    for shape, dtype in [((3, 50, 2, 64), bf16), ((3, 50, 2, 64), f32), ((2, 70, 3, 32), f32),
                         ((2, 130, 1, 128), bf16), ((64, 257, 6, 64), f32), ((5, 1, 2, 64), bf16),
                         ((4, 64, 2, 32), bf16), ((4, 65, 2, 64), bf16), ((8, 257, 6, 128), bf16),
                         ((8, 577, 6, 64), bf16), ((4, 577, 2, 128), bf16), ((2, 577, 2, 32), f32)]:
        _attention_case(shape, dtype, seed=2, variants=fwd_variants)
    _attention_case((16, 257, 6, 64), bf16, seed=3, variants=fwd_variants, strided=True)
    (q, k, v), err = _attention_case(K2_SHAPE, bf16, seed=1, variants=fwd_variants)
    if fwd_variants != {"plane", "tiled"}:
        raise AssertionError(f"K2's cases ran {fwd_variants}, not both paths")
    with torch.no_grad():
        plain_ms = time_ms(lambda: attention_plain(q, k, v))
    # the served shapes (batches of 48 and 64, bands 4) and the training one
    k2_ms = {}
    for rows in (192, 256, 384):
        shape = (rows, 257, 6, 64)
        gen = torch.Generator(device="cuda").manual_seed(rows)
        qs, ks, vs = _qkv(shape, bf16, gen, False)
        qt, kt, vt = (t.transpose(1, 2) for t in (qs, ks, vs))   # SDPA's (B, H, N, hd)
        with torch.no_grad():
            ms = time_ms(lambda: fused_attention(qs, ks, vs))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
            stats_ms = time_ms(lambda: _forward(qs, ks, vs, 0.125, with_stats=True))
        b_ms, b_by = _attention_bound(shape, 4, 2, False)
        k2_ms[rows] = (ms, lib_ms, b_ms, b_by)
        log("attention", f"K2 at {shape} bf16: kernel {ms:.4f} ms | with row statistics "
                         f"{stats_ms:.4f} ms | SDPA {lib_ms:.4f} ms | bound {b_ms:.4f} ms "
                         f"({b_by}) | {state['card']}")
    ms, lib_ms, b_ms, b_by = k2_ms[K2_SHAPE[0]]
    log("attention", f"K2 at the serve shape {K2_SHAPE}: kernel {ms:.4f} ms | plain "
                     f"{plain_ms:.4f} ms | SDPA {lib_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by}) "
                     f"| {state['card']}")
    state["kernels"]["fused_attention"] = {
        "name": "fused_attention", "route": "cuda",
        "source": "irw_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "irw_tpu/ops/vmem_attention.py:207", "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "ms_by_rows": {r: t[0] for r, t in k2_ms.items()},
        "library_ms_by_rows": {r: t[1] for r, t in k2_ms.items()}}

    # K3: N = 1 to 577, hd 32 to 128, both paths, each with the saved-statistics route
    for shape, dtype in [((3, 50, 2, 64), bf16), ((3, 50, 2, 64), f32), ((2, 70, 3, 32), f32),
                         ((2, 70, 3, 32), bf16), ((2, 130, 1, 128), bf16), ((2, 130, 1, 128), f32),
                         ((2, 3, 65, 1, 64), f32), ((64, 257, 6, 64), f32), ((5, 1, 2, 64), bf16),
                         ((4, 64, 2, 64), bf16), ((4, 65, 2, 32), bf16), ((4, 272, 2, 64), bf16),
                         ((4, 273, 2, 64), bf16), ((8, 257, 6, 128), bf16),
                         ((8, 577, 6, 64), bf16), ((2, 577, 2, 128), bf16)]:
        _attention_bwd_case(shape, dtype, seed=3, variants=bwd_variants)
    (q, k, v, g), err = _attention_bwd_case(K3_SHAPE, bf16, seed=4, variants=bwd_variants)
    if bwd_variants != {"plane", "tiled"}:
        raise AssertionError(f"K3's cases ran {bwd_variants}, not both paths")
    qt, kt, vt, gt = (t.transpose(1, 2) for t in (q, k, v, g))
    with torch.no_grad():
        _, stats = _forward(q, k, v, 0.125, with_stats=True)
    ms = time_ms(lambda: fused_attention_bwd(q, k, v, g))
    saved_ms = time_ms(lambda: fused_attention_bwd(q, k, v, g, stats=stats))
    plain_ms = time_ms(lambda: attention_plain_bwd(q, k, v, g), iters=5)
    qr, kr, vr = (t.detach().requires_grad_() for t in (qt, kt, vt))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qr, kr, vr)
        torch.autograd.grad(out, (qr, kr, vr), gt)

    with torch.no_grad():
        sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qr, kr, vr))
    lib_ms = time_ms(sdpa_fwd_bwd) - sdpa_fwd_ms
    b_ms, b_by = _attention_bound(K3_SHAPE, 7, 5, False)
    saved_b_ms, saved_b_by = _attention_bound(K3_SHAPE, 7, 5, True)
    log("attention", f"K3 at {K3_SHAPE}: kernel {ms:.4f} ms standalone (statistics computed), "
                     f"{saved_ms:.4f} ms with K2's saved statistics (bound {saved_b_ms:.4f} ms, "
                     f"{saved_b_by}) | plain {plain_ms:.4f} ms | SDPA backward {lib_ms:.4f} ms "
                     f"(fwd+bwd minus fwd {sdpa_fwd_ms:.4f}) | bound {b_ms:.4f} ms ({b_by}) | "
                     f"{state['card']}")
    # the kernels line: the call the training path makes, with K2's statistics
    state["kernels"]["fused_attention_bwd"] = {
        "name": "fused_attention_bwd", "route": "cuda",
        "source": "irw_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "irw_tpu/ops/vmem_attention.py:227", "max_abs_err": err,
        "ms": saved_ms, "plain_ms": plain_ms, "bound_ms": saved_b_ms, "bound_by": saved_b_by,
        "library_ms": lib_ms, "standalone_ms": ms, "standalone_bound_ms": b_ms}


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
    """WARMUP_CALLS batches, then SERVE_BATCHES timed ones of BATCH (cycling
    SERVE_DISTINCT image sets) through the flagship ``model``: the launches
    of every kernel per batch must equal ``expected``; then the codes of
    each image set are held against the same weights with every block's
    attention core set to ``plain_core`` and K1's plain version, on the card.  Peak
    memory is counted above the ``held`` bytes allocated before the model
    was built."""
    import torch

    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.ops.wavelets import haar_swt2_plain
    from irw_tpu_torch.transforms import DeviceTransform

    vit = model.backbone.vit
    transform = DeviceTransform(SWT_OPS)
    ds = SyntheticVOCDataset(num_train=BATCH * SERVE_DISTINCT, image_size=224, seed=0)
    distinct = [ds.images[i * BATCH:(i + 1) * BATCH] for i in range(SERVE_DISTINCT)]

    kernels = _kernel_wrappers()
    with torch.inference_mode():
        for i in range(WARMUP_CALLS):  # cuBLAS handles, allocator
            model(transform(distinct[i % SERVE_DISTINCT]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        outs, per_batch = [], []
        t0 = time.perf_counter()
        for i in range(SERVE_BATCHES):
            images = distinct[i % SERVE_DISTINCT]
            before = [fn.launches for fn in kernels]
            bands = transform(images)
            logits, aux = model.forward_logits(bands)
            if i < SERVE_DISTINCT:
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
    """The flagship ``model`` trains: WARMUP_CALLS steps, then TRAIN_STEPS
    AdamW steps at batch 96, trained img/s over the whole window to a
    synchronize (each step's time between CUDA events beside it), whose launches of every kernel per step
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

    for i in range(WARMUP_CALLS):  # cuBLAS handles, allocator, build
        step(tstate, batches[i % 2], hyper())
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


class _UnitLaunches:
    """The device transform the loop runs, wrapped: each call starts a unit
    of work (a train step, or under inference mode an eval batch) and notes
    every kernel's launch count, so a unit's launches are the counts at the
    next call (or at the end) less its own."""

    def __init__(self, transform, kernels):
        self.transform, self.kernels, self.marks = transform, kernels, []

    def __call__(self, images):
        import torch

        self.marks.append((torch.is_inference_mode_enabled(),
                           [fn.launches for fn in self.kernels]))
        return self.transform(images)

    def units(self, evaluating: bool) -> list:
        ends = [counts for _, counts in self.marks[1:]] + [[fn.launches for fn in self.kernels]]
        return [tuple(e - s for e, s in zip(end, start))
                for (inference, start), end in zip(self.marks, ends) if inference == evaluating]


def _payload_differences(saved, restored, path="state") -> list:
    """Every leaf of two checkpoint payloads that differs (tensors bit for
    bit, with dtype and shape), as its path."""
    import torch

    if torch.is_tensor(saved):
        same = (torch.is_tensor(restored) and saved.dtype == restored.dtype
                and saved.shape == restored.shape and torch.equal(saved, restored))
        return [] if same else [path]
    if isinstance(saved, dict):
        if not isinstance(restored, dict) or saved.keys() != restored.keys():
            return [path]
        return [d for k in saved for d in _payload_differences(saved[k], restored[k],
                                                                f"{path}.{k}")]
    if isinstance(saved, (list, tuple)):
        if not isinstance(restored, (list, tuple)) or len(saved) != len(restored):
            return [path]
        return [d for i, (a, b) in enumerate(zip(saved, restored))
                for d in _payload_differences(a, b, f"{path}[{i}]")]
    return [] if saved == restored else [path]


def _jsonl(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_loop(state):
    """The flagship study's epoch loop at full width (``engine.train``):
    LOOP_EPOCHS epochs of LOOP_STEPS steps at batch 96 with ``memory=voc``'s
    XBM, one Hamming eval of LOOP_QUERY queries against the LOOP_TRAIN
    train images at the last epoch, async rolling checkpoints every epoch
    and ``epoch_N`` at each; then a fresh state resumed from ``epoch_1``
    trains epoch 2 again and is held to the uninterrupted run."""
    import logging
    import os
    import shutil
    import tempfile

    import torch

    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.engine import (get_memory, init_train_state, load_checkpoint,
                                      restore_train_state, train)
    from irw_tpu_torch.engine.checkpoint import train_state_payload
    from irw_tpu_torch.losses import build_losses
    from irw_tpu_torch.samplers import RandomSampler
    from irw_tpu_torch.transforms import DeviceTransform

    held = _release_earlier_phases(state)
    exp = LOOP["experience"]
    t0 = time.perf_counter()
    train_ds = SyntheticVOCDataset(num_train=LOOP_TRAIN, image_size=224)
    query = SyntheticVOCDataset(mode="query", num_query=LOOP_QUERY, image_size=224)
    splits = {"test": {"query": query, "gallery": train_ds}}
    log("loop", f"{LOOP_TRAIN} train and {LOOP_QUERY} query images at 224² made in "
                f"{time.perf_counter() - t0:.1f} s")

    def fresh_state(seed):
        model = _flagship_model()
        _check_cores(model, "vmem_attention_fn")
        memory = get_memory(MEMORY, 64, train_ds.labels.shape[1:])
        return init_train_state(model, build_losses(HASH_LOSS), OPTIMIZER, HASH_LOSS,
                                seed=seed, xbm=memory)

    saves = []

    class SaveLog(logging.Handler):
        def emit(self, record):
            if hasattr(record, "checkpoint"):
                saves.append(record.checkpoint)

    ckpt_logger = logging.getLogger("irw_tpu_torch.engine.checkpoint")
    handler, level = SaveLog(), ckpt_logger.level
    ckpt_logger.addHandler(handler)
    ckpt_logger.setLevel(logging.INFO)
    root = tempfile.mkdtemp(prefix="irw_loop_")
    try:
        full_dir, resumed_dir = os.path.join(root, "full"), os.path.join(root, "resumed")
        tstate = fresh_state(0)
        kernels = _kernel_wrappers()
        transform = _UnitLaunches(DeviceTransform(SWT_OPS), kernels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        _, evals = train(tstate, train_ds, RandomSampler(train_ds, TRAIN_BATCH, seed=0), splits,
                         None, transform, LOOP, full_dir)
        run_seconds = time.perf_counter() - t0
        counts = _launch_counts(kernels)
        peak = torch.cuda.max_memory_allocated() - held
        steps, batches = transform.units(False), transform.units(True)
        state["launches"]["loop"] = {fn.__name__: sum(u[i] for u in steps)
                                     for i, fn in enumerate(kernels)}
        state["launches"]["loop_eval"] = {fn.__name__: sum(u[i] for u in batches)
                                          for i, fn in enumerate(kernels)}
        log("loop", f"launches over the run: {counts}")
        if len(steps) != LOOP_EPOCHS * LOOP_STEPS or len(batches) != LOOP_EVAL_BATCHES:
            raise AssertionError(f"loop: {len(steps)} train steps and {len(batches)} eval "
                                 f"batches, expected {LOOP_EPOCHS * LOOP_STEPS} and "
                                 f"{LOOP_EVAL_BATCHES}")
        _check_launches("loop", steps, (1, 24, 12, 0, 0, 0, 0), "train step")
        _check_launches("loop", batches, (1, 12, 0, 0, 0, 0, 0), "eval batch")

        records = _jsonl(os.path.join(full_dir, "metrics.jsonl"))
        epochs = [r for r in records if "train/total_loss" in r]
        if [r["step"] for r in epochs] != list(range(1, LOOP_EPOCHS + 1)):
            raise AssertionError(f"loop: epoch records {[r['step'] for r in epochs]}")
        for r in epochs:
            ips = LOOP_STEPS * TRAIN_BATCH / r["train/train_seconds"]
            log("loop", f"epoch {r['step']}: {r['train/train_seconds']:.3f} s of training, "
                        f"{ips:.1f} trained img/s ({LOOP_STEPS} steps of {TRAIN_BATCH}; host "
                        f"{r['train/step_seconds']:.3f} s issuing steps, "
                        f"{r['train/data_seconds']:.4f} s in the loader) | {state['card']}")
            log("loop", f"epoch {r['step']} metrics: " + ", ".join(
                f"{k.removeprefix('train/')} {v:.6g}" for k, v in r.items()
                if k.startswith("train/") and not k.endswith("seconds")))
            if not all(math.isfinite(v) for v in r.values()):
                raise AssertionError(f"loop: non-finite epoch metrics {r}")
        evaluated = [r for r in records if "test/map_level0" in r]
        results = evals["test"]
        if ([r["step"] for r in evaluated] != [LOOP_EPOCHS]
                or not all(math.isfinite(v) for v in results.values())
                or not 0.0 <= results["map_level0"] <= 1.0):
            raise AssertionError(f"loop: eval records {evaluated}")
        log("loop", f"eval at epoch {LOOP_EPOCHS}: {evaluated[0]['test/eval_seconds']:.3f} s "
                    f"({LOOP_QUERY} queries against {LOOP_TRAIN}, eval_bs {exp['eval_bs']}, "
                    f"top_k {exp['evaluation']['top_k']}); map_level0 "
                    f"{results['map_level0']:.4f} | {state['card']}")
        for s in saves:
            log("loop", f"save at epoch {s['epoch']}: device → host copy "
                        f"{s['copy_seconds']:.3f} s, background write up to its wait "
                        f"{s['write_seconds']:.3f} s, {s['bytes']} bytes | {state['card']}")
        if [s["epoch"] for s in saves] != list(range(1, LOOP_EPOCHS + 1)):
            raise AssertionError(f"loop: saves at epochs {[s['epoch'] for s in saves]}")
        log("loop", f"the run: {run_seconds:.1f} s; its own peak memory "
                    f"{peak / 2 ** 30:.2f} GiB (above {held / 2 ** 30:.2f} GiB held before "
                    f"its model) | {state['card']}")

        # the memory holds one slot per distinct index inserted
        sampler = RandomSampler(train_ds, TRAIN_BATCH, seed=0)
        seen = {int(i) for epoch in range(1, LOOP_EPOCHS + 1)
                for b in sampler.reshuffle(epoch).batches[:LOOP_STEPS] for i in b}
        valid = int(tstate.xbm_state.valid.sum())
        log("loop", f"XBM: {valid} valid slots of {tstate.xbm.size}, {len(seen)} distinct "
                    "indices inserted")
        if valid != len(seen):
            raise AssertionError(f"loop: the XBM holds {valid} slots, {len(seen)} inserted")

        # a fresh state (other loss and generator seeds) resumed from epoch 1
        os.makedirs(os.path.join(resumed_dir, "weights"))
        shutil.copyfile(os.path.join(full_dir, "weights", "epoch_1"),
                        os.path.join(resumed_dir, "weights", "rolling"))
        resumed = fresh_state(1)
        t0 = time.perf_counter()
        payload, meta = load_checkpoint(resumed_dir)
        t_load = time.perf_counter() - t0
        restore_train_state(resumed, payload)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0 - t_load
        log("loop", f"resume from epoch {meta['epoch']}: load {t_load:.3f} s, restore onto "
                    f"the card {t_restore:.3f} s | {state['card']}")
        differ = _payload_differences(payload, train_state_payload(resumed))
        if differ or meta["epoch"] != 1:
            raise AssertionError(f"loop: the restored state differs from the saved one at "
                                 f"{differ[:8]}")
        log("loop", "restored state equals the saved one bit for bit (parameters, BatchNorm "
                    "statistics, AdamW moments, loss parameters and optimizer, XBM, "
                    "generators, step, epoch)")
        del payload
        _, resumed_evals = train(resumed, train_ds, RandomSampler(train_ds, TRAIN_BATCH, seed=0),
                                 splits, None, DeviceTransform(SWT_OPS),
                                 {"experience": dict(exp, save_model=None)}, resumed_dir)
        ours = [r for r in _jsonl(os.path.join(resumed_dir, "metrics.jsonl"))
                if "train/total_loss" in r]
        ref = epochs[-1]
        metric_names = [k for k in ref if k.startswith("train/") and not k.endswith("seconds")]
        params = list(zip(tstate.model.parameters(), resumed.model.parameters()))
        same = (all(torch.equal(a, b) for a, b in params)
                and all(ours[0][k] == ref[k] for k in metric_names)
                and resumed_evals == evals)
        if same:
            log("loop", f"resumed epoch {LOOP_EPOCHS} equals the uninterrupted one bit for bit "
                        "(parameters, epoch metrics, eval metrics)")
        else:
            dmax = max((a.float() - b.float()).abs().max().item() for a, b in params)
            flat = [torch.cat([p.float().flatten() for p in m.parameters()])
                    for m in (tstate.model, resumed.model)]
            cosine = float(torch.nn.functional.cosine_similarity(*flat, dim=0))
            rel = abs(ours[0]["train/total_loss"] - ref["train/total_loss"]) / abs(
                ref["train/total_loss"])
            log("loop", f"resumed epoch {LOOP_EPOCHS} differs: max |Δ parameter| {dmax:.3e}, "
                        f"parameter cosine {cosine:.9f} (limit {ROUTE_COSINE}), total_loss rel "
                        f"{rel:.2e} (limit {ROUTE_LOSS_TOL})")
            if not (rel <= ROUTE_LOSS_TOL and cosine >= ROUTE_COSINE):
                raise AssertionError("loop: the resumed run disagrees with the uninterrupted one")
    finally:
        ckpt_logger.removeHandler(handler)
        ckpt_logger.setLevel(level)
        shutil.rmtree(root, ignore_errors=True)
    _release_earlier_phases(state)


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


def _k4_case(basis, levels, shape, seed, time_it=False, path_wanted=("register", "tile")):
    """K4 against ``lifting_multi_level_plain`` on uniform [-1, 1) planes, on
    the path ``lifting_kernel_variants`` names, which must be one of
    ``path_wanted``; returns (x, max error, path, ``k4_times`` and the bound
    when timed)."""
    import torch

    from irw_tpu_torch.ops.wavelets import lifting_multi_level, lifting_multi_level_plain
    from irw_tpu_torch.ops.wavelets.lifting_dwt import lifting_kernel_variants

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(shape, generator=gen, device="cuda") * 2.0 - 1.0
    out = lifting_multi_level(x, levels, basis)
    ref = lifting_multi_level_plain(x, levels, basis)
    torch.cuda.synchronize()
    path = lifting_multi_level.last_path
    err = (out - ref).abs().max().item()
    peak = ref.abs().max().item()
    tol = K4_TOL["haar" if basis == "haar" else "other"] * max(1.0, peak)
    n, h, w = shape
    msg = (f"K4 {basis} l={levels} {tuple(shape)} f32, {path} path: max|kernel - plain| = "
           f"{err:.3e} (limit {tol:.3e})")
    times = None
    if time_it:
        times = k4_times(lambda: lifting_multi_level(x, levels, basis))
        nbytes = 4 * (n * h * w + n * 4 * (h >> levels) * (w >> levels))
        times["bound_ms"], b_by = bound_ms(nbytes, _lifting_flops(n, h, w, levels, basis),
                                           "float32")
        msg += (f" | kernel {times['ms']:.4f} ms, L2 flushed {times['cold_ms']:.4f} ms, device "
                f"{times['device_ms']:.4f} ms, host {times['host_ms']:.4f} ms, bound "
                f"{times['bound_ms']:.4f} ms ({b_by})")
    log("dwt", msg)
    if not (err <= tol and out.shape == ref.shape and torch.isfinite(out).all()):
        raise AssertionError(f"K4 disagrees with its plain version: {basis} l={levels} "
                             f"{shape}: {err} > {tol}")
    if path != lifting_kernel_variants(h, w, levels, basis)["path"] or path not in path_wanted:
        raise AssertionError(f"K4 took the {path} path for {basis} l={levels} {shape}")
    return x, err, path, times


def phase_dwt(state):
    import torch
    import torch.nn.functional as F

    from irw_tpu_torch.ops.wavelets import lifting_multi_level, lifting_multi_level_plain

    levels_ms = {}
    for basis, levels, shape in [("haar", 2, K4_SHAPE), ("haar", 3, K4_SHAPE),
                                 ("cdf97", 2, K4_CDF97_SHAPE), ("bior48", 2, K4_SHAPE),
                                 ("daub4", 2, K4_SHAPE), ("haar", 2, (5, 72, 200)),
                                 ("coif12", 2, (5, 72, 200)), ("rev_bior_spline_39", 1, (3, 20, 12))]:
        _, _, path, times = _k4_case(basis, levels, shape, seed=5, time_it=shape[0] == 3 * BATCH)
        if times:
            levels_ms[f"{basis} l={levels} {shape}"] = dict(times, path=path)
    # the parent's two kernels a level, kept for halos no tile holds
    _, _, path, times = _k4_case("cdf97", 5, (3 * BATCH, 256, 256), seed=5, time_it=True,
                                 path_wanted=("two_pass",))
    levels_ms[f"cdf97 l=5 {(3 * BATCH, 256, 256)}"] = dict(times, path=path)

    # cdf97 level 1 at cub_dwt_cdf97.yaml's 448²
    x, err, cdf97_path, _ = _k4_case("cdf97", 1, K4_CDF97_SHAPE, seed=6)
    t97 = k4_times(lambda: lifting_multi_level(x, 1, "cdf97"))
    plain_ms = time_ms(lambda: lifting_multi_level_plain(x, 1, "cdf97"), iters=5)
    n, h, w = K4_CDF97_SHAPE
    b_ms, b_by = bound_ms(4 * n * h * w * 2, _lifting_flops(n, h, w, 1, "cdf97"), "float32")
    # yardstick of cost: one conv2d with the four 9 x 9 CDF 9/7 analysis filters
    # (outer products of the 9-tap low-pass and the zero-padded 7-tap high-pass)
    # at stride 2, TF32 off; its boundary handling and band scaling are the
    # filter bank's, not the lifting's, so it is timed and not compared
    lo = torch.tensor([0.026748757411, -0.016864118443, -0.078223266529, 0.266864118443,
                       0.602949018236, 0.266864118443, -0.078223266529, -0.016864118443,
                       0.026748757411])
    hi = torch.tensor([0.0, 0.091271763114, -0.057543526229, -0.591271763114, 1.115087052457,
                       -0.591271763114, -0.057543526229, 0.091271763114, 0.0])
    filt97 = torch.stack([torch.outer(a, b) for a, b in ((lo, lo), (hi, lo), (lo, hi), (hi, hi))])
    filt97 = filt97[:, None].cuda()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x4 = x[:, None]
        with torch.no_grad():
            lib97_ms = time_ms(lambda: F.conv2d(x4, filt97, stride=2, padding=4))
            lib97_device_ms = device_ms(lambda: F.conv2d(x4, filt97, stride=2, padding=4))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    cdf97 = {"cdf97_path": cdf97_path, **{f"cdf97_{k}": v for k, v in t97.items()},
             "cdf97_plain_ms": plain_ms, "cdf97_bound_ms": b_ms, "cdf97_library_ms": lib97_ms,
             "cdf97_library_device_ms": lib97_device_ms}
    log("dwt", f"K4 cdf97 l=1 at {K4_CDF97_SHAPE}, {cdf97_path} path: kernel {t97['ms']:.4f} ms "
               f"| L2 flushed {t97['cold_ms']:.4f} ms | device {t97['device_ms']:.4f} ms | host "
               f"{t97['host_ms']:.4f} ms | plain {plain_ms:.4f} ms | conv2d (9 x 9 analysis "
               f"filters, stride 2) {lib97_ms:.4f} ms, device {lib97_device_ms:.4f} ms | bound "
               f"{b_ms:.4f} ms ({b_by}) | {state['card']}")

    # the served case, haar level 1 at (192, 224, 224)
    x, err, path, _ = _k4_case("haar", 1, K4_SHAPE, seed=7)
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
            lib_device_ms = device_ms(lambda: F.conv2d(x4, filt, stride=2))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    t1 = k4_times(lambda: lifting_multi_level(x))
    plain_ms = time_ms(lambda: lifting_multi_level_plain(x))
    n, h, w = K4_SHAPE
    b_ms, b_by = bound_ms(4 * n * h * w * 2, _lifting_flops(n, h, w, 1, "haar"), "float32")
    log("dwt", f"K4 haar l=1 at the served shape {K4_SHAPE}, {path} path: kernel "
               f"{t1['ms']:.4f} ms | L2 flushed {t1['cold_ms']:.4f} ms | device "
               f"{t1['device_ms']:.4f} ms | host {t1['host_ms']:.4f} ms | plain {plain_ms:.4f} "
               f"ms | conv2d {lib_ms:.4f} ms, device {lib_device_ms:.4f} ms | bound {b_ms:.4f} "
               f"ms ({b_by}) | {state['card']}")
    state["kernels"]["lifting_multi_level"] = {
        "name": "lifting_multi_level", "route": "cuda",
        "source": "irw_tpu_torch/csrc/lifting_dwt.cu",
        "replaces": "irw_tpu/ops/wavelets/pallas_dwt.py:208", "max_abs_err": err,
        "ms": t1["ms"], "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "library_device_ms": lib_device_ms, "path": path,
        **{k: v for k, v in t1.items() if k != "ms"}, **cdf97, "levels_ms": levels_ms}


_WCNN_GROUPS = (("K4 lifting", ("lift_reg_kernel", "lift_tile_kernel", "lift_h_kernel",
                                 "lift_w_kernel")),
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

    from irw_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_plain,
        flash_kernel_variants,
    )

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
    variant = flash_kernel_variants(shape[-3], shape[-1], dtype)["fwd"]
    what = f"K6-fwd {tuple(shape)} {dtype}" + (" fused views" if fused else "") + f" ({variant})"
    log("flash", f"{what}: max|kernel - plain| = {err:.3e} (limit {tol:.3e}, max|o| "
                 f"{ref.float().abs().max().item():.3f})"
                 + (f"; l, m {stats:.3e} (limit {K6_STATS_TOL})" if residuals else ""))
    if not (err <= tol and torch.isfinite(out).all() and (not residuals or stats <= K6_STATS_TOL)):
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
        flash_kernel_variants,
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
    variant = flash_kernel_variants(shape[-3], shape[-1], dtype)["bwd"]
    log("flash", f"K6-bwd {tuple(shape)} {dtype}{what} ({variant}): max|kernel - plain| "
                 + ", ".join(report))
    return (q, k, v, o, do, l, m), worst


def _flash_surface_case(n, hd, dtype, paths):
    """K6-fwd (o, l, m) and K6-bwd against their plain versions at (2, n,
    3, hd) on the views of one fused (2, n, 4, 3, hd) projection, the
    backward fed the kernel forward's o, l, m; one launch of each wrapper;
    the paths taken are added to ``paths``."""
    import torch

    from irw_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        flash_attention_plain,
        flash_attention_plain_bwd,
        flash_kernel_variants,
    )

    gen = torch.Generator(device="cuda").manual_seed(n * 1000 + hd)
    q, k, v, do = torch.randn((2, n, 4, 3, hd), generator=gen, device="cuda").to(dtype).unbind(2)
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    o, l, m = flash_attention_fwd(q, k, v, save_residuals=True)
    grads = flash_attention_bwd(q, k, v, o, do, l, m)
    launched = (flash_attention_fwd.launches - before[0], flash_attention_bwd.launches - before[1])
    ro, rl, rm = flash_attention_plain(q, k, v, save_residuals=True)
    refs = flash_attention_plain_bwd(q, k, v, o, do, l, m)
    torch.cuda.synchronize()
    key = str(dtype).removeprefix("torch.")
    o_err = (o.float() - ro.float()).abs().max().item()
    l_err = ((l - rl).abs() / rl).max().item()
    m_err = ((m - rm).abs() - K6_STATS_TOL * rm.abs()).max().item()
    ok = (launched == (1, 1) and o_err <= K6_FWD_TOL[key] and l_err <= K6_STATS_TOL
          and m_err <= K6_M_TOL and bool(torch.isfinite(o).all()))
    report = []
    for name, out, ref in zip(("dq", "dk", "dv"), grads, refs):
        err = (out.float() - ref.float()).abs().max().item()
        # bf16: 2^-6 of max|plain|, but no less than the f32 limit: at N = 1, p = 1
        # and dp = di, so dq and dk vanish and both sides hold f32 residue only
        tol = max(K3_TOL_F32, 0.0 if dtype == torch.float32
                  else K3_TOL_BF16 * ref.float().abs().max().item())
        report.append(f"{name} {err:.2e}/{tol:.2e}")
        ok = ok and err <= tol and bool(torch.isfinite(out).all())
    variant = flash_kernel_variants(n, hd, dtype)
    paths["fwd"].add(variant["fwd"])
    paths["bwd"].add(variant["bwd"])
    log("flash", f"surface N={n} hd={hd} {key} (fwd {variant['fwd']}, bwd {variant['bwd']}): "
                 f"o {o_err:.2e}/{K6_FWD_TOL[key]:.1e}, l {l_err:.1e}, m {m_err:.1e} past "
                 f"{K6_STATS_TOL}|m|; " + ", ".join(report) + f"; launches {launched}")
    if not ok:
        raise AssertionError(f"K6 at N={n} hd={hd} {key} disagrees with its plain versions or "
                             f"launched {launched}")


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
        flash_kernel_variants,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    bf16, f32 = torch.bfloat16, torch.float32
    paths = {"fwd": set(), "bwd": set()}
    for hd in (32, 64, 128):
        for n in K6_SURFACE_N:
            for dtype in (bf16, f32):
                _flash_surface_case(n, hd, dtype, paths)
    if paths != {"fwd": {"plane", "tiled"}, "bwd": {"plane", "tiled"}}:
        raise AssertionError(f"K6's surface ran {paths}, not both paths of each kernel")
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
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with torch.no_grad():
        fwd_train_ms = time_ms(lambda: flash_attention_fwd(q, k, v, save_residuals=True))
        lib_train_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
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
    # read q, k, v and write o, l, m; two products
    train_b_ms, _ = bound_ms(4 * b * n * h * hd * 2 + 2 * b * h * n * 4, 4 * b * h * n * n * hd,
                             "bfloat16")
    # read q, k, v, o, do and l, m; write dq, dk, dv; five products
    nbytes = 8 * b * n * h * hd * 2 + 2 * b * h * n * 4
    b_ms, b_by = bound_ms(nbytes, 10 * b * h * n * n * hd, "bfloat16")
    variant = flash_kernel_variants(n, hd, bf16)
    log("flash", f"K6-fwd with l, m at the training shape {K6_TRAIN_SHAPE}, fused views "
                 f"({variant['fwd']}): kernel {fwd_train_ms:.4f} ms | SDPA {lib_train_ms:.4f} ms | "
                 f"bound {train_b_ms:.4f} ms | {state['card']}")
    log("flash", f"K6-bwd at {K6_TRAIN_SHAPE}, fused views ({variant['bwd']}, di included): "
                 f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | SDPA backward "
                 f"{lib_ms:.4f} ms (fwd+bwd minus fwd {sdpa_fwd_ms:.4f}) | bound {b_ms:.4f} ms "
                 f"({b_by}) | {state['card']}")
    state["kernels"]["flash_attention_fwd"].update(
        train_ms=fwd_train_ms, train_library_ms=lib_train_ms, train_bound_ms=train_b_ms)
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


def _k5_case(b, n, d, heads, hd, dtype, seed, quiet=False):
    """K5 against ``qkv_attention_plain``, one launch on the path
    ``qkv_kernel_variants`` names; returns the inputs, the error and the
    path."""
    import torch

    from irw_tpu_torch.ops.qkv_attention import (
        fused_qkv_attention,
        qkv_attention_plain,
        qkv_kernel_variants,
    )

    args = _k5_inputs(b, n, d, heads * hd, dtype, seed)
    before = fused_qkv_attention.launches
    with torch.no_grad():
        out = fused_qkv_attention(*args, heads=heads)
        ref = qkv_attention_plain(*args, heads=heads)
    torch.cuda.synchronize()
    path = fused_qkv_attention.last_path
    err = (out.float() - ref.float()).abs().max().item()
    peak = ref.float().abs().max().item()
    tol = K5_TOL[str(dtype).removeprefix("torch.")] * max(1.0, peak)
    if not quiet:
        log("qkv", f"K5 x ({b}, {n}, {d}) {dtype}, {heads} heads of {hd}, {path} path: "
                   f"max|kernel - plain| = {err:.3e} (limit {tol:.3e}, max|o| {peak:.3f})")
    if not (err <= tol and out.shape == ref.shape and torch.isfinite(out).all()):
        raise AssertionError(f"K5 disagrees with its plain version at ({b}, {n}, {d}) {dtype}, "
                             f"{heads} x {hd}: {err} > {tol}")
    if fused_qkv_attention.launches != before + 1 or path != qkv_kernel_variants(n, d, hd,
                                                                                 dtype)["fwd"]:
        raise AssertionError(f"K5 at ({b}, {n}, {d}) {dtype}, hd {hd}: "
                             f"{fused_qkv_attention.launches - before} launches on the {path} "
                             "path, not one on the path qkv_kernel_variants names")
    return args, err, path


def _k5_ptxas(state):
    """K5's kernels with their registers and spills, from this run's build."""
    log_text = state.get("ptxas", {}).get("qkv_attention")
    if log_text is None:
        log("qkv", "K5 registers: not built in this run")
        return
    entry, usage = "?", {}
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            entry = _kernel_name(ln.split("'")[1] if "'" in ln else ln.strip())
        elif "spill stores" in ln or "Used" in ln:
            usage.setdefault(entry, []).append(ln.split(":", 1)[-1].strip())
    for entry, lines in usage.items():
        log("qkv", f"K5 build: {entry}: " + "; ".join(lines))


def _k5_work(b, n, d, heads):
    """K5's bytes (x read and o written once, the three (d, d) weights and
    biases read once, bf16) and operations (the three projections, then
    q k^T and P.V per head) for x (b, n, d) with ``heads`` heads of d /
    heads."""
    nbytes = 2 * (2 * b * n * d + 3 * d * d + 3 * d)
    flops = 3 * 2 * b * n * d * d + 4 * b * heads * n * n * (d // heads)
    return nbytes, flops


def _two_library_calls(args, heads):
    """The two-call yardstick over K5's inputs: one ``F.linear`` onto the
    fused (3D, D) weight (made here, outside the timed calls), then SDPA;
    returns the call, whose output is (B, heads, N, hd)."""
    import torch
    import torch.nn.functional as F

    x, wq, wk, wv, bq, bk, bv = args
    b, n, _ = x.shape
    hd = wq.shape[-1] // heads
    w_qkv = torch.cat([wq, wk, wv], dim=1).t().contiguous()
    b_qkv = torch.cat([bq, bk, bv])

    def two_calls():
        q, k, v = F.linear(x, w_qkv, b_qkv).reshape(b, n, 3, heads, hd).unbind(2)
        return F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v)))
    return two_calls


def phase_qkv(state):
    """K5's registers and spills from the build; K5 against its plain version
    over its surface, logging the path each case took, and at the shapes of
    earlier runs; then timed at the micro-benchmark's default shape and at
    the flagship's served rows beside the plain version, the production
    segment, the two-call library yardstick and the bound."""
    import torch

    from irw_tpu_torch.benchmarks.vmem_qkv_micro import ref_segment
    from irw_tpu_torch.ops.qkv_attention import fused_qkv_attention, qkv_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    bf16, f32 = torch.bfloat16, torch.float32
    _k5_ptxas(state)
    # the surface (B = 2, 2 heads): N from one row to one past the plane
    # envelope, head dims 32 and 64 (plane) and 128 (tiled), D 64 to 768
    for dtype, ns, hds in [(bf16, K5_SURFACE_N, (32, 64, 128)), (f32, (37, 257), (32, 64))]:
        for n in ns:
            cases = []
            for hd in hds:
                for d in K5_SURFACE_D:
                    _, err, path = _k5_case(2, n, d, 2, hd, dtype, seed=n + hd + d, quiet=True)
                    cases.append(f"hd {hd} D {d} {path} {err:.1e}")
            log("qkv", f"K5 surface {dtype} N = {n}: " + ", ".join(cases))
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
        args, _, _ = _k5_case(b, n, d, heads, hd, dtype, seed=20)
    served_calls = _two_library_calls(args, 6)
    with torch.no_grad():
        served_ms = time_ms(lambda: fused_qkv_attention(*args, heads=6))
        served_prod_ms = time_ms(lambda: ref_segment(*args, heads=6, vmem=True))
        served_lib_ms = time_ms(served_calls)
    served_bound, _ = bound_ms(*_k5_work(256, 257, 384, 6), "bfloat16")
    log("qkv", f"K5 at the flagship's served rows (256, 257, 384) bf16: kernel {served_ms:.4f} ms "
               f"| production segment {served_prod_ms:.4f} ms | two library calls "
               f"{served_lib_ms:.4f} ms | bound {served_bound:.4f} ms | {state['card']}")

    b, n, d = K5_SHAPE
    heads, hd = K5_HEADS, d // K5_HEADS
    args, err, _ = _k5_case(b, n, d, heads, hd, bf16, seed=21)
    two_calls = _two_library_calls(args, heads)
    with torch.no_grad():
        lib_err = (two_calls().transpose(1, 2).reshape(b, n, d).float()
                   - qkv_attention_plain(*args, heads=heads).float()).abs().max().item()
        ms = time_ms(lambda: fused_qkv_attention(*args, heads=heads))
        plain_ms = time_ms(lambda: qkv_attention_plain(*args, heads=heads), iters=5)
        prod_ms = time_ms(lambda: ref_segment(*args, heads=heads, vmem=True))
        lib_ms = time_ms(two_calls)
    b_ms, b_by = bound_ms(*_k5_work(b, n, d, heads), "bfloat16")
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
        "served_rows_ms": served_ms, "served_rows_library_ms": served_lib_ms,
        "served_rows_prod_segment_ms": served_prod_ms, "served_rows_bound_ms": served_bound}


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
               "train": phase_train, "loop": phase_loop, "dwt": phase_dwt, "wcnn": phase_wcnn,
               "flash": phase_flash,
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
    trained = {"flagship": ("train", TRAIN_STEPS), "flash": ("flash_train", TRAIN_STEPS),
               "loop": ("loop", LOOP_EPOCHS * LOOP_STEPS)}
    served = {"flagship": ("serve", SERVE_BATCHES), "wcnn": ("wcnn", WCNN_BATCHES),
              "flash": ("flash_serve", SERVE_BATCHES),
              "loop_eval": ("loop_eval", LOOP_EVAL_BATCHES)}

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
