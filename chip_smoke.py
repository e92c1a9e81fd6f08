#!/usr/bin/env python3
"""Smoke test of irw_tpu_torch on one CUDA card (built for an H100, sm_90a).

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases card,build,attention,train
    python3 chip_smoke.py --phases card,build,loop
    python3 chip_smoke.py --phases card,build,runner
    python3 chip_smoke.py --phases card,build,dwt,wcnn
    python3 chip_smoke.py --phases card,build,wavelets
    python3 chip_smoke.py --phases card,build,wcnn_train,wcnn_xbm,losses
    python3 chip_smoke.py --phases card,build,flash,flash_serve,flash_train
    python3 chip_smoke.py --phases card,build,qkv,qkv_micro,variants
    python3 chip_smoke.py --phases card,build,siblings
    python3 chip_smoke.py --phases card,build,trunks
    python3 chip_smoke.py --phases card,build,files
    python3 chip_smoke.py --phases card,build,wavenets
    python3 chip_smoke.py --phases card,build,landmarks
    python3 chip_smoke.py --phases card,build,hf_towers
    python3 chip_smoke.py --phases card,build,microbatch,engine_extras
    python3 chip_smoke.py --phases card,build,wcnn,wcnn_train,trunks_half
    python3 chip_smoke.py --phases card,build,multi_card

Drives the port's serving path — uint8 images → DeviceTransform (/255, Haar
SWT: kernel K1) → the flagship MultiDinoHashing (4 × DINOv2 ViT-S/14 at
224², bf16, cross_attention_advanced fusion, 64 bits; 12 attention blocks,
kernel K2 each) → ±1 codes → Hamming retrieval metrics — its training
path — the same model in training mode with block remat, HashLoss and
AdamW, attention backward on kernel K3 — and the DWT serving path — uint8
images → DeviceTransform (Normalize, CustomTransform haar level 1: kernel
K4) → RetrievalNet ``wcnn_attention_ce`` (4 × ResNet-50 at 112², CBAM
subband gate, f32) → L2-normalised embeddings → cosine retrieval metrics —
its training, with the per-branch CE losses and with the CUB recipe's
CalibrationLoss + SupAP and their XBM memory terms, and every loss of
``configs/loss`` against the CPU — and the flagship with ``vit_kwargs={"use_flash": True}``, served and
trained with every block's attention on the flash kernels K6-fwd and K6-bwd
— and the attention-segment path — the micro-benchmarks that drive kernel K5
(q/k/v projections fused into the attention), K2 and K3, and the flagship
with the ViT Block variants ``fused_qkv``, ``split_cls`` and ``ln_fused`` —
and the flagship's siblings — the shared tower ``SharedDinoHashing`` served
and trained on K1, K2 and K3, with prompts and DSLN, and every other
configuration of the family — and prints one line per phase:

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
10. runner: the flagship study from its config, as a user runs it:
   ``studies/voc_lambda_protocol.yaml`` read with the port's YAML reader,
   its ortho_weight 0.1 job through ``irw_tpu_torch.single_experiment_runner``
   cut to 2 epochs of 960 synthetic 64² images (10 steps of 96) through the
   host stage (Resize 256, RandomResizedCrop 224, ColorJitter, flip) and 384
   queries, everything else the study's; the host stage alone timed first,
   the host's core count and whether Pillow and PyYAML are installed; then
   launches per train step and per eval batch, each epoch's trained img/s,
   ``data_seconds`` and ``step_seconds``, the eval seconds, the peak memory,
   finite metrics; a second call returns the finished run's best score
   without a launch or a record;
11. dwt: K4 against ``lifting_multi_level_plain`` for haar at levels 1-3 at
   the served shape (192, 224, 224), cdf97 at (192, 448, 448), bior48 and
   daub4 at level 2, and a ragged batch of non-square planes, logging the
   path each case took (register or tile: one launch) and requiring the one
   ``lifting_kernel_variants`` names; cdf97 at level 5 on (192, 256, 256),
   which must take the two-pass path (two kernels a level); timed over CUDA
   events, with L2 flushed before each call, as device time and as the
   host's issue time, beside the ``conv2d`` that computes haar level 1, and
   cdf97 beside one ``conv2d`` of the 9 x 9 analysis filters at stride 2
   (both also as device time);
12. wcnn: the full-width WCNN-attention model serves batches of 64: launch
   counts per batch, embeddings held against the same model with K4's
   plain version, img/s, peak memory, one batch profiled; then ``evaluate``
   (cosine) on a CUB-test-sized synthetic set (5794 images, 100 classes);
12b. wavelets: K4 in bf16 and f16 against its plain version, bit for bit,
   at the served haar shape, cdf97's (192, 448, 448) and a two-pass case,
   timed beside the bound and ``conv2d`` in the same dtype, and its three
   wrappers one launch each; the filter-bank library (``wavedec2``,
   ``swt2``, ``resize_bilinear`` and every inverse) on a served batch
   against the same calls on the CPU, with TF32 allowed; then the two DWT
   configs from ``configs/`` through ``compose`` → ``build_transforms`` →
   the getter's model → ``evaluate``: path A ``wcnn_attention_all_subs`` on
   ``dwt_all_subs`` (7 × ResNet-50 over 7 bands resized to 112²), path B
   ``wcnn_attention_ce`` on ``cifar_dwt`` (DWTTransform, 4 × ResNet-50 at
   112²): 3 warm-up and 20 timed batches of 64 (img/s, peak memory,
   launches), one batch's embeddings against the same model fed the CPU
   transform's bands;
13. wcnn_train: the WCNN CE path trains at full width (``wcnn_attention_ce``,
   ``multi_ce_fusionloss``, ``cub_wresnet``'s Adam) at CUB's batch of 128,
   uint8 images and labels in [0, 200) made on the card: 3 warm-up steps,
   then trained img/s over one synchronised window of 20 steps (CUDA-event
   step times beside it), K4 once a step, the path's own peak memory, finite
   metrics; one step on K4's route held against K4's plain route from the
   same weights (loss, and the gradient of each top-level module); one step
   profiled;
14. wcnn_xbm: the ROADMAP lineage's CUB recipe (``wcnn_attention``'s unit
   2048-d embeddings, CalibrationLoss + SupAP, ``memory=cub``'s 5824-slot
   XBM filled first through its own insert, ``configs/optimizer/cub.yaml``)
   at batch 128: 2 warm-up steps, then 10 timed with the memory term on (the
   general rank path at full M), launches, peak memory, the four loss terms;
   the first timed step's terms against float64 on the CPU (values, and the
   gradient with respect to the embeddings);
15. losses: every loss ``build_losses`` makes from ``configs/loss/*.yaml`` on
   the card at batch 128 (the memory readers also against 5824 slots), held
   against the same call on the CPU: value, gradient cosine, BlackBoxAP's
   ranks;
16. flash: K6-fwd (o, l, m) and K6-bwd against ``flash_attention_plain``
   and ``flash_attention_plain_bwd`` over the kernels' surface (N from 1 to
   577 through the one-step boundary 128/129, head dims 32, 64 and 128,
   bf16 and f32, the strided views of one fused projection, the backward
   fed the kernel forward's o, l, m), logging the path each took and
   requiring both the plane and the tiled path of each; then at the served
   shape (256, 257, 6, 64) and the training shape (384, 257, 6, 64) bf16
   on the fused views, as the path gives them, and at larger f32 shapes;
   K6-fwd timed at the served shape and, with l and m, at the training
   shape, K6-bwd at the training shape, each beside SDPA at that shape;
17. flash_serve: the full-width flagship with ``use_flash`` serves batches
   of 64 (launch counts, codes against the plain route, img/s), one batch
   profiled;
18. flash_train: the same model trains at batch 96 (launch counts per step,
   the kernel route against the plain route, trained img/s, peak memory),
   one step profiled;
19. qkv: K5's kernels with their registers and spills from the build; K5
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
20. qkv_micro: ``irw_tpu_torch.benchmarks.vmem_qkv_micro.run()`` and
   ``vmem_attn_micro.run()`` at their full default widths: their JSON, their
   maxdiffs against stated limits, and the launches of K5, K2 and K3;
21. variants: the full-width flagship served with ``fused_qkv``, with
   ``split_cls`` and with ``vmem_attn + ln_fused`` (codes against the default
   route, img/s, launch counts: never K5), ``infer_vmem_ab``'s sweep of the
   frozen flagship, and train steps at batch 96 with ``ln_fused`` on the
   K2/K3 route against the same steps without it;
22. siblings: the flagship's siblings at full width, each from its
   ``configs/model`` file read with the port's YAML reader.
   ``shareddino_attention_hashing_ortho.yaml`` (one unbanded ViT-S/14 over
   the band-major batch, unfrozen, bf16, block remat, ``vmem_attn``,
   ``cross_attention_advanced``, 64 bits) serves as ``serve`` does (K1 = 1,
   K2 = 12 a batch, codes against the plain route, img/s, peak memory) and
   trains as ``train`` does (K1 = 1, K2 = 24, K3 = 12 a step, the kernel
   route against the plain route, trained img/s, peak memory, one step
   profiled); ``prompted_shared_dino.yaml`` (a frozen f32 tower, 10 prompts,
   DSLN over 4 bands, the standard head) serves a batch of 64 and takes 3
   train steps (the prompts' gradient non-zero, the tower, DSLN included,
   unchanged bit for bit, finite ``grad_norm``); ``multidino_attention``,
   ``_cbam`` and ``multidino_original_attention`` (continuous embeddings),
   ``multidino_attention_pretrain`` (``temperature_gated``),
   ``multidino_hashing_attention_pretrained`` and the flagship with
   ``use_bn: false`` serve a batch of 64 each (launches, finite outputs),
   the last also one train step; every model's first 4 images of its batch
   against a CPU copy of it (TF32 off on the card for the comparison).
23. files: datasets read from files.  A VOC tree (384 train and 192 val
   JPEGs at 500 x 375, XML annotations, one CMYK, one grayscale, one PNG
   named .jpg and one cut JPEG among them) and a CUB-200 tree (64 classes
   each side of 100) written with Pillow; the host image loader built with
   g++ (its build seconds, or the compiler's error and the Pillow route);
   ``EpochLoader`` alone at the study's train host ops in img/s on each
   route; ``studies/voc_lambda_ablation.yaml``'s first job through the
   runner at full width (2 epochs of 4 steps of 96, one eval; K1 = 1, K2 =
   24, K3 = 12 a step) and ``cub.yaml`` + ``cub_dwt`` + ``wcnn_attention_ce``
   (2 steps of 128, one cosine eval; K4 = 1 a step), each batch's decode
   route, trained img/s; K1 and K4 on the first decoded train batches and
   K2 and K3 on block 0's q, k, v of the first step, each against its plain
   version;
24. wavenets: the wavelet CNNs (ROADMAP A10b), each from its ``configs/model``
   file through ``compose`` and the ``Getter`` at full width.
   ``wresnet_sdd_ce`` + ``sdd`` (the in-model DWT on K4, 4 x ResNet-50 with
   the 1 x 1 stem at 112², per-band CE over 120 classes) and ``mtwavenet50``
   + ``cub_dwt`` (K4 in ``CustomTransform``, 4 staged ResNet-50s with a
   cross-band attention after each stage, 272 M parameters, an embedding
   loss, ``model.freeze_batch_norm``) each serve 3 warm-up and 20 timed
   batches of 64 (K4 = 1 a batch, img/s, peak memory, each distinct batch
   against K4's plain route) and train 3 warm-up and 6 timed steps
   (``multi_ce`` at batch 16, ``pair_loss`` at cub.yaml's 128;
   ``basic.yaml``'s AdamW; K4 = 1 a step; for ``wresnet_sdd_ce`` one step's
   K4 route against its plain route); each other A10b config serves a batch
   of 8 and takes one train step of 8 (K4 = 1 each; ``mtwavenet_fusion_dml``'s
   training raises, as its JAX init does);
25. landmarks: landmark retrieval (ROADMAP A8c, A12's eval protocols).  A
   roxford5k tree (its 70 queries and 4993 gallery images, gnd of 120 easy,
   130 hard and 150 junk a query drawn from a seed, JPEGs of 384 x 288 in
   place of ~1024 x 768) and an SfM-120k tree (1024 images in 256 clusters)
   written with Pillow; ``dataset=roxford`` through ``compose`` and the
   ``Getter``, the full-width flagship embedding both sides with voc_swt's
   test ops through ``evaluate`` → ``landmark_evaluation`` (K1 = 1, K2 = 12
   an eval batch; K1 and K2 on the first decoded batch against their plain
   versions; map_medium and map_hard against the float64 scalar oracle on the
   card's embeddings; embed seconds, map ms, peak memory);
   ``landmark_bench.run()`` at roxford5k's and rparis6k's 70 x 4993 | 6322 x
   2048; the SfM recipe (``dataset=sfm120k transform=sfm120k model=deit
   optimizer=sfm120k_deit loss=roadmap experience=landmarks``) through the
   runner, one epoch of 8 steps of 128 and its eval (no kernel: a stock f32
   DeiT-S/16); ``EpochLoader`` alone with ``multicrop.yaml``'s train ops and
   with a hue, grayscale and blur; the numpy host ops against the machine's
   Pillow;
26. hf_towers: the HF vision wrapper's towers (ROADMAP A10d) at full width,
   f32, 224², no kernel on the path.  ``openclip`` and ``metaclip2`` (CLIP
   ViT-B/16) and ``siglip2`` (SigLIP B/16) through ``RetrievalNet`` from
   their ``configs/model`` files, each served as ``trunks`` serves (3 warm-up
   and 6 timed batches of 64: img/s, ms a batch, peak memory, launches,
   the first 4 images against a CPU copy with TF32 off); the registry's
   ``clip_vit_b32`` and ``vit_b16_hf`` one batch each, also against the CPU;
   ``openclip`` and ``siglip2`` trained 3 steps of 64 (``pair_loss.yaml``,
   ``basic.yaml``'s AdamW: the loss, ms a step, peak memory, every tower
   tensor moved);
27. microbatch: the full-width flagship trains at batch 96 as ``train`` does,
   micro-batched: ``sub_batch`` 32 (3 even chunks: 3 warm-up and 20 timed
   steps, trained img/s and peak memory beside ``train``'s), 40 (40 + 40 +
   16: a separate tail) and 19 (19 x 4 + 20: a tail of one merged), 1
   warm-up and 2 timed steps each; K1 = 1 a step, and per chunk K2 = 36 (the
   forward, the chunk's recompute and each block's own recompute: 3 a
   block) and K3 = 12; the kernel route against the plain route at 32
   (total_loss, gradient cosine per top-level module, the HashHead
   BatchNorm's running statistics);
28. engine_extras: the rest of ROADMAP A12 at full width.  Adaptive loss
   weighting on the CUB recipe (``wcnn_attention`` over ``cub_dwt``,
   ``roadmap_adaptative.yaml`` with the 5824-slot XBM filled first, batch
   128): 1 warm-up and 3 timed steps, ms a step, K4 = 1 a step, the weights
   against K4's plain route; RMSprop, Adagrad, LARS and Lamb each 3 steps of
   the flagship at batch 96 (finite losses) and one step of the fusion and
   hash heads on identical gradients against the same optimizer on the CPU;
   through ``run``: the DSCH recipe (``model=resnet_dsch loss=dsch
   optimizer=resnet_dsch``, patience 1, at most 4 epochs of 3 steps; the
   returned metrics are the best epoch's), the flagship with
   ``kfold.use_kfold`` for each split kind (the ``val`` split logged), and
   with ``with_fast_eval`` and the instrumentor at epochs 1 and 2
   (``fast_eval/`` logged at the epoch without eval; the dumps' keys those
   of the scanned flagship, K1 = 1 and K2 = 12 in each capture, and each
   capture's own peak memory);
29. run_tools: what a trained run is used for (ROADMAP A15b).  The flagship
   study's job through ``run`` at full width, 2 steps of 96 on 224²
   synthetic images whose host stages are identities; over its run dir,
   ``evaluate.load_and_evaluate`` (K1 = 1, K2 = 12 an eval batch; its
   metrics held to the run's last eval within 1e-6),
   ``attention.mean_attention`` and ``plot_exemples.retrieval_rows`` +
   ``render`` (K1 = 1, K2 = 12 a batch); ``alpha_weights.generate_alphas``
   over a ``wcnn_attention_ce`` + ``cub_dwt`` run dir (K4 = 1 a batch); a
   seeded hub-layout DINOv2 ViT-S/14 through the converter, grafted into
   every band of the flagship, one served batch (K1 = 1, K2 = 12);
30. serving: the serving extras (ROADMAP A14).  The flagship with
   ``quant_int8`` beside the float flagship on the same weights, 3 + 20
   batches of 64 each (img/s; K1 = 1, K2 = 0 and K1 = 1, K2 = 12 a batch;
   the share of equal sign codes); the float flagship exported with the SWT
   folded in at a serve batch of 64 (``torch.export``), loaded, one batch
   held bit for bit to the eager forward with K1 = 1 and K2 = 12 counted
   inside the program; the int8 flagship exported (int8 weights and
   scales); both artifacts' sizes;
31. trunks_half: the CNN trunks in half precision (ROADMAP A10e).
   ``model=wcnn_attention_ce transform=cub_dwt +model.kwargs.dtype=bfloat16``
   composed and built by the ``Getter`` at full width (Normalize and K4 in
   f32, 4 x ResNet-50 in bf16, the CBAM gate and classifiers in f32, every
   parameter and statistic f32): 3 + 20 served batches of 64 (img/s, peak,
   idle share; K4 = 1 a batch, its bands within 1e-5 of the plain route's;
   the unit embeddings against the same weights' f32 run with TF32 off, each
   row at cosine ``HALF_COSINE``), one f16 batch likewise; CUB's batch 128
   with ``multi_ce_fusionloss`` and Adam, the first step's loss within
   ``HALF_LOSS_REL`` of the f32 step's, then 3 + 6 timed steps (K4 = 1 a
   step); ``wresnet_sdd_ce`` + ``sdd`` in bf16 at 16, 3 + 6 steps (K4 = 1
   inside the model); one bf16 batch and step of ``mtwavenet50``,
   ``hybrid_mtwavenet_v2_ce`` (DenseNet-121), ``resnet_ce``, ``convnext`` and
   ``densenet121`` from the registry, each against its f32 twin; the bf16
   numbers beside the f32 ``wcnn`` and ``wcnn_train`` ones of the run;
32. multi_card: the serving side of multi-card (ROADMAP A13a).  The
   flagship over 5717 synthetic uint8 224² images with VOC's 20 labels
   (Hamming, k 5717) and the WCNN over 5794 with 100 classes (cosine, k
   5000), seed 0, LayerScale 1: ``compute_embeddings`` and ``evaluate`` by
   this process at batch 64, then by ranks spawned (file rendezvous) over
   a group of one rank a card on NCCL and over two ranks (two cards on
   NCCL, or both on card 0 on gloo, whose ranks first build K1 at once
   into an empty directory and load it) at 64 a rank, the metric suite's
   query chunks split over the ranks: the first 64 queries' top-k indices
   over the gathered embeddings equal to this process's, every metric
   within 1e-6, every rank's dict equal, K1 = 1 and K2 = 12 (flagship) and
   K4 = 1 (WCNN) a batch a rank, every route's ranks ended within 150 s;
   eval and scoring seconds, embedded img/s and peak memory a rank.

Then a JSON line of per-kernel numbers, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the exit code
is non-zero and the last line is not printed.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np

PHASES = ("card", "build", "swt", "attention", "serve", "profile", "retrieval", "train", "loop",
          "runner", "dwt", "wcnn", "wavelets", "wcnn_train", "wcnn_xbm", "losses", "flash",
          "flash_serve", "flash_train", "qkv", "qkv_micro", "variants", "siblings", "trunks",
          "files", "wavenets", "landmarks", "hf_towers", "microbatch", "engine_extras",
          "run_tools", "serving", "trunks_half", "multi_card")

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
# the runner phase: studies/voc_lambda_protocol.yaml's job at ortho_weight 0.1
# through the port's runner, cut to 2 epochs of 960 synthetic 64² images (10
# steps of 96 each) and 384 queries; everything else is the study's
RUNNER_PLAN = "studies/voc_lambda_protocol.yaml"
RUNNER_JOB = "model.kwargs.fusion_config.ortho_weight=0.1"
RUNNER_TRAIN, RUNNER_QUERY, RUNNER_EPOCHS = 960, 384, 2
RUNNER_CUTS = [f"dataset.kwargs.num_train={RUNNER_TRAIN}",
               f"dataset.kwargs.num_query={RUNNER_QUERY}",
               f"experience.max_iter={RUNNER_EPOCHS}", "experience.train_eval_freq=2",
               "experience.test_eval_freq=2", "experience.checkpoint_freq=1",
               f"experience.evaluation.top_k={RUNNER_TRAIN}"]
RUNNER_STEPS = RUNNER_TRAIN // TRAIN_BATCH
# inference-mode forwards of one run: the memory's embedding-size probe, then
# the eval's query set and gallery, each one padded batch of eval_bs 1000
RUNNER_EVAL_UNITS = 3
HOST_BATCHES = 4        # batches timed through the host stage alone (median)
VOC_ANCHOR_MAP = 0.3865
# K4 and its plain version round every product, sum and quotient alike; the
# limits, of max(1, max|plain|), leave room for an FMA contraction
K4_TOL = {"haar": 1e-5, "other": 1e-4}
K4_SHAPE = K1_SHAPE       # (3 · 64) planes of 224²: one served batch
K4_CDF97_SHAPE = (3 * BATCH, 448, 448)   # configs/transform/cub_dwt_cdf97.yaml
WCNN_BATCHES = 6
WCNN_EMB_TOL = 1e-4      # K4 against its plain version, on the L2-normalised embeddings
CUB_TEST = 5794          # CUB-200-2011's test split (100 classes)
# the WCNN training paths: configs/dataset/cub.yaml's batch and classes,
# configs/loss/multi_ce_fusionloss.yaml with configs/optimizer/cub_wresnet.yaml
# (wcnn_train), and configs/model/wcnn_attention.yaml with
# configs/loss/roadmap.yaml, configs/memory/cub.yaml and
# configs/optimizer/cub.yaml (wcnn_xbm); tests/test_torch_wcnn_train.py holds
# these to the files
CUB_BATCH, CUB_CLASSES = 128, 200
WCNN_CE_LOSS = [{"name": "MultiCrossEntropyLoss", "weight": 1.0,
                 "kwargs": {"weights": [0.75, 0.75, 0.75, 0.75, 2.0], "label_smoothing": 0.1}}]
CUB_WRESNET = [{"name": "Adam", "params": None, "kwargs": {"lr": 1e-05, "weight_decay": 0.0004},
                "scheduler_on_epoch": None, "scheduler_on_step": None, "scheduler_on_val": None}]
WCNN_EMB = {"name": "wcnn_attention",
            "kwargs": {"num_classes": 100, "attention": "cbam", "backbone": "resnet50"}}
ROADMAP_LOSS = [{"name": "CalibrationLoss", "weight": 1.0,
                 "kwargs": {"pos_margin": 0.9, "neg_margin": 0.6}},
                {"name": "SupAP", "weight": 1.0,
                 "kwargs": {"tau": 0.01, "rho": 100.0, "offset": 1.44, "delta": 0.05}}]
CUB_MEMORY = {"name": "XBM", "activate_after": -1, "weight": 1.0,
              "kwargs": {"size": 5824, "unique": True}}
CUB_OPTIMIZER = [{"name": "Adam", "params": None,
                  "kwargs": {"lr": 1e-05, "weight_decay": 0.0004},
                  "scheduler_on_epoch": {"name": "MultiStepLR",
                                         "kwargs": {"milestones": [30, 70], "gamma": 0.3,
                                                    "last_epoch": -1}},
                  "scheduler_on_step": None, "scheduler_on_val": None}]
WCNN_TRAIN_STEPS = 20
WCNN_TRAIN_METRICS = ("total_loss", "grad_norm", "batch_map", "loss_0_MultiCrossEntropyLoss")
XBM_WARMUP, XBM_STEPS = 2, 10
XBM_TERMS = ("loss_0_CalibrationLoss", "loss_0_memory_CalibrationLoss", "loss_1_SupAP",
             "loss_1_memory_SupAP")
XBM_TERM_TOL = 1e-4      # the card's f32 terms against float64 on the CPU, relative
XBM_COSINE = 0.999
# the losses phase: every loss of configs/loss/*.yaml at CUB's batch, D = 64
# for the hashing losses (VOC's 20 multi-label classes) and 512 for the others
# (CUB's 200 classes), the memory readers also against CUB's 5824 slots; the
# same call on the CPU; a score loss whose memory call costs B·M² (the rank
# family, BlackBoxAP) is held on its first LOSS_MEMORY_ROWS queries (each
# query's AP reads only its own row), in full on the card
LOSS_TOL, LOSS_COSINE = 1e-5, 0.9999
LOSS_MEMORY_ROWS = 4     # spans two of the card's 3-query chunks at M = 5824
HASHING_LOSSES = ("HashLoss", "HashNetAdapter", "HashNetLoss", "CSQAdapter", "CSQLoss",
                  "HHFAdapter", "HHFLoss", "SCHLoss", "QuantizationLoss")
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
# the siblings phase: configs/model files of the flagship's family
SHARED_CONFIG = "shareddino_attention_hashing_ortho"
PROMPTED_CONFIG = "prompted_shared_dino"
FAMILY_SERVED = ("multidino_attention", "multidino_attention_cbam",
                 "multidino_original_attention", "multidino_attention_pretrain",
                 "multidino_hashing_attention_pretrained")
PROMPT_STEPS = 3
CPU_IMAGES = 4           # images of a served batch held against a CPU copy of the model
CPU_F32_TOL = 1e-4       # f32 logits, the card with TF32 off against the CPU, absolute
# bf16: both sides round at the same points and accumulate in other orders;
# hashing logits take the bf16 convention (LOGIT_MARGIN), unit embeddings a cosine
CPU_EMB_COSINE = 0.999

# the trunks phase: the single-trunk configs of configs/model (ROADMAP A10c),
# over the SWT stack (kernel K1) or over Normalize'd plain images
TRUNK_SWT = ("single_band", "detail_tester", "multi_dino")
TRUNK_PLAIN = ("dino_hashing", "dino_default", "dino", "dino_v3", "deit", "ibot", "resnet",
               "resnet_ce", "resnet_hashing", "resnet_dsch", "resnet_max_ln", "convnext")
TRUNK_PLAIN_OPS = [("Normalize", {})]
TRUNK_TIMED = 6          # timed served batches per config, after WARMUP_CALLS
TRUNK_STEPS = 3
# the hf_towers phase: the HF vision wrapper's towers (ROADMAP A10d) at full
# width (ViT-B/16 or B/32, 224², f32): the configs of HF_SERVE served as the
# trunks are, HF_REGISTRY's presets one batch each from the registry, and
# HF_TRAIN trained TRUNK_STEPS steps with pair_loss.yaml and basic.yaml's AdamW
HF_SERVE = ("openclip", "metaclip2", "siglip2")
HF_REGISTRY = ("clip_vit_b32", "vit_b16_hf")
HF_TRAIN = ("openclip", "siglip2")
# the files phase: VOC and CUB-200 trees written as JPEG files (VOC's usual
# 500 x 375), read back through the datasets, the loader and the runner.
# studies/voc_lambda_ablation.yaml's first job (ortho_weight 0) at full width
# on 384 train (= gallery) and 192 val (= query) images: 2 epochs of 4 steps
# of 96, one eval at epoch 2; then cub.yaml + cub_dwt + wcnn_attention_ce on 64
# train classes of 4 images (< 100) and 64 test classes of 2 (> 100): 2 steps
# of 128 and one cosine eval
FILES_PLAN = "studies/voc_lambda_ablation.yaml"
FILES_JOB = "model.kwargs.fusion_config.ortho_weight=0"
FILES_VOC_TRAIN, FILES_VOC_VAL, FILES_IMAGE = 384, 192, (500, 375)
FILES_EPOCHS = 2
FILES_STEPS = FILES_VOC_TRAIN // TRAIN_BATCH
FILES_CUTS = [f"experience.max_iter={FILES_EPOCHS}", "experience.train_eval_freq=2",
              "experience.test_eval_freq=2", f"experience.evaluation.top_k={FILES_VOC_TRAIN}"]
FILES_CUB_CLASSES, FILES_CUB_TRAIN, FILES_CUB_TEST = 64, 4, 2
FILES_CUB_STEPS = FILES_CUB_CLASSES * FILES_CUB_TRAIN // CUB_BATCH
FILES_CUB_JOB = ["dataset=cub", "transform=cub_dwt", "model=wcnn_attention_ce",
                 "loss=multi_ce_fusionloss", "optimizer=cub_wresnet", "experience.max_iter=1",
                 "experience.train_eval_freq=1", "experience.test_eval_freq=1",
                 "experience.evaluation.distance_metric=cosine",
                 f"experience.evaluation.top_k={FILES_CUB_CLASSES * FILES_CUB_TEST}"]
FILES_SPECIAL = {3: "cmyk", 4: "gray", 5: "png", 6: "truncated"}
FILES_LOADER_WORKERS = 8   # configs/experience/default.yaml's num_workers
# the landmarks phase (ROADMAP A8c, A12's eval protocols): a roxford5k tree of
# its 70 queries and 4993 gallery images, each query's gnd at landmark_bench's
# density, the JPEGs cut from the dataset's ~1024 x 768 to LANDMARK_IMAGE; the
# flagship embeds both sides through evaluate (voc_swt's test ops) and the
# revisited protocol scores them.  Then landmark_bench at roxford5k's and
# rparis6k's gallery sizes, the SfM recipe through the runner on an SfM tree
# (LANDMARK_SFM_TRAIN images in 4-image clusters: 8 steps of sfm120k.yaml's
# batch of 128, one eval of the train split as the config gives it), and the
# host ops alone
LANDMARK_CITY = "roxford5k"
LANDMARK_COUNTS = (70, 4993)          # roxford5k's queries and gallery
LANDMARK_GND = (120, 130, 150)        # easy, hard, junk a query
LANDMARK_IMAGE = (384, 288)
LANDMARK_EVAL_BS = 256
LANDMARK_MAP_TOL = 1e-5               # the card's mAP against the float64 oracle
LANDMARK_BENCH_GALLERIES = {"roxford5k": 4993, "rparis6k": 6322}
LANDMARK_SFM_TRAIN, LANDMARK_SFM_CLUSTERS = 1024, 256
LANDMARK_SFM_JOB = ["dataset=sfm120k", "transform=sfm120k", "model=deit",
                    "optimizer=sfm120k_deit", "loss=roadmap", "experience=landmarks",
                    "experience.max_iter=1"]
LANDMARK_SFM_BATCH = 128              # configs/dataset/sfm120k.yaml
LANDMARK_SFM_STEPS = LANDMARK_SFM_TRAIN // LANDMARK_SFM_BATCH
LANDMARK_HOST_IMAGES = 256            # images through EpochLoader per host-op list
LANDMARK_PILLOW_IMAGES = 4
# the wavenets phase: every wavelet-CNN config of configs/model (ROADMAP A10b)
# with a transform whose test split fits its input (images for the in-model
# DWT, CustomTransform's band stack for the others) and a loss file of
# configs/loss (None: the config trains in neither package); the two paths of
# WAVENET_MAIN are served and trained at full width and timed: (transform,
# loss, train batch).  wresnet_sdd_ce trains at 16, not sdd.yaml's 128: one
# image holds ~2-4 GB of activations there (4 x ResNet-50 at 112² past the
# 1 x 1 stem); mtwavenet50 at cub.yaml's 128.  The JAX factory builds
# mtwavenet50 without classes, so it trains an embedding loss.
# tests/test_torch_wavenet_configs.py holds these to the files
WAVENET_CONFIGS = {
    "wresnet": ("sdd", "pair_loss.yaml"),
    "wresnet_cifar": ("cifar", "pair_loss.yaml"),
    "wresnet_cifar_ce": ("cifar", "multi_ce.yaml"),
    "wresnet_sdd": ("sdd", "pair_loss.yaml"),
    "wresnet_sdd_ce": ("sdd", "multi_ce.yaml"),
    "mtwavenet": ("cub_dwt", "multi_ce.yaml"),
    "mtwavenet50": ("cub_dwt", "pair_loss.yaml"),
    "mtwavenet50_fusion": ("cub_dwt", "multi_ce_fusionloss.yaml"),
    "mtwavenet_fusion": ("cub_dwt", "multi_ce_fusionloss.yaml"),
    "mtwavenet_fusion_dml": ("cub_dwt", None),
    "mtwavenet_tuned": ("cub_dwt", "multi_ce.yaml"),
    "hybrid_wavenet": ("cub_dwt", "celoss.yaml"),
    "hybrid_wavenet_v2": ("cub_dwt", "celoss.yaml"),
}
WAVENET_MAIN = {"wresnet_sdd_ce": ("sdd", "multi_ce.yaml", 16),
                "mtwavenet50": ("cub_dwt", "pair_loss.yaml", CUB_BATCH)}
WAVENET_OPTIMIZER = OPTIMIZER      # configs/optimizer/basic.yaml
WAVENET_STEPS = 6
WAVENET_SMALL = 8                  # the other configs' served batch and train step
# the trunks_half phase (ROADMAP A10e): the WCNN path composed with the
# config override a user gives for a bf16 trunk, served at BATCH and trained
# at CUB_BATCH (WCNN_CE_LOSS, CUB_WRESNET) for HALF_STEPS timed steps;
# wresnet_sdd_ce + sdd at 16 likewise; HALF_MODELS built by the registry in
# bf16 for one batch of HALF_SMALL and one step each (loss file, input)
HALF_OVERRIDES = ["model=wcnn_attention_ce", "transform=cub_dwt", "+model.kwargs.dtype=bfloat16"]
HALF_SDD = ["model=wresnet_sdd_ce", "transform=sdd", "+model.kwargs.dtype=bfloat16"]
HALF_STEPS = 6
HALF_SMALL = 8
HALF_MODELS = {"mtwavenet50": ({}, "pair_loss.yaml", "bands"),
               "hybrid_mtwavenet_v2_ce": ({"num_classes": CUB_CLASSES}, "celoss.yaml", "bands"),
               "resnet_ce": ({"num_classes": CUB_CLASSES}, "celoss.yaml", "images"),
               "convnext": ({}, "pair_loss.yaml", "images"),
               "densenet121": ({}, "pair_loss.yaml", "images")}
# a half-precision model's unit embeddings against the same weights' f32 run
# on the card with TF32 off, each row's cosine: ten times the CPU's largest
# 1 - cosine over the five registry models and the two WCNNs at full width
# on 224² images (tools/half_cosines.py: bf16 2.96e-5, mtwavenet50; f16
# 6.0e-7); the first bf16 train step's total_loss against the f32 step's,
# relative: at least five times JAX's own bf16-vs-f32 gap of one CE step,
# which tests/test_torch_trunks_half_step.py asserts
HALF_COSINE = {"bfloat16": 1 - 3e-4, "float16": 1 - 6e-6}
HALF_LOSS_REL = 1e-2

# the card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W)
# the microbatch phase: the flagship at TRAIN_BATCH in chunks of sub_batch,
# sub_batch → the timed steps (32: even chunks, as train's window; 40: a
# separate tail; 19: a tail of one merged into the last chunk)
MICRO_STEPS = {32: TRAIN_STEPS, 40: 2, 19: 2}
MICRO_BN_TOL = 1e-3      # the HashHead's running statistics, kernel against plain route
# the engine_extras phase.  configs/loss/roadmap_adaptative.yaml (held to the
# file by tests/test_torch_engine_extras.py) on the CUB recipe with its memory
ROADMAP_ADAPTIVE = [{"name": "CalibrationLoss", "weight": "adaptative",
                     "kwargs": {"pos_margin": 0.9, "neg_margin": 0.6}},
                    {"name": "SupAP", "weight": "adaptative",
                     "kwargs": {"tau": 0.01, "rho": 100.0, "delta": 0.05}}]
ADAPTIVE_STEPS = 3
ADAPTIVE_TOL = 1e-3      # the adaptive weights, K4 against its plain route, relative
EXTRA_OPTIMIZERS = ("RMSprop", "Adagrad", "LARS", "Lamb")
EXTRA_OPT_LR = 1e-5      # basic.yaml's learning rate
EXTRA_OPT_STEPS = 3
EXTRA_OPT_TOL = 1e-6     # one update on the card against the CPU, of the largest move
# the runs through run: over configs/default.yaml, logs under the phase's own
# temporary directory
DSCH_JOB = ["model=resnet_dsch", "loss=dsch", "optimizer=resnet_dsch", "transform=cifar",
            "dataset=synthetic", "experience.dsch_train=true", "experience.max_iter=4",
            "experience.step_per_epoch=3", "experience.train_eval_freq=1",
            "+experience.dsch.patience=1", "experience.eval_bs=256"]
EXTRAS_JOB = ["model=multidino_attention_hashing_ortho", "transform=voc_swt", "loss=hash_loss",
              "dataset=synthetic", "dataset.kwargs.multi_label=false",
              "dataset.kwargs.num_samples=192", "dataset.sampler.kwargs.batch_size=96",
              "experience.step_per_epoch=1", "experience.eval_bs=96"]
KFOLD_KINDS = ("class_disjoint", "hierarchical", "closed_set")
# the instrumentor's features of the flagship, whose dinov2 towers are scanned
# (no Block_<i> scope): the fusion head's and HashHead's, under flax's names;
# tests/test_torch_hooks.py holds them to irw_tpu's capture of a scanned flagship
_HEAD = "CrossAttentionBottleneckHead_0"
_MHA = f"{_HEAD}/_AttnCore_0/MultiHeadDotProductAttention_0"
HOOK_FEATURES = tuple(sorted(
    [f"{_HEAD}/Mlp_0/{m}/__call__/[0]" for m in ("Dense_0", "Dense_1", "Dropout_0")]
    + [f"{_HEAD}/{m}/__call__/[0]" for m in ("Mlp_0", "norm1", "norm2", "out_proj")]
    + [f"{_MHA}/__call__/[0]"] + [f"{_MHA}/{m}/__call__/[0]" for m in ("query", "key", "value",
                                                                        "out")]
    + [f"{_HEAD}/_AttnCore_0/__call__/[0]/[{i}]" for i in (0, 1)]
    + [f"{_HEAD}/__call__/[0]/[0]"]
    + [f"{_HEAD}/__call__/[0]/[1]/{k}" for k in ("attn_weights", "ortho_loss", "ortho_raw")]
    + [f"HashHead_0/{m}/__call__/[0]" for m in ("BatchNorm_0", "Dense_0")]
    + ["HashHead_0/__call__/[0]"]))

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


def _flagship_model(vit_kwargs=None, **overrides):
    """The flagship from its YAML kwargs at full width, random weights from
    seed 0; ``vit_kwargs`` are added to the backbone's (``FLASH``),
    ``overrides`` replace kwargs (``use_bn``)."""
    import torch

    from irw_tpu_torch.models import get_model

    kwargs = dict(FLAGSHIP["kwargs"], vit_kwargs=dict(vit_kwargs or {}), **overrides)
    model = _layerscale_one(get_model(FLAGSHIP["name"], seed=0, **kwargs))
    assert model.backbone.vit.dtype == torch.bfloat16
    return model


def _layerscale_one(model):
    """``model`` with every block's LayerScale set to 1 (at the 1e-5 init
    attention barely reaches the codes), after checking its tower is ViT-S/14
    at full width."""
    import torch

    vit = model.backbone.vit
    assert vit.embed_dim == 384 and len(vit.blocks) == 12
    with torch.no_grad():
        for blk in vit.blocks:
            blk.ls1.fill_(1.0)
            blk.ls2.fill_(1.0)
    return model


def _family_model(config: str):
    """``configs/model/<config>.yaml``'s model at full width (read with the
    port's YAML reader), random weights from seed 0, LayerScale set to 1."""
    import os

    from irw_tpu_torch import single_experiment_runner as runner
    from irw_tpu_torch.config import yaml_lite
    from irw_tpu_torch.models import get_model

    cfg = yaml_lite.load(os.path.join(runner.CONFIG_DIR, "model", f"{config}.yaml"))
    return _layerscale_one(get_model(cfg["name"], seed=0, **cfg["kwargs"]))


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


def _serve_flagship(state, phase: str, model, expected: tuple, plain_core, held: int,
                    what: str = "SWT + 4 x ViT-S/14 + fusion + hash, bf16"):
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
                   f"{BATCH}, {what}) | the path's own peak "
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


def _timed_steps(phase: str, state, tstate, step, batches, hyper, warmup: int, n: int,
                 expected: tuple, held: int, batch: int, what: str,
                 after_step=None) -> tuple[list, float]:
    """``warmup`` steps, then ``n`` timed ones in one window ended by a
    synchronize (each step's time between CUDA events beside it); the launches
    of every kernel per step must equal ``expected``; ``after_step(i)`` runs
    after timed step i is issued.  Returns (metrics per timed step, mean ms a
    step)."""
    import torch

    for i in range(warmup):  # cuBLAS handles, cuDNN plans, allocator, builds
        step(tstate, batches[i % len(batches)], hyper())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = _kernel_wrappers()
    for fn in kernels:
        fn.launches = 0
    per_step, metrics = [], []
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    t0 = time.perf_counter()
    for i in range(n):
        before = [fn.launches for fn in kernels]
        marks[i].record()
        metrics.append(step(tstate, batches[i % len(batches)], hyper()))
        per_step.append(tuple(fn.launches - b for fn, b in zip(kernels, before)))
        if after_step is not None:
            after_step(i)
    marks[-1].record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    counts = _launch_counts(kernels)
    state["launches"][phase] = counts
    peak = torch.cuda.max_memory_allocated() - held
    state.setdefault("timings", {})[phase] = (n * batch / seconds, peak)
    log(phase, f"launches over {n} steps: {counts}")
    _check_launches(phase, per_step, expected, "step")
    log(phase, f"{n * batch / seconds:.1f} trained img/s, {seconds / n * 1e3:.1f} ms per step "
               f"over the window (batch {batch}, {what}); steps " + ", ".join(f"{t:.1f}" for t in step_ms)
               + f" ms between CUDA events, median {statistics.median(step_ms):.1f} | the path's "
               f"own peak memory {peak / 2 ** 30:.2f} GiB (above {held / 2 ** 30:.2f} GiB held "
               f"before its model) | {state['card']}")
    return metrics, seconds / n * 1e3


def _check_finite(phase: str, metrics: list, names) -> None:
    for i, m in enumerate(metrics):
        values = {k: float(v) for k, v in m.items()}
        log(phase, f"step {i}: " + ", ".join(f"{k} {v:.6f}" for k, v in values.items()))
        if not all(math.isfinite(values[k]) for k in names):
            raise AssertionError(f"{phase} step {i}: non-finite metrics {values}")


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


def _train_flagship(state, phase: str, model, expected: tuple, plain_core, held: int,
                    what: str = "bf16, block remat, AdamW"):
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

    metrics, mean_ms = _timed_steps(phase, state, tstate, step, batches, hyper, WARMUP_CALLS,
                                    TRAIN_STEPS, expected, held, TRAIN_BATCH, what)
    _check_finite(phase, metrics, TRAIN_METRICS)

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


def _host_stage_times(host, dataset, seed: int) -> dict:
    """The host stage alone on batches of TRAIN_BATCH of ``dataset``: ms per
    batch for the train and the eval ops with no loader threads (median of
    HOST_BATCHES), and through ``EpochLoader`` with 8 threads (2 ·
    HOST_BATCHES batches, the wall time over their count)."""
    from irw_tpu_torch.data import EpochLoader

    order = np.random.RandomState(seed).permutation(len(dataset))
    batches = [order[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH] for i in range(2 * HOST_BATCHES)]
    out = {}
    for train in (True, False):
        times = []
        for b, idx in enumerate(batches[:HOST_BATCHES]):
            t0 = time.perf_counter()
            images = host.batch([dataset.images[i] for i in idx], np.random.RandomState(b), train)
            times.append((time.perf_counter() - t0) * 1e3)
        if images.shape != (TRAIN_BATCH, 224, 224, 3) or images.dtype != np.uint8:
            raise AssertionError(f"runner: the host stage gave {images.shape} {images.dtype}")
        t0 = time.perf_counter()
        n = sum(1 for _ in EpochLoader(dataset, batches, host, num_workers=8, train=train,
                                       seed=seed))
        out["train" if train else "eval"] = (statistics.median(times),
                                             (time.perf_counter() - t0) / n * 1e3)
    return out


def phase_runner(state):
    """The flagship study from its config through the port's runner
    (``irw_tpu_torch.single_experiment_runner``): the plan read with the
    port's YAML reader, its ortho_weight 0.1 job with RUNNER_CUTS, two
    epochs at full width through the host stage; launches per train step
    and per eval batch, the epochs' numbers, finite metrics; then the same
    call again returns the finished run's best score and launches nothing."""
    import importlib.util
    import os
    import shutil
    import tempfile

    import torch

    from irw_tpu_torch import single_experiment_runner as runner
    from irw_tpu_torch.config import compose
    from irw_tpu_torch.data import get_dataset
    from irw_tpu_torch.engine import load_checkpoint_meta
    from irw_tpu_torch.getter import Getter
    from irw_tpu_torch.studies.run_plan import expand_jobs, load_plan
    from irw_tpu_torch.transforms import build_transforms

    held = _release_earlier_phases(state)
    log("runner", f"host: os.cpu_count() {os.cpu_count()}; Pillow installed: "
                  f"{importlib.util.find_spec('PIL') is not None}, PyYAML installed: "
                  f"{importlib.util.find_spec('yaml') is not None} (the port uses neither)")
    repo = os.path.dirname(os.path.abspath(__file__))
    jobs = expand_jobs(load_plan(os.path.join(repo, RUNNER_PLAN)))
    (name, job), = [(n, o) for n, o in jobs if RUNNER_JOB in o]
    root = tempfile.mkdtemp(prefix="irw_runner_")
    overrides = job + RUNNER_CUTS + [f"experience.log_dir={root}"]
    log("runner", f"{len(jobs)} jobs in {RUNNER_PLAN}; running {name} with {RUNNER_CUTS}")

    config = compose(runner.CONFIG_DIR, "default", overrides)
    exp = config.experience
    if (config.dataset.sampler.kwargs.batch_size, exp.eval_bs, exp.num_workers) != (
            TRAIN_BATCH, 1000, 8) or config.dataset.kwargs.image_size != 64:
        raise AssertionError(f"runner: the study's settings changed: {config.dataset}, {exp}")
    host, _ = build_transforms(config.transform.train, device="cpu")
    dataset = get_dataset(config.dataset.name, **config.dataset.kwargs)
    for split, (alone, threaded) in _host_stage_times(host, dataset, 0).items():
        log("runner", f"host stage ({split} ops, {TRAIN_BATCH} images of 64² → 224²): "
                      f"{alone:.1f} ms a batch alone (median of {HOST_BATCHES}), {threaded:.1f} ms "
                      f"a batch through EpochLoader with 8 threads | {state['card']}")
    del dataset

    kernels = _kernel_wrappers()
    wrapped = []
    get_transform = Getter.get_transform

    def counting(self, transform_config, device=None):
        (h, d), test = get_transform(self, transform_config, device)
        wrapped.append(_UnitLaunches(d, kernels))
        return (h, wrapped[-1]), test

    Getter.get_transform = counting
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        if runner.main(overrides) != 0:
            raise AssertionError("runner: main returned non-zero")
        run_seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        counts = _launch_counts(kernels)
        (transform,) = wrapped
        steps, evals = transform.units(False), transform.units(True)
        state["launches"]["runner"] = {fn.__name__: sum(u[i] for u in steps)
                                       for i, fn in enumerate(kernels)}
        state["launches"]["runner_eval"] = {fn.__name__: sum(u[i] for u in evals)
                                            for i, fn in enumerate(kernels)}
        log("runner", f"launches over the run: {counts}")
        if len(steps) != RUNNER_EPOCHS * RUNNER_STEPS or len(evals) != RUNNER_EVAL_UNITS:
            raise AssertionError(f"runner: {len(steps)} train steps and {len(evals)} "
                                 f"inference batches, expected {RUNNER_EPOCHS * RUNNER_STEPS} "
                                 f"and {RUNNER_EVAL_UNITS}")
        _check_launches("runner", steps, (1, 24, 12, 0, 0, 0, 0), "train step")
        _check_launches("runner", evals, (1, 12, 0, 0, 0, 0, 0),
                        "eval batch (the first: the memory's embedding-size probe)")

        log_dir = os.path.join(root, name)
        records = _jsonl(os.path.join(log_dir, "metrics.jsonl"))
        epochs = [r for r in records if "train/total_loss" in r]
        if [r["step"] for r in epochs] != list(range(1, RUNNER_EPOCHS + 1)):
            raise AssertionError(f"runner: epoch records {[r['step'] for r in epochs]}")
        for r in epochs:
            ips = RUNNER_STEPS * TRAIN_BATCH / r["train/train_seconds"]
            log("runner", f"epoch {r['step']}: {r['train/train_seconds']:.3f} s, {ips:.1f} "
                          f"trained img/s ({RUNNER_STEPS} steps of {TRAIN_BATCH}); data_seconds "
                          f"{r['train/data_seconds']:.4f}, step_seconds "
                          f"{r['train/step_seconds']:.4f} | {state['card']}")
            if not all(math.isfinite(v) for v in r.values()):
                raise AssertionError(f"runner: non-finite epoch metrics {r}")
        evaluated = [r for r in records if "test/map_level0" in r]
        if ([r["step"] for r in evaluated] != [RUNNER_EPOCHS]
                or not all(math.isfinite(v) for v in evaluated[0].values())
                or not 0.0 <= evaluated[0]["test/map_level0"] <= 1.0):
            raise AssertionError(f"runner: eval records {evaluated}")
        log("runner", f"eval at epoch {RUNNER_EPOCHS}: {evaluated[0]['test/eval_seconds']:.3f} s "
                      f"({RUNNER_QUERY} queries against {RUNNER_TRAIN} through the host stage, "
                      f"eval_bs {exp.eval_bs}); map_level0 {evaluated[0]['test/map_level0']:.4f}")
        log("runner", f"the run: {run_seconds:.1f} s; its own peak memory "
                      f"{peak / 2 ** 30:.2f} GiB (above {held / 2 ** 30:.2f} GiB held before) | "
                      f"{state['card']}")
        best = load_checkpoint_meta(log_dir)["best_score"]
    finally:
        Getter.get_transform = get_transform

    try:
        # the finished-run check: the same job again trains nothing
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        score = runner.run_one(overrides)
        seconds = time.perf_counter() - t0
        again = _launch_counts(kernels)
        n_records = len(_jsonl(os.path.join(log_dir, "metrics.jsonl")))
        log("runner", f"second call: best_score {score} in {seconds:.3f} s (the first run's "
                      f"{best}), launches {again}, {n_records} records (before: {len(records)})")
        if score != best or any(again.values()) or n_records != len(records):
            raise AssertionError("runner: the finished-run check trained again")
    finally:
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


def _k4_yardstick_filters() -> dict:
    """The ``conv2d`` filters K4 is timed beside, (4, 1, k, k) f32 on the
    CPU: haar's four 2 x 2 haar · v6 filters, which give the same bands up
    to rounding at stride 2, and the four 9 x 9 CDF 9/7 analysis filters
    (outer products of the 9-tap low-pass and the zero-padded 7-tap
    high-pass), whose boundary handling and band scaling are the filter
    bank's, not the lifting's: timed, not compared."""
    import torch

    r = 1.0 / math.sqrt(2.0)
    lo = torch.tensor([0.026748757411, -0.016864118443, -0.078223266529, 0.266864118443,
                       0.602949018236, 0.266864118443, -0.078223266529, -0.016864118443,
                       0.026748757411])
    hi = torch.tensor([0.0, 0.091271763114, -0.057543526229, -0.591271763114, 1.115087052457,
                       -0.591271763114, -0.057543526229, 0.091271763114, 0.0])
    return {"haar": torch.tensor([[[[0.25, 0.25], [0.25, 0.25]]], [[[-0.5, -0.5], [0.5, 0.5]]],
                                  [[[-0.5, 0.5], [-0.5, 0.5]]], [[[r, -r], [-r, r]]]]),
            "cdf97": torch.stack([torch.outer(a, b) for a, b in ((lo, lo), (hi, lo), (lo, hi),
                                                                 (hi, hi))])[:, None]}


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
    # yardstick of cost: one conv2d with the 9 x 9 analysis filters, TF32 off
    filt97 = _k4_yardstick_filters()["cdf97"].cuda()
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
    # yardstick: conv2d, stride 2, with the haar · v6 filters; TF32 off so it
    # is the same f32 math
    filt = _k4_yardstick_filters()["haar"].cuda()
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
        state.setdefault("timings", {})["wcnn"] = (WCNN_BATCHES * BATCH / seconds, peak)
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


K4_LOW_CASES = [("haar", 1, K4_SHAPE), ("cdf97", 1, K4_CDF97_SHAPE),
                ("cdf97", 5, (3 * BATCH, 256, 256))]     # register, tile, two-pass
LIBRARY_TOL = 1e-5       # the filter-bank library on the card against the CPU, relative
# the two DWT configs as a user composes them (configs/model, configs/transform)
DWT_PATHS = {"A": ["model=wcnn_attention_all_subs", "transform=dwt_all_subs"],
             "B": ["model=wcnn_attention_ce", "transform=cifar_dwt"]}
DWT_PATH_BANDS = {"A": (7, 112), "B": (4, 112)}
DWT_EVAL = (2 * BATCH, 6 * BATCH)   # synthetic query and gallery of each path's evaluate


def _k4_low_precision(state, dtype) -> dict:
    """K4 in ``dtype`` against its plain version on K4_LOW_CASES, bit for
    bit, on the path ``lifting_kernel_variants`` names; the served haar case
    and cdf97's timed beside the plain version, the bound and ``conv2d`` in
    ``dtype``; returns the numbers."""
    import torch
    import torch.nn.functional as F

    from irw_tpu_torch.ops.wavelets import lifting_multi_level, lifting_multi_level_plain
    from irw_tpu_torch.ops.wavelets.lifting_dwt import lifting_kernel_variants

    name = str(dtype).removeprefix("torch.")
    filters = _k4_yardstick_filters()
    out_rec = {}
    for basis, levels, shape in K4_LOW_CASES:
        gen = torch.Generator(device="cuda").manual_seed(8)
        x = (torch.rand(shape, generator=gen, device="cuda") * 2.0 - 1.0).to(dtype)
        before = lifting_multi_level.launches
        out = lifting_multi_level(x, levels, basis)
        ref = lifting_multi_level_plain(x, levels, basis)
        torch.cuda.synchronize()
        path = lifting_multi_level.last_path
        err = (out.float() - ref.float()).abs().max().item()
        n, h, w = shape
        key = f"{basis} l={levels} {tuple(shape)}"
        msg = f"K4 {key} {name}, {path} path: max|kernel - plain| = {err:.3e} (limit 0.0)"
        if not (err == 0.0 and out.dtype == dtype and torch.isfinite(out.float()).all()):
            raise AssertionError(f"K4 {key} {name} disagrees with its plain version: {err}")
        if (path != lifting_kernel_variants(h, w, levels, basis)["path"]
                or lifting_multi_level.launches != before + 1):
            raise AssertionError(f"K4 {key} {name}: {lifting_multi_level.launches - before} "
                                 f"launches on the {path} path")
        rec = {"path": path, "max_abs_err": err}
        if levels == 1:
            rec.update(k4_times(lambda: lifting_multi_level(x, levels, basis)))
            rec["plain_ms"] = time_ms(lambda: lifting_multi_level_plain(x, levels, basis), iters=5)
            nbytes = x.element_size() * (n * h * w + n * 4 * (h >> levels) * (w >> levels))
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                nbytes, _lifting_flops(n, h, w, levels, basis), "float32")
            filt = filters[basis].to(device="cuda", dtype=dtype)
            x4 = x[:, None]
            pad = 0 if basis == "haar" else 4
            with torch.no_grad():
                rec["library_ms"] = time_ms(lambda: F.conv2d(x4, filt, stride=2, padding=pad))
            msg += (f" | kernel {rec['ms']:.4f} ms, L2 flushed {rec['cold_ms']:.4f} ms, device "
                    f"{rec['device_ms']:.4f} ms, host {rec['host_ms']:.4f} ms | plain "
                    f"{rec['plain_ms']:.4f} ms | conv2d {name} ({basis} analysis filters, stride "
                    f"2) {rec['library_ms']:.4f} ms | bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']}) | {state['card']}")
        out_rec[key] = rec
        log("wavelets", msg)
        del x, out, ref
    return out_rec


def _k4_wrappers(dtype):
    """``haar_multi_level``, ``cdf97_multi_level`` and ``haar_dwt2_fused``: one
    K4 launch each, bit for bit the plain version of their basis."""
    import torch

    from irw_tpu_torch.ops.wavelets import (
        cdf97_multi_level,
        haar_dwt2_fused,
        haar_multi_level,
        lifting_multi_level,
        lifting_multi_level_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(9)
    x = (torch.rand(K4_SHAPE, generator=gen, device="cuda") * 2.0 - 1.0).to(dtype)
    counts = {}
    for fn, args, basis, levels in [(haar_multi_level, (2,), "haar", 2),
                                    (cdf97_multi_level, (2,), "cdf97", 2),
                                    (haar_dwt2_fused, (), "haar", 1)]:
        before = lifting_multi_level.launches
        out = fn(x, *args)
        counts[fn.__name__] = lifting_multi_level.launches - before
        torch.cuda.synchronize()
        if not torch.equal(out, lifting_multi_level_plain(x, levels, basis)):
            raise AssertionError(f"{fn.__name__} {dtype} disagrees with the plain version")
    log("wavelets", f"K4 wrappers {dtype}: launches {counts} (one each), bit for bit the plain "
                    f"version")
    if set(counts.values()) != {1}:
        raise AssertionError(f"K4 wrappers: launches {counts}")
    return counts


def _library_on_card(state, images) -> None:
    """The filter-bank library on the planes of a served batch, on the card
    and on the CPU, with TF32 allowed in cuDNN and cuBLAS (the port calls
    neither: a TF32 leak would show here as 1e-3 errors)."""
    import torch

    from irw_tpu_torch.ops.wavelets import (
        iswt2,
        lifting_dwt2,
        lifting_idwt2,
        resize_bilinear,
        swt2,
        wavedec2,
        waverec2,
    )

    planes = images.float().div(255.0).permute(0, 3, 1, 2).reshape(-1, 224, 224)

    def calls(x):
        db2 = wavedec2(x, "db2", level=2, mode="symmetric")
        haar = wavedec2(x, "haar", level=2, mode="symmetric")
        swt = swt2(x, "db2", level=2)
        ll = haar[0].reshape(BATCH, 3, 56, 56).permute(0, 2, 3, 1)
        lift = lifting_dwt2(x, "cdf97")
        return {"wavedec2 db2 l=2 symmetric": [db2[0], *db2[1], *db2[2]],
                "wavedec2 haar l=2 symmetric": [haar[0], *haar[1], *haar[2]],
                "swt2 db2 l=2": [b for ca, det in swt for b in (ca, *det)],
                "resize 56 → 112": [resize_bilinear(ll, 112)],
                "resize 56 → 24": [resize_bilinear(ll, 24)],
                "waverec2 db2": [waverec2(db2, "db2", mode="symmetric")],
                "waverec2 haar": [waverec2(haar, "haar", mode="symmetric")],
                "iswt2 db2": [iswt2(swt, "db2")],
                "lifting_idwt2 cdf97": [lifting_idwt2(*lift, "cdf97")]}

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = calls(planes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls(planes)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    cpu = calls(planes.cpu())
    worst = 0.0
    for what, outs in card.items():
        errs = []
        for ours, ref in zip(outs, cpu[what]):
            rel = (ours.cpu() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
            errs.append(rel)
        worst = max(worst, *errs)
        log("wavelets", f"{what} on {tuple(planes.shape)}: max|card - CPU| / max(1, max|CPU|) "
                        f"= {max(errs):.3e} (limit {LIBRARY_TOL})")
        if not max(errs) <= LIBRARY_TOL:
            raise AssertionError(f"{what}: the card is {max(errs)} from the CPU")
    log("wavelets", f"the library's {len(card)} calls on the card, TF32 allowed in cuDNN and "
                    f"cuBLAS: {card_ms:.1f} ms for all; worst {worst:.3e} | {state['card']}")


def _dwt_path(state, label: str) -> dict:
    """One DWT config at full width, as a user composes it: WARMUP_CALLS and
    SERVE_BATCHES timed batches of BATCH through the test split's device
    stage and the getter's model; one batch against the CPU transform's
    bands; then the cosine ``evaluate`` on a synthetic query/gallery through
    both stages.  Returns its numbers."""
    import torch

    from irw_tpu_torch import single_experiment_runner as runner
    from irw_tpu_torch.config import compose
    from irw_tpu_torch.data import SyntheticDataset
    from irw_tpu_torch.engine import evaluate
    from irw_tpu_torch.getter import Getter
    from irw_tpu_torch.models.wresnet import WCNNAttention
    from irw_tpu_torch.transforms import DeviceTransform, build_transforms

    held = _release_earlier_phases(state)
    config = compose(runner.CONFIG_DIR, "default", DWT_PATHS[label])
    host, device = build_transforms(config.transform.test)
    bands, side = DWT_PATH_BANDS[label]
    t0 = time.perf_counter()
    model = Getter().get_model(config.model, seed=0)
    build_s = time.perf_counter() - t0
    if not (isinstance(model, WCNNAttention) and len(model.backbone.branches) == bands
            and model.backbone.out_dim == 2048):
        raise AssertionError(f"path {label}: the getter built {type(model).__name__} with "
                             f"{len(model.backbone.branches)} branches")
    desc = (f"path {label} ({' '.join(DWT_PATHS[label])}): host {[n for n, _ in host.ops]}, "
            f"device {[n for n, _ in device.ops]}, {bands} x ResNet-50 at {side}², "
            f"{config.model.kwargs.embed_dim}-d config, model built in {build_s:.1f} s")
    log("wavelets", desc)
    gen = torch.Generator(device="cuda").manual_seed(10)
    batches = [torch.randint(0, 256, (BATCH, 224, 224, 3), generator=gen, device="cuda",
                             dtype=torch.uint8) for _ in range(SERVE_DISTINCT)]
    kernels = _kernel_wrappers()
    with torch.inference_mode():
        x = device(batches[0])
        if x.shape != (BATCH, bands, side, side, 3):
            raise AssertionError(f"path {label}: device stage gave {tuple(x.shape)}")
        for i in range(WARMUP_CALLS):
            model(device(batches[i % SERVE_DISTINCT]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        per_batch, outs = [], []
        t0 = time.perf_counter()
        for i in range(SERVE_BATCHES):
            before = [fn.launches for fn in kernels]
            outs.append(model(device(batches[i % SERVE_DISTINCT]))[0])
            per_batch.append(tuple(fn.launches - b for fn, b in zip(kernels, before)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        counts = _launch_counts(kernels)
        state["launches"][f"wavelets_{label}"] = counts
        _check_launches("wavelets", per_batch, (0,) * len(kernels), f"batch, path {label}")
        ips = SERVE_BATCHES * BATCH / seconds
        log("wavelets", f"path {label}: {ips:.1f} img/s over {SERVE_BATCHES} batches of {BATCH} "
                        f"after {WARMUP_CALLS} warm-up ({seconds / SERVE_BATCHES * 1e3:.1f} ms a "
                        f"batch: device stage + model) | its own peak memory "
                        f"{peak / 2 ** 30:.2f} GiB | K4 launches {counts['lifting_multi_level']}"
                        f" | cuDNN TF32 {torch.backends.cudnn.allow_tf32} | {state['card']}")
        emb = outs[0]
        cpu = DeviceTransform(device.ops, device="cpu")
        ref = model(cpu(batches[0].cpu()).cuda())[0]
        dmax = (emb - ref).abs().max().item()
        log("wavelets", f"path {label}, batch 0: max|emb - the model fed the CPU transform's bands|"
                        f" = {dmax:.3e} (limit {WCNN_EMB_TOL})")
        if not (emb.shape == (BATCH, 2048) and torch.isfinite(emb).all()
                and dmax <= WCNN_EMB_TOL):
            raise AssertionError(f"path {label}: embeddings {tuple(emb.shape)}, {dmax} from the "
                                 "CPU transform's")
    nq, ng = DWT_EVAL
    query = SyntheticDataset(num_samples=nq, num_classes=100, image_size=224, seed=11)
    gallery = SyntheticDataset(num_samples=ng, num_classes=100, image_size=224, seed=12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = evaluate(model, {"query": query, "gallery": gallery}, device, batch_size=BATCH,
                   distance_metric="cosine", host_transform=host)
    eval_s = time.perf_counter() - t0
    log("wavelets", f"path {label}: evaluate (cosine) of {nq} queries against {ng} through the "
                    f"host and device stages: {eval_s:.2f} s; map {res['map_level0']:.4f}, "
                    f"recall@1 {res['recall_at_1_level0']:.4f} | {state['card']}")
    if not (all(math.isfinite(v) for v in res.values()) and 0.0 <= res["map_level0"] <= 1.0):
        raise AssertionError(f"path {label}: evaluate gave {res}")
    del model, batches, outs
    _release_earlier_phases(state)
    return {"img_per_s": ips, "peak_gib": peak / 2 ** 30, "eval_s": eval_s,
            "k4_launches": counts["lifting_multi_level"]}


def phase_wavelets(state):
    """K4 in bf16 and f16, its wrappers, the filter-bank library on the card,
    and the two DWT configs end to end at full width."""
    import torch

    low = {}
    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype).removeprefix("torch.")
        low[name] = _k4_low_precision(state, dtype)
        low[name]["wrapper_launches"] = _k4_wrappers(dtype)
    served = low["bfloat16"][f"haar l=1 {K4_SHAPE}"]
    rec = state["kernels"].setdefault("lifting_multi_level", {
        "name": "lifting_multi_level", "route": "cuda",
        "source": "irw_tpu_torch/csrc/lifting_dwt.cu",
        "replaces": "irw_tpu/ops/wavelets/pallas_dwt.py:208", "dtype": "bfloat16",
        **{k: served[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "path")}})
    rec.update(low)
    gen = torch.Generator(device="cuda").manual_seed(13)
    _library_on_card(state, torch.randint(0, 256, (BATCH, 224, 224, 3), generator=gen,
                                          device="cuda", dtype=torch.uint8))
    state["dwt_paths"] = {label: _dwt_path(state, label) for label in DWT_PATHS}


def _cub_batches(n: int, seed: int, memory: int | None = None) -> list:
    """``n`` batches of CUB_BATCH uint8 224² images and labels in [0, 200),
    made on the card from ``seed``; with ``memory``, distinct slot indices."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = []
    for _ in range(n):
        batch = {"image": torch.randint(0, 256, (CUB_BATCH, 224, 224, 3), generator=gen,
                                        device="cuda", dtype=torch.uint8),
                 "label": torch.randint(0, CUB_CLASSES, (CUB_BATCH,), generator=gen,
                                        device="cuda", dtype=torch.int32)}
        if memory:
            batch["index"] = torch.randperm(memory, generator=gen, device="cuda")[:CUB_BATCH]
        batches.append(batch)
    return batches


def _k4_route_step(tstate, step, batch, hyper, snapshot, plain: bool):
    """One step from the ``snapshot`` weights with K4 or with its plain
    version at both call sites; (total_loss, the gradient of each top-level
    module, flattened, frozen parameters left out)."""
    import torch

    model = tstate.model
    model.load_state_dict(snapshot)
    with _k4_plain() if plain else contextlib.nullcontext():
        metrics = step(tstate, batch, hyper)
    grads = {name: torch.cat([p.grad.flatten() for p in child.parameters()
                              if p.grad is not None])
             for name, child in model.named_children()}
    return float(metrics["total_loss"]), grads


def _hold_k4_route(phase: str, tstate, step, batch, hyper):
    """The same train step from the same weights on K4's route and on its
    plain route: total_loss within ROUTE_LOSS_TOL, the gradient of each
    top-level module at cosine ROUTE_COSINE or more."""
    import torch

    snapshot = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    loss_k, grads_k = _k4_route_step(tstate, step, batch, hyper(), snapshot, plain=False)
    loss_p, grads_p = _k4_route_step(tstate, step, batch, hyper(), snapshot, plain=True)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cosines = {m: float(torch.nn.functional.cosine_similarity(grads_k[m], grads_p[m], dim=0))
               for m in grads_k}
    log(phase, f"K4 vs plain route: total_loss {loss_k:.6f} vs {loss_p:.6f} (rel {rel:.2e}, "
               f"limit {ROUTE_LOSS_TOL}); gradient cosine per module "
               + ", ".join(f"{m} {c:.6f}" for m, c in cosines.items())
               + f" (limit {ROUTE_COSINE})")
    if not (rel <= ROUTE_LOSS_TOL and all(c >= ROUTE_COSINE for c in cosines.values())):
        raise AssertionError(f"{phase}: the K4 route disagrees with the plain route: {rel}, "
                             f"{cosines}")


def phase_wcnn_train(state):
    """The WCNN CE path trains at full width: WARMUP_CALLS steps, then
    WCNN_TRAIN_STEPS timed ones at CUB's batch (K4 once a step); the K4
    route against the plain route from identical weights; one step
    profiled."""
    from irw_tpu_torch.engine import build_train_step, init_train_state
    from irw_tpu_torch.engine.train import _build_hyper
    from irw_tpu_torch.losses import build_losses
    from irw_tpu_torch.models import get_model
    from irw_tpu_torch.transforms import DeviceTransform

    held = _release_earlier_phases(state)
    model = get_model(WCNN["name"], seed=0, **WCNN["kwargs"])
    tstate = init_train_state(model, build_losses(WCNN_CE_LOSS), CUB_WRESNET, WCNN_CE_LOSS,
                              seed=0)
    step = build_train_step(DeviceTransform(DWT_OPS))
    batches = _cub_batches(2, seed=6)

    def hyper():
        return _build_hyper(tstate.optimizer_entries, 1, tstate.step, 0, None)

    metrics, step_ms = _timed_steps(
        "wcnn_train", state, tstate, step, batches, hyper, WARMUP_CALLS, WCNN_TRAIN_STEPS,
        (0, 0, 0, 1, 0, 0, 0), held, CUB_BATCH, "Normalize + haar DWT + 4 x ResNet-50 at 112² "
        "+ CBAM gate + 5 CE heads, f32 with TF32 convs, Adam; images made on the card: the "
        "host stage is outside the window, ROADMAP M0")
    _check_finite("wcnn_train", metrics, WCNN_TRAIN_METRICS)

    _hold_k4_route("wcnn_train", tstate, step, batches[0], hyper)

    busy_ms = _device_profile("wcnn_train", lambda: step(tstate, batches[1], hyper()),
                              f"one train step of {CUB_BATCH}", state, _WCNN_GROUPS)
    if busy_ms is not None:
        log("wcnn_train", f"idle share against the timed steps' {step_ms:.1f} ms: "
                          f"{1 - busy_ms / step_ms:.3f}")


def _roadmap_terms(losses, emb, labels, ref_emb, ref_labels, valid, supap_memory=None):
    """The four terms of ``configs/loss/roadmap.yaml`` with a memory, as the
    train step forms them: each loss on the batch and against the memory
    (invalid slots zeroed, inert labels, −1e9 scores); ``supap_memory``
    replaces the SupAP memory call."""
    import torch

    from irw_tpu_torch.losses import LossContext
    from irw_tpu_torch.utils.label_matrix import create_label_matrix

    cal, sup = losses[0][0], losses[1][0]
    ref = ref_emb * valid[:, None]
    ref_labels = torch.where(valid, ref_labels, -1)
    scores = torch.where(valid[None, :], emb @ ref.T, -1e9)
    target = create_label_matrix(labels, ref_labels, dtype=emb.dtype)
    memory = (supap_memory(sup, scores, target) if supap_memory else
              sup(LossContext(labels=labels, scores=scores, label_matrix=target))[0])
    return {
        "loss_0_CalibrationLoss": cal(LossContext(labels=labels, embeddings=emb))[0],
        "loss_0_memory_CalibrationLoss": cal(LossContext(
            labels=labels, embeddings=emb, ref_embeddings=ref, ref_labels=ref_labels))[0],
        "loss_1_SupAP": sup(LossContext(labels=labels, embeddings=emb, scores=emb @ emb.T,
                                        label_matrix=create_label_matrix(labels,
                                                                         dtype=emb.dtype)))[0],
        "loss_1_memory_SupAP": memory,
    }


def _supap_rows(sup, scores, target):
    """SupAP's general path (1 − mAP over the queries) from the rows that
    count: a row i adds target[i] · pos_rank[i] / rank[i] to its query's AP,
    so only the query's positives are built, (P, M) instead of (M, M)."""
    import torch

    m = scores.shape[1]
    aps = []
    for s, t in zip(scores, target):
        rows = t.nonzero().flatten()
        diff = s[None, :] - s[rows][:, None]  # diff[r, j] = s[j] − s[rows[r]]
        approx = sup.rank_approx(diff, t, general=True)
        approx = approx * (torch.arange(m)[None, :] != rows[:, None]).to(s.dtype)
        rank = 1.0 + approx.sum(-1)
        pos_rank = 1.0 + (approx * t[None, :]).sum(-1)
        aps.append((pos_rank / rank).sum() / torch.clamp(t.sum(), min=1.0))
    return 1.0 - torch.stack(aps).mean()


def phase_wcnn_xbm(state):
    """The ROADMAP lineage's CUB recipe at full width: ``wcnn_attention``'s
    unit 2048-d embeddings, CalibrationLoss + SupAP, the 5824-slot XBM filled
    first through its own insert, XBM_WARMUP steps then XBM_STEPS timed
    ones with the memory term on (the general rank path at full M); the
    first timed step's four terms against float64 on the CPU."""
    import torch

    from irw_tpu_torch.engine import build_train_step, get_memory, init_train_state
    from irw_tpu_torch.engine.train import _build_hyper
    from irw_tpu_torch.losses import build_losses, rank_ap
    from irw_tpu_torch.models import get_model
    from irw_tpu_torch.transforms import DeviceTransform

    held = _release_earlier_phases(state)
    model = get_model(WCNN_EMB["name"], seed=0, **WCNN_EMB["kwargs"])
    xbm = get_memory(CUB_MEMORY, 2048)
    tstate = init_train_state(model, build_losses(ROADMAP_LOSS), CUB_OPTIMIZER, ROADMAP_LOSS,
                              seed=0, xbm=xbm)
    gen = torch.Generator(device="cuda").manual_seed(7)
    fill = torch.nn.functional.normalize(
        torch.randn(xbm.size, 2048, generator=gen, device="cuda"), dim=1)
    tstate.xbm_state = xbm.update(
        tstate.xbm_state, fill, torch.randint(0, CUB_CLASSES, (xbm.size,), generator=gen,
                                              device="cuda", dtype=torch.int32),
        torch.arange(xbm.size, device="cuda"))
    assert bool(tstate.xbm_state.valid.all())
    step = build_train_step(DeviceTransform(DWT_OPS), xbm=xbm, xbm_active=True)
    batches = _cub_batches(XBM_WARMUP + XBM_STEPS, seed=8, memory=xbm.size)

    def hyper():
        return _build_hyper(tstate.optimizer_entries, 1, tstate.step, 0, None)

    for i in range(XBM_WARMUP):
        step(tstate, batches[i], hyper())

    kept = {}

    def keep_first(i):
        """What the first timed step's losses read: the memory after its insert
        (copied on the card) and, in its slots, the batch's embeddings."""
        if i == 0:
            mem = tstate.xbm_state
            kept["contents"] = [t.clone() for t in (mem.embeddings, mem.labels, mem.valid)]
            kept["emb"] = mem.embeddings[batches[XBM_WARMUP]["index"].long() % xbm.size].clone()

    metrics, step_ms = _timed_steps(
        "wcnn_xbm", state, tstate, step, batches[XBM_WARMUP:], hyper, 0, XBM_STEPS,
        (0, 0, 0, 1, 0, 0, 0), held, CUB_BATCH, "Normalize + haar DWT + 4 x ResNet-50 at 112² "
        f"+ CBAM gate, CalibrationLoss + SupAP with their memory terms over {xbm.size} slots, "
        "Adam; images made on the card: the host stage is outside the window, ROADMAP M0",
        after_step=keep_first)
    _check_finite("wcnn_xbm", metrics, XBM_TERMS + ("total_loss", "grad_norm"))
    checked, contents, emb = metrics[0], kept["contents"], kept["emb"]
    labels = batches[XBM_WARMUP]["label"]

    # the first timed step's terms: the card's (f32) and float64 on the CPU
    t0 = time.perf_counter()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    x = emb.clone().requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    marks[0].record()
    card = _roadmap_terms(tstate.losses, x, labels, *contents)
    sum(card.values()).backward()
    marks[1].record()
    torch.cuda.synchronize()
    terms_peak = torch.cuda.max_memory_allocated() - base
    chunk = max(1, rank_ap.GENERAL_CHUNK_ELEMENTS // xbm.size ** 2)
    cpu_losses = [(loss.cpu().double(), w) for loss, w in build_losses(ROADMAP_LOSS)]
    x64 = emb.double().cpu().requires_grad_()
    ref = _roadmap_terms(cpu_losses, x64, labels.cpu(),
                         *(c.double().cpu() if c.is_floating_point() else c.cpu()
                           for c in contents), supap_memory=_supap_rows)
    sum(ref.values()).backward()
    cosine = float(torch.nn.functional.cosine_similarity(x.grad.double().cpu().flatten(),
                                                         x64.grad.flatten(), dim=0))
    ref = {k: float(v.detach()) for k, v in ref.items()}
    rels = {k: abs(float(checked[k]) - v) / abs(v) for k, v in ref.items()}
    log("wcnn_xbm", "first timed step's terms (card f32 | CPU float64): " + ", ".join(
        f"{k} {float(checked[k]):.7f} | {v:.7f} (rel {rels[k]:.1e})" for k, v in ref.items())
        + f"; the card's recomputed terms "
        + ", ".join(f"{float(v.detach()):.7f}" for v in card.values())
        + f" (forward and backward of the four terms {marks[0].elapsed_time(marks[1]):.1f} ms "
        f"of the {step_ms:.1f} ms step, their own peak memory {terms_peak / 2 ** 30:.2f} GiB: "
        f"SupAP's memory term in chunks of {chunk} queries, a ({chunk}, {xbm.size}, "
        f"{xbm.size}) f32 tensor {chunk * xbm.size ** 2 * 4 / 2 ** 30:.2f} GiB)"
        + f"; gradient cosine against the embeddings {cosine:.6f} (limits {XBM_TERM_TOL} "
        f"relative, {XBM_COSINE}); {time.perf_counter() - t0:.1f} s")
    if not (all(r <= XBM_TERM_TOL for r in rels.values()) and cosine >= XBM_COSINE):
        raise AssertionError(f"wcnn_xbm: the memory terms disagree with float64: {rels}, "
                             f"{cosine}")


def _loss_configs() -> list:
    """(file, entry) for every loss of ``configs/loss/*.yaml``, read with the
    port's YAML reader, ``${dataset.num_classes}`` set to CUB's 200 classes
    and ``${model.kwargs.embed_dim}`` to 512."""
    import glob
    import os

    from irw_tpu_torch.config import yaml_lite

    root = os.path.dirname(os.path.abspath(__file__))
    out = []
    for path in sorted(glob.glob(os.path.join(root, "configs", "loss", "*.yaml"))):
        with open(path) as f:
            text = f.read().replace("${dataset.num_classes}", str(CUB_CLASSES))
        for entry in yaml_lite.loads(text.replace("${model.kwargs.embed_dim}", "512")):
            out.append((os.path.basename(path), entry))
    return out


def _loss_inputs(loss, name: str, memory: bool, seed: int) -> dict:
    """Seeded numpy inputs of one call: ``x`` (an array, or a list for a
    branch loss), ``labels``, and for a memory call the (B, M) scores with the
    memory's labels, or the reference embeddings and labels."""
    from irw_tpu_torch.losses import LossKind

    rng = np.random.RandomState(seed)
    hashing = name in HASHING_LOSSES
    d = 64 if hashing else 512

    def unit(n):
        x = rng.randn(n, d).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    def labels(n):
        if hashing:  # VOC's multi-label rows
            y = (rng.rand(n, 20) > 0.85).astype(np.float32)
            y[np.arange(n), rng.randint(0, 20, n)] = 1.0
            return y
        return rng.randint(0, CUB_CLASSES, n).astype(np.int32)

    out = {"labels": labels(CUB_BATCH)}
    size = CUB_MEMORY["kwargs"]["size"]
    if loss.kind == LossKind.BRANCHES:
        width = CUB_CLASSES if name == "MultiCrossEntropyLoss" else d
        out["x"] = [rng.randn(CUB_BATCH, width).astype(np.float32)
                    for _ in range(5 if name == "MultiCrossEntropyLoss" else 4)]
    elif loss.kind == LossKind.LOGITS:
        out["x"] = 2.0 * rng.randn(CUB_BATCH, CUB_CLASSES).astype(np.float32)
    elif loss.kind == LossKind.SCORES:
        emb = unit(CUB_BATCH)
        other = unit(size) if memory else emb
        out["x"] = emb @ other.T
        out["other_labels"] = labels(size) if memory else None
    else:
        out["x"] = (3.0 * rng.randn(CUB_BATCH, d).astype(np.float32) if hashing
                    else unit(CUB_BATCH))
        if memory:
            out["ref"], out["ref_labels"] = unit(size), labels(size)
    return out


def _loss_call(loss, state, inp: dict, device: str, rows: int | None = None):
    """The loss on ``device`` (its first ``rows`` queries with ``rows``):
    (value, gradients with respect to the inputs, or None)."""
    import torch

    from irw_tpu_torch.losses import LossContext, LossKind
    from irw_tpu_torch.utils.label_matrix import create_label_matrix

    def t(a, grad=False):
        a = a[:rows] if rows is not None and grad else a
        return torch.tensor(a, device=device, requires_grad=grad)

    labels = t(inp["labels"])
    labels = labels[:rows] if rows is not None else labels
    branches = isinstance(inp["x"], list)
    xs = [t(a, True) for a in inp["x"]] if branches else [t(inp["x"], True)]
    if loss.kind == LossKind.BRANCHES:
        ctx = LossContext(labels=labels, branches=xs)
    elif loss.kind == LossKind.SCORES:
        other = None if inp["other_labels"] is None else t(inp["other_labels"])
        ctx = LossContext(labels=labels, scores=xs[0],
                          label_matrix=create_label_matrix(labels, other))
    elif "ref" in inp:
        ctx = LossContext(labels=labels, embeddings=xs[0], ref_embeddings=t(inp["ref"]),
                          ref_labels=t(inp["ref_labels"]))
    else:
        ctx = LossContext(labels=labels, embeddings=xs[0])
    value = loss(ctx, state)[0].mean()
    grads = (torch.autograd.grad(value, xs, allow_unused=True) if value.requires_grad
             else None)
    return value.detach(), grads


def _grad_cosine(card, cpu) -> float:
    import torch

    a = torch.cat([g.double().cpu().flatten() for g in card])
    b = torch.cat([g.double().flatten() for g in cpu])
    if not (a.any() or b.any()):
        return 1.0
    return float(torch.nn.functional.cosine_similarity(a, b, dim=0))


def phase_losses(state):
    """Every loss ``build_losses`` makes from ``configs/loss/*.yaml`` (each
    distinct entry once) on the card at CUB's batch, the memory readers also
    against 5824 slots, held against the same call on the CPU from the same
    seeded inputs: the value within LOSS_TOL relative, the gradient cosine
    at least LOSS_COSINE, BlackBoxAP's ranks equal."""
    import copy

    import torch

    from irw_tpu_torch.losses import LossKind, build_losses
    from irw_tpu_torch.losses.rank_ap import BlackBoxAP, SmoothRankAP, true_ranker

    _release_earlier_phases(state)
    seen, checked = {}, 0
    for file, entry in _loss_configs():
        key = json.dumps([entry["name"], entry.get("kwargs")], sort_keys=True)
        if key in seen:
            log("losses", f"{file}: {entry['name']} as in {seen[key]}")
            continue
        seen[key] = file
        (loss, _), = build_losses([entry])
        name = entry["name"]
        if getattr(loss, "inner", True) is None:
            # multi_roadmap_loss.yaml keys its inner loss loss_name:, which the
            # constructor swallows as the JAX one does: no call can run
            for device in ("cpu", "cuda"):
                inp = _loss_inputs(loss, name, False, 0)
                try:
                    _loss_call(loss.to(device), None, inp, device)
                except TypeError:
                    continue
                raise AssertionError(f"{file}: {name} without an inner loss ran on {device}")
            log("losses", f"{file}: {name} has no inner loss (loss_name: is swallowed, as in "
                          "the JAX package): its call raises on both devices")
            continue
        loss.reset_parameters(torch.Generator().manual_seed(0))
        card_loss = copy.deepcopy(loss).cuda()
        loss_state = loss.init_state()
        for _ in range(10):  # a non-trivial schedule (QuantizationLoss's weight)
            loss_state = loss.epoch_update(loss_state)
        reads = loss.kind == LossKind.SCORES or getattr(loss, "accepts_refs", False)
        for memory in (False, True) if reads else (False,):
            inp = _loss_inputs(loss, name, memory, seed=len(seen))
            rows = (LOSS_MEMORY_ROWS if memory and isinstance(loss, (SmoothRankAP, BlackBoxAP))
                    else None)
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            marks[0].record()
            full, _ = _loss_call(card_loss, loss_state, inp, "cuda")
            marks[1].record()
            torch.cuda.synchronize()
            ours, card_grads = _loss_call(card_loss, loss_state, inp, "cuda", rows)
            ref, cpu_grads = _loss_call(loss, loss_state, inp, "cpu", rows)
            rel = abs(float(ours) - float(ref)) / max(abs(float(ref)), 1e-30)
            if (card_grads is None) != (cpu_grads is None):
                raise AssertionError(f"{file}: {name}: a gradient on one device only")
            cosine = 1.0 if card_grads is None else _grad_cosine(card_grads, cpu_grads)
            same_ranks = ""
            if isinstance(loss, BlackBoxAP):
                scores, other = inp["x"], inp["other_labels"]
                target = (inp["labels"][:, None] == (inp["labels"] if other is None
                                                     else other)[None, :]).astype(np.float32)
                adj = scores - np.float32(loss.margin) * target
                ranks = [true_ranker(torch.tensor(adj, device=dev), loss.lambda_val).cpu()
                         for dev in ("cuda", "cpu")]
                if not torch.equal(*ranks):
                    raise AssertionError(f"{file}: BlackBoxAP ranks differ between the card "
                                         "and the CPU")
                same_ranks = f", ranks of {tuple(adj.shape)} equal"
            what = ("memory" if memory else "batch") + (f", first {rows} queries" if rows else "")
            log("losses", f"{file}: {name} ({what}): card {float(ours):.7f} | CPU "
                          f"{float(ref):.7f} (rel {rel:.1e}), gradient cosine {cosine:.7f}"
                          f"{same_ranks}; the card's full call {float(full):.6f} in "
                          f"{marks[0].elapsed_time(marks[1]):.1f} ms")
            if not (math.isfinite(float(full)) and rel <= LOSS_TOL and cosine >= LOSS_COSINE):
                raise AssertionError(f"{file}: {name} ({what}) disagrees with the CPU: rel "
                                     f"{rel}, cosine {cosine}")
            checked += 1
    log("losses", f"{checked} calls of {len(seen)} distinct losses held against the CPU "
                  f"| {state['card']}")


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


def _serve_once(label: str, model, images, expected: tuple):
    """One served batch of ``images`` through the device transform and
    ``model``: its launches must equal ``expected`` and its output be finite.
    Returns (bands, output: logits of a hashing model, else the embeddings)."""
    import torch

    from irw_tpu_torch.transforms import DeviceTransform

    transform = DeviceTransform(SWT_OPS)
    kernels = _kernel_wrappers()
    hashing = hasattr(model, "forward_logits")
    with torch.inference_mode():
        for fn in kernels:
            fn.launches = 0
        bands = transform(images)
        out = (model.forward_logits(bands) if hashing else model(bands))[0]
        torch.cuda.synchronize()
    _check_launches("siblings", [tuple(fn.launches for fn in kernels)], expected,
                    f"batch, {label}")
    if not (torch.isfinite(out).all() and out.shape[0] == len(images)):
        raise AssertionError(f"{label}: served output not finite / wrong shape {out.shape}")
    return bands, out


def _against_cpu(label: str, model, bands, out) -> None:
    """The first CPU_IMAGES of a served batch through a CPU copy of ``model``
    (its kernels' wrappers take their plain versions there), the card's side
    recomputed with TF32 off: f32 logits within CPU_F32_TOL; bf16 logits
    within LOGIT_MARGIN with the codes equal past it; unit embeddings at
    cosine CPU_EMB_COSINE or more."""
    import copy

    import torch

    hashing = hasattr(model, "forward_logits")
    bf16 = model.backbone.vit.dtype == torch.bfloat16
    cpu = copy.deepcopy(model).cpu()
    x = bands[:CPU_IMAGES]
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            card = (model.forward_logits(x) if hashing else model(x))[0].float().cpu()
            t0 = time.perf_counter()
            ref = (cpu.forward_logits(x.cpu()) if hashing else cpu(x.cpu()))[0].float()
            cpu_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    del cpu
    dmax = (card - ref).abs().max().item()
    if not hashing:
        cos = torch.nn.functional.cosine_similarity(card, ref, dim=-1).min().item()
        ok = cos >= CPU_EMB_COSINE
        verdict = f"min cosine {cos:.6f} (limit {CPU_EMB_COSINE})"
    elif bf16:
        sure = ref.abs() > LOGIT_MARGIN
        n_differ = int(((torch.sign(card) != torch.sign(ref)) & sure).sum())
        ok = dmax <= LOGIT_MARGIN and n_differ == 0
        verdict = (f"codes differ at {n_differ} of {int(sure.sum())}/{sure.numel()} bits past "
                   f"{LOGIT_MARGIN} (limit {LOGIT_MARGIN} on |logit - cpu|)")
    else:
        ok = dmax <= CPU_F32_TOL
        verdict = f"limit {CPU_F32_TOL}"
    log("siblings", f"{label} against the CPU on {CPU_IMAGES} images: max|card - cpu| = "
                    f"{dmax:.3e}; {verdict} (CPU {cpu_s:.1f} s)")
    if not ok:
        raise AssertionError(f"{label}: the card disagrees with the CPU")


def phase_siblings(state):
    """The flagship's siblings at full width (ROADMAP A10a): the shared tower
    served and trained on K1, K2 and K3, the prompted DSLN tower, and one
    served batch of every other configuration of the family."""
    import torch

    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.engine import build_train_step, init_train_state
    from irw_tpu_torch.engine.train import _build_hyper
    from irw_tpu_torch.losses import build_losses
    from irw_tpu_torch.ops.attention import attention_plain, attention_plain_autograd
    from irw_tpu_torch.transforms import DeviceTransform

    images = SyntheticVOCDataset(num_train=BATCH, image_size=224, seed=7).images
    tds = SyntheticVOCDataset(num_train=TRAIN_BATCH * 2, image_size=224, seed=3)
    tbatches = [{"image": tds.images[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                 "label": tds.labels[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]} for i in range(2)]

    # (a) the slice's path: the unfrozen shared tower on K1, K2, K3
    shared_what = "SWT + 1 x ViT-S/14 over 4 x 64 band-major + fusion + hash, bf16"
    held = _release_earlier_phases(state)
    model = _family_model(SHARED_CONFIG)
    assert type(model).__name__ == "SharedDinoHashing" and model.backbone.vit.pos_embed.dim() == 2
    _check_cores(model, "vmem_attention_fn")
    _serve_flagship(state, "siblings_serve", model, (1, 12, 0, 0, 0, 0, 0), attention_plain,
                    held, shared_what)
    bands, out = _serve_once(SHARED_CONFIG, model, images, (1, 12, 0, 0, 0, 0, 0))
    _against_cpu(SHARED_CONFIG, model, bands, out)
    del model, bands, out
    held = _release_earlier_phases(state)
    model = _family_model(SHARED_CONFIG)
    _train_flagship(state, "siblings_train", model, (1, 24, 12, 0, 0, 0, 0),
                    attention_plain_autograd, held,
                    "1 x ViT-S/14 over 4 x 96 band-major, bf16, block remat, AdamW")
    del model

    # (b) prompts and DSLN in a frozen f32 tower
    held = _release_earlier_phases(state)
    model = _family_model(PROMPTED_CONFIG)
    vit = model.backbone.vit
    assert model.frozen_backbone and model.num_prompts == 10 and vit.num_domains == 4
    assert vit.dtype == torch.float32 and type(model.head).__name__ == "StandardFusionHead"
    bands, out = _serve_once(PROMPTED_CONFIG, model, images, (1, 0, 0, 0, 0, 0, 0))
    _against_cpu(PROMPTED_CONFIG, model, bands, out)
    del bands, out
    tower = {k: v.clone() for k, v in model.backbone.state_dict().items()}
    tstate = init_train_state(model, build_losses(HASH_LOSS), OPTIMIZER, HASH_LOSS, seed=0)
    step = build_train_step(DeviceTransform(SWT_OPS), proxy_map_metric="hamming")
    kernels = _kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(PROMPT_STEPS):
        for fn in kernels:
            fn.launches = 0
        m = step(tstate, tbatches[i % 2], _build_hyper(tstate.optimizer_entries, 1, tstate.step,
                                                       0, None, None))
        _check_launches("siblings", [tuple(fn.launches for fn in kernels)],
                        (1, 0, 0, 0, 0, 0, 0), f"train step, {PROMPTED_CONFIG}")
        grad = model.prompts.grad
        grad_abs = 0.0 if grad is None else grad.abs().sum().item()
        moved = [k for k, v in model.backbone.state_dict().items()
                 if not torch.equal(v, tower[k])]
        log("siblings", f"{PROMPTED_CONFIG} step {i}: total_loss {float(m['total_loss']):.6f}, "
                        f"grad_norm {float(m['grad_norm']):.6f}, sum|d prompts| {grad_abs:.4e}, "
                        f"tower tensors moved {len(moved)} of {len(tower)}")
        if not (grad_abs > 0 and not moved and math.isfinite(float(m["grad_norm"]))):
            raise AssertionError(f"{PROMPTED_CONFIG} step {i}: prompts' gradient {grad_abs}, "
                                 f"tower moved {moved[:3]}, grad_norm {float(m['grad_norm'])}")
    torch.cuda.synchronize()
    log("siblings", f"{PROMPTED_CONFIG}: {PROMPT_STEPS} steps of {TRAIN_BATCH} in "
                    f"{time.perf_counter() - t0:.2f} s (the first included), the path's own peak "
                    f"memory {(torch.cuda.max_memory_allocated() - held) / 2 ** 30:.2f} GiB | "
                    f"{state['card']}")
    del model, tstate, step, tower

    # (c) one served batch of every other configuration, and the flagship
    # without BatchNorm in its hash head, which also trains one step
    for config in FAMILY_SERVED + ("flagship, use_bn: false",):
        _release_earlier_phases(state)
        if config in FAMILY_SERVED:
            model = _family_model(config)
        else:
            model = _flagship_model(use_bn=False)
        frozen = model.frozen_backbone
        _check_cores(model, "dot_product_attention" if frozen else "vmem_attention_fn")
        expected = (1, 0 if frozen else 12, 0, 0, 0, 0, 0)
        bands, out = _serve_once(config, model, images, expected)
        log("siblings", f"{config}: {type(model).__name__}, head "
                        f"{type(model.head).__name__}, frozen {frozen}, output {tuple(out.shape)}")
        _against_cpu(config, model, bands, out)
        del bands, out
        if config not in FAMILY_SERVED:
            assert model.hash_head.bn is None
            tstate = init_train_state(model, build_losses(HASH_LOSS), OPTIMIZER, HASH_LOSS)
            step = build_train_step(DeviceTransform(SWT_OPS), proxy_map_metric="hamming")
            for fn in kernels:
                fn.launches = 0
            m = step(tstate, tbatches[0], _build_hyper(tstate.optimizer_entries, 1, 0, 0, None,
                                                       None))
            _check_launches("siblings", [tuple(fn.launches for fn in kernels)],
                            (1, 24, 12, 0, 0, 0, 0), f"train step, {config}")
            _check_finite("siblings", [m], TRAIN_METRICS)
            del tstate, step
        del model
    _release_earlier_phases(state)


def _trunk_model(config: str):
    """``configs/model/<config>.yaml`` composed over ``configs/default.yaml``
    (the port's ``compose``) and built by the ``Getter`` at full width, seed
    0, on the card; LayerScale set to 1 (the ViTs' ``ls1``/``ls2``,
    ConvNeXt's ``gamma``) and the zero-initialised classifiers drawn, so
    that the towers and heads reach the output.  Returns (config, model)."""
    import torch

    from irw_tpu_torch import single_experiment_runner as runner
    from irw_tpu_torch.config import compose
    from irw_tpu_torch.getter import Getter
    from irw_tpu_torch.models.layers import Linear

    cfg = compose(runner.CONFIG_DIR, "default", [f"model={config}"])
    model = Getter().get_model(cfg.model, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("ls1", "ls2", "gamma"):
                p.fill_(1.0)
        for mod in model.modules():
            if isinstance(mod, Linear) and not mod.weight.any():
                mod.weight.normal_(0.0, mod.weight.shape[-1] ** -0.5, generator=gen)
    return cfg, model


def _trunk_bf16(model) -> bool:
    import torch

    return any(getattr(m, "dtype", None) == torch.bfloat16 for m in model.modules())


def _trunk_outputs(model, x):
    """(eval output, the pre-sign logits of a model whose eval output is ±1
    codes, else None)."""
    kind = type(model).__name__
    out = model(x)[0]
    if kind == "DINOHashBaseline":
        logits = model.hash_head(model.backbone(x))
    elif kind == "SingleBandNet" and model.hash_head is not None:
        logits = model.hash_head(model.backbone(x[:, model.band]))
    elif kind == "ResNetHashing":
        logits = model.fc(model.trunk(x))
    elif kind == "ResNet50Mod":
        logits = model.dsch(x)[0]
    else:
        logits = None
    return out.float(), None if logits is None else logits.float()


def _hold_trunk(label: str, what: str, card, ref, bf16: bool, phase: str = "trunks") -> None:
    """``card`` against ``ref``, each (output, logits or None): codes equal
    past the margin (LOGIT_MARGIN in bf16, 1e-3 in f32) and the logits within
    it (CPU_F32_TOL in f32); unit embeddings at cosine CPU_EMB_COSINE (bf16)
    or within CPU_F32_TOL (f32)."""
    import torch

    (out, logits), (out_ref, logits_ref) = card, ref
    if logits is not None:
        margin, tol = (LOGIT_MARGIN, LOGIT_MARGIN) if bf16 else (1e-3, CPU_F32_TOL)
        sure = logits_ref.abs() > margin
        n_differ = int(((torch.sign(out) != torch.sign(logits_ref)) & sure).sum())
        dmax = (logits - logits_ref).abs().max().item()
        ok = n_differ == 0 and dmax <= tol and 2 * int(sure.sum()) >= sure.numel()
        verdict = (f"max|logit - {what}| = {dmax:.3e} (limit {tol}); codes differ at {n_differ} "
                   f"of {int(sure.sum())}/{sure.numel()} bits past {margin}")
    elif bf16:
        cos = torch.nn.functional.cosine_similarity(out, out_ref, dim=-1).min().item()
        ok = cos >= CPU_EMB_COSINE
        verdict = f"min cosine to {what} {cos:.6f} (limit {CPU_EMB_COSINE})"
    else:
        dmax = (out - out_ref).abs().max().item()
        ok = dmax <= CPU_F32_TOL
        verdict = f"max|out - {what}| = {dmax:.3e} (limit {CPU_F32_TOL})"
    log(phase, f"{label}: {verdict}")
    if not ok:
        raise AssertionError(f"{phase}: {label} disagrees with {what}")


def _serve_trunk(state, config: str, images, phase: str = "trunks", model=None,
                 warmup: int = WARMUP_CALLS, timed: int = TRUNK_TIMED) -> None:
    """``warmup`` batches, then ``timed`` timed batches of BATCH through the
    device transform (the SWT stack, kernel K1, for the band models;
    Normalize for the others) and the model (``config``'s, or ``model`` when
    given, ``config`` then being its label): launches per batch, img/s, the
    path's own peak memory; then the first batch held against the plain
    route (K1's plain version, on the card) or, with no kernel on the path,
    against a CPU copy of the model on CPU_IMAGES images (TF32 off on the
    card)."""
    import copy

    import torch

    from irw_tpu_torch.ops.wavelets import haar_swt2_plain
    from irw_tpu_torch.transforms import DeviceTransform

    held = _release_earlier_phases(state)
    torch.cuda.reset_peak_memory_stats()
    name = config
    if model is None:
        cfg, model = _trunk_model(config)
        name = cfg.model.name
    swt = config in TRUNK_SWT
    bf16 = _trunk_bf16(model)
    transform = DeviceTransform(SWT_OPS if swt else TRUNK_PLAIN_OPS)
    kernels = _kernel_wrappers()
    with torch.inference_mode():
        for i in range(warmup):
            model(transform(images[i % len(images)]))
        torch.cuda.synchronize()
        for fn in kernels:
            fn.launches = 0
        per_batch = []
        t0 = time.perf_counter()
        for i in range(timed):
            before = [fn.launches for fn in kernels]
            out = model(transform(images[i % len(images)]))[0]
            per_batch.append(tuple(fn.launches - b for fn, b in zip(kernels, before)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        state["launches"][f"{phase}_{config}"] = _launch_counts(kernels)
        _check_launches(phase, per_batch, (1 if swt else 0,) + (0,) * 6, f"batch, {config}")
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        log(phase, f"{config}: {name} → {type(model).__name__}, "
                   f"{'bf16' if bf16 else 'f32'}, output {tuple(out.shape)}; "
                   f"{timed * BATCH / seconds:.1f} img/s, {seconds / timed * 1e3:.2f} ms per "
                   f"batch of {BATCH} ({timed} timed after {warmup}), peak {peak:.2f} GiB "
                   f"| {state['card']}")

        x = transform(images[0])
        if not torch.isfinite(_trunk_outputs(model, x)[0]).all():
            raise AssertionError(f"{phase}: {config}'s output is not finite")
        if swt:
            raw = torch.from_numpy(images[0]).cuda().float() / 255.0
            b, h, w, c = raw.shape
            flat = haar_swt2_plain(raw.permute(0, 3, 1, 2).reshape(b * c, h, w))
            plain = flat.reshape(b, c, 4, h, w).permute(0, 2, 3, 4, 1)
            _hold_trunk(config, "the plain route", _trunk_outputs(model, x),
                        _trunk_outputs(model, plain), bf16, phase)
        else:
            cpu = copy.deepcopy(model).cpu()
            flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            try:
                card = _trunk_outputs(model, x[:CPU_IMAGES])
            finally:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
            ref = _trunk_outputs(cpu, x[:CPU_IMAGES].cpu())
            _hold_trunk(config, "the CPU", tuple(None if t is None else t.cpu() for t in card),
                        ref, bf16, phase)
            del cpu
    del model


def _train_trunk(state, config: str, loss_file: str, batches, alpha: float = 1.0,
                 phase: str = "trunks"):
    """TRUNK_STEPS train steps of ``config``'s model at BATCH with the loss
    of ``configs/loss/<loss_file>`` and ``configs/optimizer/basic.yaml``'s
    AdamW, the optimizers and the step built with the config's freezing set
    (``model.freeze_*`` and the model's frozen collections), ``model_alpha``
    ``alpha``; the launches and the path's own peak memory logged.  Returns
    (model, the parameters before, the last metrics, the first step's loss
    input, the train state)."""
    import os

    import torch

    from irw_tpu_torch import single_experiment_runner as runner
    from irw_tpu_torch.config import yaml_lite
    from irw_tpu_torch.engine import build_train_step, init_train_state
    from irw_tpu_torch.engine.train import _build_hyper
    from irw_tpu_torch.losses import build_losses
    from irw_tpu_torch.transforms import DeviceTransform
    from irw_tpu_torch.utils.freezing import config_freeze_set

    held = _release_earlier_phases(state)
    torch.cuda.reset_peak_memory_stats()
    cfg, model = _trunk_model(config)
    loss_cfg = yaml_lite.load(os.path.join(runner.CONFIG_DIR, "loss", loss_file))
    frozen = config_freeze_set(model, cfg.model)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tstate = init_train_state(model, build_losses(loss_cfg), OPTIMIZER, loss_cfg, seed=0,
                              frozen_collections=frozen)
    tstate.model_alpha = alpha
    step = build_train_step(DeviceTransform(TRUNK_PLAIN_OPS), frozen_collections=frozen)
    seen = []
    hook = tstate.losses[0][0].register_forward_hook(
        lambda mod, args, out: seen.append(args[0]) if not seen else None)
    kernels = _kernel_wrappers()
    metrics, per_step, ends = [], [], [torch.cuda.Event(enable_timing=True)]
    try:
        torch.cuda.synchronize()
        ends[0].record()
        t0 = time.perf_counter()
        for fn in kernels:
            fn.launches = 0
        for i in range(TRUNK_STEPS):
            before_step = [fn.launches for fn in kernels]
            metrics.append(step(tstate, batches[i % len(batches)],
                                _build_hyper(tstate.optimizer_entries, 1, tstate.step, 0, None)))
            per_step.append(tuple(fn.launches - b for fn, b in zip(kernels, before_step)))
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        hook.remove()
    state["launches"][f"{phase}_{config}_train"] = _launch_counts(kernels)
    _check_launches(phase, per_step, (0,) * 7, f"train step, {config}")
    _check_finite(phase, metrics, ("total_loss", "grad_norm"))
    step_ms = ", ".join(f"{a.elapsed_time(b):.1f}" for a, b in zip(ends[:-1], ends[1:]))
    losses = ", ".join(f"{float(m['total_loss']):.6f}" for m in metrics)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    log(phase, f"{config} trained {TRUNK_STEPS} steps of {BATCH} ({loss_file}, freezing set "
               f"{frozen}) in {seconds:.2f} s, the first step included; ms a step (CUDA "
               f"events) {step_ms}; total_loss {losses}; peak {peak:.2f} GiB | {state['card']}")
    return model, before, metrics[-1], seen[0], tstate


def _train_batches(n_classes: int, multi_label: bool, seed: int) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        labels = ((rng.rand(BATCH, n_classes) > 0.8).astype(np.float32) if multi_label
                  else rng.randint(0, n_classes, BATCH))
        if multi_label:
            labels[:, 0] = 1.0
        out.append({"image": rng.randint(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8),
                    "label": labels})
    return out


def phase_trunks(state):
    """Every single-trunk model (ROADMAP A10c): the configs of TRUNK_SWT and
    TRUNK_PLAIN served at full width; four of them trained; the repo's
    default composition through the runner (K4) and
    ``studies/smoke_plan.yaml``'s jobs through ``run_plan``."""
    import os
    import shutil
    import tempfile

    import torch

    from irw_tpu_torch import single_experiment_runner as runner
    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.getter import Getter
    from irw_tpu_torch.studies.run_plan import expand_jobs, load_plan, run_jobs
    from irw_tpu_torch.transforms import DeviceTransform

    ds = SyntheticVOCDataset(num_train=BATCH * 2, image_size=224, seed=11)
    images = [ds.images[:BATCH], ds.images[BATCH:]]
    for config in TRUNK_SWT + TRUNK_PLAIN:
        _serve_trunk(state, config, images)

    # training: CE with frozen BatchNorm, HashLoss at α = 2, a metric loss
    # unfrozen, and freeze_pos_embedding
    model, before, _, _, _ = _train_trunk(state, "resnet_ce", "celoss.yaml",
                                          _train_batches(8, False, 1))
    stats = [k for k in before if k.endswith(("running_mean", "running_var"))]
    moved = [k for k in stats if not torch.equal(model.state_dict()[k], before[k])]
    log("trunks", f"resnet_ce: frozen_bn {model.trunk.frozen_bn}; BatchNorm statistics moved "
                  f"{len(moved)} of {len(stats)}")
    if moved or not model.trunk.frozen_bn:
        raise AssertionError(f"trunks: resnet_ce's frozen BatchNorm moved {moved[:3]}")

    batches = _train_batches(20, True, 2)
    model, before, _, ctx, tstate = _train_trunk(state, "resnet_hashing", "hash_loss.yaml",
                                                 batches, alpha=2.0)
    model.load_state_dict(before)  # the weights the first step saw
    with torch.no_grad():
        fc = model.fc(model.trunk(DeviceTransform(TRUNK_PLAIN_OPS)(batches[0]["image"])))
    # the step's forward and this one may take other TF32 conv algorithms
    dmax = (torch.tanh(2.0 * fc) - ctx.embeddings).abs().max().item()
    d_one = (torch.tanh(fc) - ctx.embeddings).abs().max().item()
    log("trunks", f"resnet_hashing: model_alpha {tstate.model_alpha}; max|tanh(2·fc) - what the "
                  f"loss saw| = {dmax:.3e} (limit 1e-3), max|tanh(fc) - what it saw| = "
                  f"{d_one:.3e}")
    if not (dmax <= 1e-3 and d_one > 10 * dmax):
        raise AssertionError("trunks: the loss did not see tanh(2·fc)")
    del model, tstate, ctx

    model, before, _, _, _ = _train_trunk(state, "convnext", "pair_loss.yaml",
                                          _train_batches(10, False, 3))
    changed = sum(not torch.equal(v, before[k]) for k, v in model.state_dict().items())
    log("trunks", f"convnext (unfrozen): {changed} of {len(before)} tensors moved")
    if not changed or model.frozen_backbone:
        raise AssertionError("trunks: convnext did not train")

    model, before, _, _, _ = _train_trunk(state, "dino_default", "celoss.yaml",
                                          _train_batches(200, False, 4))
    held = ("backbone.pos_embed", "backbone.cls_token")
    same = [k for k in held if torch.equal(model.state_dict()[k], before[k])]
    head_moved = not torch.equal(model.classifier.weight, before["classifier.weight"])
    log("trunks", f"dino_default (freeze_pos_embedding): {same} unchanged; the classifier "
                  f"moved: {head_moved}")
    if len(same) != len(held) or not head_moved:
        raise AssertionError("trunks: dino_default's frozen embeddings moved or its head did not")
    del model
    _release_earlier_phases(state)

    # the repo's default composition through the runner, on the card (K4)
    root = tempfile.mkdtemp(prefix="irw_trunks_")
    try:
        kernels = _kernel_wrappers()
        wrapped = []
        get_transform = Getter.get_transform

        def counting(self, transform_config, device=None):
            (h, d), test = get_transform(self, transform_config, device)
            wrapped.append(_UnitLaunches(d, kernels))
            return (h, wrapped[-1]), test

        overrides = ["dataset=synthetic", "experience.max_iter=1", "experience.step_per_epoch=2",
                     f"experience.log_dir={root}"]
        Getter.get_transform = counting
        try:
            for fn in kernels:
                fn.launches = 0
            t0 = time.perf_counter()
            score = runner.run_one(overrides)
            seconds = time.perf_counter() - t0
        finally:
            Getter.get_transform = get_transform
        (transform,) = wrapped
        steps, evals = transform.units(False), transform.units(True)
        state["launches"]["trunks_default"] = {fn.__name__: sum(u[i] for u in steps)
                                               for i, fn in enumerate(kernels)}
        state["launches"]["trunks_default_eval"] = {fn.__name__: sum(u[i] for u in evals)
                                                    for i, fn in enumerate(kernels)}
        state["default_units"] = (len(steps), len(evals))
        _check_launches("trunks", steps, (0, 0, 0, 1, 0, 0, 0), "train step, default composition")
        _check_launches("trunks", evals, (0, 0, 0, 1, 0, 0, 0),
                        "eval batch, default composition (the first: the size probe)")
        log("trunks", f"default composition (single_band_tiny, transform dwt, synthetic): "
                      f"{len(steps)} train steps, {len(evals)} inference batches, map_level0 "
                      f"{score:.4f} in {seconds:.1f} s | {state['card']}")
        if len(steps) != 2 or not 0.0 <= score <= 1.0:
            raise AssertionError(f"trunks: the default composition ran {len(steps)} steps, "
                                 f"score {score}")

        # studies/smoke_plan.yaml through run_plan, each job in its own process
        repo = os.path.dirname(os.path.abspath(__file__))
        jobs = expand_jobs(load_plan(os.path.join(repo, "studies", "smoke_plan.yaml")))
        jobs = [(name, [o for o in overrides_ if not o.startswith("experience.log_dir=")]
                 + [f"experience.log_dir={root}"]) for name, overrides_ in jobs]
        t0 = time.perf_counter()
        failed = run_jobs(jobs)
        seconds = time.perf_counter() - t0
        scores = {}
        for name, _ in jobs:
            records = _jsonl(os.path.join(root, name, "metrics.jsonl"))
            scores[name] = [r["test/map_level0"] for r in records if "test/map_level0" in r]
        log("trunks", f"smoke_plan: {len(jobs)} jobs in {seconds:.1f} s, failed {failed}, "
                      f"map_level0 {scores}")
        if failed or not all(len(v) == 1 and 0.0 <= v[0] <= 1.0 for v in scores.values()):
            raise AssertionError(f"trunks: smoke_plan failed {failed} / {scores}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _release_earlier_phases(state)


def phase_hf_towers(state):
    """The HF vision wrapper's towers at full width (ROADMAP A10d): CLIP
    (``openclip``, ``metaclip2``), SigLIP (``siglip2``) through
    ``RetrievalNet`` from their ``configs/model`` files, each served as the
    trunks are (no kernel on the path: held against a CPU copy); the
    ``clip_vit_b32`` and ``vit_b16_hf`` presets from the registry, one batch
    each; ``openclip`` and ``siglip2`` trained, every tower parameter
    moving."""
    import torch

    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.models import get_model

    ds = SyntheticVOCDataset(num_train=BATCH * 2, image_size=224, seed=12)
    images = [ds.images[:BATCH], ds.images[BATCH:]]
    for config in HF_SERVE:
        _serve_trunk(state, config, images, phase="hf_towers")
    for name in HF_REGISTRY:
        _serve_trunk(state, name, images, phase="hf_towers", model=get_model(name, seed=0),
                     warmup=0, timed=1)
    for i, config in enumerate(HF_TRAIN):
        model, before, _, _, _ = _train_trunk(state, config, "pair_loss.yaml",
                                              _train_batches(10, False, 5 + i), phase="hf_towers")
        after = model.state_dict()
        tower = [k for k in before if k.startswith("backbone.")]
        still = [k for k in tower if torch.equal(after[k], before[k])]
        fc = "fc.layers.0.weight"
        log("hf_towers", f"{config}: {len(tower) - len(still)} of {len(tower)} tower tensors "
                         f"moved; the projection moved: {not torch.equal(after[fc], before[fc])}")
        if still or model.frozen_backbone:
            raise AssertionError(f"hf_towers: {config}'s tower did not train: {still[:3]}")
        del model, after
    _release_earlier_phases(state)


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


def _write_jpeg(path, arr, kind: str = "jpeg") -> None:
    """``arr`` (H, W, 3) uint8 to ``path`` as a baseline JPEG, or as the
    sample ``kind`` names: CMYK or grayscale JPEG, a PNG under the JPEG's
    name, or a JPEG cut in its scan data."""
    from PIL import Image

    img = Image.fromarray(arr)
    if kind == "cmyk":
        img = img.convert("CMYK")
    elif kind == "gray":
        img = img.convert("L")
    img.save(path, "PNG" if kind == "png" else "JPEG", quality=90)
    if kind == "truncated":
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:len(data) // 2])


def _photos(rs, w: int, h: int, n_base: int = 4):
    """An endless supply of (h, w, 3) uint8 images that compress like
    photographs: windows at random offsets into ``n_base`` smooth random
    images with noise, twice as wide and high."""
    yy, xx = np.mgrid[0:2 * h, 0:2 * w].astype(np.float32)
    bases = []
    for _ in range(n_base):
        f = rs.uniform(0.005, 0.05, (3, 2))
        phase = rs.uniform(0, 2 * np.pi, 3)
        smooth = np.stack([np.sin(f[c, 0] * xx + f[c, 1] * yy + phase[c]) for c in range(3)], -1)
        noisy = 127.5 + 100 * smooth + rs.randint(-12, 13, smooth.shape)
        bases.append(np.clip(noisy, 0, 255).astype(np.uint8))
    while True:
        y, x = rs.randint(h), rs.randint(w)
        yield np.ascontiguousarray(bases[rs.randint(n_base)][y:y + h, x:x + w])


def _write_file_trees(root) -> tuple[str, str]:
    """The VOC tree (``VOCdevkit/VOC2012``: ids, XML annotations of 1-3 of
    the 20 classes, JPEGs, FILES_SPECIAL among the train ids) and the CUB
    tree (``images.txt``, ``image_class_labels.txt``, ``images/``, half
    the images portrait) under ``root``; the JPEGs encoded on 8 threads."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from irw_tpu_torch.data.datasets_multilabel import VOC_CLASSES

    rs = np.random.RandomState(17)
    landscape = _photos(rs, *FILES_IMAGE)
    portrait = _photos(rs, *FILES_IMAGE[::-1])
    images = []  # (path, pixels, kind)
    voc = os.path.join(root, "voc", "VOCdevkit", "VOC2012")
    for sub in ("ImageSets/Main", "Annotations", "JPEGImages"):
        os.makedirs(os.path.join(voc, sub))
    ids = [f"2011_{i:06d}" for i in range(FILES_VOC_TRAIN + FILES_VOC_VAL)]
    for split, chosen in (("train", ids[:FILES_VOC_TRAIN]), ("val", ids[FILES_VOC_TRAIN:])):
        with open(os.path.join(voc, "ImageSets", "Main", f"{split}.txt"), "w") as f:
            f.write("".join(f"{i}\n" for i in chosen))
    for k, img_id in enumerate(ids):
        names = rs.choice(VOC_CLASSES, rs.randint(1, 4))
        with open(os.path.join(voc, "Annotations", f"{img_id}.xml"), "w") as f:
            f.write(f"<annotation><filename>{img_id}.jpg</filename>" + "".join(
                f"<object><name>{n}</name></object>" for n in names) + "</annotation>")
        images.append((os.path.join(voc, "JPEGImages", f"{img_id}.jpg"), next(landscape),
                       FILES_SPECIAL.get(k, "jpeg")))
    cub = os.path.join(root, "cub")
    entries = [(c, n) for c in range(1, FILES_CUB_CLASSES + 1) for n in range(FILES_CUB_TRAIN)]
    entries += [(100 + c, n) for c in range(1, FILES_CUB_CLASSES + 1)
                for n in range(FILES_CUB_TEST)]
    os.makedirs(cub)
    with open(os.path.join(cub, "images.txt"), "w") as f:
        f.write("".join(f"{i + 1} {c:03d}.Bird/{c:03d}_{n}.jpg\n"
                        for i, (c, n) in enumerate(entries)))
    with open(os.path.join(cub, "image_class_labels.txt"), "w") as f:
        f.write("".join(f"{i + 1} {c}\n" for i, (c, _) in enumerate(entries)))
    for c, n in entries:
        os.makedirs(os.path.join(cub, "images", f"{c:03d}.Bird"), exist_ok=True)
        images.append((os.path.join(cub, "images", f"{c:03d}.Bird", f"{c:03d}_{n}.jpg"),
                       next(portrait if n % 2 else landscape), "jpeg"))
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: _write_jpeg(*job), images))
    return os.path.join(root, "voc"), cub


def _write_jpegs(jobs, threads: int = 8) -> None:
    """(path, pixels) pairs written as baseline JPEGs on ``threads`` threads."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(lambda job: _write_jpeg(*job), jobs))


def write_revisited_tree(root, city: str, n_query: int, n_gallery: int, gnd_counts: tuple,
                         size: tuple, seed: int = 0) -> str:
    """A revisited Oxford/Paris tree under ``root``: ``<city>/gnd_<city>.pkl``
    ({"imlist", "qimlist", "gnd"}: each query's easy, hard and junk gallery
    positions, ``gnd_counts`` of them from one permutation of the gallery,
    and a bbx) and ``<city>/jpg/<name>.jpg`` of ``size`` (w, h); returns
    ``root``."""
    import os
    import pickle

    rs = np.random.RandomState(seed)
    jpg = os.path.join(root, city, "jpg")
    os.makedirs(jpg, exist_ok=True)
    imlist = [f"{city}_{i:06d}" for i in range(n_gallery)]
    qimlist = [f"{city}_query_{i:03d}" for i in range(n_query)]
    n_easy, n_hard, n_junk = gnd_counts
    gnd = []
    for _ in range(n_query):
        perm = rs.permutation(n_gallery)
        gnd.append({"easy": perm[:n_easy], "hard": perm[n_easy:n_easy + n_hard],
                    "junk": perm[n_easy + n_hard:n_easy + n_hard + n_junk],
                    "bbx": [float(v) for v in np.sort(rs.uniform(0, min(size), 4))]})
    with open(os.path.join(root, city, f"gnd_{city}.pkl"), "wb") as f:
        pickle.dump({"imlist": imlist, "qimlist": qimlist, "gnd": gnd}, f)
    photos = _photos(rs, *size)
    _write_jpegs([(os.path.join(jpg, f"{name}.jpg"), next(photos)) for name in qimlist + imlist])
    return str(root)


def write_sfm_tree(root, n_train: int, n_clusters: int, size: tuple, n_val: int = 0,
                   seed: int = 0) -> str:
    """An SfM-120k tree under ``root``: ``retrieval-SfM-120k.pkl`` ({"train",
    "val"}: "cids", "cluster" = position mod ``n_clusters``, empty "qidxs"
    and "pidxs") and ``ims/<cid[-2:]>/<cid[-4:-2]>/<cid[-6:-4]>/<cid>`` JPEGs of
    ``size`` (w, h); returns ``root``."""
    import os
    import pickle

    rs = np.random.RandomState(seed)
    photos = _photos(rs, *size)
    db, jobs = {}, []
    for split, n in (("train", n_train), ("val", n_val)):
        cids = [rs.bytes(16).hex() for _ in range(n)]
        db[split] = {"cids": cids, "cluster": [i % n_clusters for i in range(n)],
                     "qidxs": [], "pidxs": []}
        for cid in cids:
            folder = os.path.join(root, "ims", cid[-2:], cid[-4:-2], cid[-6:-4])
            os.makedirs(folder, exist_ok=True)
            jobs.append((os.path.join(folder, cid), next(photos)))
    with open(os.path.join(root, "retrieval-SfM-120k.pkl"), "wb") as f:
        pickle.dump(db, f)
    _write_jpegs(jobs)
    return str(root)


class _FileRun(_UnitLaunches):
    """``_UnitLaunches`` that also keeps the first train batch's images."""

    first_train = None

    def __call__(self, images):
        import torch

        if self.first_train is None and not torch.is_inference_mode_enabled():
            self.first_train = np.array(images)
        return super().__call__(images)


def _loader_rate(dataset, host, native: bool) -> float:
    """img/s of ``EpochLoader`` alone over ``dataset`` through the host stage
    ``host`` in batches of TRAIN_BATCH, training draws, FILES_LOADER_WORKERS
    threads, on the native route or the host route."""
    from irw_tpu_torch.data import EpochLoader

    batches = [np.arange(i, i + TRAIN_BATCH) for i in range(0, len(dataset), TRAIN_BATCH)]
    loader = EpochLoader(dataset, batches, host, num_workers=FILES_LOADER_WORKERS, native=native)
    t0 = time.perf_counter()
    n = sum(len(b["image"]) for b in loader)
    seconds = time.perf_counter() - t0
    want = "native" if native else "host"
    if set(loader.routes.values()) != {want}:
        raise AssertionError(f"files: the loader took {loader.routes} where {want} was asked")
    return n / seconds


def _file_job(state, label: str, overrides: list, expected_step: tuple, expected_eval: tuple,
              epochs: int, steps: int, batch: int, prepare=None, phase: str = "files"):
    """``overrides`` through the port's runner, the device transform wrapped
    to count every kernel's launches per train step and per inference
    batch (the first: ``run``'s sample batch, transform only), the model
    captured (and handed to ``prepare`` once built), every loader batch's
    route recorded; ``epochs`` of ``steps`` steps of ``batch`` in all.
    Returns (the wrapped transform, the model, the routes by train/eval, the
    metrics records); the counts are kept under ``<phase>_<label>``."""
    import os

    import torch

    from irw_tpu_torch import single_experiment_runner as runner
    from irw_tpu_torch.config import compose
    from irw_tpu_torch.data import loader as loader_mod
    from irw_tpu_torch.getter import Getter
    from irw_tpu_torch.run import log_dir_of

    kernels = _kernel_wrappers()
    wrapped, models, routes = [], [], {"train": [], "eval": []}
    get_transform, get_model = Getter.get_transform, Getter.get_model
    load_batch = loader_mod.EpochLoader._load_batch

    def counting(self, transform_config, device=None):
        (h, d), test = get_transform(self, transform_config, device)
        wrapped.append(_FileRun(d, kernels))
        return (h, wrapped[-1]), test

    def capturing(self, *args, **kwargs):
        models.append(get_model(self, *args, **kwargs))
        if prepare is not None:
            prepare(models[-1])
        return models[-1]

    def recording(self, batch_idx, indices):
        out = load_batch(self, batch_idx, indices)
        routes["train" if self.train else "eval"].append(self.routes[batch_idx])
        return out

    Getter.get_transform, Getter.get_model = counting, capturing
    loader_mod.EpochLoader._load_batch = recording
    try:
        torch.cuda.synchronize()
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        if runner.main(overrides) != 0:
            raise AssertionError(f"{phase}, {label}: the runner returned non-zero")
        seconds = time.perf_counter() - t0
    finally:
        Getter.get_transform, Getter.get_model = get_transform, get_model
        loader_mod.EpochLoader._load_batch = load_batch
    (transform,), (model,) = wrapped, models
    train_units, eval_units = transform.units(False), transform.units(True)
    key = f"{phase}_{label}"
    state["launches"][key] = {fn.__name__: sum(u[i] for u in train_units)
                              for i, fn in enumerate(kernels)}
    state["launches"][f"{key}_eval"] = {fn.__name__: sum(u[i] for u in eval_units[1:])
                                        for i, fn in enumerate(kernels)}
    state[f"{key}_units"] = (len(train_units), len(eval_units) - 1)
    log(phase, f"{label}: the run took {seconds:.1f} s; launches over it: "
                 f"{_launch_counts(kernels)}")
    if len(train_units) != steps:
        raise AssertionError(f"{phase}, {label}: {len(train_units)} train steps, expected {steps}")
    _check_launches(phase, train_units, expected_step, f"train step, {label}")
    sample = tuple(n if i in (0, 3) else 0 for i, n in enumerate(expected_eval))
    _check_launches(phase, eval_units[:1], sample, f"sample batch, {label} (transform only)")
    _check_launches(phase, eval_units[1:], expected_eval, f"eval batch, {label}")

    log_dir = log_dir_of(compose(runner.CONFIG_DIR, "default", overrides).experience)
    records = _jsonl(os.path.join(log_dir, "metrics.jsonl"))
    epoch_records = [r for r in records if "train/train_seconds" in r]
    if [r["step"] for r in epoch_records] != list(range(1, epochs + 1)):
        raise AssertionError(f"{phase}, {label}: epoch records {epoch_records}")
    for r in records:
        if not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"{phase}, {label}: non-finite metrics {r}")
    for r in epoch_records:
        ips = steps // epochs * batch / r["train/train_seconds"]
        log(phase, f"{label}, epoch {r['step']}: {r['train/train_seconds']:.3f} s, {ips:.1f} "
                     f"trained img/s ({steps // epochs} steps of {batch}); data_seconds "
                     f"{r['train/data_seconds']:.4f}, step_seconds {r['train/step_seconds']:.4f}, "
                     f"total_loss {r['train/total_loss']:.5f} | {state['card']}")
    return transform, model, routes, records


def phase_files(state):
    """Datasets read from files (ROADMAP A8c): the VOC flagship study's
    first job and the CUB WCNN recipe from JPEG trees written here, through
    the datasets, ``EpochLoader`` (the host image loader where it builds,
    else Pillow and the numpy host stage) and the runner; K1-K4 launched
    from the decoded batches and each held against its plain version."""
    import os
    import shutil
    import tempfile

    import torch

    from irw_tpu_torch import native
    from irw_tpu_torch import single_experiment_runner as runner
    from irw_tpu_torch.config import compose
    from irw_tpu_torch.data import get_dataset
    from irw_tpu_torch.native import build
    from irw_tpu_torch.ops.attention import (
        attention_plain,
        attention_plain_bwd,
        fused_attention,
        fused_attention_bwd,
    )
    from irw_tpu_torch.ops.wavelets import (
        haar_swt2,
        haar_swt2_plain,
        lifting_multi_level,
        lifting_multi_level_plain,
    )
    from irw_tpu_torch.studies.run_plan import expand_jobs, load_plan
    from irw_tpu_torch.transforms import build_transforms

    _release_earlier_phases(state)
    root = tempfile.mkdtemp(prefix="irw_files_")
    try:
        t0 = time.perf_counter()
        voc_dir, cub_dir = _write_file_trees(root)
        log("files", f"wrote {FILES_VOC_TRAIN} + {FILES_VOC_VAL} VOC JPEGs and "
                     f"{FILES_CUB_CLASSES * (FILES_CUB_TRAIN + FILES_CUB_TEST)} CUB JPEGs of "
                     f"{FILES_IMAGE[0]} x {FILES_IMAGE[1]} in {time.perf_counter() - t0:.1f} s "
                     f"(VOC train samples {sorted(FILES_SPECIAL)}: {FILES_SPECIAL})")

        t0 = time.perf_counter()
        if native.available():  # builds it (g++) where it is not built yet
            log("files", f"host image loader: {build.lib_path()} (g++ "
                         f"{build.LAST_BUILD.get('seconds', 0.0):.1f} s; built already: "
                         f"{'seconds' not in build.LAST_BUILD})")
            route = "native"
        else:
            log("files", f"host image loader NOT built ({time.perf_counter() - t0:.1f} s); "
                         f"the compiler said:\n{build.LAST_BUILD.get('error')}")
            log("files", "this phase decodes through Pillow (load_image's fallback) and the "
                         "numpy host stage: the loader's host route")
            route = "host"

        # the loader alone, the study's train host ops (transform=swt)
        jobs = expand_jobs(load_plan(os.path.join(os.path.dirname(runner.CONFIG_DIR),
                                                  FILES_PLAN)))
        name, job = jobs[0]
        if FILES_JOB not in job or "dataset=voc" not in job:
            raise AssertionError(f"files: {FILES_PLAN}'s first job is {job}")
        overrides = job + FILES_CUTS + [f"dataset.kwargs.data_dir={voc_dir}",
                                        f"experience.log_dir={root}/runs"]
        config = compose(runner.CONFIG_DIR, "default", overrides)
        host, _ = build_transforms(config.transform.train, device="cpu")
        dataset = get_dataset(config.dataset.name, **config.dataset.kwargs)
        rates = {"host (Pillow + numpy)": _loader_rate(dataset, host, False)}
        if route == "native":
            rates["native, fast_scale"] = _loader_rate(dataset, host, True)
        else:
            rates["native, fast_scale"] = "not measured (library not built)"
        log("files", f"EpochLoader alone, {host.ops}, batches of {TRAIN_BATCH}, "
                     f"{FILES_LOADER_WORKERS} threads on {os.cpu_count()} CPUs, the files just "
                     f"written (warm): "
                     + ", ".join(f"{k} {v if isinstance(v, str) else f'{v:.1f} img/s'}"
                                 for k, v in rates.items()) + f" | {state['card']}")
        del dataset

        # the VOC study job through the runner: K1, K2, K3; block 0's q, k, v
        # of the first train step kept
        captured = {}

        def keep_qkv(model):
            attn = model.backbone.vit.blocks[0].attn
            core = attn.core

            def core_fn(q, k, v):
                if "qkv" not in captured and torch.is_grad_enabled():
                    captured["qkv"] = tuple(t.detach().clone() for t in (q, k, v))
                return core(q, k, v)
            attn.core = core_fn

        log("files", f"{name}: {job}; cut: {FILES_CUTS}, and {FILES_VOC_TRAIN} train (= "
                     f"gallery) and {FILES_VOC_VAL} val (= query) images in place of "
                     "VOC2012's splits")
        transform, model, routes, records = _file_job(
            state, "voc", overrides, (1, 24, 12, 0, 0, 0, 0), (1, 12, 0, 0, 0, 0, 0),
            FILES_EPOCHS, FILES_EPOCHS * FILES_STEPS, TRAIN_BATCH, prepare=keep_qkv)
        log("files", f"voc decode routes: train batches {routes['train']}, eval batches "
                     f"{routes['eval']}")
        if set(routes["train"] + routes["eval"]) != {route}:
            raise AssertionError(f"files: batches took {routes}, expected every one {route}")
        evaluated = [r for r in records if "test/map_level0" in r]
        if [r["step"] for r in evaluated] != [FILES_EPOCHS] or not (
                0.0 <= evaluated[0]["test/map_level0"] <= 1.0):
            raise AssertionError(f"files: voc eval records {evaluated}")
        log("files", f"voc eval at epoch {FILES_EPOCHS}: {evaluated[0]['test/eval_seconds']:.3f} s "
                     f"({FILES_VOC_VAL} queries against {FILES_VOC_TRAIN}); map_level0 "
                     f"{evaluated[0]['test/map_level0']:.4f}")
        del model

        # K1 on the first decoded train batch; K2, K3 on block 0's q, k, v of
        # the first train step
        images = torch.from_numpy(transform.first_train).cuda().float() / 255.0
        b, h, w, c = images.shape
        planes = images.permute(0, 3, 1, 2).reshape(b * c, h, w).contiguous()
        err1 = (haar_swt2(planes) - haar_swt2_plain(planes)).abs().max().item()
        q, k, v = captured["qkv"]
        with torch.no_grad():
            ref2 = attention_plain(q, k, v).float()
            err2 = (fused_attention(q, k, v).float() - ref2).abs().max().item()
        # K2_TOL is one bf16 ulp for |o| < 2: here one ulp at the largest |o|
        peak2 = ref2.abs().max().item()
        tol2 = K2_TOL["bfloat16"] * 2.0 ** max(0, math.floor(math.log2(peak2)))
        g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(0),
                        device="cuda").to(q.dtype)
        errs3 = []
        for out, ref in zip(fused_attention_bwd(q, k, v, g), attention_plain_bwd(q, k, v, g)):
            errs3.append(((out.float() - ref.float()).abs().max().item(),
                          K3_TOL_BF16 * ref.float().abs().max().item()))
        torch.cuda.synchronize()
        log("files", f"K1 on the first decoded train batch {tuple(planes.shape)}: max|kernel - "
                     f"plain| = {err1:.3e} (limit {K1_TOL}); K2 on block 0's q, k, v "
                     f"{tuple(q.shape)} {q.dtype}: {err2:.3e} (limit {tol2:.3e}, one bf16 ulp at "
                     f"max|o| {peak2:.3f}); "
                     "K3 dq, dk, dv: " + ", ".join(f"{e:.3e} (limit {t:.3e})" for e, t in errs3))
        if not (err1 <= K1_TOL and q.dtype == torch.bfloat16 and err2 <= tol2
                and all(e <= t for e, t in errs3)):
            raise AssertionError("files: a kernel disagrees with its plain version on the "
                                 "decoded batches")
        state["files_errors"] = {"haar_swt2": err1, "fused_attention": err2,
                                 "fused_attention_bwd": max(e for e, _ in errs3)}
        _release_earlier_phases(state)

        # the CUB WCNN recipe from files: K4
        overrides = FILES_CUB_JOB + [f"dataset.kwargs.data_dir={cub_dir}",
                                     "experience.experiment_name=files_cub",
                                     f"experience.log_dir={root}/runs"]
        log("files", f"cub job: {FILES_CUB_JOB[:5]}; cut: {FILES_CUB_JOB[5:]}, and "
                     f"{FILES_CUB_CLASSES} train classes of {FILES_CUB_TRAIN} images and "
                     f"{FILES_CUB_CLASSES} test classes of {FILES_CUB_TEST} in place of "
                     "CUB-200-2011's 100 and 100 classes")
        transform, model, routes, records = _file_job(
            state, "cub", overrides, (0, 0, 0, 1, 0, 0, 0), (0, 0, 0, 1, 0, 0, 0), 1,
            FILES_CUB_STEPS, CUB_BATCH)
        del model
        log("files", f"cub decode routes: train batches {routes['train']}, eval batches "
                     f"{routes['eval']}")
        if set(routes["train"] + routes["eval"]) != {route}:
            raise AssertionError(f"files: batches took {routes}, expected every one {route}")
        evaluated = [r for r in records if "test/map_level0" in r]
        if len(evaluated) != 1 or not 0.0 <= evaluated[0]["test/map_level0"] <= 1.0:
            raise AssertionError(f"files: cub eval records {evaluated}")
        log("files", f"cub eval: {FILES_CUB_CLASSES * FILES_CUB_TEST} test images, cosine, "
                     f"map_level0 {evaluated[0]['test/map_level0']:.4f}")
        x = torch.from_numpy(transform.first_train).cuda().float() / 255.0
        mean = torch.tensor(DWT_OPS[0][1]["mean"], device="cuda")
        std = torch.tensor(DWT_OPS[0][1]["std"], device="cuda")
        x = (x - mean) / std
        b, h, w, c = x.shape
        planes = x.permute(0, 3, 1, 2).reshape(b * c, h, w).contiguous()
        out, ref = lifting_multi_level(planes, 1, "haar"), lifting_multi_level_plain(planes, 1,
                                                                                     "haar")
        torch.cuda.synchronize()
        err4 = (out - ref).abs().max().item()
        tol4 = K4_TOL["haar"] * max(1.0, ref.abs().max().item())
        log("files", f"K4 on the first decoded CUB train batch {tuple(planes.shape)}: "
                     f"max|kernel - plain| = {err4:.3e} (limit {tol4:.3e})")
        if not err4 <= tol4:
            raise AssertionError("files: K4 disagrees with its plain version on decoded batches")
        state["files_errors"]["lifting_multi_level"] = err4
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _release_earlier_phases(state)


class _EvalRun(_UnitLaunches):
    """``_UnitLaunches`` that also keeps the first batch's images."""

    first = None

    def __call__(self, images):
        if self.first is None:
            self.first = np.array(images)
        return super().__call__(images)


def _map_oracle(query, gallery, gnd, protocol: str) -> float:
    """The float64 scalar oracle of the revisited protocol: the cosine of
    the embeddings in float64, a stable ranking, each query's positive and
    junk sets straight from its gnd entry (medium: easy | hard and junk;
    hard: hard and junk | easy), its AP by ``engine.landmark._ap_for_query``,
    the mean over queries with positives."""
    from irw_tpu_torch.engine.landmark import _ap_for_query

    q, g = query.astype(np.float64), gallery.astype(np.float64)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    g /= np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-12)
    orders = np.argsort(-(q @ g.T), axis=1, kind="stable")
    aps = []
    for order, entry in zip(orders.tolist(), gnd):
        easy, hard, junk = ({int(i) for i in np.atleast_1d(entry.get(key, []))}
                            for key in ("easy", "hard", "junk"))
        positives, junk = (easy | hard, junk) if protocol == "medium" else (hard, junk | easy)
        if positives:
            aps.append(_ap_for_query(order, positives, junk))
    return float(np.mean(aps)) if aps else 0.0


def _pillow_differences(images) -> dict:
    """The largest |numpy - Pillow| of the host stage's blur (radii 0.1 to
    2), hue round trip (shifts -26, +13, +77, 0) and grayscale over
    ``images``, against this machine's Pillow."""
    from PIL import Image, ImageFilter

    from irw_tpu_torch.transforms.host import gaussian_blur, grayscale, hue_shift

    worst = {"blur": 0, "hue": 0, "grayscale": 0}
    for k, img in enumerate(images):
        pil = Image.fromarray(img)
        radius = 0.1 + 1.9 * k / max(len(images) - 1, 1)
        factor = (-0.1, 0.05, 0.3, 0.0)[k % 4]
        hsv = np.asarray(pil.convert("HSV"), dtype=np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(round(factor * 255))) % 256
        refs = {"blur": (gaussian_blur(img, radius), pil.filter(ImageFilter.GaussianBlur(radius))),
                "hue": (hue_shift(img, factor),
                        Image.fromarray(hsv.astype(np.uint8), mode="HSV").convert("RGB")),
                "grayscale": (grayscale(img), pil.convert("L").convert("RGB"))}
        for op, (ours, ref) in refs.items():
            worst[op] = max(worst[op], int(np.abs(ours.astype(int) - np.asarray(ref)).max()))
    return worst


def phase_landmarks(state):
    """Landmark retrieval (ROADMAP A8c, A12's eval protocols): the revisited
    Oxford protocol at roxford5k's scale with the full-width flagship
    through ``compose``, the ``Getter`` and ``evaluate`` (K1 and K2 on every
    eval batch, each held against its plain version; the mAPs against the
    float64 oracle on the card's embeddings), ``landmark_bench`` at roxford5k
    and rparis6k scale, the SfM recipe through the runner, and the host ops
    alone."""
    import os
    import shutil
    import tempfile

    import PIL
    import torch

    from irw_tpu_torch import native
    from irw_tpu_torch import single_experiment_runner as runner
    from irw_tpu_torch.benchmarks import landmark_bench
    from irw_tpu_torch.config import compose
    from irw_tpu_torch.data import EpochLoader, get_dataset, subset
    from irw_tpu_torch.engine import evaluate
    from irw_tpu_torch.engine import landmark as landmark_mod
    from irw_tpu_torch.getter import Getter
    from irw_tpu_torch.ops.attention import attention_plain, fused_attention
    from irw_tpu_torch.ops.wavelets import haar_swt2, haar_swt2_plain
    from irw_tpu_torch.transforms import HostTransform, build_transforms

    _release_earlier_phases(state)
    root = tempfile.mkdtemp(prefix="irw_landmarks_")
    try:
        nq, ng = LANDMARK_COUNTS
        t0 = time.perf_counter()
        write_revisited_tree(os.path.join(root, "revisitop"), LANDMARK_CITY, nq, ng, LANDMARK_GND,
                             LANDMARK_IMAGE, seed=19)
        write_sfm_tree(os.path.join(root, "sfm"), LANDMARK_SFM_TRAIN, LANDMARK_SFM_CLUSTERS,
                       LANDMARK_IMAGE, seed=23)
        log("landmarks", f"wrote {nq} + {ng} {LANDMARK_CITY} JPEGs (gnd {LANDMARK_GND} easy, "
                         f"hard, junk a query) and {LANDMARK_SFM_TRAIN} SfM JPEGs in "
                         f"{LANDMARK_SFM_CLUSTERS} clusters, {LANDMARK_IMAGE[0]} x "
                         f"{LANDMARK_IMAGE[1]} (cut from the datasets' ~1024 x 768), in "
                         f"{time.perf_counter() - t0:.1f} s; decode route: "
                         f"{'native' if native.available() else 'Pillow (no host image loader)'}")

        # 1. the revisited protocol with the flagship, through the getter
        cfg = compose(runner.CONFIG_DIR, "default", [
            "dataset=roxford", f"dataset.kwargs.data_dir={root}/revisitop", "transform=voc_swt"])
        _, evals = Getter().get_dataset(cfg.dataset)
        sides = evals["test"]
        if (len(sides["query"]), len(sides["gallery"]), len(sides["query"].gnd)) != (nq, ng, nq):
            raise AssertionError(f"landmarks: the getter built {sides}")
        _, (host, dev) = Getter().get_transform(cfg.transform, "cuda")
        kernels = _kernel_wrappers()
        transform = _EvalRun(dev, kernels)
        model = _flagship_model()
        attn = model.backbone.vit.blocks[0].attn
        core, captured, seen = attn.core, {}, {}

        def core_fn(q, k, v):
            if "qkv" not in captured:
                captured["qkv"] = tuple(t.detach().clone() for t in (q, k, v))
            return core(q, k, v)

        real_map = landmark_mod.landmark_evaluation

        def timed_map(query, gallery, gnd, **kw):
            torch.cuda.synchronize()
            t_map = time.perf_counter()
            out = real_map(query, gallery, gnd, **kw)
            seen.update(ms=(time.perf_counter() - t_map) * 1e3, device=query.device,
                        on_card=(query, gallery))
            return out

        attn.core, landmark_mod.landmark_evaluation = core_fn, timed_map
        try:
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for fn in kernels:
                fn.launches = 0
            t0 = time.perf_counter()
            maps = evaluate(model, sides, transform, batch_size=LANDMARK_EVAL_BS,
                            host_transform=host, num_workers=8)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            attn.core, landmark_mod.landmark_evaluation = core, real_map
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        units = transform.units(True)
        batches = -(-nq // LANDMARK_EVAL_BS) + -(-ng // LANDMARK_EVAL_BS)
        state["launches"]["landmarks_eval"] = {fn.__name__: sum(u[i] for u in units)
                                               for i, fn in enumerate(kernels)}
        state["landmarks_units"] = len(units)
        if len(units) != batches:
            raise AssertionError(f"landmarks: {len(units)} eval batches, expected {batches}")
        _check_launches("landmarks", units, (1, 12, 0, 0, 0, 0, 0), "eval batch")
        if seen.get("device") is None or seen["device"].type != "cuda":
            raise AssertionError(f"landmarks: the map ran on {seen.get('device')}")
        query, gallery = seen.pop("on_card")
        warm = []
        for _ in range(5):  # the same call again, its kernels loaded
            torch.cuda.synchronize()
            t_map = time.perf_counter()
            again = real_map(query, gallery, sides["query"].gnd)
            warm.append((time.perf_counter() - t_map) * 1e3)
        if again != maps:
            raise AssertionError(f"landmarks: the map gave {maps}, then {again}")
        embed = seconds - seen["ms"] / 1e3
        log("landmarks", f"{LANDMARK_CITY} revisited protocol, flagship (4 x ViT-S/14 bf16, 64 "
                         f"bits), voc_swt's test ops, {batches} eval batches of "
                         f"{LANDMARK_EVAL_BS}: {seconds:.3f} s in all, embedding {embed:.3f} s "
                         f"({(nq + ng) / embed:.1f} img/s), map {seen['ms']:.2f} ms inside "
                         f"evaluate (its first call: kernels loading), "
                         f"{statistics.median(warm):.2f} ms warm (median of 5), peak "
                         f"{peak:.2f} GiB | {state['card']}")
        state["landmarks_map_ms"] = (seen["ms"], statistics.median(warm))
        query, gallery = query.float().cpu().numpy(), gallery.float().cpu().numpy()
        for protocol in ("medium", "hard"):
            value = maps[f"map_{protocol}"]
            oracle = _map_oracle(query, gallery, sides["query"].gnd, protocol)
            log("landmarks", f"map_{protocol} {value:.6f}; float64 scalar oracle on the card's "
                             f"embeddings {oracle:.6f} (|diff| {abs(value - oracle):.2e}, limit "
                             f"{LANDMARK_MAP_TOL})")
            if not (0.0 <= value <= 1.0 and abs(value - oracle) <= LANDMARK_MAP_TOL):
                raise AssertionError(f"landmarks: map_{protocol} {value} against {oracle}")
        state["landmarks_maps"] = maps

        # K1 on the first decoded batch, K2 on block 0's q, k, v of that batch
        images = torch.from_numpy(transform.first).cuda().float() / 255.0
        b, h, w, c = images.shape
        planes = images.permute(0, 3, 1, 2).reshape(b * c, h, w).contiguous()
        err1 = (haar_swt2(planes) - haar_swt2_plain(planes)).abs().max().item()
        q, k, v = captured["qkv"]
        with torch.no_grad():
            ref2 = attention_plain(q, k, v).float()
            err2 = (fused_attention(q, k, v).float() - ref2).abs().max().item()
        peak2 = ref2.abs().max().item()
        tol2 = K2_TOL["bfloat16"] * 2.0 ** max(0, math.floor(math.log2(peak2)))
        torch.cuda.synchronize()
        log("landmarks", f"K1 on the first decoded eval batch {tuple(planes.shape)}: max|kernel - "
                         f"plain| = {err1:.3e} (limit {K1_TOL}); K2 on block 0's q, k, v "
                         f"{tuple(q.shape)} {q.dtype}: {err2:.3e} (limit {tol2:.3e}, one bf16 ulp "
                         f"at max|o| {peak2:.3f})")
        if not (err1 <= K1_TOL and q.dtype == torch.bfloat16 and err2 <= tol2):
            raise AssertionError("landmarks: a kernel disagrees with its plain version on the "
                                 "decoded eval batch")
        state["landmarks_errors"] = {"haar_swt2": err1, "fused_attention": err2}
        del model, transform, captured, images, planes, q, k, v, ref2
        _release_earlier_phases(state)

        # 2. the map alone at roxford5k's and rparis6k's scale
        for city, gallery in LANDMARK_BENCH_GALLERIES.items():
            out = landmark_bench.run(nq=nq, ng=gallery, d=2048, iters=5)
            log("landmarks", f"landmark_bench at {city} scale {out['shape']}: {out['ms']:.2f} ms a "
                             f"call (medium + hard, host masks and copies included, mean of 5 "
                             f"after a warm-up); map_medium {out['map_medium']:.4f}, map_hard "
                             f"{out['map_hard']:.4f} | {state['card']}")
            if not (out["device"] == torch.cuda.get_device_name(0) and 0 <= out["map_hard"] <= 1
                    and 0 <= out["map_medium"] <= 1):
                raise AssertionError(f"landmarks: landmark_bench gave {out}")
            state[f"landmarks_bench_{city}"] = out["ms"]

        # 3. the SfM recipe through the runner
        overrides = LANDMARK_SFM_JOB + [f"dataset.kwargs.data_dir={root}/sfm",
                                        f"experience.log_dir={root}/runs"]
        log("landmarks", f"sfm job: {LANDMARK_SFM_JOB}; {LANDMARK_SFM_TRAIN} train images in "
                         f"{LANDMARK_SFM_CLUSTERS} clusters of 4 in place of SfM-120k's")
        route = "native" if native.available() else "host"
        _, model, routes, records = _file_job(
            state, "sfm", overrides, (0, 0, 0, 0, 0, 0, 0), (0, 0, 0, 0, 0, 0, 0), 1,
            LANDMARK_SFM_STEPS, LANDMARK_SFM_BATCH, phase="landmarks")
        del model
        log("landmarks", f"sfm decode routes: train batches {routes['train']}, eval batches "
                         f"{routes['eval']}")
        if set(routes["train"] + routes["eval"]) != {route}:
            raise AssertionError(f"landmarks: batches took {routes}, expected every one {route}")
        evaluated = [r for r in records if "test/map_level0" in r]
        if len(evaluated) != 1 or not 0.0 <= evaluated[0]["test/map_level0"] <= 1.0:
            raise AssertionError(f"landmarks: sfm eval records {evaluated}")
        log("landmarks", f"sfm eval of the train split (drop-self, cosine): "
                         f"{evaluated[0]['test/eval_seconds']:.3f} s, map_level0 "
                         f"{evaluated[0]['test/map_level0']:.4f}")
        _release_earlier_phases(state)

        # 4. the host ops alone, and against this machine's Pillow
        sfm = get_dataset("SfM120kDataset", data_dir=f"{root}/sfm")
        sub = subset(sfm, np.arange(LANDMARK_HOST_IMAGES))
        multicrop, _ = build_transforms(compose(runner.CONFIG_DIR, "default", [
            "transform=multicrop"]).transform.train, device="cpu")
        pixel = HostTransform([
            ("RandomResizedCrop", {"size": 224}),
            ("ColorJitter", {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4, "hue": 0.1}),
            ("RandomGrayscale", {"p": 0.2}), ("GaussianBlur", {"sigma": [0.1, 2.0], "p": 0.5}),
            ("RandomHorizontalFlip", {})])
        batches = [np.arange(i, i + 128) for i in range(0, LANDMARK_HOST_IMAGES, 128)]
        for label, host in (("multicrop.yaml's train ops (2 x 224 + 6 x 96)", multicrop),
                            ("RandomResizedCrop 224, ColorJitter(hue=0.1), RandomGrayscale, "
                             "GaussianBlur, flip", pixel)):
            loader = EpochLoader(sub, batches, host, num_workers=8)
            t0 = time.perf_counter()
            out = list(loader)
            rate = LANDMARK_HOST_IMAGES / (time.perf_counter() - t0)
            keys = sorted(k for k in out[0] if k.startswith("crop_"))
            shapes = [out[0][k].shape[1:3] for k in keys] or [out[0]["image"].shape[1:3]]
            log("landmarks", f"EpochLoader alone, {label}: {rate:.1f} img/s over "
                             f"{LANDMARK_HOST_IMAGES} images in batches of 128, 8 threads on "
                             f"{os.cpu_count()} CPUs, routes {sorted(set(loader.routes.values()))}, "
                             f"outputs {shapes} | {state['card']}")
            if set(loader.routes.values()) != {"host"} or (host is multicrop and shapes != [
                    (224, 224)] * 2 + [(96, 96)] * 6):
                raise AssertionError(f"landmarks: host ops gave {loader.routes}, {shapes}")
        worst = _pillow_differences([sfm.load_image(i) for i in range(LANDMARK_PILLOW_IMAGES)])
        log("landmarks", f"numpy host ops against this machine's Pillow {PIL.__version__} on "
                         f"{LANDMARK_PILLOW_IMAGES} decoded images: largest |diff| {worst} "
                         "(limit 1)")
        if max(worst.values()) > 1:
            raise AssertionError(f"landmarks: the host ops stray from Pillow by {worst}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _release_earlier_phases(state)


@contextlib.contextmanager
def _k4_plain():
    """K4's plain version in both of its call sites: ``CustomTransform``'s
    route 1 and the in-model DWT of ``WaveResNet(CE)``."""
    from irw_tpu_torch.models import wresnet
    from irw_tpu_torch.ops.wavelets import lifting_multi_level_plain
    from irw_tpu_torch.transforms import pipeline

    saved = wresnet.lifting_multi_level, pipeline.lifting_multi_level
    wresnet.lifting_multi_level = pipeline.lifting_multi_level = lifting_multi_level_plain
    try:
        yield
    finally:
        wresnet.lifting_multi_level, pipeline.lifting_multi_level = saved


def _wavenet_model(config: str, transform: str):
    """``configs/model/<config>.yaml`` with ``transform=<transform>`` composed
    over ``configs/default.yaml`` and built by the ``Getter`` at full width,
    seed 0, on the card; (config, model, the test split's and the train
    split's device stage, build seconds)."""
    from irw_tpu_torch import single_experiment_runner as runner
    from irw_tpu_torch.config import compose
    from irw_tpu_torch.getter import Getter
    from irw_tpu_torch.transforms import build_transforms

    cfg = compose(runner.CONFIG_DIR, "default", [f"model={config}", f"transform={transform}"])
    t0 = time.perf_counter()
    model = Getter().get_model(cfg.model, seed=0)
    build_s = time.perf_counter() - t0
    return (cfg, model, build_transforms(cfg.transform.test)[1],
            build_transforms(cfg.transform.train)[1], build_s)


def _wavenet_batches(n: int, batch: int, size: int, classes: int, seed: int) -> list:
    """``n`` batches of uint8 ``size``² images and labels in [0, classes),
    made on the card (the host stage's geometry is outside the path)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [{"image": torch.randint(0, 256, (batch, size, size, 3), generator=gen,
                                    device="cuda", dtype=torch.uint8),
             "label": torch.randint(0, classes, (batch,), generator=gen, device="cuda",
                                    dtype=torch.int32)} for _ in range(n)]


def _wavenet_step(cfg, model, train_dev, loss_file: str):
    """The train state and step of ``model`` with ``configs/loss/<loss_file>``
    and ``configs/optimizer/basic.yaml``'s AdamW, the config's freezing set
    applied; (state, step, hyper, freezing set)."""
    import os

    from irw_tpu_torch import single_experiment_runner as runner
    from irw_tpu_torch.config import yaml_lite
    from irw_tpu_torch.engine import build_train_step, init_train_state
    from irw_tpu_torch.engine.train import _build_hyper
    from irw_tpu_torch.losses import build_losses
    from irw_tpu_torch.utils.freezing import config_freeze_set

    loss_cfg = yaml_lite.load(os.path.join(runner.CONFIG_DIR, "loss", loss_file))
    frozen = config_freeze_set(model, cfg.model)
    tstate = init_train_state(model, build_losses(loss_cfg), WAVENET_OPTIMIZER, loss_cfg,
                              seed=0, frozen_collections=frozen)
    step = build_train_step(train_dev, frozen_collections=frozen)

    def hyper():
        return _build_hyper(tstate.optimizer_entries, 1, tstate.step, 0, None)

    return tstate, step, hyper, frozen


def _serve_wavenet(state, config: str, model, device, size: int, classes: int, held: int):
    """WARMUP_CALLS and SERVE_BATCHES timed batches of BATCH through the test
    split's device stage and ``model`` (K4 once a batch), then each distinct
    batch held against the same model with K4's plain version."""
    import torch

    batches = [b["image"] for b in _wavenet_batches(SERVE_DISTINCT, BATCH, size, classes, 20)]
    kernels = _kernel_wrappers()
    with torch.inference_mode():
        for i in range(WARMUP_CALLS):
            model(device(batches[i % SERVE_DISTINCT]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        per_batch, outs = [], []
        t0 = time.perf_counter()
        for i in range(SERVE_BATCHES):
            before = [fn.launches for fn in kernels]
            out = model(device(batches[i % SERVE_DISTINCT]))[0]
            if i < SERVE_DISTINCT:
                outs.append(out)
            per_batch.append(tuple(fn.launches - b for fn, b in zip(kernels, before)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        counts = _launch_counts(kernels)
        state["launches"][f"wavenets_{config}_serve"] = counts
        _check_launches("wavenets", per_batch, (0, 0, 0, 1, 0, 0, 0), f"batch, {config}")
        ips = SERVE_BATCHES * BATCH / seconds
        log("wavenets", f"{config}: {ips:.1f} img/s, {seconds / SERVE_BATCHES * 1e3:.1f} ms per "
                        f"batch of {BATCH} ({SERVE_BATCHES} timed after {WARMUP_CALLS}; device "
                        f"stage + model), output {tuple(outs[0].shape)} | the path's own peak "
                        f"memory {peak / 2 ** 30:.2f} GiB | {state['card']}")
        batch_ms = seconds / SERVE_BATCHES * 1e3
        busy_ms = _device_profile("wavenets", lambda: model(device(batches[0])),
                                  f"{config}: one served batch of {BATCH}", state, _WCNN_GROUPS)
        if busy_ms is not None:
            log("wavenets", f"{config}: idle share against the timed batches' {batch_ms:.1f} "
                            f"ms: {1 - busy_ms / batch_ms:.3f}")
        with _k4_plain():
            for i, (images, out) in enumerate(zip(batches, outs)):
                ref = model(device(images))[0]
                dmax = (out - ref).abs().max().item()
                log("wavenets", f"{config}, batch {i}: max|emb - K4's plain route| = {dmax:.3e} "
                                f"(limit {WCNN_EMB_TOL})")
                unit = torch.allclose(out.norm(dim=-1), torch.ones_like(out[:, 0]), atol=1e-5)
                if not (torch.isfinite(out).all() and unit and dmax <= WCNN_EMB_TOL):
                    raise AssertionError(f"wavenets: {config}'s batch {i} is not finite and unit "
                                         f"or strays {dmax} from K4's plain route")
    return ips


def _train_wavenet(state, config: str, cfg, model, train_dev, loss_file: str, batch: int,
                   held: int):
    """WARMUP_CALLS steps, then WAVENET_STEPS timed ones at ``batch`` of 224²
    images (K4 once a step); finite metrics; returns (state, step, hyper,
    batches, mean ms a step)."""
    classes = cfg.model.kwargs.to_dict().get("num_classes") or 100
    tstate, step, hyper, frozen = _wavenet_step(cfg, model, train_dev, loss_file)
    batches = _wavenet_batches(2, batch, 224, classes, 21)
    metrics, step_ms = _timed_steps(
        "wavenets", state, tstate, step, batches, hyper, WARMUP_CALLS, WAVENET_STEPS,
        (0, 0, 0, 1, 0, 0, 0), held, batch,
        f"{config} with {loss_file}, basic.yaml's AdamW, freezing set {frozen}, f32 with "
        "TF32 convs; images made on the card")
    state["launches"][f"wavenets_{config}_train"] = state["launches"].pop("wavenets")
    _check_finite("wavenets", metrics, ("total_loss", "grad_norm"))
    return tstate, step, hyper, batches, step_ms


def phase_wavenets(state):
    """The wavelet CNNs (ROADMAP A10b) at full width through ``compose``,
    the ``Getter`` and ``build_train_step``: ``wresnet_sdd_ce`` + ``sdd``
    (the in-model DWT on K4, 4 x ResNet-50 with the 1 x 1 stem at 112²) and
    ``mtwavenet50`` + ``cub_dwt`` (K4 in ``CustomTransform``, 4 staged
    ResNet-50s with the cross-band attention) served and trained, K4's
    route held against its plain route; every other A10b config serves a
    batch and takes a train step (``mtwavenet_fusion_dml``'s raises, as in
    JAX)."""
    import torch

    precision = (f"cuDNN TF32 {torch.backends.cudnn.allow_tf32}, matmul TF32 "
                 f"{torch.backends.cuda.matmul.allow_tf32}")
    results = {}
    for config, (transform, loss_file, batch) in WAVENET_MAIN.items():
        held = _release_earlier_phases(state)
        cfg, model, serve_dev, train_dev, build_s = _wavenet_model(config, transform)
        n_params = sum(p.numel() for p in model.parameters())
        classes = cfg.model.kwargs.to_dict().get("num_classes") or 100
        log("wavenets", f"{config} + {transform}: {type(model).__name__}, {n_params / 1e6:.1f} M "
                        f"parameters, f32, built in {build_s:.1f} s; device stage "
                        f"{[n for n, _ in serve_dev.ops]}; {precision}")
        ips = _serve_wavenet(state, config, model, serve_dev, 224, classes, held)
        tstate, step, hyper, batches, step_ms = _train_wavenet(
            state, config, cfg, model, train_dev, loss_file, batch, held)
        busy_ms = _device_profile("wavenets", lambda: step(tstate, batches[1], hyper()),
                                  f"{config}: one train step of {batch}", state, _WCNN_GROUPS)
        if busy_ms is not None:
            log("wavenets", f"{config}: idle share against the timed steps' {step_ms:.1f} ms: "
                            f"{1 - busy_ms / step_ms:.3f}")
        frozen_bn = [m for m in model.modules() if getattr(m, "frozen_bn", False)]
        log("wavenets", f"{config}: model.freeze_batch_norm {cfg.model.freeze_batch_norm} (the "
                        f"freezing set: every BatchNorm's scale and bias); trunks with frozen_bn "
                        f"(statistics pinned) {len(frozen_bn)}, as the JAX factory builds it")
        results[config] = (ips, step_ms, torch.cuda.max_memory_allocated() - held)
        if config.startswith("wresnet"):  # the new call site of K4: its training route
            _hold_k4_route("wavenets", tstate, step, batches[0], hyper)
        del model, tstate, step, batches

    kernels = _kernel_wrappers()
    for config, (transform, loss_file) in WAVENET_CONFIGS.items():
        if config in WAVENET_MAIN:
            continue
        _release_earlier_phases(state)
        cfg, model, serve_dev, train_dev, build_s = _wavenet_model(config, transform)
        size = 32 if transform == "cifar" else 224
        classes = cfg.model.kwargs.to_dict().get("num_classes") or 100
        batches = _wavenet_batches(1, WAVENET_SMALL, size, classes, 22)
        for fn in kernels:
            fn.launches = 0
        with torch.inference_mode():
            out = model(serve_dev(batches[0]["image"]))[0]
        _check_launches("wavenets", [tuple(fn.launches for fn in kernels)],
                        (0, 0, 0, 1, 0, 0, 0), f"served batch, {config}")
        unit = bool(torch.allclose(out.norm(dim=-1), torch.ones_like(out[:, 0]), atol=1e-5))
        if not (out.shape[0] == WAVENET_SMALL and out.dim() == 2 and torch.isfinite(out).all()
                and unit == (type(model).__name__ != "WaveResNet")):
            raise AssertionError(f"wavenets: {config} served {tuple(out.shape)}, unit {unit}")
        if loss_file is None:
            model.train()
            try:
                model(serve_dev(batches[0]["image"]))
            except TypeError as exc:
                trained = f"training raises as in JAX ({str(exc)[:60]}...)"
            else:
                raise AssertionError(f"wavenets: {config} trained without classes")
        else:
            tstate, step, hyper, frozen = _wavenet_step(cfg, model, train_dev, loss_file)
            for fn in kernels:
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(tstate, batches[0], hyper())
            torch.cuda.synchronize()
            _check_launches("wavenets", [tuple(fn.launches for fn in kernels)],
                            (0, 0, 0, 1, 0, 0, 0), f"train step, {config}")
            _check_finite("wavenets", [metrics], ("total_loss", "grad_norm"))
            trained = (f"one step of {WAVENET_SMALL} with {loss_file} in "
                       f"{time.perf_counter() - t0:.2f} s (its first: plans and allocations), "
                       f"freezing set {frozen}")
            del tstate, step
        n_params = sum(p.numel() for p in model.parameters())
        log("wavenets", f"{config} + {transform}: {type(model).__name__}, {n_params / 1e6:.1f} M "
                        f"parameters, built in {build_s:.1f} s; served {tuple(out.shape)} "
                        f"(unit {unit}); {trained} | {state['card']}")
        del model
    _release_earlier_phases(state)
    for config, (ips, step_ms, peak) in results.items():
        log("wavenets", f"summary {config}: {ips:.1f} img/s served at batch {BATCH}, "
                        f"{step_ms:.1f} ms a train step at batch {WAVENET_MAIN[config][2]}, "
                        f"training's peak memory {peak / 2 ** 30:.2f} GiB above what was held "
                        f"before the model | {state['card']}")


def _twin(name: str, kwargs: dict, src, dtype: str):
    """The model ``name`` (registry name and keyword arguments) built on the
    meta device in ``dtype`` and given ``src``'s parameters and statistics:
    what ``get_model(..., dtype=dtype)`` builds from ``src``'s seed, without
    drawing 100 M weights again."""
    import torch

    from irw_tpu_torch.models import MODEL_REGISTRY

    with torch.device("meta"):
        twin = MODEL_REGISTRY[name](torch.device("cuda"), **dict(kwargs, dtype=dtype))
    twin = twin.to_empty(device="cuda")
    twin.load_state_dict(src.state_dict())
    return twin.train(src.training)


@contextlib.contextmanager
def _no_tf32():
    import torch

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _hold_half(phase: str, label: str, out, ref, dtype: str) -> float:
    """Each row of the unit embeddings ``out`` at cosine HALF_COSINE[dtype]
    or more to the f32 run's ``ref``; both finite and unit."""
    import torch

    out, ref = out.float(), ref.float()
    cos = torch.nn.functional.cosine_similarity(out, ref, dim=-1).min().item()
    unit = bool(torch.allclose(out.norm(dim=-1), torch.ones_like(out[:, 0]), atol=2e-2))
    log(phase, f"{label}: min cosine to the f32 run (TF32 off) {cos:.6f} (limit "
               f"{HALF_COSINE[dtype]}); unit {unit}")
    if not (torch.isfinite(out).all() and unit and cos >= HALF_COSINE[dtype]):
        raise AssertionError(f"{phase}: {label} strays from the f32 run: cosine {cos}")
    return cos


def _check_f32_state(phase: str, label: str, model) -> None:
    """Parameters and BatchNorm statistics stay float32 (flax's
    ``param_dtype``), the compute dtype only casts at use."""
    import torch

    dtypes = {t.dtype for t in (*model.parameters(), *model.buffers()) if t.is_floating_point()}
    log(phase, f"{label}: parameter and buffer dtypes {sorted(map(str, dtypes))}")
    if dtypes != {torch.float32}:
        raise AssertionError(f"{phase}: {label} holds {dtypes}, not float32 alone")


def _half_compute(model) -> set:
    from irw_tpu_torch.models.resnet import BatchNorm, Conv2d

    return {str(m.dtype) for m in model.modules() if isinstance(m, (Conv2d, BatchNorm))}


def phase_trunks_half(state):
    """The CNN trunks in half precision (ROADMAP A10e): ``model=wcnn_attention_ce
    transform=cub_dwt +model.kwargs.dtype=bfloat16`` composed and built by the
    ``Getter`` at full width, served (K4 once a batch, its bands against K4's
    plain route, the embeddings against the f32 run of the same weights with
    TF32 off) and trained at CUB's batch (the first step's loss against the
    f32 step's); ``wresnet_sdd_ce`` + ``sdd`` in bf16 trained at 16 (K4 in
    the model); one bf16 batch and step of each of HALF_MODELS from the
    registry; one f16 batch of the WCNN; parameters and statistics float32
    throughout.  Logs img/s, ms a step and peak memory beside the f32
    ``wcnn`` and ``wcnn_train`` numbers of the run."""
    import os

    import torch

    from irw_tpu_torch import single_experiment_runner as runner
    from irw_tpu_torch.config import compose, yaml_lite
    from irw_tpu_torch.engine import build_train_step, init_train_state
    from irw_tpu_torch.engine.train import _build_hyper
    from irw_tpu_torch.getter import Getter
    from irw_tpu_torch.losses import build_losses
    from irw_tpu_torch.models import get_model
    from irw_tpu_torch.transforms import DeviceTransform, build_transforms

    phase = "trunks_half"
    held = _release_earlier_phases(state)
    cfg = compose(runner.CONFIG_DIR, "default", HALF_OVERRIDES)
    name, kwargs = cfg.model.name, cfg.model.kwargs.to_dict()
    t0 = time.perf_counter()
    model = Getter().get_model(cfg.model, seed=0)
    build_s = time.perf_counter() - t0
    serve_dev = build_transforms(cfg.transform.test)[1]
    compute = _half_compute(model)
    gate = {str(m.dtype) for m in model.gate.modules() if hasattr(m, "dtype")}
    log(phase, f"{' '.join(HALF_OVERRIDES)}: {type(model).__name__} built in {build_s:.1f} s; "
               f"trunk convs and BatchNorms compute in {sorted(compute)}, the gate in "
               f"{sorted(gate)}, the classifiers in {model.classifier.dtype}")
    if compute != {"torch.bfloat16"} or gate != {"torch.float32"}:
        raise AssertionError(f"{phase}: the override built {compute} trunks, a {gate} gate")
    _check_f32_state(phase, "wcnn_attention_ce bf16 as built", model)

    # served: WARMUP_CALLS + SERVE_BATCHES batches of BATCH, K4 once a batch
    images = [b["image"] for b in _wavenet_batches(SERVE_DISTINCT, BATCH, 224, 64, 23)]
    kernels = _kernel_wrappers()
    with torch.inference_mode():
        for i in range(WARMUP_CALLS):
            model(serve_dev(images[i % SERVE_DISTINCT]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        per_batch, outs = [], []
        t0 = time.perf_counter()
        for i in range(SERVE_BATCHES):
            before = [fn.launches for fn in kernels]
            emb = model(serve_dev(images[i % SERVE_DISTINCT]))[0]
            if i < SERVE_DISTINCT:
                outs.append(emb)
            per_batch.append(tuple(fn.launches - b for fn, b in zip(kernels, before)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        serve_peak = torch.cuda.max_memory_allocated() - held
        state["launches"]["trunks_half_serve"] = _launch_counts(kernels)
        _check_launches(phase, per_batch, (0, 0, 0, 1, 0, 0, 0), "served batch")
        serve_ips = SERVE_BATCHES * BATCH / seconds
        log(phase, f"bf16 WCNN served {serve_ips:.1f} img/s, {seconds / SERVE_BATCHES * 1e3:.2f} "
                   f"ms a batch of {BATCH} ({SERVE_BATCHES} timed after {WARMUP_CALLS}; Normalize "
                   f"+ K4 in f32, 4 x ResNet-50 in bf16, CBAM gate in f32), embeddings "
                   f"{outs[0].dtype} {tuple(outs[0].shape)} | peak memory "
                   f"{serve_peak / 2 ** 30:.2f} GiB | {state['card']}")
        batch_ms = seconds / SERVE_BATCHES * 1e3
        busy_ms = _device_profile(phase, lambda: model(serve_dev(images[0])),
                                  f"one bf16 WCNN batch of {BATCH}", state, _WCNN_GROUPS)
        if busy_ms is not None:
            log(phase, f"idle share against the timed batches' {batch_ms:.2f} ms: "
                       f"{1 - busy_ms / batch_ms:.3f}")
        bands = serve_dev(images[0])
        with _k4_plain():
            plain = serve_dev(images[0])
            plain_emb = model(plain)[0]
        k4_err = (bands - plain).abs().max().item() / max(1.0, plain.abs().max().item())
        log(phase, f"K4 against its plain route on the batch's images: max|bands - plain| "
                   f"{k4_err:.3e} of max(1, max|plain|) (limit {K4_TOL['haar']})")
        if not k4_err <= K4_TOL["haar"]:
            raise AssertionError(f"{phase}: K4 strays {k4_err} from its plain route")
        _hold_half(phase, "bf16 WCNN, K4's route against its plain route", outs[0], plain_emb,
                   "bfloat16")
        twin32 = _twin(name, kwargs, model, "float32")
        twin16 = _twin(name, kwargs, model, "float16")
        with _no_tf32():
            refs = [twin32(serve_dev(x))[0] for x in images]
        for i, (emb, ref) in enumerate(zip(outs, refs)):
            _hold_half(phase, f"bf16 WCNN batch {i}", emb, ref, "bfloat16")
        f16 = twin16(serve_dev(images[0]))[0]
        _hold_half(phase, f"f16 WCNN batch 0 ({_half_compute(twin16)})", f16, refs[0],
                   "float16")
        del twin16, refs, outs

    # trained: the first step against the f32 twin's, then HALF_STEPS timed
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():  # the zero-initialised classifiers drawn: a loss the features reach
        for lin in (model.branch_classifier, model.classifier):
            lin.weight.copy_(0.02 * torch.randn(lin.weight.shape, generator=gen))
    twin32 = _twin(name, kwargs, model, "float32")
    batches = _cub_batches(2, seed=24)
    states, firsts = {}, {}
    for label, mdl in (("bf16", model), ("f32", twin32)):
        states[label] = init_train_state(mdl, build_losses(WCNN_CE_LOSS), CUB_WRESNET,
                                         WCNN_CE_LOSS, seed=0)
    train_dev = build_transforms(cfg.transform.train)[1]
    step = build_train_step(train_dev)

    def hyper(ts):
        return _build_hyper(ts.optimizer_entries, 1, ts.step, 0, None)

    firsts["bf16"] = float(step(states["bf16"], batches[0], hyper(states["bf16"]))["total_loss"])
    with _no_tf32():
        firsts["f32"] = float(step(states["f32"], batches[0], hyper(states["f32"]))["total_loss"])
    rel = abs(firsts["bf16"] - firsts["f32"]) / abs(firsts["f32"])
    log(phase, f"first train step's total_loss: bf16 {firsts['bf16']:.6f}, f32 (TF32 off) "
               f"{firsts['f32']:.6f}, relative {rel:.2e} (limit {HALF_LOSS_REL})")
    if not rel <= HALF_LOSS_REL:
        raise AssertionError(f"{phase}: the bf16 step's loss strays {rel} from the f32 step's")
    del states["f32"], twin32
    torch.cuda.empty_cache()
    tstate = states["bf16"]
    metrics, step_ms = _timed_steps(
        phase, state, tstate, step, batches, lambda: hyper(tstate), WARMUP_CALLS, HALF_STEPS,
        (0, 0, 0, 1, 0, 0, 0), held, CUB_BATCH, "Normalize + K4 in f32, 4 x ResNet-50 in bf16, "
        "CBAM gate and 5 CE heads in f32, Adam; images made on the card")
    _check_finite(phase, metrics, ("total_loss", "grad_norm"))
    _check_f32_state(phase, "wcnn_attention_ce bf16 after its steps", model)
    opt_dtypes = {t.dtype for e in tstate.optimizer_entries for st in e.optimizer.state.values()
                  for t in st.values() if torch.is_tensor(t) and t.is_floating_point()}
    if opt_dtypes != {torch.float32}:
        raise AssertionError(f"{phase}: the optimizer state holds {opt_dtypes}")
    train_ips, train_peak = state["timings"][phase]
    busy_ms = _device_profile(phase, lambda: step(tstate, batches[1], hyper(tstate)),
                              f"one bf16 train step of {CUB_BATCH}", state, _WCNN_GROUPS)
    if busy_ms is not None:
        log(phase, f"idle share against the timed steps' {step_ms:.1f} ms: "
                   f"{1 - busy_ms / step_ms:.3f}")
    del model, tstate, step, batches, states

    # wresnet_sdd_ce + sdd in bf16: the in-model DWT (K4) before bf16 branches
    _release_earlier_phases(state)
    cfg_sdd = compose(runner.CONFIG_DIR, "default", HALF_SDD)
    sdd = Getter().get_model(cfg_sdd.model, seed=0)
    if _half_compute(sdd) != {"torch.bfloat16"}:
        raise AssertionError(f"{phase}: wresnet_sdd_ce built {_half_compute(sdd)}")
    sdd_batch = WAVENET_MAIN["wresnet_sdd_ce"][2]
    tstate, sdd_step, sdd_hyper, frozen = _wavenet_step(
        cfg_sdd, sdd, build_transforms(cfg_sdd.transform.train)[1], "multi_ce.yaml")
    sdd_batches = _wavenet_batches(2, sdd_batch, 224, 120, 25)
    metrics, sdd_ms = _timed_steps(
        "trunks_half_sdd", state, tstate, sdd_step, sdd_batches, sdd_hyper, WARMUP_CALLS,
        HALF_STEPS, (0, 0, 0, 1, 0, 0, 0), held, sdd_batch,
        f"wresnet_sdd_ce + sdd in bf16 (K4 in the model, 4 x ResNet-50 with the 1 x 1 stem at "
        f"112²), multi_ce, basic.yaml's AdamW, freezing set {frozen}")
    _check_finite(phase, metrics, ("total_loss", "grad_norm"))
    _check_f32_state(phase, "wresnet_sdd_ce bf16 after its steps", sdd)
    del sdd, tstate, sdd_step, sdd_batches

    # one bf16 batch and one step of each registry model, against its f32 twin
    norm_dev = DeviceTransform(DWT_OPS[:1])
    band_dev = DeviceTransform(DWT_OPS)
    for reg, (kw, loss_file, inputs) in HALF_MODELS.items():
        _release_earlier_phases(state)
        t0 = time.perf_counter()
        mdl = get_model(reg, seed=0, dtype="bfloat16", **kw)
        build_s = time.perf_counter() - t0
        dev = band_dev if inputs == "bands" else norm_dev
        expected = (0, 0, 0, 1 if inputs == "bands" else 0, 0, 0, 0)
        batch = _wavenet_batches(1, HALF_SMALL, 224, CUB_CLASSES, 26)[0]
        for fn in kernels:
            fn.launches = 0
        with torch.inference_mode():
            out = mdl(dev(batch["image"]))
            out = out[0] if isinstance(out, tuple) else out
            _check_launches(phase, [tuple(fn.launches for fn in kernels)], expected,
                            f"served batch, {reg}")
            twin = _twin(reg, kw, mdl, "float32")
            with _no_tf32():
                ref = twin(dev(batch["image"]))
            ref = ref[0] if isinstance(ref, tuple) else ref
            del twin
        unit = torch.nn.functional.normalize
        _hold_half(phase, f"{reg} bf16 ({type(mdl).__name__}, output {out.dtype} "
                          f"{tuple(out.shape)})", unit(out.float(), dim=-1),
                   unit(ref.float(), dim=-1), "bfloat16")
        loss_cfg = yaml_lite.load(os.path.join(runner.CONFIG_DIR, "loss", loss_file))
        tstate = init_train_state(mdl, build_losses(loss_cfg), WAVENET_OPTIMIZER, loss_cfg,
                                  seed=0)
        mstep = build_train_step(dev)
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        metrics = mstep(tstate, batch, _build_hyper(tstate.optimizer_entries, 1, 0, 0, None))
        torch.cuda.synchronize()
        _check_launches(phase, [tuple(fn.launches for fn in kernels)], expected,
                        f"train step, {reg}")
        _check_finite(phase, [metrics], ("total_loss", "grad_norm"))
        _check_f32_state(phase, f"{reg} bf16 after its step", mdl)
        log(phase, f"{reg}: built in {build_s:.1f} s, one bf16 step of {HALF_SMALL} with "
                   f"{loss_file} in {time.perf_counter() - t0:.2f} s (its first) | "
                   f"{state['card']}")
        del mdl, tstate, mstep

    f32_serve = state.get("timings", {}).get("wcnn")
    f32_train = state.get("timings", {}).get("wcnn_train")
    log(phase, "summary, WCNN at full width: served "
               + (f"f32 (TF32 convs) {f32_serve[0]:.1f} img/s, peak {f32_serve[1] / 2 ** 30:.2f} "
                  f"GiB; " if f32_serve else "f32 not run (phase wcnn); ")
               + f"bf16 {serve_ips:.1f} img/s, peak {serve_peak / 2 ** 30:.2f} GiB | trained at "
               f"{CUB_BATCH}: "
               + (f"f32 (TF32 convs) {f32_train[0]:.1f} img/s, {CUB_BATCH / f32_train[0] * 1e3:.1f} "
                  f"ms a step, peak {f32_train[1] / 2 ** 30:.2f} GiB; " if f32_train
                  else "f32 not run (phase wcnn_train); ")
               + f"bf16 {train_ips:.1f} img/s, {step_ms:.1f} ms a step, peak "
               f"{train_peak / 2 ** 30:.2f} GiB | wresnet_sdd_ce bf16 {sdd_ms:.1f} ms a step "
               f"at {sdd_batch} | {state['card']}")


def phase_microbatch(state):
    """The flagship trains micro-batched (ROADMAP A12): the train phase's model
    and step with ``sub_batch`` 32, 40 and 19; launches per step; img/s and
    peak memory beside ``train``'s; the kernel route against the plain route
    at 32, running statistics included."""
    import torch

    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.engine import build_train_step, init_train_state
    from irw_tpu_torch.engine.train import _build_hyper
    from irw_tpu_torch.engine.train_step import micro_batches
    from irw_tpu_torch.losses import build_losses
    from irw_tpu_torch.ops.attention import attention_plain_autograd
    from irw_tpu_torch.transforms import DeviceTransform

    held = _release_earlier_phases(state)
    model = _flagship_model()
    _check_cores(model, "vmem_attention_fn")
    ds = SyntheticVOCDataset(num_train=TRAIN_BATCH * 2, image_size=224, seed=3)
    batches = [{"image": ds.images[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                "label": ds.labels[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]} for i in range(2)]
    tstate = init_train_state(model, build_losses(HASH_LOSS), OPTIMIZER, HASH_LOSS, seed=0)

    def hyper():
        return _build_hyper(tstate.optimizer_entries, 1, tstate.step, PROTOCOL["warm_up"], None,
                            PROTOCOL["ortho_scale"])

    steps, window_ms = {}, None
    for sub_batch, n in MICRO_STEPS.items():
        chunks = micro_batches(TRAIN_BATCH, sub_batch)
        steps[sub_batch] = build_train_step(DeviceTransform(SWT_OPS),
                                            clip_grad=PROTOCOL["clip_grad"],
                                            proxy_map_metric="hamming", sub_batch=sub_batch)
        # K2: each block's forward, its chunk's recompute and its own recompute
        expected = (1, 36 * len(chunks), 12 * len(chunks), 0, 0, 0, 0)
        metrics, step_ms = _timed_steps(
            f"microbatch_{sub_batch}", state, tstate, steps[sub_batch], batches, hyper,
            WARMUP_CALLS if n == TRAIN_STEPS else 1, n, expected, held, TRAIN_BATCH,
            f"chunks {chunks}, bf16, block remat inside each chunk's checkpoint, AdamW")
        _check_finite("microbatch", metrics, TRAIN_METRICS)
        window_ms = window_ms if sub_batch != next(iter(MICRO_STEPS)) else step_ms
    timings = state["timings"]
    even = next(iter(MICRO_STEPS))  # the timed window's sub_batch
    ips, peak = timings[f"microbatch_{even}"]
    if "train" in timings:
        log("microbatch", f"sub_batch {even}: {ips:.1f} trained img/s and {peak / 2 ** 30:.2f} GiB "
                          f"peak beside the unchunked train phase's {timings['train'][0]:.1f} "
                          f"img/s and {timings['train'][1] / 2 ** 30:.2f} GiB at batch "
                          f"{TRAIN_BATCH} in this run | {state['card']}")

    # the kernel route against the plain route, from one saved state
    snapshot = {"model": {k: v.clone() for k, v in model.state_dict().items()},
                "loss": {k: v.clone() for k, v in tstate.losses[0][0].state_dict().items()},
                "rng": {k: g.get_state() for k, g in tstate.generators.items()}}
    routes = {}
    for name, core in (("kernel", None), ("plain", attention_plain_autograd)):
        loss, grads = _route_step(tstate, steps[even], batches[0], hyper(), snapshot, core=core)
        bn = model.hash_head.bn
        routes[name] = (loss, grads, torch.cat([bn.running_mean, bn.running_var]).clone())
    (loss_k, grads_k, bn_k), (loss_p, grads_p, bn_p) = routes["kernel"], routes["plain"]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cosines = {m: float(torch.nn.functional.cosine_similarity(grads_k[m], grads_p[m], dim=0))
               for m in grads_k}
    bn_err = float(((bn_k - bn_p).abs() / bn_p.abs().clamp(min=1.0)).max())
    moved = not torch.equal(bn_k, torch.cat([snapshot["model"]["hash_head.bn.running_mean"],
                                             snapshot["model"]["hash_head.bn.running_var"]]))
    log("microbatch", f"kernel vs plain route at sub_batch {even}: total_loss {loss_k:.6f} vs "
                      f"{loss_p:.6f} (rel {rel:.2e}, limit {ROUTE_LOSS_TOL}); gradient cosine "
                      "per module " + ", ".join(f"{m} {c:.6f}" for m, c in cosines.items())
                      + f" (limit {ROUTE_COSINE}); HashHead running statistics within "
                      f"{bn_err:.2e} (limit {MICRO_BN_TOL}), moved {moved}")
    if not (rel <= ROUTE_LOSS_TOL and all(c >= ROUTE_COSINE for c in cosines.values())
            and bn_err <= MICRO_BN_TOL and moved):
        raise AssertionError(f"microbatch: the kernel route disagrees with the plain route: "
                             f"{rel}, {cosines}, {bn_err}, moved {moved}")
    busy_ms = _device_profile("microbatch", lambda: steps[even](tstate, batches[1], hyper()),
                              f"one train step of {TRAIN_BATCH} in chunks of {even}", state)
    if busy_ms is not None:
        log("microbatch", f"idle share against the timed steps' {window_ms:.1f} ms: "
                          f"{1 - busy_ms / window_ms:.3f}")
    _release_earlier_phases(state)


def _extras_adaptive(state, held: int):
    """Adaptive loss weighting on the CUB recipe: ADAPTIVE_STEPS timed steps
    (K4 once a step), the weights finite, and one step's weights on K4's
    route against its plain route from the same weights and memory."""
    import torch

    from irw_tpu_torch.engine import build_train_step, get_memory, init_train_state
    from irw_tpu_torch.engine.train import _build_hyper
    from irw_tpu_torch.losses import build_losses
    from irw_tpu_torch.models import get_model
    from irw_tpu_torch.transforms import DeviceTransform

    model = get_model(WCNN_EMB["name"], seed=0, **WCNN_EMB["kwargs"])
    xbm = get_memory(CUB_MEMORY, 2048)
    tstate = init_train_state(model, build_losses(ROADMAP_ADAPTIVE), CUB_OPTIMIZER,
                              ROADMAP_ADAPTIVE, seed=0, xbm=xbm)
    gen = torch.Generator(device="cuda").manual_seed(7)
    tstate.xbm_state = xbm.update(
        tstate.xbm_state,
        torch.nn.functional.normalize(torch.randn(xbm.size, xbm.embedding_dim, generator=gen,
                                                  device="cuda"), dim=1),
        torch.randint(0, CUB_CLASSES, (xbm.size,), generator=gen, device="cuda",
                      dtype=torch.int32),
        torch.arange(xbm.size, device="cuda"))
    step = build_train_step(DeviceTransform(DWT_OPS), xbm=xbm, xbm_active=True,
                            adaptive_weights=True)
    batches = _cub_batches(ADAPTIVE_STEPS + 1, seed=9, memory=xbm.size)

    def hyper():
        return _build_hyper(tstate.optimizer_entries, 1, tstate.step, 0, None)

    weights = [f"adaptive_weight_{i}" for i in range(4)]
    metrics, step_ms = _timed_steps(
        "engine_extras_adaptive", state, tstate, step, batches, hyper, 1, ADAPTIVE_STEPS,
        (0, 0, 0, 1, 0, 0, 0), held, CUB_BATCH, "the CUB recipe with adaptive weighting: one "
        "forward, 5 pullbacks (CalibrationLoss, its memory term, SupAP, its memory term, ortho) "
        f"over {xbm.size} slots, Adam")
    _check_finite("engine_extras", metrics, XBM_TERMS + ("total_loss", "grad_norm", *weights))

    snapshot = {"model": {k: v.clone() for k, v in model.state_dict().items()},
                "xbm": [t.clone() for t in (tstate.xbm_state.embeddings, tstate.xbm_state.labels,
                                            tstate.xbm_state.valid, tstate.xbm_state.ptr)]}
    routes = []
    for plain in (False, True):
        model.load_state_dict(snapshot["model"])
        for t, saved in zip((tstate.xbm_state.embeddings, tstate.xbm_state.labels,
                             tstate.xbm_state.valid, tstate.xbm_state.ptr), snapshot["xbm"]):
            t.copy_(saved)
        with _k4_plain() if plain else contextlib.nullcontext():
            m = step(tstate, batches[0], hyper())
        routes.append([float(m[w]) for w in weights])
    rel = max(abs(a - b) / abs(b) for a, b in zip(*routes))
    log("engine_extras", f"adaptive weights {routes[0]} on K4's route, {routes[1]} on its plain "
                         f"route (rel {rel:.2e}, limit {ADAPTIVE_TOL}); {step_ms:.1f} ms a step "
                         f"| {state['card']}")
    if rel > ADAPTIVE_TOL:
        raise AssertionError(f"engine_extras: adaptive weights differ between routes: {routes}")


def _extras_optimizers(state):
    """RMSprop, Adagrad, LARS and Lamb: EXTRA_OPT_STEPS flagship steps each,
    then one step of the fusion and hash heads on the last step's gradients,
    on the card and on the CPU."""
    import copy

    import torch

    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.engine import build_train_step, init_train_state, optimizers
    from irw_tpu_torch.engine.train import _build_hyper
    from irw_tpu_torch.losses import build_losses
    from irw_tpu_torch.transforms import DeviceTransform

    model = _flagship_model()
    ds = SyntheticVOCDataset(num_train=TRAIN_BATCH, image_size=224, seed=5)
    batch = {"image": ds.images, "label": ds.labels}
    step = build_train_step(DeviceTransform(SWT_OPS), proxy_map_metric="hamming")
    for name in EXTRA_OPTIMIZERS:
        cfg = [{"name": name, "params": None, "kwargs": {"lr": EXTRA_OPT_LR}}]
        tstate = init_train_state(model, build_losses(HASH_LOSS), cfg, HASH_LOSS, seed=0)
        assert isinstance(tstate.optimizer_entries[0].optimizer, optimizers.OptaxOptimizer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = [step(tstate, batch, _build_hyper(tstate.optimizer_entries, 1, tstate.step, 0,
                                                    None)) for _ in range(EXTRA_OPT_STEPS)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        losses = [float(m["total_loss"]) for m in metrics]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"engine_extras: {name} gave losses {losses}")
        # one step of the heads on identical gradients, card against CPU
        heads = torch.nn.ModuleDict({"head": copy.deepcopy(model.head),
                                     "hash_head": copy.deepcopy(model.hash_head)})
        grads = {f"{m}.{n}": p.grad.clone() for m in ("head", "hash_head")
                 for n, p in getattr(model, m).named_parameters() if p.grad is not None}
        after, start = [], {}
        for module in (heads, copy.deepcopy(heads).cpu()):
            start = {n: p.detach().cpu().clone() for n, p in module.named_parameters()}
            for n, p in module.named_parameters():
                p.grad = grads[n].to(p.device) if n in grads else None
            entry = optimizers.build_optimizers([dict(cfg[0], kwargs={"lr": 1e-3})], module)[0]
            entry.optimizer.step()
            after.append({n: p.detach().cpu() for n, p in module.named_parameters()
                          if n in grads})
        # the card's update against the CPU's, of the CPU's largest move in each
        # tensor, past one unit in the last place of the parameter itself
        err = 0.0
        for n, ref in after[1].items():
            excess = (after[0][n] - ref).abs().numpy() - np.spacing(np.abs(ref.numpy()))
            err = max(err, float(excess.max()) / max(float((ref - start[n]).abs().max()), 1e-30))
        log("engine_extras", f"{name}: losses {', '.join(f'{v:.6f}' for v in losses)} over "
                             f"{EXTRA_OPT_STEPS} steps of {TRAIN_BATCH} ({seconds:.2f} s, the "
                             f"first with its build); one update of the heads' "
                             f"{len(after[1])} tensors on identical gradients within {err:.2e} "
                             f"of the CPU's largest move (limit {EXTRA_OPT_TOL})")
        if err > EXTRA_OPT_TOL:
            raise AssertionError(f"engine_extras: {name}'s update on the card differs from "
                                 f"the CPU's: {err}")
        del tstate, heads
    del model


def _extras_run(overrides: list, log_root: str, name: str) -> tuple:
    """``run`` of ``compose(default, overrides)`` on the card, logs under
    ``log_root``: (metrics by split, the run's metrics.jsonl records, its log
    directory, seconds)."""
    import os

    from irw_tpu_torch import run as port_run
    from irw_tpu_torch import single_experiment_runner as runner
    from irw_tpu_torch.config import compose

    cfg = compose(runner.CONFIG_DIR, "default",
                  overrides + [f"experience.log_dir={log_root}",
                               f"experience.experiment_name={name}"])
    t0 = time.perf_counter()
    metrics = port_run.run(cfg)
    log_dir = os.path.join(log_root, name)
    return metrics, _jsonl(os.path.join(log_dir, "metrics.jsonl")), log_dir, \
        time.perf_counter() - t0


def _extras_runs(state):
    """The DSCH recipe, the three k-fold kinds and the fast eval with the
    instrumentor, each through ``run`` on the card."""
    import os
    import tempfile

    import torch

    from irw_tpu_torch.hooks import instrumentation

    with tempfile.TemporaryDirectory() as root:
        metrics, records, _, seconds = _extras_run(DSCH_JOB, root, "dsch")
        scores = {r["step"]: r["test/map_level0"] for r in records if "test/map_level0" in r}
        alphas = [r["train/model_alpha"] for r in records if "train/model_alpha" in r]
        best = max(scores, key=lambda e: (scores[e], -e))
        stopped = max(scores) < 4
        log("engine_extras", f"DSCH recipe: test map_level0 by epoch {scores}, α {alphas}; "
                             f"stopped early {stopped}; returned {metrics['test']['map_level0']} "
                             f"(epoch {best}'s) in {seconds:.1f} s")
        if metrics["test"]["map_level0"] != scores[best]:
            raise AssertionError("engine_extras: DSCH returned other than the best epoch's "
                                 f"metrics: {metrics['test']}, {scores}")

        for kind in KFOLD_KINDS:
            metrics, records, _, seconds = _extras_run(
                EXTRAS_JOB + ["experience.kfold.use_kfold=true", f"experience.kfold.kind={kind}",
                              "experience.max_iter=1", "experience.val_eval_freq=1",
                              "experience.test_eval_freq=-1", "experience.train_eval_freq=-1"],
                root, f"kfold_{kind}")
            logged = [r["val/map_level0"] for r in records if "val/map_level0" in r]
            log("engine_extras", f"k-fold {kind}: val map_level0 {logged} logged, splits "
                                 f"{sorted(metrics)} in {seconds:.1f} s")
            if len(logged) != 1 or "val" not in metrics:
                raise AssertionError(f"engine_extras: k-fold {kind} logged no val split")

        kernels = _kernel_wrappers()
        dumps = []
        dump = instrumentation.FixedBatchInstrumentor.maybe_dump

        def counted(self, epoch, *args, **kwargs):
            # the capture's own peak memory: above what the run holds when it starts
            before = [fn.launches for fn in kernels]
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            path = dump(self, epoch, *args, **kwargs)
            torch.cuda.synchronize()
            if path is not None:
                dumps.append((path, tuple(fn.launches - b for fn, b in zip(kernels, before)),
                              (torch.cuda.max_memory_allocated() - held) / 2 ** 30))
            return path

        instrumentation.FixedBatchInstrumentor.maybe_dump = counted
        try:
            metrics, records, log_dir, seconds = _extras_run(
                EXTRAS_JOB + ["experience.with_fast_eval=true", "experience.max_iter=2",
                              "experience.train_eval_freq=2", "experience.test_eval_freq=2",
                              "experience.hooks_configs.active=true",
                              "experience.hooks_configs.target_epochs=[1, 2]"],
                root, "extras")
        finally:
            instrumentation.FixedBatchInstrumentor.maybe_dump = dump
        fast = [r["step"] for r in records if any(k.startswith("fast_eval/") for k in r)]
        files = sorted(os.listdir(os.path.join(log_dir, "instrumentation")))
        keys = []
        for path, _, _ in dumps:
            with np.load(path) as data:
                keys.append(sorted(k[len("feat/"):] for k in data.files if k.startswith("feat/")))
        log("engine_extras", f"fast eval logged at epochs {fast}; instrumentation files {files}; "
                             f"{len(keys[0]) if keys else 0} features a dump; launches per "
                             f"capture ({', '.join(KERNEL_IDS)}): {[c for _, c, _ in dumps]}; "
                             f"the captures' own peak memory "
                             f"{[round(g, 3) for _, _, g in dumps]} GiB; in {seconds:.1f} s")
        if fast != [1]:
            raise AssertionError(f"engine_extras: fast_eval/ logged at {fast}, not [1]")
        if files != ["analysis_epoch_1.npz", "analysis_epoch_2.npz", "fixed_batch.npz"]:
            raise AssertionError(f"engine_extras: instrumentation wrote {files}")
        if keys != [list(HOOK_FEATURES)] * 2:
            raise AssertionError(f"engine_extras: the dumps hold {keys}")
        _check_launches("engine_extras", [c for _, c, _ in dumps], (1, 12, 0, 0, 0, 0, 0),
                        "instrumentor capture")


def phase_engine_extras(state):
    """The rest of ROADMAP A12 at full width: adaptive weighting (K4), the
    four optax optimizers, the DSCH protocol, k-fold splits, the fast eval
    and the instrumentor (K1, K2) through ``run``."""
    t0 = time.perf_counter()
    held = _release_earlier_phases(state)
    _extras_adaptive(state, held)
    _release_earlier_phases(state)
    t1 = time.perf_counter()
    _extras_optimizers(state)
    _release_earlier_phases(state)
    t2 = time.perf_counter()
    _extras_runs(state)
    _release_earlier_phases(state)
    log("engine_extras", f"adaptive {t1 - t0:.1f} s, optimizers {t2 - t1:.1f} s, runs "
                         f"{time.perf_counter() - t2:.1f} s")


# the run_tools phase: the flagship study's job through ``run`` at full width,
# 2 steps of 96 on 224² synthetic images whose host stages are identities
# (Resize and crops at 224), so the offline eval sees the run's own eval
# pixels; eval_bs 256 (its query set and gallery each one padded batch)
RUN_TOOLS_TRAIN, RUN_TOOLS_QUERY, RUN_TOOLS_EVAL_BS = 192, 128, 256
RUN_TOOLS_CUTS = [f"dataset.kwargs.num_train={RUN_TOOLS_TRAIN}",
                  f"dataset.kwargs.num_query={RUN_TOOLS_QUERY}", "dataset.kwargs.image_size=224",
                  "transform.train.Resize.size=224", "transform.train.RandomResizedCrop.size=224",
                  "transform.test.Resize.size=224", "transform.test.CenterCrop.size=224",
                  "experience.max_iter=1", "experience.train_eval_freq=1",
                  "experience.test_eval_freq=1", "experience.checkpoint_freq=1",
                  f"experience.eval_bs={RUN_TOOLS_EVAL_BS}",
                  f"experience.evaluation.top_k={RUN_TOOLS_TRAIN}"]
RUN_TOOLS_BS = 64           # mean_attention's and generate_alphas's --bs default
RUN_TOOLS_METRIC_TOL = 1e-6  # the offline eval against the run's own, absolute
# generate_alphas over configs/model/wcnn_attention_ce.yaml + cub_dwt at full width
RUN_TOOLS_WCNN = ["dataset=synthetic", "dataset.kwargs.num_samples=128", "transform=cub_dwt",
                  "model=wcnn_attention_ce"]
# the serving phase: the int8 flagship beside the float one, and the exports
EXPORT_CODES_SHARE = 0.9    # least share of int8 sign codes equal to the float program's


def _tool_launches(kernels, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with every count set to 0 first; (its
    result, the launches of its run less those of ``run.first_sample``, the
    one sizing batch ``load_run`` sends through the train stages)."""
    import torch

    from irw_tpu_torch import run as port_run

    sizing = [0] * len(kernels)
    first_sample = port_run.first_sample

    def counted(*a, **k):
        before = [k_.launches for k_ in kernels]
        out = first_sample(*a, **k)
        for i, (k_, b) in enumerate(zip(kernels, before)):
            sizing[i] += k_.launches - b
        return out

    for k_ in kernels:
        k_.launches = 0
    port_run.first_sample = counted
    try:
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
    finally:
        port_run.first_sample = first_sample
    return out, {k_.__name__: k_.launches - s for k_, s in zip(kernels, sizing)}


def _per_unit(phase: str, counts: dict, units: int, expected: tuple, what: str) -> None:
    per = tuple(counts[fn.__name__] / units for fn in _kernel_wrappers())
    _check_launches(phase, [per], expected, what)


def _hub_dinov2_vits14(tokens: int, depth: int = 12, seed: int = 0) -> dict:
    """A torch.hub DINOv2 ViT-S/14 state dict (``blocks.N.attn.qkv``,
    ``ls1.gamma``, ``mask_token``, …) drawn from ``seed``, its position
    table ``tokens`` long: made in memory, nothing is downloaded."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    d, sd = 384, {}

    def draw(*shape, std=0.02, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen)

    sd["cls_token"], sd["mask_token"] = draw(1, 1, d), draw(1, d)
    sd["pos_embed"] = draw(1, tokens, d)
    sd["patch_embed.proj.weight"] = draw(d, 3, 14, 14, std=(3 * 14 * 14) ** -0.5)
    sd["patch_embed.proj.bias"] = draw(d)
    for i in range(depth):
        b = f"blocks.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{b}.{norm}.weight"], sd[f"{b}.{norm}.bias"] = draw(d, std=0.1, mean=1.0), draw(d)
        for name, (o, n) in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                             ("mlp.fc1", (4 * d, d)), ("mlp.fc2", (d, 4 * d))):
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = draw(o, n, std=n ** -0.5), draw(o)
        sd[f"{b}.ls1.gamma"], sd[f"{b}.ls2.gamma"] = draw(d, std=0.1, mean=1.0), draw(d, std=0.1,
                                                                                      mean=1.0)
    sd["norm.weight"], sd["norm.bias"] = draw(d, std=0.1, mean=1.0), draw(d)
    return sd


def phase_run_tools(state):
    """What a trained run is used for (ROADMAP A15b): the flagship study's
    job through ``run`` (RUN_TOOLS_CUTS), then over its run dir, on the
    card, ``evaluate.load_and_evaluate`` (held to the run's own last eval),
    ``attention.mean_attention``, ``plot_exemples.retrieval_rows`` and
    ``render``; ``alpha_weights.generate_alphas`` over a wcnn_attention_ce +
    cub_dwt run dir (K4); a seeded hub-layout DINOv2 ViT-S/14 converted and
    grafted into the flagship, which serves a batch."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from irw_tpu_torch import alpha_weights, attention, evaluate, plot_exemples
    from irw_tpu_torch import single_experiment_runner as runner
    from irw_tpu_torch.config import compose
    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.getter import Getter
    from irw_tpu_torch.run import first_sample, first_sampler, run
    from irw_tpu_torch.studies.run_plan import expand_jobs, load_plan
    from irw_tpu_torch.tools.convert_torch_weights import convert
    from irw_tpu_torch.transforms import DeviceTransform
    from irw_tpu_torch.utils.pretrained import graft_flagship_backbone

    held = _release_earlier_phases(state)
    kernels = _kernel_wrappers()
    repo = os.path.dirname(os.path.abspath(__file__))
    (name, job), = [(n, o) for n, o in expand_jobs(load_plan(os.path.join(repo, RUNNER_PLAN)))
                    if RUNNER_JOB in o]
    root = tempfile.mkdtemp(prefix="irw_run_tools_")
    try:
        t0 = time.perf_counter()
        metrics = run(compose(runner.CONFIG_DIR, "default",
                              job + RUN_TOOLS_CUTS + [f"experience.log_dir={root}"]))["test"]
        run_dir = os.path.join(root, name)
        t1 = time.perf_counter()
        log("run_tools", f"the run: {t1 - t0:.1f} s ({RUN_TOOLS_TRAIN // TRAIN_BATCH} steps of "
                         f"{TRAIN_BATCH}, its eval), map_level0 {metrics['map_level0']:.4f}")

        offline, counts = _tool_launches(kernels, evaluate.load_and_evaluate, run_dir,
                                         batch_size=RUN_TOOLS_EVAL_BS)
        t2 = time.perf_counter()
        state["launches"]["run_tools_eval"] = counts
        _per_unit("run_tools", counts, 2, (1, 12, 0, 0, 0, 0, 0),
                  "eval batch of load_and_evaluate (query set, gallery)")
        worst = max(abs(offline[k] - metrics[k]) for k in metrics)
        log("run_tools", f"load_and_evaluate: {t2 - t1:.1f} s, map_level0 "
                         f"{offline['map_level0']:.6f}, max |offline - the run's last eval| over "
                         f"{len(metrics)} metrics {worst:.3e}")
        if set(offline) != set(metrics) or worst > RUN_TOOLS_METRIC_TOL:
            raise AssertionError(f"run_tools: offline eval {offline} differs from the run's "
                                 f"last eval {metrics}")

        mean, counts = _tool_launches(kernels, attention.mean_attention, run_dir, "test",
                                      RUN_TOOLS_BS)
        batches = -(-RUN_TOOLS_TRAIN // RUN_TOOLS_BS)   # the gallery
        state["launches"]["run_tools_attention"] = counts
        _per_unit("run_tools", counts, batches, (1, 12, 0, 0, 0, 0, 0), "mean_attention batch")
        log("run_tools", f"mean_attention over {RUN_TOOLS_TRAIN} gallery images: per band "
                         f"{np.round(mean.mean(0), 4).tolist()}, rows sum to "
                         f"{np.round(mean.sum(1), 6).tolist()}")
        if mean.shape != (4, 4) or not np.allclose(mean.sum(1), 1.0, atol=1e-3):
            raise AssertionError(f"run_tools: attention weights {mean}")

        t3 = time.perf_counter()
        rows, counts = _tool_launches(kernels, plot_exemples.retrieval_rows, run_dir, 6, 5)
        state["launches"]["run_tools_panels"] = counts
        _per_unit("run_tools", counts, 2, (1, 12, 0, 0, 0, 0, 0),
                  "retrieval_rows batch (query set, gallery)")
        png = os.path.join(root, "panels.png")
        canvas = plot_exemples.render([rows], png)
        with open(png, "rb") as f:
            signature = f.read(8)
        colours = [c for row in rows for _, c in row]
        log("run_tools", f"retrieval_rows + render: {time.perf_counter() - t3:.1f} s, canvas "
                         f"{canvas.shape}, {os.path.getsize(png)} PNG bytes, borders "
                         f"{ {c: colours.count(c) for c in sorted(set(colours))} }")
        if canvas.shape != (6 * 110, 6 * 110, 3) or signature != b"\x89PNG\r\n\x1a\n":
            raise AssertionError("run_tools: the retrieval panel")

        # generate_alphas over a wcnn_attention_ce + cub_dwt run dir: the
        # config's model at full width, its weights from seed 0
        wcnn_dir = os.path.join(root, "wcnn")
        cfg = compose(runner.CONFIG_DIR, "default", RUN_TOOLS_WCNN)
        getter = Getter()
        (host_train, device_train), _ = getter.get_transform(cfg.transform)
        train_ds, _ = getter.get_dataset(cfg.dataset)
        sample = first_sample(first_sampler(getter, cfg, train_ds, 0), train_ds, host_train,
                              device_train, 0)
        model = getter.get_model(cfg.model, seed=0, image_size=tuple(sample.shape[-3:-1]))
        os.makedirs(os.path.join(wcnn_dir, "weights"))
        torch.save({"state": {"model": model.state_dict()},
                    "meta": {"config": cfg.to_dict(), "epoch": 0, "score": None,
                             "best_score": None}}, os.path.join(wcnn_dir, "weights", "rolling"))
        del model
        t4 = time.perf_counter()
        alphas, counts = _tool_launches(kernels, alpha_weights.generate_alphas, wcnn_dir, "test",
                                        RUN_TOOLS_BS)
        state["launches"]["run_tools_alphas"] = counts
        _per_unit("run_tools", counts, 2, (0, 0, 0, 1, 0, 0, 0), "generate_alphas batch")
        log("run_tools", f"generate_alphas (wcnn_attention_ce, cub_dwt, 128 images): "
                         f"{time.perf_counter() - t4:.1f} s, mean gate "
                         f"{np.round(alphas, 4).tolist()}")
        if alphas.shape != (4,) or not np.isfinite(alphas).all():
            raise AssertionError(f"run_tools: gate alphas {alphas}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # a hub-layout DINOv2 ViT-S/14 converted and grafted into every band
    _release_earlier_phases(state)
    t5 = time.perf_counter()
    model = _flagship_model()
    vit = model.backbone.vit
    converted = convert(_hub_dinov2_vits14(vit.pos_embed.shape[-2], len(vit.blocks)),
                        "dinov2_vits14")
    graft_flagship_backbone(model, converted)
    last = len(vit.blocks) - 1
    q = vit.blocks[last].attn.query.weight
    if not all(torch.equal(q[b].cpu(), converted[f"blocks.{last}.attn.query.weight"])
               for b in range(4)):
        raise AssertionError("run_tools: the grafted tower is not in every band")
    images = SyntheticVOCDataset(num_train=BATCH, image_size=224, seed=0).images
    transform = DeviceTransform(SWT_OPS)
    with torch.inference_mode():
        (codes, _), counts = _tool_launches(kernels, lambda: model(transform(images)))
    state["launches"]["run_tools_graft"] = counts
    _per_unit("run_tools", counts, 1, (1, 12, 0, 0, 0, 0, 0), "served batch of the grafted model")
    log("run_tools", f"graft + a served batch of {BATCH}: {time.perf_counter() - t5:.1f} s, codes "
                     f"{tuple(codes.shape)}, share of +1 bits "
                     f"{float((codes > 0).float().mean()):.3f}"
                     f" | {state['card']}")
    if codes.shape != (BATCH, 64) or not bool(torch.isin(codes, torch.tensor(
            [-1.0, 1.0], device=codes.device)).all()):
        raise AssertionError("run_tools: the grafted model's codes")
    _release_earlier_phases(state)


def _serve_timed(model, transform, distinct, kernels):
    """WARMUP_CALLS, then SERVE_BATCHES timed batches; (ms a batch, the
    launches per batch, the codes of each distinct image set)."""
    import torch

    with torch.inference_mode():
        for i in range(WARMUP_CALLS):
            model(transform(distinct[i % SERVE_DISTINCT]))
        torch.cuda.synchronize()
        for fn in kernels:
            fn.launches = 0
        codes = []
        t0 = time.perf_counter()
        for i in range(SERVE_BATCHES):
            out, _ = model(transform(distinct[i % SERVE_DISTINCT]))
            if i < SERVE_DISTINCT:
                codes.append(out)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / SERVE_BATCHES * 1e3
    return ms, _launch_counts(kernels), codes


def phase_serving(state):
    """The serving extras (ROADMAP A14): the flagship with ``quant_int8``
    beside the float flagship on the same weights (img/s, launches, the
    share of equal sign codes); the float flagship exported with its device
    transform at a serve batch of BATCH, loaded and held bit for bit to
    the eager forward, K1 and K2 counted inside the program; the int8
    artifact (int8 weights and scales) exported; both artifacts' sizes."""
    import os
    import shutil
    import tempfile

    import torch

    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.tools.export_serving import export_model
    from irw_tpu_torch.transforms import DeviceTransform

    held = _release_earlier_phases(state)
    kernels = _kernel_wrappers()
    transform = DeviceTransform(SWT_OPS)
    ds = SyntheticVOCDataset(num_train=BATCH * SERVE_DISTINCT, image_size=224, seed=0)
    distinct = [ds.images[i * BATCH:(i + 1) * BATCH] for i in range(SERVE_DISTINCT)]
    model = _flagship_model()
    quant = _flagship_model(vit_kwargs={"quant_int8": True})
    quant.load_state_dict(model.state_dict())
    if type(quant.backbone.vit.blocks[0].attn).__name__ != "QuantMHA":
        raise AssertionError("serving: quant_int8 did not take the QuantMHA route")
    results = {}
    for label, m, expected in (("float", model, (1, 12, 0, 0, 0, 0, 0)),
                               ("int8", quant, (1, 0, 0, 0, 0, 0, 0))):
        ms, counts, codes = _serve_timed(m, transform, distinct, kernels)
        state["launches"][f"serving_{label}"] = counts
        _per_unit("serving", counts, SERVE_BATCHES, expected, f"{label} served batch")
        results[label] = codes
        log("serving", f"{label}: {BATCH * 1e3 / ms:.1f} img/s, {ms:.2f} ms a batch of {BATCH} "
                       f"(SWT + 4 x ViT-S/14 + fusion + hash, bf16) | {state['card']}")
    same = torch.cat([(a == b).float().flatten() for a, b in zip(results["float"],
                                                                  results["int8"])])
    log("serving", f"int8 sign codes equal to the float program's: {float(same.mean()):.4f} of "
                   f"{same.numel()} bits")
    if float(same.mean()) < EXPORT_CODES_SHARE:
        raise AssertionError("serving: the int8 codes left the float program's")

    root = tempfile.mkdtemp(prefix="irw_serving_")
    try:
        images = torch.from_numpy(distinct[0]).cuda()
        path = os.path.join(root, "float.pt2")
        t0 = time.perf_counter()
        export_model(model, None, (224, 224, 3), out_path=path, symbolic_batch=BATCH,
                     device_transform=transform)
        t1 = time.perf_counter()
        served = torch.export.load(path).module()
        t2 = time.perf_counter()
        with torch.inference_mode():
            eager, _ = model(transform(images))
            out, counts = _tool_launches(kernels, served, images)
        state["launches"]["serving_export"] = counts
        _per_unit("serving", counts, 1, (1, 12, 0, 0, 0, 0, 0), "batch of the loaded artifact")
        log("serving", f"float artifact: {os.path.getsize(path) / 2 ** 20:.1f} MiB, export "
                       f"{t1 - t0:.1f} s, load {t2 - t1:.1f} s, codes {tuple(out.shape)} equal "
                       f"to the eager forward's: {bool(torch.equal(out, eager))}")
        if not torch.equal(out, eager):
            raise AssertionError("serving: the loaded artifact's codes differ")
        del served
        # the int8 artifact (the CPU tests load one and hold it to the eager
        # int8 forward): its size
        path = os.path.join(root, "int8.pt2")
        t0 = time.perf_counter()
        export_model(quant, None, (224, 224, 3), out_path=path, symbolic_batch=BATCH,
                     device_transform=transform, compress_int8=True)
        log("serving", f"int8 artifact (int8 weights and scales): "
                       f"{os.path.getsize(path) / 2 ** 20:.1f} MiB, export "
                       f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _release_earlier_phases(state)


# the multi_card phase (ROADMAP A13a): the flagship over a VOC-train-sized
# set (the study's 5717-image gallery, Hamming) and the WCNN over CUB's test
# split (cosine), evaluated by one process and over process groups
MULTI_CARD_N = {"flagship": 5717, "wcnn": CUB_TEST}
MULTI_CARD_IMAGE = 224
MULTI_CARD_K = {"flagship": 5717, "wcnn": 5000}   # the study's top_k; phase wcnn's
MULTI_CARD_FIRST = 64     # queries whose top-k indices must equal the single process's
MULTI_CARD_TOL = 1e-6     # every metric against the single process, absolute
MULTI_CARD_PER_BATCH = {"flagship": (1, 12, 0, 0, 0, 0, 0), "wcnn": (0, 0, 0, 1, 0, 0, 0)}
MULTI_CARD_ROUTE_S = 150.0   # a route's ranks end within this, or are killed (33 s seen)


def _join_by(context, deadline: float, route: str) -> None:
    """Join the spawned ranks (``join`` raises if one failed); past
    ``deadline`` (``time.perf_counter``) kill the ones still running and
    raise naming them."""
    while not context.join(max(deadline - time.perf_counter(), 0.0)):
        if time.perf_counter() >= deadline:
            alive = [r for r, p in enumerate(context.processes) if p.is_alive()]
            for p in context.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
            raise AssertionError(f"{route}: ranks {alive} still running after "
                                 f"{MULTI_CARD_ROUTE_S:.0f} s, killed")


def _multi_card_sets(workdir: str) -> None:
    """The phase's images and labels, drawn on the card from seed 0 and
    written as .npy for every process to map: uint8 224² images, VOC's 20
    multi-label classes for the flagship, 100 CUB classes for the WCNN."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, n in MULTI_CARD_N.items():
        size = MULTI_CARD_IMAGE
        images = torch.randint(0, 256, (n, size, size, 3), generator=gen, device="cuda",
                               dtype=torch.uint8)
        if name == "flagship":
            labels = (torch.rand(n, 20, generator=gen, device="cuda") > 0.85).float()
        else:
            labels = torch.randint(0, 100, (n,), generator=gen, device="cuda")
        np.save(f"{workdir}/{name}_images.npy", images.cpu().numpy())
        np.save(f"{workdir}/{name}_labels.npy", labels.cpu().numpy())


def _multi_card_eval(name: str, batch: int, workdir: str) -> dict:
    """Model ``name`` at full width (seed 0, replicated from rank 0 under a
    group) over the phase's set, as one process or one rank runs it: one
    warm-up batch, then ``evaluate`` timed with its launches, its embedding
    sweep (``compute_embeddings``) timed inside it and its embeddings (as
    the group gathered them) kept for the first query chunk's top-k
    indices; the peak memory."""
    import importlib

    import torch

    from irw_tpu_torch.data.base import InMemoryDataset
    from irw_tpu_torch.models import get_model
    from irw_tpu_torch.ops.knn import knn
    from irw_tpu_torch.parallel import replicate, world_size
    from irw_tpu_torch.transforms import DeviceTransform

    ds = InMemoryDataset([], np.load(f"{workdir}/{name}_labels.npy"))
    ds.images = np.load(f"{workdir}/{name}_images.npy", mmap_mode="r")   # the memory route
    if name == "flagship":
        model, ops, metric = _flagship_model(), SWT_OPS, "hamming"
    else:
        model, ops, metric = get_model(WCNN["name"], seed=0, **WCNN["kwargs"]), DWT_OPS, "cosine"
    replicate(model)
    transform = DeviceTransform(ops)
    k = min(MULTI_CARD_K[name], len(ds) - 1)
    kernels = _kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        model(transform(np.array(ds.images[:batch // world_size()])))
    sweep = {}
    engine_evaluate = importlib.import_module("irw_tpu_torch.engine.evaluate")
    embed = engine_evaluate.compute_embeddings

    def timed_embed(*args, **kwargs):   # the sweep inside evaluate, timed and kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep["emb"], labels = embed(*args, **kwargs)
        torch.cuda.synchronize()
        sweep["seconds"] = time.perf_counter() - t0
        return sweep["emb"], labels

    for fn in kernels:
        fn.launches = 0
    engine_evaluate.compute_embeddings = timed_embed
    try:
        t0 = time.perf_counter()
        metrics = engine_evaluate.evaluate(model, ds, transform, batch_size=batch, top_k=k,
                                           distance_metric=metric)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    finally:
        engine_evaluate.compute_embeddings = embed
    launches = [fn.launches for fn in kernels]
    emb = sweep["emb"]
    idx, _ = knn(emb[:512], emb, k, metric, same_source=True, query_chunk=512)
    return {"metrics": metrics, "first": idx[:MULTI_CARD_FIRST].cpu().numpy(),
            "launches": launches, "names": [fn.__name__ for fn in kernels], "eval_s": eval_s,
            "embed_s": sweep["seconds"], "peak": torch.cuda.max_memory_allocated(), "k": k}


def _fresh_k1_build(directory: str) -> dict:
    """K1 built into the empty ``directory`` (``cuda_lib.load`` at its first
    launch), loaded and held against its plain version once; the build
    directory is restored after."""
    from pathlib import Path

    import torch

    from irw_tpu_torch import cuda_lib
    from irw_tpu_torch.ops.wavelets import haar_swt2, haar_swt2_plain

    cached, cuda_lib.BUILD_DIR = cuda_lib.BUILD_DIR, Path(directory)
    try:
        t0 = time.perf_counter()
        x = torch.randn(3, 224, 224, device="cuda")
        err = (haar_swt2(x) - haar_swt2_plain(x)).abs().max().item()
        return {"seconds": time.perf_counter() - t0, "max_abs_err": err,
                "bytes": cuda_lib.lib_path("haar_swt2").stat().st_size}
    finally:
        cuda_lib.BUILD_DIR = cached


def _multi_card_rank(rank: int, world: int, backend: str, cards: list, workdir: str,
                     fresh_build: str | None) -> None:
    """One rank of a route: joins the group on card ``cards[rank]``; with
    ``fresh_build`` every rank builds K1 into that empty directory at the
    same moment, loads it and holds one launch against the plain version;
    then both models' ``_multi_card_eval``, written to ``rank<r>.pt``."""
    import gc
    import os

    import torch
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(cards[rank])   # the card resolve_device gives the rank
    torch.cuda.set_device(cards[rank])
    from irw_tpu_torch.parallel import close_group, init_group

    init_group(backend=backend, init_method=f"file://{workdir}/pg_{backend}_{world}",
               world_size=world, rank=rank)
    out = {"card": torch.cuda.current_device()}
    try:
        if fresh_build:
            dist.barrier()
            out["fresh_build"] = _fresh_k1_build(fresh_build)
        for name in MULTI_CARD_N:
            out[name] = _multi_card_eval(name, BATCH * world, workdir)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        close_group()
    torch.save(out, f"{workdir}/{backend}_{world}_rank{rank}.pt")


def _gemm_widths(n: int, dim: int, chunk: int = 512) -> dict:
    """Whether cuBLAS's f32 GEMM gives the same bits for a score block of a
    gallery half as for the whole width, for a full query chunk and the tail
    chunk of ``n`` queries: {rows: max |difference|}.  Where it does not, a
    rank ranking a gallery block would reorder near-tied cosine scores, which
    is why ``parallel.eval_sharding`` splits the query chunks over the ranks
    and not the gallery."""
    import torch

    from irw_tpu_torch.ops.distances import pairwise_distance

    gen = torch.Generator(device="cuda").manual_seed(1)
    gallery = torch.randn(n, dim, generator=gen, device="cuda")
    half = -(-n // 2)
    out = {}
    for rows in (chunk, n % chunk or chunk):
        q = gallery[:rows]
        whole = pairwise_distance(q, gallery, "cosine")
        blocks = torch.cat([pairwise_distance(q, gallery[:half], "cosine"),
                            pairwise_distance(q, gallery[half:], "cosine")], dim=1)
        out[rows] = (whole - blocks).abs().max().item()
    return out


def phase_multi_card(state):
    """The serving side of ROADMAP A13: the flagship's and the WCNN's eval
    (embedding sweep and the metric suite, its query chunks split over the
    ranks) by one process, then over a group of one rank a card on NCCL and
    over two ranks (two cards on NCCL, or both on card 0 on gloo), each held
    to the one process.  A route whose ranks have not all ended within
    ``MULTI_CARD_ROUTE_S`` is killed and fails the phase."""
    import os
    import tempfile

    import torch
    import torch.multiprocessing as mp

    _release_earlier_phases(state)
    n_cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="irw_multi_card_") as workdir:
        t0 = time.perf_counter()
        _multi_card_sets(workdir)
        log("multi_card", f"sets of {MULTI_CARD_N} uint8 {MULTI_CARD_IMAGE}² images written "
                          f"in {time.perf_counter() - t0:.1f} s")
        single = {}
        for name in MULTI_CARD_N:
            single[name] = _multi_card_eval(name, BATCH, workdir)
            _release_earlier_phases(state)
        widths = _gemm_widths(MULTI_CARD_N["wcnn"], 2048)
        log("multi_card", f"cosine scores of the WCNN's 2048-d embeddings, whole gallery "
                          f"against two halves (query rows: max |diff|): {widths}")
        fresh = os.path.join(workdir, "fresh_build")
        os.makedirs(fresh)
        routes = [("nccl", n_cards, list(range(n_cards)), None),
                  ("nccl", 2, [0, 1], fresh) if n_cards >= 2 else ("gloo", 2, [0, 0], fresh)]
        for backend, world, cards, fresh_build in routes:
            t0 = time.perf_counter()
            context = mp.start_processes(_multi_card_rank,
                                         args=(world, backend, cards, workdir, fresh_build),
                                         nprocs=world, join=False, start_method="spawn")
            _join_by(context, t0 + MULTI_CARD_ROUTE_S, f"{backend} x {world}")
            spawn_s = time.perf_counter() - t0
            ranks = [torch.load(f"{workdir}/{backend}_{world}_rank{r}.pt", weights_only=False)
                     for r in range(world)]
            route = f"{backend} x {world} on cards {cards}"
            if fresh_build:
                builds = [r["fresh_build"] for r in ranks]
                log("multi_card", f"{route}: K1 built by every rank at once into an empty "
                                  f"directory and loaded: {builds}")
                if not all(b["max_abs_err"] <= K1_TOL for b in builds):
                    raise AssertionError(f"{route}: K1 from the concurrent build disagrees")
            _check_multi_card(state, route, world, ranks, single)
            log("multi_card", f"{route}: ranks ran in {spawn_s:.1f} s (spawn, set-up, both "
                              f"models) | {state['card']}")


def _check_multi_card(state, route: str, world: int, ranks: list, single: dict) -> None:
    """Every rank's answers against the single process's: the first queries'
    top-k indices equal, every metric within MULTI_CARD_TOL, every rank's
    dict equal, the launches a batch a rank; logs the times."""
    for name, ref in single.items():
        n_batches = -(-MULTI_CARD_N[name] // (BATCH * world))
        expected = [n * n_batches for n in MULTI_CARD_PER_BATCH[name]]
        first = ranks[0][name]
        for r, out in enumerate(ranks):
            if out[name]["metrics"] != first["metrics"]:
                raise AssertionError(f"{route} {name}: rank {r}'s metrics differ from rank 0's")
            if out[name]["launches"] != expected:
                raise AssertionError(f"{route} {name}: rank {r} launched {out[name]['launches']}"
                                     f" ({', '.join(KERNEL_IDS)}), expected {expected}")
            if not np.array_equal(out[name]["first"], ref["first"]):
                raise AssertionError(f"{route} {name}: rank {r}'s top-{ref['k']} indices of the "
                                     f"first {MULTI_CARD_FIRST} queries differ")
        worst = max(abs(first["metrics"][key] - ref["metrics"][key]) for key in ref["metrics"])
        if set(first["metrics"]) != set(ref["metrics"]) or not worst <= MULTI_CARD_TOL:
            raise AssertionError(f"{route} {name}: metrics {first['metrics']} against the single "
                                 f"process's {ref['metrics']} (max diff {worst})")
        if not all(math.isfinite(v) for v in first["metrics"].values()):
            raise AssertionError(f"{route} {name}: non-finite metrics {first['metrics']}")
        n = MULTI_CARD_N[name]
        peaks = ", ".join(f"{out[name]['peak'] / 2 ** 30:.2f}" for out in ranks)
        log("multi_card", f"{route} {name}: eval {first['eval_s']:.2f} s (scoring "
                          f"{first['eval_s'] - first['embed_s']:.2f} s), embedded "
                          f"{n / first['embed_s']:.1f} img/s (one process: {ref['eval_s']:.2f} s, "
                          f"scoring {ref['eval_s'] - ref['embed_s']:.2f} s, "
                          f"{n / ref['embed_s']:.1f} img/s); map {first['metrics']['map_level0']:.6f}"
                          f", max |metric - one process| {worst:.2e}; launches a rank {expected} "
                          f"over {n_batches} batches of {BATCH * world}; peak GiB a rank [{peaks}]"
                          f" (one process {ref['peak'] / 2 ** 30:.2f}) | {state['card']}")
        key = f"multi_card_{name}"
        state["launches"][key] = dict(zip(first["names"], first["launches"]))
        state.setdefault("multi_card_units", {})[key] = n_batches


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
               "train": phase_train, "loop": phase_loop, "runner": phase_runner,
               "dwt": phase_dwt, "wcnn": phase_wcnn, "wavelets": phase_wavelets,
               "wcnn_train": phase_wcnn_train,
               "wcnn_xbm": phase_wcnn_xbm, "losses": phase_losses,
               "flash": phase_flash,
               "flash_serve": phase_flash_serve, "flash_train": phase_flash_train,
               "qkv": phase_qkv, "qkv_micro": phase_qkv_micro, "variants": phase_variants,
               "siblings": phase_siblings, "trunks": phase_trunks, "files": phase_files,
               "wavenets": phase_wavenets, "landmarks": phase_landmarks,
               "hf_towers": phase_hf_towers, "microbatch": phase_microbatch,
               "engine_extras": phase_engine_extras, "run_tools": phase_run_tools,
               "serving": phase_serving, "trunks_half": phase_trunks_half,
               "multi_card": phase_multi_card}
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
               "loop": ("loop", LOOP_EPOCHS * LOOP_STEPS),
               "runner": ("runner", RUNNER_EPOCHS * RUNNER_STEPS),
               "wcnn": ("wcnn_train", WCNN_TRAIN_STEPS), "wcnn_xbm": ("wcnn_xbm", XBM_STEPS),
               "shared": ("siblings_train", TRAIN_STEPS),
               **{f"microbatch_{sb}": (f"microbatch_{sb}", n) for sb, n in MICRO_STEPS.items()},
               "adaptive": ("engine_extras_adaptive", ADAPTIVE_STEPS),
               **{config: (f"wavenets_{config}_train", WAVENET_STEPS) for config in WAVENET_MAIN},
               "wcnn_bf16": ("trunks_half", HALF_STEPS),
               "wresnet_sdd_ce_bf16": ("trunks_half_sdd", HALF_STEPS),
               **{f"hf_{config}": (f"hf_towers_{config}_train", TRUNK_STEPS)
                  for config in HF_TRAIN}}
    served = {"flagship": ("serve", SERVE_BATCHES), "wcnn": ("wcnn", WCNN_BATCHES),
              "flash": ("flash_serve", SERVE_BATCHES),
              "loop_eval": ("loop_eval", LOOP_EVAL_BATCHES),
              "runner_eval": ("runner_eval", RUNNER_EVAL_UNITS),
              "wavelets_A": ("wavelets_A", SERVE_BATCHES),
              "wavelets_B": ("wavelets_B", SERVE_BATCHES),
              "shared": ("siblings_serve", SERVE_BATCHES),
              **{config: (f"trunks_{config}", TRUNK_TIMED) for config in TRUNK_SWT},
              **{config: (f"wavenets_{config}_serve", SERVE_BATCHES) for config in WAVENET_MAIN},
              "wcnn_bf16": ("trunks_half_serve", SERVE_BATCHES),
              **{f"hf_{config}": (f"hf_towers_{config}", TRUNK_TIMED) for config in HF_SERVE},
              **{f"hf_{name}": (f"hf_towers_{name}", 1) for name in HF_REGISTRY},
              "run_tools_eval": ("run_tools_eval", 2),
              "run_tools_attention": ("run_tools_attention", -(-RUN_TOOLS_TRAIN // RUN_TOOLS_BS)),
              "run_tools_panels": ("run_tools_panels", 2),
              "run_tools_alphas": ("run_tools_alphas", 2),
              "run_tools_graft": ("run_tools_graft", 1),
              "serving_float": ("serving_float", SERVE_BATCHES),
              "serving_int8": ("serving_int8", SERVE_BATCHES),
              "serving_export": ("serving_export", 1)}
    if "default_units" in state:  # the default composition's run (trunks)
        trained["default"] = ("trunks_default", state["default_units"][0])
        served["default_eval"] = ("trunks_default_eval", state["default_units"][1])
    for key in ("files_voc", "files_cub", "landmarks_sfm"):  # the runs from files
        if f"{key}_units" in state:
            n_steps, n_evals = state[f"{key}_units"]
            trained[key] = (key, n_steps)
            served[f"{key}_eval"] = (f"{key}_eval", n_evals)
    for key, n_batches in state.get("multi_card_units", {}).items():  # a rank's eval batches
        served[key] = (key, n_batches)
    if "landmarks_units" in state:  # the revisited protocol's eval batches
        served["landmarks"] = ("landmarks_eval", state["landmarks_units"])

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
