#!/usr/bin/env python3
"""Where the epoch loop's time goes on one CUDA card.

    python3 tools/loop_host_time.py [ROUNDS]

The full-width flagship of ``chip_smoke.py``'s loop phase (K2/K3 route,
block remat, HashLoss, AdamW, ``memory=voc``'s XBM) trains on the loop
phase's 480 synthetic VOC images at batch 96 through ``engine.train``,
EPOCHS epochs of STEPS steps a run, no eval, in turns with parts of the
loop switched off, beside the plain step loop:

- ``loop``: as the loop phase (8 loader threads, an async save after every
  epoch, whose write runs while the next epoch trains);
- ``no_save``: saves only after the last epoch (``checkpoint_freq`` past
  ``max_iter``), so no write overlaps training;
- ``no_xbm``: the step without the memory (no index copy, no insert);
- ``serial_loader``: ``num_workers`` 0 (each batch gathered when asked for);
- ``steps``: ``build_train_step`` over the same batches with the metrics
  summed on the device and fetched once an epoch, as ``phase_train`` times
  it (no sampler, loader, epoch hooks or memory).

ROUNDS rounds (default 2), the order reversed every other round, all from
one state (the model trains on).  Per configuration: the median over its
epochs, each run's first epoch left out, of the epoch's seconds (start to
the fetch of its metrics, which waits for the card) as trained img/s, and
of the host's seconds issuing steps and waiting for the loader.  Then one
``loop`` epoch under torch.profiler (``profile_epoch``): the device busy
time, its idle share over the epoch, and the largest gaps between kernels.
Ends with the card's name and power limit.  Needs the card; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402

EPOCHS, STEPS = 4, 4
CONFIGS = ("loop", "no_save", "no_xbm", "serial_loader", "steps")


def _epochs(log_dir: str) -> list:
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "train/total_loss" in r]


def _experience(name: str, **extra) -> dict:
    exp = dict(cs.LOOP["experience"], max_iter=EPOCHS, step_per_epoch=STEPS,
               test_eval_freq=-1)
    exp.update(extra)
    if name == "no_save":
        exp["checkpoint_freq"] = EPOCHS + 1
    if name == "serial_loader":
        exp["num_workers"] = 0
    return {"experience": exp}


def _run_train(name, tstate, memory, ds, transform) -> list:
    """One ``engine.train`` run of ``name``: per epoch (seconds, host
    seconds issuing steps, seconds in the loader)."""
    from irw_tpu_torch.engine import train
    from irw_tpu_torch.samplers import RandomSampler

    tstate.epoch = 0
    tstate.xbm, tstate.xbm_state = (None, None) if name == "no_xbm" else memory
    log_dir = tempfile.mkdtemp(prefix="irw_loop_time_")
    try:
        train(tstate, ds, RandomSampler(ds, cs.TRAIN_BATCH, seed=0), {}, None, transform,
              _experience(name), log_dir)
        return [(r["train/train_seconds"], r["train/step_seconds"], r["train/data_seconds"])
                for r in _epochs(log_dir)]
    finally:
        tstate.xbm, tstate.xbm_state = memory
        shutil.rmtree(log_dir, ignore_errors=True)


def _run_steps(tstate, ds, transform) -> list:
    """The plain step loop over the ``loop`` configuration's batches."""
    import torch

    from irw_tpu_torch.engine import build_train_step
    from irw_tpu_torch.engine.train import _build_hyper
    from irw_tpu_torch.samplers import RandomSampler

    step = build_train_step(transform, clip_grad=cs.PROTOCOL["clip_grad"],
                            proxy_map_metric="hamming")
    sampler = RandomSampler(ds, cs.TRAIN_BATCH, seed=0)
    out = []
    for epoch in range(1, EPOCHS + 1):
        batches = [{"image": ds.images[b], "label": ds.labels[b]}
                   for b in sampler.reshuffle(epoch).batches[:STEPS]]
        t0 = time.perf_counter()
        sums, issue = None, 0.0
        for batch in batches:
            hyper = _build_hyper(tstate.optimizer_entries, epoch, tstate.step,
                                 cs.PROTOCOL["warm_up"], None, cs.PROTOCOL["ortho_scale"])
            t_step = time.perf_counter()
            metrics = step(tstate, batch, hyper)
            issue += time.perf_counter() - t_step
            sums = metrics if sums is None else {k: sums[k] + v for k, v in metrics.items()}
        torch.stack([v.float() for v in sums.values()]).tolist()
        out.append((time.perf_counter() - t0, issue, 0.0))
    return out


def _profiled_epoch(tstate, memory, ds, transform, card: str) -> None:
    """One ``loop`` epoch under torch.profiler (the loop's own
    ``profile_epoch``): device busy, idle share, largest gaps."""
    from irw_tpu_torch.engine import train
    from irw_tpu_torch.samplers import RandomSampler

    tstate.epoch = 1
    log_dir = tempfile.mkdtemp(prefix="irw_loop_prof_")
    try:
        exp = _experience("loop", max_iter=2, profile_epoch=2)
        train(tstate, ds, RandomSampler(ds, cs.TRAIN_BATCH, seed=0), {}, None, transform, exp,
              log_dir)
        seconds = _epochs(log_dir)[-1]["train/train_seconds"]
        with open(os.path.join(log_dir, "profile", "epoch_2.json")) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    device = ("kernel", "gpu_memcpy", "gpu_memset")
    kernels = sorted((e for e in events if e.get("cat") in device), key=lambda e: e["ts"])
    if not kernels:
        print("[profile] the profiler recorded no device kernel: device time not measured")
        return
    busy = sum(e["dur"] for e in kernels) / 1e6
    span = (kernels[-1]["ts"] + kernels[-1]["dur"] - kernels[0]["ts"]) / 1e6
    gaps = sorted(((b["ts"] - a["ts"] - a["dur"], b["name"])
                   for a, b in zip(kernels, kernels[1:])), reverse=True)
    print(f"[profile] one loop epoch of {STEPS} steps under the profiler: {seconds:.3f} s, "
          f"device busy {busy:.3f} s, idle share {1 - busy / seconds:.3f} over the epoch, "
          f"{1 - busy / span:.3f} between its first and last kernel | {card}")
    print("[profile] largest gaps: " + "; ".join(f"{g / 1e3:.2f} ms before {n[:60]}"
                                                 for g, n in gaps[:6]))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rounds = int(argv[0]) if argv else 2
    import torch

    if not torch.cuda.is_available():
        print("loop_host_time: no CUDA device", file=sys.stderr)
        return 2
    from irw_tpu_torch.data import SyntheticVOCDataset
    from irw_tpu_torch.engine import get_memory, init_train_state
    from irw_tpu_torch.losses import build_losses
    from irw_tpu_torch.transforms import DeviceTransform

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    ds = SyntheticVOCDataset(num_train=cs.LOOP_TRAIN, image_size=224)
    model = cs._flagship_model()
    tstate = init_train_state(model, build_losses(cs.HASH_LOSS), cs.OPTIMIZER, cs.HASH_LOSS,
                              seed=0, xbm=get_memory(cs.MEMORY, 64, ds.labels.shape[1:]))
    memory = (tstate.xbm, tstate.xbm_state)
    transform = DeviceTransform(cs.SWT_OPS)
    _run_steps(tstate, ds, transform)  # warm-up: allocator, cuBLAS
    results = {name: [] for name in CONFIGS}
    for r in range(rounds):
        for name in (CONFIGS if r % 2 == 0 else CONFIGS[::-1]):
            epochs = (_run_steps(tstate, ds, transform) if name == "steps"
                      else _run_train(name, tstate, memory, ds, transform))
            results[name] += epochs[1:]
    for name, epochs in results.items():
        seconds, issue, data = (statistics.median(x) for x in zip(*epochs))
        print(f"[{name}] {STEPS * cs.TRAIN_BATCH / seconds:.1f} trained img/s, {seconds:.4f} s "
              f"an epoch of {STEPS} steps (median of {len(epochs)}); host "
              f"{issue / STEPS * 1e3:.1f} ms issuing a step, {data * 1e3:.2f} ms an epoch in "
              "the loader; epochs "
              + ", ".join(f"{s:.4f}" for s, _, _ in epochs) + f" s | {card}")
    _profiled_epoch(tstate, memory, ds, transform, card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
