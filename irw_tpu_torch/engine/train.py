"""The epoch loop (port of ``irw_tpu/engine/train.py:31-64, 67-92,
95-508``).

Per epoch: the loss schedules' epoch updates and the continuation α, the
sampler's reshuffle, exactly ``step_per_epoch`` train steps over the
loader, the per-split evals on their cadence with best-score tracking and
the plateau schedulers, the epoch's scalars to ``metrics.jsonl`` (and
TensorBoard when it imports), and the rolling checkpoint on its cadence.

The step's metrics stay on the device, summed there, and are fetched once
an epoch: a fetch per step would wait for each step in turn.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from irw_tpu_torch.data.loader import EpochLoader
from irw_tpu_torch.engine.checkpoint import finalize_checkpoints, save_checkpoint
from irw_tpu_torch.engine.evaluate import evaluate
from irw_tpu_torch.engine.train_step import build_train_step
from irw_tpu_torch.utils.meters import DictAverage

LOGGER = logging.getLogger(__name__)


class MetricsLogger:
    """One JSON line of scalars per call to ``log`` in
    ``log_dir/metrics.jsonl``, and TensorBoard scalars when
    ``torch.utils.tensorboard`` imports."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self.tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def log(self, step: int, scalars: dict, prefix: str = ""):
        record = {"step": int(step)}
        for key, value in scalars.items():
            if isinstance(value, (int, float, np.floating, np.integer)) or (
                    getattr(value, "ndim", 1) == 0):
                name = f"{prefix}{key}"
                record[name] = float(value)
                if self.tb is not None:
                    self.tb.add_scalar(name, float(value), step)
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def close(self):
        if self.tb is not None:
            self.tb.close()


def _alpha_schedule(epoch: int, cfg: dict) -> float:
    """The tanh(α·x) continuation: α_e = (1 + gamma·e)^power."""
    return float((1.0 + cfg.get("alpha_gamma", 1.0) * epoch) ** cfg.get("alpha_power", 0.5))


def _apply_loss_epoch_updates(losses, state):
    """Advance every loss's per-epoch schedule in ``state.loss_states``."""
    new_states = dict(state.loss_states)
    for idx, (loss, _) in enumerate(losses):
        key = str(idx)
        if new_states.get(key):
            new_states[key] = loss.epoch_update(new_states[key])
    state.loss_states = new_states
    return state


def _build_hyper(optimizer_entries, epoch, step, warm_up, warm_up_key, ortho_scale=None):
    """Per-entry group learning rates at (epoch, step) and the warm-up gate:
    while ``epoch < warm_up`` only the entry named ``warm_up_key`` steps."""
    lrs, active = {}, {}
    for entry in optimizer_entries:
        lrs[entry.name] = entry.group_lrs(epoch, step)
        active[entry.name] = (epoch >= warm_up) or (warm_up_key is not None
                                                    and entry.name == warm_up_key)
    hyper = {"lrs": lrs, "active": active}
    if ortho_scale is not None:
        hyper["ortho_scale"] = float(ortho_scale)
    return hyper


def _refuse_unported(exp: dict, config: dict, instrumentor) -> None:
    """The loop's options that wait for a later ROADMAP item (the step
    refuses ``sub_batch`` below the batch and adaptive weights itself)."""
    if instrumentor is not None:
        raise NotImplementedError("the fixed-batch instrumentor (hooks) waits for ROADMAP A12")
    if exp.get("with_fast_eval"):
        raise NotImplementedError("with_fast_eval (the fast-eval subset) waits for ROADMAP A12")
    model_cfg = dict(config.get("model") or {})
    for flag in ("freeze_batch_norm", "freeze_pos_embedding"):
        if model_cfg.get(flag):
            raise NotImplementedError(f"model.{flag} waits for ROADMAP A12")
    # use_mesh is ignored on one device, as the JAX loop ignores it with one
    for key in ("model_parallel", "band_parallel", "pipeline_parallel"):
        if int(exp.get(key, 1) or 1) > 1:
            raise NotImplementedError(f"experience.{key} > 1 waits for ROADMAP A13")


def train(state, train_dataset, sampler, eval_datasets: dict, host_transform, device_transform,
          config: dict, log_dir: str, eval_fn=None, instrumentor=None):
    """Run the training from ``state.epoch + 1`` to ``max_iter``.

    The JAX signature, without the arguments the port's ``TrainState``
    carries (the model, losses, optimizer entries, the losses' optimizer
    and the XBM memory).  ``eval_datasets``: split name → dataset or
    ``{"query", "gallery"}`` dict.  ``host_transform`` must be None (the
    host stage waits for ROADMAP A8b).  ``eval_fn(state, datasets)``
    replaces ``engine.evaluate``.  Returns (state, metrics by split)."""
    exp = dict(config.get("experience", config))
    _refuse_unported(exp, config, instrumentor)
    max_iter = exp.get("max_iter", 50)
    step_per_epoch = exp.get("step_per_epoch", None)
    # per-split eval cadence: each split has its own freq; -1 turns that
    # split off, even at max_iter
    default_eval_freq = exp.get("train_eval_freq", exp.get("eval_freq", 5))

    def _should_eval(freq, epoch) -> bool:
        try:
            freq = int(freq)
        except (TypeError, ValueError):
            return False
        return freq > 0 and (epoch % freq == 0 or epoch == max_iter)

    eval_bs = exp.get("eval_bs", 256)
    principal_metric = exp.get("principal_metric", "map_level0")
    eval_split = exp.get("eval_split", "test")
    warm_up = exp.get("warm_up", 0)
    warm_up_key = exp.get("warm_up_key", None)
    num_workers = exp.get("num_workers", 8)
    top_k = (exp.get("evaluation") or {}).get("top_k", exp.get("top_k"))
    distance_metric = (exp.get("evaluation") or {}).get(
        "distance_metric", exp.get("distance_metric", "cosine"))
    save_model_every = exp.get("save_model", None)
    profile_epoch = exp.get("profile_epoch", None)
    adaptive = bool(exp.get("adaptive_weights", False)) or any(
        entry.get("weight") == "adaptative" for entry in (config.get("loss") or []))

    model = state.model
    device = next(model.parameters()).device
    xbm = state.xbm
    xbm_activate_after = xbm.activate_after if xbm is not None else 0
    steps = {}

    def step_fn(xbm_on: bool):
        if xbm_on not in steps:
            steps[xbm_on] = build_train_step(
                device_transform, clip_grad=exp.get("clip_grad", None),
                proxy_map_metric="hamming" if distance_metric == "hamming" else "cosine",
                xbm=xbm, sub_batch=exp.get("sub_batch", None), adaptive_weights=adaptive,
                xbm_active=xbm_on)
        return steps[xbm_on]

    run_eval = eval_fn or (lambda current, datasets: evaluate(
        current.model, datasets, device_transform, batch_size=eval_bs, top_k=top_k,
        distance_metric=distance_metric, device=device))

    logger = MetricsLogger(log_dir)
    best_score = -float("inf")
    metrics_by_split: dict[str, dict] = {}
    try:
        for epoch in range(int(state.epoch) + 1, max_iter + 1):
            t0 = time.perf_counter()
            # the reference's epoch hooks fire at the END of epoch e; applied
            # at the start of every epoch but the first, so epoch E runs with
            # E - 1 updates and α = f(E - 1), and a resumed run (whose saved
            # loss states carry their updates) follows the same sequence
            if epoch > 1:
                _apply_loss_epoch_updates(state.losses, state)
            state.epoch = epoch
            state.model_alpha = _alpha_schedule(epoch - 1, exp)

            sampler.reshuffle(epoch)
            batches = sampler.batches
            if step_per_epoch:
                batches = batches[:step_per_epoch]  # exactly N batches
            loader = EpochLoader(train_dataset, batches, host_transform,
                                 num_workers=num_workers, train=True,
                                 seed=exp.get("seed", 0) + epoch)

            # the memory term is on from activate_after (inclusive); inserts
            # happen in every epoch
            step = step_fn(xbm is not None and epoch >= xbm_activate_after)

            profiler = None
            if profile_epoch is not None and epoch == profile_epoch:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()

            meters = DictAverage()
            data_time = step_time = 0.0
            metric_sums, n_steps = None, 0
            t_mark = time.perf_counter()
            for batch in loader:
                data_time += time.perf_counter() - t_mark
                # state.step is the host's counter: building hyper waits for nothing
                hyper = _build_hyper(state.optimizer_entries, epoch, state.step, warm_up,
                                     warm_up_key, ortho_scale=exp.get("ortho_scale"))
                t_step = time.perf_counter()
                metrics = step(state, batch, hyper)
                metric_sums = (metrics if metric_sums is None else
                               {k: metric_sums[k] + v for k, v in metrics.items()})
                n_steps += 1
                step_time += time.perf_counter() - t_step
                t_mark = time.perf_counter()
            if metric_sums is not None:
                keys = list(metric_sums)
                fetched = torch.stack([metric_sums[k].float() for k in keys]).tolist()
                meters.update({k: v / n_steps for k, v in zip(keys, fetched)})
            train_seconds = time.perf_counter() - t0

            if profiler is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                profiler.stop()
                trace_dir = os.path.join(log_dir, "profile")
                os.makedirs(trace_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(trace_dir, f"epoch_{epoch}.json"))
                LOGGER.info(f"profiler trace written to {trace_dir}")

            epoch_metrics = meters.avg
            lr_now = state.optimizer_entries[0].group_lrs(epoch, state.step)
            epoch_metrics["lr"] = next(iter(lr_now.values()))
            epoch_metrics["data_seconds"] = data_time
            epoch_metrics["step_seconds"] = step_time
            epoch_metrics["train_seconds"] = train_seconds
            logger.log(epoch, epoch_metrics, prefix="train/")
            LOGGER.info(f"epoch {epoch}/{max_iter} "
                        f"loss={epoch_metrics.get('total_loss', float('nan')):.4f} "
                        f"batch_map={epoch_metrics.get('batch_map', 0.0):.4f} "
                        f"[{train_seconds:.1f}s | data {data_time:.1f}s step {step_time:.1f}s]")

            score = None
            evaluated = []
            for split, datasets in eval_datasets.items():
                if not _should_eval(exp.get(f"{split}_eval_freq", default_eval_freq), epoch):
                    continue
                t_eval = time.perf_counter()
                model.eval()
                try:
                    results = run_eval(state, datasets)
                finally:
                    model.train()
                metrics_by_split[split] = results
                evaluated.append(split)
                logger.log(epoch, dict(results, eval_seconds=time.perf_counter() - t_eval),
                           prefix=f"{split}/")
                LOGGER.info(f"  eval[{split}]: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in sorted(results.items())
                    if isinstance(v, float) and "recall" not in k))
            if eval_split in evaluated:
                split_metrics = metrics_by_split.get(eval_split, {})
                score = split_metrics.get(principal_metric)
                for entry in state.optimizer_entries:
                    if entry.plateau is not None:
                        # each plateau scheduler tracks its own configured key
                        tracked = split_metrics.get(entry.plateau.key or principal_metric, score)
                        if tracked is not None:
                            entry.plateau.update(tracked)
                if score is not None and score > best_score:
                    best_score = score

            # checkpoint_freq: the rolling save's cadence; the last epoch
            # always saves, so a finished run's checkpoint says max_iter
            ckpt_freq = max(int(exp.get("checkpoint_freq", 1) or 1), 1)
            if epoch % ckpt_freq == 0 or epoch == max_iter:
                save_checkpoint(log_dir, state, dict(config), epoch, score=score,
                                best_score=best_score if best_score > -float("inf") else None,
                                save_model_every=save_model_every,
                                async_save=bool(exp.get("async_checkpoint", True)))

        # write the final save and promote rolling.next → rolling
        finalize_checkpoints(log_dir)
    finally:
        logger.close()
    return state, metrics_by_split
