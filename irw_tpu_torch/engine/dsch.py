"""The DSCH training protocol (port of ``irw_tpu/engine/dsch.py``), which
``run`` takes with ``experience.dsch_train``.

It differs from ``engine.train`` in four ways:

1. the tanh continuation α_e = (1 + γ·⌊e/step⌋)^p is set on
   ``state.model_alpha`` each epoch (``dsch_alpha``);
2. the eval is a Hamming eval at ``top_k`` of every split, and the score
   is ``test``'s ``map_level0``;
3. an ``EarlyStopping`` on that score with ``patience`` (a bad epoch is one
   that does not beat the best; the stop fires at ``patience`` of them);
4. at the end the best epoch's state is put back
   (``checkpoint.train_state_payload`` / ``restore_train_state``), and the
   metrics returned are that epoch's.

The settings come from ``experience.dsch`` (``topk``, ``patience``,
``alpha_gamma`` 0.005, ``alpha_power`` 0.5), not from the top-level
``experience.alpha_gamma`` that ``engine.train``'s continuation reads.  A
checkpoint is saved at each eval and ``finalize_checkpoints`` runs at the
end.  The step, the loader and the logger are ``engine.train``'s.
"""

from __future__ import annotations

import logging
import time

import torch

from irw_tpu_torch.data.loader import EpochLoader
from irw_tpu_torch.engine.checkpoint import (
    finalize_checkpoints,
    restore_train_state,
    save_checkpoint,
    train_state_payload,
)
from irw_tpu_torch.engine.evaluate import evaluate
from irw_tpu_torch.engine.train import MetricsLogger, _build_hyper
from irw_tpu_torch.engine.train_step import build_train_step
from irw_tpu_torch.utils.meters import DictAverage

LOGGER = logging.getLogger(__name__)


class EarlyStopping:
    """Patience-based stopping on a maximised metric."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = -float("inf")
        self.bad_epochs = 0
        self.should_stop = False

    def update(self, value: float) -> bool:
        if value > self.best + self.min_delta:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                self.should_stop = True
        return self.should_stop


def dsch_alpha(epoch: int, gamma: float = 0.005, power: float = 0.5, step_size: int = 1) -> float:
    """α_e = (1 + γ·⌊e/step⌋)^p: tanh sharpened toward sign over training."""
    return float((1.0 + gamma * (epoch // step_size)) ** power)


def train_dsch(state, train_dataset, sampler, eval_datasets: dict, host_transform,
               device_transform, config: dict, log_dir: str):
    """DSCH-protocol training from ``state.epoch + 1``; the arguments are
    ``engine.train``'s.  Returns (state at its best epoch, that epoch's
    metrics by split)."""
    exp = dict(config.get("experience", config))
    dsch_cfg = dict(exp.get("dsch") or {})
    max_iter = exp.get("max_iter", 50)
    step_per_epoch = exp.get("step_per_epoch", None)
    eval_freq = exp.get("train_eval_freq", 1)
    top_k = dsch_cfg.get("topk", (exp.get("evaluation") or {}).get("top_k", 5000))
    patience = dsch_cfg.get("patience", 10)
    alpha_gamma = dsch_cfg.get("alpha_gamma", 0.005)
    alpha_power = dsch_cfg.get("alpha_power", 0.5)
    num_workers = exp.get("num_workers", 8)
    eval_bs = exp.get("eval_bs", 256)

    model = state.model
    device = next(model.parameters()).device
    logger = MetricsLogger(log_dir)
    stopper = EarlyStopping(patience=patience)
    step = build_train_step(device_transform, clip_grad=exp.get("clip_grad"),
                            proxy_map_metric="hamming")
    best_payload, best_score = None, -float("inf")
    metrics_by_split: dict = {}
    best_metrics: dict = {}
    try:
        for epoch in range(int(state.epoch) + 1, max_iter + 1):
            t0 = time.perf_counter()
            alpha = dsch_alpha(epoch, alpha_gamma, alpha_power)
            state.epoch, state.model_alpha = epoch, alpha
            sampler.reshuffle(epoch)
            batches = sampler.batches[:step_per_epoch] if step_per_epoch else sampler.batches
            loader = EpochLoader(train_dataset, batches, host_transform,
                                 num_workers=num_workers, train=True, seed=epoch)
            meters = DictAverage()
            sums, n_steps = None, 0
            for batch in loader:
                hyper = _build_hyper(state.optimizer_entries, epoch, state.step, 0, None,
                                     ortho_scale=exp.get("ortho_scale"))
                metrics = step(state, batch, hyper)
                sums = metrics if sums is None else {k: sums[k] + v for k, v in metrics.items()}
                n_steps += 1
            if sums is not None:
                keys = list(sums)
                fetched = torch.stack([sums[k].float() for k in keys]).tolist()
                meters.update({k: v / n_steps for k, v in zip(keys, fetched)})
            train_metrics = dict(meters.avg, model_alpha=alpha)
            logger.log(epoch, train_metrics, prefix="train/")
            LOGGER.info(f"[dsch] epoch {epoch}/{max_iter} α={alpha:.3f} "
                        f"loss={train_metrics.get('total_loss', float('nan')):.4f} "
                        f"[{time.perf_counter() - t0:.1f}s]")

            if epoch % eval_freq == 0 or epoch == max_iter:
                model.eval()
                try:
                    for split, datasets in eval_datasets.items():
                        results = evaluate(model, datasets, device_transform,
                                           batch_size=eval_bs, top_k=top_k,
                                           distance_metric="hamming", device=device,
                                           host_transform=host_transform,
                                           num_workers=num_workers)
                        metrics_by_split[split] = results
                        logger.log(epoch, results, prefix=f"{split}/")
                finally:
                    model.train()
                score = metrics_by_split.get("test", {}).get("map_level0", 0.0)
                LOGGER.info(f"[dsch] val mAP@{top_k} = {score:.4f} "
                            f"(best {max(best_score, score):.4f})")
                if score > best_score:
                    best_score = score
                    best_payload = train_state_payload(state)
                    best_metrics = {k: dict(v) for k, v in metrics_by_split.items()}
                save_checkpoint(log_dir, state, dict(config), epoch, score=score,
                                best_score=best_score,
                                async_save=bool(exp.get("async_checkpoint", True)))
                if stopper.update(score):
                    LOGGER.info(f"[dsch] early stop at epoch {epoch} (patience {patience})")
                    break
        finalize_checkpoints(log_dir)
    finally:
        logger.close()
    if best_payload is not None:
        # the returned metrics describe the restored best model
        restore_train_state(state, best_payload)
        metrics_by_split = best_metrics
    return state, metrics_by_split
