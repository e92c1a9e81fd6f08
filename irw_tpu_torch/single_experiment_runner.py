"""CLI entry point (port of ``single_experiment_runner.py:26-80``)::

    python -m irw_tpu_torch.single_experiment_runner dataset=voc_synthetic \
        model=multidino_attention_hashing_ortho experience.max_iter=2
    python -m irw_tpu_torch.single_experiment_runner -m experience.seed=1,2  # multirun

Composes the repo's ``configs/`` with the overrides and trains on the card.
With ``experience.maybe_resume=true`` a run whose rolling checkpoint is at
``max_iter`` or beyond returns that checkpoint's ``best_score`` without
building anything; an unfinished one resumes from it.
"""

from __future__ import annotations

import logging
import os
import sys

from irw_tpu_torch.config import compose, expand_sweeps
from irw_tpu_torch.engine.checkpoint import load_checkpoint_meta
from irw_tpu_torch.run import log_dir_of, run

LOGGER = logging.getLogger(__name__)
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def run_one(overrides, name_suffix: str = "", device=None) -> float | None:
    """One job: its principal metric on its eval split, or the finished
    run's best score."""
    config = compose(CONFIG_DIR, "default", overrides)
    exp = config.experience
    if name_suffix:
        exp["experiment_name"] = f"{exp.get('experiment_name', 'default')}{name_suffix}"
    if exp.get("maybe_resume"):
        meta = load_checkpoint_meta(log_dir_of(exp))
        if meta is not None:
            if meta.get("epoch", 0) >= exp.get("max_iter", 50):
                LOGGER.info(f"experiment already finished (epoch {meta['epoch']}); skipping")
                return meta.get("best_score")
            config.experience["resume"] = True
    metrics = run(config, device)
    split = exp.get("eval_split", "test")
    return metrics.get(split, {}).get(exp.get("principal_metric", "map_level0"))


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    multirun = False
    for flag in ("-m", "--multirun"):
        if flag in argv:
            argv.remove(flag)
            multirun = True
    jobs = list(expand_sweeps(argv)) if multirun else [argv]
    for i, overrides in enumerate(jobs):
        suffix = ""
        if multirun:
            LOGGER.info(f"--- multirun job {i + 1}/{len(jobs)}: {overrides}")
            suffix = f"_job{i}"
        LOGGER.info(f"job result: {run_one(overrides, name_suffix=suffix, device=device)}")
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    sys.exit(main())
