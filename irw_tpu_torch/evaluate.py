"""Offline evaluation of a run (port of ``evaluate.py:28-100``).

Rebuilds the model and the eval datasets from a run directory
(``run_dir.load_run``: the config travels inside the rolling checkpoint)
and runs the retrieval metric suite (``engine.evaluate``) with the run's
test transforms.

    python -m irw_tpu_torch.evaluate --run experiments/myrun [--set test]
        [--bs 256] [--k 5000] [--metric hamming] [--append-file results.txt]
        [--parse-file runs.txt] [--device cpu]

The JAX CLI's chip lock and XLA compile cache (``evaluate.py:68-73``) have
no counterpart here.  ``device=None`` means the card.
"""

from __future__ import annotations

import argparse
import json
import logging

from irw_tpu_torch.engine.evaluate import evaluate as engine_evaluate
from irw_tpu_torch.run_dir import load_run

LOGGER = logging.getLogger(__name__)


def load_and_evaluate(run_dir, eval_set: str = "test", batch_size: int = 256,
                      num_workers: int = 8, k=None, distance_metric=None, device=None) -> dict:
    """The metrics of the run under ``run_dir`` on its ``eval_set`` split
    (the first split if it has none of that name); ``k`` and
    ``distance_metric`` default to the run's ``experience.evaluation``."""
    run = load_run(run_dir, device)
    evaluation = run.config.experience.get("evaluation") or {}
    k = k if k is not None else evaluation.get("top_k")
    distance_metric = distance_metric or evaluation.get("distance_metric", "cosine")
    metrics = engine_evaluate(run.model, run.eval_split(eval_set), run.device_test,
                              batch_size=batch_size, top_k=k, distance_metric=distance_metric,
                              device=run.device, host_transform=run.host_test,
                              num_workers=num_workers)
    LOGGER.info(f"eval[{eval_set}] epoch={run.meta['epoch']}: {metrics}")
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--run", required=True, help="run directory (contains weights/)")
    parser.add_argument("--set", default="test")
    parser.add_argument("--bs", type=int, default=256)
    parser.add_argument("--nw", type=int, default=8)
    parser.add_argument("--k", type=int, default=None)
    parser.add_argument("--metric", default=None)
    parser.add_argument("--append-file", default=None,
                        help="append metrics as a JSON line")
    parser.add_argument("--parse-file", default=None,
                        help="file with one run dir per line (batch mode)")
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    runs = [args.run]
    if args.parse_file:
        with open(args.parse_file) as f:
            runs = [line.strip() for line in f if line.strip()]
    for run_dir in runs:
        metrics = load_and_evaluate(run_dir, args.set, args.bs, args.nw, args.k, args.metric,
                                    args.device)
        if args.append_file:
            with open(args.append_file, "a") as f:
                f.write(json.dumps({"run": run_dir, **metrics}) + "\n")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    main()
