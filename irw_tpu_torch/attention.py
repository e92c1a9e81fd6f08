"""The fusion head's attention weights over a dataset (port of
``attention.py:28-68``).

The fusion heads return their query-over-band attention as
``aux["attn_weights"]`` (B, num_queries, S) (``models/fusion.py``);
``mean_attention`` averages it over a run's eval split in numpy, in the JAX
CLI's order (each batch's sum over samples, then one division by the
count), and logs the mean per subband.

    python -m irw_tpu_torch.attention --run experiments/myrun [--set test]
        [--bs 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from irw_tpu_torch.run_dir import load_run, mean_aux

LOGGER = logging.getLogger(__name__)
BAND_NAMES = ["LL", "LH", "HL", "HH"]


def mean_attention(run_dir: str, eval_set: str = "test", batch_size: int = 64,
                   device=None) -> np.ndarray:
    """The (num_queries, S) attention weights of the run's fusion head,
    averaged over the ``eval_set`` split (its gallery, for a query/gallery
    split)."""
    mean, count = mean_aux(load_run(run_dir, device), "attn_weights", eval_set, batch_size,
                    "model exposes no attention weights (aux['attn_weights'])")
    per_band = mean.mean(0)
    LOGGER.info("mean attention per subband:")
    for name, value in zip(BAND_NAMES, per_band):
        LOGGER.info(f"  {name}: {value:.4f}")
    return mean


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser()
    parser.add_argument("--run", required=True)
    parser.add_argument("--set", default="test")
    parser.add_argument("--bs", type=int, default=64)
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args()
    mean_attention(args.run, args.set, args.bs, args.device)
