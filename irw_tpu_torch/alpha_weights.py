"""The subband gate's alphas over a dataset (port of
``alpha_weights.py:27-64``).

Models with a subband gate return its values as ``aux["gate"]``
(``WCNNAttention``, ``WaveResNet`` with attention, ``mtwavenet50_fusion``,
the cbam/eca fusion heads); ``generate_alphas`` averages them over a run's
eval split in numpy, in the JAX CLI's order (each batch's sum over samples,
then one division by the count).

    python -m irw_tpu_torch.alpha_weights --run experiments/myrun [--set test]
        [--bs 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from irw_tpu_torch.run_dir import load_run, mean_aux

LOGGER = logging.getLogger(__name__)


def generate_alphas(run_dir: str, eval_set: str = "test", batch_size: int = 64,
                    device=None) -> np.ndarray:
    """The gate's values averaged over the ``eval_set`` split (its gallery,
    for a query/gallery split)."""
    mean, count = mean_aux(load_run(run_dir, device), "gate", eval_set, batch_size,
                    "model exposes no gate alphas (aux['gate'] missing)")
    LOGGER.info(f"mean gate alphas over {count} samples: {np.round(mean, 4).tolist()}")
    return mean


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser()
    parser.add_argument("--run", required=True)
    parser.add_argument("--set", default="test")
    parser.add_argument("--bs", type=int, default=64)
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args()
    generate_alphas(args.run, args.set, args.bs, args.device)
