"""Wall clock of the revisited-Oxford landmark evaluation at roxford5k's
scale: 70 queries × 4993 gallery × 2048-d descriptors, 120 easy, 130 hard
and 150 junk gallery items a query (port of ``benchmarks/landmark_bench.py``:
the same draws from ``np.random.RandomState(0)``: queries, gallery, then
one permutation of the gallery a query).  Times ``landmark_evaluation``
(medium and hard) as a user calls it, host masks and copies included: one
warm-up call, then the mean of ``iters`` calls on the host clock.

    python -m irw_tpu_torch.benchmarks.landmark_bench [--ng 6322]   # rparis6k

One JSON line out.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from irw_tpu_torch.benchmarks import device_label
from irw_tpu_torch.device import resolve_device
from irw_tpu_torch.engine.landmark import landmark_evaluation


SEED = 0


def make_inputs(nq: int = 70, ng: int = 4993, d: int = 2048):
    """(queries, gallery, gnd) as ``benchmarks/landmark_bench.py`` draws them."""
    rng = np.random.RandomState(SEED)
    q = rng.randn(nq, d).astype(np.float32)
    g = rng.randn(ng, d).astype(np.float32)
    gnd = []
    for _ in range(nq):
        perm = rng.permutation(ng)
        gnd.append({"easy": perm[:120], "hard": perm[120:250], "junk": perm[250:400]})
    return q, g, gnd


def run(nq: int = 70, ng: int = 4993, d: int = 2048, iters: int = 5, device=None) -> dict:
    device = resolve_device(device)
    q, g, gnd = make_inputs(nq, ng, d)
    out = landmark_evaluation(q, g, gnd, device=device)  # warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        out = landmark_evaluation(q, g, gnd, device=device)
    ms = (time.perf_counter() - t0) / iters * 1e3
    return {"shape": [nq, ng, d], "iters": iters, "ms": ms, **out,
            "device": device_label(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ng", type=int, default=4993, help="gallery size (6322: rparis6k)")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' runs on the CPU")
    a = ap.parse_args(argv)
    print(json.dumps(run(ng=a.ng, device=a.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
