"""Run ``chip_smoke.py`` phases of several checkouts in turns on one card,
and collect the lines that report img/s.

    python -m irw_tpu_torch.benchmarks.smoke_ab --phases card,build,serve,train \\
        build/parent . . build/parent

Each checkout (a directory holding ``chip_smoke.py``; one may repeat, as in
parent, change, change, parent) runs ``python3 chip_smoke.py --phases ...``
from its own root, one after the other, so every run builds its own
kernels and sees the same card.  A run that fails stops the script.  Prints
each run's img/s lines as they come and then one JSON line, ``{"runs":
[{"checkout": ..., "seconds": ..., "lines": [...]}]}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def run_phases(checkout: str, phases: str, timeout: float) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases", phases],
                          cwd=os.path.abspath(checkout), capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        sys.stdout.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"smoke_ab: {checkout} exited {proc.returncode}")
    lines = [line for line in proc.stdout.splitlines() if "img/s" in line]
    return {"checkout": checkout, "seconds": time.perf_counter() - t0, "lines": lines}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="card,build,serve,train")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a run may take")
    ap.add_argument("checkouts", nargs="+")
    args = ap.parse_args(argv)
    runs = []
    for checkout in args.checkouts:
        runs.append(run_phases(checkout, args.phases, args.timeout))
        print(f"--- {checkout} ({runs[-1]['seconds']:.1f} s)", flush=True)
        for line in runs[-1]["lines"]:
            print(line, flush=True)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
