#!/usr/bin/env python3
"""Time kernel K4 (``lifting_multi_level``) of one or more checkouts on one CUDA card.

    python3 tools/k4_times.py [ROOT ...]

Each ROOT is a checkout of the repository (this one when none is given);
they run in the order given, each in its own process, so a parent and a
change compare in one call in turns (``PARENT . . PARENT``).  For each case
below the ROOT's K4 is checked against its plain version (the bit-exact
limit, 0) and timed by this checkout's ``chip_smoke.k4_times``, the helper
``phase_dwt`` records with, whatever the ROOT's own ``chip_smoke.py`` holds:
over CUDA events (20 calls after 3 warm-ups on one input, so what the 50 MB
L2 keeps between calls helps), with L2 flushed before each call (a 64 MB
scratch write), as device time (each call between its own events behind
a sleep kernel, ``chip_smoke.device_ms``), and as the host's time to issue
a call.  Bounds from ``chip_smoke.bound_ms``.  The cases past
``chip_smoke.py``'s are deeper levels and small planes: those at which the
tile path pays (``tile_pays`` in csrc/lifting_dwt.cu), and cdf97 and bior48
at 3 levels, where it did not and the two-pass kernels run.  One JSON line
per ROOT, then the card's name and power limit.  Needs the card; imports
nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
CASES = [("haar", 1, (192, 224, 224)), ("haar", 2, (192, 224, 224)), ("haar", 3, (192, 224, 224)),
         ("cdf97", 1, (192, 448, 448)), ("cdf97", 2, (192, 448, 448)),
         ("bior48", 2, (192, 224, 224)), ("daub4", 2, (192, 224, 224)),
         ("haar", 4, (192, 224, 224)), ("haar", 5, (192, 224, 224)),
         ("cdf97", 3, (192, 448, 448)), ("bior48", 3, (192, 224, 224)),
         ("daub4", 3, (192, 224, 224)), ("daub4", 4, (192, 224, 224)),
         ("rev_bior33", 3, (192, 224, 224)), ("cdf53", 4, (192, 448, 448)),
         ("coif12", 2, (192, 224, 224)),
         ("cdf97", 1, (192, 64, 64)), ("cdf97", 2, (192, 64, 64)), ("bior48", 2, (192, 32, 32)),
         ("haar", 4, (192, 32, 32))]


def _smoke():
    spec = importlib.util.spec_from_file_location("k4_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from irw_tpu_torch.ops.wavelets import lifting_dwt

    smoke = _smoke()
    result = {"root": root, "cases": []}
    for basis, levels, shape in CASES:
        n, h, w = shape
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.rand(shape, generator=gen, device="cuda") * 2.0 - 1.0
        out = lifting_dwt.lifting_multi_level(x, levels, basis)
        err = (out - lifting_dwt.lifting_multi_level_plain(x, levels, basis)).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"{root}: K4 {basis} l={levels} {shape} is {err} from plain")
        nbytes = 4 * (n * h * w + n * 4 * (h >> levels) * (w >> levels))
        b_ms, _ = smoke.bound_ms(nbytes, smoke._lifting_flops(n, h, w, levels, basis), "float32")

        def call():
            return lifting_dwt.lifting_multi_level(x, levels, basis)

        result["cases"].append({
            "case": f"{basis} l={levels} {shape}",
            "path": getattr(lifting_dwt.lifting_multi_level, "last_path", None),
            **smoke.k4_times(call), "bound_ms": b_ms})
    return result


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    for root in argv or ["."]:
        proc = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                              text=True, timeout=600)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            print(f"k4_times: {root} failed ({proc.returncode})", file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
