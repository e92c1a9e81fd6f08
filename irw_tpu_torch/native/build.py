"""Build the host image loader (``src/irw_loader.cpp``) with the system
``g++`` into ``build/irw_tpu_torch/`` at the root of the checkout.

The file name is keyed on the hash of the source, the flags and the target
options ``-march=native`` resolves to on this machine (``g++ -Q
--help=target``), so a checkout carried to another CPU builds its own.  The
compiler writes a per-process temporary file that ``os.replace`` swaps in:
two processes that build at once never load half a library.  Nothing here
runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from functools import lru_cache
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src" / "irw_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "irw_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-fno-math-errno", "-fPIC", "-shared", "-pthread",
             "-std=c++17")
LINK = ("-ljpeg", "-lpng")

# the last build of this process: {"path", "seconds", "log"} on success,
# {"error": compiler output} when it failed
LAST_BUILD: dict = {}


@lru_cache(maxsize=1)
def _native_target() -> bytes:
    """The target options ``-march=native`` selects here (empty without g++)."""
    try:
        return subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                              capture_output=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return b""


def lib_path(build_dir=None) -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK).encode())
    h.update(_native_target())
    return Path(build_dir or BUILD_DIR) / f"libirwloader-{h.hexdigest()[:16]}.so"


def build(build_dir=None) -> str | None:
    """The library's path, compiled first if it is not built yet; None when
    the compiler or the libjpeg/libpng headers are missing (the reason is
    in ``LAST_BUILD["error"]``)."""
    out = lib_path(build_dir)
    if out.exists():
        return str(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), *LINK, "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        LAST_BUILD.clear()
        LAST_BUILD["error"] = f"{' '.join(cmd)}: {exc}"
        tmp.unlink(missing_ok=True)
        return None
    LAST_BUILD.clear()
    if proc.returncode != 0:
        LAST_BUILD["error"] = f"{' '.join(cmd)} (exit {proc.returncode})\n{proc.stderr}"
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic: a reader never sees half a library
    LAST_BUILD.update(path=str(out), seconds=time.perf_counter() - t0, log=proc.stderr)
    return str(out)


if __name__ == "__main__":
    print(build() or f"BUILD FAILED\n{LAST_BUILD.get('error')}")
