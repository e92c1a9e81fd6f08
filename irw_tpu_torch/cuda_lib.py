"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/irw_tpu_torch/`` at the
root of the checkout, under a file name keyed on the hash of the sources and
flags, and loaded with ``ctypes`` (no PyTorch headers: a build takes seconds,
not minutes).  Pointers and the stream cross as ``c_void_p``; each C entry
returns ``cudaGetLastError()`` and ``check`` raises when it is not 0.

``build(names)`` starts one ``nvcc`` per source, all at once, and waits for
them: ``chip_smoke.py`` uses it so the build phase costs the slowest kernel,
not their sum.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "irw_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("haar_swt2", "attention_fwd", "attention_bwd", "lifting_dwt", "flash_attention_fwd",
           "flash_attention_bwd", "qkv_attention")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # finds the toolkit; builds nothing

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of irw_tpu_torch "
                           "are built from source at first use")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, dict]:
    """Compile every kernel of ``names`` that is not built yet, in parallel.

    Returns ``{name: {"seconds": s, "ptxas": log}}`` for the kernels it
    compiled (``{}`` when all were built already).  Raises with the compiler's
    output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a library
        report[name] = {"seconds": seconds, "ptxas": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed.

    ``signatures`` maps each C entry to ``(argtypes, restype)``; they are set
    once, when the library is loaded (ctypes would otherwise pass a pointer as
    a 32-bit int and cut it)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            sigs = {**signatures,
                    "irw_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p)}
            for fn, (argtypes, restype) in sigs.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib


def check(status: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise if a C entry reported a CUDA error (launch refused, bad config)."""
    if status != 0:
        msg = lib.irw_cuda_error_string(status).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {status} at launch ({msg})")


def stream_of(tensor) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)
