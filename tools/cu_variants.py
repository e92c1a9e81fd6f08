"""Build and time variants of one of the port's CUDA sources on one card.

The helpers of ``tools/k4_variants.py`` and ``tools/k5_variants.py``.  A
variant is named by a spec, ``KEY=value`` items joined with commas: a key of
``constants`` sets that ``constexpr int`` of the source, ``PATCH=name``
makes the named edits of ``patches`` (each a list of (text, replacement)
pairs, every text found once).  The empty spec is the committed source,
tagged ``committed``.  Needs nvcc and, for ``time_in_turns``, the card.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import statistics
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def tag_of(spec: str) -> str:
    return spec or "committed"


def variant_source(cu_name: str, spec: str, constants: dict, patches: dict,
                   out_dir: Path) -> Path:
    """A copy of csrc/ with the edits of ``spec`` made to ``cu_name``;
    returns the copied source.  Raises if an edit does not apply once."""
    from irw_tpu_torch import cuda_lib

    out_dir.mkdir(parents=True, exist_ok=True)
    for src in cuda_lib.CSRC.glob("*.cu*"):
        shutil.copy(src, out_dir / src.name)
    path = out_dir / cu_name
    text = path.read_text()
    for item in filter(None, spec.split(",")):
        key, value = item.split("=")
        if key == "PATCH":
            for old, new in patches[value]:
                if text.count(old) != 1:
                    raise ValueError(f"patch {value} does not apply to {cu_name}: {old[:60]!r}")
                text = text.replace(old, new)
            continue
        name = constants[key]
        text, count = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                              text)
        if count != 1:
            raise ValueError(f"{name} not found once in {cu_name}")
    path.write_text(text)
    return path


def _entry_label(line: str) -> str:
    """``name<args>`` of the kernel in ptxas's "Compiling entry function" line."""
    m = re.search(r"\d+([A-Za-z]\w*?_kernel)(I(?:Li\d+E)+E)?", line)
    if not m:
        return line.strip()
    return m.group(1) + (f"<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>" if m.group(2)
                         else "")


def build(cu_name: str, specs: list[str], constants: dict, patches: dict,
          entries: str) -> dict[str, tuple[Path, str]]:
    """Every variant of ``specs`` built into ``build/<stem>_variants/``, one
    nvcc each, all started together once every edit has applied; returns
    ``{tag: (library, usage)}``, usage being ptxas's registers and spills
    of the kernels whose name holds ``entries``."""
    from irw_tpu_torch import cuda_lib

    base = ROOT / "build" / f"{Path(cu_name).stem}_variants"
    sources = {tag_of(spec): variant_source(cu_name, spec, constants, patches,
                                            base / re.sub(r"[^A-Za-z0-9]+", "_", tag_of(spec)))
               for spec in specs}
    procs = {}
    for tag, src in sources.items():
        lib = src.with_suffix(".so")
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    built = {}
    for tag, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {tag} does not build:\n{log}")
        usage, entry = [], ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = _entry_label(ln)
            elif entries in entry and ("Used" in ln or "spill" in ln):
                usage.append(f"{entry}: {ln.split(':', 1)[-1].strip()}")
        built[tag] = (lib, " | ".join(usage))
    return built


def load(path: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    lib.irw_cuda_error_string.argtypes = [ctypes.c_int]
    lib.irw_cuda_error_string.restype = ctypes.c_char_p
    return lib


def time_in_turns(tags, cases, make_call, rounds: int = 3, iters: int = 20,
                  warmup: int = 3) -> dict:
    """``{tag: {case: ms}}``: the median over ``rounds`` of the mean of
    ``iters`` calls between two CUDA events, after ``warmup`` calls, the
    variants taking turns at each case."""
    import torch

    times = {tag: {case: [] for case in cases} for tag in tags}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(rounds):
        for case in cases:
            for tag in tags:
                call = make_call(tag, case)
                for _ in range(warmup):
                    call()
                start.record()
                for _ in range(iters):
                    call()
                end.record()
                torch.cuda.synchronize()
                times[tag][case].append(start.elapsed_time(end) / iters)
    return {tag: {case: statistics.median(v) for case, v in by.items()}
            for tag, by in times.items()}


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
