"""ctypes bindings for the host image loader (port of
``irw_tpu/native/__init__.py``).

File read, JPEG/PNG decode and the geometry and colour plans run in a C++
thread pool (``src/irw_loader.cpp``, built by ``build.py`` at first use);
Python draws the plans (``transforms.host.native_plan``), so the draws are
the host stage's.  Samples the library cannot decode (CMYK JPEGs, other
containers, corrupt files) come back with a non-zero status and are decoded
through the dataset's ``load_image`` instead.  ``IRW_DISABLE_NATIVE`` set
to a non-empty value switches the library off.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading

import numpy as np

# plan opcodes — keep in sync with irw_loader.cpp
OP_END, OP_CROP, OP_RESIZE, OP_FLIP = 0, 1, 2, 3
OP_BRIGHTNESS, OP_CONTRAST, OP_SATURATION, OP_GRAYSCALE, OP_BLUR = 4, 5, 6, 7, 8
FILTER_BILINEAR, FILTER_BICUBIC = 0, 1
_FP16 = 65536  # fixed-point scale for float operands in int32 plans
PLAN_STEP = 6          # ints per step
PLAN_MAX_STEPS = 16    # a host stage plans about 4 steps
PLAN_STRIDE = PLAN_STEP * PLAN_MAX_STEPS

LOGGER = logging.getLogger(__name__)
_lock = threading.Lock()
_lib = None
_lib_tried = False


def get_lib():
    """The loaded library, built first if needed; None when it is switched
    off, or cannot be built or loaded, which is logged once a process as a
    warning with the compiler's or the loader's error."""
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        if os.environ.get("IRW_DISABLE_NATIVE"):
            return None
        from irw_tpu_torch.native.build import LAST_BUILD, build

        path = build()
        if path is None:
            LOGGER.warning("the host image loader did not build; files decode through Pillow:"
                           "\n%s", LAST_BUILD.get("error"))
            return None
        try:
            lib = ctypes.CDLL(path)
            _bind(lib)
            if lib.irw_abi_version() != 1:
                raise OSError(f"ABI version {lib.irw_abi_version()}, not 1")
        except (AttributeError, OSError) as exc:
            LOGGER.warning("the host image loader %s did not load (%s); files decode through "
                           "Pillow", path, exc)
            return None
        _lib = lib
        return _lib


def _bind(lib) -> None:
    lib.irw_image_size.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.irw_image_size.restype = ctypes.c_int
    lib.irw_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.irw_decode.restype = ctypes.c_int
    lib.irw_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.irw_load_batch.restype = None
    lib.irw_resize.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.irw_resize.restype = ctypes.c_int
    lib.irw_abi_version.restype = ctypes.c_int


def available() -> bool:
    return get_lib() is not None


def image_size(path: str):
    """(width, height) from the container header, or None on failure."""
    lib = get_lib()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.irw_image_size(os.fsencode(path), ctypes.byref(w), ctypes.byref(h))
    return (w.value, h.value) if rc == 0 else None


def decode(path: str, size) -> np.ndarray | None:
    """Decode to RGB uint8 (h, w, 3); size = (w, h) from image_size."""
    lib = get_lib()
    if lib is None:
        return None
    w, h = size
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.irw_decode(
        os.fsencode(path),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w,
        h,
    )
    return out if rc == 0 else None


def resize(img: np.ndarray, dw: int, dh: int, filter: int = FILTER_BILINEAR) -> np.ndarray:
    """PIL-convention antialiased resize of an (h, w, 3) uint8 array."""
    lib = get_lib()
    assert lib is not None
    img = np.ascontiguousarray(img, np.uint8)
    sh, sw = img.shape[:2]
    out = np.empty((dh, dw, 3), np.uint8)
    lib.irw_resize(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sw,
        sh,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dw,
        dh,
        filter,
    )
    return out


_FLOAT_OPS = {"brightness": OP_BRIGHTNESS, "contrast": OP_CONTRAST,
              "saturation": OP_SATURATION, "blur": OP_BLUR}


def pack_plan(steps) -> np.ndarray:
    """steps: list of tuples — ("crop", l, t, w, h) | ("resize", w, h, filter)
    | ("flip",) | ("brightness"/"contrast"/"saturation", f) | ("grayscale",)
    | ("blur", radius) — to the int32 plan row the C side executes (floats
    carried as 16.16 fixed point)."""
    plan = np.zeros(PLAN_STRIDE, np.int32)
    if len(steps) > PLAN_MAX_STEPS:
        raise ValueError(f"plan too long: {len(steps)} > {PLAN_MAX_STEPS}")
    for i, step in enumerate(steps):
        base = i * PLAN_STEP
        if step[0] == "crop":
            plan[base : base + 5] = (OP_CROP, *step[1:5])
        elif step[0] == "resize":
            plan[base : base + 4] = (OP_RESIZE, *step[1:4])
        elif step[0] == "flip":
            plan[base] = OP_FLIP
        elif step[0] in _FLOAT_OPS:
            plan[base : base + 2] = (_FLOAT_OPS[step[0]],
                                     int(round(step[1] * _FP16)))
        elif step[0] == "grayscale":
            plan[base] = OP_GRAYSCALE
        else:
            raise ValueError(f"unknown plan step {step!r}")
    return plan


def load_batch(paths, plans, out_w: int, out_h: int, n_threads: int = 0,
               fast_scale: bool = False):
    """Decode + execute geometry plans for a batch in the C++ thread pool.

    fast_scale=True permits JPEG DCT-domain scaled decode when a plan opens
    with a resize: about quadratically cheaper on downscales, the output
    within a few LSB of the full-resolution path (for augmentation; keep
    False where the pixels must equal Pillow's).

    Returns (images (n, out_h, out_w, 3) uint8, status (n,) int32) where
    status is 0 ok / 1 error / 2 unsupported-format; non-zero entries are
    untouched in `images` and are the caller's to fill.
    """
    lib = get_lib()
    assert lib is not None
    n = len(paths)
    enc = [os.fsencode(p) for p in paths]
    c_paths = (ctypes.c_char_p * n)(*enc)
    plan_arr = np.ascontiguousarray(np.stack(plans), np.int32)
    assert plan_arr.shape == (n, PLAN_STRIDE), plan_arr.shape
    out = np.zeros((n, out_h, out_w, 3), np.uint8)
    status = np.zeros(n, np.int32)
    lib.irw_load_batch(
        c_paths,
        n,
        plan_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        PLAN_STRIDE,
        out_w,
        out_h,
        n_threads,
        1 if fast_scale else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out, status
