"""The host transform stage (port of ``HostTransform``,
``irw_tpu/transforms/pipeline.py:40-236``), PIL's arithmetic in numpy.

Ops: ``Resize`` (bilinear, square for an int size), ``CenterCrop`` (a crop
past the image's edge is zero-filled, as PIL's), ``RandomCrop``,
``RandomResizedCrop`` (aspect ratio drawn log-uniformly), ``RandomHorizontalFlip``,
``ColorJitter`` (brightness, contrast, saturation and hue factors drawn in
that order, applied in ``rng.permutation`` order), ``RandomGrayscale``,
``GaussianBlur``, ``FixSize`` (bicubic, up to a multiple of 2^level) and
``MultiCrop`` (SwAV's crops, in training only).  The draws consume a
``np.random.RandomState`` exactly as the JAX ``__call__`` does; the pixels
equal PIL's bit for bit (``tests/test_torch_host_transforms.py``,
``tests/test_torch_host_ops.py``):

- ``Image.resize`` with BILINEAR or BICUBIC on 8-bit RGB: per output
  pixel the filter's taps over [center - support, center + support)
  (support scaled by the reduction), normalised to 1 and rounded to 22-bit
  fixed point; a horizontal pass, rounded and clipped to uint8, then a
  vertical pass: ``(acc + 2^21) >> 22`` clipped to 0-255;
- ``ImageEnhance`` Brightness, Contrast and Color as PIL's ``blend`` of a
  degenerate image and the image, ``d + f·(x - d)`` in float32, clipped and
  truncated: the degenerate image is 0, the mean of the L image rounded to
  an int (Contrast), or the L image (Color), L being
  ``(19595 r + 38470 g + 7471 b + 2^15) >> 16``; grayscale is L in each
  channel;
- ``ImageFilter.GaussianBlur(r)``: not a Gaussian but three box blurs
  along each axis (rows first), each rounded to uint8, edges clamped; the
  box's radius is fractional (``gaussian_box_radius``) and its two edge
  taps share what the 24-bit fixed-point weights of the inner taps leave;
- the hue: ``convert("HSV")``, H shifted by ``round(f·255)`` mod 256,
  ``convert("RGB")``, Pillow's ``rgb2hsv``/``hsv2rgb`` with their float and
  double steps and truncating casts.

``plan`` draws one image's steps; ``apply`` runs them on an (H, W, 3)
uint8 image, computing a resize followed by an in-bounds crop only over
the crop.  ``HostTransform.batch`` draws every image's plan in
turn, then runs the pixels; ``HostTransform.crops`` gives one image's list
of multi-crops.  ``native_plan`` gives the same draws as a plan
the host image loader (``irw_tpu_torch.native``) runs from the file, or
None where an image needs a crop past its edge, which the loader does not
fill, or a hue (port of ``HostTransform.plan``,
``irw_tpu/transforms/pipeline.py:259-344``); the loader's blur is a true
Gaussian, as in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np

BILINEAR, BICUBIC = 0, 1
PRECISION_BITS = 22  # PIL's 8-bit resample: 32 - 8 - 2
_OPS = ("Resize", "CenterCrop", "RandomCrop", "RandomResizedCrop", "RandomHorizontalFlip",
        "ColorJitter", "RandomGrayscale", "GaussianBlur", "FixSize", "MultiCrop")


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


_FILTERS = {BILINEAR: (_bilinear, 1.0), BICUBIC: (_bicubic, 2.0)}


@lru_cache(maxsize=4096)
def resample_coeffs(in_size: int, out_size: int, filt: int, channels: int = 1):
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for a resize
    of the whole axis: per output index its taps' input indices and int32
    weights, (out, T) each, T the most non-zero taps any output takes (the
    rest weigh 0 at a valid index).  With ``channels`` > 1 the axis holds
    that many interleaved channels: (out · channels, T)."""
    fn, support = _FILTERS[filt]
    scale = filterscale = float(in_size) / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support * filterscale
    ss = 1.0 / filterscale
    rows = []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        k = [int(-0.5 + w * (1 << PRECISION_BITS)) if w < 0
             else int(0.5 + w * (1 << PRECISION_BITS)) for w in k]
        rows.append([(xmin + x, w) for x, w in enumerate(k) if w != 0] or [(xmin, 0)])
    taps = max(len(r) for r in rows)
    index = np.empty((out_size, taps), np.intp)
    weight = np.zeros((out_size, taps), np.int32)
    for xx, r in enumerate(rows):
        index[xx] = [x for x, _ in r] + [r[-1][0]] * (taps - len(r))
        weight[xx, :len(r)] = [w for _, w in r]
    if channels > 1:
        index = (index[:, None, :] * channels + np.arange(channels)[None, :, None]).reshape(
            out_size * channels, taps)
        weight = np.repeat(weight, channels, axis=0)
    return index, weight


def _clip8(acc: np.ndarray) -> np.ndarray:
    np.right_shift(acc, PRECISION_BITS, out=acc)
    np.maximum(acc, 0, out=acc)
    np.minimum(acc, 255, out=acc)
    return acc.astype(np.uint8)


def _pass(src: np.ndarray, index: np.ndarray, weight: np.ndarray, axis: int) -> np.ndarray:
    """One resample pass of a 2-D uint8 array along ``axis`` (0: rows, 1:
    columns) for the output indices ``index``/``weight``."""
    weight = weight if axis == 1 else weight[:, :, None]
    acc = np.multiply(np.take(src, index[:, 0], axis=axis), weight[:, 0], dtype=np.int32)
    tmp = np.empty_like(acc)
    for t in range(1, index.shape[1]):
        np.multiply(np.take(src, index[:, t], axis=axis), weight[:, t], out=tmp)
        acc += tmp
    acc += 1 << (PRECISION_BITS - 1)
    return _clip8(acc)


def resize(img: np.ndarray, out_w: int, out_h: int, filt: int, window=None) -> np.ndarray:
    """PIL's ``Image.resize((out_w, out_h), filt)`` of the (H, W, 3) uint8
    ``img``, cropped to ``window`` = (left, top, width, height) inside the
    output: only the window's pixels are computed."""
    in_h, in_w, _ = img.shape
    left, top, cw, ch = window or (0, 0, out_w, out_h)
    need_h, need_v = out_w != in_w, out_h != in_h
    if need_v:
        rindex, rweight = resample_coeffs(in_h, out_h, filt)
        rindex, rweight = rindex[top:top + ch], rweight[top:top + ch]
        r0, r1 = int(rindex.min()), int(rindex.max()) + 1
        rows = slice(r0, r1)
    else:
        rows = slice(top, top + ch)
    if need_h:
        cindex, cweight = resample_coeffs(in_w, out_w, filt, 3)
        cols = slice(3 * left, 3 * (left + cw))
        flat = np.ascontiguousarray(img[rows]).reshape(-1, 3 * in_w)
        img = _pass(flat, cindex[cols], cweight[cols], 1).reshape(-1, cw, 3)
    else:
        img = img[rows, left:left + cw]
    if need_v:
        flat = np.ascontiguousarray(img).reshape(img.shape[0], -1)
        img = _pass(flat, rindex - r0, rweight, 0).reshape(ch, cw, 3)
    return img


def crop(img: np.ndarray, left: int, top: int, cw: int, ch: int) -> np.ndarray:
    """PIL's ``crop``: the part past the image's edge is black."""
    h, w, _ = img.shape
    if left >= 0 and top >= 0 and left + cw <= w and top + ch <= h:
        return img[top:top + ch, left:left + cw]
    out = np.zeros((ch, cw, 3), np.uint8)
    x0, y0 = max(left, 0), max(top, 0)
    x1, y1 = min(left + cw, w), min(top + ch, h)
    if x1 > x0 and y1 > y0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


def luminance(img: np.ndarray) -> np.ndarray:
    """PIL's RGB → L, (19595 r + 38470 g + 7471 b + 2^15) >> 16, as uint8
    (H, W).  Elementwise, with no BLAS call: a BLAS library's own threads
    would compete with the loader's."""
    lum = img[..., 0] * np.int32(19595)
    lum += img[..., 1] * np.int32(38470)
    lum += img[..., 2] * np.int32(7471)
    lum += 0x8000
    lum >>= 16
    return lum.astype(np.uint8)


def _blend(d, x, alpha: np.float32):
    """``d + alpha·(x - d)`` in float32, clipped to 0-255, truncated to uint8."""
    t = np.subtract(x, d, dtype=np.float32)
    t *= alpha
    t += d
    np.maximum(t, 0.0, out=t)
    np.minimum(t, 255.0, out=t)
    return t.astype(np.uint8)


_LEVELS = np.arange(256, dtype=np.float32)


def enhance(img: np.ndarray, kind: str, factor: float) -> np.ndarray:
    """``ImageEnhance.Brightness`` / ``Contrast`` / ``Color`` ``.enhance``:
    PIL's ``Image.blend(degenerate, img, factor)``, the factor as a float32.
    The blend of a pixel depends on its level and the degenerate image's
    there, so each op is a table lookup: over the 256 levels for Brightness
    (degenerate 0) and Contrast (the rounded mean of L), over the 256 × 256
    (L, level) pairs for Color."""
    alpha = np.float32(factor)
    if kind == "saturation":
        lum = luminance(img)
        if alpha == 0.0:
            return np.repeat(lum, 3).reshape(img.shape)
        if alpha == 1.0:
            return img
        index = np.repeat(lum.astype(np.uint16) << 8, 3).reshape(img.shape)
        index |= img
        return np.take(_blend(_LEVELS[:, None], _LEVELS[None, :], alpha).reshape(-1), index)
    if kind == "brightness":
        d = 0
    else:
        d = int(float(luminance(img).sum(dtype=np.int64)) / (img.size // 3) + 0.5)
    if alpha == 0.0:
        return np.full_like(img, d)
    if alpha == 1.0:
        return img
    return np.take(_blend(np.float32(d), _LEVELS, alpha), img)


def grayscale(img: np.ndarray) -> np.ndarray:
    """``ImageOps.grayscale(img).convert("RGB")``."""
    return np.repeat(luminance(img), 3).reshape(img.shape)


_BLUR_PASSES = 3  # Pillow's GaussianBlur: three box blurs along each axis


def gaussian_box_radius(radius: float) -> np.float32:
    """Pillow's ``_gaussian_blur_radius``: the fractional radius of the box
    whose three-fold blur has the variance of a Gaussian of σ = radius,
    in float32 where Pillow computes in float and double where it does."""
    f32 = np.float32
    r = f32(radius)
    sigma2 = f32(r * r) / f32(_BLUR_PASSES)
    big_l = f32(np.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = f32(np.floor((float(big_l) - 1.0) / 2.0))
    a = (f32(2) * small_l + f32(1)) * (small_l * (small_l + f32(1)) - f32(3) * sigma2)
    a = a / (f32(6) * (sigma2 - (small_l + f32(1)) * (small_l + f32(1))))
    return f32(small_l + a)


def _box_pass(img: np.ndarray, box: np.float32, axis: int) -> np.ndarray:
    """One of Pillow's box-blur passes along ``axis``: each output is
    ``(ww · Σ_{|k| <= r} p[x + k] + fw · (p[x - r - 1] + p[x + r + 1]) + 2^23)
    >> 24`` over edge-clamped pixels, r = int(box), ww = 2^24 / (2·box + 1)
    in float truncated, fw = (2^24 - (2r + 1)·ww) / 2."""
    r = int(box)
    ww = int(np.float32(1 << 24) / (box * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    x = np.moveaxis(img, axis, 0)
    n = x.shape[0]
    padded = x[np.clip(np.arange(-r - 1, n + r + 1), 0, n - 1)].astype(np.int64)
    sums = np.zeros((len(padded) + 1,) + x.shape[1:], np.int64)
    np.cumsum(padded, axis=0, out=sums[1:])
    acc = sums[2 * r + 2:2 * r + 2 + n] - sums[1:1 + n]
    acc *= ww
    acc += (padded[:n] + padded[2 * r + 2:2 * r + 2 + n]) * fw
    acc += 1 << 23
    acc >>= 24
    return np.moveaxis(acc.astype(np.uint8), 0, axis)


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """``img.filter(ImageFilter.GaussianBlur(radius))`` of an (H, W, 3)
    uint8 image: three box blurs along the rows, then along the
    columns (none for a box of radius 0)."""
    box = gaussian_box_radius(radius)
    if box == 0:
        return img
    for axis in [1] * _BLUR_PASSES + [0] * _BLUR_PASSES:
        img = _box_pass(img, box, axis)
    return img


_BYTE = np.arange(256)
# hsv2rgb's per-(h, s) factors: i = floor(h·6/255), f its remainder, fs = s/255
_HUE_I = np.floor(_BYTE * 6.0 / 255.0).astype(np.int64)
_HUE_F = (_BYTE * 6.0 / 255.0 - _HUE_I.astype(np.float32)).astype(np.float32)
_SAT_F = (_BYTE / 255.0).astype(np.float32)
_Q_FACTOR = (1.0 - (_HUE_F[:, None] * _SAT_F[None, :]).astype(np.float64)).reshape(-1)
_T_FACTOR = (1.0 - _SAT_F[None, :].astype(np.float64)
             * (1.0 - _HUE_F[:, None].astype(np.float64))).reshape(-1)
# r, g, b of hsv2rgb's six sectors, as indices into (v, p, q, t)
_SECTORS = np.array([(0, 3, 1), (2, 0, 1), (1, 0, 3), (1, 2, 0), (3, 1, 0), (0, 1, 2)], np.uint8)
_SECTOR_OF_HUE = _SECTORS[_HUE_I % 6]


def _round_byte(x: np.ndarray) -> np.ndarray:
    """C's ``round`` of a non-negative double, clipped to uint8."""
    x += 0.5
    np.floor(x, out=x)
    np.clip(x, 0, 255, out=x)
    return x.astype(np.uint8)


# float32(d / c) at c · 256 + d (c = 0 taken as 1): rgb2hsv's rc, gc, bc
_RATIO = (_BYTE[None, :].astype(np.float32)
          / np.maximum(_BYTE, 1)[:, None].astype(np.float32)).reshape(-1)
# rgb2hsv's saturation byte int(float32(c / maxc) · 255.0) at c · 256 + maxc
_SATURATION = np.clip((_RATIO.reshape(256, 256).T.astype(np.float64) * 255.0).astype(np.int64),
                      0, 255).astype(np.uint8).reshape(-1)
# hsv2rgb's p = round(v · (1 - fs)) at s · 256 + v
_P = _round_byte(_BYTE[None, :] * (1.0 - _SAT_F[:, None].astype(np.float64))).reshape(-1)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``Image.convert("HSV")`` of an (H, W, 3) uint8 RGB image (Pillow's
    ``rgb2hsv_row``: rc, gc, bc and h in float, the sector offsets, the
    wrap and the scale to a byte in double, truncated)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = np.maximum(np.maximum(r, g), b)
    cr = (maxc - np.minimum(np.minimum(r, g), b)).astype(np.intp)
    row = cr << 8

    def part(c):  # float32((maxc - c) / cr)
        return np.take(_RATIO, row | (maxc - c))

    rc, gc, bc = part(r), part(g), part(b)
    h = np.where(g == maxc, 2.0 + rc.astype(np.float64) - bc,
                 4.0 + gc.astype(np.float64) - rc)
    h = np.where(r == maxc, (bc - gc).astype(np.float64), h).astype(np.float32)
    h = h.astype(np.float64)
    h /= 6.0
    h += 1.0
    h -= h >= 1.0  # fmod(h, 1) of h in [0, 2)
    h = h.astype(np.float32).astype(np.float64)
    h *= 255.0
    uh = h.astype(np.int64)
    np.clip(uh, 0, 255, out=uh)
    flat = cr == 0
    uh[flat] = 0
    us = np.take(_SATURATION, row | maxc)  # cr = 0 gives 0
    return np.stack([uh.astype(np.uint8), us, maxc], axis=-1)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``Image.fromarray(hsv, mode="HSV").convert("RGB")`` (Pillow's
    ``hsv2rgb``): p, q, t = round(v · (1 - fs)), round(v · (1 - fs·f)),
    round(v · (1 - fs·(1 - f))), arranged by the sector i mod 6.  s = 0
    gives p = q = t = v."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    hs = (h.astype(np.intp) << 8) | s
    parts = np.empty(v.shape + (4,), np.uint8)
    parts[..., 0] = v
    parts[..., 1] = np.take(_P, (s.astype(np.intp) << 8) | v)
    parts[..., 2] = _round_byte(np.take(_Q_FACTOR, hs) * v)
    parts[..., 3] = _round_byte(np.take(_T_FACTOR, hs) * v)
    return np.take_along_axis(parts, _SECTOR_OF_HUE[h].astype(np.intp), axis=-1)


def hue_shift(img: np.ndarray, factor: float) -> np.ndarray:
    """ColorJitter's hue: H shifted by ``round(factor · 255)`` mod 256 in
    Pillow's HSV (``irw_tpu/transforms/pipeline.py:92-95``), in blocks of
    rows of about 2^18 pixels (the temporaries stay in cache)."""
    shift = int(round(factor * 255))
    out = np.empty_like(img)
    rows = max(1, (1 << 18) // max(img.shape[1], 1))
    for top in range(0, img.shape[0], rows):
        hsv = rgb_to_hsv(img[top:top + rows])
        hsv[..., 0] = (hsv[..., 0].astype(np.int16) + shift) % 256
        out[top:top + rows] = hsv_to_rgb(hsv)
    return out


def _size2d(size):
    if isinstance(size, int):
        return (size, size)
    return tuple(size)


def plan(ops, width: int, height: int, rng: np.random.RandomState, train: bool):
    """One image's steps, drawing from ``rng`` as the JAX ``__call__`` does:
    (steps, out_w, out_h); steps are ("resize", w, h, filter),
    ("crop", left, top, w, h), ("flip",), (enhance kind, factor),
    ("hue", factor), ("grayscale",) and ("blur", radius).  ``MultiCrop`` is
    left out: ``multi_crop_plans`` draws it."""
    steps, w, h = [], width, height
    for name, kw in ops:
        if name == "Resize":
            th, tw = _size2d(kw.get("size", 224))
            steps.append(("resize", tw, th, BILINEAR))
            w, h = tw, th
        elif name in ("CenterCrop", "RandomCrop"):
            th, tw = _size2d(kw.get("size", 224))
            if name == "RandomCrop" and train and w >= tw and h >= th:
                left = rng.randint(0, w - tw + 1)
                top = rng.randint(0, h - th + 1)
            else:
                left, top = max((w - tw) // 2, 0), max((h - th) // 2, 0)
            steps.append(("crop", int(left), int(top), tw, th))
            w, h = tw, th
        elif name == "RandomResizedCrop":
            th, tw = _size2d(kw.get("size", 224))
            if train:
                scale = kw.get("scale", (0.08, 1.0))
                ratio_span = kw.get("ratio", (3 / 4, 4 / 3))
                target = rng.uniform(*scale) * (w * h)
                ratio = float(np.exp(rng.uniform(np.log(ratio_span[0]), np.log(ratio_span[1]))))
                cw = min(int(round(np.sqrt(target * ratio))), w)
                ch = min(int(round(np.sqrt(target / ratio))), h)
                left = rng.randint(0, w - cw + 1)
                top = rng.randint(0, h - ch + 1)
                steps.append(("crop", int(left), int(top), cw, ch))
            steps.append(("resize", tw, th, BILINEAR))
            w, h = tw, th
        elif name == "RandomHorizontalFlip":
            if train and rng.rand() < kw.get("p", 0.5):
                steps.append(("flip",))
        elif name == "ColorJitter":
            if train:
                drawn = [(kind, rng.uniform(max(0.0, 1 - span), 1 + span))
                         for kind, span in (("brightness", kw.get("brightness", 0.0)),
                                            ("contrast", kw.get("contrast", 0.0)),
                                            ("saturation", kw.get("saturation", 0.0)))
                         if span]
                hue = kw.get("hue", 0.0)
                if hue:
                    drawn.append(("hue", rng.uniform(-hue, hue)))
                for i in rng.permutation(len(drawn)):
                    steps.append(drawn[int(i)])
        elif name == "RandomGrayscale":
            if train and rng.rand() < kw.get("p", 0.1):
                steps.append(("grayscale",))
        elif name == "GaussianBlur":
            if train and rng.rand() < kw.get("p", 1.0):
                sigma = kw.get("sigma", (0.1, 2.0))
                lo, hi = (sigma, sigma) if isinstance(sigma, (int, float)) else sigma
                steps.append(("blur", float(rng.uniform(lo, hi))))
        elif name == "FixSize":
            factor = 2 ** kw.get("level", 1)
            new_w = int(np.ceil(w / factor) * factor)
            new_h = int(np.ceil(h / factor) * factor)
            if (new_w, new_h) != (w, h):
                steps.append(("resize", new_w, new_h, BICUBIC))
                w, h = new_w, new_h
    return steps, w, h


def native_plannable(ops, train: bool) -> bool:
    """Whether the host image loader can run ``ops`` (``irw_tpu/transforms/
    pipeline.py:232-257``): every geometry op and the colour ops, but not
    ``MultiCrop`` in training (a list of crops) nor, in training,
    ``ColorJitter`` with a hue (Pillow's HSV round trip)."""
    for name, kw in ops:
        if name == "MultiCrop":
            if train:
                return False
        elif name == "ColorJitter":
            if train and kw.get("hue", 0.0):
                return False
        elif name not in _OPS:
            return False
    return True


def native_plan(ops, width: int, height: int, rng: np.random.RandomState, train: bool):
    """``plan``'s draws as (steps, out_w, out_h) for ``native.pack_plan``,
    or None where a crop reaches past the image, which only the host stage
    fills."""
    steps, out_w, out_h = plan(ops, width, height, rng, train)
    w, h = width, height
    for step in steps:
        if step[0] == "hue":  # native_plannable refuses it
            return None
        if step[0] == "resize":
            w, h = step[1:3]
        elif step[0] == "crop":
            _, left, top, w_crop, h_crop = step
            if left < 0 or top < 0 or left + w_crop > w or top + h_crop > h:
                return None
            w, h = w_crop, h_crop
    return steps, out_w, out_h


def apply(img: np.ndarray, steps) -> np.ndarray:
    """Run ``steps`` on the (H, W, 3) uint8 ``img``."""
    i = 0
    while i < len(steps):
        step = steps[i]
        if step[0] == "resize":
            _, tw, th, filt = step
            nxt = steps[i + 1] if i + 1 < len(steps) else None
            if (nxt is not None and nxt[0] == "crop" and nxt[1] >= 0 and nxt[2] >= 0
                    and nxt[1] + nxt[3] <= tw and nxt[2] + nxt[4] <= th):
                img = resize(img, tw, th, filt, window=nxt[1:])
                i += 1
            else:
                img = resize(img, tw, th, filt)
        elif step[0] == "crop":
            img = crop(img, *step[1:])
        elif step[0] == "flip":
            img = img[:, ::-1]
        elif step[0] == "grayscale":
            img = grayscale(img)
        elif step[0] == "blur":
            img = gaussian_blur(img, step[1])
        elif step[0] == "hue":
            img = hue_shift(img, step[1])
        else:
            img = enhance(img, step[0], step[1])
        i += 1
    return img


def _color_distort_steps(rng: np.random.RandomState, strength: float = 1.0) -> list:
    """SwAV's colour distortion (``_color_distort``,
    ``irw_tpu/transforms/pipeline.py:40-54``): with probability 0.8
    brightness, contrast and saturation in that order, each 1 + 0.8·strength
    · U(-1, 1); then grayscale with probability 0.2."""
    steps = []
    if rng.rand() < 0.8:
        for kind in ("brightness", "contrast", "saturation"):
            steps.append((kind, 1.0 + 0.8 * strength * (rng.rand() * 2 - 1)))
    if rng.rand() < 0.2:
        steps.append(("grayscale",))
    return steps


def multi_crop_plans(cfg: dict, width: int, height: int, rng: np.random.RandomState) -> list:
    """``MultiCrop``'s crops of one (width, height) image as a list of
    steps, drawn as ``_multi_crop`` draws them
    (``irw_tpu/transforms/pipeline.py:110-135``): per crop the area share
    and aspect ratio (both uniform), its corner, then a bilinear resize to
    the crop size, a flip with probability 0.5, the colour distortion and a
    blur of radius U(0.1, 2) with probability 0.5."""
    crops = []
    for size, count, lo, hi in zip(cfg.get("size_crops", [224, 96]), cfg.get("nmb_crops", [2, 6]),
                                   cfg.get("min_scale_crops", [0.14, 0.05]),
                                   cfg.get("max_scale_crops", [1.0, 0.14])):
        for _ in range(count):
            target = rng.uniform(lo, hi) * (width * height)
            ratio = rng.uniform(3 / 4, 4 / 3)
            cw = min(int(round(np.sqrt(target * ratio))), width)
            ch = min(int(round(np.sqrt(target / ratio))), height)
            left = rng.randint(0, width - cw + 1)
            top = rng.randint(0, height - ch + 1)
            steps = [("crop", int(left), int(top), cw, ch), ("resize", size, size, BILINEAR)]
            if rng.rand() < 0.5:
                steps.append(("flip",))
            steps += _color_distort_steps(rng)
            if rng.rand() < 0.5:
                steps.append(("blur", float(rng.uniform(0.1, 2.0))))
            crops.append(steps)
    return crops


class HostTransform:
    """``ops``: list of (name, kwargs); with none, ``Resize(image_size)``.
    ``__call__(img, rng, train)`` takes one (H, W, 3) uint8 image and gives
    one, or in training with ``MultiCrop`` the list of its crops, as the
    JAX class does for a PIL image; ``batch`` takes a sequence of images
    and gives (B, H, W, 3), drawing the images' plans in order (with
    ``MultiCrop`` in training, the images' crop lists stacked as the JAX
    ``run`` stacks them: (B, crops, size, size, 3) where every crop has one
    size, else ``np.stack``'s error); ``crops`` gives one image's crops."""

    def __init__(self, ops: Sequence[tuple[str, dict]] = (), image_size: int = 224):
        self.ops = [(name, dict(kw or {})) for name, kw in ops] or [
            ("Resize", {"size": (image_size, image_size)})]
        for name, _ in self.ops:
            if name not in _OPS:
                raise ValueError(f"unknown host transform {name!r}")
        self.multi_crop = next((kw for name, kw in self.ops if name == "MultiCrop"), None)

    def __call__(self, img: np.ndarray, rng: np.random.RandomState, train: bool):
        if self.multi_crop is not None and train:
            return self.crops(img, rng)
        return self.batch([img], rng, train)[0]

    def crops(self, img: np.ndarray, rng: np.random.RandomState) -> list:
        """The ``MultiCrop`` crops of ``img``, (size, size, 3) uint8 each."""
        img = np.asarray(img, np.uint8)
        return [apply(img, steps)
                for steps in multi_crop_plans(self.multi_crop, img.shape[1], img.shape[0], rng)]

    def batch(self, images, rng: np.random.RandomState, train: bool) -> np.ndarray:
        if self.multi_crop is not None and train:
            return np.stack([self.crops(img, rng) for img in images])
        plans = [plan(self.ops, img.shape[1], img.shape[0], rng, train) for img in images]
        sizes = {(w, h) for _, w, h in plans}
        if len(sizes) != 1:
            raise ValueError(f"the host stage gives images of sizes {sorted(sizes)}: a batch "
                             "needs one")
        (w, h), = sizes
        out = np.empty((len(images), h, w, 3), np.uint8)
        for b, (img, (steps, _, _)) in enumerate(zip(images, plans)):
            out[b] = apply(np.asarray(img, np.uint8), steps)
        return out
