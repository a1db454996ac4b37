"""Host image I/O without Pillow or OpenCV: PNG, PIL's bilinear resize, JET.

- :func:`read_png`: 8-bit gray, gray + alpha, RGB and RGBA PNGs, every one
  of the five scanline filters, any number of IDAT chunks (zlib and
  numpy). Interlaced, palette and 16-bit files raise, naming the file.
- :func:`write_png`: 8-bit gray / gray + alpha / RGB / RGBA with one
  scanline filter for every row (Sub by default).
- :func:`resize_bilinear`: ``PIL.Image.resize(size, Image.BILINEAR)`` on
  uint8 images, as the JAX dataset resizes its frames: Pillow's separable
  triangle filter widened by the scale, its 22-bit fixed-point weights,
  horizontal then vertical pass through a uint8 image, and RGBA resized
  with premultiplied alpha.
- :data:`JET`: OpenCV's ``COLORMAP_JET`` as a (256, 3) RGB uint8 table.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}        # PNG colour type -> channels
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _unfilter_rows(filt: np.ndarray, ftype: np.ndarray, bpp: int):
    """Rows of filters 0-2 only: one vector operation a row."""
    h, stride = filt.shape
    out = np.empty_like(filt)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        row = filt[r]
        if ftype[r] == 1:
            row = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype[r] == 2:
            row = row + prev
        out[r] = row
        prev = out[r]
    return out


def _unfilter_wavefront(filt: np.ndarray, ftype: np.ndarray, bpp: int):
    """Any filters: pixel (r, x) needs (r, x-1), (r-1, x) and (r-1, x-1),
    so each anti-diagonal r + x = d decodes at once from the ones before."""
    h, stride = filt.shape
    w = stride // bpp
    raw = filt.reshape(h, w, bpp).astype(np.int16)
    out = np.zeros((h + 1, w + 1, bpp), np.int16)    # a zero row and column
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a = out[r + 1, x]          # left
        b = out[r, x + 1]          # up
        c = out[r, x]              # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.select(
            [ftype[r, None] == k for k in (1, 2, 3, 4)],
            [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (raw[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, stride)


def read_png(path: str) -> np.ndarray:
    """(H, W) uint8 for gray, (H, W, C) for gray + alpha, RGB, RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in a {kind.decode()} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype == 3:
        raise ValueError(f"{path}: palette PNGs are not supported")
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit gray / gray+alpha / RGB / "
                         f"RGBA PNGs are supported (bit depth {depth}, "
                         f"colour type {ctype})")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    ch = _CHANNELS[ctype]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, want "
                         f"{h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    ftype, filt = raw[:, 0], raw[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown scanline filter {ftype.max()}")
    if ftype.max(initial=0) <= 2:
        img = _unfilter_rows(filt, ftype, ch)
    else:
        img = _unfilter_wavefront(filt, ftype, ch)
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def write_png(path: str, img: np.ndarray, filter_type: int = 1):
    """Write (H, W) or (H, W, C) uint8, C in 1-4, with scanline filter
    ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) on every
    row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in _COLOR_TYPE:
        raise ValueError(f"{path}: {ch} channels")
    x = img.reshape(h, w * ch).astype(np.int16)
    left = np.zeros_like(x)
    left[:, ch:] = x[:, :-ch]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, ch:] = x[:-1, :-ch]
    if filter_type == 0:
        pred = np.zeros_like(x)
    elif filter_type == 1:
        pred = left
    elif filter_type == 2:
        pred = up
    elif filter_type == 3:
        pred = (left + up) >> 1
    elif filter_type == 4:
        p = left + up - upleft
        pa, pb, pc = (np.abs(p - left), np.abs(p - up), np.abs(p - upleft))
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"unknown PNG filter type {filter_type}")
    rows = np.empty((h, w * ch + 1), np.uint8)
    rows[:, 0] = filter_type
    rows[:, 1:] = ((x - pred) & 0xFF).astype(np.uint8)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    hdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", hdr)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


# -- Pillow's BILINEAR resize ---------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the triangle filter (support 1)
    and ``normalize_coeffs_8bpc``: (first source index (out,), fixed-point
    weights (out, K))."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    xmin = np.empty(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        t = (np.arange(lo, hi) - center + 0.5) / filterscale
        k = np.maximum(1.0 - np.abs(t), 0.0)
        ww = k.sum()
        if ww != 0.0:
            k = k / ww
        kk[xx, :hi - lo] = np.where(
            k < 0, (-0.5 + k * (1 << _PRECISION_BITS)).astype(np.int64),
            (0.5 + k * (1 << _PRECISION_BITS)).astype(np.int64))
        xmin[xx] = lo
    return xmin, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's ``ImagingResample{Horizontal,Vertical}_8bpc``
    along ``axis`` of a uint8 array."""
    in_size = img.shape[axis]
    if in_size == out_size:
        return img
    xmin, kk = _coeffs(in_size, out_size)
    x = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + x.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    extra = (1,) * (x.ndim - 1)
    for j in range(kk.shape[1]):
        idx = np.minimum(xmin + j, in_size - 1)
        acc += x[idx] * kk[:, j].reshape((-1,) + extra)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    tmp = a.astype(np.int64) * b + 128
    return (((tmp >> 8) + tmp) >> 8).astype(np.uint8)


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """``img`` ((H, W) or (H, W, C) uint8) resized to ``size`` = (h, w) as
    ``PIL.Image.fromarray(img).resize((w, h), Image.BILINEAR)`` resizes
    it."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_bilinear takes uint8, got {img.dtype}")
    h, w = size
    alpha = img.ndim == 3 and img.shape[-1] in (2, 4)
    if alpha:       # Pillow resizes LA / RGBA premultiplied (La / RGBa)
        a = img[..., -1:]
        img = np.concatenate([_muldiv255(img[..., :-1], a), a], axis=-1)
    out = _resample_axis(_resample_axis(img, w, 1), h, 0)
    if alpha:
        a = out[..., -1:].astype(np.int64)
        c = out[..., :-1].astype(np.int64)
        un = np.clip(255 * c // np.maximum(a, 1), 0, 255)
        c = np.where((a == 0) | (a == 255), c, un)
        out = np.concatenate([c, a], axis=-1).astype(np.uint8)
    return out


# -- OpenCV's COLORMAP_JET ------------------------------------------------

def _jet() -> np.ndarray:
    """Each channel of OpenCV's table is a clipped tent of slope 4 a level
    (red peaks late, green in the middle, blue early); one entry of its
    blue ramp, level 159, is 1 where the line gives 2."""
    i = np.arange(256)
    rgb = np.stack([np.minimum(4 * i - 382, 1148 - 4 * i),
                    np.minimum(4 * i - 128, 892 - 4 * i),
                    np.minimum(4 * i + 128, 638 - 4 * i)], axis=-1)
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    rgb[159, 2] = 1
    return rgb


JET = _jet()
