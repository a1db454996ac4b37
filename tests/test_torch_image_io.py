"""The port's host image I/O (``moco_flow_tpu_torch/utils/image.py``)
against Pillow and OpenCV, which the JAX package uses and the GPU machine
lacks.

- PNGs written by Pillow (gray, gray + alpha, RGB, RGBA; Pillow picks a
  filter a row, so its files mix Sub, Up and Paeth; large ones span
  several IDAT chunks) read back equal; PNGs the port writes with each of
  the five filters read back equal through Pillow and the port.
- Interlaced, palette and 16-bit files raise, naming the file.
- ``resize_bilinear`` against ``Image.resize(..., Image.BILINEAR)`` at
  1080 -> 216, 1080 -> 108 and 48 -> 30: within 1 level of 255 (measured on
  this container: max 0, mean 0, the same bits).
- ``JET`` against ``cv2.applyColorMap(..., COLORMAP_JET)`` on all 256
  levels, exactly.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu_torch.utils.image import (JET, read_png, resize_bilinear,
                                             write_png)

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _image(h, w, ch, seed=0):
    """Noise beside smooth ramps and flat runs, so an adaptive encoder
    picks several filters."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
    yy, xx = np.mgrid[:h, :w]
    img[:, : w // 3] = ((xx[:, : w // 3, None] * 7 + yy[:, : w // 3, None]
                         * 3) % 256).astype(np.uint8)
    img[h // 2:, w // 3: 2 * w // 3] = 17
    return img[..., 0] if ch == 1 else img


def _chunks(path):
    data = open(path, "rb").read()
    pos, out = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        out.append((kind, data[pos + 8:pos + 8 + n]))
        pos += 12 + n
    return out


def _filters(path):
    chunks = _chunks(path)
    w, h, _, ctype = struct.unpack(">IIBB", chunks[0][1][:10])
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype] + 1
    return {raw[r * stride] for r in range(h)}


@pytest.mark.parametrize("mode", list(MODES))
def test_reads_pillow_pngs(tmp_path, mode):
    img = _image(61, 97, MODES[mode])
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(img, mode).save(path)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, img)


def test_pillow_files_cover_the_filters_and_chunks(tmp_path):
    """What the cases above and below read: rows of several filters,
    Paeth among them, and a file of several IDAT chunks."""
    seen = set()
    for mode, ch in MODES.items():
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(_image(61, 97, ch), mode).save(path)
        seen |= _filters(path)
    assert {1, 2, 4} <= seen
    big = _image(400, 400, 4, seed=1)
    path = str(tmp_path / "big.png")
    Image.fromarray(big, "RGBA").save(path)
    assert sum(k == b"IDAT" for k, _ in _chunks(path)) > 1
    np.testing.assert_array_equal(read_png(path), big)


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("mode", list(MODES))
def test_port_pngs_read_back_through_pillow(tmp_path, mode, ftype):
    img = _image(33, 45, MODES[mode], seed=ftype)
    path = str(tmp_path / "x.png")
    write_png(path, img, filter_type=ftype)
    assert _filters(path) == {ftype}
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(path), img)


def _with_ihdr(path, out, **fields):
    """Copy ``path`` with IHDR fields replaced (the CRC recomputed)."""
    chunks = _chunks(path)
    w, h, depth, ctype, comp, filt, inter = struct.unpack(">IIBBBBB",
                                                          chunks[0][1])
    vals = {"depth": depth, "ctype": ctype, "interlace": inter, **fields}
    body = struct.pack(">IIBBBBB", w, h, vals["depth"], vals["ctype"], comp,
                       filt, vals["interlace"])
    with open(out, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        for kind, b in [(b"IHDR", body)] + chunks[1:]:
            f.write(struct.pack(">I", len(b)) + kind + b + struct.pack(
                ">I", zlib.crc32(kind + b) & 0xFFFFFFFF))


def test_unsupported_pngs_raise_naming_the_file(tmp_path):
    rgb = str(tmp_path / "rgb.png")
    Image.fromarray(_image(8, 8, 3), "RGB").save(rgb)
    pal = str(tmp_path / "palette.png")
    Image.fromarray(_image(8, 8, 3), "RGB").convert("P").save(pal)
    deep = str(tmp_path / "deep16.png")
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8)
                    * 1000).save(deep)
    inter = str(tmp_path / "interlaced.png")
    _with_ihdr(rgb, inter, interlace=1)
    for path, what in ((pal, "palette"), (deep, "bit depth 16"),
                       (inter, "interlaced")):
        with pytest.raises(ValueError, match=what) as e:
            read_png(path)
        assert path in str(e.value)
    bad = str(tmp_path / "bad.png")
    open(bad, "wb").write(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(bad)


@pytest.mark.parametrize("src,dst,mode", [
    (1080, 216, "RGBA"), (1080, 108, "RGBA"), (48, 30, "RGBA"),
    (1080, 216, "RGB"), (48, 30, "L"), (30, 48, "RGBA")])
def test_resize_equals_pillow_bilinear(src, dst, mode):
    """Frames with an alpha blob (Pillow resizes RGBA premultiplied)."""
    img = _image(src, src, MODES[mode], seed=src + dst)
    if mode == "RGBA":
        yy, xx = np.mgrid[:src, :src] / src
        r2 = (xx - 0.5) ** 2 + (yy - 0.5) ** 2
        img[..., 3] = np.where(r2 < 0.1, 255, np.where(r2 < 0.15, 128, 0))
    got = resize_bilinear(img, (dst, dst)).astype(int)
    want = np.asarray(Image.fromarray(img, mode).resize(
        (dst, dst), Image.BILINEAR)).astype(int)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    print(f"{src}->{dst} {mode}: max {diff.max()}, mean {diff.mean():.3g}")
    assert diff.max() <= 1


def test_jet_equals_opencv():
    import cv2
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    bgr = cv2.applyColorMap(levels, cv2.COLORMAP_JET).reshape(256, 3)
    np.testing.assert_array_equal(JET, bgr[:, ::-1])
